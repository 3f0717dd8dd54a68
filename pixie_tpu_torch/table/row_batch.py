"""RowBatch: one columnar batch of rows.

Parity with reference src/table_store/schema/row_batch.h:40 (a vector of Arrow
arrays + eow/eos stream markers), but columns are numpy arrays in the table-store
storage encoding (codes for dict-encoded types) and batches carry an explicit
`num_valid` so they can be padded to fixed shapes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from pixie_tpu_torch.types import STORAGE_DTYPE, Relation


@dataclasses.dataclass
class RowBatch:
    relation: Relation
    columns: dict[str, np.ndarray]
    #: rows [num_valid:] are padding and must be masked by consumers.
    num_valid: int = -1
    #: end-of-window marker (windowed/streaming aggs emit on eow; reference
    #: exec_node.h:213-219).
    eow: bool = False
    #: end-of-stream marker.
    eos: bool = False

    def __post_init__(self):
        n = None
        for name, arr in self.columns.items():
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(f"column {name} length {len(arr)} != {n}")
        if n is None:
            n = 0
        if self.num_valid < 0:
            self.num_valid = n

    @property
    def num_rows(self) -> int:
        """Physical (padded) row count."""
        for arr in self.columns.values():
            return len(arr)
        return 0

    def col(self, name: str) -> np.ndarray:
        return self.columns[name]

    def slice(self, start: int, stop: int) -> "RowBatch":
        stop = min(stop, self.num_rows)
        return RowBatch(
            self.relation,
            {k: v[start:stop] for k, v in self.columns.items()},
            num_valid=max(0, min(self.num_valid, stop) - start),
            eow=self.eow,
            eos=self.eos,
        )

    def compact(self) -> "RowBatch":
        """Drop padding rows."""
        if self.num_valid == self.num_rows:
            return self
        return self.slice(0, self.num_valid)

    def pad_to(self, n: int) -> "RowBatch":
        """Pad columns with zeros up to n physical rows (static-shape bucketing)."""
        cur = self.num_rows
        if cur == n:
            return self
        if cur > n:
            raise ValueError(f"cannot pad {cur} rows down to {n}")
        cols = {}
        for c in self.relation:
            arr = self.columns[c.name]
            pad = np.zeros(n - cur, dtype=arr.dtype)
            cols[c.name] = np.concatenate([arr, pad])
        return RowBatch(self.relation, cols, num_valid=self.num_valid, eow=self.eow, eos=self.eos)

    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.columns.values())

    @staticmethod
    def empty(relation: Relation, eow: bool = False, eos: bool = False) -> "RowBatch":
        cols = {c.name: np.empty(0, dtype=STORAGE_DTYPE[c.data_type]) for c in relation}
        return RowBatch(relation, cols, num_valid=0, eow=eow, eos=eos)

    @staticmethod
    def concat(batches: list["RowBatch"]) -> "RowBatch":
        if not batches:
            raise ValueError("concat of no batches")
        rel = batches[0].relation
        batches = [b.compact() for b in batches]
        cols = {
            c.name: np.concatenate([b.columns[c.name] for b in batches]) for c in rel
        }
        return RowBatch(rel, cols, eow=batches[-1].eow, eos=batches[-1].eos)
