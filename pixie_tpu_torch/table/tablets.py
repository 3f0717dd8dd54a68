"""Tablet-partitioned tables: sharding by key.

Reference: src/table_store/table/tablets_group.h:34-56 — a table may be split
into tablets keyed by a column value (UPIDs in practice); plans address one
tablet via MemorySourceOperator.Tablet (planpb/plan.proto:149-168).

Copied from the reference package (pixie_tpu/table/tablets.py).  All tablets
SHARE one dictionary set, so row batches from different tablets live in one
code space (a whole-group scan is then just a chained cursor and the chain
kernel's programs are the same); a whole-group scan namespaces its gens as
(tablet id, gen) pairs, so the executor's device feed cache never answers
one tablet with another's feed and the resident tier declines the chain, and
a one-tablet scan reads the tablet's own Table (its own uid).
"""
from __future__ import annotations

import threading

import numpy as np

from pixie_tpu_torch.status import InvalidArgument, NotFound, Unimplemented
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.table.table import DEFAULT_BATCH_ROWS, DEFAULT_TABLE_BYTES, Table, _table_uid
from pixie_tpu_torch.types import Relation, is_dict_encoded


class _ChainedCursor:
    """Concatenation of per-tablet cursors presenting the Cursor surface."""

    def __init__(self, group: "TabletsGroup", cursors: list):
        self.table = group
        self._cursors = cursors

    def __iter__(self):
        for tid, cur in self._cursors:
            for rb, row_id, gen in cur:
                # namespace gens per tablet: the device feed cache keys on
                # (table uid, gens) and tablets share the group uid
                yield rb, row_id, ((tid, gen) if gen is not None else None)

    def __len__(self):
        return sum(len(c) for _t, c in self._cursors)

    def num_rows(self) -> int:
        return sum(c.num_rows() for _t, c in self._cursors)

    def time_range(self):
        lo = hi = None
        for _t, c in self._cursors:
            r = c.time_range()
            if r is None:
                continue
            lo = r[0] if lo is None else min(lo, r[0])
            hi = r[1] if hi is None else max(hi, r[1])
        return None if lo is None else (lo, hi)


class TabletsGroup:
    """name → {tablet id → Table} with a shared dictionary set."""

    def __init__(
        self,
        name: str,
        relation: Relation,
        tablet_col: str,
        max_bytes: int = DEFAULT_TABLE_BYTES,
        batch_rows: int = DEFAULT_BATCH_ROWS,
    ):
        if tablet_col not in relation:
            raise InvalidArgument(f"tablet column {tablet_col!r} not in relation")
        self.name = name
        self.uid = next(_table_uid)
        self.relation = relation
        self.tablet_col = tablet_col
        self.max_bytes = max_bytes
        self.batch_rows = batch_rows
        self.time_col = "time_" if "time_" in relation else None
        #: ONE dictionary set for every tablet (cross-tablet code consistency)
        self.dictionaries: dict[str, Dictionary] = {
            c.name: Dictionary() for c in relation if is_dict_encoded(c.data_type)
        }
        self._tablets: dict[str, Table] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ write
    def write(self, data: dict) -> int:
        """Route rows to tablets by the tablet column's value."""
        if self.tablet_col not in data:
            raise InvalidArgument(
                f"write to {self.name}: missing tablet column {self.tablet_col!r}"
            )
        keys = np.asarray(data[self.tablet_col], dtype=object)
        n = len(keys)
        if n == 0:
            return 0
        uniq, inverse = np.unique(keys.astype(str), return_inverse=True)
        cols = {k: np.asarray(v, dtype=object) if not isinstance(v, np.ndarray) else v
                for k, v in data.items()}
        written = 0
        for i, tid in enumerate(uniq):
            mask = inverse == i
            t = self.tablet(str(tid), create=True)
            written += t.write({k: v[mask] for k, v in cols.items()})
        return written

    def tablet(self, tid: str, create: bool = False) -> Table:
        with self._lock:
            t = self._tablets.get(tid)
            if t is None:
                if not create:
                    raise NotFound(
                        f"table {self.name!r} has no tablet {tid!r} "
                        f"(have {sorted(self._tablets)})"
                    )
                t = Table(
                    f"{self.name}/{tid}", self.relation,
                    max_bytes=self.max_bytes, batch_rows=self.batch_rows,
                )
                t.dictionaries = self.dictionaries  # shared code space
                self._tablets[tid] = t
            return t

    def tablet_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._tablets)

    # ---------------------------------------------------- Table-like surface
    def cursor(self, start_time=None, stop_time=None, include_hot: bool = True):
        with self._lock:
            items = [
                (tid, t.cursor(start_time, stop_time, include_hot))
                for tid, t in sorted(self._tablets.items())
            ]
        return _ChainedCursor(self, items)

    def cursor_since(self, *a, **kw):
        raise Unimplemented("streaming resume over tabletized tables")

    def last_row_id(self) -> int:
        raise Unimplemented("streaming resume over tabletized tables")

    def stats(self) -> dict:
        with self._lock:
            tablets = list(self._tablets.values())
        per = [t.stats() for t in tablets]
        return {
            "name": self.name,
            "tablets": len(per),
            "batches": sum(s["batches"] for s in per),
            "hot_rows": sum(s["hot_rows"] for s in per),
            "rows_written": sum(s["rows_written"] for s in per),
            "bytes": sum(s["bytes"] for s in per),
            "expired_batches": sum(s["expired_batches"] for s in per),
            "dict_sizes": {k: d.size for k, d in self.dictionaries.items()},
        }

    def nbytes(self) -> int:
        with self._lock:
            tablets = list(self._tablets.values())
        return sum(t.nbytes() for t in tablets)
