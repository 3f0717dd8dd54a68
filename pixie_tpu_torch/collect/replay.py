"""Replay connector: streams a recorded/synthetic columnar dataset into the
table store at a configurable rate, rewriting timestamps to arrival time.

Reference role: SURVEY §7 step 8 names a "file/replay connector (enough for
all benchmarks)" as collection phase one; bench config #5 (100M-row streaming
replay, BASELINE.md) runs through this.  A dataset is either a dict of numpy
columns or a zero-arg generator yielding such dicts (synthetic generators
avoid materializing 100M rows up front).

Copied from the reference package (pixie_tpu/collect/replay.py).
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from pixie_tpu_torch.collect.core import SourceConnector, TableSpec, now_ns
from pixie_tpu_torch.status import InvalidArgument
from pixie_tpu_torch.types import Relation


class ReplayConnector(SourceConnector):
    """Streams chunks of a dataset into one table.

    data: {col: np.ndarray} replayed in slices, OR an iterator/generator of
    such dicts (each yield = one transfer's batch).
    """

    name = "replay"

    def __init__(
        self,
        table: str,
        relation: Relation,
        data=None,
        batches: Optional[Iterator[dict]] = None,
        rows_per_transfer: int = 1 << 16,
        sample_period_s: float = 0.01,
        rewrite_time: bool = True,
        name: Optional[str] = None,
        max_bytes: int = 1 << 30,
    ):
        if (data is None) == (batches is None):
            raise InvalidArgument("replay: pass exactly one of data / batches")
        self.table = table
        self.relation = relation
        self._data = data
        self._batches = iter(batches) if batches is not None else None
        self.rows_per_transfer = rows_per_transfer
        self.sample_period_s = sample_period_s
        self.rewrite_time = rewrite_time
        self._off = 0
        self._max_bytes = max_bytes
        if name is not None:
            self.name = name
        self.rows_replayed = 0

    def tables(self) -> list[TableSpec]:
        return [TableSpec(self.table, self.relation,
                          sample_period_s=self.sample_period_s,
                          max_bytes=self._max_bytes)]

    def _next_chunk(self) -> Optional[dict]:
        if self._batches is not None:
            try:
                return dict(next(self._batches))
            except StopIteration:
                return None
        n = len(next(iter(self._data.values())))
        if self._off >= n:
            return None
        end = min(self._off + self.rows_per_transfer, n)
        out = {k: v[self._off:end] for k, v in self._data.items()}
        self._off = end
        return out

    def transfer_data(self) -> dict[str, dict]:
        chunk = self._next_chunk()
        if chunk is None:
            self.exhausted = True
            return {}
        if self.rewrite_time and "time_" in chunk:
            n = len(chunk["time_"])
            # Preserve intra-chunk ordering offsets, anchor at arrival time.
            t = np.asarray(chunk["time_"], dtype=np.int64)
            base = t[0] if n else 0
            chunk = dict(chunk)
            chunk["time_"] = now_ns() + (t - base)
        self.rows_replayed += len(next(iter(chunk.values()))) if chunk else 0
        return {self.table: chunk}
