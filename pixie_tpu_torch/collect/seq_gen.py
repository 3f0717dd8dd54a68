"""Deterministic sequence-generator connector — the test/bench workhorse.

Reference: src/stirling/source_connectors/seq_gen/seq_gen_connector.h:36 — two
tables of functional sequences (linear, modulo, quadratic, fibonacci) used to
test the collector runtime end-to-end without real tracing.

Copied from the reference package (pixie_tpu/collect/seq_gen.py).
"""
from __future__ import annotations

import numpy as np

from pixie_tpu_torch.collect.core import SourceConnector, TableSpec, now_ns
from pixie_tpu_torch.types import DataType as DT, Relation


class SeqGenConnector(SourceConnector):
    """Emits `rows_per_transfer` rows of deterministic sequences per tick.

    seq0: time_, x (linear), xmod10, xsquared
    seq1: time_, fib
    """

    name = "seq_gen"

    def __init__(self, rows_per_transfer: int = 1024, sample_period_s: float = 0.1,
                 total_rows: int | None = None):
        self.rows_per_transfer = rows_per_transfer
        self.sample_period_s = sample_period_s
        self.total_rows = total_rows
        self._x = 0
        self._fib = (0, 1)

    def tables(self) -> list[TableSpec]:
        return [
            TableSpec(
                "seq0",
                Relation.of(
                    ("time_", DT.TIME64NS), ("x", DT.INT64),
                    ("xmod10", DT.INT64), ("xsquared", DT.INT64),
                ),
                sample_period_s=self.sample_period_s,
            ),
            TableSpec(
                "seq1",
                Relation.of(("time_", DT.TIME64NS), ("fib", DT.INT64)),
                sample_period_s=self.sample_period_s,
            ),
        ]

    def transfer_data(self) -> dict[str, dict]:
        n = self.rows_per_transfer
        if self.total_rows is not None:
            n = min(n, self.total_rows - self._x)
            if n <= 0:
                self.exhausted = True
                return {}
        x = np.arange(self._x, self._x + n, dtype=np.int64)
        self._x += n
        if self.total_rows is not None and self._x >= self.total_rows:
            self.exhausted = True
        fibs = np.empty(n, dtype=np.int64)
        a, b = self._fib
        for i in range(n):
            fibs[i] = a
            a, b = b, (a + b) % (1 << 62)
        self._fib = (a, b)
        t = np.full(n, now_ns(), dtype=np.int64) + np.arange(n, dtype=np.int64)
        return {
            "seq0": {"time_": t, "x": x, "xmod10": x % 10, "xsquared": x * x},
            "seq1": {"time_": t, "fib": fibs},
        }
