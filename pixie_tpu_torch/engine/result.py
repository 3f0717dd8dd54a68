"""Query results: host-side columnar output with attached dictionaries."""
from __future__ import annotations

import dataclasses

import numpy as np

from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.types import Relation


@dataclasses.dataclass
class QueryResult:
    """One sink's output (reference: rows streamed via
    carnotpb TransferResultChunk → vizierpb RowBatchData)."""

    name: str
    relation: Relation
    columns: dict[str, np.ndarray]
    dictionaries: dict[str, Dictionary]
    exec_stats: dict = dataclasses.field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        for v in self.columns.values():
            return len(v)
        return 0

    def decoded(self, name: str):
        """Column as python values (strings decoded)."""
        arr = self.columns[name]
        d = self.dictionaries.get(name)
        if d is not None:
            return d.decode(arr)
        return arr.tolist()

    def to_records(self) -> list[dict]:
        names = self.relation.names()
        cols = {n: self.decoded(n) for n in names}
        return [{n: cols[n][i] for n in names} for i in range(self.num_rows)]

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({n: self.decoded(n) for n in self.relation.names()})

    def __repr__(self):
        return f"QueryResult({self.name!r}, rows={self.num_rows}, cols={self.relation.names()})"
