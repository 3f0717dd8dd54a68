"""Type system.

Parity with the reference's 6 physical types and semantic-type annotations
(src/shared/types/typespb/types.proto:26-33,63-91).  The device twist is the
*storage class*: STRING and UINT128 columns are dictionary-encoded at ingest, so
their device representation is a dense int32 code tensor; the dictionary (unique
values) lives host-side.  All kernels therefore see only fixed-width numeric
tensors.

Physical type → host (numpy) / device (torch) representation:

  BOOLEAN   bool_      bool_
  INT64     int64      int64
  UINT128   int32 code into a dictionary of (hi, lo) uint64 pairs
  FLOAT64   float64    float64
  STRING    int32 code into a string dictionary
  TIME64NS  int64      int64 (nanoseconds since epoch)
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np


class DataType(enum.IntEnum):
    """Physical data types (reference types.proto:26-33)."""

    UNKNOWN = 0
    BOOLEAN = 1
    INT64 = 2
    UINT128 = 3
    FLOAT64 = 4
    STRING = 5
    TIME64NS = 6


class SemanticType(enum.IntEnum):
    """Semantic annotations (reference types.proto:63-91)."""

    ST_UNSPECIFIED = 0
    ST_NONE = 1
    ST_TIME_NS = 2
    ST_AGENT_UID = 100
    ST_ASID = 101
    ST_UPID = 200
    ST_SERVICE_NAME = 300
    ST_POD_NAME = 400
    ST_POD_PHASE = 401
    ST_POD_STATUS = 402
    ST_NODE_NAME = 500
    ST_CONTAINER_NAME = 600
    ST_CONTAINER_STATE = 601
    ST_CONTAINER_STATUS = 602
    ST_NAMESPACE_NAME = 700
    ST_BYTES = 800
    ST_PERCENT = 900
    ST_DURATION_NS = 901
    ST_THROUGHPUT_PER_NS = 902
    ST_THROUGHPUT_BYTES_PER_NS = 903
    ST_QUANTILES = 1000
    ST_DURATION_NS_QUANTILES = 1001
    ST_IP_ADDRESS = 1100
    ST_PORT = 1200
    ST_HTTP_REQ_METHOD = 1300
    ST_HTTP_RESP_STATUS = 1400
    ST_HTTP_RESP_MESSAGE = 1500
    ST_SCRIPT_REFERENCE = 3000


class PatternType(enum.IntEnum):
    """Data pattern annotations (reference types.proto PatternType)."""

    UNSPECIFIED = 0
    GENERAL = 100
    GENERAL_ENUM = 101
    STRUCTURED = 200
    METRIC_COUNTER = 300
    METRIC_GAUGE = 301


# Physical storage dtype of a column's *row* data (codes for dict-encoded types).
STORAGE_DTYPE = {
    DataType.BOOLEAN: np.dtype(np.bool_),
    DataType.INT64: np.dtype(np.int64),
    DataType.UINT128: np.dtype(np.int32),  # dictionary code
    DataType.FLOAT64: np.dtype(np.float64),
    DataType.STRING: np.dtype(np.int32),  # dictionary code
    DataType.TIME64NS: np.dtype(np.int64),
}

#: Types whose storage is a dictionary code.
DICT_ENCODED = frozenset({DataType.STRING, DataType.UINT128})

#: Types addable/comparable directly on device.
NUMERIC = frozenset({DataType.BOOLEAN, DataType.INT64, DataType.FLOAT64, DataType.TIME64NS})


def is_dict_encoded(dt: DataType) -> bool:
    return dt in DICT_ENCODED


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    name: str
    data_type: DataType
    semantic_type: SemanticType = SemanticType.ST_NONE
    desc: str = ""


class Relation:
    """Ordered column schema (reference src/table_store/schema/relation.h)."""

    def __init__(self, columns: list[ColumnSchema] | None = None):
        self._cols: list[ColumnSchema] = list(columns or [])
        self._by_name = {c.name: i for i, c in enumerate(self._cols)}
        if len(self._by_name) != len(self._cols):
            raise ValueError("duplicate column names in relation")

    @staticmethod
    def of(*cols: tuple) -> "Relation":
        """Relation.of(("time_", DataType.TIME64NS), ("name", DataType.STRING, ST.ST_POD_NAME))"""
        return Relation([ColumnSchema(*c) for c in cols])

    def __len__(self) -> int:
        return len(self._cols)

    def __iter__(self):
        return iter(self._cols)

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __eq__(self, other) -> bool:
        return isinstance(other, Relation) and self._cols == other._cols

    def names(self) -> list[str]:
        return [c.name for c in self._cols]

    def col(self, name: str) -> ColumnSchema:
        try:
            return self._cols[self._by_name[name]]
        except KeyError:
            raise KeyError(f"column {name!r} not in relation {self.names()}") from None

    def index(self, name: str) -> int:
        return self._by_name[name]

    def dtype(self, name: str) -> DataType:
        return self.col(name).data_type

    def add(self, col: ColumnSchema) -> "Relation":
        return Relation(self._cols + [col])

    def select(self, names: list[str]) -> "Relation":
        return Relation([self.col(n) for n in names])

    def __repr__(self) -> str:
        inner = ", ".join(f"{c.name}:{c.data_type.name}" for c in self._cols)
        return f"Relation[{inner}]"

    def to_dict(self) -> list[dict]:
        return [
            {"name": c.name, "type": int(c.data_type), "st": int(c.semantic_type)}
            for c in self._cols
        ]

    @staticmethod
    def from_dict(d: list[dict]) -> "Relation":
        return Relation(
            [ColumnSchema(e["name"], DataType(e["type"]), SemanticType(e.get("st", 1))) for e in d]
        )


@dataclasses.dataclass(frozen=True, order=True)
class UInt128:
    """128-bit value as (high, low) u64 pair (reference types.proto UInt128,
    src/shared/upid/upid.h). Used for UPIDs: high = ASID<<32 | PID, low = start-time."""

    high: int
    low: int

    @staticmethod
    def make_upid(asid: int, pid: int, start_time_ns: int) -> "UInt128":
        return UInt128((asid << 32) | (pid & 0xFFFFFFFF), start_time_ns)

    @property
    def asid(self) -> int:
        return (self.high >> 32) & 0xFFFFFFFF

    @property
    def pid(self) -> int:
        return self.high & 0xFFFFFFFF

    def __str__(self) -> str:
        return f"{self.asid}:{self.pid}:{self.low}"
