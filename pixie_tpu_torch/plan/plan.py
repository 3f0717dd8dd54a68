"""Physical plan schema — the planpb equivalent (reference src/carnot/planpb/plan.proto
and src/carnot/plan/).

A Plan is a DAG of operators (reference dag/dag.h:44); expressions are small
immutable trees (reference plan/scalar_expression.h).  Plans serialize to plain
dicts (JSON) for the control plane; there is no protobuf dependency in the hot
path because plans are compiled, not interpreted.

Key departure from the reference: operators do not carry execution logic — the
engine lowers a whole fragment chain into one chain kernel (see
pixie_tpu_torch.engine.executor), so these classes are pure schema.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from pixie_tpu_torch.status import InvalidArgument
from pixie_tpu_torch.types import DataType

# ------------------------------------------------------------------ expressions


@dataclasses.dataclass(frozen=True)
class Expr:
    def to_dict(self) -> dict:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Column(Expr):
    name: str

    def to_dict(self):
        return {"k": "col", "name": self.name}


@dataclasses.dataclass(frozen=True)
class Literal(Expr):
    value: object
    dtype: DataType

    def to_dict(self):
        return {"k": "lit", "v": self.value, "t": int(self.dtype)}


@dataclasses.dataclass(frozen=True)
class Call(Expr):
    fn: str
    args: tuple[Expr, ...]

    def to_dict(self):
        return {"k": "call", "fn": self.fn, "args": [a.to_dict() for a in self.args]}


def lit(v) -> Literal:
    """Infer a Literal from a python value."""
    if isinstance(v, Expr):
        return v
    if isinstance(v, bool):
        return Literal(v, DataType.BOOLEAN)
    if isinstance(v, int):
        return Literal(v, DataType.INT64)
    if isinstance(v, float):
        return Literal(v, DataType.FLOAT64)
    if isinstance(v, str):
        return Literal(v, DataType.STRING)
    raise InvalidArgument(f"cannot infer literal type of {v!r}")


def expr_from_dict(d: dict) -> Expr:
    k = d["k"]
    if k == "col":
        return Column(d["name"])
    if k == "lit":
        return Literal(d["v"], DataType(d["t"]))
    if k == "call":
        return Call(d["fn"], tuple(expr_from_dict(a) for a in d["args"]))
    raise InvalidArgument(f"bad expr kind {k}")


# ------------------------------------------------------------------- operators


@dataclasses.dataclass
class Operator:
    id: int = -1

    @property
    def kind(self) -> str:
        return type(self).__name__.removesuffix("Op").lower()

    def to_dict(self) -> dict:
        d = {"op": self.kind, "id": self.id}
        d.update(self._fields())
        return d

    def _fields(self) -> dict:
        return {}


@dataclasses.dataclass
class MemorySourceOp(Operator):
    """Scan a table-store cursor (reference exec/memory_source_node.cc:105).

    since_row_id/stop_row_id bound the scan to a row-id range — the streaming
    executor's resume token (reference: the cursor's persistent position for
    `streaming` sources, table.h:76-124)."""

    table: str = ""
    columns: Optional[list[str]] = None  # None = all
    start_time: Optional[int] = None
    stop_time: Optional[int] = None
    streaming: bool = False
    since_row_id: Optional[int] = None
    stop_row_id: Optional[int] = None
    #: tablet id for tabletized tables (reference planpb
    #: MemorySourceOperator.Tablet, plan.proto:149-168)
    tablet: Optional[str] = None

    def _fields(self):
        return {
            "table": self.table,
            "columns": self.columns,
            "start_time": self.start_time,
            "stop_time": self.stop_time,
            "streaming": self.streaming,
            "since_row_id": self.since_row_id,
            "stop_row_id": self.stop_row_id,
            "tablet": self.tablet,
        }


@dataclasses.dataclass
class UDTFSourceOp(Operator):
    """Table-generating-function source (reference exec/udtf_source_node.*,
    udf/udtf.h).  `schema` serializes the declared output relation so remote
    executors don't need the UDTF registered locally to type-check."""

    name: str = ""
    args: dict = dataclasses.field(default_factory=dict)
    schema: Optional[list] = None

    def _fields(self):
        return {"name": self.name, "args": self.args, "schema": self.schema}


@dataclasses.dataclass
class MapOp(Operator):
    """Projection + computed columns. exprs defines the FULL output column list
    (reference planpb MapOperator semantics)."""

    exprs: list[tuple[str, Expr]] = dataclasses.field(default_factory=list)

    def _fields(self):
        return {"exprs": [(n, e.to_dict()) for n, e in self.exprs]}


@dataclasses.dataclass
class FilterOp(Operator):
    expr: Expr = None

    def _fields(self):
        return {"expr": self.expr.to_dict()}


@dataclasses.dataclass(frozen=True)
class AggExpr:
    out_name: str
    fn: str  # UDA name
    arg: Optional[str]  # input column; None for nullary (count)


@dataclasses.dataclass
class AggOp:
    """Group-by aggregate (reference exec/agg_node.h:66, planpb/plan.proto:239-257).

    partial/finalize flags mirror the reference's split for distributed partial
    aggregation; in the device engine `partial` means "emit device state", and
    `finalize` means "merge states via a collective, then finalize".
    """

    id: int = -1
    groups: list[str] = dataclasses.field(default_factory=list)
    values: list[AggExpr] = dataclasses.field(default_factory=list)
    windowed: bool = False
    partial: bool = False
    finalize: bool = False

    kind = "agg"

    def to_dict(self):
        return {
            "op": "agg",
            "id": self.id,
            "groups": self.groups,
            "values": [dataclasses.astuple(v) for v in self.values],
            "windowed": self.windowed,
            "partial": self.partial,
            "finalize": self.finalize,
        }


@dataclasses.dataclass
class LimitOp(Operator):
    n: int = 0

    def _fields(self):
        return {"n": self.n}


@dataclasses.dataclass
class MemorySinkOp(Operator):
    """Terminal sink producing a client-visible result (reference
    exec/memory_sink_node.*)."""

    name: str = "output"
    columns: Optional[list[str]] = None

    def _fields(self):
        return {"name": self.name, "columns": self.columns}


@dataclasses.dataclass
class JoinOp(Operator):
    """Equijoin (reference exec/equijoin_node.*, planpb JoinOperator
    plan.proto:301-316). Parents: [left, right]; symmetric m:n expansion
    (engine.executor._run_join)."""

    how: str = "inner"  # inner | left | right | outer
    left_on: list[str] = dataclasses.field(default_factory=list)
    right_on: list[str] = dataclasses.field(default_factory=list)
    #: output columns as (side, col, out_name); side in {"left","right"}
    output: list[tuple[str, str, str]] = dataclasses.field(default_factory=list)

    def _fields(self):
        return {
            "how": self.how,
            "left_on": self.left_on,
            "right_on": self.right_on,
            "output": self.output,
        }


@dataclasses.dataclass
class UnionOp(Operator):
    """Concatenate parents with identical relations (reference exec/union_node.*)."""

    def _fields(self):
        return {}


@dataclasses.dataclass
class OTelExportSinkOp(Operator):
    """Export parent rows as OTLP metrics/spans (reference
    exec/otel_export_sink_node.*, planpb OTelExportSinkOperator
    plan.proto:358-490 — column NAMES here instead of indices).

    config = {
      "endpoint": {"url": str, "headers": {..}} | None (collect-only),
      "resource": {attr: {"column": name} | literal},
      "metrics": [{name, description?, unit?, time_column,
                   attributes: [{name, column}],
                   gauge: {"value_column": c} |
                   summary: {count_column, sum_column?,
                             quantiles: [{"q": f, "column": c}]}}],
      "spans": [{name | name_column, start_time_column, end_time_column,
                 trace_id_column?, span_id_column?, parent_span_id_column?,
                 attributes: [{name, column}]}],
    }"""

    config: dict = dataclasses.field(default_factory=dict)

    def _fields(self):
        return {"config": self.config}


@dataclasses.dataclass
class ResultSinkOp(Operator):
    """Terminal op on an agent plan shipping results to a remote consumer
    (reference exec/grpc_sink_node.* streaming TransferResultChunk).

    payload "rows": parent's row batches ship as-is.
    payload "agg_state": parent is AggOp(partial=True); the per-group UDA state
    ships value-keyed (group VALUES + state leaves), the TPU analog of the
    reference's serialized-UDA-string partial rows (planpb plan.proto:250-257).
    """

    channel: str = ""
    payload: str = "rows"

    def _fields(self):
        return {"channel": self.channel, "payload": self.payload}


@dataclasses.dataclass
class PartitionSinkOp(Operator):
    """Agent-plan sink hash-partitioning parent rows by key VALUE into
    n_parts bucket channels `{prefix}{p}` (the shuffle-edge producer half of
    a repartitioned join — reference splitter.h:114-155 GRPCSink shuffle).
    Each bucket ships as an ordinary rows channel."""

    prefix: str = ""
    keys: list[str] = dataclasses.field(default_factory=list)
    n_parts: int = 1

    def _fields(self):
        return {"prefix": self.prefix, "keys": list(self.keys),
                "n_parts": self.n_parts}


@dataclasses.dataclass
class RemoteSourceOp(Operator):
    """Source on a merger plan reading a channel fed by remote agents
    (reference exec/grpc_source_node.* + grpc_router.h demux)."""

    channel: str = ""
    #: relation of the incoming rows (serialized schema)
    schema: Optional[list] = None

    def _fields(self):
        return {"channel": self.channel, "schema": self.schema}


# ------------------------------------------------------------------------ plan


class Plan:
    """Operator DAG. Edges run parent → child (data flows parent to child)."""

    def __init__(self):
        self._ops: dict[int, Operator] = {}
        self._children: dict[int, list[int]] = {}
        self._parents: dict[int, list[int]] = {}
        self._next_id = itertools.count(0)

    def add(self, op, parents: list = ()) -> "Operator":
        op.id = next(self._next_id)
        self._ops[op.id] = op
        self._children[op.id] = []
        self._parents[op.id] = []
        for p in parents:
            pid = p.id if isinstance(p, (Operator, AggOp)) else int(p)
            self._children[pid].append(op.id)
            self._parents[op.id].append(pid)
        return op

    def op(self, opid: int):
        return self._ops[opid]

    def ops(self) -> list:
        return list(self._ops.values())

    def parents(self, op) -> list:
        return [self._ops[i] for i in self._parents[op.id]]

    def children(self, op) -> list:
        return [self._ops[i] for i in self._children[op.id]]

    def sources(self) -> list:
        return [o for i, o in self._ops.items() if not self._parents[i]]

    def sinks(self) -> list:
        return [o for i, o in self._ops.items() if not self._children[i]]

    def topo_sorted(self) -> list:
        """Kahn topological sort (reference dag/dag.h TopologicalSort)."""
        indeg = {i: len(p) for i, p in self._parents.items()}
        ready = sorted(i for i, d in indeg.items() if d == 0)
        out = []
        while ready:
            i = ready.pop(0)
            out.append(self._ops[i])
            for c in self._children[i]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
        if len(out) != len(self._ops):
            raise InvalidArgument("plan DAG has a cycle")
        return out

    def to_dict(self) -> dict:
        return {
            "ops": [o.to_dict() for o in self.topo_sorted()],
            "edges": [[p, c] for p, cs in self._children.items() for c in cs],
        }

    def explain(self) -> str:
        """Pretty-print the DAG (reference src/carnot/plandebugger/)."""
        from pixie_tpu_torch.plan.debug import explain

        return explain(self)

    @staticmethod
    def from_dict(d: dict) -> "Plan":
        p = Plan()
        byid = {}
        for od in d["ops"]:
            op = _op_from_dict(od)
            byid[od["id"]] = op
        # preserve original ids through re-add in topo order
        parents_of: dict[int, list[int]] = {}
        for pe, ce in d["edges"]:
            parents_of.setdefault(ce, []).append(pe)
        id_map = {}
        for od in d["ops"]:
            op = byid[od["id"]]
            ps = [id_map[x] for x in parents_of.get(od["id"], [])]
            p.add(op, parents=[p.op(i) for i in ps])
            id_map[od["id"]] = op.id
        return p


def _op_from_dict(d: dict):
    k = d["op"]
    if k == "memorysource":
        return MemorySourceOp(
            table=d["table"],
            columns=d["columns"],
            start_time=d["start_time"],
            stop_time=d["stop_time"],
            streaming=d.get("streaming", False),
            since_row_id=d.get("since_row_id"),
            stop_row_id=d.get("stop_row_id"),
            tablet=d.get("tablet"),
        )
    if k == "map":
        return MapOp(exprs=[(n, expr_from_dict(e)) for n, e in d["exprs"]])
    if k == "filter":
        return FilterOp(expr=expr_from_dict(d["expr"]))
    if k == "agg":
        return AggOp(
            groups=list(d["groups"]),
            values=[AggExpr(*v) for v in d["values"]],
            windowed=d.get("windowed", False),
            partial=d.get("partial", False),
            finalize=d.get("finalize", False),
        )
    if k == "limit":
        return LimitOp(n=d["n"])
    if k == "memorysink":
        return MemorySinkOp(name=d["name"], columns=d["columns"])
    if k == "join":
        return JoinOp(
            how=d["how"],
            left_on=d["left_on"],
            right_on=d["right_on"],
            output=[tuple(t) for t in d["output"]],
        )
    if k == "union":
        return UnionOp()
    if k == "udtfsource":
        return UDTFSourceOp(name=d["name"], args=dict(d["args"]), schema=d["schema"])
    if k == "otelexportsink":
        return OTelExportSinkOp(config=dict(d["config"]))
    if k == "resultsink":
        return ResultSinkOp(channel=d["channel"], payload=d["payload"])
    if k == "partitionsink":
        return PartitionSinkOp(prefix=d["prefix"], keys=list(d["keys"]),
                               n_parts=int(d["n_parts"]))
    if k == "remotesource":
        return RemoteSourceOp(channel=d["channel"], schema=d["schema"])
    raise InvalidArgument(f"unknown operator kind {k!r}")
