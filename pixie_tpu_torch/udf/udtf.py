"""UDTF framework: table-generating functions (cluster introspection).

Reference: src/carnot/udf/udtf.h (UDTF base: Init/NextRecord with a declared
output relation + executor scope) and the vizier metadata UDTFs
(src/vizier/funcs/md_udtfs/md_udtfs_impl.h) behind px.GetAgentStatus,
px.GetTables, px.GetSchemas, px.GetUDFList, ...

A UDTF is a host function producing one COLUMNAR batch (dict of arrays) —
there is no row-at-a-time NextRecord loop to feed a vectorized engine.
Scope mirrors the reference's executor hint: "merger" (ONE_KELVIN analog —
runs once, broker-side) or "all_agents" (fans out, rows union; not yet used
by the builtin set).  The executor turns the batch into a HostBatch
(PlanExecutor._run_udtf); no UDTF touches the card.

Copied from the reference package (pixie_tpu/udf/udtf.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from pixie_tpu_torch.types import DataType as DT, Relation


@dataclasses.dataclass
class UDTFContext:
    """Ambient state a UDTF reads (injected by the executing service)."""

    table_store: object = None
    registry: object = None
    #: services.registry.AgentRegistry when running under a broker;
    #: None for library/local execution.
    agent_registry: object = None
    #: static schema catalog fallback when no live agents ship schemas
    schema_catalog: Optional[dict] = None
    #: services.tracepoints.TracepointManager when dynamic tracing is wired
    tracepoint_manager: object = None
    asid: int = 0
    node_name: str = ""


@dataclasses.dataclass(frozen=True)
class UDTF:
    name: str
    relation: Relation
    fn: Callable  # fn(ctx: UDTFContext, **args) -> dict[col, sequence]
    scope: str = "merger"  # merger | all_agents


# ------------------------------------------------------------------- builtins


def _schema_map(ctx: UDTFContext) -> dict[str, Relation]:
    out: dict[str, Relation] = {}
    if ctx.agent_registry is not None:
        out.update(ctx.agent_registry.combined_schemas())
    if ctx.table_store is not None:
        out.update(ctx.table_store.schemas())
    if not out and ctx.schema_catalog:
        out.update(ctx.schema_catalog)
    return out


def _get_tables(ctx: UDTFContext) -> dict:
    names = sorted(_schema_map(ctx))
    return {"table_name": names, "table_desc": ["" for _ in names]}


def _get_schemas(ctx: UDTFContext) -> dict:
    rows = {"table_name": [], "column_name": [], "column_type": [],
            "pattern_type": [], "column_desc": []}
    for t, rel in sorted(_schema_map(ctx).items()):
        for c in rel:
            rows["table_name"].append(t)
            rows["column_name"].append(c.name)
            rows["column_type"].append(c.data_type.name)
            rows["pattern_type"].append("GENERAL")
            rows["column_desc"].append(c.desc)
    return rows


def _get_agent_status(ctx: UDTFContext) -> dict:
    rows = {"agent_id": [], "asid": [], "hostname": [], "ip_address": [],
            "agent_state": [], "create_time": [], "last_heartbeat_ns": []}
    if ctx.agent_registry is not None:
        import time

        now = time.monotonic()
        for r in ctx.agent_registry.all_agents():
            rows["agent_id"].append((0, r.asid))
            rows["asid"].append(r.asid)
            rows["hostname"].append(r.name)
            rows["ip_address"].append("")
            rows["agent_state"].append(
                "AGENT_STATE_HEALTHY" if r.alive else "AGENT_STATE_UNRESPONSIVE"
            )
            rows["create_time"].append(0)
            rows["last_heartbeat_ns"].append(
                int((now - r.last_heartbeat) * 1e9) if r.alive else -1
            )
    else:
        # library/local mode: this process is the single "agent"
        rows["agent_id"].append((0, ctx.asid))
        rows["asid"].append(ctx.asid)
        rows["hostname"].append(ctx.node_name or "localhost")
        rows["ip_address"].append("127.0.0.1")
        rows["agent_state"].append("AGENT_STATE_HEALTHY")
        rows["create_time"].append(0)
        rows["last_heartbeat_ns"].append(0)
    return rows


def _fmt_args(arg_types) -> str:
    return ",".join(t.name for t in arg_types)


def _get_udf_list(ctx: UDTFContext) -> dict:
    rows = {"name": [], "return_type": [], "args": []}
    reg = ctx.registry
    if reg is not None:
        for name, o in reg.scalar_overloads():
            rows["name"].append(name)
            rows["return_type"].append(o.out_type.name)
            rows["args"].append(_fmt_args(o.arg_types))
    return rows


def _get_uda_list(ctx: UDTFContext) -> dict:
    rows = {"name": [], "return_type": [], "args": []}
    reg = ctx.registry
    if reg is not None:
        for name in reg.uda_names():
            uda = reg.uda(name)
            out = uda.out_type(DT.FLOAT64)
            rows["name"].append(name)
            rows["return_type"].append(out.name if out else "FLOAT64")
            rows["args"].append("" if uda.nullary else "FLOAT64")
    return rows


def _get_udtf_list(ctx: UDTFContext) -> dict:
    rows = {"name": [], "executor": [], "init_args": [], "output_relation": []}
    reg = ctx.registry
    if reg is not None:
        for u in reg.udtfs():
            rows["name"].append(u.name)
            rows["executor"].append(u.scope)
            rows["init_args"].append("")
            rows["output_relation"].append(
                ",".join(f"{c.name}:{c.data_type.name}" for c in u.relation)
            )
    return rows


def _get_debug_table_info(ctx: UDTFContext) -> dict:
    rows = {"asid": [], "name": [], "id": [], "batches_added": [],
            "num_batches": [], "size": [], "min_time": []}
    if ctx.table_store is not None:
        for st in ctx.table_store.stats():
            rows["asid"].append(ctx.asid)
            rows["name"].append(st["name"])
            rows["id"].append(0)
            rows["batches_added"].append(st["batches"] + st["expired_batches"])
            rows["num_batches"].append(st["batches"])
            rows["size"].append(st["bytes"])
            rows["min_time"].append(0)
    return rows


def _get_tracepoint_status(ctx: UDTFContext) -> dict:
    rows = {"tracepoint_id": [], "name": [], "state": [], "status": [],
            "output_tables": [], "create_time": []}
    mgr = ctx.tracepoint_manager
    if mgr is not None:
        for i, tp in enumerate(mgr.list()):
            rows["tracepoint_id"].append((0, i))
            rows["name"].append(tp.name)
            rows["state"].append(tp.state)
            rows["status"].append(tp.status)
            rows["output_tables"].append(tp.table_name)
            rows["create_time"].append(tp.created_ns)
    return rows


def register_builtin_udtfs(registry) -> None:
    """Install the introspection UDTF set (reference md_udtfs_impl.h relations,
    cited by line in SURVEY-visible comments above)."""
    S, I, T, U = DT.STRING, DT.INT64, DT.TIME64NS, DT.UINT128
    for u in [
        UDTF("GetTables",
             Relation.of(("table_name", S), ("table_desc", S)), _get_tables),
        UDTF("GetSchemas",
             Relation.of(("table_name", S), ("column_name", S),
                         ("column_type", S), ("pattern_type", S),
                         ("column_desc", S)), _get_schemas),
        UDTF("GetAgentStatus",
             Relation.of(("agent_id", U), ("asid", I), ("hostname", S),
                         ("ip_address", S), ("agent_state", S),
                         ("create_time", T), ("last_heartbeat_ns", I)),
             _get_agent_status),
        UDTF("GetUDFList",
             Relation.of(("name", S), ("return_type", S), ("args", S)),
             _get_udf_list),
        UDTF("GetUDAList",
             Relation.of(("name", S), ("return_type", S), ("args", S)),
             _get_uda_list),
        UDTF("GetUDTFList",
             Relation.of(("name", S), ("executor", S), ("init_args", S),
                         ("output_relation", S)), _get_udtf_list),
        UDTF("GetDebugTableInfo",
             Relation.of(("asid", I), ("name", S), ("id", I),
                         ("batches_added", I), ("num_batches", I),
                         ("size", I), ("min_time", T)), _get_debug_table_info),
        # reference md_udtfs_impl.h:726 GetTracepointStatus
        UDTF("GetTracepointStatus",
             Relation.of(("tracepoint_id", U), ("name", S), ("state", S),
                         ("status", S), ("output_tables", S),
                         ("create_time", T)), _get_tracepoint_status),
    ]:
        registry.register_udtf(u)
