"""Plan inspection: pretty-printer + exec-stats rendering.

The reference ships a CLI REPL for compiled plans (src/carnot/plandebugger/)
and per-operator ExecNodeStats surfaced in analyze mode (exec_node.h:41,
carnot.cc:318-349).  Our engine compiles whole chains into single kernels, so
the honest stat grain is per-kernel (chain) and per-blocking-op; `explain`
renders the logical DAG, `render_stats` renders what actually ran.
"""
from __future__ import annotations

from pixie_tpu_torch.plan.plan import (
    AggOp,
    Call,
    Column,
    Expr,
    FilterOp,
    JoinOp,
    LimitOp,
    MapOp,
    MemorySinkOp,
    MemorySourceOp,
    Plan,
    Literal,
    RemoteSourceOp,
    ResultSinkOp,
    UnionOp,
)

_INFIX = {
    "add": "+", "subtract": "-", "multiply": "*", "divide": "/",
    "equal": "==", "not_equal": "!=", "less": "<", "less_equal": "<=",
    "greater": ">", "greater_equal": ">=", "logical_and": "and",
    "logical_or": "or", "modulo": "%", "floordiv": "//",
}


def expr_str(e: Expr) -> str:
    if isinstance(e, Column):
        return e.name
    if isinstance(e, Literal):
        return repr(e.value)
    if isinstance(e, Call):
        if e.fn in _INFIX and len(e.args) == 2:
            return f"({expr_str(e.args[0])} {_INFIX[e.fn]} {expr_str(e.args[1])})"
        return f"{e.fn}({', '.join(expr_str(a) for a in e.args)})"
    return repr(e)


def _op_desc(op) -> str:
    if isinstance(op, MemorySourceOp):
        parts = [f"table={op.table}"]
        if op.columns is not None:
            parts.append(f"cols={op.columns}")
        if op.start_time is not None or op.stop_time is not None:
            parts.append(f"time=[{op.start_time}, {op.stop_time})")
        if op.streaming:
            parts.append("streaming")
        return "MemorySource " + " ".join(parts)
    if isinstance(op, MapOp):
        inner = ", ".join(f"{n}={expr_str(e)}" for n, e in op.exprs)
        if len(inner) > 120:
            inner = inner[:117] + "..."
        return f"Map {inner}"
    if isinstance(op, FilterOp):
        return f"Filter {expr_str(op.expr)}"
    if isinstance(op, AggOp):
        vals = ", ".join(
            f"{v.out_name}={v.fn}({v.arg or ''})" for v in op.values
        )
        flags = "".join(
            f" [{f}]" for f in ("windowed", "partial", "finalize")
            if getattr(op, f)
        )
        return f"Agg by={op.groups} {vals}{flags}"
    if isinstance(op, LimitOp):
        return f"Limit {op.n}"
    if isinstance(op, JoinOp):
        return f"Join {op.how} on {list(zip(op.left_on, op.right_on))}"
    if isinstance(op, UnionOp):
        return "Union"
    if isinstance(op, MemorySinkOp):
        return f"MemorySink {op.name!r}"
    if isinstance(op, ResultSinkOp):
        return f"ResultSink channel={op.channel} payload={op.payload}"
    if isinstance(op, RemoteSourceOp):
        return f"RemoteSource channel={op.channel}"
    return type(op).__name__


def explain(plan: Plan) -> str:
    """Render the plan DAG bottom-up (sinks last), one line per operator.

    Operators are listed in topological order with explicit parent ids, which
    renders shared subtrees (DAGs) without duplication.
    """
    lines = []
    for op in plan.topo_sorted():
        pids = [p.id for p in plan.parents(op)]
        src = f" <- {pids}" if pids else ""
        lines.append(f"[{op.id:>3}] {_op_desc(op)}{src}")
    return "\n".join(lines)


def render_stats(exec_stats: dict) -> str:
    """Human-readable table of the per-kernel/per-op stats an executor
    recorded (exec_stats['operators'])."""
    ops = exec_stats.get("operators", [])
    lines = [
        f"{'what':<48} {'rows_out':>12} {'self_ms':>10} {'total_ms':>10}"
    ]
    for rec in ops:
        lines.append(
            f"{rec['label'][:48]:<48} {rec.get('rows_out', 0):>12} "
            f"{rec.get('self_ns', 0) / 1e6:>10.2f} {rec.get('wall_ns', 0) / 1e6:>10.2f}"
        )
    for key in ("rows_scanned", "rows_output", "batches", "compile_s"):
        if key in exec_stats:
            lines.append(f"{key}: {exec_stats[key]}")
    return "\n".join(lines)
