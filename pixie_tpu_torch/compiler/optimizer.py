"""Plan-level optimizer (reference src/carnot/planner/compiler/optimizer/:
MergeNodesRule, PruneUnusedColumnsRule, PruneUnusedOperatorsRule; plus the
analyzer's AddLimitToBatchResultSinkRule).

Trace-time DataFrame assignment produces one Map per assignment; these passes
make that free (copied from the reference package, pixie_tpu/compiler/optimizer.py):
  * fuse_maps      — collapse Map→Map chains by expression substitution
                     (the reference fuses at exec time; we fuse in the plan so
                     one chain kernel sees one projection).
  * prune_columns  — backward column-requirement analysis; narrows memory
                     sources (less host→device traffic) and map outputs.
  * inject_limit   — default row limit on un-limited, un-aggregated sinks.
"""
from __future__ import annotations

from typing import Optional

from pixie_tpu_torch.plan.plan import (
    AggOp,
    Call,
    Column,
    Expr,
    FilterOp,
    JoinOp,
    LimitOp,
    Literal,
    MapOp,
    MemorySinkOp,
    MemorySourceOp,
    Plan,
    UnionOp,
)
from pixie_tpu_torch.status import CompilerError


def _real_sinks(plan: Plan) -> list:
    """Terminal ops that actually OUTPUT something.  Rebuilding only from
    these drops dangling dead branches (a DataFrame built but never
    displayed/exported — the reference's PruneUnusedOperatorsRule)."""
    from pixie_tpu_torch.plan.plan import OTelExportSinkOp, ResultSinkOp

    out = [
        s for s in plan.sinks()
        if isinstance(s, (MemorySinkOp, ResultSinkOp, OTelExportSinkOp))
    ]
    if not out:
        raise CompilerError("plan has no output sink")
    return out


def _subst(e: Expr, env: dict[str, Expr]) -> Expr:
    if isinstance(e, Column):
        return env.get(e.name, e)
    if isinstance(e, Call):
        return Call(e.fn, tuple(_subst(a, env) for a in e.args))
    return e


def _cols_of(e: Expr, out: set):
    if isinstance(e, Column):
        out.add(e.name)
    elif isinstance(e, Call):
        for a in e.args:
            _cols_of(a, out)


def fuse_maps(plan: Plan) -> Plan:
    new = Plan()
    memo: dict[int, object] = {}

    def build(op):
        got = memo.get(op.id)
        if got is not None:
            return got
        parents = plan.parents(op)
        if isinstance(op, MapOp) and len(parents) == 1:
            exprs = list(op.exprs)
            parent = parents[0]
            while (
                isinstance(parent, MapOp)
                and len(plan.children(parent)) == 1
                and len(plan.parents(parent)) == 1
            ):
                env = dict(parent.exprs)
                exprs = [(n, _subst(e, env)) for n, e in exprs]
                parent = plan.parents(parent)[0]
            newop = MapOp(exprs=exprs)
            new.add(newop, parents=[build(parent)])
        else:
            newop = _clone(op)
            new.add(newop, parents=[build(p) for p in parents])
        memo[op.id] = newop
        return newop

    for sink in _real_sinks(plan):
        build(sink)
    return new


def _clone(op):
    import copy

    c = copy.copy(op)
    c.id = -1
    if isinstance(op, MapOp):
        c.exprs = list(op.exprs)
    elif isinstance(op, AggOp):
        c.groups = list(op.groups)
        c.values = list(op.values)
    elif isinstance(op, JoinOp):
        c.left_on = list(op.left_on)
        c.right_on = list(op.right_on)
        c.output = list(op.output)
    elif isinstance(op, MemorySourceOp):
        c.columns = list(op.columns) if op.columns is not None else None
    elif isinstance(op, MemorySinkOp):
        c.columns = list(op.columns) if op.columns is not None else None
    return c


def prune_columns(plan: Plan) -> Plan:
    """Backward pass computing, for every op, the set of output columns any
    consumer actually reads; then rebuild with narrowed sources/maps.
    None = all columns required."""
    need: dict[int, Optional[set]] = {}

    def merge(opid: int, req: Optional[set]):
        cur = need.get(opid, set())
        if req is None or cur is None:
            need[opid] = None
        else:
            need[opid] = cur | req

    # Requirements flow only from REACHABLE ops — a dead branch (dropped by
    # the _real_sinks rebuild) must not widen upstream sources.
    reachable: set[int] = set()
    stack = list(_real_sinks(plan))
    while stack:
        op = stack.pop()
        if op.id in reachable:
            continue
        reachable.add(op.id)
        stack.extend(plan.parents(op))

    order = plan.topo_sorted()
    for op in reversed(order):
        if op.id not in reachable:
            continue
        my_need = need.get(op.id, set())
        parents = plan.parents(op)
        if isinstance(op, MemorySinkOp):
            req = set(op.columns) if op.columns is not None else None
            merge(parents[0].id, req)
        elif isinstance(op, MapOp):
            kept = op.exprs if my_need is None else [(n, e) for n, e in op.exprs if n in my_need]
            # Nothing required (e.g. a nullary-count agg downstream): keep one
            # column anyway so batches have a length — and REGISTER its inputs
            # upstream, or the rebuild fallback would reference pruned columns.
            if not kept:
                kept = op.exprs[:1]
            req: set = set()
            for _, e in kept:
                _cols_of(e, req)
            merge(parents[0].id, req)
        elif isinstance(op, FilterOp):
            req = None if my_need is None else set(my_need)
            if req is not None:
                _cols_of(op.expr, req)
            merge(parents[0].id, req)
        elif isinstance(op, LimitOp):
            merge(parents[0].id, my_need if my_need is None else set(my_need))
        elif isinstance(op, AggOp):
            req = set(op.groups) | {v.arg for v in op.values if v.arg}
            merge(parents[0].id, req)
        elif isinstance(op, JoinOp):
            kept = (
                op.output
                if my_need is None
                else [t for t in op.output if t[2] in my_need]
            )
            if not kept:
                kept = op.output[:1]
            lreq = {c for s, c, _ in kept if s == "left"} | set(op.left_on)
            rreq = {c for s, c, _ in kept if s == "right"} | set(op.right_on)
            merge(parents[0].id, lreq)
            merge(parents[1].id, rreq)
        elif isinstance(op, UnionOp):
            for p in parents:
                merge(p.id, my_need if my_need is None else set(my_need))
        elif isinstance(op, MemorySourceOp):
            pass
        else:
            for p in parents:
                merge(p.id, None)

    new = Plan()
    memo: dict[int, object] = {}

    def build(op):
        got = memo.get(op.id)
        if got is not None:
            return got
        my_need = need.get(op.id, set())
        c = _clone(op)
        if isinstance(c, MemorySourceOp) and my_need is not None and c.columns:
            cols = [n for n in c.columns if n in my_need]
            if not cols:
                cols = c.columns[:1]  # keep one column so batches have a length
            c.columns = cols
        elif isinstance(c, MapOp) and my_need is not None:
            kept = [(n, e) for n, e in c.exprs if n in my_need]
            c.exprs = kept if kept else c.exprs[:1]
        elif isinstance(c, JoinOp) and my_need is not None:
            kept = [t for t in c.output if t[2] in my_need]
            c.output = kept if kept else c.output[:1]
        new.add(c, parents=[build(p) for p in plan.parents(op)])
        memo[op.id] = c
        return c

    for sink in _real_sinks(plan):
        build(sink)
    return new


def inject_limit(plan: Plan, default_limit: int) -> Plan:
    """Add LimitOp(default_limit) above sinks whose streaming transform chain
    contains no limit (reference AddLimitToBatchResultSinkRule)."""
    new = Plan()
    memo: dict[int, object] = {}

    def build(op):
        got = memo.get(op.id)
        if got is not None:
            return got
        c = _clone(op)
        new.add(c, parents=[build(p) for p in plan.parents(op)])
        memo[op.id] = c
        return c

    for sink in _real_sinks(plan):
        if not isinstance(sink, MemorySinkOp):
            build(sink)
            continue
        cur = plan.parents(sink)[0]
        has_limit = False
        probe = cur
        while isinstance(probe, (MapOp, FilterOp, LimitOp)):
            if isinstance(probe, LimitOp):
                has_limit = True
                break
            probe = plan.parents(probe)[0]
        parent_new = build(cur)
        if not has_limit and isinstance(probe, MemorySourceOp) and not probe.streaming:
            lim = LimitOp(n=default_limit)
            new.add(lim, parents=[parent_new])
            parent_new = lim
        s = _clone(sink)
        new.add(s, parents=[parent_new])
        memo[sink.id] = s
    return new


def optimize(plan: Plan, default_limit: Optional[int] = None) -> Plan:
    p = fuse_maps(plan)
    p = prune_columns(p)
    if default_limit is not None:
        p = inject_limit(p, default_limit)
    return p
