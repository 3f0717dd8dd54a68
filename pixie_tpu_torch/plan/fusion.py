"""Common-subplan fusion: merge several compiled plans into one, deduping
structurally identical operators.

Reference: MergeNodesRule (src/carnot/planner/compiler/optimizer/
optimizer.h:39) fuses shared subplans so multi-widget vis scripts execute
each shared scan/filter/agg ONCE.  Here the fusion is hash-consing over the
op DAG: an operator is shared when its serialized fields and its (already
fused) parents are identical.  Everything downstream is automatic — a single
PlanExecutor materializes each blocking op once (`_materialized`) and the
feed cache dedupes scan bytes, so fusing the plans IS the optimization.

Copied whole from the reference package (pixie_tpu/plan/fusion.py); query
batching (serving/batching.py) fuses its members' plans through
`merge_plans`.
"""
from __future__ import annotations

import copy
import json

from pixie_tpu_torch.plan.plan import (
    AggOp,
    FilterOp,
    JoinOp,
    LimitOp,
    MapOp,
    MemorySinkOp,
    MemorySourceOp,
    Plan,
    UnionOp,
)


def merge_plans(named: list) -> tuple[Plan, dict]:
    """[(prefix, Plan)] → (fused plan, {prefix: {orig sink: fused sink}}).

    Sinks are never deduped: each input plan keeps its own, renamed
    `{prefix}/{name}` so multi-func outputs stay addressable.
    """
    fused = Plan()
    canon: dict = {}
    sink_map: dict = {}
    for prefix, plan in named:
        local: dict = {}
        for op in plan.topo_sorted():
            parents = [local[p.id] for p in plan.parents(op)]
            if isinstance(op, MemorySinkOp):
                c = copy.copy(op)
                c.id = -1
                c.name = f"{prefix}/{op.name}" if prefix else op.name
                fused.add(c, parents=parents)
                local[op.id] = c
                sink_map.setdefault(prefix, {})[op.name] = c.name
                continue
            d = op.to_dict()
            d.pop("id", None)
            key = (json.dumps(d, sort_keys=True, default=str),
                   tuple(p.id for p in parents))
            got = canon.get(key)
            if got is None:
                c = copy.copy(op)
                c.id = -1
                fused.add(c, parents=parents)
                canon[key] = c
                got = c
            local[op.id] = got
    # scan merging re-parents downstream ops, so re-run hash-consing to
    # collapse the now-identical chains (filters over the merged scan)
    # before looking for sibling aggs
    fused = _dedup(_merge_pruned_scans(fused))
    return _merge_sibling_aggs(fused), sink_map


def _dedup(fused: Plan) -> Plan:
    """One hash-consing pass over a single plan (sinks preserved as-is)."""
    out = Plan()
    canon: dict = {}
    new_of: dict = {}
    for op in fused.topo_sorted():
        parents = [new_of[p.id] for p in fused.parents(op)]
        if isinstance(op, MemorySinkOp):
            c = copy.copy(op)
            c.id = -1
            out.add(c, parents=parents)
            new_of[op.id] = c
            continue
        d = op.to_dict()
        d.pop("id", None)
        key = (json.dumps(d, sort_keys=True, default=str),
               tuple(p.id for p in parents))
        got = canon.get(key)
        if got is None:
            c = copy.copy(op)
            c.id = -1
            out.add(c, parents=parents)
            canon[key] = c
            got = c
        new_of[op.id] = got
    return out


def _consumer_children(fused: Plan) -> dict:
    children: dict[int, list] = {}
    for op in fused.topo_sorted():
        for p in fused.parents(op):
            children.setdefault(p.id, []).append(op)
    return children


def _descendants_project(op, children: dict) -> bool:
    """True if every transitive consumer selects columns EXPLICITLY, so
    widening `op`'s output columns cannot leak into a full-schema consumer
    (a Union branch or columns-less sink would change shape/crash)."""
    stack = list(children.get(op.id, []))
    while stack:
        c = stack.pop()
        if isinstance(c, UnionOp):
            return False
        if isinstance(c, JoinOp) and not c.output:
            return False
        if isinstance(c, MemorySinkOp):
            if c.columns is None:
                return False
            continue  # sinks terminate the walk
        if isinstance(c, MapOp):
            continue  # explicit full output list: nothing leaks past it
        if isinstance(c, AggOp):
            # agg output is exactly groups + value out_names: extra INPUT
            # columns never reach its consumers, so the walk ends here.
            # (Sibling-AGG merging widens the agg's own output and checks
            # the agg's consumers separately — this guard is about ops
            # UPSTREAM of the agg, e.g. a widened shared scan.)
            continue
        if isinstance(c, (FilterOp, LimitOp, JoinOp)):
            stack.extend(children.get(c.id, []))
            continue
        return False  # unknown consumer: don't risk schema leaks
    return True


def _merge_pruned_scans(fused: Plan) -> Plan:
    """Merge MemorySourceOps identical except for per-plan column pruning,
    widening to the column UNION — guarded so the extra columns only flow
    into consumers that project explicitly."""
    children = _consumer_children(fused)
    groups: dict[str, list] = {}
    for op in fused.topo_sorted():
        if not isinstance(op, MemorySourceOp):
            continue
        d = op.to_dict()
        d.pop("id", None)
        d.pop("columns", None)
        groups.setdefault(json.dumps(d, sort_keys=True, default=str),
                          []).append(op)
    replace: dict[int, MemorySourceOp] = {}
    for ops in groups.values():
        if len(ops) < 2:
            continue
        if not all(_descendants_project(o, children) for o in ops):
            continue
        cols: list | None = []
        for o in ops:
            if o.columns is None:
                cols = None
                break
            cols.extend(c for c in o.columns if c not in cols)
        merged = copy.copy(ops[0])
        merged.columns = cols
        for o in ops:
            replace[o.id] = merged
    if not replace:
        return fused
    out = Plan()
    new_of: dict = {}
    added: dict = {}
    for op in fused.topo_sorted():
        parents = [new_of[p.id] for p in fused.parents(op)]
        m = replace.get(op.id)
        if m is not None:
            got = added.get(id(m))
            if got is None:
                c = copy.copy(m)
                c.id = -1
                out.add(c, parents=parents)
                added[id(m)] = c
                got = c
            new_of[op.id] = got
            continue
        c = copy.copy(op)
        c.id = -1
        out.add(c, parents=parents)
        new_of[op.id] = c
    return out


def _merge_sibling_aggs(fused: Plan) -> Plan:
    """Merge sibling AggOps sharing (parent, groups) into ONE multi-value
    aggregate — two widgets computing different aggregates of the same
    filtered scan then share a single device kernel pass (the deeper half of
    the reference's MergeNodesRule: hash-consing only dedups IDENTICAL ops;
    sibling aggs differ by value list yet still share all their input work).

    Conservative guards: non-windowed single-parent aggs only; value
    out_names must not collide with different (fn, arg); every descendant
    must project columns explicitly (Map/Filter/Limit/sinks-with-columns/
    joins-with-output), so the extra sibling columns never leak into a
    full-schema consumer.
    """
    children = _consumer_children(fused)

    def descendants_project(op) -> bool:
        return _descendants_project(op, children)

    sibs: dict[tuple, list] = {}
    for op in fused.topo_sorted():
        if not isinstance(op, AggOp) or op.windowed:
            continue
        ps = fused.parents(op)
        if len(ps) != 1:
            continue
        key = (ps[0].id, tuple(op.groups), op.partial, op.finalize)
        sibs.setdefault(key, []).append(op)

    replace: dict[int, AggOp] = {}
    for key, ops in sibs.items():
        if len(ops) < 2 or not all(descendants_project(o) for o in ops):
            continue
        seen: dict = {}
        vals = []
        ok = True
        for o in ops:
            for ae in o.values:
                prev = seen.get(ae.out_name)
                if prev is None:
                    seen[ae.out_name] = (ae.fn, ae.arg)
                    vals.append(ae)
                elif prev != (ae.fn, ae.arg):
                    ok = False  # same name, different aggregate: bail
                    break
            if not ok:
                break
        if not ok:
            continue
        merged = AggOp(groups=list(ops[0].groups), values=vals,
                       windowed=False, partial=ops[0].partial,
                       finalize=ops[0].finalize)
        for o in ops:
            replace[o.id] = merged
    if not replace:
        return fused

    out = Plan()
    new_of: dict = {}
    added: dict = {}
    for op in fused.topo_sorted():
        parents = [new_of[p.id] for p in fused.parents(op)]
        m = replace.get(op.id)
        if m is not None:
            got = added.get(id(m))
            if got is None:
                c = copy.copy(m)
                c.id = -1
                out.add(c, parents=parents)
                added[id(m)] = c
                got = c
            new_of[op.id] = got
            continue
        c = copy.copy(op)
        c.id = -1
        out.add(c, parents=parents)
        new_of[op.id] = c
    return out


def fuse_compiled(queries: list):
    """[(prefix, CompiledQuery)] → (fused plan, sink_map, mutations).

    Compile each vis func separately (each sees its own func args), then
    fuse — the shared prefixes (same table scan, same filters, often the
    same first aggregate) collapse.
    """
    muts = []
    for _prefix, q in queries:
        muts.extend(q.mutations or [])
    fused, sink_map = merge_plans([(p, q.plan) for p, q in queries])
    return fused, sink_map, muts
