"""Semantic-type propagation through plans.

Reference: semantic types (src/shared/types/typespb/types.proto:63-91) ride
column schemas end-to-end and drive client/vis formatting (duration columns
render as '2.3ms', bytes as '1.2MB', pod names link to entities).  The
reference resolves STs during compilation (SemanticRuleBatch); here the
analysis is a PLAN walk at execution time — the plan plus the source
schemas fully determine output STs, so kernels never carry them.

Rules:
  * sources: the table/UDTF/remote-channel relation's declared STs
  * Map: Column refs inherit; Calls take the UDF's declared `out_st`, or the
    first ST-typed argument's ST when `st_preserve` (bin over time is time)
  * Filter/Limit: pass-through
  * Agg: group keys inherit; values take the UDA's `out_st` or the input's
    ST when `st_preserve` (p50 of durations is a duration)
  * Join: each output takes its side's ST; Union: first parent's

Copied from the reference package (pixie_tpu/engine/semantics.py).  The
executor stamps every sink's relation (`sink_relation`); LocalCluster and
the stream queries restamp results whose plans read channels.
"""
from __future__ import annotations

from typing import Optional

from pixie_tpu_torch.plan.plan import (
    AggOp,
    Call,
    Column,
    FilterOp,
    JoinOp,
    LimitOp,
    Literal,
    MapOp,
    MemorySourceOp,
    RemoteSourceOp,
    UDTFSourceOp,
    UnionOp,
)
from pixie_tpu_torch.types import Relation, SemanticType as ST

_NONE = ST.ST_NONE


def _expr_dt(expr, dtenv: dict, registry):
    """Physical dtype of an expression, or None when unresolvable — used to
    pick the same scalar overload the executor will run."""
    if isinstance(expr, Column):
        return dtenv.get(expr.name)
    if isinstance(expr, Literal):
        return expr.dtype
    if isinstance(expr, Call):
        argdts = [_expr_dt(a, dtenv, registry) for a in expr.args]
        if any(d is None for d in argdts):
            return None
        try:
            return registry.scalar(expr.fn, argdts).out_type
        except Exception:
            return None
    return None


def _call_st(expr: Call, env: dict, dtenv: dict, registry) -> ST:
    try:
        overloads = registry._scalar.get(expr.fn) or []
    except AttributeError:  # registry without scalar table
        overloads = []
    if not overloads:
        return _NONE
    # Resolve the overload by the call's argument dtypes — overloads of one
    # name may declare different out_st/st_preserve, and the first-listed one
    # is not necessarily the one the executor dispatches.
    udf = None
    argdts = [_expr_dt(a, dtenv, registry) for a in expr.args]
    if all(d is not None for d in argdts):
        try:
            udf = registry.scalar(expr.fn, argdts)
        except Exception:
            udf = None
    if udf is None:
        # dtypes unresolvable here: the ST metadata is only trustworthy when
        # every overload agrees on it.
        if len({(o.out_st, o.st_preserve) for o in overloads}) != 1:
            return _NONE
        udf = overloads[0]
    if udf.out_st is not None:
        return udf.out_st
    if udf.st_preserve:
        for a in expr.args:
            st = _expr_st(a, env, dtenv, registry)
            if st != _NONE:
                return st
    return _NONE


def _expr_st(expr, env: dict, dtenv: dict, registry) -> ST:
    if isinstance(expr, Column):
        return env.get(expr.name, _NONE)
    if isinstance(expr, Call):
        return _call_st(expr, env, dtenv, registry)
    return _NONE


def semantic_types(plan, op, store, registry, memo: Optional[dict] = None
                   ) -> dict:
    """{column: SemanticType} of `op`'s output."""
    return _type_envs(plan, op, store, registry,
                      memo if memo is not None else {})[0]


def _type_envs(plan, op, store, registry, memo: dict) -> tuple[dict, dict]:
    """(semantic-type env, physical-dtype env) of `op`'s output.  The dtype
    env exists so Call STs resolve the overload the executor dispatches."""
    got = memo.get(op.id)
    if got is not None:
        return got
    out: dict = {}
    dts: dict = {}
    if isinstance(op, MemorySourceOp):
        try:
            rel = store.table(op.table).relation
        except Exception:
            rel = None
        if rel is not None:
            cols = op.columns or rel.names()
            out = {c.name: c.semantic_type for c in rel if c.name in cols}
            dts = {c.name: c.data_type for c in rel if c.name in cols}
    elif isinstance(op, (UDTFSourceOp, RemoteSourceOp)):
        rel = None
        if op.schema is not None:
            rel = Relation.from_dict(op.schema)
        elif isinstance(op, UDTFSourceOp):
            try:
                rel = registry.udtf(op.name).relation
            except Exception:
                rel = None
        if rel is not None:
            out = {c.name: c.semantic_type for c in rel}
            dts = {c.name: c.data_type for c in rel}
    elif isinstance(op, MapOp):
        env, dtenv = _type_envs(plan, plan.parents(op)[0], store, registry,
                                memo)
        out = {name: _expr_st(e, env, dtenv, registry) for name, e in op.exprs}
        dts = {name: _expr_dt(e, dtenv, registry) for name, e in op.exprs}
    elif isinstance(op, (FilterOp, LimitOp)):
        env, dtenv = _type_envs(plan, plan.parents(op)[0], store, registry,
                                memo)
        out, dts = dict(env), dict(dtenv)
    elif isinstance(op, AggOp):
        env, dtenv = _type_envs(plan, plan.parents(op)[0], store, registry,
                                memo)
        out = {g: env.get(g, _NONE) for g in op.groups}
        dts = {g: dtenv.get(g) for g in op.groups}
        for ae in op.values:
            st = _NONE
            try:
                uda = registry.uda(ae.fn)
            except Exception:
                uda = None
            if uda is not None:
                if uda.out_st is not None:
                    st = uda.out_st
                    # quantiles of durations are duration-quantiles
                    # (typespb ST_DURATION_NS_QUANTILES exists for this)
                    if st == ST.ST_QUANTILES and ae.arg is not None \
                            and env.get(ae.arg) == ST.ST_DURATION_NS:
                        st = ST.ST_DURATION_NS_QUANTILES
                elif uda.st_preserve and ae.arg is not None:
                    st = env.get(ae.arg, _NONE)
                try:
                    dts[ae.out_name] = uda.out_type(dtenv.get(ae.arg))
                except Exception:
                    dts[ae.out_name] = None
            out[ae.out_name] = st
    elif isinstance(op, JoinOp):
        left, right = plan.parents(op)
        lenv, ldt = _type_envs(plan, left, store, registry, memo)
        renv, rdt = _type_envs(plan, right, store, registry, memo)
        if op.output:
            for side, col, out_name in op.output:
                env, dtenv = (lenv, ldt) if side == "left" else (renv, rdt)
                out[out_name] = env.get(col, _NONE)
                dts[out_name] = dtenv.get(col)
        else:
            out = {**renv, **lenv}
            dts = {**rdt, **ldt}
    elif isinstance(op, UnionOp):
        env, dtenv = _type_envs(plan, plan.parents(op)[0], store, registry,
                                memo)
        out, dts = dict(env), dict(dtenv)
    else:  # unknown op kinds contribute nothing rather than failing queries
        parents = plan.parents(op)
        if parents:
            env, dtenv = _type_envs(plan, parents[0], store, registry, memo)
            out, dts = dict(env), dict(dtenv)
    memo[op.id] = (out, dts)
    return out, dts


class SchemaStore:
    """Store shim exposing .table(name).relation from a schema dict — lets
    the broker (which holds agent-reported schemas, not tables) run the same
    plan-level ST propagation as a local executor."""

    class _T:
        def __init__(self, relation):
            self.relation = relation

    def __init__(self, schemas: dict):
        self._schemas = schemas

    def table(self, name: str):
        return self._T(self._schemas[name])


def restamp_result(result, plan, store, registry):
    """Overwrite a QueryResult's relation STs from the LOGICAL plan.

    Distributed/streaming executions run merger/post plans whose sources are
    remote channels with no ST knowledge; the logical plan + source schemas
    still fully determine the output STs."""
    from pixie_tpu_torch.types import ColumnSchema

    for sink in plan.sinks():
        if getattr(sink, "name", None) != result.name:
            continue
        parents = plan.parents(sink)
        if not parents:
            break
        sts = semantic_types(plan, parents[0], store, registry)
        result.relation = Relation([
            ColumnSchema(c.name, c.data_type,
                         sts.get(c.name, c.semantic_type))
            for c in result.relation
        ])
        break
    return result


def sink_relation(plan, sink, out_names, out_dtypes, store, registry
                  ) -> Relation:
    """Typed output relation for a sink: physical dtypes + propagated STs."""
    from pixie_tpu_torch.types import ColumnSchema

    parent = plan.parents(sink)[0]
    sts = semantic_types(plan, parent, store, registry)
    return Relation([
        ColumnSchema(n, out_dtypes[n], sts.get(n, _NONE)) for n in out_names
    ])
