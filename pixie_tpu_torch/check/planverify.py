"""Compile-time plan verification: a typed dataflow pass over Carnot plans.

Copied from the reference package (pixie_tpu/check/planverify.py).

The broker and LocalCluster run this before EVERY dispatch (PX_PLAN_VERIFY,
default on).  A miscompiled fragment — mismatched dtypes across a shuffle,
a non-mergeable partial agg split across agents, a matview prefix that
silently diverges between producers, mismatched partition counts on a
repartitioned join — would otherwise surface only as a runtime bit-diff or
a hung wave.  Flare/Tailwind (PAPERS.md) lean on a verified lowering
contract between plan and substrate; this pass is that contract.

Checked invariants (each names itself in the raised PlanVerifyError):

  unknown-table / unknown-column / unknown-udf / unknown-uda
      every name a plan references resolves against the live schemas and
      the UDF registry, with the SAME overload resolution the executor uses
  filter-not-boolean       filter predicates type to BOOLEAN
  dict-input-agg           dictionary-encoded agg inputs only into dict_ok UDAs
  bad-limit                LimitOp.n is a non-negative int
  windowed-agg-no-time     windowed aggs carry a time-typed group key
  join-key-arity / join-key-dtype / join-how / join-output
      equijoin keys pair up with matching dtypes; outputs name real columns
  union-schema             union parents share one name→dtype relation
  agg-state-sink           agg_state sinks are fed by a partial AggOp
  not-mergeable            every partial agg has a combine path: each UDA's
      reduce_ops() tree is add/min/max leaves (what combine_partials and the
      in-mesh merge consume) and a finalize path exists — the
      fold-correctness linchpin
  partial-dict-agg         cross-agent partials never carry dictionary codes
      (each agent's code space is private; state must merge by VALUE)
  unknown-producer / unknown-channel / missing-bucket-channel
      channel topology is closed: producers exist, sinks ship to declared
      channels, every partition bucket channel exists
  shuffle-schema-mismatch  all producers of one channel ship ONE relation
      (names AND dtypes) — the dtype-flip-across-a-shuffle miscompile
  partition-count-mismatch all PartitionSinks of a join stage agree with the
      stage's n_parts (the shard-axis consistency contract)
  channel-agg-mismatch     an agg_state channel's declared agg (what the
      merger finalizes with) matches the partial agg its producers run
  matview-prefix-divergence all producers of an agg_state channel
      canonicalize to the SAME standing-view key (broker matcher and agent
      maintainers must agree on what the state is a function of)
  batch-slot-missing-sink / batch-slot-overlap
      fused multi-query (batched) splits: each member slot's renamed sinks
      exist exactly once in the merger plan and two slots never claim one
      fused sink (the per-member demux partition contract) — verified once
      per batch signature, riding the fused split cache

Cost model: one O(ops) walk per distributed split.  Both dispatch sites
cache splits in the whole-query plan cache keyed by (script, params,
topology epoch), and verification runs only when the split is freshly
computed — a warm query's verified signature IS its split-cache slot, so
warm queries pay zero re-verification.
"""
from __future__ import annotations

from typing import Optional

from pixie_tpu_torch import flags as _flags
from pixie_tpu_torch.plan.plan import (
    AggOp,
    Call,
    Column,
    FilterOp,
    JoinOp,
    LimitOp,
    Literal,
    MapOp,
    MemorySinkOp,
    MemorySourceOp,
    OTelExportSinkOp,
    PartitionSinkOp,
    Plan,
    RemoteSourceOp,
    ResultSinkOp,
    UDTFSourceOp,
    UnionOp,
)
from pixie_tpu_torch.status import Code, PxError
from pixie_tpu_torch.types import DICT_ENCODED, DataType as DT, Relation

_flags.define_bool(
    "PX_PLAN_VERIFY", True,
    "typed dataflow verification of every compiled plan before dispatch "
    "(broker and LocalCluster): schema/dtype flow, shuffle consistency, "
    "partial-agg mergeability, matview prefix agreement.  Violations raise "
    "PlanVerifyError naming the op and invariant; 0 disables (A/B only)")

_REDUCE_OPS = frozenset({"add", "min", "max"})
_JOIN_HOWS = frozenset({"inner", "left", "right", "outer"})
#: dtype pairs a join may legally mix (time is int64 nanoseconds on device)
_JOIN_COMPAT = frozenset({DT.INT64, DT.TIME64NS})


class PlanVerifyError(PxError):
    """A plan failed pre-dispatch verification.

    Structured: ``invariant`` is the rule id (stable, test-asserted),
    ``op_kind``/``op_id`` name the offending operator, ``where`` locates the
    fragment (logical plan, an agent's plan, a channel, a join stage)."""

    code = Code.INVALID_ARGUMENT

    def __init__(self, invariant: str, detail: str, op=None, where: str = ""):
        self.invariant = invariant
        self.op_kind = getattr(op, "kind", None) if op is not None else None
        self.op_id = getattr(op, "id", None) if op is not None else None
        self.where = where
        at = f" at {self.op_kind}#{self.op_id}" if op is not None else ""
        loc = f" [{where}]" if where else ""
        super().__init__(f"plan verify{loc}: {invariant}{at}: {detail}")


def enabled() -> bool:
    return bool(_flags.get("PX_PLAN_VERIFY"))


# ------------------------------------------------------------ expression flow


def _expr_dtype(expr, env: dict, registry, op, where: str):
    """Physical dtype of an expression under `env`, resolved with the same
    overload rules the executor applies.  Raises on unknown names."""
    if isinstance(expr, Column):
        dt = env.get(expr.name)
        if dt is None:
            raise PlanVerifyError(
                "unknown-column",
                f"column {expr.name!r} not in input relation "
                f"{sorted(env)}", op, where)
        return dt
    if isinstance(expr, Literal):
        return expr.dtype
    if isinstance(expr, Call):
        argdts = [_expr_dtype(a, env, registry, op, where) for a in expr.args]
        if any(d is None for d in argdts):
            return None
        # string-aware structural forms the evaluator lowers BEFORE registry
        # dispatch (engine.eval.ExprCompiler._compile_call)
        if expr.fn in ("equal", "not_equal") and argdts and all(
                d in DICT_ENCODED for d in argdts):
            return DT.BOOLEAN
        if expr.fn == "select" and len(argdts) == 3 \
                and argdts[1] == DT.STRING:
            return DT.STRING
        try:
            return registry.scalar(expr.fn, argdts).out_type
        except Exception as e:
            raise PlanVerifyError(
                "unknown-udf",
                f"no scalar overload {expr.fn!r} for "
                f"{tuple(getattr(d, 'name', d) for d in argdts)}: {e}",
                op, where) from None
    return None  # unknown expr kinds stay opaque rather than failing queries


# --------------------------------------------------------------- agg checks


def _check_reduce_tree(tree, ae, op, where: str) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _check_reduce_tree(v, ae, op, where)
        return
    if tree not in _REDUCE_OPS:
        raise PlanVerifyError(
            "not-mergeable",
            f"agg {ae.out_name!r} ({ae.fn}): reduce op {tree!r} is not one "
            f"of {sorted(_REDUCE_OPS)}", op, where)


def _check_agg_mergeable(agg: AggOp, registry, op, where: str,
                         cross_agent: bool) -> None:
    """Every value of a PARTIAL agg must have a registered combine path:
    reduce_ops() drives combine_partials AND the in-mesh psum merge, so a
    UDA without a valid reduce tree has no way back to one answer.
    `cross_agent` additionally bans dictionary-coded state — each agent's
    code space is private, so cross-agent state must merge by VALUE."""
    from pixie_tpu_torch.udf.udf import UDA

    for ae in agg.values:
        try:
            uda = registry.uda(ae.fn)
        except Exception as e:
            raise PlanVerifyError(
                "not-mergeable",
                f"agg {ae.out_name!r}: no combine_partials path — UDA "
                f"{ae.fn!r} is not registered ({e})", op, where) from None
        try:
            tree = uda.reduce_ops()
        except Exception as e:
            raise PlanVerifyError(
                "not-mergeable",
                f"agg {ae.out_name!r} ({ae.fn}): reduce_ops() failed: {e}",
                op, where) from None
        _check_reduce_tree(tree, ae, op, where)
        finalizable = (
            type(uda).finalize_host is not UDA.finalize_host
            or getattr(uda, "device_finalize", False)
            or getattr(uda, "needs_dict", False))
        if not finalizable:
            raise PlanVerifyError(
                "not-mergeable",
                f"agg {ae.out_name!r} ({ae.fn}): no finalize path "
                "(finalize_host/finalize_device/finalize_dict)", op, where)
        if cross_agent and (uda.dict_ok or getattr(uda, "needs_dict", False)):
            raise PlanVerifyError(
                "partial-dict-agg",
                f"agg {ae.out_name!r} ({ae.fn}): dictionary-coded state "
                "cannot merge across agents' private code spaces "
                "(the planner must ship rows for this aggregate)",
                op, where)


def _agg_sig(agg: AggOp) -> tuple:
    """Identity of an agg MODULO the partial/finalize split flags and op id
    — what must agree between a channel's declared agg and its producers'."""
    return (tuple(agg.groups),
            tuple((v.out_name, v.fn, v.arg) for v in agg.values),
            bool(agg.windowed))


# ------------------------------------------------------------------ op walk


def _source_env(op, schemas: dict, registry, channel_relations,
                where: str) -> Optional[dict]:
    if isinstance(op, MemorySourceOp):
        rel = schemas.get(op.table)
        if rel is None:
            raise PlanVerifyError(
                "unknown-table",
                f"table {op.table!r} not in live schemas "
                f"{sorted(schemas)[:20]}", op, where)
        cols = op.columns if op.columns is not None else rel.names()
        env = {}
        for c in cols:
            if c not in rel:
                raise PlanVerifyError(
                    "unknown-column",
                    f"table {op.table!r} has no column {c!r} "
                    f"(has {rel.names()})", op, where)
            env[c] = rel.dtype(c)
        return env
    if isinstance(op, UDTFSourceOp):
        rel = Relation.from_dict(op.schema) if op.schema is not None else None
        if rel is None:
            try:
                rel = registry.udtf(op.name).relation
            except Exception as e:
                raise PlanVerifyError(
                    "unknown-udf",
                    f"UDTF {op.name!r} is not registered and the plan "
                    f"carries no schema: {e}", op, where) from None
        return {c.name: c.data_type for c in rel}
    if isinstance(op, RemoteSourceOp):
        if channel_relations is not None and op.channel in channel_relations:
            return channel_relations[op.channel]
        if op.schema is not None:
            return {c.name: c.data_type
                    for c in Relation.from_dict(op.schema)}
        return None  # opaque: downstream checks skip rather than guess
    return None


def verify_plan(plan: Plan, schemas: dict, registry=None,
                channel_relations: Optional[dict] = None,
                where: str = "plan") -> dict:
    """Typed dataflow pass over one plan.  Returns {op id: output env}
    where an env is {column: DataType} (or None for opaque subgraphs fed by
    channels with no declared relation).  Raises PlanVerifyError on the
    first violation.

    `schemas` maps table name → Relation; `channel_relations` maps remote
    channel id → env for merger/fragment plans whose sources are channels.
    """
    if registry is None:
        from pixie_tpu_torch.udf import registry as registry  # noqa: PLW0127
    envs: dict[int, Optional[dict]] = {}
    for op in plan.topo_sorted():
        parents = plan.parents(op)
        penvs = [envs[p.id] for p in parents]
        env: Optional[dict]
        if not parents:
            env = _source_env(op, schemas, registry, channel_relations, where)
        elif isinstance(op, MapOp):
            env = None
            if penvs[0] is not None:
                env = {}
                for name, expr in op.exprs:
                    env[name] = _expr_dtype(expr, penvs[0], registry, op,
                                            where)
        elif isinstance(op, FilterOp):
            env = penvs[0]
            if env is not None and op.expr is not None:
                dt = _expr_dtype(op.expr, env, registry, op, where)
                if dt is not None and dt != DT.BOOLEAN:
                    raise PlanVerifyError(
                        "filter-not-boolean",
                        f"predicate types to {getattr(dt, 'name', dt)}, "
                        "expected BOOLEAN", op, where)
        elif isinstance(op, LimitOp):
            if not isinstance(op.n, int) or isinstance(op.n, bool) \
                    or op.n < 0:
                raise PlanVerifyError(
                    "bad-limit", f"limit n={op.n!r} must be a non-negative "
                    "int", op, where)
            env = penvs[0]
        elif isinstance(op, AggOp):
            env = self_env = penvs[0]
            if self_env is not None:
                env = {}
                for g in op.groups:
                    if g not in self_env:
                        raise PlanVerifyError(
                            "unknown-column",
                            f"group key {g!r} not in input relation "
                            f"{sorted(self_env)}", op, where)
                    env[g] = self_env[g]
                if op.windowed and not any(
                        self_env.get(g) in (DT.TIME64NS, DT.INT64)
                        for g in op.groups):
                    raise PlanVerifyError(
                        "windowed-agg-no-time",
                        "windowed agg has no time-typed group key "
                        f"(groups {op.groups})", op, where)
                for ae in op.values:
                    try:
                        uda = registry.uda(ae.fn)
                    except Exception as e:
                        raise PlanVerifyError(
                            "unknown-uda", f"agg {ae.out_name!r}: {e}",
                            op, where) from None
                    in_dt = None
                    if not uda.nullary:
                        if ae.arg is None or ae.arg not in self_env:
                            raise PlanVerifyError(
                                "unknown-column",
                                f"agg {ae.out_name!r} ({ae.fn}) input "
                                f"{ae.arg!r} not in relation "
                                f"{sorted(self_env)}", op, where)
                        in_dt = self_env[ae.arg]
                        if in_dt in DICT_ENCODED and not uda.dict_ok:
                            raise PlanVerifyError(
                                "dict-input-agg",
                                f"agg {ae.out_name!r}: UDA {ae.fn!r} cannot "
                                f"consume dictionary-encoded "
                                f"{in_dt.name} column {ae.arg!r}", op, where)
                    try:
                        env[ae.out_name] = uda.out_type(in_dt)
                    except Exception:
                        env[ae.out_name] = None
                if op.partial:
                    # a partial agg's state must have a combine path even
                    # in-process (SPMD mesh merge uses the same reduce tree)
                    _check_agg_mergeable(op, registry, op, where,
                                         cross_agent=False)
        elif isinstance(op, JoinOp):
            if op.how not in _JOIN_HOWS:
                raise PlanVerifyError(
                    "join-how", f"unknown join how={op.how!r}", op, where)
            if len(op.left_on) != len(op.right_on):
                raise PlanVerifyError(
                    "join-key-arity",
                    f"left_on {op.left_on} and right_on {op.right_on} "
                    "differ in length", op, where)
            lenv, renv = (penvs + [None, None])[:2]
            if lenv is not None and renv is not None:
                for lk, rk in zip(op.left_on, op.right_on):
                    if lk not in lenv:
                        raise PlanVerifyError(
                            "unknown-column", f"left join key {lk!r} not in "
                            f"{sorted(lenv)}", op, where)
                    if rk not in renv:
                        raise PlanVerifyError(
                            "unknown-column", f"right join key {rk!r} not "
                            f"in {sorted(renv)}", op, where)
                    a, b = lenv[lk], renv[rk]
                    if a != b and not (a in _JOIN_COMPAT
                                       and b in _JOIN_COMPAT):
                        raise PlanVerifyError(
                            "join-key-dtype",
                            f"key {lk!r}:{a.name} vs {rk!r}:{b.name} — "
                            "join keys must share a physical dtype",
                            op, where)
                env = {}
                for side, col, out_name in op.output:
                    src = lenv if side == "left" else (
                        renv if side == "right" else None)
                    if src is None:
                        raise PlanVerifyError(
                            "join-output", f"output side {side!r} is not "
                            "left/right", op, where)
                    if col not in src:
                        raise PlanVerifyError(
                            "join-output",
                            f"output {out_name!r} references missing "
                            f"{side} column {col!r}", op, where)
                    env[out_name] = src[col]
                if not op.output:
                    env = {**renv, **lenv}
            else:
                env = None
        elif isinstance(op, UnionOp):
            known = [e for e in penvs if e is not None]
            for e in known[1:]:
                if e != known[0]:
                    raise PlanVerifyError(
                        "union-schema",
                        f"parents disagree: {sorted(known[0].items())} vs "
                        f"{sorted(e.items())}", op, where)
            env = known[0] if len(known) == len(penvs) and known else None
        elif isinstance(op, ResultSinkOp):
            if op.payload == "agg_state":
                if len(parents) != 1 or not isinstance(parents[0], AggOp) \
                        or not parents[0].partial:
                    raise PlanVerifyError(
                        "agg-state-sink",
                        "agg_state sink must be fed by AggOp(partial=True), "
                        f"got {parents[0].kind if parents else 'nothing'}",
                        op, where)
            env = penvs[0] if penvs else None
        elif isinstance(op, PartitionSinkOp):
            if op.n_parts < 1:
                raise PlanVerifyError(
                    "bad-limit", f"n_parts={op.n_parts} must be >= 1",
                    op, where)
            env = penvs[0] if penvs else None
            if env is not None:
                for k in op.keys:
                    if k not in env:
                        raise PlanVerifyError(
                            "unknown-column",
                            f"partition key {k!r} not in relation "
                            f"{sorted(env)}", op, where)
        elif isinstance(op, MemorySinkOp):
            env = penvs[0] if penvs else None
            if env is not None and op.columns:
                for c in op.columns:
                    if c not in env:
                        raise PlanVerifyError(
                            "unknown-column",
                            f"sink column {c!r} not in relation "
                            f"{sorted(env)}", op, where)
        elif isinstance(op, OTelExportSinkOp):
            env = penvs[0] if penvs else None
        else:  # unknown op kinds pass their parent's env through
            env = penvs[0] if penvs else None
        envs[op.id] = env
    return envs


# ------------------------------------------------------- distributed checks


def _sink_parent_env(plan: Plan, sink, envs: dict):
    parents = plan.parents(sink)
    return envs.get(parents[0].id) if parents else None


def _fragment_sig(plan: Plan, sink) -> str:
    """Content signature of the single-parent chain feeding `sink` (op
    dicts minus runtime ids) — what all producers of one channel must agree
    on, and what the matview registry's prefix canonicalization is a
    function of."""
    import json as _json

    sigs = []
    cur = sink
    while True:
        d = cur.to_dict()
        d.pop("id", None)
        sigs.append(d)
        ps = plan.parents(cur)
        if len(ps) != 1:
            sigs.append({"parents": len(ps)})
            break
        cur = ps[0]
    return _json.dumps(sigs, sort_keys=True, default=str)


def verify_distributed(dp, schemas: dict, registry=None) -> None:
    """Verify a DistributedPlan end to end: every agent fragment, the
    channel topology, cross-producer shuffle consistency, join-stage
    partition counts, matview prefix agreement, and the merger plan (fed
    the channel relations its producers actually ship)."""
    if registry is None:
        from pixie_tpu_torch.udf import registry as registry  # noqa: PLW0127
    agent_envs: dict[str, dict] = {}
    #: channel id -> {agent: env shipped on that channel}
    produced: dict[str, dict] = {}
    #: channel id -> {agent: the partial AggOp the producer runs}
    produced_agg: dict[str, dict] = {}
    for name, plan in dp.agent_plans.items():
        envs = verify_plan(plan, schemas, registry, where=f"agent {name}")
        agent_envs[name] = envs
        for op in plan.ops():
            if isinstance(op, ResultSinkOp):
                if op.channel not in dp.channels:
                    raise PlanVerifyError(
                        "unknown-channel",
                        f"sink ships to undeclared channel {op.channel!r}",
                        op, f"agent {name}")
                produced.setdefault(op.channel, {})[name] = \
                    _sink_parent_env(plan, op, envs)
                if op.payload == "agg_state":
                    produced_agg.setdefault(op.channel, {})[name] = \
                        plan.parents(op)[0]
            elif isinstance(op, PartitionSinkOp):
                env = envs.get(plan.parents(op)[0].id) if plan.parents(op) \
                    else None
                for i in range(op.n_parts):
                    cid = f"{op.prefix}{i}"
                    if cid not in dp.channels:
                        raise PlanVerifyError(
                            "missing-bucket-channel",
                            f"partition bucket channel {cid!r} is not "
                            "declared", op, f"agent {name}")
                    produced.setdefault(cid, {})[name] = env

    # ---- join stages: shard-axis consistency across the exchange
    stage_out_env: dict[str, Optional[dict]] = {}
    for si, stage in enumerate(getattr(dp, "join_stages", None) or []):
        where = f"join stage {si}"
        side_env: dict[str, Optional[dict]] = {}
        for chan_name, prefix in (("left", stage.left_prefix),
                                  ("right", stage.right_prefix)):
            envs_seen = []
            for name, plan in dp.agent_plans.items():
                for op in plan.ops():
                    if isinstance(op, PartitionSinkOp) \
                            and op.prefix == prefix:
                        if op.n_parts != stage.n_parts:
                            raise PlanVerifyError(
                                "partition-count-mismatch",
                                f"agent {name} partitions {prefix!r} "
                                f"{op.n_parts}-way but the stage joins "
                                f"{stage.n_parts} partitions", op, where)
                        ps = plan.parents(op)
                        envs_seen.append(
                            agent_envs[name].get(ps[0].id) if ps else None)
            if not envs_seen:
                raise PlanVerifyError(
                    "partition-count-mismatch",
                    f"no producer partitions prefix {prefix!r}", None, where)
            known = [e for e in envs_seen if e is not None]
            side_env[chan_name] = known[0] if len(known) == len(envs_seen) \
                and known else None
        # stage output channels are synthesized by run_join_stages (they
        # are not declared Channels); their relation feeds the merger below
        frag_envs = verify_plan(
            stage.fragment, schemas, registry,
            channel_relations={stage.left_channel: side_env["left"],
                               stage.right_channel: side_env["right"]},
            where=where)
        for op in stage.fragment.ops():
            if isinstance(op, ResultSinkOp):
                stage_out_env[op.channel] = \
                    _sink_parent_env(stage.fragment, op, frag_envs)

    # ---- channels: producers exist, relations agree, aggs are mergeable
    channel_relations: dict[str, Optional[dict]] = {}
    for cid, ch in dp.channels.items():
        where = f"channel {cid}"
        if not ch.producers:
            raise PlanVerifyError(
                "unknown-producer", "channel has no producers", None, where)
        for p in ch.producers:
            if p not in dp.agent_plans:
                raise PlanVerifyError(
                    "unknown-producer",
                    f"producer {p!r} has no agent plan", None, where)
        by_agent = produced.get(cid, {})
        known = [(a, e) for a, e in sorted(by_agent.items())
                 if e is not None]
        for a, e in known[1:]:
            if e != known[0][1]:
                raise PlanVerifyError(
                    "shuffle-schema-mismatch",
                    f"producer {known[0][0]!r} ships "
                    f"{sorted(known[0][1].items())} but {a!r} ships "
                    f"{sorted(e.items())} — all producers of a channel "
                    "must agree on one relation", None, where)
        env = known[0][1] if known and len(known) == len(by_agent) else None
        if ch.kind == "agg_state":
            if ch.agg is None:
                raise PlanVerifyError(
                    "channel-agg-mismatch",
                    "agg_state channel carries no agg spec", None, where)
            _check_agg_mergeable(ch.agg, registry, None, where,
                                 cross_agent=True)
            for a, pagg in sorted(produced_agg.get(cid, {}).items()):
                if _agg_sig(pagg) != _agg_sig(ch.agg):
                    raise PlanVerifyError(
                        "channel-agg-mismatch",
                        f"producer {a!r} computes partial agg "
                        f"{_agg_sig(pagg)} but the merger finalizes "
                        f"{_agg_sig(ch.agg)}", pagg, where)
            # broker-side matview matcher and agent-side maintainers key
            # standing state off the SAME canonicalized prefix, and every
            # producer's fragment is a clone of ONE logical subgraph.
            # Divergent fragment content (a filter constant, a map expr —
            # invisible to dtype checks) means producers answer different
            # questions under one channel: the stale-matview miscompile.
            sigs = {}
            for p in ch.producers:
                plan = dp.agent_plans.get(p)
                if plan is None:
                    continue
                for op in plan.ops():
                    if isinstance(op, ResultSinkOp) and op.channel == cid:
                        sigs[p] = _fragment_sig(plan, op)
            uniq = set(sigs.values())
            if len(uniq) > 1:
                by_sig: dict = {}
                for p, s in sigs.items():
                    by_sig.setdefault(s, []).append(p)
                raise PlanVerifyError(
                    "matview-prefix-divergence",
                    f"producers of one agg_state channel compute "
                    f"{len(uniq)} distinct fragments "
                    f"({sorted(sorted(v) for v in by_sig.values())}) — "
                    "their standing-view prefixes cannot agree", None,
                    where)
            # what the MERGER receives on this channel is the finalized
            # relation — identical to the partial agg's output env (group
            # key dtypes + each UDA's declared out_type)
            channel_relations[cid] = env
        else:
            channel_relations[cid] = env
    channel_relations.update(stage_out_env)

    verify_plan(dp.merger_plan, schemas, registry,
                channel_relations=channel_relations, where="merger")


# -------------------------------------------------- fused multi-query form


def verify_fused_batch(dp, sink_map: dict) -> None:
    """The fused multi-query (batched) plan form — ran ON TOP of
    verify_distributed for a batch's merged split, once per batch signature
    (it rides the fused split cache, so warm batches pay zero
    re-verification).

    Per-slot invariants (each member query is one slot, its sinks renamed
    `q{slot}/{name}` by plan fusion):

      batch-slot-missing-sink   every slot sink the demux will read exists
          exactly once in the merger plan — a slot whose output was lost
          (or duplicated) in fusion would silently answer the wrong member
      batch-slot-overlap        two slots never claim the same fused sink —
          demux by prefix must partition the result set

    Per-slot schema flow and partial-agg mergeability need no extra pass:
    verify_distributed already types every fused chain op-by-op and checks
    each agg_state channel's combine/finalize path — the fused plan IS a
    plan."""
    sinks = [op.name for op in dp.merger_plan.ops()
             if isinstance(op, MemorySinkOp)]
    counts: dict[str, int] = {}
    for n in sinks:
        counts[n] = counts.get(n, 0) + 1
    claimed: dict[str, str] = {}
    for prefix, m in sorted(sink_map.items()):
        for orig, fused_name in sorted(m.items()):
            if counts.get(fused_name, 0) != 1:
                raise PlanVerifyError(
                    "batch-slot-missing-sink",
                    f"slot {prefix!r} output {orig!r} maps to fused sink "
                    f"{fused_name!r} which appears "
                    f"{counts.get(fused_name, 0)}x in the merger plan",
                    where=f"batch slot {prefix}")
            other = claimed.get(fused_name)
            if other is not None and other != prefix:
                raise PlanVerifyError(
                    "batch-slot-overlap",
                    f"fused sink {fused_name!r} claimed by slots "
                    f"{other!r} and {prefix!r}",
                    where=f"batch slot {prefix}")
            claimed[fused_name] = prefix


def maybe_verify_fused_batch(dp, sink_map: dict) -> None:
    """verify_fused_batch under the PX_PLAN_VERIFY flag (callers run
    maybe_verify on the merged split first, inside the same cache fill)."""
    if not enabled():
        return
    verify_fused_batch(dp, sink_map)


# ------------------------------------------------------------ dispatch hook


def maybe_verify(dp, schemas: dict, registry=None) -> None:
    """The pre-dispatch hook (broker / LocalCluster): verify a freshly
    computed split under the PX_PLAN_VERIFY flag.  Callers skip this for
    split-cache hits — a cached split was verified when computed, which is
    what makes warm-query re-verification zero-cost."""
    if not enabled():
        return
    from pixie_tpu_torch import metrics as _metrics
    from pixie_tpu_torch import trace

    with trace.span("plan_verify"):
        try:
            verify_distributed(dp, schemas, registry)
        except PlanVerifyError:
            _metrics.counter_inc(
                "px_plan_verify_failures_total",
                help_="compiled plans rejected by pre-dispatch verification")
            raise
        _metrics.counter_inc(
            "px_plan_verify_total",
            help_="distributed splits verified before dispatch")
