"""Plan verification: pixie_tpu_torch.check.planverify against pixie_tpu's.

One case per invariant the reference's docstring names
(pixie_tpu/check/planverify.py:12-46): the same plan, or the same seeded
miscompile of the same distributed split, runs through both packages'
verifiers, and both must raise PlanVerifyError naming the same invariant
(and the same operator kind).  Unmutated splits verify clean in both.

Beyond the verifier itself: every UDA's reduce_ops() tree (what
`not-mergeable` walks) and out_type agree UDA by UDA; LocalCluster verifies
a cold query's fresh split once and a warm query's cached split zero times,
in both packages; a mutated split raises before any agent runs; and
PX_PLAN_VERIFY=0 skips verification.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview  # noqa: F401  (defines PL_MATVIEW_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu import metrics as ref_metrics
from pixie_tpu import plan as ref_plan
from pixie_tpu.check import planverify as ref_pv
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.parallel.distributed import DistributedPlanner as RefPlanner
from pixie_tpu.parallel.topology import AgentInfo as RefAgent, ClusterSpec as RefSpec
from pixie_tpu.serving import batching as ref_batching
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.udf import registry as ref_registry

import pixie_tpu_torch.matview  # noqa: F401
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch import metrics as port_metrics
from pixie_tpu_torch import plan as port_plan
from pixie_tpu_torch.check import planverify as port_pv
from pixie_tpu_torch.compiler import compile_pxl as port_compile
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.parallel.distributed import DistributedPlanner
from pixie_tpu_torch.parallel.topology import AgentInfo, ClusterSpec
from pixie_tpu_torch.serving import batching as port_batching
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation
from pixie_tpu_torch.udf import registry as port_registry

NOW = 1_700_000_000_000_000_000

AGG_SRC = """
import px
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service']).agg(total=('latency', px.sum),
                                 cnt=('latency', px.count))
px.display(df, 'out')
"""

AGG2_SRC = """
import px
df = px.DataFrame(table='http_events')
df = df.groupby(['status']).agg(mx=('latency', px.max))
px.display(df, 'out')
"""

LIMIT_SRC = """
import px
df = px.DataFrame(table='http_events')
df = df.head(20)
px.display(df, 'out')
"""

JOIN_SRC = """
import px
a = px.DataFrame(table='http_events')
b = px.DataFrame(table='conn_stats')
j = a.merge(b, how='inner', left_on=['service'], right_on=['service'],
            suffixes=['', '_r'])
px.display(j, 'out')
"""


class Pkg:
    """One package's verifier, planner and plan vocabulary."""

    def __init__(self, name: str):
        ref = name == "ref"
        self.name = name
        self.P = ref_plan if ref else port_plan
        self.pv = ref_pv if ref else port_pv
        self.DT = RefDT if ref else DT
        self.flags = ref_flags if ref else port_flags
        self.metrics = ref_metrics if ref else port_metrics
        self.registry = ref_registry if ref else port_registry
        self.batching = ref_batching if ref else port_batching
        self._compile = ref_compile if ref else port_compile
        rel = RefRelation if ref else Relation
        self.schemas = {
            "http_events": rel.of(("time_", self.DT.TIME64NS), ("service", self.DT.STRING),
                                  ("latency", self.DT.FLOAT64), ("status", self.DT.INT64)),
            "conn_stats": rel.of(("time_", self.DT.TIME64NS), ("service", self.DT.STRING),
                                 ("bytes", self.DT.INT64)),
        }
        agent_cls, spec_cls = (RefAgent, RefSpec) if ref else (AgentInfo, ClusterSpec)
        agents = [agent_cls(name=f"pem{i}", has_data_store=True, processes_data=True,
                            accepts_remote_sources=False, schemas=self.schemas)
                  for i in range(2)]
        agents.append(agent_cls(name="merger", has_data_store=False, processes_data=False,
                                accepts_remote_sources=True, schemas={}))
        self.spec = spec_cls(agents)
        self.planner = RefPlanner(self.spec) if ref else DistributedPlanner(self.spec)

    def compile(self, src):
        return self._compile(src, self.schemas, now=NOW)

    def split(self, src):
        return self.planner.plan(self.compile(src).plan)

    def verify_plan(self, plan):
        return self.pv.verify_plan(plan, self.schemas)

    def verify_split(self, dp):
        return self.pv.verify_distributed(dp, self.schemas)


PKGS = [Pkg("ref"), Pkg("port")]


def _rebuild_chain(pkg, plan, transform):
    """Rebuild a LINEAR agent plan with `transform` applied to its copied
    op list (the mutation seam of the reference's golden tests)."""
    ops = [copy.copy(o) for o in plan.topo_sorted()]
    new = pkg.P.Plan()
    node = None
    for op in transform(ops):
        op.id = -1
        node = new.add(op, parents=[] if node is None else [node])
    return new


def _source_sink(pkg, **src_kw):
    P = pkg.P
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table=src_kw.pop("table", "http_events"), **src_kw))
    return p, src


def _agg_channel(dp):
    (cid, ch), = [(c, ch) for c, ch in dp.channels.items() if ch.kind == "agg_state"]
    return cid, ch


# ------------------------------------------------------------ the cases


def case_unknown_table(pkg):
    p, src = _source_sink(pkg, table="nope")
    p.add(pkg.P.MemorySinkOp(name="out"), parents=[src])
    pkg.verify_plan(p)


def case_unknown_column(pkg):
    p, src = _source_sink(pkg, columns=["service", "nope"])
    p.add(pkg.P.MemorySinkOp(name="out"), parents=[src])
    pkg.verify_plan(p)


def case_unknown_udf(pkg):
    P = pkg.P
    p, src = _source_sink(pkg)
    m = p.add(P.MapOp(exprs=[("x", P.Call("no_such_fn", (P.Column("latency"),)))]),
              parents=[src])
    p.add(P.MemorySinkOp(name="out"), parents=[m])
    pkg.verify_plan(p)


def case_unknown_uda(pkg):
    P = pkg.P
    p, src = _source_sink(pkg)
    a = p.add(P.AggOp(groups=["service"], values=[P.AggExpr("x", "no_such_uda", "latency")]),
              parents=[src])
    p.add(P.MemorySinkOp(name="out"), parents=[a])
    pkg.verify_plan(p)


def case_filter_not_boolean(pkg):
    P = pkg.P
    p, src = _source_sink(pkg)
    f = p.add(P.FilterOp(expr=P.Column("latency")), parents=[src])
    p.add(P.MemorySinkOp(name="out"), parents=[f])
    pkg.verify_plan(p)


def case_dict_input_agg(pkg):
    P = pkg.P
    p, src = _source_sink(pkg)
    a = p.add(P.AggOp(groups=["status"], values=[P.AggExpr("s", "sum", "service")]),
              parents=[src])
    p.add(P.MemorySinkOp(name="out"), parents=[a])
    pkg.verify_plan(p)


def case_bad_limit(pkg):
    q = pkg.compile(LIMIT_SRC)
    for op in q.plan.ops():
        if op.kind == "limit":
            op.n = -5
    pkg.verify_plan(q.plan)


def case_windowed_agg_no_time(pkg):
    P = pkg.P
    p, src = _source_sink(pkg)
    p.add(P.AggOp(groups=["service"], values=[P.AggExpr("cnt", "count", None)],
                  windowed=True), parents=[src])
    pkg.verify_plan(p)


def _join(pkg, **kw):
    P = pkg.P
    p = P.Plan()
    a = p.add(P.MemorySourceOp(table="http_events"))
    b = p.add(P.MemorySourceOp(table="conn_stats"))
    spec = dict(how="inner", left_on=["service"], right_on=["service"],
                output=[("left", "service", "service"), ("right", "bytes", "bytes")])
    spec.update(kw)
    j = p.add(P.JoinOp(**spec), parents=[a, b])
    p.add(P.MemorySinkOp(name="out"), parents=[j])
    pkg.verify_plan(p)


def case_join_key_arity(pkg):
    _join(pkg, right_on=["service", "time_"])


def case_join_key_dtype(pkg):
    _join(pkg, left_on=["latency"], right_on=["bytes"])


def case_join_how(pkg):
    _join(pkg, how="sideways")


def case_join_output(pkg):
    _join(pkg, output=[("left", "nope", "x")])


def case_union_schema(pkg):
    P = pkg.P
    p = P.Plan()
    a = p.add(P.MemorySourceOp(table="http_events"))
    b = p.add(P.MemorySourceOp(table="conn_stats"))
    u = p.add(P.UnionOp(), parents=[a, b])
    p.add(P.MemorySinkOp(name="out"), parents=[u])
    pkg.verify_plan(p)


def case_agg_state_sink(pkg):
    P = pkg.P
    p, src = _source_sink(pkg)
    p.add(P.ResultSinkOp(channel="c", payload="agg_state"), parents=[src])
    pkg.verify_plan(p)


def case_not_mergeable(pkg):
    dp = pkg.split(AGG_SRC)
    _cid, ch = _agg_channel(dp)
    ch.agg = copy.copy(ch.agg)
    ch.agg.values = [pkg.P.AggExpr(ch.agg.values[0].out_name, "no_such_uda",
                                   ch.agg.values[0].arg)] + list(ch.agg.values[1:])
    pkg.verify_split(dp)


def case_partial_dict_agg(pkg):
    dp = pkg.split(AGG_SRC)
    _cid, ch = _agg_channel(dp)
    ch.agg.values.append(pkg.P.AggExpr("svc", "any", "service"))
    pkg.verify_split(dp)


def case_unknown_producer(pkg):
    dp = pkg.split(AGG_SRC)
    _cid, ch = _agg_channel(dp)
    ch.producers = list(ch.producers) + ["ghost"]
    pkg.verify_split(dp)


def case_unknown_channel(pkg):
    dp = pkg.split(LIMIT_SRC)
    victim = sorted(dp.agent_plans)[0]
    for op in dp.agent_plans[victim].ops():
        if isinstance(op, pkg.P.ResultSinkOp):
            op.channel = "no_such_channel"
    pkg.verify_split(dp)


def case_missing_bucket_channel(pkg):
    dp = pkg.split(JOIN_SRC)
    assert dp.join_stages, "the join must repartition"
    prefix = dp.join_stages[0].left_prefix
    del dp.channels[f"{prefix}0"]
    pkg.verify_split(dp)


def case_shuffle_schema_mismatch(pkg):
    P = pkg.P
    dp = pkg.split(LIMIT_SRC)
    victim = sorted(dp.agent_plans)[1]

    def flip(ops):
        *chain, sink = ops
        cast = P.MapOp(exprs=[
            ("time_", P.Column("time_")), ("service", P.Column("service")),
            ("latency", P.Column("status")),  # INT64 masquerading as latency
            ("status", P.Column("status")),
        ])
        return chain + [cast, sink]

    dp.agent_plans[victim] = _rebuild_chain(pkg, dp.agent_plans[victim], flip)
    pkg.verify_split(dp)


def case_partition_count_mismatch(pkg):
    dp = pkg.split(JOIN_SRC)
    assert dp.join_stages, "the join must repartition"
    dp.join_stages[0].n_parts += 1
    pkg.verify_split(dp)


def case_channel_agg_mismatch(pkg):
    dp = pkg.split(AGG_SRC)
    _cid, ch = _agg_channel(dp)
    ch.agg = copy.copy(ch.agg)
    ch.agg.groups = ["status"]
    pkg.verify_split(dp)


def case_matview_prefix_divergence(pkg):
    P = pkg.P
    dp = pkg.split(AGG_SRC)
    victim = sorted(dp.agent_plans)[1]

    def reconstant(ops):
        return [P.FilterOp(expr=P.Call("not_equal", (P.Column("status"),
                                                      P.Literal(500, pkg.DT.INT64))))
                if isinstance(op, P.FilterOp) else op for op in ops]

    dp.agent_plans[victim] = _rebuild_chain(pkg, dp.agent_plans[victim], reconstant)
    pkg.verify_split(dp)


def _fused(pkg):
    fused, sink_map = pkg.batching.fuse_members(
        [("q0", pkg.compile(AGG_SRC).plan), ("q1", pkg.compile(AGG2_SRC).plan)],
        pkg.schemas)
    return pkg.planner.plan(fused), sink_map


def case_batch_slot_missing_sink(pkg):
    dp, sink_map = _fused(pkg)
    bad = {p: dict(m) for p, m in sink_map.items()}
    bad["q1"]["out"] = "q1/definitely_not_there"
    pkg.pv.verify_fused_batch(dp, bad)


def case_batch_slot_overlap(pkg):
    dp, sink_map = _fused(pkg)
    bad = {p: dict(m) for p, m in sink_map.items()}
    bad["q1"]["out"] = bad["q0"]["out"]
    pkg.pv.verify_fused_batch(dp, bad)


CASES = {name[len("case_"):].replace("_", "-"): fn
         for name, fn in dict(globals()).items() if name.startswith("case_")}


def test_every_named_invariant_has_a_case():
    """The invariants the reference's docstring names, one case each."""
    import re

    doc = ref_pv.__doc__
    section = doc[doc.index("Checked invariants"):doc.index("Cost model")]
    named = set()
    for line in section.splitlines():
        if line.startswith("  ") and not line.startswith("      "):
            # the names lead the line, joined by " / ", before the prose
            for part in re.split(r"\s+/\s+", line.strip()):
                word = part.split()[0]
                if re.fullmatch(r"[a-z]+(-[a-z]+)+", word):
                    named.add(word)
    assert named == set(CASES)
    assert len(CASES) == 25


@pytest.mark.parametrize("invariant", sorted(CASES))
def test_same_plan_raises_the_same_invariant(invariant):
    got = {}
    for pkg in PKGS:
        with pytest.raises(pkg.pv.PlanVerifyError) as ei:
            CASES[invariant](pkg)
        got[pkg.name] = (ei.value.invariant, ei.value.op_kind, ei.value.code)
    assert got["port"][:2] == got["ref"][:2]
    assert got["port"][0] == invariant
    assert got["port"][2].name == got["ref"][2].name == "INVALID_ARGUMENT"


@pytest.mark.parametrize("src", ["agg", "limit", "join"])
def test_unmutated_splits_verify_clean(src):
    text = {"agg": AGG_SRC, "limit": LIMIT_SRC, "join": JOIN_SRC}[src]
    for pkg in PKGS:
        pkg.verify_split(pkg.split(text))
    for pkg in PKGS:
        dp, sink_map = _fused(pkg)
        pkg.verify_split(dp)
        pkg.pv.verify_fused_batch(dp, sink_map)


def test_verified_envs_agree():
    """The typed pass's output envs (op id → {column: dtype}) agree op by op
    on every agent plan and the merger plan of the join split."""
    envs = {}
    for pkg in PKGS:
        dp = pkg.split(JOIN_SRC)
        envs[pkg.name] = {
            name: {k: ({c: d.name for c, d in v.items()} if v is not None else None)
                   for k, v in pkg.pv.verify_plan(plan, pkg.schemas).items()}
            for name, plan in sorted(dp.agent_plans.items())}
    assert envs["port"] == envs["ref"]


@pytest.mark.parametrize("name", sorted(ref_registry.uda_names()))
def test_uda_reduce_trees_agree(name):
    """`not-mergeable` walks each UDA's reduce_ops() tree: the port's must
    be the reference's, UDA by UDA, with the same finalize paths and
    out_types."""
    if not port_registry.has_uda(name):
        pytest.skip(f"UDA {name!r} is not in the port's registry yet")
    r, p = ref_registry.uda(name), port_registry.uda(name)
    assert p.reduce_ops() == r.reduce_ops()
    assert (p.nullary, p.dict_ok, bool(getattr(p, "needs_dict", False))) == \
        (r.nullary, r.dict_ok, bool(getattr(r, "needs_dict", False)))
    for dt in ("INT64", "FLOAT64", "TIME64NS"):
        try:
            want = r.out_type(getattr(RefDT, dt)).name
        except Exception:
            want = None
        try:
            have = p.out_type(getattr(DT, dt)).name
        except Exception:
            have = None
        assert have == want, dt


def test_port_registry_covers_the_reference_udas():
    assert set(port_registry.uda_names()) == set(ref_registry.uda_names())


# ------------------------------------------------------ LocalCluster


def _stores(pkg_name):
    store_cls, rel_cls, dt = ((RefStore, RefRelation, RefDT) if pkg_name == "ref"
                              else (TableStore, Relation, DT))
    out = {}
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        ts = store_cls()
        t = ts.create("http_events", rel_cls.of(
            ("time_", dt.TIME64NS), ("service", dt.STRING),
            ("latency", dt.FLOAT64), ("status", dt.INT64)), batch_rows=1024)
        n = 2000
        t.write({"time_": NOW - np.arange(n, dtype=np.int64)[::-1] * 1_000_000,
                 "service": rng.choice(["cart", "frontend"], n).tolist(),
                 "latency": rng.exponential(10.0, n),
                 "status": rng.choice([200, 404, 500], n)})
        out[f"pem{seed}"] = ts
    return out


def _cluster(pkg_name):
    if pkg_name == "ref":
        return RefCluster(_stores("ref"), n_devices_per_agent=1)
    return LocalCluster(_stores("port"), device="cpu")


@pytest.fixture(autouse=True)
def _views_off():
    """Views off in both packages, so every query runs the split it was
    verified on."""
    saved = [(f, f.get("PL_MATVIEW_ENABLED")) for f in (ref_flags, port_flags)]
    for f, _v in saved:
        f.set_for_testing("PL_MATVIEW_ENABLED", False)
    yield
    for f, v in saved:
        f.set_for_testing("PL_MATVIEW_ENABLED", v)


def test_cold_query_verifies_once_and_warm_queries_never():
    counts = {}
    for pkg in PKGS:
        c = _cluster(pkg.name)
        v0 = pkg.metrics.counter_value("px_plan_verify_total")
        first = c.query(AGG_SRC)["out"]
        v1 = pkg.metrics.counter_value("px_plan_verify_total")
        for _ in range(5):
            again = c.query(AGG_SRC)["out"]
        v2 = pkg.metrics.counter_value("px_plan_verify_total")
        assert again.num_rows == first.num_rows > 0
        counts[pkg.name] = (v1 - v0, v2 - v1)
    assert counts["port"] == counts["ref"] == (1, 0)


def test_mutated_split_raises_before_any_agent_runs(monkeypatch):
    """A miscompiled split never reaches an executor: the port's cluster
    raises PlanVerifyError, counted as a failure, with no PlanExecutor
    built."""
    import pixie_tpu_torch.parallel.cluster as cluster_mod

    c = _cluster("port")
    q = port_compile(AGG_SRC, c.schemas(), now=NOW)
    real = c.planner

    class Mutator:
        def plan(self, logical):
            dp = real.plan(logical)
            for ch in dp.channels.values():
                if ch.kind == "agg_state":
                    ch.agg = copy.copy(ch.agg)
                    ch.agg.values = [port_plan.AggExpr(
                        ch.agg.values[0].out_name, "no_such_uda",
                        ch.agg.values[0].arg)] + list(ch.agg.values[1:])
            return dp

    def no_executor(*a, **k):
        raise AssertionError("an executor ran a split that failed verification")

    c.planner = Mutator()
    monkeypatch.setattr(cluster_mod, "PlanExecutor", no_executor)
    f0 = port_metrics.counter_value("px_plan_verify_failures_total")
    with pytest.raises(port_pv.PlanVerifyError) as ei:
        c.execute(q.plan)
    assert ei.value.invariant == "not-mergeable"
    assert port_metrics.counter_value("px_plan_verify_failures_total") == f0 + 1


def test_flag_off_skips_verification():
    saved = port_flags.get("PX_PLAN_VERIFY")
    port_flags.set_for_testing("PX_PLAN_VERIFY", False)
    try:
        c = _cluster("port")
        before = port_metrics.counter_value("px_plan_verify_total")
        assert c.query(AGG_SRC)["out"].num_rows > 0
        assert port_metrics.counter_value("px_plan_verify_total") == before
    finally:
        port_flags.set_for_testing("PX_PLAN_VERIFY", saved)


def test_fused_batch_verifies_once_per_signature():
    """The batch leader verifies the fused split (typed pass and slot
    invariants) once per batch signature; a warm batch verifies nothing."""
    from pixie_tpu_torch.serving import batching

    saved = {n: port_flags.get(n) for n in ("PL_QUERY_BATCHING", "PL_BATCH_MAX_QUERIES",
                                            "PX_MQ_FUSION")}
    port_flags.set_for_testing("PL_QUERY_BATCHING", True)
    port_flags.set_for_testing("PL_BATCH_MAX_QUERIES", 2)
    port_flags.set_for_testing("PX_MQ_FUSION", 1)
    try:
        c = _cluster("port")
        c._batcher = batching.BatchCollector()
        c._batcher.force_wait = True
        import threading

        def round_trip():
            got = {}
            th = [threading.Thread(target=lambda t=t, s=s: got.update({t: c.query(s)["out"]}))
                  for t, s in (("a", AGG_SRC), ("b", AGG2_SRC))]
            for x in th:
                x.start()
            for x in th:
                x.join(timeout=120)
            return got

        v0 = port_metrics.counter_value("px_plan_verify_total")
        first = round_trip()
        v1 = port_metrics.counter_value("px_plan_verify_total")
        second = round_trip()
        v2 = port_metrics.counter_value("px_plan_verify_total")
        assert first["a"].exec_stats["batch"]["size"] == 2
        assert second["b"].exec_stats["batch"]["size"] == 2
        assert (v1 - v0, v2 - v1) == (1, 0)
    finally:
        for n, v in saved.items():
            port_flags.set_for_testing(n, v)
