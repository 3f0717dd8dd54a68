"""Concurrent-query batching and the multi-query gang: pixie_tpu_torch
against pixie_tpu.

The building blocks of serving/batching.py (group keys, the view shape,
slots, signatures, member fusion) give the same answers in both packages,
and the fused plans are the same plans.  The executor's gang runs the
partial aggregates of a fused agent plan over one shared scan: the port's
(device="cpu": the plain version of kernel G1) against the reference's
(PX_MQ_FUSION=1, force_backend="tpu", mesh=None, as
tests/test_query_batching.py runs it): group key values, counts, int sums,
min / max and sketch cells exactly, float64 sums to rtol 1e-12 (the
reference sums by one-hot products, the plain version by index_add_).  On
the CPU the port's gang is bit for bit its own per-sink route.
LocalCluster's batching gate forms batches deterministically through
`BatchCollector.force_wait` and a full batch, never through sleeps.
"""
import threading

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine.executor import PlanExecutor as RefExecutor
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.plan import plan as ref_plan
from pixie_tpu.serving import batching as ref_batching
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation

import pixie_tpu_torch.engine.executor as port_executor
from pixie_tpu_torch import flags, metrics
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine.executor import PlanExecutor, mq_fusion_enabled
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.plan import plan as port_plan
from pixie_tpu_torch.serving import batching
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation
from pixie_tpu_torch.udf import registry as port_registry
from pixie_tpu_torch.udf.udf import UDA

S_SERVICE = """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service']).agg(cnt=('latency', px.count),
                                 avg=('latency', px.mean))
px.display(df, 'out')
"""

S_STATUS = """
df = px.DataFrame(table='http_events')
df = df[df.latency > 5.0]
df = df.groupby(['status']).agg(mx=('latency', px.max),
                                p50=('latency', px.p50))
px.display(df, 'out')
"""

S_JOINY = """
left = px.DataFrame(table='http_events')
l = left.groupby('service').agg(cnt=('latency', px.count))
right = px.DataFrame(table='http_events')
r = right.groupby('service').agg(mx=('latency', px.max))
df = l.merge(r, how='inner', left_on='service', right_on='service',
             suffixes=['', '_r'])
px.display(df, 'out')
"""

#: the reference's load harness, pixie_tpu/serving/load_bench.py BATCH_SCRIPTS
BATCH_SCRIPTS = [
    """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean))
px.display(df, 'out')
""",
    """
df = px.DataFrame(table='http_events')
df = df[df.latency > 10.0]
df = df.groupby('service').agg(cnt=('latency', px.count),
                               mx=('latency', px.max))
px.display(df, 'out')
""",
    """
df = px.DataFrame(table='http_events')
df = df.groupby('status').agg(p50=('latency', px.p50),
                              p99=('latency', px.p99))
px.display(df, 'out')
""",
    """
df = px.DataFrame(table='http_events')
df = df[df.status == 200]
df = df.groupby('service').agg(avg=('latency', px.mean),
                               mn=('latency', px.min))
px.display(df, 'out')
""",
]

#: the other leaf updates of G1 that a planner split reaches: int64 sum,
#: min / max of int64 and time, variance, stddev, quantiles, a computed value
#: column, and window keys of two widths, each with its own origin (any and
#: sample ship rows through the planner: test_gang_any_and_sample)
S_WIDE = """
df = px.DataFrame(table='http_events')
df.lat_ms = df.latency * 0.001 + df.status / 7
df = df.groupby(['service']).agg(
    s=('status', px.sum), lo=('status', px.min), hi=('time_', px.max),
    v=('latency', px.variance), sd=('lat_ms', px.stddev), q=('latency', px.quantiles),
    p10=('lat_ms', px.p10))
px.display(df, 'out')
"""
S_WINDOW = """
df = px.DataFrame(table='http_events')
df.timestamp = px.bin(df.time_, 1000000)
df = df.groupby(['timestamp', 'service']).agg(cnt=('latency', px.count),
                                             p90=('latency', px.p90))
px.display(df, 'out')
"""
S_WINDOW2 = """
df = px.DataFrame(table='http_events')
df = df[df.status != 500]
df.timestamp = px.bin(df.time_, 3000000)
df = df.groupby(['timestamp']).agg(mx=('latency', px.max), n=('status', px.count))
px.display(df, 'out')
"""
GANG_SCRIPTS = BATCH_SCRIPTS + [S_WIDE, S_WINDOW, S_WINDOW2]

FLAG_NAMES = ("PL_QUERY_BATCHING", "PL_BATCH_WINDOW_MS", "PL_BATCH_MAX_QUERIES",
              "PX_MQ_FUSION", "PX_FEED_ROWS")
REF_ONLY = ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")


@pytest.fixture(autouse=True)
def _flags():
    """Each test sets flags through both packages' set_for_testing; all are
    restored after it.  The reference runs with standing views and tracing
    off, as the port runs."""
    saved = {n: flags.get(n) for n in FLAG_NAMES}
    ref_saved = {n: ref_flags.get(n) for n in FLAG_NAMES + REF_ONLY}
    for n in REF_ONLY:
        ref_flags.set_for_testing(n, False)
    yield
    for n, v in saved.items():
        flags.set_for_testing(n, v)
    for n, v in ref_saved.items():
        ref_flags.set_for_testing(n, v)


def both(name, value):
    flags.set_for_testing(name, value)
    ref_flags.set_for_testing(name, value)


def _cols(seed: int, n: int = 30_000) -> dict:
    rng = np.random.default_rng(seed)
    svc = np.array([f"svc-{i}" for i in range(6)])
    return {"time_": np.arange(n, dtype=np.int64) * 1000,
            "service": svc[rng.integers(0, len(svc), n)],
            "latency": rng.exponential(20.0, n),
            "status": rng.choice([200, 404, 500], n)}


def _store(pkg: str, cols: dict):
    ts, rel_cls, dt = ((RefStore(), RefRelation, RefDT) if pkg == "ref"
                       else (TableStore(), Relation, DT))
    rel = rel_cls.of(("time_", dt.TIME64NS), ("service", dt.STRING),
                     ("latency", dt.FLOAT64), ("status", dt.INT64))
    ts.create("http_events", rel, batch_rows=1 << 13, max_bytes=1 << 32).write(cols)
    return ts


def _clusters(cols_by_agent: dict):
    ref = RefCluster({a: _store("ref", c) for a, c in cols_by_agent.items()},
                     n_devices_per_agent=1)
    port = LocalCluster({a: _store("port", c) for a, c in cols_by_agent.items()},
                        device="cpu")
    return ref, port


def _fused_agent_plans(ref, port, scripts, agent="pem0"):
    """The fused plan of `scripts` and its agent plan, in both packages."""
    out = []
    for cl, comp, bat in ((ref, ref_compile, ref_batching), (port, compile_pxl, batching)):
        qs = [comp(s, cl.schemas()) for s in scripts]
        fused, sink_map = bat.fuse_members([(f"q{i}", q.plan) for i, q in enumerate(qs)],
                                           cl.schemas())
        out.append((fused, sink_map, cl.planner.plan(fused).agent_plans[agent]))
    return out


# ------------------------------------------------------------ comparisons


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix, np.asarray(tree))]


def assert_payload_same(got, want, float_rtol=1e-12):
    """Two PartialAggBatch: key values, counts, int sums, min / max and
    sketch cells exactly; float64 state leaves to float_rtol."""
    assert sorted(got.key_cols) == sorted(want.key_cols)
    keys = sorted(got.key_cols)

    def order(pb):
        return sorted(range(pb.num_groups),
                      key=lambda i: tuple(str(pb.key_cols[k][i]) for k in keys))

    og, ow = order(got), order(want)
    assert len(og) == len(ow)
    for k in keys:
        assert [str(got.key_cols[k][i]) for i in og] == [str(want.key_cols[k][i]) for i in ow], k
    assert {k: v.name for k, v in got.key_dtypes.items()} == \
        {k: v.name for k, v in want.key_dtypes.items()}
    assert sorted(got.states) == sorted(want.states)
    for name in got.states:
        fg, fw = _flat(got.states[name]), _flat(want.states[name])
        assert [p for p, _ in fg] == [p for p, _ in fw], name
        for (path, g), (_p, w) in zip(fg, fw):
            g, w = g[og], w[ow]
            assert g.dtype == w.dtype, (name, path, g.dtype, w.dtype)
            if g.dtype == np.float64 and float_rtol:
                np.testing.assert_allclose(g, w, rtol=float_rtol, atol=0,
                                           err_msg=f"{name}/{path}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{name}/{path}")


def _rows(r):
    names = r.relation.names()
    return names, sorted(map(tuple, zip(*[map(str, r.decoded(n)) for n in names])))


def assert_results_same(got, want):
    """Two QueryResults: the same rows, float columns to rtol 1e-12."""
    assert got.relation.names() == want.relation.names()
    assert got.num_rows == want.num_rows
    names = got.relation.names()

    def srt(r):
        keys = [n for n in names if r.columns[n].dtype.kind not in "f"]
        idx = sorted(range(r.num_rows),
                     key=lambda i: tuple(str(r.decoded(k)[i]) for k in keys))
        return {n: np.asarray(r.decoded(n))[idx] for n in names}

    g, w = srt(got), srt(want)
    for n in names:
        if g[n].dtype.kind == "f":
            np.testing.assert_allclose(g[n], w[n], rtol=1e-12, atol=0, err_msg=n)
        else:
            assert g[n].tolist() == w[n].tolist(), n


# ------------------------------------------------------- building blocks


@pytest.fixture(scope="module")
def pair():
    return _clusters({"pem0": _cols(3)})


@pytest.mark.parametrize("script", [S_SERVICE, S_STATUS, S_JOINY] + BATCH_SCRIPTS,
                         ids=["service", "status", "joiny", "b0", "b1", "b2", "b3"])
def test_group_key_and_view_shape_match_reference(pair, script):
    ref, port = pair
    rq, pq = ref_compile(script, ref.schemas()), compile_pxl(script, port.schemas())
    assert batching.group_key(pq.plan) == ref_batching.group_key(rq.plan)
    assert batching.view_shaped(pq.plan) == ref_batching.view_shaped(rq.plan)
    # no standing views in the port: no member leaves a batch for one
    assert batching.leaves_for_matview(pq.plan) is False


def test_group_key_shapes(pair):
    _ref, port = pair
    q = compile_pxl(S_SERVICE, port.schemas())
    assert batching.group_key(q.plan) == ("http_events", None, None, None)
    assert batching.group_key(compile_pxl(S_JOINY, port.schemas()).plan) is None
    assert batching.view_shaped(q.plan)
    assert not batching.view_shaped(compile_pxl(S_JOINY, port.schemas()).plan)


@pytest.mark.parametrize("scripts", [[S_SERVICE, S_STATUS], [S_SERVICE, S_SERVICE],
                                     BATCH_SCRIPTS, GANG_SCRIPTS],
                         ids=["two", "identical", "batch_scripts", "gang_scripts"])
def test_fuse_members_matches_reference(pair, scripts):
    """The same fused plan: ops, the one shared scan over the column union,
    merged sibling aggs, and the sink map."""
    ref, port = pair
    (rf, rmap, rap), (pf, pmap, pap) = _fused_agent_plans(ref, port, scripts)
    assert pf.to_dict() == rf.to_dict()
    assert pmap == rmap
    assert pap.to_dict() == rap.to_dict()
    scans = [o for o in pf.ops() if isinstance(o, port_plan.MemorySourceOp)]
    assert len(scans) == 1
    n_aggs = len([o for o in pf.ops() if isinstance(o, port_plan.AggOp)])
    assert n_aggs == len([o for o in rf.ops() if isinstance(o, ref_plan.AggOp)])
    if scripts[0] is scripts[1]:
        assert n_aggs == 1  # identical chains hash-cons into one agg


def test_dedup_slots_and_signature_match_reference():
    for bat in (batching, ref_batching):
        ms = [bat.Member(("a",), "PA"), bat.Member(("a",), "PA"), bat.Member(("b",), "PB")]
        plans, slots = bat.dedup_slots(ms)
        assert plans == ["PA", "PB"] and slots == [0, 0, 1]
        assert bat.batch_signature(ms) == (repr(("a",)), repr(("b",)))


def test_collector_window_and_slot_order():
    """A full batch (max_n) closes at once: the leader returns both members
    in plan-cache-key order and the joiner gets the leader's delivery."""
    c = batching.BatchCollector()
    m1, m2 = batching.Member(("b",), None), batching.Member(("a",), None)
    got = {}

    def leader():
        got["m1"] = c.collect("k", m1, window_s=30.0, max_n=2, wait=True)

    tl = threading.Thread(target=leader)
    tl.start()
    while True:  # until the leader's batch is open
        with c._lock:
            if "k" in c._pending:
                break
    got["m2"] = c.collect("k", m2, window_s=30.0, max_n=2, wait=True)
    tl.join(timeout=30)
    assert not tl.is_alive()
    assert got["m2"] is None and [m.key for m in got["m1"]] == [("a",), ("b",)]
    m2.deliver({"ok": 1}, {})
    assert m2.wait(1.0)[0] == {"ok": 1}


def test_metrics_counters_and_histogram():
    before = metrics.counter_value("px_batch_formed_total")
    q0 = metrics.counter_value("px_batch_queries_total")
    batching.note_formed(3)
    batching.note_fallback("solo")
    assert metrics.counter_value("px_batch_formed_total") == before + 1
    assert metrics.counter_value("px_batch_queries_total") == q0 + 3
    assert metrics.counter_value("px_batch_fallback_total", {"reason": "solo"}) >= 1
    assert "px_batch_size_bucket" in metrics.render()
    assert batching.recent_size_p50() > 0


# ------------------------------------------------------ the executor's gang


def _run_ref_agent(ap, store, fusion: int):
    ref_flags.set_for_testing("PX_MQ_FUSION", fusion)
    ex = RefExecutor(ap, store, None, mesh=None, force_backend="tpu")
    return ex.run_agent(), ex.stats


def _run_port_agent(ap, store, fusion: int, device="cpu"):
    flags.set_for_testing("PX_MQ_FUSION", fusion)
    ex = PlanExecutor(ap, store, None, device=device)
    return ex.run_agent(), ex.stats


@pytest.mark.parametrize("scripts", [BATCH_SCRIPTS, GANG_SCRIPTS, [S_SERVICE, S_STATUS]],
                         ids=["batch_scripts", "every_leaf", "two"])
@pytest.mark.parametrize("feed_rows", [1 << 24, 1 << 13], ids=["one_feed", "many_feeds"])
def test_gang_matches_reference_gang(pair, scripts, feed_rows):
    ref, port = pair
    both("PX_FEED_ROWS", feed_rows)
    (_rf, _rm, rap), (_pf, _pm, pap) = _fused_agent_plans(ref, port, scripts)
    want, rstats = _run_ref_agent(rap, ref.stores["pem0"], 1)
    got, pstats = _run_port_agent(pap, port.stores["pem0"], 1)
    assert rstats.get("mq_fused") == pstats.get("mq_fused") >= 2
    assert sorted(got) == sorted(want)
    for cid in got:
        assert_payload_same(got[cid], want[cid])


@pytest.mark.parametrize("scripts", [BATCH_SCRIPTS, GANG_SCRIPTS],
                         ids=["batch_scripts", "every_leaf"])
def test_gang_bit_equal_to_per_sink_route(pair, scripts):
    _ref, port = pair
    both("PX_FEED_ROWS", 1 << 13)
    (_rf, _rm, _rap), (_pf, _pm, pap) = _fused_agent_plans(pair[0], port, scripts)
    got, st = _run_port_agent(pap, port.stores["pem0"], 1)
    base, st0 = _run_port_agent(pap, port.stores["pem0"], 0)
    assert "mq_fused" not in st0
    assert sorted(got) == sorted(base)
    for cid in got:
        assert got[cid].to_bytes() == base[cid].to_bytes(), cid
    assert st["rows_scanned"] == 30_000  # the shared scan read once
    n_aggs = len([o for o in pap.ops() if isinstance(o, port_plan.AggOp)])
    assert st0["rows_scanned"] == 30_000 * n_aggs


def test_gang_counts_members_and_waves(pair):
    _ref, port = pair
    both("PX_FEED_ROWS", 1 << 13)
    (_rf, _rm, _rap), (_pf, _pm, pap) = _fused_agent_plans(pair[0], port, BATCH_SCRIPTS)
    _out, st = _run_port_agent(pap, port.stores["pem0"], 1)
    assert st["mq_fused"] == 4
    # 30,000 rows: three sealed 8,192-row batches, each its own feed at
    # PX_FEED_ROWS = 8,192, and the hot remainder
    assert st["mq_waves"] == st["feeds"] == 4
    assert [o["label"] for o in st["operators"]] == ["mq_gang[4]"]


@pytest.mark.parametrize("flag, device, want", [
    (0, "cpu", False), (0, "cuda", False), (1, "cpu", True), (1, "cuda", True),
    (-1, "cpu", False), (-1, "cuda", True)])
def test_mq_fusion_predicate(flag, device, want):
    flags.set_for_testing("PX_MQ_FUSION", flag)
    assert mq_fusion_enabled(torch_device(device)) is want


def torch_device(name):
    import torch

    return torch.device(name)


def test_mq_fusion_auto_is_off_on_a_cpu_executor(pair):
    _ref, port = pair
    (_rf, _rm, _rap), (_pf, _pm, pap) = _fused_agent_plans(pair[0], port, BATCH_SCRIPTS)
    _out, st = _run_port_agent(pap, port.stores["pem0"], -1)
    assert "mq_fused" not in st


def _hand_plan(mod, member_b):
    """An agent plan of two partial aggregates over one scan: member A
    (count and mean by service) and member_b(mod, src) → its AggOp."""
    p = mod.Plan()
    src = p.add(mod.MemorySourceOp(table="http_events"))
    a = p.add(mod.AggOp(groups=["service"], values=[
        mod.AggExpr("cnt", "count", None), mod.AggExpr("avg", "mean", "latency")],
        partial=True), parents=[src])
    p.add(mod.ResultSinkOp(channel="a", payload="agg_state"), parents=[a])
    b = member_b(mod, p, src)
    p.add(mod.ResultSinkOp(channel="b", payload="agg_state"), parents=[b])
    return p


def _any_member(mod, p, src):
    return p.add(mod.AggOp(groups=["status"], values=[
        mod.AggExpr("a", "any", "status"), mod.AggExpr("sm", "sample", "latency"),
        mod.AggExpr("b", "any", "time_")], partial=True), parents=[src])


def test_gang_any_and_sample(pair):
    """any / sample over numbers (a min leaf of int64 and float64 values)
    in a gang: the planner ships these as rows, so the agent plan is built
    by hand."""
    ref, port = pair
    want, rstats = _run_ref_agent(_hand_plan(ref_plan, _any_member), ref.stores["pem0"], 1)
    got, pstats = _run_port_agent(_hand_plan(port_plan, _any_member), port.stores["pem0"], 1)
    assert rstats.get("mq_fused") == pstats.get("mq_fused") == 2
    for cid in ("a", "b"):
        assert_payload_same(got[cid], want[cid])


def _limit_member(mod, p, src):
    lim = p.add(mod.LimitOp(n=5000), parents=[src])
    return p.add(mod.AggOp(groups=["status"], values=[mod.AggExpr("n", "count", None)],
                           partial=True), parents=[lim])


def _float_key_member(mod, p, src):
    return p.add(mod.AggOp(groups=["latency"], values=[mod.AggExpr("n", "count", None)],
                           partial=True), parents=[src])


def _string_any_member(mod, p, src):
    return p.add(mod.AggOp(groups=["status"], values=[mod.AggExpr("s", "any", "service")],
                           partial=True), parents=[src])


def _ml_fit_member(mod, p, src):
    return p.add(mod.AggOp(groups=["status"], values=[
        mod.AggExpr("m", "_build_request_path_clusters", "service")],
        partial=True), parents=[src])


@pytest.mark.parametrize("member_b", [_limit_member, _float_key_member],
                         ids=["limit", "float_key"])
def test_gang_bails_to_the_per_sink_route(pair, member_b):
    """A member with a limit, or with a key that takes the sorted fallback,
    sends the whole gang to the per-sink route, with the reference's
    results."""
    ref, port = pair
    want, rstats = _run_ref_agent(_hand_plan(ref_plan, member_b), ref.stores["pem0"], 1)
    got, pstats = _run_port_agent(_hand_plan(port_plan, member_b), port.stores["pem0"], 1)
    assert "mq_fused" not in rstats and "mq_fused" not in pstats
    assert "mq_waves" not in pstats
    for cid in ("a", "b"):
        assert_payload_same(got[cid], want[cid])


@pytest.mark.parametrize("member_b", [_string_any_member, _ml_fit_member],
                         ids=["string_any", "ml_fit"])
def test_gang_bails_on_dictionary_valued_members(pair, member_b):
    """A dictionary-valued aggregate (a string `any`, a model-fitting UDA)
    sends the gang to the per-sink route, which refuses to ship its state as
    a partial — in both packages (the planner ships such aggregates as
    rows)."""
    ref, port = pair
    with pytest.raises(Exception, match="dict-valued aggregates must ship rows"):
        _run_ref_agent(_hand_plan(ref_plan, member_b), ref.stores["pem0"], 1)
    flags.set_for_testing("PX_MQ_FUSION", 1)
    ex = PlanExecutor(_hand_plan(port_plan, member_b), port.stores["pem0"], None,
                      device="cpu")
    assert ex._gang_agg_payloads() == {}
    assert "mq_fused" not in ex.stats
    with pytest.raises(Exception, match="dict-valued aggregates must ship rows"):
        ex.run_agent()


class _CubeSumUDA(UDA):
    """A sum of cubes: an aggregate whose state G1 cannot update."""

    name = "cube_sum"

    def out_type(self, in_type):
        return DT.FLOAT64

    def init(self, num_groups, in_dtype, device):
        import torch

        return torch.zeros((num_groups,), dtype=torch.float64, device=device)

    def update(self, state, gid, value, mask, num_groups):
        from pixie_tpu_torch.ops.groupby import masked_segment_sum

        v = value.to(state.dtype)
        return masked_segment_sum(v * v * v, gid, num_groups, mask, out=state)

    def reduce_ops(self):
        return "add"

    def finalize_host(self, state_np):
        return np.asarray(state_np)


def test_gang_bails_on_a_uda_g1_cannot_update(pair):
    _ref, port = pair
    port_registry.register_uda("cube_sum", _CubeSumUDA)
    try:
        def member(mod, p, src):
            return p.add(mod.AggOp(groups=["status"], values=[
                mod.AggExpr("c", "cube_sum", "latency")], partial=True), parents=[src])

        plan = _hand_plan(port_plan, member)
        got, st = _run_port_agent(plan, port.stores["pem0"], 1)
        base, _st0 = _run_port_agent(plan, port.stores["pem0"], 0)
    finally:
        port_registry._uda.pop("cube_sum", None)
    assert "mq_fused" not in st
    for cid in ("a", "b"):
        assert got[cid].to_bytes() == base[cid].to_bytes()


@pytest.mark.parametrize("chunk", [0, 2], ids=["whole", "sliced"])
def test_run_agent_stream_equal_with_and_without_the_gang(pair, chunk):
    _ref, port = pair
    (_rf, _rm, _rap), (_pf, _pm, pap) = _fused_agent_plans(pair[0], port, GANG_SCRIPTS)
    out = {}
    for fusion in (1, 0):
        flags.set_for_testing("PX_MQ_FUSION", fusion)
        ex = PlanExecutor(pap, port.stores["pem0"], None, device="cpu")
        out[fusion] = [(cid, pb.to_bytes()) for cid, pb in ex.run_agent_stream(chunk)]
        assert ("mq_fused" in ex.stats) == bool(fusion)
    assert out[1] == out[0]
    assert len(out[1]) >= len(GANG_SCRIPTS)


# ------------------------------------------------------------ LocalCluster


def _batched_round(cluster, scripts, rounds: int):
    """`rounds` rounds of one query per script from its own thread; each
    round is one full batch (max_n = len(scripts)) that the leader waits for
    (force_wait).  → per script, its results of every round."""
    cluster._batcher = batching.BatchCollector()
    cluster._batcher.force_wait = True
    flags.set_for_testing("PL_BATCH_MAX_QUERIES", len(scripts))
    flags.set_for_testing("PL_BATCH_WINDOW_MS", 60_000.0)
    got = {i: [] for i in range(len(scripts))}
    errs = []
    barrier = threading.Barrier(len(scripts), timeout=120)

    def run(i):
        try:
            for _ in range(rounds):
                barrier.wait()
                got[i].append(cluster.query(scripts[i])["out"])
        except Exception as e:  # surfaced below
            errs.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(scripts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    return got


def test_cluster_concurrent_batches_match_reference_and_flag_off():
    ref, port = _clusters({"pem0": _cols(5)})
    both("PL_QUERY_BATCHING", False)
    solo = [port.query(s)["out"] for s in BATCH_SCRIPTS]
    want = [ref.query(s)["out"] for s in BATCH_SCRIPTS]
    for s, w in zip(solo, want):
        assert "batch" not in s.exec_stats
        assert_results_same(s, w)
    flags.set_for_testing("PL_QUERY_BATCHING", True)
    flags.set_for_testing("PX_MQ_FUSION", 1)
    formed0 = metrics.counter_value("px_batch_formed_total")
    got = _batched_round(port, BATCH_SCRIPTS, rounds=2)
    assert metrics.counter_value("px_batch_formed_total") == formed0 + 2
    for i, rs in got.items():
        for r in rs:
            assert r.exec_stats["batch"]["size"] == len(BATCH_SCRIPTS)
            assert r.exec_stats["batch"]["slots"] == len(BATCH_SCRIPTS)
            assert_results_same(r, want[i])
            assert _rows(r) == _rows(solo[i])
        agents = rs[-1].exec_stats["agents"]["pem0"]
        assert agents["mq_fused"] == len(BATCH_SCRIPTS) and agents["mq_waves"] >= 1
    # the second round reused the first's fused plan and split
    assert len(port._batch_splits) == 1


def test_identical_members_share_one_slot():
    _ref, port = _clusters({"pem0": _cols(6, 5000)})
    flags.set_for_testing("PL_QUERY_BATCHING", True)
    flags.set_for_testing("PX_MQ_FUSION", 1)
    scripts = [BATCH_SCRIPTS[0]] * 3 + [BATCH_SCRIPTS[2]]
    got = _batched_round(port, scripts, rounds=1)
    slots = {got[i][0].exec_stats["batch"]["slot"] for i in range(3)}
    assert len(slots) == 1
    assert got[3][0].exec_stats["batch"]["slots"] == 2
    assert _rows(got[0][0]) == _rows(got[1][0]) == _rows(got[2][0])


def test_cluster_flag_off_is_the_unbatched_path():
    _ref, port = _clusters({"pem0": _cols(7, 5000)})
    flags.set_for_testing("PL_QUERY_BATCHING", False)
    formed0 = metrics.counter_value("px_batch_formed_total")
    r1 = port.query(S_SERVICE)["out"]
    r2 = port.query(S_SERVICE)["out"]  # warm repeat
    assert _rows(r1) == _rows(r2)
    assert "batch" not in r1.exec_stats
    assert metrics.counter_value("px_batch_formed_total") == formed0


def test_three_store_cluster_merges_deferred_gang_members_with_m1(monkeypatch):
    """Three agents with equal dictionaries: each agent's gang leaves every
    member's state on the device, M1 (here its plain route) merges each
    member across the agents, and the results equal the reference's."""
    calls = []
    real = port_executor.merge_states

    def counting(reduce_tree, states):
        calls.append(len(states))
        return real(reduce_tree, states)

    monkeypatch.setattr(port_executor, "merge_states", counting)
    cols = _cols(8, 12_000)
    ref, port = _clusters({f"pem{a}": cols for a in range(3)})
    both("PL_QUERY_BATCHING", False)
    want = [ref.query(s)["out"] for s in BATCH_SCRIPTS]
    flags.set_for_testing("PL_QUERY_BATCHING", True)
    flags.set_for_testing("PX_MQ_FUSION", 1)
    got = _batched_round(port, BATCH_SCRIPTS, rounds=1)
    assert calls == [3] * len(BATCH_SCRIPTS)
    for i, w in enumerate(want):
        r = got[i][0]
        assert r.exec_stats["agents"]["pem1"]["mq_fused"] == len(BATCH_SCRIPTS)
        assert_results_same(r, w)
