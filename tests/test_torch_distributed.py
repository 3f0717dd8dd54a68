"""Distributed partial→final execution: pixie_tpu_torch against pixie_tpu.

The single-device cases of tests/test_distributed.py run through both
packages' LocalCluster over the same agent stores (numpy seeds, private
dictionary code spaces per agent): the reference with one device per agent
on the JAX CPU, the port with device="cpu".  Each compares the distributed
split (`DistributedPlan.to_dict()`) and the results: counts, int sums,
min / max and sketch quantiles exactly, float64 sums and means to rtol 1e-12
(a different summation order).  Both packages run with standing views off
(tests/test_torch_matview.py runs them on).

Beyond the reference's cases: 8 agents with identical dictionaries (bench
config #4's shape, small) take the gang route — every agent's state merges
through ops/merge.py's `merge_states` (kernel M1 on the card, its plain
version here) — and equal a single-store oracle; agents with different
dictionaries take the host value-keyed merge and never call it; a computed
key takes `_sorted_partial_batch`; and two agents run concurrently.
"""
import threading

import numpy as np
import pandas as pd
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation

from pixie_tpu_torch import flags as port_flags
import pixie_tpu_torch.engine.executor as port_executor
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.ops import _build
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.plan.plan import AggOp, MemorySourceOp, RemoteSourceOp
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation

NOW = 1_700_000_000_000_000_000
N_PER_AGENT = 3000
SERVICES = {"pem0": ["cart", "frontend"], "pem1": ["frontend", "checkout", "cart"],
            "pem2": ["payments"]}


@pytest.fixture(scope="module", autouse=True)
def reference_flags():
    """These cases measure the rescan route: both packages run with standing
    views off (tests/test_torch_matview.py runs them on), and the reference
    without its flight recorder, which the port does not have."""
    saved = {f: ref_flags.get(f) for f in ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")}
    for f in saved:
        ref_flags.set_for_testing(f, False)
    port_views = port_flags.get("PL_MATVIEW_ENABLED")
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    yield
    for f, v in saved.items():
        ref_flags.set_for_testing(f, v)
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", port_views)


def _http_cols(seed: int, services, n: int = N_PER_AGENT) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "time_": NOW - np.arange(n, dtype=np.int64)[::-1] * 1_000_000,
        "service": rng.choice(services, n).tolist(),
        "latency": rng.exponential(10.0, n),
        "status": rng.choice([200, 404, 500], n),
    }


def _store(pkg: str, cols: dict, batch_rows: int = 1024):
    ts, rel_cls, dt = ((RefStore(), RefRelation, RefDT) if pkg == "ref"
                       else (TableStore(), Relation, DT))
    rel = rel_cls.of(("time_", dt.TIME64NS), ("service", dt.STRING),
                     ("latency", dt.FLOAT64), ("status", dt.INT64))
    ts.create("http_events", rel, batch_rows=batch_rows).write(cols)
    return ts


def _clusters(cols_by_agent: dict):
    ref = RefCluster({a: _store("ref", c) for a, c in cols_by_agent.items()},
                     n_devices_per_agent=1)
    port = LocalCluster({a: _store("port", c) for a, c in cols_by_agent.items()},
                        device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def pair():
    return _clusters({a: _http_cols(i, s) for i, (a, s) in enumerate(SERVICES.items())})


@pytest.fixture(scope="module")
def oracle_df():
    frames = [pd.DataFrame(_http_cols(i, s)) for i, s in enumerate(SERVICES.values())]
    return pd.concat(frames, ignore_index=True)


def _frame(res, by):
    df = res.to_pandas()
    return df.sort_values(by).reset_index(drop=True) if by else df


def assert_same(got: pd.DataFrame, want: pd.DataFrame):
    """Equal frames: float columns to rtol 1e-12, everything else exactly."""
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f" or w.dtype.kind == "f":
            np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                       rtol=1e-12, atol=0, err_msg=c)
        else:
            assert g.tolist() == w.tolist(), c


def run_both(pair, src, by=None, sink="output", **kw):
    """(port frame, reference frame) of one script through both clusters, and
    the two distributed splits' dicts."""
    ref, port = pair
    rq = ref_compile(src, ref.schemas(), now=NOW, **kw)
    pq = compile_pxl(src, port.schemas(), now=NOW, **kw)
    rdp, pdp = ref.planner.plan(rq.plan), port.planner.plan(pq.plan)
    assert pdp.to_dict() == rdp.to_dict()
    want = _frame(ref.execute(rq.plan)[sink], by)
    got = _frame(port.execute(pq.plan)[sink], by)
    assert_same(got, want)
    return got, pdp


@pytest.fixture
def merge_calls(monkeypatch):
    """Counts the executor's calls of the state merge (kernel M1 on the card,
    whose launch counter cannot rise on the CPU)."""
    calls = []
    real = port_executor.merge_states

    def counting(reduce_tree, states):
        calls.append(len(states))
        return real(reduce_tree, states)

    monkeypatch.setattr(port_executor, "merge_states", counting)
    return calls


def test_planner_splits_agg(pair):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby('service').agg(cnt=('latency', px.count))
px.display(df)
"""
    _got, dp = run_both(pair, src, ["service"])
    assert set(dp.agent_plans) == {"pem0", "pem1", "pem2"}
    for plan in dp.agent_plans.values():
        kinds = [o.kind for o in plan.topo_sorted()]
        assert kinds[0] == "memorysource" and kinds[-1] == "resultsink"
        aggs = [o for o in plan.ops() if isinstance(o, AggOp)]
        assert len(aggs) == 1 and aggs[0].partial
    ch = next(iter(dp.channels.values()))
    assert len(dp.channels) == 1 and ch.kind == "agg_state" and len(ch.producers) == 3
    assert len([o for o in dp.merger_plan.ops() if isinstance(o, RemoteSourceOp)]) == 1


def test_distributed_groupby_matches_oracle(pair, oracle_df):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), total=('latency', px.sum),
    lo=('time_', px.min), hi=('time_', px.max))
px.display(df)
"""
    got, _dp = run_both(pair, src, ["service", "status"])
    exp = (oracle_df[oracle_df.status != 404]
           .groupby(["service", "status"], as_index=False)
           .agg(cnt=("latency", "count"), total=("latency", "sum"),
                lo=("time_", "min"), hi=("time_", "max"))
           .sort_values(["service", "status"]).reset_index(drop=True))
    assert got.service.tolist() == exp.service.tolist()
    assert got.cnt.tolist() == exp.cnt.tolist()
    np.testing.assert_allclose(got.total.values, exp.total.values, rtol=1e-9)
    assert got.lo.tolist() == exp.lo.tolist() and got.hi.tolist() == exp.hi.tolist()


def test_distributed_quantile_merge(pair, oracle_df):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(p50=('latency', px.p50), avg=('latency', px.mean))
px.display(df)
"""
    got, _dp = run_both(pair, src, ["service"])
    exp = oracle_df.groupby("service").latency.agg(["median", "mean"]).sort_index()
    np.testing.assert_allclose(got.avg.values, exp["mean"].values, rtol=1e-9)
    np.testing.assert_allclose(got.p50.values, exp["median"].values, rtol=0.05)


def test_distributed_scan_rows(pair, oracle_df):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df[df.status == 500]
df.lat_ms = df.latency / 1000.0
px.display(df)
"""
    got, dp = run_both(pair, src, ["time_", "service", "latency"])
    assert {c.kind for c in dp.channels.values()} == {"rows"}
    exp = oracle_df[oracle_df.status == 500]
    assert len(got) == len(exp)
    np.testing.assert_allclose(np.sort(got.lat_ms.values), np.sort(exp.latency.values / 1000.0))


def test_post_agg_transforms_on_merger(pair, oracle_df):
    src = """
import px
df = px.DataFrame(table='http_events')
stats = df.groupby('service').agg(cnt=('latency', px.count), total=('latency', px.sum))
stats.avg = stats.total / stats.cnt
stats = stats[stats.cnt > 0]
px.display(stats)
"""
    got, _dp = run_both(pair, src, ["service"])
    exp = (oracle_df.groupby("service", as_index=False)
           .agg(cnt=("latency", "count"), total=("latency", "sum"))
           .sort_values("service").reset_index(drop=True))
    np.testing.assert_allclose(got.avg.values, (exp.total / exp.cnt).values, rtol=1e-9)


def test_source_pruned_to_owning_agents():
    cols = {a: _http_cols(i, s) for i, (a, s) in enumerate(SERVICES.items())}
    ref, port = _clusters(cols)
    for cl, rel_cls, dt in ((ref, RefRelation, RefDT), (port, Relation, DT)):
        cl.stores["pem2"].create(
            "only_pem2", rel_cls.of(("time_", dt.TIME64NS), ("v", dt.INT64))
        ).write({"time_": np.arange(10, dtype=np.int64), "v": np.arange(10)})
    pair2 = (RefCluster(ref.stores, n_devices_per_agent=1),
             LocalCluster(port.stores, device="cpu"))
    src = """
import px
df = px.DataFrame(table='only_pem2')
df = df.agg(total=('v', px.sum))
px.display(df)
"""
    got, dp = run_both(pair2, src)
    assert set(dp.agent_plans) == {"pem2"}
    assert int(got.total[0]) == 45


def test_distributed_join_of_two_aggs(pair, oracle_df):
    src = """
import px
df = px.DataFrame(table='http_events')
stats = df.groupby('service').agg(cnt=('latency', px.count))
tw = px.DataFrame(table='http_events')
tw = tw.agg(t_min=('time_', px.min))
stats.k = 1
tw.k = 1
j = stats.merge(tw, how='inner', left_on='k', right_on='k')
j = j.drop(['k_x', 'k_y'])
px.display(j)
"""
    got, _dp = run_both(pair, src, ["service"])
    exp = oracle_df.groupby("service", as_index=False).agg(cnt=("latency", "count"))
    assert got.cnt.tolist() == exp.sort_values("service").cnt.tolist()
    assert (got.t_min == oracle_df.time_.min()).all()


def test_distributed_join_two_tables():
    """The tests/test_distributed.py two-table case: the aggregate cuts as a
    partial on both agents, the owners table ships rows from its one owner,
    and the join runs on the merger (not a repartitioned join)."""
    cols = {"pem0": _http_cols(0, ["cart", "frontend"]),
            "pem1": _http_cols(1, ["frontend", "checkout"])}
    ref, port = _clusters(cols)
    for cl, rel_cls, dt in ((ref, RefRelation, RefDT), (port, Relation, DT)):
        cl.stores["pem1"].create(
            "owners", rel_cls.of(("service", dt.STRING), ("owner", dt.STRING))
        ).write({"service": ["cart", "frontend", "checkout"],
                 "owner": ["team-a", "team-b", "team-c"]})
    pair2 = (RefCluster(ref.stores, n_devices_per_agent=1),
             LocalCluster(port.stores, device="cpu"))
    src = """
import px
df = px.DataFrame(table='http_events')
agg = df.groupby('service').agg(cnt=('latency', px.count))
own = px.DataFrame(table='owners')
j = agg.merge(own, how='left', left_on='service', right_on='service')
px.display(j)
"""
    got, dp = run_both(pair2, src, ["owner"])
    assert not dp.join_stages
    assert sorted(c.kind for c in dp.channels.values()) == ["agg_state", "rows"]
    assert set(got.owner) == {"team-a", "team-b", "team-c"}
    assert int(got.cnt.sum()) == 2 * N_PER_AGENT


def test_distributed_head_limit_reapplied_at_merger(pair):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df.head(5)
px.display(df)
"""
    assert pair[1].query(src, now=NOW)["output"].num_rows == 5
    assert pair[0].query(src, now=NOW)["output"].num_rows == 5


def test_distributed_default_limit_reapplied_at_merger(pair):
    src = """
import px
df = px.DataFrame(table='http_events')
px.display(df)
"""
    assert pair[1].query(src, now=NOW, default_limit=50)["output"].num_rows == 50
    _got, dp = run_both(pair, src, ["time_", "service", "latency"], default_limit=50)
    assert {c.kind for c in dp.channels.values()} == {"rows"}


def test_distributed_limit_before_agg(pair):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df.head(5)
df = df.groupby('service').agg(cnt=('latency', px.count))
px.display(df)
"""
    res = pair[1].query(src, now=NOW)
    assert int(res["output"].to_pandas()["cnt"].sum()) == 5
    ref, port = pair
    rdp = ref.planner.plan(ref_compile(src, ref.schemas(), now=NOW).plan)
    pdp = port.planner.plan(compile_pxl(src, port.schemas(), now=NOW).plan)
    assert pdp.to_dict() == rdp.to_dict()


def test_net_flow_graph_distributed_aggs_agent_side(pair, oracle_df):
    src = """
import px
df = px.DataFrame(table='http_events')
tx = df.groupby('service').agg(total=('latency', px.sum))
rx = df.groupby('service').agg(cnt=('latency', px.count))
flow = tx.merge(rx, how='inner', left_on='service', right_on='service')
px.display(flow, 'flow')
"""
    got, dp = run_both(pair, src, ["service_x"], sink="flow")
    assert {c.kind for c in dp.channels.values()} == {"agg_state"}
    assert len(dp.channels) == 2
    for plan in dp.agent_plans.values():
        assert len([o for o in plan.ops() if isinstance(o, MemorySourceOp)]) == 1
        aggs = [o for o in plan.ops() if isinstance(o, AggOp)]
        assert len(aggs) == 2 and all(a.partial for a in aggs)
    exp = (oracle_df.groupby("service", as_index=False)["latency"].sum()
           .merge(oracle_df.groupby("service", as_index=False)["latency"].count(),
                  on="service").sort_values("service").reset_index(drop=True))
    np.testing.assert_allclose(got.total.values, exp.latency_x.values, rtol=1e-9)
    np.testing.assert_array_equal(got.cnt.values, exp.latency_y.values)


def test_multi_blocking_second_agg_on_merger(pair, oracle_df):
    src = """
import px
df = px.DataFrame(table='http_events')
per_svc = px.DataFrame(table='http_events')
per_svc = per_svc.groupby(['service', 'status']).agg(cnt=('latency', px.count))
top = per_svc.groupby('service').agg(combos=('cnt', px.count))
px.display(top)
"""
    got, dp = run_both(pair, src, ["service"])
    assert {c.kind for c in dp.channels.values()} == {"agg_state"}
    exp = (oracle_df.groupby(["service", "status"]).size().reset_index()
           .groupby("service").size().to_dict())
    assert dict(zip(got.service, got.combos)) == exp


def test_union_waits_for_the_port_union(pair, oracle_df):
    """The distributed union: each agent's filtered scans ship as rows, the
    merger unions them (UnionOp) and aggregates; equal to the reference."""
    src = """
import px
a = px.DataFrame(table='http_events')
a = a[a.status == 200]
b = px.DataFrame(table='http_events')
b = b[b.status == 500]
u = a.append(b)
u = u.groupby('service').agg(cnt=('latency', px.count))
px.display(u)
"""
    got, _dp = run_both(pair, src, ["service"])
    exp = oracle_df[oracle_df.status.isin([200, 500])].groupby("service").size().to_dict()
    assert dict(zip(got.service, got.cnt)) == exp


CONFIG4 = """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(df, 'output')
"""


def test_eight_agents_same_dictionaries_take_the_gang_merge(merge_calls):
    """Bench config #4's shape, small: 8 agents built from one seed, so every
    dictionary and int-key value set agrees and the layouts match.  Each
    query gang-merges the 8 states once, equals the reference and a
    single-store oracle, and a warm repeat is served by the plan cache."""
    cols = _http_cols(12, ["svc-%d" % i for i in range(16)], 4000)
    ref, port = _clusters({f"pem{a}": cols for a in range(8)})
    got = _frame(port.query(CONFIG4)["output"], ["service", "status"])
    assert merge_calls == [8]
    want = _frame(ref.query(CONFIG4)["output"], ["service", "status"])
    assert_same(got, want)
    one = TableStore()
    one.create("http_events", Relation.of(
        ("time_", DT.TIME64NS), ("service", DT.STRING), ("latency", DT.FLOAT64),
        ("status", DT.INT64)), batch_rows=1024).write(
        {k: (np.concatenate([v] * 8) if isinstance(v, np.ndarray) else v * 8)
         for k, v in cols.items()})
    oracle = _frame(execute_plan(compile_pxl(CONFIG4, one.schemas(), now=NOW).plan,
                                 one, device="cpu")["output"], ["service", "status"])
    assert_same(got, oracle)
    port.query(CONFIG4)
    assert merge_calls == [8, 8]
    assert port.plan_cache.hits == 1 and port.plan_cache.misses == 1


def test_mixed_dictionaries_take_the_host_merge(pair, merge_calls):
    src = CONFIG4
    got, _dp = run_both(pair, "import px\n" + src, ["service", "status"])
    assert merge_calls == []
    assert len(got) > 0


def test_computed_key_takes_the_sorted_partial(pair, merge_calls, monkeypatch):
    """A computed numeric key has no dense code: every agent's partial comes
    from _sorted_partial_batch (host factorization, never deferred)."""
    src = """
import px
df = px.DataFrame(table='http_events')
df.bucket = px.bin(df.status, 100)
df = df.groupby('bucket').agg(cnt=('latency', px.count), avg=('latency', px.mean),
                              p50=('latency', px.p50))
px.display(df)
"""
    sorted_agents = set()
    real = port_executor.PlanExecutor._sorted_partial_batch

    def spy(self, op):
        sorted_agents.add(id(self))
        return real(self, op)

    monkeypatch.setattr(port_executor.PlanExecutor, "_sorted_partial_batch", spy)
    got, _dp = run_both(pair, src, ["bucket"])
    assert len(sorted_agents) == 3 and merge_calls == []
    assert int(got.cnt.sum()) == 3 * N_PER_AGENT


def test_two_agents_run_concurrently(monkeypatch):
    """The two agents' fragments run at the same time in the cluster's
    thread pool: each waits at a barrier that only both together pass."""
    cols = {"pem0": _http_cols(0, ["a", "b"]), "pem1": _http_cols(1, ["b", "c"])}
    ref, port = _clusters(cols)
    barrier = threading.Barrier(2, timeout=60)
    real = port_executor.PlanExecutor.run_agent

    def meet(self):
        barrier.wait()
        return real(self)

    monkeypatch.setattr(port_executor.PlanExecutor, "run_agent", meet)
    got = _frame(port.query(CONFIG4)["output"], ["service", "status"])
    want = _frame(ref.query(CONFIG4)["output"], ["service", "status"])
    assert_same(got, want)


def test_launch_counter_is_exact_under_threads():
    """Agents launch kernels from several threads at once: no count is lost
    (more threads than cores, the interpreter switching threads often)."""
    import os
    import sys

    k = _build.Kernel("probe")
    n_threads, per = (os.cpu_count() or 4) + 2, 5000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [k.count("e") for _ in range(per)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert k.launches == n_threads * per and k.by_entry == {"e": n_threads * per}
