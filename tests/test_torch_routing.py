"""The CPU/card routing of the port's executor against the reference's.

An aggregate whose input rows times route_scale are at most
PX_CPU_CROSSOVER_ROWS takes the CPU arm: the np_partial loop, then the
whole-plan loop, as the reference's executor tries them; a query neither
admits runs the card route (on a CPU executor: the plain versions of the
card's kernels).  Here, on the CPU:

  * under the crossover the port takes the fast path the reference takes
    (equal wholeplan_native / np_fast_polls counts) and gives its answer;
  * force_backend pins the arm, and a pinned executor's join takes the
    gate's static decision;
  * on a CUDA device at crossover 0 no autotune model is consulted for a
    host arm;
  * LocalCluster routes by the QUERY's rows (route_scale = its agents),
    and so does a standing view's refresh;
  * the join gate decides on the CPU what the reference's decides;
  * a multi-query gang declines when its first member is CPU-routed;
  * with PX_AUTOTUNE=0 every decision is the static one, and none is
    recorded.
"""
import numpy as np
import pytest

import bench
from pixie_tpu import flags as ref_flags
from pixie_tpu.engine import executor as ref_executor
from pixie_tpu.ops import join_device as ref_jd

import pixie_tpu_torch.interop as interop
import pixie_tpu_torch.matview  # noqa: F401  (defines PL_MATVIEW_ENABLED)
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.engine import autotune
from pixie_tpu_torch.engine import executor as port_executor
from pixie_tpu_torch.engine.executor import PlanExecutor
from pixie_tpu_torch.ops import join_device as jd
from pixie_tpu_torch.parallel.cluster import LocalCluster
from pixie_tpu_torch.status import Internal
from tests.test_torch_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

from test_torch_executor import PLANS, REL, http_columns
from test_torch_wholeplan import same_tree, stores

N = 1 << 16
FLAGS = ("PX_CPU_CROSSOVER_ROWS", "PX_AUTOTUNE", "PL_MATVIEW_ENABLED", "PX_MQ_FUSION",
         "PX_DEVICE_JOIN")
REF_FLAGS = ("PX_CPU_CROSSOVER_ROWS", "PX_AUTOTUNE", "PX_DEVICE_JOIN", "PX_MQ_FUSION")


@pytest.fixture(autouse=True)
def _flags():
    """Both crossovers at the reference's default 4,194,304 rows, autotune
    off (tests/conftest.py's default); restored after."""
    saved = {n: port_flags.get(n) for n in FLAGS}
    ref_saved = {n: ref_flags.get(n) for n in REF_FLAGS}
    for f in (port_flags, ref_flags):
        f.set_for_testing("PX_CPU_CROSSOVER_ROWS", 1 << 22)
        f.set_for_testing("PX_AUTOTUNE", False)
    autotune.MODEL.reset_for_testing()
    yield
    for n, v in saved.items():
        port_flags.set_for_testing(n, v)
    for n, v in ref_saved.items():
        ref_flags.set_for_testing(n, v)
    jd.reset_gate_for_testing()
    ref_jd.reset_gate_for_testing()
    autotune.MODEL.reset_for_testing()


@pytest.fixture(scope="module")
def http():
    return stores(http_columns(), rel=REL, table="http_events", batch_rows=1 << 12)


def _fast(stats) -> dict:
    return {k: stats.get(k, 0) for k in ("wholeplan_native", "np_fast_polls")}


def _port_plan(plan):
    return interop.plan_from_dict(plan.to_dict())


def _frame(qr):
    df = qr.to_pandas()
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def _same_frames(got, want, exact: bool) -> None:
    a, b = _frame(want), _frame(got)
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        x, y = a[c].to_numpy(), b[c].to_numpy()
        if x.dtype.kind == "f":
            if exact:
                np.testing.assert_array_max_ulp(y, x, maxulp=1)
            else:
                np.testing.assert_allclose(y, x, rtol=1e-12)
        elif x.dtype == object and len(x) and isinstance(x[0], np.ndarray):
            np.testing.assert_allclose(np.stack(y), np.stack(x), rtol=1e-12)
        else:
            np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_cpu_executor_takes_the_reference_fast_path(http, name):
    plan = PLANS[name]()
    rex = ref_executor.PlanExecutor(plan, http[0], mesh=None)
    want = rex.run()["output"]
    ex = PlanExecutor(_port_plan(plan), http[1], device="cpu")
    got = ex.run()["output"]
    assert _fast(ex.stats) == _fast(want.exec_stats)
    took = any(_fast(ex.stats).values())
    routes = ex.stats["routes"]
    assert routes[0]["arm"] == ("cpu" if took else "device")
    # a CPU-routed chain uploads nothing (agg_of_agg's second aggregate
    # reads a host batch, which no fast path takes: it runs the card route)
    assert (ex.stats["h2d_bytes"] == 0) == all(r["arm"] == "cpu" for r in routes)
    _same_frames(got, want, exact=took)


def test_over_the_crossover_the_card_route_runs(http):
    port_flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", N - 1)
    ex = PlanExecutor(_port_plan(bench.http_plan()), http[1], device="cpu")
    got = ex.run()["output"]
    assert _fast(ex.stats) == {"wholeplan_native": 0, "np_fast_polls": 0}
    assert ex.stats["routes"][0] == {"chain": "scan(http_events)->filter->agg",
                                     "arm": "device", "route": "device"}
    port_flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", N)  # at the crossover: CPU
    ex = PlanExecutor(_port_plan(bench.http_plan()), http[1], device="cpu")
    cpu = ex.run()["output"]
    assert ex.stats["wholeplan_native"] == 1
    _same_frames(got, cpu, exact=False)


@pytest.mark.parametrize("pin", ["cpu", "device"])
def test_force_backend_pins_the_arm(http, pin):
    """force_backend pins the arm whatever the size, and takes only the two
    arms' names."""
    port_flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", 0 if pin == "cpu" else 1 << 30)
    plan = _port_plan(bench.http_plan())
    ex = PlanExecutor(plan, http[1], device="cpu", force_backend=pin)
    ex.run()
    assert ex.stats.get("wholeplan_native", 0) == (pin == "cpu")
    assert ex.stats["routes"][0]["arm"] == pin
    assert ex.force_backend == pin
    assert PlanExecutor(plan, http[1], device="cpu").force_backend is None
    with pytest.raises(Internal):
        PlanExecutor(plan, http[1], device="cpu", force_backend="tpu")


def test_force_backend_cpu_without_a_fast_path_runs_the_card_route(http):
    ex = PlanExecutor(_port_plan(PLANS["limit_then_agg"]()), http[1], device="cpu",
                      force_backend="cpu")
    ex.run()
    assert _fast(ex.stats) == {"wholeplan_native": 0, "np_fast_polls": 0}
    assert ex.stats["routes"][0]["arm"] == "device"


SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(cnt=('latency', px.count),
                                           avg=('latency', px.mean))
px.display(df, 'out')
"""


def _cluster(rows_each: int, agents: int = 2):
    cols = http_columns(n=rows_each)
    return LocalCluster({f"pem{i}": stores(cols, rel=REL, table="http_events",
                                           batch_rows=1 << 12)[1] for i in range(agents)},
                        device="cpu")


@pytest.mark.parametrize("crossover,arm", [(N, "device"), (2 * N, "cpu")])
def test_local_cluster_routes_by_the_query_rows(crossover, arm):
    """Two agents of N rows: each agent's executor sees its N rows times
    route_scale 2, so a crossover of N keeps the card and one of 2N takes
    the CPU; both answers agree."""
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    cl = _cluster(N)
    port_flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", crossover)
    res = cl.query(SCRIPT)["out"]
    agents = res.exec_stats["agents"]
    assert {r["arm"] for st in agents.values() for r in st["routes"]} == {arm}
    assert sum(st.get("wholeplan_native", 0) for st in agents.values()) == \
        (2 if arm == "cpu" else 0)
    port_flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", 0)
    _same_frames(res, cl.query(SCRIPT)["out"], exact=False)


def test_view_refresh_routes_by_the_query_rows():
    """A standing view's fold takes route_scale from the cluster: at a
    crossover of N its 2-agent delta folds stay on the card route, at 2N
    they take the CPU route (no upload)."""
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", True)
    for crossover, h2d_zero in ((N, False), (2 * N, True)):
        port_flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", crossover)
        cl = _cluster(N)
        cl.query(SCRIPT)  # first sight: registers
        res = cl.query(SCRIPT)["out"]  # second: folds every row into the view
        infos = [st["matview"] for st in res.exec_stats["agents"].values()]
        assert all(i["hit"] for i in infos)
        assert all((i["h2d_bytes"] == 0) == h2d_zero for i in infos), infos


@pytest.mark.parametrize("flag", [-1, 0, 1])
def test_join_gate_on_the_cpu_decides_as_the_reference(flag):
    port_flags.set_for_testing("PX_DEVICE_JOIN", flag)
    ref_flags.set_for_testing("PX_DEVICE_JOIN", flag)
    jd.reset_gate_for_testing()
    ref_jd.reset_gate_for_testing()
    got, want = jd.device_join_gate("cpu"), ref_jd.device_join_gate()
    assert (got["enabled"], got["reason"]) == (want["enabled"], want["reason"])
    if flag == -1:
        assert got["path"] == want["path"] == "native_cpu"


def test_join_gate_autotune_arm_records_its_decision():
    """Under PX_AUTOTUNE the gate's decision is the device_join model's
    static arm: the decision lands in stats and in the event rows, and the
    answer is the static route's."""
    from test_torch_join import _kv_plan, _kv_stores

    st_ = _kv_stores(1 << 16, 11, (0, 1 << 13), (1 << 12, 3 << 12))
    plan = _port_plan(_kv_plan("inner"))
    want = PlanExecutor(plan, st_[1], device="cpu").run()["out"]
    port_flags.set_for_testing("PX_AUTOTUNE", True)
    ex = PlanExecutor(plan, st_[1], device="cpu")
    got = ex.run()["out"]
    (dec,) = [d for d in ex.stats["autotune"] if d["gate"] == autotune.GATE_DEVICE_JOIN]
    assert dec["static_arm"] == "device" and dec["arm"] == "device"
    assert dec["observed_ms"] >= 0
    assert any(r["gate"] == autotune.GATE_DEVICE_JOIN for r in autotune.MODEL.drain_rows())
    _same_frames(got, want, exact=True)


@pytest.mark.parametrize("pin", ["cpu", "device"])
def test_pinned_executor_join_takes_the_static_gate(pin):
    """A pinned executor's join consults no device_join model under
    PX_AUTOTUNE: the gate's static decision runs (a native join on a CPU
    device), no decision is recorded, and the model takes no sample."""
    from test_torch_join import _kv_plan, _kv_stores

    st_ = _kv_stores(1 << 16, 11, (0, 1 << 13), (1 << 12, 3 << 12))
    plan = _port_plan(_kv_plan("inner"))
    want = PlanExecutor(plan, st_[1], device="cpu").run()["out"]
    port_flags.set_for_testing("PX_AUTOTUNE", True)
    for _ in range(8):  # past the cold probe's beat
        ex = PlanExecutor(plan, st_[1], device="cpu", force_backend=pin)
        got = ex.run()["out"]
        assert not [d for d in ex.stats.get("autotune", [])
                    if d["gate"] == autotune.GATE_DEVICE_JOIN]
        assert ex.stats["device_joins"] == 1
        assert ex.stats["device"]["join_gate"]["reason"] == "native_cpu"
        _same_frames(got, want, exact=True)
    assert autotune.GATE_DEVICE_JOIN not in autotune.MODEL.snapshot()


@pytest.mark.parametrize("crossover", [0, 1 << 22])
def test_card_consults_no_host_arm_at_crossover_zero(http, crossover):
    """On a CUDA device the host arms are live only while the crossover is
    above 0: at 0 (the H100 sweep's answer) _backend_for takes the card and
    records no cpu_crossover decision, under PX_AUTOTUNE too; above 0 the
    model is consulted as on a CPU device.  Only the routing seam runs here
    (no tensor is made on the card)."""
    import torch

    port_flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", crossover)
    port_flags.set_for_testing("PX_AUTOTUNE", True)
    plan = _port_plan(bench.http_plan())
    ex = PlanExecutor(plan, http[1], device="cpu")
    assert ex._host_arms_live()
    src = ex._agg_setup(next(o for o in plan.ops() if o.kind == "agg")).src
    ex.device = torch.device("cuda", 0)
    assert ex._host_arms_live() == (crossover > 0)
    for _ in range(8):  # a consulted cold model probes the other arm by the 4th
        arm = ex._backend_for(src)
        ex._at_route.clear()
        if crossover == 0:
            assert arm == "device"
    decisions = ex.stats.get("autotune", [])
    assert len(decisions) == (8 if crossover else 0)
    if crossover:
        assert {d["source"] for d in decisions} == {"cold", "explore"}


def test_gang_declines_when_its_first_member_is_cpu_routed():
    from test_torch_batching import BATCH_SCRIPTS, _clusters, _cols, _fused_agent_plans

    ref, port = _clusters({"pem0": _cols(3)})
    (_rf, _rm, rap), (_pf, _pm, pap) = _fused_agent_plans(ref, port, BATCH_SCRIPTS)
    port_flags.set_for_testing("PX_MQ_FUSION", 1)
    ref_flags.set_for_testing("PX_MQ_FUSION", 1)
    ex = PlanExecutor(pap, port.stores["pem0"], None, device="cpu")
    got = ex.run_agent()
    rex = ref_executor.PlanExecutor(rap, ref.stores["pem0"], None, mesh=None)
    want = rex.run_agent()
    assert "mq_fused" not in ex.stats and "mq_fused" not in rex.stats
    assert _fast(ex.stats) == _fast(rex.stats)
    assert sum(_fast(ex.stats).values()) == len(got)
    for cid in got:
        same_tree(got[cid].states, want[cid].states)
    ex = PlanExecutor(pap, port.stores["pem0"], None, device="cpu", force_backend="device")
    ex.run_agent()
    assert ex.stats["mq_fused"] == len(got)


@pytest.mark.parametrize("rows", [N, 4 * N])
def test_autotune_off_decisions_are_static(http, rows):
    """PX_AUTOTUNE=0: the arm is the crossover's, and no decision is
    recorded; on, the same executor records one cpu_crossover decision per
    size bucket whose static arm is the crossover's."""
    port_flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", 2 * N)
    static = "cpu" if rows <= 2 * N else "device"
    src_ts = stores(http_columns(n=rows), rel=REL, table="http_events",
                    batch_rows=1 << 12)[1]
    plan = _port_plan(PLANS["three_keys"]())
    for _ in range(5):
        ex = PlanExecutor(plan, src_ts, device="cpu")
        ex.run()
        assert ex.stats["routes"][0]["arm"] == static
        assert "autotune" not in ex.stats
    assert autotune.MODEL.snapshot() == {}
    port_flags.set_for_testing("PX_AUTOTUNE", True)
    ex = PlanExecutor(plan, src_ts, device="cpu")
    ex.run()
    (dec,) = ex.stats["autotune"]
    assert dec["gate"] == autotune.GATE_CPU_CROSSOVER and dec["static_arm"] == static
    assert dec["size_bucket"] == autotune.size_bucket(rows)
    assert port_executor._route_backend(ex._agg_setup(
        next(o for o in plan.ops() if o.kind == "agg")).src) == static
