"""Multi-tenant serving front: admission quotas, DRR fairness, shedding,
degradation (readyz flip + stale matview serving), tenant cache isolation,
and flag-off equivalence — tests/test_serving.py's cases against the
port's serving front, broker and agents (on the CPU), and the DRR
scheduler's dispatch order against the reference's.

Unit tests drive ServingFront directly (the scheduler is deterministic
under a held lock); integration tests run the real broker + agent + client
path so the tenant id, retry-after envelope and degradation hints are
proven ON THE WIRE, not just in-process.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from pixie_tpu_torch import flags, metrics
import pixie_tpu_torch.engine.plancache  # noqa: F401 — defines PL_QUERY_FASTPATH
from pixie_tpu_torch.serving import (
    COST_COLD,
    COST_WARM,
    ServingFront,
    ShedError,
    TokenBucket,
    parse_tenant_spec,
)
from test_torch_services import Agent  # the port's, on the CPU
from test_torch_services import Broker  # the port's, on the CPU
from pixie_tpu_torch.services.client import Client, QueryError
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation

SERVING_FLAGS = (
    "PL_SERVING_ENABLED", "PL_TENANT_QPS", "PL_TENANT_CONCURRENCY",
    "PL_TENANT_WEIGHTS", "PL_SERVING_MAX_INFLIGHT",
    "PL_SERVING_QUEUE_DEPTH", "PL_SERVING_QUEUE_TIMEOUT_S",
    "PL_SERVING_SHED_WATERMARK", "PL_SERVING_DEGRADED_WINDOW",
    "PL_TENANT_ISOLATION", "PL_QUERY_FASTPATH", "PL_CLIENT_RETRIES",
)


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = {n: flags.get(n) for n in SERVING_FLAGS}
    yield
    for n, v in saved.items():
        flags.set_for_testing(n, v)


def _set(**kw):
    for n, v in kw.items():
        flags.set_for_testing(n, v)


def _bg_admit(front, tenant, cost, timeout_s=30.0):
    """admit() on a background thread → holder dict with ticket/shed."""
    holder = {}

    def go():
        try:
            holder["ticket"] = front.admit(tenant, cost, timeout_s=timeout_s)
        except ShedError as e:
            holder["shed"] = e

    th = threading.Thread(target=go, daemon=True)
    th.start()
    holder["thread"] = th
    return holder


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


# ------------------------------------------------------------------- units


def test_parse_tenant_spec():
    assert parse_tenant_spec("") == (None, {})
    assert parse_tenant_spec("10") == (10.0, {})
    assert parse_tenant_spec("0") == (None, {})  # 0 = unlimited
    assert parse_tenant_spec("10,vip=50,batch=2") == (
        10.0, {"vip": 50.0, "batch": 2.0})
    # malformed parts degrade, never raise (ops env var typos)
    assert parse_tenant_spec("x=,=3,junk,5") == (5.0, {})


def test_token_bucket_rate_and_retry_after():
    b = TokenBucket(rate=10.0, capacity=2.0)
    now = time.monotonic()
    assert b.try_take(now) == 0.0
    assert b.try_take(now) == 0.0
    ra = b.try_take(now)  # bucket dry: retry in 1/rate
    assert 0.0 < ra <= 0.1 + 1e-9
    assert b.try_take(now + 0.2) == 0.0  # refilled 2 tokens


def test_disabled_front_is_passthrough():
    _set(PL_SERVING_ENABLED=0, PL_SERVING_MAX_INFLIGHT=1)
    front = ServingFront("t")
    tickets = [front.admit("a", COST_COLD) for _ in range(8)]
    assert front.inflight == 0  # no accounting at all
    for t in tickets:
        front.release(t)
    assert front.stats()["queued"] == 0


def test_qps_quota_sheds_over_limit_tenant_only():
    _set(PL_SERVING_ENABLED=1, PL_TENANT_QPS="0,greedy=2",
         PL_SERVING_MAX_INFLIGHT=64)
    front = ServingFront("t")
    front.admit("greedy", COST_WARM)
    front.admit("greedy", COST_WARM)  # burst capacity = max(1, rate) = 2
    with pytest.raises(ShedError) as ei:
        front.admit("greedy", COST_WARM)
    assert ei.value.reason == "qps"
    assert ei.value.retry_after_s > 0
    # an under-limit tenant is untouched by its neighbor's quota
    for _ in range(8):
        front.release(front.admit("calm", COST_WARM))
    assert metrics.counter_value(
        "px_serving_shed_total",
        labels={"tenant": "greedy", "reason": "qps"}) >= 1


def test_tenant_concurrency_queues_then_dispatches():
    _set(PL_SERVING_ENABLED=1, PL_TENANT_CONCURRENCY="0,t=1",
         PL_SERVING_MAX_INFLIGHT=64, PL_TENANT_QPS="")
    front = ServingFront("t")
    first = front.admit("t", COST_WARM)
    h = _bg_admit(front, "t", COST_WARM)
    assert _wait(lambda: front.stats()["queued"] == 1)
    assert "ticket" not in h
    front.release(first)
    h["thread"].join(timeout=5.0)
    assert h["ticket"].queued and h["ticket"].outcome == "run"
    front.release(h["ticket"])
    assert front.stats()["inflight"] == 0


def test_queue_depth_bounds_and_sheds_with_retry_after():
    _set(PL_SERVING_ENABLED=1, PL_SERVING_MAX_INFLIGHT=1,
         PL_SERVING_QUEUE_DEPTH=2, PL_TENANT_QPS="",
         PL_TENANT_CONCURRENCY="")
    front = ServingFront("t")
    blocker = front.admit("a", COST_WARM)
    hs = [_bg_admit(front, "a", COST_WARM) for _ in range(2)]
    assert _wait(lambda: front.stats()["queued"] == 2)
    with pytest.raises(ShedError) as ei:
        front.admit("a", COST_WARM)
    assert ei.value.reason == "queue_full"
    assert front.stats()["queued"] == 2  # the bound held
    front.release(blocker)
    for h in hs:
        h["thread"].join(timeout=5.0)
        front.release(h.get("ticket"))


def test_queue_timeout_sheds():
    _set(PL_SERVING_ENABLED=1, PL_SERVING_MAX_INFLIGHT=1,
         PL_SERVING_QUEUE_DEPTH=8)
    front = ServingFront("t")
    blocker = front.admit("a", COST_WARM)
    with pytest.raises(ShedError) as ei:
        front.admit("a", COST_WARM, timeout_s=0.1)
    assert ei.value.reason == "timeout"
    front.release(blocker)
    assert front.stats()["queued"] == 0


def test_timeout_racing_dispatch_never_double_resolves():
    """Regression for the pxlint lock-discipline finding in admit(): the
    timeout path used to read _retry_hint_locked's state (and decide the
    shed) OUTSIDE the lock, so a dispatch racing the timeout could have its
    'run' outcome overwritten with 'shed' — leaking the inflight slot.
    Storm the exact window: a capacity-blocked ticket whose release lands
    right at its queue timeout.  Whatever side wins, the ticket must
    resolve exactly once and the accounting must return to zero."""
    _set(PL_SERVING_ENABLED=1, PL_SERVING_MAX_INFLIGHT=1,
         PL_SERVING_QUEUE_DEPTH=8)
    front = ServingFront("t")
    timeout_s = 0.03
    for _ in range(30):
        blocker = front.admit("a", COST_WARM)
        out = {}

        def admit(out=out):
            try:
                t = front.admit("a", COST_WARM, timeout_s=timeout_s)
                out["ticket"] = t
            except ShedError:
                out["shed"] = True

        th = threading.Thread(target=admit)
        th.start()
        time.sleep(timeout_s)  # release lands right at the timeout edge
        front.release(blocker)
        th.join(5.0)
        assert not th.is_alive()
        if "ticket" in out:  # dispatch won: it must be honored end-to-end
            assert out["ticket"].outcome == "run"
            front.release(out["ticket"])
        else:
            assert out.get("shed")
        st = front.stats()
        assert st["inflight"] == 0 and st["queued"] == 0, st


def test_drr_weights_warm_over_cold():
    """One saturating cold tenant vs one warm tenant with equal queue
    pressure: DRR dispatches ~COST_COLD/COST_WARM warm queries per cold
    one, so the cheap tenant drains proportionally faster."""
    _set(PL_SERVING_ENABLED=1, PL_SERVING_MAX_INFLIGHT=1,
         PL_SERVING_QUEUE_DEPTH=64, PL_TENANT_QPS="",
         PL_TENANT_CONCURRENCY="", PL_SERVING_SHED_WATERMARK=0)
    front = ServingFront("t")
    blocker = front.admit("x", COST_WARM)
    batch = [_bg_admit(front, "batch", COST_COLD) for _ in range(6)]
    warm = [_bg_admit(front, "inter", COST_WARM) for _ in range(12)]
    assert _wait(lambda: front.stats()["queued"] == 18)
    order = []
    current = blocker
    for _ in range(12):
        front.release(current)
        assert _wait(lambda: any("ticket" in h and h["ticket"].accounted
                                 for h in batch + warm))
        running = [h for h in batch + warm
                   if "ticket" in h and h["ticket"].accounted]
        assert len(running) == 1  # cap 1: exactly one dispatched
        h = running[0]
        order.append(h["ticket"].tenant)
        current = h["ticket"]
    front.release(current)
    inter = order.count("inter")
    assert inter >= 2 * order.count("batch")
    assert order.count("batch") >= 1  # ... but the cold tenant is not starved


def test_drr_fractional_weight_cold_query_not_starved():
    """Regression: a tenant with weight < 0.5 queueing a cold (cost 4)
    query must still afford it once capacity frees — the deficit cap and
    round budget scale with the smallest eligible weight, so 'slow to
    afford' never becomes 'permanently unaffordable' (it used to shed on
    timeout with a completely free broker)."""
    _set(PL_SERVING_ENABLED=1, PL_SERVING_MAX_INFLIGHT=1,
         PL_SERVING_QUEUE_DEPTH=8, PL_TENANT_QPS="",
         PL_TENANT_CONCURRENCY="", PL_TENANT_WEIGHTS="1,slow=0.4",
         PL_SERVING_SHED_WATERMARK=0)
    front = ServingFront("t")
    blocker = front.admit("x", COST_WARM)
    h = _bg_admit(front, "slow", COST_COLD, timeout_s=5.0)
    assert _wait(lambda: front.stats()["queued"] == 1)
    front.release(blocker)
    h["thread"].join(timeout=5.0)
    assert "shed" not in h, f"starved: {h.get('shed')}"
    assert h["ticket"].outcome == "run"
    front.release(h["ticket"])


def test_closed_loop_fairness_and_bounded_queue():
    """Mini closed-loop: a flood of cold clients must not starve warm
    clients (their queue wait stays bounded), and peak queue depth never
    exceeds the outstanding client count (closed loops self-limit)."""
    _set(PL_SERVING_ENABLED=1, PL_SERVING_MAX_INFLIGHT=4,
         PL_SERVING_QUEUE_DEPTH=64, PL_TENANT_QPS="",
         PL_TENANT_CONCURRENCY="", PL_SERVING_SHED_WATERMARK=0,
         PL_SERVING_QUEUE_TIMEOUT_S=30.0)
    front = ServingFront("t")
    done = threading.Event()
    waits: list[float] = []
    wlock = threading.Lock()

    def inter_client(n_iters=25):
        mine = []
        for _ in range(n_iters):
            t0 = time.perf_counter()
            tk = front.admit("inter", COST_WARM)
            mine.append(time.perf_counter() - t0)
            time.sleep(0.002)
            front.release(tk)
        with wlock:
            waits.extend(mine)

    def batch_client():
        while not done.is_set():
            try:
                tk = front.admit("batch", COST_COLD, timeout_s=5.0)
            except ShedError:
                continue
            time.sleep(0.004)
            front.release(tk)

    batchers = [threading.Thread(target=batch_client, daemon=True)
                for _ in range(12)]
    inters = [threading.Thread(target=inter_client, daemon=True)
              for _ in range(4)]
    for th in batchers + inters:
        th.start()
    for th in inters:
        th.join(timeout=60.0)
    done.set()
    for th in batchers:
        th.join(timeout=10.0)
    assert len(waits) == 4 * 25
    waits.sort()
    p99 = waits[int(0.99 * len(waits))]
    # 12 saturating cold clients, 4 warm: a warm query's p99 admission wait
    # stays bounded well below the run length (starvation would sit at the
    # queue timeout)
    assert p99 < 5.0
    assert front.peak_queued <= 16  # never beyond the outstanding clients
    assert front.stats()["queued"] == 0


def test_degradation_flips_ready_sheds_cold_and_recovers():
    _set(PL_SERVING_ENABLED=1, PL_SERVING_MAX_INFLIGHT=1,
         PL_SERVING_QUEUE_DEPTH=8, PL_SERVING_SHED_WATERMARK=1,
         PL_TENANT_QPS="", PL_TENANT_CONCURRENCY="")
    front = ServingFront("t")
    assert front.ready()
    blocker = front.admit("a", COST_WARM)
    h = _bg_admit(front, "a", COST_WARM)
    assert _wait(lambda: front.stats()["queued"] == 1)
    assert not front.ready()  # watermark hit: alive but not ready
    with pytest.raises(ShedError) as ei:
        front.admit("b", COST_COLD)  # cold work sheds at the door
    assert ei.value.reason == "overload"
    h2 = _bg_admit(front, "b", COST_WARM)  # warm work still queues
    assert _wait(lambda: front.stats()["queued"] == 2)
    front.release(blocker)
    h["thread"].join(timeout=5.0)
    assert h["ticket"].degraded  # dispatched while past the watermark
    front.release(h["ticket"])
    h2["thread"].join(timeout=5.0)
    front.release(h2["ticket"])
    assert front.ready()  # queue drained: readiness recovers


# ------------------------------------------------- tenant cache isolation


def test_plan_cache_tenant_namespaces_and_per_ns_lru():
    from pixie_tpu_torch.engine.plancache import QueryPlanCache

    _set(PL_TENANT_ISOLATION=1)

    class Q:
        now_sensitive = False
        mutations = ()

    cache = QueryPlanCache(max_entries=2)
    ka = QueryPlanCache.key("s", None, None, None, ("fp", 0), tenant="a")
    kb = QueryPlanCache.key("s", None, None, None, ("fp", 0), tenant="b")
    assert ka != kb  # tenants never share entries
    _set(PL_TENANT_ISOLATION=0)
    assert QueryPlanCache.key("s", None, None, None, ("fp", 0), tenant="a") \
        == QueryPlanCache.key("s", None, None, None, ("fp", 0), tenant="b")
    _set(PL_TENANT_ISOLATION=1)
    for i in range(4):  # tenant a churns past its budget...
        cache.get_query(
            QueryPlanCache.key(f"s{i}", None, None, None, ("fp", 0),
                               tenant="a"), lambda: Q())
    kb0 = QueryPlanCache.key("warm", None, None, None, ("fp", 0), tenant="b")
    cache.get_query(kb0, lambda: Q())
    for i in range(4):  # ...and keeps churning after b cached its plan
        cache.get_query(
            QueryPlanCache.key(f"s{10 + i}", None, None, None, ("fp", 0),
                               tenant="a"), lambda: Q())
    assert cache.contains(kb0)  # a's churn never evicted b's entry
    assert len([k for k in cache._entries if k[0] == "a"]) == 2


def _mv_store(n=4000):
    rel = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                      ("latency", DT.FLOAT64), ("status", DT.INT64))
    ts = TableStore()
    t = ts.create("http_events", rel, batch_rows=512)
    rng = np.random.default_rng(3)
    t.write({
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "service": rng.choice(["cart", "auth"], n).tolist(),
        "latency": rng.integers(0, 100, n).astype(np.float64),
        "status": rng.choice([200, 500], n),
    })
    return ts


def _mv_plan():
    from pixie_tpu_torch.plan.plan import (
        AggExpr, AggOp, MemorySourceOp, Plan, ResultSinkOp,
    )

    p = Plan()
    src = p.add(MemorySourceOp(table="http_events"))
    agg = p.add(AggOp(groups=["service"],
                      values=[AggExpr("cnt", "count", None),
                              AggExpr("s", "sum", "status")],
                      partial=True), parents=[src])
    p.add(ResultSinkOp(channel="ch0", payload="agg_state"), parents=[agg])
    return p


def test_matview_tenant_namespaces_and_stale_serving():
    from pixie_tpu_torch.matview import MatViewManager

    _set(PL_TENANT_ISOLATION=1)
    flags.set_for_testing("PL_MATVIEW_ENABLED", True)
    ts = _mv_store()
    mgr = MatViewManager(ts, device="cpu")
    plan = _mv_plan()
    assert mgr.serve(plan, tenant="a") is None  # first sight: register
    got_a = mgr.serve(plan, tenant="a")
    assert got_a is not None  # a's second sight serves
    # tenant b's first sight must NOT see a's standing state
    assert mgr.serve(plan, tenant="b") is None
    assert {v.ns for v in mgr._views.values()} == {"a", "b"}
    # stale-while-revalidate: new rows pending, stale_ok skips the fold...
    n0 = got_a[1].num_groups
    ts.table("http_events").write({
        "time_": np.arange(100, dtype=np.int64),
        "service": ["cart"] * 100,
        "latency": np.ones(100),
        "status": np.full(100, 500, dtype=np.int64),
    })
    _ch, pb_stale, info = mgr.serve(plan, tenant="a", stale_ok=True)
    assert info["stale"] and info["rows_folded"] == 0
    assert info["stale_pending_rows"] == 100
    assert pb_stale.num_groups == n0
    # ...and the next healthy serve folds the pending delta (revalidate)
    _ch, _pb, info2 = mgr.serve(plan, tenant="a")
    assert not info2.get("stale")
    assert info2["rows_folded"] == 100
    # isolation off: one shared view for everyone
    _set(PL_TENANT_ISOLATION=0)
    mgr2 = MatViewManager(ts, device="cpu")
    assert mgr2.serve(plan, tenant="a") is None
    assert mgr2.serve(plan, tenant="b") is not None  # b hits a's state
    assert {v.ns for v in mgr2._views.values()} == {""}


def test_matview_global_backstop_bounds_namespace_flood():
    """Per-namespace budgets alone would let a client cycling tenant ids
    grow standing state by one full budget per id; past
    MAX_NAMESPACE_BUDGETS × budget the eviction goes LRU across ALL
    namespaces."""
    from pixie_tpu_torch.matview import MatViewManager

    _set(PL_TENANT_ISOLATION=1)
    flags.set_for_testing("PL_MATVIEW_ENABLED", True)
    flags.set_for_testing("PL_MATVIEW_MAX_STATE_MB", 1)
    try:
        ts = _mv_store()
        mgr = MatViewManager(ts, device="cpu")
        plan = _mv_plan()
        for i in range(6):  # six tenant namespaces, each under ITS budget
            mgr.serve(plan, tenant=f"t{i}")   # register
            mgr.serve(plan, tenant=f"t{i}")   # build state
        budget = 1 << 20
        with mgr._lock:
            for v in mgr._views.values():
                v.state_bytes = int(0.9 * budget)  # 5.4 budgets total
        mgr._evict_over_budget()
        total = mgr.state_bytes()
        assert total <= MatViewManager.MAX_NAMESPACE_BUDGETS * budget
        assert 0 < len(mgr._views) < 6  # evicted across namespaces, not all
    finally:
        flags.set_for_testing("PL_MATVIEW_MAX_STATE_MB", 256)


# ------------------------------------------------------------- integration


REL = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                  ("latency", DT.FLOAT64), ("status", DT.INT64))

SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status == 500]
df = df.groupby('service').agg(cnt=('latency', px.count),
                               s=('latency', px.sum))
px.display(df, 'out')
"""


def _store(seed, n=8000):
    rng = np.random.default_rng(seed)
    ts = TableStore()
    t = ts.create("http_events", REL, batch_rows=1024)
    t.write({
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "service": rng.choice(["cart", "auth", "web"], n).tolist(),
        "latency": rng.integers(0, 1000, n).astype(np.float64),
        "status": rng.choice([200, 500], n),
    })
    return ts


@pytest.fixture(scope="module")
def net_cluster():
    broker = Broker(hb_expiry_s=5.0, query_timeout_s=30.0,
                    healthz_port=0).start()
    agents = [Agent("pem1", "127.0.0.1", broker.port, store=_store(1),
                    heartbeat_s=1.0).start()]
    client = Client("127.0.0.1", broker.port, timeout_s=30.0)
    yield broker, agents, client
    client.close()
    for a in agents:
        a.stop()
    broker.stop()


def test_quota_shed_over_network_with_retry_after(net_cluster):
    broker, _agents, client = net_cluster
    # the raw shed surface is under test: the client's auto-retry would
    # otherwise honor retry_after_s and mask it (tests/test_fault_tolerance)
    _set(PL_CLIENT_RETRIES=0)
    # 0.2 qps: the bucket holds ONE burst token, and the first query would
    # have to take 5s for the refill to mask the shed (load-robust)
    _set(PL_TENANT_QPS="0,greedy=0.2")
    broker.serving.reset_for_testing()  # re-read quotas
    assert client.execute_script(SCRIPT, tenant="greedy")["out"].num_rows > 0
    with pytest.raises(QueryError) as ei:
        client.execute_script(SCRIPT, tenant="greedy")
    assert ei.value.retry_after_s is not None  # shed, not a query failure
    assert ei.value.retry_after_s > 0
    # the under-limit tenant on the SAME connection is unaffected
    assert client.execute_script(SCRIPT, tenant="calm")["out"].num_rows > 0
    # stats carry the serving block with the tenant id
    res = client.execute_script(SCRIPT, tenant="calm2")
    assert res["out"].exec_stats["serving"]["tenant"] == "calm2"


def test_flag_off_results_bit_identical(net_cluster):
    _broker, _agents, client = net_cluster
    on = client.execute_script(SCRIPT, tenant="a")["out"]
    _set(PL_SERVING_ENABLED=0)
    off = client.execute_script(SCRIPT, tenant="a")["out"]
    for c in on.columns:
        np.testing.assert_array_equal(on.columns[c], off.columns[c])
    assert on.dictionaries.keys() == off.dictionaries.keys()
    for k in on.dictionaries:
        assert on.dictionaries[k].values() == off.dictionaries[k].values()


def test_healthz_stays_green_while_readyz_flips_on_overload(net_cluster):
    """The liveness/readiness split regression test: queue-depth overload
    flips /readyz to 503 while /healthz keeps returning 200 (a restart
    loop would wipe the very queues the broker is trying to drain)."""
    import json as _json
    import urllib.error
    import urllib.request

    broker, _agents, client = net_cluster

    def get(path):
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{broker.healthz.port}{path}",
                    timeout=5.0) as r:
                return r.status, _json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, _json.loads(e.read())

    assert get("/healthz")[0] == 200
    assert get("/readyz")[0] == 200
    _set(PL_SERVING_MAX_INFLIGHT=1, PL_SERVING_SHED_WATERMARK=1)
    blocker = broker.serving.admit("t", COST_WARM)
    h = _bg_admit(broker.serving, "t", COST_WARM)
    assert _wait(lambda: broker.serving.stats()["queued"] == 1)
    code, body = get("/readyz")
    assert code == 503 and body["checks"]["serving"] == "failed"
    code, body = get("/healthz")
    assert code == 200 and "serving" not in body["checks"]
    broker.serving.release(blocker)
    h["thread"].join(timeout=5.0)
    broker.serving.release(h["ticket"])
    assert get("/readyz")[0] == 200  # recovered without a restart
    # the data path still works end to end after recovery
    assert client.execute_script(SCRIPT, tenant="t")["out"].num_rows > 0


def test_fastpath_off_degraded_does_not_shed_everything(net_cluster):
    """Regression: with PL_QUERY_FASTPATH=0 every query used to price
    COST_COLD, so a degraded broker shed ALL traffic — a full outage.
    With the cache off there is no warm/cold signal and no cheaper class
    to prefer, so pricing is uniform and degradation keeps serving."""
    broker, _agents, client = net_cluster
    _set(PL_QUERY_FASTPATH=0, PL_SERVING_SHED_WATERMARK=1,
         PL_TENANT_CONCURRENCY="0,z=1")
    broker.serving.reset_for_testing()
    blocker = broker.serving.admit("z", COST_WARM)
    h = _bg_admit(broker.serving, "z", COST_WARM)
    assert _wait(lambda: not broker.serving.ready())
    res = client.execute_script(SCRIPT, tenant="fresh")  # never seen
    assert res["out"].num_rows > 0
    assert res["out"].exec_stats["serving"]["degraded"] is True
    broker.serving.release(blocker)
    h["thread"].join(timeout=5.0)
    broker.serving.release(h["ticket"])


def test_degraded_dispatch_serves_stale_matview(net_cluster):
    """Past the watermark an admitted warm query is dispatched with
    stale_ok + a narrowed stream window: the agent answers matview hits
    from standing state WITHOUT folding the pending delta."""
    broker, agents, client = net_cluster
    flags.set_for_testing("PL_MATVIEW_ENABLED", True)
    for _ in range(3):  # register, build, hit: the warm dashboard shape
        client.execute_script(SCRIPT, tenant="dash")
    agents[0].store.table("http_events").write({
        "time_": np.arange(50, dtype=np.int64),
        "service": ["cart"] * 50,
        "latency": np.ones(50),
        "status": np.full(50, 500, dtype=np.int64),
    })
    # force degradation: tenant-cap-blocked queue entry past watermark 1
    _set(PL_SERVING_SHED_WATERMARK=1, PL_TENANT_CONCURRENCY="0,z=1")
    broker.serving.reset_for_testing()
    blocker = broker.serving.admit("z", COST_WARM)
    h = _bg_admit(broker.serving, "z", COST_WARM)
    assert _wait(lambda: not broker.serving.ready())
    res = client.execute_script(SCRIPT, tenant="dash")["out"]
    assert res.exec_stats["serving"]["degraded"] is True
    mv = res.exec_stats["agents"]["pem1"].get("matview") or {}
    assert mv.get("hit") and mv.get("stale")
    assert mv.get("stale_pending_rows", 0) >= 50
    broker.serving.release(blocker)
    h["thread"].join(timeout=5.0)
    broker.serving.release(h["ticket"])
    # healthy again: the next query folds the delta (revalidate)
    res2 = client.execute_script(SCRIPT, tenant="dash")["out"]
    mv2 = res2.exec_stats["agents"]["pem1"].get("matview") or {}
    assert mv2.get("hit") and not mv2.get("stale")
    assert mv2.get("rows_folded", 0) >= 50


def test_batch_rebate_refunds_amortized_share():
    """DRR cost accounting: a queued member admitted at full
    estimated cost that then executes inside a fused batch is re-priced to
    its amortized share — the difference returns to its tenant's DRR
    deficit (capped), so batching doesn't distort fair-share drain rates.
    Pass-through / un-queued / disabled cases are no-ops."""
    _set(PL_SERVING_ENABLED=1, PL_SERVING_MAX_INFLIGHT=1,
         PL_SERVING_QUEUE_DEPTH=8, PL_TENANT_QPS="",
         PL_TENANT_CONCURRENCY="", PL_TENANT_WEIGHTS="",
         PL_SERVING_SHED_WATERMARK=0)
    front = ServingFront("t")
    blocker = front.admit("x", COST_WARM)
    h = _bg_admit(front, "tA", COST_COLD)
    assert _wait(lambda: front.stats()["queued"] == 1)
    front.release(blocker)  # dispatches tA's cold query, spending deficit
    assert _wait(lambda: "ticket" in h and h["ticket"].accounted)
    t = h["ticket"]
    before = front.stats()["tenants"]["tA"]["deficit"]
    # batch of 4: the member owes COST_COLD/4, refund = 3/4 * COST_COLD
    front.rebate(t, t.cost / 4)
    after = front.stats()["tenants"]["tA"]["deficit"]
    assert after - before == pytest.approx(0.75 * COST_COLD)
    assert t.cost == pytest.approx(COST_COLD / 4)
    # idempotent-ish: a second rebate to the SAME share refunds nothing
    front.rebate(t, t.cost)
    assert front.stats()["tenants"]["tA"]["deficit"] == pytest.approx(after)
    # never refunds UP (a larger share than admitted is ignored)
    front.rebate(t, 100 * COST_COLD)
    assert t.cost == pytest.approx(COST_COLD / 4)
    front.release(t)
    # un-accounted tickets (pass-through / released) are no-ops
    front.rebate(t, 0.0)
    # disabled front: no accounting to fix
    _set(PL_SERVING_ENABLED=0)
    t2 = front.admit("tA", COST_COLD)
    front.rebate(t2, 0.5)
    assert t2.cost == COST_COLD


def test_batch_rebate_deficit_capped():
    """The refund cannot bank deficit past the anti-burst cap the dispatch
    loop tops up against."""
    _set(PL_SERVING_ENABLED=1, PL_SERVING_MAX_INFLIGHT=1,
         PL_SERVING_QUEUE_DEPTH=64, PL_TENANT_QPS="",
         PL_TENANT_CONCURRENCY="", PL_TENANT_WEIGHTS="",
         PL_SERVING_SHED_WATERMARK=0)
    front = ServingFront("t")
    blocker = front.admit("x", COST_WARM)
    hs = [_bg_admit(front, "tA", COST_COLD) for _ in range(4)]
    assert _wait(lambda: front.stats()["queued"] == 4)
    front.release(blocker)
    assert _wait(lambda: any("ticket" in h and h["ticket"].accounted
                             for h in hs))
    running = next(h for h in hs if "ticket" in h and h["ticket"].accounted)
    t = running["ticket"]
    for _ in range(8):  # repeated maximal refunds must stay capped
        t.cost = COST_COLD
        front.rebate(t, 0.0)
    cap = max(2.0 * COST_COLD * 1.0, COST_COLD)
    assert front.stats()["tenants"]["tA"]["deficit"] <= cap
    front.release(t)
    for h in hs:
        if "ticket" in h and h["ticket"] is not t:
            h["ticket"].event.wait(5.0)
            front.release(h["ticket"])


# ------------------------------------------------- parity with the reference


def _drr_order(serving, flag_mod, admits):
    """Dispatch order of `admits` [(tenant, cost)] through one package's
    ServingFront at capacity 1: each admit queues before the next starts
    (so the queue's order is the list's), then each release dispatches one
    ticket; returns the dispatched (tenant, index) sequence."""
    for n, v in dict(PL_SERVING_ENABLED=1, PL_SERVING_MAX_INFLIGHT=1,
                     PL_SERVING_QUEUE_DEPTH=64, PL_TENANT_QPS="",
                     PL_TENANT_CONCURRENCY="", PL_TENANT_WEIGHTS="1,vip=3,slow=0.5",
                     PL_SERVING_SHED_WATERMARK=0).items():
        flag_mod.set_for_testing(n, v)
    front = serving.ServingFront("t")
    blocker = front.admit("x", serving.COST_WARM)
    held = []
    for i, (tenant, cost) in enumerate(admits):
        holder = {}

        def go(tenant=tenant, cost=cost, holder=holder):
            holder["ticket"] = front.admit(tenant, cost, timeout_s=30.0)

        th = threading.Thread(target=go, daemon=True)
        th.start()
        holder["thread"], holder["i"] = th, i
        held.append(holder)
        assert _wait(lambda: front.stats()["queued"] == i + 1)
    order = []
    current = blocker
    for _ in admits:
        front.release(current)
        assert _wait(lambda: any("ticket" in h and h["ticket"].accounted
                                 and h["i"] not in {o[1] for o in order} for h in held))
        h = next(h for h in held if "ticket" in h and h["ticket"].accounted
                 and h["i"] not in {o[1] for o in order})
        order.append((h["ticket"].tenant, h["i"]))
        current = h["ticket"]
    front.release(current)
    return order


def test_drr_dispatch_order_equals_the_references():
    """The same admits, queued in the same order, dispatch in the
    reference's order: three tenants of weights 1, 3 and 0.5, warm and
    cold costs mixed."""
    from pixie_tpu import flags as ref_flags
    from pixie_tpu import serving as ref_serving
    import pixie_tpu_torch.serving as port_serving

    rng = np.random.default_rng(7)
    admits = [(str(rng.choice(["batch", "vip", "slow", "inter"])),
               float(rng.choice([COST_WARM, COST_COLD]))) for _ in range(16)]
    saved = {n: ref_flags.get(n) for n in SERVING_FLAGS if n != "PL_CLIENT_RETRIES"}
    try:
        want = _drr_order(ref_serving, ref_flags, admits)
    finally:
        for n, v in saved.items():
            ref_flags.set_for_testing(n, v)
    got = _drr_order(port_serving, flags, admits)
    assert got == want
    assert len({t for t, _ in got}) == 4
    assert [i for _t, i in got] != list(range(len(admits)))  # not FIFO
