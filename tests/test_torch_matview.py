"""Standing views: pixie_tpu_torch.matview against pixie_tpu.matview.

The cases of tests/test_matview.py that need no broker run through both
packages with views on: the reference's LocalCluster with one device per
agent on the JAX CPU, the port's with device="cpu", over stores written
from the same numpy seeds.  Each case compares the two packages' answers
and their views' bookkeeping (rows folded, hits, the rebuilt reason, which
views the budget evicted), and each package's warm answer with its own cold
one.  The aggregates are integer-exact (count, sums of integral values,
min, max), so every comparison is exact.

Beyond the reference's cases: one query whose agents' payloads mix a view's
host batch with rescanned device states (the rescanned agents gang-merge
first, and the view's batch is never mutated, and the rescan's stats say
why), a fold whose error is not a lost table propagating, the
stale-while-revalidate route (`serve(stale_ok=True)`), and the background
refresh (`start_refresher`) folding a delta before the next sight.  The broker case
(test_matview_spans_and_broker_stats) waits for the port's broker.
"""
import time

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu import plan as ref_plan
from pixie_tpu.engine.executor import PlanExecutor as RefExecutor
from pixie_tpu.matview import MatViewManager as RefManager
from pixie_tpu.matview import registry as ref_registry
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation

import pixie_tpu_torch.engine.executor as port_executor
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch import metrics
from pixie_tpu_torch import plan as port_plan
from pixie_tpu_torch.engine.executor import PlanExecutor
from pixie_tpu_torch.matview import MatViewManager
from pixie_tpu_torch.matview import registry as port_registry
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.status import Unavailable, Unimplemented
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation

SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status == 500]
df = df.groupby('service').agg(
    cnt=('latency', px.count), s=('latency', px.sum),
    lo=('latency', px.min), hi=('latency', px.max))
px.display(df, 'out')
"""

WINDOWED = """
df = px.DataFrame(table='http_events')
df.time_ = px.bin(df.time_, px.seconds(10))
df = df.groupby('time_').agg(
    cnt=('latency', px.count), hi=('latency', px.max))
px.display(df, 'out')
"""


class Pkg:
    """One package's entry points, so a case runs the same steps in both."""

    def __init__(self, name: str):
        self.name = name
        ref = name == "ref"
        self.flags = ref_flags if ref else port_flags
        self.plan = ref_plan if ref else port_plan
        self.registry = ref_registry if ref else port_registry
        self.dt = RefDT if ref else DT
        self.rel_cls = RefRelation if ref else Relation
        self.store_cls = RefStore if ref else TableStore
        self.rel = self.rel_cls.of(
            ("time_", self.dt.TIME64NS), ("service", self.dt.STRING),
            ("latency", self.dt.FLOAT64), ("status", self.dt.INT64))

    def cluster(self, stores):
        if self.name == "ref":
            return RefCluster(stores, n_devices_per_agent=1)
        return LocalCluster(stores, device="cpu")

    def manager(self, store):
        return RefManager(store) if self.name == "ref" else MatViewManager(store, device="cpu")

    def run_agent(self, plan, store):
        if self.name == "ref":
            return RefExecutor(plan, store).run_agent()
        return PlanExecutor(plan, store, device="cpu").run_agent()

    def cold(self, stores, script=SCRIPT, by="service"):
        """Oracle: the same query on a FRESH cluster with views off."""
        self.flags.set_for_testing("PL_MATVIEW_ENABLED", False)
        try:
            return _df(self.cluster(stores).query(script)["out"], by)
        finally:
            self.flags.set_for_testing("PL_MATVIEW_ENABLED", True)

    def store(self, seed, n=30_000, **kw):
        ts = self.store_cls()
        _write(ts.create("http_events", self.rel, batch_rows=4096, **kw), n, seed)
        return ts

    def partial_plan(self):
        P = self.plan
        p = P.Plan()
        src = p.add(P.MemorySourceOp(table="http_events"))
        agg = p.add(P.AggOp(groups=["service"], values=[P.AggExpr("cnt", "count", None)],
                            partial=True), parents=[src])
        p.add(P.ResultSinkOp(channel="mv", payload="agg_state"), parents=[agg])
        return p


PKGS = [Pkg("ref"), Pkg("port")]


@pytest.fixture(autouse=True)
def _matview_on():
    """Views on in both packages (the port's default); the reference's
    tracing off, as every parity file runs it."""
    saved = [(f, n, f.get(n)) for f in (ref_flags, port_flags)
             for n in ("PL_MATVIEW_ENABLED", "PL_MATVIEW_MAX_STATE_MB")]
    saved.append((ref_flags, "PL_TRACING_ENABLED", ref_flags.get("PL_TRACING_ENABLED")))
    for f in (ref_flags, port_flags):
        f.set_for_testing("PL_MATVIEW_ENABLED", True)
        f.set_for_testing("PL_MATVIEW_MAX_STATE_MB", 256)
    ref_flags.set_for_testing("PL_TRACING_ENABLED", False)
    yield
    for f, n, v in saved:
        f.set_for_testing(n, v)


def _write(t, n, seed, t0=0, shuffle=True):
    """n rows with OUT-OF-ORDER times (ingest order != time order)."""
    rng = np.random.default_rng(seed)
    times = np.arange(t0, t0 + n, dtype=np.int64) * 1000
    if shuffle:
        rng.shuffle(times)
    t.write({
        "time_": times,
        "service": rng.choice(["cart", "auth", "web"], n).tolist(),
        "latency": rng.integers(0, 1000, n).astype(np.float64),
        "status": rng.choice([200, 500], n),
    })


def _df(res, by="service"):
    return res.to_pandas().sort_values(by).reset_index(drop=True)


def _hits(res):
    return {a: (s.get("matview") or {}) for a, s in res.exec_stats["agents"].items()}


def _view_books(info: dict) -> dict:
    """What a view's answer must agree on across packages."""
    return {k: info.get(k) for k in ("hit", "rows_folded", "rebuilt", "groups")}


def both(case):
    """Run `case(pkg)` for both packages; the outputs must be equal."""
    ref, port = (case(p) for p in PKGS)
    assert _comparable(port) == _comparable(ref)
    return ref, port


def _comparable(x):
    if hasattr(x, "to_dict") and hasattr(x, "columns"):
        return {c: x[c].tolist() for c in x.columns}
    if isinstance(x, dict):
        return {k: _comparable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_comparable(v) for v in x]
    return x


# ------------------------------------------------------------- equivalence


def test_warm_equals_cold_after_out_of_order_ingest():
    def case(pkg):
        stores = {"pem1": pkg.store(1), "pem2": pkg.store(2)}
        cluster = pkg.cluster(stores)
        first = cluster.query(SCRIPT)  # 1st sight: register (normal path)
        assert all(not i for i in _hits(first["out"]).values())
        warm1 = _df(cluster.query(SCRIPT)["out"])  # 2nd: build + serve
        assert warm1.equals(pkg.cold(stores))
        # out-of-order delta: later-ingested rows carry EARLIER times
        _write(stores["pem1"].table("http_events"), 5_000, seed=7, t0=-5_000)
        res = cluster.query(SCRIPT)["out"]
        mv = _hits(res)
        assert all(i.get("hit") for i in mv.values()), mv
        assert mv["pem1"]["rows_folded"] == 5_000  # O(delta), not O(table)
        assert mv["pem2"]["rows_folded"] == 0
        cold = pkg.cold(stores)
        assert _df(res).equals(cold)
        return {"warm1": warm1, "warm": _df(res), "books": {a: _view_books(i)
                                                          for a, i in mv.items()}}

    both(case)


def test_windowed_agg_serves_from_view():
    def case(pkg):
        stores = {"pem1": pkg.store(3)}
        cluster = pkg.cluster(stores)
        cluster.query(WINDOWED)
        res = cluster.query(WINDOWED)["out"]
        assert all(i.get("hit") for i in _hits(res).values())
        assert _df(res, "time_").equals(pkg.cold(stores, WINDOWED, "time_"))
        return {"warm": _df(res, "time_"),
                "books": {a: _view_books(i) for a, i in _hits(res).items()}}

    both(case)


def test_disabling_flag_yields_identical_results():
    def case(pkg):
        stores = {"pem1": pkg.store(4)}
        cluster = pkg.cluster(stores)
        cluster.query(SCRIPT)
        warm = _df(cluster.query(SCRIPT)["out"])
        pkg.flags.set_for_testing("PL_MATVIEW_ENABLED", False)
        res = cluster.query(SCRIPT)["out"]
        pkg.flags.set_for_testing("PL_MATVIEW_ENABLED", True)
        assert _hits(res) == {"pem1": {}}  # flag off: a rescan
        cold = _df(res)
        assert warm.equals(cold)  # byte-identical frames (integer-exact aggs)
        return warm

    both(case)


# ------------------------------------------------------------ invalidation


def test_invalidation_on_retention_trim_past_cursor():
    def case(pkg):
        # tiny byte budget: new writes expire old sealed batches
        stores = {"pem1": pkg.store(5, n=20_000, max_bytes=1 << 20)}
        t = stores["pem1"].table("http_events")
        cluster = pkg.cluster(stores)
        cluster.query(SCRIPT)
        res = cluster.query(SCRIPT)["out"]
        assert all(i.get("hit") for i in _hits(res).values())
        first_before = t.first_row_id()
        # trim past the view's base: the standing state now covers expired rows
        _write(t, 40_000, seed=6, t0=20_000)
        assert t.first_row_id() > first_before
        res2 = cluster.query(SCRIPT)["out"]
        mv = _hits(res2)["pem1"]
        assert mv.get("hit") and mv.get("rebuilt") in ("trimmed", "gap")
        assert _df(res2).equals(pkg.cold(stores))
        return {"first_row_id": t.first_row_id(), "books": _view_books(mv),
                "warm": _df(res2)}

    both(case)


def test_schema_change_forces_rebuild():
    def case(pkg):
        stores = {"pem1": pkg.store(8)}
        cluster = pkg.cluster(stores)
        cluster.query(SCRIPT)
        assert all(i.get("hit") for i in _hits(cluster.query(SCRIPT)["out"]).values())
        # drop + recreate under the same name (new uid, fresh data): the view
        # must detect the stale table and rebuild instead of serving old state
        stores["pem1"].drop("http_events")
        t = stores["pem1"].create("http_events", pkg.rel, batch_rows=4096)
        _write(t, 9_000, seed=9)
        if pkg.name == "ref":
            cluster.apply_mutations([])  # refresh planner schemas (no-op mutations)
        res = cluster.query(SCRIPT)["out"]
        mv = _hits(res)["pem1"]
        assert mv.get("hit") and mv.get("rebuilt") == "stale_table"
        assert _df(res).equals(pkg.cold(stores))
        return {"books": _view_books(mv), "warm": _df(res)}

    both(case)


def test_dead_cursor_falls_back_to_full_rescan():
    def case(pkg):
        ts = pkg.store(10, n=8_192, max_bytes=1 << 20)
        t = ts.table("http_events")
        mgr = pkg.manager(ts)
        plan = pkg.partial_plan()
        assert mgr.serve(plan) is None  # first sight registers only
        served = mgr.serve(plan)
        assert served is not None
        view = mgr._views[pkg.registry.plan_view_key(plan)]
        wm = view.cursor.watermark
        # expire EVERYTHING the cursor read and then some: unread rows are gone
        _write(t, 60_000, seed=11, t0=8_192)
        assert t.first_row_id() > wm  # a dead cursor (gap), not just a trim
        _cid, pb, info = mgr.serve(plan)
        assert info["rebuilt"] == "gap"
        # rebuilt state equals a cold partial over the retained rows
        pkg.flags.set_for_testing("PL_MATVIEW_ENABLED", False)
        cold = pkg.run_agent(pkg.partial_plan(), ts)["mv"]
        pkg.flags.set_for_testing("PL_MATVIEW_ENABLED", True)
        assert pb.num_groups == cold.num_groups
        got = np.sort(np.asarray(pb.states["cnt"]))
        np.testing.assert_array_equal(got, np.sort(np.asarray(cold.states["cnt"])))
        return {"cnt": got.tolist(), "watermark": wm, "books": _view_books(info),
                "stats": [{k: s[k] for k in ("refreshes", "rows_folded", "hits", "rebuilds")}
                          for s in mgr.stats()]}

    both(case)


# ----------------------------------------------------------------- hygiene


def test_state_budget_evicts_lru_views():
    """Every retained view's state stays under PL_MATVIEW_MAX_STATE_MB, with
    LRU eviction of cold views; both packages evict the same view."""
    rng = np.random.default_rng(12)
    n = 120_000
    data = {"time_": np.arange(n, dtype=np.int64),
            "k": np.arange(n, dtype=np.int64),  # 120k distinct groups
            "v": rng.random(n)}

    def case(pkg):
        ts = pkg.store_cls()
        rel = pkg.rel_cls.of(("time_", pkg.dt.TIME64NS), ("k", pkg.dt.INT64),
                             ("v", pkg.dt.FLOAT64))
        ts.create("wide", rel, batch_rows=1 << 14, max_bytes=1 << 30).write(
            {k: v.copy() for k, v in data.items()})
        mgr = pkg.manager(ts)
        P = pkg.plan

        def plan_for(out):
            p = P.Plan()
            src = p.add(P.MemorySourceOp(table="wide"))
            agg = p.add(P.AggOp(groups=["k"], values=[P.AggExpr(out, "sum", "v")],
                                partial=True), parents=[src])
            p.add(P.ResultSinkOp(channel="mv", payload="agg_state"), parents=[agg])
            return p

        plans = [plan_for(o) for o in ("a", "b", "c")]
        keys = [pkg.registry.plan_view_key(p) for p in plans]
        assert len(set(keys)) == 3
        for p in plans:
            mgr.serve(p)  # register
        served = [mgr.serve(p) for p in plans]
        assert all(s is not None for s in served)
        per_view = max(v.state_bytes for v in mgr._views.values())
        assert per_view > 1 << 20  # the fixture actually stresses the budget
        budget_mb = max(1, (2 * per_view) >> 20)  # room for ~2 of 3 views
        pkg.flags.set_for_testing("PL_MATVIEW_MAX_STATE_MB", budget_mb)
        mgr.serve(plans[2])  # re-serve the newest: triggers budget enforcement
        kept = set(mgr._views)
        assert keys[2] in kept  # the hot view survives
        assert keys[0] not in kept  # the LRU view evicted
        assert mgr.state_bytes() <= budget_mb << 20
        return {"kept": sorted(keys.index(k) for k in kept), "budget_mb": budget_mb,
                "per_view": per_view}

    before = metrics.counter_value("px_matview_evictions_total")
    both(case)
    assert metrics.counter_value("px_matview_evictions_total") > before
    assert "px_matview_evictions_total" in metrics.render()


def test_oversized_single_view_never_retained():
    def case(pkg):
        ts = pkg.store(13, n=8_192)
        mgr = pkg.manager(ts)
        plan = pkg.partial_plan()
        mgr.serve(plan)
        pkg.flags.set_for_testing("PL_MATVIEW_MAX_STATE_MB", 0)
        served = mgr.serve(plan)
        assert served is not None  # the answer is still produced...
        assert not mgr._views  # ...but a budget-busting view is not retained
        return np.sort(np.asarray(served[1].states["cnt"])).tolist()

    both(case)


# ----------------------------------------------------------- eligibility


def test_time_bounded_and_limited_plans_are_ineligible():
    def case(pkg):
        P = pkg.plan
        p = P.Plan()
        src = p.add(P.MemorySourceOp(table="http_events", start_time=0, stop_time=10))
        agg = p.add(P.AggOp(groups=["service"], values=[P.AggExpr("cnt", "count", None)],
                            partial=True), parents=[src])
        p.add(P.ResultSinkOp(channel="mv", payload="agg_state"), parents=[agg])
        assert pkg.registry.match_prefix(p) is None

        p2 = P.Plan()
        src = p2.add(P.MemorySourceOp(table="http_events"))
        lim = p2.add(P.LimitOp(n=10), parents=[src])
        agg = p2.add(P.AggOp(groups=["service"], values=[P.AggExpr("cnt", "count", None)],
                             partial=True), parents=[lim])
        p2.add(P.ResultSinkOp(channel="mv", payload="agg_state"), parents=[agg])
        assert pkg.registry.match_prefix(p2) is None
        return pkg.registry.match_prefix(pkg.partial_plan()) is not None

    both(case)


def test_view_key_stable_across_compilations():
    def case(pkg):
        k1 = pkg.registry.plan_view_key(pkg.partial_plan())
        k2 = pkg.registry.plan_view_key(pkg.partial_plan())
        assert k1 == k2 and k1 is not None
        assert pkg.registry.view_key(pkg.registry.match_prefix(pkg.partial_plan())) == k1
        return k1

    both(case)  # the same key in both packages: the plans' dicts agree


# ------------------------------------------------- beyond the reference


def test_mixed_view_and_rescanned_payloads_equal_the_cold_answer(monkeypatch):
    """pem1 answers from its view; pem2 and pem3 (identical stores, so one
    layout) fail their refresh and rescan: their device states gang-merge
    among themselves (one merge of 2 states), then merge by key values with
    pem1's host batch, which stays as the view holds it."""
    stores = {"pem1": Pkg("port").store(21), "pem2": Pkg("port").store(22),
              "pem3": Pkg("port").store(22)}
    cluster = LocalCluster(stores, device="cpu")
    cluster.query(SCRIPT)  # first sight: every agent registers

    def refresh_fails(*a, **k):
        raise Unavailable("the table went away under the fold")

    for agent in ("pem2", "pem3"):
        monkeypatch.setattr(cluster.matviews(agent), "_compute_partial", refresh_fails)
    merges = []
    real = port_executor.merge_states

    def counting(reduce_tree, states):
        merges.append(len(states))
        return real(reduce_tree, states)

    monkeypatch.setattr(port_executor, "merge_states", counting)
    res = cluster.query(SCRIPT)["out"]
    mv = _hits(res)
    assert mv["pem1"]["hit"] and mv["pem1"]["rows_folded"] == 30_000
    for agent in ("pem2", "pem3"):  # fell back to a rescan, which says why
        assert mv[agent]["hit"] is False and mv[agent]["reason"] == "refresh_failed"
        assert "went away" in mv[agent]["error"]
        assert res.exec_stats["agents"][agent]["rows_scanned"] == 30_000
    assert merges == [2]
    assert set(cluster.matviews("pem2")._views) == set()  # the failed view dropped
    (view,) = cluster.matviews("pem1")._views.values()
    held = {k: np.array(v, copy=True) for k, v in view.state.states.items()}
    keys = np.array(view.state.key_cols["service"], copy=True)
    got = _df(res)
    assert got.equals(Pkg("port").cold(stores))
    ref_stores = {"pem1": Pkg("ref").store(21), "pem2": Pkg("ref").store(22),
                  "pem3": Pkg("ref").store(22)}
    assert _comparable(got) == _comparable(Pkg("ref").cold(ref_stores))
    # a third query: pem1 serves the same standing batch, unchanged
    again = _df(cluster.query(SCRIPT)["out"])
    assert again.equals(got)
    assert all(np.array_equal(np.asarray(view.state.states[k]), v) for k, v in held.items())
    assert np.array_equal(view.state.key_cols["service"], keys)


def test_background_refresher_folds_the_delta():
    """start_refresher(0.05): the cron tick (refresh_all) folds appended rows
    before the next sight, which then folds nothing and equals a cold
    partial."""
    def case(pkg):
        ts = pkg.store(31, n=8_192)
        mgr = pkg.manager(ts)
        plan = pkg.partial_plan()
        assert mgr.serve(plan) is None
        assert mgr.serve(plan)[2]["rows_folded"] == 8_192
        (view,) = mgr._views.values()
        _write(ts.table("http_events"), 3_000, seed=32, t0=8_192)
        mgr.start_refresher(0.05)
        try:
            deadline = time.monotonic() + 30
            while view.rows_folded < 11_192 and time.monotonic() < deadline:
                time.sleep(0.02)
        finally:
            mgr.stop_refresher()
        assert view.rows_folded == 11_192 and mgr._ticker is None
        _cid, pb, info = mgr.serve(plan)
        assert info["rows_folded"] == 0
        pkg.flags.set_for_testing("PL_MATVIEW_ENABLED", False)
        cold = pkg.run_agent(pkg.partial_plan(), ts)["mv"]
        pkg.flags.set_for_testing("PL_MATVIEW_ENABLED", True)
        order = np.argsort(np.asarray(pb.key_cols["service"], dtype=str))
        corder = np.argsort(np.asarray(cold.key_cols["service"], dtype=str))
        got = np.asarray(pb.states["cnt"])[order]
        np.testing.assert_array_equal(got, np.asarray(cold.states["cnt"])[corder])
        return {"cnt": got.tolist(), "refreshes": view.refreshes}

    both(case)


def test_snapshot_dir_is_refused():
    mgr = MatViewManager(TableStore(), device="cpu")
    mgr.set_snapshot_dir(None)  # no directory: nothing to refuse
    with pytest.raises(Unimplemented, match="6b"):
        mgr.set_snapshot_dir("/nonexistent/snapshots")


def test_a_fold_that_faults_propagates(monkeypatch):
    """Only a fold that lost its table falls back to a rescan: any other
    error (a kernel's, a torch error, a porting bug) reaches the caller."""
    stores = {"pem1": Pkg("port").store(51)}
    cluster = LocalCluster(stores, device="cpu")
    cluster.query(SCRIPT)  # first sight: registers

    def faults(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(cluster.matviews("pem1"), "_compute_partial", faults)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        cluster.query(SCRIPT)


def test_stale_ok_serves_the_standing_state_without_folding():
    """serve(stale_ok=True), the stale-while-revalidate route: a view with
    standing state answers as it stands and reports the rows it left
    pending; the next plain serve folds them."""
    def case(pkg):
        ts = pkg.store(61, n=8_192)
        mgr = pkg.manager(ts)
        plan = pkg.partial_plan()
        assert mgr.serve(plan, stale_ok=True) is None  # first sight registers
        _cid, built, info = mgr.serve(plan)
        assert info["rows_folded"] == 8_192 and "stale" not in info
        _write(ts.table("http_events"), 2_000, seed=62, t0=8_192)
        _cid, stale, sinfo = mgr.serve(plan, stale_ok=True)
        assert stale is built  # the standing batch, unchanged
        assert sinfo["stale"] and sinfo["rows_folded"] == 0
        assert sinfo["stale_pending_rows"] == 2_000
        _cid, fresh, finfo = mgr.serve(plan)
        assert finfo["rows_folded"] == 2_000
        (view,) = mgr._views.values()
        order = np.argsort(np.asarray(fresh.key_cols["service"], dtype=str))
        return {"stale": {k: sinfo[k] for k in ("rows_folded", "stale_pending_rows",
                                                "groups", "rebuilt")},
                "cnt": np.asarray(fresh.states["cnt"])[order].tolist(),
                "stale_serves": view.stale_serves, "hits": view.hits}

    both(case)


def test_analyze_bypasses_the_views():
    stores = {"pem1": Pkg("port").store(41)}
    cluster = LocalCluster(stores, device="cpu")
    cluster.query(SCRIPT)
    cluster.query(SCRIPT)
    res = cluster.query(SCRIPT, analyze=True)["out"]
    assert _hits(res) == {"pem1": {}}
    assert res.exec_stats["agents"]["pem1"]["rows_scanned"] == 30_000
