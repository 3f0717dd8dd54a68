"""Tablets: pixie_tpu_torch.table.tablets against pixie_tpu.table.tablets.

The cases of tests/test_tablets.py run through both packages over the same
writes (numpy seeds): writes route to tablets by the tablet column, a
whole-group scan and a one-tablet scan (`MemorySourceOp.tablet`) answer as
the reference's (counts exactly, float sums to rtol 1e-12) and as pandas,
every tablet shares the group's dictionaries, an unknown tablet or a
tablet asked of a plain table raise the reference's errors, plans with a
tablet round-trip through to_dict, and an int group key over a tabletized
table works.  A standing view over one tablet folds that tablet's rows.

Beyond the reference's cases, the port's device caches: two tablets whose
seal generations coincide never answer each other's scans — the feed
cache keys carry the tablet (a whole-group cursor namespaces its gens as
(tablet, gen), and a one-tablet scan reads the tablet's own Table uid),
and the resident tier declines a group's namespaced gens.
"""
from __future__ import annotations

import numpy as np
import pandas as pd
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview  # noqa: F401
from pixie_tpu import flags as ref_flags
from pixie_tpu import plan as ref_plan
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.status import InvalidArgument as RefInvalidArgument, NotFound as RefNotFound
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation

import pixie_tpu_torch.engine.executor as port_executor
import pixie_tpu_torch.matview  # noqa: F401
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch import plan as port_plan
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.engine import resident as port_resident
from pixie_tpu_torch.matview import MatViewManager
from pixie_tpu_torch.status import InvalidArgument, NotFound
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.table.tablets import TabletsGroup
from pixie_tpu_torch.types import DataType as DT, Relation


@pytest.fixture(autouse=True)
def _clean():
    saved = [(f, f.get("PX_CPU_CROSSOVER_ROWS")) for f in (ref_flags, port_flags)]
    for f, _v in saved:
        f.set_for_testing("PX_CPU_CROSSOVER_ROWS", 0)
    port_executor.clear_device_cache()
    port_resident.clear_for_testing()
    yield
    for f, v in saved:
        f.set_for_testing("PX_CPU_CROSSOVER_ROWS", v)


class Pkg:
    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.P = port_plan if port else ref_plan
        self.DT = DT if port else RefDT
        self.Relation = Relation if port else RefRelation
        self.Store = TableStore if port else RefStore
        self.NotFound = NotFound if port else RefNotFound
        self.InvalidArgument = InvalidArgument if port else RefInvalidArgument

    def execute(self, plan, ts):
        if self.name == "port":
            return execute_plan(plan, ts, device="cpu")
        return ref_execute(plan, ts)

    def store(self, n=6000, seed=4):
        rng = np.random.default_rng(seed)
        ts = self.Store()
        rel = self.Relation.of(("time_", self.DT.TIME64NS), ("pod", self.DT.STRING),
                               ("svc", self.DT.STRING), ("v", self.DT.FLOAT64))
        t = ts.create("events", rel, tablet_col="pod", batch_rows=512)
        pods = np.array([f"pod-{i}" for i in range(4)])
        data = {"time_": np.arange(n, dtype=np.int64), "pod": pods[rng.integers(0, 4, n)],
                "svc": rng.choice(["a", "b"], n), "v": rng.exponential(1.0, n)}
        t.write(data)
        return ts, pd.DataFrame(data)

    def scan_plan(self, tablet=None, groups=("svc",)):
        P = self.P
        p = P.Plan()
        src = p.add(P.MemorySourceOp(table="events", tablet=tablet))
        agg = p.add(P.AggOp(groups=list(groups),
                            values=[P.AggExpr("cnt", "count", None), P.AggExpr("s", "sum", "v")]),
                    parents=[src])
        p.add(P.MemorySinkOp(name="out"), parents=[agg])
        return p


PKGS = [Pkg("ref"), Pkg("port")]


def _frame(res, by="svc"):
    return res.to_pandas().sort_values(by).reset_index(drop=True)


def _same(got, want):
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c], want[c], rtol=1e-12, err_msg=c)
        else:
            assert got[c].tolist() == want[c].tolist(), c


@pytest.mark.parametrize("tablet", [None, "pod-0", "pod-2", "pod-3"])
def test_scan_matches_the_reference_and_pandas(tablet):
    out = {}
    for pk in PKGS:
        ts, df = pk.store()
        out[pk.name] = _frame(pk.execute(pk.scan_plan(tablet=tablet), ts)["out"])
    _same(out["port"], out["ref"])
    sel = df if tablet is None else df[df["pod"] == tablet]
    want = (sel.groupby("svc").agg(cnt=("v", "size"), s=("v", "sum")).reset_index()
            .sort_values("svc").reset_index(drop=True))
    assert out["port"]["cnt"].tolist() == want["cnt"].tolist()
    np.testing.assert_allclose(out["port"]["s"], want["s"], rtol=1e-9)


def test_write_routes_and_shares_one_code_space():
    stats = {}
    for pk in PKGS:
        ts, df = pk.store()
        g = ts.table("events")
        assert g.tablet_ids() == [f"pod-{i}" for i in range(4)]
        d = g.dictionaries["svc"]
        assert all(g.tablet(tid).dictionaries["svc"] is d for tid in g.tablet_ids())
        s = g.stats()
        stats[pk.name] = (s["tablets"], s["rows_written"], s["batches"], s["hot_rows"],
                          s["dict_sizes"],
                          [g.tablet(t).stats()["rows_written"] for t in g.tablet_ids()])
    assert stats["port"] == stats["ref"]
    assert isinstance(TableStore().create(
        "x", Relation.of(("time_", DT.TIME64NS), ("k", DT.STRING)), tablet_col="k"),
        TabletsGroup)


@pytest.mark.parametrize("case", ["unknown_tablet", "untabletized"])
def test_errors_equal_the_references(case):
    raised = {}
    for pk in PKGS:
        if case == "unknown_tablet":
            ts, _df = pk.store()
            plan, want = pk.scan_plan(tablet="nope"), pk.NotFound
        else:
            ts = pk.Store()
            ts.create("events", pk.Relation.of(("time_", pk.DT.TIME64NS),
                                               ("v", pk.DT.FLOAT64)))
            ts.table("events").write({"time_": np.arange(4, dtype=np.int64), "v": np.ones(4)})
            P = pk.P
            plan = P.Plan()
            src = plan.add(P.MemorySourceOp(table="events", tablet="x"))
            plan.add(P.MemorySinkOp(name="out"), parents=[src])
            want = pk.InvalidArgument
        with pytest.raises(want) as ei:
            pk.execute(plan, ts)
        raised[pk.name] = type(ei.value).__name__
    assert raised["port"] == raised["ref"]


def test_tablet_plan_roundtrip():
    pk = PKGS[1]
    p = pk.scan_plan(tablet="pod-1")
    p2 = port_plan.Plan.from_dict(p.to_dict())
    assert p2.to_dict() == ref_plan.Plan.from_dict(p.to_dict()).to_dict()
    ts, _df = pk.store()
    _same(_frame(pk.execute(p2, ts)["out"]), _frame(pk.execute(p, ts)["out"]))


def test_int_group_key_on_tabletized_table():
    out = {}
    for pk in PKGS:
        rng = np.random.default_rng(4)
        ts = pk.Store()
        t = ts.create("codes", pk.Relation.of(("time_", pk.DT.TIME64NS), ("pod", pk.DT.STRING),
                                              ("code", pk.DT.INT64)),
                      tablet_col="pod", batch_rows=512)
        n = 4000
        data = {"time_": np.arange(n, dtype=np.int64),
                "pod": np.array(["p0", "p1"])[rng.integers(0, 2, n)],
                "code": rng.choice([200, 404, 500], n)}
        t.write(data)
        P = pk.P
        p = P.Plan()
        src = p.add(P.MemorySourceOp(table="codes"))
        agg = p.add(P.AggOp(groups=["code"], values=[P.AggExpr("n", "count", None)]),
                    parents=[src])
        p.add(P.MemorySinkOp(name="out"), parents=[agg])
        out[pk.name] = _frame(pk.execute(p, ts)["out"], "code")
    _same(out["port"], out["ref"])
    want = pd.Series(data["code"]).value_counts().sort_index()
    assert out["port"]["code"].tolist() == list(want.index)


def test_view_over_one_tablet_folds_that_tablets_rows():
    ts, df = PKGS[1].store()
    P = port_plan
    p = P.Plan()
    src = p.add(P.MemorySourceOp(table="events", tablet="pod-1"))
    agg = p.add(P.AggOp(groups=["svc"], values=[P.AggExpr("cnt", "count", None)],
                        partial=True), parents=[src])
    p.add(P.ResultSinkOp(channel="mv", payload="agg_state"), parents=[agg])
    mgr = MatViewManager(ts, device="cpu")
    assert mgr.serve(p) is None  # first sight registers
    _cid, pb, info = mgr.serve(p)
    assert info["rows_folded"] == int((df["pod"] == "pod-1").sum())
    assert sum(np.asarray(pb.states["cnt"]).tolist()) == info["rows_folded"]


def test_two_tablets_with_coinciding_generations_never_alias_in_the_caches():
    """Tablets pod-0 and pod-1 seal the same generations (0, 1, ...): each
    one-tablet scan must answer with its own rows, warm and cold, and the
    whole-group scan must not reuse either tablet's feed."""
    pk = PKGS[1]
    ts = pk.Store()
    rel = Relation.of(("time_", DT.TIME64NS), ("pod", DT.STRING), ("svc", DT.STRING),
                      ("v", DT.FLOAT64))
    g = ts.create("events", rel, tablet_col="pod", batch_rows=512)
    n = 2048  # 1024 rows a tablet: 2 sealed batches each, gens 0 and 1 in both
    g.write({"time_": np.arange(n, dtype=np.int64),
             "pod": np.array(["pod-0", "pod-1"])[np.arange(n) % 2],
             "svc": np.array(["a", "b"])[(np.arange(n) // 2) % 2],
             "v": np.where(np.arange(n) % 2 == 0, 1.0, 100.0)})
    gens = {tid: [sb.gen for sb in g.tablet(tid)._sealed] for tid in g.tablet_ids()}
    assert gens["pod-0"] == gens["pod-1"] == [0, 1]
    assert g.tablet("pod-0").uid != g.tablet("pod-1").uid
    for _round in range(2):  # cold, then warm (resident tier / feed cache)
        for tid, v in (("pod-0", 1.0), ("pod-1", 100.0)):
            got = _frame(pk.execute(pk.scan_plan(tablet=tid), ts)["out"])
            assert got["cnt"].tolist() == [512, 512]
            assert got["s"].tolist() == [512 * v, 512 * v]
        whole = _frame(pk.execute(pk.scan_plan(), ts)["out"])
        assert whole["cnt"].tolist() == [1024, 1024]
        assert whole["s"].tolist() == [512 * 101.0, 512 * 101.0]
    group_keys = [k for k in port_executor._DEVICE_CACHE if k[0] == g.uid]
    assert group_keys and all(isinstance(gen, tuple) for k in group_keys for gen in k[1])
    assert not any(k[0] == g.uid for k in port_resident._TIER)
