"""The sorted high-cardinality group-by fallback: pixie_tpu against
pixie_tpu_torch (device="cpu") over the same rows.

The single-device cases of tests/test_sorted_agg.py run through both
packages (the reference with mesh=None, its single-device executor): a
computed key, a million distinct groups, a float key, NaN keys dropped, a bin
over a value column, `any` over strings with nulls, and two string keys past
the MAX_GROUPS bound; and the chip phase's two shapes, small (a raw int key
past MAX_GROUPS; a binned key with a p50).  Each asserts that both executors took the fallback
once and compares the results sorted by group key: keys, counts, int64 sums,
min, max and string pickers exactly; float64 sums and means to rtol 1e-12
(a different summation order); quantiles to rtol 1e-12 (the same sketch
bin).
"""
import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.engine.executor as ref_exmod
from pixie_tpu.plan import (
    AggExpr, AggOp, Call, Column, JoinOp, MapOp, MemorySinkOp, MemorySourceOp,
    Plan, lit,
)
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as DT, Relation

import pixie_tpu_torch.engine.executor as port_exmod
import pixie_tpu_torch.interop as interop
from pixie_tpu_torch.table import TableStore as PortStore
from pixie_tpu_torch.types import Relation as PortRelation

EXACT = ("cnt", "mn", "mx", "s_int", "nm", "s_str")


def _stores(tables: dict):
    """{name: (fields, cols, batch_rows)} written into both packages."""
    ref, port = RefStore(), PortStore()
    for name, (fields, cols, batch_rows) in tables.items():
        rel = Relation.of(*fields)
        ref.create(name, rel, batch_rows=batch_rows).write(
            {k: v.copy() for k, v in cols.items()})
        port.create(name, PortRelation.from_dict(rel.to_dict()),
                    batch_rows=batch_rows).write({k: v.copy() for k, v in cols.items()})
    return ref, port


def _events(n, ids, vals, extra=()):
    fields = [("time_", DT.TIME64NS), ("id", DT.INT64), ("v", DT.FLOAT64)]
    cols = {"time_": np.arange(n, dtype=np.int64), "id": ids, "v": vals}
    for name, dt, arr in extra:
        fields.append((name, dt))
        cols[name] = arr
    return _stores({"events": (fields, cols, 1 << 15)})


def _agg_plan(groups, values, map_exprs=None):
    p = Plan()
    node = p.add(MemorySourceOp(table="events"))
    if map_exprs:
        node = p.add(MapOp(exprs=map_exprs), parents=[node])
    agg = p.add(AggOp(groups=groups, values=values), parents=[node])
    p.add(MemorySinkOp(name="out"), parents=[agg])
    return p


def _frame(res):
    """{column: values}, string columns decoded."""
    cols = {c: np.asarray(res.decoded(c), dtype=object) if c in res.dictionaries
            else np.asarray(res.columns[c]) for c in res.relation.names()}
    return cols


def _run_both(stores, plan, groups):
    ref_store, port_store = stores
    rex = ref_exmod.PlanExecutor(plan, ref_store, mesh=None)
    want = rex.run()["out"]
    pex = port_exmod.PlanExecutor(interop.plan_from_dict(plan.to_dict()), port_store,
                                  device="cpu")
    got = pex.run()["out"]
    assert rex.stats.get("sorted_agg_fallbacks", 0) == 1
    assert pex.stats.get("sorted_agg_fallbacks", 0) == 1
    g, w = _frame(got), _frame(want)
    assert list(g) == list(w)
    assert len(g[groups[0]]) == len(w[groups[0]])

    def order(f):
        return np.lexsort([np.asarray(f[k]).astype(str) if f[k].dtype == object
                           else f[k] for k in reversed(groups)])

    go, wo = order(g), order(w)
    for c in g:
        a, b = g[c][go], w[c][wo]
        if c in groups or c in EXACT or a.dtype == object:
            np.testing.assert_array_equal(a, b, err_msg=c)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=c)
    return g


def test_computed_numeric_key():
    rng = np.random.default_rng(5)
    n = 50_000
    ids, vals = rng.integers(0, 1000, n), rng.exponential(3.0, n)
    got = _run_both(_events(n, ids, vals), _agg_plan(
        ["k"], [AggExpr("cnt", "count", None), AggExpr("s", "sum", "v")],
        map_exprs=[("k", Call("modulo", (Column("id"), lit(7)))), ("v", Column("v"))]),
        ["k"])
    assert list(got["k"]) == list(range(7))


def test_million_distinct_groups():
    rng = np.random.default_rng(6)
    n, n_groups = 2_200_000, 1_100_000
    ids = rng.permutation(np.arange(n) % n_groups)  # every group exactly twice
    vals = rng.normal(10.0, 2.0, n)
    got = _run_both(_events(n, ids, vals), _agg_plan(
        ["k"], [AggExpr("cnt", "count", None), AggExpr("s", "sum", "v"),
                AggExpr("mn", "min", "v"), AggExpr("mx", "max", "v")],
        map_exprs=[("k", Call("add", (Call("multiply", (Column("id"), lit(2))), lit(1)))),
                   ("v", Column("v"))]), ["k"])
    assert len(got["k"]) == n_groups and (got["cnt"] == 2).all()


def test_float_group_key():
    rng = np.random.default_rng(7)
    n = 10_000
    ids = rng.integers(0, 50, n)
    fkey = (ids % 5).astype(np.float64) * 0.5
    got = _run_both(_events(n, ids, rng.exponential(1.0, n), [("fk", DT.FLOAT64, fkey)]),
                    _agg_plan(["fk"], [AggExpr("cnt", "count", None),
                                       AggExpr("m", "mean", "v")]), ["fk"])
    assert list(got["fk"]) == [0.0, 0.5, 1.0, 1.5, 2.0]


def test_nan_float_keys_dropped():
    fk = np.array([1.0, np.nan, 1.0, np.nan, 2.0])
    got = _run_both(_events(5, np.arange(5), np.arange(1.0, 6.0), [("fk", DT.FLOAT64, fk)]),
                    _agg_plan(["fk"], [AggExpr("cnt", "count", None)]), ["fk"])
    assert list(got["fk"]) == [1.0, 2.0] and list(got["cnt"]) == [2, 1]


def test_bin_over_value_column_not_window():
    rng = np.random.default_rng(11)
    n = 5_000
    ids = rng.integers(0, 1000, n)
    got = _run_both(_events(n, ids, rng.exponential(1.0, n)), _agg_plan(
        ["b"], [AggExpr("cnt", "count", None)],
        map_exprs=[("b", Call("bin", (Column("id"), lit(100)))), ("v", Column("v"))]),
        ["b"])
    assert list(got["b"]) == list(range(0, 1000, 100))


def test_computed_key_with_mean_and_p50():
    """The chip phase's S2 shape, small: a bin over a value column with a
    count, a mean and a p50, whose sketch state is updated per chunk and
    finalized through the quantile kernel's plain version."""
    rng = np.random.default_rng(13)
    n = 40_000
    ids = rng.integers(0, 1 << 20, n)
    _run_both(_events(n, ids, rng.exponential(50.0, n)), _agg_plan(
        ["b"], [AggExpr("cnt", "count", None), AggExpr("m", "mean", "v"),
                AggExpr("p50", "p50", "v")],
        map_exprs=[("b", Call("bin", (Column("id"), lit(4096)))), ("v", Column("v"))]),
        ["b"])


def test_any_over_string_column_sorted_path():
    rng = np.random.default_rng(21)
    n = 8_000
    ids = rng.integers(0, 50, n)
    svc = np.array([f"svc-{i % 5}" for i in ids])
    got = _run_both(
        _events(n, ids, rng.exponential(1.0, n), [("svc", DT.STRING, svc)]),
        _agg_plan(["k"], [AggExpr("s_str", "any", "svc")],
                  map_exprs=[("k", Call("modulo", (Column("id"), lit(5)))),
                             ("svc", Column("svc"))]), ["k"])
    assert len(got["k"]) == 5 and set(got["s_str"]) <= set(svc)


def test_any_over_string_nulls_decode_to_none():
    """Left-join fills give null names; the computed key sends the agg down
    the sorted path, where all-null groups must decode to null."""
    stores = _stores({
        "left": ([("k", DT.INT64), ("v", DT.FLOAT64)],
                 {"k": np.array([1, 1, 2, 3, 4, 4]), "v": np.ones(6)}, 1024),
        "right": ([("k", DT.INT64), ("name", DT.STRING)],
                  {"k": np.array([1, 4]), "name": np.array(["one", "four"])}, 1024),
    })
    p = Plan()
    j = p.add(JoinOp(how="left", left_on=["k"], right_on=["k"],
                     output=[("left", "k", "k"), ("left", "v", "v"),
                             ("right", "name", "name")]),
              parents=[p.add(MemorySourceOp(table="left")),
                       p.add(MemorySourceOp(table="right"))])
    m = p.add(MapOp(exprs=[("kk", Call("multiply", (Column("k"), lit(10)))),
                           ("name", Column("name"))]), parents=[j])
    agg = p.add(AggOp(groups=["kk"], values=[AggExpr("nm", "any", "name"),
                                             AggExpr("cnt", "count", None)]), parents=[m])
    p.add(MemorySinkOp(name="out"), parents=[agg])
    got = _run_both(stores, p, ["kk"])
    assert dict(zip(got["kk"], got["nm"])) == {10: "one", 20: None, 30: None, 40: "four"}


def test_string_keys_beyond_max_groups(monkeypatch):
    """Two dict keys whose cardinality product exceeds MAX_GROUPS take the
    fallback (not an error) in both packages."""
    rng = np.random.default_rng(9)
    n = 20_000
    svc = np.array([f"svc-{i}" for i in range(64)])[rng.integers(0, 64, n)]
    path = np.array([f"/p/{i}" for i in range(64)])[rng.integers(0, 64, n)]
    stores = _events(n, rng.integers(0, 100, n), rng.exponential(1.0, n),
                     [("svc", DT.STRING, svc), ("path", DT.STRING, path)])
    monkeypatch.setattr(ref_exmod, "MAX_GROUPS", 1024)
    monkeypatch.setattr(port_exmod, "MAX_GROUPS", 1024)
    got = _run_both(stores, _agg_plan(["svc", "path"], [AggExpr("cnt", "count", None)]),
                    ["svc", "path"])
    assert int(got["cnt"].sum()) == n and len(got["cnt"]) == len(set(zip(svc, path)))


def test_raw_int_key_beyond_max_groups(monkeypatch):
    """The chip phase's S1 shape, small: a raw int64 key with more distinct
    values than MAX_GROUPS takes the fallback with count, int64 sum, mean,
    min and max."""
    rng = np.random.default_rng(13)
    n = 30_000
    ids = rng.integers(0, 1 << 14, n)
    stores = _events(n, ids, rng.exponential(50.0, n),
                     [("nbytes", DT.INT64, rng.integers(0, 1 << 24, n))])
    monkeypatch.setattr(ref_exmod, "MAX_GROUPS", 1024)
    monkeypatch.setattr(port_exmod, "MAX_GROUPS", 1024)
    got = _run_both(stores, _agg_plan(["id"], [
        AggExpr("cnt", "count", None), AggExpr("s_int", "sum", "nbytes"),
        AggExpr("m", "mean", "v"), AggExpr("mn", "min", "v"), AggExpr("mx", "max", "v")]),
        ["id"])
    np.testing.assert_array_equal(got["id"], np.unique(ids))


def test_two_computed_keys_sparse_code_space():
    """Two keys whose composite code space (~10^6) far exceeds the rows:
    the groups come from a sort and a binary search, not a dense map."""
    rng = np.random.default_rng(17)
    n = 5_000
    ids = rng.integers(0, 1 << 30, n)
    fk = rng.integers(0, 1000, n).astype(np.float64)
    _run_both(_events(n, ids, rng.exponential(1.0, n), [("fk", DT.FLOAT64, fk)]), _agg_plan(
        ["k", "fk"], [AggExpr("cnt", "count", None), AggExpr("m", "mean", "v"),
                      AggExpr("mx", "max", "v")],
        map_exprs=[("k", Call("modulo", (Column("id"), lit(997)))), ("fk", Column("fk")),
                   ("v", Column("v"))]), ["k", "fk"])


def test_value_columns_named_gid_and_mask():
    """Value columns may carry any name, including those of the chunk's own
    group-id and mask arrays."""
    rng = np.random.default_rng(19)
    n = 3_000
    ids = rng.integers(0, 100, n)
    _run_both(_events(n, ids, rng.exponential(1.0, n),
                      [("gid", DT.INT64, rng.integers(0, 1 << 40, n)),
                       ("mask", DT.FLOAT64, rng.normal(0.0, 1.0, n))]),
              _agg_plan(["k"], [AggExpr("s_int", "sum", "gid"), AggExpr("mx", "max", "mask")],
                        map_exprs=[("k", Call("modulo", (Column("id"), lit(9)))),
                                   ("gid", Column("gid")), ("mask", Column("mask"))]), ["k"])
