"""The slice as a whole: aggregate plans run through pixie_tpu.engine and
through pixie_tpu_torch.engine (device="cpu") over the same rows.

Plans are built (or compiled) by the reference and carried across with
Plan.to_dict / from_dict; the tables are written from the same numpy columns
into both packages' stores.  Results are compared sorted by group key:
counts, int sums, min and max exactly; means to rtol 1e-12 (different
summation order); quantiles in the same sketch bin or one bin apart (ratio
gamma), the adjacent-bin rule of test_torch_sketch: a value on a bin edge may
land in the neighbouring bin when XLA's and PyTorch's float32 log differ in
the last ulp.  "Same bin" allows 1 ulp, as the reference's device finalize
computes gamma^(idx-1.5) with XLA's pow, which differs from libm's in the
last ulp for some exponents (see test_torch_sketch).
"""
import numpy as np
import pytest

import bench
import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu.compiler import compile_pxl
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.plan import (
    AggExpr, AggOp, Call, Column, FilterOp, LimitOp, MapOp, MemorySinkOp,
    MemorySourceOp, Plan, lit,
)
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as DT, Relation

import pixie_tpu_torch.interop as interop
from pixie_tpu_torch.engine import execute_plan, resident
from pixie_tpu_torch.engine.executor import clear_device_cache

N = 1 << 16
SEC = 1_000_000_000
GAMMA = 1.0404


def http_columns(n=N, seed=12):
    """bench.build_http_table's generator (16 services, exponential(50)
    latency, status 200/404/500 at .85/.05/.10) plus a method string and an
    int64 byte count near 2^62, so sums wrap."""
    rng = np.random.default_rng(seed)
    services = np.array([f"svc-{i}" for i in range(16)])
    methods = np.array(["GET", "POST", "PUT"])
    return {
        "time_": np.arange(n, dtype=np.int64) * (600 * SEC // n),
        "service": services[rng.integers(0, 16, n)],
        "latency": rng.exponential(50.0, n),
        "status": rng.choice([200, 404, 500], n, p=[0.85, 0.05, 0.10]),
        "method": methods[rng.integers(0, 3, n)],
        "bytes": rng.integers(2 ** 61, 2 ** 62, n, dtype=np.int64),
    }


REL = Relation.of(
    ("time_", DT.TIME64NS), ("service", DT.STRING), ("latency", DT.FLOAT64),
    ("status", DT.INT64), ("method", DT.STRING), ("bytes", DT.INT64),
)


@pytest.fixture(scope="module")
def stores():
    cols = http_columns()
    ref = RefStore()
    ref.create("http_events", REL, batch_rows=1 << 12).write(
        {k: v.copy() for k, v in cols.items()})
    port = interop.store_from_columns(
        {"http_events": (REL.to_dict(), {k: v.copy() for k, v in cols.items()})},
        batch_rows=1 << 12)
    return ref, port


def _agg_plan(groups, values, filt=None, pre=None):
    p = Plan()
    node = p.add(MemorySourceOp(table="http_events"))
    for op in (pre or []):
        node = p.add(op, parents=[node])
    if filt is not None:
        node = p.add(FilterOp(expr=filt), parents=[node])
    agg = p.add(AggOp(groups=groups, values=values), parents=[node])
    p.add(MemorySinkOp(name="output"), parents=[agg])
    return p


def _windowed_plan():
    p = Plan()
    src = p.add(MemorySourceOp(table="http_events"))
    m = p.add(MapOp(exprs=[
        ("time_", Call("bin", (Column("time_"), lit(10 * SEC)))),
        ("service", Column("service")),
        ("latency", Column("latency")),
    ]), parents=[src])
    agg = p.add(AggOp(groups=["time_", "service"], windowed=True, values=[
        AggExpr("cnt", "count", None), AggExpr("p50", "p50", "latency"),
        AggExpr("p99", "p99", "latency")]), parents=[m])
    p.add(MemorySinkOp(name="output"), parents=[agg])
    return p


def _agg_of_agg_plan():
    """A second aggregate over the first one's (host) output."""
    p = Plan()
    src = p.add(MemorySourceOp(table="http_events"))
    a1 = p.add(AggOp(groups=["service", "status"], values=[
        AggExpr("cnt", "count", None), AggExpr("hi", "max", "latency")]), parents=[src])
    a2 = p.add(AggOp(groups=["status"], values=[
        AggExpr("total", "sum", "cnt"), AggExpr("lo", "min", "hi"),
        AggExpr("p50", "p50", "hi")]), parents=[a1])
    p.add(MemorySinkOp(name="output"), parents=[a2])
    return p


PLANS = {
    "http_plan": bench.http_plan,
    "string_filter": lambda: _agg_plan(
        ["status"],
        [AggExpr("cnt", "count", None), AggExpr("avg", "mean", "latency"),
         AggExpr("p90", "p90", "latency")],
        filt=Call("equal", (Column("service"), lit("svc-3")))),
    "int64_sum_min_max": lambda: _agg_plan(
        ["service"],
        [AggExpr("total", "sum", "bytes"), AggExpr("lo", "min", "bytes"),
         AggExpr("hi", "max", "bytes"), AggExpr("lat_hi", "max", "latency"),
         AggExpr("any_method", "any", "method")]),
    "no_group_keys": lambda: _agg_plan(
        [],
        [AggExpr("cnt", "count", None), AggExpr("total", "sum", "bytes"),
         AggExpr("p50", "p50", "latency"), AggExpr("sd", "stddev", "latency")],
        filt=Call("greater", (Column("latency"), lit(10.0)))),
    "three_keys": lambda: _agg_plan(
        ["service", "status", "method"],
        [AggExpr("cnt", "count", None), AggExpr("avg", "mean", "latency"),
         AggExpr("lo", "min", "latency"), AggExpr("p99", "p99", "latency")]),
    "windowed": _windowed_plan,
    "agg_of_agg": lambda: _agg_of_agg_plan(),
    "limit_then_agg": lambda: _agg_plan(
        ["status"], [AggExpr("cnt", "count", None), AggExpr("avg", "mean", "latency")],
        pre=[LimitOp(n=5000)]),
}


def _sorted_frame(res):
    df = res.to_pandas()
    keys = [c for c in df.columns if df[c].dtype == object or c in
            ("status", "time_")]
    keys = [k for k in keys if k in ("service", "status", "method", "time_")]
    return df.sort_values(keys).reset_index(drop=True) if keys else df


def _assert_results_match(got, want):
    assert got.num_rows == want.num_rows
    assert got.relation.names() == want.relation.names()
    assert [c.data_type for c in got.relation] == [c.data_type for c in want.relation]
    g, w = _sorted_frame(got), _sorted_frame(want)
    for col in w.columns:
        gv, wv = g[col].to_numpy(), w[col].to_numpy()
        if col.startswith("p") and col[1:].isdigit():
            same = (np.abs(gv - wv) <= np.spacing(np.abs(wv))) | \
                (np.isnan(gv) & np.isnan(wv))
            adjacent = np.isclose(gv / np.where(wv == 0, 1, wv), GAMMA, rtol=1e-12) | \
                np.isclose(wv / np.where(gv == 0, 1, gv), GAMMA, rtol=1e-12)
            assert (same | adjacent).all(), col
        elif col in ("avg", "avg_lat", "sd"):
            np.testing.assert_allclose(gv.astype(float), wv.astype(float),
                                       rtol=1e-12, equal_nan=True)
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=col)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_matches_reference(stores, name):
    ref_store, port_store = stores
    plan = PLANS[name]()
    want = ref_execute(plan, ref_store)["output"]
    got = execute_plan(interop.plan_from_dict(plan.to_dict()), port_store,
                       device="cpu")["output"]
    assert want.num_rows > 0
    _assert_results_match(got, want)


def test_compiled_pxl_plan_matches_reference(stores):
    """A plan the reference compiled from PxL text runs on the port."""
    ref_store, port_store = stores
    src = """
import px
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean),
    p50=('latency', px.p50))
px.display(df, 'output')
"""
    q = compile_pxl(src, ref_store.schemas(), now=700 * SEC)
    want = ref_execute(q.plan, ref_store)["output"]
    got = execute_plan(interop.plan_from_dict(q.plan.to_dict()), port_store,
                       device="cpu")["output"]
    _assert_results_match(got, want)


def test_http_plan_exec_stats(stores):
    _ref_store, port_store = stores
    # a cold query: earlier tests may have left this feed on the device
    resident.clear_for_testing()
    clear_device_cache()
    plan = interop.plan_from_dict(bench.http_plan().to_dict())
    res = execute_plan(plan, port_store, device="cpu")["output"]
    st = res.exec_stats
    assert st["rows_scanned"] == N and st["feeds"] == 1
    # service codes, latency and status only: time_ is pruned away
    assert st["h2d_bytes"] == N * (4 + 8 + 8)
    # warm: the feed is resident and nothing crosses the link
    st = execute_plan(plan, port_store, device="cpu")["output"].exec_stats
    assert st["resident_feeds"] == 1 and st["h2d_bytes"] == 0
