"""Select sinks: plans whose sink is fed by a chain of map, filter and limit
run through pixie_tpu.engine and through pixie_tpu_torch.engine
(device="cpu") over the same rows, and the output step (K4's plain version,
ops/compact.py) against the reference's `ChainKernel.make_output_step`.

Plans are built by the reference and carried across with Plan.to_dict /
plan_from_dict; the tables are written from the same numpy columns into both
packages' stores.  A select only moves rows, so results must be exactly
equal, rows in the same order.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu import flags as ref_flags
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.engine.executor import ChainKernel as RefChainKernel
from pixie_tpu.plan import (
    AggExpr, AggOp, Call, Column, FilterOp, LimitOp, MapOp, MemorySinkOp,
    MemorySourceOp, Plan, lit,
)
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.udf import registry as ref_registry

import pixie_tpu_torch.interop as interop
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.engine.executor import ChainKernel
from pixie_tpu_torch.ops import compact as k4
from pixie_tpu_torch.types import DataType as PDT
from pixie_tpu_torch.udf import registry as port_registry

from test_torch_executor import N, REL, SEC, http_columns


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


def _select(ops, columns=None, **src):
    p = Plan()
    node = p.add(MemorySourceOp(table="http_events", **src))
    for op in ops:
        node = p.add(op, parents=[node])
    p.add(MemorySinkOp(name="output", columns=columns), parents=[node])
    return p


def _eq(col, v):
    return Call("equal", (Column(col), lit(v)))


def _after_agg():
    """A filter over an aggregate's (host) output: K4 over a host batch."""
    p = Plan()
    src = p.add(MemorySourceOp(table="http_events"))
    agg = p.add(AggOp(groups=["service", "status"], values=[
        AggExpr("cnt", "count", None), AggExpr("hi", "max", "latency")]), parents=[src])
    f = p.add(FilterOp(expr=Call("greater", (Column("cnt"), lit(300)))), parents=[agg])
    p.add(MemorySinkOp(name="output"), parents=[f])
    return p


PLANS = {
    "filter": lambda: _select([FilterOp(expr=_eq("status", 500))]),
    "filter_project": lambda: _select(
        [FilterOp(expr=_eq("status", 500))],
        columns=["time_", "service", "latency", "status"]),
    "map_then_filter": lambda: _select([
        MapOp(exprs=[("lat2", Call("multiply", (Column("latency"), lit(2.0)))),
                     ("service", Column("service")), ("bytes", Column("bytes")),
                     ("slow", Call("greater", (Column("latency"), lit(100.0))))]),
        FilterOp(expr=Call("greater", (Column("lat2"), lit(150.0))))]),
    "limit_filter_limit": lambda: _select([
        LimitOp(n=5000), FilterOp(expr=Call("not_equal", (Column("status"), lit(404)))),
        LimitOp(n=1000)]),
    "head": lambda: _select([LimitOp(n=777)]),
    "filter_then_head": lambda: _select([FilterOp(expr=_eq("status", 500)),
                                         LimitOp(n=100)]),
    "time_bounds": lambda: _select(
        [FilterOp(expr=_eq("method", "POST"))], columns=["service", "latency"],
        start_time=100 * SEC, stop_time=250 * SEC),
    "string_columns": lambda: _select(
        [FilterOp(expr=_eq("service", "svc-3"))], columns=["method", "service"]),
    "empty_result": lambda: _select(
        [FilterOp(expr=Call("less", (Column("latency"), lit(0.0))))]),
    "bare_scan": lambda: _select([]),
    "after_agg": _after_agg,
}


def _frames_equal(got, want):
    assert got.relation.names() == want.relation.names()
    assert [c.data_type for c in got.relation] == [c.data_type for c in want.relation]
    pd.testing.assert_frame_equal(got.to_pandas(), want.to_pandas(), check_exact=True)


def _run_both(stores, plan):
    ref_store, port_store = stores
    want = ref_execute(plan, ref_store)["output"]
    got = execute_plan(interop.plan_from_dict(plan.to_dict()), port_store,
                       device="cpu")["output"]
    return got, want


@pytest.mark.parametrize("name", sorted(PLANS))
def test_select_matches_reference(stores, name):
    got, want = _run_both(stores, PLANS[name]())
    if name == "empty_result":
        assert want.num_rows == 0
    else:
        assert want.num_rows > 0
    _frames_equal(got, want)


@pytest.fixture
def small_feeds():
    """4096-row feeds in both packages: 16 feeds per scan, so the readback
    pipeline runs one and two feeds behind."""
    ref_flags.set_for_testing("PX_FEED_ROWS", 1 << 12)
    port_flags.set_for_testing("PX_FEED_ROWS", 1 << 12)
    yield
    ref_flags.set_for_testing("PX_FEED_ROWS", 1 << 24)
    port_flags.set_for_testing("PX_FEED_ROWS", 1 << 24)


@pytest.mark.parametrize("name", ["filter", "limit_filter_limit", "map_then_filter",
                                  "filter_then_head"])
def test_select_over_many_feeds_matches_reference(stores, small_feeds, name):
    got, want = _run_both(stores, PLANS[name]())
    assert want.num_rows > 0
    _frames_equal(got, want)
    assert got.exec_stats["feeds"] == N >> 12


def test_select_exec_stats(stores, small_feeds):
    _ref, port_store = stores
    plan = PLANS["limit_filter_limit"]()
    res = execute_plan(interop.plan_from_dict(plan.to_dict()), port_store,
                       device="cpu")["output"]
    st = res.exec_stats
    # 16 feeds: every feed after the first starts the previous one's readback
    assert st["pipelined_waves"] == (N >> 12) - 1
    (rec,) = [r for r in st["operators"] if r["label"].endswith("select")]
    assert rec["label"] == "scan(http_events)->limit->filter->limit->select"
    assert rec["rows_out"] == res.num_rows == 1000
    # the first limit admitted 5000 rows, the second its whole budget
    assert rec["limit_remaining"] == [0, 0]


# ------------------------------------------------------------- output step


def _feed(rng, n):
    return {
        "time_": np.arange(n, dtype=np.int64) * 7,
        "latency": rng.exponential(50.0, n),
        "status": rng.choice([200, 404, 500], n),
        "flag": rng.random(n) < 0.5,
    }


@pytest.mark.parametrize("density", [0.9, 0.1, 1.0, 0.0])
def test_output_step_matches_reference(density):
    """One feed through the reference's jitted output step and the port's
    (K4's plain version): the first `count` rows of every column equal."""
    import jax.numpy as jnp

    from pixie_tpu.types import DataType as DT

    rng = np.random.default_rng(3)
    n = 1 << 14
    cols = _feed(rng, n)
    cut = float(np.quantile(cols["latency"], 1.0 - density)) if 0 < density < 1 else (
        -1.0 if density == 1.0 else np.inf)
    dtypes = {"time_": DT.TIME64NS, "latency": DT.FLOAT64, "status": DT.INT64,
              "flag": DT.BOOLEAN}
    chain = [FilterOp(expr=Call("greater_equal", (Column("latency"), lit(cut))))]
    names = ["time_", "latency", "status", "flag"]
    ref = RefChainKernel(dtypes, {}, chain, ref_registry, "time_", names)
    rstep, _, _ = ref.make_output_step(names)
    routs, rcnt, _ = rstep({k: jnp.asarray(v) for k, v in cols.items()}, np.int64(n - 5),
                           np.int64(0), np.int64(7 * (n - 100)), ref.init_limits(),
                           ref.luts)
    # the same chain carried across as plain data, with the port's types
    pchain = [op for op in interop.plan_from_dict(_select(chain).to_dict()).ops()
              if op.kind == "filter"]
    pk = ChainKernel({k: PDT(int(v)) for k, v in dtypes.items()}, {}, pchain,
                     port_registry, "time_", torch.device("cpu"), names)
    pstep, _, _ = pk.make_output_step(names)
    pouts, pcnt, _ = pstep({k: torch.from_numpy(v) for k, v in cols.items()}, n - 5,
                           0, 7 * (n - 100), pk.init_limits(), {})
    c = int(rcnt)
    assert int(pcnt) == c
    if density == 0.0:
        assert c == 0
    for k in names:
        np.testing.assert_array_equal(pouts[k][:c].numpy(), np.asarray(routs[k])[:c],
                                      err_msg=k)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float64, torch.bool,
                                   torch.int16])
def test_compact_plain_is_a_stable_partition(dtype):
    rng = np.random.default_rng(4)
    n = 10_000
    m = rng.random(n) < 0.37
    v = rng.integers(-1000, 1000, n)
    col = torch.from_numpy(v).to(dtype)
    outs, count = k4.compact(torch.from_numpy(m), [col, col.flip(0).contiguous()])
    c = int(count)
    assert c == m.sum()
    np.testing.assert_array_equal(outs[0][:c].numpy(), col.numpy()[m])
    np.testing.assert_array_equal(outs[1][:c].numpy(), col.flip(0).numpy()[m])
    # the rows not kept follow, also in input order (the reference's argsort)
    np.testing.assert_array_equal(outs[0][c:].numpy(), col.numpy()[~m])


def test_compact_with_no_columns_counts():
    outs, count = k4.compact(torch.tensor([True, False, True]), [])
    assert outs == [] and int(count) == 2
