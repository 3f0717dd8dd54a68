"""The CPU route's np_partial loop (pixie_tpu_torch/engine/np_partial.py)
against the reference's (pixie_tpu/engine/np_partial.py).

The same rows go into both packages' stores and the same plan through both
executors on the CPU route (both crossovers at the reference's 4,194,304
rows): `eligible()` gives the reference's answer on every shape, and where
the loop runs its state equals the reference's bit for bit — the
bincount-shaped numpy, the exact int64 limb sums that wrap mod 2^64, the
sort-based min/max, the native sketch scatter (a NaN value in bin 0 on both
CPU routes) and the fused window loop (native px_window_agg).
"""
import numpy as np
import pytest

from pixie_tpu.engine import executor as ref_executor
from pixie_tpu.engine import np_partial as ref_np_partial
from pixie_tpu.engine.executor import _time_bounds
from pixie_tpu.plan import AggExpr, AggOp, Call, Column, FilterOp, LimitOp, MapOp, lit
from pixie_tpu.types import DataType as DT, Relation

import pixie_tpu_torch.interop as interop
from pixie_tpu_torch.engine import np_partial
from pixie_tpu_torch.engine.executor import PlanExecutor
from tests.test_torch_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

from test_torch_wholeplan import (  # noqa: F401  (_cpu_route is autouse)
    ALL_VALUES, NOT_404, SEC, _agg_of, _cpu_route, assert_same_run, columns, plan_of,
    run_states, same_tree, stores,
)

W = 10 * SEC


def _windowed(values, src_kw=None, chain_pre=()):
    return plan_of(
        ["time_", "service"], values,
        [*chain_pre, MapOp(exprs=[("time_", Call("bin", (Column("time_"), lit(W)))),
                                  ("service", Column("service")),
                                  ("latency", Column("latency")),
                                  ("status", Column("status"))])],
        src_kw=src_kw)


def _windowed_agg(plan):
    """plan_of's windowed plans mark their aggregate windowed, as the
    compiler does for a rolling window."""
    for op in plan.ops():
        if isinstance(op, AggOp):
            op.windowed = True
    return plan


PASSTHROUGH = [v for v in ALL_VALUES if v.out_name != "qs"] + [
    AggExpr("qs", "quantiles", "latency")]

CASES = {
    "dict_key_all_udas": lambda: plan_of(["service"], PASSTHROUGH),
    "int_key": lambda: plan_of(["status"], [AggExpr("cnt", "count", None),
                                            AggExpr("avg", "mean", "latency"),
                                            AggExpr("p99", "p99", "latency")]),
    "two_keys": lambda: plan_of(["service", "status"], PASSTHROUGH),
    "no_groups": lambda: plan_of([], [AggExpr("cnt", "count", None),
                                      AggExpr("s", "sum", "status")]),
    "bool_sum_and_any": lambda: plan_of(["service"], [AggExpr("s", "sum", "ok"),
                                                      AggExpr("a", "any", "latency")]),
    "rename": lambda: plan_of(["svc"], [AggExpr("cnt", "count", None),
                                        AggExpr("m", "mean", "lat")],
                              [MapOp(exprs=[("svc", Column("service")),
                                            ("lat", Column("latency"))])]),
    "window_fused": lambda: _windowed_agg(_windowed(
        [AggExpr("cnt", "count", None), AggExpr("avg", "mean", "latency"),
         AggExpr("p50", "p50", "latency"), AggExpr("p99", "p99", "latency")])),
    "window_min_max": lambda: _windowed_agg(_windowed(
        [AggExpr("mn", "min", "latency"), AggExpr("mx", "max", "status"),
         AggExpr("v", "variance", "latency")])),
    "bounded_passthrough": lambda: plan_of(
        ["service"], [AggExpr("cnt", "count", None), AggExpr("p50", "p50", "latency")],
        src_kw={"start_time": 100 * SEC, "stop_time": 400 * SEC}),
}

#: shapes np_partial declines in both packages
DECLINED = {
    "filter": lambda: plan_of(["service"], [AggExpr("cnt", "count", None)], [NOT_404]),
    "limit": lambda: plan_of(["service"], [AggExpr("cnt", "count", None)], [LimitOp(n=5)]),
    "computed_value": lambda: plan_of(
        ["service"], [AggExpr("s", "sum", "dbl")],
        [MapOp(exprs=[("service", Column("service")),
                      ("dbl", Call("multiply", (Column("latency"), lit(2.0))))])]),
    "dict_valued": lambda: plan_of(["status"], [AggExpr("a", "any", "service")]),
    "window_bounded": lambda: _windowed_agg(_windowed(
        [AggExpr("cnt", "count", None)],
        src_kw={"start_time": 100 * SEC, "stop_time": 400 * SEC})),
}


@pytest.fixture(scope="module")
def st():
    return stores(columns(n=90_000, seed=5))


def _eligible(st_, plan) -> tuple[bool, bool]:
    """(reference eligible() and value_args_ok(), the port's) for `plan`."""
    ref_ts, port_ts = st_
    rs = ref_executor.PlanExecutor(plan, ref_ts, mesh=None)._agg_setup(_agg_of(plan))
    t_lo, t_hi = _time_bounds(_agg_head(plan))
    ref = (ref_np_partial.eligible(rs.kern, rs.keys, rs.udas, rs.val_dicts, t_lo, t_hi, rs.src)
           and ref_np_partial.value_args_ok(rs.kern, rs.op, rs.names))
    pplan = interop.plan_from_dict(plan.to_dict())
    ps = PlanExecutor(pplan, port_ts, device="cpu", mesh=None)._agg_setup(_agg_of(pplan))
    port = (np_partial.eligible(ps.kern, ps.keys, ps.udas, ps.val_dicts, t_lo, t_hi, ps.src)
            and np_partial.value_args_ok(ps.kern, ps.op, ps.names))
    return ref, port


def _agg_head(plan):
    node = _agg_of(plan)
    while plan.parents(node):
        node = plan.parents(node)[0]
    return node


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_equals_the_reference_bit_for_bit(st, case):
    plan = CASES[case]()
    assert _eligible(st, plan) == (True, True)
    assert_same_run(st, plan, "np_fast_polls")


@pytest.mark.parametrize("case", sorted(DECLINED))
def test_eligible_declines_where_the_reference_declines(st, case):
    assert _eligible(st, DECLINED[case]()) == (False, False)


def test_fused_window_loop_runs_in_both():
    """One window key, unbounded time, count/mean/quantiles over one f64
    column: both packages take the fused native window loop."""
    st_ = stores(columns(n=40_000, seed=8))
    plan = _windowed_agg(plan_of(
        ["time_"], [AggExpr("cnt", "count", None), AggExpr("avg", "mean", "latency"),
                    AggExpr("p50", "p50", "latency")],
        [MapOp(exprs=[("time_", Call("bin", (Column("time_"), lit(W)))),
                      ("latency", Column("latency"))])]))
    t_lo, t_hi = _time_bounds(_agg_head(plan))
    rs = ref_executor.PlanExecutor(plan, st_[0], mesh=None)._agg_setup(_agg_of(plan))
    pplan = interop.plan_from_dict(plan.to_dict())
    ps = PlanExecutor(pplan, st_[1], device="cpu", mesh=None)._agg_setup(_agg_of(pplan))
    assert np_partial._window_fused_ok(ps.kern, ps.keys, ps.init_specs,
                                       np_partial.value_args(ps.kern, ps.op), t_lo, t_hi)
    assert ref_np_partial._window_fused_ok(rs.kern, rs.keys, rs.init_specs,
                                           ref_np_partial.value_args(rs.kern, rs.op), t_lo, t_hi)
    assert_same_run(st_, plan, "np_fast_polls")


def test_int64_sums_wrap_as_the_reference():
    """int64 sums near 2^62 wrap mod 2^64 on the exact limb path, bit for
    bit as the reference's."""
    rel = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING), ("bytes", DT.INT64))
    rng = np.random.default_rng(4)
    n = 50_000
    cols = {"time_": np.arange(n, dtype=np.int64),
            "service": rng.choice(["a", "b", "c"], n),
            "bytes": rng.integers(2 ** 61, 2 ** 62, n, dtype=np.int64)}
    st_ = stores(cols, rel=rel, table="t")
    plan = plan_of(["service"], [AggExpr("s", "sum", "bytes"), AggExpr("m", "max", "bytes")],
                   table="t")
    rstate, pstate, _rs, pst, _rk, _pk = run_states(st_, plan)
    assert pst["np_fast_polls"] == 1
    same_tree(pstate, rstate)
    want = np.zeros(4, np.uint64)
    codes = np.unique(cols["service"], return_inverse=True)[1]
    np.add.at(want, codes, cols["bytes"].astype(np.uint64))
    assert sorted(pstate["s"][:3].view(np.uint64).tolist()) == sorted(want[:3].tolist())


def test_nan_sketch_values_bin_at_zero_as_the_reference_cpu_route():
    """A NaN latency lands in sketch bin 0 on both CPU routes (the card
    route of a batch query bins it at 1)."""
    cols = columns(n=30_000, seed=6)
    cols["latency"][::5] = np.nan
    st_ = stores(cols)
    plan = plan_of(["service"], [AggExpr("p10", "p10", "latency"),
                                 AggExpr("cnt", "count", None)])
    rstate, pstate, _rs, pst, _rk, _pk = run_states(st_, plan)
    assert pst["np_fast_polls"] == 1
    same_tree(pstate, rstate)
    hist = pstate["p10"]
    lat = cols["latency"]
    small = np.sum(lat[~np.isnan(lat)] <= 1.0 / 1.0404)  # the finite values of bin 0
    assert hist[:, 0].sum() == np.isnan(lat).sum() + small


def test_sealed_and_hot_batches_match_the_reference():
    """Two writes (sealed batches and a hot remainder): the feeds split
    where the reference's do, so even float sums agree bit for bit."""
    cols = columns(n=70_000, seed=9)
    st_ = stores({k: v[:50_000] for k, v in cols.items()})
    for ts in st_:
        ts.table("events").write({k: v[50_000:].copy() for k, v in cols.items()})
    assert_same_run(st_, plan_of(["service", "status"], PASSTHROUGH), "np_fast_polls")
