"""The CPU route's whole-plan loop (pixie_tpu_torch/native/codegen.py over
native/wholeplan.cc) against the reference's (pixie_tpu/native/codegen.py).

The cases of tests/test_wholeplan.py whose shape the port runs: the same
rows (numpy, seeded) go into both packages' stores, the same plan (carried
across with to_dict / from_dict) runs through both executors on the CPU
route, and

  * the aggregate's STATE equals the reference's bit for bit (both run the
    same loop at the same PX_WHOLEPLAN_THREADS), the finalized frames too;
  * `lower()` returns None exactly where the reference's does, and the
    wholeplan_native / np_fast_polls counts agree.

Both crossovers are set to the reference's 4,194,304 rows here, so the
tables (at most 120,000 rows) take the CPU route whatever the port's
default is.
"""
import numpy as np
import pandas as pd
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu import flags as ref_flags
from pixie_tpu.engine import executor as ref_executor
from pixie_tpu.engine import np_partial as ref_np_partial
from pixie_tpu.engine.plancache import native_programs as ref_programs
from pixie_tpu.native import codegen as ref_codegen
from pixie_tpu.plan import (
    AggExpr, AggOp, Call, Column, FilterOp, LimitOp, MapOp, MemorySinkOp,
    MemorySourceOp, Plan, lit,
)
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as DT, Relation

import pixie_tpu_torch.interop as interop
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.engine import np_partial
from pixie_tpu_torch.engine.executor import PlanExecutor
from pixie_tpu_torch.engine.plancache import native_programs
from pixie_tpu_torch.native import codegen
from tests.test_torch_native import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")

SEC = 1_000_000_000
CROSSOVER = 1 << 22

REL = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                  ("latency", DT.FLOAT64), ("status", DT.INT64),
                  ("ok", DT.BOOLEAN))


@pytest.fixture(autouse=True)
def _cpu_route():
    """Both crossovers at the reference's default, autotune off, the
    program caches empty."""
    saved = {(f, n): f.get(n) for f in (ref_flags, port_flags)
             for n in ("PX_CPU_CROSSOVER_ROWS", "PX_AUTOTUNE")}
    for f in (ref_flags, port_flags):
        f.set_for_testing("PX_CPU_CROSSOVER_ROWS", CROSSOVER)
        f.set_for_testing("PX_AUTOTUNE", False)
    native_programs.clear()
    ref_programs.clear()
    yield
    for (f, n), v in saved.items():
        f.set_for_testing(n, v)
    native_programs.clear()
    ref_programs.clear()


def columns(n=120_000, seed=3):
    """tests/test_wholeplan.py's events table."""
    rng = np.random.default_rng(seed)
    return {
        "time_": np.sort(rng.integers(0, 600 * SEC, n)).astype(np.int64),
        "service": rng.choice([f"svc-{i}" for i in range(12)], n),
        "latency": rng.exponential(50.0, n),
        "status": rng.choice([200, 404, 500], n).astype(np.int64),
        "ok": rng.random(n) < 0.8,
    }


def stores(cols, rel=REL, table="events", batch_rows=1 << 14):
    """The same columns in a reference store and a port store."""
    ref = RefStore()
    ref.create(table, rel, batch_rows=batch_rows).write({k: v.copy() for k, v in cols.items()})
    port = interop.store_from_columns(
        {table: (rel.to_dict(), {k: v.copy() for k, v in cols.items()})}, batch_rows=batch_rows)
    return ref, port


def plan_of(groups, values, chain_ops=(), src_kw=None, table="events"):
    p = Plan()
    node = p.add(MemorySourceOp(table=table, **(src_kw or {})))
    for op in chain_ops:
        node = p.add(op, parents=[node])
    agg = p.add(AggOp(groups=groups, values=values), parents=[node])
    p.add(MemorySinkOp(name="out"), parents=[agg])
    return p


def _agg_of(plan):
    return next(op for op in plan.ops() if op.kind == "agg")


def same_tree(a, b, path="state") -> None:
    """Two state trees equal bit for bit (dtypes, shapes and bytes)."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            same_tree(a[k], b[k], f"{path}.{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), path


def run_states(st, plan, port_kw=None):
    """Both packages' aggregate state for `plan`'s aggregate on one device
    (mesh=None), with each executor's stats → (ref state, port state, ref
    stats, port stats, ref keys, port keys)."""
    ref_ts, port_ts = st
    rex = ref_executor.PlanExecutor(plan, ref_ts, mesh=None)
    rkeys, _u, rstate, *_ = rex._agg_state(_agg_of(plan))
    pplan = interop.plan_from_dict(plan.to_dict())
    pex = PlanExecutor(pplan, port_ts, device="cpu", mesh=None, **(port_kw or {}))
    pkeys, _u, pstate, *_ = pex._agg_state(_agg_of(pplan))
    return rstate, pstate, rex.stats, pex.stats, rkeys, pkeys


def _frames(res_ref, res_port):
    def frame(qr):
        df = qr.to_pandas()
        return df.sort_values(list(df.columns)).reset_index(drop=True)

    return frame(res_ref), frame(res_port)


def assert_same_run(st, plan, expect: str):
    """The whole query in both packages: equal states bit for bit, equal
    fast-path counts (`expect` names the one that ran: "wholeplan_native",
    "np_fast_polls" or "" for neither), and equal frames (the float columns
    bit for bit too; a quantile to one ulp, the two finalizes' pow)."""
    rstate, pstate, rst, pst, rkeys, pkeys = run_states(st, plan)
    for k in ("wholeplan_native", "np_fast_polls"):
        assert rst.get(k, 0) == pst.get(k, 0) == (1 if k == expect else 0), (k, rst, pst)
    assert [(k.name, k.kind, k.card, k.t0_bin) for k in pkeys] == \
        [(k.name, k.kind, k.card, k.t0_bin) for k in rkeys]
    if expect:
        same_tree(pstate, rstate)
    ref_ts, port_ts = st
    want = ref_executor.PlanExecutor(plan, ref_ts, mesh=None).run()["out"]
    got = PlanExecutor(interop.plan_from_dict(plan.to_dict()), port_ts, device="cpu",
                       mesh=None).run()["out"]
    a, b = _frames(want, got)
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        x, y = a[c].to_numpy(), b[c].to_numpy()
        if x.dtype.kind == "f" and expect:
            np.testing.assert_array_max_ulp(y, x, maxulp=1)
        elif x.dtype.kind == "f":
            np.testing.assert_allclose(y, x, rtol=1e-12)
        elif x.dtype == object and len(x) and isinstance(x[0], np.ndarray):
            np.testing.assert_array_max_ulp(np.stack(y), np.stack(x), maxulp=1)
        else:
            np.testing.assert_array_equal(y, x)


def lowered(st, plan) -> tuple:
    """(reference lower() result, port lower() result) for `plan`'s
    aggregate, straight from each package's codegen."""
    ref_ts, port_ts = st
    rex = ref_executor.PlanExecutor(plan, ref_ts, mesh=None)
    rs = rex._agg_setup(_agg_of(plan))
    rprog = ref_codegen.lower(rs.kern, rs.chain, rs.op, rs.keys, rs.init_specs, rs.dtypes,
                              rs.dicts, rs.names, rs.time_col)
    pplan = interop.plan_from_dict(plan.to_dict())
    pex = PlanExecutor(pplan, port_ts, device="cpu", mesh=None)
    ps = pex._agg_setup(_agg_of(pplan))
    pprog = codegen.lower(ps.kern, ps.chain, ps.op, ps.keys, ps.init_specs, ps.dtypes,
                          ps.dicts, ps.names, ps.time_col)
    return rprog, pprog


def same_program(rprog, pprog) -> None:
    assert (rprog is None) == (pprog is None)
    if rprog is None:
        return
    for field in ("cols", "col_tags", "filters", "time_idx", "aggs", "requires_unbounded",
                  "hist_width", "inv_log_gamma", "min_value"):
        assert getattr(pprog, field) == getattr(rprog, field), field
    assert [k[:4] for k in pprog.keys] == [k[:4] for k in rprog.keys]


ALL_VALUES = [
    AggExpr("cnt", "count", None), AggExpr("avg", "mean", "latency"),
    AggExpr("s", "sum", "latency"), AggExpr("si", "sum", "status"),
    AggExpr("mn", "min", "latency"), AggExpr("mx", "max", "latency"),
    AggExpr("mni", "min", "status"), AggExpr("mxi", "max", "status"),
    AggExpr("p50", "p50", "latency"), AggExpr("p99", "p99", "latency"),
    AggExpr("v", "variance", "latency"), AggExpr("sd", "stddev", "latency"),
    AggExpr("qs", "quantiles", "latency"),
]
NOT_404 = FilterOp(expr=Call("not_equal", (Column("status"), lit(404))))


@pytest.fixture(scope="module")
def big():
    return stores(columns())


@pytest.fixture(scope="module")
def small():
    return stores(columns(n=60_000))


def test_all_udas_filtered_dict_and_int_keys(big):
    """Every supported aggregate over the config #1 shape: a filter, a
    dictionary key and an int key."""
    assert_same_run(big, plan_of(["service", "status"], ALL_VALUES, [NOT_404]),
                    "wholeplan_native")


@pytest.mark.parametrize("fn,rhs", [
    ("equal", 200), ("not_equal", 404), ("less", 450),
    ("less_equal", 404), ("greater", 200), ("greater_equal", 404),
])
def test_every_comparison_op(small, fn, rhs):
    plan = plan_of(["service"], [AggExpr("cnt", "count", None),
                                 AggExpr("avg", "mean", "latency")],
                   [FilterOp(expr=Call(fn, (Column("status"), lit(rhs))))])
    assert_same_run(small, plan, "wholeplan_native")


def test_float_predicate_and_literal_on_left(small):
    plan = plan_of(["service"], [AggExpr("cnt", "count", None)],
                   [FilterOp(expr=Call("less", (Column("latency"), lit(30.0)))),
                    FilterOp(expr=Call("greater", (lit(5.0), Column("latency"))))])
    assert_same_run(small, plan, "wholeplan_native")


def test_bare_boolean_column_predicate(small):
    plan = plan_of(["service"], [AggExpr("cnt", "count", None)],
                   [FilterOp(expr=Column("ok"))])
    assert_same_run(small, plan, "wholeplan_native")


def test_window_key_with_filter(big):
    """The windowed dashboard shape with a predicate: raw-time binning in
    the loop, in both packages."""
    w = 10 * SEC
    plan = plan_of(
        ["time_", "service"],
        [AggExpr("cnt", "count", None), AggExpr("p50", "p50", "latency"),
         AggExpr("avg", "mean", "latency")],
        [NOT_404, MapOp(exprs=[("time_", Call("bin", (Column("time_"), lit(w)))),
                               ("service", Column("service")),
                               ("latency", Column("latency"))])])
    assert_same_run(big, plan, "wholeplan_native")


def test_rename_map_passthrough(small):
    plan = plan_of(["svc"], [AggExpr("cnt", "count", None), AggExpr("avg", "mean", "lat")],
                   [MapOp(exprs=[("svc", Column("service")), ("lat", Column("latency")),
                                 ("code", Column("status"))]),
                    FilterOp(expr=Call("not_equal", (Column("code"), lit(404))))])
    assert_same_run(small, plan, "wholeplan_native")


def test_bounded_time_parity(big):
    plan = plan_of(["service"], [AggExpr("cnt", "count", None), AggExpr("p50", "p50", "latency")],
                   [NOT_404], src_kw={"start_time": 100 * SEC, "stop_time": 400 * SEC})
    assert_same_run(big, plan, "wholeplan_native")


def test_bounded_time_with_window_rewrite_falls_back(big):
    """Window rewrite + bounded time: both programs refuse the run (the
    card route runs it on the port, the kernel path on the reference)."""
    w = 10 * SEC
    plan = plan_of(["time_"], [AggExpr("cnt", "count", None)],
                   [NOT_404, MapOp(exprs=[("time_", Call("bin", (Column("time_"), lit(w)))),
                                          ("latency", Column("latency")),
                                          ("status", Column("status"))])],
                   src_kw={"start_time": 100 * SEC, "stop_time": 400 * SEC})
    rprog, pprog = lowered(big, plan)
    same_program(rprog, pprog)
    assert pprog is not None and not codegen.applicable(pprog, 100 * SEC, 400 * SEC)
    assert_same_run(big, plan, "")


def test_limit_falls_back(small):
    plan = plan_of(["service"], [AggExpr("cnt", "count", None)], [LimitOp(n=1000)])
    rprog, pprog = lowered(small, plan)
    assert rprog is None and pprog is None
    assert_same_run(small, plan, "")


def test_computed_map_falls_back(small):
    plan = plan_of(["service"], [AggExpr("s", "sum", "dbl")],
                   [MapOp(exprs=[("service", Column("service")),
                                 ("dbl", Call("multiply", (Column("latency"), lit(2.0))))])])
    rprog, pprog = lowered(small, plan)
    assert rprog is None and pprog is None
    assert_same_run(small, plan, "")


LOWER_CASES = {
    "config1": lambda: plan_of(["service", "status"], ALL_VALUES, [NOT_404]),
    "no_groups": lambda: plan_of([], [AggExpr("cnt", "count", None)], [NOT_404]),
    "passthrough": lambda: plan_of(["service"], [AggExpr("cnt", "count", None)]),
    "dict_predicate": lambda: plan_of(
        ["status"], [AggExpr("cnt", "count", None)],
        [FilterOp(expr=Call("equal", (Column("service"), lit("svc-3"))))]),
    "dict_valued_any": lambda: plan_of(["status"], [AggExpr("m", "any", "service")], [NOT_404]),
    "computed_predicate": lambda: plan_of(
        ["service"], [AggExpr("cnt", "count", None)],
        [FilterOp(expr=Call("less", (Call("multiply", (Column("latency"), lit(2.0))),
                                     lit(30.0))))]),
    "and_predicate": lambda: plan_of(
        ["service"], [AggExpr("cnt", "count", None)],
        [FilterOp(expr=Call("logicalAnd", (Call("less", (Column("latency"), lit(30.0))),
                                           Column("ok"))))]),
    "bool_sum": lambda: plan_of(["service"], [AggExpr("s", "sum", "ok")], [NOT_404]),
    "float_key": lambda: plan_of(["service"], [AggExpr("s", "sum", "latency")], [
        MapOp(exprs=[("service", Column("service")), ("latency", Column("latency")),
                     ("status", Column("status"))]), NOT_404]),
    "limit": lambda: plan_of(["service"], [AggExpr("cnt", "count", None)], [LimitOp(n=10)]),
}


@pytest.mark.parametrize("case", sorted(LOWER_CASES))
def test_lower_declines_where_the_reference_declines(small, case):
    rprog, pprog = lowered(small, LOWER_CASES[case]())
    same_program(rprog, pprog)


def test_program_cached_per_plan_signature(small):
    plan = interop.plan_from_dict(plan_of(["service"], [AggExpr("cnt", "count", None)],
                                          [NOT_404]).to_dict())
    ex1 = PlanExecutor(plan, small[1], device="cpu", mesh=None)
    r1 = ex1.run()["out"]
    assert ex1.stats.get("wholeplan_native") == 1
    before = len(native_programs)
    ex2 = PlanExecutor(plan, small[1], device="cpu", mesh=None)
    r2 = ex2.run()["out"]
    assert ex2.stats.get("wholeplan_native") == 1
    assert len(native_programs) == before  # no re-lowering
    np.testing.assert_array_equal(r1.columns["cnt"], r2.columns["cnt"])


def test_count_only_zero_column_program(small, monkeypatch):
    """group-by-none count lowers to a program with ZERO columns; np_partial
    (which owns this passthrough shape) is switched off in both packages to
    drive the loop."""
    monkeypatch.setattr(np_partial, "eligible", lambda *a, **k: False)
    monkeypatch.setattr(ref_np_partial, "eligible", lambda *a, **k: False)
    plan = plan_of([], [AggExpr("cnt", "count", None)])
    rprog, pprog = lowered(small, plan)
    same_program(rprog, pprog)
    assert [a[0] for a in pprog.aggs] == [0, 0]  # count and the seen counter: no value column
    assert_same_run(small, plan, "wholeplan_native")
    got = PlanExecutor(interop.plan_from_dict(plan.to_dict()), small[1], device="cpu",
                       mesh=None).run()["out"]
    assert got.columns["cnt"].tolist() == [60_000]


def test_flag_flip_respected_after_caching(small):
    """PX_WHOLEPLAN_NATIVE is read outside the program cache: off, a cached
    program is not run (the card route is); back on, the cache serves."""
    plan = interop.plan_from_dict(plan_of(["service"], [AggExpr("cnt", "count", None)],
                                          [NOT_404]).to_dict())

    def run():
        ex = PlanExecutor(plan, small[1], device="cpu", mesh=None)
        out = ex.run()["out"]
        return ex.stats, out

    st, want = run()
    assert st.get("wholeplan_native") == 1
    port_flags.set_for_testing("PX_WHOLEPLAN_NATIVE", False)
    try:
        st, got = run()
        assert "wholeplan_native" not in st
        assert st["routes"][0]["route"] == "device"
        np.testing.assert_array_equal(got.columns["cnt"], want.columns["cnt"])
    finally:
        port_flags.set_for_testing("PX_WHOLEPLAN_NATIVE", True)
    st, _ = run()
    assert st.get("wholeplan_native") == 1


@pytest.mark.parametrize("threads", [1, 3])
def test_serial_and_parallel_loops(big, threads):
    """PX_WHOLEPLAN_THREADS=1 (serial, strict row order) and a threaded range
    fan-out: at equal thread counts the port's state is the reference's bit
    for bit."""
    saved = (ref_flags.get("PX_WHOLEPLAN_THREADS"), port_flags.get("PX_WHOLEPLAN_THREADS"))
    ref_flags.set_for_testing("PX_WHOLEPLAN_THREADS", threads)
    port_flags.set_for_testing("PX_WHOLEPLAN_THREADS", threads)
    try:
        assert_same_run(big, plan_of(["service", "status"], ALL_VALUES, [NOT_404]),
                        "wholeplan_native")
    finally:
        ref_flags.set_for_testing("PX_WHOLEPLAN_THREADS", saved[0])
        port_flags.set_for_testing("PX_WHOLEPLAN_THREADS", saved[1])


def test_serial_and_parallel_loops_agree(big):
    """Within the port: the serial loop and the threaded fan-out agree
    (integers exact, floats within merge rounding), as in the reference."""
    plan = interop.plan_from_dict(
        plan_of(["service", "status"], ALL_VALUES, [NOT_404]).to_dict())
    a = PlanExecutor(plan, big[1], device="cpu", mesh=None).run()["out"]
    port_flags.set_for_testing("PX_WHOLEPLAN_THREADS", 1)
    try:
        b = PlanExecutor(plan, big[1], device="cpu", mesh=None).run()["out"]
    finally:
        port_flags.set_for_testing("PX_WHOLEPLAN_THREADS", 0)
    ga = a.to_pandas().sort_values(["service", "status"]).reset_index(drop=True)
    gb = b.to_pandas().sort_values(["service", "status"]).reset_index(drop=True)
    pd.testing.assert_frame_equal(ga.drop(columns=["qs"]), gb.drop(columns=["qs"]),
                                  check_dtype=False)
