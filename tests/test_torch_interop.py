"""State carried across: a partial aggregate state computed by the reference
(PlanExecutor._agg_state) is carried into the port with
pixie_tpu_torch.interop and finalized there; the port's finalize must equal
the reference's own finalize of that state exactly (same state, same
arithmetic: the port's device quantile reads the host finalize's bin table).
"""
import numpy as np
import pytest
import torch

import bench
import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu.engine.executor import PlanExecutor as RefExecutor
from pixie_tpu.plan import AggExpr, AggOp, MemorySinkOp, MemorySourceOp, Plan
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as DT, Relation

import pixie_tpu_torch.interop as interop
from pixie_tpu_torch.engine.executor import PlanExecutor
from pixie_tpu_torch.plan import AggOp as PortAggOp
from pixie_tpu_torch.status import InvalidArgument
from pixie_tpu_torch.udf.udf import MeanUDA, QuantileUDA

N = 1 << 15
REL = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                  ("latency", DT.FLOAT64), ("status", DT.INT64),
                  ("bytes", DT.INT64))


def _columns():
    rng = np.random.default_rng(5)
    services = np.array([f"svc-{i}" for i in range(16)])
    return {
        "time_": np.arange(N, dtype=np.int64),
        "service": services[rng.integers(0, 16, N)],
        "latency": rng.exponential(50.0, N),
        "status": rng.choice([200, 404, 500], N, p=[0.85, 0.05, 0.10]),
        "bytes": rng.integers(-(2 ** 62), 2 ** 62, N, dtype=np.int64),
    }


def _plans():
    p = Plan()
    src = p.add(MemorySourceOp(table="http_events"))
    agg = p.add(AggOp(groups=["status"], values=[
        AggExpr("total", "sum", "bytes"), AggExpr("lo", "min", "latency"),
        AggExpr("q", "quantiles", "latency"), AggExpr("var", "variance", "latency"),
    ]), parents=[src])
    p.add(MemorySinkOp(name="output"), parents=[agg])
    return {"http_plan": bench.http_plan(), "mixed": p}


@pytest.fixture(scope="module")
def stores():
    cols = _columns()
    ref = RefStore()
    ref.create("http_events", REL).write({k: v.copy() for k, v in cols.items()})
    port = interop.store_from_columns(
        {"http_events": (REL.to_dict(), {k: v.copy() for k, v in cols.items()})})
    return ref, port


@pytest.mark.parametrize("name", ["http_plan", "mixed"])
def test_reference_state_finalizes_identically(stores, name):
    ref_store, port_store = stores
    plan = _plans()[name]
    op = next(o for o in plan.ops() if isinstance(o, AggOp))
    rex = RefExecutor(plan, ref_store, mesh=None)
    rex._partial_wire = True  # raw mergeable state, no device finalize
    keys, udas, state_np, seen, in_types, val_dicts = rex._agg_state(op)
    want = rex._finalize_agg(op, keys, udas, state_np, seen, in_types, val_dicts)

    pplan = interop.plan_from_dict(plan.to_dict())
    pop = next(o for o in pplan.ops() if isinstance(o, PortAggOp))
    pex = PlanExecutor(pplan, port_store, device="cpu")
    s = pex._agg_setup(pop)
    assert [k.card for k in s.keys] == [k.card for k in keys]
    states = interop.states_from_numpy({n: u for n, u, _vb in s.udas}, state_np, "cpu")
    for n, u, _vb in s.udas:  # the reference's leaf shapes and dtypes
        ref_leaf = state_np[n]
        got = interop.states_to_numpy({n: states[n]})[n]
        if isinstance(ref_leaf, dict):
            assert {k: (v.dtype, v.shape) for k, v in got.items()} == \
                {k: (np.asarray(v).dtype, np.shape(v)) for k, v in ref_leaf.items()}
        else:
            assert (got.dtype, got.shape) == (np.asarray(ref_leaf).dtype, np.shape(ref_leaf))
    got = pex._finalize_agg(pop, s.keys, s.udas, states, s.seen_name, s.in_types,
                            s.val_dicts)
    assert list(got.cols) == list(want.cols)
    for col in want.cols:
        np.testing.assert_array_equal(got.cols[col], want.cols[col], err_msg=col)


def test_state_layouts_match_reference_udas():
    import jax.numpy as jnp
    from pixie_tpu.udf.udf import MeanUDA as RefMean, QuantileUDA as RefQuantile

    for port_uda, ref_uda in ((MeanUDA(), RefMean()),
                              (QuantileUDA(0.5), RefQuantile(0.5))):
        got = interop.states_to_numpy(
            {"x": port_uda.init(8, np.float64, "cpu")})["x"]
        want = ref_uda.init(8, jnp.float64)
        if isinstance(want, dict):
            assert {k: (v.dtype, v.shape) for k, v in got.items()} == \
                {k: (np.dtype(v.dtype), v.shape) for k, v in want.items()}
        else:
            assert (got.dtype, got.shape) == (np.dtype(want.dtype), want.shape)


def test_states_round_trip_and_layout_check():
    st = {"m": {"sum": np.arange(4.0), "count": np.arange(4)},
          "q": np.zeros((4, 514), np.float32)}
    udas = {"m": MeanUDA(), "q": QuantileUDA(0.5)}
    t = interop.states_from_numpy(udas, st, "cpu")
    assert t["m"]["count"].dtype == torch.int64 and t["q"].dtype == torch.float32
    back = interop.states_to_numpy(t)
    np.testing.assert_array_equal(back["m"]["sum"], st["m"]["sum"])
    np.testing.assert_array_equal(back["q"], st["q"])
    with pytest.raises(InvalidArgument):
        interop.states_from_numpy({"m": MeanUDA()}, {"m": np.zeros(4)}, "cpu")
    with pytest.raises(InvalidArgument):
        interop.states_from_numpy({"m": MeanUDA()}, {}, "cpu")
