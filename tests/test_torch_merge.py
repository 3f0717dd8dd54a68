"""M1, the cross-agent state merge: pixie_tpu_torch against pixie_tpu.

The plain version of ops/merge.py `merge_states` (what runs on the CPU; on a
CUDA tensor the wrapper launches kernel M1) is held against the reference's
`ChainKernel.merge_states_fn(reduce_tree)` on the JAX CPU, over the same
numpy states, for the state of every UDA the port registers and N in
{1, 2, 3, 8} states.  Integer leaves (counts, int64 sums that wrap mod 2^64,
int min / max), sketch bins (float32 counts) and float min / max (with NaN
and +-inf, which propagate NaN in both) must match exactly; float64 sums to
rtol 1e-12 (both add in agent order; XLA may associate differently).  One
case runs both packages' `gang_merge_states` over `_DeferredPartial`s.
"""
import numpy as np
import pytest
import torch

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import jax.numpy as jnp
from pixie_tpu.engine.executor import ChainKernel
from pixie_tpu.engine.executor import _DeferredPartial as RefDeferred
from pixie_tpu.engine.executor import gang_merge_states as ref_gang_merge

from pixie_tpu_torch.engine.executor import _DeferredPartial, gang_merge_states
from pixie_tpu_torch.ops import _build
from pixie_tpu_torch.ops.merge import merge_states, merge_states_plain
from pixie_tpu_torch.udf import registry
from pixie_tpu_torch.udf.udf import tree_map

G = 64
#: (case, UDA name, input dtype): the state of every UDA the port registers
CASES = [
    ("count", "count", None),
    ("sum_i64", "sum", np.int64),
    ("sum_f64", "sum", np.float64),
    ("mean", "mean", np.float64),
    ("min_f64", "min", np.float64),
    ("max_f64", "max", np.float64),
    ("min_i64", "min", np.int64),
    ("max_i64", "max", np.int64),
    ("any_i32", "any", np.int32),
    ("variance", "variance", np.float64),
    ("stddev", "stddev", np.float64),
    ("p50", "p50", np.float64),
    ("quantiles", "quantiles", np.float64),
]


def _leaf(rng, t: torch.Tensor, op: str) -> np.ndarray:
    shape, dt = tuple(t.shape), t.numpy().dtype
    if dt == np.float32:  # sketch bins: integer counts
        return rng.integers(0, 1000, shape).astype(np.float32)
    if dt == np.float64:
        v = rng.normal(0, 1e3, shape)
        if op != "add":  # NaN and +-inf propagate through min / max
            flat = v.reshape(-1)
            flat[rng.integers(0, flat.size, 3)] = np.nan
            flat[rng.integers(0, flat.size, 3)] = np.inf
            flat[rng.integers(0, flat.size, 3)] = -np.inf
        return v
    if dt == np.int64 and op == "add":  # sums that wrap past 2^63
        return rng.integers(2 ** 62, 2 ** 63 - 1, shape, dtype=np.int64)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt)


def _states(case, n, seed):
    _c, name, in_dt = next(c for c in CASES if c[0] == case)
    uda = registry.uda(name)
    rt = {"v": uda.reduce_ops(), "__seen": "add"}
    rng = np.random.default_rng(seed)
    states = []
    for _ in range(n):
        init = {"v": uda.init(G, in_dt, "cpu"),
                "__seen": torch.zeros(G, dtype=torch.int64)}
        states.append(tree_map(lambda t, op: _leaf(rng, t, op), init,
                               _ops_like(rt, init)))
    return rt, states


def _ops_like(ops, tree):
    """The reduce-op tree broadcast to the state tree's shape."""
    if isinstance(tree, dict):
        return {k: _ops_like(ops[k] if isinstance(ops, dict) else ops, v)
                for k, v in tree.items()}
    return ops


def _assert_merged_equal(got, want, rt):
    if isinstance(rt, dict):
        for k in rt:
            _assert_merged_equal(got[k], want[k], rt[k])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == np.float64 and rt == "add":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_merge_plain_equals_reference(case, n):
    rt, states = _states(case, n, seed=len(case) * 31 + n)
    want = ChainKernel.merge_states_fn(rt)(*[tree_map(jnp.asarray, s) for s in states])
    before = _build.KERNELS["merge"].launches
    got = merge_states(rt, [tree_map(torch.from_numpy, s) for s in states])
    assert _build.KERNELS["merge"].launches == before  # the CPU runs no kernel
    _assert_merged_equal(tree_map(lambda t: t.numpy(), got), want, rt)


def test_merge_plain_wraps_int64_exactly():
    a = torch.tensor([2 ** 63 - 1, -(2 ** 63)], dtype=torch.int64)
    b = torch.tensor([1, -1], dtype=torch.int64)
    got = merge_states_plain("add", [a, b])
    assert got.tolist() == [-(2 ** 63), 2 ** 63 - 1]


def test_gang_merge_over_deferred_partials_equals_reference():
    """Both packages' gang_merge_states over 8 agents' deferred states of
    config #4's aggregate (count, mean, p50, seen)."""
    reg = {"cnt": registry.uda("count"), "avg_lat": registry.uda("mean"),
           "p50": registry.uda("p50"), "__seen": registry.uda("count")}
    rt = {k: u.reduce_ops() for k, u in reg.items()}
    rng = np.random.default_rng(4)
    states = []
    for _ in range(8):
        init = {k: u.init(G, np.float64, "cpu") for k, u in reg.items()}
        states.append(tree_map(lambda t, op: _leaf(rng, t, op), init,
                               _ops_like(rt, init)))
    fp = ("layout",)
    ref = ref_gang_merge([RefDeferred([tree_map(jnp.asarray, s)], None, layout_fp=fp,
                                      reduce_tree=rt) for s in states])
    got = gang_merge_states([_DeferredPartial([tree_map(torch.from_numpy, s)], None,
                                              layout_fp=fp, reduce_tree=rt)
                             for s in states])
    _assert_merged_equal(tree_map(lambda t: t.numpy(), got), ref, rt)
