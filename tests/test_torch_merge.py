"""M1, the cross-agent state merge: pixie_tpu_torch against pixie_tpu.

The plain version of ops/merge.py `merge_states` (what runs on the CPU; on a
CUDA tensor the wrapper launches kernel M1) is held against the reference's
`ChainKernel.merge_states_fn(reduce_tree)` on the JAX CPU, over the same
numpy states, for the state of every UDA the port registers and N in
{1, 2, 3, 8} states.  Integer leaves (counts, int64 sums that wrap mod 2^64,
int min / max), sketch bins (float32 counts) and float min / max (with NaN
and +-inf, which propagate NaN in both) must match exactly; float64 sums to
rtol 1e-12 (both add in agent order; XLA may associate differently).  The
port's merge comes back packed (one buffer at the merged tree's P1 layout,
`pack.Packed`) or, with packed=False, as views of that buffer: both forms
are held against the reference, and the packed one, unpacked on the host,
against `merge_states_plain` bit for bit.  One case runs both packages'
`gang_merge_states` over `_DeferredPartial`s, and one feeds M1's packed
output back in as a state.  M1's launch plan (`M1Plan`, cached per tree,
leaf spec and N) is held against the per-call descriptor encoding the
wrapper used before it (a fresh table per call): the same rows, split
into launches that cover every leaf once, in order.
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
from pixie_tpu_torch.ops import merge as m1
from pixie_tpu_torch.ops.merge import merge_states, merge_states_plain
from pixie_tpu_torch.ops.pack import Packed, flatten
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


def _host_tree(state):
    """A merged state on the host: a Packed unpacked from its bytes, as
    transfer.pull_states unpacks the pulled buffer, else the tree's arrays."""
    if isinstance(state, Packed):
        return state.unpack(state.buf.numpy())
    return tree_map(lambda t: t.numpy(), state)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_merge_plain_equals_reference(case, n, packed):
    rt, states = _states(case, n, seed=len(case) * 31 + n)
    want = ChainKernel.merge_states_fn(rt)(*[tree_map(jnp.asarray, s) for s in states])
    before = _build.KERNELS["merge"].launches
    tstates = [tree_map(torch.from_numpy, s) for s in states]
    got = merge_states(rt, tstates, packed=packed)
    assert _build.KERNELS["merge"].launches == before  # the CPU runs no kernel
    if n > 1:
        plan = m1.plan_for(rt, tstates)
        assert isinstance(got, Packed) == (packed and plan.packs)
        if isinstance(got, Packed):
            assert got.layout is plan.layout and got.buf.numel() == plan.layout.nbytes
        else:  # every leaf a view of the one buffer
            assert len({x.untyped_storage().data_ptr() for _p, x in flatten(got)}) == 1
        plain = tree_map(lambda t: t.numpy(), merge_states_plain(rt, tstates))
        _assert_bits_equal(_host_tree(got), plain)
    _assert_merged_equal(_host_tree(got), want, rt)


def _assert_bits_equal(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_bits_equal(got[k], want[k])
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


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
    assert isinstance(got, Packed)
    _assert_merged_equal(_host_tree(got), ref, rt)


def _per_call_rows(rt, states, out_ptrs):
    """The descriptor table as the wrapper encoded it on every call before
    the plan was cached: per leaf [flags, n, out, in_0 .. in_{N-1}], the
    vector flag set when every pointer of the row is 16-byte aligned, and
    the most units of any leaf."""
    rows, max_units = [], 1
    for (_path, op, xs), out in zip(m1._leaves(rt, states), out_ptrs):
        x0 = xs[0]
        ptrs = [out, *(x.data_ptr() for x in xs)]
        vec = not any(q & 15 for q in ptrs)
        units = -(-x0.numel() // (16 // x0.element_size())) if vec else x0.numel()
        max_units = max(max_units, units)
        rows.append([m1._OPS[op] | (m1._DTYPES[x0.dtype] << 8) | (int(vec) << 16),
                     x0.numel(), *ptrs])
    return np.array(rows, dtype=np.int64), max_units


def _shifted(state, shift):
    """The state's leaves as views `shift` elements into a longer buffer
    (not 16-byte aligned for shift 1)."""
    def leaf(t):
        flat = torch.cat([t.reshape(-1)[:shift], t.reshape(-1)])
        return flat[shift:].view(t.shape)

    return tree_map(leaf, state)


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("case", [c[0] for c in CASES] + ["config4"])
def test_m1_plan_rows_equal_per_call_encoding(case, n, shift):
    """The cached plan's rows for these states equal the per-call encoding
    (flags with the vector flag, counts, output pointers at the packed
    buffer's offsets, input pointers), and one launch carries them."""
    if case == "config4":
        rt, states = _config4_states(n, seed=n)
    else:
        rt, states = _states(case, n, seed=n)
    states = [_shifted(tree_map(torch.from_numpy, s), shift) if i % 2 else
              tree_map(torch.from_numpy, s) for i, s in enumerate(states)]
    plan = m1.plan_for(rt, states)
    assert m1.plan_for(rt, states) is plan
    base = 1 << 40
    got = plan.rows(states, base, -1)
    want, max_units = _per_call_rows(rt, states, [base + o for o in plan.layout.offsets])
    np.testing.assert_array_equal(got, want)
    assert all(o % 16 == 0 for o in plan.layout.offsets)
    assert len(plan.launches) == 1 and plan.launches[0][:2] == (0, len(want))
    if shift == 0:
        assert plan.launches[0][2] == max_units
    # the thread's buffer is reused: an aligned call after an unaligned one
    # sets every vector flag again
    aligned = [tree_map(torch.from_numpy, s) for s in _states(case, n, seed=n)[1]] \
        if case != "config4" else [tree_map(torch.from_numpy, s)
                                   for s in _config4_states(n, seed=n)[1]]
    again = plan.rows(aligned, base, -1)
    np.testing.assert_array_equal(again, _per_call_rows(
        rt, aligned, [base + o for o in plan.layout.offsets])[0])


@pytest.mark.parametrize("n_states,n_leaves", [(2, 1), (8, 5), (8, 369), (8, 370),
                                               (17, 250), (2, 1000), (100, 50),
                                               (m1.MAX_STATES, 2)])
def test_m1_plan_splits_past_one_launch(n_states, n_leaves):
    """A table past one launch's parameter block splits into launches of
    whole rows that cover every leaf exactly once, in order, each within
    the largest capacity; a merge of more states than one row holds
    raises."""
    ops = tuple(((f"l{i}",), ("add", "min", "max")[i % 3]) for i in range(n_leaves))
    dts = (torch.int64, torch.float32, torch.float64, torch.int32)
    spec = tuple((dts[i % 4], (1 + i % 7,)) for i in range(n_leaves))
    plan = m1.M1Plan.of(ops, spec, n_states)
    width = 3 + n_states
    per = m1.M1_WORDS[-1] // width
    assert len(plan.launches) == -(-n_leaves // per)
    covered = [i for a, b, _u in plan.launches for i in range(a, b)]
    assert covered == list(range(n_leaves))
    assert all((b - a) * width <= m1.M1_WORDS[-1] for a, b, _u in plan.launches)
    with pytest.raises(ValueError):
        m1.M1Plan.of(ops[:1], spec[:1], m1.MAX_STATES + 1)


def test_merge_of_many_leaves_and_states_equals_plain():
    """17 states over 250 leaves (two launches' worth of rows on the card):
    the packed merge unpacks equal to the plain fold, bit for bit."""
    rng = np.random.default_rng(5)
    rt = {f"l{i}": ("add", "min", "max")[i % 3] for i in range(250)}
    states = [{k: torch.from_numpy(rng.integers(-(2 ** 62), 2 ** 62, 3 + i % 5))
               if i % 2 else torch.from_numpy(rng.normal(size=3 + i % 5))
               for i, k in enumerate(rt)} for _ in range(17)]
    assert len(m1.plan_for(rt, states).launches) == 2
    got = merge_states(rt, states)
    assert isinstance(got, Packed)
    _assert_bits_equal(_host_tree(got),
                       tree_map(lambda t: t.numpy(), merge_states_plain(rt, states)))


def _config4_states(n, seed):
    reg = {"cnt": registry.uda("count"), "avg_lat": registry.uda("mean"),
           "p50": registry.uda("p50"), "__seen": registry.uda("count")}
    rt = {k: u.reduce_ops() for k, u in reg.items()}
    rng = np.random.default_rng(seed)
    states = []
    for _ in range(n):
        init = {k: u.init(G, np.float64, "cpu") for k, u in reg.items()}
        states.append(tree_map(lambda t, op: _leaf(rng, t, op), init,
                               _ops_like(rt, init)))
    return rt, states


@pytest.mark.parametrize("case", [c[0] for c in CASES] + ["config4"])
def test_merge_takes_its_own_packed_output(case):
    """M1's output enters M1 again as a state, as a mesh agent's merged
    shards enter the cross-agent merge: equal to the plain fold of the same
    trees, and to the reference over all the states where it is exact."""
    if case == "config4":
        rt, states = _config4_states(6, seed=9)
    else:
        rt, states = _states(case, 6, seed=9)
    tstates = [tree_map(torch.from_numpy, s) for s in states]
    halves = [merge_states(rt, tstates[:3]), merge_states(rt, tstates[3:], packed=False)]
    got = merge_states(rt, halves)
    want = merge_states_plain(rt, [h.tree() if isinstance(h, Packed) else h for h in halves])
    _assert_bits_equal(_host_tree(got), tree_map(lambda t: t.numpy(), want))
    ref = ChainKernel.merge_states_fn(rt)(*[tree_map(jnp.asarray, s) for s in states])
    _assert_merged_equal(_host_tree(got), ref, rt)
