"""Parity: pixie_tpu_torch.ops.groupby (plain CPU path of kernel K1) against
pixie_tpu.ops.groupby on the same numpy inputs.

Tolerances: counts, int64 sums (wrapping mod 2^64), min and max are exact.
float64 sums agree to rtol 1e-12: the two packages add in different orders
(the CUDA kernel's atomics in an order that varies per run).  float32 sums use
integer-valued inputs whose partial sums stay below 2^24, so every order is
exact and the comparison is exact too.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu.ops import groupby as ref
from pixie_tpu_torch.ops import groupby as port

N = 4096
GROUPS = [1, 64, 5000]


def _rows(g, seed, empty=False):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, g, N).astype(np.int32)
    mask = np.zeros(N, bool) if empty else rng.random(N) < 0.7
    return rng, gid, mask


def _values(kind, rng):
    if kind == "int64_wrap":
        # magnitudes near 2^63: every group's sum wraps
        v = rng.integers(2 ** 62, 2 ** 63 - 1, N, dtype=np.int64)
        return v * np.where(rng.random(N) < 0.5, -1, 1)
    if kind == "float64":
        return rng.normal(0.0, 1e3, N)
    if kind == "float64_nan":
        v = rng.exponential(50.0, N)
        v[rng.random(N) < 0.01] = np.nan
        return v
    if kind == "float32":
        return rng.integers(-1000, 1000, N).astype(np.float32)
    if kind == "int32":
        return rng.integers(-(2 ** 31), 2 ** 31 - 1, N, dtype=np.int64).astype(np.int32)
    if kind == "bool":
        return rng.random(N) < 0.5
    raise AssertionError(kind)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_same(got: torch.Tensor, want, rtol=0.0):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("empty", [False, True])
def test_count(g, empty):
    _rng, gid, mask = _rows(g, 1, empty)
    want = ref.masked_segment_count(jnp.asarray(gid), g, jnp.asarray(mask))
    _assert_same(port.masked_segment_count(_t(gid), g, _t(mask)), want)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("kind", ["int64_wrap", "float64", "float64_nan", "float32",
                                  "bool"])
def test_sum(g, kind):
    rng, gid, mask = _rows(g, 2)
    v = _values(kind, rng)
    # The reference sums booleans only after its UDAs cast them to int64
    # (jax segment_sum rejects bool on the CPU): compare on that input.
    rv = v.astype(np.int64) if kind == "bool" else v
    want = ref.masked_segment_sum(jnp.asarray(rv), jnp.asarray(gid), g,
                                  jnp.asarray(mask))
    got = port.masked_segment_sum(_t(v), _t(gid), g, _t(mask))
    _assert_same(got, want, rtol=1e-12 if kind.startswith("float64") else 0.0)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("kind", ["int64_wrap", "float64_nan", "float32", "int32"])
def test_min_max(g, op, kind):
    rng, gid, mask = _rows(g, 3)
    v = _values(kind, rng)
    fref = ref.masked_segment_min if op == "min" else ref.masked_segment_max
    fport = port.masked_segment_min if op == "min" else port.masked_segment_max
    want = fref(jnp.asarray(v), jnp.asarray(gid), g, jnp.asarray(mask))
    _assert_same(fport(_t(v), _t(gid), g, _t(mask)), want)


@pytest.mark.parametrize("op", ["count", "sum", "min", "max"])
def test_empty_mask_keeps_identity(op):
    _rng, gid, mask = _rows(64, 4, empty=True)
    v = np.arange(N, dtype=np.float64)
    if op == "count":
        want = ref.masked_segment_count(jnp.asarray(gid), 64, jnp.asarray(mask))
        got = port.masked_segment_count(_t(gid), 64, _t(mask))
    else:
        fref = getattr(ref, f"masked_segment_{op}")
        fport = getattr(port, f"masked_segment_{op}")
        want = fref(jnp.asarray(v), jnp.asarray(gid), 64, jnp.asarray(mask))
        got = fport(_t(v), _t(gid), 64, _t(mask))
    _assert_same(got, want)


@pytest.mark.parametrize("op", ["count", "sum", "min", "max"])
def test_accumulates_in_place(op):
    """Two feeds into one state equal the reference's per-feed results merged
    with the UDA reduce op (add / minimum / maximum)."""
    g = 64
    rng, gid, mask = _rows(g, 5)
    v = rng.integers(-(2 ** 40), 2 ** 40, N)
    halves = [slice(0, N // 2), slice(N // 2, N)]
    if op == "count":
        state = torch.zeros(g, dtype=torch.int64)
        for h in halves:
            port.masked_segment_count(_t(gid[h]), g, _t(mask[h]), out=state)
        want = ref.masked_segment_count(jnp.asarray(gid), g, jnp.asarray(mask))
    else:
        fport = getattr(port, f"masked_segment_{op}")
        fref = getattr(ref, f"masked_segment_{op}")
        state = None
        for h in halves:
            state = fport(_t(v[h]), _t(gid[h]), g, _t(mask[h]), out=state)
        want = fref(jnp.asarray(v), jnp.asarray(gid), g, jnp.asarray(mask))
    _assert_same(state, want)


def _edge_rows(g, dtype, seed):
    """Ids in [-2, g + 2) (out-of-range rows drop) and values 1% NaN with
    +-0.0, +-inf and the type's extremes, as the kernel's tests feed K1."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(-2, g + 2, N).astype(np.int32)
    mask = rng.random(N) < 0.8
    v = rng.normal(0.0, 10.0, N)
    v[rng.random(N) < 0.01] = np.nan
    special = [0.0, -0.0, np.inf, -np.inf, 1e-300, -1e-300, 1e300, -1e300]
    v[rng.integers(0, N, 64)] = np.resize(special, 64)
    with np.errstate(over="ignore"):  # +-1e300 are +-inf in float32
        return gid, mask, v.astype(dtype)


@pytest.mark.parametrize("g", GROUPS + [1 << 16])
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_min_max_edge_values(g, op, dtype):
    """NaN rows, +-0.0, +-inf and ids outside [0, G), on both of K1's
    routes' group counts (G = 2^16 is past a block's shared memory): NaN
    where the reference has NaN, equal values elsewhere (which zero a group
    keeps is unspecified)."""
    gid, mask, v = _edge_rows(g, dtype, 11 + g)
    fref = getattr(ref, f"masked_segment_{op}")
    fport = getattr(port, f"masked_segment_{op}")
    want = fref(jnp.asarray(v), jnp.asarray(gid), g, jnp.asarray(mask))
    _assert_same(fport(_t(v), _t(gid), g, _t(mask)), want)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_min_max_state_entering_nan_stays_nan(op, dtype, sign):
    """A state that enters holding NaN (of either sign) in some groups, two
    feeds accumulating in place: the reference's per-feed result folded into
    the same state with minimum / maximum, NaN kept wherever it was."""
    g = 64
    gid, mask, v = _edge_rows(g, dtype, 17)
    ident = np.inf if op == "min" else -np.inf
    state0 = np.full(g, ident, dtype=dtype)
    state0[:8] = np.copysign(np.nan, sign)
    state = _t(state0.copy())
    for h in (slice(0, N // 2), slice(N // 2, N)):
        state = getattr(port, f"masked_segment_{op}")(_t(v[h]), _t(gid[h]), g, _t(mask[h]),
                                                       out=state)
    fold = jnp.minimum if op == "min" else jnp.maximum
    want = fold(jnp.asarray(state0), getattr(ref, f"masked_segment_{op}")(
        jnp.asarray(v), jnp.asarray(gid), g, jnp.asarray(mask)))
    _assert_same(state, want)
    assert np.isnan(state.numpy()[:8]).all()


def test_out_of_range_ids_drop():
    """Rows whose group id lies outside [0, G) are dropped, as the reference's
    scatter drops them."""
    gid = np.array([0, 1, 2, -1, 7, 2], np.int32)
    mask = np.ones(6, bool)
    v = np.arange(6, dtype=np.int64)
    want = ref.masked_segment_sum(jnp.asarray(v), jnp.asarray(gid), 3, jnp.asarray(mask))
    _assert_same(port.masked_segment_sum(_t(v), _t(gid), 3, _t(mask)), want)


@pytest.mark.parametrize("cards", [[16], [16, 4], [3, 5, 7]])
def test_combine_and_split_codes(cards):
    rng = np.random.default_rng(6)
    codes = [rng.integers(-1, c + 1, N).astype(np.int32) for c in cards]
    want, g_ref = ref.combine_codes([jnp.asarray(c) for c in codes], cards)
    got, g_port = port.combine_codes([_t(c) for c in codes], cards)
    assert g_port == g_ref
    _assert_same(got, want)
    gids = got.numpy()
    for a, b in zip(port.split_codes(gids, cards), ref.split_codes(gids, cards)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("lut_len", [1, 3, 64, 300])
def test_encode_against(lut_len):
    rng = np.random.default_rng(7)
    lut = np.unique(rng.integers(0, 1000, lut_len * 3))[:lut_len].astype(np.int64)
    vals = rng.integers(-5, 1005, N).astype(np.int64)
    want = ref.encode_against(jnp.asarray(lut), jnp.asarray(vals))
    _assert_same(port.encode_against(_t(lut), _t(vals)), want)
