"""Parity: pixie_tpu_torch.ops.sketch.LogHistogram (plain CPU paths of kernels
K2 and K3) against pixie_tpu.ops.sketch.LogHistogram on the same inputs.

Tolerance rule for the histogram update.  Both packages compute the bin as
ceil(float32 log(v) / float32 log(gamma)) + 1, but XLA's float32 log and
PyTorch's (and CUDA's logf) may differ in the last ulp, which moves a value
sitting on a bin edge into the neighbouring bin (measured: 1 of 4M
exponential(50) values).  So per-group totals must be exact, and a value may
change bin only if its float32 log(v)/log(gamma) lies within 4 ulp of an
integer, and then only into the adjacent bin; those values must account for
the whole difference between the two histograms.

quantile_device on one histogram equals the reference's host `quantile` bit
for bit (the port reads gamma^(idx-1.5) from a table that the host finalize
computes).  Against the reference's `quantile_device` it picks the same bin,
and the value agrees to 1 ulp: XLA's pow and libm's pow differ in the last
ulp at 31 of the 514 exponents (measured), while adjacent bins differ by 4%.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu.ops.sketch import LogHistogram as RefHist
from pixie_tpu_torch.ops.sketch import LogHistogram

LH, REF = LogHistogram(), RefHist()
W = LH.width


def _values(n, seed):
    rng = np.random.default_rng(seed)
    v = rng.exponential(50.0, n)
    # values exactly on bin edges (gamma^k) and next to them, plus the zero
    # bin's edge and the special values the reference bins by its int32 rule
    k = np.arange(-530, 530, dtype=np.float64)
    edges = np.power(REF.gamma, k)
    special = np.array([0.0, -1.0, 1e-9, np.nextafter(1e-9, 1.0), 5e-324, 1.0,
                        np.inf, -np.inf, np.nan, 1e300, 3.4e38, 3.5e38])
    v = np.concatenate([v, edges, np.nextafter(edges, 0.0), np.nextafter(edges, np.inf),
                        special])
    return rng.permutation(v)


def _port_lg(v):
    """The port's float32 log(v)/log(gamma), the quantity the bin rounds up."""
    x = torch.clamp_min(torch.as_tensor(v).to(torch.float32), float(np.float32(1e-9)))
    return (torch.log(x) / torch.full_like(x, LH._log_gamma_f32())).numpy()


def test_bin_index_special_values_exact():
    v = np.array([np.nan, np.inf, -np.inf, 0.0, -5.0, 1e-9, 1.0000001e-9, 1.0,
                  1e300, 5e-324, 3.4e38, 3.5e38, 1e-8, 50.0])
    want = np.asarray(REF.bin_index(jnp.asarray(v)))
    np.testing.assert_array_equal(LH.bin_index(torch.as_tensor(v)).numpy(), want)


def test_bin_index_edge_rule():
    v = _values(1 << 16, 1)
    want = np.asarray(REF.bin_index(jnp.asarray(v))).astype(np.int64)
    got = LH.bin_index(torch.as_tensor(v)).numpy()
    diff = got != want
    if diff.any():
        lg = _port_lg(v[diff]).astype(np.float32)
        near = np.abs(lg - np.round(lg)) <= 4 * np.spacing(np.abs(lg))
        assert near.all(), v[diff][~near]
        np.testing.assert_array_equal(np.abs(got[diff] - want[diff]), 1)
    assert diff.sum() <= 16


@pytest.mark.parametrize("g", [1, 64, 300])
@pytest.mark.parametrize("route", ["segment", "sorted"])
def test_update_matches_reference_routes(g, route):
    v = _values(1 << 15, 2 + g)
    n = len(v)
    rng = np.random.default_rng(g)
    gid = rng.integers(0, g, n).astype(np.int32)
    mask = rng.random(n) < 0.8
    bins_ref = REF.bin_index(jnp.asarray(v))
    upd = REF._update_segment if route == "segment" else REF._update_sorted
    want = np.asarray(upd(REF.init(g), jnp.asarray(gid), bins_ref,
                          jnp.asarray(mask), g))
    got = LH.update(LH.init(g, "cpu"), torch.as_tensor(gid), torch.as_tensor(v),
                    torch.as_tensor(mask), g).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1))
    # every cell difference is explained by values near a bin edge that moved
    # to the adjacent bin
    b_ref = np.asarray(bins_ref).astype(np.int64)
    b_port = LH.bin_index(torch.as_tensor(v)).numpy()
    moved = mask & (b_ref != b_port)
    if moved.any():
        lg = _port_lg(v[moved]).astype(np.float32)
        assert (np.abs(lg - np.round(lg)) <= 4 * np.spacing(np.abs(lg))).all()
        np.testing.assert_array_equal(np.abs(b_ref[moved] - b_port[moved]), 1)
    explained = (np.bincount(gid[moved] * W + b_port[moved], minlength=g * W)
                 - np.bincount(gid[moved] * W + b_ref[moved], minlength=g * W))
    np.testing.assert_array_equal((got - want).reshape(-1), explained)


def test_update_accumulates_and_respects_mask():
    v = _values(4096, 3)
    n = len(v)
    gid = np.arange(n, dtype=np.int32) % 8
    h = LH.init(8, "cpu")
    LH.update(h, torch.as_tensor(gid), torch.as_tensor(v), torch.zeros(n, dtype=torch.bool), 8)
    assert h.sum() == 0
    LH.update(h, torch.as_tensor(gid), torch.as_tensor(v), torch.ones(n, dtype=torch.bool), 8)
    LH.update(h, torch.as_tensor(gid), torch.as_tensor(v), torch.ones(n, dtype=torch.bool), 8)
    np.testing.assert_array_equal(h.sum(dim=1).numpy(), 2 * np.bincount(gid, minlength=8))


QS = [0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0]


def _hist(g, seed):
    rng = np.random.default_rng(seed)
    n = 1 << 15
    v = rng.exponential(50.0, n)
    gid = rng.integers(0, g, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    mask[gid == g - 1] = False  # one empty group → NaN
    h = np.asarray(REF._update_segment(REF.init(g), jnp.asarray(gid),
                                       REF.bin_index(jnp.asarray(v)),
                                       jnp.asarray(mask), g))
    return h.copy()


@pytest.mark.parametrize("g", [1, 2, 64, 500])
def test_quantile_device_matches_host_quantile_exactly(g):
    h = _hist(g, 10 + g)
    got = LH.quantile_device(torch.as_tensor(h), QS).numpy()
    want = REF.quantile(h, QS)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(LH.quantile(h, QS), want)


@pytest.mark.parametrize("g", [2, 64, 500])
def test_quantile_device_matches_reference_device_finalize(g):
    h = _hist(g, 20 + g)
    got = LH.quantile_device(torch.as_tensor(h), QS).numpy()
    want = np.asarray(REF.quantile_device(jnp.asarray(h), QS))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert (np.abs(got[ok] - want[ok]) <= np.spacing(np.abs(want[ok]))).all()


def _within_ulp(got, want):
    """The module's rule against the reference's device finalize: the same
    NaNs, the values within 1 ulp (XLA's pow against libm's)."""
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    assert (np.abs(got[ok] - want[ok]) <= np.spacing(np.abs(want[ok]))).all()


def test_bin_value_table_is_cached_by_the_sketch_values():
    """K3's bin-value table is cached by (gamma, min_value, width, device),
    not by instance: two gammas in one process give their own values, each
    equal to the reference's finalizes of that gamma, and a new instance of
    equal values (the quantile UDAs make one every finalize) reads the same
    table."""
    h = _hist(64, 31)
    pairs = [(LogHistogram(gamma=1.0404), RefHist(gamma=1.0404)),
             (LogHistogram(gamma=1.02), RefHist(gamma=1.02))]
    for _ in range(2):  # the second round reads the cached tables
        for port, ref in pairs + [(LogHistogram(), RefHist())]:
            got = port.quantile_device(torch.as_tensor(h), QS).numpy()
            np.testing.assert_array_equal(got, ref.quantile(h, QS))
            _within_ulp(got, np.asarray(ref.quantile_device(jnp.asarray(h), QS)))
    a, b = pairs[0][0], pairs[1][0]
    assert a._bin_values("cpu") is LogHistogram()._bin_values("cpu")
    assert a._bin_values("cpu") is not b._bin_values("cpu")
    assert a._bin_values("cpu") is not LogHistogram(min_value=1e-6)._bin_values("cpu")
    assert not np.array_equal(a.quantile_plain(torch.as_tensor(h), QS).numpy(),
                              b.quantile_plain(torch.as_tensor(h), QS).numpy())


#: quantile sets of 1, 5 (QuantilesUDA's), 16 (one K3 launch) and 17 (two)
#: quantiles, each with q = 0 or q = 1; the 16 and 17 are multiples of 1/16,
#: exact in float32 (see the f32 target test below)
RANK_QS = {1: [1.0], 5: [0.0, 0.01, 0.5, 0.99, 1.0],
           16: [k / 16 for k in range(1, 17)], 17: [k / 16 for k in range(17)]}


def _rank_hist():
    """Six groups: Poisson counts, one empty group, one of total 2^24 - 1
    spread over every bin, one whose rows all sit in bin 100, one with
    rows only in the zero bin and the overflow bin."""
    rng = np.random.default_rng(5)
    h = rng.poisson(3.0, (6, W)).astype(np.float32)
    h[1] = 0
    h[2] = rng.multinomial(2 ** 24 - 1, np.full(W, 1.0 / W))
    h[3] = 0
    h[3, 100] = 1000
    h[4] = 0
    h[4, 0], h[4, W - 1] = 3, 5
    assert h[2].sum(dtype=np.float64) == 2 ** 24 - 1
    return h


@pytest.mark.parametrize("nq", sorted(RANK_QS))
def test_quantile_plain_rank_rule_matches_reference(nq):
    """quantile_plain (K3's plain version) at nq = 1, 5, 16 and 17, with q
    = 0 and q = 1, an empty group and a group of total just under 2^24:
    the reference's device finalize's bins (values within 1 ulp) and its
    host finalize's values exactly."""
    h, qs = _rank_hist(), RANK_QS[nq]
    got = LH.quantile_plain(torch.as_tensor(h), qs).numpy()
    assert got.shape == (6, nq) and got.dtype == np.float64
    assert np.isnan(got[1]).all() and not np.isnan(np.delete(got, 1, 0)).any()
    np.testing.assert_array_equal(got, REF.quantile(h, qs))
    np.testing.assert_array_equal(LH.quantile(h, qs), REF.quantile(h, qs))
    _within_ulp(got, np.asarray(REF.quantile_device(jnp.asarray(h), qs)))
    np.testing.assert_array_equal(LH.quantile_device(torch.as_tensor(h), qs).numpy(), got)


def test_quantile_target_is_formed_in_float32_as_the_reference_device():
    """The device rule forms q * total in float32, as the reference's
    quantile_device does: with q = 1/15 and 45 rows the float32 target is
    3.0000002, so a running count of exactly 3 is below it and the next bin
    is picked, where the host finalize's float64 target is 3.0 exactly.
    K3's plain version follows the device rule (the card tests hold K3 to
    the host finalize only at quantiles exact in float32)."""
    h = np.zeros((1, W), np.float32)
    h[0, 10], h[0, 11] = 3, 42
    got = LH.quantile_plain(torch.as_tensor(h), [1 / 15]).numpy()
    _within_ulp(got, np.asarray(REF.quantile_device(jnp.asarray(h), [1 / 15])))
    assert got[0, 0] == LH.bin_value(np.array([11]))[0]
    assert REF.quantile(h, [1 / 15])[0, 0] == LH.bin_value(np.array([10]))[0]


def test_bin_value_matches_reference():
    idx = np.arange(-2, W + 2)
    np.testing.assert_array_equal(LH.bin_value(idx), REF.bin_value(idx))


# ------------------------------------------------------------- the NaN bin

from pixie_tpu.engine import np_partial as ref_np  # noqa: E402


def _nan_values(n, seed):
    v = _values(n, seed)
    v[np.random.default_rng(seed).random(len(v)) < 0.2] = np.nan
    return v


@pytest.mark.parametrize("nan_bin", [0, 1])
def test_bin_index_nan_bin_is_the_only_difference_of_the_routes(nan_bin):
    """bin_index(nan_bin=1) is the reference's device rule, nan_bin=0 its
    CPU route's (`np_partial._bin_index_np`, which its streaming polls
    take): each NaN lands in nan_bin, every other value where the rule
    puts it."""
    v = np.array([np.nan, np.inf, -np.inf, 0.0, -5.0, 1e-9, 1.0000001e-9, 1.0,
                  1e300, 5e-324, 3.4e38, 3.5e38, 1e-8, 50.0, np.nan])
    if nan_bin == 1:
        want = np.asarray(REF.bin_index(jnp.asarray(v))).astype(np.int64)
    else:
        want = ref_np._bin_index_np(REF, v).astype(np.int64)
    got = LH.bin_index(torch.as_tensor(v), nan_bin).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[np.isnan(v)] == nan_bin).all()


@pytest.mark.parametrize("g", [1, 64])
def test_update_nan_bin_0_equals_reference_cpu_route(g):
    """K2's plain version at nan_bin 0 over values 20% NaN equals the
    reference's CPU-route histogram (`np_partial._hist_update`, native or
    numpy) in every NaN's cell and in every group's total."""
    v = _nan_values(1 << 14, 7 + g)
    n = len(v)
    rng = np.random.default_rng(g)
    gid = rng.integers(0, g, n).astype(np.int64)
    mask = rng.random(n) < 0.8
    want = ref_np._hist_update(REF, np.where(mask, gid, -1), mask, v, g)
    got = LH.update(LH.init(g, "cpu"), torch.as_tensor(gid.astype(np.int32)),
                    torch.as_tensor(v), torch.as_tensor(mask), g, nan_bin=0).numpy()
    np.testing.assert_array_equal(got.sum(axis=1), np.asarray(want).sum(axis=1))
    nan_cells = np.bincount(gid[mask & np.isnan(v)], minlength=g)
    assert (got[:, 0] >= nan_cells).all() and (got[:, 1] == np.asarray(want)[:, 1]).all()
    np.testing.assert_array_equal(got[:, 0], np.asarray(want)[:, 0])


@pytest.mark.parametrize("groups,blocks", [(1, 1), (64, 1), (113, 1), (114, 0), (1024, 0),
                                           (1 << 20, 0)])
def test_update_regime_follows_the_sketch_bytes(groups, blocks):
    """K2's regime (csrc/loghist_update.cu px_loghist_regime) at W = 514 on
    an H100's 227 KB of opt-in shared memory: one block's shared memory
    through 113 groups (config #1's 64), global atomics from 114 (config
    #2's 1,024); on a card with 48 KB, through 23 groups."""
    from pixie_tpu_torch.ops.sketch import H100_SMEM_OPTIN, update_regime

    assert update_regime(groups, 514) == blocks
    assert (groups * 514 * 4 <= H100_SMEM_OPTIN) == bool(blocks)
    assert update_regime(groups, 514, smem_optin=48 * 1024) == (1 if groups <= 23 else 0)
