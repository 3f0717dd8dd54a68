"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA card and nvcc; elsewhere they skip.  On a machine with a
card and no JAX, run them without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import zlib

import numpy as np
import pytest
import torch

from pixie_tpu_torch.engine import transfer
from pixie_tpu_torch.ops import _build
from pixie_tpu_torch.ops import compact as k4
from pixie_tpu_torch.ops import groupby as gb
from pixie_tpu_torch.ops import join_device as jd
from pixie_tpu_torch.ops import kmeans as km_ops
from pixie_tpu_torch.ops import merge as m1
from pixie_tpu_torch.ops import resident as rk
from pixie_tpu_torch.ops.sketch import LogHistogram

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _rows(dev, n, g, seed):
    rng = np.random.default_rng(seed)
    gid = torch.from_numpy(rng.integers(0, g, n).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    return rng, gid, mask


@pytest.mark.parametrize("g", [1, 64, 1 << 15])
def test_segment_count_and_int64_sum_exact(dev, g):
    rng, gid, mask = _rows(dev, 1 << 18, g, 1)
    v = torch.from_numpy(rng.integers(2 ** 62, 2 ** 63 - 1, 1 << 18, dtype=np.int64)).to(dev)
    before = _build.KERNELS["segment_reduce"].launches
    got_c = gb.masked_segment_count(gid, g, mask)
    got_s = gb.masked_segment_sum(v, gid, g, mask)
    assert _build.KERNELS["segment_reduce"].launches == before + 2
    want_c = gb.segment_count_plain(gid, g, mask, torch.zeros(g, dtype=torch.int64, device=dev))
    want_s = gb.segment_sum_plain(v, gid, g, mask, torch.zeros(g, dtype=torch.int64, device=dev))
    assert torch.equal(got_c, want_c) and torch.equal(got_s, want_s)


@pytest.mark.parametrize("op", ["min", "max"])
def test_segment_pick_f64_nan_wins(dev, op):
    rng, gid, mask = _rows(dev, 1 << 16, 64, 2)
    v = rng.exponential(1.0, 1 << 16)
    v[::997] = np.nan
    v = torch.from_numpy(v).to(dev)
    got = getattr(gb, f"masked_segment_{op}")(v, gid, 64, mask)
    want = gb.segment_pick_plain(v, gid, 64, mask, torch.full(
        (64,), gb._identity_for(torch.float64, op), dtype=torch.float64, device=dev), op)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("g", [1, 64, 512])
def test_loghist_update_and_quantile_exact(dev, g):
    rng, gid, mask = _rows(dev, 1 << 18, g, 3)
    lh = LogHistogram()
    v = torch.from_numpy(rng.exponential(50.0, 1 << 18)).to(dev)
    got = lh.update(lh.init(g, dev), gid, v, mask, g)
    want = lh.update_plain(lh.init(g, dev), gid, v, mask, g)
    assert torch.equal(got, want)
    qs = [0.01, 0.5, 0.99]
    q = lh.quantile_device(got, qs)
    assert torch.equal(q.nan_to_num(-1.0), lh.quantile_plain(got, qs).nan_to_num(-1.0))


#: K3's quantile sets: 1, 5 (QuantilesUDA's), 16 (one launch), 17 (two).
#: The 16 and 17 are multiples of 1/16, exact in float32, so the device's
#: f32 target q * total equals the host finalize's f64 one; a q such as 0.2
#: can put the two on either side of a running count (the reference's own
#: device and host finalizes differ there: tests/test_torch_sketch.py)
_K3_QS = {1: [0.5], 5: [0.01, 0.1, 0.5, 0.9, 0.99],
          16: [k / 16 for k in range(1, 17)], 17: [k / 16 for k in range(17)]}


@pytest.mark.parametrize("nq", sorted(_K3_QS))
@pytest.mark.parametrize("g", [1, 64, 4096])
def test_loghist_quantile_equals_plain_and_host(dev, g, nq):
    """K3 bit for bit (NaN as NaN) against its plain version and the host
    finalize, with empty groups (and at G = 1 an empty sketch), in
    ceil(nq / 16) launches."""
    rng = np.random.default_rng(g + nq)
    lh, qs = LogHistogram(), _K3_QS[nq]
    h = rng.poisson(2.0, (g, lh.width)).astype(np.float32)
    h[rng.random(g) < 0.1] = 0
    h[0] = 0
    t = torch.from_numpy(h).to(dev)
    before = _build.KERNELS["loghist_quantile"].launches
    got = lh.quantile_device(t, qs)
    assert _build.KERNELS["loghist_quantile"].launches == before + -(-nq // 16)
    want = lh.quantile_plain(t, qs)
    torch.cuda.synchronize()
    assert got.shape == (g, nq) and got.dtype == torch.float64
    assert torch.equal(got.isnan(), want.isnan()) and bool(got[0].isnan().all())
    assert torch.equal(got.nan_to_num(-1.0), want.nan_to_num(-1.0))
    np.testing.assert_array_equal(got.cpu().numpy(), lh.quantile(h, qs))


def test_loghist_quantile_two_gammas_and_a_large_group(dev):
    """Two sketches of different gamma in one process read their own cached
    bin values; a group of total 2^24 - 1 keeps the f32 rank rule."""
    rng = np.random.default_rng(3)
    h = rng.poisson(3.0, (64, 514)).astype(np.float32)
    h[7] = rng.multinomial(2 ** 24 - 1, np.full(514, 1.0 / 514))
    t = torch.from_numpy(h).to(dev)
    qs = _K3_QS[17]
    for _ in range(2):
        for lh in (LogHistogram(gamma=1.0404), LogHistogram(gamma=1.02), LogHistogram()):
            got = lh.quantile_device(t, qs)
            assert torch.equal(got, lh.quantile_plain(t, qs))
            np.testing.assert_array_equal(got.cpu().numpy(), lh.quantile(h, qs))
    a, b = LogHistogram(gamma=1.0404), LogHistogram(gamma=1.02)
    assert not torch.equal(a.quantile_device(t, qs), b.quantile_device(t, qs))


@pytest.mark.parametrize("g", [1, 64, 113, 114, 1024])
@pytest.mark.parametrize("nan_bin", [0, 1])
@pytest.mark.parametrize("offset", [0, 1])
def test_loghist_update_regimes_equal_plain(dev, g, nan_bin, offset):
    """K2 in each regime (shared through 113 groups, global atomics at 114
    and 1,024) against update_plain exactly, over values 20% NaN at both
    NaN bins and a feed that ends mid-run; offset 1 starts every input one
    value past alignment (the one-row loads)."""
    from pixie_tpu_torch.ops.sketch import update_regime

    n = (1 << 20) + 3
    rng = np.random.default_rng(g + 7 * nan_bin)
    lh = LogHistogram()
    gid = torch.from_numpy(rng.integers(-1, g + 1, n + offset).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random(n + offset) < 0.8).to(dev)
    v = rng.exponential(50.0, n + offset)
    v[rng.random(n + offset) < 0.2] = np.nan
    v[offset: offset + 6] = [np.inf, -np.inf, 0.0, 1e-9, -1.0, 1e300]
    v = torch.from_numpy(v).to(dev)
    gid, mask, v = gid[offset:], mask[offset:], v[offset:]
    assert update_regime(g, lh.width) == {1: 1, 64: 1, 113: 1, 114: 0, 1024: 0}[g]
    before = _build.KERNELS["loghist_update"].launches
    got = lh.update(lh.init(g, dev), gid, v, mask, g, nan_bin)
    assert _build.KERNELS["loghist_update"].launches == before + 1
    want = lh.update_plain(lh.init(g, dev), gid, v, mask, g, nan_bin)
    assert torch.equal(got, want)


def test_loghist_regime_on_the_card_equals_the_mirror(dev):
    """px_loghist_regime on the card equals ops/sketch.py update_regime at
    the card's opt-in shared memory."""
    import ctypes

    from pixie_tpu_torch.ops.sketch import update_regime

    fn = _build.function("loghist_update", "px_loghist_regime", [ctypes.c_int, ctypes.c_int])
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for g in (1, 64, 113, 114, 1024, 5000):
        assert fn(g, 514) == update_regime(g, 514, optin), g


@pytest.mark.parametrize("nan_bin", [0, 1])
def test_loghist_update_nan_bin_equals_plain(dev, nan_bin):
    """K2 over values 20% NaN (and +-inf, 0, values <= min_value): each NaN
    in bin `nan_bin`, exactly as the plain version bins it."""
    rng, gid, mask = _rows(dev, 1 << 18, 64, 4)
    lh = LogHistogram()
    v = rng.exponential(50.0, 1 << 18)
    v[rng.random(1 << 18) < 0.2] = np.nan
    v[:6] = [np.inf, -np.inf, 0.0, 1e-9, -1.0, 1e300]
    v = torch.from_numpy(v).to(dev)
    got = lh.update(lh.init(64, dev), gid, v, mask, 64, nan_bin)
    want = lh.update_plain(lh.init(64, dev), gid, v, mask, 64, nan_bin)
    assert torch.equal(got, want)
    nan_rows = mask & torch.isnan(v)
    assert int(got[:, nan_bin].sum()) >= int(nan_rows.sum())


#: K1's NaN bits: a NaN that a row brings into a min state is the negative
#: quiet NaN, into a max state the positive one (csrc/segment_reduce.cu)
_K1_NAN = {(torch.float64, "min"): -(1 << 51), (torch.float64, "max"): 0x7FF8 << 48,
           (torch.float32, "min"): -(1 << 22), (torch.float32, "max"): 0x7FC00000}


def _edge_values(rng, n, dtype):
    """Values with NaN rows (1%), +-0.0, +-inf and the type's extremes."""
    v = rng.normal(0.0, 10.0, n)
    v[rng.random(n) < 0.01] = np.nan
    special = [0.0, -0.0, np.inf, -np.inf, 1e-300, -1e-300, 1e300, -1e300]
    at = rng.integers(0, n, 8 * len(special))
    v[at] = np.resize(special, at.shape[0])
    with np.errstate(over="ignore"):  # +-1e300 are +-inf in float32
        return torch.from_numpy(v.astype(np.float64 if dtype == torch.float64 else np.float32))


def _same_pick(got, want):
    """NaN where the plain version has NaN, equal values elsewhere (which of
    -0.0 and +0.0 a group keeps is unspecified)."""
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("g", [64, 1 << 16])
def test_segment_pick_float_edges_equal_plain(dev, dtype, op, g):
    """K1 min / max on the shared route (G = 64) and the global route (G =
    2^16, past a block's shared memory) against the plain version: NaN rows,
    +-0.0, +-inf, ids outside [0, G), a state that enters holding NaN of
    either sign in some groups (which stays NaN), two calls accumulating in
    place, and inputs one value past alignment (the row-by-row loads)."""
    n = (1 << 18) + 5
    rng = np.random.default_rng(21 + g)
    gid = torch.from_numpy(rng.integers(-2, g + 2, n).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    v = _edge_values(rng, n, dtype).to(dev)
    state = torch.full((g,), gb._identity_for(dtype, op), dtype=dtype, device=dev)
    ints = torch.int64 if dtype == torch.float64 else torch.int32
    pos_nan = 0x7FF8 << 48 if dtype == torch.float64 else 0x7FC00000
    neg_nan = _K1_NAN[(dtype, "min")]
    state.view(ints)[: g // 8] = pos_nan
    state.view(ints)[g // 8: g // 4] = neg_nan
    entered, entered_bits = state.isnan(), state.view(ints).clone()
    want = state.clone()
    fn = getattr(gb, f"masked_segment_{op}")
    before = _build.KERNELS["segment_reduce"].launches
    for lo, hi in ((0, n // 2), (n // 2 + 1, n)):  # the second half starts unaligned
        fn(v[lo:hi], gid[lo:hi], g, mask[lo:hi], out=state)
        gb.segment_pick_plain(v[lo:hi], gid[lo:hi], g, mask[lo:hi], want, op)
    assert _build.KERNELS["segment_reduce"].launches == before + 2
    _same_pick(state, want)
    assert bool(state[entered].isnan().all())
    # a NaN a row brought is the op's own NaN; an entering NaN keeps its bits
    from_rows = state.isnan() & ~entered
    assert bool(from_rows.any())
    assert bool((state.view(ints)[from_rows] == _K1_NAN[(dtype, op)]).all())
    assert torch.equal(state.view(ints)[entered], entered_bits[entered])


@pytest.mark.parametrize("op", ["count", "sum_i64", "sum_f64", "sum_f32", "min_i64", "max_i32"])
def test_segment_global_route_equals_plain(dev, op):
    """The global route (2^20 rows into 2^23 groups, the sorted path's chunk)
    for the entry points other than the float min / max: counts, integer
    sums, min and max exactly, float sums to 1e-12 of the sum of |values|
    (f32: integer values, exact); aligned and one row past alignment."""
    n, g = 1 << 20, 1 << 23
    rng = np.random.default_rng(31)
    gid = torch.from_numpy(rng.integers(-1, g + 1, n + 1).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random(n + 1) < 0.9).to(dev)
    raw = {"count": None,
           "sum_i64": rng.integers(-(2 ** 62), 2 ** 62, n + 1),
           "sum_f64": rng.normal(0, 1e3, n + 1),
           "sum_f32": rng.integers(-100, 100, n + 1).astype(np.float32),
           "min_i64": rng.integers(-(2 ** 62), 2 ** 62, n + 1),
           "max_i32": rng.integers(-(2 ** 31), 2 ** 31 - 1, n + 1).astype(np.int32)}[op]
    v = None if raw is None else torch.from_numpy(raw).to(dev)
    kind = op.split("_")[0]
    dt = torch.int64 if v is None else v.dtype  # the state's type
    for off in (0, 1):
        gi, m = gid[off: off + n], mask[off: off + n]
        x = None if v is None else v[off: off + n]
        if kind in ("min", "max"):
            init = torch.full((g,), gb._identity_for(dt, kind), dtype=dt, device=dev)
        else:
            init = torch.zeros(g, dtype=dt, device=dev)
        got, want = init.clone(), init.clone()
        for _ in range(2):  # twice, accumulating in place
            if kind == "count":
                gb.masked_segment_count(gi, g, m, out=got)
                gb.segment_count_plain(gi, g, m, want)
            elif kind == "sum":
                gb.masked_segment_sum(x, gi, g, m, out=got)
                gb.segment_sum_plain(x, gi, g, m, want)
            else:
                getattr(gb, f"masked_segment_{kind}")(x, gi, g, m, out=got)
                gb.segment_pick_plain(x, gi, g, m, want, kind)
        if op == "sum_f64":
            # 1e-12 of the sum of |values| the two calls added
            scale = 2 * gb.segment_sum_plain(x.abs(), gi, g, m, torch.zeros_like(want))
            assert bool(((got - want).abs() <= 1e-12 * scale).all())
        else:
            assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 31, 4095, 4097, 1 << 20, (1 << 20) + 3])
@pytest.mark.parametrize("density", [0.0, 0.001, 0.1, 0.5, 0.9, 1.0])
def test_compact_equals_stable_partition(dev, n, density):
    rng = np.random.default_rng(5)
    m = torch.from_numpy(rng.random(n) < density).to(dev)
    cols = [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n)).to(dev),
            torch.from_numpy(rng.normal(size=n)).to(dev),
            torch.from_numpy(rng.random(n) < 0.5).to(dev),
            torch.from_numpy(rng.integers(0, 100, n).astype(np.int16)).to(dev),
            torch.from_numpy(rng.integers(-128, 127, n).astype(np.int8)).to(dev),
            torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)]
    before = _build.KERNELS["compact"].launches
    got, count = k4.compact(m, cols)
    assert _build.KERNELS["compact"].launches == before + 1
    want, want_count = k4.compact_plain(m, cols)
    c = int(count)
    assert c == int(want_count)
    for g, w in zip(got, want):
        assert torch.equal(g[:c], w[:c])


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_compact_unaligned_inputs(dev, offset):
    """Mask and columns that start past 16-byte alignment (views of a larger
    buffer): the row-by-row mask read and the columns' element loads."""
    n = 3 * 4096 + 17
    rng = np.random.default_rng(offset)
    big_m = torch.from_numpy(rng.random(n + offset) < 0.3).to(dev)
    big_c = [torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n + offset)).to(dev),
             torch.from_numpy(rng.integers(0, 100, n + offset).astype(np.int16)).to(dev)]
    m, cols = big_m[offset:], [c[offset:] for c in big_c]
    got, count = k4.compact(m, cols)
    want, want_count = k4.compact_plain(m, cols)
    c = int(count)
    assert c == int(want_count)
    for g, w in zip(got, want):
        assert torch.equal(g[:c], w[:c])


def test_compact_more_columns_than_one_launch_holds(dev):
    m = torch.arange(10_000, device=dev) % 3 == 0
    cols = [torch.arange(10_000, device=dev) * i for i in range(20)]
    got, count = k4.compact(m, cols)
    for i, g in enumerate(got):
        assert torch.equal(g[:int(count)], cols[i][m])


def test_compact_forty_columns_of_every_width(dev):
    """40 columns of widths 1, 2, 4 and 8 (three launches of one C call, one
    count on the launch counter) over a mask of density 0.1, and no column
    at all (the count alone)."""
    n = (1 << 16) + 9
    rng = np.random.default_rng(40)
    m = torch.from_numpy(rng.random(n) < 0.1).to(dev)
    kinds = [np.int8, np.int16, np.float32, np.int64]
    cols = [torch.from_numpy(rng.integers(-100, 100, n).astype(kinds[i % 4])).to(dev)
            for i in range(40)]
    before = _build.KERNELS["compact"].launches
    got, count = k4.compact(m, cols)
    assert _build.KERNELS["compact"].launches == before + 1
    assert int(count) == int(m.sum())
    for g, c in zip(got, cols):
        assert torch.equal(g[:int(count)], c[m])
    outs, count = k4.compact(m, [])
    assert outs == [] and int(count) == int(m.sum())


def _pair_keys(bidx, pidx, npr):
    return torch.sort(bidx * npr + pidx).values


@pytest.mark.parametrize("case", ["uniform", "heavy", "no_match", "null_probe", "wide"])
def test_join_kernels_equal_plain(dev, case):
    rng = np.random.default_rng(6)
    n = 1 << 18
    if case == "uniform":
        b, p = rng.integers(0, n, n), rng.integers(0, n, n)
    elif case == "heavy":
        b = np.concatenate([np.full(512, 7), rng.integers(100, n, n)])
        p = np.concatenate([np.full(512, 7), rng.integers(100, n, n)])
    elif case == "no_match":
        b, p = rng.integers(0, n, n), rng.integers(n, 2 * n, n)
    elif case == "null_probe":
        b, p = rng.integers(0, n, n), np.full(n, -2)
    else:
        b, p = rng.integers(0, 1000, n) << 40, rng.integers(0, 1000, n) << 40
    b = torch.from_numpy(b.astype(np.int64)).to(dev)
    p = torch.from_numpy(p.astype(np.int64)).to(dev)
    before = dict(_build.KERNELS["join"].by_entry)
    got = jd.device_join_codes(b, p)
    for e in ("px_join_build", "px_join_probe", "px_join_expand"):
        assert _build.KERNELS["join"].by_entry[e] == before.get(e, 0) + 1
    want = jd.device_join_codes(b.cpu(), p.cpu())
    npr = p.shape[0]
    assert torch.equal(_pair_keys(torch.from_numpy(got[0]), torch.from_numpy(got[1]), npr),
                       _pair_keys(torch.from_numpy(want[0]), torch.from_numpy(want[1]), npr))
    assert np.array_equal(got[2], want[2]) and np.array_equal(got[3], want[3])


def test_join_stages_equal_plain(dev):
    rng = np.random.default_rng(7)
    b = torch.from_numpy(rng.integers(-1, 5000, 1 << 16)).to(dev)
    p = torch.from_numpy(rng.integers(-2, 6000, 1 << 16)).to(dev)
    K = 5000
    cnt, first, rows = jd.join_build(b, K)
    cnt0, first0, rows0 = jd.join_build_plain(b, K)
    assert torch.equal(cnt, cnt0) and torch.equal(first, first0)
    # within a code the rows come in ascending order, as the plain version's
    # stable argsort gives them; only the first sum(cnt) slots are written
    # (the -1 rows have none)
    assert torch.equal(rows[: rows0.shape[0]], rows0)
    cnt_p, lo_p, total = jd.join_probe(p, cnt, first)
    cnt_p0, lo_p0, total0 = jd.join_probe_plain(p, cnt0, first0)
    assert torch.equal(cnt_p, cnt_p0) and torch.equal(lo_p, lo_p0)
    assert int(total) == int(total0)
    # J3's pairs in order (by probe row, then ascending build row), and
    # both flags
    got = jd.join_expand(cnt_p, lo_p, rows, b.shape[0], int(total))
    want = jd.join_expand_plain(cnt_p0, lo_p0, rows0, b.shape[0], int(total0))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _j2_case(dev, case):
    """(probe codes, cnt, first) of a J2 card case."""
    rng = np.random.default_rng(12)
    K = 1 if case == "k_1" else 1 << 12
    b = torch.from_numpy(rng.integers(-1, K, 1 << 16)).to(dev)
    cnt, first, _rows = jd.join_build(b, K)
    if case.startswith("npr_"):
        p = rng.integers(-2, K + 100, int(case[4:]))
    elif case == "sentinels":
        p = np.where(rng.random(3 * 4096 + 5) < 0.5, -1, -2)
    elif case == "k_1":
        p = rng.integers(-2, 3, 4097)
    else:
        assert case == "unaligned"
        return torch.from_numpy(rng.integers(-2, K + 100, 9001)).to(dev)[1:], cnt, first
    return torch.from_numpy(p.astype(np.int64)).to(dev), cnt, first


@pytest.mark.parametrize("case", ["npr_1", "npr_3", "npr_4095", "npr_4097", "npr_4194304",
                                  "sentinels", "k_1", "unaligned"])
def test_join_probe_equals_plain(dev, case):
    """J2's count, lo and total exactly as its plain version's, and with its
    tiles, their offsets and probe_matched; one launch of px_join_probe a
    call."""
    p, cnt, first = _j2_case(dev, case)
    before = _build.KERNELS["join"].by_entry.get("px_join_probe", 0)
    got = jd.join_probe(p, cnt, first)
    tiled = jd.join_probe(p, cnt, first, tiles=True)
    assert _build.KERNELS["join"].by_entry["px_join_probe"] == before + 2
    want = jd.join_probe_plain(p, cnt, first, tiles=True)
    torch.cuda.synchronize()
    for x in (got, tiled):
        assert torch.equal(x[0], want[0]) and torch.equal(x[1], want[1])
        assert x[2].shape == () and int(x[2]) == int(want[2])
    assert torch.equal(tiled[3][0], want[3][0]) and torch.equal(tiled[3][1], want[3][1])
    if case == "sentinels":
        assert int(want[2]) == 0


@pytest.mark.parametrize("case", ["uniform", "phase", "heavy", "no_match", "total_0",
                                  "one_probe_row", "npr_ragged"])
def test_join_expand_with_and_without_the_counts_pass_equal(dev, case):
    """J3 given J2's tiles (no counts pass) and J3 counting its own tiles
    give the same pairs in the same order and the same flags, equal to the
    plain version's; device_join_codes (which passes the tiles) equals the
    stages."""
    bh, ph = _j3_case(case)
    b, p, K = jd._dense(torch.from_numpy(bh.astype(np.int64)).to(dev),
                        torch.from_numpy(ph.astype(np.int64)).to(dev))
    cnt, first, rows = jd.join_build(b, K)
    cnt_p, lo_p, total, tiles = jd.join_probe(p, cnt, first, tiles=True)
    total = int(total)
    nb = b.shape[0]
    fused = jd.join_expand(cnt_p, lo_p, rows, nb, total, tiles)
    alone = jd.join_expand(cnt_p, lo_p, rows, nb, total)
    want = jd.join_expand_plain(cnt_p, lo_p, rows, nb, total)
    torch.cuda.synchronize()
    for f, a, w in zip(fused, alone, want):
        assert torch.equal(f, w) and torch.equal(a, w)
    got = jd.device_join_codes(b, p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.cpu().numpy())


def _j3_case(case):
    """(build codes, probe codes) of a J3 card case, as numpy int64."""
    rng = np.random.default_rng(9)
    if case == "uniform":
        n = 1 << 20
        return rng.integers(0, n, n), rng.integers(0, n, n)
    if case == "phase":
        # the device join phase's shape: 2^22 a side, codes in [0, 2^20)
        return rng.integers(0, 1 << 20, 1 << 22), rng.integers(0, 1 << 20, 1 << 22)
    if case == "heavy":
        # one key with 4,096 rows a side (16M pairs) over 2^20 background rows
        bg = rng.integers(100, 1 << 22, 1 << 20)
        return (np.concatenate([np.full(4096, 7), bg]),
                np.concatenate([np.full(4096, 7), bg[::-1]]))
    if case == "no_match":
        return rng.integers(0, 1 << 16, 1 << 16), rng.integers(1 << 16, 1 << 17, 1 << 16)
    if case == "total_0":
        return rng.integers(0, 1 << 16, 1 << 16), np.full(3 * 4096 + 5, -2)
    if case == "one_row_2_20_pairs":
        p = rng.integers(1 << 21, 1 << 22, 3 * 4096)
        p[5000] = 5
        return np.full(1 << 20, 5), p
    if case == "one_probe_row":
        return rng.integers(0, 50, 5000), np.array([17])
    assert case == "npr_ragged"
    return rng.integers(0, 3000, 3 * 4096 + 77), rng.integers(0, 3000, 3 * 4096 + 77)


@pytest.mark.parametrize("case", ["uniform", "phase", "heavy", "no_match", "total_0",
                                  "one_row_2_20_pairs", "one_probe_row", "npr_ragged"])
def test_join_expand_equals_plain_in_order(dev, case):
    """J3's pairs equal the plain version's exactly and in order, and both
    matched flags, on J1's and J2's outputs on the card."""
    bh, ph = _j3_case(case)
    b, p, K = jd._dense(torch.from_numpy(bh.astype(np.int64)).to(dev),
                        torch.from_numpy(ph.astype(np.int64)).to(dev))
    cnt, first, rows = jd.join_build(b, K)
    cnt_p, lo_p, total = jd.join_probe(p, cnt, first)
    total = int(total)
    before = _build.KERNELS["join"].by_entry.get("px_join_expand", 0)
    got = jd.join_expand(cnt_p, lo_p, rows, b.shape[0], total)
    assert _build.KERNELS["join"].by_entry["px_join_expand"] == before + 1
    want = jd.join_expand_plain(cnt_p, lo_p, rows, b.shape[0], total)
    torch.cuda.synchronize()
    assert got[0].shape == (total,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if case in ("no_match", "total_0"):
        assert total == 0
    if case == "one_row_2_20_pairs":
        assert total == 1 << 20


def test_join_expand_cuda_tensor_never_reaches_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    for name in ("join_build_plain", "join_probe_plain", "join_expand_plain",
                 "probe_tiles_plain"):
        monkeypatch.setattr(jd, name, boom)
    b = torch.arange(5000, device=dev) % 300
    cnt, first, rows = jd.join_build(b, 300)
    cnt_p, lo_p, total = jd.join_probe(b, cnt, first)
    jd.join_expand(cnt_p, lo_p, rows, 5000, int(total))
    torch.cuda.synchronize()


def _j1_case(dev, case):
    """(build codes, K, the sort's passes) of a J1 card case."""
    rng = np.random.default_rng(8)
    n = (1 << 20) + 77
    if case == "one_pass":
        return rng.integers(-1, 200, n), 200, 1
    if case == "two_passes":
        return rng.integers(-1, 5000, n), 5000, 2
    if case == "three_passes":
        return rng.integers(0, 1 << 24, 1 << 22), 1 << 24, 3
    if case == "four_passes_after_dense":
        # K past 2^24 as _dense admits it: build codes up to 4 (nb + np) - 1
        nb = 1 << 22
        b = rng.integers(0, 8 * nb, nb)
        b[0] = 8 * nb - 1
        bd, _pd, K = jd._dense(torch.from_numpy(b).to(dev),
                               torch.from_numpy(rng.integers(0, 8 * nb, nb)).to(dev))
        assert K == 8 * nb > 1 << 24
        return bd.cpu().numpy(), K, 4
    if case == "all_one_code":
        return np.full(n, 12345), 1 << 20, 3
    if case == "half_one_code":
        b = rng.integers(0, 1 << 20, n)
        b[rng.random(n) < 0.5] = 777
        return b, 1 << 20, 3
    if case == "sentinels":
        b = rng.integers(0, 70000, n)
        b[rng.random(n) < 0.3] = -1
        return b, 70000, 3
    if case == "n_4095":
        return rng.integers(0, 300, 4095), 300, 2
    assert case == "n_4097"
    return rng.integers(0, 300, 4097), 300, 2


@pytest.mark.parametrize("case", ["one_pass", "two_passes", "three_passes",
                                  "four_passes_after_dense", "all_one_code", "half_one_code",
                                  "sentinels", "n_4095", "n_4097"])
def test_join_build_equals_plain_exactly(dev, case):
    bh, K, passes = _j1_case(dev, case)
    b = torch.from_numpy(np.ascontiguousarray(bh, dtype=np.int64)).to(dev)
    assert jd._build_plan(b.shape[0], K)[2] == passes
    cnt, first, rows = jd.join_build(b, K)
    cnt0, first0, rows0 = jd.join_build_plain(b, K)
    m = rows0.shape[0]
    assert torch.equal(cnt, cnt0) and torch.equal(first, first0)
    assert torch.equal(rows[:m], rows0)
    # two runs give the same bits
    again = jd.join_build(b, K)
    assert torch.equal(again[0], cnt) and torch.equal(again[1], first)
    assert torch.equal(again[2][:m], rows[:m])


def test_readback_wave_lands_in_pinned_memory_and_is_counted(dev):
    x = torch.arange(1 << 20, device=dev)
    before = dict(transfer.stats)
    h = transfer.pull_async({"x": x[: 1000], "y": [x.double()]})
    assert h.n_dev == 2
    out = h.wait()
    np.testing.assert_array_equal(out["x"], np.arange(1000))
    np.testing.assert_array_equal(out["y"][0], np.arange(1 << 20, dtype=np.float64))
    assert transfer.stats["waves"] == before["waves"] + 1
    assert transfer.stats["bytes"] == before["bytes"] + 1000 * 8 + (1 << 20) * 8
    assert transfer.h2d_bandwidth_probe(device=dev)["mbps"] > 0


def test_cuda_tensor_never_reaches_the_plain_version(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(gb, "segment_count_plain", boom)
    monkeypatch.setattr(LogHistogram, "update_plain", boom)
    for name in ("compact_plain",):
        monkeypatch.setattr(k4, name, boom)
    for name in ("join_build_plain", "join_probe_plain", "join_expand_plain",
                 "probe_tiles_plain"):
        monkeypatch.setattr(jd, name, boom)
    for name in ("fold_plain", "move_plain"):
        monkeypatch.setattr(rk, name, boom)
    monkeypatch.setattr(m1, "merge_states_plain", boom)
    _rng, gid, mask = _rows(dev, 4096, 8, 4)
    gb.masked_segment_count(gid, 8, mask)
    lh = LogHistogram()
    lh.update(lh.init(8, dev), gid, torch.ones(4096, dtype=torch.float64, device=dev), mask, 8)
    k4.compact(mask, [gid])
    codes = gid.long()
    jd.device_join_codes(codes, codes)
    bufs = rk.move([gid], 0, 4096, 8192)
    rk.fold(bufs, [[np.arange(100, dtype=np.int32)]], 4096)
    m1.merge_states("add", [gid, gid])


#: resident buffers of every element width (1, 2, 4, 8 bytes)
_RES_DTYPES = [np.uint8, np.int16, np.int32, np.float64, np.int64]


def _res_bufs(dev, rows, seed):
    rng = np.random.default_rng(seed)
    return rng, [torch.from_numpy(rng.integers(0, 100, rows).astype(dt)).to(dev)
                 for dt in _RES_DTYPES]


@pytest.mark.parametrize("off,d", [(0, 1 << 16), (1001, 4099), (1 << 16, 5), (4096, 0)])
def test_resident_fold_equals_plain(dev, off, d):
    rng, bufs = _res_bufs(dev, 1 << 18, 8)
    # each column's delta arrives in chunks, as sealed batches do
    parts = [[rng.integers(0, 100, k).astype(dt) for k in (d // 3, d - d // 3)]
             for dt in _RES_DTYPES]
    want = [b.clone() for b in bufs]
    for w, chunks in zip(want, parts):
        rk.fold_plain(w, torch.from_numpy(np.concatenate(chunks)).to(dev), off)
    before = _build.KERNELS["resident"].by_entry.get("px_resident_fold", 0)
    assert rk.fold(bufs, parts, off) == sum(d * np.dtype(dt).itemsize for dt in _RES_DTYPES)
    torch.cuda.synchronize()
    assert _build.KERNELS["resident"].by_entry.get("px_resident_fold", 0) == before + (d > 0)
    for b, w in zip(bufs, want):
        assert torch.equal(b, w)


@pytest.mark.parametrize("lo,n,dst_rows", [(0, 3000, 1 << 13), (0, 1 << 12, 1 << 12),
                                           (1 << 12, 5000, 1 << 14), (1001, 7000, 1 << 14),
                                           (0, 0, 1 << 10)])
def test_resident_move_equals_plain(dev, lo, n, dst_rows):
    _rng, srcs = _res_bufs(dev, 1 << 14, 9)
    before = _build.KERNELS["resident"].by_entry.get("px_resident_move", 0)
    got = rk.move(srcs, lo, n, dst_rows)
    torch.cuda.synchronize()
    assert _build.KERNELS["resident"].by_entry["px_resident_move"] == before + 1
    for g, s in zip(got, srcs):
        assert torch.equal(g, rk.move_plain(s, lo, n, dst_rows))


def _m1_states(dev, n, g, seed, offset=0):
    """n states of config #4's tree plus int and NaN-carrying min / max
    leaves; `offset` > 0 makes every leaf an unaligned view (scalar path)."""
    rng = np.random.default_rng(seed)
    rt = {"cnt": "add", "avg": {"sum": "add", "count": "add"}, "p50": "add",
          "lo": "min", "hi": "max", "ilo": "min", "wrap": "add", "code": "min"}

    def leaf(arr):
        t = torch.from_numpy(np.concatenate([arr.reshape(-1)[:offset], arr.reshape(-1)]))
        return t.to(dev)[offset:].view(arr.shape)

    states = []
    for _ in range(n):
        f = rng.normal(size=g)
        f[rng.integers(0, g, 2)] = np.nan
        f[rng.integers(0, g, 2)] = np.inf
        states.append({
            "cnt": leaf(rng.integers(0, 1 << 30, g)),
            "avg": {"sum": leaf(rng.normal(size=g)), "count": leaf(rng.integers(0, 99, g))},
            "p50": leaf(rng.integers(0, 1000, (g, 514)).astype(np.float32)),
            "lo": leaf(f), "hi": leaf(-f),
            "ilo": leaf(rng.integers(-(2 ** 63), 2 ** 63 - 1, g, dtype=np.int64)),
            "wrap": leaf(rng.integers(2 ** 62, 2 ** 63 - 1, g, dtype=np.int64)),
            "code": leaf(rng.integers(-(2 ** 31), 2 ** 31 - 1, g).astype(np.int32)),
        })
    return rt, states


@pytest.mark.parametrize("n,g,offset", [(2, 64, 0), (3, 1, 0), (8, 64, 0), (8, 4099, 0),
                                        (9, 1000, 0), (17, 300, 0), (8, 257, 1)])
def test_merge_states_equals_plain(dev, n, g, offset):
    rt, states = _m1_states(dev, n, g, 21 + n, offset)
    before = _build.KERNELS["merge"].launches
    got = m1.merge_states(rt, states)
    torch.cuda.synchronize()
    assert _build.KERNELS["merge"].launches == before + 1
    # one packed buffer at the merged tree's layout
    assert isinstance(got, m1.Packed) and got.buf.is_cuda
    got = got.tree()
    want = m1.merge_states_plain(rt, states)
    for path in ("cnt", "p50", "lo", "hi", "ilo", "wrap", "code"):
        a, b = got[path], want[path]
        assert a.dtype == b.dtype and torch.equal(a.isnan() if a.is_floating_point()
                                                  else a, b.isnan() if b.is_floating_point() else b)
        assert torch.equal(a.nan_to_num() if a.is_floating_point() else a,
                           b.nan_to_num() if b.is_floating_point() else b), path
    assert torch.equal(got["avg"]["count"], want["avg"]["count"])
    # float64 sums: one add per state, in agent order, in both
    assert torch.equal(got["avg"]["sum"], want["avg"]["sum"])


def test_cluster_gang_merge_launches_m1_once(dev):
    """8 agents with identical data on the card: one M1 launch per query,
    and the result equals the same cluster's CPU run."""
    from pixie_tpu_torch import flags
    from pixie_tpu_torch.parallel import LocalCluster
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    rng = np.random.default_rng(12)
    n = 1 << 14
    cols = {"time_": np.arange(n, dtype=np.int64),
            "service": np.array([f"svc-{i}" for i in range(16)])[rng.integers(0, 16, n)],
            "latency": rng.exponential(50.0, n),
            "status": rng.choice([200, 404, 500], n)}
    rel = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                      ("latency", DT.FLOAT64), ("status", DT.INT64))

    def stores():
        out = {}
        for a in range(8):
            ts = TableStore()
            ts.create("http_events", rel, batch_rows=4096).write(cols)
            out[f"pem{a}"] = ts
        return out

    script = """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(df, 'output')
"""
    pulls = []
    real_pull = transfer.pull_states

    def pull_states(states):
        leaves0 = transfer.stats["leaves"]
        out = real_pull(states)
        pulls.append((states, transfer.stats["leaves"] - leaves0))
        return out

    saved = flags.get("PL_MATVIEW_ENABLED")
    flags.set_for_testing("PL_MATVIEW_ENABLED", False)  # the rescan route
    try:
        cluster = LocalCluster(stores(), device=dev)
        cluster.query(script)  # warm: tier admission, the plan cache
        torch.cuda.synchronize()
        _build.reset_launches()
        transfer.pull_states = pull_states
        try:
            got = cluster.query(script)["output"].to_pandas()
        finally:
            transfer.pull_states = real_pull
        want = LocalCluster(stores(), device="cpu").query(script)["output"].to_pandas()
    finally:
        flags.set_for_testing("PL_MATVIEW_ENABLED", saved)
    assert _build.KERNELS["merge"].launches == 1
    # the merged state is M1's packed buffer: no P1, one copy
    assert _build.KERNELS["pack"].launches == 0
    assert len(pulls) == 1 and len(pulls[0][0]) == 1
    assert isinstance(pulls[0][0][0], m1.Packed) and pulls[0][1] == 1
    got, want = (f.sort_values(["service", "status"]).reset_index(drop=True)
                 for f in (got, want))
    assert got.cnt.tolist() == want.cnt.tolist() and got.p50.tolist() == want.p50.tolist()
    np.testing.assert_allclose(got.avg_lat, want.avg_lat, rtol=1e-12, atol=0)


# ------------------------------------------------------------ KM1-KM3


def _km_data(dev, n, d, k, seed, spread=10.0):
    rng = np.random.default_rng(seed)
    cent = rng.normal(0, spread, (k, d)).astype(np.float32)
    x = cent[rng.integers(0, k, n)] + rng.normal(0, 1, (n, d)).astype(np.float32)
    c = x[rng.choice(n, k, replace=n < k)] + 0.25
    return (torch.from_numpy(x).to(dev), torch.from_numpy(c.astype(np.float32)).to(dev),
            torch.from_numpy((rng.random(n) + 0.5).astype(np.float32)).to(dev))


def _scale(x, c):
    """|x|^2 + max |c|^2 per point: the expansion's rounding is relative to it."""
    return (x * x).sum(1) + (c * c).sum(1).max()


#: (n, d, k): the fit's shape at test size, k = 1, more centers than a
#: block's points, d not a multiple of 4, n not a multiple of the block,
#: d over one shared-memory tile, k over one register tile, and each side of
#: where the center tile (8, 32, 64) and the column chunk (64) turn
_KM_SHAPES = [(1 << 16, 64, 64), (5000, 16, 1), (4099, 8, 300), (3001, 13, 7),
              (1, 3, 1), (2000, 150, 200), (10000, 64, 129), (4099, 64, 8), (4099, 64, 9),
              (4099, 64, 32), (4099, 64, 33), (4099, 64, 65), (3001, 64, 64), (3001, 65, 64)]


@pytest.mark.parametrize("n,d,k", _KM_SHAPES)
def test_kmeans_assign_equals_plain(dev, n, d, k):
    x, c, _w = _km_data(dev, n, d, k, 31)
    before = _build.KERNELS["kmeans"].by_entry.get("px_kmeans_assign", 0)
    ids, mind = km_ops.assign(x, c)
    torch.cuda.synchronize()
    assert _build.KERNELS["kmeans"].by_entry["px_kmeans_assign"] == before + 1
    ids0, mind0 = km_ops.assign_plain(x, c)
    scale = _scale(x, c)
    assert torch.all((mind - mind0).abs() <= 1e-5 * scale)
    # ids equal except where the two nearest distances are within 1e-5
    d_all = km_ops.sq_dists_plain(x, c)
    two = torch.topk(d_all, min(2, k), dim=1, largest=False).values
    gap = (two[:, -1] - two[:, 0]) if k > 1 else torch.full_like(mind0, float("inf"))
    tie = gap <= 1e-5 * scale
    assert torch.equal(ids[~tie], ids0[~tie])


@pytest.mark.parametrize("n,d,k", _KM_SHAPES)
def test_kmeans_lloyd_step_equals_plain(dev, n, d, k):
    x, c, w = _km_data(dev, n, d, k, 32)
    ones = torch.ones_like(w)
    wsum, xsum = km_ops.lloyd_step(x, ones, c)
    wsum0, xsum0 = km_ops.lloyd_step_plain(x, ones, c)
    ids0, _ = km_ops.assign_plain(x, c)
    assert torch.equal(wsum, wsum0)  # unit weights: exact counts
    absx = torch.zeros_like(xsum0).index_add_(0, ids0, x.abs())
    assert torch.all((xsum - xsum0).abs() <= 1e-5 * absx + 1e-6)
    wsum, xsum = km_ops.lloyd_step(x, w, c)
    wsum0, xsum0 = km_ops.lloyd_step_plain(x, w, c)
    absx = torch.zeros_like(xsum0).index_add_(0, ids0, (x * w[:, None]).abs())
    assert torch.all((wsum - wsum0).abs() <= 1e-6 * wsum0)
    assert torch.all((xsum - xsum0).abs() <= 1e-5 * absx + 1e-6)


def test_kmeans_lloyd_step_is_reproducible(dev):
    x, c, w = _km_data(dev, 1 << 18, 64, 64, 33)
    a = km_ops.lloyd_step(x, w, c)
    b = km_ops.lloyd_step(x, w, c)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_kmeans_zero_weight_cluster_keeps_its_center(dev):
    from pixie_tpu_torch.ml import kmeans as km

    x, c, w = _km_data(dev, 4096, 12, 6, 34)
    ids, _ = km_ops.assign(x, c)
    w = torch.where(ids == 2, 0.0, w)
    wsum, _xsum = km_ops.lloyd_step(x, w, c)
    assert float(wsum[2]) == 0.0
    newc = km._lloyd_centers(x, w, c, 1)
    assert torch.equal(newc[2], c[2])


@pytest.mark.parametrize("n,d", [(1 << 16, 64), (3001, 13), (1, 4), (4097, 150)])
def test_kmeans_seed_step_equals_plain(dev, n, d):
    x, c, w = _km_data(dev, n, d, 4, 35)
    mind = torch.full((n,), float("inf"), device=dev)
    mind0 = mind.clone()
    for j in range(c.shape[0]):
        p = km_ops.seed_step(x, w, c[j], mind)
        p0 = km_ops.seed_step_plain(x, w, c[j], mind0)
        scale = (x * x).sum(1) + (c[j] * c[j]).sum()
        assert torch.all((mind - mind0).abs() <= 1e-5 * scale)
        assert torch.all((p - p0).abs() <= 1e-5 * scale * w)


def test_kmeans_fit_on_the_card_is_deterministic_and_counts_launches(dev):
    from pixie_tpu_torch.ml import kmeans_fit

    x, _c, w = _km_data(dev, 1 << 20, 64, 16, 36, spread=300.0)
    _build.reset_launches()
    a = kmeans_fit(x, 16, weights=w, seed=5, device=dev)
    by = dict(_build.KERNELS["kmeans"].by_entry)
    assert by == {"px_kmeans_seed_step": 15, "px_kmeans_lloyd": 10, "px_kmeans_assign": 1}
    b = kmeans_fit(x, 16, weights=w, seed=5, device=dev)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def _nan_close(got, want, scale, rtol):
    """NaN in the same places, and |got - want| <= rtol * scale elsewhere."""
    assert torch.equal(got.isnan(), want.isnan())
    keep = ~want.isnan() & torch.isfinite(scale)
    assert torch.all((got - want).abs()[keep] <= rtol * scale[keep] + 1e-6)


def _km_edge(dev, case):
    """KM2's and KM3's new edges: n one short of and one past KM2's tile, a
    tile past every block of the capped grid, every point on one center,
    rows holding NaN, rows not 16-byte aligned, and a k whose norms alone
    would fill a block's shared memory.  The tile and the capped grid are
    the kernel's own plan's."""
    plan = km_ops._lloyd_plan(dev.index, 1 << 20, 64, 64)
    grid, tile = plan[2], plan[4]
    if case == "short":
        return _km_data(dev, tile - 1, 64, 64, 50)
    if case == "past":
        return _km_data(dev, tile + 1, 64, 64, 51)
    if case == "past_k8":
        return _km_data(dev, tile + 1, 64, 8, 52)
    if case == "capped_grid":
        assert grid * tile < 1 << 20
        return _km_data(dev, grid * tile + 1, 64, 64, 53)
    if case == "big_k":
        # 40,000 blobs, the centers theirs moved by N(0, 0.25): every point
        # far nearer its own center than any other
        rng = np.random.default_rng(62)
        cent = rng.normal(0, 10, (40000, 64)).astype(np.float32)
        x = cent[rng.integers(0, 40000, 4099)] + rng.normal(0, 1, (4099, 64))
        c = cent + rng.normal(0, 0.5, cent.shape)
        return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                     for a in (x, c, rng.random(4099) + 0.5))
    if case == "skew":
        x, c, w = _km_data(dev, 1 << 14, 64, 64, 54)
        g = torch.Generator(device=dev).manual_seed(55)
        return (c[5] + 0.1 * torch.randn(x.shape, generator=g, device=dev)).contiguous(), c, w
    if case in ("nan", "nan_d13"):
        x, c, w = _km_data(dev, 4099, 64 if case == "nan" else 13, 64 if case == "nan" else 7,
                           56)
        x[::97, 3] = float("nan")
        x[5] = float("nan")
        return x, c, w
    assert case == "unaligned"
    x, c, w = _km_data(dev, 3001, 64, 64, 57)
    flat = torch.empty(x.numel() + 1, device=dev)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape), c, w


_KM_EDGES = ["short", "past", "past_k8", "capped_grid", "skew", "nan", "nan_d13", "unaligned",
             "big_k"]


@pytest.mark.parametrize("case", _KM_EDGES)
def test_kmeans_assign_edges_equal_plain(dev, case):
    x, c, _w = _km_edge(dev, case)
    ids, mind = km_ops.assign(x, c)
    ids0, mind0 = km_ops.assign_plain(x, c)
    scale = _scale(x, c)
    _nan_close(mind, mind0, scale, 1e-5)
    # ids equal except where the two nearest distances are within 1e-5 of
    # the scale (a row of NaN takes the first center on both)
    two = torch.topk(km_ops.sq_dists_plain(x, c), 2, dim=1, largest=False).values
    tie = (two[:, 1] - two[:, 0]) <= 1e-5 * scale
    assert torch.equal(ids[~tie], ids0[~tie])


@pytest.mark.parametrize("case", _KM_EDGES)
def test_kmeans_lloyd_step_edges_equal_plain(dev, case):
    x, c, w = _km_edge(dev, case)
    k = c.shape[0]
    ids, _ = km_ops.assign(x, c)
    ids0, _ = km_ops.assign_plain(x, c)
    ones = torch.ones_like(w)
    wsum, _xsum = km_ops.lloyd_step(x, ones, c)
    # KM2's assignment is KM1's, bit for bit: unit weights count KM1's ids
    assert torch.equal(wsum, torch.bincount(ids, minlength=k).float())
    wsum, xsum = km_ops.lloyd_step(x, w, c)
    wsum0, xsum0 = km_ops.lloyd_step_plain(x, w, c)
    absx = torch.zeros_like(xsum0).index_add_(0, ids0, (x * w[:, None]).abs())
    _nan_close(wsum, wsum0, wsum0.abs(), 1e-6)
    _nan_close(xsum, xsum0, absx, 1e-5)


@pytest.mark.parametrize("case", _KM_EDGES)
def test_kmeans_seed_step_edges_equal_plain(dev, case):
    x, c, w = _km_edge(dev, case)
    n = x.shape[0]
    mind = torch.full((n,), float("inf"), device=dev)
    mind0 = mind.clone()
    for j in range(3):
        p = km_ops.seed_step(x, w, c[j], mind)
        p0 = km_ops.seed_step_plain(x, w, c[j], mind0)
        scale = (x * x).sum(1) + (c[j] * c[j]).sum()
        _nan_close(mind, mind0, scale, 1e-5)
        _nan_close(p, p0, scale * w, 1e-5)
        assert torch.all(torch.isfinite(p))


def test_kmeans_lloyd_step_same_bits_over_5_calls(dev):
    x, c, w = _km_data(dev, 1 << 20, 64, 64, 58)
    first = km_ops.lloyd_step(x, w, c)
    for _ in range(4):
        again = km_ops.lloyd_step(x, w, c)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.parametrize("n,d,k", [(1, 3, 1), (127, 64, 64), (129, 64, 8), (1 << 20, 64, 64),
                                   (3001, 150, 200), (10000, 64, 129), (4099, 64, 40000)])
def test_kmeans_lloyd_plan_sizes_its_scratch(dev, n, d, k):
    elems, tickets, grid, rows, tile = km_ops._lloyd_plan(dev.index, n, d, k)
    groups = -(-grid // 16)
    # the grid is fixed by n and the card: the tiles, capped where n is large
    cap = km_ops._lloyd_plan(dev.index, 1 << 30, d, k)[2]
    assert grid == min(-(-n // tile), cap) and cap < (1 << 30) // tile
    assert tickets == groups + 1
    assert elems == (grid + (groups if groups > 1 else 0)) * rows * (d + 1)
    # registers hold every center's sums at k <= 64, d <= 64; shared memory
    # a range of them, as many as fit beside a fixed part that does not
    # grow with k
    if k <= 64 and d <= 64:
        assert rows == k
    else:
        assert 0 < rows <= k
        if rows < k:
            assert km_ops._lloyd_plan(dev.index, n, d, 4 * k)[3] == rows


def test_kmeans_lloyd_repeat_call_reuses_its_scratch(dev):
    x, c, w = _km_data(dev, 1 << 16, 64, 64, 60)
    km_ops.lloyd_step(x, w, c)
    key = (dev.type, dev.index, _build.raw_stream(dev.index))
    held = km_ops._SCRATCH[key]
    hits = km_ops._lloyd_plan.cache_info().hits
    km_ops.lloyd_step(x, w, c)
    assert km_ops._SCRATCH[key] is held
    assert km_ops._lloyd_plan.cache_info().hits == hits + 1
    assert int(held[1].abs().sum()) == 0  # every launch leaves its tickets 0


def test_kmeans_lloyd_on_another_stream_has_its_own_tickets(dev):
    x, c, w = _km_data(dev, 1 << 18, 64, 64, 61)
    want = km_ops.lloyd_step(x, w, c)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = km_ops.lloyd_step(x, w, c)
        other = km_ops.lloyd_step(x, w, c)
    torch.cuda.synchronize(dev)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(other[1], want[1])
    main_key = (dev.type, dev.index, _build.raw_stream(dev.index))
    assert km_ops._SCRATCH[(dev.type, dev.index, side.cuda_stream)][1].data_ptr() != \
        km_ops._SCRATCH[main_key][1].data_ptr()


def test_kmeans_cuda_tensor_never_reaches_the_plain_versions(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called on a CUDA tensor")

    for name in ("sq_dists_plain", "assign_plain", "lloyd_step_plain", "seed_step_plain"):
        monkeypatch.setattr(km_ops, name, boom)
    x, c, w = _km_data(dev, 1000, 8, 3, 37)
    km_ops.assign(x, c)
    km_ops.lloyd_step(x, w, c)
    km_ops.seed_step(x, w, c[0], torch.full((1000,), float("inf"), device=dev))


# ---------------------------------------------------------------- C1 (chain)

from pixie_tpu_torch.ops import chain as c1  # noqa: E402

_I64_EDGES = np.array([np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1, 1, -7, 7,
                       2, -2, 3, 10 ** 12, -(10 ** 12)], dtype=np.int64)
_F64_EDGES = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, 1.5, 2.5, -0.5, -2.5,
                       1e-300, 1e300, -7.25, 3.0, 1e-9, 2.0 ** 53 + 1], dtype=np.float64)


def c1_column(kind, n, rng):
    """n values of `kind` with the edge values at the front, the rest random
    (so every edge meets every other edge across the two operands)."""
    if kind == c1.B:
        return rng.random(n) < 0.5
    if kind == c1.F64:
        v = rng.normal(0, 100, n)
        v[: len(_F64_EDGES)] = _F64_EDGES
        v[len(_F64_EDGES): 2 * len(_F64_EDGES)] = rng.permutation(_F64_EDGES)
        return v
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    v[: len(_I64_EDGES)] = _I64_EDGES
    v[len(_I64_EDGES): 2 * len(_I64_EDGES)] = rng.permutation(_I64_EDGES)
    return v


def c1_same(got, want) -> bool:
    """Bit for bit (a NaN equals a NaN: the payload is not compared)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if got.dtype == torch.float64:
        both_nan = torch.isnan(got) & torch.isnan(want)
        return bool(torch.all(both_nan | (got.view(torch.int64) == want.view(torch.int64))))
    return torch.equal(got, want)


_I, _F, _B = c1.I64, c1.F64, c1.B
C1_OP_CASES = (
    [(op, k) for op in ("add", "subtract", "multiply", "modulo", "floordiv", "divide", "pow",
                        "eq", "ne", "lt", "le", "gt", "ge")
     for k in ((_I, _I), (_F, _F), (_I, _F), (_F, _I))]
    + [(op, (k,)) for op in ("abs", "negate", "log", "log2", "log10", "exp", "sqrt", "ceil",
                             "floor", "round", "invert", "identity") for k in (_I, _F)]
    + [("bin", (_I, _I)), ("approx_eq", (_F, _F)), ("eq", (_B, _B)), ("ne", (_B, _B)),
       ("and", (_B, _B)), ("or", (_B, _B)), ("not", (_B,)),
       ("select", (_B, _I, _I)), ("select", (_B, _F, _F)), ("select", (_B, _B, _B))])


@pytest.mark.parametrize("op,kinds", C1_OP_CASES)
@pytest.mark.parametrize("const_b", [False, True])
def test_chain_opcode_equals_plain(dev, op, kinds, const_b):
    """Every `_dev` opcode: C1 against the plain interpreter on the same
    CUDA columns (edge values included), bit for bit."""
    rng = np.random.default_rng(zlib.crc32(repr((op, kinds)).encode()))
    n = 4099
    consts = None
    if const_b and len(kinds) > 1:
        consts = [None] * len(kinds)
        consts[-1] = {_I: -3, _F: -2.5, _B: True}[kinds[-1]]
    prog, bnd = c1.op_program(op, list(kinds), consts)
    cols = [torch.from_numpy(c1_column(k, n, rng)).to(dev)
            for i, k in enumerate(kinds) if f"a{i}" in bnd.cols]
    before = _build.KERNELS["chain"].launches
    _m, _g, got = c1.run(prog, cols, [], [], n, dev)
    assert _build.KERNELS["chain"].launches == before + 1
    _m, _g, want = c1.run_plain(prog, cols, [], [], n, dev)
    assert c1_same(got[0], want[0]), (op, kinds, prog.listing())


def test_chain_structural_opcodes_equal_plain(dev):
    """LUT gathers (codes < 0, past the end, an empty LUT), a bounded
    domain, a code pair, a sorted search, the window key with a runtime
    origin, the group-id combine and the mask with n_valid < n."""
    rng = np.random.default_rng(5)
    n = 70_001
    codes = torch.from_numpy(rng.integers(-2, 40, n).astype(np.int32)).to(dev)
    codes2 = torch.from_numpy(rng.integers(-1, 9, n).astype(np.int32)).to(dev)
    t = torch.from_numpy(rng.integers(-(10 ** 12), 10 ** 12, n).astype(np.int64)).to(dev)
    t[:3] = torch.tensor([np.iinfo(np.int64).min, -1, 0])
    luts = {"f": torch.from_numpy(rng.normal(0, 1, 32)).to(dev),
            "s": torch.from_numpy(rng.integers(0, 5, 32).astype(np.int32)).to(dev),
            "e": torch.zeros(0, dtype=torch.bool, device=dev),
            "p": torch.from_numpy(rng.random(40 * 9) < 0.5).to(dev),
            "u": torch.from_numpy(np.unique(rng.integers(-1000, 1000, 300))).to(dev),
            "d": torch.from_numpy(rng.integers(0, 99, 500).astype(np.int64)).to(dev)}
    b = c1.ProgramBuilder()
    b.row(); b.scalar("n_valid"); b.op("LT_I"); b.mask_and()
    b.col("c", c1.I32); b.lut("f", c1.F64, 0.0); b.store()
    b.col("c", c1.I32); b.lut("s", c1.I32, -1); b.store()
    b.col("c", c1.I32); b.lut("e", c1.B, False); b.store()
    b.col("c", c1.I32); b.col("c2", c1.I32); b.pair(9); b.lut("p", c1.B, False); b.store()
    b.col("t", c1.I64); b.lut_domain("d", c1.I64, 100, 599, -5); b.store()
    b.col("t", c1.I64); b.search("u"); b.store()
    b.col("t", c1.I64); b.window(10 ** 10, "origin"); b.store()
    b.col("c", c1.I32); b.dup(); b.const(0, c1.I64); b.op("GE_I"); b.mask_and(); b.combine(64)
    b.col("c2", c1.I32); b.combine(16)
    prog, bnd = b.finish(has_gid=True)
    cols = {"c": codes, "c2": codes2, "t": t}
    args = ([cols[k] for k in bnd.cols], [luts[k] for k in bnd.luts])
    for origin in (0, -123, 77):
        scal = {"n_valid": n - 17, "origin": origin}
        sc = [scal[k] for k in bnd.scalars]
        got = c1.run(prog, *args, sc, n, dev)
        want = c1.run_plain(prog, *args, sc, n, dev)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        for g, w in zip(got[2], want[2]):
            assert c1_same(g, w)


def test_chain_kernel_on_the_card_equals_cpu_route(dev):
    """A chain with two limits, a string predicate and a computed float
    column through the executor: the card's result equals the CPU's, and
    C1 ran on the card."""
    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.plan import (Call, Column, FilterOp, LimitOp, MapOp, MemorySinkOp,
                                      MemorySourceOp, Plan, lit)
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    rng = np.random.default_rng(8)
    ts = TableStore()
    t = ts.create("t", Relation.of(("time_", DT.TIME64NS), ("svc", DT.STRING),
                                   ("lat", DT.FLOAT64), ("st", DT.INT64)), batch_rows=4096)
    n = 50_000
    t.write({"time_": np.arange(n, dtype=np.int64), "svc": rng.choice(["a", "b", "c"], n),
             "lat": rng.exponential(5.0, n), "st": rng.choice([200, 404, 500], n)})
    p = Plan()
    node = p.add(MemorySourceOp(table="t"))
    node = p.add(FilterOp(expr=Call("not_equal", (Column("svc"), lit("b")))), parents=[node])
    node = p.add(LimitOp(n=20_000), parents=[node])
    node = p.add(MapOp(exprs=[("svc", Column("svc")), ("st", Column("st")),
                              ("x", Call("multiply", (Column("lat"), lit(2.5))))]),
                 parents=[node])
    node = p.add(FilterOp(expr=Call("equal", (Column("st"), lit(500)))), parents=[node])
    node = p.add(LimitOp(n=1000), parents=[node])
    p.add(MemorySinkOp(name="out"), parents=[node])
    before = _build.KERNELS["chain"].launches
    got = execute_plan(p, ts, device=dev)["out"]
    assert _build.KERNELS["chain"].launches > before
    assert got.exec_stats["chain_leaves"] == 0
    want = execute_plan(p, ts, device="cpu")["out"]
    for k in ("svc", "st", "x"):
        assert np.array_equal(got.columns[k], want.columns[k])


_DIVISORS = [1, 2, 3, 7, 10 ** 10, 2 ** 32 + 1, 2 ** 40, 2 ** 62, 2 ** 63 - 1, 0, -1, -3,
             -(2 ** 63)]


@pytest.mark.parametrize("op", ["floordiv", "modulo", "bin"])
@pytest.mark.parametrize("d", _DIVISORS)
def test_chain_division_by_a_constant_equals_plain(dev, op, d):
    """FDIV_I, MOD_I and BIN_I by a constant (the multiply-high for d >= 1,
    the plain division below): C1 equals the plain interpreter on every
    int64 edge dividend, negative and INT64_MIN included."""
    prog, bnd = c1.op_program(op, [c1.I64, c1.I64], [None, d])
    rng = np.random.default_rng(abs(d) % 1000)
    x = rng.integers(-(2 ** 63), 2 ** 63 - 1, 1 << 16, dtype=np.int64)
    edges = [v for v in (-(2 ** 63), -(2 ** 63) + 1, -d - 1, -d, -d + 1, -1, 0, 1, d - 1, d,
                         d + 1, 2 ** 63 - 1) if -(2 ** 63) <= v < 2 ** 63]
    x[: len(edges)] = edges
    cols = [torch.from_numpy(x).to(dev)]
    _m, _g, got = c1.run(prog, cols, [], [], x.shape[0], dev)
    _m, _g, want = c1.run_plain(prog, cols, [], [], x.shape[0], dev)
    assert torch.equal(got[0], want[0]), (op, d)


@pytest.mark.parametrize("cmp", ["EQ", "NE", "LT", "LE", "GT", "GE"])
@pytest.mark.parametrize("kind", [c1.I64, c1.F64, c1.I32, c1.B])
@pytest.mark.parametrize("offset", [0, 1])
def test_chain_fused_instructions_equal_plain(dev, cmp, kind, offset):
    """MASK_CMP (the compare against a constant, and for integers a second
    against a scalar, and the row bound), the same compare as a binary op
    with an immediate, DICT_KEY, a bool column into the mask, SEARCH over a
    short LUT (a count) and a long one (a binary search), WINDOW by a width
    past 2^32, more columns than CACHE holds, and a feed that ends mid-tile;
    with offset 1 every column starts one value past 16-byte alignment, so
    the interpreter takes its one-value loads and stores."""
    rng = np.random.default_rng(31 + kind + 10 * offset)
    n = 3 * 2048 + 123
    pad = n + offset

    def column(k, lo=-50, hi=50):
        if k == c1.F64:
            v = rng.normal(0, 40, pad)
            v[offset: offset + 6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 3.0]
            return torch.from_numpy(v).to(dev)[offset:]
        if k == c1.B:
            return torch.from_numpy(rng.random(pad) < 0.7).to(dev)[offset:]
        dt = np.int32 if k == c1.I32 else np.int64
        v = rng.integers(lo, hi, pad).astype(dt)
        v[offset: offset + 3] = [7, -7, 0]
        if k == c1.I64:
            v[offset + 3: offset + 5] = [-(2 ** 63), 2 ** 63 - 1]
        return torch.from_numpy(v).to(dev)[offset:]

    cols = {"x": column(kind), "y": column(c1.I64), "code": column(c1.I32, -3, 20),
            "t": column(c1.I64, -(10 ** 12), 10 ** 12), "b": column(c1.B)}
    lit = {c1.F64: 3.0, c1.B: True}.get(kind, 7)
    op = cmp + ("_F" if kind == c1.F64 else "_I")
    luts = {"short": torch.tensor([-20, 0, 7, 9, 30], dtype=torch.int64, device=dev),
            "long": torch.arange(-40, 40, 3, dtype=torch.int64, device=dev)}
    b = c1.ProgramBuilder()
    b.row(); b.scalar("n_valid"); b.op("LT_I"); b.mask_and()
    b.col("x", kind); b.const(lit, kind); b.op(op); b.store()
    b.col("x", kind); b.const(lit, kind); b.op(op); b.mask_and()
    if kind in (c1.I64, c1.I32):
        b.col("x", kind); b.scalar("s"); b.op(op); b.store()
    b.col("b", c1.B); b.mask_and()
    b.col("code", c1.I32); b.dup(); b.const(0, c1.I64); b.op("GE_I"); b.mask_and()
    b.combine(16)
    b.col("t", c1.I64); b.window(10 ** 10, "origin"); b.combine(256)
    b.col("y", c1.I64); b.search("short"); b.store()
    b.col("y", c1.I64); b.search("long"); b.store()
    prog, bnd = b.finish(has_gid=True)
    names = [c1.OPS[i[0]] for i in prog.code]
    assert {"MASK_CMP", "DICT_KEY", "CACHE"} <= set(names) and len(bnd.cols) > c1.LOCALS
    scal = {"n_valid": n - 77, "s": 5, "origin": -3}
    args = ([cols[k] for k in bnd.cols], [luts[k] for k in bnd.luts],
            [scal[k] for k in bnd.scalars], n, dev)
    before = _build.KERNELS["chain"].launches
    got = c1.run(prog, *args)
    assert _build.KERNELS["chain"].launches == before + 1
    want = c1.run_plain(prog, *args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for g, w in zip(got[2], want[2]):
        assert c1_same(g, w)


@pytest.mark.parametrize("idx", range(4))
def test_chain_smoke_chains_equal_plain(dev, idx, monkeypatch):
    """chip_smoke's four chains (config #1's, config #2's, the select's,
    two limits) at a feed of 2^20 + 37 rows: C1 equals the plain
    interpreter on the same CUDA columns, with n_valid < n."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "FEED", (1 << 20) + 37)
    label, kern, cols, luts, scalars, limits, _p = chip_smoke.chain_programs(dev)[idx]
    n = chip_smoke.FEED

    def run(runner):
        lim = None if limits is None else limits.clone()
        return kern.run_segments(kern.segments, cols, n, n - 999, -(2 ** 63), 2 ** 63 - 1,
                                 lim, luts, scalars, runner=runner)

    got, want = run(c1.run), run(c1.run_plain)
    for g, w in zip((got[0], got[1], got[3], *got[2]), (want[0], want[1], want[3], *want[2])):
        assert (g is None and w is None) or c1_same(g, w), label


def test_chain_cuda_tensor_never_reaches_the_plain_interpreter(dev, monkeypatch):
    prog, bnd = c1.op_program("add", [c1.I64, c1.I64])
    x = torch.arange(10, device=dev)

    def boom(*a, **k):
        raise AssertionError("plain interpreter reached with CUDA tensors")

    monkeypatch.setattr(c1, "run_plain", boom)
    _m, _g, (out,) = c1.run(prog, [x, x], [], [], 10, dev)
    assert torch.equal(out, 2 * x)


# ------------------------------------------------------------------ G1 (gang)

from pixie_tpu_torch.ops import gang as g1  # noqa: E402

_G1_LEAVES = [  # (op, state dtype, value column)
    ("count", torch.int64, None), ("sum", torch.int64, "i64"), ("sum", torch.int64, "b"),
    ("sum", torch.float64, "pos"), ("sum", torch.float64, "posint"),
    ("sum", torch.float64, 0), ("sumsq", torch.float64, "pos"),
    ("min", torch.int32, "i32"), ("max", torch.int32, "i32"),
    ("min", torch.int64, "i64"), ("max", torch.int64, "i64"), ("min", torch.int64, "b"),
    ("min", torch.float64, "edge"), ("max", torch.float64, "edge"),
    ("hist", torch.float32, "edge"), ("hist", torch.float32, 0)]


def _g1_members(dev, n, groups, seed, n_valid, all_false):
    """Two gang members over one feed of n rows, of groups[0] and groups[1]
    groups, with a leaf of every op and state dtype between them, and
    states started away from their identities, as after earlier feeds."""
    rng = np.random.default_rng(seed)
    edge = rng.exponential(50.0, n)
    edge[:len(_F64_EDGES)] = _F64_EDGES
    edge[rng.random(n) < 0.001] = np.nan
    cols = {"code": rng.integers(-1, 97, n).astype(np.int32),
            "code2": rng.integers(0, 1 << 14, n).astype(np.int32),
            "st": rng.choice([200, 404, 500], n).astype(np.int64),
            "i64": rng.integers(-(2 ** 62), 2 ** 62, n).astype(np.int64),
            "i32": rng.integers(-(2 ** 31), 2 ** 31 - 1, n).astype(np.int32),
            "b": rng.random(n) < 0.3,
            "pos": rng.exponential(20.0, n),
            "posint": rng.integers(0, 10 ** 6, n).astype(np.int64),
            "edge": edge}
    if all_false:
        cols["st"][:] = 404
    cols = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    sk = LogHistogram()
    hists = [lf for lf in _G1_LEAVES if lf[0] == "hist"]
    members = []
    for m, g in enumerate(groups):
        b = c1.ProgramBuilder()
        b.row(); b.scalar("n_valid"); b.op("LT_I"); b.mask_and()
        b.col("st", c1.I64); b.const(404, c1.I64); b.op("NE_I"); b.mask_and()
        b.col("code", c1.I32); b.dup(); b.const(0, c1.I64); b.op("GE_I"); b.mask_and()
        b.combine(min(g, 64))
        if g > 64:
            b.col("code2", c1.I32); b.combine(g // 64)
        b.col("pos", c1.F64); b.const(1.5 + m, c1.F64); b.op("MUL_F"); b.store()
        prog, bnd = b.finish(has_gid=True)
        leaves = []
        # one sketch a member: two [8, 514] sketches fit a block's budget
        for op, dt, v in [lf for lf in _G1_LEAVES if lf[0] != "hist"] + [hists[m]]:
            shape = (g, sk.width) if op == "hist" else (g,)
            if op in ("min", "max"):
                info = torch.finfo(dt) if dt.is_floating_point else torch.iinfo(dt)
                state = torch.full(shape, info.max if op == "min" else info.min, dtype=dt,
                                   device=dev)
                state[::3] = torch.tensor(rng.integers(-1000, 1000, state[::3].shape[0]),
                                          dtype=dt, device=dev)
            elif op == "hist":
                state = torch.from_numpy(rng.integers(0, 5, shape).astype(np.float32)).to(dev)
            else:
                state = torch.from_numpy(rng.integers(0, 100, shape)).to(dt).to(dev)
            value = cols[v] if isinstance(v, str) else v
            leaves.append(g1.Leaf(op, state, value, sk if op == "hist" else None))
        members.append(g1.Member(prog, [cols[k] for k in bnd.cols], [],
                                 [n_valid], g, leaves))
    return members


def _g1_clone(members):
    return [g1.Member(m.prog, m.cols, m.luts, m.scalars, m.num_groups,
                      [g1.Leaf(lf.op, lf.state.clone(), lf.value, lf.sketch)
                       for lf in m.leaves]) for m in members]


@pytest.mark.parametrize("groups", [(8, 8), (1 << 20, 1 << 20), (8, 1 << 20)],
                         ids=["shared", "global", "mixed"])
@pytest.mark.parametrize("case", ["all", "n_valid", "all_false"])
def test_gang_equals_plain(dev, groups, case):
    """G1 against its plain version on the same CUDA tensors, for every leaf
    op and state dtype, with private accumulators in shared memory (8
    groups), with global atomics (2^20 groups) and both in one launch:
    counts, int64 sums, min, max and sketch cells exactly, float64 sums to
    rtol 1e-12 (positive values: no cancellation)."""
    n = 300_001
    n_valid = n - 4321 if case == "n_valid" else n
    members = _g1_members(dev, n, groups, 11, n_valid, case == "all_false")
    offs, _acc = g1.plan_shared(members)
    assert [o is None for o in offs] == [g > 64 for g in groups]
    got, want = _g1_clone(members), _g1_clone(members)
    before = _build.KERNELS["gang"].launches
    g1.run(got, n, dev)
    assert _build.KERNELS["gang"].launches == before + 1
    g1.run_plain(want, n, dev)
    torch.cuda.synchronize()
    for m_got, m_want, m0 in zip(got, want, members):
        for lg, lw, l0 in zip(m_got.leaves, m_want.leaves, m0.leaves):
            what = (lg.op, lg.state.dtype, m_got.num_groups, case)
            if lg.state.dtype == torch.float64 and lg.op in ("sum", "sumsq"):
                assert torch.allclose(lg.state, lw.state, rtol=1e-12, atol=0), what
            else:
                assert torch.equal(lg.state, lw.state) or (
                    lg.state.dtype == torch.float64
                    and c1_same(lg.state, lw.state)), what
            if case == "all_false":
                assert c1_same(lg.state, l0.state), what


@pytest.mark.parametrize("nan_bin", [0, 1])
def test_gang_nan_bin_equals_plain(dev, nan_bin):
    """G1's sketch leaves over a column with NaN values bin each NaN at the
    leaf's `nan_bin`, as the plain version does, private (8 groups) and on
    global atomics (2^20 groups)."""
    n = 200_003
    members = _g1_members(dev, n, (8, 1 << 20), 13, n, False)
    for m in members:
        for lf in m.leaves:
            lf.nan_bin = nan_bin
    got, want = _g1_clone(members), _g1_clone(members)
    g1.run(got, n, dev)
    g1.run_plain(want, n, dev)
    torch.cuda.synchronize()
    for m_got, m_want in zip(got, want):
        for lg, lw in zip(m_got.leaves, m_want.leaves):
            if lg.op == "hist":
                assert torch.equal(lg.state, lw.state), (m_got.num_groups, nan_bin)


def test_gang_past_capacity_splits_and_equals_plain(dev):
    """24 members of 4 leaves (past G1_CAPACITY's 16 members) run as two
    launches over the same feed, equal to the plain version leaf by leaf."""
    n = 100_001
    base = _g1_members(dev, n, (8, 64), 14, n, False)
    for m in base:
        m.leaves = m.leaves[:4]
    members = _g1_clone(base * 12)
    assert len(members) == 24
    plan = g1.plan_for(members, dev)
    assert len(plan.launches) == 2
    assert [(a, b) for a, b, _p, _c in plan.launches] == [(0, 16), (16, 24)]
    got, want = _g1_clone(members), _g1_clone(members)
    before = _build.KERNELS["gang"].launches
    g1.run(got, n, dev)
    assert _build.KERNELS["gang"].launches == before + 2
    g1.run_plain(want, n, dev)
    torch.cuda.synchronize()
    for m_got, m_want in zip(got, want):
        for lg, lw in zip(m_got.leaves, m_want.leaves):
            if lg.state.dtype == torch.float64 and lg.op in ("sum", "sumsq"):
                assert torch.allclose(lg.state, lw.state, rtol=1e-12, atol=0)
            else:
                assert torch.equal(lg.state, lw.state) or (
                    lg.state.dtype == torch.float64 and c1_same(lg.state, lw.state))


def test_gang_cuda_tensor_never_reaches_the_plain_version(dev, monkeypatch):
    members = _g1_members(dev, 4097, (8, 64), 12, 4097, False)

    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(g1, "run_plain", boom)
    monkeypatch.setattr(c1, "run_plain", boom)
    g1.run(members, 4097, dev)
    torch.cuda.synchronize()


def test_gang_on_the_card_equals_cpu_route(dev):
    """The fused agent plan of the reference load harness's four dashboard
    scripts through run_agent: G1 on the card, once per feed, equal to the
    CPU's gang (its plain version)."""
    from pixie_tpu_torch import flags
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine.executor import PlanExecutor
    from pixie_tpu_torch.parallel import LocalCluster
    from pixie_tpu_torch.serving import batching
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    scripts = [
        "df = px.DataFrame(table='http_events')\ndf = df[df.status != 404]\n"
        "df = df.groupby(['service', 'status']).agg(cnt=('latency', px.count), "
        "avg_lat=('latency', px.mean))\npx.display(df, 'out')\n",
        "df = px.DataFrame(table='http_events')\ndf = df[df.latency > 10.0]\n"
        "df = df.groupby('service').agg(cnt=('latency', px.count), mx=('latency', px.max))\n"
        "px.display(df, 'out')\n",
        "df = px.DataFrame(table='http_events')\ndf = df.groupby('status').agg("
        "p50=('latency', px.p50), p99=('latency', px.p99))\npx.display(df, 'out')\n",
        "df = px.DataFrame(table='http_events')\ndf = df[df.status == 200]\n"
        "df = df.groupby('service').agg(avg=('latency', px.mean), mn=('latency', px.min))\n"
        "px.display(df, 'out')\n"]
    rng = np.random.default_rng(9)
    n = 200_000
    ts = TableStore()
    ts.create("http_events", Relation.of(
        ("time_", DT.TIME64NS), ("service", DT.STRING), ("latency", DT.FLOAT64),
        ("status", DT.INT64)), batch_rows=1 << 15).write({
            "time_": np.arange(n, dtype=np.int64), "service": rng.choice(["a", "b", "c"], n),
            "latency": rng.exponential(20.0, n), "status": rng.choice([200, 404, 500], n)})
    saved = flags.get("PX_MQ_FUSION")
    try:
        flags.set_for_testing("PX_MQ_FUSION", -1)  # auto: on for a CUDA executor
        out = {}
        for device in (dev, "cpu"):
            if device == "cpu":
                flags.set_for_testing("PX_MQ_FUSION", 1)
            cl = LocalCluster({"pem0": ts}, device=device)
            qs = [compile_pxl(s, cl.schemas()) for s in scripts]
            fused, _sm = batching.fuse_members([(f"q{i}", q.plan) for i, q in enumerate(qs)],
                                               cl.schemas())
            ap = cl.planner.plan(fused).agent_plans["pem0"]
            before = _build.KERNELS["gang"].launches
            ex = PlanExecutor(ap, ts, None, device=device)
            out[str(device)] = ex.run_agent()
            assert ex.stats["mq_fused"] == 4
            if device != "cpu":
                assert _build.KERNELS["gang"].launches - before == ex.stats["mq_waves"] >= 1
    finally:
        flags.set_for_testing("PX_MQ_FUSION", saved)
    got, want = out[str(dev)], out["cpu"]
    for cid in want:
        g, w = got[cid], want[cid]
        assert {k: list(map(str, v)) for k, v in g.key_cols.items()} == \
            {k: list(map(str, v)) for k, v in w.key_cols.items()}
        for name in w.states:
            gl, wl = g.states[name], w.states[name]
            for key in (sorted(wl) if isinstance(wl, dict) else [None]):
                a = np.asarray(gl[key] if key else gl)
                b = np.asarray(wl[key] if key else wl)
                if a.dtype == np.float64 and name.startswith(("avg", "sum")):
                    np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
                else:
                    np.testing.assert_array_equal(a, b)


# ------------------------------------------------ X1, X2 and the mesh path
def _x1_inputs(dev, n_dev, per, seed, skew=False):
    """One int64 key (values above 2^63 as uint64 among them), one
    dictionary key with nulls, and the shards' valid rows."""
    from pixie_tpu_torch.ops import repartition as xr

    rng = np.random.default_rng(seed)
    a = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n_dev * per,
                     dtype=np.int64)
    if skew:
        a[: n_dev * per // 2] = 7  # one key holds half the rows
    codes = rng.integers(-1, 300, n_dev * per).astype(np.int32)
    lut = xr.value_hash_lut([f"svc-{i}" for i in range(300)])
    nv = np.full(n_dev, per, dtype=np.int64)
    nv[-1] = per // 3
    keys = [(torch.from_numpy(a).to(dev), None),
            (torch.from_numpy(codes).to(dev), torch.from_numpy(lut).to(dev))]
    return keys, nv


@pytest.mark.parametrize("n_dev,per,skew", [(4, 1 << 16, False), (8, 12345, False),
                                            (4, 1 << 16, True), (3, 5000, False),
                                            (1, 4097, False)])
def test_partition_count_equals_plain(dev, n_dev, per, skew):
    from pixie_tpu_torch.ops import repartition as xr

    keys, nv = _x1_inputs(dev, n_dev, per, 21, skew)
    before = _build.KERNELS["repartition"].by_entry.get("px_partition_count", 0)
    got = xr.partition_count(keys, nv, n_dev)
    assert _build.KERNELS["repartition"].by_entry["px_partition_count"] == before + 1
    want = xr.partition_count_plain(keys, nv, n_dev)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.parametrize("n_dev,per,skew", [(4, 1 << 16, False), (8, 12345, False),
                                            (4, 1 << 16, True), (3, 5000, False)])
def test_partition_scatter_equals_plain(dev, n_dev, per, skew):
    """X2's received layout equals its plain version's in every block's
    valid rows, for every column width; the received counts exactly."""
    from pixie_tpu_torch.ops import repartition as xr

    keys, nv = _x1_inputs(dev, n_dev, per, 22, skew)
    part, counts, tiles = xr.partition_count(keys, nv, n_dev)
    cap = int(counts.max())
    rng = np.random.default_rng(23)
    cols = [keys[0][0], keys[1][0], torch.from_numpy(rng.normal(size=n_dev * per)).to(dev),
            torch.from_numpy(rng.random(n_dev * per) < 0.5).to(dev),
            torch.from_numpy(rng.integers(0, 1 << 15, n_dev * per).astype(np.int16)).to(dev)]
    got, grecv = xr.partition_scatter(part, tiles, counts, cols, n_dev, cap)
    want, wrecv = xr.partition_scatter_plain(part, tiles, counts, cols, n_dev, cap)
    assert torch.equal(grecv.cpu(), wrecv.cpu())
    assert int(grecv.sum()) == int(nv.sum())
    rc = grecv.cpu().numpy()
    for g, w in zip(got, want):
        g = g.cpu().view(n_dev * n_dev, cap)
        w = w.cpu().view(n_dev * n_dev, cap)
        for b in range(n_dev * n_dev):
            assert torch.equal(g[b, : rc[b]], w[b, : rc[b]])


#: X2's column dtypes: widths 1, 2, 4 and 8 in turn
_X2_DTYPES = [np.uint8, np.int16, np.float32, np.int64, np.bool_, np.int32, np.float64]


def _x2_cols(dev, n, ncols, seed):
    rng = np.random.default_rng(seed)
    out = []
    for c in range(ncols):
        dt = _X2_DTYPES[c % len(_X2_DTYPES)]
        if dt == np.bool_:
            a = rng.random(n) < 0.5
        elif np.issubdtype(dt, np.floating):
            a = rng.normal(size=n).astype(dt)
        else:
            a = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, n, dtype=dt)
        out.append(torch.from_numpy(a).to(dev))
    return out


def _x2_hold(dev, n_dev, per, ncols, cap=None, seed=26):
    """X2 on the card against its plain version: recv exactly, every
    block's received rows bit for bit, one launch; → recv."""
    from pixie_tpu_torch.ops import repartition as xr

    keys, nv = _x1_inputs(dev, n_dev, per, seed)
    part, counts, tiles = xr.partition_count(keys, nv, n_dev)
    cap = int(counts.max()) if cap is None else cap
    cols = _x2_cols(dev, n_dev * per, ncols, seed + 1)
    before = _build.KERNELS["repartition"].by_entry.get("px_partition_scatter", 0)
    got, grecv = xr.partition_scatter(part, tiles, counts, cols, n_dev, cap)
    assert _build.KERNELS["repartition"].by_entry["px_partition_scatter"] == before + 1
    want, wrecv = xr.partition_scatter_plain(part, tiles, counts, cols, n_dev, cap)
    assert torch.equal(grecv.cpu(), wrecv.cpu())
    valid = torch.arange(cap, device=dev).view(1, cap) < grecv.view(-1, 1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g.view(-1, cap)[valid], w.view(-1, cap)[valid])
    return grecv, nv


@pytest.mark.parametrize("ncols", [17, 40])
def test_partition_scatter_many_columns_equal_plain(dev, ncols):
    """Columns of widths 1, 2, 4 and 8, by value in the launch (17) and
    from the device table past 32 (40): one launch ranks each tile once for
    all of them."""
    recv, nv = _x2_hold(dev, 4, 5000, ncols)
    assert int(recv.sum()) == int(nv.sum())


@pytest.mark.parametrize("n_dev,per", [(1, 9001), (3, 4096 * 2 + 5), (1024, 300)])
def test_partition_scatter_partition_counts_equal_plain(dev, n_dev, per):
    recv, nv = _x2_hold(dev, n_dev, per, 5)
    assert int(recv.sum()) == int(nv.sum())


def test_partition_scatter_short_cap_equals_plain(dev):
    """At a cap below the largest bucket the rows below cap equal the plain
    version's, the rows at rank >= cap are not written, and recv says so."""
    from pixie_tpu_torch.ops import repartition as xr

    keys, nv = _x1_inputs(dev, 4, 4096 * 3 + 11, 27)
    _part, counts, _tiles = xr.partition_count(keys, nv, 4)
    recv, nv = _x2_hold(dev, 4, 4096 * 3 + 11, 6, cap=int(counts.max()) - 100, seed=27)
    assert int(recv.sum()) < int(nv.sum())


def test_partition_scatter_short_cap_drops_rows_visibly(dev):
    """Rows past cap are not written, and the received counts say so."""
    from pixie_tpu_torch.ops import repartition as xr

    keys, nv = _x1_inputs(dev, 4, 4096, 24)
    part, counts, tiles = xr.partition_count(keys, nv, 4)
    _outs, recv = xr.partition_scatter(part, tiles, counts, [keys[0][0]], 4,
                                       int(counts.max()) - 1)
    assert int(recv.sum()) < int(nv.sum())


def test_repartition_cuda_tensor_never_reaches_the_plain_versions(dev, monkeypatch):
    from pixie_tpu_torch.ops import repartition as xr

    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(xr, "partition_count_plain", boom)
    monkeypatch.setattr(xr, "partition_scatter_plain", boom)
    keys, nv = _x1_inputs(dev, 4, 4096, 25)
    part, counts, tiles = xr.partition_count(keys, nv, 4)
    xr.partition_scatter(part, tiles, counts, [keys[0][0]], 4, int(counts.max()))
    torch.cuda.synchronize()


def test_mesh_query_and_exchange_on_the_card_equal_cpu(dev):
    """An aggregate over a 4-shard mesh and a mesh exchange on the card:
    C1, K1 and K2 per shard, then F2 once over the shards' states (no M1,
    no K3: the device finalize merges them), X1 and X2 launched, results
    equal to the CPU's mesh route."""
    from pixie_tpu_torch import flags
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine.executor import HostBatch, PlanExecutor
    from pixie_tpu_torch.parallel import repartition as rp
    from pixie_tpu_torch.parallel.spmd import make_mesh
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.table.dictionary import Dictionary
    from pixie_tpu_torch.types import DataType as DT, Relation

    rng = np.random.default_rng(31)
    n = 300_000
    ts = TableStore()
    ts.create("http_events", Relation.of(
        ("time_", DT.TIME64NS), ("service", DT.STRING), ("latency", DT.FLOAT64),
        ("status", DT.INT64)), batch_rows=1 << 15).write({
            "time_": np.arange(n, dtype=np.int64), "service": rng.choice(["a", "b", "c"], n),
            "latency": rng.exponential(20.0, n), "status": rng.choice([200, 404, 500], n)})
    src = ("df = px.DataFrame(table='http_events')\ndf = df[df.status != 404]\n"
           "df = df.groupby(['service', 'status']).agg(cnt=('latency', px.count), "
           "avg=('latency', px.mean), p50=('latency', px.p50))\npx.display(df, 'out')\n")
    saved = flags.get("PIXIE_TORCH_VIRTUAL_SHARDS")
    flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", 4)
    try:
        plan = compile_pxl(src, ts.schemas()).plan
        _build.reset_launches()
        got = PlanExecutor(plan, ts, device=dev, mesh=make_mesh(4, device=dev)).run()["out"]
        by = _build.KERNELS
        assert by["finalize"].by_entry == {"px_merge_finalize": 1}
        assert by["merge"].launches == 0 and by["loghist_quantile"].launches == 0
        assert by["chain"].launches >= 4 and by["segment_reduce"].launches >= 4
        want = PlanExecutor(plan, ts, device="cpu",
                            mesh=make_mesh(4, device="cpu")).run()["out"]
        g = got.to_pandas().sort_values(["service", "status"]).reset_index(drop=True)
        w = want.to_pandas().sort_values(["service", "status"]).reset_index(drop=True)
        assert g.cnt.tolist() == w.cnt.tolist()
        np.testing.assert_allclose(g.avg, w.avg, rtol=1e-12)
        np.testing.assert_array_equal(g.p50, w.p50)
        d = Dictionary([f"k{i}" for i in range(50)])
        hb = HostBatch({"k": DT.STRING, "v": DT.INT64}, {"k": d},
                       {"k": rng.integers(-1, 50, 100_001).astype(np.int32),
                        "v": np.arange(100_001, dtype=np.int64)})
        cuda_parts = rp.mesh_partition_exchange(hb, ["k", "v"], 4, make_mesh(4, device=dev))
        assert by["repartition"].by_entry.get("px_partition_scatter", 0) == 1
        cpu_parts = rp.mesh_partition_exchange(hb, ["k", "v"], 4, make_mesh(4, device="cpu"))
        for a, b in zip(cuda_parts, cpu_parts):
            for c in ("k", "v"):
                np.testing.assert_array_equal(a.cols[c], b.cols[c])
    finally:
        flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", saved)


def test_device_joins_from_threads_equal_serial(dev):
    """J1-J3 launched from several threads at once (a repartitioned join's
    partition joins run in a thread pool) give the serial pair sets: no
    kernel's scratch is freed before its launch is enqueued."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(41)
    cases = [(rng.integers(0, 1 << 18, 1 << 20), rng.integers(0, 1 << 18, 1 << 20))
             for _ in range(8)]

    def pairs(bp):
        bi, pi, bm, pm = jd.device_join_codes(bp[0], bp[1], device=dev)
        return sorted(zip(bi.tolist(), pi.tolist())), bm.tolist(), pm.tolist()

    want = [pairs(c) for c in cases]
    for _ in range(3):
        with ThreadPoolExecutor(max_workers=8) as pool:
            got = list(pool.map(pairs, cases))
        assert got == want


# ------------------------------------------- P1, F2 and F1 (the device finalize)
from pixie_tpu_torch.ops import finalize as fin  # noqa: E402
from pixie_tpu_torch.ops import pack as p1  # noqa: E402

_FIN_RT = {"cnt": "add", "avg": {"sum": "add", "count": "add"}, "p50": "add", "qs": "add",
           "mn32": "min", "mx64": "max", "mnf": "min", "__seen": "add"}
_FINALS = {"p50": fin.Final(LogHistogram(), (0.5,), True),
           "qs": fin.Final(LogHistogram(), (0.01, 0.1, 0.5, 0.9, 0.99), False)}


def _fin_states(dev, n, g, seed):
    """n states of one tree: counts, an f64 mean, two sketches (a quarter of
    their groups empty), int32 min, int64 max and an f64 min with NaN."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sk = rng.integers(0, 64, (2, g, 514)).astype(np.float32)
        sk[:, rng.random(g) < 0.25] = 0.0
        mnf = rng.exponential(5.0, g)
        mnf[rng.random(g) < 0.05] = np.nan
        st = {"cnt": rng.integers(-(2 ** 62), 2 ** 62, g),
              "avg": {"sum": rng.exponential(50.0, g) * 1e3, "count": rng.integers(0, 1 << 20, g)},
              "p50": sk[0], "qs": sk[1],
              "mn32": rng.integers(-(2 ** 31), 2 ** 31 - 1, g).astype(np.int32),
              "mx64": rng.integers(-(2 ** 62), 2 ** 62, g), "mnf": mnf,
              "__seen": rng.integers(0, 3, g)}
        out.append({k: ({kk: torch.from_numpy(vv).to(dev) for kk, vv in v.items()}
                        if isinstance(v, dict) else torch.from_numpy(v).to(dev))
                    for k, v in st.items()})
    return out


def _same_trees(got, want) -> None:
    gl, wl = p1.flatten(got), p1.flatten(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_p, b) in zip(gl, wl):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path


@pytest.mark.parametrize("g", [1, 64, 4096])
def test_state_pack_equals_plain_and_unpacks_bit_for_bit(dev, g):
    """P1 against its plain version (the buffer, padding included, byte for
    byte) and the unpacked leaves against a leaf-by-leaf pull, with one
    leaf a view that is not 16-byte aligned."""
    (st,) = _fin_states(dev, 1, g, 31)
    st["mn32"] = torch.arange(g + 1, dtype=torch.int32, device=dev)[1:]
    layout = p1.state_packer(st)
    leaves = [x for _p, x in p1.flatten(st)]
    before = _build.KERNELS["pack"].launches
    got = p1.pack(leaves, layout)
    assert _build.KERNELS["pack"].launches == before + 1
    want = p1.pack_plain(leaves, layout)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _same_trees(layout.unpack(got.cpu().numpy()),
                {k: ({kk: vv.cpu().numpy() for kk, vv in v.items()} if isinstance(v, dict)
                     else v.cpu().numpy()) for k, v in st.items()})


def test_state_pack_past_one_launch_splits_and_equals_plain(dev):
    """2,000 leaves of four dtypes and ragged sizes: P1 packs them in
    ceil(2000 / P1_CAPACITY) launches, byte for byte the plain version's
    buffer."""
    rng = np.random.default_rng(35)
    dts = (np.int32, np.int64, np.float32, np.float64)
    leaves = [torch.from_numpy(rng.integers(-1000, 1000, 1 + (i * 37) % 300).astype(
        dts[i % 4])).to(dev) for i in range(2000)]
    layout = p1.Layout.of([((f"l{i}",), x.dtype, x.shape) for i, x in enumerate(leaves)])
    before = _build.KERNELS["pack"].launches
    got = p1.pack(leaves, layout)
    torch.cuda.synchronize()
    assert _build.KERNELS["pack"].launches == before + -(-2000 // p1.P1_CAPACITY)
    assert torch.equal(got, p1.pack_plain(leaves, layout))


def test_merge_past_one_launch_splits_and_equals_plain(dev):
    """17 states over 250 leaves (rows of 20 words: 203 a launch): M1
    merges them in two launches, equal to the plain fold bit for bit, NaN
    positions and int64 wraps included."""
    rng = np.random.default_rng(36)
    rt = {f"l{i}": ("add", "min", "max")[i % 3] for i in range(250)}

    def leaf(i):
        if i % 2:
            return rng.integers(2 ** 62, 2 ** 63 - 1, 3 + i % 5, dtype=np.int64)
        v = rng.normal(size=3 + i % 5)
        v[rng.integers(0, v.size)] = np.nan
        return v

    states = [{k: torch.from_numpy(leaf(i)).to(dev) for i, k in enumerate(rt)}
              for _ in range(17)]
    plan = m1.plan_for(rt, states)
    before = _build.KERNELS["merge"].launches
    got = m1.merge_states(rt, states)
    torch.cuda.synchronize()
    assert _build.KERNELS["merge"].launches == before + len(plan.launches) == before + 2
    want = m1.merge_states_plain(rt, states)
    got = got.tree()
    for k in rt:
        a, b = got[k], want[k]
        assert torch.equal(a.isnan() if a.is_floating_point() else a,
                           b.isnan() if b.is_floating_point() else b), k
        assert torch.equal(a.nan_to_num() if a.is_floating_point() else a,
                           b.nan_to_num() if b.is_floating_point() else b), k


def test_pack_and_merge_from_threads_equal_serial(dev):
    """8 threads packing and merging at once, as LocalCluster's agents run,
    give the serial results: every thread writes its own descriptor rows."""
    import threading

    rt, states = _m1_states(dev, 4, 257, 37)
    packs = [_fin_states(dev, 1, 64 + t, 38 + t)[0] for t in range(8)]
    want_m = [m1.merge_states(rt, states[t % 4:] + states[:t % 4]) for t in range(8)]
    want_p = [p1.pack_state(st) for st in packs]
    torch.cuda.synchronize()
    got_m, got_p, errs = [None] * 8, [None] * 8, []
    barrier = threading.Barrier(8)

    def run(t):
        try:
            barrier.wait()
            for _ in range(50):
                got_m[t] = m1.merge_states(rt, states[t % 4:] + states[:t % 4])
                got_p[t] = p1.pack_state(packs[t])
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001  (reported below)
            errs.append(e)

    threads = [threading.Thread(target=run, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errs, errs
    for t in range(8):
        assert torch.equal(got_m[t].buf, want_m[t].buf), t
        assert torch.equal(got_p[t].buf, want_p[t].buf), t


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("g", [1, 64, 1024])
@pytest.mark.parametrize("with_finals", [True, False])
def test_merge_finalize_equals_plain(dev, n, g, with_finals):
    """F2 against its plain version (M1's merge in state order, K3's rank
    rule, the pack) on the same CUDA tensors: every output leaf exactly."""
    states = _fin_states(dev, n, g, 32 + n)
    finals = _FINALS if with_finals else {}
    before = _build.KERNELS["finalize"].launches
    got = fin.merge_finalize(states, _FIN_RT, finals)
    assert _build.KERNELS["finalize"].launches == before + 1
    want = fin.merge_finalize_plain(states, _FIN_RT, finals)
    torch.cuda.synchronize()
    g_f, g_r = got.unpack(got.buf.cpu().numpy())
    w_f, w_r = want.unpack(want.buf.cpu().numpy())
    _same_trees(g_f, w_f)
    _same_trees(g_r, w_r)


def test_finalize_cuda_tensors_never_reach_the_plain_versions(dev, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version reached with CUDA tensors")

    monkeypatch.setattr(fin, "merge_finalize_plain", boom)
    monkeypatch.setattr(fin, "pack_plain", boom)
    monkeypatch.setattr(p1, "pack_plain", boom)
    states = _fin_states(dev, 2, 8, 33)
    fin.merge_finalize(states, _FIN_RT, _FINALS)
    p1.pack_state(states[0])
    torch.cuda.synchronize()


def _fin_table(n, seed, nan_share=0.0):
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    rng = np.random.default_rng(seed)
    ts = TableStore()
    ts.create("http_events", Relation.of(
        ("time_", DT.TIME64NS), ("service", DT.STRING), ("latency", DT.FLOAT64),
        ("status", DT.INT64)), batch_rows=1 << 14).write({
            "time_": np.sort(rng.integers(0, 600 * 10 ** 9, n)).astype(np.int64),
            "service": rng.choice([f"svc-{i}" for i in range(16)], n),
            "latency": np.where(rng.random(n) < nan_share, np.nan, rng.exponential(50.0, n)),
            "status": rng.choice([200, 404, 500], n)})
    return ts


_FIN_SCRIPTS = {
    "by_status": "df = px.DataFrame(table='http_events')\n"
                 "df = df.groupby('status').agg(cnt=('latency', px.count), "
                 "p50=('latency', px.p50), avg=('latency', px.mean))\npx.display(df, 'out')\n",
    "grouped": "df = px.DataFrame(table='http_events')\ndf = df[df.status != 404]\n"
               "df = df.groupby(['service', 'status']).agg(cnt=('latency', px.count), "
               "avg=('latency', px.mean), p50=('latency', px.p50), "
               "qs=('latency', px.quantiles), mx=('latency', px.max), mn=('status', px.min))\n"
               "px.display(df, 'out')\n",
    "windowed": "df = px.DataFrame(table='http_events')\n"
                "df.w = px.bin(df.time_, px.DurationNanos(10 * 1000 * 1000 * 1000))\n"
                "df = df.groupby(['w', 'service']).agg(cnt=('latency', px.count), "
                "p99=('latency', px.p99))\npx.display(df, 'out')\n",
}


@pytest.mark.parametrize("script", sorted(_FIN_SCRIPTS))
@pytest.mark.parametrize("feeds", [1, 4])
def test_device_finalize_on_the_card_equals_cpu_route(dev, script, feeds):
    """One feed: F1 is the query's only kernel launch (no C1, K1, K2, K3)
    and one readback wave, the second query's from F1's cached plan; four
    feeds: F2 once after the per-feed route.  Either way the card's result
    equals the CPU's (means to 1e-12)."""
    from pixie_tpu_torch import flags
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine import execute_plan

    ts = _fin_table(1 << 16, 34)
    plan = compile_pxl(_FIN_SCRIPTS[script], ts.schemas()).plan
    saved = flags.get("PX_FEED_ROWS")
    try:
        flags.set_for_testing("PX_FEED_ROWS", (1 << 16) // feeds)
        execute_plan(plan, ts, device=dev)  # warm: tier admission, key uniques
        torch.cuda.synchronize()
        _build.reset_launches()
        waves = transfer.stats["waves"]
        got = execute_plan(plan, ts, device=dev)["out"]
        torch.cuda.synchronize()
        launches = {k: v.launches for k, v in _build.KERNELS.items() if v.launches}
        want = execute_plan(plan, ts, device="cpu")["out"]
    finally:
        flags.set_for_testing("PX_FEED_ROWS", saved)
    if feeds == 1:
        assert got.exec_stats["fused_single_feed"] == 1
        assert launches == {"finalize": 1}, launches
        assert _build.KERNELS["finalize"].by_entry == {"px_fused_partial_finalize": 1}
        assert transfer.stats["waves"] - waves == 1
    else:
        assert "fused_single_feed" not in got.exec_stats
        assert _build.KERNELS["finalize"].by_entry == {"px_merge_finalize": 1}
        assert "loghist_quantile" not in launches
    g, w = got.to_pandas(), want.to_pandas()
    keys = [c for c in w.columns if c in ("service", "status", "w")]
    g = g.sort_values(keys).reset_index(drop=True)
    w = w.sort_values(keys).reset_index(drop=True)
    for c in w.columns:
        if c == "avg":
            np.testing.assert_allclose(g[c], w[c], rtol=1e-12, atol=0)
        else:
            assert g[c].tolist() == w[c].tolist() or np.array_equal(
                g[c].to_numpy(), w[c].to_numpy(), equal_nan=True), c


@pytest.mark.parametrize("nan_bin", [0, 1])
def test_fused_finalize_nan_bin_equals_plain(dev, nan_bin):
    """F1 over latencies 20% NaN, its executor's NaN bin 0 (a streaming
    poll's) or 1 (a batch query's), equal to its plain version."""
    _fused_vs_plain(dev, _fin_table(1 << 15, 36, nan_share=0.2), nan_bin)


def test_fused_finalize_shared_and_global_accumulators_equal_plain(dev):
    """F1 directly over one feed, against its plain version on the same CUDA
    tensors: states of 3 and 48 groups (every leaf in a block's private
    accumulators at 1024 threads) and 1,024 window groups (the sketch on
    global atomics, the small leaves private)."""
    _fused_vs_plain(dev, _fin_table(1 << 15, 35), 1)


def _fused_vs_plain(dev, ts, nan_bin):
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine.executor import PlanExecutor, _time_bounds
    from pixie_tpu_torch.plan import AggOp

    for script in sorted(_FIN_SCRIPTS):
        plan = compile_pxl(_FIN_SCRIPTS[script], ts.schemas()).plan
        ex = PlanExecutor(plan, ts, device=dev, nan_bin=nan_bin)
        (op,) = [o for o in plan.topo_sorted() if isinstance(o, AggOp)]
        s = ex._agg_setup(op)
        cols = {k: torch.from_numpy(np.concatenate(
            [rb.columns[k][:rb.num_valid] for rb, _r, _g in s.src])).to(dev) for k in s.names}
        n = next(iter(cols.values())).shape[0]
        luts = {k: torch.as_tensor(v).to(dev) for k, v in s.kern.luts.items()}
        t_lo, t_hi = _time_bounds(s.head)

        def build(st):
            return s.kern.gang_member(cols, n, t_lo, t_hi, luts, st, s.origins)

        def init(d):
            return {name: uda.init(s.num_groups, dt, d) for name, uda, dt in s.init_specs}

        rt = {name: uda.reduce_ops() for name, uda, _vb in s.udas}
        finals = fin.finals_of((name, uda) for name, uda, _vb in s.udas)
        got = fin.fused_partial_finalize(build, init, rt, finals, n, dev)
        state = init(dev)
        g1.run_plain([build(state)], n, dev)
        want = fin.merge_finalize_plain([state], rt, finals)
        torch.cuda.synchronize()
        for a, b in zip(got.unpack(got.buf.cpu().numpy()), want.unpack(want.buf.cpu().numpy())):
            for (path, x), (_p, y) in zip(p1.flatten(a), p1.flatten(b)):
                if x.dtype.kind == "f" and path[-1] == "sum":
                    np.testing.assert_allclose(x, y, rtol=1e-12, atol=0)
                else:
                    assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), (script, path)


#: one state shape (groups and UDAs), three chains: two filter literals and
#: a deeper filter expression
_F1_CHAINS = {
    "not_404": "df = df[df.status != 404]\n",
    "not_500": "df = df[df.status != 500]\n",
    "deeper": "df = df[(df.status != 404) & (df.latency * 2.0 + 1.0 > 3.0 * (df.latency - 1.0))]\n",
}


def test_fused_finalize_cached_launch_follows_the_chain(dev):
    """Three one-feed queries of one state shape (by service and status:
    count, mean, p50) whose chains differ — a filter's literal, a deeper
    filter — share F1's cached plan and each get their own launch (the
    member's program is part of its encoding), and each equals the CPU
    route, run in turn in one process."""
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine import execute_plan

    ts = _fin_table(1 << 15, 37)
    fin._F1_PLANS.clear()
    fin._F1_LAUNCHES.clear()
    for label in ("not_404", "not_500", "deeper", "not_404"):
        src = ("df = px.DataFrame(table='http_events')\n" + _F1_CHAINS[label] +
               "df = df.groupby(['service', 'status']).agg(cnt=('latency', px.count), "
               "avg=('latency', px.mean), p50=('latency', px.p50))\npx.display(df, 'out')\n")
        plan = compile_pxl(src, ts.schemas()).plan
        got = execute_plan(plan, ts, device=dev)["out"]
        torch.cuda.synchronize()
        want = execute_plan(plan, ts, device="cpu")["out"]
        assert got.exec_stats["fused_single_feed"] == 1, label
        g = got.to_pandas().sort_values(["service", "status"]).reset_index(drop=True)
        w = want.to_pandas().sort_values(["service", "status"]).reset_index(drop=True)
        assert len(g) == len(w) and g["status"].tolist() == w["status"].tolist(), label
        assert g["cnt"].tolist() == w["cnt"].tolist() and g["p50"].tolist() == w["p50"].tolist()
        np.testing.assert_allclose(g["avg"], w["avg"], rtol=1e-12, atol=0)
    assert len(fin._F1_PLANS) == 1 and len(fin._F1_LAUNCHES) == 3


# ------------------------------------------------- standing views, unions

VIEW_SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(df, 'output')
"""


def _http_store(n, seed, services=16, name="http_events", ts=None):
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    ts = TableStore() if ts is None else ts
    t = ts.create(name, Relation.of(
        ("time_", DT.TIME64NS), ("service", DT.STRING), ("latency", DT.FLOAT64),
        ("status", DT.INT64)), batch_rows=1 << 14)
    _append_http(t, n, seed, services)
    return ts


def _append_http(t, n, seed, services=16):
    rng = np.random.default_rng(seed)
    t.write({"time_": np.arange(n, dtype=np.int64),
             "service": np.array([f"svc-{i}" for i in range(services)])[
                 rng.integers(0, services, n)],
             "latency": rng.exponential(50.0, n),
             "status": rng.choice([200, 404, 500], n, p=[0.85, 0.05, 0.10])})


def _same_result(got, want, keys):
    g = got.to_pandas().sort_values(keys).reset_index(drop=True)
    w = want.to_pandas().sort_values(keys).reset_index(drop=True)
    assert list(g.columns) == list(w.columns) and len(g) == len(w)
    for c in g.columns:
        if c.startswith("avg"):
            np.testing.assert_allclose(g[c], w[c], rtol=1e-12, atol=0, err_msg=c)
        else:
            assert g[c].tolist() == w[c].tolist(), c


def test_matview_build_and_fold_on_the_card_equal_a_rescan(dev):
    """4 agents with views on: the build (every agent's state computed on
    the card and pulled to the host) and the fold of rows appended to one
    agent (C1 and K1 over the delta) equal a views-off rescan on the card,
    counts and p50 exactly, means to rtol 1e-12; a hit with no delta
    launches no kernel of the chain."""
    from pixie_tpu_torch import flags
    from pixie_tpu_torch.parallel import LocalCluster

    stores = {f"pem{a}": _http_store(1 << 18, 40 + a) for a in range(4)}

    def rescan():
        flags.set_for_testing("PL_MATVIEW_ENABLED", False)
        try:
            return LocalCluster(stores, device=dev).query(VIEW_SCRIPT)["output"]
        finally:
            flags.set_for_testing("PL_MATVIEW_ENABLED", True)

    saved = flags.get("PL_MATVIEW_ENABLED")
    flags.set_for_testing("PL_MATVIEW_ENABLED", True)
    try:
        cluster = LocalCluster(stores, device=dev)
        cluster.query(VIEW_SCRIPT)  # first sight: registers
        built = cluster.query(VIEW_SCRIPT)["output"]
        info = {a: s["matview"] for a, s in built.exec_stats["agents"].items()}
        assert all(i["hit"] and i["rows_folded"] == 1 << 18 for i in info.values())
        _same_result(built, rescan(), ["service", "status"])
        _build.reset_launches()
        hit = cluster.query(VIEW_SCRIPT)["output"]
        torch.cuda.synchronize()
        assert _build.KERNELS["chain"].launches == 0
        _same_result(hit, built, ["service", "status"])
        _append_http(stores["pem2"].table("http_events"), 1 << 16, 99)
        _build.reset_launches()
        folded = cluster.query(VIEW_SCRIPT)["output"]
        torch.cuda.synchronize()
        rows = {a: s["matview"]["rows_folded"]
                for a, s in folded.exec_stats["agents"].items()}
        assert rows == {"pem0": 0, "pem1": 0, "pem2": 1 << 16, "pem3": 0}
        assert _build.KERNELS["chain"].launches >= 1
        assert _build.KERNELS["segment_reduce"].launches >= 1
        _same_result(folded, rescan(), ["service", "status"])
    finally:
        flags.set_for_testing("PL_MATVIEW_ENABLED", saved)


def test_union_on_the_card_equals_the_cpu(dev):
    """A union of two filtered scans of tables with different dictionaries,
    grouped: C1 and K4 for the parents on the card, equal to device="cpu"."""
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine import execute_plan

    ts = _http_store(1 << 18, 50, name="a_events")
    _http_store(1 << 17, 51, services=24, name="b_events", ts=ts)
    src = """
a = px.DataFrame(table='a_events')
a = a[a.status == 500]
b = px.DataFrame(table='b_events')
b = b[b.status == 404]
u = a.append(b)
u = u.groupby('service').agg(cnt=('latency', px.count), avg_lat=('latency', px.mean),
                             p50=('latency', px.p50))
px.display(u, 'output')
"""
    plan = compile_pxl(src, ts.schemas()).plan
    _build.reset_launches()
    got = execute_plan(plan, ts, device=dev)["output"]
    torch.cuda.synchronize()
    assert _build.KERNELS["chain"].launches >= 2 and _build.KERNELS["compact"].launches >= 2
    want = execute_plan(plan, ts, device="cpu")["output"]
    _same_result(got, want, ["service"])


# ------------------------------------------------- the mesh across processes
def test_multihost_two_ranks_share_the_card(dev):
    """shard_bench's multi-process arm with both ranks on this card: gloo,
    the world merge's buffer staged through pinned host memory, M1 twice a
    step on each rank (its local shards, then the world's buffers), rank 0
    bit-equal to the single-device step and both ranks the same bytes; the
    exchange's X1, X2 and K4 on each rank, every block as the sender's rows."""
    from pixie_tpu_torch.parallel import shard_bench as sb

    out = sb.run_subprocess(1 << 20, repeats=1, processes=2, devices_per_proc=2,
                            device="cuda", timeout=600.0, exchange_rows=1 << 16)
    assert out["mode"] == "multihost" and out["backend"] == "gloo"
    assert out["bit_equal"] is True and out["ranks_equal"] is True
    for r in out["ranks"]:
        assert r["launches"]["merge"]["px_merge_states"] == 2
        assert r["launches"]["chain"]["px_chain_run"] >= 2
        assert r["staged_bytes"] > 0
        x = r["exchange"]
        assert x["rows_equal"] is True and x["staged_bytes"] > 0
        assert x["launches"]["repartition"]["px_partition_count"] == 1
        assert x["launches"]["repartition"]["px_partition_scatter"] == 1
        assert x["launches"]["compact"]["px_compact"] == 1


def test_world_merge_in_a_one_rank_nccl_world(dev):
    """One rank on one card is NCCL; its world merge (M1 over the local
    shards, an NCCL all_gather of the packed buffer) equals M1 over the same
    states bit for bit."""
    from pixie_tpu_torch import flags
    from pixie_tpu_torch.parallel import multihost, spmd

    rng = np.random.default_rng(3)
    rt = {"n": "add", "s": "add", "lo": "min", "hi": "max"}
    saved = flags.get("PIXIE_TORCH_VIRTUAL_SHARDS")
    flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", 4)
    try:
        assert multihost.init_multihost(f"127.0.0.1:{multihost.free_port()}", 1, 0,
                                        device="cuda")
        assert multihost.describe()["backend"] == "nccl"
        mesh = multihost.global_mesh()
        sts = [{"n": torch.from_numpy(rng.integers(0, 9, 100)).to(dev),
                "s": torch.from_numpy(rng.normal(size=100)).to(dev),
                "lo": torch.from_numpy(rng.normal(size=100)).to(dev),
                "hi": torch.from_numpy(rng.normal(size=100)).to(dev)} for _ in range(4)]
        got = spmd.collective_merge(sts, rt, mesh=mesh)
        want = m1.merge_states(rt, sts)
        assert torch.equal(got.buf, want.buf)
        assert multihost.exec_stats()["gathered_bytes"] == want.layout.nbytes
    finally:
        multihost.shutdown()
        flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", saved)


# ------------------------------------------------------ metadata and UDTFs
def test_ctx_query_on_the_card_equals_the_cpu_across_an_epoch(dev):
    """df.ctx['service'] over a UINT128 column on the card (the chain
    program's LUT opcode over the UPID codes; one feed, so F1 runs it)
    equals device="cpu" before and after an epoch change; the warm query
    after it uploads the new LUT and no column."""
    from pixie_tpu_torch.collect.schemas import SCHEMAS
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.engine.executor import device_cache_stats
    from pixie_tpu_torch.metadata import state as md_state
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import UInt128

    rng = np.random.default_rng(22)
    n = 1 << 18
    upids = [UInt128.make_upid(1 + u % 4, 100 + u, 7 + u) for u in range(80)]
    pool = np.empty(len(upids), dtype=object)
    pool[:] = upids
    ts = TableStore()
    cols = {"time_": np.arange(n, dtype=np.int64),
            "upid": pool[rng.integers(0, 80, n)].tolist(),
            "resp_status": rng.choice(np.array([200, 404, 500]), n),
            "latency": (rng.exponential(50.0, n) * 1e6).astype(np.int64)}
    for c in SCHEMAS["http_events"]:
        if c.name not in cols:
            cols[c.name] = (np.full(n, "x") if c.data_type.name == "STRING"
                            else np.zeros(n, dtype=np.int64))
    ts.create("http_events", SCHEMAS["http_events"]).write(cols)
    ups = [{"kind": "service", "uid": f"s{s}", "name": f"svc{s}", "namespace": "ns",
            "pod_uids": [f"p{p}" for p in range(8 * s, 8 * s + 8)]} for s in range(8)]
    ups += [{"kind": "pod", "uid": f"p{p}", "name": f"pod{p}", "namespace": "ns"}
            for p in range(64)]
    ups += [{"kind": "process", "upid": u, "pod_uid": f"p{i}"} for i, u in enumerate(upids[:64])]
    old = md_state.global_manager()
    mgr = md_state.MetadataStateManager(asid=1)
    mgr.apply_updates(ups)
    md_state.set_global_manager(mgr)
    src = """
import px
df = px.DataFrame(table='http_events')
df = df[df.resp_status != 404]
df.service = df.ctx['service']
df = df.groupby(['service', 'resp_status']).agg(
    cnt=('latency', px.count), total=('latency', px.sum), avg_lat=('latency', px.mean))
px.display(df, 'output')
"""
    try:
        plan = compile_pxl(src, ts.schemas()).plan
        _build.reset_launches()
        got = execute_plan(plan, ts, device=dev)["output"]
        torch.cuda.synchronize()
        assert _build.KERNELS["finalize"].by_entry.get("px_fused_partial_finalize") == 1
        _same_result(got, execute_plan(plan, ts, device="cpu")["output"],
                     ["service", "resp_status"])
        execute_plan(plan, ts, device=dev)  # warm
        # a rename alone keeps the LUT's codes (only its dictionary's strings
        # change); the rebound UPID changes them
        mgr.apply_updates([{"kind": "service", "uid": "s3", "name": "renamed",
                            "namespace": "ns"},
                           {"kind": "process", "upid": upids[0], "pod_uid": "p63"}])
        before = device_cache_stats()["lut_uploads"]
        after = execute_plan(plan, ts, device=dev)["output"]
        torch.cuda.synchronize()
        assert device_cache_stats()["lut_uploads"] == before + 1
        assert after.exec_stats["h2d_bytes"] == 0
        assert "ns/renamed" in after.to_pandas()["service"].tolist()
        _same_result(after, execute_plan(plan, ts, device="cpu")["output"],
                     ["service", "resp_status"])
    finally:
        md_state.set_global_manager(old)


def test_traced_http_events_ctx_query_on_the_card_equals_the_cpu(dev):
    """2^16 HTTP/1 exchanges of the seeded socket traffic (512 keep-alive
    connections of 128) parsed by the port's socket tracer, one connector a
    node, then chip_smoke's ctx query (status != 404, df.ctx['service'],
    count, int64 sum, mean, p50) under its metadata snapshot: one feed, so
    F1 launches once and runs the filter and the ctx LUT in its member pass,
    with no C1 launch; the answer equals the CPU route's (keys,
    counts and sums exactly, means and p50 to rtol 1e-12) and the
    generator's oracle."""
    import chip_smoke as cs

    from pixie_tpu_torch.collect.tracer import QueueEventSource
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.metadata import state as md_state
    from pixie_tpu_torch.testing import socket_traffic as traffic
    from pixie_tpu_torch.types import UInt128

    gen = traffic.Traffic("http", 512, 128, seed=23, node_of_upid=cs.md_node_of_upid(),
                          think_ms=traffic.HTTP_THINK_MS)
    events, keys = gen.events(seg_seed=123)
    sources = {n: QueueEventSource() for n in range(cs.MD_NODES)}
    col, conns = cs.st_collector(sources)
    traffic.feed_windows(col, sources, traffic.node_of([gen]), events, keys)
    want_rows = gen.truth()
    assert sum(c.stats["records"] for c in conns) == len(want_rows) == 1 << 16
    old = md_state.global_manager()
    mgr = md_state.MetadataStateManager(asid=1, node_name="node-0")
    mgr.apply_updates(cs.md_updates(UInt128))
    md_state.set_global_manager(mgr)
    try:
        plan = compile_pxl(cs.MD_SCRIPT, col.store.schemas()).plan
        _build.reset_launches()
        got = execute_plan(plan, col.store, device=dev)["output"]
        torch.cuda.synchronize()
        assert _build.KERNELS["finalize"].by_entry.get("px_fused_partial_finalize") == 1
        assert not _build.KERNELS["chain"].launches
        want = execute_plan(plan, col.store, device="cpu")["output"]
        keys_ = ["service", "resp_status"]
        g = got.to_pandas().sort_values(keys_).reset_index(drop=True)
        w = want.to_pandas().sort_values(keys_).reset_index(drop=True)
        assert list(g.columns) == list(w.columns) and len(g) == len(w)
        for c in ("service", "resp_status", "cnt", "total"):
            assert g[c].tolist() == w[c].tolist(), c
        for c in ("avg_lat", "p50"):
            np.testing.assert_allclose(g[c], w[c], rtol=1e-12, atol=0, err_msg=c)
        oracle = cs.MdOracle()
        oracle.add(np.array([r["upid"] for r in want_rows]),
                   np.array([r["resp_status"] for r in want_rows]),
                   np.array([r["latency"] for r in want_rows], dtype=np.int64))
        assert oracle.check("traced ctx query", got, moved=False)["rows_kept"] == (
            sum(r["resp_status"] != 404 for r in want_rows))
    finally:
        md_state.set_global_manager(old)
