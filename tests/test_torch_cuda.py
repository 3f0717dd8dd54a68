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


@pytest.mark.parametrize("n", [1, 4095, 4097, 1 << 20])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.9, 1.0])
def test_compact_equals_stable_partition(dev, n, density):
    rng = np.random.default_rng(5)
    m = torch.from_numpy(rng.random(n) < density).to(dev)
    cols = [torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n)).to(dev),
            torch.from_numpy(rng.normal(size=n)).to(dev),
            torch.from_numpy(rng.random(n) < 0.5).to(dev),
            torch.from_numpy(rng.integers(0, 100, n).astype(np.int16)).to(dev)]
    before = _build.KERNELS["compact"].launches
    got, count = k4.compact(m, cols)
    assert _build.KERNELS["compact"].launches == before + 1
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
    # rows agree as a set within each code (atomics order them per run);
    # only the first sum(cnt) slots are written (the -1 rows have none)
    rows = rows[: rows0.shape[0]]
    assert torch.equal(torch.sort(b[rows.long()] * (1 << 20) + rows).values,
                       torch.sort(b[rows0.long()] * (1 << 20) + rows0).values)
    cnt_p, lo_p, total = jd.join_probe(p, cnt, first)
    cnt_p0, lo_p0, total0 = jd.join_probe_plain(p, cnt0, first0)
    assert torch.equal(cnt_p, cnt_p0) and torch.equal(lo_p, lo_p0)
    assert int(total) == int(total0)


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
    for name in ("join_build_plain", "join_probe_plain", "join_expand_plain"):
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

    cluster = LocalCluster(stores(), device=dev)
    cluster.query(script)  # warm: tier admission, the plan cache
    torch.cuda.synchronize()
    _build.reset_launches()
    transfer.pull_states = pull_states
    try:
        got = cluster.query(script)["output"].to_pandas()
    finally:
        transfer.pull_states = real_pull
    assert _build.KERNELS["merge"].launches == 1
    # the merged state is M1's packed buffer: no P1, one copy
    assert _build.KERNELS["pack"].launches == 0
    assert len(pulls) == 1 and len(pulls[0][0]) == 1
    assert isinstance(pulls[0][0][0], m1.Packed) and pulls[0][1] == 1
    want = LocalCluster(stores(), device="cpu").query(script)["output"].to_pandas()
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
#: d over one shared-memory tile, k over one register tile
_KM_SHAPES = [(1 << 16, 64, 64), (5000, 16, 1), (4099, 8, 300), (3001, 13, 7),
              (1, 3, 1), (2000, 150, 200), (10000, 64, 129)]


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
