"""The port's CUDA kernels against their plain versions, on the card.

These need a CUDA card and nvcc; elsewhere they skip.  On a machine with a
card and no JAX, run them without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
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
    before = _build.KERNELS["merge"].launches
    got = LocalCluster(stores(), device=dev).query(script)["output"].to_pandas()
    assert _build.KERNELS["merge"].launches == before + 1
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
