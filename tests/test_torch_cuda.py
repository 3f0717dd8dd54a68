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
