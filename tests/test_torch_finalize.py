"""The device finalize (slice 9): P1, F2, F1 and the executor's routes through
them, pixie_tpu_torch against pixie_tpu on the CPU.

  (a) P1 (ops/pack.py) against the reference's `_state_packer`: None for
      exactly the same trees (no more leaves than dtypes), unpacked leaves
      bit for bit;
  (b) F2 (ops/finalize.py `merge_finalize`, its plain version here) against
      `_merge_finalize_fn(spec_key, rt, udas)(*states)` at N = 1, 2, 4, 8,
      with finalize_ok True and False: counts, int64 sums, min and max
      exactly, float64 sums to rtol 1e-12 (the reference sums a stacked
      axis), and the quantiles exactly equal to the reference's host
      finalize of the merged sketch (`LogHistogram.quantile`: the port reads
      its bin values from the table the host computes) and within 1 ulp of
      the reference's device finalize (XLA's pow and libm's differ in the
      last ulp at some exponents: tests/test_torch_sketch.py);
  (c) the executor end to end: the reference `PlanExecutor(...,
      force_backend="tpu")` against the port at device="cpu" over
      tests/test_fastpaths.py's store and VALUES — grouped, group-by-none,
      windowed, an empty table, a filter that keeps no row, one feed (both
      report fused_single_feed = 1), many feeds (PX_FEED_ROWS = 2^14) and a
      mesh of 4 shards (PIXIE_TORCH_VIRTUAL_SHARDS = 4);
  (d) the distributed partial path ships raw, unfinalized state;
  (e) the mixed-dictionary cluster and the batched gang read back through
      P1, with the reference's results; eight equal-layout agents read their
      gang-merged state (M1's packed output) back with no P1 call.
P1's launch plan (`P1Plan`, cached per layout) is held against the per-call
descriptor encoding the wrapper used before it: the same rows, split into
launches of at most P1_CAPACITY leaves that cover every leaf once, in order.
Inputs come from numpy seeds.  Means compare to rtol 1e-12, the quantile
columns to 1 ulp of the reference's device finalize (as (b)), every other
column exactly.
"""
import numpy as np
import pytest
import torch

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
import jax
import jax.numpy as jnp
from pixie_tpu import flags as ref_flags
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import executor as ref_executor
from pixie_tpu.ops.sketch import LogHistogram as RefHist
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.plan import AggExpr, AggOp, Call, Column, FilterOp, MapOp, MemorySinkOp
from pixie_tpu.plan import MemorySourceOp, Plan, lit
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.udf import registry as ref_registry

import pixie_tpu_torch.interop as interop
from pixie_tpu_torch import flags
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import resident
from pixie_tpu_torch.engine.executor import PlanExecutor, clear_device_cache
from pixie_tpu_torch.ops import finalize as fin
from pixie_tpu_torch.ops import pack as p1
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.parallel.spmd import make_mesh
from pixie_tpu_torch.serving import batching
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation
from pixie_tpu_torch.udf import registry as port_registry

SEC = 1_000_000_000
CPU = torch.device("cpu")
WIDTH = 514


@pytest.fixture(autouse=True)
def _env():
    """Both packages without standing views (these cases measure the rescan
    route), the reference without its flight recorder (the port has none);
    empty tiers and caches around each test."""
    saved = {f: ref_flags.get(f) for f in ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")}
    for f in saved:
        ref_flags.set_for_testing(f, False)
    port_views = flags.get("PL_MATVIEW_ENABLED")
    flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    resident.clear_for_testing()
    clear_device_cache()
    yield
    for f, v in saved.items():
        ref_flags.set_for_testing(f, v)
    flags.set_for_testing("PL_MATVIEW_ENABLED", port_views)
    resident.clear_for_testing()
    clear_device_cache()


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.asarray(t)


def _leaves(t):
    return p1.flatten(_np_tree(t))


def _same_leaf(path, a, b, rtol_sums: bool):
    assert a.dtype == b.dtype and a.shape == b.shape, path
    if rtol_sums and a.dtype == np.float64 and path[-1] == "sum":
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=str(path))
    else:
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), path
        assert a.tobytes() == b.tobytes() or a.dtype.kind == "f", path


def _same_tree(got, want, rtol_sums: bool = False):
    g, w = _leaves(got), sorted(_leaves(want), key=lambda x: x[0])
    g = sorted(g, key=lambda x: x[0])
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_p, b) in zip(g, w):
        _same_leaf(path, a, b, rtol_sums)


# ------------------------------------------------------------------ (a) P1

#: state trees: {name: (kind, dtype)}; kind "g" a [G] leaf, "sketch" [G, 514]
TREES = {
    "count": {"cnt": np.int64},
    "count_max": {"cnt": np.int64, "mx": np.float64},
    "mean": {"avg": {"sum": np.float64, "count": np.int64}},
    "minmax_i32": {"lo": np.int32, "hi": np.int32, "seen": np.int64},
    "minmax_i64": {"lo": np.int64, "hi": np.int64},
    "minmax_f64": {"lo": np.float64, "hi": np.float64, "cnt": np.int64},
    "p50": {"p50": "sketch"},
    "p50_seen": {"p50": "sketch", "seen": np.int64},
    "config1": {"cnt": np.int64, "avg": {"sum": np.float64, "count": np.int64},
                "p50": "sketch", "seen": np.int64},
    "all": {"cnt": np.int64, "avg": {"sum": np.float64, "count": np.int64},
            "lo32": np.int32, "hi64": np.int64, "lof": np.float64, "p50": "sketch",
            "seen": np.int64},
}


def _tree(spec, g, rng):
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out[k] = _tree(v, g, rng)
        elif v == "sketch":
            out[k] = rng.integers(0, 50, (g, WIDTH)).astype(np.float32)
        elif v == np.float64:
            x = rng.exponential(50.0, g)
            x[rng.random(g) < 0.1] = np.nan
            out[k] = x
        else:
            info = np.iinfo(v)
            out[k] = rng.integers(info.min, info.max, g, dtype=v)
    return out


def _torch(t):
    if isinstance(t, dict):
        return {k: _torch(v) for k, v in t.items()}
    return torch.from_numpy(np.ascontiguousarray(t))


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("g", [1, 7, 4096])
def test_state_packer_matches_reference(tree, g):
    """None for exactly the trees the reference does not pack; the port's
    packed buffer unpacks to the reference's unpacked leaves and to the
    leaves themselves, bit for bit."""
    st = _tree(TREES[tree], g, np.random.default_rng(g))
    jst = jax.tree.map(jnp.asarray, st)
    ref = ref_executor._state_packer(jst)
    layout = p1.state_packer(_torch(st))
    assert (ref is None) == (layout is None)
    if ref is None:
        assert not isinstance(p1.pack_state(_torch(st)), p1.Packed)
        return
    pack_jit, unpack = ref
    want = unpack(pack_jit(jst))
    packed = p1.pack_state(_torch(st))
    assert isinstance(packed, p1.Packed)
    assert packed.buf.dtype == torch.uint8 and packed.buf.numel() == layout.nbytes
    assert all(off % p1.ALIGN == 0 for off in layout.offsets)
    got = packed.unpack(packed.buf.numpy())
    _same_tree(got, want)
    _same_tree(got, st)


def _per_call_p1_rows(leaves, layout, base):
    """The descriptor table as the wrapper encoded it on every call before
    the plan was cached: per leaf [src, nbytes, dst], and the most 16-byte
    words of any leaf."""
    rows, max_words = [], 1
    for x, off in zip(leaves, layout.offsets):
        n = x.numel() * x.element_size()
        max_words = max(max_words, (n + p1.ALIGN - 1) // p1.ALIGN)
        rows.append([x.data_ptr(), n, base + off])
    return np.array(rows, dtype=np.int64), max_words


@pytest.mark.parametrize("tree", sorted(TREES))
@pytest.mark.parametrize("g", [1, 7, 4096])
def test_p1_plan_rows_equal_per_call_encoding(tree, g):
    """The plan cached on a layout gives the rows of the per-call encoding
    (source pointers, byte counts, buffer offsets past the base) in one
    launch, also for a tree state_packer declines (M1 writes such a merged
    state into one buffer too)."""
    st = _torch(_tree(TREES[tree], g, np.random.default_rng(g)))
    items = p1.flatten(st)
    layout = p1.Layout.of([(path, x.dtype, x.shape) for path, x in items])
    leaves = [x for _p, x in items]
    plan = layout.p1
    assert layout.p1 is plan
    base = 1 << 40
    want, max_words = _per_call_p1_rows(leaves, layout, base)
    np.testing.assert_array_equal(plan.rows(leaves, base, -1), want)
    assert plan.launches == ((0, len(leaves), max_words),)
    with pytest.raises(TypeError):
        plan.rows([x.to(torch.int16) for x in leaves], base, -1)


@pytest.mark.parametrize("n_leaves", [1, 8, 9, 64, 65, 1024, 1025, 2000, 2048])
def test_p1_plan_splits_past_one_launch(n_leaves):
    """A layout of more leaves than one launch carries splits into launches
    of at most P1_CAPACITY leaves that cover every leaf exactly once, in
    order, each sized by its own largest leaf; the rows stay those of the
    per-call encoding."""
    rng = np.random.default_rng(n_leaves)
    dts = (torch.int32, torch.int64, torch.float32, torch.float64)
    leaves = [torch.from_numpy(rng.integers(0, 100, 1 + (i * 37) % 300)).to(dts[i % 4])
              for i in range(n_leaves)]
    layout = p1.Layout.of([((f"l{i}",), x.dtype, x.shape) for i, x in enumerate(leaves)])
    plan = layout.p1
    assert len(plan.launches) == -(-n_leaves // p1.P1_CAPACITY)
    assert [i for a, b, _w in plan.launches for i in range(a, b)] == list(range(n_leaves))
    for a, b, w in plan.launches:
        assert b - a <= p1.P1_CAPACITY
        assert w == max((x.numel() * x.element_size() + 15) // 16 for x in leaves[a:b])
    base = 1 << 36
    np.testing.assert_array_equal(plan.rows(leaves, base, -1),
                                  _per_call_p1_rows(leaves, layout, base)[0])
    got = p1.pack(leaves, layout)
    assert got.numel() == layout.nbytes
    unpacked = layout.unpack(got.numpy())
    assert all(np.array_equal(unpacked[(f"l{i}")], x.numpy()) for i, x in enumerate(leaves))


def test_state_packer_is_cached_per_tree_and_spec():
    st = _torch(_tree(TREES["config1"], 64, np.random.default_rng(1)))
    assert p1.state_packer(st) is p1.state_packer(_torch(_tree(TREES["config1"], 64,
                                                              np.random.default_rng(2))))
    assert p1.state_packer(st) is not p1.state_packer(
        _torch(_tree(TREES["config1"], 65, np.random.default_rng(2))))


# ------------------------------------------------------------------ (b) F2

#: (name, registry UDA name, input dtype) of the merged tree
F2_UDAS = [("cnt", "count", None), ("avg", "mean", np.float64), ("p50", "p50", np.float64),
           ("qs", "quantiles", np.float64), ("lo", "min", np.int32), ("hi", "max", np.float64),
           ("lo64", "min", np.int64), ("__seen", "count", None)]


def _f2_states(n, g, seed):
    """n states of F2_UDAS's tree, leaves away from their identities and a
    quarter of the sketches' groups empty (NaN quantiles)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        empty = rng.random(g) < 0.25
        st = {}
        for name, fn, _dt in F2_UDAS:
            if fn == "count":
                st[name] = rng.integers(0, 1 << 40, g)
            elif fn == "mean":
                st[name] = {"sum": rng.exponential(50.0, g) * 1e3,
                            "count": rng.integers(0, 1 << 20, g)}
            elif fn in ("p50", "quantiles"):
                h = rng.integers(0, 40, (g, WIDTH)).astype(np.float32)
                h[empty] = 0.0
                st[name] = h
            elif name == "lo":
                st[name] = rng.integers(-(2 ** 31), 2 ** 31 - 1, g).astype(np.int32)
            elif name == "lo64":
                st[name] = rng.integers(-(2 ** 62), 2 ** 62, g)
            else:
                x = rng.exponential(5.0, g)
                x[rng.random(g) < 0.05] = np.nan
                st[name] = x
        out.append(st)
    return out


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("finalize_ok", [True, False])
@pytest.mark.parametrize("g", [1, 64])
def test_merge_finalize_matches_reference(n, finalize_ok, g):
    states = _f2_states(n, g, 100 * n + g)
    ref_udas = {name: ref_registry.uda(fn) for name, fn, _dt in F2_UDAS}
    port_udas = [(name, port_registry.uda(fn)) for name, fn, _dt in F2_UDAS]
    rt = {name: uda.reduce_ops() for name, uda in port_udas}
    ref_rt = {name: uda.reduce_ops() for name, uda in ref_udas.items()}
    assert rt == ref_rt
    spec_key = ("test_torch_finalize", n, g, finalize_ok)
    want_f, want_r = ref_executor._merge_finalize_fn(spec_key, ref_rt, ref_udas, finalize_ok)(
        *[jax.tree.map(jnp.asarray, s) for s in states])
    finals = fin.finals_of(port_udas, finalize_ok)
    assert set(finals) == set(want_f)
    got = fin.merge_finalize([_torch(s) for s in states], rt, finals)
    got_f, got_r = got.unpack(got.buf.numpy())
    _same_tree(got_r, want_r, rtol_sums=True)
    for name, f in finals.items():
        a, b = got_f[name], np.asarray(want_f[name])
        merged = np.sum([s[name] for s in states], axis=0)  # integer counts: exact
        host = RefHist().quantile(merged, list(f.qs))
        np.testing.assert_array_equal(a, host[:, 0] if f.squeeze else host)
        assert a.shape == b.shape and np.array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(b)
        assert (np.abs(a[ok] - b[ok]) <= np.spacing(np.abs(b[ok]))).all(), name
    assert got.buf.numel() == got.layout.nbytes


def test_merge_finalize_plain_route_is_merge_quantile_pack():
    """F2's plain version is M1's plain merge, K3's plain quantiles and P1's
    plain pack, laid out as output_layout says."""
    from pixie_tpu_torch.ops.merge import merge_states_plain

    states = [_torch(s) for s in _f2_states(3, 16, 7)]
    port_udas = [(name, port_registry.uda(fn)) for name, fn, _dt in F2_UDAS]
    rt = {name: uda.reduce_ops() for name, uda in port_udas}
    finals = fin.finals_of(port_udas)
    got_f, got_r = fin.merge_finalize(states, rt, finals).unpack(
        fin.merge_finalize(states, rt, finals).buf.numpy())
    merged = merge_states_plain(rt, states)
    for name, uda in port_udas:
        if name in finals:
            np.testing.assert_array_equal(got_f[name], uda.finalize_device(merged[name]).numpy())
    _same_tree(got_r, {k: v for k, v in merged.items() if k not in finals})


# ------------------------------------------------------------------ (c) executor

#: tests/test_fastpaths.py VALUES
VALUES = [("cnt", "count", None), ("avg", "mean", "latency"), ("p50", "p50", "latency"),
          ("p99", "p99", "latency"), ("mx", "max", "latency"), ("qs", "quantiles", "latency")]


def _stores(n=200_000, seed=0):
    """tests/test_fastpaths.py `_store`, built in both packages."""
    rng = np.random.default_rng(seed)
    data = {
        "time_": np.sort(rng.integers(0, 600 * SEC, n)).astype(np.int64),
        "latency": rng.exponential(50.0, n),
        "status": rng.choice([200, 404, 500], n).astype(np.int64),
    }
    data["service"] = rng.choice([f"svc-{i}" for i in range(12)], n).tolist()
    out = []
    for store, rel, dt in ((RefStore(), RefRelation, RefDT), (TableStore(), Relation, DT)):
        t = store.create("http_events", rel.of(("time_", dt.TIME64NS), ("service", dt.STRING),
                                               ("latency", dt.FLOAT64), ("status", dt.INT64)),
                         batch_rows=1 << 14)
        if n:
            t.write(data)
        out.append(store)
    return out


def _plan(groups, windowed=False, keep_none=False):
    p = Plan()
    node = p.add(MemorySourceOp(table="http_events"))
    if keep_none:
        node = p.add(FilterOp(expr=Call("equal", (Column("status"), lit(999)))),
                     parents=[node])
    if windowed:
        node = p.add(MapOp(exprs=[("time_", Call("bin", (Column("time_"), lit(10 * SEC)))),
                                  ("service", Column("service")),
                                  ("latency", Column("latency"))]), parents=[node])
    agg = p.add(AggOp(groups=groups, values=[AggExpr(*v) for v in VALUES],
                      windowed=windowed), parents=[node])
    p.add(MemorySinkOp(name="out"), parents=[agg])
    return p


def _same_frames(got, want, keys):
    g, w = got.to_pandas(), want.to_pandas()
    if keys:
        g = g.sort_values(keys).reset_index(drop=True)
        w = w.sort_values(keys).reset_index(drop=True)
    assert list(g.columns) == list(w.columns) and len(g) == len(w)
    for c in w.columns:
        a, b = g[c].to_numpy(), w[c].to_numpy()
        if c == "avg":
            np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                       rtol=1e-12, atol=0)
        elif c in ("p50", "p99"):
            a, b = a.astype(np.float64), b.astype(np.float64)
            assert np.array_equal(np.isnan(a), np.isnan(b)), c
            ok = ~np.isnan(b)
            assert (np.abs(a[ok] - b[ok]) <= np.spacing(np.abs(b[ok]))).all(), c
        elif a.dtype.kind == "f" or b.dtype.kind == "f":
            assert np.array_equal(a.astype(np.float64), b.astype(np.float64),
                                  equal_nan=True), c
        else:
            assert a.tolist() == b.tolist(), c


def _run_both(plan, stores, mesh=None, ref_mesh=None):
    ref_ts, ts = stores
    rex = ref_executor.PlanExecutor(plan, ref_ts, force_backend="tpu", mesh=ref_mesh)
    want = rex.run()["out"]
    ex = PlanExecutor(interop.plan_from_dict(plan.to_dict()), ts, device="cpu", mesh=mesh)
    got = ex.run()["out"]
    return got, want, ex.stats, rex.stats


CASES = {
    "grouped": (["service", "status"], False, False),
    "group_by_none": ([], False, False),
    "windowed": (["time_", "service"], True, False),
    "keeps_no_row": (["service"], False, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_feed_query_is_one_fused_execution(case):
    """One feed: both packages run the query as their fused single-feed
    execution (fused_single_feed = 1) and agree."""
    groups, windowed, keep_none = CASES[case]
    # 12 sealed batches and no hot remainder (which would stream as a feed
    # of its own in both packages)
    got, want, st, rst = _run_both(_plan(groups, windowed, keep_none),
                                   _stores(n=12 * (1 << 14)))
    assert st["feeds"] == 1 and st.get("fused_single_feed") == 1
    assert rst.get("fused_single_feed") == 1
    _same_frames(got, want, groups)


@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_feed_query_merge_finalizes(case, monkeypatch):
    """PX_FEED_ROWS = 2^14 (13 feeds): the per-feed route, then F2 (N = 1 in
    the port, the reference's merge of 13 partials); no fused execution."""
    groups, windowed, keep_none = CASES[case]
    monkeypatch.setattr(ref_executor, "FEED_ROWS", 1 << 14)
    saved = flags.get("PX_FEED_ROWS")
    flags.set_for_testing("PX_FEED_ROWS", 1 << 14)
    try:
        got, want, st, rst = _run_both(_plan(groups, windowed, keep_none), _stores())
    finally:
        flags.set_for_testing("PX_FEED_ROWS", saved)
    assert st["feeds"] > 1 and "fused_single_feed" not in st
    assert "fused_single_feed" not in rst
    _same_frames(got, want, groups)


@pytest.mark.parametrize("groups", [["service", "status"], []])
def test_empty_table(groups):
    """No feed at all: the identity state's finalize (no row grouped, one
    row of the identity for group-by-none), as the reference's."""
    got, want, st, _rst = _run_both(_plan(groups), _stores(n=0))
    assert st["feeds"] == 0 and "fused_single_feed" not in st
    _same_frames(got, want, groups)


@pytest.mark.parametrize("case", ["grouped", "windowed"])
def test_mesh_query_merge_finalizes_the_shards(case):
    """A mesh of 4 co-located shards: F2 merges the shards' states (N = 4)
    as it finalizes; equal to the reference over its 4-device mesh."""
    from pixie_tpu.parallel import spmd as ref_spmd
    import pixie_tpu_torch.parallel  # noqa: F401  (defines the flag)

    groups, windowed, keep_none = CASES[case]
    saved = flags.get("PIXIE_TORCH_VIRTUAL_SHARDS")
    flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", 4)
    try:
        got, want, st, rst = _run_both(_plan(groups, windowed, keep_none), _stores(),
                                       mesh=make_mesh(4, device="cpu"),
                                       ref_mesh=ref_spmd.make_mesh(4))
    finally:
        flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", saved)
    assert st["spmd_feeds"] >= 1 and "fused_single_feed" not in st
    _same_frames(got, want, groups)


def test_limit_query_keeps_its_route():
    """A limit threads budgets through the feeds: no fused execution, the
    K3 route (its plain version here), equal to the reference's."""
    p = Plan()
    node = p.add(MemorySourceOp(table="http_events"))
    from pixie_tpu.plan import LimitOp

    node = p.add(LimitOp(n=5000), parents=[node])
    agg = p.add(AggOp(groups=["service"], values=[AggExpr(*v) for v in VALUES]),
                parents=[node])
    p.add(MemorySinkOp(name="out"), parents=[agg])
    got, want, st, _rst = _run_both(p, _stores())
    assert "fused_single_feed" not in st
    _same_frames(got, want, ["service"])


#: (rows written, PX_FEED_ROWS): one sealed feed; sealed rows and a hot
#: remainder; many feeds; none
FEED_SHAPES = {"one_sealed": (12 * (1 << 14), 1 << 24),
               "sealed_and_hot": (12 * (1 << 14) + 100, 1 << 24),
               "many": (200_000, 1 << 14), "empty": (0, 1 << 24)}


@pytest.mark.parametrize("shape", sorted(FEED_SHAPES))
def test_single_feed_prediction_follows_the_feeds(shape):
    """The executor's prediction of one feed and its feeds come from one
    policy (_feed_batches): predicted exactly when at most one feed comes."""
    from pixie_tpu_torch.engine.executor import _feed_batches

    n, feed_rows = FEED_SHAPES[shape]
    saved = flags.get("PX_FEED_ROWS")
    flags.set_for_testing("PX_FEED_ROWS", feed_rows)
    try:
        ts = _stores(n=n)[1]
        plan = interop.plan_from_dict(_plan(["service"]).to_dict())
        ex = PlanExecutor(plan, ts, device="cpu")
        (op,) = [o for o in plan.topo_sorted() if o.__class__.__name__ == "AggOp"]
        s = ex._agg_setup(op)
        feeds = [n_valid for _cols, n_valid in ex._feed(s.src, s.names, s.cap)]
        policy = [sum(rb.num_valid for rb, _g in b)
                  for b, _cold in _feed_batches(s.src, max(s.cap, feed_rows))]
    finally:
        flags.set_for_testing("PX_FEED_ROWS", saved)
    assert feeds == policy and sum(feeds) == n
    assert ex._predicted_single_feed(s.src, s.cap) == (len(feeds) <= 1)
    assert len(feeds) == {"one_sealed": 1, "sealed_and_hot": 2, "empty": 0}.get(shape, 13)


@pytest.mark.parametrize("case", sorted(CASES))
def test_f1_plan_is_the_launch_table_at_any_address(case):
    """F1's plan, built once per aggregate shape, patched with a launch
    buffer's address equals the row table built for that buffer directly
    (fill rows at each leaf update's state with its identity, a quantile
    row per final reading its sketch, its quantiles and bin values in the
    plan's constant buffer), and a member over a second buffer updates the
    plan's leaves in the plan's order."""
    groups, windowed, keep_none = CASES[case]
    ts = _stores(n=12 * (1 << 14))[1]
    plan = interop.plan_from_dict(_plan(groups, windowed, keep_none).to_dict())
    ex = PlanExecutor(plan, ts, device="cpu")
    (op,) = [o for o in plan.topo_sorted() if o.__class__.__name__ == "AggOp"]
    s = ex._agg_setup(op)
    (cols, n_valid), = list(ex._feed(s.src, s.names, s.cap))
    luts = {k: torch.as_tensor(v) for k, v in s.kern.luts.items()}
    finals = fin.finals_of((name, uda) for name, uda, _vb in s.udas)
    template = {name: uda.init(s.num_groups, dt, "meta") for name, uda, dt in s.init_specs}
    layout, leaves, total = fin._state_leaves(template, finals)

    def member_over(buf):
        state = fin._views(buf, leaves)
        return state, s.kern.gang_member(cols, n_valid, 0, 2 ** 62, luts, state, s.origins)

    buf = torch.empty(total, dtype=torch.uint8)
    state, member = member_over(buf)
    f1 = fin.f1_plan(layout, leaves, total, finals, member, buf.data_ptr(), "cpu")
    consts = fin.consts_for(finals, "cpu")
    assert f1.consts is consts
    for name, f in finals.items():
        qs_at, binv_at = consts.at[name]
        words = consts.buf.numpy()
        base = consts.buf.data_ptr()
        assert tuple(words[(qs_at - base) // 8:][:len(f.qs)]) == f.qs
        assert np.array_equal(words[(binv_at - base) // 8:][:f.sketch.width],
                              f.sketch.bin_value(np.arange(f.sketch.width)))
    for b in (buf, torch.empty(total + 64, dtype=torch.uint8)[16:]):
        state, member = member_over(b)
        want = fin._Table(1)
        for lf in member.leaves:
            want.fill(lf.state.dtype, lf.state.numel(), lf.state.data_ptr(),
                      fin._identity_bits(lf.op, lf.state.dtype))
        for path, shp, off in zip(layout.paths, layout.shapes, layout.offsets):
            if path[0] == "finals":
                want.quantile(finals[path[1]], shp[0], b.data_ptr() + off,
                              [state[path[1]].data_ptr()], *consts.at[path[1]])
        assert np.array_equal(f1.table_at(b.data_ptr()), want.array())
        assert tuple((lf.op, lf.state.data_ptr() - b.data_ptr())
                     for lf in member.leaves) == f1.fills
    assert f1.n_fill == len(member.leaves) and f1.n_rows == f1.n_fill + len(finals)
    assert f1.layout == layout and f1.total == total


@pytest.mark.parametrize("fn", ["p50", "quantiles"])
def test_sketch_gang_leaves_need_no_init(fn):
    """A warm F1 query builds its member from the cached plan without
    calling init: a fresh sketch UDA's gang and update take its sketch all
    the same."""
    uda = port_registry.uda(fn)
    state = torch.zeros(3, WIDTH, dtype=torch.float32)
    ((op, leaf, sketch),) = uda.gang_leaves(state)
    assert op == "hist" and leaf is state and sketch.width == WIDTH
    uda.update(state, torch.tensor([0, 2], dtype=torch.int32),
               torch.tensor([1.5, 80.0], dtype=torch.float64), torch.ones(2, dtype=torch.bool), 3)
    assert state.sum().item() == 2.0


# ------------------------------------------------- (d), (e) the raw-state paths

SCRIPT = """
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(cnt=('latency', px.count), p50=('latency', px.p50))
px.display(df, 'out')
"""


def _cluster_stores(seeds, services=None):
    """One store per agent in both packages, built as tests/test_fastpaths.py
    `_store` builds them (services: per agent, a subset of the 12)."""
    ref, port = {}, {}
    for i, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        n = 50_000
        names = services[i] if services else [f"svc-{j}" for j in range(12)]
        data = {"time_": np.sort(rng.integers(0, 600 * SEC, n)).astype(np.int64),
                "latency": rng.exponential(50.0, n),
                "status": rng.choice([200, 404, 500], n).astype(np.int64),
                "service": rng.choice(names, n).tolist()}
        for out, store, rel, dt in ((ref, RefStore(), RefRelation, RefDT),
                                    (port, TableStore(), Relation, DT)):
            store.create("http_events", rel.of(
                ("time_", dt.TIME64NS), ("service", dt.STRING), ("latency", dt.FLOAT64),
                ("status", dt.INT64)), batch_rows=1 << 14).write(data)
            out[f"pem{i}"] = store
    return ref, port


@pytest.fixture
def pack_calls(monkeypatch):
    """Counts P1's packs (its launch counter cannot rise on the CPU)."""
    calls = []
    real = p1.pack

    def counting(leaves, layout):
        calls.append(len(leaves))
        return real(leaves, layout)

    monkeypatch.setattr(p1, "pack", counting)
    return calls


def test_distributed_partial_ships_raw_state():
    """tests/test_fastpaths.py:86: the partial wire path ships raw,
    mergeable state — each agent's p50 is its [G, 514] sketch, never a
    finalized quantile — and the cluster's answer equals the reference's."""
    ref_stores, stores = _cluster_stores([1, 2])
    cl = LocalCluster(stores, device="cpu")
    q = compile_pxl(SCRIPT, cl.schemas())
    ap = cl.planner.plan(q.plan).agent_plans["pem0"]
    ex = PlanExecutor(ap, stores["pem0"], device="cpu")
    (payload,) = ex.run_agent().values()
    assert payload.states["p50"].ndim == 2 and payload.states["p50"].shape[1] == WIDTH
    assert "fused_single_feed" not in ex.stats
    got = cl.query(SCRIPT)["out"]
    want = RefCluster(ref_stores, n_devices_per_agent=1).query(SCRIPT)["out"]
    _same_frames(got, want, ["service"])


def test_mixed_dictionary_cluster_reads_back_through_p1(pack_calls):
    """Agents whose dictionaries differ take the host value-keyed merge: each
    agent's raw state is packed by P1 into one buffer, the wave stays one
    pull, and the answer equals the reference's."""
    svcs = [[f"svc-{j}" for j in range(0, 8)], [f"svc-{j}" for j in range(4, 12)],
            [f"svc-{j}" for j in range(2, 6)]]
    ref_stores, stores = _cluster_stores([3, 4, 5], svcs)
    got = LocalCluster(stores, device="cpu").query(SCRIPT)["out"]
    assert len(pack_calls) == 3  # one pack per agent state (cnt, p50, seen)
    want = RefCluster(ref_stores, n_devices_per_agent=1).query(SCRIPT)["out"]
    _same_frames(got, want, ["service"])


CONFIG4_SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(df, 'output')
"""


def test_gang_merged_cluster_state_reads_back_without_p1(pack_calls, monkeypatch):
    """Config #4's script over eight agents with equal dictionaries: M1 (its
    plain route here) merges their states once into one packed buffer,
    which reads back with no P1 call; the answer equals the reference's."""
    from pixie_tpu_torch.engine import executor as port_executor

    merged = []
    real = port_executor.merge_states

    def recording(reduce_tree, states):
        out = real(reduce_tree, states)
        merged.append((len(states), out))
        return out

    monkeypatch.setattr(port_executor, "merge_states", recording)
    ref_stores, stores = _cluster_stores([7] * 8)
    got = LocalCluster(stores, device="cpu").query(CONFIG4_SCRIPT)["output"]
    assert [n for n, _out in merged] == [8]
    assert isinstance(merged[0][1], p1.Packed)
    assert pack_calls == []
    want = RefCluster(ref_stores, n_devices_per_agent=1).query(CONFIG4_SCRIPT)["output"]
    _same_frames(got, want, ["service", "status"])


def test_batched_gang_reads_back_through_p1(pack_calls):
    """The fused agent plan of the reference load harness's scripts runs as
    one gang (G1's plain version here); its states read back through P1 in
    one wave, and every member's answer equals the reference's solo one."""
    from tests.test_torch_batching import BATCH_SCRIPTS

    ref_stores, stores = _cluster_stores([6])
    saved = flags.get("PX_MQ_FUSION")
    flags.set_for_testing("PX_MQ_FUSION", 1)
    try:
        cl = LocalCluster(stores, device="cpu")
        qs = [compile_pxl(s, cl.schemas()) for s in BATCH_SCRIPTS]
        fused, _slots = batching.fuse_members([(f"q{i}", q.plan) for i, q in enumerate(qs)],
                                              cl.schemas())
        ap = cl.planner.plan(fused).agent_plans["pem0"]
        ex = PlanExecutor(ap, stores["pem0"], device="cpu")
        ex.run_agent()
        assert ex.stats["mq_fused"] == len(BATCH_SCRIPTS)
        assert len(pack_calls) == len(BATCH_SCRIPTS)
        n_packs = len(pack_calls)
        ref = RefCluster(ref_stores, n_devices_per_agent=1)
        keys = [["service", "status"], ["service"], ["status"], ["service"]]
        for script, by in zip(BATCH_SCRIPTS, keys):
            got = cl.query(script)["out"]
            want = ref.query(script)["out"]
            _same_frames(got, want, by)
        assert len(pack_calls) > n_packs  # solo partials read back through P1 too
    finally:
        flags.set_for_testing("PX_MQ_FUSION", saved)


# ------------------------------------- F1's and F2's tables past capacity


def _wide_plan(values):
    p = Plan()
    node = p.add(MemorySourceOp(table="http_events"))
    agg = p.add(AggOp(groups=["service"], values=[AggExpr(*v) for v in values]),
                parents=[node])
    p.add(MemorySinkOp(name="out"), parents=[agg])
    return p


#: aggregates whose F1 table fits one launch, and ones past it: 31 counts
#: (+ seen: 32 leaf updates, the most), 32 counts (33 leaves), 23 p50s (24
#: leaves and 47 rows, the most) and 24 p50s (25 leaves, 49 rows)
WIDE = {
    "32_leaves": ([(f"c{i}", "count", None) for i in range(31)], True),
    "33_leaves": ([(f"c{i}", "count", None) for i in range(32)], False),
    "47_rows": ([(f"p{i}", "p50", "latency") for i in range(23)], True),
    "49_rows": ([(f"p{i}", "p50", "latency") for i in range(24)], False),
}


@pytest.mark.parametrize("case", sorted(WIDE))
def test_single_feed_prediction_declines_an_f1_table_past_capacity(case):
    """A one-feed aggregate whose F1 table does not fit one launch (32 leaf
    updates, 48 fill and quantile rows) is declined by the single-feed
    prediction before any launch: it takes the multi-feed route (F2),
    counted in exec_stats["f1_declined"], with the reference's results."""
    values, fits = WIDE[case]
    plan = _wide_plan(values)
    stores = _stores(n=1 << 14)
    got, want, stats, _rstats = _run_both(plan, stores)
    assert stats.get("fused_single_feed", 0) == int(fits)
    assert stats.get("f1_declined", 0) == int(not fits)
    g = got.to_pandas().sort_values("service").reset_index(drop=True)
    w = want.to_pandas().sort_values("service").reset_index(drop=True)
    assert list(g.columns) == list(w.columns) and list(g["service"]) == list(w["service"])
    for c in w.columns[1:]:
        a, b = g[c].to_numpy(), w[c].to_numpy()
        if c.startswith("p"):  # to 1 ulp of the reference's device finalize
            assert (np.abs(a - b) <= np.spacing(np.abs(b))).all(), c
        else:
            assert a.tolist() == b.tolist(), c
    ex = PlanExecutor(interop.plan_from_dict(plan.to_dict()), stores[1], device="cpu")
    (op,) = [o for o in ex.plan.topo_sorted() if o.__class__.__name__ == "AggOp"]
    s = ex._agg_setup(op)
    from pixie_tpu_torch.engine.executor import f1_shape

    ok, n_leaves, n_finals = f1_shape(s.num_groups, s.init_specs, s.udas)
    assert ok and fin.f1_fits(n_leaves, n_finals) == fits
    assert ex._predicted_single_feed(s.src, s.cap) is True
    assert ex._predicted_single_feed(s.src, s.cap, (ok, n_leaves, n_finals)) == fits


def test_f1_launch_key_holds_the_members_program():
    """F1's launch cache: aggregates of one state shape (by service and
    status: count, mean, p50) share F1Plan's key (f1_key) whatever their
    chain; their members' gang_key, which keys the launch (the member's
    encoding holds its program), differs between two filter literals and
    for a deeper filter, and is the same for the same chain compiled
    again (programs are interned by contents)."""
    from pixie_tpu_torch.engine.executor import f1_key
    from pixie_tpu_torch.ops import gang as g1

    store = _stores(n=1 << 12)[1]
    chains = ("df = df[df.status != 404]\n", "df = df[df.status != 500]\n",
              "df = df[(df.status != 404) & (df.latency * 2.0 > df.latency - 1.0)]\n",
              "df = df[df.status != 404]\n")
    keys = []
    for chain in chains:
        src = ("df = px.DataFrame(table='http_events')\n" + chain +
               "df = df.groupby(['service', 'status']).agg(cnt=('latency', px.count), "
               "avg=('latency', px.mean), p50=('latency', px.p50))\npx.display(df, 'out')\n")
        ex = PlanExecutor(compile_pxl(src, store.schemas()).plan, store, device="cpu")
        (op,) = [o for o in ex.plan.topo_sorted() if o.__class__.__name__ == "AggOp"]
        s = ex._agg_setup(op)
        state = {name: uda.init(s.num_groups, dt, "cpu") for name, uda, dt in s.init_specs}
        cols = {k: torch.zeros(4, dtype=torch.float64 if k == "latency" else torch.int64)
                for k in s.names}
        luts = {k: torch.as_tensor(v) for k, v in s.kern.luts.items()}
        m = s.kern.gang_member(cols, 4, 0, 1, luts, state, s.origins)
        keys.append((f1_key(s.num_groups, s.init_specs), g1.gang_key([m], torch.device("cpu")),
                     m.prog.depth))
    assert len({k[0] for k in keys}) == 1
    assert len({k[1] for k in keys[:3]}) == 3 and keys[3][1] == keys[0][1]
    assert keys[2][2] > keys[0][2]


def _leafy_f2_states(n_states, n_leaves, g, seed):
    rng = np.random.default_rng(seed)
    dts = (torch.int64, torch.float64, torch.int32)
    out = []
    for _ in range(n_states):
        st = {f"l{i}": torch.from_numpy(rng.integers(-100, 100, g)).to(dts[i % 3])
              for i in range(n_leaves)}
        st["p50"] = torch.from_numpy(rng.integers(0, 8, (g, WIDTH)).astype(np.float32))
        out.append(st)
    rt = {**{f"l{i}": ("add", "min", "max")[i % 3] for i in range(n_leaves)}, "p50": "add"}
    return out, rt


def _per_call_f2_rows(states, rt, finals, layout, base, consts):
    """The row table as the wrapper encoded it on every call before the plan
    was cached: a quantile row per final, a merge row per other leaf."""
    table = fin._Table(len(states))
    for path, d, s, off in zip(layout.paths, layout.dtypes, layout.shapes, layout.offsets):
        if path[0] == "finals":
            table.quantile(finals[path[1]], s[0], base + off,
                           [st[path[1]].data_ptr() for st in states], *consts.at[path[1]])
            continue
        n = int(np.prod(s))
        xs = [fin._get(st, path[1:]) for st in states]
        vec = not any(p & 15 for p in [base + off, *(x.data_ptr() for x in xs)])
        table.merge(fin._get(rt, path[1:]), d, n, base + off, [x.data_ptr() for x in xs], vec)
    return table.array().reshape(len(table.rows), -1)


@pytest.mark.parametrize("n_states,n_leaves", [(1, 3), (4, 40), (8, 300), (8, 700)])
def test_f2_plan_rows_equal_per_call_encoding_and_split(n_states, n_leaves):
    """F2's plan, cached per tree, finals and N, gives the rows of the
    per-call encoding (the quantiles and bin values read from the plan's
    constant buffer); past one launch's table (F2_WORDS) it splits into
    launches of whole rows that cover every row once, in order, each within
    the capacity; the plain route's output is the same either way."""
    states, rt = _leafy_f2_states(n_states, n_leaves, 5, n_leaves)
    finals = {"p50": fin.Final(fin.LogHistogram(), (0.5,), True)}
    plan = fin.f2_plan_for(states, rt, finals, torch.device("cpu"))
    assert fin.f2_plan_for(states, rt, finals, torch.device("cpu")) is plan
    width = 6 + n_states
    n_rows = n_leaves + 1
    assert [i for a, b, _v, _s in plan.launches for i in range(a, b)] == list(range(n_rows))
    assert all((b - a) * width <= fin.F2_WORDS[-1] for a, b, _v, _s in plan.launches)
    assert len(plan.launches) == -(-n_rows // (fin.F2_WORDS[-1] // width))
    base = 1 << 40
    rows, vec = plan.rows(states, base, -1)
    want = _per_call_f2_rows(states, rt, finals, plan.layout, base, plan.consts)
    np.testing.assert_array_equal(rows, want)
    got = fin.merge_finalize(states, rt, finals)
    ref = fin.merge_finalize_plain(states, rt, finals)
    assert torch.equal(got.buf, ref.buf)


def test_f1_pass_planner_widths_and_private_leaves():
    """F1's member pass: 1024 threads of 2 rows with the whole state
    private where it fits beside the stack and slots (config #1's
    64-group state), of 1 row for a deeper program; past that the sketch on
    global atomics and the small leaves private (1,024 groups: 256 threads
    of 4 rows), 256 threads of one row for a program too deep for the rest;
    every plan within the 227 KB a block may opt in to.  G1's pass runs 256
    threads of 4 rows (fewer for a deeper program) within BLOCK_SMEM, its
    members' states private in order within SHARED_STATE_BYTES.  F1's warps
    combine their rows of one group in a 1024-thread layout for a member of
    at most COMBINE_GROUPS groups; G1's never do."""
    from pixie_tpu_torch.ops import chain as c1
    from pixie_tpu_torch.ops import gang as g1
    from pixie_tpu_torch.ops.sketch import LogHistogram

    def member(groups, depth):
        b = c1.ProgramBuilder()
        for _ in range(depth):
            b.col("x", c1.I64)
        for _ in range(depth - 1):
            b.op("ADD_I")
        b.const(0, c1.I64)
        b.op("GE_I")
        b.mask_and()
        prog, _bnd = b.finish()
        sk = LogHistogram()
        leaves = [g1.Leaf("count", torch.zeros(groups, dtype=torch.int64)),
                  g1.Leaf("sum", torch.zeros(groups, dtype=torch.float64), 0),
                  g1.Leaf("count", torch.zeros(groups, dtype=torch.int64)),
                  g1.Leaf("hist", torch.zeros(groups, sk.width), 0, sk),
                  g1.Leaf("count", torch.zeros(groups, dtype=torch.int64))]
        return g1.Member(prog, [], [], [], groups, leaves)

    cfg1 = g1.plan_f1_pass(member(64, 3))
    assert (cfg1.block, cfg1.rows_per_thread, cfg1.hist_shared) == (1024, 2, True)
    assert cfg1.offs == (0,) and cfg1.acc_bytes == 64 * (4 + 8 + 4 + 514 * 4 + 4)
    assert cfg1.combine
    deeper = g1.plan_f1_pass(member(64, 8))
    assert (deeper.block, deeper.rows_per_thread, deeper.hist_shared) == (1024, 1, True)
    cfg2 = g1.plan_f1_pass(member(1024, 3))
    assert (cfg2.block, cfg2.rows_per_thread, cfg2.hist_shared) == (256, 4, False)
    assert cfg2.offs == (0,) and cfg2.acc_bytes == 1024 * (4 + 8 + 4 + 4)
    deep = g1.plan_f1_pass(member(64, 31))
    assert (deep.block, deep.rows_per_thread, deep.hist_shared) == (256, 1, False)
    for p in (cfg1, cfg2, deep):
        assert p.smem <= g1.SMEM_OPTIN
    wider = g1.plan_f1_pass(member(g1.COMBINE_GROUPS + 1, 3))
    assert (wider.block, wider.rows_per_thread, wider.hist_shared) == (1024, 2, True)
    assert not wider.combine and not cfg2.combine and not deep.combine
    gang = g1.plan_pass([member(3, 3), member(64, 3), member(1 << 20, 3)])
    assert (gang.block, gang.rows_per_thread) == (256, 4) and not gang.combine
    assert gang.offs == (0, None, None) and gang.smem <= g1.BLOCK_SMEM
    for depth, layout in ((14, (256, 2)), (31, (256, 1))):
        deep_gang = g1.plan_pass([member(3, depth), member(3, 3)])
        assert (deep_gang.block, deep_gang.rows_per_thread) == layout
        assert deep_gang.smem <= g1.BLOCK_SMEM
