"""SPMD aggregation over a mesh: pixie_tpu_torch against pixie_tpu.

The reference runs its mesh paths on the 8 virtual CPU devices that
tests/conftest.py provides (`make_mesh(n)`, psum / pmin / pmax inside
shard_map).  The port runs the same paths over n co-located CPU shards
(PIXIE_TORCH_VIRTUAL_SHARDS = 8; parallel/spmd.py): each shard updates its
own state, and the collective merge is ops/merge.py's `collective_merge`
(kernel M1 on the card, its plain version here).  Inputs come from numpy
seeds.  Counts, int64 sums, min, max and sketch quantiles must match
exactly; float64 sums and means to rtol 1e-12 (another summation order).

The cases of tests/test_spmd.py and the cases of tests/test_sharded_parity.py
that need no `shard_bench` harness run here, plus the carry form, the
per-shard valid tails, a shard that gets no row, a mesh whose width does not
split the feeds, the gang over a mesh and the mesh gates.
"""
import numpy as np
import pytest
import torch

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import resident as ref_resident
from pixie_tpu.engine.executor import ChainKernel as RefKernel
from pixie_tpu.engine.executor import GroupKey as RefGroupKey
from pixie_tpu.engine.executor import PlanExecutor as RefExecutor
from pixie_tpu.engine.executor import clear_device_cache as ref_clear_cache
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.parallel import spmd as ref_spmd
from pixie_tpu.parallel.shard_bench import N_SERVICES, agg_plan, shard_cols
from pixie_tpu.plan import Call, Column, FilterOp, lit
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.table.dictionary import Dictionary as RefDictionary
from pixie_tpu.types import DataType as DT, Relation as RefRelation
from pixie_tpu.udf import registry as ref_registry

import pixie_tpu_torch.interop as interop
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch import metrics
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import resident
from pixie_tpu_torch.engine.executor import INT64_MAX, INT64_MIN, ChainKernel, GroupKey
from pixie_tpu_torch.engine.executor import PlanExecutor, clear_device_cache
from pixie_tpu_torch.parallel import LocalCluster, spmd
from pixie_tpu_torch.parallel.spmd import (
    collective_gate,
    collective_merge,
    collective_merge_carry,
    make_mesh,
    per_shard_valid,
    reduce_tree_for,
    shard_batches,
    spmd_agg_step,
    spmd_multi_partial_step,
    spmd_partial_step,
)
from pixie_tpu_torch.ops.pack import Packed
from pixie_tpu_torch.plan import plan as port_plan
from pixie_tpu_torch.status import Unimplemented
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.types import Relation
from pixie_tpu_torch.udf import registry

N_DEV = 8
ROWS_PER_DEV = 512
N = N_DEV * ROWS_PER_DEV
NOW = 1_700_000_000_000_000_000
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _mesh_env():
    """8 co-located CPU shards for the port (the reference's conftest gives
    it 8 virtual devices); both packages without standing views (these
    cases measure the rescan route), the reference without its flight
    recorder, which the port does not have; empty tiers."""
    saved = {f: ref_flags.get(f) for f in ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")}
    for f in saved:
        ref_flags.set_for_testing(f, False)
    port_views = port_flags.get("PL_MATVIEW_ENABLED")
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    port_flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", N_DEV)
    for clear in (ref_resident.clear_for_testing, ref_clear_cache,
                  resident.clear_for_testing, clear_device_cache):
        clear()
    yield
    port_flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", 1)
    for f, v in saved.items():
        ref_flags.set_for_testing(f, v)
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", port_views)
    for clear in (ref_resident.clear_for_testing, ref_clear_cache,
                  resident.clear_for_testing, clear_device_cache):
        clear()


# ------------------------------------------------------------ lifted steps
AGGS = [("cnt", "count", None), ("total", "sum", "latency"), ("lo", "min", "latency"),
        ("hi", "max", "latency"), ("avg", "mean", "latency")]


def _ref_agg():
    """filter(status == 200) + group by service + count/sum/min/max/mean,
    the reference's kernel (tests/test_spmd.py build_agg)."""
    d = RefDictionary(["a", "b", "c"])
    dtypes = {"service": DT.STRING, "status": DT.INT64, "latency": DT.FLOAT64}
    kern = RefKernel(dtypes, {"service": d},
                     [FilterOp(expr=Call("equal", (Column("status"), lit(200))))],
                     ref_registry, time_col=None)
    keys = [RefGroupKey("service", "dict", 4, DT.STRING, d,
                        key_sval=kern.ctx.sym["service"])]
    udas, state = [], {}
    for out, fn, arg in AGGS:
        uda = ref_registry.uda(fn)
        udas.append((out, uda, kern.ctx.sym[arg].build if arg else None))
        state[out] = uda.init(4, np.float64)
    kern.make_agg_step(keys, udas, 4)
    return kern, udas, state


def _port_agg():
    """The same kernel in the port, on the CPU."""
    from pixie_tpu_torch.plan.plan import Call as PCall, Column as PColumn
    from pixie_tpu_torch.plan.plan import FilterOp as PFilter, lit as plit

    d = Dictionary(["a", "b", "c"])
    dtypes = {"service": DT.STRING, "status": DT.INT64, "latency": DT.FLOAT64}
    kern = ChainKernel(dtypes, {"service": d},
                       [PFilter(expr=PCall("equal", (PColumn("status"), plit(200))))],
                       registry, None, CPU)
    keys = [GroupKey("service", "dict", 4, DT.STRING, d, key_sval=kern.ctx.sym["service"])]
    udas, state = [], {}
    for out, fn, arg in AGGS:
        uda = registry.uda(fn)
        udas.append((out, uda, kern.ctx.sym[arg] if arg else None))
        state[out] = uda.init(4, np.float64, CPU)
    kern.make_agg_step(keys, udas, 4)
    return kern, udas, state


def _cols(rng, n=N):
    return {"service": rng.integers(0, 3, n).astype(np.int32),
            "status": rng.choice([200, 500], n).astype(np.int64),
            "latency": rng.exponential(10.0, n)}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def assert_states(got, want):
    """Equal state trees: float leaves to rtol 1e-12, others exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_states(got[k], want[k])
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape
    if w.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(g, w)


def _ref_lifted(n_valid, cols, state=None):
    kern, udas, st0 = _ref_agg()
    mesh = ref_spmd.make_mesh(N_DEV)
    step = ref_spmd.spmd_agg_step(kern.raw_agg_step, ref_spmd.reduce_tree_for(udas), mesh)
    return step({k: v.reshape(N_DEV, -1) for k, v in cols.items()}, n_valid,
                np.int64(INT64_MIN), np.int64(INT64_MAX), np.int64(INT64_MAX),
                kern.luts, st0 if state is None else state)


def _port_lifted(n_valid, cols, state=None):
    kern, udas, st0 = _port_agg()
    step = spmd_agg_step(kern.raw_agg_step, reduce_tree_for(udas), make_mesh(N_DEV,
                                                                             device="cpu"))
    luts = {k: torch.as_tensor(v) for k, v in kern.luts.items()}
    return step({k: torch.from_numpy(v).view(N_DEV, -1) for k, v in cols.items()}, n_valid,
                INT64_MIN, INT64_MAX, None, luts, st0 if state is None else state)


def test_spmd_agg_matches_single_device(rng):
    """tests/test_spmd.py: the lifted step over 8 shards against the
    reference's over 8 devices and a numpy oracle."""
    cols = _cols(rng)
    nv = np.full(N_DEV, ROWS_PER_DEV, dtype=np.int64)
    want, want_total = _ref_lifted(nv, cols)
    got, total = _port_lifted(nv, cols)
    m = cols["status"] == 200
    assert int(total) == int(want_total) == m.sum()
    assert_states(_np_tree(got), _np_tree(want))
    for g in range(3):
        sel = m & (cols["service"] == g)
        assert int(got["cnt"][g]) == sel.sum()
        assert float(got["lo"][g]) == cols["latency"][sel].min()
        np.testing.assert_allclose(float(got["total"][g]), cols["latency"][sel].sum(),
                                   rtol=1e-12)


def test_spmd_respects_per_shard_valid(rng):
    cols = _cols(rng)
    cols["status"][:] = 200
    n_valid_total = N - 700  # the last shards partly padded
    nv = per_shard_valid(n_valid_total, N, N_DEV)
    assert nv.sum() == n_valid_total
    want, want_total = _ref_lifted(nv, cols)
    got, total = _port_lifted(nv, cols)
    assert int(total) == int(want_total) == n_valid_total
    assert_states(_np_tree(got), _np_tree(want))


@pytest.mark.parametrize("n_valid,total,n_dev", [
    (0, 64, 8), (1, 64, 8), (63, 64, 8), (64, 64, 8), (100, 4096, 4), (4095, 4096, 4),
    (10, 12, 3)])
def test_per_shard_valid_tails(n_valid, total, n_dev):
    """Per-shard valid counts of a prefix-valid padded batch, and the
    [n_dev, rows / n_dev] split, equal the reference's."""
    got = per_shard_valid(n_valid, total, n_dev)
    want = ref_spmd.per_shard_valid(n_valid, total, n_dev)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and got.sum() == n_valid
    cols = {"x": np.arange(total)}
    np.testing.assert_array_equal(shard_batches(cols, n_dev)["x"],
                                  ref_spmd.shard_batches(cols, n_dev)["x"])


def _merge_inputs(rng, n_shards, g=4):
    return [{"cnt": rng.integers(0, 100, g).astype(np.int64),
             "avg": {"sum": rng.normal(size=g), "count": rng.integers(0, 9, g).astype(np.int64)},
             "lo": rng.normal(size=g), "hi": rng.normal(size=g)}
            for _ in range(n_shards)]


TREE = {"cnt": "add", "avg": {"sum": "add", "count": "add"}, "lo": "min", "hi": "max"}


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    return torch.from_numpy(np.array(t))


def _ref_shard_map(fn, states, n_dev):
    """Run fn(local state) over the reference's n_dev-device mesh, each
    device holding one of `states`."""
    import jax
    from jax.sharding import PartitionSpec as P

    mesh = ref_spmd.make_mesh(n_dev)
    stacked = jax.tree.map(lambda *xs: np.concatenate(xs), *states)
    out = jax.jit(ref_spmd.shard_map(fn, mesh=mesh, in_specs=(P("agents"),),
                                     out_specs=P()))(stacked)
    return _np_tree(jax.tree.map(np.asarray, out))


@pytest.mark.parametrize("packed", [True, False])
def test_collective_merge_tree(rng, packed):
    """tests/test_spmd.py: psum / pmin / pmax of a state tree over 4 shards;
    the merged state packed (read back as transfer.pull_states reads it) or
    as views of its buffer."""
    states = _merge_inputs(rng, 4, g=1)
    want = _ref_shard_map(lambda s: ref_spmd.collective_merge(s, TREE, "agents"), states, 4)
    got = collective_merge([_torch_tree(s) for s in states], TREE, packed=packed)
    assert isinstance(got, Packed) == packed
    got = got.unpack(got.buf.numpy()) if packed else _np_tree(got)
    assert_states(got, want)
    assert int(got["cnt"][0]) == sum(int(s["cnt"][0]) for s in states)
    assert float(got["lo"][0]) == min(float(s["lo"][0]) for s in states)


def test_collective_merge_carry(rng):
    """The carry form: shard states each seeded from a replicated carry merge
    as c + sum(x_i - c) for add leaves and min / max over the full states —
    equal to the reference's in-mesh collective_merge_carry, and the carry
    counted once."""
    g = 4
    carry = _merge_inputs(rng, 1, g)[0]
    deltas = _merge_inputs(rng, N_DEV, g)
    news = [{"cnt": carry["cnt"] + d["cnt"],
             "avg": {"sum": carry["avg"]["sum"] + d["avg"]["sum"],
                     "count": carry["avg"]["count"] + d["avg"]["count"]},
             "lo": np.minimum(carry["lo"], d["lo"]), "hi": np.maximum(carry["hi"], d["hi"])}
            for d in deltas]
    import jax.numpy as jnp

    cj = {"cnt": jnp.asarray(carry["cnt"]), "avg": {"sum": jnp.asarray(carry["avg"]["sum"]),
          "count": jnp.asarray(carry["avg"]["count"])}, "lo": jnp.asarray(carry["lo"]),
          "hi": jnp.asarray(carry["hi"])}
    want = _ref_shard_map(lambda s: ref_spmd.collective_merge_carry(cj, s, TREE, "agents"),
                          news, N_DEV)
    got = _np_tree(collective_merge_carry(_torch_tree(carry), [_torch_tree(s) for s in news],
                                          TREE))
    assert_states(got, want)
    np.testing.assert_array_equal(got["cnt"], carry["cnt"] + sum(d["cnt"] for d in deltas))


def test_spmd_partial_and_multi_partial_steps(rng):
    """The per-feed lifted forms: identity states per shard, merged once —
    equal to the single-device step over all rows; the multi form runs each
    member's step over the shards."""
    cols = _cols(rng)
    kern, udas, st = _port_agg()
    luts = {k: torch.as_tensor(v) for k, v in kern.luts.items()}
    tcols = {k: torch.from_numpy(v) for k, v in cols.items()}
    want, _c = kern.raw_agg_step(tcols, N, INT64_MIN, INT64_MAX, None, luts, st)[:2]
    mesh = make_mesh(N_DEV, device="cpu")
    specs = [(n, u, np.float64) for n, u, _vb in udas]

    def init():
        return {n: u.init(4, dt, CPU) for n, u, dt in specs}

    nv = per_shard_valid(N, N, N_DEV)
    lifted = spmd_partial_step(kern.raw_agg_step, init, reduce_tree_for(udas), 0, mesh)
    got = lifted(tcols, nv, INT64_MIN, INT64_MAX, luts)
    assert_states(_np_tree(got), _np_tree(want))
    multi = spmd_multi_partial_step([(kern.raw_agg_step, init, reduce_tree_for(udas), 0)] * 2,
                                    mesh)
    for g in multi(tcols, nv, INT64_MIN, INT64_MAX, (luts, luts)):
        assert_states(_np_tree(g), _np_tree(want))


# ------------------------------------------------------------ the executor
HTTP_SCRIPT = ("import px\n"
               "df = px.DataFrame(table='http_events')\n"
               "df = df[df.status != 404]\n"
               "df = df.groupby('service').agg(cnt=('latency', px.count),"
               " s=('latency', px.sum), lo=('latency', px.min), p50=('latency', px.p50))\n"
               "px.display(df)\n")


def _http_stores(rng, n=50_000, batch_rows=2048):
    cols = {"time_": NOW - np.arange(n, dtype=np.int64)[::-1],
            "service": rng.choice(["a", "b", "c"], n),
            "latency": rng.exponential(5.0, n),
            "status": rng.choice([200, 404], n).astype(np.int64)}
    rel = [("time_", DT.TIME64NS), ("service", DT.STRING), ("latency", DT.FLOAT64),
           ("status", DT.INT64)]
    ref = RefStore()
    ref.create("http_events", RefRelation.of(*rel), batch_rows=batch_rows).write(
        {k: v.copy() for k, v in cols.items()})
    port = TableStore()
    port.create("http_events", Relation.from_dict(RefRelation.of(*rel).to_dict()),
                batch_rows=batch_rows).write({k: v.copy() for k, v in cols.items()})
    return ref, port


def assert_frames(got, want, by):
    """Result frames sorted by `by`: floats to rtol 1e-12, else exactly."""
    g = got.to_pandas().sort_values(by).reset_index(drop=True)
    w = want.to_pandas().sort_values(by).reset_index(drop=True)
    assert list(g.columns) == list(w.columns) and len(g) == len(w)
    for c in g.columns:
        if g[c].dtype.kind == "f":
            np.testing.assert_allclose(g[c].to_numpy(), w[c].to_numpy(), rtol=1e-12, atol=0,
                                       err_msg=c)
        else:
            assert g[c].tolist() == w[c].tolist(), c


def test_plan_executor_real_query_path_is_spmd(rng):
    """tests/test_spmd.py: the executor's real query path shards every
    unlimited agg over the default mesh (8 shards), equal to the reference's
    8-device run and to the single-device executor."""
    ref_ts, ts = _http_stores(rng)
    q = compile_pxl(HTTP_SCRIPT, ts.schemas(), now=NOW)
    ex = PlanExecutor(q.plan, ts, device="cpu")  # mesh="auto": 8 shards
    assert ex.mesh is not None and ex.mesh.size == N_DEV
    out = ex.run()["output"]
    assert out.exec_stats.get("spmd_feeds", 0) > 0, "agg did not shard over the mesh"
    assert len(out.exec_stats["shard_rows"]) == N_DEV
    single = PlanExecutor(q.plan, ts, device="cpu", mesh=None).run()["output"]
    assert single.exec_stats.get("spmd_feeds", 0) == 0
    ref = RefExecutor(ref_compile(HTTP_SCRIPT, ref_ts.schemas(), now=NOW).plan, ref_ts)
    assert ref.mesh is not None and ref.mesh.size == N_DEV
    want = ref.run()["output"]
    assert out.exec_stats["spmd_feeds"] == want.exec_stats["spmd_feeds"]
    assert_frames(out, want, "service")
    assert_frames(out, single, "service")


def _cluster_stores(rng, n=20_000):
    now_cols = []
    for _ in range(2):
        now_cols.append({"time_": NOW - np.arange(n, dtype=np.int64)[::-1],
                         "service": rng.choice(["x", "y"], n),
                         "latency": rng.exponential(3.0, n)})
    rel = [("time_", DT.TIME64NS), ("service", DT.STRING), ("latency", DT.FLOAT64)]
    ref, port = {}, {}
    for i, c in enumerate(now_cols):
        r = RefStore()
        r.create("http_events", RefRelation.of(*rel), batch_rows=1024).write(
            {k: v.copy() for k, v in c.items()})
        p = TableStore()
        p.create("http_events", Relation.from_dict(RefRelation.of(*rel).to_dict()),
                 batch_rows=1024).write({k: v.copy() for k, v in c.items()})
        ref[f"pem{i}"], port[f"pem{i}"] = r, p
    return ref, port


COUNT_SCRIPT = ("import px\ndf = px.DataFrame(table='http_events')\n"
                "df = df.groupby('service').agg(cnt=('latency', px.count),"
                " avg=('latency', px.mean))\npx.display(df)\n")


def test_local_cluster_agents_run_spmd(rng):
    """tests/test_spmd.py: LocalCluster agents shard over their mesh (the
    default mesh when n_devices_per_agent is None); explicit widths build
    bounded meshes, clamped to a power of two."""
    ref_stores, stores = _cluster_stores(rng)
    cl = LocalCluster(stores, device="cpu")
    assert cl._agent_mesh("pem0") == "auto"
    res = cl.query(COUNT_SCRIPT, now=NOW)["output"]
    want = RefCluster(ref_stores).query(COUNT_SCRIPT, now=NOW)["output"]
    assert int(res.to_pandas()["cnt"].sum()) == 40_000
    assert_frames(res, want, "service")
    agents = res.exec_stats["agents"]
    assert set(agents) == {"pem0", "pem1"}
    assert all(s.get("spmd_feeds", 0) > 0 for s in agents.values()), agents
    assert (res.exec_stats["transfer"]["spmd_feeds"]
            == want.exec_stats["transfer"]["spmd_feeds"])
    m = LocalCluster(stores, device="cpu", n_devices_per_agent=4)._agent_mesh("pem0")
    assert m is not None and m.size == 4
    assert LocalCluster(stores, device="cpu", n_devices_per_agent=6)._agent_mesh("pem0").size == 4
    assert LocalCluster(stores, device="cpu", n_devices_per_agent=1)._agent_mesh("pem0") is None


def test_cluster_transfer_summary_sums_across_shards(rng):
    """tests/test_sharded_parity.py: h2d_bytes and spmd_feeds sum across the
    agents (each an 8-shard mesh) into exec_stats["transfer"], with the
    worst placement skew."""
    _ref_stores, stores = _cluster_stores(rng, n=16_384)
    res = LocalCluster(stores, device="cpu").query(COUNT_SCRIPT, now=NOW)["output"]
    agents = res.exec_stats["agents"]
    xfer = res.exec_stats["transfer"]
    assert xfer["spmd_feeds"] == sum(s.get("spmd_feeds", 0) for s in agents.values()) > 0
    assert xfer["h2d_bytes"] == sum(s.get("h2d_bytes", 0) for s in agents.values())
    skews = [s["shard_skew_frac"] for s in agents.values() if "shard_skew_frac" in s]
    assert skews and xfer["shard_skew_frac"] == max(skews) >= 1.0
    for s in agents.values():
        if s.get("spmd_feeds"):
            assert len(s["shard_rows"]) == N_DEV and sum(s["shard_rows"]) > 0
    assert metrics.snapshot()  # the gauges exist
    names = {n for _k, n, _l, _v in metrics.snapshot()}
    assert "px_shard_skew_frac" in names and "px_collective_serialize_enabled" in names


# ---------------------------------------------- sharded parity (bench agg)
def _bench_stores(rows, batch_rows=None):
    """The sharded-agg workload of pixie_tpu/parallel/shard_bench.py written
    into one store of each package (its shard_cols, every row sealed)."""
    if batch_rows is None:
        batch_rows = rows // 16 if rows % 16 == 0 else 1 << 16
    rel = [("time_", DT.TIME64NS), ("service", DT.STRING), ("status", DT.INT64),
           ("bytes", DT.INT64), ("latency", DT.FLOAT64)]
    services = np.array([f"svc-{i}" for i in range(N_SERVICES)])
    cols = shard_cols(rows, 0, 1)
    data = {"time_": cols["time_"], "service": services[cols["service"]],
            "status": cols["status"], "bytes": cols["bytes"], "latency": cols["latency"]}
    ref = RefStore()
    ref.create("http_events", RefRelation.of(*rel), batch_rows=batch_rows,
               max_bytes=1 << 38).write({k: v.copy() for k, v in data.items()})
    port = TableStore()
    port.create("http_events", Relation.from_dict(RefRelation.of(*rel).to_dict()),
                batch_rows=batch_rows, max_bytes=1 << 38).write(
        {k: v.copy() for k, v in data.items()})
    return ref, port


def _bench_frames(got, want):
    assert_frames(got, want, ["service", "status"])


@pytest.mark.parametrize("rows", [64_000, 99_997])
def test_sharded_agg_matches_reference_and_single_device(rows):
    """tests/test_sharded_parity.py: filter → map → group by (service,
    status) over the mesh equals the reference's 8-device run and the port's
    single-device executor — dictionary group keys by value, and an uneven
    tail (99_997 rows: a short last shard and a hot remainder)."""
    ref_ts, ts = _bench_stores(rows)
    plan = agg_plan()
    mesh = make_mesh(N_DEV, device="cpu")
    sharded = PlanExecutor(interop.plan_from_dict(plan.to_dict()), ts, device="cpu", mesh=mesh)
    got = sharded.run()["output"]
    assert "service" in got.dictionaries
    assert sharded.stats["spmd_feeds"] >= 1 and sharded.stats["shard_skew_frac"] >= 1.0
    single = PlanExecutor(interop.plan_from_dict(plan.to_dict()), ts, device="cpu",
                          mesh=None).run()["output"]
    rex = RefExecutor(plan, ref_ts, mesh=ref_spmd.make_mesh(N_DEV), force_backend="tpu")
    want = rex.run()["output"]
    assert sharded.stats["spmd_feeds"] == rex.stats["spmd_feeds"]
    _bench_frames(got, want)
    _bench_frames(got, single)


def test_sharded_resident_warm_zero_h2d_and_delta_fold():
    """tests/test_sharded_parity.py: warm SPMD queries are served whole from
    the sharded resident entry (0 H2D bytes); a new sealed batch folds only
    its delta's bytes; tier counters equal the reference's throughout."""
    batch = 8192
    rows = 3 * batch
    ref_ts, ts = _bench_stores(rows, batch_rows=batch)
    plan = agg_plan()
    pplan = interop.plan_from_dict(plan.to_dict())
    mesh, rmesh = make_mesh(N_DEV, device="cpu"), ref_spmd.make_mesh(N_DEV)

    def run():
        ex = PlanExecutor(pplan, ts, device="cpu", mesh=mesh)
        got = ex.run()["output"]
        rex = RefExecutor(plan, ref_ts, mesh=rmesh, force_backend="tpu")
        want = rex.run()["output"]
        _bench_frames(got, want)
        for k in ("entries", "hits", "folds", "admissions", "fallbacks"):
            assert resident.tier_stats()[k] == ref_resident.tier_stats()[k], k
        assert ex.stats.get("resident_feeds") == rex.stats.get("resident_feeds") == 1
        return ex.stats

    cold = run()
    assert cold["h2d_bytes"] > 0
    warm = run()
    assert warm["h2d_bytes"] == 0 and warm["spmd_feeds"] == 1
    # one more sealed batch: only its bytes cross (service i32 + status,
    # bytes, latency: the agg's pruned feed)
    services = np.array([f"svc-{i}" for i in range(N_SERVICES)])
    cols = shard_cols(batch, 0, 1)
    data = {"time_": cols["time_"] + rows * 1000, "service": services[cols["service"]],
            "status": cols["status"], "bytes": cols["bytes"], "latency": cols["latency"]}
    ref_ts.table("http_events").write({k: v.copy() for k, v in data.items()})
    ts.table("http_events").write({k: v.copy() for k, v in data.items()})
    fold = run()
    assert fold["h2d_bytes"] == batch * (4 + 8 + 8 + 8)
    assert resident.tier_stats()["folds"] >= 1


def test_sharded_and_single_device_entries_coexist():
    """tests/test_sharded_parity.py: the entry key carries the mesh width, so
    a single-device query after a sharded one admits its own entry."""
    batch = 4096
    ref_ts, ts = _bench_stores(2 * batch, batch_rows=batch)
    plan = agg_plan()
    pplan = interop.plan_from_dict(plan.to_dict())
    PlanExecutor(pplan, ts, device="cpu", mesh=make_mesh(N_DEV, device="cpu")).run()
    PlanExecutor(pplan, ts, device="cpu", mesh=None).run()
    RefExecutor(plan, ref_ts, mesh=ref_spmd.make_mesh(N_DEV), force_backend="tpu").run()
    RefExecutor(plan, ref_ts, mesh=None, force_backend="tpu").run()
    got, want = resident.tier_stats(), ref_resident.tier_stats()
    assert got["entries"] == want["entries"] == 2
    assert got["admissions"] == want["admissions"] == 2


def test_empty_shards_hold_identity_states(rng):
    """A feed that leaves shards without a valid row (per_shard_valid gives
    0) merges their identity states: results equal the single device's."""
    ref_ts, ts = _http_stores(rng, n=300, batch_rows=1024)  # one 1024-row feed
    q = compile_pxl(HTTP_SCRIPT, ts.schemas(), now=NOW)
    ex = PlanExecutor(q.plan, ts, device="cpu", mesh=make_mesh(N_DEV, device="cpu"))
    got = ex.run()["output"]
    assert ex.stats["shard_rows"][-1] == 0 and ex.stats["shard_skew_frac"] > 1.0
    single = PlanExecutor(q.plan, ts, device="cpu", mesh=None).run()["output"]
    assert_frames(got, single, "service")


def test_mesh_width_that_does_not_split_feeds_runs_single_step(rng):
    """A 3-shard mesh cannot split a power-of-two feed: each feed runs the
    single-device step (counted in spmd_skipped_feeds), as the reference
    runs it, and the results are the same."""
    _ref_ts, ts = _http_stores(rng, n=5000)
    q = compile_pxl(HTTP_SCRIPT, ts.schemas(), now=NOW)
    ex = PlanExecutor(q.plan, ts, device="cpu", mesh=make_mesh(3, device="cpu"))
    got = ex.run()["output"]
    assert ex.stats.get("spmd_feeds", 0) == 0 and ex.stats["spmd_skipped_feeds"] >= 1
    assert_frames(got, PlanExecutor(q.plan, ts, device="cpu", mesh=None).run()["output"],
                  "service")


def test_gang_over_mesh_equals_single_device(rng):
    """The multi-query gang over a mesh: G1 (its plain version here) per
    shard, then one collective merge per member — every member's payload
    equal to the single-device gang's."""
    from pixie_tpu_torch.plan.plan import AggExpr as PAggExpr, AggOp as PAggOp
    from pixie_tpu_torch.plan.plan import MemorySourceOp as PSource, Plan as PPlan
    from pixie_tpu_torch.plan.plan import ResultSinkOp as PResultSink

    _ref_ts, ts = _http_stores(rng, n=20_000)
    p = PPlan()
    src = p.add(PSource(table="http_events", columns=["service", "latency", "status"]))
    for i, (groups, fn) in enumerate(((["service"], "mean"), (["status"], "max"),
                                      (["service", "status"], "p50"))):
        agg = p.add(PAggOp(groups=groups, values=[PAggExpr("v", fn, "latency"),
                                                  PAggExpr("n", "count", None)],
                           partial=True), parents=[src])
        p.add(PResultSink(channel=f"c{i}", payload="agg_state"), parents=[agg])
    port_flags.set_for_testing("PX_MQ_FUSION", 1)
    try:
        ex = PlanExecutor(p, ts, device="cpu", mesh=make_mesh(4, device="cpu"))
        got = ex.run_agent()
        single = PlanExecutor(p, ts, device="cpu", mesh=None).run_agent()
    finally:
        port_flags.set_for_testing("PX_MQ_FUSION", -1)
    assert ex.stats["mq_fused"] == 3 and ex.stats["spmd_feeds"] == ex.stats["mq_waves"] >= 1
    for cid in ("c0", "c1", "c2"):
        g, w = got[cid], single[cid]
        for k in w.key_cols:
            np.testing.assert_array_equal(np.asarray(g.key_cols[k]), np.asarray(w.key_cols[k]))
        assert_states(_np_tree(g.states), _np_tree(w.states))


# ------------------------------------------------------------ mesh gates
def test_collective_serialize_gate_auto_and_forced(rng):
    """tests/test_sharded_parity.py: the serialization decision is gated and
    recorded with the reference's reasons — auto serializes an all-CPU mesh,
    the flag forces either way, and the executor records the decision."""
    mesh = make_mesh(4, device="cpu")
    ref_mesh = ref_spmd.make_mesh(4)
    gate = collective_gate(mesh, refresh=True)
    want = ref_spmd.collective_gate(ref_mesh, refresh=True)
    for k in ("serialize", "reason", "mesh_devices", "flag"):
        assert gate[k] == want[k], k
    assert gate["reason"] == "xla_cpu_shared_pool" and gate["mesh_devices"] == 4
    try:
        for v, reason in ((0, "forced_off"), (1, "forced_on")):
            port_flags.set_for_testing("PX_SERIALIZE_CPU_COLLECTIVES", v)
            got = collective_gate(mesh)
            assert got["serialize"] is bool(v) and got["reason"] == reason
    finally:
        port_flags.set_for_testing("PX_SERIALIZE_CPU_COLLECTIVES", -1)
        collective_gate(mesh, refresh=True)
    _ref_ts, ts = _http_stores(rng, n=4096, batch_rows=1024)
    q = compile_pxl(HTTP_SCRIPT, ts.schemas(), now=NOW)
    rec = PlanExecutor(q.plan, ts, device="cpu").stats["device"]["collective_gate"]
    assert rec["reason"] == "xla_cpu_shared_pool" and "_key" not in rec


def test_mesh_construction_and_default_gates():
    """make_mesh raises past the local device list, default_mesh is None
    with one shard or PIXIE_TPU_SPMD=0 and clamps to a power of two, and an
    executor refuses a mesh over another device."""
    assert make_mesh(device="cpu").size == N_DEV
    with pytest.raises(RuntimeError, match="need 9 devices"):
        make_mesh(9, device="cpu")
    assert spmd.default_mesh("cpu").size == N_DEV
    port_flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", 6)
    assert spmd.default_mesh("cpu").size == 4
    port_flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", 1)
    assert spmd.default_mesh("cpu") is None
    port_flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", N_DEV)
    port_flags.set_for_testing("PIXIE_TPU_SPMD", "0")
    try:
        assert spmd.default_mesh("cpu") is None
    finally:
        port_flags.set_for_testing("PIXIE_TPU_SPMD", "auto")
    other = spmd.Mesh((torch.device("meta"),) * 2)
    with pytest.raises(Unimplemented, match="multi-card slice"):
        PlanExecutor(port_plan.Plan(), TableStore(), device="cpu", mesh=other)


def test_stream_polls_run_without_a_mesh(rng):
    """Streaming polls run on one device, as the reference's (mesh=None),
    whatever the default mesh."""
    from pixie_tpu_torch.engine.stream import stream_pxl

    _ref_ts, ts = _http_stores(rng, n=4096, batch_rows=1024)
    sq = stream_pxl("import px\ndf = px.DataFrame(table='http_events')\n"
                    "df = df.stream()\n"
                    "df = df.groupby('service').agg(cnt=('latency', px.count))\n"
                    "px.display(df)\n", ts, device="cpu")
    sq.poll()
    sq.close()
    assert sq.stats.get("spmd_feeds", 0) == 0


def test_mesh_and_single_device_agents_merge_on_the_device(rng, monkeypatch):
    """Agents with equal dictionaries, one over a 4-shard mesh and one on
    one device: each agent's state stays on the device, their layouts agree
    and one cross-agent merge (M1's plain version here) combines them —
    equal to the reference's cluster."""
    import pixie_tpu_torch.engine.executor as port_executor

    n = 8192
    cols = {"time_": NOW - np.arange(n, dtype=np.int64)[::-1],
            "service": np.array(["x", "y", "z", "w"])[rng.integers(0, 4, n)],
            "latency": rng.exponential(3.0, n)}
    cols["service"][:4] = ["x", "y", "z", "w"]  # one dictionary order in both stores
    rel = [("time_", DT.TIME64NS), ("service", DT.STRING), ("latency", DT.FLOAT64)]
    ref_stores, stores = {}, {}
    for a in ("pem0", "pem1"):
        ref_stores[a] = RefStore()
        ref_stores[a].create("http_events", RefRelation.of(*rel), batch_rows=1024).write(
            {k: v.copy() for k, v in cols.items()})
        stores[a] = TableStore()
        stores[a].create("http_events", Relation.from_dict(RefRelation.of(*rel).to_dict()),
                         batch_rows=1024).write({k: v.copy() for k, v in cols.items()})
    cl = LocalCluster(stores, device="cpu", n_devices_per_agent=4)
    cl.spec.agents[1].n_devices = 1
    merges = []
    real = port_executor.merge_states
    monkeypatch.setattr(port_executor, "merge_states",
                        lambda rt, sts: merges.append(len(sts)) or real(rt, sts))
    res = cl.query(COUNT_SCRIPT, now=NOW)["output"]
    agents = res.exec_stats["agents"]
    assert agents["pem0"]["spmd_feeds"] > 0 and agents["pem1"].get("spmd_feeds", 0) == 0
    assert merges == [2]  # the two agents' states, merged once on the device
    want = RefCluster(ref_stores, n_devices_per_agent=1).query(COUNT_SCRIPT, now=NOW)["output"]
    assert_frames(res, want, "service")
