"""Real-size sharded execution bench.

filter→map→partial-agg runs shard-local over a mesh with one collective
merge at the blocking boundary, at real sizes, and reports rows/s + p50
with bit-equality against the single-device executor verified on every run.

Three runners, sharing one workload (`build_store` / chain shape):

  * `run_local(...)` — the engine path: a real TableStore + PlanExecutor
    over an n-shard mesh (parallel/spmd.py `make_mesh`: n co-located
    shards of one device), so the measured run exercises the sharded feed
    layout (the sharded resident tier), per-shard transfer accounting and
    the SPMD partial step (C1, K1, K2 a shard, F2 merging the shards as it
    finalizes) — compared bit for bit against `PlanExecutor(mesh=None)`.
  * `run_shuffled_join(...)` — the shuffle join: one agent's n-shard mesh,
    the planner widening the repartition to the mesh width, both sides
    exchanged in the mesh (X1, X2), per-partition joins riding the device
    join (J1-J3) — compared against the single-device join.
  * `run_multihost(...)` (via `run_subprocess` and `main --worker`) — the
    multi-process job (parallel/multihost.py): each process feeds ONLY its
    host-local shards and the collective merge spans processes (M1 over the
    local shards, one all_gather, M1 over the world's buffers), with
    `run_exchange` timing the keyed exchange across them (X1, X2, K4 and
    one all_to_all_single a column) — rank 0 compared
    bit for bit against the single-device step over the full data.

Every aggregate in the workload is ORDER-INDEPENDENT at the bit level
(count/sum/mean over ints, min/max, log-histogram p50 whose counts are
integer-valued), so "bit-equal to the single-device result" is a checked
invariant, not an rtol claim — see `assert_bitequal`.

The one-process arms take `device` (None: the card) and need
PIXIE_TORCH_VIRTUAL_SHARDS of at least `n_devices` (the mesh's shards).
Copied from the reference package (pixie_tpu/parallel/shard_bench.py),
except that `run_subprocess` has no one-process fallback: a worker that
fails raises.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

SEC = 1_000_000_000
N_SERVICES = 16
STATUSES = (200, 404, 500)


# ------------------------------------------------------------------ workload
def shard_cols(rows: int, shard: int, n_shards: int) -> dict:
    """Generate ONE row-block shard of the workload, seeded by shard index —
    any process can build exactly its shards (multihost host-local feeds)
    while the oracle rebuilds the full table from the same seeds."""
    per = rows // n_shards
    rng = np.random.default_rng(1234 + shard)
    n = per
    return {
        "time_": (shard * per + np.arange(n, dtype=np.int64)) * 1000,
        "service": rng.integers(0, N_SERVICES, n).astype(np.int32),
        "status": rng.choice(np.asarray(STATUSES, dtype=np.int64), n),
        "bytes": rng.integers(0, 1 << 20, n).astype(np.int64),
        "latency": rng.exponential(50.0, n),
    }


def build_store(rows: int, batch_rows: int | None = None):
    """TableStore holding the workload with EVERY row sealed (batch_rows
    divides rows), so the sharded-resident tier covers the whole feed."""
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    ts = TableStore()
    rel = Relation.of(
        ("time_", DT.TIME64NS), ("service", DT.STRING),
        ("status", DT.INT64), ("bytes", DT.INT64), ("latency", DT.FLOAT64),
    )
    if batch_rows is None:
        batch_rows = rows // 16 if rows % 16 == 0 else 1 << 16
    t = ts.create("http_events", rel, batch_rows=batch_rows,
                  max_bytes=1 << 38)
    services = np.array([f"svc-{i}" for i in range(N_SERVICES)])
    n_chunks = max(1, rows // (1 << 21))
    # chunk boundaries aligned to the shard generator so data is identical
    # however it is produced
    n_shards = n_chunks
    while rows % n_shards:
        n_shards -= 1
    for i in range(n_shards):
        cols = shard_cols(rows, i, n_shards)
        t.write({
            "time_": cols["time_"],
            "service": services[cols["service"]],
            "status": cols["status"],
            "bytes": cols["bytes"],
            "latency": cols["latency"],
        })
    return ts


def agg_plan():
    """filter(status != 404) → map(lat_us = latency*1000) →
    groupby(service, status) agg — every value exactly mergeable."""
    from pixie_tpu_torch.plan import (
        AggExpr, AggOp, Call, Column, FilterOp, MapOp, MemorySinkOp,
        MemorySourceOp, Plan, lit,
    )

    p = Plan()
    src = p.add(MemorySourceOp(table="http_events"))
    f = p.add(FilterOp(expr=Call("not_equal", (Column("status"), lit(404)))),
              parents=[src])
    m = p.add(MapOp(exprs=[
        ("service", Column("service")),
        ("status", Column("status")),
        ("bytes", Column("bytes")),
        ("lat_us", Call("multiply", (Column("latency"), lit(1000.0)))),
    ]), parents=[f])
    agg = p.add(AggOp(groups=["service", "status"], values=[
        AggExpr("cnt", "count", None),
        AggExpr("b", "sum", "bytes"),
        AggExpr("avg_b", "mean", "bytes"),
        AggExpr("lo", "min", "lat_us"),
        AggExpr("hi", "max", "lat_us"),
        AggExpr("p50", "p50", "lat_us"),
    ]), parents=[m])
    p.add(MemorySinkOp(name="output"), parents=[agg])
    return p


def assert_bitequal(got, want, keys=("service", "status")) -> None:
    """Bit-level equality of two QueryResults/HostBatches, row order
    normalized by the key columns.  Raises AssertionError with the first
    differing column."""
    gc = _result_cols(got)
    wc = _result_cols(want)
    assert set(gc) == set(wc), (sorted(gc), sorted(wc))

    def sortable(x):
        return x.astype(str) if x.dtype == object else x

    go = np.lexsort(tuple(sortable(gc[k]) for k in reversed(keys)))
    wo = np.lexsort(tuple(sortable(wc[k]) for k in reversed(keys)))
    for name in sorted(gc):
        a, b = gc[name][go], wc[name][wo]
        assert a.dtype == b.dtype and a.shape == b.shape, (
            name, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), (
            f"column {name!r} not bit-equal: "
            f"{a[:5]!r} vs {b[:5]!r}")


def _result_cols(res) -> dict:
    if hasattr(res, "dictionaries"):  # QueryResult: dict cols by VALUE
        out = {}
        for n, col in res.columns.items():
            d = res.dictionaries.get(n)
            out[n] = (np.asarray(d.decode(col), dtype=object)
                      if d is not None else np.asarray(col))
        return out
    return {k: np.asarray(v) for k, v in res.cols.items()}


def _p50(xs):
    return sorted(xs)[len(xs) // 2]


# ------------------------------------------------------- engine-path runner
def run_local(rows: int, repeats: int = 3, n_devices: int = 8, device=None,
              store=None) -> dict:
    """The engine-path sharded run: PlanExecutor over an n-shard mesh vs
    the single-device executor, bit-equal, with warm-feed transfer and
    skew accounting.  `store` is build_store(rows) made by the caller, or
    None to build it here.  Returns the result dict (see keys below)."""
    from pixie_tpu_torch.engine.executor import PlanExecutor, resolve_device
    from pixie_tpu_torch.parallel.spmd import make_mesh

    device = resolve_device(device)
    mesh = make_mesh(n_devices, device=device)
    ts = build_store(rows) if store is None else store
    plan = agg_plan()

    def run_sharded():
        ex = PlanExecutor(plan, ts, device=device, mesh=mesh)
        return ex.run()["output"], ex

    out, ex = run_sharded()  # cold: compiles + admits the sharded tier
    times = []
    for _ in range(max(repeats, 2)):
        t0 = time.perf_counter()
        out, ex = run_sharded()
        times.append(time.perf_counter() - t0)
    single = PlanExecutor(plan, ts, device=device, mesh=None)
    sres = single.run()["output"]
    assert_bitequal(out, sres)
    p50 = _p50(times)
    stats = ex.stats
    return {
        "rows": rows,
        "n_devices": n_devices,
        "rows_per_sec": round(rows / p50),
        "p50_ms": round(p50 * 1000, 1),
        "bit_equal": True,
        "spmd_feeds": int(stats.get("spmd_feeds", 0)),
        "resident_feeds": int(stats.get("resident_feeds", 0)),
        "warm_h2d_bytes": int(stats.get("h2d_bytes", 0)),
        "shard_skew_frac": stats.get("shard_skew_frac"),
        "collective_gate": (stats.get("device") or {}).get(
            "collective_gate", {}).get("reason"),
    }


def join_plan():
    from pixie_tpu_torch.plan import (
        AggExpr, AggOp, JoinOp, MemorySinkOp, MemorySourceOp, Plan,
    )

    p = Plan()
    left = p.add(MemorySourceOp(table="left_t", columns=["k", "lv"]))
    right = p.add(MemorySourceOp(table="right_t", columns=["k", "rv"]))
    j = p.add(JoinOp(how="inner", left_on=["k"], right_on=["k"],
                     output=[("left", "k", "k"), ("left", "lv", "lv"),
                             ("right", "rv", "rv")]),
              parents=[left, right])
    agg = p.add(AggOp(groups=[], values=[
        AggExpr("n", "count", None), AggExpr("s", "sum", "rv"),
    ]), parents=[j])
    p.add(MemorySinkOp(name="out"), parents=[agg])
    return p


def build_join_store(rows_per_side: int):
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    ts = TableStore()
    rng = np.random.default_rng(77)
    lt = ts.create("left_t", Relation.of(("k", DT.INT64), ("lv", DT.INT64)),
                   batch_rows=1 << 16, max_bytes=1 << 38)
    rt = ts.create("right_t", Relation.of(("k", DT.INT64), ("rv", DT.INT64)),
                   batch_rows=1 << 16, max_bytes=1 << 38)
    chunk = 1 << 21
    for t, col in ((lt, "lv"), (rt, "rv")):
        written = 0
        while written < rows_per_side:
            n = min(chunk, rows_per_side - written)
            t.write({"k": rng.integers(0, rows_per_side, n),
                     col: rng.integers(0, 1 << 20, n)})
            written += n
    return ts


def run_shuffled_join(rows_per_side: int, n_devices: int = 8, device=None,
                      store=None) -> dict:
    """Shuffled equijoin: ONE agent whose n-shard mesh widens the planner's
    repartition to n partitions, both sides exchanged in the mesh (X1, X2),
    per-partition device joins (J1-J3) — vs the single-device executor
    join, bit-equal (the post-join aggregate is over ints).  `store` is
    build_join_store(rows_per_side) made by the caller, or None to build it
    here."""
    from pixie_tpu_torch.engine.executor import PlanExecutor
    from pixie_tpu_torch.parallel.cluster import LocalCluster

    ts = build_join_store(rows_per_side) if store is None else store
    cluster = LocalCluster({"pem0": ts}, device=device, n_devices_per_agent=n_devices)
    plan = join_plan()
    dp = cluster.planner.plan(plan)
    if not dp.join_stages or dp.join_stages[0].n_parts != n_devices:
        raise RuntimeError(
            f"planner did not widen the shuffle to the mesh: "
            f"{[s.n_parts for s in dp.join_stages]}")
    t0 = time.perf_counter()
    res = cluster.execute(plan)["out"]
    secs = time.perf_counter() - t0
    agents = res.exec_stats["agents"]
    shuffles = sum(s.get("mesh_shuffles", 0) for s in agents.values())
    if shuffles < 2:
        raise RuntimeError(f"join sides did not mesh-exchange: {shuffles}")
    single = PlanExecutor(plan, ts, device=cluster.device, mesh=None).run()["out"]
    assert_bitequal(res, single, keys=("n",))
    return {
        "rows": 2 * rows_per_side,
        "n_parts": dp.join_stages[0].n_parts,
        "rows_per_sec": round(2 * rows_per_side / secs),
        "all_to_all_exchanges": int(shuffles),
        "bit_equal": True,
        "join_rows": int(np.asarray(res.decoded("n"))[0]),
    }


# ------------------------------------------------------- multihost runner
def _chain_kernel(device):
    """The multihost bench's fragment kernel: the same filter→map→partial-agg
    chain, at the ChainKernel level (the multihost data plane feeds the
    kernel directly — each process owns only its host-local shards, so the
    TableStore/executor layer stays per-process)."""
    from pixie_tpu_torch.engine.executor import ChainKernel, GroupKey
    from pixie_tpu_torch.plan import AggExpr, Call, Column, FilterOp, MapOp, lit
    from pixie_tpu_torch.table.dictionary import Dictionary
    from pixie_tpu_torch.types import DataType as DT
    from pixie_tpu_torch.udf import registry

    svc_dict = Dictionary([f"svc-{i}" for i in range(N_SERVICES)])
    dtypes = {"time_": DT.TIME64NS, "service": DT.STRING,
              "status": DT.INT64, "bytes": DT.INT64, "latency": DT.FLOAT64}
    chain = [
        FilterOp(expr=Call("not_equal", (Column("status"), lit(404)))),
        MapOp(exprs=[
            ("service", Column("service")),
            ("status", Column("status")),
            ("bytes", Column("bytes")),
            ("lat_us", Call("multiply", (Column("latency"), lit(1000.0)))),
        ]),
    ]
    kern = ChainKernel(dtypes, {"service": svc_dict}, chain, registry, "time_", device)
    status_lut = kern.ctx.ec._add_lut(np.asarray(STATUSES, dtype=np.int64))
    keys = [
        GroupKey("service", "dict", N_SERVICES, DT.STRING, svc_dict,
                 key_sval=kern.ctx.sym["service"]),
        GroupKey("status", "intdevice", 4, DT.INT64, Dictionary(list(STATUSES)),
                 src_name="status", lut_name=status_lut),
    ]
    num_groups = N_SERVICES * 4
    udas, init_specs = [], []
    for ae in [AggExpr("cnt", "count", None), AggExpr("b", "sum", "bytes"),
               AggExpr("lo", "min", "lat_us"), AggExpr("hi", "max", "lat_us"),
               AggExpr("p50", "p50", "lat_us")]:
        uda = registry.uda(ae.fn)
        vb = kern.ctx.sym[ae.arg] if ae.arg else None
        in_dt = np.int64 if ae.arg == "bytes" else (np.float64 if ae.arg else None)
        udas.append((ae.out_name, uda, vb))
        init_specs.append((ae.out_name, uda, in_dt))
    kern.make_agg_step(keys, udas, num_groups)
    return kern, udas, init_specs, num_groups


_NAMES = ("time_", "service", "status", "bytes", "latency")
#: rows a call of the single-device oracle (the executor's feed size)
ORACLE_FEED = 1 << 24


def _launched() -> dict:
    """Kernel launches since the last reset, by library and entry point."""
    from pixie_tpu_torch.ops import _build

    return {lib: {e: n for e, n in k.by_entry.items() if n}
            for lib, k in _build.KERNELS.items() if any(k.by_entry.values())}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state_bytes(state) -> list:
    """The leaves of a state tree as numpy arrays, in key order."""
    from pixie_tpu_torch.engine import transfer
    from pixie_tpu_torch.ops.pack import flatten

    return [np.ascontiguousarray(a) for _p, a in flatten(transfer.pull(state))]


def run_multihost(rows: int, repeats: int, mesh, device=None) -> dict:
    """One process's share of the benched multihost sharded agg: feed ONLY
    host-local shards, run the lifted partial step (each local shard's C1,
    K1 and K2, M1 over the local shards, one all_gather, M1 over the
    world's buffers) over the mesh, and check bit-equality against the
    single-device step over the regenerated full data on process 0.
    `device` None: the mesh's local device."""
    import hashlib

    import torch

    from pixie_tpu_torch.engine.executor import INT64_MAX, INT64_MIN, device_luts
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.parallel import multihost
    from pixie_tpu_torch.parallel.spmd import (
        per_shard_valid, reduce_tree_for, spmd_partial_step,
    )

    dev = torch.device(device) if device is not None else mesh.device
    kern, udas, init_specs, num_groups = _chain_kernel(dev)
    n_dev = int(mesh.size)
    per = -(-rows // n_dev)
    padded = per * n_dev
    lo, hi = mesh.local_slice
    shards = [shard_cols(padded, i, n_dev) for i in range(lo, hi)]
    cols = {k: torch.from_numpy(np.concatenate([c[k] for c in shards])).to(dev)
            for k in _NAMES}
    del shards
    nv = per_shard_valid(rows, padded, n_dev)
    luts = device_luts(kern.luts, dev)

    def init_fn():
        return {name: uda.init(num_groups, in_dt, dev) for name, uda, in_dt in init_specs}

    step = spmd_partial_step(kern.raw_agg_step, init_fn, reduce_tree_for(udas),
                             len(kern.limit_ns), mesh)

    def run_once():
        t0 = time.perf_counter()
        out = step(cols, nv, INT64_MIN, INT64_MAX, luts)
        _sync(dev)
        return time.perf_counter() - t0, out

    run_once()  # warm: the kernel plans, the layout check
    _build.reset_launches()
    multihost.reset_exec_stats()
    run_once()  # the counted step
    launches = _launched()
    merge = multihost.exec_stats()
    times, out = [], None
    for _ in range(max(repeats, 2)):
        dt, out = run_once()
        times.append(dt)
    state = _state_bytes(out)
    digest = hashlib.blake2b(b"".join(a.tobytes() for a in state), digest_size=16).hexdigest()
    desc = multihost.describe()
    result = {
        "rows": rows,
        "n_devices": n_dev,
        "processes": len(set(mesh.processes)),
        "shards_per_process": hi - lo,
        "backend": desc["backend"],
        "device": dev.type,
        "rows_per_sec": round(rows / _p50(times)),
        "p50_ms": round(_p50(times) * 1000, 1),
        "rank": mesh.rank,
        "launches": launches,
        "gathered_bytes": merge["gathered_bytes"],
        "staged_bytes": merge["staged_bytes"],
        "world_merge_ms": merge["merge_wall_s"] * 1000,
        "state_digest": digest,
    }
    if mesh.rank == 0:
        # single-device oracle over the FULL regenerated data — bit-equal
        # (fed ORACLE_FEED rows a call into one state: the same bits as one
        # call, every leaf of this workload exact)
        full = {k: np.concatenate([shard_cols(padded, i, n_dev)[k] for i in range(n_dev)])
                for k in _NAMES}
        limits = torch.full((max(1, len(kern.limit_ns)),), INT64_MAX, dtype=torch.int64,
                            device=dev)
        ref = init_fn()
        for a in range(0, rows, ORACLE_FEED):
            feed = {k: torch.from_numpy(v[a:a + ORACLE_FEED]).to(dev) for k, v in full.items()}
            ref = kern.raw_agg_step(feed, min(ORACLE_FEED, rows - a), INT64_MIN, INT64_MAX,
                                    limits, luts, ref)[0]
        del full, feed
        want = _state_bytes(ref)
        result["bit_equal"] = len(want) == len(state) and all(
            a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
            for a, b in zip(state, want))
        assert result["bit_equal"], "sharded state != single-device state"
    return result


def exchange_cols(rows: int, position: int) -> dict:
    """The exchange's rows of one mesh position, seeded by it: an int64 key
    over 2^40 values, an int32 and a float64 value (20 bytes a row)."""
    rng = np.random.default_rng(4321 + position)
    return {"k": rng.integers(0, 1 << 40, rows).astype(np.int64),
            "v": rng.integers(0, 1 << 31, rows).astype(np.int32),
            "w": rng.normal(size=rows)}


def run_exchange(rows_per_rank: int, repeats: int, mesh, device=None) -> dict:
    """One process's share of a keyed exchange across the mesh's processes
    (parallel/repartition.py mesh_repartition: X1, the counts'
    all_to_all_single, X2 and K4, one all_to_all_single a column) over
    `rows_per_rank` rows split over its shards.  Every block it receives is
    held against the sender's regenerated rows of that target, in order."""
    import torch

    from pixie_tpu_torch.engine.executor import HostBatch
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.parallel import multihost
    from pixie_tpu_torch.parallel.repartition import mesh_repartition, partition_ids
    from pixie_tpu_torch.types import DataType as DT

    dev = torch.device(device) if device is not None else mesh.device
    n_dev = mesh.size
    lo, hi = mesh.local_slice
    per = rows_per_rank // (hi - lo)
    mine = [exchange_cols(per, g) for g in range(lo, hi)]
    cols = {k: torch.from_numpy(np.concatenate([c[k] for c in mine])).to(dev) for k in mine[0]}
    nv = np.full(hi - lo, per, dtype=np.int64)
    exchange = mesh_repartition(mesh, ["k"])

    def run_once():
        t0 = time.perf_counter()
        got = exchange(cols, nv)
        _sync(dev)
        return time.perf_counter() - t0, got

    run_once()
    _build.reset_launches()
    multihost.reset_exec_stats()
    _dt, got = run_once()
    launches = _launched()
    stats = multihost.exec_stats()
    times = [run_once()[0] for _ in range(max(repeats, 2))]
    dtypes = {"k": DT.INT64}
    for s in range(n_dev):
        src = exchange_cols(per, s)
        part = partition_ids(HostBatch(dtypes, {}, {"k": src["k"]}), ["k"], n_dev)
        for j in range(hi - lo):
            sel = part == lo + j
            for name, want in src.items():
                have = got.block(name, j, s).cpu().numpy()
                if not np.array_equal(have, want[sel]):
                    raise AssertionError(f"exchange block ({lo + j}, {s}) of {name} differs")
    return {"rows_per_rank": rows_per_rank, "n_devices": n_dev,
            "sent_bytes": got.sent_bytes, "recv_bytes": got.recv_bytes,
            "all_to_all_calls": stats["all_to_all_calls"],
            "staged_bytes": stats["staged_bytes"],
            "wall_ms": _p50(times) * 1000, "rows_equal": True, "launches": launches}


# ---------------------------------------------------- subprocess harness
def _repo_root() -> str:
    import os

    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _worker_env(devices_per_proc: int) -> dict:
    """A worker's environment: this one's, with the port's flags as this
    process holds them (flags.env_exports: whatever was overridden, by env
    or set_for_testing, re-parses in the worker, PX_AUTOTUNE and
    PX_CPU_CROSSOVER_ROWS included), PIXIE_TORCH_VIRTUAL_SHARDS =
    devices_per_proc (its local shards) and the checkout on PYTHONPATH.
    The rendezvous flags are set a rank by multihost.launch."""
    import os

    from pixie_tpu_torch import flags as _flags
    import pixie_tpu_torch.engine.executor  # noqa: F401  (defines the route flags)

    env = {k: v for k, v in os.environ.items() if not k.startswith("PX_JAX_")}
    env.update(_flags.env_exports())
    for k in ("PX_JAX_COORDINATOR", "PX_JAX_NUM_PROCESSES", "PX_JAX_PROCESS_ID"):
        env.pop(k, None)
    env["PIXIE_TORCH_VIRTUAL_SHARDS"] = str(devices_per_proc)
    env["PYTHONPATH"] = os.pathsep.join(
        [_repo_root()] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


#: keys of each rank's report that run_subprocess lists by rank
_RANK_KEYS = ("rank", "launches", "gathered_bytes", "staged_bytes", "world_merge_ms",
              "state_digest", "p50_ms", "exchange")


def run_subprocess(rows: int, repeats: int = 3, processes: int = 2,
                   devices_per_proc: int = 4, timeout: float = 1200.0, device=None,
                   exchange_rows: int = 0) -> dict:
    """Drive the benched multihost sharded agg in `processes` fresh worker
    processes of `devices_per_proc` shards each, joined by torch.distributed
    (parallel/multihost.py), on `device` (None: the card; every worker on
    its card by the topology rule, the CPU with "cpu").  On a card every
    kernel library is built first, so the workers do not run nvcc at once.
    With `exchange_rows`, each worker then runs the keyed exchange over
    that many rows (run_exchange).  → rank 0's report, mode "multihost",
    with every rank's launches, bytes and state digest under "ranks".
    There is no one-process fallback: a worker that fails or outlives
    `timeout` raises with its stderr."""
    from pixie_tpu_torch.engine.executor import resolve_device
    from pixie_tpu_torch.parallel import multihost

    dev = resolve_device(device)
    if dev.type == "cuda":
        from pixie_tpu_torch.ops import _build

        _build.build_all()
    argv = ["-m", "pixie_tpu_torch.parallel.shard_bench", "--worker", "--rows", str(rows),
            "--repeats", str(repeats), "--device", dev.type,
            "--exchange-rows", str(exchange_rows)]
    outs = multihost.launch(lambda rank: argv, processes, _worker_env(devices_per_proc),
                            timeout)
    docs = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    doc = dict(docs[0])
    doc["mode"] = "multihost"
    doc["ranks"] = [{k: d.get(k) for k in _RANK_KEYS} for d in docs]
    doc["ranks_equal"] = len({d["state_digest"] for d in docs}) == 1
    if not doc["ranks_equal"]:
        raise AssertionError(f"the ranks' merged states differ: {doc['ranks']}")
    return doc


def main(argv=None) -> int:
    """`python -m pixie_tpu_torch.parallel.shard_bench --worker ...`: one
    rank of the multihost job.  The rendezvous comes from --coordinator /
    --processes / --process-id or the PX_JAX_* flags; without either the
    worker runs one process over its local shards.  Every rank prints its
    report as its last line."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--rows", type=int, default=64_000_000)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--coordinator", type=str, default="")
    ap.add_argument("--processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--device", type=str, default=None)
    ap.add_argument("--exchange-rows", type=int, default=0)
    args = ap.parse_args(argv)

    from pixie_tpu_torch.parallel import multihost
    from pixie_tpu_torch.parallel.spmd import local_devices, make_mesh

    try:
        if multihost.init_multihost(args.coordinator or None, args.processes,
                                    args.process_id, device=args.device):
            mesh = multihost.global_mesh()
        else:
            mesh = make_mesh(len(local_devices(args.device)), device=args.device)
        if mesh is None or mesh.size < 2:
            raise RuntimeError("no multi-shard mesh available")
        out = run_multihost(args.rows, args.repeats, mesh)
        if args.exchange_rows:
            out["exchange"] = run_exchange(args.exchange_rows, args.repeats, mesh)
        print(json.dumps(out), flush=True)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
