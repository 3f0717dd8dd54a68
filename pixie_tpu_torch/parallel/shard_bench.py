"""Real-size sharded execution bench: the one-process arms.

filter→map→partial-agg runs shard-local over a mesh with one collective
merge at the blocking boundary, at real sizes, and reports rows/s + p50
with bit-equality against the single-device executor verified on every run.

Two runners, sharing one workload (`build_store` / chain shape):

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

Every aggregate in the workload is ORDER-INDEPENDENT at the bit level
(count/sum/mean over ints, min/max, log-histogram p50 whose counts are
integer-valued), so "bit-equal to the single-device result" is a checked
invariant, not an rtol claim — see `assert_bitequal`.

Both take `device` (None: the card) and need PIXIE_TORCH_VIRTUAL_SHARDS of at
least `n_devices` (the mesh's shards).  Copied from the reference package
(pixie_tpu/parallel/shard_bench.py).  Its multi-process arm (`run_multihost`,
`run_subprocess`, `main --worker`) raises Unimplemented: processes that
each feed their own shards wait for the multi-card slice (ROADMAP Queue 1
item 5).
"""
from __future__ import annotations

import sys
import time

import numpy as np

from pixie_tpu_torch.status import Unimplemented

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
def _multi_process(what: str):
    raise Unimplemented(
        f"{what}: processes that each feed their own shards are not ported yet "
        "(ROADMAP Queue 1 item 5, the multi-card slice)")


def run_multihost(rows: int, repeats: int, mesh) -> dict:
    """One process's share of the multihost sharded agg (not ported)."""
    _multi_process("run_multihost")


def _worker_env(devices_per_proc: int) -> dict:
    _multi_process("_worker_env")


def run_subprocess(rows: int, repeats: int = 3, processes: int = 2,
                   devices_per_proc: int = 4, timeout: float = 1200.0) -> dict:
    """The multihost sharded agg in subprocesses (not ported)."""
    _multi_process("run_subprocess")


def main(argv=None) -> int:
    """`python -m pixie_tpu_torch.parallel.shard_bench --worker ...`, the
    multihost worker (not ported)."""
    _multi_process("shard_bench --worker")


if __name__ == "__main__":
    sys.exit(main())
