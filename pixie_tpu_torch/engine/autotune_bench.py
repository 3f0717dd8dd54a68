"""Adaptive-gates A/B harness: the static crossover against the fitted model.

The proof for the adaptive routing (engine/autotune.py): the SAME mixed
workload runs under two arms in alternating interleaved blocks —

  * **static** — ``PX_AUTOTUNE=0``, every gate on its constant, with
    ``PX_CPU_CROSSOVER_ROWS`` deliberately MIS-set for the workload
    (`mis_set`: 4096 against a query the CPU route serves faster, or 2^40
    against one the card serves faster — the constant says one arm, the
    measurements say the other).  This is the realistic failure mode the
    model exists for — a constant tuned once on one box, wrong here.
  * **adaptive** — ``PX_AUTOTUNE=1``, the gates route through the online
    cost models.  After the warmup phase the routing model has measured
    both arms and steers the aggregate chains onto the arm the measurements
    favor.

Every answer under either arm is held against the static baseline's.  The
reference holds them bit for bit (``bit_equal_frac``); on the port the two
arms run different code — the host fast paths and the card's kernels, whose
atomics add floats in another order — so ``tolerance_equal_frac`` compares
order-independently (rows sorted by every column's value) with counts,
integers and strings exact, floats to rtol 1e-12 and the quantiles in the
same sketch bin or the adjacent one: the CPU route bins as the reference's
CPU routes (f32 log times 1/log(gamma)) and the card as its device route
(divided by log(gamma)), which part for a value within an ulp of a bin
edge.  The reference also
feeds its sketch-sort model a measured crossover probe; the port's sketch
update has no sort formulation, so that gate is not exercised here.
"""
from __future__ import annotations

import time

import numpy as np

from pixie_tpu_torch import flags
from pixie_tpu_torch.engine import autotune

#: the reference harness's scripts (its chaos_bench SCRIPTS[:2], a filter
#: and a self-join): count/max, count/mean/p50 by two keys, a filtered
#: count/max, and a raw-rows join on time_ whose sides reach the device-join
#: gate (>= 2^16 rows) so the join gate's model decides too
SCRIPTS = [
    """
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(cnt=('latency', px.count),
                               mx=('latency', px.max))
px.display(df, 'out')
""",
    """
df = px.DataFrame(table='http_events')
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), m=('latency', px.mean),
    p50=('latency', px.p50))
px.display(df, 'out')
""",
    """
df = px.DataFrame(table='http_events')
df = df[df.status == 500]
df = df.groupby('service').agg(cnt=('latency', px.count),
                               mx=('latency', px.max))
px.display(df, 'out')
""",
    """
l = px.DataFrame(table='http_events')
r = px.DataFrame(table='http_events')
j = l.merge(r, how='inner', left_on='time_', right_on='time_')
j = j.groupby('service_x').agg(cnt=('latency_x', px.count))
px.display(j, 'out')
""",
]

#: flags the harness overrides and restores
_FLAGS = ("PX_AUTOTUNE", "PX_CPU_CROSSOVER_ROWS", "PL_MATVIEW_ENABLED")

#: float columns agree across arms to this relative tolerance
RTOL = 1e-12
#: the scripts' quantile columns: the same sketch bin or the adjacent one
QUANTILE_COLS = frozenset({"p50"})


def _mkstore(seed: int, rows: int, batch_rows: int = 1 << 13):
    """One agent's http_events table (the reference harness's generator:
    6 services, exponential(20) latency, status 200/404/500 at .9/.05/.05)."""
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    rng = np.random.default_rng(seed)
    svc = np.array([f"svc-{i}" for i in range(6)])
    ts = TableStore()
    rel = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                      ("latency", DT.FLOAT64), ("status", DT.INT64))
    t = ts.create("http_events", rel, batch_rows=batch_rows, max_bytes=1 << 32)
    if rows:
        t.write({"time_": np.arange(rows, dtype=np.int64) * 1000,
                 "service": svc[rng.integers(0, len(svc), rows)],
                 "latency": rng.exponential(20.0, rows),
                 "status": rng.choice([200, 404, 500], rows, p=[0.9, 0.05, 0.05])})
    return ts


def canonical(results: dict) -> dict:
    """An answer in order-independent form: per sink, every column's values
    (dictionary codes decoded) with the rows sorted by all columns."""
    out = {}
    for name in sorted(results):
        qr = results[name]
        cols = {}
        for cname in sorted(qr.columns):
            arr = qr.columns[cname]
            if cname in qr.dictionaries:
                vals = qr.dictionaries[cname].decode(arr)
                cols[cname] = np.asarray(["" if v is None else v for v in vals], dtype=object)
            else:
                cols[cname] = np.asarray(arr)
        order = np.lexsort([c.astype("U64") if c.dtype == object else c
                            for c in cols.values()]) if cols else []
        out[name] = {k: v[order] for k, v in cols.items()}
    return out


def answers_agree(got: dict, want: dict) -> bool:
    """Counts, integers and strings exact, floats to rtol RTOL, the
    QUANTILE_COLS at most one sketch bin apart (ratio LogHistogram.gamma)."""
    from pixie_tpu_torch.ops.sketch import LogHistogram

    log_gamma = np.log(LogHistogram.gamma)
    if got.keys() != want.keys():
        return False
    for name in want:
        a, b = got[name], want[name]
        if a.keys() != b.keys():
            return False
        for c in b:
            x, y = a[c], b[c]
            if x.shape != y.shape:
                return False
            if c in QUANTILE_COLS:
                if not np.all(np.abs(np.log(x / y)) <= log_gamma * (1 + 1e-9)):
                    return False
            elif y.dtype.kind == "f":
                if not np.allclose(x, y, rtol=RTOL, atol=0.0, equal_nan=True):
                    return False
            elif not np.array_equal(x, y):
                return False
    return True


def _pct(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def run_adaptive_gates(rows: int = 400_000, queries: int = 96, blocks: int = 6,
                       warmup: int = 40, device=None, mis_set: int = 4096) -> dict:
    """Run the A/B comparison over a LocalCluster of two agents holding
    rows/2 each, on `device` (the card unless given); `mis_set` is the static
    arm's PX_CPU_CROSSOVER_ROWS.  → the report dict."""
    import pixie_tpu_torch.matview.maintainer  # noqa: F401 (defines PL_MATVIEW_*)
    from pixie_tpu_torch.parallel.cluster import LocalCluster

    saved = {n: flags.get(n) for n in _FLAGS}
    t_bench0 = time.perf_counter()
    autotune.MODEL.reset_for_testing()
    try:
        flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", int(mis_set))
        # standing views would serve every warm repeat from their state and
        # never reach the routing seam the gates live on
        flags.set_for_testing("PL_MATVIEW_ENABLED", False)
        stores = {f"pem{i}": _mkstore(i, rows // 2) for i in range(2)}
        cluster = LocalCluster(stores, device=device)

        # static baseline (autotune OFF): the answer each later run must match
        flags.set_for_testing("PX_AUTOTUNE", False)
        base = []
        for s in SCRIPTS:
            cluster.query(s)  # warm
            base.append(canonical(cluster.query(s)))

        flags.set_for_testing("PX_AUTOTUNE", True)
        for i in range(warmup):
            cluster.query(SCRIPTS[i % len(SCRIPTS)])

        per_block = max(1, queries // (blocks * 2))
        times = {"static": [], "adaptive": []}
        checks = ok = 0
        si = 0
        for _b in range(blocks):
            for arm in ("static", "adaptive"):
                flags.set_for_testing("PX_AUTOTUNE", arm == "adaptive")
                for _ in range(per_block):
                    idx = si % len(SCRIPTS)
                    si += 1
                    t0 = time.perf_counter()
                    res = cluster.query(SCRIPTS[idx])
                    times[arm].append(time.perf_counter() - t0)
                    checks += 1
                    ok += answers_agree(canonical(res), base[idx])

        snap = autotune.MODEL.snapshot()
        gates_decided = sum(1 for g in snap.values() if g["decisions"] > 0 or g["samples"] > 0)
        s_gp = len(times["static"]) / max(sum(times["static"]), 1e-9)
        a_gp = len(times["adaptive"]) / max(sum(times["adaptive"]), 1e-9)
        s_p99 = _pct(times["static"], 0.99)
        return {
            "rows": rows,
            "mis_set_crossover": int(mis_set),
            "seconds": time.perf_counter() - t_bench0,
            "queries": checks,
            "static_goodput_qps": s_gp,
            "adaptive_goodput_qps": a_gp,
            "adaptive_vs_static": a_gp / max(s_gp, 1e-9),
            "static_p50_ms": _pct(times["static"], 0.5) * 1e3,
            "adaptive_p50_ms": _pct(times["adaptive"], 0.5) * 1e3,
            "static_p99_ms": s_p99 * 1e3,
            "adaptive_p99_ms": _pct(times["adaptive"], 0.99) * 1e3,
            "p99_ratio": _pct(times["adaptive"], 0.99) / max(s_p99, 1e-9),
            "tolerance_equal_frac": ok / max(checks, 1),
            "gates_decided": gates_decided,
            "gates": snap,
            "decisions": sum(g["decisions"] for g in snap.values()),
            "fallbacks": sum(g["fallbacks"] for g in snap.values()),
        }
    finally:
        for n, v in saved.items():
            flags.set_for_testing(n, v)
        autotune.MODEL.reset_for_testing()
