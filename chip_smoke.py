#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pixie_tpu_torch) once on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which fails the run if it fails:

  1. device   — the card's name, and name + power limit from nvidia-smi;
  2. build    — every kernel under pixie_tpu_torch/csrc/ built with nvcc
                (all sources at once) and loaded;
  3. kernels  — each kernel held against its plain PyTorch version on the
                same CUDA tensors, at the main path's shapes and at edge
                cases (int64 sums that wrap, an all-false mask, one group,
                more groups than shared memory holds, values on sketch bin
                edges and <= 1e-9).  Integer results and the quantiles must
                match exactly, float64 sums to 1e-12 of each group's sum
                of |values|.  Each kernel is
                timed (CUDA events) beside its plain version, the nearest
                single PyTorch library call and its bound on the card;
  4. slice    — bench config #1 (filter status != 404, group by service and
                status, count / mean / p50 of latency) over an http_events
                table of 64M rows (bench's headline size) built with the
                port's TableStore, run through
                execute_plan(device="cuda"), checked against a numpy oracle
                (counts exact, means to rtol 1e-9, p50 in the oracle's sketch
                bin or the next one, and within 2.1% of np.median), with
                every kernel of the path launched at least once; then timed
                warm (median of 5 runs after 2 warm-ups).

It prints one JSON line per kernel, a {"kernels": [...]} line, the card's
name and power limit, and last {"ok": true, "device": {...}}.  It exits
non-zero, printing no result, without a CUDA device or outside the repo.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np

SEC = 1_000_000_000
N_SERVICES = 16
#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and float32
#: operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
FEED = 1 << 24
#: http_events rows of the slice phase: bench's headline size, 4 full feeds
ROWS = 1 << 26
#: the sketch's parameters (LogHistogram defaults), for the oracle
GAMMA, MIN_VALUE, WIDTH = 1.0404, 1e-9, 514


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ timing


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn() on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over the memory rate or
    float32 operations over the peak rate, whichever is larger."""
    b_ms, o_ms = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


# ------------------------------------------------------------ kernel checks


def check_kernels(dev) -> list[dict]:
    """Hold K1-K3 against their plain versions; returns the kernel rows
    (each names its C entry point, whose main-path launches fill in later)."""
    import torch

    from pixie_tpu_torch.ops import groupby as gb
    from pixie_tpu_torch.ops.sketch import LogHistogram

    rng = np.random.default_rng(7)
    rows = []

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def same(kind, got, want, rtol=0.0, scale=None):
        """Exact equality, or for float64 sums |got - want| <= rtol * scale,
        where scale is each group's sum of |values| (a sum's rounding error
        in any order is relative to that, not to a sum near zero)."""
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if rtol:
            s_ = np.abs(w) if scale is None else scale.cpu().numpy()
            both_nan = np.isnan(g) & np.isnan(w)
            ok = bool(np.all(both_nan | (np.abs(g - w) <= rtol * s_)))
            d = np.abs(g - w)[~both_nan]
            err = float(d.max()) if d.size else 0.0
        else:
            ok = np.array_equal(g, w, equal_nan=g.dtype.kind == "f")
            err = 0.0 if ok else float(np.nanmax(np.abs(g.astype(np.float64)
                                                         - w.astype(np.float64))))
        if not ok:
            raise AssertionError(f"{kind}: kernel and plain version disagree "
                                 f"(max abs err {err})")
        return err

    def k1(op, v, gid, mask, g, out0):
        a, b = out0.clone(), out0.clone()
        scale = None
        if op == "count":
            gb.masked_segment_count(gid, g, mask, out=a)
            gb.segment_count_plain(gid, g, mask, b)
        elif op == "sum":
            gb.masked_segment_sum(v, gid, g, mask, out=a)
            gb.segment_sum_plain(v, gid, g, mask, b)
            if v.dtype == torch.float64:
                scale = gb.segment_sum_plain(v.abs(), gid, g, mask, torch.zeros_like(b))
        else:
            getattr(gb, f"masked_segment_{op}")(v, gid, g, mask, out=a)
            gb.segment_pick_plain(v, gid, g, mask, b, op)
        return a, b, scale

    # ---- K1 edge cases (exactness of every variant and of the global path)
    n = 1 << 20
    wrap = rng.integers(2 ** 62, 2 ** 63 - 1, n, dtype=np.int64) * np.where(
        rng.random(n) < 0.5, -1, 1)
    f64 = rng.exponential(50.0, n)
    f64[rng.random(n) < 1e-4] = np.nan
    edge_cases = [
        ("sum i64 near +-2^63 (wraps)", "sum", wrap, 64, torch.int64, 0.0),
        ("sum f64", "sum", rng.normal(0, 1e3, n), 64, torch.float64, 1e-12),
        ("sum f32 integer-valued", "sum", rng.integers(-100, 100, n).astype(np.float32),
         64, torch.float32, 0.0),
        ("min f64 with NaN", "min", f64, 64, torch.float64, 0.0),
        ("max f64 with NaN", "max", f64, 64, torch.float64, 0.0),
        ("min i64", "min", wrap, 64, torch.int64, 0.0),
        ("max i32", "max", rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32), 64,
         torch.int32, 0.0),
        ("min f32", "min", rng.normal(0, 1, n).astype(np.float32), 64, torch.float32, 0.0),
        ("count G=1", "count", None, 1, torch.int64, 0.0),
        ("count G=2^14 (opt-in shared memory)", "count", None, 1 << 14, torch.int64, 0.0),
        ("sum f64 G=5000", "sum", rng.normal(0, 1, n), 5000, torch.float64, 1e-12),
        ("sum f64 G=1", "sum", f64, 1, torch.float64, 1e-12),
        ("count G=2^16 (global atomics)", "count", None, 1 << 16, torch.int64, 0.0),
        ("sum f64 G=2^15 (global atomics)", "sum", rng.normal(0, 1, n), 1 << 15,
         torch.float64, 1e-12),
        ("max f64 G=2^15 (global atomics)", "max", f64, 1 << 15, torch.float64, 0.0),
        ("sum i64 G=2^15 (global atomics)", "sum", wrap, 1 << 15, torch.int64, 0.0),
    ]
    for label, op, vals, g, dt, rtol in edge_cases:
        gid = t(rng.integers(0, g, n).astype(np.int32))
        for mask_label, m in (("", rng.random(n) < 0.9), (", all-false mask", np.zeros(n, bool))):
            mask = t(m)
            v = t(vals) if vals is not None else None
            if op in ("min", "max"):
                out0 = torch.full((g,), gb._identity_for(dt, op), dtype=dt, device=dev)
            else:
                out0 = torch.zeros(g, dtype=dt, device=dev)
            a, b, scale = k1(op, v, gid, mask, g, out0)
            torch.cuda.synchronize()
            err = same(label + mask_label, a, b, rtol, scale)
            log(json.dumps({"check": "K1 " + label + mask_label, "ok": True,
                            "max_abs_err": err}))

    # ---- K1 at the main path's shapes: one 16M-row feed, G = 64
    g = 64
    gid = t(rng.integers(0, g, FEED).astype(np.int32))
    mask = t(rng.random(FEED) < 0.95)
    lat = t(rng.exponential(50.0, FEED))
    gid64, mask64 = gid.long(), mask.long()
    lat_masked = torch.where(mask, lat, 0.0)
    for op, v, dt, entry, rtol in (("count", None, torch.int64, "px_segment_count", 0.0),
                                   ("sum", lat, torch.float64, "px_segment_sum_f64", 1e-12)):
        out0 = torch.zeros(g, dtype=dt, device=dev)
        a, b, scale = k1(op, v, gid, mask, g, out0)
        torch.cuda.synchronize()
        err = same(f"{op} main", a, b, rtol, scale)
        acc = torch.zeros(g, dtype=dt, device=dev)
        if op == "count":
            kern = lambda: gb.masked_segment_count(gid, g, mask, out=acc)  # noqa: E731
            plain = lambda: gb.segment_count_plain(gid, g, mask, acc)  # noqa: E731
            lib = lambda: acc.index_add_(0, gid64, mask64)  # noqa: E731
            nbytes = FEED * (4 + 1) + 2 * g * 8
        else:
            kern = lambda: gb.masked_segment_sum(lat, gid, g, mask, out=acc)  # noqa: E731
            plain = lambda: gb.segment_sum_plain(lat, gid, g, mask, acc)  # noqa: E731
            lib = lambda: acc.index_add_(0, gid64, lat_masked)  # noqa: E731
            nbytes = FEED * (4 + 1 + 8) + 2 * g * 8
        b_ms, by = bound(nbytes, FEED if op == "sum" else 0)
        rows.append({
            "name": f"segment_reduce.{op}" + ("_f64" if op == "sum" else ""),
            "route": "cuda", "source": "pixie_tpu_torch/csrc/segment_reduce.cu",
            "replaces": ("pixie_tpu/ops/groupby.py:177 masked_segment_count"
                         if op == "count" else
                         "pixie_tpu/ops/groupby.py:136 masked_segment_sum"),
            "entry": ("segment_reduce", entry),
            "max_abs_err": err,
            "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": b_ms, "bound_by": by,
            "library_ms": cuda_ms(lib, 10),
            "shape": {"rows": FEED, "groups": g},
        })

    # ---- K2: bin edges, the zero bin, special values, both memory paths
    lh = LogHistogram()
    W = lh.width
    k = np.arange(-530, 530, dtype=np.float64)
    edges = np.power(lh.gamma, k)
    special = np.array([0.0, -1.0, 1e-9, np.nextafter(1e-9, 1.0), 5e-324, 1.0, np.inf,
                        -np.inf, np.nan, 1e300, 3.4e38, 3.5e38])
    edge_vals = np.concatenate([edges, np.nextafter(edges, 0.0),
                                np.nextafter(edges, np.inf), special])
    for label, g_, nv in (("bin edges G=64", 64, None), ("bin edges G=1", 1, None),
                          ("G=512 (global atomics)", 512, 1 << 20)):
        vals = (np.resize(edge_vals, 1 << 18) if nv is None
                else np.concatenate([rng.exponential(50.0, nv), edge_vals]))
        m = len(vals)
        gid_e = t(rng.integers(0, g_, m).astype(np.int32))
        v_e = t(rng.permutation(vals))
        for mask_label, mm in (("", rng.random(m) < 0.9), (", all-false mask", np.zeros(m, bool))):
            mask_e = t(mm)
            a, b = lh.init(g_, dev), lh.init(g_, dev)
            lh.update(a, gid_e, v_e, mask_e, g_)
            lh.update_plain(b, gid_e, v_e, mask_e, g_)
            torch.cuda.synchronize()
            err = same("K2 " + label + mask_label, a, b)
            log(json.dumps({"check": "K2 " + label + mask_label, "ok": True,
                            "max_abs_err": err}))
    # main shapes
    a, b = lh.init(g, dev), lh.init(g, dev)
    lh.update(a, gid, lat, mask, g)
    lh.update_plain(b, gid, lat, mask, g)
    torch.cuda.synchronize()
    err = same("K2 main", a, b)
    acc = lh.init(g, dev)
    cell = gid64 * W + lh.bin_index(lat)
    weights = mask.float()
    rows.append({
        "name": "loghist_update", "route": "cuda",
        "source": "pixie_tpu_torch/csrc/loghist_update.cu",
        "replaces": "pixie_tpu/ops/sketch.py:118 LogHistogram.update (+ bin_index :101)",
        "entry": ("loghist_update", "px_loghist_update"),
        "max_abs_err": err,
        "ms": cuda_ms(lambda: lh.update(acc, gid, lat, mask, g), 20),
        "plain_ms": cuda_ms(lambda: lh.update_plain(acc, gid, lat, mask, g), 5),
        "bound_ms": bound(FEED * 13 + 2 * g * W * 4, 2 * FEED)[0],
        "bound_by": bound(FEED * 13 + 2 * g * W * 4, 2 * FEED)[1],
        # nearest single call: a weighted bincount of the precomputed cells
        "library_ms": cuda_ms(lambda: torch.bincount(cell, weights=weights,
                                                     minlength=g * W), 10),
        "shape": {"rows": FEED, "groups": g, "bins": W},
    })

    # ---- K3: exact against its plain version, incl. empty groups and G = 1
    qs = [0.0, 0.01, 0.5, 0.9, 0.99, 1.0]
    for label, g_ in (("G=64", 64), ("G=1", 1), ("G=4096", 4096)):
        h = torch.from_numpy(rng.poisson(3.0, (g_, W)).astype(np.float32)).to(dev)
        h[g_ // 2] = 0  # an empty group → NaN
        got, want = lh.quantile_device(h, qs), lh.quantile_plain(h, qs)
        torch.cuda.synchronize()
        same("K3 " + label, got, want)
        host = lh.quantile(h.cpu().numpy(), qs)
        same("K3 vs host " + label, got, torch.from_numpy(host))
        log(json.dumps({"check": "K3 " + label, "ok": True, "max_abs_err": 0.0}))
    got, want = lh.quantile_device(a, [0.5]), lh.quantile_plain(a, [0.5])
    torch.cuda.synchronize()
    err = same("K3 main", got, want)
    rows.append({
        "name": "loghist_quantile", "route": "cuda",
        "source": "pixie_tpu_torch/csrc/loghist_quantile.cu",
        "replaces": "pixie_tpu/ops/sketch.py:257 LogHistogram.quantile_device",
        "entry": ("loghist_quantile", "px_loghist_quantile"),
        "max_abs_err": err,
        "ms": cuda_ms(lambda: lh.quantile_device(a, [0.5]), 50),
        "plain_ms": cuda_ms(lambda: lh.quantile_plain(a, [0.5]), 20),
        "bound_ms": bound(g * W * 4 + 4 + W * 8 + g * 8)[0],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": {"groups": g, "bins": W, "quantiles": 1},
    })
    return rows


# -------------------------------------------------------------------- slice


def build_http_table(ts, rows: int, batch_rows: int = 1 << 16, span_s: int = 600):
    """bench.build_http_table's generator, written into the port's store."""
    from pixie_tpu_torch.types import DataType as DT, Relation

    rng = np.random.default_rng(12)
    rel = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                      ("latency", DT.FLOAT64), ("status", DT.INT64))
    t = ts.create("http_events", rel, batch_rows=batch_rows, max_bytes=1 << 36)
    services = np.array([f"svc-{i}" for i in range(N_SERVICES)])
    chunk = 1 << 21
    written = 0
    t_step = span_s * SEC // max(rows, 1)
    while written < rows:
        n = min(chunk, rows - written)
        svc_idx = rng.integers(0, N_SERVICES, n)
        t.write({
            "time_": np.arange(written, written + n, dtype=np.int64) * t_step,
            "service": services[svc_idx],
            "latency": rng.exponential(50.0, n),
            "status": rng.choice([200, 404, 500], n, p=[0.85, 0.05, 0.10]),
        })
        written += n
    return t


def http_plan():
    """bench.http_plan() (config #1) with the port's plan API."""
    from pixie_tpu_torch.plan import (AggExpr, AggOp, Call, Column, FilterOp,
                                      MemorySinkOp, MemorySourceOp, Plan, lit)

    p = Plan()
    src = p.add(MemorySourceOp(table="http_events"))
    node = p.add(FilterOp(expr=Call("not_equal", (Column("status"), lit(404)))),
                 parents=[src])
    agg = p.add(AggOp(groups=["service", "status"], values=[
        AggExpr("cnt", "count", None), AggExpr("avg_lat", "mean", "latency"),
        AggExpr("p50", "p50", "latency")]), parents=[node])
    p.add(MemorySinkOp(name="output"), parents=[agg])
    return p


def oracle_check(table, res) -> dict:
    """numpy oracle of config #1 over the table's rows; raises on mismatch.
    Its sketch is plain numpy and shares no code with the port's."""
    cols = {k: [] for k in ("service", "latency", "status")}
    for rb, _rid, _gen in table.cursor():
        for k in cols:
            cols[k].append(rb.columns[k][: rb.num_valid])
    svc, lat, st = (np.concatenate(cols[k]) for k in ("service", "latency", "status"))
    sel = st != 404
    svc, lat, st = svc[sel], lat[sel], st[sel]
    statuses = np.unique(st)
    key = svc.astype(np.int64) * len(statuses) + np.searchsorted(statuses, st)
    ng = int(key.max()) + 1
    cnt = np.bincount(key, minlength=ng)
    mean = np.bincount(key, weights=lat, minlength=ng) / np.maximum(cnt, 1)
    W = WIDTH
    x = np.maximum(lat.astype(np.float32), np.float32(MIN_VALUE))
    lg = np.log(x) / np.float32(math.log(GAMMA))
    bins = np.clip(np.ceil(lg).astype(np.int64) + 1, 0, W - 1)
    bins[lat <= MIN_VALUE] = 0
    hist = np.bincount(key * W + bins, minlength=ng * W).reshape(ng, W)
    # p50 bin: first bin whose running count reaches half the group's total
    cum = np.cumsum(hist, axis=1)
    idx = np.minimum((cum < 0.5 * cum[:, -1:]).sum(axis=1), W - 1)
    sketch_p50 = np.where(idx <= 0, 0.0, GAMMA ** (idx - 1.5))
    order = np.argsort(key, kind="stable")
    bounds = np.searchsorted(key[order], np.arange(ng + 1))
    lat_sorted = lat[order]
    median = np.array([np.median(lat_sorted[bounds[i]:bounds[i + 1]]) if cnt[i] else np.nan
                       for i in range(ng)])

    got_key = (res.columns["service"].astype(np.int64) * len(statuses)
               + np.searchsorted(statuses, res.columns["status"]))
    if res.num_rows != int((cnt > 0).sum()):
        raise AssertionError(f"groups: got {res.num_rows}, want {(cnt > 0).sum()}")
    if not np.array_equal(np.asarray(res.columns["cnt"]), cnt[got_key]):
        raise AssertionError("counts differ from the oracle")
    if not np.allclose(res.columns["avg_lat"], mean[got_key], rtol=1e-9, atol=0):
        raise AssertionError("means differ from the oracle beyond rtol 1e-9")
    p50 = np.asarray(res.columns["p50"])
    want = sketch_p50[got_key]
    ratio = p50 / want
    in_bin = ((ratio == 1.0) | np.isclose(ratio, GAMMA, rtol=1e-12)
              | np.isclose(ratio, 1 / GAMMA, rtol=1e-12))
    if not in_bin.all():
        raise AssertionError(f"p50 outside the oracle's sketch bin: {p50[~in_bin]}")
    rel_err = np.abs(p50 - median[got_key]) / median[got_key]
    if not (rel_err <= 0.021).all():
        raise AssertionError(f"p50 beyond 2.1% of np.median: {rel_err.max()}")
    if not all(np.isfinite(np.asarray(res.columns[c], dtype=np.float64)).all()
               for c in ("cnt", "avg_lat", "p50")):
        raise AssertionError("non-finite results")
    return {"groups": res.num_rows,
            "p50_exact_bin": int((ratio == 1.0).sum()),
            "p50_max_rel_err_vs_median": float(rel_err.max())}


def profile_query(query) -> dict:
    """One query under torch.profiler: device busy time (kernels and copies,
    by name) against the host wall time, and so the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        query()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:15]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "top": [{"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in top]}


def run_slice(dev, with_profile: bool) -> dict:
    import torch

    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.table import TableStore

    t0 = time.perf_counter()
    ts = TableStore()
    table = build_http_table(ts, ROWS)
    log(json.dumps({"phase": "slice.data", "rows": ROWS,
                    "seconds": time.perf_counter() - t0}))
    plan = http_plan()

    def query(**kw):
        r = execute_plan(plan, ts, device=dev, **kw)["output"]
        torch.cuda.synchronize(dev)
        return r

    _build.reset_launches()
    t0 = time.perf_counter()
    res = query()
    first_s = time.perf_counter() - t0
    launches = {name: dict(k.by_entry) for name, k in _build.KERNELS.items()}
    totals = {name: k.launches for name, k in _build.KERNELS.items()}
    missing = [name for name, c in totals.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    log(json.dumps({"phase": "slice.launches", "per_query": launches}))
    check = oracle_check(table, res)
    log(json.dumps({"phase": "slice.oracle", "ok": True, **check}))

    for _ in range(2):
        query()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        query()
        times.append(time.perf_counter() - t0)
    times.sort()
    med = times[len(times) // 2]
    analyzed = execute_plan(plan, ts, device=dev, analyze=True)["output"].exec_stats
    if with_profile:
        log(json.dumps({"phase": "slice.profile", **profile_query(query)}))
    return {"launches": launches, "first_query_s": first_s, "query_s": times,
            "median_query_s": med, "rows_per_s": ROWS / med,
            "feeds": analyzed["feeds"], "h2d_bytes": analyzed["h2d_bytes"],
            "analyze_feed_ms": [x / 1e6 for x in analyzed.get("feed_ns", [])]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one warm query with torch.profiler")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import pixie_tpu_torch  # noqa: F401  (fails outside the repo)
    from pixie_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(json.dumps({"phase": "device", "name": name, "nvidia_smi": smi,
                    "torch": torch.__version__, "cuda": torch.version.cuda}))

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(json.dumps({"phase": "build", "wall_s": time.perf_counter() - t0,
                    "nvcc_s": secs}))

    rows = check_kernels(dev)
    sl = run_slice(dev, args.profile)
    log(json.dumps({"phase": "slice", "card": smi, **sl}))
    for r in rows:
        lib, entry = r.pop("entry")
        r["launches"] = sl["launches"][lib].get(entry, 0)
        log(json.dumps({"kernel": r["name"], "kernel_ms": r["ms"], "plain_ms": r["plain_ms"],
                        "library_ms": r["library_ms"], "bound_ms": r["bound_ms"],
                        "launches": r["launches"], "shape": r["shape"], "card": smi}))
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shape"}
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
