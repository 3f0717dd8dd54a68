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
                single PyTorch library call and its bound on the card.
                The phase also holds K4 (stable compaction) against its plain
                version at 2^24 rows of 4 columns (int32, int64, f64, bool)
                and mask densities 0.9, 0.1, 1 and 0, exactly and in order;
                J1-J3 (the join's build, probe and expand) through
                device_join_codes at bench's device-join shape (16M x 16M
                codes uniform in [0, 16M), seed 11) and at edge cases (one
                key with 4096 rows a side, no matches, all-null probe codes,
                wide sparse codes), as exact pair sets and matched flags; and
                times K1 min/max at the main path's shape;
  4. slice    — bench config #1 (filter status != 404, group by service and
                status, count / mean / p50 of latency) over an http_events
                table of 64M rows (bench's headline size) built with the
                port's TableStore, run through
                execute_plan(device="cuda"), checked against a numpy oracle
                (counts exact, means to rtol 1e-9, p50 in the oracle's sketch
                bin or the next one, and within 2.1% of np.median), with
                every kernel of the path launched at least once; then timed
                warm (median of 5 runs after 2 warm-ups);
  5. select   — over the same table: filter status == 500, select time_,
                service, latency, status (~6.4M rows), and the same with
                head(100000); rows and their order equal to a numpy oracle;
                each timed warm (median of 5 after 2 warm-ups);
  6. config3  — bench_config3 (16M network_stats rows, 256 pods, seed 5,
                sums per pod, joined with the 256-row pods table, sums per
                service): 24 rows with the oracle's exact int64 sums; the
                join is below the device gate and matches on the host;
  7. join     — an inner join of two 2^22-row tables (k uniform in
                [0, 2^20), seed 9) through execute_plan(device="cuda"): one
                device join (J1-J3) with gate reason h2d_direct_attached,
                sorted (k, a, b) rows equal to a numpy oracle's; timed warm,
                and one analyze run splits it into host key codes, H2D,
                J1-J3 and D2H (--profile adds the device trace).
Each slice phase resets the launch counts just before its first query and
reads them just after; a kernel of the phase that did not launch fails it.

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
#: bench's device-join shape (bench.py bench_device_join): 16M x 16M codes
JOIN_ROWS = 1 << 24
#: config #3's network_stats rows (bench_config3 at 16M) and the executor
#: device join's rows per side
CONFIG3_ROWS = 1 << 24
EXEC_JOIN_ROWS = 1 << 22
#: (library, C entry point) of the kernels each slice phase must launch
CONFIG1_KERNELS = [("segment_reduce", "px_segment_count"),
                   ("segment_reduce", "px_segment_sum_f64"),
                   ("loghist_update", "px_loghist_update"),
                   ("loghist_quantile", "px_loghist_quantile")]
SELECT_KERNELS = [("compact", "px_compact")]
CONFIG3_KERNELS = [("segment_reduce", "px_segment_sum_i64"), ("compact", "px_compact")]
JOIN_KERNELS = [("compact", "px_compact"), ("join", "px_join_build"),
                ("join", "px_join_probe"), ("join", "px_join_expand")]


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


def read_launches(phase: str, required) -> dict:
    """Launches since the last reset, by library and C entry point; raises if
    a kernel the phase must run did not launch."""
    from pixie_tpu_torch.ops import _build

    launches = {name: dict(k.by_entry) for name, k in _build.KERNELS.items()}
    missing = [f"{lib}.{e}" for lib, e in required if launches[lib].get(e, 0) == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {phase} path: {missing}")
    return launches


def warm_times(query, warmup: int = 2, reps: int = 5) -> list[float]:
    """Sorted wall seconds of `reps` runs of query() after `warmup` runs."""
    for _ in range(warmup):
        query()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        query()
        times.append(time.perf_counter() - t0)
    return sorted(times)


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
            "entry": ("segment_reduce", entry), "path": "config1",
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
        "entry": ("loghist_update", "px_loghist_update"), "path": "config1",
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
        "entry": ("loghist_quantile", "px_loghist_quantile"), "path": "config1",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: lh.quantile_device(a, [0.5]), 50),
        "plain_ms": cuda_ms(lambda: lh.quantile_plain(a, [0.5]), 20),
        "bound_ms": bound(g * W * 4 + 4 + W * 8 + g * 8)[0],
        "bound_by": "bytes",
        "library_ms": None,
        "shape": {"groups": g, "bins": W, "quantiles": 1},
    })
    return rows


def check_new_kernels(dev) -> list[dict]:
    """K1 min/max timed at the main path's shape; K4 and J1-J3 held against
    their plain versions.  Returns their kernel rows."""
    import torch

    from pixie_tpu_torch.ops import compact as k4
    from pixie_tpu_torch.ops import groupby as gb
    from pixie_tpu_torch.ops import join_device as jd

    rows = []

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # ---- K1 min / max at the main path's shape: one 16M-row feed, G = 64
    rng = np.random.default_rng(8)
    g = 64
    gid = t(rng.integers(0, g, FEED).astype(np.int32))
    mask = t(rng.random(FEED) < 0.95)
    lat = t(rng.exponential(50.0, FEED))
    gid64 = gid.long()
    for op in ("min", "max"):
        ident = gb._identity_for(torch.float64, op)
        out0 = torch.full((g,), ident, dtype=torch.float64, device=dev)
        a, b = out0.clone(), out0.clone()
        getattr(gb, f"masked_segment_{op}")(lat, gid, g, mask, out=a)
        gb.segment_pick_plain(lat, gid, g, mask, b, op)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"K1 {op} main: kernel and plain version disagree")
        acc = out0.clone()
        lat_id = torch.where(mask, lat, ident)
        red = "amin" if op == "min" else "amax"
        b_ms, by = bound(FEED * (4 + 1 + 8) + 2 * g * 8, FEED)
        rows.append({
            "name": f"segment_reduce.{op}_f64", "route": "cuda",
            "source": "pixie_tpu_torch/csrc/segment_reduce.cu",
            "replaces": f"pixie_tpu/ops/groupby.py:{188 if op == 'min' else 194} "
                        f"masked_segment_{op}",
            "entry": ("segment_reduce", f"px_segment_{op}_f64"), "path": None,
            "max_abs_err": 0.0,
            "ms": cuda_ms(lambda: getattr(gb, f"masked_segment_{op}")(
                lat, gid, g, mask, out=acc), 20),
            "plain_ms": cuda_ms(lambda: gb.segment_pick_plain(lat, gid, g, mask, acc, op), 5),
            "bound_ms": b_ms, "bound_by": by,
            "library_ms": cuda_ms(lambda: acc.scatter_reduce_(
                0, gid64, lat_id, reduce=red, include_self=True), 10),
            "shape": {"rows": FEED, "groups": g},
        })
    del gid, mask, lat, gid64

    # ---- K4: 2^24 rows, 4 columns, four densities; exact and in order
    rng = np.random.default_rng(9)
    n = FEED
    cols = [t(rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)),
            t(rng.integers(-2 ** 62, 2 ** 62, n)), t(rng.normal(size=n)),
            t(rng.random(n) < 0.5)]
    width = sum(c.element_size() for c in cols)
    u = t(rng.random(n))
    timed = {}
    for density in (0.9, 0.1, 1.0, 0.0):
        m = u < density
        got, count = k4.compact(m, cols)
        want, want_count = k4.compact_plain(m, cols)
        torch.cuda.synchronize()
        c = int(count)
        if c != int(want_count) or not all(torch.equal(x[:c], y[:c])
                                           for x, y in zip(got, want)):
            raise AssertionError(f"K4 density {density}: kernel and plain version disagree")
        log(json.dumps({"check": f"K4 density {density}", "ok": True, "kept": c,
                        "max_abs_err": 0.0}))
        if density in (0.9, 0.1):
            b_ms, by = bound(n + 2 * c * width + 8)
            timed[density] = {
                "ms": cuda_ms(lambda: k4.compact(m, cols), 20),
                "plain_ms": cuda_ms(lambda: k4.compact_plain(m, cols), 5),
                "library_ms": cuda_ms(lambda: [x[m] for x in cols], 10),
                "bound_ms": b_ms, "bound_by": by, "kept": c}
    log(json.dumps({"kernel_detail": "compact", "by_density": timed}))
    # the select phase keeps ~10% of each feed: its row is timed at 0.1
    rows.append({
        "name": "compact", "route": "cuda", "source": "pixie_tpu_torch/csrc/compact.cu",
        "replaces": "pixie_tpu/engine/executor.py:603 ChainKernel.make_output_step",
        "entry": ("compact", "px_compact"), "path": "select", "max_abs_err": 0.0,
        **{k: v for k, v in timed[0.1].items() if k != "kept"},
        "shape": {"rows": n, "columns": "int32,int64,f64,bool", "density": 0.1,
                  "kept": timed[0.1]["kept"]},
    })
    del cols, u, m, got, want

    # ---- J1-J3 at bench's device-join shape, stage by stage
    rng = np.random.default_rng(11)
    nj = JOIN_ROWS
    b = t(rng.integers(0, nj, nj).astype(np.int64))
    p = t(rng.integers(0, nj, nj).astype(np.int64))
    b2, p2, K = jd._dense(b, p)
    cnt, first, rbc = jd.join_build(b2, K)
    cnt_p, lo_p, total_t = jd.join_probe(p2, cnt, first)
    total = int(total_t)
    bidx, pidx, bm, pm = jd.join_expand(cnt_p, lo_p, rbc, nj, total)
    cnt0, first0, rbc0 = jd.join_build_plain(b2, K)
    cnt_p0, lo_p0, total0 = jd.join_probe_plain(p2, cnt0, first0)
    bidx0, pidx0, bm0, pm0 = jd.join_expand_plain(cnt_p0, lo_p0, rbc0, nj, int(total0))
    torch.cuda.synchronize()
    checks = {
        "J1 cnt/first": torch.equal(cnt, cnt0) and torch.equal(first, first0),
        "J1 rows_by_code": torch.equal(torch.sort(b2[rbc[:rbc0.shape[0]].long()] * nj
                                                  + rbc[:rbc0.shape[0]]).values,
                                       torch.sort(b2[rbc0.long()] * nj + rbc0).values),
        "J2 count/lo/total": (torch.equal(cnt_p, cnt_p0) and torch.equal(lo_p, lo_p0)
                              and total == int(total0)),
        "J3 pairs": torch.equal(torch.sort(bidx * nj + pidx).values,
                                torch.sort(bidx0 * nj + pidx0).values),
        "J3 matched flags": torch.equal(bm, bm0) and torch.equal(pm, pm0),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"J1-J3 at {nj} x {nj}: kernels and plain versions disagree: {bad}")
    log(json.dumps({"check": f"J1-J3 {nj} x {nj} uniform", "ok": True, "K": K,
                    "pairs": total, "max_abs_err": 0.0}))
    hit = min(K, nj)  # table slots a probe can touch
    stages = [
        ("join.build", "px_join_build", "pixie_tpu/ops/join_device.py:136 _pack_sort",
         lambda: jd.join_build(b2, K), lambda: jd.join_build_plain(b2, K),
         nj * 8 + K * 4 * 2 + nj * 4),
        ("join.probe", "px_join_probe", "pixie_tpu/ops/join_device.py:161 _bucket_match",
         lambda: jd.join_probe(p2, cnt, first), lambda: jd.join_probe_plain(p2, cnt0, first0),
         nj * 8 + hit * 8 + nj * 8 + 8),
        ("join.expand", "px_join_expand",
         "pixie_tpu/ops/join_device.py:188 _bucket_expand (+ _expand :103, match_ranges :87)",
         lambda: jd.join_expand(cnt_p, lo_p, rbc, nj, total),
         lambda: jd.join_expand_plain(cnt_p0, lo_p0, rbc0, nj, total),
         nj * 8 + min(total, nj) * 4 + total * 16 + nj + nj),
    ]
    for name, entry, replaces, kern, plain, nbytes in stages:
        b_ms, by = bound(nbytes)
        rows.append({
            "name": name, "route": "cuda", "source": "pixie_tpu_torch/csrc/join.cu",
            "replaces": replaces, "entry": ("join", entry), "path": "device_join",
            "max_abs_err": 0.0, "ms": cuda_ms(kern, 10), "plain_ms": cuda_ms(plain, 3, 1),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "shape": {"build": nj, "probe": nj, "K": K, "pairs": total},
        })
    del cnt, first, rbc, cnt_p, lo_p, bidx, pidx, bm, pm
    del cnt0, first0, rbc0, cnt_p0, lo_p0, bidx0, pidx0, bm0, pm0, b2, p2

    # ---- J1-J3 edge cases through device_join_codes, against the plain route
    def plain_join(bc, pc):
        bd, pd_, kk = jd._dense(bc, pc)
        c0, f0, r0 = jd.join_build_plain(bd, kk)
        cp, lp, tt = jd.join_probe_plain(pd_, c0, f0)
        return jd.join_expand_plain(cp, lp, r0, bc.shape[0], int(tt))

    bg = rng.integers(100, 1 << 22, 1 << 20)
    edges = {
        "one key, 4096 rows a side": (np.concatenate([np.full(4096, 7), bg]),
                                      np.concatenate([np.full(4096, 7), bg[::-1]])),
        "no matches": (rng.integers(0, 1 << 20, 1 << 20),
                       rng.integers(1 << 20, 1 << 21, 1 << 20)),
        "all-null probe codes": (rng.integers(0, 1 << 20, 1 << 20), np.full(1 << 20, -2)),
        "wide sparse codes (x 2^40)": (rng.integers(0, 1 << 20, 1 << 20) << 40,
                                       rng.integers(0, 1 << 20, 1 << 20) << 40),
    }
    for label, (bh, ph) in edges.items():
        bc, pc = t(bh.astype(np.int64)), t(ph.astype(np.int64))
        gi, gp, gbm, gpm = (t(x) for x in jd.device_join_codes(bc, pc))
        wi, wp, wbm, wpm = plain_join(bc, pc)
        npr = pc.shape[0]
        ok = (gi.shape == wi.shape
              and torch.equal(torch.sort(gi * npr + gp).values, torch.sort(wi * npr + wp).values)
              and torch.equal(gbm, wbm) and torch.equal(gpm, wpm))
        if not ok:
            raise AssertionError(f"J1-J3 {label}: kernels and plain route disagree")
        log(json.dumps({"check": f"J1-J3 {label}", "ok": True, "pairs": int(gi.shape[0]),
                        "max_abs_err": 0.0}))
    del b, p
    torch.cuda.empty_cache()
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
    launches = read_launches("config #1", CONFIG1_KERNELS)
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
            "analyze_feed_ms": [x / 1e6 for x in analyzed.get("feed_ns", [])]}, ts, table


def _table_columns(table, names) -> dict:
    parts = {k: [] for k in names}
    for rb, _rid, _gen in table.cursor():
        for k in names:
            parts[k].append(rb.columns[k][: rb.num_valid])
    return {k: np.concatenate(v) for k, v in parts.items()}


def select_plan(head: int | None):
    """filter status == 500 → [head(n)] → select time_, service, latency,
    status."""
    from pixie_tpu_torch.plan import (Call, Column, FilterOp, LimitOp, MemorySinkOp,
                                      MemorySourceOp, Plan, lit)

    p = Plan()
    node = p.add(FilterOp(expr=Call("equal", (Column("status"), lit(500)))),
                 parents=[p.add(MemorySourceOp(table="http_events"))])
    if head is not None:
        node = p.add(LimitOp(n=head), parents=[node])
    p.add(MemorySinkOp(name="output", columns=["time_", "service", "latency", "status"]),
          parents=[node])
    return p


def run_select(dev, ts, table, with_profile: bool) -> dict:
    """Select phase over config #1's table: all status-500 rows, then the
    first 100000 of them; rows and order against a numpy oracle."""
    import torch

    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.ops import _build

    names = ["time_", "service", "latency", "status"]
    cols = _table_columns(table, names)
    sel = np.nonzero(cols["status"] == 500)[0]
    out = {}
    for label, head in (("select", None), ("select_head", 100_000)):
        plan = select_plan(head)
        want_rows = sel if head is None else sel[:head]

        def query(plan=plan):
            r = execute_plan(plan, ts, device=dev)["output"]
            torch.cuda.synchronize(dev)
            return r

        _build.reset_launches()
        res = query()
        launches = read_launches(label, SELECT_KERNELS)
        if res.num_rows != len(want_rows):
            raise AssertionError(f"{label}: {res.num_rows} rows, oracle {len(want_rows)}")
        for k in names:
            if not np.array_equal(np.asarray(res.columns[k]), cols[k][want_rows]):
                raise AssertionError(f"{label}: column {k} differs from the oracle")
        times = warm_times(query)
        out[label] = {"rows": res.num_rows, "launches": launches, "query_s": times,
                      "median_query_s": times[len(times) // 2],
                      "pipelined_waves": res.exec_stats.get("pipelined_waves", 0),
                      "h2d_bytes": res.exec_stats["h2d_bytes"]}
        log(json.dumps({"phase": f"slice.{label}", "ok": True,
                        **{k: v for k, v in out[label].items() if k != "launches"}}))
        if with_profile and head is None:
            log(json.dumps({"phase": "slice.select.profile", **profile_query(query)}))
    return out


def run_config3(dev) -> dict:
    """bench_config3 through the port: 24 services with exact int64 sums."""
    import torch

    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.plan import (AggExpr, AggOp, JoinOp, MemorySinkOp,
                                      MemorySourceOp, Plan)
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    n_pods, rows = 256, CONFIG3_ROWS
    ts = TableStore()
    t = ts.create("network_stats", Relation.of(
        ("time_", DT.TIME64NS), ("pod_id", DT.STRING), ("rx_bytes", DT.INT64),
        ("tx_bytes", DT.INT64)), batch_rows=1 << 16, max_bytes=1 << 36)
    pods = np.array([f"pod-{i}" for i in range(n_pods)])
    pod_idx, rx, tx = [], [], []
    written, chunk = 0, 1 << 21
    while written < rows:
        n = min(chunk, rows - written)
        pi = rng.integers(0, n_pods, n)
        r_, x_ = rng.integers(0, 1 << 20, n), rng.integers(0, 1 << 20, n)
        t.write({"time_": np.arange(written, written + n, dtype=np.int64),
                 "pod_id": pods[pi], "rx_bytes": r_, "tx_bytes": x_})
        pod_idx.append(pi)
        rx.append(r_)
        tx.append(x_)
        written += n
    services = np.array([f"svc-{i % 24}" for i in range(n_pods)])
    ts.create("pods", Relation.of(("pod_id", DT.STRING), ("service", DT.STRING))).write(
        {"pod_id": pods, "service": services})
    log(json.dumps({"phase": "config3.data", "rows": rows,
                    "seconds": time.perf_counter() - t0}))

    p = Plan()
    agg = p.add(AggOp(groups=["pod_id"], values=[
        AggExpr("rx", "sum", "rx_bytes"), AggExpr("tx", "sum", "tx_bytes")]),
        parents=[p.add(MemorySourceOp(table="network_stats"))])
    join = p.add(JoinOp(how="inner", left_on=["pod_id"], right_on=["pod_id"],
                        output=[("left", "pod_id", "pod_id"), ("left", "rx", "rx"),
                                ("left", "tx", "tx"), ("right", "service", "service")]),
                 parents=[agg, p.add(MemorySourceOp(table="pods"))])
    agg2 = p.add(AggOp(groups=["service"], values=[
        AggExpr("rx", "sum", "rx"), AggExpr("tx", "sum", "tx")]), parents=[join])
    p.add(MemorySinkOp(name="output"), parents=[agg2])

    def query():
        r = execute_plan(p, ts, device=dev)["output"]
        torch.cuda.synchronize(dev)
        return r

    _build.reset_launches()
    res = query()
    launches = read_launches("config #3", CONFIG3_KERNELS)
    # oracle: int64 sums per pod, then per service (svc index = pod % 24)
    pod_idx, rx, tx = (np.concatenate(v) for v in (pod_idx, rx, tx))
    svc_of_pod = np.arange(n_pods) % 24
    # (float64 bincounts are exact here: every sum is an integer below 2^53)
    want = {}
    for name, v in (("rx", rx), ("tx", tx)):
        per_pod = np.bincount(pod_idx, weights=v, minlength=n_pods)
        per_svc = np.bincount(svc_of_pod, weights=per_pod, minlength=24)
        if per_svc.max() >= 2.0 ** 53:
            raise AssertionError("config #3 oracle: sums beyond float64's exact integers")
        want[name] = per_svc.astype(np.int64)
    got_svc = [int(s.split("-")[1]) for s in res.decoded("service")]
    if res.num_rows != 24 or sorted(got_svc) != list(range(24)):
        raise AssertionError(f"config #3: {res.num_rows} rows, want the 24 services")
    for name in ("rx", "tx"):
        if not np.array_equal(np.asarray(res.columns[name]), want[name][got_svc]):
            raise AssertionError(f"config #3: {name} sums differ from the oracle")
    st = res.exec_stats
    if st.get("device_joins", 0) != 0:
        raise AssertionError("config #3's 256-row join left the host match")
    times = warm_times(query)
    out = {"rows": res.num_rows, "launches": launches, "query_s": times,
           "median_query_s": times[len(times) // 2], "rows_per_s": rows / times[len(times) // 2],
           "join_route": "host match (_match_pairs): the join has 256 rows a side, "
                         "below the 2^16-row device gate"}
    log(json.dumps({"phase": "slice.config3", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"}}))
    return out


def run_device_join(dev, with_profile: bool) -> dict:
    """An executor-level inner join of two 2^22-row tables on the card."""
    import torch

    from pixie_tpu_torch.engine.executor import PlanExecutor
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.plan import JoinOp, MemorySinkOp, MemorySourceOp, Plan
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation

    n = EXEC_JOIN_ROWS
    rng = np.random.default_rng(9)
    lk, rk = rng.integers(0, 1 << 20, n), rng.integers(0, 1 << 20, n)
    ts = TableStore()
    ts.create("left", Relation.of(("k", DT.INT64), ("a", DT.INT64)), batch_rows=1 << 16,
              max_bytes=1 << 34).write({"k": lk, "a": np.arange(n, dtype=np.int64)})
    ts.create("right", Relation.of(("k", DT.INT64), ("b", DT.INT64)), batch_rows=1 << 16,
              max_bytes=1 << 34).write({"k": rk, "b": np.arange(n, dtype=np.int64)})
    p = Plan()
    j = p.add(JoinOp(how="inner", left_on=["k"], right_on=["k"],
                     output=[("left", "k", "k"), ("left", "a", "a"), ("right", "b", "b")]),
              parents=[p.add(MemorySourceOp(table="left")),
                       p.add(MemorySourceOp(table="right"))])
    p.add(MemorySinkOp(name="out"), parents=[j])

    def run(analyze=False):
        ex = PlanExecutor(p, ts, device=dev, analyze=analyze)
        r = ex.run()["out"]
        torch.cuda.synchronize(dev)
        return r, ex.stats

    _build.reset_launches()
    res, st = run()
    launches = read_launches("device join", JOIN_KERNELS)
    gate = st.get("device", {}).get("join_gate", {})
    if st.get("device_joins", 0) != 1 or gate.get("reason") != "h2d_direct_attached":
        raise AssertionError(f"device join: device_joins={st.get('device_joins')}, "
                             f"gate={gate}")
    # oracle: every (left row, right row) with equal k; rows (k, a, b) sorted
    # by (a, b), which are unique row ids
    order = np.argsort(rk, kind="stable")
    lo = np.searchsorted(rk[order], lk, "left")
    hi = np.searchsorted(rk[order], lk, "right")
    cnt = hi - lo
    a_w = np.repeat(np.arange(n, dtype=np.int64), cnt)
    b_w = order[np.repeat(lo, cnt) + (np.arange(cnt.sum()) - np.repeat(np.cumsum(cnt) - cnt, cnt))]
    want = np.sort(a_w * n + b_w)
    a_g, b_g, k_g = (np.asarray(res.columns[c]) for c in ("a", "b", "k"))
    got_key = a_g * n + b_g
    if len(got_key) != len(want) or not np.array_equal(np.sort(got_key), want) \
            or not np.array_equal(k_g, lk[a_g]) or not np.array_equal(k_g, rk[b_g]):
        raise AssertionError("device join: rows differ from the numpy oracle")
    times = warm_times(lambda: run(), warmup=1, reps=3)
    _res, st_an = run(analyze=True)
    out = {"pairs": int(len(got_key)), "launches": launches, "gate": gate,
           "query_s": times, "median_query_s": times[len(times) // 2],
           "split_s": st_an["join_split_s"]}
    log(json.dumps({"phase": "slice.device_join", "ok": True,
                    **{k: v for k, v in out.items() if k != "launches"}}))
    if with_profile:
        log(json.dumps({"phase": "slice.device_join.profile",
                        **profile_query(lambda: run())}))
    return out


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

    rows = check_kernels(dev) + check_new_kernels(dev)
    sl, ts, table = run_slice(dev, args.profile)
    log(json.dumps({"phase": "slice", "card": smi, **sl}))
    paths = {"config1": sl["launches"]}
    paths["select"] = run_select(dev, ts, table, args.profile)["select"]["launches"]
    del ts, table
    paths["config3"] = run_config3(dev)["launches"]
    paths["device_join"] = run_device_join(dev, args.profile)["launches"]
    log(json.dumps({"phase": "launches", "per_path": paths}))
    idle = [lib for lib in _build.KERNELS if not any(p_[lib] for p_ in paths.values())]
    if idle:
        raise AssertionError(f"kernels launched on no path: {idle}")
    for r in rows:
        lib, entry = r.pop("entry")
        path = r.pop("path")
        # K1 min/max is on no path of this slice: it launches 0 times there
        r["launches"] = paths[path][lib].get(entry, 0) if path else 0
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
