"""Device equijoin: the match phase over int64 key codes, kernels J1-J3.

Reference: pixie_tpu/ops/join_device.py, which packs `code << idx_bits | row`,
sorts it and matches pow2 radix buckets (static shapes for XLA, cache-sized
working sets for the TPU).  On Hopper the executor's codes are dense
(`_composite_codes` gives unique-inverse codes in [0, K), K <= nl + nr), so a
code addresses its own slot and the join is a counting join
(csrc/join.cu):

  * J1 `join_build`: histogram of the build codes → cnt[K], its exclusive
    scan → first[K], and the build rows grouped by code → rows_by_code;
  * J2 `join_probe`: per probe row, its match count cnt[code] and start
    first[code] (codes outside [0, K), such as the executor's null sentinels
    -1 and -2, match nothing), and the total number of pairs;
  * J3 `join_expand`: each probe row's pair offset (an exclusive scan of the
    counts) and the pairs themselves, with both sides' matched flags.

Codes that are negative on both sides, or too wide to address directly, are
first made dense with one `torch.unique(..., return_inverse=True)` over both
sides, so wide and sparse codes go through the same kernels.

Each of join_build / join_probe / join_expand launches its kernel on a CUDA
tensor and runs the plain PyTorch version beside it on a CPU tensor; a CUDA
tensor never reaches a plain version.  `device_join_codes` is the entry
point, with the reference's contract: (build_idx, probe_idx, build_matched,
probe_matched), pair order unspecified.  On the card the
pairs come grouped by probe row in probe-row order; within a probe row the
build rows come in the order J1's atomics gave out their slots, which can
change from run to run.  The plain versions give build rows ascending.

The gate (`device_join_gate`) is the reference's: PX_DEVICE_JOIN forces it
(0 off, 1 on); -1 decides from the measured host→device bandwidth on a CUDA
device.  The reference's CPU decision rests on its native C++ join, which the
port does not load, so on a CPU device the auto gate is off.
"""
from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

from pixie_tpu_torch import flags
from pixie_tpu_torch.ops import _build
from pixie_tpu_torch.ops.compact import TILE_ROWS

DEVICE_JOIN = flags.define_int(
    "PX_DEVICE_JOIN", -1,
    "-1 = auto (measured H2D probe on a CUDA device; off on the CPU), "
    "0 = force host match, 1 = force device kernels")

MIN_H2D_MBPS = flags.define_int(
    "PX_DEVICE_JOIN_MIN_H2D_MBPS", 1000,
    "auto-gate threshold: enable the device join when the measured "
    "host->device bandwidth reaches this (MB/s)")

_J = "join"
#: direct addressing takes codes in [0, K) with K up to this many slots per
#: input row (or 2^20, whichever is larger); wider code spaces are densified
_DIRECT_SLOTS_PER_ROW = 4
_INT32_MAX = (1 << 31) - 1
_P, _L = ctypes.c_void_p, ctypes.c_longlong


# --------------------------------------------------------------- plain versions


def join_build_plain(codes: torch.Tensor, K: int):
    valid = (codes >= 0) & (codes < K)
    vc = codes[valid]
    cnt = torch.bincount(vc, minlength=K).to(torch.int32)
    first = (torch.cumsum(cnt, 0, dtype=torch.int64) - cnt).to(torch.int32)
    rows = torch.nonzero(valid).squeeze(1)[torch.argsort(vc, stable=True)]
    return cnt, first, rows.to(torch.int32)


def join_probe_plain(codes: torch.Tensor, cnt: torch.Tensor, first: torch.Tensor):
    K = cnt.shape[0]
    valid = (codes >= 0) & (codes < K)
    c = codes.clamp(0, K - 1)
    zero = torch.zeros((), dtype=torch.int32, device=codes.device)
    cnt_p = torch.where(valid, cnt[c], zero)
    return cnt_p, torch.where(valid, first[c], zero), torch.sum(cnt_p, dtype=torch.int64)


def join_expand_plain(cnt_p, lo_p, rows, nb: int, total: int):
    npr = cnt_p.shape[0]
    counts = cnt_p.to(torch.int64)
    offs = torch.cumsum(counts, 0) - counts
    pidx = torch.repeat_interleave(torch.arange(npr, device=cnt_p.device), counts,
                                   output_size=total)
    within = torch.arange(total, device=cnt_p.device) - offs[pidx]
    bidx = rows[lo_p[pidx].to(torch.int64) + within].to(torch.int64)
    bm = torch.zeros(nb, dtype=torch.bool, device=cnt_p.device)
    bm[bidx] = True
    return bidx, pidx, bm, cnt_p > 0


# -------------------------------------------------------------------- kernels


def _check_codes(codes: torch.Tensor) -> None:
    if codes.dtype != torch.int64 or codes.dim() != 1 or not codes.is_contiguous():
        raise TypeError("codes must be a contiguous 1-D int64 tensor")
    if codes.shape[0] > _INT32_MAX:
        raise ValueError(f"{codes.shape[0]} rows exceed the kernels' int32 row ids")


def _scratch(n: int, dev) -> torch.Tensor:
    return torch.empty(max(1, -(-n // TILE_ROWS)), dtype=torch.int64, device=dev)


def join_build(codes: torch.Tensor, K: int):
    """J1 → (cnt[K] int32, first[K] int32, rows_by_code int32): the build
    rows with a code in [0, K), grouped by code, group c at first[c].  On the
    card rows_by_code has room for every build row and only its first
    sum(cnt) entries are written; the plain version returns just those."""
    if not codes.is_cuda:
        return join_build_plain(codes, K)
    _check_codes(codes)
    if not 0 < K <= _INT32_MAX:
        raise ValueError(f"code space of {K} slots is outside the kernel's (0, 2^31)")
    dev, nb = codes.device, codes.shape[0]
    cnt = torch.empty(K, dtype=torch.int32, device=dev)
    first = torch.empty(K, dtype=torch.int32, device=dev)
    fill = torch.empty(K, dtype=torch.int32, device=dev)
    rows = torch.empty(nb, dtype=torch.int32, device=dev)
    fn = _build.function(_J, "px_join_build", [_P, _L, _L, _P, _P, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        err = fn(_build.ptr(codes), nb, K, _build.ptr(cnt), _build.ptr(first),
                 _build.ptr(fill), _build.ptr(rows), _build.ptr(_scratch(K, dev)),
                 _build.stream_of(codes))
    _build.check(_J, err, "join_build")
    _build.KERNELS[_J].count("px_join_build")
    return cnt, first, rows


def join_probe(codes: torch.Tensor, cnt: torch.Tensor, first: torch.Tensor):
    """J2 → (count int32, lo int32 per probe row, total pairs as a 0-dim
    int64 tensor)."""
    if not codes.is_cuda:
        return join_probe_plain(codes, cnt, first)
    _check_codes(codes)
    dev, npr = codes.device, codes.shape[0]
    for t in (cnt, first):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError("cnt and first must be contiguous int32 tensors on the "
                            "codes' device")
    cnt_p = torch.empty(npr, dtype=torch.int32, device=dev)
    lo_p = torch.empty(npr, dtype=torch.int32, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    fn = _build.function(_J, "px_join_probe", [_P, _L, _L, _P, _P, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        err = fn(_build.ptr(codes), npr, cnt.shape[0], _build.ptr(cnt), _build.ptr(first),
                 _build.ptr(cnt_p), _build.ptr(lo_p), _build.ptr(total),
                 _build.stream_of(codes))
    _build.check(_J, err, "join_probe")
    _build.KERNELS[_J].count("px_join_probe")
    return cnt_p, lo_p, total.reshape(())


def join_expand(cnt_p: torch.Tensor, lo_p: torch.Tensor, rows: torch.Tensor, nb: int,
                total: int):
    """J3 → (build_idx int64[total], probe_idx int64[total],
    build_matched bool[nb], probe_matched bool[npr])."""
    if not cnt_p.is_cuda:
        return join_expand_plain(cnt_p, lo_p, rows, nb, total)
    dev, npr = cnt_p.device, cnt_p.shape[0]
    for t in (cnt_p, lo_p, rows):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise TypeError("count, lo and rows must be contiguous 1-D int32 tensors on "
                            "one device")
    if lo_p.shape != (npr,):
        raise TypeError(f"lo must have shape ({npr},)")
    bidx = torch.empty(total, dtype=torch.int64, device=dev)
    pidx = torch.empty(total, dtype=torch.int64, device=dev)
    bm = torch.empty(nb, dtype=torch.bool, device=dev)
    pm = torch.empty(npr, dtype=torch.bool, device=dev)
    offs = torch.empty(npr, dtype=torch.int64, device=dev)
    fn = _build.function(_J, "px_join_expand",
                         [_P, _P, _L, _P, _L, _P, _P, _P, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        err = fn(_build.ptr(cnt_p), _build.ptr(lo_p), npr, _build.ptr(rows), nb,
                 _build.ptr(offs), _build.ptr(_scratch(npr, dev)), _build.ptr(bidx),
                 _build.ptr(pidx), _build.ptr(bm), _build.ptr(pm), _build.stream_of(cnt_p))
    _build.check(_J, err, "join_expand")
    _build.KERNELS[_J].count("px_join_expand")
    return bidx, pidx, bm, pm


# ---------------------------------------------------------------- entry point


def _dense(b: torch.Tensor, p: torch.Tensor):
    """(b', p', K): codes J1-J3 can address directly, matching exactly where
    b and p match.  Directly when the only negative codes are -1 on the build
    side and -2 on the probe side (the executor's null sentinels, which then
    match nothing, as in the reference) and the build codes fit a table of
    K slots; else densified over both sides with one torch.unique."""
    from pixie_tpu_torch.engine.transfer import pull

    nb, npr = b.shape[0], p.shape[0]
    stats = torch.stack([b.min(), b.max(), p.min(), (p == -1).any().to(torch.int64)])
    bmin, bmax, pmin, p_has_m1 = (int(x) for x in pull(stats))
    cap = max(_DIRECT_SLOTS_PER_ROW * (nb + npr), 1 << 20)
    if bmin >= -1 and pmin >= -2 and not p_has_m1 and bmax < cap:
        return b, p, max(bmax + 1, 1)
    u, inv = torch.unique(torch.cat([b, p]), return_inverse=True)
    return inv[:nb].contiguous(), inv[nb:].contiguous(), int(u.shape[0])


def device_join_codes(build_codes, probe_codes, device=None, timings: dict | None = None):
    """Join over int64 key codes → (build_idx, probe_idx, build_matched[nb],
    probe_matched[np]) as numpy, the contract of the host `_match_pairs`.
    Pair order is unspecified.

    Inputs are numpy arrays or tensors.  Numpy inputs go to `device` (CUDA
    unless given); tensors stay where they are.  With a `timings` dict the
    phases are synchronized and their wall seconds recorded (h2d, densify,
    j1_build, j2_probe, j3_expand, d2h)."""
    from pixie_tpu_torch.engine.executor import resolve_device
    from pixie_tpu_torch.engine.transfer import pull, to_device

    nb, npr = int(build_codes.shape[0]), int(probe_codes.shape[0])
    if nb == 0 or npr == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), np.zeros(nb, bool), np.zeros(npr, bool)
    if isinstance(build_codes, torch.Tensor):
        dev = build_codes.device
    else:
        dev = resolve_device(device)
    clock = _Clock(dev, timings)

    def put(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev, torch.int64).contiguous()
        return to_device(np.ascontiguousarray(x, dtype=np.int64), dev)

    b, p = put(build_codes), put(probe_codes)
    clock.lap("h2d")
    b, p, K = _dense(b, p)
    clock.lap("densify")
    cnt, first, rows = join_build(b, K)
    clock.lap("j1_build")
    cnt_p, lo_p, total = join_probe(p, cnt, first)
    total = int(total)
    clock.lap("j2_probe")
    out = join_expand(cnt_p, lo_p, rows, nb, total)
    clock.lap("j3_expand")
    bidx, pidx, bm, pm = pull(list(out))
    clock.lap("d2h")
    return bidx, pidx, bm, pm


class _Clock:
    """Wall seconds per phase, synchronized, when asked for."""

    def __init__(self, dev, timings):
        self.dev, self.timings = dev, timings
        self.t = time.perf_counter() if timings is not None else 0.0

    def lap(self, name: str) -> None:
        if self.timings is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.timings[name] = now - self.t
        self.t = now


def join_path(device) -> str:
    """Which kernels `device_join_codes` takes on `device`: "cuda_counting"
    (J1-J3) on a CUDA device, "plain_cpu" (their plain versions) else."""
    return "cuda_counting" if torch.device(device).type == "cuda" else "plain_cpu"


# ---------------------------------------------------------------- auto-gate

_gate_lock = threading.Lock()
#: device → (decision, transfer.probe_epoch() it was derived from)
_gate_cache: dict = {}


def device_join_gate(device, refresh: bool = False) -> dict:
    """The device-join decision for `device`, measured once per process.

    → {"enabled", "reason", "path", "h2d_mbps" (CUDA only), "flag"}.
    PX_DEVICE_JOIN forces it (0/1); -1 = auto: on a CUDA device on iff the
    measured H2D bandwidth (transfer.h2d_bandwidth_probe) reaches
    PX_DEVICE_JOIN_MIN_H2D_MBPS ("h2d_direct_attached", else
    "h2d_tunneled"; a failing probe raises); on the CPU off
    ("no_native_kernel": the reference's CPU decision needs its native join,
    which the port does not load).  The auto decision is cached until the
    probe it rests on expires."""
    from pixie_tpu_torch.engine import transfer as _transfer

    dev = torch.device(device)
    key = str(dev)
    with _gate_lock:
        flag = flags.get("PX_DEVICE_JOIN")
        hit = _gate_cache.get(key)
        if hit is not None and not refresh and hit[0].get("flag") == flag \
                and hit[1] == _transfer.probe_epoch():
            return hit[0]
        out = {"flag": flag, "path": join_path(dev)}
        if flag == 0:
            out.update(enabled=False, reason="forced_off")
        elif flag == 1:
            out.update(enabled=True, reason="forced_on")
        elif out["path"] != "cuda_counting":
            out.update(enabled=False, reason="no_native_kernel")
        else:
            mbps = _transfer.h2d_bandwidth_probe(device=dev)["mbps"]
            out["h2d_mbps"] = mbps
            thresh = flags.get("PX_DEVICE_JOIN_MIN_H2D_MBPS")
            out.update(enabled=mbps >= thresh,
                       reason=("h2d_direct_attached" if mbps >= thresh
                               else "h2d_tunneled"))
        if flag == -1:
            _gate_cache[key] = (out, _transfer.probe_epoch())
        return out


def reset_gate_for_testing() -> None:
    with _gate_lock:
        _gate_cache.clear()
