"""Device equijoin: the match phase over int64 key codes, kernels J1-J3.

Reference: pixie_tpu/ops/join_device.py, which packs `code << idx_bits | row`,
sorts it and matches pow2 radix buckets (static shapes for XLA, cache-sized
working sets for the TPU).  On Hopper the executor's codes are dense
(`_composite_codes` gives unique-inverse codes in [0, K), K <= nl + nr), so a
code addresses its own slot and the join is a counting join
(csrc/join.cu):

  * J1 `join_build`: the build rows sorted by code, stably → rows_by_code,
    and from the sorted codes each code's count cnt[K] and start first[K]
    (on the card one [K, 2] table of (count, first) slots);
  * J2 `join_probe`: per probe row, its match count cnt[code] and start
    first[code] (codes outside [0, K), such as the executor's null sentinels
    -1 and -2, match nothing), and the total number of pairs; asked for its
    tiles, also each 4,096-row tile's offset among the pairs and
    probe_matched;
  * J3 `join_expand`: the pairs, load-balanced over the card (each block a
    run of consecutive pairs, its probe rows found from the scanned counts
    of their 4,096-row tile), with both sides' matched flags.  Given J2's
    tiles it starts at the pairs; without them it counts the tiles itself.

Codes that are negative on both sides, or too wide to address directly, are
first made dense with one `torch.unique(..., return_inverse=True)` over both
sides, so wide and sparse codes go through the same kernels.

Each of join_build / join_probe / join_expand launches its kernel on a CUDA
tensor and runs the plain PyTorch version beside it on a CPU tensor; a CUDA
tensor never reaches a plain version.  `device_join_codes` is the entry
point, with the reference's contract: (build_idx, probe_idx, build_matched,
probe_matched), pair order unspecified.  On the card and in the plain
versions the pairs come grouped by probe row in probe-row order, and within
a probe row in ascending build row.

The gate (`device_join_gate`) is the reference's: PX_DEVICE_JOIN forces it
(0 off, 1 on: the device kernels, their plain versions on a CPU device); -1
decides from the measured host→device bandwidth on a CUDA device, and on a
CPU device takes the native host join (`native_join_codes`, the port's copy
of the reference's native/join.cc radix hash join) where the native library
loads, as the reference's CPU dispatch does.
"""
from __future__ import annotations

import ctypes
import functools
import threading
import time

import numpy as np
import torch

from pixie_tpu_torch import flags
from pixie_tpu_torch.ops import _build
from pixie_tpu_torch.ops.compact import TILE_ROWS

DEVICE_JOIN = flags.define_int(
    "PX_DEVICE_JOIN", -1,
    "-1 = auto (measured H2D probe on a CUDA device; the native host join "
    "on a CPU device), 0 = force host match, 1 = force device kernels")

MIN_H2D_MBPS = flags.define_int(
    "PX_DEVICE_JOIN_MIN_H2D_MBPS", 1000,
    "auto-gate threshold: enable the device join when the measured "
    "host->device bandwidth reaches this (MB/s)")

_J = "join"
#: direct addressing takes codes in [0, K) with K up to this many slots per
#: input row (or 2^20, whichever is larger); wider code spaces are densified
_DIRECT_SLOTS_PER_ROW = 4
_INT32_MAX = (1 << 31) - 1
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# --------------------------------------------------------------- plain versions


def join_build_plain(codes: torch.Tensor, K: int):
    valid = (codes >= 0) & (codes < K)
    vc = codes[valid]
    cnt = torch.bincount(vc, minlength=K).to(torch.int32)
    first = (torch.cumsum(cnt, 0, dtype=torch.int64) - cnt).to(torch.int32)
    rows = torch.nonzero(valid).squeeze(1)[torch.argsort(vc, stable=True)]
    return cnt, first, rows.to(torch.int32)


def probe_tiles_plain(cnt_p: torch.Tensor):
    """(tile offsets int64[ceil(npr / TILE_ROWS)], probe_matched bool[npr]):
    each TILE_ROWS-row tile's exclusive sum of the counts before it, and
    count > 0 a row."""
    npr = cnt_p.shape[0]
    nt = -(-npr // TILE_ROWS)
    pad = torch.zeros(nt * TILE_ROWS - npr, dtype=torch.int64, device=cnt_p.device)
    sums = torch.cat([cnt_p.to(torch.int64), pad]).view(nt, TILE_ROWS).sum(1)
    return torch.cumsum(sums, 0) - sums, cnt_p > 0


def join_probe_plain(codes: torch.Tensor, cnt: torch.Tensor, first: torch.Tensor,
                     tiles: bool = False):
    K = cnt.shape[0]
    valid = (codes >= 0) & (codes < K)
    c = codes.clamp(0, K - 1)
    zero = torch.zeros((), dtype=torch.int32, device=codes.device)
    cnt_p = torch.where(valid, cnt[c], zero)
    out = (cnt_p, torch.where(valid, first[c], zero), torch.sum(cnt_p, dtype=torch.int64))
    return (*out, probe_tiles_plain(cnt_p)) if tiles else out


def join_expand_plain(cnt_p, lo_p, rows, nb: int, total: int, tiles=None):
    npr = cnt_p.shape[0]
    counts = cnt_p.to(torch.int64)
    offs = torch.cumsum(counts, 0) - counts
    pidx = torch.repeat_interleave(torch.arange(npr, device=cnt_p.device), counts,
                                   output_size=total)
    within = torch.arange(total, device=cnt_p.device) - offs[pidx]
    bidx = rows[lo_p[pidx].to(torch.int64) + within].to(torch.int64)
    bm = torch.zeros(nb, dtype=torch.bool, device=cnt_p.device)
    bm[bidx] = True
    return bidx, pidx, bm, (cnt_p > 0) if tiles is None else tiles[1]


# -------------------------------------------------------------------- kernels


def _check_codes(codes: torch.Tensor) -> None:
    if codes.dtype != torch.int64 or codes.dim() != 1 or not codes.is_contiguous():
        raise TypeError("codes must be a contiguous 1-D int64 tensor")
    if codes.shape[0] > _INT32_MAX:
        raise ValueError(f"{codes.shape[0]} rows exceed the kernels' int32 row ids")


def _scratch(n: int, dev) -> torch.Tensor:
    return torch.empty(max(1, -(-n // TILE_ROWS)), dtype=torch.int64, device=dev)


@functools.lru_cache(maxsize=256)
def _build_plan(nb: int, K: int) -> tuple:
    """px_join_build_scratch's (int32 elements, int64 elements, sort passes,
    sort tiles) for nb build rows and K codes."""
    out = (ctypes.c_longlong * 4)()
    fn = _build.function(_J, "px_join_build_scratch",
                         [_L, _L, ctypes.POINTER(ctypes.c_longlong)])
    _build.check(_J, fn(nb, K, out), "join_build scratch")
    return tuple(out)


def join_build(codes: torch.Tensor, K: int):
    """J1 → (cnt[K] int32, first[K] int32, rows_by_code int32): the build
    rows with a code in [0, K), grouped by code in ascending row order,
    group c at first[c].  On the card cnt and first are the two columns of
    one [K, 2] slot table (J2 gathers a code's pair in one load), and
    rows_by_code has room for every build row and only its first sum(cnt)
    entries are written; the plain version returns just those."""
    if not codes.is_cuda:
        return join_build_plain(codes, K)
    _check_codes(codes)
    if not 0 < K <= _INT32_MAX:
        raise ValueError(f"code space of {K} slots is outside the kernel's (0, 2^31)")
    dev, nb = codes.device, codes.shape[0]
    n32, n64 = _build_plan(nb, K)[:2]
    slots = torch.empty((K, 2), dtype=torch.int32, device=dev)
    rows = torch.empty(nb, dtype=torch.int32, device=dev)
    # held until the launches are enqueued: a block freed before them could
    # go to another thread's allocation on this stream, whose kernels J1
    # would race
    s32 = torch.empty(n32, dtype=torch.int32, device=dev)
    s64 = torch.empty(n64, dtype=torch.int64, device=dev)
    fn = _build.function(_J, "px_join_build", [_P, _L, _L, _P, _P, _P, _P, _P])
    d = dev.index
    err = _build.call(d, fn, codes.data_ptr(), nb, K, slots.data_ptr(), rows.data_ptr(),
                      s32.data_ptr(), s64.data_ptr(), _build.raw_stream(d))
    _build.check(_J, err, "join_build")
    _build.KERNELS[_J].count("px_join_build")
    return slots[:, 0], slots[:, 1], rows


def _slot_table(cnt: torch.Tensor, first: torch.Tensor, dev) -> int:
    """The address of the [K, 2] slot table whose columns are cnt and first
    (J1's layout on the card); raises on any other layout."""
    K = cnt.shape[0]
    if (cnt.device != dev or first.device != dev or cnt.dtype != torch.int32
            or first.dtype != torch.int32 or cnt.shape != (K,) or first.shape != (K,)
            or cnt.stride() != (2,) or first.stride() != (2,)
            or first.data_ptr() != cnt.data_ptr() + 4):
        raise TypeError("cnt and first must be the two columns of one [K, 2] int32 slot "
                        "table on the codes' device, as join_build gives them")
    return cnt.data_ptr()


def join_probe(codes: torch.Tensor, cnt: torch.Tensor, first: torch.Tensor,
               tiles: bool = False):
    """J2 → (count int32, lo int32 per probe row, total pairs as a 0-dim
    int64 tensor); with `tiles`, also (tile offsets int64, probe_matched
    bool[npr]) as a fourth element (probe_tiles_plain), which join_expand
    takes in place of its own counts pass."""
    if not codes.is_cuda:
        return join_probe_plain(codes, cnt, first, tiles)
    _check_codes(codes)
    dev, npr = codes.device, codes.shape[0]
    slots = _slot_table(cnt, first, dev)
    if codes.data_ptr() % 16:  # J2 reads the codes in 16-byte vectors
        codes = codes.clone()
    nt = -(-npr // TILE_ROWS)
    cnt_p = torch.empty(npr, dtype=torch.int32, device=dev)
    lo_p = torch.empty(npr, dtype=torch.int32, device=dev)
    # the tiles' offsets, then the total
    offs = torch.empty(nt + 1, dtype=torch.int64, device=dev)
    pm = torch.empty(npr, dtype=torch.bool, device=dev) if tiles else None
    total = offs[nt]
    fn = _build.function(_J, "px_join_probe", [_P, _L, _L, _P, _P, _P, _P, _P, _P, _P])
    d = dev.index
    err = _build.call(d, fn, codes.data_ptr(), npr, cnt.shape[0], slots, cnt_p.data_ptr(),
                      lo_p.data_ptr(), offs.data_ptr(), pm.data_ptr() if tiles else None,
                      total.data_ptr(), _build.raw_stream(d))
    _build.check(_J, err, "join_probe")
    _build.KERNELS[_J].count("px_join_probe")
    out = (cnt_p, lo_p, total)
    return (*out, (offs[:nt], pm)) if tiles else out


def join_expand(cnt_p: torch.Tensor, lo_p: torch.Tensor, rows: torch.Tensor, nb: int,
                total: int, tiles=None):
    """J3 → (build_idx int64[total], probe_idx int64[total],
    build_matched bool[nb], probe_matched bool[npr]).  With `tiles`, J2's
    (tile offsets, probe_matched) for these counts, J3 skips its counts
    pass and returns that probe_matched."""
    if not cnt_p.is_cuda:
        return join_expand_plain(cnt_p, lo_p, rows, nb, total, tiles)
    dev, npr, total = cnt_p.device, cnt_p.shape[0], int(total)
    for t in (cnt_p, lo_p, rows):
        if t.device != dev or t.dtype != torch.int32 or t.dim() != 1 \
                or not t.is_contiguous():
            raise TypeError("count, lo and rows must be contiguous 1-D int32 tensors on "
                            "one device")
    if lo_p.shape != (npr,):
        raise TypeError(f"lo must have shape ({npr},)")
    if cnt_p.data_ptr() % 16:  # J3 reads the counts in 16-byte vectors
        cnt_p = cnt_p.clone()
    nt = -(-npr // TILE_ROWS)
    if tiles is None:
        # held until the launches are enqueued (see join_build): the tiles' sums
        partial = _scratch(npr, dev)
        pm = torch.empty(npr, dtype=torch.bool, device=dev)
    else:
        partial, pm = tiles
        if (partial.device != dev or partial.dtype != torch.int64 or partial.shape != (nt,)
                or pm.device != dev or pm.dtype != torch.bool or pm.shape != (npr,)):
            raise TypeError(f"tiles must be ({nt} int64 tile offsets, {npr} bools) on the "
                            "counts' device")
    bidx = torch.empty(total, dtype=torch.int64, device=dev)
    pidx = torch.empty(total, dtype=torch.int64, device=dev)
    bm = torch.empty(nb, dtype=torch.bool, device=dev)
    # build_matched as bits, held until the launches are enqueued
    bits = torch.empty(max(1, -(-nb // 32)), dtype=torch.int32, device=dev)
    fn = _build.function(_J, "px_join_expand",
                         [_P, _P, _L, _P, _L, _L, _P, _I, _P, _P, _P, _P, _P, _P])
    d = dev.index
    err = _build.call(d, fn, cnt_p.data_ptr(), lo_p.data_ptr(), npr, rows.data_ptr(), nb, total,
                      partial.data_ptr(), int(tiles is not None), bits.data_ptr(),
                      bidx.data_ptr(), pidx.data_ptr(), bm.data_ptr(), pm.data_ptr(),
                      _build.raw_stream(d))
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
    cnt_p, lo_p, total, tiles = join_probe(p, cnt, first, tiles=True)
    total = int(total)
    clock.lap("j2_probe")
    out = join_expand(cnt_p, lo_p, rows, nb, total, tiles)
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


def join_path(device, forced: bool = False) -> str:
    """Which join the executor's enabled gate runs on `device`:
    "cuda_counting" (J1-J3) on a CUDA device; on a CPU device "native_cpu"
    (`native_join_codes`) where the native library loads and the device
    kernels are not `forced`, else "plain_cpu" (J1-J3's plain versions)."""
    if torch.device(device).type == "cuda":
        return "cuda_counting"
    if not forced and native_join_available():
        return "native_cpu"
    return "plain_cpu"


# ------------------------------------------------------ native host join


def native_join_available() -> bool:
    from pixie_tpu_torch.native.build import load_native

    return load_native() is not None


def native_join(bh: np.ndarray, ph: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The native radix hash join (native/join.cc) over int64 codes → the
    (build_idx, probe_idx) pairs, bucket-major: pair order unspecified."""
    from pixie_tpu_torch.native.build import load_native

    lib = load_native()
    bh = np.ascontiguousarray(bh, dtype=np.int64)
    ph = np.ascontiguousarray(ph, dtype=np.int64)
    total = ctypes.c_int64(0)
    h = lib.px_join_run(
        bh.ctypes.data_as(ctypes.c_void_p), len(bh),
        ph.ctypes.data_as(ctypes.c_void_p), len(ph), ctypes.byref(total))
    try:
        n = total.value
        bidx = np.empty(n, np.int64)
        pidx = np.empty(n, np.int64)
        if n:
            lib.px_join_fetch(h, bidx.ctypes.data_as(ctypes.c_void_p),
                              pidx.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.px_join_free(h)
    return bidx, pidx


def native_join_codes(build_codes, probe_codes):
    """`device_join_codes`'s contract on the host through the native join:
    (build_idx, probe_idx, build_matched[nb], probe_matched[np]) as numpy,
    pair order unspecified (the executor's null sentinels -1 and -2 never
    match)."""
    nb, npr = int(build_codes.shape[0]), int(probe_codes.shape[0])
    if nb == 0 or npr == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), np.zeros(nb, bool), np.zeros(npr, bool)
    bidx, pidx = native_join(np.asarray(build_codes), np.asarray(probe_codes))
    bm = np.zeros(nb, bool)
    pm = np.zeros(npr, bool)
    bm[bidx] = True
    pm[pidx] = True
    return bidx, pidx, bm, pm


# ---------------------------------------------------------------- auto-gate

_gate_lock = threading.Lock()
#: device → (decision, transfer.probe_epoch() it was derived from)
_gate_cache: dict = {}


def device_join_gate(device, refresh: bool = False) -> dict:
    """The device-join decision for `device`, measured once per process.

    → {"enabled", "reason", "path", "h2d_mbps" (CUDA only), "flag"}.
    PX_DEVICE_JOIN forces it (0/1; forced on, a CPU device runs J1-J3's
    plain versions); -1 = auto: on a CUDA device on iff the measured H2D
    bandwidth (transfer.h2d_bandwidth_probe) reaches
    PX_DEVICE_JOIN_MIN_H2D_MBPS ("h2d_direct_attached", else
    "h2d_tunneled"; a failing probe raises); on a CPU device on iff the
    native join loads ("native_cpu", else "no_native_kernel"), as the
    reference's CPU decision.  The auto decision is cached until the probe
    it rests on expires."""
    from pixie_tpu_torch.engine import transfer as _transfer

    dev = torch.device(device)
    key = str(dev)
    with _gate_lock:
        flag = flags.get("PX_DEVICE_JOIN")
        hit = _gate_cache.get(key)
        if hit is not None and not refresh and hit[0].get("flag") == flag \
                and hit[1] == _transfer.probe_epoch():
            return hit[0]
        out = {"flag": flag, "path": join_path(dev, forced=flag == 1)}
        if flag == 0:
            out.update(enabled=False, reason="forced_off")
        elif flag == 1:
            out.update(enabled=True, reason="forced_on")
        elif out["path"] != "cuda_counting":
            ok = out["path"] == "native_cpu"
            out.update(enabled=ok, reason="native_cpu" if ok else "no_native_kernel")
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
