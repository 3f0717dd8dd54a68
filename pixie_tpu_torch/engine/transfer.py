"""Batched and pipelined device→host readback, and the host→device link probe.

Reference: pixie_tpu/engine/transfer.py.  A query's device outputs come back
in transfer waves:

  * `pull(tree)` — the one-shot wave: start every leaf's copy, then block;
  * `pull_async(tree)` → `AsyncPull.wait()` — the pipelined wave: the copies
    start now and the block comes later, so device work enqueued in between
    (the next feed's step) runs while the copies are in flight.  The select
    path's feed loop reads its waves one and two feeds behind.

On CUDA a wave's copies run on a side stream that first waits for the work
already enqueued on the current stream; each leaf lands in a pinned host
buffer (`non_blocking=True`) and a CUDA event recorded after the last copy
completes the wave.  CPU tensors and numpy leaves pass through.

`h2d_bandwidth_probe` times a pinned-to-device copy; the device-join gate
(ops/join_device.py) decides on it.  Probes are memoized per process and
expire after PX_PROBE_MAX_AGE_S.  The reference's wave gauges and trace spans
come with the observability slice; here each wave is counted in `stats`.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from pixie_tpu_torch import flags as _flags

_flags.define_float(
    "PX_PROBE_MAX_AGE_S", 900.0,
    "staleness horizon for the memoized environment probes (H2D bandwidth): "
    "a probe older than this re-measures on next read; 0 = never expire")

#: wave counters: waves, device leaves, bytes copied, and for pipelined waves
#: the overlap split (overlap_ns: wall time between copy start and wait, i.e.
#: work covered by the in-flight copy; block_ns: time the host stalled)
stats = {"waves": 0, "leaves": 0, "bytes": 0, "overlap_ns": 0, "block_ns": 0}
_STATS_LOCK = threading.Lock()

_PROBE_LOCK = threading.Lock()
_PROBE_CACHE: dict = {}
#: bumped on every invalidation or expiry: decisions derived from a probe
#: (the device-join gate) key on it, so a re-probe re-opens them
_PROBE_EPOCH = 0


def _now() -> float:
    return time.monotonic()


def probe_epoch() -> int:
    with _PROBE_LOCK:
        return _PROBE_EPOCH


def _probe_cached(key, measure, refresh: bool):
    global _PROBE_EPOCH
    max_age = float(_flags.get("PX_PROBE_MAX_AGE_S"))
    with _PROBE_LOCK:
        got = None
        if not refresh:
            hit = _PROBE_CACHE.get(key)
            if hit is not None:
                value, ts = hit
                if max_age > 0 and _now() - ts > max_age:
                    _PROBE_CACHE.pop(key, None)
                    _PROBE_EPOCH += 1
                else:
                    got = value
    if got is not None:
        return got
    got = measure()
    with _PROBE_LOCK:
        _PROBE_CACHE[key] = (got, _now())
    return got


def invalidate_probes() -> None:
    """Drop every memoized probe now (the link changed); the device-join gate
    re-decides on its next read."""
    global _PROBE_EPOCH
    with _PROBE_LOCK:
        _PROBE_CACHE.clear()
        _PROBE_EPOCH += 1
    from pixie_tpu_torch.ops import join_device

    join_device.reset_gate_for_testing()


def reset_probe_cache_for_testing() -> None:
    global _PROBE_EPOCH
    with _PROBE_LOCK:
        _PROBE_CACHE.clear()
        _PROBE_EPOCH += 1


def _count(**kw) -> None:
    with _STATS_LOCK:
        for k, v in kw.items():
            stats[k] += v


# ------------------------------------------------------------------ readback


def _flatten(tree, out: list):
    """Leaves of nested dicts/lists/tuples in order, and a rebuild function."""
    if isinstance(tree, dict):
        parts = {k: _flatten(v, out) for k, v in tree.items()}
        return lambda leaves: {k: f(leaves) for k, f in parts.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, out) for v in tree]
        kind = type(tree)
        return lambda leaves: kind(f(leaves) for f in parts)
    i = len(out)
    out.append(tree)
    return lambda leaves: leaves[i]


class AsyncPull:
    """An in-flight D2H wave: the copies start at construction and complete
    at wait().  Construct through pull_async()."""

    __slots__ = ("_leaves", "_rebuild", "_hosts", "_event", "_n_dev", "_t_submit",
                 "_out", "_done")

    def __init__(self, tree):
        self._leaves: list = []
        self._rebuild = _flatten(tree, self._leaves)
        self._hosts: list = [None] * len(self._leaves)
        self._event = None
        cuda = [i for i, x in enumerate(self._leaves)
                if isinstance(x, torch.Tensor) and x.is_cuda]
        self._n_dev = len(cuda)
        if cuda:
            dev = self._leaves[cuda[0]].device
            side = _side_stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            nbytes = 0
            with torch.cuda.stream(side):
                for i in cuda:
                    src = self._leaves[i]
                    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                    host.copy_(src, non_blocking=True)
                    self._hosts[i] = host
                    nbytes += src.numel() * src.element_size()
                self._event = torch.cuda.Event()
                self._event.record(side)
            _count(waves=1, leaves=len(cuda), bytes=nbytes)
        self._t_submit = time.perf_counter_ns()
        self._out = None
        self._done = False

    @property
    def n_dev(self) -> int:
        return self._n_dev

    def wait(self):
        """Block until the wave lands; → the tree with numpy leaves.
        Idempotent."""
        if self._done:
            return self._out
        t_wait = time.perf_counter_ns()
        if self._event is not None:
            self._event.synchronize()
        leaves = [
            h.numpy() if h is not None else
            (x.numpy() if isinstance(x, torch.Tensor) else x)
            for h, x in zip(self._hosts, self._leaves)
        ]
        if self._n_dev:
            t_done = time.perf_counter_ns()
            _count(overlap_ns=t_wait - self._t_submit, block_ns=t_done - t_wait)
        self._out = self._rebuild(leaves)
        self._leaves, self._hosts = [], []  # release the device tensors
        self._done = True
        return self._out


#: device index → the stream that readback copies run on
_SIDE: dict = {}


def _side_stream(dev: torch.device):
    with _STATS_LOCK:
        s = _SIDE.get(dev.index)
        if s is None:
            s = _SIDE[dev.index] = torch.cuda.Stream(dev)
        return s


def pull_async(tree) -> AsyncPull:
    """Start a D2H wave without blocking; `.wait()` materializes it.  Work
    enqueued between the two overlaps the copies."""
    return AsyncPull(tree)


def pull(tree):
    """Tree of tensors → the same tree of numpy arrays, every leaf's copy
    started before the one wait."""
    return AsyncPull(tree).wait()


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → tensor on `device`.  On CUDA the array is copied into a
    pinned buffer and uploaded with non_blocking=True on the current stream."""
    if device.type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    host = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype, pin_memory=True)
    host.numpy()[...] = arr
    return host.to(device, non_blocking=True)


def h2d_bandwidth_probe(payload_bytes: int = 1 << 20, repeats: int = 2,
                        device=None, refresh: bool = False) -> dict:
    """Host→device upload bandwidth: best-of MB/s of a `payload_bytes`
    pinned-to-device copy, synchronized (best-of, because the probe asks what
    the link can do; one stall must not flip the gate low).  Memoized per
    process and device (refresh=True re-measures)."""
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    if dev.type != "cuda":
        raise ValueError(f"the H2D probe needs a CUDA device, got {dev}")

    def measure() -> dict:
        n = max(payload_bytes // 8, 1)
        host = torch.arange(n, dtype=torch.int64).pin_memory()
        dst = torch.empty(n, dtype=torch.int64, device=dev)
        dst[: 1 << 13].copy_(host[: 1 << 13], non_blocking=True)  # warm the path
        torch.cuda.synchronize(dev)
        secs = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            dst.copy_(host, non_blocking=True)
            torch.cuda.synchronize(dev)
            secs.append(time.perf_counter() - t0)
        best = min(secs)
        return {"bytes": int(n * 8), "secs_best": round(best, 6),
                "mbps": round(n * 8 / max(best, 1e-9) / 1e6, 1), "repeats": repeats}

    return _probe_cached(("h2d", payload_bytes, repeats, str(dev)), measure, refresh)
