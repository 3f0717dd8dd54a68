"""R1, R2: the resident tier's buffer moves (engine/resident.py).

Reference: pixie_tpu/engine/resident.py `_kernels` — `fold`
(dynamic_update_slice of an ingest delta), `grow` (jnp.pad to a larger
bucket) and `shift` (jnp.roll after a retention trim).

  * `fold(bufs, parts, off)` appends the delta rows of every column at row
    `off` of its buffer.  On CUDA the delta of all columns is assembled once
    into ONE pinned host buffer (columns back to back at 16-byte-aligned
    offsets), crosses the link in one non_blocking copy, and kernel R1
    (csrc/resident.cu `px_resident_fold`) moves each column's slice into
    place in one launch.
  * `move(srcs, lo, n, dst_rows)` returns new buffers with dst[0, n) =
    src[lo, lo + n) and zeros after: grow is lo = 0 into a larger bucket,
    rebase is lo = the dropped rows into a buffer of the same bucket.  On
    CUDA it is kernel R2 (`px_resident_move`), one launch for all columns.

On CPU tensors both run their plain PyTorch versions beside them (slice
assignment; torch.cat of the kept rows and zeros).  The choice follows the
buffers' device only; a CUDA tensor never reaches a plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pixie_tpu_torch.ops import _build

_R = "resident"
#: byte alignment of each column's slice of the staging buffer
ALIGN = 16
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def fold_plain(buf: torch.Tensor, delta: torch.Tensor, off: int) -> torch.Tensor:
    """buf[off, off + len(delta)) = delta, in place."""
    buf[off: off + delta.shape[0]] = delta
    return buf


def move_plain(src: torch.Tensor, lo: int, n: int, dst_rows: int) -> torch.Tensor:
    """A new buffer of dst_rows: src[lo, lo + n), then zeros."""
    return torch.cat([src[lo: lo + n], src.new_zeros(dst_rows - n)])


def _check(bufs: list[torch.Tensor]) -> None:
    for b in bufs:
        if b.dim() != 1 or not b.is_contiguous():
            raise TypeError("resident buffers must be contiguous 1-D tensors")
        if b.device != bufs[0].device:
            raise ValueError(f"buffers on {bufs[0].device} and {b.device}")
        if b.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"no resident buffer of element size {b.element_size()}")


def stage(parts: list[list[np.ndarray]], device) -> tuple[torch.Tensor, list[int], int]:
    """One device staging buffer holding every column's delta: → (staging,
    byte offset of each column, delta rows).  parts[c] lists column c's
    host chunks; they are written straight into one pinned buffer, which
    crosses the link in one non_blocking copy."""
    d = sum(len(a) for a in parts[0]) if parts else 0
    offsets, total = [], 0
    for chunks in parts:
        if sum(len(a) for a in chunks) != d:
            raise ValueError("delta columns of different lengths")
        offsets.append(total)
        total += _align(d * chunks[0].dtype.itemsize)
    host = torch.empty(max(total, ALIGN), dtype=torch.uint8, pin_memory=True)
    flat = host.numpy()
    for chunks, o in zip(parts, offsets):
        dt = chunks[0].dtype
        out = flat[o: o + d * dt.itemsize].view(dt)
        if len(chunks) == 1:
            out[:] = chunks[0]
        else:
            np.concatenate(chunks, out=out)
    return host.to(device, non_blocking=True), offsets, d


def fold_staged(bufs: list[torch.Tensor], staging: torch.Tensor, offsets: list[int],
                d: int, off: int) -> None:
    """R1: copy each column's d staged rows to rows [off, off + d) of its
    buffer (CUDA only)."""
    _check(bufs)
    for b in bufs:
        if b.shape[0] < off + d:
            raise ValueError(f"buffer of {b.shape[0]} rows cannot take rows [{off}, {off + d})")
    if not bufs or d == 0:
        return
    k = len(bufs)
    dst = (_P * k)(*[b.data_ptr() for b in bufs])
    width = (_I * k)(*[b.element_size() for b in bufs])
    soff = (_L * k)(*offsets)
    fn = _build.function(_R, "px_resident_fold", [_I, _P, _P, _P, _P, _L, _L, _P])
    with torch.cuda.device(staging.device):
        err = fn(k, dst, width, _build.ptr(staging), soff, d, off,
                 _build.stream_of(staging))
    _build.check(_R, err, "resident fold")
    _build.KERNELS[_R].count("px_resident_fold")


def fold(bufs: list[torch.Tensor], parts: list[list[np.ndarray]], off: int) -> int:
    """Append the host delta `parts` (parts[c]: column c's chunks) at row
    `off` of `bufs`, in place; → the bytes that crossed host→device."""
    _check(bufs)
    for b, chunks in zip(bufs, parts):
        if b.element_size() != chunks[0].dtype.itemsize:
            raise TypeError(f"delta of {chunks[0].dtype} into a {b.dtype} buffer")
    nbytes = sum(sum(a.nbytes for a in chunks) for chunks in parts)
    if nbytes == 0:
        return 0
    if bufs[0].is_cuda:
        staging, offsets, d = stage(parts, bufs[0].device)
        fold_staged(bufs, staging, offsets, d, off)
        return nbytes
    for b, chunks in zip(bufs, parts):
        # (a sealed batch is a read-only view: torch takes a writable copy)
        delta = np.concatenate(chunks) if len(chunks) > 1 else np.array(chunks[0])
        fold_plain(b, torch.from_numpy(delta), off)
    return nbytes


def move(srcs: list[torch.Tensor], lo: int, n: int, dst_rows: int) -> list[torch.Tensor]:
    """New buffers of dst_rows rows: each src's rows [lo, lo + n), then
    zeros (grow: lo = 0; rebase: lo = the dropped rows)."""
    _check(srcs)
    if lo < 0 or n < 0 or n > dst_rows:
        raise ValueError(f"move of rows [{lo}, {lo + n}) into {dst_rows} rows")
    for s in srcs:
        if s.shape[0] < lo + n:
            raise ValueError(f"buffer of {s.shape[0]} rows has no rows [{lo}, {lo + n})")
    if not srcs or not srcs[0].is_cuda:
        return [move_plain(s, lo, n, dst_rows) for s in srcs]
    outs = [torch.empty(dst_rows, dtype=s.dtype, device=s.device) for s in srcs]
    if dst_rows == 0:
        return outs
    k = len(srcs)
    src = (_P * k)(*[s.data_ptr() for s in srcs])
    dst = (_P * k)(*[o.data_ptr() for o in outs])
    width = (_I * k)(*[s.element_size() for s in srcs])
    fn = _build.function(_R, "px_resident_move", [_I, _P, _P, _P, _L, _L, _L, _P])
    with torch.cuda.device(srcs[0].device):
        err = fn(k, src, dst, width, lo, n, dst_rows, _build.stream_of(srcs[0]))
    _build.check(_R, err, "resident move")
    _build.KERNELS[_R].count("px_resident_move")
    return outs
