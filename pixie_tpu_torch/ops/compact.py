"""K4: stable front-compaction of a feed's output columns by a row mask.

The select path's output step (reference: pixie_tpu/engine/executor.py
`ChainKernel.make_output_step`) moves the rows a chain keeps to the front of
every output column, in input order, and counts them; the host then reads
back exactly `count` rows of each column.

On a CUDA tensor `compact` launches kernel K4 (csrc/compact.cu): one C call
compacts every column (the tiles' counts, their scan, then one launch a 16
columns).  On a CPU tensor it runs the plain PyTorch version beside it,
which repeats the reference's arithmetic: a stable argsort of the negated
mask and one gather per column.  The choice follows the mask's device
only; a CUDA tensor never reaches the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from pixie_tpu_torch.ops import _build

_K4 = "compact"
#: rows per tile of the kernels' scans (csrc/compact.cu and csrc/scan.cuh
#: kTile); K4 keeps one int64 of scratch a tile (its offset)
TILE_ROWS = 4096
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def compact_plain(mask: torch.Tensor, cols: list[torch.Tensor]):
    """(columns permuted so the kept rows lead in input order, count)."""
    order = torch.argsort(torch.logical_not(mask), stable=True)
    return ([c.index_select(0, order) for c in cols],
            torch.sum(mask, dtype=torch.int64))


def _check(mask: torch.Tensor, cols: list[torch.Tensor]) -> None:
    if mask.dtype != torch.bool or mask.dim() != 1 or not mask.is_contiguous():
        raise TypeError("mask must be a contiguous 1-D bool tensor")
    n = mask.shape[0]
    for c in cols:
        if c.shape != (n,) or not c.is_contiguous():
            raise TypeError(f"columns must be contiguous tensors of shape ({n},)")
        if c.device != mask.device:
            raise ValueError(f"tensors on {mask.device} and {c.device}")
        if c.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"no compaction for element size {c.element_size()}")


def _launch_k4(mask: torch.Tensor, cols: list[torch.Tensor]):
    _check(mask, cols)
    n = mask.shape[0]
    outs = [torch.empty_like(c) for c in cols]
    scratch = torch.empty(-(-n // TILE_ROWS), dtype=torch.int64, device=mask.device)
    count = torch.empty(1, dtype=torch.int64, device=mask.device)
    k = len(cols)
    src = (_P * max(k, 1))(*[c.data_ptr() for c in cols])
    dst = (_P * max(k, 1))(*[o.data_ptr() for o in outs])
    width = (_I * max(k, 1))(*[c.element_size() for c in cols])
    fn = _build.function(_K4, "px_compact", [_P, _L, _I, _P, _P, _P, _P, _P, _P])
    dev = mask.device.index
    err = _build.call(dev, fn, mask.data_ptr(), n, k, src, dst, width, scratch.data_ptr(),
                      count.data_ptr(), _build.raw_stream(dev))
    _build.check(_K4, err, "compact")
    _build.KERNELS[_K4].count("px_compact")
    return outs, count.reshape(())


def compact(mask: torch.Tensor, cols: list[torch.Tensor]):
    """→ (outs, count): outs[i] holds cols[i]'s kept rows (mask True) at its
    front, in input order; count is a 0-dim int64 tensor on the mask's
    device.  Rows of outs past count are unspecified."""
    if mask.is_cuda:
        return _launch_k4(mask, cols)
    return compact_plain(mask, cols)
