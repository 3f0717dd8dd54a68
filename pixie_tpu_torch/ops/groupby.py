"""Group-by primitives: dense group codes + masked segment reductions.

Replaces the reference's hash group-by (AbslRowTupleHashMap over RowTuples,
src/carnot/exec/agg_node.h:55-140): every group key column is a dense int32
code (dictionary code for strings/UPIDs; query-time dictionary for raw ints),
multi-key groups are mixed-radix combined into a single segment id, and
aggregation is a masked segment reduction.

On the query path the chain program (ops/chain.py, kernel C1) computes the
group ids itself (its GID_COMBINE and SEARCH opcodes); `combine_codes` and
`encode_against` stay here as the plain torch forms of the same functions.

The reductions accumulate IN PLACE into a caller-owned state tensor `out`
(the aggregate state lives on the device across feeds).  On a CUDA tensor each
`masked_segment_*` launches kernel K1 (csrc/segment_reduce.cu); on a CPU tensor
it runs the plain PyTorch version beside it (index_add_ / scatter_reduce_).
The choice follows the tensor's device only; a CUDA tensor never reaches a
plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pixie_tpu_torch.ops import _build


def next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


def combine_codes(codes: list[torch.Tensor], cards: list[int]) -> tuple[torch.Tensor, int]:
    """Mixed-radix combine k dense code columns into one int32 group id.

    cards[i] is a static upper bound on codes[i] (dictionary-size snapshot,
    bucketed by the caller). Returns (gid, num_groups) with num_groups =
    prod(cards); gid of a row with any out-of-range/negative code is clamped
    into range — callers must mask such rows out beforehand.
    """
    assert len(codes) == len(cards) and codes
    num_groups = 1
    for c in cards:
        num_groups *= int(c)
    gid = torch.zeros(codes[0].shape, dtype=torch.int32, device=codes[0].device)
    for code, card in zip(codes, cards):
        c = torch.clamp(code.to(torch.int32), 0, card - 1)
        gid = gid * card + c
    return gid, num_groups


def split_codes(gids: np.ndarray, cards: list[int]) -> list[np.ndarray]:
    """Host-side inverse of combine_codes: group id → per-key codes."""
    out = []
    rem = np.asarray(gids)
    for card in reversed(cards):
        out.append((rem % card).astype(np.int32))
        rem = rem // card
    return list(reversed(out))


def encode_against(lut: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """value → sorted-LUT position (searchsorted, side='left'), int32."""
    return torch.searchsorted(lut, values.to(lut.dtype), out_int32=True)


# ----------------------------------------------------------------- identities


def _identity_for(dtype: torch.dtype, op: str):
    """Neutral element of min/max for `dtype` (a Python scalar)."""
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    if dtype == torch.bool:
        return op == "min"
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulator of a segment sum: integers and bools wrap in int64."""
    if dtype in (torch.float64, torch.float32):
        return dtype
    if dtype in (torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
                 torch.uint8):
        return torch.int64
    raise TypeError(f"no segment sum for dtype {dtype}")


# ------------------------------------------------------------ K1 (CUDA) path

_K1 = "segment_reduce"
_SUFFIX = {torch.int32: "i32", torch.int64: "i64", torch.float32: "f32",
           torch.float64: "f64"}
_KINDS = {"sum": (torch.int64, torch.float64, torch.float32),
          "min": tuple(_SUFFIX), "max": tuple(_SUFFIX)}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check_rows(gid: torch.Tensor, mask: torch.Tensor, values, out: torch.Tensor,
                num_groups: int) -> None:
    dev = gid.device
    if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous():
        raise TypeError("gid must be a contiguous 1-D int32 tensor")
    n = gid.shape[0]
    if mask.dtype != torch.bool or mask.shape != (n,) or not mask.is_contiguous():
        raise TypeError(f"mask must be a contiguous bool tensor of shape ({n},)")
    if values is not None and (values.shape != (n,) or not values.is_contiguous()):
        raise TypeError(f"values must be a contiguous tensor of shape ({n},)")
    if out.shape != (num_groups,) or not out.is_contiguous():
        raise TypeError(f"out must be a contiguous tensor of shape ({num_groups},)")
    for t in (mask, values, out):
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if num_groups >= 2 ** 31:
        raise ValueError(f"{num_groups} groups exceed the kernel's int32 ids")


def _launch_k1(kind: str, gid, mask, values, out, num_groups: int) -> None:
    """Launch K1 for `kind` ("count" | "sum" | "min" | "max") into `out`."""
    _check_rows(gid, mask, values, out, num_groups)
    dev = gid.device.index
    if kind == "count":
        if out.dtype != torch.int64:
            raise TypeError("count state must be int64")
        sym = "px_segment_count"
        fn = _build.function(_K1, sym, [_P, _P, _L, _P, _I, _P])
        args = (gid.data_ptr(), mask.data_ptr(), gid.shape[0], out.data_ptr(),
                num_groups, _build.raw_stream(dev))
    else:
        if out.dtype not in _KINDS[kind] or values.dtype != out.dtype:
            raise TypeError(
                f"segment {kind}: values {values.dtype} / state {out.dtype} "
                f"not supported")
        sym = f"px_segment_{kind}_{_SUFFIX[out.dtype]}"
        fn = _build.function(_K1, sym, [_P, _P, _P, _L, _P, _I, _P])
        args = (gid.data_ptr(), mask.data_ptr(), values.data_ptr(), gid.shape[0],
                out.data_ptr(), num_groups, _build.raw_stream(dev))
    err = _build.call(dev, fn, *args)
    _build.check(_K1, err, f"segment_reduce {kind}")
    _build.KERNELS[_K1].count(sym)


# --------------------------------------------------------- plain (CPU) path


def _valid_rows(gid, mask, num_groups):
    """(clamped int64 ids, keep-mask): rows with ids outside [0, G) drop out,
    as the kernel (and XLA's scatter) drop them."""
    keep = mask & (gid >= 0) & (gid < num_groups)
    return gid.clamp(0, max(num_groups - 1, 0)).long(), keep


def segment_count_plain(gid, num_groups, mask, out):
    idx, keep = _valid_rows(gid, mask, num_groups)
    return out.index_add_(0, idx, keep.to(out.dtype))


def segment_sum_plain(values, gid, num_groups, mask, out):
    idx, keep = _valid_rows(gid, mask, num_groups)
    v = torch.where(keep, values.to(out.dtype), 0)
    return out.index_add_(0, idx, v)


def segment_pick_plain(values, gid, num_groups, mask, out, op: str):
    idx, keep = _valid_rows(gid, mask, num_groups)
    v = torch.where(keep, values.to(out.dtype), _identity_for(out.dtype, op))
    return out.scatter_reduce_(0, idx, v, reduce="amin" if op == "min" else "amax",
                               include_self=True)


# ------------------------------------------------------------------ the API


def masked_segment_count(gid: torch.Tensor, num_groups: int, mask: torch.Tensor,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Rows per group (int64, exact), added into `out` (zeros if None)."""
    if out is None:
        out = torch.zeros(num_groups, dtype=torch.int64, device=gid.device)
    if gid.is_cuda:
        _launch_k1("count", gid, mask, None, out, num_groups)
        return out
    return segment_count_plain(gid, num_groups, mask, out)


def masked_segment_sum(values: torch.Tensor, gid: torch.Tensor, num_groups: int,
                       mask: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Per-group sum of the masked values added into `out`: int64 (integers
    and bools, wrapping mod 2^64), float64 or float32."""
    if out is None:
        out = torch.zeros(num_groups, dtype=_sum_dtype(values.dtype), device=gid.device)
    if gid.is_cuda:
        _launch_k1("sum", gid, mask, values.to(out.dtype).contiguous(), out, num_groups)
        return out
    return segment_sum_plain(values, gid, num_groups, mask, out)


def _masked_pick(op, values, gid, num_groups, mask, out):
    if out is None:
        out = torch.full((num_groups,), _identity_for(values.dtype, op),
                         dtype=values.dtype, device=gid.device)
    if gid.is_cuda:
        _launch_k1(op, gid, mask, values.to(out.dtype).contiguous(), out, num_groups)
        return out
    return segment_pick_plain(values, gid, num_groups, mask, out, op)


def masked_segment_min(values: torch.Tensor, gid: torch.Tensor, num_groups: int,
                       mask: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Per-group min of the masked values folded into `out` (NaN wins)."""
    return _masked_pick("min", values, gid, num_groups, mask, out)


def masked_segment_max(values: torch.Tensor, gid: torch.Tensor, num_groups: int,
                       mask: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Per-group max of the masked values folded into `out` (NaN wins)."""
    return _masked_pick("max", values, gid, num_groups, mask, out)
