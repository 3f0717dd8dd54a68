"""X1, X2: the keyed repartition of rows over the shards of a mesh.

Reference: pixie_tpu/parallel/repartition.py — `_device_key_fn` (:156) with
`mesh_bucket_counts` (:358), the counts pass of the in-mesh exchange, and
`_local_partition` (:335) with `mesh_repartition` (:395), the stable bucket
scatter of every column and its lax.all_to_all.

  * `partition_count(keys, n_valid, n_dev)` hashes every row of a padded
    batch of n_dev shards by its key VALUES (the hash of partition_ids, bit
    for bit) → (part, counts, tile_counts): part int32 per row (n_dev past a
    shard's valid rows), counts int64 [n_dev shards, n_dev targets], and the
    same counts per tile of TILE rows, [n_dev, tiles, n_dev].  On CUDA it is
    kernel X1 (csrc/repartition.cu `px_partition_count`), one launch for all
    shards.
  * `partition_scatter(part, tile_counts, counts, cols, n_dev, cap)` writes
    every column into the received layout: row-block p * n_dev + i holds
    shard i's rows for partition p in row order, cap rows a block → (outs,
    recv), recv[p * n_dev + i] = min(counts[i, p], cap).  On CUDA it is
    kernel X2 (`px_partition_scatter`); rows past a block's count are
    unspecified there (zeros in the plain version).

`keys` is a list of (column, lut): an int64-valued column with lut None, or
int32 dictionary codes with lut the int64 bits of each code's uint64 value
hash (`value_hash_lut`).  On CPU tensors both run their plain PyTorch
versions beside them (the hash in int64, whose wrapping multiply and add
are the uint64 bits; a stable argsort and a scatter).  The choice follows
the tensors' device only; a CUDA tensor never reaches a plain version.
"""
from __future__ import annotations

import ctypes
import zlib

import numpy as np
import torch

from pixie_tpu_torch.ops import _build

_X = "repartition"
#: rows of one shard that one block of X1 / X2 covers
TILE = 4096
MAX_KEYS = 8
MAX_PARTS = 1024
#: columns X2 takes by value in its launch; more are read from a device table
SCATTER_INLINE_COLS = 32
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_U64 = 1 << 64
#: splitmix64 constants (parallel/repartition.py), as uint64 ...
SM_GAMMA = 0x9E3779B97F4A7C15
SM_M1 = 0xBF58476D1CE4E5B9
SM_M2 = 0x94D049BB133111EB
#: ... hash of a null dictionary code ("null")
NULL_HASH = 0x6E756C6C


def _i64(u: int) -> int:
    """The int64 with the bits of uint64 u."""
    return u - _U64 if u >= 1 << 63 else u


def splitmix64_np(x: np.ndarray) -> np.ndarray:
    """The host hash of parallel/repartition.py, over uint64."""
    with np.errstate(over="ignore"):
        z = (x + np.uint64(SM_GAMMA)).astype(np.uint64)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(SM_M1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(SM_M2)
        return z ^ (z >> np.uint64(31))


def value_hash_lut(values) -> np.ndarray:
    """Per dictionary code, splitmix64(crc32(str(value))), as int64 bits."""
    crc = np.asarray([zlib.crc32(str(v).encode()) for v in values], dtype=np.uint64)
    return splitmix64_np(crc).view(np.int64)


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of the uint64 bits held in an int64 tensor."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def splitmix64_plain(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 over the uint64 bits of an int64 tensor (two's-complement
    adds and multiplies wrap to the same bits)."""
    z = x + _i64(SM_GAMMA)
    z = (z ^ _srl(z, 30)) * _i64(SM_M1)
    z = (z ^ _srl(z, 27)) * _i64(SM_M2)
    return z ^ _srl(z, 31)


def umod_plain(h: torch.Tensor, n: int) -> torch.Tensor:
    """(uint64 bits of h) mod n, for 1 <= n < 2^31."""
    if n & (n - 1) == 0:
        return h & (n - 1)
    hi, lo = _srl(h, 32), h & 0xFFFFFFFF
    return ((hi % n) * ((1 << 32) % n) + lo % n) % n


def _key_hash_plain(col: torch.Tensor, lut) -> torch.Tensor:
    if lut is None:
        return splitmix64_plain(col.to(torch.int64))
    if lut.numel() == 0:
        return torch.full(col.shape, NULL_HASH, dtype=torch.int64, device=col.device)
    codes = col.to(torch.int64)
    return torch.where(codes >= 0, lut[codes.clamp(0, lut.numel() - 1)],
                       torch.full_like(codes, NULL_HASH))


def _n_tiles(per: int) -> int:
    return -(-per // TILE)


def _check_keys(keys, n_dev: int) -> tuple[int, int]:
    if not 1 <= len(keys) <= MAX_KEYS:
        raise ValueError(f"repartition takes 1 to {MAX_KEYS} key columns, got {len(keys)}")
    if not 1 <= n_dev <= MAX_PARTS:
        raise ValueError(f"repartition into {n_dev} parts (1 to {MAX_PARTS})")
    rows = keys[0][0].shape[0]
    dev = keys[0][0].device
    for col, lut in keys:
        if col.dim() != 1 or col.shape[0] != rows or col.device != dev:
            raise ValueError("key columns must be 1-D, of one length, on one device")
        if lut is not None and (col.dtype != torch.int32 or lut.dtype != torch.int64
                                or lut.device != dev):
            raise TypeError("a dictionary key is int32 codes with an int64 LUT on its device")
    if rows == 0 or rows % n_dev:
        raise ValueError(f"{rows} rows do not split into {n_dev} shards")
    return rows, rows // n_dev


def partition_count_plain(keys, n_valid, n_dev: int):
    """The plain PyTorch version of X1."""
    rows, per = _check_keys(keys, n_dev)
    dev = keys[0][0].device
    h = torch.zeros(rows, dtype=torch.int64, device=dev)
    for col, lut in keys:
        h = h * _i64(SM_GAMMA) + _key_hash_plain(col, lut)
    part = umod_plain(splitmix64_plain(h), n_dev).view(n_dev, per)
    nv = torch.as_tensor(np.asarray(n_valid, dtype=np.int64), device=dev).view(n_dev, 1)
    part = torch.where(torch.arange(per, device=dev) < nv, part,
                       torch.full_like(part, n_dev)).to(torch.int32)
    tiles = _n_tiles(per)
    shard = torch.arange(n_dev, device=dev).view(n_dev, 1)
    tile = (torch.arange(per, device=dev) // TILE).view(1, per)
    cell = (shard * tiles + tile) * (n_dev + 1) + part.to(torch.int64)
    tile_counts = torch.bincount(cell.view(-1), minlength=n_dev * tiles * (n_dev + 1))
    tile_counts = tile_counts.view(n_dev, tiles, n_dev + 1)[:, :, :n_dev].contiguous()
    return part.view(-1), tile_counts.sum(1), tile_counts


def partition_scatter_plain(part, tile_counts, counts, cols, n_dev: int, cap: int):
    """The plain PyTorch version of X2 (the reference's stable sort by
    (partition, row index) and scatter; tile_counts is not read)."""
    rows = part.shape[0]
    per = rows // n_dev
    dev = part.device
    marked = part.view(n_dev, per).to(torch.int64)
    ridx = torch.arange(per, device=dev)
    order = torch.argsort(marked * (per + 1) + ridx, dim=1, stable=True)
    sorted_part = torch.gather(marked, 1, order)
    starts = torch.cumsum(counts, 1) - counts
    within = ridx - torch.gather(starts, 1, sorted_part.clamp(max=n_dev - 1))
    shard = torch.arange(n_dev, device=dev).view(n_dev, 1)
    dest = torch.where((sorted_part < n_dev) & (within < cap),
                       (sorted_part * n_dev + shard) * cap + within,
                       torch.full_like(within, n_dev * n_dev * cap)).view(-1)
    src = (order + shard * per).view(-1)
    outs = []
    for c in cols:
        flat = torch.zeros(n_dev * n_dev * cap + 1, dtype=c.dtype, device=dev)
        flat[dest] = c[src]
        outs.append(flat[:-1])
    recv = counts.clamp(max=cap).t().reshape(-1).contiguous()
    return outs, recv


def partition_count(keys, n_valid, n_dev: int):
    """→ (part, counts, tile_counts) of a padded batch of n_dev shards (see
    the module docstring); n_valid holds each shard's valid rows."""
    rows, per = _check_keys(keys, n_dev)
    dev = keys[0][0].device
    if dev.type != "cuda":
        return partition_count_plain(keys, n_valid, n_dev)
    cols, luts, sizes = [], [], []
    for col, lut in keys:
        cols.append(col.contiguous() if lut is not None else col.to(torch.int64).contiguous())
        luts.append(None if lut is None else lut.contiguous())
        sizes.append(0 if lut is None else lut.numel())
    nv = torch.as_tensor(np.asarray(n_valid, dtype=np.int64)).pin_memory().to(
        dev, non_blocking=True)
    tiles = _n_tiles(per)
    part = torch.empty(rows, dtype=torch.int32, device=dev)
    tile_counts = torch.empty((n_dev, tiles, n_dev), dtype=torch.int64, device=dev)
    counts = torch.zeros((n_dev, n_dev), dtype=torch.int64, device=dev)
    k = len(keys)
    col_p = (_P * k)(*[c.data_ptr() for c in cols])
    # an empty dictionary's LUT may have no storage: its pointer only has to
    # be non-null (X1 never reads a LUT of size 0)
    lut_p = (_P * k)(*[None if u is None else (u.data_ptr() or 1) for u in luts])
    size_a = (_L * k)(*sizes)
    fn = _build.function(_X, "px_partition_count",
                         [_I, _P, _P, _P, _P, _L, _I, _P, _P, _P, _P])
    with torch.cuda.device(dev):
        err = fn(k, col_p, lut_p, size_a, _build.ptr(nv), per, n_dev, _build.ptr(part),
                 _build.ptr(tile_counts), _build.ptr(counts), _build.stream_of(part))
    _build.check(_X, err, "partition count")
    _build.KERNELS[_X].count("px_partition_count")
    return part, counts, tile_counts


def partition_scatter(part, tile_counts, counts, cols, n_dev: int, cap: int):
    """→ (outs, recv): every column of `cols` in the received layout (see the
    module docstring), at `cap` rows a block."""
    rows = part.shape[0]
    if not 1 <= n_dev <= MAX_PARTS or rows % n_dev or cap < 1:
        raise ValueError(f"scatter of {rows} rows into {n_dev} parts at cap {cap}")
    per = rows // n_dev
    if tile_counts.shape != (n_dev, _n_tiles(per), n_dev) or counts.shape != (n_dev, n_dev):
        raise ValueError("tile counts or counts do not match the batch")
    for c in cols:
        if c.dim() != 1 or c.shape[0] != rows or c.device != part.device:
            raise ValueError("columns must be 1-D, as long as part, on its device")
        if c.element_size() not in (1, 2, 4, 8):
            raise TypeError(f"no scatter of element size {c.element_size()}")
    if part.device.type != "cuda":
        return partition_scatter_plain(part, tile_counts, counts, cols, n_dev, cap)
    dev = part.device
    tile_counts = tile_counts.contiguous()
    # each tile's first rank per target, written by X2's first launch
    tile_first = torch.empty_like(tile_counts)
    srcs = [c.contiguous() for c in cols]
    part, counts = part.contiguous(), counts.contiguous()
    outs = [torch.empty(n_dev * n_dev * cap, dtype=c.dtype, device=dev) for c in srcs]
    recv = torch.empty(n_dev * n_dev, dtype=torch.int64, device=dev)
    k = len(srcs)
    src_p = (_P * max(k, 1))(*[c.data_ptr() for c in srcs])
    dst_p = (_P * max(k, 1))(*[o.data_ptr() for o in outs])
    width = (_I * max(k, 1))(*[c.element_size() for c in srcs])
    table = None
    if k > SCATTER_INLINE_COLS:
        # past the launch's by-value columns X2 reads (src, dst, width) a
        # column from the device; held until the launch is enqueued
        words = [w for c, o in zip(srcs, outs) for w in (c.data_ptr(), o.data_ptr(),
                                                          c.element_size())]
        table = torch.tensor(words, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    fn = _build.function(_X, "px_partition_scatter",
                         [_I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _L, _P, _P])
    with torch.cuda.device(dev):
        err = fn(k, src_p, dst_p, width, None if table is None else _build.ptr(table),
                 _build.ptr(part), _build.ptr(tile_counts), _build.ptr(tile_first),
                 _build.ptr(counts), per, n_dev, cap, _build.ptr(recv), _build.stream_of(part))
    _build.check(_X, err, "partition scatter")
    _build.KERNELS[_X].count("px_partition_scatter")
    return outs, recv
