"""Keyed repartition: hash-partitioned exchange for large-large joins.

Reference: pixie_tpu/parallel/repartition.py.  The splitter repartitions at
blocking boundaries via GRPCSink/GRPCSourceGroup shuffle edges
(splitter/splitter.h:114-155); a join of two unaggregated sides
hash-exchanges both inputs so each consumer joins one key-disjoint partition.

  * host exchange: agents hash rows by key VALUE (stable across processes —
    dictionary codes are per-agent) into P buckets; bucket p from every
    producer lands with consumer p, which joins locally.  Each bucket is an
    ordinary rows channel, so the wire format is unchanged.
  * in-mesh exchange (`mesh_partition_exchange`): the same keyed exchange
    across the shards of an agent's mesh.  On co-located shards the
    reference's lax.all_to_all is a layout: kernel X1 hashes every row and
    counts the rows per (shard, target), kernel X2 writes every column
    straight into the received layout (ops/repartition.py).

Both assign partitions by the same value hash, bit for bit, so a
mesh-exchanged and a host-exchanged producer of one join stage interoperate.
"""
from __future__ import annotations

import collections
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from pixie_tpu_torch import metrics as _metrics
from pixie_tpu_torch.engine import transfer
from pixie_tpu_torch.engine.executor import HostBatch, PlanExecutor
from pixie_tpu_torch.ops import repartition as _rp
from pixie_tpu_torch.ops.repartition import NULL_HASH, SM_GAMMA, splitmix64_np
from pixie_tpu_torch.status import Internal
from pixie_tpu_torch.table.table import TableStore

_SM_GAMMA = np.uint64(SM_GAMMA)
_splitmix64 = splitmix64_np


def _column_hash(hb, name: str) -> np.ndarray:
    """Per-row u64 hash of a column by VALUE (not by per-agent dict code)."""
    col = np.asarray(hb.cols[name])
    d = hb.dicts.get(name)
    if d is None:
        with np.errstate(over="ignore"):
            return _splitmix64(col.astype(np.int64).view(np.uint64))
    # Hash each UNIQUE value once (crc32 is process-stable, unlike hash()),
    # then spread per-row through the code LUT.
    uniq = [zlib.crc32(str(v).encode()) for v in d.values()]
    lut = _splitmix64(np.asarray(uniq, dtype=np.uint64))
    codes = col.astype(np.int64)
    out = np.zeros(len(codes), dtype=np.uint64)
    valid = codes >= 0
    out[valid] = lut[codes[valid]]
    out[~valid] = np.uint64(NULL_HASH)  # nulls hash together ("null")
    return out


def partition_ids(hb, keys: list, n_parts: int) -> np.ndarray:
    """Stable partition id per row from the key columns' VALUES."""
    if not keys:
        raise Internal("repartition requires at least one key")
    with np.errstate(over="ignore"):
        h = np.zeros(hb.num_rows, dtype=np.uint64)
        for k in keys:
            h = h * _SM_GAMMA + _column_hash(hb, k)
        h = _splitmix64(h)
    return (h % np.uint64(n_parts)).astype(np.int64)


def split_host_batch(hb, part: np.ndarray, n_parts: int) -> list:
    """HostBatch → one HostBatch per partition (dictionaries shared)."""
    order = np.argsort(part, kind="stable")
    sorted_part = part[order]
    bounds = np.searchsorted(sorted_part, np.arange(n_parts + 1))
    out = []
    for p in range(n_parts):
        idx = order[bounds[p]:bounds[p + 1]]
        out.append(HostBatch(
            dict(hb.dtypes), dict(hb.dicts),
            {c: np.asarray(v)[idx] for c, v in hb.cols.items()},
        ))
    return out


# ------------------------------------------------------------ join stages
def run_join_stages(dp, payloads: dict, registry, store=None, device=None,
                    max_workers: int = 8, analyze: bool = False) -> None:
    """Execute a DistributedPlan's repartition-join stages.

    For each stage: partition p's buckets from every producer (both sides)
    union and join in parallel workers, each on `device` — each partition
    holds a key-disjoint slice, so the per-partition joins concatenate into
    the exact join.  Consumes the bucket channels from `payloads` and adds
    the join-output channel."""
    from concurrent.futures import ThreadPoolExecutor

    from pixie_tpu_torch.parallel.cluster import _union_host_batches

    for stage in getattr(dp, "join_stages", None) or []:
        def run_part(p, stage=stage):
            def gather(prefix):
                got = payloads.get(f"{prefix}{p}", [])
                if not got:
                    raise Internal(f"repartition channel {prefix}{p} got no payloads")
                # same wire-shape contract as ordinary rows channels: a
                # mis-typed agent payload fails cleanly, not deep in a join
                if not all(isinstance(b, HostBatch) for b in got):
                    raise Internal(f"repartition channel {prefix}{p}: expected row payloads")
                return _union_host_batches(got)

            ex = PlanExecutor(
                stage.fragment, store or TableStore(), registry, device=device,
                inputs={stage.left_channel: gather(stage.left_prefix),
                        stage.right_channel: gather(stage.right_prefix)},
                analyze=analyze,
            )
            return ex.run_agent()[stage.out_channel]

        with ThreadPoolExecutor(max_workers=min(stage.n_parts, max_workers)) as pool:
            parts = list(pool.map(run_part, range(stage.n_parts)))
        payloads[stage.out_channel] = parts


def bucket_channels(dp) -> set:
    """Channel ids consumed by join stages (excluded from the merger's
    channel-input merge)."""
    consumed = set()
    for s in getattr(dp, "join_stages", None) or []:
        for p in range(s.n_parts):
            consumed.add(f"{s.left_prefix}{p}")
            consumed.add(f"{s.right_prefix}{p}")
    return consumed


def stage_output_inputs(dp, payloads: dict) -> dict:
    """{out_channel: unioned HostBatch} for every executed join stage."""
    from pixie_tpu_torch.parallel.cluster import _union_host_batches

    return {
        s.out_channel: _union_host_batches(payloads[s.out_channel])
        for s in (getattr(dp, "join_stages", None) or [])
    }


# ------------------------------------------------------- in-mesh exchange
#: per-dictionary key LUTs on the device, keyed by (device, key columns'
#: dictionary ids and sizes): without this every shuffle would CRC32 every
#: dictionary value again.  Dictionaries are append-only, so (id, size) pins
#: content; the entry keeps the dictionaries and checks identity, so a
#: recycled id never serves a stale LUT.
_EXCHANGE_CACHE: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_EXCHANGE_CACHE_MAX = 32
_EXCHANGE_LOCK = threading.Lock()


def _exchange_cached(key, dicts: tuple, build):
    with _EXCHANGE_LOCK:
        got = _EXCHANGE_CACHE.get(key)
        if got is not None and all(a is b for a, b in zip(got[0], dicts)):
            _EXCHANGE_CACHE.move_to_end(key)
            return got[1]
    val = build()
    with _EXCHANGE_LOCK:
        _EXCHANGE_CACHE[key] = (dicts, val)
        while len(_EXCHANGE_CACHE) > _EXCHANGE_CACHE_MAX:
            _EXCHANGE_CACHE.popitem(last=False)
    return val


def _exchange_sig(hb, keys, mesh) -> tuple:
    return (str(mesh.device), tuple(keys),
            tuple((k, id(hb.dicts[k]), hb.dicts[k].size) for k in keys if k in hb.dicts))


def _device_key_luts(hb, keys, device) -> dict:
    """{dictionary key column: its per-code value-hash LUT on `device`}."""
    return {k: transfer.to_device(_rp.value_hash_lut(hb.dicts[k].values()), device)
            for k in keys if k in hb.dicts}


def _upload_padded(a: np.ndarray, padded: int, device) -> torch.Tensor:
    if padded != len(a):
        a = np.concatenate([a, np.zeros(padded - len(a), a.dtype)])
    return transfer.to_device(a, device)


def mesh_partition_exchange(hb, keys, n_parts: int, mesh):
    """Keyed repartition of a HostBatch over an agent's mesh → one HostBatch
    per partition, each partition's rows in (shard, row) order.

    Requires n_parts == mesh size (shard d IS partition d); the assignment
    equals partition_ids() exactly.  The rows shard row-block-wise; two
    passes, as in the reference: X1 hashes every row and counts each
    shard's rows per partition, which come back in one small readback; the
    host sizes the per-block capacity `cap` to the measured largest bucket;
    X2 writes every column into the received layout ([n_dev, n_dev, cap]:
    block (p, i) = the rows shard i sends to partition p) with the received
    counts, which come back in the second readback.  A capacity fault fails
    the row-conservation check loudly."""
    n_dev = mesh.size
    if n_parts != n_dev:
        raise Internal(
            f"mesh exchange requires n_parts == mesh devices ({n_parts} != {n_dev})")
    from pixie_tpu_torch.parallel.spmd import per_shard_valid

    dev = mesh.device
    rows = hb.num_rows
    per = max(1, -(-rows // n_dev))  # ceil; >= 1 so shards are non-empty
    padded = per * n_dev
    names = list(hb.cols)
    cols_dev = {name: _upload_padded(np.asarray(hb.cols[name]), padded, dev)
                for name in names}
    n_valid = per_shard_valid(rows, padded, n_dev)
    luts = _exchange_cached(_exchange_sig(hb, keys, mesh),
                            tuple(hb.dicts[k] for k in keys if k in hb.dicts),
                            lambda: _device_key_luts(hb, keys, dev))

    # ---- pass 1: partition ids (kept on the device for pass 2) and counts
    part, counts_dev, tile_counts = _rp.partition_count(
        [(cols_dev[k], luts.get(k)) for k in keys], n_valid, n_dev)
    send_counts = transfer.pull(counts_dev)
    # the measured largest bucket (no compile to reuse, so no pow2 rounding),
    # never beyond the shard size
    cap = min(per, max(1, int(send_counts.max()) if send_counts.size else 1))

    # ---- pass 2: the exchange proper at the measured capacity
    outs, recv = _rp.partition_scatter(part, tile_counts, counts_dev,
                                       [cols_dev[n] for n in names], n_dev, cap)
    exchanged, counts = transfer.pull((outs, recv))
    counts = np.asarray(counts).reshape(n_dev, n_dev)  # [partition, shard]
    if int(counts.sum()) != rows:  # a capacity fault must fail loudly, not drop rows
        raise Internal(f"mesh exchange lost rows: sent {rows}, received "
                       f"{int(counts.sum())} (cap={cap})")
    out = []
    for p in range(n_dev):
        cols_p = {}
        for name, arr in zip(names, exchanged):
            blocks = np.asarray(arr).reshape(n_dev, n_dev, cap)[p]
            cols_p[name] = np.concatenate([blocks[i, : counts[p, i]] for i in range(n_dev)])
        out.append(HostBatch(dict(hb.dtypes), dict(hb.dicts), cols_p))
    # receive-side partition skew (max/mean rows per join partition)
    recv_rows = counts.sum(axis=1)
    mean = recv_rows.mean() if n_dev else 0
    skew = float(recv_rows.max() / mean) if mean > 0 else 1.0
    _metrics.gauge_set(
        "px_partition_skew_frac", skew,
        help_="max/mean rows received per join partition in this "
              "process's latest mesh shuffle (key-hash skew; 1.0 = even)")
    return out


# ------------------------------------------------ exchange across processes
def _local_blocks(mesh, cols: dict, n_valid):
    """This process's shards as X1 / X2 see them across processes: the
    local batch (n_local shards of `per` rows, each padded to a multiple of
    the process count) cut into mesh.size sub-shards of q rows, so that X1
    and X2, which take as many shards as targets, hash every local row to
    a mesh position.  Sub-shard s * n_proc + j is rows [j * q, (j + 1) * q)
    of local shard s.  → (flat columns, sub-shard valid counts, n_local, q)."""
    from pixie_tpu_torch.parallel.spmd import local_valid

    n_local = mesh.local_size
    n_proc = mesh.size // n_local
    nv = np.asarray(local_valid(n_valid, mesh), dtype=np.int64)
    flat, per = {}, None
    for name, v in cols.items():
        blocks = v if v.dim() == 2 else v.view(n_local, v.shape[0] // n_local)
        if blocks.shape[0] != n_local or (per is not None and blocks.shape[1] != per):
            raise Internal(f"{name}: {tuple(blocks.shape)} is not {n_local} local shards")
        per = blocks.shape[1]
        q = -(-per // n_proc)
        if q * n_proc != per:
            padded = torch.zeros((n_local, q * n_proc), dtype=blocks.dtype,
                                 device=blocks.device)
            padded[:, :per] = blocks
            blocks = padded
        flat[name] = blocks.reshape(-1)
    q = -(-per // n_proc)
    starts = np.arange(n_proc, dtype=np.int64) * q
    sub_nv = np.clip(nv[:, None] - starts[None, :], 0, q).reshape(-1)
    return flat, sub_nv, n_local, q


def _key_inputs(flat: dict, keys: list, luts: dict) -> list:
    return [(flat[k], (luts or {}).get(k)) for k in keys]


def mesh_bucket_counts(mesh, keys: list, luts: Optional[dict] = None):
    """The counts pass of the exchange across a mesh's processes (reference
    `mesh_bucket_counts`): → fn(cols, n_valid) -> (part, counts).  X1 hashes
    this process's rows by the key columns' values (partition_ids' hash, bit
    for bit) into mesh positions: part int32 [n_local, per] (mesh.size past
    a shard's valid rows) and counts int64 [n_local, mesh.size], each local
    shard's rows per target position, on the shards' device.  `luts` maps a
    dictionary key column (int32 codes) to its value-hash LUT on that
    device (ops/repartition.py value_hash_lut).  No collective."""
    def run(cols, n_valid):
        flat, sub_nv, n_local, _q = _local_blocks(mesh, cols, n_valid)
        n_dev = mesh.size
        part, sub_counts, _tiles = _rp.partition_count(_key_inputs(flat, keys, luts),
                                                       sub_nv, n_dev)
        per = next(iter(cols.values())).numel() // n_local
        part = part.view(n_local, -1)[:, :per]
        return part, sub_counts.view(n_local, n_dev // n_local, n_dev).sum(1)

    return run


class Exchanged:
    """What one rank received from a keyed exchange across processes.

    cols[name] is one flat tensor holding every block (j, s): the rows
    source position s sent to this process's j-th position, in the source's
    row order; counts[j, s] and offsets[j, s] (numpy int64 [n_local,
    mesh.size]) give each block's length and start.  Nothing past a block's
    count is held."""

    def __init__(self, cols: dict, counts: np.ndarray, offsets: np.ndarray,
                 sent_bytes: int, recv_bytes: int):
        self.cols, self.counts, self.offsets = cols, counts, offsets
        self.sent_bytes, self.recv_bytes = sent_bytes, recv_bytes

    def block(self, name: str, j: int, s: int) -> torch.Tensor:
        o = int(self.offsets[j, s])
        return self.cols[name][o:o + int(self.counts[j, s])]

    def rows(self, j: int) -> dict:
        """{name: local position j's rows, grouped by source position in
        mesh order} as numpy arrays."""
        return {name: np.concatenate([transfer.pull(self.block(name, j, s))
                                      for s in range(self.counts.shape[1])])
                for name in self.cols}


def mesh_repartition(mesh, keys: list, luts: Optional[dict] = None):
    """The keyed repartition across a mesh's processes (reference
    `mesh_repartition`): → fn(cols, n_valid) -> Exchanged.

    Each process passes its own shards (cols {name: [n_local, per] or
    padded 1-D}, on its device; n_valid per local shard or per mesh
    position).  X1 counts every local shard's rows by target position
    (mesh_bucket_counts' pass); one all_to_all_single exchanges the counts;
    X2 scatters each local shard stably into blocks by (target, shard) and
    K4 closes the blocks' gaps, so the rows for each rank lie contiguous in
    (target, source, row) order; one all_to_all_single a column sends them
    with the counted splits.  Rows arrive grouped by source position, in
    the reference's order and with its counts, and rows past a block's
    count are never sent."""
    from pixie_tpu_torch.ops.compact import compact
    from pixie_tpu_torch.parallel import multihost

    def run(cols, n_valid) -> Exchanged:
        t0 = time.perf_counter()
        n_dev = mesh.size
        flat, sub_nv, n_local, _q = _local_blocks(mesh, cols, n_valid)
        n_proc = n_dev // n_local
        names = list(flat)
        # ---- X1: targets and counts of every sub-shard (one small readback)
        part, sub_counts, tiles = _rp.partition_count(_key_inputs(flat, keys, luts),
                                                      sub_nv, n_dev)
        sc = transfer.pull(sub_counts).reshape(n_dev, n_dev)  # [sub-shard, target]
        if int(sc.sum()) != int(sub_nv.sum()):
            raise Internal(f"exchange counted {int(sc.sum())} of {int(sub_nv.sum())} rows")
        # per (target, local shard): the rows each source position sends
        by_src = sc.reshape(n_local, n_proc, n_dev).sum(1).T  # [target, local shard]
        # ---- the counts exchange: rank r gets [its targets, my shards]
        send_counts = by_src.reshape(n_proc, n_local * n_local)
        got = multihost.all_to_all_counts(send_counts, mesh).reshape(
            n_proc, n_local, n_local)  # [source rank, my target, its shard]
        counts = got.transpose(1, 0, 2).reshape(n_local, n_dev)  # [my target, source]
        # ---- X2 then K4: this rank's rows in (target, sub-shard, row) order
        cap = max(1, int(sc.max()) if sc.size else 1)
        outs, recv = _rp.partition_scatter(part, tiles, sub_counts,
                                           [flat[n] for n in names], n_dev, cap)
        dev = part.device
        keep = (torch.arange(cap, device=dev).view(1, cap) < recv.view(-1, 1)).view(-1)
        dense, _n = compact(keep, outs)
        send = by_src.reshape(n_proc, n_local * n_local).sum(1)  # rows to each rank
        recv_rows = got.reshape(n_proc, -1).sum(1)  # rows from each rank
        total_send = int(send.sum())
        out_cols = {name: multihost.all_to_all_rows(col[:total_send], send.tolist(),
                                                    recv_rows.tolist(), mesh)
                    for name, col in zip(names, dense)}
        # block (j, s) sits in rank r's segment (s // n_local) at its
        # (target j, shard) place, the segment's blocks target-major
        offsets = np.zeros((n_local, n_dev), dtype=np.int64)
        base = np.concatenate([[0], np.cumsum(recv_rows)[:-1]])
        for r in range(n_proc):
            seg = got[r].reshape(-1)  # [my target, its shard], target-major
            starts = base[r] + np.concatenate([[0], np.cumsum(seg)[:-1]])
            offsets[:, r * n_local:(r + 1) * n_local] = starts.reshape(n_local, n_local)
        width = sum(flat[n].element_size() for n in names)
        multihost._count(exchanges=1, exchange_wall_s=time.perf_counter() - t0)
        return Exchanged(out_cols, counts, offsets, total_send * width,
                         int(recv_rows.sum()) * width)

    return run
