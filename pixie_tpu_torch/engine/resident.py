"""Device-resident hot tables: the pinned tier above the HBM feed cache.

Reference: pixie_tpu/engine/resident.py, the single-device tier.

The sealed-feed HBM cache (executor._DEVICE_CACHE) keys whole feeds by their
seal-gen tuple, so every new seal changes the key and the next query
re-uploads every byte of the hot columns.  This tier fixes the invalidation
granularity:

  * One pinned entry per (table uid, column set, device): the newest run of
    sealed batches as ONE device buffer per column (power-of-two bucket,
    zero padded past `rows`).
  * Ingest deltas FOLD IN PLACE: a new seal uploads only its own rows, which
    kernel R1 appends to the resident buffers (ops/resident.py `fold`); a
    fold past the bucket first grows it with kernel R2.
  * Retention trims EVICT: `Table._expire_locked` calls `on_retention_trim`;
    a fully expired entry frees at once, a head-trimmed entry marks
    `trim_to` and its next feed rebases it (R2 moves the retained rows to
    the front of a fresh buffer; they never re-cross the link).
  * A warm query whose cursor matches the resident range is served the
    buffers directly: zero host→device bytes.

Budget: `PL_HBM_RESIDENT_MB` bounds the tier (LRU across entries; an entry
that cannot fit falls back to the executor's feed cache / upload path, with
the same results).  `PL_HBM_RESIDENT=0` turns the tier off.

Sharded entries (the reference's `_SHARD_KERNELS`, row 15): an SPMD
consumer over a mesh of n_dev co-located shards asks with `n_dev`, and its
entry is keyed by it, so sharded and single-device entries of one table
coexist and never alias, as in the reference.  A sharded entry is the same
contiguous device buffer per column, read as [n_dev, bucket / n_dev] (shard
i holds rows [i * bucket / n_dev, (i + 1) * bucket / n_dev)), so its fold,
grow and rebase are R1 and R2 as for any entry, and a fold that crosses a
shard boundary lands where `dynamic_update_slice` on the reference's
row-wise NamedSharding puts it.  The bucket must split into n_dev shards.

Not ported yet: the tier's metrics, which come with the observability
slice; this module counts in `stats` instead.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from pixie_tpu_torch import flags as _flags
from pixie_tpu_torch.ops import resident as _rk
from pixie_tpu_torch.udf.udf import to_torch_dtype

_flags.define_bool(
    "PL_HBM_RESIDENT", True,
    "pinned device-resident tier for sealed hot-table columns (warm "
    "queries upload zero bytes; deltas fold in place)")
_flags.define_int(
    "PL_HBM_RESIDENT_MB", 2048,
    "resident-tier HBM budget (MB); entries beyond it fall back to the "
    "streaming feed path")

MIN_BUCKET = 1 << 10

_LOCK = threading.Lock()
#: per-entry feed locks: fold/rebase range math must serialize PER ENTRY (two
#: warm queries racing the same delta would double-fold it), but a global
#: lock would block every table's warm hit behind one table's admission
_ENTRY_LOCKS: dict = {}
#: (table_uid, names tuple, device, n_dev) -> _Entry, LRU order
_TIER: "OrderedDict[tuple, _Entry]" = OrderedDict()
_TIER_BYTES = 0

#: process-wide tier counters
stats = {"hits": 0, "folds": 0, "rebases": 0, "admissions": 0,
         "fallbacks": 0, "trims": 0}


def _entry_lock(key):
    with _LOCK:
        lk = _ENTRY_LOCKS.get(key)
        if lk is None:
            lk = _ENTRY_LOCKS[key] = threading.RLock()
        return lk


class _Entry:
    __slots__ = ("gen_lo", "gen_hi", "rows", "batch_rows", "bucket", "cols",
                 "nbytes", "trim_to")

    def __init__(self, gen_lo, gen_hi, rows, batch_rows, bucket, cols):
        self.gen_lo = gen_lo
        self.gen_hi = gen_hi
        self.rows = rows
        self.batch_rows = batch_rows
        self.bucket = bucket
        self.cols = cols
        self.nbytes = sum(_nbytes(v) for v in cols.values())
        self.trim_to: Optional[int] = None


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


def bucket_rows(n: int) -> int:
    """Rows of the padded buffer that holds a feed of n rows."""
    return max(_next_pow2(n), MIN_BUCKET)


def _budget_bytes() -> int:
    return int(_flags.get("PL_HBM_RESIDENT_MB")) << 20


def _evict_lru_locked(need: int, keep_key) -> bool:
    """Evict LRU entries (never `keep_key`) until `need` bytes fit the
    budget.  Returns False when impossible (the entry alone exceeds it)."""
    global _TIER_BYTES
    budget = _budget_bytes()
    if need > budget:
        return False
    while _TIER_BYTES + need > budget:
        victim = next((k for k in _TIER if k != keep_key), None)
        if victim is None:
            return False
        e = _TIER.pop(victim)
        _TIER_BYTES -= e.nbytes
    return True


def upload_padded(parts: list, names, n: int, bucket: int, device) -> tuple[dict, int]:
    """The one implementation of padded feed upload (the tier's admission
    and the executor's feed cache both use it): zeroed device buffers of
    `bucket` rows with the feed's n rows folded in at row 0 (R1 on CUDA).
    → ({name: buffer}, bytes that crossed host→device)."""
    bufs = [torch.zeros(bucket, dtype=to_torch_dtype(parts[0][k].dtype), device=device)
            for k in names]
    h2d = _rk.fold(bufs, [[p[k] for p in parts] for k in names], 0)
    return dict(zip(names, bufs)), h2d


def feed(table_uid: int, names: tuple, gens: list, batch_rows: int,
         parts: list, n_rows: int, device, prewarmed=None, n_dev: int = 1):
    """Serve one sealed-only feed from the resident tier.

    → (device cols dict padded to the entry bucket, h2d_bytes) or None
    (tier off / shape not coverable / budget exceeded: the caller streams
    through the feed cache or a fresh upload).  `gens` must be the
    consecutive seal gens of `parts`, each part exactly `batch_rows` rows
    (whole sealed batches; sliced delta batches carry gen None and never
    reach here).  `prewarmed` optionally carries the feed cache's entry for
    exactly this feed: admission then ADOPTS those buffers instead of
    uploading the same bytes again beside them.  `n_dev` > 1 selects the
    sharded entry of a mesh of n_dev shards (None when the bucket does not
    split into them: the caller streams).
    """
    if not _flags.get("PL_HBM_RESIDENT") or not gens:
        return None
    if not all(isinstance(g, (int, np.integer)) for g in gens):
        return None
    if any(gens[i + 1] != gens[i] + 1 for i in range(len(gens) - 1)):
        return None  # time-pruned cursor skipped interior batches
    if any(len(p[names[0]]) != batch_rows for p in parts):
        return None
    if n_dev > 1 and bucket_rows(n_rows) % n_dev:
        return None  # not row-block shardable; the caller streams
    key = (table_uid, names, str(torch.device(device)), n_dev)
    # one feed mutates a given entry at a time: concurrent warm queries over
    # the same table would otherwise both compute the same delta and fold it
    # twice (other tables' feeds proceed in parallel)
    with _entry_lock(key):
        return _feed_locked(key, gens, parts, batch_rows, n_rows, device, prewarmed)


def _feed_locked(key, gens, parts, batch_rows, n_rows, device, prewarmed=None):
    global _TIER_BYTES
    g0, g1 = int(gens[0]), int(gens[-1])
    with _LOCK:
        entry = _TIER.get(key)
        if entry is not None:
            _TIER.move_to_end(key)
    if entry is None:
        return _admit(key, g0, g1, batch_rows, parts, n_rows, device, prewarmed)
    # lazily apply a pending retention trim before range math
    if entry.trim_to is not None and entry.trim_to > entry.gen_lo:
        _rebase(entry, entry.trim_to)
    if g0 < entry.gen_lo:
        # an old pinned cursor reaching below the resident window: its head
        # rows are gone from the tier — stream it, keep the entry
        stats["fallbacks"] += 1
        return None
    if g1 <= entry.gen_hi:
        if g0 == entry.gen_lo and g1 == entry.gen_hi:
            stats["hits"] += 1
            return dict(entry.cols), 0
        stats["fallbacks"] += 1
        return None  # strict subrange (bounded cursor): stream it
    if g0 > entry.gen_hi + 1:
        # disjoint newer run (a table's later feed): the newest batches win
        # the pinned slot
        with _LOCK:
            _TIER.pop(key, None)
            _TIER_BYTES -= entry.nbytes
        return _admit(key, g0, g1, batch_rows, parts, n_rows, device, prewarmed)
    # overlap/extension: fold only the new batches.  A cursor starting PAST
    # the entry head without a pending trim is a time-pruned head (the head
    # batches are still retained and other queries still want them) — stream
    # it rather than rebasing the pinned entry; real retention trims arrive
    # via on_retention_trim and were applied above.
    if g0 > entry.gen_lo:
        stats["fallbacks"] += 1
        return None
    delta = [p for g, p in zip(gens, parts) if g > entry.gen_hi]
    h2d = _fold(key, entry, delta, g1)
    if h2d is None:
        return None
    if entry.rows != n_rows:  # defensive: never serve a mis-sized buffer
        with _LOCK:
            _TIER.pop(key, None)
            _TIER_BYTES -= entry.nbytes
        return None
    return dict(entry.cols), h2d


def _admit(key, g0, g1, batch_rows, parts, n_rows, device, prewarmed=None):
    global _TIER_BYTES
    names = key[1]
    bucket = bucket_rows(n_rows)
    dev = torch.device(device)

    def adoptable(t):
        return t.shape == (bucket,) and t.device == dev

    if (prewarmed is not None
            and all(n in prewarmed and adoptable(prewarmed[n]) for n in names)):
        # adopt the feed cache's buffers for this exact feed: zero re-upload,
        # and the caller evicts the cache entry so the bytes are pinned ONCE
        cols = {n: prewarmed[n] for n in names}
        nbytes = sum(_nbytes(v) for v in cols.values())
    else:
        cols = None
        nbytes = bucket * sum(parts[0][n].dtype.itemsize for n in names)
    with _LOCK:
        if not _evict_lru_locked(nbytes, key):
            stats["fallbacks"] += 1
            return None
    h2d = 0
    if cols is None:
        # h2d is the bytes that really cross the link: the feed's rows, not
        # the zero padding (made on the device)
        cols, h2d = upload_padded(parts, names, n_rows, bucket, dev)
    entry = _Entry(g0, g1, n_rows, batch_rows, bucket, cols)
    with _LOCK:
        old = _TIER.pop(key, None)
        if old is not None:
            _TIER_BYTES -= old.nbytes
        _TIER[key] = entry
        _TIER_BYTES += entry.nbytes
    stats["admissions"] += 1
    return dict(entry.cols), h2d


def _rebase(entry: _Entry, new_lo: int) -> None:
    """Drop expired head batches on the device: R2 moves the retained rows
    to the front of fresh buffers of the same bucket."""
    drop = (new_lo - entry.gen_lo) * entry.batch_rows
    names = list(entry.cols)
    moved = _rk.move([entry.cols[k] for k in names], drop, entry.rows - drop,
                     entry.bucket)
    entry.cols = dict(zip(names, moved))
    entry.rows -= drop
    entry.gen_lo = new_lo
    with _LOCK:
        # clear the trim mark only if no NEWER trim landed mid-rebase (the
        # writer sets trim_to under _LOCK)
        if entry.trim_to is not None and entry.trim_to <= new_lo:
            entry.trim_to = None
    stats["rebases"] += 1


def _fold(key, entry: _Entry, delta_parts: list, new_hi: int):
    """Append new sealed batches in place; → uploaded delta bytes or None
    (growth blew the budget — entry dropped, caller streams)."""
    global _TIER_BYTES
    names = key[1]
    add_rows = sum(len(p[names[0]]) for p in delta_parts)
    new_rows = entry.rows + add_rows
    if new_rows > entry.bucket:
        new_bucket = bucket_rows(new_rows)
        grown_bytes = sum((_nbytes(v) // entry.bucket) * new_bucket
                          for v in entry.cols.values())
        with _LOCK:
            # a concurrent retention trim may have popped this entry: then
            # the byte ledger no longer covers it — grow the orphan for this
            # one serve without touching the accounting
            present = _TIER.get(key) is entry
            if present:
                _TIER_BYTES -= entry.nbytes
                if not _evict_lru_locked(grown_bytes, key):
                    _TIER.pop(key, None)
                    stats["fallbacks"] += 1
                    return None
                _TIER_BYTES += grown_bytes
            # nbytes flips inside the ledger's lock
            entry.nbytes = grown_bytes
        cols = list(entry.cols)
        grown = _rk.move([entry.cols[k] for k in cols], 0, entry.rows, new_bucket)
        entry.cols = dict(zip(cols, grown))
        entry.bucket = new_bucket
    h2d = _rk.fold([entry.cols[k] for k in names],
                   [[p[k] for p in delta_parts] for k in names], entry.rows)
    entry.rows = new_rows
    entry.gen_hi = new_hi
    stats["folds"] += 1
    return h2d


def on_retention_trim(table_uid: int, oldest_retained_gen) -> None:
    """Table expiry hook: free fully expired entries now; mark head-trimmed
    entries for a lazy rebase at their next feed.  Cheap (no device work):
    it runs on the writer thread under the table lock, so it never waits on
    an entry's feed lock."""
    global _TIER_BYTES
    with _LOCK:
        for key in [k for k in _TIER if k[0] == table_uid]:
            e = _TIER[key]
            if oldest_retained_gen is None or oldest_retained_gen > e.gen_hi:
                _TIER.pop(key)
                _TIER_BYTES -= e.nbytes
                stats["trims"] += 1
            elif oldest_retained_gen > e.gen_lo:
                e.trim_to = max(e.trim_to or 0, oldest_retained_gen)


def drop_table(table_uid: int) -> None:
    """Free every resident entry of one table now."""
    global _TIER_BYTES
    with _LOCK:
        for key in [k for k in _TIER if k[0] == table_uid]:
            e = _TIER.pop(key)
            _TIER_BYTES -= e.nbytes
            stats["trims"] += 1


def tier_stats() -> dict:
    with _LOCK:
        return {"entries": len(_TIER), "bytes": _TIER_BYTES, **stats}


def per_table_bytes() -> dict[int, int]:
    """{table_uid: pinned device bytes}."""
    out: dict[int, int] = {}
    with _LOCK:
        for key, e in _TIER.items():
            uid = int(key[0])
            out[uid] = out.get(uid, 0) + int(e.nbytes)
    return out


def clear_for_testing() -> None:
    global _TIER_BYTES
    with _LOCK:
        _TIER.clear()
        _ENTRY_LOCKS.clear()
        _TIER_BYTES = 0
    for k in stats:
        stats[k] = 0
