"""In-memory columnar table store.

Parity with reference src/table_store/table/table.h and table_store.h:79:

  * Hot side: appended records accumulate until a full batch is available
    (reference "hot" partition).
  * Cold side: sealed batches of exactly `batch_rows` rows — the compaction unit
    (reference CompactHotToCold, table.h:166, 64KiB cold batches table.h:64-67).
  * Ring-buffer expiry by byte budget (reference table.h expiry).
  * Time+row-id indexed cursor (reference Cursor, table.h:76-124): batch-level
    pruning on [min_time, max_time]; fine-grained time bounds are applied by the
    executor as a row mask inside the chain kernel.
  * Dictionary encoding of STRING/UINT128 columns happens here, at write time.
  * The durable ingest journal (table/journal.py), the compressed on-disk
    cold tier (table/lifecycle.py) and tablets (table/tablets.py) hook in
    here as in the reference.  Seal replication (`on_seal`,
    services/replication.py) is not ported yet (ROADMAP Queue 1 item 6d,
    part 2) and is refused with Unimplemented where a caller reaches it.

A retention trim notifies the device-resident tier (engine/resident.py),
which frees or rebases the table's pinned device buffers.

Thread model: one writer per table (the collector poll loop) + concurrent readers;
a lock guards the batch list and builder swap, matching the reference's spinlocked
hot/cold partitions (table.h:174-190, ABSL_GUARDED_BY annotations).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Iterator, Optional

import numpy as np

from pixie_tpu_torch.status import InvalidArgument, NotFound, Unimplemented
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.types import STORAGE_DTYPE, Relation, is_dict_encoded

DEFAULT_BATCH_ROWS = 1 << 16
DEFAULT_TABLE_BYTES = 256 * 1024 * 1024

#: Process-unique table ids for engine caches — id() of a freed Table can be
#: reused by a new allocation, which would alias cache keys.
_table_uid = itertools.count(1)

class _SealedBatch:
    __slots__ = ("batch", "row_id_start", "min_time", "max_time", "nbytes",
                 "gen", "num_rows", "sealed_at")

    def __init__(self, batch: RowBatch, row_id_start: int, time_col: str | None, gen: int):
        self.batch = batch
        self.row_id_start = row_id_start
        self.gen = gen  # monotonically increasing seal id
        if time_col is not None and batch.num_valid > 0:
            t = batch.columns[time_col][: batch.num_valid]
            self.min_time = int(t.min())
            self.max_time = int(t.max())
        else:
            self.min_time = None
            self.max_time = None
        self.nbytes = batch.nbytes()
        #: row count + seal time as METADATA (not via .batch) so the cold
        #: tier's demoted stubs (table.lifecycle._ColdBatch, same duck-type)
        #: can answer size/age questions without decoding from disk
        self.num_rows = batch.num_rows
        self.sealed_at = time.monotonic()


class Table:
    """One telemetry table: schema + dictionaries + hot builder + sealed batches."""

    def __init__(
        self,
        name: str,
        relation: Relation,
        max_bytes: int = DEFAULT_TABLE_BYTES,
        batch_rows: int = DEFAULT_BATCH_ROWS,
    ):
        self.name = name
        self.uid = next(_table_uid)
        self.relation = relation
        self.max_bytes = max_bytes
        self.batch_rows = batch_rows
        self.time_col = "time_" if "time_" in relation else None
        self.dictionaries: dict[str, Dictionary] = {
            c.name: Dictionary() for c in relation if is_dict_encoded(c.data_type)
        }
        self._lock = threading.Lock()
        #: durable ingest journal (table.journal.TableJournal) — when set,
        #: every acknowledged write appends one CRC-framed record BEFORE
        #: returning, so a restarted process replays acked rows back
        self.journal = None
        #: seal observer (replication): called OUTSIDE the lock with the
        #: newly sealed batches of one write — services/replication.py ships
        #: them to this shard's replica peers
        self.on_seal = None
        #: compressed on-disk cold tier (table.lifecycle.ColdTier) —
        #: attached by journal.attach_store when PL_COLD_TIER is on (or cold
        #: segments already exist on disk); None = the all-RAM seed
        #: behavior, bit-identical paths
        self.cold = None
        #: batches adopted from the cold tier at restore time (journal
        #: replay uses this to tell a legitimate pruned-head gap from
        #: corruption when the replay head starts past the frontier)
        self._cold_rows_adopted = 0
        self._sealed: list[_SealedBatch] = []
        self._hot: dict[str, list[np.ndarray]] = {c.name: [] for c in relation}
        self._hot_rows = 0
        self._next_row_id = 0
        self._next_gen = 0
        self._sealed_bytes = 0
        self._expired_batches = 0
        self._total_rows_written = 0
        #: cached full-table snapshot (the interactive warm-query fast path):
        #: (version, Cursor).  A warm dashboard query re-snapshots the same
        #: unchanged table every few ms; rebuilding the Cursor re-lists the
        #: sealed batches and re-concatenates the hot rows each time.  The
        #: version key covers every way the snapshot can change — appended
        #: rows/seals (_next_row_id, _hot_rows) and retention trimming
        #: (_expired_batches) — so a stale snapshot is unreachable.
        self._snap_cache: tuple | None = None

    # ------------------------------------------------------------------ write
    def write(self, data: dict) -> int:
        """Append a record batch given as {col: sequence}. Returns rows written.

        Reference: Table::WriteRowBatch / TransferRecordBatch (table.h:152-155).
        Encodes dict-typed columns; seals full `batch_rows` chunks.

        OWNERSHIP: write() takes ownership of any numpy arrays passed in —
        matching-dtype arrays are aliased, not copied, and sealed batches are
        views into them (see _seal_full_locked for why).  Callers must not
        mutate an array after passing it here; non-dict ndarray columns are
        marked read-only at write time so violation raises instead of
        corrupting sealed (and device-cached) data.
        """
        if self.on_seal is not None:
            raise Unimplemented(
                f"write to {self.name}: seal replication is not ported yet "
                "(ROADMAP Queue 1 item 6d, part 2)")
        # Validate shape before touching dictionaries: a rejected write must not
        # leak values into the append-only dictionaries.
        n = None
        for c in self.relation:
            if c.name not in data:
                raise InvalidArgument(f"write to {self.name}: missing column {c.name}")
            ln = len(data[c.name])
            if n is None:
                n = ln
            elif ln != n:
                raise InvalidArgument(f"write to {self.name}: ragged columns")
        cols: dict[str, np.ndarray] = {}
        for c in self.relation:
            v = data[c.name]
            if c.name in self.dictionaries:
                cols[c.name] = self.dictionaries[c.name].encode(v)
            else:
                arr = np.asarray(v, dtype=STORAGE_DTYPE[c.data_type])
                # Enforce the take-ownership contract: freezing the (possibly
                # aliased) array makes a caller's post-write mutation raise.
                # Only freezing base-owning arrays: a read-only view would not
                # stop writes through the caller's base anyway.
                if arr.base is None:
                    arr.flags.writeable = False
                cols[c.name] = arr
        if not n:
            return 0
        with self._lock:
            gen0 = self._next_gen
            for k, v in cols.items():
                self._hot[k].append(v)
            self._hot_rows += n
            self._total_rows_written += n
            if self._hot_rows >= self.batch_rows:
                self._seal_full_locked()
            self._expire_locked()
            wm_after = self._total_rows_written
            new_sealed = None
            if self.on_seal is not None and self._next_gen > gen0:
                # seals append at the tail in gen order: walk back from the
                # end instead of scanning the whole ring (O(new batches),
                # not O(total sealed) per write)
                new_sealed = []
                for sb in reversed(self._sealed):
                    if sb.gen < gen0:
                        break
                    new_sealed.append(sb)
                new_sealed.reverse()
        # Durability hooks run OUTSIDE the lock (journal fsync and peer
        # sends must not serialize readers) but BEFORE the return — the
        # return IS the ack, and an acked row must already be journaled.
        # Thread model unchanged: one writer per table orders the appends.
        if self.journal is not None:
            from pixie_tpu_torch.table import journal as _journal

            self.journal.append(_journal.encode_write_record(
                self.name, self.relation, data, wm_after - n, n))
        if new_sealed:
            self.on_seal(self, new_sealed)
        return n

    def _take_hot_locked(self) -> dict[str, np.ndarray]:
        merged = {
            k: (np.concatenate(v) if len(v) != 1 else v[0]) if v else
            np.empty(0, dtype=STORAGE_DTYPE[self.relation.dtype(k)])
            for k, v in self._hot.items()
        }
        return merged

    def _seal_full_locked(self, limit: Optional[int] = None):
        """Seal every full batch_rows chunk in ONE concatenation pass.

        A bulk write of N rows seals N//batch_rows batches; concatenating the
        hot buffer per sealed batch (the old per-batch loop) re-copied the
        shrinking remainder every iteration — O(N^2/batch_rows) bytes.

        Sealed slices are VIEWS into the writer's arrays, not copies: fresh
        per-batch allocations run at page-fault speed (~1.5 GB/s measured vs
        14 GB/s reusing memory) and dominated the ingest path.  Two
        consequences, both bounded: (a) write() takes OWNERSHIP of the arrays
        passed in — callers must not mutate them afterwards (connectors build
        fresh arrays per transfer); (b) ring-buffer expiry frees a backing
        chunk only when its last sealed view dies, so transient
        over-retention is bounded by one write-chunk at the expiry frontier.
        """
        merged = self._take_hot_locked()
        take = self.batch_rows
        k = self._hot_rows // take
        if limit is not None:
            k = min(k, limit)
        for i in range(k):
            batch_cols = {
                c: v[i * take:(i + 1) * take] for c, v in merged.items()
            }
            rb = RowBatch(self.relation, batch_cols)
            sb = _SealedBatch(rb, self._next_row_id, self.time_col,
                              self._next_gen)
            self._next_gen += 1
            self._sealed.append(sb)
            self._sealed_bytes += sb.nbytes
            self._next_row_id += rb.num_rows
        sealed_rows = k * take
        self._hot = {
            c: [v[sealed_rows:]] if len(v) > sealed_rows else []
            for c, v in merged.items()
        }
        self._hot_rows -= sealed_rows

    def _expire_locked(self):
        # Ring-buffer semantics: oldest sealed batches fall off when over budget
        # (reference table.h expiry by table_size_limit).  With a cold tier
        # attached retention becomes DEMOTE then expire: the age/RAM-ceiling
        # pass runs first, and budget pressure spills the oldest RAM batch
        # to disk before any row is dropped.
        expired = False
        if self.cold is not None:
            expired = self.cold.manage_locked()
        while self._sealed and self._sealed_bytes + self._hot_bytes_locked() > self.max_bytes:
            if self.cold is not None and self.cold.demote_oldest_locked():
                continue
            sb = self._sealed.pop(0)
            if getattr(sb, "is_cold", False) and not sb.in_ram:
                # cold entries hold no RAM budget; dropping one is cold-tier
                # bookkeeping (file delete + in-memory carry for snapshots)
                self.cold.on_drop_locked(sb)
            else:
                self._sealed_bytes -= sb.nbytes
            self._expired_batches += 1
            expired = True
        if expired:
            # The cached snapshot still references every popped batch; drop
            # it now (not at the next cursor() call, which may never come for
            # an idle-but-written table) so expiry actually frees the memory.
            self._snap_cache = None
            # Same for device-pinned copies: the resident tier must not keep
            # expired batches in HBM (fully-expired entries free now; a
            # head-trim marks the entry for a lazy on-device rebase).  Cheap
            # bookkeeping only — no device ops on the writer thread.
            # (Imported here: the engine imports this module.)
            from pixie_tpu_torch.engine import resident

            resident.on_retention_trim(
                self.uid, self._sealed[0].gen if self._sealed else None)

    def _hot_bytes_locked(self) -> int:
        return sum(a.nbytes for arrs in self._hot.values() for a in arrs)

    # ------------------------------------------------------------------- read
    def cursor(
        self,
        start_time: int | None = None,
        stop_time: int | None = None,
        include_hot: bool = True,
    ) -> "Cursor":
        """Snapshot cursor over sealed batches (+ a padded snapshot of hot rows).

        The unbounded full-table snapshot (the shape every warm interactive
        query takes) is cached per table version: repeat queries over an
        unchanged table reuse ONE immutable Cursor object instead of
        re-listing batches and re-merging hot rows per query.  Time-bounded
        cursors are not cached (relative ranges change every call).
        """
        cacheable = start_time is None and stop_time is None and include_hot
        with self._lock:
            if cacheable:
                version = (self._next_row_id, self._hot_rows,
                           self._expired_batches)
                if self._snap_cache is not None \
                        and self._snap_cache[0] == version:
                    return self._snap_cache[1]
            sealed = list(self._sealed)
            hot = None
            if include_hot and self._hot_rows > 0:
                merged = self._take_hot_locked()
                hot = RowBatch(self.relation, merged)
            hot_row_id = self._next_row_id
        cur = Cursor(self, sealed, hot, hot_row_id, start_time, stop_time)
        if cacheable:
            with self._lock:
                if (self._next_row_id, self._hot_rows,
                        self._expired_batches) == version:
                    self._snap_cache = (version, cur)
        return cur

    def last_row_id(self) -> int:
        """Row id one past the newest row (streaming resume token source)."""
        with self._lock:
            return self._next_row_id + self._hot_rows

    def advance_row_frontier(self, row_id: int, allow_gap: bool = False) -> None:
        """Pre-advance an EMPTY table's row-id space to `row_id`: rows
        below it count as expired-before-restore.  Journal replay uses
        this when the journal head was pruned (PL_JOURNAL_MAX_MB), so the
        replayed tail keeps its ABSOLUTE row ids — peer-fetch coverage
        arithmetic and watermark accounting stay consistent across every
        consumer instead of silently renumbering rows from zero.

        `allow_gap=True` advances the frontier of a NON-empty table past
        its tail (hot side must be empty): restore uses it when cold
        segments were adopted but the journal head above them was pruned —
        the missing ids are rows that expired before the crash.  Sealed
        batches keep their own absolute ids, so the gap never shifts data."""
        with self._lock:
            if allow_gap:
                if self._hot_rows or int(row_id) < self._next_row_id:
                    raise InvalidArgument(
                        f"advance_row_frontier(allow_gap) on {self.name}: "
                        f"frontier {self._next_row_id} hot {self._hot_rows} "
                        f"target {row_id}")
                self._next_row_id = int(row_id)
                self._total_rows_written = int(row_id)
                return
            if (self._sealed or self._hot_rows
                    or self._total_rows_written):
                raise InvalidArgument(
                    f"advance_row_frontier on non-empty table {self.name}")
            self._next_row_id = int(row_id)
            self._total_rows_written = int(row_id)

    def adopt_cold_batches(self, entries) -> int:
        """Adopt restored cold-tier batch stubs (lifecycle.ColdTier.
        restore_into) into an EMPTY table, oldest first.  Entries must be
        contiguous in row-id space; adoption stops at the first gap (a
        lost middle segment must not splice disjoint row ranges into one
        ring).  Runs BEFORE journal replay, so replay's watermark
        idempotence skips the journal records these rows came from.
        Returns the number of entries adopted."""
        adopted = 0
        with self._lock:
            if self._sealed or self._hot_rows or self._total_rows_written:
                raise InvalidArgument(
                    f"adopt_cold_batches on non-empty table {self.name}")
            for e in entries:
                if adopted == 0:
                    self._next_row_id = e.row_id_start
                    self._total_rows_written = e.row_id_start
                elif e.row_id_start != self._next_row_id:
                    break
                e.gen = self._next_gen
                self._next_gen += 1
                self._sealed.append(e)
                self._next_row_id += e.num_rows
                self._total_rows_written += e.num_rows
                adopted += 1
            self._cold_rows_adopted = adopted
        return adopted

    def seal_hot(self) -> int:
        """Force-seal the hot remainder as ONE short sealed batch (fewer
        than batch_rows rows) — re-homing prep: a donor must get EVERY row
        into replicable sealed form before the shard map flips, and only
        sealed batches travel the replication channel.  The short batch is
        a normal sealed gen (device-cacheable, shipped via on_seal like any
        seal).  Returns rows sealed."""
        if self.on_seal is not None:
            raise Unimplemented(
                f"seal_hot on {self.name}: seal replication is not ported yet "
                "(ROADMAP Queue 1 item 6d, part 2)")
        with self._lock:
            n = self._hot_rows
            if n == 0:
                return 0
            merged = self._take_hot_locked()
            rb = RowBatch(self.relation, merged)
            sb = _SealedBatch(rb, self._next_row_id, self.time_col,
                              self._next_gen)
            self._next_gen += 1
            self._sealed.append(sb)
            self._sealed_bytes += sb.nbytes
            self._next_row_id += rb.num_rows
            self._hot = {c.name: [] for c in self.relation}
            self._hot_rows = 0
            self._snap_cache = None
            new_sealed = [sb]
        if self.on_seal is not None:
            self.on_seal(self, new_sealed)
        return n

    def first_row_id(self) -> int:
        """Row id of the oldest RETAINED row — the ring-buffer expiry
        frontier.  Monotone non-decreasing: expiry only pops sealed batches
        from the head, and hot rows (ids ≥ _next_row_id) never expire.
        Delta cursors (table.delta) compare their coverage against this to
        detect retention trimming past their watermark."""
        with self._lock:
            if self._sealed:
                return self._sealed[0].row_id_start
            return self._next_row_id

    def cursor_since(
        self,
        row_id: int,
        stop_row_id: int | None = None,
        start_time: int | None = None,
        stop_time: int | None = None,
    ) -> "Cursor":
        """Snapshot cursor over rows with row_id in [row_id, stop_row_id).

        The streaming executor's incremental read (reference: `streaming`
        MemorySource cursors persist their position, table.h:76-124): each
        poll scans only the appended delta.  Rows expired from the ring
        buffer are silently skipped (loss-by-design, as in the reference).
        Partially-overlapping sealed batches are sliced; slices carry gen
        None (not device-cacheable — their content is not a whole sealed gen).
        """
        with self._lock:
            hi = (
                stop_row_id
                if stop_row_id is not None
                else self._next_row_id + self._hot_rows
            )
            items: list[_SealedBatch] = []
            for sb in self._sealed:
                # metadata only — touching sb.batch here would decode every
                # cold segment on every streaming poll
                n = sb.num_rows
                lo_off = max(0, row_id - sb.row_id_start)
                hi_off = min(n, hi - sb.row_id_start)
                if hi_off <= 0 or lo_off >= n:
                    continue
                if lo_off == 0 and hi_off == n:
                    items.append(sb)
                else:
                    # partial overlap slices through sb.batch — for a cold
                    # entry this decodes under the lock, but only a delta
                    # scan whose watermark lands INSIDE an already-cold
                    # batch gets here (streaming reads the fresh tail)
                    rb = RowBatch(
                        self.relation,
                        {k: v[lo_off:hi_off] for k, v in sb.batch.columns.items()},
                    )
                    items.append(
                        _SealedBatch(rb, sb.row_id_start + lo_off, self.time_col, gen=None)
                    )
            hot = None
            hot_row_id = self._next_row_id
            if self._hot_rows > 0:
                lo_off = max(0, row_id - hot_row_id)
                hi_off = min(self._hot_rows, hi - hot_row_id)
                if hi_off > lo_off:
                    merged = self._take_hot_locked()
                    if lo_off > 0 or hi_off < self._hot_rows:
                        merged = {k: v[lo_off:hi_off] for k, v in merged.items()}
                    hot = RowBatch(self.relation, merged)
                    hot_row_id += lo_off
        return Cursor(self, items, hot, hot_row_id, start_time, stop_time,
                      is_delta=True, since_row_id=row_id)

    # ------------------------------------------------------------------ stats
    def stats(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "batches": len(self._sealed),
                "hot_rows": self._hot_rows,
                "rows_written": self._total_rows_written,
                "bytes": self._sealed_bytes + self._hot_bytes_locked(),
                "expired_batches": self._expired_batches,
                "dict_sizes": {k: d.size for k, d in self.dictionaries.items()},
                "cold": self.cold.stats() if self.cold is not None else None,
            }

    def nbytes(self) -> int:
        with self._lock:
            return (
                self._sealed_bytes
                + self._hot_bytes_locked()
                + sum(d.nbytes() for d in self.dictionaries.values())
            )


class Cursor:
    """Time-bounded batch iterator with snapshot isolation (reference table.h:76-124).

    Yields (RowBatch, row_id_start, gen). `gen` is None for the hot remainder batch
    (not device-cacheable); sealed batches carry a stable gen for device caching.
    Batch-level time pruning only — callers apply exact row-level time bounds as a
    mask (the executor folds it into the chain's filter).
    """

    def __init__(self, table, sealed, hot, hot_row_id, start_time, stop_time,
                 is_delta: bool = False, since_row_id: int = 0):
        self.table = table
        self.start_time = start_time
        self.stop_time = stop_time
        #: first row id this cursor can yield (0 = scans from the table head);
        #: the executor's key-uniques cache requires full coverage and only
        #: trusts cursors whose since_row_id is at/below its watermark.
        self.since_row_id = since_row_id
        #: row-id-bounded incremental scan (streaming): its feeds are read
        #: ONCE and must never enter the device feed cache — caching every
        #: poll's delta fills the cache with dead entries (measured: poll
        #: latency degrading 10x over a 100M-row stream)
        self.is_delta = is_delta
        #: item[0] is a RowBatch for RAM-resident data, or a cold-tier stub
        #: (lifecycle._ColdBatch) whose .batch decodes from disk — iteration
        #: materializes cold segments lazily, so building a cursor over a
        #: mostly-cold retention window stays O(metadata)
        self._items: list[tuple[object, int, int | None]] = []
        #: (min_time, max_time) per item, from seal-time metadata; None = unknown
        #: (hot remainder) — aligned with _items for O(batches) time_range().
        self._bounds: list[tuple[int, int] | None] = []
        #: valid rows per item, from metadata (a cold stub's num_rows):
        #: num_rows() and iter_meta() read them without touching a batch
        self._rows: list[int] = []
        cold: set[int] = set()
        for sb in sealed:
            if start_time is not None and sb.max_time is not None and sb.max_time < start_time:
                continue
            if stop_time is not None and sb.min_time is not None and sb.min_time >= stop_time:
                continue
            if getattr(sb, "is_cold", False) and not sb.in_ram:
                self._items.append((sb, sb.row_id_start, sb.gen))
                self._rows.append(sb.num_rows)
                cold.add(sb.gen)
            else:
                self._items.append((sb.batch, sb.row_id_start, sb.gen))
                self._rows.append(sb.batch.num_valid)
            self._bounds.append(
                (sb.min_time, sb.max_time) if sb.min_time is not None else None
            )
        #: gens that were on disk at snapshot time — the executor flushes
        #: feeds at cold↔RAM boundaries, serves these under the `cold` heat
        #: tier and keeps them out of the device feed caches
        self.cold_gens = frozenset(cold)
        if hot is not None:
            tc = table.time_col
            keep = True
            if tc is not None and hot.num_valid > 0:
                t = hot.columns[tc]
                if start_time is not None and t.max() < start_time:
                    keep = False
                if stop_time is not None and t.min() >= stop_time:
                    keep = False
            if keep:
                self._items.append((hot, hot_row_id, None))
                self._rows.append(hot.num_valid)
                self._bounds.append(None)

    def __iter__(self) -> Iterator[tuple[RowBatch, int, int | None]]:
        if not self.cold_gens:
            return iter(self._items)  # all-RAM: the zero-overhead seed path
        return self._iter_decoding()

    def _iter_decoding(self) -> Iterator[tuple[RowBatch, int, int | None]]:
        for obj, rid, gen in self._items:
            yield (obj if isinstance(obj, RowBatch) else obj.batch), rid, gen

    def iter_meta(self) -> Iterator[tuple[int, int, int | None]]:
        """(rows, row_id_start, gen) per item WITHOUT materializing data —
        the executor's feed-shape predictor sizes pad buckets from counts
        alone, so it must never decode cold segments."""
        for n, (_obj, rid, gen) in zip(self._rows, self._items):
            yield n, rid, gen

    def __len__(self) -> int:
        return len(self._items)

    def num_rows(self) -> int:
        return sum(self._rows)

    def time_range(self) -> tuple[int, int] | None:
        """(min, max) time over the snapshot, using seal-time bounds — only the
        hot remainder is scanned, so this is O(sealed batches + hot rows)."""
        tc = self.table.time_col
        if tc is None:
            return None
        t_min = t_max = None
        for (b, _rid, _gen), bounds in zip(self._items, self._bounds):
            if bounds is None:
                if not isinstance(b, RowBatch):
                    b = b.batch
                t = b.columns[tc][: b.num_valid]
                if not len(t):
                    continue
                mn, mx = int(t.min()), int(t.max())
            else:
                mn, mx = bounds
            t_min = mn if t_min is None else min(t_min, mn)
            t_max = mx if t_max is None else max(t_max, mx)
        if t_min is None:
            return None
        return t_min, t_max


class TableStore:
    """Name → Table map (reference src/table_store/table/table_store.h:79)."""

    def __init__(self):
        self._tables: dict[str, Table] = {}
        self._lock = threading.Lock()
        #: owning shard/agent identity, stamped by Agent / LocalCluster —
        #: the heat model (table/heat.py) labels per-shard access with it
        self.node_name = ""
        #: table-creation observers (durability wiring: a tracepoint table
        #: deployed after journal attach must start journaling too); called
        #: OUTSIDE the store lock with the new table
        self._observers: list = []
        #: schema epoch: bumped whenever the table SET changes (create/drop/
        #: add_table).  Compiled-plan caches key on this — a tracepoint
        #: deploying a new table must miss every plan compiled before it.
        #: Relations themselves are immutable, so the set is the schema.
        self.epoch = 0

    def create(self, name: str, relation: Relation, tablet_col: str | None = None, **kw):
        """Create a Table, or a TabletsGroup when tablet_col is given
        (reference TabletsGroup, table/tablets_group.h:34-56)."""
        with self._lock:
            if name in self._tables:
                raise InvalidArgument(f"table {name} already exists")
            if tablet_col is not None:
                from pixie_tpu_torch.table.tablets import TabletsGroup

                t = TabletsGroup(name, relation, tablet_col, **kw)
            else:
                t = Table(name, relation, **kw)
            self._tables[name] = t
            self.epoch += 1
        self._notify(t)
        return t

    def add_observer(self, fn) -> None:
        with self._lock:
            self._observers.append(fn)

    def clear_observers(self) -> None:
        with self._lock:
            self._observers.clear()

    def _notify(self, table) -> None:
        with self._lock:
            obs = list(self._observers)
        for fn in obs:
            fn(table)

    def add_table(self, table: Table):
        with self._lock:
            self._tables[table.name] = table
            self.epoch += 1
        self._notify(table)

    def drop(self, name: str) -> None:
        with self._lock:
            if self._tables.pop(name, None) is not None:
                self.epoch += 1

    def table(self, name: str) -> Table:
        t = self._tables.get(name)
        if t is None:
            raise NotFound(f"table {name!r} not found (have {sorted(self._tables)})")
        return t

    def has(self, name: str) -> bool:
        return name in self._tables

    def names(self) -> list[str]:
        return sorted(self._tables)

    def relation(self, name: str) -> Relation:
        return self.table(name).relation

    def schemas(self) -> dict[str, Relation]:
        return {n: t.relation for n, t in self._tables.items()}

    def stats(self) -> list[dict]:
        return [t.stats() for t in self._tables.values()]
