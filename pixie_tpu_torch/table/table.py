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

Not ported yet, and refused with Unimplemented where a caller reaches them:
the durable ingest journal and seal replication (the host-layer slice),
tablets (the host-layer slice) and the compressed cold tier (the host-layer slice).  A retention trim
notifies the device-resident tier (engine/resident.py), which frees or
rebases the table's pinned device buffers.

Thread model: one writer per table (the collector poll loop) + concurrent readers;
a lock guards the batch list and builder swap, matching the reference's spinlocked
hot/cold partitions (table.h:174-190, ABSL_GUARDED_BY annotations).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Iterator

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
        #: durable ingest journal and seal observer (replication) hooks of the
        #: reference; the port refuses a table that has either set (the host-layer slice)
        self.journal = None
        self.on_seal = None
        self._sealed: list[_SealedBatch] = []
        self._hot: dict[str, list[np.ndarray]] = {c.name: [] for c in relation}
        self._hot_rows = 0
        self._next_row_id = 0
        self._next_gen = 0
        self._sealed_bytes = 0
        self._expired_batches = 0
        self._total_rows_written = 0
        #: cached full-table snapshot: (version, Cursor).  The version key
        #: covers every way the snapshot can change — appended rows/seals
        #: (_next_row_id, _hot_rows) and retention trimming (_expired_batches).
        self._snap_cache: tuple | None = None

    # ------------------------------------------------------------------ write
    def write(self, data: dict) -> int:
        """Append a record batch given as {col: sequence}. Returns rows written.

        Reference: Table::WriteRowBatch / TransferRecordBatch (table.h:152-155).
        Encodes dict-typed columns; seals full `batch_rows` chunks.

        OWNERSHIP: write() takes ownership of any numpy arrays passed in —
        matching-dtype arrays are aliased, not copied, and sealed batches are
        views into them.  Non-dict ndarray columns are marked read-only at
        write time so a caller's later mutation raises.
        """
        if self.journal is not None or self.on_seal is not None:
            raise Unimplemented(
                f"write to {self.name}: the ingest journal and seal "
                "replication are not ported yet (the host-layer slice)")
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
                if arr.base is None:
                    arr.flags.writeable = False
                cols[c.name] = arr
        if not n:
            return 0
        with self._lock:
            for k, v in cols.items():
                self._hot[k].append(v)
            self._hot_rows += n
            self._total_rows_written += n
            if self._hot_rows >= self.batch_rows:
                self._seal_full_locked()
            self._expire_locked()
        return n

    def _take_hot_locked(self) -> dict[str, np.ndarray]:
        return {
            k: (np.concatenate(v) if len(v) != 1 else v[0]) if v else
            np.empty(0, dtype=STORAGE_DTYPE[self.relation.dtype(k)])
            for k, v in self._hot.items()
        }

    def _seal_full_locked(self):
        """Seal every full batch_rows chunk in ONE concatenation pass.  Sealed
        slices are VIEWS into the writer's arrays, not copies (see write's
        ownership note)."""
        merged = self._take_hot_locked()
        take = self.batch_rows
        k = self._hot_rows // take
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
        # (reference table.h expiry by table_size_limit).
        expired = False
        while self._sealed and self._sealed_bytes + self._hot_bytes_locked() > self.max_bytes:
            sb = self._sealed.pop(0)
            self._sealed_bytes -= sb.nbytes
            self._expired_batches += 1
            expired = True
        if expired:
            # The cached snapshot still references every popped batch; drop
            # it now so expiry actually frees the memory.
            self._snap_cache = None
            # Same for device-pinned copies: fully expired resident entries
            # free now; a head trim marks the entry for a lazy rebase on the
            # device.  Bookkeeping only, no device work on the writer
            # thread.  (Imported here: the engine imports this module.)
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
        """Snapshot cursor over sealed batches (+ a snapshot of hot rows).

        The unbounded full-table snapshot is cached per table version: repeat
        queries over an unchanged table reuse ONE immutable Cursor object.
        Time-bounded cursors are not cached.
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
                hot = RowBatch(self.relation, self._take_hot_locked())
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

    def first_row_id(self) -> int:
        """Row id of the oldest RETAINED row — the ring-buffer expiry frontier."""
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

        Rows expired from the ring buffer are silently skipped (loss-by-design,
        as in the reference).  Partially-overlapping sealed batches are sliced;
        slices carry gen None.
        """
        with self._lock:
            hi = (
                stop_row_id
                if stop_row_id is not None
                else self._next_row_id + self._hot_rows
            )
            items: list[_SealedBatch] = []
            for sb in self._sealed:
                n = sb.num_rows
                lo_off = max(0, row_id - sb.row_id_start)
                hi_off = min(n, hi - sb.row_id_start)
                if hi_off <= 0 or lo_off >= n:
                    continue
                if lo_off == 0 and hi_off == n:
                    items.append(sb)
                else:
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

    Yields (RowBatch, row_id_start, gen). `gen` is None for the hot remainder batch;
    sealed batches carry a stable gen.  Batch-level time pruning only — callers
    apply exact row-level time bounds as a mask (the executor folds it into the
    chain's filter).
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
        #: row-id-bounded incremental scan (streaming)
        self.is_delta = is_delta
        self._items: list[tuple[RowBatch, int, int | None]] = []
        #: (min_time, max_time) per item, from seal-time metadata; None = unknown
        #: (hot remainder) — aligned with _items for O(batches) time_range().
        self._bounds: list[tuple[int, int] | None] = []
        for sb in sealed:
            if start_time is not None and sb.max_time is not None and sb.max_time < start_time:
                continue
            if stop_time is not None and sb.min_time is not None and sb.min_time >= stop_time:
                continue
            self._items.append((sb.batch, sb.row_id_start, sb.gen))
            self._bounds.append(
                (sb.min_time, sb.max_time) if sb.min_time is not None else None
            )
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
                self._bounds.append(None)

    def __iter__(self) -> Iterator[tuple[RowBatch, int, int | None]]:
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def num_rows(self) -> int:
        """Rows in the snapshot (the executor routes by it)."""
        return sum(b.num_valid for b, _, _ in self._items)

    def time_range(self) -> tuple[int, int] | None:
        """(min, max) time over the snapshot, using seal-time bounds — only the
        hot remainder is scanned, so this is O(sealed batches + hot rows)."""
        tc = self.table.time_col
        if tc is None:
            return None
        t_min = t_max = None
        for (b, _rid, _gen), bounds in zip(self._items, self._bounds):
            if bounds is None:
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
        #: schema epoch: bumped whenever the table SET changes (create/drop/
        #: add_table).
        self.epoch = 0

    def create(self, name: str, relation: Relation, tablet_col: str | None = None, **kw):
        """Create a Table (tabletized tables are not ported yet: the host-layer slice)."""
        if tablet_col is not None:
            raise Unimplemented(
                f"table {name}: tablets are not ported yet (the host-layer slice)")
        with self._lock:
            if name in self._tables:
                raise InvalidArgument(f"table {name} already exists")
            t = Table(name, relation, **kw)
            self._tables[name] = t
            self.epoch += 1
        return t

    def add_table(self, table: Table):
        with self._lock:
            self._tables[table.name] = table
            self.epoch += 1

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
