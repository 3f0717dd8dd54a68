"""Per-table append-only ingest journal: acknowledged rows survive restarts.

The reference Pixie deliberately loses telemetry on pod death (SURVEY.md §5
— only control state is durable).  This module is the data-plane half of the
durability story: every acknowledged `Table.write` appends one CRC-framed
record to a segment file under `PL_DATA_DIR/<node>/journal/<table>/` BEFORE
the write returns, so a restarted agent replays the journal into a fresh
store and recovers every row it ever acked.  Replication of sealed batches
(services/replication.py) covers the complementary failure — the journal
directory itself lost with the pod.

On-disk format, designed for torn-write recovery:

    segment file  = record*            (seg-00000001.jrn, rotated by size)
    record        = MAGIC "PXJ1" | u32 payload_len | u32 crc32(payload)
                    | payload
    payload       = a services.wire host_batch frame whose meta carries
                    {"t": table, "wm": rows-written-before-this-record,
                     "n": rows}

A record is valid iff its magic, length (in-file), and CRC all check out.
Replay stops at the FIRST invalid record — a torn tail from a crash mid-
append — and `recover()` truncates the segment there, so the next append
extends a clean file.  Records carry the table's pre-write row watermark
(`wm`): replaying into a store that already holds rows past `wm` skips the
record, which makes replay idempotent (re-attach to a live store is a
no-op) and makes re-ingest after the watermark safe.

Dictionary-encoded columns are journaled as VALUES (a per-record dictionary
rides the frame), never as codes into the table's live dictionary — replay
into a fresh table re-encodes deterministically, so code spaces and sealed
batch contents come back bit-identical.

Copied from the reference package (pixie_tpu/table/journal.py); the
segments are byte for byte the reference's.  `decode_columns` hands STRING
columns back as numpy arrays where that gives the same codes (replay's
Table.write then encodes them on the native path).
"""
from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Optional

import numpy as np

from pixie_tpu_torch import flags, metrics
from pixie_tpu_torch.services import wire
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.types import STORAGE_DTYPE, DataType as DT, Relation, is_dict_encoded

flags.define_str(
    "PL_DATA_DIR", "",
    "base directory for the durable data plane (per-table ingest journals, "
    "matview state snapshots); empty disables durability entirely — the "
    "seed in-memory behavior, bit-identical")
flags.define_str(
    "PL_JOURNAL_FSYNC", "always",
    "journal durability policy: 'always' fsyncs every appended record "
    "before the write acks (no acked row can be lost to a power cut), "
    "'batch' fsyncs every %d records and on rotate/close (bounded loss "
    "window, much cheaper), 'off' leaves flushing to the OS" % 64)
flags.define_int(
    "PL_JOURNAL_SEG_MB", 8,
    "journal segment rotation size; smaller segments bound the torn-tail "
    "rescan on restart and let the byte-budget prune finer")
flags.define_int(
    "PL_JOURNAL_MAX_MB", 512,
    "per-table journal byte budget: on rotation the OLDEST sealed segments "
    "delete until under budget, bounding disk use and restart replay time "
    "on long-lived ring-buffer tables.  Replay tolerates the pruned head "
    "by advancing the fresh store's row frontier (absolute ids preserved); "
    "size the budget >= the table's retention bytes so pruned rows are "
    "also retention-expired rows.  0 = unbounded")

REC_MAGIC = b"PXJ1"
_REC_HDR = struct.Struct("<4sII")
#: px_journal_fsync_seconds bucket bounds: sub-ms (page-cache flush) through
#: a stalled disk — the PL_JOURNAL_FSYNC=always write-ack tax, measured
FSYNC_BOUNDS_S = (0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.25, 1.0)
#: `batch` policy fsync cadence (also flushed on rotate and close)
FSYNC_BATCH_RECORDS = 64
#: hard ceiling on one record's payload (a corrupt length field must not
#: drive a giant allocation during the recovery scan)
MAX_RECORD_BYTES = 1 << 30


# ------------------------------------------------------------------ records


def _timed_fsync(fh) -> None:
    """fsync + latency histogram: every acked write pays this under the
    'always' policy, so its tail IS the ingest durability tax."""
    import time as _time

    t0 = _time.perf_counter()
    os.fsync(fh.fileno())
    metrics.histogram_observe(
        "px_journal_fsync_seconds", _time.perf_counter() - t0,
        FSYNC_BOUNDS_S,
        help_="journal fsync latency (the write-ack durability tax)")


class _Rec:  # duck-typed HostBatch surface for wire.encode_host_batch
    __slots__ = ("dtypes", "dicts", "cols")


def encode_columns(relation: Relation, data: dict, meta: dict) -> bytes:
    """Raw column dict → self-contained wire host_batch payload.  Dict-typed
    columns get a per-record dictionary built from their OWN values, so the
    payload never references live store state (replay/replication into a
    different process re-encodes deterministically)."""
    rec = _Rec()
    rec.dtypes, rec.dicts, rec.cols = {}, {}, {}
    for c in relation:
        rec.dtypes[c.name] = c.data_type
        v = data[c.name]
        if is_dict_encoded(c.data_type):
            d = Dictionary()
            rec.cols[c.name] = d.encode(v)
            rec.dicts[c.name] = d
        else:
            rec.cols[c.name] = np.asarray(v, dtype=STORAGE_DTYPE[c.data_type])
    return wire.encode_host_batch(rec, meta)


def encode_write_record(table_name: str, relation: Relation, data: dict,
                        wm: int, n: int) -> bytes:
    """One acknowledged write → a journal payload carrying the table's
    pre-write row watermark (the idempotence key for replay)."""
    return encode_columns(
        relation, data, {"t": table_name, "wm": int(wm), "n": int(n)})


def decode_columns(hb) -> dict:
    """Decoded host_batch payload → {col: raw values ready for
    Table.write}.  Dict-typed columns decode back to their values — the ONE
    place this idiom lives; journal replay (and, with the services,
    replication) decodes through it, so the bit-equal re-encode contract has
    a single implementation to keep correct.  A STRING column whose codes
    are all valid and whose values a numpy 'U' array holds exactly (no
    trailing NUL) comes back as that array, gathered from the record's
    dictionary: Table.write encodes it on the native path, to the codes the
    value list would get (first occurrence order), at a fraction of the host
    time; any other dict-typed column comes back as a value list."""
    out: dict = {}
    for name, arr in hb.cols.items():
        if name in hb.dicts and is_dict_encoded(hb.dtypes[name]):
            d = hb.dicts[name]
            vals = _values_array(d, arr) if hb.dtypes[name] == DT.STRING else None
            out[name] = d.decode(arr) if vals is None else vals
        else:
            out[name] = arr
    return out


def _values_array(d: Dictionary, codes) -> Optional[np.ndarray]:
    """`d.decode(codes)` as a numpy 'U' array, or None where the array
    would not hold the same values (a code out of range decodes to None; a
    trailing NUL would be dropped)."""
    vals = d.values()
    codes = np.asarray(codes)
    if not vals or (len(codes) and (int(codes.min()) < 0 or int(codes.max()) >= len(vals))):
        return None
    if not all(isinstance(v, str) and not v.endswith("\x00") for v in vals):
        return None
    return np.asarray(vals, dtype=np.str_)[codes]


def recode_first_seen(codes: np.ndarray, dictionary: Dictionary):
    """Codes into `dictionary` → (codes, Dictionary) of a fresh dictionary
    holding their values in first-occurrence order: exactly
    `d = Dictionary(); d.encode(dictionary.decode(codes))`, computed on the
    codes (a code and its value are one to one), so no value list is
    materialized.  None where a code is out of range (it decodes to None)."""
    codes = np.asarray(codes)
    size = dictionary.size
    if len(codes) and (int(codes.min()) < 0 or int(codes.max()) >= size):
        return None
    d = Dictionary()
    if not len(codes):
        return np.empty(0, dtype=np.int32), d
    uniq, first_idx, inverse = np.unique(codes, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    d.encode([dictionary.value(int(c)) for c in uniq[order]])
    rank = np.empty(len(uniq), dtype=np.int32)
    rank[order] = np.arange(len(uniq), dtype=np.int32)
    return rank[inverse.reshape(-1)], d


def decode_write_record(payload: bytes) -> tuple[dict, dict]:
    """payload → (meta {"t","wm","n"}, Table.write-ready column dict)."""
    kind, hb = wire.decode_frame(payload)
    if kind != "host_batch":
        from pixie_tpu_torch.status import InvalidArgument

        raise InvalidArgument(f"journal: unexpected record kind {kind!r}")
    return hb.wire_meta, decode_columns(hb)


def pack_record(payload: bytes) -> bytes:
    return _REC_HDR.pack(REC_MAGIC, len(payload),
                         zlib.crc32(payload) & 0xFFFFFFFF) + payload


def scan_segment(path: str) -> tuple[list[bytes], int, bool]:
    """Read one segment → (payloads, valid_bytes, clean).  Stops at the
    first invalid record (bad magic / length past EOF / CRC mismatch);
    `clean` is False when trailing bytes remain past the last valid
    record — the torn tail `recover()` truncates."""
    payloads: list[bytes] = []
    with open(path, "rb") as f:
        raw = f.read()
    off = 0
    total = len(raw)
    while off + _REC_HDR.size <= total:
        magic, n, crc = _REC_HDR.unpack_from(raw, off)
        if magic != REC_MAGIC or n > MAX_RECORD_BYTES:
            break
        end = off + _REC_HDR.size + n
        if end > total:
            break  # partial record: a write torn by the crash
        payload = raw[off + _REC_HDR.size:end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            break
        payloads.append(payload)
        off = end
    return payloads, off, off == total


class TableJournal:
    """Append/replay for ONE table's journal directory."""

    def __init__(self, dir_path: str):
        self.dir = dir_path
        os.makedirs(self.dir, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = None
        self._fh_bytes = 0
        self._since_fsync = 0
        #: () -> int: extra durable bytes (the table's cold-tier segments)
        #: charged against PL_JOURNAL_MAX_MB — demoted data already lives
        #: on disk once, so the replay window shrinks by what the cold tier
        #: holds instead of double-holding it (set by attach_store)
        self.extra_disk = None
        segs = self.segments()
        self._seg_no = (int(os.path.basename(segs[-1])[4:12]) if segs else 0)

    # ------------------------------------------------------------- layout
    def segments(self) -> list[str]:
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith("seg-") and n.endswith(".jrn"))
        except FileNotFoundError:
            return []
        return [os.path.join(self.dir, n) for n in names]

    def _seg_path(self, no: int) -> str:
        return os.path.join(self.dir, f"seg-{no:08d}.jrn")

    def disk_usage(self) -> tuple[int, int]:
        """(bytes, segments) on disk — the PL_JOURNAL_MAX_MB pruning
        pressure, surfaced via /healthz detail and storage_state rows."""
        nbytes = nsegs = 0
        for p in self.segments():
            try:
                nbytes += os.path.getsize(p)
            except OSError:
                continue
            nsegs += 1
        return nbytes, nsegs

    # ------------------------------------------------------------ recover
    def recover(self) -> int:
        """Truncate a torn tail on the NEWEST segment (older segments were
        sealed by rotation; damage there is a gap, not a tail).  Returns
        bytes truncated."""
        segs = self.segments()
        if not segs:
            return 0
        _, valid, clean = scan_segment(segs[-1])
        if clean:
            return 0
        dropped = os.path.getsize(segs[-1]) - valid
        with open(segs[-1], "r+b") as f:
            f.truncate(valid)
        metrics.counter_inc(
            "px_journal_truncated_bytes_total", float(dropped),
            help_="torn-tail bytes truncated during journal recovery")
        return dropped

    def replay(self) -> list[bytes]:
        """Every valid payload across segments in order.  A dirty NON-last
        segment means later records lost their contiguity guarantee —
        replay stops there (counted) rather than apply rows past a hole."""
        out: list[bytes] = []
        segs = self.segments()
        for i, path in enumerate(segs):
            payloads, _, clean = scan_segment(path)
            out.extend(payloads)
            if not clean and i != len(segs) - 1:
                metrics.counter_inc(
                    "px_journal_gap_segments_total",
                    help_="journal segments with mid-file corruption; "
                          "replay stopped at the hole")
                break
        return out

    # ------------------------------------------------------------- append
    def append(self, payload: bytes) -> None:
        rec = pack_record(payload)
        policy = str(flags.get("PL_JOURNAL_FSYNC")).strip().lower()
        seg_bytes = max(int(flags.get("PL_JOURNAL_SEG_MB")), 1) << 20
        with self._lock:
            if self._fh is None:
                if self._seg_no == 0:
                    self._seg_no = 1
                path = self._seg_path(self._seg_no)
                self._fh = open(path, "ab")
                self._fh_bytes = self._fh.tell()
            elif self._fh_bytes >= seg_bytes:
                self._rotate_locked()
            self._fh.write(rec)
            self._fh_bytes += len(rec)
            self._fh.flush()
            self._since_fsync += 1
            if policy == "always" or (policy == "batch"
                                      and self._since_fsync
                                      >= FSYNC_BATCH_RECORDS):
                _timed_fsync(self._fh)
                self._since_fsync = 0
        metrics.counter_inc("px_journal_appends_total",
                            help_="journal records appended")
        metrics.counter_inc("px_journal_bytes_total", float(len(rec)),
                            help_="journal bytes appended (framed)")

    def _rotate_locked(self) -> None:
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._seg_no += 1
        self._fh = open(self._seg_path(self._seg_no), "ab")
        self._fh_bytes = 0
        self._since_fsync = 0
        self._prune_locked()

    def _prune_locked(self) -> None:
        """Delete the oldest sealed segments while over the byte budget —
        without this a long-lived agent's journal (and its restart replay
        time) grows without bound.  The open segment never prunes."""
        budget = int(flags.get("PL_JOURNAL_MAX_MB")) << 20
        if budget <= 0:
            return
        segs = self.segments()
        sizes = {p: os.path.getsize(p) for p in segs}
        total = sum(sizes.values())
        if self.extra_disk is not None:
            try:
                total += int(self.extra_disk())
            except Exception:
                pass
        for p in segs[:-1]:
            if total <= budget:
                break
            try:
                os.remove(p)
            except OSError:
                break
            total -= sizes[p]
            metrics.counter_inc(
                "px_journal_pruned_segments_total",
                help_="journal segments deleted by the PL_JOURNAL_MAX_MB "
                      "budget (head rows age out of replay coverage)")

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._since_fsync = 0

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.flush()
                os.fsync(self._fh.fileno())
                self._fh.close()
                self._fh = None


# ------------------------------------------------------------- store wiring


def non_durable_tables() -> set:
    """Tables excluded from journaling AND replication: self-telemetry is
    deliberately not durable (the reference's split — control state
    persists, telemetry does not), and journaling the spans table would
    charge every query's span flush an fsync."""
    from pixie_tpu_torch import trace

    return {trace.SPANS_TABLE}


def node_dir(node: str) -> Optional[str]:
    """PL_DATA_DIR/<node>, or None when durability is disabled."""
    base = str(flags.get("PL_DATA_DIR")).strip()
    if not base:
        return None
    return os.path.join(base, node)


def _journal_dir(ndir: str, table_name: str) -> str:
    return os.path.join(ndir, "journal", table_name)


def _write_schema(jdir: str, table) -> None:
    path = os.path.join(jdir, "schema.json")
    if os.path.exists(path):
        return
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"relation": table.relation.to_dict(),
                   "batch_rows": table.batch_rows,
                   "max_bytes": table.max_bytes}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def replay_table(table, journal: TableJournal) -> dict:
    """Apply every journaled record to `table` idempotently: a record whose
    watermark precedes rows already present is skipped; a record AHEAD of
    the store (a hole) stops replay — applying past a hole would fabricate
    row ids.  Must run BEFORE table.journal is attached (replayed writes
    must not re-journal)."""
    assert table.journal is None, "replay with an attached journal re-appends"
    applied = rows = skipped = 0
    first = True
    for payload in journal.replay():
        meta, data = decode_write_record(payload)
        if first:
            first = False
            wm0 = int(meta["wm"])
            if table._total_rows_written == 0 and wm0 > 0:
                # pruned head (PL_JOURNAL_MAX_MB): advance the FRESH
                # store's frontier so the replayed tail keeps ABSOLUTE row
                # ids — rows below it count as expired-before-restore
                # (size the budget ≥ the table's retention bytes and they
                # are also retention-expired).  Watermarks stay absolute,
                # so peer-fetch coverage arithmetic stays consistent.
                table.advance_row_frontier(wm0)
                metrics.counter_inc(
                    "px_journal_pruned_head_replays_total",
                    help_="replays that began past a pruned journal head")
            elif (getattr(table, "_cold_rows_adopted", 0)
                  and table._hot_rows == 0
                  and 0 < table._total_rows_written < wm0):
                # cold segments restored BELOW a pruned journal head: the
                # ids between the cold tail and the journal head are rows
                # that expired before the crash (the prune budget charges
                # cold bytes via extra_disk, so pruning past live rows
                # requires budget < retention, same contract as above).
                # Bridge the gap so the tail keeps absolute ids; without
                # this the wm>have check below reads a legitimate pruned
                # head as a hole and drops the whole journal tail.
                table.advance_row_frontier(wm0, allow_gap=True)
                metrics.counter_inc(
                    "px_journal_pruned_head_replays_total",
                    help_="replays that began past a pruned journal head")
        have = table._total_rows_written
        wm, n = int(meta["wm"]), int(meta["n"])
        if wm + n <= have:
            skipped += 1
            continue
        if wm > have:
            metrics.counter_inc(
                "px_journal_replay_holes_total",
                help_="journal replays stopped at a row-id hole")
            break
        off = have - wm
        if off:
            # partial overlap (store already holds this record's head —
            # e.g. a caller pre-populated rows before attach): apply only
            # the missing tail, mirroring replication.fetch_missing
            data = {c: v[off:] for c, v in data.items()}
        table.write(data)
        applied += 1
        rows += n - off
    if rows:
        metrics.counter_inc(
            "px_journal_replayed_rows_total", float(rows),
            help_="rows restored into tables by journal replay")
    return {"applied": applied, "rows": rows, "skipped": skipped}


def attach_store(store, ndir: str) -> dict:
    """Recover + replay + attach journals for every plain Table in `store`
    (and tables found only on disk — recreated from their schema.json),
    then journal every future write.  New tables created later (tracepoint
    deploys) attach via a store observer.  Returns replay stats."""
    from pixie_tpu_torch.table import lifecycle as _lifecycle  # local: import cycle
    from pixie_tpu_torch.table.table import Table, TableStore  # local: import cycle

    assert isinstance(store, TableStore)
    stats = {"tables": 0, "applied": 0, "rows": 0, "truncated": 0,
             "cold_restored": 0}
    jroot = os.path.join(ndir, "journal")
    os.makedirs(jroot, exist_ok=True)
    # tables known only to the journal (a fresh store after pod loss):
    # recreate from the persisted schema before replay
    for name in sorted(os.listdir(jroot)):
        spath = os.path.join(jroot, name, "schema.json")
        if store.has(name) or not os.path.exists(spath):
            continue
        with open(spath) as f:
            meta = json.load(f)
        store.create(name, Relation.from_dict(meta["relation"]),
                     batch_rows=int(meta["batch_rows"]),
                     max_bytes=int(meta["max_bytes"]))
    skip = non_durable_tables()
    for name in store.names():
        t = store._tables.get(name)
        if not isinstance(t, Table) or t.journal is not None or name in skip:
            continue
        jdir = _journal_dir(ndir, name)
        j = TableJournal(jdir)
        stats["truncated"] += j.recover()
        # cold tier restores BEFORE replay: replay's watermark idempotence
        # then skips the journal records the adopted cold rows came from
        stats["cold_restored"] += _lifecycle.attach_table(t, ndir)
        r = replay_table(t, j)
        stats["applied"] += r["applied"]
        stats["rows"] += r["rows"]
        _write_schema(jdir, t)
        t.journal = j
        if t.cold is not None:
            j.extra_disk = t.cold.disk_usage_bytes
        stats["tables"] += 1

    def _on_table(table) -> None:
        if (isinstance(table, Table) and table.journal is None
                and table.name not in non_durable_tables()):
            jdir = _journal_dir(ndir, table.name)
            j = TableJournal(jdir)
            j.recover()
            _lifecycle.attach_table(table, ndir)
            replay_table(table, j)
            _write_schema(jdir, table)
            table.journal = j
            if table.cold is not None:
                j.extra_disk = table.cold.disk_usage_bytes

    store.add_observer(_on_table)
    return stats


def detach_store(store) -> None:
    """Close journal handles and stop journaling (same-process restarts
    reopen the files; two live handles on one segment would interleave)."""
    from pixie_tpu_torch.table.table import Table

    store.clear_observers()
    for name in store.names():
        t = store._tables.get(name)
        if isinstance(t, Table) and t.journal is not None:
            j, t.journal = t.journal, None
            j.close()
