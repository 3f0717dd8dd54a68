"""Data lifecycle: the compressed on-disk cold tier of the table store.

The seed retention model keeps every sealed batch in host RAM until the
ring-buffer byte budget drops it — fine for a short-window demo, fatal for
a retention window larger than host RAM.  This module is the demotion half
of the fleet-scale data lifecycle (with shard re-homing, services/): sealed batches that age
past ``PL_COLD_AFTER_S`` (or that push the table's sealed RAM over
``PL_COLD_MAX_HOT_MB``) are **demoted** into columnar-compressed segments
on disk, and retention becomes *demote then expire* — the ring-buffer
budget spills the oldest batch to disk instead of dropping its rows.

On-disk format (one file per demoted batch, under
``PL_DATA_DIR/<node>/cold/<table>/b-<row_id_start>.pxc``):

    file    = journal.pack_record(payload)     (the journal's CRC framing —
                                                a torn demote is detected and
                                                discarded at restore)
    payload = MAGIC "PXC1" | u32 hdr_len | hdr JSON | blob
    hdr     = {rid, n, mn, mx, raw, codec, flen}  (row ids, time bounds,
              in-RAM bytes, codec name, uncompressed frame length)
    blob    = wire._compress(codec, frame)     (the PL_WIRE_COMPRESS codecs,
              reused; stored raw when incompressible)
    frame   = journal.encode_columns(...)      (dict columns as VALUES with a
              per-record dictionary — decode re-encodes through the table's
              append-only dictionaries, so codes come back bit-identical)

Serving is decode-on-read: a cold batch stays in the table's sealed list as
a ``_ColdBatch`` stub (same duck-type surface as ``_SealedBatch``), cursors
carry it lazily, and the executor's streaming ``_feed`` decodes it when the
scan actually reaches it — counted as the ``cold`` serving tier in the heat
model, never entering the resident/HBM feed caches.  Batches read
``PL_COLD_PROMOTE_READS`` times promote back to RAM (heat-driven), and the
oldest cold segments expire when ``PL_COLD_MAX_DISK_MB`` is exceeded.

Crash safety: demote writes are fsynced tmp+rename, so a cold file either
fully exists or is a discarded torn write; the journal's byte-budget prune
counts cold bytes (``TableJournal.extra_disk``), and restore order is
cold-restore-then-journal-replay, with the journal's watermark idempotence
skipping rows the cold tier already holds — no double-hold, no drops.

``PL_COLD_TIER=0`` (the default) never touches any of this: no stubs are
created, every code path is gated, and behavior is bit-identical to the
seed paths.  Existing cold files still restore with the flag off (data
recovery beats configuration), but no further demotion happens.

Copied from the reference package (pixie_tpu/table/lifecycle.py); the
cold files are byte for byte the reference's.  The port's demote builds each
record's dictionary from the batch's codes (`journal.recode_first_seen`)
and its decode maps the record's codes through a dictionary LUT, neither
materializing the values; the executor uploads a decoded batch through
`_feed`'s pinned copy and never caches it.
"""
from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Optional

import numpy as np

from pixie_tpu_torch import flags, metrics
from pixie_tpu_torch.services import wire
from pixie_tpu_torch.status import InvalidArgument
from pixie_tpu_torch.table import journal as _journal
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.table.row_batch import RowBatch
from pixie_tpu_torch.types import STORAGE_DTYPE, is_dict_encoded

flags.define_int(
    "PL_COLD_TIER", 0,
    "master switch for the compressed on-disk cold tier: 1 demotes cold "
    "sealed batches to PL_DATA_DIR/<node>/cold/<table>/ and serves them "
    "decode-on-read; 0 (default) is bit-identical to the all-RAM seed "
    "behavior.  Requires PL_DATA_DIR", live=True)
flags.define_float(
    "PL_COLD_AFTER_S", 600.0,
    "age-driven demotion: a sealed batch older than this (seconds since "
    "seal) moves to the cold tier on the next write's retention pass; "
    "<=0 disables age-driven demotion (size-driven only)", live=True)
flags.define_int(
    "PL_COLD_MAX_HOT_MB", 0,
    "per-table sealed-RAM ceiling (MB): when sealed bytes exceed it the "
    "oldest RAM-resident batches demote to the cold tier until under; "
    "also the promotion headroom gate.  0 = no ceiling (age-driven only)",
    live=True)
flags.define_int(
    "PL_COLD_MAX_DISK_MB", 0,
    "per-table cold-tier disk budget (MB): the oldest cold segments expire "
    "(rows leave retention) when exceeded — 'demote then expire'.  0 = "
    "unbounded", live=True)
flags.define_int(
    "PL_COLD_PROMOTE_READS", 3,
    "heat-driven promotion: a cold batch decoded this many times promotes "
    "back to RAM (subject to the PL_COLD_MAX_HOT_MB headroom gate); "
    "0 disables promotion", live=True)

COLD_MAGIC = b"PXC1"
_COLD_HDR = struct.Struct("<4sI")

#: pxlint lock-discipline: ColdTier's *_locked members run under the OWNING
#: TABLE's mutex (the tier has no lock of its own — list surgery on
#: table._sealed and the byte accounting must be atomic with seal/expiry)
_pxlint_locks_ = {
    "manage_locked": "._lock",
    "demote_oldest_locked": "._lock",
    "on_drop_locked": "._lock",
    "_demote_entry_locked": "._lock",
    "_first_ram_index_locked": "._lock",
}


def enabled() -> bool:
    return int(flags.get("PL_COLD_TIER")) != 0


def cold_dir(ndir: str, table_name: str) -> str:
    return os.path.join(ndir, "cold", table_name)


def _codec() -> str:
    """Cold segments reuse the PL_WIRE_COMPRESS codec choice; unlike the
    wire (where compression is opt-in), cold storage defaults to zlib —
    an uncompressed cold tier defeats its purpose."""
    cfg = wire._compress_cfg()
    return cfg[0] if cfg else "zlib"


class _ColdBatch:
    """A demoted sealed batch: same duck-type surface as
    table._SealedBatch (row_id_start / min_time / max_time / nbytes / gen /
    num_rows) but ``batch`` decodes from disk on access.  ``_ram`` holds the
    decoded RowBatch after heat-driven promotion; ``_mem`` holds the raw
    file bytes after cold expiry, so snapshot cursors taken before the
    expiry keep serving (the RAM tier's snapshot-isolation contract)."""

    is_cold = True
    __slots__ = ("row_id_start", "min_time", "max_time", "nbytes", "gen",
                 "num_rows", "sealed_at", "path", "tier", "disk_bytes",
                 "reads", "_ram", "_mem")

    def __init__(self, tier, path: str, row_id_start: int, num_rows: int,
                 nbytes: int, min_time, max_time, disk_bytes: int,
                 gen=None, sealed_at: Optional[float] = None):
        self.tier = tier
        self.path = path
        self.row_id_start = int(row_id_start)
        self.num_rows = int(num_rows)
        self.nbytes = int(nbytes)
        self.min_time = min_time
        self.max_time = max_time
        self.disk_bytes = int(disk_bytes)
        self.gen = gen
        self.sealed_at = sealed_at if sealed_at is not None else time.monotonic()
        self.reads = 0
        self._ram: Optional[RowBatch] = None
        self._mem: Optional[bytes] = None

    @property
    def in_ram(self) -> bool:
        return self._ram is not None

    @property
    def batch(self) -> RowBatch:
        if self._ram is not None:
            return self._ram
        return self.tier.decode(self)


class ColdTier:
    """The per-table cold tier: demote/decode/promote/expire over one
    ``cold/<table>/`` directory.  All list surgery on ``table._sealed`` and
    all byte accounting run under the table's own lock (the *_locked
    members); file reads for decode run lock-free (files are immutable
    once renamed in)."""

    def __init__(self, table, dir_path: str):
        self.table = table
        self.dir = dir_path
        os.makedirs(self.dir, exist_ok=True)
        self._by_gen: dict[int, _ColdBatch] = {}
        self._disk_bytes = 0
        self._segments = 0
        self.demotions = 0
        self.promotions = 0
        self.expired = 0

    # --------------------------------------------------------------- encode
    def _path_for(self, row_id_start: int) -> str:
        return os.path.join(self.dir, f"b-{int(row_id_start):012d}.pxc")

    def _encode_payload(self, rb: RowBatch, row_id_start: int,
                        min_time, max_time, raw_nbytes: int) -> bytes:
        t = self.table
        rec = _journal._Rec()
        rec.dtypes, rec.dicts, rec.cols = {}, {}, {}
        for c in t.relation:
            arr = rb.columns[c.name][: rb.num_valid]
            rec.dtypes[c.name] = c.data_type
            if c.name in t.dictionaries and is_dict_encoded(c.data_type):
                # store VALUES, never live codes (journal.py's contract): the
                # record's own dictionary, in first-occurrence order, built
                # from the codes (journal.recode_first_seen: the same bytes
                # as decoding to values and encoding them again); restore
                # re-encodes through the append-only dictionary, so codes
                # come back bit-identical
                got = _journal.recode_first_seen(arr, t.dictionaries[c.name])
                if got is None:
                    d = Dictionary()
                    got = d.encode(t.dictionaries[c.name].decode(arr)), d
                rec.cols[c.name], rec.dicts[c.name] = got
            else:
                rec.cols[c.name] = np.asarray(arr, dtype=STORAGE_DTYPE[c.data_type])
        frame = wire.encode_host_batch(
            rec, {"t": t.name, "rid": int(row_id_start), "n": int(rb.num_valid)})
        codec = _codec()
        blob = wire._compress(codec, frame)
        if len(blob) >= len(frame):
            codec, blob = "", frame  # incompressible: store raw
        hdr = json.dumps({
            "rid": int(row_id_start), "n": int(rb.num_valid),
            "mn": min_time, "mx": max_time, "raw": int(raw_nbytes),
            "codec": codec, "flen": len(frame),
        }, sort_keys=True).encode()
        return _COLD_HDR.pack(COLD_MAGIC, len(hdr)) + hdr + blob

    def _write_segment(self, path: str, payload: bytes) -> int:
        """fsynced tmp+rename: the file either fully exists or not at all —
        the journal prune counts cold bytes as durable coverage, so a
        half-written cold segment must be impossible to observe."""
        rec = _journal.pack_record(payload)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(rec)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return len(rec)

    # --------------------------------------------------------------- decode
    @staticmethod
    def _parse_record(raw: bytes) -> Optional[bytes]:
        """One cold file's bytes → payload, or None when torn/corrupt."""
        if len(raw) < _journal._REC_HDR.size:
            return None
        magic, n, crc = _journal._REC_HDR.unpack_from(raw, 0)
        end = _journal._REC_HDR.size + n
        if (magic != _journal.REC_MAGIC or n > _journal.MAX_RECORD_BYTES
                or end > len(raw)):
            return None
        payload = raw[_journal._REC_HDR.size:end]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            return None
        return payload

    @staticmethod
    def _parse_header(payload: bytes) -> Optional[dict]:
        if len(payload) < _COLD_HDR.size:
            return None
        magic, hlen = _COLD_HDR.unpack_from(payload, 0)
        if magic != COLD_MAGIC or _COLD_HDR.size + hlen > len(payload):
            return None
        try:
            return json.loads(payload[_COLD_HDR.size:_COLD_HDR.size + hlen])
        except ValueError:
            return None

    def decode(self, ref: _ColdBatch) -> RowBatch:
        """Cold segment → RowBatch, bit-identical to the batch that was
        demoted: dict columns re-encode through the table's append-only
        dictionaries (values were inserted at the original write, so the
        codes are the original codes)."""
        if ref._mem is not None:
            raw = ref._mem
        else:
            with open(ref.path, "rb") as f:
                raw = f.read()
        payload = self._parse_record(raw)
        if payload is None:
            raise InvalidArgument(
                f"cold segment {ref.path} corrupt (CRC/framing)")
        hdr = self._parse_header(payload)
        if hdr is None:
            raise InvalidArgument(f"cold segment {ref.path}: bad header")
        _, hlen = _COLD_HDR.unpack_from(payload, 0)
        blob = payload[_COLD_HDR.size + hlen:]
        codec = str(hdr.get("codec") or "")
        flen = int(hdr.get("flen") or 0)
        frame = (wire._decompress(codec, blob, flen) if codec
                 else bytes(blob))
        kind, hb = wire.decode_frame(frame)
        if kind != "host_batch":
            raise InvalidArgument(
                f"cold segment {ref.path}: unexpected kind {kind!r}")
        t = self.table
        cols = {}
        for c in t.relation:
            v = hb.cols[c.name]
            if c.name in t.dictionaries and is_dict_encoded(c.data_type):
                # the record's codes through a LUT into the table's
                # dictionary: translate_to inserts a missing value in the
                # record dictionary's (first-occurrence) order, as encoding
                # the decoded values would, so the codes are the same
                rd = hb.dicts[c.name]
                if len(v) and (int(v.min()) < 0 or int(v.max()) >= rd.size):
                    cols[c.name] = t.dictionaries[c.name].encode(rd.decode(v))
                else:
                    lut = rd.translate_to(t.dictionaries[c.name], insert=True)
                    cols[c.name] = lut[np.asarray(v)].astype(np.int32, copy=False)
            else:
                cols[c.name] = np.asarray(v, dtype=STORAGE_DTYPE[c.data_type])
        rb = RowBatch(t.relation, cols)
        metrics.counter_inc(
            "px_cold_decodes_total",
            help_="cold-tier segments decoded on read (the decode-on-read "
                  "serving cost of the demoted retention window)")
        metrics.counter_inc(
            "px_cold_decode_bytes_total", float(rb.nbytes()),
            help_="bytes materialized by cold-tier decode-on-read")
        return rb

    # ------------------------------------------------- demotion (table lock)
    def _first_ram_index_locked(self) -> Optional[int]:
        """Index of the oldest RAM-resident sealed entry (a plain
        _SealedBatch, or a promoted _ColdBatch) — the next demotion
        candidate.  None when everything sealed is already cold."""
        for i, sb in enumerate(self.table._sealed):
            if not getattr(sb, "is_cold", False) or sb.in_ram:
                return i
        return None

    def _demote_entry_locked(self, idx: int) -> bool:
        t = self.table
        sb = t._sealed[idx]
        rb = sb._ram if getattr(sb, "is_cold", False) else sb.batch
        path = self._path_for(sb.row_id_start)
        try:
            payload = self._encode_payload(rb, sb.row_id_start, sb.min_time,
                                           sb.max_time, sb.nbytes)
            disk = self._write_segment(path, payload)
        except OSError:
            metrics.counter_inc(
                "px_cold_demote_errors_total",
                help_="cold-tier demotions failed on disk I/O (the batch "
                      "stays in RAM; retention falls back to expiry)")
            return False
        if getattr(sb, "is_cold", False):
            # re-demoting a promoted batch: drop the RAM copy, keep the stub
            sb._ram = None
            sb.disk_bytes = disk
            ref = sb
        else:
            ref = _ColdBatch(self, path, sb.row_id_start, sb.num_rows,
                             sb.nbytes, sb.min_time, sb.max_time, disk,
                             gen=sb.gen, sealed_at=sb.sealed_at)
            t._sealed[idx] = ref
        t._sealed_bytes -= sb.nbytes
        # the cached snapshot cursor pins the demoted RowBatch in RAM —
        # drop it now (the table version key does not cover demotions)
        t._snap_cache = None
        self._by_gen[ref.gen] = ref
        self._disk_bytes += disk
        self._segments += 1
        self.demotions += 1
        metrics.counter_inc(
            "px_cold_demotions_total",
            help_="sealed batches demoted to the compressed on-disk cold "
                  "tier (age- or RAM-ceiling-driven)")
        metrics.counter_inc(
            "px_cold_demoted_bytes_total", float(disk),
            help_="compressed bytes written by cold-tier demotion")
        # a demoted head behaves like a trimmed head for the resident tier:
        # its HBM copy must not outlive the RAM batch (cheap bookkeeping
        # only, same contract as Table._expire_locked's trim notice)
        try:
            from pixie_tpu_torch.engine import resident

            nxt = self._first_ram_index_locked()
            resident.on_retention_trim(
                t.uid, t._sealed[nxt].gen if nxt is not None else None)
        except Exception:
            pass
        return True

    def demote_oldest_locked(self) -> bool:
        """Spill the oldest RAM-resident sealed batch to disk — the
        demote-then-expire hook Table._expire_locked calls under byte-budget
        pressure.  False when nothing is left to demote."""
        if not enabled():
            return False
        idx = self._first_ram_index_locked()
        if idx is None:
            return False
        return self._demote_entry_locked(idx)

    def manage_locked(self) -> bool:
        """The retention-pass body (runs on every write, under the table
        lock): age- and RAM-ceiling-driven demotions, then cold-tier disk
        expiry.  Returns True when cold expiry dropped rows (the caller
        invalidates snapshot caches, as RAM expiry does)."""
        t = self.table
        if enabled():
            after_s = float(flags.get("PL_COLD_AFTER_S"))
            ceiling = int(flags.get("PL_COLD_MAX_HOT_MB")) << 20
            now = time.monotonic()
            while True:
                idx = self._first_ram_index_locked()
                if idx is None:
                    break
                sb = t._sealed[idx]
                over_age = (after_s > 0
                            and now - getattr(sb, "sealed_at", now) > after_s)
                over_ram = ceiling > 0 and t._sealed_bytes > ceiling
                if not (over_age or over_ram):
                    break
                if not self._demote_entry_locked(idx):
                    break
        budget = int(flags.get("PL_COLD_MAX_DISK_MB")) << 20
        expired = False
        while (budget > 0 and self._disk_bytes > budget and t._sealed
               and getattr(t._sealed[0], "is_cold", False)
               and not t._sealed[0].in_ram):
            sb = t._sealed.pop(0)
            self.on_drop_locked(sb)
            t._expired_batches += 1
            self.expired += 1
            expired = True
            metrics.counter_inc(
                "px_cold_expired_segments_total",
                help_="cold segments expired by the PL_COLD_MAX_DISK_MB "
                      "budget (rows leave retention: demote THEN expire)")
        return expired

    def on_drop_locked(self, sb: _ColdBatch) -> None:
        """A cold entry leaving the sealed list (cold expiry, or RAM expiry
        walking into the cold prefix): keep the raw bytes on the stub for
        snapshot cursors taken before the drop, then delete the file."""
        try:
            with open(sb.path, "rb") as f:
                sb._mem = f.read()
        except OSError:
            sb._mem = None
        try:
            os.remove(sb.path)
        except OSError:
            pass
        self._by_gen.pop(sb.gen, None)
        self._disk_bytes -= sb.disk_bytes
        self._segments -= 1

    # ------------------------------------------------------------ promotion
    def note_reads(self, gens) -> None:
        """Executor hook, once per cold feed emit: bump read counters and
        promote any batch that crossed PL_COLD_PROMOTE_READS back to RAM."""
        thresh = int(flags.get("PL_COLD_PROMOTE_READS"))
        if thresh <= 0:
            return
        hot = []
        for g in set(gens):
            ref = self._by_gen.get(g)
            if ref is None or ref.in_ram:
                continue
            ref.reads += 1
            if ref.reads >= thresh:
                hot.append(ref)
        for ref in hot:
            self.promote(ref)

    def promote(self, ref: _ColdBatch) -> bool:
        """Decode outside the lock, swap in under it.  The stub object stays
        in place (live cursors hold it), gaining a `_ram` batch; the disk
        segment is deleted and the RAM accounting grows.  Skipped when the
        PL_COLD_MAX_HOT_MB headroom gate says promotion would immediately
        re-demote."""
        t = self.table
        try:
            rb = self.decode(ref)
        except (OSError, InvalidArgument):
            return False
        with t._lock:
            if ref.in_ram or self._by_gen.get(ref.gen) is not ref:
                return False
            ceiling = int(flags.get("PL_COLD_MAX_HOT_MB")) << 20
            if ceiling > 0 and t._sealed_bytes + ref.nbytes > ceiling:
                ref.reads = 0  # no headroom: stay cold, restart the count
                return False
            ref._ram = rb
            ref.reads = 0
            t._sealed_bytes += ref.nbytes
            self._by_gen.pop(ref.gen, None)
            self._disk_bytes -= ref.disk_bytes
            self._segments -= 1
            try:
                os.remove(ref.path)
            except OSError:
                pass
            self.promotions += 1
        metrics.counter_inc(
            "px_cold_promotions_total",
            help_="cold batches promoted back to RAM by read heat "
                  "(PL_COLD_PROMOTE_READS)")
        return True

    # -------------------------------------------------------------- restore
    def restore_into(self) -> int:
        """Adopt every valid cold segment on disk into the (empty) table —
        runs at journal attach time, BEFORE replay, so the journal's
        watermark idempotence skips rows the cold tier already holds.
        Torn files (a crash mid-demote) are deleted — their rows are still
        journal-covered, so no segment AFTER a torn one may adopt either:
        adoption sets the replay watermark past its rows, and the torn
        rows would never be refilled.  Returns batches adopted."""
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith("b-") and n.endswith(".pxc"))
        except FileNotFoundError:
            return 0
        entries = []
        torn_before = None  # min row id of any torn segment
        for name in names:
            path = os.path.join(self.dir, name)
            try:
                with open(path, "rb") as f:
                    raw = f.read()
            except OSError:
                continue
            payload = self._parse_record(raw)
            hdr = self._parse_header(payload) if payload is not None else None
            if hdr is None:
                metrics.counter_inc(
                    "px_cold_torn_segments_total",
                    help_="cold segments discarded at restore (torn/corrupt "
                          "framing; their rows are journal-covered)")
                try:
                    os.remove(path)
                except OSError:
                    pass
                try:
                    rid = int(name[2:-4])
                except ValueError:
                    rid = 0
                if torn_before is None or rid < torn_before:
                    torn_before = rid
                continue
            entries.append(_ColdBatch(
                self, path, int(hdr["rid"]), int(hdr["n"]),
                int(hdr.get("raw") or 0), hdr.get("mn"), hdr.get("mx"),
                len(raw)))
        entries.sort(key=lambda e: e.row_id_start)
        skipped_torn = 0
        if torn_before is not None:
            keep = [e for e in entries if e.row_id_start < torn_before]
            skipped_torn = len(entries) - len(keep)
            entries = keep
        adopted = self.table.adopt_cold_batches(entries)
        for e in entries[:adopted]:
            self._by_gen[e.gen] = e
            self._disk_bytes += e.disk_bytes
            self._segments += 1
        if adopted < len(entries) or skipped_torn:
            metrics.counter_inc(
                "px_cold_restore_skipped_total",
                float(len(entries) - adopted + skipped_torn),
                help_="cold segments skipped at restore (row-id gap after a "
                      "lost or torn segment; kept on disk, never served)")
        if adopted:
            metrics.counter_inc(
                "px_cold_restored_segments_total", float(adopted),
                help_="cold segments adopted back into tables at restart")
        return adopted

    # ---------------------------------------------------------------- stats
    def disk_usage(self) -> tuple[int, int]:
        """(cold bytes, cold segments) on disk — feeds storage_state rows
        and the journal's PL_JOURNAL_MAX_MB accounting (extra_disk)."""
        return self._disk_bytes, self._segments

    def disk_usage_bytes(self) -> int:
        return self._disk_bytes

    def stats(self) -> dict:
        return {"cold_bytes": self._disk_bytes,
                "cold_segments": self._segments,
                "demotions": self.demotions,
                "promotions": self.promotions,
                "expired": self.expired}


def attach_table(table, ndir: str) -> int:
    """Create + attach a ColdTier for `table` under `ndir` and restore any
    existing cold segments (BEFORE journal replay — see restore_into).
    With PL_COLD_TIER=0 and no cold files on disk this is a pure no-op:
    no directory, no tier, bit-identical tables."""
    cdir = cold_dir(ndir, table.name)
    if not enabled() and not os.path.isdir(cdir):
        return 0
    if table.cold is not None:
        return 0
    tier = ColdTier(table, cdir)
    restored = tier.restore_into()
    table.cold = tier
    return restored
