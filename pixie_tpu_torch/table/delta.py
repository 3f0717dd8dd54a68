"""Eviction-aware delta cursors: high-watermark positions in a table's
row-id space.

The incremental building block for standing queries (pixie_tpu.matview) and
any other consumer that folds a table's appended rows batch-by-batch: a
DeltaCursor remembers the contiguous row-id range [base_row_id, watermark)
whose rows it has already consumed, and classifies itself against the live
table before every advance.  Row ids are stable across sealing and monotone
across writes (table.py), so the range is exact bookkeeping, not heuristics.

Ring-buffer expiry (Table._expire_locked) can invalidate a cursor two ways:

  * trimmed  — rows BELOW base_row_id were the consumer's responsibility
    too?  No: rows below base were never consumed, they simply predate the
    cursor.  "trimmed" means expiry advanced the retention frontier PAST
    base_row_id, i.e. rows the consumer DID fold are no longer visible to a
    fresh scan.  Accumulated state now covers rows a cold query cannot see,
    so consumers needing scan-equivalence must rebuild.
  * gap      — the frontier advanced past the watermark itself: unread rows
    expired before the cursor got to them (a dead cursor).  The delta
    [watermark, first_row_id) is unrecoverable; only a rebuild helps.

`gap` implies `trimmed` (base ≤ watermark); status() reports the most
severe classification so callers can count invalidation reasons.

Copied from the reference package (pixie_tpu/table/delta.py).  Standing
views (pixie_tpu.matview), its consumer there, are not ported yet.
"""
from __future__ import annotations

#: status values in increasing severity
OK = "ok"
TRIMMED = "trimmed"
GAP = "gap"
STALE_TABLE = "stale_table"


class DeltaCursor:
    """Watermark bookkeeping for one table (or one tablet's Table)."""

    __slots__ = ("table_uid", "base_row_id", "watermark")

    def __init__(self, table):
        self.rebase(table)

    def rebase(self, table) -> None:
        """Re-anchor on the table's current retention frontier (rebuild)."""
        self.table_uid = table.uid
        self.base_row_id = table.first_row_id()
        self.watermark = self.base_row_id

    def status(self, table) -> str:
        """Classify this cursor against the live table (see module doc)."""
        if table.uid != self.table_uid:
            # the table was dropped and recreated under the same name —
            # possibly with a different schema; nothing carries over
            return STALE_TABLE
        first = table.first_row_id()
        if first > self.watermark:
            return GAP
        if first > self.base_row_id:
            return TRIMMED
        return OK

    def delta_bounds(self, table) -> tuple[int, int]:
        """[lo, hi) row-id bounds of the unread delta as of now.  The caller
        scans it with table.cursor_since(lo, hi) (snapshot isolation pins
        the rows) and then calls advance(hi)."""
        return self.watermark, table.last_row_id()

    def advance(self, hi: int) -> None:
        self.watermark = max(self.watermark, int(hi))

    def covered_rows(self) -> int:
        return self.watermark - self.base_row_id
