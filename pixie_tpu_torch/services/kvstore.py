"""Durable control-state store.

The reference persists agent registry / schemas / tracepoints / cron scripts in
an embedded KV store (pebbledb default; src/vizier/utils/datastore/) — telemetry
data itself is deliberately NOT durable (SURVEY.md §5 checkpoint/resume).  This
is the same split: a small sqlite3-backed KV for control state only.

Copied from the reference package (pixie_tpu/services/kvstore.py).
"""
from __future__ import annotations

import json
import sqlite3
import threading
from typing import Iterator, Optional


class KVStore:
    """Tiny durable KV (namespace via key prefixes, like the reference's
    datastore `SetWithPrefix/GetWithPrefix`)."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.Lock()
        with self._lock:
            if path != ":memory:":
                # Crash safety: the KV now backs the replication shard map
                # and the agent registry, so a broker killed mid-write must
                # reopen to a consistent store.  WAL keeps readers unblocked
                # and makes commits an fsynced append; synchronous=FULL
                # makes every commit durable through power loss, not just
                # process death; busy_timeout bounds writer contention from
                # a standby broker sharing the file instead of failing cas.
                self._conn.execute("PRAGMA journal_mode=WAL")
                self._conn.execute("PRAGMA synchronous=FULL")
                self._conn.execute("PRAGMA busy_timeout=5000")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v BLOB)"
            )
            self._conn.commit()

    def set(self, key: str, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT INTO kv(k, v) VALUES(?, ?) "
                "ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                (key, value),
            )
            self._conn.commit()

    def get(self, key: str) -> Optional[bytes]:
        with self._lock:
            row = self._conn.execute("SELECT v FROM kv WHERE k=?", (key,)).fetchone()
        return None if row is None else bytes(row[0])

    def delete(self, key: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k=?", (key,))
            self._conn.commit()

    def scan(self, prefix: str) -> Iterator[tuple[str, bytes]]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT k, v FROM kv WHERE k >= ? AND k < ? ORDER BY k",
                (prefix, prefix + "￿"),
            ).fetchall()
        for k, v in rows:
            yield k, bytes(v)

    def cas(self, key: str, old: Optional[bytes], new: bytes) -> bool:
        """Atomic compare-and-set in ONE sqlite transaction (BEGIN IMMEDIATE
        takes the write lock up front, so a concurrent process cannot
        interleave between the read and the write — the primitive leader
        election needs for a race-free lease take-over)."""
        with self._lock:
            try:
                self._conn.execute("BEGIN IMMEDIATE")
                row = self._conn.execute(
                    "SELECT v FROM kv WHERE k=?", (key,)).fetchone()
                cur = None if row is None else bytes(row[0])
                if cur != old:
                    self._conn.rollback()
                    return False
                self._conn.execute(
                    "INSERT INTO kv(k, v) VALUES(?, ?) "
                    "ON CONFLICT(k) DO UPDATE SET v=excluded.v",
                    (key, new),
                )
                self._conn.commit()
                return True
            except sqlite3.OperationalError:
                self._conn.rollback()
                return False

    # JSON conveniences (control state is JSON-safe by construction)
    def set_json(self, key: str, value) -> None:
        self.set(key, json.dumps(value).encode())

    def get_json(self, key: str, default=None):
        raw = self.get(key)
        return default if raw is None else json.loads(raw.decode())

    def close(self):
        with self._lock:
            self._conn.close()
