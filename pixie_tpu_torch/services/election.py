"""Leader election over the control KV store.

Reference: src/shared/services/election/ — Go services elect a leader via a
k8s lease so exactly one broker instance serves mutations at a time.  Here
the lease lives in the shared control KVStore (sqlite): a compare-and-swap
on a single key with a TTL, renewed by the holder, stealable after expiry.
The KVStore's process-level lock serializes the read-modify-write (sqlite
single-writer semantics cover the cross-process case when the KV is a
shared file).

Usage (broker failover):
    elector = LeaderElector(kv, "broker", instance_id="broker-1").start()
    ... if elector.is_leader(): serve mutations ...
    elector.stop()   # resigns, letting a standby take over immediately

Copied from the reference package (pixie_tpu/services/election.py).
"""
from __future__ import annotations

import threading
import time
from typing import Optional

_KEY = "election/%s"

#: one lock per (kv identity, key): serializes the lease read-modify-write
#: among in-process electors of the SAME election without coupling
#: unrelated elections (or blocking is_leader() behind another elector's
#: sqlite I/O — the kv.cas itself is the cross-process guard)
_CAS_LOCKS: dict = {}
_CAS_LOCKS_GUARD = threading.Lock()


def _cas_lock(kv, key: str) -> threading.Lock:
    k = (id(kv), key)
    with _CAS_LOCKS_GUARD:
        return _CAS_LOCKS.setdefault(k, threading.Lock())


class LeaderElector:
    def __init__(self, kv, name: str, instance_id: str,
                 ttl_s: float = 5.0, renew_s: Optional[float] = None):
        self.kv = kv
        self.key = _KEY % name
        self.instance_id = instance_id
        self.ttl_s = float(ttl_s)
        self.renew_s = renew_s if renew_s is not None else self.ttl_s / 3
        self._leader = False
        self._lock = _cas_lock(kv, self.key)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ lease
    def try_acquire(self, now: Optional[float] = None) -> bool:
        """One CAS round: take the lease if free/expired/ours; else False.
        The read-modify-write runs as an atomic kv.cas (single sqlite
        transaction), so two processes racing for an expired lease cannot
        both win."""
        import json

        now = time.time() if now is None else now
        with self._lock:
            raw = self.kv.get(self.key)
            cur = None if raw is None else json.loads(raw.decode())
            if (cur is None or cur.get("expires", 0) <= now
                    or cur.get("holder") == self.instance_id):
                new = json.dumps({
                    "holder": self.instance_id,
                    "expires": now + self.ttl_s,
                }).encode()
                # CAS against the exact bytes we read; a concurrent winner
                # changes them and our take fails cleanly
                self._leader = self.kv.cas(self.key, raw, new)
            else:
                self._leader = False
            return self._leader

    def resign(self) -> None:
        import json

        with self._lock:
            raw = self.kv.get(self.key)
            cur = None if raw is None else json.loads(raw.decode())
            if cur is not None and cur.get("holder") == self.instance_id:
                # CAS to an expired lease rather than delete: if someone
                # stole the lease between read and write, the CAS fails and
                # we don't clobber THEIR lease
                self.kv.cas(self.key, raw, json.dumps(
                    {"holder": None, "expires": 0}).encode())
            self._leader = False

    def is_leader(self) -> bool:
        # plain bool read (atomic in CPython): must not block behind a
        # CAS in flight — the health/readiness probes and the per-query
        # leadership gate call this on hot paths
        return self._leader

    def leader(self) -> Optional[str]:
        """Current holder name (None when the lease is free/expired)."""
        cur = self.kv.get_json(self.key)
        if cur is None or cur.get("expires", 0) <= time.time():
            return None
        return cur.get("holder")

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "LeaderElector":
        self.try_acquire()
        self._thread = threading.Thread(
            target=self._renew_loop, daemon=True,
            name=f"pixie-election-{self.instance_id}")
        self._thread.start()
        return self

    def _renew_loop(self):
        while not self._stop.wait(timeout=self.renew_s):
            try:
                self.try_acquire()
            except Exception:
                # a failed renewal (kv locked/closed/disk error) must DEMOTE,
                # not freeze a stale _leader=True while the thread dies
                with self._lock:
                    self._leader = False

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        self.resign()
