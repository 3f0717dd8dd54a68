"""/proc-scanning PID→UPID tracker.

Reference: src/shared/metadata/pids.cc (PID start-time from /proc/<pid>/stat
makes the UPID unique across pid reuse) + cgroup_metadata_reader.cc (the
cgroup path names the pod uid, binding a live process to its k8s pod).

The scanner feeds `process` ResourceUpdates into the MetadataStateManager so
metadata UDFs (`ctx['pod']`, upid_to_cmdline, ...) resolve for REAL local
processes — the same UPIDs the tap/tracer stamps on traffic, because both
derive the start time from the same /proc field.

Copied from the reference package (pixie_tpu/metadata/proc_scanner.py).
"""
from __future__ import annotations

import os
import re
from typing import Callable, Optional

from pixie_tpu_torch.types import UInt128

_POD_RE = re.compile(r"pod([0-9a-fA-F]{8}[-_][0-9a-fA-F]{4}[-_][0-9a-fA-F]{4}"
                     r"[-_][0-9a-fA-F]{4}[-_][0-9a-fA-F]{12})")


def _boot_time_ns(proc: str = "/proc") -> int:
    with open(os.path.join(proc, "stat")) as f:
        for line in f:
            if line.startswith("btime "):
                return int(line.split()[1]) * 1_000_000_000
    return 0


def pid_start_time_ns(pid: int, proc: str = "/proc",
                      _cache: dict = {}) -> int:
    """Monotonic-unique process start time in ns since epoch (reference
    pids.cc: /proc/<pid>/stat field 22, clock ticks since boot)."""
    key = ("boot", proc)
    if key not in _cache:
        _cache[key] = (_boot_time_ns(proc), os.sysconf("SC_CLK_TCK"))
    boot_ns, hz = _cache[key]
    try:
        with open(os.path.join(proc, str(pid), "stat"), "rb") as f:
            raw = f.read().decode("latin-1")
    except OSError:
        return 0
    # comm (field 2) may contain spaces/parens: fields resume after the LAST
    # ')'; starttime is overall field 22 → index 19 of the remainder.
    rest = raw.rsplit(")", 1)[-1].split()
    if len(rest) < 20:
        return 0
    ticks = int(rest[19])
    return boot_ns + ticks * 1_000_000_000 // hz


def pid_cmdline(pid: int, proc: str = "/proc") -> str:
    try:
        with open(os.path.join(proc, str(pid), "cmdline"), "rb") as f:
            return f.read().replace(b"\x00", b" ").decode(
                "utf-8", "replace").strip()
    except OSError:
        return ""


def pid_pod_uid(pid: int, proc: str = "/proc") -> Optional[str]:
    """Pod uid from the process's cgroup path (reference
    cgroup_metadata_reader.cc: .../pod<uid>/<container-id>/...)."""
    try:
        with open(os.path.join(proc, str(pid), "cgroup")) as f:
            text = f.read()
    except OSError:
        return None
    m = _POD_RE.search(text)
    return m.group(1).replace("_", "-") if m else None


class ProcScanner:
    """Periodically scans /proc and binds live PIDs to UPIDs (+pods).

    `classifier(pid, cmdline) -> pod_uid | None` supplements the cgroup
    reader for non-k8s hosts (tests, bare-metal demos): whatever it returns
    binds the process to that pod in the metadata state.
    """

    def __init__(self, asid: int = 0, proc: str = "/proc",
                 classifier: Optional[Callable[[int, str],
                                               Optional[str]]] = None):
        self.asid = asid
        self.proc = proc
        self.classifier = classifier
        self.last_scanned = 0
        #: previous scan's applied updates, keyed by upid — periodic scans
        #: only re-apply CHANGED bindings so an idle system doesn't bump the
        #: metadata epoch (which would invalidate every epoch-keyed kernel
        #: cache) every period.  Exited PIDs' entries linger in the state
        #: (the reference also keeps terminated UPIDs resolvable for a
        #: retention window; rows referencing them still need names).
        self._prev: dict = {}

    def upid_of(self, pid: int) -> UInt128:
        return UInt128.make_upid(self.asid, pid,
                                 pid_start_time_ns(pid, self.proc))

    def scan_updates(self) -> list[dict]:
        """One full scan → `process` ResourceUpdates for every live PID."""
        updates = []
        try:
            pids = [int(d) for d in os.listdir(self.proc) if d.isdigit()]
        except OSError:
            return updates
        for pid in pids:
            start = pid_start_time_ns(pid, self.proc)
            if start == 0:
                continue  # raced exit
            cmd = pid_cmdline(pid, self.proc)
            u = {"kind": "process",
                 "upid": UInt128.make_upid(self.asid, pid, start),
                 "cmdline": cmd or f"[pid {pid}]"}
            pod = pid_pod_uid(pid, self.proc)
            if pod is None and self.classifier is not None:
                pod = self.classifier(pid, cmd)
            if pod is not None:
                u["pod_uid"] = pod
            updates.append(u)
        self.last_scanned = len(updates)
        return updates

    def scan_into(self, manager) -> int:
        """Scan and apply CHANGED bindings to a MetadataStateManager;
        returns updates applied."""
        updates = self.scan_updates()
        fresh = {}
        changed = []
        for u in updates:
            key = u["upid"]
            fresh[key] = (u.get("pod_uid"), u.get("cmdline"))
            if self._prev.get(key) != fresh[key]:
                changed.append(u)
        self._prev = fresh
        if changed:
            manager.apply_updates(changed)
        return len(changed)
