"""ResourceUpdate watch feed: apply externally-produced metadata updates.

Reference: the k8s watcher → ResourceUpdate fanout
(src/vizier/services/metadata/controllers/k8smeta/k8s_metadata_handler.go:
139-157 publishes watch deltas over NATS; each agent's
AgentMetadataStateManager applies them).  Here the feed is a JSONL file
(tailed incrementally — a kubectl-watch shim, an operator, or a test writes
it) or any iterable of update dicts; apply is the same
MetadataStateManager.apply_updates epoch swap either way.

Copied from the reference package (pixie_tpu/metadata/watch.py).
"""
from __future__ import annotations

import json
import os

from pixie_tpu_torch.types import UInt128


def _decode_update(u: dict) -> dict:
    if u.get("kind") == "process" and not isinstance(u.get("upid"), UInt128):
        v = u.get("upid")
        if isinstance(v, (list, tuple)) and len(v) == 2:
            u = {**u, "upid": UInt128(int(v[0]), int(v[1]))}
    return u


class ResourceUpdateFeed:
    """Tails a JSONL file of ResourceUpdates into a MetadataStateManager."""

    def __init__(self, manager, path: str):
        self.manager = manager
        self.path = path
        self._offset = 0
        self._partial = b""
        self.applied = 0
        self.errors = 0

    def poll(self) -> int:
        """Apply any new complete lines; returns updates applied."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return 0
        if size < self._offset:  # truncated/rotated: start over
            self._offset = 0
            self._partial = b""
        if size == self._offset:
            return 0
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            chunk = f.read()
            self._offset = f.tell()
        data = self._partial + chunk
        lines = data.split(b"\n")
        self._partial = lines.pop()  # incomplete tail (or empty)
        applied = 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            # apply per update: one malformed line must not abort (and
            # permanently lose — the offset already advanced) a whole batch
            try:
                self.manager.apply_updates([_decode_update(json.loads(line))])
                applied += 1
            except Exception:
                self.errors += 1
        self.applied += applied
        return applied


def apply_updates_json(manager, updates: list[dict]) -> None:
    """Apply a batch of wire-form (JSON-safe) updates."""
    manager.apply_updates([_decode_update(u) for u in updates])
