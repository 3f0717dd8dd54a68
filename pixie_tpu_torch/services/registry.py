"""Agent registry with heartbeat expiry, persisted in the control KV store.

Reference: the metadata service's agent manager — register/heartbeat agents,
expire them when heartbeats stop, drop their schemas from planning
(src/vizier/services/metadata/controllers/agent/agent.go:81-150,221-470).

Copied from the reference package (pixie_tpu/services/registry.py), with
the PL_REPLICATION flag its shard map reads (defined in the reference's
services/replication.py).  Replication itself is not ported yet (ROADMAP
Queue 1 item 6d, part 2), nor the re-homing overrides of the shard map
(`add_replica`, `remove_replica`): at the default of 1 the shard map is
empty, and `refuse_replication` is what the broker and the agents call to
refuse more.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from pixie_tpu_torch import flags
from pixie_tpu_torch.parallel.topology import AgentInfo, ClusterSpec
from pixie_tpu_torch.services.kvstore import KVStore
from pixie_tpu_torch.status import Unimplemented
from pixie_tpu_torch.types import Relation

flags.define_int(
    "PL_REPLICATION", 1,
    "copies of every sealed batch across the agent set (including the "
    "primary); 1 disables replication entirely — the seed single-copy "
    "behavior, bit-identical")


def refuse_replication() -> None:
    """Raise unless replication is off (PL_REPLICATION <= 1)."""
    if int(flags.get("PL_REPLICATION")) > 1:
        raise Unimplemented(
            "sealed-batch replication (PL_REPLICATION > 1) is not ported yet "
            "(ROADMAP Queue 1 item 6d, part 2)")


@dataclasses.dataclass
class AgentRecord:
    name: str
    asid: int
    schemas: dict  # table -> Relation
    n_devices: Optional[int]
    last_heartbeat: float
    alive: bool = True
    #: incarnation fence: bumped on EVERY register.  A restarted agent
    #: re-registering under the same name supersedes its old socket; frames
    #: still in flight from the dead incarnation (chunks, acks, heartbeats)
    #: carry — via their connection's recorded incarnation — a stale value
    #: and are rejected instead of folded (reference: ASIDs are never
    #: reused, agent.go expired agents handshake anew).
    incarnation: int = 0
    #: monotonic time the agent was last observed dying (disconnect or
    #: heartbeat expiry); 0 = never died (or recalled-from-KV cold record).
    #: The broker's rejoin grace window measures from this: a JUST-dead
    #: agent is likely a restarting pod, not a removed one.
    died_at: float = 0.0
    #: (host, port) of the agent's replication peer server (None when the
    #: agent runs without PL_REPLICATION); persisted so a rehydrating peer
    #: can find its replicas across broker restarts
    repl_addr: Optional[tuple] = None


class AgentRegistry:
    """Live agent set + durable record (the registry survives broker restarts;
    liveness does not — agents must re-register/heartbeat)."""

    def __init__(self, kv: Optional[KVStore] = None, expiry_s: float = 15.0):
        self.kv = kv or KVStore()
        self.expiry_s = expiry_s
        self._agents: dict[str, AgentRecord] = {}
        self._next_asid = 1
        self._lock = threading.Lock()
        #: topology/schema epoch: bumped on every liveness or schema change
        #: ((re-)register, death, expiry).  The broker's plan cache keys its
        #: compiled queries and distributed splits on this, so a changed
        #: cluster view can never serve a stale plan.
        self.epoch = 0
        # Recall durable records (dead until they heartbeat again).
        for key, raw in self.kv.scan("agent/"):
            import json

            d = json.loads(raw.decode())
            rec = AgentRecord(
                name=d["name"],
                asid=d["asid"],
                schemas={t: Relation.from_dict(r) for t, r in d["schemas"].items()},
                n_devices=d.get("n_devices"),
                last_heartbeat=0.0,
                alive=False,
                repl_addr=(tuple(d["repl_addr"])
                           if d.get("repl_addr") else None),
            )
            self._agents[rec.name] = rec
            self._next_asid = max(self._next_asid, rec.asid + 1)

    # ---------------------------------------------------------------- mutation
    def register(self, name: str, schemas: dict, n_devices: Optional[int] = None,
                 repl_addr: Optional[tuple] = None) -> int:
        """(Re-)register an agent; returns its ASID."""
        now = time.monotonic()
        with self._lock:
            self.epoch += 1
            rec = self._agents.get(name)
            if rec is None:
                rec = AgentRecord(name, self._next_asid, schemas, n_devices, now)
                self._next_asid += 1
                self._agents[name] = rec
            else:
                rec.schemas = schemas
                rec.n_devices = n_devices
                rec.last_heartbeat = now
                rec.alive = True
            rec.incarnation += 1
            rec.repl_addr = tuple(repl_addr) if repl_addr else None
            self.kv.set_json(
                f"agent/{name}",
                {
                    "name": name,
                    "asid": rec.asid,
                    "schemas": {t: r.to_dict() for t, r in schemas.items()},
                    "n_devices": n_devices,
                    "repl_addr": list(rec.repl_addr) if rec.repl_addr else None,
                },
            )
            self._update_shard_map_locked()
            return rec.asid

    def heartbeat(self, name: str) -> bool:
        with self._lock:
            rec = self._agents.get(name)
            if rec is None or not rec.alive:
                # Unknown OR already expired: a heartbeat cannot revive a dead
                # agent — it must re-register (reference agent.go: expired
                # agents are deleted and handshake anew).  This also closes
                # the expire/heartbeat race: once dead, stays dead until
                # register().
                return False
            rec.last_heartbeat = time.monotonic()
            return True

    def mark_dead(self, name: str) -> None:
        with self._lock:
            rec = self._agents.get(name)
            if rec is not None:
                was_alive = rec.alive
                rec.alive = False
                if was_alive:
                    self.epoch += 1
                    rec.died_at = time.monotonic()
                    self._update_shard_map_locked()

    def expire(self) -> list[str]:
        """Mark agents whose heartbeats lapsed as dead; returns newly-dead."""
        now = time.monotonic()
        out = []
        with self._lock:
            for rec in self._agents.values():
                if rec.alive and now - rec.last_heartbeat > self.expiry_s:
                    rec.alive = False
                    rec.died_at = now
                    out.append(rec.name)
            if out:
                self.epoch += 1
                self._update_shard_map_locked()
        return out

    # --------------------------------------------------------------- shard map
    def _update_shard_map_locked(self) -> None:
        """Recompute + persist the primary→replicas shard map on every
        liveness change (join/evict).  Replicas are the next
        PL_REPLICATION-1 LIVE agents after the primary in sorted ring
        order; dead primaries KEEP an entry (their replicas are exactly
        what failover and rehydration need to find).  No-op with
        replication disabled — no KV writes, bit-identical legacy paths."""
        k = int(flags.get("PL_REPLICATION"))
        if k <= 1:
            return
        live = sorted(r.name for r in self._agents.values() if r.alive)
        out: dict[str, list] = {}
        import bisect

        for name in sorted(self._agents):
            ring = [a for a in live if a != name]
            reps: list = []
            if ring:
                pos = bisect.bisect_left(ring, name)
                reps = [ring[(pos + i) % len(ring)]
                        for i in range(min(k - 1, len(ring)))]
            out[name] = reps
        self.kv.set_json("shardmap/current", {"k": k, "map": out})

    def shard_map(self) -> dict:
        """The persisted primary→replicas map ({} when replication is off)."""
        return (self.kv.get_json("shardmap/current") or {}).get("map", {})

    def peer_addrs(self) -> dict[str, list]:
        """Replication peer addresses of LIVE agents (dead peers are not
        dialable; a rehydrating agent re-registers with a fresh port)."""
        with self._lock:
            return {r.name: list(r.repl_addr)
                    for r in self._agents.values()
                    if r.alive and r.repl_addr}

    def record(self, name: str) -> Optional[AgentRecord]:
        with self._lock:
            return self._agents.get(name)

    def deregister(self, name: str) -> bool:
        """Permanently remove an agent (operator decommission).  Without
        this a retired node's durable record keeps it in the shard map as
        a failover primary forever — every plan carries its virtual shard
        and the serving front never leaves catch-up.  Returns whether the
        record existed."""
        with self._lock:
            rec = self._agents.pop(name, None)
            if rec is None:
                return False
            self.epoch += 1
            self.kv.delete(f"agent/{name}")
            self._update_shard_map_locked()
            return True

    # ------------------------------------------------------------------- views
    def incarnation(self, name: str) -> int:
        """Current incarnation of `name` (0 = never registered).  Frames
        from a connection recorded under an older incarnation are stale."""
        with self._lock:
            rec = self._agents.get(name)
            return rec.incarnation if rec is not None else 0

    def recently_dead(self, grace_s: float) -> list[str]:
        """Agents observed dying within the last `grace_s` seconds — the
        set the broker's dispatch holds for (a restarting pod re-registers
        within the grace; a removed one ages out of it)."""
        now = time.monotonic()
        with self._lock:
            return sorted(
                rec.name for rec in self._agents.values()
                if not rec.alive and rec.died_at > 0
                and now - rec.died_at < grace_s)

    def all_agents(self) -> list[AgentRecord]:
        """Every known agent, dead or alive (GetAgentStatus shows both)."""
        self.expire()
        with self._lock:
            return list(self._agents.values())

    def live_agents(self) -> list[AgentRecord]:
        self.expire()
        with self._lock:
            return [r for r in self._agents.values() if r.alive]

    def cluster_spec(self, merger_name: str = "broker") -> ClusterSpec:
        """Planner topology over LIVE agents only (dead agents are planned
        around — reference: expired agents drop out of DistributedState)."""
        agents = [
            AgentInfo(
                name=r.name,
                has_data_store=True,
                processes_data=True,
                accepts_remote_sources=False,
                schemas=r.schemas,
                n_devices=r.n_devices,
            )
            for r in self.live_agents()
        ]
        agents.append(
            AgentInfo(
                name=merger_name,
                has_data_store=False,
                processes_data=False,
                accepts_remote_sources=True,
                schemas={},
            )
        )
        return ClusterSpec(agents)

    def combined_schemas(self) -> dict[str, Relation]:
        out: dict[str, Relation] = {}
        for r in self.live_agents():
            for t, rel in r.schemas.items():
                out.setdefault(t, rel)
        return out
