"""Cluster topology specs — the CarnotInfo analog.

Reference: distributedpb CarnotInfo{has_data_store, processes_data,
accepts_remote_sources} (src/carnot/distributedpb/distributed_plan.proto:48-72)
drives the coordinator's partition of a logical plan into per-agent physical
plans (coordinator/coordinator.h:40-91).  Copied from the reference package
(pixie_tpu/parallel/topology.py).  An agent's `n_devices` is the width of
its mesh (in the port, co-located shards of one device: parallel/spmd.py);
the planner reads it to size a repartitioned join.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from pixie_tpu_torch.types import Relation


@dataclasses.dataclass
class AgentInfo:
    """One query-executing agent (PEM or Kelvin analog)."""

    name: str
    #: has local telemetry tables (PEM-like)
    has_data_store: bool = True
    #: runs source fragments over its own data
    processes_data: bool = True
    #: can terminate remote streams and merge partials (Kelvin-like)
    accepts_remote_sources: bool = False
    #: table name → Relation available on this agent (the planner prunes
    #: sources whose table an agent lacks — reference
    #: prune_unavailable_sources_rule.cc)
    schemas: dict = dataclasses.field(default_factory=dict)
    #: devices in this agent's local mesh: None = auto, 1 = single device,
    #: N = an explicit N-device mesh (the planner's repartition width)
    n_devices: Optional[int] = None

    def has_table(self, name: str) -> bool:
        return name in self.schemas


@dataclasses.dataclass
class ClusterSpec:
    """The planner's view of the cluster (reference DistributedState)."""

    agents: list[AgentInfo]

    def data_agents(self, table: Optional[str] = None) -> list[AgentInfo]:
        out = [a for a in self.agents if a.has_data_store and a.processes_data]
        if table is not None:
            out = [a for a in out if a.has_table(table)]
        return out

    def merger(self) -> AgentInfo:
        for a in self.agents:
            if a.accepts_remote_sources:
                return a
        raise ValueError("cluster has no merger (accepts_remote_sources) agent")

    def combined_schemas(self) -> dict[str, Relation]:
        out: dict[str, Relation] = {}
        for a in self.agents:
            for t, rel in a.schemas.items():
                out.setdefault(t, rel)
        return out
