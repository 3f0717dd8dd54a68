"""Distributed execution on one device: the planner's split of a logical
plan across agents (distributed.py), value-keyed partial aggregates
(partial.py) and the in-process cluster that runs them (cluster.py)."""
from pixie_tpu_torch.parallel.topology import AgentInfo, ClusterSpec
from pixie_tpu_torch.parallel.distributed import (
    Channel,
    DistributedPlan,
    DistributedPlanner,
)
from pixie_tpu_torch.parallel.partial import PartialAggBatch, merge_partials
from pixie_tpu_torch.parallel.cluster import LocalCluster

__all__ = [
    "AgentInfo",
    "ClusterSpec",
    "Channel",
    "DistributedPlan",
    "DistributedPlanner",
    "PartialAggBatch",
    "merge_partials",
    "LocalCluster",
]
