"""Distributed execution: the planner's split of a logical plan across
agents (distributed.py), value-keyed partial aggregates (partial.py), SPMD
aggregation over a mesh of co-located shards (spmd.py) or of shards across
processes joined by torch.distributed (multihost.py), the keyed
repartition of join sides (repartition.py) and the in-process cluster that
runs them (cluster.py)."""
from pixie_tpu_torch.parallel.spmd import (
    collective_merge,
    collective_merge_carry,
    make_mesh,
    reduce_tree_for,
    spmd_agg_step,
)
from pixie_tpu_torch.parallel.topology import AgentInfo, ClusterSpec
from pixie_tpu_torch.parallel.distributed import (
    Channel,
    DistributedPlan,
    DistributedPlanner,
)
from pixie_tpu_torch.parallel.partial import PartialAggBatch, merge_partials
from pixie_tpu_torch.parallel.cluster import LocalCluster
from pixie_tpu_torch.parallel.multihost import (
    global_mesh,
    host_local_slice,
    init_multihost,
    world_merge,
)
from pixie_tpu_torch.parallel.repartition import mesh_bucket_counts, mesh_repartition

__all__ = [
    "make_mesh",
    "collective_merge",
    "collective_merge_carry",
    "spmd_agg_step",
    "reduce_tree_for",
    "AgentInfo",
    "ClusterSpec",
    "Channel",
    "DistributedPlan",
    "DistributedPlanner",
    "PartialAggBatch",
    "merge_partials",
    "LocalCluster",
    "init_multihost",
    "global_mesh",
    "host_local_slice",
    "world_merge",
    "mesh_bucket_counts",
    "mesh_repartition",
]
