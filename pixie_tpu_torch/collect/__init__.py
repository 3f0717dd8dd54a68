"""Collection layer: source connectors + poll-loop runtime (Stirling analog).

Copied from the reference package (pixie_tpu/collect/__init__.py).
"""
from pixie_tpu_torch.collect.core import (
    Collector,
    FrequencyManager,
    SourceConnector,
    TableSpec,
)
from pixie_tpu_torch.collect.proc_stats import NetworkStatsConnector, ProcessStatsConnector
from pixie_tpu_torch.collect.replay import ReplayConnector
from pixie_tpu_torch.collect.seq_gen import SeqGenConnector

__all__ = [
    "Collector",
    "FrequencyManager",
    "SourceConnector",
    "TableSpec",
    "SeqGenConnector",
    "ReplayConnector",
    "ProcessStatsConnector",
    "NetworkStatsConnector",
]
