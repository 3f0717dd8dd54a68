"""/proc scrapers: process + network stats connectors.

Reference: src/stirling/source_connectors/process_stats (1s cadence,
process_stats_connector.h) and network_stats — per-process CPU/memory and
per-interface traffic counters scraped from procfs.  No eBPF required, so
these run anywhere Linux does; they are the first REAL telemetry sources of
the port (seq_gen/replay are synthetic).

Copied from the reference package (pixie_tpu/collect/proc_stats.py).
"""
from __future__ import annotations

import os
import time

import numpy as np

from pixie_tpu_torch.collect.core import SourceConnector, TableSpec, now_ns
from pixie_tpu_torch.types import DataType as DT, Relation

_CLK_TCK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


class ProcessStatsConnector(SourceConnector):
    """Samples /proc/<pid>/stat for every visible process.

    Table process_stats: time_, pid, cmd, utime_ns, stime_ns, rss_bytes,
    vsize_bytes, num_threads (reference process_stats_connector.h table).
    """

    name = "process_stats"

    def __init__(self, sample_period_s: float = 1.0):
        self.sample_period_s = sample_period_s

    def tables(self) -> list[TableSpec]:
        return [
            TableSpec(
                "process_stats",
                Relation.of(
                    ("time_", DT.TIME64NS),
                    ("pid", DT.INT64),
                    ("cmd", DT.STRING),
                    ("utime_ns", DT.INT64),
                    ("stime_ns", DT.INT64),
                    ("rss_bytes", DT.INT64),
                    ("vsize_bytes", DT.INT64),
                    ("num_threads", DT.INT64),
                ),
                sample_period_s=self.sample_period_s,
            )
        ]

    def transfer_data(self) -> dict[str, dict]:
        rows = {k: [] for k in ("pid", "cmd", "utime_ns", "stime_ns",
                                "rss_bytes", "vsize_bytes", "num_threads")}
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            try:
                with open(f"/proc/{entry}/stat", "rb") as f:
                    raw = f.read().decode("ascii", "replace")
            except OSError:
                continue  # process exited between listdir and open
            # comm may contain spaces/parens: split around the LAST ')'.
            lp, rp = raw.find("("), raw.rfind(")")
            if lp < 0 or rp < 0:
                continue
            cmd = raw[lp + 1 : rp]
            fields = raw[rp + 2 :].split()
            # fields[0] is state; utime=11, stime=12, num_threads=17,
            # vsize=20, rss=21 (0-based within the post-comm fields).
            try:
                utime, stime = int(fields[11]), int(fields[12])
                nthreads = int(fields[17])
                vsize, rss = int(fields[20]), int(fields[21])
            except (IndexError, ValueError):
                continue
            rows["pid"].append(int(entry))
            rows["cmd"].append(cmd)
            rows["utime_ns"].append(utime * (1_000_000_000 // _CLK_TCK))
            rows["stime_ns"].append(stime * (1_000_000_000 // _CLK_TCK))
            rows["rss_bytes"].append(rss * _PAGE)
            rows["vsize_bytes"].append(vsize)
            rows["num_threads"].append(nthreads)
        n = len(rows["pid"])
        if n == 0:
            return {}
        out = {"time_": np.full(n, now_ns(), dtype=np.int64)}
        out.update(rows)
        return {"process_stats": out}


class NetworkStatsConnector(SourceConnector):
    """Samples /proc/net/dev per-interface counters.

    Table network_stats: time_, interface, rx_bytes, rx_packets, tx_bytes,
    tx_packets (reference network_stats_connector.h, 1s cadence).
    """

    name = "network_stats"

    def __init__(self, sample_period_s: float = 1.0):
        self.sample_period_s = sample_period_s

    def tables(self) -> list[TableSpec]:
        return [
            TableSpec(
                "network_stats",
                Relation.of(
                    ("time_", DT.TIME64NS),
                    ("interface", DT.STRING),
                    ("rx_bytes", DT.INT64),
                    ("rx_packets", DT.INT64),
                    ("tx_bytes", DT.INT64),
                    ("tx_packets", DT.INT64),
                ),
                sample_period_s=self.sample_period_s,
            )
        ]

    def transfer_data(self) -> dict[str, dict]:
        try:
            with open("/proc/net/dev", "r") as f:
                lines = f.readlines()[2:]  # skip 2 header lines
        except OSError:
            return {}
        rows = {k: [] for k in ("interface", "rx_bytes", "rx_packets",
                                "tx_bytes", "tx_packets")}
        for line in lines:
            if ":" not in line:
                continue
            iface, rest = line.split(":", 1)
            f = rest.split()
            if len(f) < 12:
                continue
            rows["interface"].append(iface.strip())
            rows["rx_bytes"].append(int(f[0]))
            rows["rx_packets"].append(int(f[1]))
            rows["tx_bytes"].append(int(f[8]))
            rows["tx_packets"].append(int(f[9]))
        n = len(rows["interface"])
        if n == 0:
            return {}
        out = {"time_": np.full(n, now_ns(), dtype=np.int64)}
        out.update(rows)
        return {"network_stats": out}
