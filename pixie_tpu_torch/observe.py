"""Query flight recorder: every query becomes data served by the engine.

The engine grew a deep stack of invisible fast paths — plan cache, matview
serves, resident feeds, batched dispatch, failover/hedging — but the
spans give a timeline, not attribution: nothing answers "which fast paths
fired for THIS query and where did its time actually go?".  This module
closes that loop with the system's own machinery (the Tailwind argument:
accelerator query frameworks need honest end-to-end accounting):

  * **Per-query profiles** — the broker and `LocalCluster` assemble, from
    the per-query `stats` they already collect plus explicit phase timers,
    one structured row per query: admission wait, compile, plan split,
    dispatch/exec, merge ns; h2d/d2h bytes; rows scanned/output; and the
    full cache/fault provenance (plan-cache and split-cache hits, matview
    hit/stale serves, resident feeds, batch membership + dedup slot,
    failover routes, hedges/evictions/retries).  Rows ingest through the
    NORMAL write path into ``self_telemetry.query_profiles`` (+ per-op
    ``self_telemetry.op_stats``), so PxL scripts and standing matviews
    dashboard the engine at O(delta) like any other telemetry.
  * **EXPLAIN ANALYZE** — ``execute_script(explain=True)`` (CLI
    ``run --explain``) returns the annotated plan tree with per-op ns,
    rows, bytes and the provenance block, correct for distributed,
    batched (member demux), matview-hit, and failover-served queries.
  * **Metrics as data** — ``sample_metrics_rows`` folds the whole metrics
    registry (counters, gauges, histogram sum/count/p50/p99 via
    ``metrics.hist_quantile``) into ``self_telemetry.metrics`` rows; the
    broker/agents run it on a `PL_SELF_METRICS_S` cron cadence.

Everything here is gated on ``PL_TRACING_ENABLED`` (profiles ride the same
master switch as spans): with tracing off no profile is assembled, no row
is written, and query results are bit-identical to the uninstrumented
path.  ``explain=True`` is an explicit per-query opt-in that works either
way (it assembles the profile for the answer without recording it).

Copied from the reference package (pixie_tpu/observe.py).  In the port
LocalCluster assembles the profiles (the broker comes with the services
slice), and `render_explain` says how the per-op ns were taken: on a CUDA
device an EXPLAIN query's executors synchronize the device at every
operator frame's ends, so an op's ns hold its kernels.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

from pixie_tpu_torch import flags, metrics, trace
from pixie_tpu_torch.types import DataType as DT, Relation, SemanticType as ST

flags.define_float(
    "PL_SELF_METRICS_S", 0.0,
    "cadence (seconds) for folding the metrics registry into "
    "self_telemetry.metrics (and evaluating PL_SLO burn rates); 0 disables "
    "the sampler")

#: per-query op rows kept in self_telemetry.op_stats (a pathological plan
#: with thousands of compiled chains must not flood the telemetry table)
MAX_OP_ROWS = 128

#: telemetry rows buffered per process; rows arriving at a full buffer are
#: dropped (counted) until a flush drains it — the flight recorder must
#: never become the memory leak it exists to catch
MAX_PENDING_ROWS = 4096

PROFILES_TABLE = "self_telemetry.query_profiles"
OP_STATS_TABLE = "self_telemetry.op_stats"
METRICS_TABLE = "self_telemetry.metrics"
ALERTS_TABLE = "self_telemetry.alerts"
SCALE_EVENTS_TABLE = "self_telemetry.scale_events"
SHARD_HEAT_TABLE = "self_telemetry.shard_heat"
STORAGE_STATE_TABLE = "self_telemetry.storage_state"
AUTOTUNE_TABLE = "self_telemetry.autotune"

PROFILES_RELATION = Relation.of(
    ("time_", DT.TIME64NS, ST.ST_TIME_NS),
    ("query_id", DT.STRING),
    ("tenant", DT.STRING),
    ("service", DT.STRING),
    ("status", DT.STRING),
    ("error", DT.STRING),
    ("wall_ns", DT.INT64, ST.ST_DURATION_NS),
    ("admission_wait_ns", DT.INT64, ST.ST_DURATION_NS),
    ("compile_ns", DT.INT64, ST.ST_DURATION_NS),
    ("plan_split_ns", DT.INT64, ST.ST_DURATION_NS),
    ("exec_ns", DT.INT64, ST.ST_DURATION_NS),
    ("merge_ns", DT.INT64, ST.ST_DURATION_NS),
    ("accounted_ns", DT.INT64, ST.ST_DURATION_NS),
    ("agents", DT.INT64),
    ("rows_scanned", DT.INT64),
    ("rows_output", DT.INT64),
    ("h2d_bytes", DT.INT64, ST.ST_BYTES),
    ("d2h_bytes", DT.INT64, ST.ST_BYTES),
    ("plan_cache_hit", DT.INT64),
    ("split_cache_hit", DT.INT64),
    ("matview_eligible", DT.INT64),
    ("matview_hits", DT.INT64),
    ("matview_stale", DT.INT64),
    ("matview_rows_folded", DT.INT64),
    ("resident_feeds", DT.INT64),
    ("batch_size", DT.INT64),
    ("batch_slot", DT.INT64),
    ("failover", DT.STRING),
    ("hedged", DT.INT64),
    ("evictions", DT.INT64),
    ("retries", DT.INT64),
    ("chunks_discarded", DT.INT64),
    ("degraded", DT.INT64),
)

OP_STATS_RELATION = Relation.of(
    ("time_", DT.TIME64NS, ST.ST_TIME_NS),
    ("query_id", DT.STRING),
    ("agent", DT.STRING),
    ("op", DT.STRING),
    ("wall_ns", DT.INT64, ST.ST_DURATION_NS),
    ("self_ns", DT.INT64, ST.ST_DURATION_NS),
    ("rows_out", DT.INT64),
    ("bytes_out", DT.INT64, ST.ST_BYTES),
)

METRICS_RELATION = Relation.of(
    ("time_", DT.TIME64NS, ST.ST_TIME_NS),
    ("service", DT.STRING),
    ("name", DT.STRING),
    ("labels", DT.STRING),
    ("kind", DT.STRING),
    ("value", DT.FLOAT64),
)

ALERTS_RELATION = Relation.of(
    ("time_", DT.TIME64NS, ST.ST_TIME_NS),
    ("slo", DT.STRING),
    ("tenant", DT.STRING),
    ("window", DT.STRING),
    ("burn_rate", DT.FLOAT64),
    ("threshold", DT.FLOAT64),
    ("objective", DT.FLOAT64),
    ("state", DT.STRING),
)

#: autoscaler control-loop decisions (serving/elastic.py): every spawn,
#: retire, hand-off and refused retire lands here with the smoothed
#: pressure that drove it and the live agent count after it — the fleet's
#: own sizing history is queryable like any other telemetry
SCALE_EVENTS_RELATION = Relation.of(
    ("time_", DT.TIME64NS, ST.ST_TIME_NS),
    ("action", DT.STRING),
    ("agent", DT.STRING),
    ("reason", DT.STRING),
    ("pressure", DT.FLOAT64),
    ("agents", DT.INT64),
)

#: the storage-side twin of the query profiles (pixie_tpu_torch.table.heat): the
#: decayed per-(table, shard, serving tier, batch-age bucket) access model,
#: folded on the PL_SELF_METRICS_S cron.  `skew` is the per-table max/mean
#: shard heat — the signal the shard rebalancer (services/rebalance.py) reads.
SHARD_HEAT_RELATION = Relation.of(
    ("time_", DT.TIME64NS, ST.ST_TIME_NS),
    ("table_name", DT.STRING),
    ("shard", DT.STRING),
    ("tier", DT.STRING),
    ("age_bucket", DT.STRING),
    ("rows_scanned", DT.INT64),
    ("bytes", DT.INT64, ST.ST_BYTES),
    ("heat", DT.FLOAT64),
    ("skew", DT.FLOAT64),
    ("last_access", DT.TIME64NS, ST.ST_TIME_NS),
)

#: per-(agent, table) storage accounting: what each agent actually HOLDS —
#: hot rows, sealed batches with their age histogram (JSON {bucket: count}),
#: journal bytes/segments on disk, resident-tier and matview state bytes,
#: and replication lag as the sealed-vs-acked watermark delta per peer
#: (`peer_lag` is JSON {peer: batches}; `repl_lag_batches` its max).  The
#: journal/replication columns are per-table (journals are per-table files;
#: lag is stamped on every row of the owning agent for joinability).
STORAGE_STATE_RELATION = Relation.of(
    ("time_", DT.TIME64NS, ST.ST_TIME_NS),
    ("agent", DT.STRING),
    ("table_name", DT.STRING),
    ("hot_rows", DT.INT64),
    ("sealed_batches", DT.INT64),
    ("sealed_bytes", DT.INT64, ST.ST_BYTES),
    ("age_histogram", DT.STRING),
    ("resident_bytes", DT.INT64, ST.ST_BYTES),
    ("matview_bytes", DT.INT64, ST.ST_BYTES),
    ("journal_bytes", DT.INT64, ST.ST_BYTES),
    ("journal_segments", DT.INT64),
    ("repl_lag_batches", DT.INT64),
    ("peer_lag", DT.STRING),
    ("cold_bytes", DT.INT64, ST.ST_BYTES),
    ("cold_segments", DT.INT64),
)

#: adaptive-gate decision stream (engine/autotune.py): every profile-fed
#: gate decision (and every tail-guard fallback, source="fallback") with
#: the model inputs that drove it — "why did this query take this path"
#: is a PxL query, not a debugger session
AUTOTUNE_RELATION = Relation.of(
    ("time_", DT.TIME64NS, ST.ST_TIME_NS),
    ("query_id", DT.STRING),
    ("gate", DT.STRING),
    ("plan_class", DT.STRING),
    ("size_bucket", DT.STRING),
    ("arm", DT.STRING),
    ("static_arm", DT.STRING),
    ("source", DT.STRING),
    ("model_ms", DT.FLOAT64),
    ("static_ms", DT.FLOAT64),
    ("observed_ms", DT.FLOAT64),
    ("reason", DT.STRING),
)

SELF_TABLES: dict[str, Relation] = {
    PROFILES_TABLE: PROFILES_RELATION,
    OP_STATS_TABLE: OP_STATS_RELATION,
    METRICS_TABLE: METRICS_RELATION,
    ALERTS_TABLE: ALERTS_RELATION,
    SCALE_EVENTS_TABLE: SCALE_EVENTS_RELATION,
    SHARD_HEAT_TABLE: SHARD_HEAT_RELATION,
    STORAGE_STATE_TABLE: STORAGE_STATE_RELATION,
    AUTOTUNE_TABLE: AUTOTUNE_RELATION,
}


def enabled() -> bool:
    """Profiles ride the tracing master switch: fully off means no profile
    is assembled and results are bit-identical to the uninstrumented path."""
    return trace.enabled()


# ------------------------------------------------------------ table storage


def ensure_table(store, table: str):
    """Get-or-create one self-telemetry table (raced creations fold into
    the winner — same contract as trace.ensure_table)."""
    if not store.has(table):
        try:
            store.create(table, SELF_TABLES[table], batch_rows=1024)
        except Exception:
            pass  # lost a creation race; the table exists now
    return store.table(table)


def ensure_self_tables(store) -> None:
    """Create every flight-recorder table in `store` (agents call this
    before registration so the broker's registry knows the schemas from
    the first handshake)."""
    for table in SELF_TABLES:
        ensure_table(store, table)


def write_rows(store, table: str, rows: list[dict]) -> int:
    """Append telemetry rows (dicts in the table's relation) through the
    normal table write path — the same path user telemetry takes."""
    if not rows:
        return 0
    import numpy as np

    rel = SELF_TABLES[table]
    t = ensure_table(store, table)
    cols: dict = {}
    for c in rel:
        if c.data_type == DT.STRING:
            cols[c.name] = [str(r.get(c.name, "")) for r in rows]
        elif c.data_type == DT.FLOAT64:
            cols[c.name] = np.asarray(
                [float(r.get(c.name, 0.0) or 0.0) for r in rows],
                dtype=np.float64)
        else:
            cols[c.name] = np.asarray(
                [int(r.get(c.name, 0) or 0) for r in rows], dtype=np.int64)
    t.write(cols)
    return len(rows)


class RowBuffer:
    """Bounded per-process buffer of pending telemetry rows, grouped by
    table.  The broker drains it into its ship-to-agent path at query end;
    LocalCluster flushes into an agent store once `flush_rows` accumulate
    — the batch is sized so the amortized per-query write cost stays well
    under the observe_overhead gate's 5% ceiling (per-row table writes
    WERE the tax the gate caught at threshold 32)."""

    def __init__(self, flush_rows: int = 256,
                 max_rows: int = MAX_PENDING_ROWS):
        self.flush_rows = int(flush_rows)
        self.max_rows = int(max_rows)
        self._lock = threading.Lock()
        self._rows: dict[str, list[dict]] = {}
        self._n = 0
        self.dropped = 0

    def add(self, table: str, rows: list[dict]) -> None:
        if not rows:
            return
        dropped_now = 0
        with self._lock:
            for r in rows:
                if self._n >= self.max_rows:
                    dropped_now += 1
                    continue
                self._rows.setdefault(table, []).append(r)
                self._n += 1
            self.dropped += dropped_now
        if dropped_now:
            metrics.counter_inc(
                "px_telemetry_rows_dropped_total", float(dropped_now),
                help_="telemetry rows dropped by a full flight-recorder "
                      "buffer (bounded per process)")

    def __len__(self) -> int:
        with self._lock:
            return self._n

    def drain(self) -> dict[str, list[dict]]:
        with self._lock:
            out, self._rows, self._n = self._rows, {}, 0
        return out

    def flush_into(self, store, force: bool = False) -> int:
        """Write pending rows into `store` once the flush threshold is
        reached (or unconditionally with force=True).  Returns rows
        written; write failures are counted, never raised."""
        with self._lock:
            if self._n == 0 or (not force and self._n < self.flush_rows):
                return 0
        n = 0
        for table, rows in self.drain().items():
            try:
                n += write_rows(store, table, rows)
            except Exception:
                metrics.counter_inc(
                    "px_telemetry_write_errors_total", float(len(rows)),
                    help_="telemetry rows that failed to persist to the "
                          "local store")
        return n


# --------------------------------------------------------- profile assembly


def _agent_dicts(stats: dict) -> dict[str, dict]:
    return {a: s for a, s in (stats.get("agents") or {}).items()
            if isinstance(s, dict)}


def build_profile(query_id: str, tenant: str, service: str,
                  start_unix_ns: int, wall_ns: int, stats: dict,
                  status: str = "ok", error: str = "",
                  ) -> tuple[dict, list[dict]]:
    """One (profile_row, op_rows) pair from the per-query `stats` the
    broker/LocalCluster already assemble plus the phase timers they stamp
    into ``stats["phases"]``.  Every field is attribution of measured work;
    nothing is modeled."""
    phases = stats.get("phases") or {}
    serving = stats.get("serving") or {}
    fastpath = stats.get("fastpath") or {}
    fault = stats.get("fault") or {}
    batch = stats.get("batch") or {}
    mv = stats.get("matview") or {}
    merger = stats.get("merger") or {}
    agents = _agent_dicts(stats)

    mv_hits = int(mv.get("agents_hit", 0))
    mv_stale = 0
    for s in agents.values():
        info = s.get("matview")
        if isinstance(info, dict):
            if not mv and info.get("hit"):
                mv_hits += 1
            if info.get("hit") and info.get("stale"):
                mv_stale += 1

    op_rows: list[dict] = []

    def _op_sources():
        for a, s in agents.items():
            yield a, s.get("operators") or []
        yield "merger", merger.get("operators") or []

    d2h = 0
    for a, recs in _op_sources():
        for rec in recs:
            if not isinstance(rec, dict):
                continue
            d2h += int(rec.get("bytes_out", 0) or 0)
            if len(op_rows) < MAX_OP_ROWS:
                op_rows.append({
                    "time_": int(rec.get("t0_unix_ns") or start_unix_ns),
                    "query_id": query_id,
                    "agent": a,
                    "op": str(rec.get("label", "")),
                    "wall_ns": int(rec.get("wall_ns", 0) or 0),
                    "self_ns": int(rec.get("self_ns",
                                           rec.get("wall_ns", 0)) or 0),
                    "rows_out": int(rec.get("rows_out", 0) or 0),
                    "bytes_out": int(rec.get("bytes_out", 0) or 0),
                })

    rows_scanned = sum(int(s.get("rows_scanned", 0) or 0)
                       for s in agents.values())
    admission_ns = int(float(serving.get("queued_ms") or 0.0) * 1e6)
    compile_ns = int(phases.get("compile_ns", 0) or 0)
    split_ns = int(phases.get("plan_split_ns", 0) or 0)
    exec_ns = int(phases.get("exec_ns", 0) or 0)
    if exec_ns == 0 and agents:
        exec_ns = max(int(s.get("wall_ns",
                                float(s.get("exec_s", 0.0)) * 1e9) or 0)
                      for s in agents.values())
    merge_ns = int(phases.get("merge_ns", 0) or 0)
    accounted = admission_ns + compile_ns + split_ns + exec_ns + merge_ns

    profile = {
        "time_": int(start_unix_ns),
        "query_id": query_id,
        "tenant": str(tenant or ""),
        "service": service,
        "status": status,
        "error": str(error or "")[:200],
        "wall_ns": int(wall_ns),
        "admission_wait_ns": admission_ns,
        "compile_ns": compile_ns,
        "plan_split_ns": split_ns,
        "exec_ns": exec_ns,
        "merge_ns": merge_ns,
        "accounted_ns": accounted,
        "agents": len(agents),
        "rows_scanned": rows_scanned,
        "rows_output": int(merger.get("rows_output", 0) or 0),
        "h2d_bytes": sum(int(s.get("h2d_bytes", 0) or 0)
                         for s in agents.values()),
        "d2h_bytes": d2h,
        "plan_cache_hit": int(bool(fastpath.get("plan_cache_hit"))),
        "split_cache_hit": int(bool(fastpath.get("split_cache_hit"))),
        "matview_eligible": int(mv.get("eligible_agents", 0) or 0),
        "matview_hits": mv_hits,
        "matview_stale": mv_stale,
        "matview_rows_folded": int(mv.get("rows_folded", 0) or 0),
        "resident_feeds": sum(int(s.get("resident_feeds", 0) or 0)
                              for s in agents.values()),
        "batch_size": int(batch.get("size", 0) or 0),
        "batch_slot": int(batch.get("slot", -1) if batch else -1),
        "failover": (json.dumps(fault.get("failover"), sort_keys=True)
                     if fault.get("failover") else ""),
        "hedged": int(fault.get("hedged", 0) or 0),
        "evictions": int(fault.get("evictions", 0) or 0),
        "retries": int(fault.get("rounds", 0) or 0),
        "chunks_discarded": int(fault.get("chunks_discarded", 0) or 0),
        "degraded": int(bool(serving.get("degraded"))),
    }
    # adaptive-gate provenance rides the profile as a non-relation key
    # (write_rows only persists relation columns; the full decision rows
    # land in self_telemetry.autotune via autotune.rows_from_stats)
    at = stats.get("autotune") or any(
        isinstance(s, dict) and s.get("autotune")
        for s in agents.values())
    if at:
        from pixie_tpu_torch.engine import autotune as _autotune

        profile["autotune"] = _autotune.summary_from_stats(stats)
    return profile, op_rows


# ----------------------------------------------------------- EXPLAIN ANALYZE


def _ms(ns) -> str:
    return f"{int(ns or 0) / 1e6:.2f}ms"


def _provenance_lines(profile: dict) -> list[str]:
    out = []
    out.append(
        f"  plan cache: {'HIT' if profile['plan_cache_hit'] else 'miss'}"
        f"   split cache: {'HIT' if profile['split_cache_hit'] else 'miss'}")
    if profile["matview_eligible"] or profile["matview_hits"]:
        stale = (f" ({profile['matview_stale']} stale)"
                 if profile["matview_stale"] else "")
        out.append(
            f"  matview: {profile['matview_hits']}/"
            f"{profile['matview_eligible'] or profile['matview_hits']} "
            f"agent fragments served from standing view state{stale}, "
            f"{profile['matview_rows_folded']} delta rows folded")
    if profile["resident_feeds"]:
        out.append(f"  resident tier: {profile['resident_feeds']} "
                   f"device-resident feeds (h2d {profile['h2d_bytes']}B)")
    if profile["batch_size"]:
        out.append(
            f"  batched: member of a fused batch of {profile['batch_size']} "
            f"(computed slot q{profile['batch_slot']}, results demuxed)")
    if profile["failover"]:
        out.append(f"  failover: shards served by replicas "
                   f"{profile['failover']}")
    if profile["hedged"] or profile["evictions"] or profile["retries"]:
        out.append(
            f"  fault recovery: {profile['retries']} re-dispatch rounds, "
            f"{profile['evictions']} evictions, {profile['hedged']} hedges, "
            f"{profile['chunks_discarded']} chunks discarded")
    if profile["degraded"]:
        out.append("  degraded dispatch (stale-while-revalidate views, "
                   "narrowed ack window)")
    if profile.get("autotune"):
        out.append(f"  autotune: {profile['autotune']}")
    return out


def render_explain(profile: dict, op_rows: list[dict],
                   plan_text: Optional[str] = None,
                   op_timing: Optional[str] = None) -> str:
    """The EXPLAIN ANALYZE text: the logical plan tree, the measured phase
    breakdown (with % of e2e wall), per-op device/host ns per agent, and
    the provenance block — assembled entirely from the profile, so it is
    correct for whatever path actually served the query (batched members,
    matview hits, failover serves included).  `op_timing` says how the
    per-op ns were taken (kernel launches are asynchronous: on a CUDA device
    an op's host timer holds its kernels only when the device was
    synchronized at its boundaries)."""
    wall = max(int(profile.get("wall_ns", 0)), 1)
    lines = ["== EXPLAIN ANALYZE =="]
    if plan_text:
        lines.append("-- plan:")
        lines.extend(plan_text.splitlines())
    lines.append(
        f"-- phases (e2e {_ms(wall)}, "
        f"{100.0 * profile['accounted_ns'] / wall:.0f}% attributed):")
    for key, label in (("admission_wait_ns", "admission wait"),
                       ("compile_ns", "compile"),
                       ("plan_split_ns", "plan split"),
                       ("exec_ns", "dispatch+exec"),
                       ("merge_ns", "merge")):
        ns = int(profile.get(key, 0) or 0)
        lines.append(f"  {label:<16} {_ms(ns):>10}  "
                     f"{100.0 * ns / wall:5.1f}%")
    if op_rows:
        lines.append("-- operators (per compiled unit):")
        if op_timing:
            lines.append(f"  timing: {op_timing}")
        lines.append(f"  {'agent':<10} {'op':<44} {'wall':>10} "
                     f"{'self':>10} {'rows':>10}")
        for r in op_rows:
            lines.append(
                f"  {r['agent'][:10]:<10} {r['op'][:44]:<44} "
                f"{_ms(r['wall_ns']):>10} {_ms(r['self_ns']):>10} "
                f"{r['rows_out']:>10}")
    lines.append("-- provenance:")
    lines.extend(_provenance_lines(profile))
    lines.append(
        f"-- io: scanned {profile['rows_scanned']} rows on "
        f"{profile['agents']} agents, h2d {profile['h2d_bytes']}B, "
        f"d2h {profile['d2h_bytes']}B, output {profile['rows_output']} rows")
    return "\n".join(lines)


def explain_local(plan, exec_stats: dict, wall_ns: int,
                  query_id: str = "local", op_timing: Optional[str] = None) -> str:
    """EXPLAIN rendering for the single-process path (CLI demo data): adapt
    one executor's exec_stats into the profile shape."""
    from pixie_tpu_torch.plan.debug import explain as plan_explain

    stats = {"agents": {"local": dict(exec_stats)},
             "merger": {"rows_output": exec_stats.get("rows_output", 0)}}
    profile, op_rows = build_profile(
        query_id, "", "local", time.time_ns(), wall_ns, stats)
    return render_explain(profile, op_rows, plan_text=plan_explain(plan),
                          op_timing=op_timing)


# ------------------------------------------------------------ metrics-as-data


def sample_metrics_rows(service: str,
                        now_ns: Optional[int] = None) -> list[dict]:
    """Fold the metrics registry into self_telemetry.metrics rows: every
    counter/gauge series, evaluated lazy gauges, and histogram sum/count
    plus p50/p99 read through metrics.hist_quantile — the registry becomes
    a queryable table instead of a scrape-only text page."""
    now_ns = int(now_ns if now_ns is not None else time.time_ns())

    def row(name, labels, kind, value):
        return {"time_": now_ns, "service": service, "name": name,
                "labels": json.dumps(dict(labels), sort_keys=True)
                if labels else "", "kind": kind, "value": float(value)}

    out = []
    for kind, name, labels, value in metrics.snapshot():
        out.append(row(name, labels, kind, value))
    return out
