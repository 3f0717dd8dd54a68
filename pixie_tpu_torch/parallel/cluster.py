"""In-process distributed execution harness.

Reference test strategy (SURVEY.md §4): every distributed behavior has an
in-process seam — fake agent topologies for the planner, local loopback for
shuffle edges.  LocalCluster is that seam made first-class: each agent has its
own TableStore (its own dictionary code spaces, like independent PEMs), the
planner splits queries across them, agents run their fragments, and channel
payloads are merged exactly as a remote merger would — including a real
serialization round-trip so the wire format is exercised on every query.

Copied from the reference package (pixie_tpu/parallel/cluster.py).  The
agents share one device (CUDA unless the caller passes another): they run
concurrently in a thread pool, every agent's partial aggregate state stays on
the device, and per agg_state channel all agents' states merge there in one
launch of kernel M1 when their layouts agree (else each is read back and
merged by key values on the host); one readback wave follows.

`n_devices_per_agent` gives each agent a mesh (parallel/spmd.py) of that
many co-located shards of the device (None: the default mesh, 1: none), over
which its executor shards every unlimited aggregate and exchanges the rows of
a repartitioned join in the mesh (kernels X1, X2).  Repartitioned joins run
as the reference runs them: the agents' partition sinks hash both sides into
bucket channels, each partition's buckets join in a worker (`run_join_stages`,
parallel/repartition.py), and the merger reads the joined channel.

Concurrent-query batching (PL_QUERY_BATCHING, serving/batching.py) runs as
in the reference: groupable concurrent queries rendezvous at `query()`, the
leader fuses the member plans, splits the fused plan once per batch
signature and executes it once (its agents run the members' partial
aggregates as one multi-query gang, kernel G1), and each member gets its
demuxed results with exec_stats["batch"].  The batch window is the static
flag (the reference's autotuned window is host-layer work), and there are no
tenant namespaces.

Plan verification (PX_PLAN_VERIFY, check/planverify.py) runs on every
freshly computed split, the fused split of a batch included; a split-cache
hit is a verified split, so a warm query verifies nothing.  Results carry
the logical plan's semantic types (engine/semantics.py restamp_result).
With tracing on (PL_TRACING_ENABLED) every query leaves a flight-recorder
profile (observe.py) in `self_telemetry.query_profiles` and its operators in
`self_telemetry.op_stats` on the first agent store, and SLO alerts
(serving/slo.py) and autotune decisions there too; each agent's feeds bump
the shard-heat model (table/heat.py), which `fold_storage_observatory`
writes with every store's storage state.  All of it reads host-side
counters only.  `query(explain=True)` adds the EXPLAIN ANALYZE text, whose
per-operator ns come from executors that synchronize a CUDA device at every
operator boundary (the default path never synchronizes for them).

Standing views (PL_MATVIEW_ENABLED, on by default, matview/) run as in the
reference: each agent has a MatViewManager on the cluster's device; the
first sight of a partial-agg fragment registers a view, and later sights
(not under analyze) answer from the view's standing state after folding
the rows appended since its watermark.  Such an agent's payload is a host
PartialAggBatch; the other agents' device states gang-merge among
themselves and then merge by key values with it.

UDTF sources (px.GetTables(), px.GetAgentStatus(), ...) run in the merger
plan (the reference's merger scope) with the agents' schema catalog.

Not ported yet: one process over several distinct cards (the multi-card
slice; parallel/multihost.py spans cards with one process a card) and
tracepoint mutations (ROADMAP Queue 1 item 6e).
Streaming queries over a cluster run through parallel/streaming.py.
"""
from __future__ import annotations

import threading
import time as _time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from pixie_tpu_torch import observe as _observe
from pixie_tpu_torch import trace as _trace
from pixie_tpu_torch.check import planverify
from pixie_tpu_torch.engine import transfer
from pixie_tpu_torch.engine.eval import apply_lut_np
from pixie_tpu_torch.engine.executor import (
    HostBatch,
    PlanExecutor,
    _DeferredPartial,
    gang_merge_states,
    resolve_device,
)
from pixie_tpu_torch.engine.plancache import QueryPlanCache
from pixie_tpu_torch.engine.result import QueryResult
from pixie_tpu_torch.engine.semantics import SchemaStore, restamp_result
from pixie_tpu_torch.matview import MatViewManager
from pixie_tpu_torch.parallel.distributed import DistributedPlanner
from pixie_tpu_torch.parallel.partial import (
    PartialAggBatch,
    PartialAggFold,
    combine_partials,
    finalize_partial,
    merge_partials,
)
from pixie_tpu_torch.parallel.repartition import (
    bucket_channels,
    run_join_stages,
    stage_output_inputs,
)
from pixie_tpu_torch.parallel.topology import AgentInfo, ClusterSpec
from pixie_tpu_torch.plan.plan import Plan, UDTFSourceOp
from pixie_tpu_torch.status import Internal, InvalidArgument, Unimplemented
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.table.table import TableStore


class HostBatchUnion:
    """Incremental union of row batches from different producers: each add()
    reconciles the chunk's dictionary code space into the running merged
    dictionaries and stashes the translated columns; finish() pays one
    concatenation.

    Row order follows fold order; distributed row-channel consumers are
    order-insensitive (the merger re-aggregates / re-sorts as the plan
    demands), matching the per-agent arrival order semantics.
    """

    __slots__ = ("count", "_first", "_dicts", "_parts")

    def __init__(self):
        self.count = 0
        self._first: HostBatch | None = None
        self._dicts: dict[str, Dictionary] = {}
        self._parts: dict[str, list[np.ndarray]] = {}

    def add(self, hb: HostBatch) -> None:
        self.count += 1
        if self._first is None:
            self._first = hb
            self._dicts = {n: Dictionary() for n in hb.dicts}
            self._parts = {n: [] for n in hb.dtypes}
        if hb.num_rows == 0:
            return
        self._fold_cols(hb)

    def _fold_cols(self, hb: HostBatch) -> None:
        for name in self._first.dtypes:
            if name in self._dicts:
                lut = hb.dicts[name].translate_to(self._dicts[name], insert=True)
                self._parts[name].append(apply_lut_np(lut, hb.cols[name]))
            else:
                self._parts[name].append(hb.cols[name])

    def finish(self) -> HostBatch:
        first = self._first
        if first is None:
            raise InvalidArgument("HostBatchUnion.finish: no chunks folded")
        if not any(self._parts.values()):
            # every chunk was empty: fold the first chunk anyway so the
            # result still carries its dtypes/dictionary values
            self._fold_cols(first)
        cols = {
            name: (parts[0] if len(parts) == 1 else np.concatenate(parts))
            for name, parts in self._parts.items()
        }
        return HostBatch(dict(first.dtypes), dict(self._dicts), cols)


def _union_host_batches(batches: list[HostBatch]) -> HostBatch:
    """Concatenate row batches from different agents, reconciling each
    dictionary code space into a fresh merged dictionary."""
    u = HostBatchUnion()
    for b in batches:
        u.add(b)
    return u.finish()


class SourceKeyedFold:
    """Per-producer fold accounting for one merge-input channel (the
    networked broker's, services/broker.py).

    The fault-tolerant broker must be able to DISCARD one producer's
    contribution after the fact — an evicted agent whose chunks partially
    arrived, or the losing attempt of a hedged duplicate dispatch — without
    poisoning the merge.  A single shared accumulator cannot un-fold; this
    keys one sub-accumulator per source id (``agent#attempt``), keeps the
    incremental-fold overlap per source, and pays one cross-source combine
    at finish over the ACCEPTED sources only.

    Accepted sources merge in sorted-source order (one accepted attempt per
    agent), so the combine order — and therefore float state reductions —
    is deterministic regardless of cross-agent arrival interleaving;
    re-dispatched and hedged runs fold bit-equal to fault-free ones.  The
    merge is the host's (combine_partials / finalize_partial), as the
    reference's broker merges.
    """

    __slots__ = ("kind", "agg", "registry", "subs", "counts")

    def __init__(self, kind: str, agg=None, registry=None):
        self.kind = kind  # "agg_state" | "rows"
        self.agg = agg
        self.registry = registry
        self.subs: dict[str, object] = {}
        self.counts: dict[str, int] = {}

    def add(self, src: str, payload) -> None:
        sub = self.subs.get(src)
        if sub is None:
            sub = self.subs[src] = (
                PartialAggFold(self.agg, self.registry)
                if self.kind == "agg_state" else HostBatchUnion())
        if self.kind == "agg_state":
            if not isinstance(payload, PartialAggBatch):
                raise TypeError("expected agg_state payloads")
        elif not isinstance(payload, HostBatch):
            raise TypeError("expected row payloads")
        sub.add(payload)
        self.counts[src] = self.counts.get(src, 0) + 1

    def count_for(self, src: str) -> int:
        return self.counts.get(src, 0)

    def discarded_chunks(self, accepted: set) -> int:
        """Chunks folded into sources that did NOT win (evicted agents,
        losing hedge attempts) — dropped idempotently at finish."""
        return sum(n for s, n in self.counts.items() if s not in accepted)

    def finish(self, accepted: set) -> HostBatch:
        subs = [self.subs[s] for s in sorted(accepted) if s in self.subs]
        if not subs:
            raise InvalidArgument("SourceKeyedFold.finish: no accepted "
                                  "sources folded")
        if self.kind == "agg_state":
            parts = [p for sub in subs for p in sub.raw_parts()]
            acc = (parts[0] if len(parts) == 1
                   else combine_partials(self.agg, parts, self.registry))
            return finalize_partial(self.agg, acc, self.registry)
        u = HostBatchUnion()
        for sub in subs:
            u.add(sub.finish())
        return u.finish()


class LocalCluster:
    """N agents with private table stores + one merger, in one process, on
    one device."""

    def __init__(self, stores: dict, merger_store: Optional[TableStore] = None,
                 registry=None, device=None, n_devices_per_agent: Optional[int] = None):
        self.stores = dict(stores)
        for name, store in self.stores.items():
            # shard identity for the heat model (table/heat.py): feeds over
            # each agent store account as that agent's shard
            store.node_name = name
        if self.stores and _trace.enabled():
            # flight-recorder tables live in the FIRST agent store, created
            # UP FRONT: a lazy creation mid-run would bump the store's schema
            # epoch and invalidate warm plan-cache entries between otherwise
            # identical queries
            _observe.ensure_self_tables(self.stores[sorted(self.stores)[0]])
        self.merger_store = merger_store or TableStore()
        self.registry = registry
        #: the device every agent's and the merger's PlanExecutor runs on
        self.device = resolve_device(device)
        agents = [
            AgentInfo(
                name=name,
                has_data_store=True,
                processes_data=True,
                accepts_remote_sources=False,
                schemas=store.schemas(),
                n_devices=n_devices_per_agent,
            )
            for name, store in self.stores.items()
        ]
        agents.append(
            AgentInfo(
                name="merger",
                has_data_store=False,
                processes_data=False,
                accepts_remote_sources=True,
                schemas={},
            )
        )
        self.spec = ClusterSpec(agents)
        self.planner = DistributedPlanner(self.spec, registry)
        #: whole-query plan cache (PL_QUERY_FASTPATH): warm repeated scripts
        #: skip re-trace/re-split (engine/plancache.py documents soundness)
        self.plan_cache = QueryPlanCache()
        #: per-agent standing-view maintainers (matview/): repeated
        #: partial-agg fragments answer from O(delta)-refreshed state
        self._mv_managers: dict = {}
        #: guards the batching state below and the view maintainers
        self._mesh_lock = threading.Lock()
        #: concurrent-query batching rendezvous (PL_QUERY_BATCHING):
        #: groupable concurrent queries fuse into one dispatch, results demux
        #: per member (serving/batching.py); built on the first groupable query
        self._batcher = None
        #: batch signature -> BatchSlot (fused plan, sink map, split slot), so
        #: warm repeats of the same member set skip re-merge and re-split
        self._batch_splits: OrderedDict = OrderedDict()
        #: concurrent query() calls in flight: the batching gate's
        #: concurrent-traffic signal
        self._query_inflight = 0
        #: query flight recorder (observe.py): per-query profile and op-stat
        #: rows buffered here and flushed into the first agent store in
        #: batches (a table write a query would be the instrumentation tax)
        self._telemetry = _observe.RowBuffer()

    def matviews(self, agent_name: str):
        # under _mesh_lock: concurrent execute() calls must not each
        # construct a manager and orphan one side's view registrations
        with self._mesh_lock:
            mgr = self._mv_managers.get(agent_name)
            if mgr is None:
                mgr = self._mv_managers[agent_name] = MatViewManager(
                    self.stores[agent_name], self.registry, device=self.device)
            return mgr

    def schemas(self) -> dict:
        return self.spec.combined_schemas()

    def _agent_mesh(self, agent_name: str):
        """Resolve an agent's mesh from AgentInfo.n_devices: None = the
        default mesh ("auto"), 1 = single device, N = N co-located shards."""
        info = next(a for a in self.spec.agents if a.name == agent_name)
        n = info.n_devices
        if n is None:
            return "auto"
        if n <= 1:
            return None
        from pixie_tpu_torch.parallel.spmd import make_mesh

        # Clamp to a power of two: feed buckets are pow2-sized, so e.g. a
        # 6-shard mesh would fail every divisibility gate and silently run
        # single-device (same clamp as spmd.default_mesh).
        return make_mesh(1 << (n.bit_length() - 1), device=self.device)

    def _schemas_fp(self) -> tuple:
        """Schema fingerprint for the plan cache: per-store table-set epochs
        (bumped by create/drop).  Relations are immutable, so the epochs pin
        the combined schema view exactly."""
        return tuple(sorted((n, s.epoch) for n, s in self.stores.items()))

    def query(self, pxl_source: str, func: Optional[str] = None,
              func_args: Optional[dict] = None, now: Optional[int] = None,
              default_limit: Optional[int] = None,
              analyze: bool = False, explain: bool = False) -> dict[str, QueryResult]:
        """Compile a PxL script against the cluster's combined schemas and
        execute it distributed (the ExecuteScript analog).  Warm repeats of
        the same script hit the whole-query plan cache and skip the compile
        and distributed-split work entirely (bit-equal results — the cached
        plan IS the plan a recompile would produce).  A cacheable query may
        run as a member of a batch with concurrent queries over the same scan
        (PL_QUERY_BATCHING, `_maybe_batched_query`).

        With tracing on (PL_TRACING_ENABLED) every query also leaves a
        flight-recorder profile in `self_telemetry.query_profiles` on the
        first agent store; `explain=True` additionally attaches the EXPLAIN
        ANALYZE text to each result's ``exec_stats["explain"]`` (and works
        with tracing off)."""
        from pixie_tpu_torch.engine import autotune as _autotune

        if _autotune.enabled():
            # arrival-rate signal for the batch-window controller
            _autotune.MODEL.observe_arrival()
        prof_on = _trace.enabled() or explain
        prof: dict = {}
        t0 = _time.perf_counter_ns()
        t0_unix = _time.time_ns()
        with self._mesh_lock:
            self._query_inflight += 1
        try:
            results = self._query(pxl_source, func, func_args, now, default_limit,
                                  analyze, prof if prof_on else None, explain=explain)
        except Exception as e:
            if _trace.enabled():
                self._observe_query(None, prof, t0_unix, _time.perf_counter_ns() - t0,
                                    explain=False, error=str(e))
            raise
        finally:
            with self._mesh_lock:
                self._query_inflight -= 1
        if prof_on:
            self._observe_query(results, prof, t0_unix, _time.perf_counter_ns() - t0,
                                explain=explain)
        return results

    def _observe_query(self, results, prof: dict, t0_unix: int, wall_ns: int,
                       explain: bool, error: str = "") -> None:
        """Assemble and record one query's flight-recorder profile from its
        results' exec_stats and the phase timers `_query` filled.  Host
        counters only: it reads no device tensor and synchronizes nothing."""
        import secrets as _secrets

        from pixie_tpu_torch.serving import slo as _slo

        first = next(iter(results.values())) if results else None
        es = first.exec_stats if first is not None else {}
        stats = {
            "agents": es.get("agents") or {},
            "merger": {"operators": es.get("operators") or [],
                       "rows_output": es.get("rows_output", 0)},
            "phases": prof.get("phases") or {},
            "fastpath": prof.get("fastpath") or {},
            "batch": es.get("batch") or {},
            "autotune": es.get("autotune") or [],
        }
        c = _trace.current()
        qid = c[1].trace_id if c is not None else _secrets.token_hex(16)
        profile, op_rows = _observe.build_profile(
            qid, "", "cluster", t0_unix, wall_ns, stats,
            status="error" if error else "ok", error=error)
        if explain and results:
            text = _observe.render_explain(
                profile, op_rows, plan_text=prof.get("plan_text"),
                op_timing=_op_timing_note(self.device))
            for r in results.values():
                r.exec_stats["explain"] = text
        if results:
            for r in results.values():
                r.exec_stats["profile"] = profile
        if _trace.enabled():
            self._telemetry.add(_observe.PROFILES_TABLE, [profile])
            self._telemetry.add(_observe.OP_STATS_TABLE, op_rows)
            from pixie_tpu_torch.engine import autotune as _autotune

            if _autotune.enabled():
                # per-query decisions + pending model events (the
                # LocalCluster analog of the broker's self-metrics cron)
                at_rows = _autotune.rows_from_stats(stats, qid)
                at_rows += _autotune.MODEL.drain_rows()
                if at_rows:
                    self._telemetry.add(_observe.AUTOTUNE_TABLE, at_rows)
            _slo.record_query("", wall_ns / 1e9, not error)
            if _slo.configured():
                # burn-rate edges reach self_telemetry.alerts on a
                # LocalCluster-only deployment too
                mon = _slo.monitor()
                mon.maybe_evaluate()
                self._telemetry.add(_observe.ALERTS_TABLE, mon.drain_alerts())
            store = self.stores[sorted(self.stores)[0]]
            self._telemetry.flush_into(store)

    def flush_telemetry(self) -> int:
        """Force-flush buffered flight-recorder rows into the first agent
        store (tests and shutdown paths; the query path flushes in
        batches)."""
        store = self.stores[sorted(self.stores)[0]]
        return self._telemetry.flush_into(store, force=True)

    def fold_storage_observatory(self) -> int:
        """The broker-less analog of the agents' PL_SELF_METRICS_S cron:
        fold the decayed shard-heat snapshot plus EVERY agent store's
        storage state into the telemetry store (table/heat.py), so
        self_telemetry.shard_heat / .storage_state answer on a LocalCluster
        deployment too.  Returns rows written (0 with tracing off)."""
        from pixie_tpu_torch.table import heat as _heat

        if not _observe.enabled() or not self.stores:
            return 0
        telemetry_store = self.stores[sorted(self.stores)[0]]
        n = _observe.write_rows(telemetry_store, _observe.SHARD_HEAT_TABLE,
                                _heat.snapshot_rows())
        for name in sorted(self.stores):
            n += _observe.write_rows(
                telemetry_store, _observe.STORAGE_STATE_TABLE,
                _heat.storage_state_rows(
                    self.stores[name], name,
                    matviews=self._mv_managers.get(name)))
        return n

    def _query(self, pxl_source, func, func_args, now, default_limit, analyze,
               prof=None, explain: bool = False):
        from pixie_tpu_torch.compiler import compile_pxl

        fp = self._schemas_fp()
        key = self.plan_cache.key(pxl_source, func, func_args, default_limit, fp)
        t_c0 = _time.perf_counter_ns()
        q, entry, _hit = self.plan_cache.get_query(
            key, lambda: compile_pxl(pxl_source, self.schemas(), func=func,
                                     func_args=func_args, now=now,
                                     default_limit=default_limit,
                                     registry=self.registry))
        phases = None
        if prof is not None:
            phases = prof.setdefault("phases", {})
            phases["compile_ns"] = _time.perf_counter_ns() - t_c0
            prof["fastpath"] = {"plan_cache_hit": _hit}
            if explain:
                from pixie_tpu_torch.plan.debug import explain as _plan_explain

                prof["plan_text"] = _plan_explain(q.plan)
        if q.mutations:
            raise Unimplemented("tracepoint mutations are not ported yet "
                                "(ROADMAP Queue 1 item 6e)")
        if not analyze and not explain and not getattr(q, "now_sensitive", True):
            # Concurrent-query batching: groupable concurrent queries over the
            # same (table, scan window, schema epoch) rendezvous and dispatch
            # as ONE fused plan with a shared scan; per-member results demux
            # back here.  None = this query runs the normal path.
            got = self._maybe_batched_query(q, key, fp)
            if got is not None:
                return got

        def _split():
            dp = self.planner.plan(q.plan)
            # verification rides the fresh split: a split-cache hit IS a
            # verified split, so warm queries pay zero re-verification
            planverify.maybe_verify(dp, self.schemas(), self.registry)
            return dp, {}

        t_s0 = _time.perf_counter_ns()
        (dp, _extras), _shit = QueryPlanCache.get_split(entry, fp, _split)
        if phases is not None:
            phases["plan_split_ns"] = _time.perf_counter_ns() - t_s0
            prof["fastpath"]["split_cache_hit"] = _shit
        return self.execute(q.plan, analyze=analyze, dp=dp, phases=phases,
                            sync_op_timing=explain)

    # ------------------------------------------------- query batching
    def _maybe_batched_query(self, q, key, fp):
        """Pass one compiled, cache-eligible query through the shared
        batching gate (serving/batching.gate).  Returns the member's demuxed
        results, or None when the query should run the normal path (batching
        off, a plan that cannot batch, or a solo leader)."""
        from pixie_tpu_torch import flags as _flags
        from pixie_tpu_torch.serving import batching

        if not batching.enabled():
            return None
        with self._mesh_lock:
            if self._batcher is None:
                self._batcher = batching.BatchCollector()
            batcher = self._batcher
        window_s = float(_flags.get("PL_BATCH_WINDOW_MS")) / 1e3
        max_n = int(_flags.get("PL_BATCH_MAX_QUERIES"))
        got = batching.gate(
            batcher, q.plan, key, fp, window_s, max_n,
            lambda members: self._execute_batch(members, fp),
            wait_timeout_s=600.0,  # bounded by the leader's own execution
            registry=self.registry,
            concurrency=lambda: self._query_inflight >= 2)
        return got[0] if isinstance(got, tuple) else got

    def _execute_batch(self, members: list, fp) -> list:
        """Leader path: merge the member plans (shared scans, deduped chains,
        renamed sinks; identical members share ONE computed slot), split
        ONCE per batch signature, run one distributed execution, and demux
        per-member result dicts."""
        from pixie_tpu_torch.serving import batching

        slot, plans, slot_of = batching.fused_slot(
            self._batch_splits, self._mesh_lock, members, self.schemas())

        def _split():
            dp = self.planner.plan(slot.fused)
            # the fused form verifies once per batch signature, riding the
            # split cache exactly like single-query verification
            planverify.maybe_verify(dp, self.schemas(), self.registry)
            planverify.maybe_verify_fused_batch(dp, slot.sink_map)
            return dp, {}

        (dp, _extras), _hit = QueryPlanCache.get_split(slot, fp, _split)
        results = self.execute(slot.fused, dp=dp)
        batching.note_formed(len(members))
        out = []
        for i, _m in enumerate(members):
            res = batching.demux_results(results, slot.sink_map, f"q{slot_of[i]}")
            for qr in res.values():
                qr.exec_stats["batch"] = {"size": len(members), "slots": len(plans),
                                          "slot": slot_of[i]}
            out.append(res)
        return out

    def execute(self, logical: Plan, analyze: bool = False, dp=None,
                phases: Optional[dict] = None,
                sync_op_timing: bool = False) -> dict[str, QueryResult]:
        """Run a logical plan distributed.  `phases` (the flight recorder's
        timers) receives exec_ns and merge_ns; `sync_op_timing` (EXPLAIN)
        makes every executor time its operators with the device synchronized
        at their boundaries."""
        t_exec0 = _time.perf_counter_ns()
        if dp is None:
            dp = self.planner.plan(logical)
            # direct-plan callers (no plan cache in front) verify here;
            # query() verifies inside its split-cache fill instead
            planverify.maybe_verify(dp, self.schemas(), self.registry)

        # 1. run agent fragments (reference: per-agent Carnot::ExecutePlan),
        #    each over the agent's mesh (AgentInfo.n_devices).
        #    Agents run CONCURRENTLY (they are separate processes in the
        #    networked deployment); host-side work (feed assembly, dictionary
        #    prescans) overlaps even though they share one device.
        payloads: dict[str, list] = {cid: [] for cid in dp.channels}
        agent_stats: dict[str, dict] = {}
        items = list(dp.agent_plans.items())

        def run_one(agent_name, plan):
            mesh = self._agent_mesh(agent_name)
            # Standing-view fast path: first sight registers, later sights
            # answer from O(delta)-refreshed state; analyze runs bypass to
            # measure the real scan.
            miss: dict = {}
            if not analyze:
                served = self.matviews(agent_name).serve(plan, route_scale=len(items), mesh=mesh,
                                                         miss=miss)
                if served is not None:
                    cid, pb, info = served
                    return agent_name, {cid: pb}, {"matview": info}
            # route_scale: the CPU/card routing must see the QUERY size (all
            # agents' shards), not this agent's shard alone (see
            # executor._route_backend)
            ex = PlanExecutor(plan, self.stores[agent_name], self.registry,
                              device=self.device, analyze=analyze, mesh=mesh,
                              route_scale=len(items))
            ex.sync_op_timing = sync_op_timing
            # Colocated agents share one device: defer each agent's partial
            # readback so ALL agents' states merge there and come back in ONE
            # transfer wave below.
            ex.defer_agg_pull = len(items) > 1
            out = ex.run_agent()
            stats = dict(ex.stats)
            if miss:  # a view whose refresh failed: the rescan says why
                stats["matview"] = miss
            return agent_name, out, stats

        if len(items) > 1:
            # worker threads inherit the active trace context, so their
            # executors' op spans parent correctly
            calls = [_trace.propagating_call(run_one, *kv) for kv in items]
            with ThreadPoolExecutor(max_workers=min(len(items), 16)) as pool:
                outs = list(pool.map(lambda c: c(), calls))
        else:
            outs = [run_one(*kv) for kv in items]
        # Deferred agent partials: per channel, either merge all agents'
        # states ON DEVICE (equal layouts: one M1 launch and one readback
        # instead of N) or pull everything in one transfer wave and merge by
        # key values on the host.  View-served agents' host batches are not
        # deferred: they join the channel's key-value merge below, copied
        # by the wire round trip (a view's batch is shared, never mutated).
        by_channel: dict[str, list] = {}
        for _name, out, _stats in outs:
            for cid, payload in out.items():
                if isinstance(payload, _DeferredPartial):
                    by_channel.setdefault(cid, []).append(payload)
        finished: dict[int, object] = {}
        pull_states = []
        pull_done = []  # (fn(pulled states) -> None, how many states) per entry
        for cid, ds in by_channel.items():
            fps = {d.layout_fp for d in ds}
            if len(fps) == 1 and None not in fps and len(ds) > 1:
                pull_states.append(gang_merge_states(ds))

                def done(pulled, ds=ds):
                    # all agents resolve to ONE merged batch; keep a single
                    # payload entry (merge_partials is idempotent over one)
                    for d in ds:
                        finished[id(d)] = None
                    finished[id(ds[0])] = ds[0].finish_state(pulled[0])

                pull_done.append((done, 1))
            else:
                for d in ds:
                    pull_states.extend(d.partials)

                    def done(pulled, d=d):
                        finished[id(d)] = d.finish(pulled)

                    pull_done.append((done, len(d.partials)))
        # one wave; each multi-leaf state packed into one buffer first (P1)
        pulled_all = transfer.pull_states(pull_states)
        at = 0
        for fn, k in pull_done:
            fn(pulled_all[at:at + k])
            at += k
        for agent_name, out, stats in outs:
            for cid, payload in out.items():
                if isinstance(payload, _DeferredPartial):
                    payload = finished[id(payload)]
                    if payload is None:
                        continue  # folded into the gang-merged batch
                if isinstance(payload, PartialAggBatch):
                    # round-trip the wire format on every query
                    payload = PartialAggBatch.from_bytes(payload.to_bytes())
                payloads[cid].append(payload)
            agent_stats[agent_name] = stats
        # the exec window: agent fragments + the coalesced readback wave;
        # everything after is merge-side work
        t_merge0 = _time.perf_counter_ns()

        # 2. repartitioned joins: per-partition key-disjoint joins between
        #    the agent stage and the merger (reference splitter shuffle).
        reg = self.registry
        if reg is None:
            from pixie_tpu_torch.udf import registry as reg
        if dp.join_stages:
            run_join_stages(dp, payloads, reg, store=self.merger_store,
                            device=self.device, analyze=analyze)

        # 3. merge channel payloads (reference: Kelvin finalize / row merge).
        inputs: dict[str, HostBatch] = {}
        consumed = bucket_channels(dp)
        for cid, ch in dp.channels.items():
            if cid in consumed:
                continue  # bucket channels were joined in their stage
            got = payloads.get(cid, [])
            if not got:
                raise Internal(f"channel {cid} received no payloads")
            if ch.kind == "agg_state":
                inputs[cid] = merge_partials(ch.agg, got, reg)
            else:
                inputs[cid] = _union_host_batches(got)
        inputs.update(stage_output_inputs(dp, payloads))

        # 4. run the merger plan over the injected channels.  UDTF sources
        # run here (merger scope) against the agents' schema catalog, built
        # only for a plan that has one; the tracepoint manager comes with the
        # tracepoint slice (ROADMAP Queue 1 item 6e), so GetTracepointStatus
        # answers its empty table.
        udtf_ctx = None
        if any(isinstance(op, UDTFSourceOp) for op in dp.merger_plan.ops()):
            from pixie_tpu_torch.udf.udtf import UDTFContext

            udtf_ctx = UDTFContext(table_store=self.merger_store, registry=reg,
                                   schema_catalog=self.schemas())
        ex = PlanExecutor(dp.merger_plan, self.merger_store, self.registry,
                          device=self.device, inputs=inputs, analyze=analyze,
                          udtf_ctx=udtf_ctx)
        ex.sync_op_timing = sync_op_timing
        results = ex.run()
        # Per-agent exec stats ride along with every result (reference:
        # AgentExecutionStats shipped with the final chunk, carnot.cc:227-275),
        # with the whole-query transfer summary (a warm resident-tier query
        # uploads ZERO feed bytes).
        xfer = {
            k: sum(int(s.get(k, 0)) for s in agent_stats.values())
            for k in ("h2d_bytes", "resident_feeds", "feed_cache_hits",
                      "spmd_feeds", "mesh_shuffles")
        }
        # placement skew across mesh shards: the worst agent's max/mean shard rows
        skews = [s.get("shard_skew_frac") for s in agent_stats.values()
                 if isinstance(s.get("shard_skew_frac"), (int, float))]
        if skews:
            xfer["shard_skew_frac"] = max(skews)
        # The merger plan's sources are channels (no ST knowledge): restamp
        # semantic types from the LOGICAL plan and the agents' schemas.
        sstore = SchemaStore(self.schemas())
        timers = {"exec_ns": t_merge0 - t_exec0,
                  "merge_ns": _time.perf_counter_ns() - t_merge0}
        if phases is not None:
            phases.update(timers)
        for r in results.values():
            restamp_result(r, logical, sstore, reg)
            r.exec_stats["agents"] = agent_stats
            r.exec_stats["transfer"] = xfer
            r.exec_stats["phases"] = timers
        return results


def _op_timing_note(device) -> str:
    """How EXPLAIN's per-operator ns were taken on `device`."""
    if device.type == "cuda":
        return ("device synchronized at every operator boundary "
                "(torch.cuda.synchronize), so each op's ns hold its kernels")
    return "host wall time (CPU device: every op runs synchronously)"
