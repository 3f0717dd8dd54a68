"""Query broker: the networked ExecuteScript front door.

Reference: src/vizier/services/query_broker — Server.ExecuteScript
(controllers/server.go:307) compiles the script, LaunchQuery ships per-agent
plans (launch_query.go:36-66), and QueryResultForwarder merges agent result
streams into the client stream with producer/consumer watchdogs
(query_result_forwarder.go:358-560).

This broker listens on one framed-TCP port for BOTH agents and clients
(the envelope's `msg` field routes).  Per query: compile against the live
registry's schemas, split with DistributedPlanner, push `execute` frames to
each agent's connection, collect channel payload frames, merge (partials via
combine/finalize, rows via dictionary-reconciled union), run the merger plan
locally, and stream result chunks back to the client.

Copied from the reference package (pixie_tpu/services/broker.py).  The
agents run their fragments on their own devices (services/agent.py); the
broker folds their chunk frames per source (parallel/cluster.py
SourceKeyedFold) and merges on the host (combine_partials /
finalize_partial), as the reference's broker does, and its merger
PlanExecutor runs on `device`: the CUDA card unless the caller passes
another (`device="cpu"`).  With no card and no device given it raises.

What stays refused, with Unimplemented, and is never reached under the
default flags: sealed-batch replication and its failover serves
(PL_REPLICATION > 1), shard re-homing (`rehome_agent`), retires
(`retire_agent`) and the agent autoscaler (PL_AUTOSCALE) — ROADMAP Queue 1
item 6d, part 2 — and tracepoint mutations (item 6e).
"""
from __future__ import annotations

import json as _json
import threading
import time
import traceback
from typing import Optional

from pixie_tpu_torch import flags as _flags
from pixie_tpu_torch import trace
from pixie_tpu_torch.engine import autotune as _autotune
from pixie_tpu_torch.engine.executor import HostBatch, PlanExecutor, resolve_device
from pixie_tpu_torch.engine.result import QueryResult
from pixie_tpu_torch.parallel.distributed import DistributedPlanner
from pixie_tpu_torch.serving import COST_COLD, COST_WARM, ServingFront, ShedError
from pixie_tpu_torch.services import wire
from pixie_tpu_torch.services.kvstore import KVStore
from pixie_tpu_torch.services.registry import AgentRegistry, refuse_replication
from pixie_tpu_torch.services.transport import Connection, Server
from pixie_tpu_torch.status import PxError, Unimplemented
from pixie_tpu_torch.table.table import TableStore
from pixie_tpu_torch.types import Relation

DEFAULT_QUERY_TIMEOUT_S = 60.0

#: tenant id stamped on queries that arrive without one (older clients,
#: in-process callers like cron): they share one namespace and one quota
#: bucket rather than bypassing admission entirely
DEFAULT_TENANT = "default"

#: broker end-to-end query latency buckets (seconds)
QUERY_LATENCY_BOUNDS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                        10.0, 30.0, 60.0)

#: incremental_fold spans recorded per query (folds beyond the cap still
#: merge and count; only their span detail is dropped)
MAX_FOLD_EVENT_SPANS = 256

_flags.define_int(
    "PL_QUERY_RETRIES", 2,
    "broker-side re-dispatch rounds after an agent eviction (heartbeat "
    "expiry / mid-stream disconnect): surviving agents' folded results are "
    "kept, the lost fragments re-plan onto the live agent set and re-"
    "dispatch under fresh per-dispatch tokens; 0 restores fail-fast")
_flags.define_int(
    "PL_RETRY_BACKOFF_MS", 100,
    "base for the jittered exponential backoff between re-dispatch rounds "
    "(round i sleeps ~base*2^i, capped at 5s) — the window a killed-and-"
    "restarted agent gets to re-register before its fragments re-plan "
    "around it")
_flags.define_bool(
    "PL_HEDGE_ENABLED", True,
    "straggler hedging: a dispatch outliving its per-agent service-time "
    "deadline (EWMA/p99-derived) gets a duplicate dispatch; first answer "
    "wins, the loser's chunks are discarded idempotently")
_flags.define_int(
    "PL_HEDGE_MIN_MS", 500,
    "floor for the hedge deadline — never hedge a dispatch younger than "
    "this, however fast the agent's history says it should be")
_flags.define_float(
    "PL_HEDGE_FACTOR", 3.0,
    "hedge deadline = max(PL_HEDGE_MIN_MS, factor * p99_estimate) where "
    "p99_estimate = service-time EWMA + 4 * EWMA(|deviation|)")
_flags.define_bool(
    "PL_AUTOSCALE", False,
    "broker-driven agent autoscaling (the reference's serving/elastic.py "
    "AgentSupervisor); not ported yet: setting it makes Broker.start raise")
_flags.define_float(
    "PL_REJOIN_GRACE_S", 2.0,
    "how long after an agent's death its shard counts as REJOINING: "
    "dispatch (and re-dispatch) holds for it instead of silently planning "
    "a reduced topology — a restarting pod re-registers within the grace; "
    "past it the cluster serves the surviving agents' data (the reference "
    "data-plane semantic).  Only active when PL_QUERY_RETRIES > 0")

#: service-time samples required before hedging arms for an agent — a cold
#: EWMA over one or two samples would hedge every slow compile
HEDGE_MIN_SAMPLES = 8

#: cap on the re-dispatch backoff and on the retry-after hint shipped with
#: a retry-budget-exhausted error
MAX_BACKOFF_MS = 5000.0

#: pxlint lock-discipline: _QueryCtx's *_locked members are owned by the
#: per-query ctx lock (read by the reference's check/pxlint.py, which comes
#: to the port with ROADMAP Queue 1 item 6d, part 2)
_pxlint_locks_ = {"_check_done_locked": ".lock"}


class _QueryCtx:
    """In-flight bookkeeping for one distributed query.

    Fault-tolerant dispatch model: every `execute` frame is one DISPATCH,
    identified by ``src = f"{agent}#{attempt}"`` and authenticated by its
    OWN token (the per-query token, narrowed per dispatch).  Chunk
    frames fold into per-src accumulators (`parallel.cluster.
    SourceKeyedFold`), so an evicted agent's partial stream — or the losing
    side of a hedged duplicate dispatch — is discarded at merge simply by
    never ACCEPTING its src; nothing is un-folded and late/duplicate chunks
    land in sub-folds nobody reads (idempotent discard).  The first
    exec_done per agent wins (`accepted[agent] = src`)."""

    def __init__(self, channels: set[str]):
        self.lock = threading.RLock()
        self.error: Optional[str] = None
        self.done = threading.Event()
        #: nudges the query thread: completion, eviction, or error
        self.wake = threading.Event()
        #: agents whose answer the current plan requires
        self.needed_agents: set[str] = set()
        #: src → {agent, attempt, frag, deadline, hedged, t0}
        self.pending: dict[str, dict] = {}
        #: src → per-dispatch auth token (never pruned within a query: late
        #: frames from a losing/evicted src must validate so their discard
        #: is COUNTED as a discard, not mistaken for a stale-query frame)
        self.tokens: dict[str, str] = {}
        #: agent → winning src (first exec_done)
        self.accepted: dict[str, str] = {}
        #: src → the fragment JSON it was dispatched with (re-dispatch
        #: keeps an accepted result only when its fragment is unchanged
        #: under the re-planned split)
        self.frags: dict[str, Optional[str]] = {}
        self.next_attempt: dict[str, int] = {}
        #: (agent, reason) eviction events awaiting the query thread
        self.evictions: list[tuple] = []
        #: one hedge per agent per dispatch round
        self.hedged_agents: set[str] = set()
        #: per-src dispatch spans, opened at frame send and closed by the
        #: exec_done/exec_error handler threads (or eviction cleanup)
        self.dispatch_spans: dict[str, object] = {}
        self.agent_stats: dict[str, dict] = {}
        # ---- streaming incremental merge (set up by configure_folds) ----
        #: channel id → SourceKeyedFold: chunk frames fold into per-src
        #: sub-accumulators AS THEY ARRIVE (reader threads), so merge work
        #: hides under the slowest agent's compute AND a src is droppable
        self.folds: dict[str, object] = {}
        #: per-channel locks: fold.add serializes across agent reader
        #: threads, but folds on DISTINCT channels share no state
        self.fold_locks: dict[str, threading.Lock] = {}
        #: join-stage bucket channels accumulate whole payload lists per
        #: src; the stage runner consumes the accepted srcs' lists at merge
        self.bucket_payloads: dict[str, dict[str, list]] = {}
        #: (channel, src) → chunks the producer reported on exec_done
        self.expected_chunks: dict[tuple, int] = {}
        #: (start_unix_ns, duration_ns, channel, agent) per fold, emitted as
        #: incremental_fold spans at merge time (the reader threads hold no
        #: trace context); capped — first_fold_ns/last_terminal_ns carry the
        #: overlap evidence, span detail beyond the cap adds nothing
        self.fold_events: list[tuple] = []
        self.first_fold_ns: Optional[int] = None
        self.last_terminal_ns: Optional[int] = None

    def configure_folds(self, dp, registry) -> None:
        """Arm one source-keyed accumulator per merge-input channel.  Must
        run before the first `execute` frame is sent (chunks race the
        dispatch loop); join-stage bucket channels keep list accumulation —
        the stage runner consumes whole per-partition lists at merge time."""
        from pixie_tpu_torch.parallel.cluster import SourceKeyedFold
        from pixie_tpu_torch.parallel.repartition import bucket_channels

        consumed = bucket_channels(dp)
        for cid, ch in dp.channels.items():
            if cid in consumed:
                continue
            self.folds[cid] = SourceKeyedFold(ch.kind, agg=ch.agg,
                                              registry=registry)
            self.fold_locks[cid] = threading.Lock()

    # ------------------------------------------------------- dispatch state
    @staticmethod
    def src_of(meta: dict) -> str:
        return f"{meta.get('agent')}#{int(meta.get('attempt') or 0)}"

    def register_dispatch(self, agent: str, frag=None, deadline=None,
                          hedged: bool = False):
        import secrets
        import time as _time

        with self.lock:
            attempt = self.next_attempt.get(agent, 0)
            self.next_attempt[agent] = attempt + 1
            src = f"{agent}#{attempt}"
            self.tokens[src] = secrets.token_urlsafe(12)
            self.frags[src] = frag
            self.pending[src] = {
                "agent": agent, "attempt": attempt, "frag": frag,
                "deadline": deadline, "hedged": hedged,
                "t0": _time.monotonic(),
            }
            if hedged:
                self.hedged_agents.add(agent)
            return src, self.tokens[src], attempt

    def drop_dispatch(self, src: str) -> None:
        with self.lock:
            self.pending.pop(src, None)
            self.tokens.pop(src, None)

    def token_for(self, src: str) -> Optional[str]:
        with self.lock:
            return self.tokens.get(src)

    def frag_of(self, src: str) -> Optional[str]:
        return self.frags.get(src)

    def outstanding_agents(self) -> list[str]:
        with self.lock:
            return sorted(self.needed_agents - set(self.accepted))

    def uncovered_agents(self) -> list[str]:
        """Needed agents with neither an accepted result nor an in-flight
        dispatch — the set a re-dispatch round must cover."""
        with self.lock:
            covered = set(self.accepted)
            covered.update(i["agent"] for i in self.pending.values())
            return sorted(self.needed_agents - covered)

    def _check_done_locked(self) -> None:
        if self.error is not None or self.needed_agents <= set(self.accepted):
            self.done.set()
        self.wake.set()

    def fail(self, error: str) -> None:
        with self.lock:
            if self.error is None:
                self.error = error
            self._check_done_locked()

    # --------------------------------------- producer frames (reader threads)
    def on_exec_done(self, meta: dict):
        """Returns (agent, service_seconds) when this frame ACCEPTED the
        agent's result; None for stale or hedge-losing frames."""
        import time as _time

        src = self.src_of(meta)
        with self.lock:
            self.last_terminal_ns = _time.time_ns()
            info = self.pending.pop(src, None)
            if info is None:
                return None
            agent = info["agent"]
            if agent in self.accepted:
                # a hedge raced: first answer already won — this src's
                # chunks are discarded at merge (never accepted)
                self._check_done_locked()
                return None
            self.accepted[agent] = src
            self.agent_stats[agent] = meta.get("stats", {})
            for cid, n in (meta.get("chunks") or {}).items():
                self.expected_chunks[(cid, src)] = int(n)
            self._check_done_locked()
            return agent, _time.monotonic() - info["t0"]

    def on_exec_error(self, meta: dict) -> Optional[str]:
        """Returns the fatal error when no other live attempt can still
        answer for this agent; None when a hedge twin is outstanding or
        the frame is stale."""
        src = self.src_of(meta)
        with self.lock:
            info = self.pending.pop(src, None)
            if info is None:
                return None
            agent = info["agent"]
            if agent in self.accepted:
                return None
            if any(i["agent"] == agent for i in self.pending.values()):
                return None  # the hedged twin may still answer
            err = f"agent {meta.get('agent')}: {meta.get('error')}"
            if self.error is None:
                self.error = err
            self._check_done_locked()
            return err

    def on_agent_lost(self, agent: str, reason: str) -> list[str]:
        """Connection/liveness loss: drop the agent's in-flight dispatches
        and queue an eviction for the query thread.  Returns dropped srcs
        for span cleanup.  An
        agent whose result was already accepted is a no-op — its data is
        folded and verified; its later death cannot poison this query."""
        with self.lock:
            srcs = [s for s, i in self.pending.items() if i["agent"] == agent]
            for s in srcs:
                self.pending.pop(s, None)
            affected = bool(srcs) or (agent in self.needed_agents
                                      and agent not in self.accepted)
            if not affected:
                self.wake.set()
                return srcs
            self.evictions.append((agent, reason))
            self.wake.set()
            return srcs

    def take_evictions(self) -> list[tuple]:
        with self.lock:
            ev, self.evictions = self.evictions, []
            return ev

    def reset_for_restart(self, dp, registry) -> None:
        """Full re-dispatch: the re-planned channel topology changed (e.g.
        a repartition join lost its widest mesh), so every fold so far is
        unusable.  Fresh tokens mean frames from superseded dispatches are
        rejected (and counted) rather than folded."""
        with self.lock:
            self.pending.clear()
            self.tokens.clear()
            self.accepted.clear()
            self.frags = {}
            self.expected_chunks = {}
            self.agent_stats = {}
            self.folds = {}
            self.fold_locks = {}
            self.bucket_payloads = {}
            self.configure_folds(dp, registry)
            self.needed_agents = set(dp.agent_plans)
            self.hedged_agents = set()
            self.done.clear()

    # ------------------------------------------- chunk folds (reader threads)
    def fold_chunk(self, meta: dict, payload) -> None:
        """Fold one producer chunk frame; called from connection reader
        threads.  A malformed chunk fails the QUERY (error + done), never
        the reader thread."""
        import time as _time

        cid = meta["channel"]
        src = self.src_of(meta)
        fold = self.folds.get(cid)
        t0 = _time.time_ns()
        try:
            if fold is None:
                with self.lock:
                    self.bucket_payloads.setdefault(cid, {}).setdefault(
                        src, []).append(payload)
                return
            with self.fold_locks[cid]:
                fold.add(src, payload)
        except Exception as e:
            self.fail(f"chunk fold failed on channel {cid}: {e}")
            return
        if self.first_fold_ns is None:
            self.first_fold_ns = t0
        if len(self.fold_events) < MAX_FOLD_EVENT_SPANS:
            self.fold_events.append(
                (t0, _time.time_ns() - t0, cid, meta.get("agent")))


def _channels_compatible(dp, dp2) -> bool:
    """Whether a re-planned split can reuse the folds of the original: the
    channel set/kinds, join stages (incl. partition counts), and the merger
    plan must be identical — producer lists may differ (that is the point
    of re-planning around a dead agent)."""
    a, b = dp.to_dict(), dp2.to_dict()
    ak = {cid: (c["kind"], _json.dumps(c["agg"], sort_keys=True))
          for cid, c in a["channels"].items()}
    bk = {cid: (c["kind"], _json.dumps(c["agg"], sort_keys=True))
          for cid, c in b["channels"].items()}
    return (ak == bk and a["merger_plan"] == b["merger_plan"]
            and a["join_stages"] == b["join_stages"])


class Broker:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        datastore_path: str = ":memory:",
        hb_expiry_s: float = 15.0,
        registry=None,
        query_timeout_s: float = DEFAULT_QUERY_TIMEOUT_S,
        auth_token: Optional[str] = None,
        healthz_port: Optional[int] = None,
        elector=None,
        election_id: Optional[str] = None,
        device=None,
    ):
        # resource-free validation FIRST: a raise here must not leak a
        # bound socket or an open KV handle
        refuse_replication()
        #: the device the merger plan runs on
        self.device = resolve_device(device)
        if (election_id is not None and elector is None
                and datastore_path == ":memory:"):
            from pixie_tpu_torch.status import InvalidArgument

            raise InvalidArgument(
                "leader election requires a shared --datastore file "
                "(an in-memory lease is private to this process)")
        #: shared-secret auth (reference fronts this port with JWT,
        #: src/shared/services/).  When set, every connection must present the
        #: token in an `auth` frame before any other message is honored.  The
        #: port must never be exposed beyond a trusted network regardless.
        self.auth_token = auth_token
        self.udf_registry = registry
        self.query_timeout_s = query_timeout_s
        self.merger_store = TableStore()
        #: whole-query plan cache (PL_QUERY_FASTPATH): warm dashboard
        #: queries skip re-trace/re-optimize/re-split/re-serialize — see
        #: engine/plancache.py for the soundness argument
        from pixie_tpu_torch.engine.plancache import QueryPlanCache

        self.plan_cache = QueryPlanCache()
        #: multi-tenant serving front (pixie_tpu_torch.serving): every
        #: ExecuteScript passes its admission gate (per-tenant token
        #: buckets, global in-flight cap, DRR fair-share dispatch) and
        #: returns its slot on completion.  PL_SERVING_ENABLED=0 makes it
        #: a pass-through.
        self.serving = ServingFront("broker")
        #: measured per-(tenant, plan-class) service-rate model
        #: (serving/ratemodel.py): fed from every completion, it replaces
        #: the static warm/cold DRR costs and the heuristic retry-after
        #: with measured rates, and drives the autoscaler's demand signal
        from pixie_tpu_torch.serving.ratemodel import ServiceRateModel

        self.ratemodel = ServiceRateModel()
        self.serving.rate_model = self.ratemodel
        #: self-telemetry spans for the query path; shipped to an agent's
        #: spans table at query end (the broker holds no scanned store)
        self.tracer = trace.Tracer("broker")
        #: query flight recorder: per-query profile/op-stat rows (and SLO
        #: alert + sampled-metric rows) buffered here, shipped to an agent
        #: store alongside the spans (pixie_tpu_torch.observe)
        from pixie_tpu_torch import observe as _observe

        self._telemetry = _observe.RowBuffer()
        self._self_metrics: Optional[object] = None
        #: concurrent-query batching rendezvous (PL_QUERY_BATCHING):
        #: groupable concurrent queries fuse into ONE distributed dispatch
        #: with a shared scan; results demux per member (serving/batching)
        from pixie_tpu_torch.serving import batching as _batching

        self._batcher = _batching.BatchCollector()
        #: batch signature → BatchSlot (fused plan + sink map + split slot)
        from collections import OrderedDict as _OrderedDict

        self._batch_splits: "_OrderedDict" = _OrderedDict()
        self._agent_conns: dict[str, Connection] = {}
        self._queries: dict[str, _QueryCtx] = {}
        self._qlock = threading.Lock()
        #: client query threads still running (stop() waits for them before
        #: it closes the KV they may still write)
        self._query_threads: set[threading.Thread] = set()
        #: broker→agent control RPC slots (storage reports):
        #: req_id -> [Event, reply payload]
        self._control_replies: dict[str, list] = {}
        #: per-agent service-time model for straggler hedging: EWMA of
        #: dispatch→exec_done seconds + EWMA of |deviation| (a cheap p99
        #: estimate: ewma + 4*dev); warmed by HEDGE_MIN_SAMPLES before a
        #: hedge deadline arms
        self._svc: dict[str, dict] = {}
        self._svc_lock = threading.Lock()
        self._req_counter = 0
        self._stopped = threading.Event()
        self._expiry_thread = threading.Thread(
            target=self._expiry_loop, daemon=True, name="pixie-broker-expiry"
        )
        self.kv = KVStore(datastore_path)
        self.healthz: Optional[object] = None
        self._server = None
        try:
            self.registry = AgentRegistry(self.kv, expiry_s=hb_expiry_s)
            from pixie_tpu_torch.services.cron import CronScriptRunner

            #: cron scripts (reference script_runner.go:47-54), persisted in kv
            self.cron = CronScriptRunner(
                lambda script, func, func_args: self.execute_script(
                    script, func=func, func_args=func_args
                )[0],
                kv=self.kv,
            )
            # live tenant quotas persisted by the control plane: recall
            # them into the serving front so quota writes survive broker
            # restart (the PL_TENANT_* env specs stay the defaults)
            self._load_quotas()
            # recall the persisted adaptive-gate model (engine/autotune.py,
            # same KV pattern as quotas) so a restarted broker's gates
            # start warm — its first queries pay no cold exploration burst
            if _autotune.enabled():
                _autotune.MODEL.load_kv(self.kv)
            #: optional LeaderElector (services/election.py): when set, this
            #: broker only serves queries while holding the lease — a standby
            #: broker sharing the KV takes over when the leader dies
            #: (reference src/shared/services/election/).  `election_id`
            #: builds one over THIS broker's kv (one handle, one close path).
            if election_id is not None and elector is None:
                from pixie_tpu_torch.services.election import LeaderElector

                elector = LeaderElector(self.kv, "broker", election_id)
            self.elector = elector
            #: optional HTTP healthz/metrics listener (reference
            #: src/shared/services/ healthz for k8s probes).  Leadership is
            #: a READINESS concern only: a healthy standby must pass
            #: /healthz (liveness) or a k8s liveness probe would restart it
            #: in a loop, defeating failover.
            if healthz_port is not None:
                from pixie_tpu_torch.services.health import HealthzServer

                def _kv_alive() -> bool:
                    self.kv.get("__healthz")  # raises when the kv is unusable
                    return True

                self.healthz = HealthzServer(checks={
                    "kv": _kv_alive,
                    "server": lambda: not self._stopped.is_set(),
                }, ready_checks={
                    "leader": lambda: (self.elector is None
                                       or self.elector.is_leader()),
                }, host=host, port=healthz_port)
                # READINESS only: an overloaded broker (admission queue
                # past the shed watermark) must drop out of the serving
                # endpoints without a liveness restart wiping its queues
                self.healthz.add_ready_check("serving", self.serving.ready)
            self._server = Server(host, port, self._on_frame, self._on_close)
        except Exception:
            if self.healthz is not None:
                self.healthz.stop()
            self.kv.close()
            raise

    # ------------------------------------------------------------------ server
    @property
    def port(self) -> int:
        return self._server.port

    def start(self) -> "Broker":
        from pixie_tpu_torch import metrics as _metrics

        _metrics.register_gauge_fn(
            "px_broker_live_agents",
            lambda: {(): float(len(self.registry.live_agents()))},
            "agents currently live in the registry",
        )
        trace.register_gauges()
        if _flags.get("PL_AUTOSCALE"):
            raise Unimplemented(
                "agent autoscaling (PL_AUTOSCALE) is not ported yet "
                "(ROADMAP Queue 1 item 6d, part 2)")
        self.serving.attach_gauges()
        self.ratemodel.attach_gauges()
        self._server.start()
        self._expiry_thread.start()
        self.cron.start()
        period = float(_flags.get("PL_SELF_METRICS_S"))
        if period > 0:
            from pixie_tpu_torch.services.cron import Ticker

            #: metrics-as-data: fold the registry into
            #: self_telemetry.metrics (and evaluate SLO burn rates) on the
            #: same cadence dashboards poll at
            self._self_metrics = Ticker("self_metrics", period,
                                        self._sample_self_metrics).start()
        if self.elector is not None:
            self.elector.start()
        if self.healthz is not None:
            self.healthz.start()
        return self

    def stop(self):
        from pixie_tpu_torch import metrics as _metrics

        self._stopped.set()
        self.cron.stop()
        if self._self_metrics is not None:
            self._self_metrics.stop()
            self._self_metrics = None
        if self.healthz is not None:
            self.healthz.stop()
        if self.elector is not None:
            self.elector.stop()
        # the connections' reader threads, the expiry loop and the client
        # query threads all write the KV: every one ends before it closes
        self._server.stop()
        if self._expiry_thread.is_alive():
            self._expiry_thread.join(timeout=5.0)
        with self._qlock:
            threads = list(self._query_threads)
        for t in threads:
            t.join(timeout=self.query_timeout_s)
        self.serving.detach_gauges()
        self.ratemodel.detach_gauges()
        _metrics.unregister_gauge_fn("px_broker_live_agents")
        if _autotune.enabled():
            # final checkpoint: the next broker on this KV starts warm
            _autotune.MODEL.save_kv(self.kv)
        self.kv.close()

    def _expiry_loop(self):
        while not self._stopped.wait(timeout=max(self.registry.expiry_s / 3, 0.2)):
            self.registry.expire()
            # Reconcile connections against registry liveness — no matter
            # WHICH thread's expire() marked an agent dead (query paths call
            # live_agents() too), its connection gets closed here.  Dead
            # agents can't be revived by heartbeats (registry.heartbeat), so
            # this doesn't race a revival.
            live = {r.name for r in self.registry.live_agents()}
            for name, conn in list(self._agent_conns.items()):
                if name not in live:
                    self._agent_conns.pop(name, None)
                    conn.close()

    # ------------------------------------------------------------------ frames
    def _on_frame(self, conn: Connection, frame: bytes):
        if self.auth_token is not None and not conn.state.get("authed"):
            import hmac

            # Unauthenticated peers get NO decode work: the only acceptable
            # first frame is a small auth json.  Oversized or malformed
            # frames close the connection without allocating for them
            # (decode_frame would happily materialize a 1GB host_batch).
            if len(frame) > 4096:
                conn.close()
                return
            try:
                kind, payload = wire.decode_frame(frame)
            except Exception:
                conn.close()
                return
            # compare_digest over utf-8 bytes: str operands raise TypeError
            # on non-ASCII, which would skip the reject-and-close path.
            if (kind == "json" and payload.get("msg") == "auth"
                    and hmac.compare_digest(
                        str(payload.get("token", "")).encode(),
                        self.auth_token.encode())):
                conn.state["authed"] = True
                conn.send(wire.encode_json({"msg": "auth_ok"}))
            else:
                rid = payload.get("req_id") if kind == "json" else None
                conn.send(wire.encode_json(
                    {"msg": "error", "req_id": rid,
                     "error": "authentication required"}))
                conn.close()
            return
        kind, payload = wire.decode_frame(frame)
        if kind == "json":
            msg = payload.get("msg")
            if msg == "auth":
                conn.state["authed"] = True
                conn.send(wire.encode_json({"msg": "auth_ok"}))
            elif msg == "register":
                self._handle_register(conn, payload)
            elif msg == "heartbeat":
                if self._stale_incarnation(conn):
                    return  # a superseded socket's heartbeat must not keep
                    # the NEW incarnation's record warm
                if not self.registry.heartbeat(payload["agent"]):
                    conn.send(wire.encode_json({"msg": "reregister"}))
            elif msg == "exec_done":
                if self._stale_incarnation(conn):
                    return
                self._handle_exec_done(payload)
            elif msg == "exec_error":
                if self._stale_incarnation(conn):
                    return
                self._handle_exec_error(payload)
            elif msg == "execute_script":
                t = threading.Thread(
                    target=self._run_query, args=(conn, payload), daemon=True)
                with self._qlock:
                    self._query_threads.add(t)
                t.start()
            elif msg == "metrics":
                from pixie_tpu_torch import metrics as _metrics

                conn.send(wire.encode_json({
                    "msg": "metrics_text",
                    "req_id": payload.get("req_id"),
                    "text": _metrics.render(),
                }))
            elif msg == "flags":
                from pixie_tpu_torch import flags as _flags

                conn.send(wire.encode_json({
                    "msg": "flags_dump",
                    "req_id": payload.get("req_id"),
                    "flags": _flags.dump(),
                }))
            elif msg == "cron_upsert":
                self._reply_ack(conn, payload, lambda: self.cron.upsert(
                    payload["name"], payload["script"],
                    payload.get("interval_s", 60.0),
                    func=payload.get("func"),
                    func_args=payload.get("func_args"),
                ))
            elif msg == "cron_delete":
                self._reply_ack(
                    conn, payload, lambda: self.cron.delete(payload["name"])
                )
            elif msg == "cron_list":
                conn.send(wire.encode_json({
                    "msg": "cron_scripts", "req_id": payload.get("req_id"),
                    "scripts": [
                        {"name": c.name, "interval_s": c.interval_s,
                         "enabled": c.enabled, "run_count": c.run_count,
                         "error_count": c.error_count,
                         "last_error": c.last_error}
                        for c in self.cron.list()
                    ],
                }))
            elif msg == "set_quota":
                self._handle_set_quota(conn, payload)
            elif msg == "get_quotas":
                conn.send(wire.encode_json({
                    "msg": "quotas", "req_id": payload.get("req_id"),
                    "quotas": self.serving.quotas(),
                    "rate_model": self.ratemodel.snapshot(),
                }))
            elif msg == "storage_report":
                # reply to a broker→agent control RPC (heat_map storage
                # fan-out)
                with self._qlock:
                    slot = self._control_replies.get(payload.get("req_id"))
                if slot is not None:
                    slot[1] = payload
                    slot[0].set()
            elif msg == "heat_map":
                # cluster storage observatory read ("df for the data
                # plane") — off the read loop: it blocks on per-agent RPCs
                threading.Thread(
                    target=self._answer_heat_map, args=(conn, payload),
                    daemon=True, name="pixie-broker-heatmap",
                ).start()
            elif msg == "rehome_agent":
                conn.send(wire.encode_json({
                    "msg": "error", "req_id": payload.get("req_id"),
                    "error": "Unimplemented: shard re-homing is not ported "
                             "yet (ROADMAP Queue 1 item 6d, part 2)"}))
            elif msg == "deregister_agent":
                # operator decommission: drop the durable record (the
                # reference's last-holder refusal reads the replication
                # shard map, which is empty with replication off)
                name = str(payload.get("agent"))
                ok = self.registry.deregister(name)
                conn.send(wire.encode_json({
                    "msg": "ok" if ok else "error",
                    "req_id": payload.get("req_id"),
                    **({} if ok else {"error": "unknown agent"})}))
            elif msg == "get_peers":
                # pre-registration topology fetch: a rehydrating agent asks
                # who backs its shard (and where their replication ports
                # live) BEFORE it registers, so peer fetch completes before
                # the broker ever dispatches to it
                conn.send(wire.encode_json({
                    "msg": "peers", "req_id": payload.get("req_id"),
                    "shard_map": self.registry.shard_map(),
                    "peers": self.registry.peer_addrs(),
                }))
            elif msg == "list_schemas":
                conn.send(wire.encode_json({
                    "msg": "schemas",
                    "req_id": payload.get("req_id"),
                    "schemas": {
                        t: r.to_dict()
                        for t, r in self.registry.combined_schemas().items()
                    },
                }))
            else:
                conn.send(wire.encode_json({"msg": "error", "error": f"unknown msg {msg!r}"}))
        else:
            # data chunk from an agent (host_batch | partial_agg)
            if self._stale_incarnation(conn):
                return
            meta = payload.wire_meta
            self._handle_chunk(conn, meta, payload)

    @staticmethod
    def _reply_ack(conn: Connection, payload: dict, fn) -> None:
        """Run a control action; reply {msg: ok} or the error envelope."""
        try:
            fn()
            conn.send(wire.encode_json({"msg": "ok", "req_id": payload.get("req_id")}))
        except Exception as e:
            conn.send(wire.encode_json({
                "msg": "error", "req_id": payload.get("req_id"), "error": str(e),
            }))

    def _on_close(self, conn: Connection):
        if conn.state.get("superseded"):
            # a newer incarnation already owns the name: marking it dead
            # here would kill the NEW agent's liveness (dead stays dead
            # until register), and its eviction already ran at supersede
            return
        name = conn.state.get("agent")
        if name is not None:
            self.registry.mark_dead(name)
            if self._agent_conns.get(name) is conn:
                self._agent_conns.pop(name, None)
            # producer watchdog analog: evict the agent from every pending
            # query — queries re-plan + re-dispatch (PL_QUERY_RETRIES=0 fails
            # them fast)
            self._evict_agent(name, "disconnected")

    def _stale_incarnation(self, conn: Connection) -> bool:
        """Incarnation fence: frames arriving on a connection registered
        under an OLDER incarnation of the agent name are dropped (counted).
        A restarted agent re-registering under the same name supersedes the
        old socket; whatever that socket still delivers — chunks, acks,
        heartbeats — must be rejected, not folded."""
        name = conn.state.get("agent")
        inc = conn.state.get("incarnation")
        if name is None or inc is None:
            return False
        if inc == self.registry.incarnation(name):
            return False
        from pixie_tpu_torch import metrics as _metrics

        _metrics.counter_inc(
            "px_broker_stale_incarnation_frames_total",
            help_="frames dropped from superseded agent sockets (an agent "
                  "re-registered under the same name; the old incarnation "
                  "is fenced)")
        return True

    def _evict_agent(self, name: str, reason: str) -> None:
        from pixie_tpu_torch import metrics as _metrics

        _metrics.counter_inc(
            "px_agent_evictions_total",
            help_="agent connections lost (disconnect, heartbeat expiry, "
                  "or supersede by a re-registration)")
        # per-agent series ride a CAPPED label: agent names arrive on the
        # wire, so an id flood must not mint immortal counter series past
        # the cap (same policy as the tenant-label cap)
        _metrics.counter_inc(
            "px_agent_evictions_by_agent_total",
            labels={"agent": _metrics.capped_label("agent", name)},
            help_="agent evictions by (capped) agent name")
        with self._qlock:
            ctxs = list(self._queries.values())
        for ctx in ctxs:
            for src in ctx.on_agent_lost(name, reason):
                self._finish_dispatch_span(ctx, src,
                                           error=f"agent {name} {reason}")

    # ---------------------------------------------------------- quota control
    def _handle_set_quota(self, conn: Connection, payload: dict) -> None:
        """Live tenant quota write: validate (malformed specs are REJECTED
        with a clean error — this is an interactive API, not an env var),
        apply to the serving front in place, persist in the KV so the
        record survives broker restart."""
        from pixie_tpu_torch.serving.admission import normalize_quota
        from pixie_tpu_torch.status import InvalidArgument

        rid = payload.get("req_id")
        tenant = payload.get("tenant")
        try:
            rec = normalize_quota(tenant, payload.get("qps"),
                                  payload.get("concurrency"),
                                  payload.get("weight"))
        except InvalidArgument as e:
            conn.send(wire.encode_json(
                {"msg": "error", "req_id": rid, "error": str(e)}))
            return
        try:
            eff = self.serving.set_quota(tenant, rec)
        except PxError as e:  # e.g. the live-record cap: a clean reject
            conn.send(wire.encode_json(
                {"msg": "error", "req_id": rid, "error": str(e)}))
            return
        if all(v is None for v in rec.values()):
            self.kv.delete(f"quota/{tenant}")
        else:
            self.kv.set_json(f"quota/{tenant}", rec)
        conn.send(wire.encode_json({
            "msg": "quota_ok", "req_id": rid, "tenant": tenant,
            "effective": eff}))

    def _load_quotas(self) -> None:
        """Recall persisted quota records into the serving front (broker
        restart).  A corrupt record is skipped (counted), never fatal."""
        from pixie_tpu_torch import metrics as _metrics
        from pixie_tpu_torch.serving.admission import normalize_quota

        for key, raw in self.kv.scan("quota/"):
            tenant = key[len("quota/"):]
            try:
                d = _json.loads(raw.decode())
                rec = normalize_quota(tenant, d.get("qps"),
                                      d.get("concurrency"), d.get("weight"))
            except Exception:
                _metrics.counter_inc(
                    "px_broker_quota_recall_errors_total",
                    help_="persisted quota records skipped at broker "
                          "startup (corrupt or no longer valid)")
                continue
            self.serving.set_quota(tenant, rec)

    # ------------------------------------------------------------ agent control
    def _agent_rpc(self, name: str, meta: dict, timeout: float = 5.0) -> dict:
        """One broker→agent control round-trip on the agent's connection."""
        conn = self._agent_conns.get(name)
        if conn is None or conn.closed:
            raise TimeoutError(f"agent {name} not connected")
        with self._qlock:
            self._req_counter += 1
            rid = f"ctl{self._req_counter}"
            slot = [threading.Event(), None]
            self._control_replies[rid] = slot
        try:
            meta = dict(meta, req_id=rid)
            if not conn.send(wire.encode_json(meta)):
                raise TimeoutError(f"agent {name} not connected")
            if not slot[0].wait(timeout):
                raise TimeoutError(
                    f"agent {name} did not answer {meta.get('msg')}")
            return slot[1]
        finally:
            with self._qlock:
                self._control_replies.pop(rid, None)

    def _answer_heat_map(self, conn: Connection, payload: dict) -> None:
        """Aggregate every live agent's storage_report into the cluster
        heat map: per-agent raw reports plus a per-table rollup (shard →
        summed decayed heat, cluster skew = max/mean shard heat).  Consumed
        by `Client.heat_map`; also refreshes the px_journal_bytes
        gauge family from the reports (the broker may be the only scraped
        process in a multi-process deployment)."""
        from pixie_tpu_torch import metrics as _metrics

        agents: dict = {}
        for rec in self.registry.live_agents():
            try:
                rep = self._agent_rpc(rec.name, {"msg": "storage_report"},
                                      timeout=5.0)
            except TimeoutError as e:
                agents[rec.name] = {"error": str(e)}
                continue
            agents[rec.name] = {
                "shard_heat": rep.get("shard_heat") or [],
                "storage_state": rep.get("storage_state") or [],
                **({"error": rep["error"]} if rep.get("error") else {}),
            }
        tables: dict = {}
        for rep in agents.values():
            for r in rep.get("shard_heat") or []:
                t = tables.setdefault(str(r.get("table_name")), {
                    "shards": {}, "rows_scanned": 0, "bytes": 0})
                sh = str(r.get("shard"))
                t["shards"][sh] = (t["shards"].get(sh, 0.0)
                                   + float(r.get("heat") or 0.0))
                t["rows_scanned"] += int(r.get("rows_scanned") or 0)
                t["bytes"] += int(r.get("bytes") or 0)
        for t in tables.values():
            heats = list(t["shards"].values())
            mean = sum(heats) / max(len(heats), 1)
            t["skew"] = round(max(heats) / mean, 4) if mean > 0 else 1.0
        jbytes: dict = {}
        for name, rep in agents.items():
            for r in rep.get("storage_state") or []:
                jbytes[name] = (jbytes.get(name, 0)
                                + int(r.get("journal_bytes") or 0))
        for name, b in jbytes.items():
            _metrics.gauge_set(
                "px_journal_bytes", float(b),
                labels={"agent": _metrics.capped_label("heat_shard", name)},
                help_="journal bytes on disk per agent (PL_JOURNAL_MAX_MB "
                      "pruning pressure)")
        conn.send(wire.encode_json({
            "msg": "heat_map", "req_id": payload.get("req_id"),
            "agents": agents, "tables": tables}))

    # ------------------------------------------------- item 6d, part 2 (refused)
    def rehome_agent(self, donor: str, target: Optional[str] = None,
                     reason: str = "manual") -> dict:
        raise Unimplemented("shard re-homing is not ported yet "
                            "(ROADMAP Queue 1 item 6d, part 2)")

    def retire_agent(self, name: str, force: bool = False) -> dict:
        raise Unimplemented("agent retire is not ported yet "
                            "(ROADMAP Queue 1 item 6d, part 2)")

    # ---------------------------------------------------------------- handlers
    def _handle_register(self, conn: Connection, meta: dict):
        name = meta["agent"]
        schemas = {t: Relation.from_dict(r) for t, r in meta["schemas"].items()}
        asid = self.registry.register(name, schemas, meta.get("n_devices"),
                                      repl_addr=meta.get("repl_addr"))
        conn.state["agent"] = name
        # the incarnation this socket speaks for — older sockets for the
        # same name are fenced from here on (_stale_incarnation)
        conn.state["incarnation"] = self.registry.incarnation(name)
        old = self._agent_conns.get(name)
        self._agent_conns[name] = conn
        if old is not None and old is not conn:
            # fence the old socket BEFORE acking the new registration:
            # once the agent sees "registered" the rejoin is observable,
            # so the supersede marker must already be set.  Keep
            # "agent"+"incarnation" on the old conn so frames its reader
            # already queued are FENCED (stale incarnation) rather than
            # processed; the superseded marker keeps its close from
            # killing the new registration
            old.state["superseded"] = True
            old.close()
        conn.send(wire.encode_json({"msg": "registered", "asid": asid}))
        if old is not None and old is not conn:
            # in-flight dispatches on the old socket are orphaned (the new
            # process never saw them): evict so they re-dispatch to the
            # fresh incarnation (after the ack, so any re-dispatch frame
            # follows "registered" on the new socket)
            self._evict_agent(name, "superseded")

    def _ctx(self, meta: dict) -> Optional[_QueryCtx]:
        """Resolve the query ctx for a producer frame, enforcing the
        per-dispatch token.  Mismatched/missing tokens are dropped (and
        counted): a stale producer must not corrupt a newer query — or a
        newer dispatch round — that reused context state."""
        import hmac

        with self._qlock:
            ctx = self._queries.get(meta.get("req_id", ""))
        if ctx is None:
            return None
        expect = ctx.token_for(_QueryCtx.src_of(meta))
        # utf-8 bytes operands: compare_digest raises TypeError on non-ASCII
        # str, which would skip the counted-drop path (same pitfall the auth
        # handler avoids)
        if expect is None or not hmac.compare_digest(
                str(meta.get("qtoken", "")).encode(), expect.encode()):
            from pixie_tpu_torch import metrics as _metrics

            _metrics.counter_inc(
                "px_broker_stale_token_frames_total",
                help_="producer frames rejected for a bad per-dispatch token")
            # surfaced loudly: an agent that never echoes the token (e.g. a
            # version mismatch) would otherwise present as an opaque query
            # timeout with only a metric to explain it
            _metrics.warn(
                "dropping producer frame with bad per-dispatch token",
                req_id=meta.get("req_id"), agent=meta.get("agent"),
                has_token=bool(meta.get("qtoken")))
            return None
        return ctx

    def _handle_chunk(self, conn: Connection, meta: dict, payload):
        ctx = self._ctx(meta)
        if ctx is not None:
            ctx.fold_chunk(meta, payload)
        # Open the producer's in-flight window (its backpressure gate): the
        # ack means this chunk's fold work is DONE, so a slow merge throttles
        # the agents instead of queueing unbounded frames.  Acked even when
        # the query is already dead (ctx None / stale token): acks are pure
        # flow control, and a producer still draining a doomed stream must
        # not stall on a window nobody will ever open.  Replied on the SAME
        # connection the chunk arrived on — routing by agent name would ack
        # a restarted incarnation for its predecessor's frames.
        if not conn.closed:
            conn.send(wire.encode_json({
                "msg": "chunk_ack", "req_id": meta.get("req_id"),
                "channel": meta["channel"], "seq": meta.get("seq"),
                "attempt": meta.get("attempt"),
                # the SOURCE the chunk answered for (≠ the executing agent
                # on a failover takeover): the producer's ack-window key
                # includes it, so two streams on one socket stay distinct
                "agent": meta.get("agent"),
            }))

    def _finish_dispatch_span(self, ctx: _QueryCtx, src,
                              error: Optional[str] = None) -> None:
        sp = ctx.dispatch_spans.pop(src, None)
        if sp is not None:
            if error:
                sp.attributes["error"] = error[:200]
            self.tracer.finish(sp)

    #: distinct agents the service-time model tracks; like metric label
    #: series, the dict is keyed by wire-supplied names and would otherwise
    #: grow without bound — past the cap the least-recently-updated entry
    #: is evicted (a re-appearing agent just re-warms)
    MAX_SVC_AGENTS = 256

    def _record_service_time(self, agent: str, secs: float) -> None:
        """Fold one dispatch→exec_done sample into the agent's EWMA model
        (hedge deadlines derive from it)."""
        import time as _time

        if _autotune.enabled():
            # the same completion stream feeds the fleet-wide hedge-floor
            # model (engine/autotune.py): measured service p99 replaces
            # the fixed PL_HEDGE_MIN_MS once warm
            _autotune.MODEL.observe_service(secs)
        a = 0.2
        with self._svc_lock:
            s = self._svc.get(agent)
            if s is None:
                if len(self._svc) >= self.MAX_SVC_AGENTS:
                    lru = min(self._svc, key=lambda k: self._svc[k]["at"])
                    self._svc.pop(lru, None)
                self._svc[agent] = {"ewma": secs, "dev": secs / 2, "n": 1,
                                    "at": _time.monotonic()}
                return
            s["ewma"] += a * (secs - s["ewma"])
            s["dev"] += a * (abs(secs - s["ewma"]) - s["dev"])
            s["n"] += 1
            s["at"] = _time.monotonic()

    def _hedge_deadline_s(self, agent: str) -> Optional[float]:
        """Seconds a dispatch to `agent` may run before a hedged duplicate
        fires; None while the service-time model is cold (or hedging off)."""
        if not _flags.get("PL_HEDGE_ENABLED"):
            return None
        with self._svc_lock:
            s = self._svc.get(agent)
            if s is None or s["n"] < HEDGE_MIN_SAMPLES:
                return None
            p99 = s["ewma"] + 4.0 * s["dev"]
        floor = float(_flags.get("PL_HEDGE_MIN_MS")) / 1e3
        if _autotune.enabled():
            # adaptive floor: the measured fleet service p99 (with
            # headroom) replaces the fixed half-second constant once the
            # model is warm.  It only ever LOWERS the operator's floor —
            # a fast fleet hedges stragglers in tens of ms; the tail guard
            # snaps back to the static floor if the model drifts.
            floor, _dec = _autotune.MODEL.hedge_floor_s(floor)
        return max(floor, float(_flags.get("PL_HEDGE_FACTOR")) * p99)

    def _handle_exec_done(self, meta: dict):
        ctx = self._ctx(meta)
        if ctx is None:
            return
        src = _QueryCtx.src_of(meta)
        res = ctx.on_exec_done(meta)
        self._finish_dispatch_span(ctx, src)
        if res is not None:
            self._record_service_time(*res)

    def _handle_exec_error(self, meta: dict):
        ctx = self._ctx(meta)
        if ctx is None:
            return
        src = _QueryCtx.src_of(meta)
        ctx.on_exec_error(meta)
        self._finish_dispatch_span(ctx, src, error=str(meta.get("error")))

    # ------------------------------------------------------------------- query
    def _run_query(self, client: Connection, meta: dict):
        req_id = meta.get("req_id", "")
        tenant = str(meta.get("tenant") or DEFAULT_TENANT)
        try:
            with trace.root(self.tracer, "query", req_id=req_id,
                            tenant=tenant):
                results, stats = self.execute_script(
                    meta["script"],
                    func=meta.get("func"),
                    func_args=meta.get("func_args"),
                    now=meta.get("now"),
                    default_limit=meta.get("default_limit"),
                    analyze=bool(meta.get("analyze", False)),
                    funcs=[tuple(f) for f in meta.get("funcs") or []] or None,
                    tenant=tenant,
                    explain=bool(meta.get("explain", False)),
                )
                with trace.span("render"):
                    for name, qr in results.items():
                        hb = HostBatch(
                            dtypes={n: qr.relation.dtype(n)
                                    for n in qr.relation.names()},
                            dicts=qr.dictionaries,
                            cols=qr.columns,
                        )
                        client.send(wire.encode_host_batch(
                            hb, {"msg": "result_chunk", "req_id": req_id,
                                 "table": name,
                                 # semantic types ride the wire with the
                                 # relation
                                 "relation": qr.relation.to_dict()}
                        ))
                    client.send(wire.encode_json(
                        {"msg": "done", "req_id": req_id,
                         "stats": _jsonable(stats)}
                    ))
        except ShedError as e:
            # admission rejection: NOT a failure of the query itself — the
            # envelope carries the retry-after hint so clients back off
            client.send(wire.encode_error(req_id, e,
                                          retry_after_s=e.retry_after_s))
        except Exception as e:  # compile/plan/exec errors all surface to client
            if not isinstance(e, PxError):
                traceback.print_exc()
            # infrastructure failures on idempotent queries carry the
            # retryable marker (+ a retry-after hint) so clients auto-retry
            # instead of surfacing a one-off agent death to the user
            client.send(wire.encode_error(
                req_id, e,
                retry_after_s=getattr(e, "retry_after_s", None),
                retryable=getattr(e, "retryable", None)))
        finally:
            self._ship_spans()
            with self._qlock:
                self._query_threads.discard(threading.current_thread())

    def _ship_spans(self) -> None:
        """Persist this broker's finished spans AND flight-recorder rows
        (query profiles, op stats, sampled metrics, SLO alerts) into the
        data plane: everything goes to one live agent's self_telemetry
        tables through the normal write path, so PxL scripts and standing
        matviews see it without the broker holding a scanned store.

        Runs in query finally-blocks: telemetry failure (agent churn racing
        the conn map, dead sockets) must never replace a query's outcome, so
        everything is counted instead of raised."""
        from pixie_tpu_torch import metrics as _metrics

        try:
            if self.tracer.buffered == 0 and len(self._telemetry) == 0:
                return
            # snapshot: the expiry thread pops entries concurrently
            conns = dict(self._agent_conns)

            def send_to_agent(frame) -> bool:
                for name in sorted(conns):
                    c = conns[name]
                    if not c.closed and c.send(frame):
                        return True
                return False

            def send(rows):
                if not send_to_agent(wire.encode_json(
                        {"msg": "spans", "spans": rows})):
                    _metrics.counter_inc(
                        "px_broker_trace_spans_unshipped_total",
                        float(len(rows)),
                        help_="broker spans dropped: no agent accepted them")

            self.tracer.flush(send=send)
            for table, rows in self._telemetry.drain().items():
                if not send_to_agent(wire.encode_json(
                        {"msg": "telemetry_rows", "table": table,
                         "rows": rows})):
                    _metrics.counter_inc(
                        "px_broker_telemetry_rows_unshipped_total",
                        float(len(rows)),
                        help_="flight-recorder rows dropped: no agent "
                              "accepted them")
        except Exception:
            _metrics.counter_inc(
                "px_broker_trace_ship_errors_total",
                help_="unexpected failures shipping broker spans")

    def _sample_self_metrics(self) -> None:
        """PL_SELF_METRICS_S cron body: metrics registry → telemetry rows,
        SLO burn-rate evaluation → alert rows, one ship."""
        from pixie_tpu_torch import observe as _observe
        from pixie_tpu_torch.serving import slo as _slo

        self._telemetry.add(_observe.METRICS_TABLE,
                            _observe.sample_metrics_rows("broker"))
        if _slo.configured():
            mon = _slo.monitor()
            mon.evaluate()
            self._telemetry.add(_observe.ALERTS_TABLE, mon.drain_alerts())
        if _autotune.enabled():
            # fallback trips and fitted-threshold changes → the autotune
            # telemetry table; checkpoint the model so a crash between
            # crons loses at most one period of learning
            rows = _autotune.MODEL.drain_rows()
            if rows:
                self._telemetry.add(_observe.AUTOTUNE_TABLE, rows)
            _autotune.MODEL.save_kv(self.kv)
        self._ship_spans()

    # ------------------------------------------------- fault-tolerant dispatch
    def _await_rejoin_grace(self) -> None:
        """Hold dispatch while a just-dead agent may still re-register: a
        query planned in the kill→restart window would otherwise silently
        answer from the surviving shards only.  Bounded by the grace window
        measured from each death (never the full query timeout); a no-op
        with retries disabled — PL_QUERY_RETRIES=0 keeps the legacy
        plan-with-whatever-is-live behavior bit-identically."""
        import time as _time

        if int(_flags.get("PL_QUERY_RETRIES")) <= 0:
            return
        grace = float(_flags.get("PL_REJOIN_GRACE_S"))
        if grace <= 0:
            return
        deadline = _time.monotonic() + min(grace, self.query_timeout_s)
        waited_for = None
        t0 = _time.time_ns()
        while _time.monotonic() < deadline:
            recent = self.registry.recently_dead(grace)
            if not recent:
                break
            waited_for = recent
            _time.sleep(0.05)
        if waited_for is not None:
            trace.event_span("rejoin_wait", t0, _time.time_ns() - t0,
                             agents=",".join(waited_for))

    def _send_execute(self, ctx: _QueryCtx, req_id: str, agent: str,
                      plan_json: str, base_meta: dict,
                      hedged: bool = False) -> str:
        """Send one execute dispatch (fragment `plan_json`) to `agent` under
        a fresh per-dispatch token.  Returns the src id; raises Unavailable
        when the agent has no live connection."""
        from pixie_tpu_torch.status import Unavailable

        conn = self._agent_conns.get(agent)
        if conn is None or conn.closed:
            raise Unavailable(f"agent {agent} not connected")
        deadline = None
        if not hedged:
            h = self._hedge_deadline_s(agent)
            if h is not None:
                import time as _time

                deadline = _time.monotonic() + h
        src, token, attempt = ctx.register_dispatch(
            agent, frag=plan_json, deadline=deadline, hedged=hedged)
        # one dispatch span per src: opened at send, closed by the
        # exec_done/exec_error handler (or eviction cleanup); its id rides
        # the wire so the agent's exec spans parent under it cross-process
        dsp = trace.start_child("dispatch", agent=agent, attempt=attempt,
                                hedged=hedged)
        tctx = None
        if dsp is not None:
            ctx.dispatch_spans[src] = dsp
            tctx = {"trace_id": dsp.trace_id, "span_id": dsp.span_id}
        meta = dict(base_meta)
        meta.update({"req_id": req_id, "qtoken": token, "attempt": attempt,
                     "trace": tctx})
        # splice the cached plan JSON (encoded once per plan/split, not per
        # query) instead of re-serializing the plan dict
        if not conn.send(wire.encode_json_raw(meta, {"plan": plan_json})):
            ctx.drop_dispatch(src)
            self._finish_dispatch_span(ctx, src, error="send failed")
            raise Unavailable(f"agent {agent} not connected")
        return src

    def _await_agents(self, ctx: _QueryCtx, req_id: str, entry, q, dp,
                      split_extras, base_meta: dict, reg, fault: dict,
                      retries: int, extra_verify=None):
        """Wait for every needed agent's answer, surviving evictions and
        stragglers: evicted fragments re-plan onto the live agent set and
        re-dispatch with jittered exponential backoff (bounded by
        PL_QUERY_RETRIES); dispatches outliving their service-time deadline
        get a hedged duplicate.  Returns the final (dp, split_extras) —
        re-dispatch may have re-planned them."""
        import random as _random
        import time as _time

        from pixie_tpu_torch import metrics as _metrics
        from pixie_tpu_torch.status import CompilerError, Unavailable

        backoff_ms = float(_flags.get("PL_RETRY_BACKOFF_MS"))
        rng = _random.Random()
        deadline = _time.monotonic() + self.query_timeout_s
        rounds = 0
        while True:
            if ctx.error:
                raise Unavailable(ctx.error)
            if ctx.done.is_set():
                return dp, split_extras
            evicted = ctx.take_evictions()
            fault["evictions"] += len(evicted)
            if evicted or ctx.uncovered_agents():
                names = (sorted({a for a, _ in evicted})
                         or ctx.uncovered_agents())
                if rounds >= retries:
                    err = Unavailable(
                        f"agent {names[0]} disconnected mid-query")
                    # infrastructure loss, not a query bug: the client
                    # may retry once the agent re-registers.  The hint
                    # composes BOTH waits the retry faces: the backoff
                    # schedule covering the agent's rejoin window (the
                    # drain rate says nothing about when lost DATA
                    # comes back — a bare drain hint of 0.05s on an
                    # idle queue would burn every client retry inside
                    # the rejoin grace) and, when the rate model is
                    # warm, the measured time for the queued work
                    # ahead of the retry to drain.
                    err.retryable = True
                    hint = self.ratemodel.retry_after_s(
                        self.serving.total_queued,
                        int(_flags.get("PL_SERVING_MAX_INFLIGHT")))
                    err.retry_after_s = max(
                        min(backoff_ms * (2 ** rounds),
                            MAX_BACKOFF_MS) / 1e3,
                        hint or 0.0)
                    raise err
                rounds += 1
                fault["rounds"] = rounds
                _metrics.counter_inc(
                    "px_query_retries_total",
                    help_="query re-dispatch rounds after agent eviction")
                # jittered exponential backoff: the window a killed-and-
                # restarted agent gets to re-register before this round
                # re-plans around it
                delay = (backoff_ms * (2 ** (rounds - 1)) / 1e3
                         * (0.5 + rng.random()))
                delay = min(delay, MAX_BACKOFF_MS / 1e3,
                            max(deadline - _time.monotonic(), 0.0))
                if delay > 0:
                    _time.sleep(delay)
                t0 = _time.time_ns()
                try:
                    dp, split_extras = self._redispatch(
                        ctx, req_id, entry, q, dp, split_extras, base_meta,
                        reg, fault, extra_verify=extra_verify)
                except (Unavailable, CompilerError):
                    # the cluster cannot serve the query right now (e.g.
                    # the killed agent has not re-registered): burn the
                    # round and look again after the next backoff — the
                    # uncovered set keeps this loop re-entering here
                    continue
                trace.event_span("redispatch", t0, _time.time_ns() - t0,
                                 agents=",".join(names), round=rounds)
                continue
            nxt = self._maybe_hedge(ctx, req_id, base_meta, fault)
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise Unavailable(
                    f"query timed out after {self.query_timeout_s}s waiting "
                    f"for agents {ctx.outstanding_agents()}")
            wait_s = min(0.25, remaining)
            if nxt is not None:
                wait_s = min(wait_s, max(nxt, 0.01))
            ctx.wake.wait(timeout=wait_s)
            ctx.wake.clear()

    def _redispatch(self, ctx: _QueryCtx, req_id: str, entry, q, dp,
                    split_extras, base_meta: dict, reg, fault: dict,
                    extra_verify=None):
        """One re-plan + re-dispatch round: re-split over the LIVE agent
        set and dispatch every uncovered fragment under fresh tokens.
        Accepted results (and in-flight dispatches) whose fragments are
        unchanged are KEPT — only the lost work repeats.  Falls back to a
        full restart when the channel topology changed (e.g. a repartition
        join lost its widest mesh)."""
        from pixie_tpu_torch.engine.plancache import QueryPlanCache as _QPC
        from pixie_tpu_torch.parallel.distributed import DistributedPlanner
        from pixie_tpu_torch.status import Unavailable

        topo_epoch = self.registry.epoch
        spec = self.registry.cluster_spec()
        if not any(a.has_data_store for a in spec.agents):
            raise Unavailable("no live data agents registered")
        # a needed agent that died within the rejoin grace is REJOINING,
        # not gone: re-planning around it now would silently answer from
        # the surviving shards — burn the round and wait for it instead
        grace = float(_flags.get("PL_REJOIN_GRACE_S"))
        live = {a.name for a in spec.agents}
        rejoining = [a for a in sorted(ctx.needed_agents)
                     if a not in live
                     and a in set(self.registry.recently_dead(grace))]
        if rejoining:
            raise Unavailable(
                f"agent {rejoining[0]} re-registration pending")

        def _split():
            with trace.span("plan_split", redispatch=True):
                dp2 = DistributedPlanner(spec).plan(q.plan)
                # the re-planned split dispatches too: same pre-dispatch
                # verification contract as the first round — INCLUDING the
                # fused-batch demux invariants for batched carriers (the
                # re-split is cached into the batch slot for warm repeats)
                from pixie_tpu_torch.check import planverify

                planverify.maybe_verify(dp2, spec.combined_schemas(), reg)
                if extra_verify is not None:
                    extra_verify(dp2)
                extras = {"plan_json": {
                    a: _json.dumps(p.to_dict())
                    for a, p in dp2.agent_plans.items()
                }}
                return dp2, extras

        (dp2, extras2), _hit = _QPC.get_split(
            entry, ("split", topo_epoch), _split)
        base_meta["route_scale"] = len(dp2.agent_plans)
        if not _channels_compatible(dp, dp2):
            # topology-shaped plan state (join partition counts, channel
            # sets, the merger plan) changed: nothing folded so far is
            # usable — restart the whole dispatch under fresh tokens
            for src in list(ctx.dispatch_spans):
                self._finish_dispatch_span(ctx, src, error="redispatched")
            ctx.reset_for_restart(dp2, reg)
        else:
            with ctx.lock:
                ctx.needed_agents = set(dp2.agent_plans)
                # an accepted fragment that CHANGED under the new plan (or
                # an in-flight dispatch of one) cannot be kept — its chunks
                # answer a different question now
                for agent in list(ctx.accepted):
                    if (agent in dp2.agent_plans
                            and ctx.frag_of(ctx.accepted[agent])
                            != extras2["plan_json"][agent]):
                        ctx.accepted.pop(agent)
                for src, info in list(ctx.pending.items()):
                    agent = info["agent"]
                    if (agent not in dp2.agent_plans
                            or info.get("frag")
                            != extras2["plan_json"][agent]):
                        ctx.pending.pop(src, None)
                ctx.hedged_agents.clear()  # fresh round, fresh hedge budget
                ctx._check_done_locked()
        for agent in ctx.uncovered_agents():
            try:
                self._send_execute(ctx, req_id, agent,
                                   extras2["plan_json"][agent], base_meta)
            except Unavailable:
                # its conn raced away again — the uncovered set re-enters
                # the retry loop for it
                continue
            if agent not in fault["redispatched"]:
                fault["redispatched"].append(agent)
        return dp2, extras2

    def _maybe_hedge(self, ctx: _QueryCtx, req_id: str, base_meta: dict,
                     fault: dict):
        """Dispatch hedged duplicates for in-flight dispatches past their
        straggler deadline (first answer wins; the loser's chunks are
        discarded idempotently at merge).  Returns seconds until the next
        armed deadline, or None when nothing is armed."""
        if not _flags.get("PL_HEDGE_ENABLED"):
            return None
        import time as _time

        from pixie_tpu_torch import metrics as _metrics
        from pixie_tpu_torch.status import Unavailable

        now = _time.monotonic()
        soonest = None
        with ctx.lock:
            pend = [(s, dict(i)) for s, i in ctx.pending.items()]
        for src, info in pend:
            dl = info.get("deadline")
            if dl is None or info.get("hedged"):
                continue
            agent = info["agent"]
            with ctx.lock:
                if agent in ctx.hedged_agents or agent in ctx.accepted:
                    continue
            if now < dl:
                gap = dl - now
                soonest = gap if soonest is None else min(soonest, gap)
                continue
            try:
                self._send_execute(ctx, req_id, agent, info["frag"],
                                   base_meta, hedged=True)
            except Unavailable:
                continue  # conn gone: the eviction path owns this agent now
            fault["hedged"] += 1
            _metrics.counter_inc(
                "px_hedged_dispatches_total",
                help_="duplicate dispatches sent for straggling agents "
                      "(first answer wins)")
            _metrics.counter_inc(
                "px_hedged_dispatches_by_agent_total",
                labels={"agent": _metrics.capped_label("agent", agent)},
                help_="hedged dispatches by (capped) agent name")
        return soonest

    def _admit(self, script, func, func_args, default_limit, tenant):
        """Pass one query through the serving front's admission gate.

        Cost estimate: a plan-cache peek decides warm (dispatch+merge only)
        vs cold (full compile/split) — the same signal the DRR scheduler
        charges, so a tenant flooding cold compiles drains proportionally
        slower.  The cold price is the MEASURED cold/warm service-time
        ratio once the rate model has samples (PL_RATE_MODEL), the static
        COST_COLD until then.  Raises ShedError (quota/queue-full/timeout/
        overload); returns (ticket, plan_class) — ticket None when serving
        is disabled (the class still feeds the model)."""
        from pixie_tpu_torch.serving import ratemodel as _rm

        trace.set_attr(tenant=tenant)
        from pixie_tpu_torch.engine import plancache as _plancache

        # mutations classify apart (deploy round-trips must skew neither
        # service class) — the same lexical marker the client's no-retry
        # rule uses; everything else prices off the plan-cache peek
        mutation = ("UpsertTracepoint" in script
                    or "DeleteTracepoint" in script)
        if not _plancache.enabled():
            # PL_QUERY_FASTPATH=0: no warm/cold signal exists and every
            # query pays the same full compile — price uniformly WARM so
            # DRR stays fair by count and the overload shed (which drops
            # cost >= COST_COLD work) cannot turn degradation into a full
            # outage
            warm = True
        else:
            key = self.plan_cache.key(script, func, func_args, default_limit,
                                      ("reg", self.registry.epoch),
                                      tenant=tenant)
            warm = self.plan_cache.contains(key)
        cls = _rm.plan_class(warm, mutation=mutation)
        self.ratemodel.observe_arrival(tenant, cls)
        if not self.serving.enabled():
            return None, cls  # pass-through: no accounting, no queueing
        cost = (COST_WARM if warm
                else self.ratemodel.cost_of(False) if _rm.enabled()
                else COST_COLD)
        with trace.span("admission_wait", tenant=tenant, cost=cost):
            ticket = self.serving.admit(tenant, cost)
        if ticket.queued:
            # the scheduler's dispatch decision as its own span: start =
            # enqueue, duration = queue wait (ends at dispatch)
            trace.event_span("sched_dispatch", ticket.enqueue_ns,
                             ticket.wait_ns, tenant=tenant, cost=cost,
                             degraded=ticket.degraded)
        return ticket, cls

    def execute_script(
        self, script: str, func=None, func_args=None, now=None,
        default_limit=None, analyze: bool = False, funcs=None,
        tenant: str = None, explain: bool = False,
    ) -> tuple[dict[str, QueryResult], dict]:
        """Compile + distribute + merge (the in-process core of ExecuteScript).

        `funcs=[(prefix, func_name, func_args)]` executes a MULTI-widget
        request as ONE fused distributed query (shared scans/filters/aggs
        run once — reference optimizer.h:39 MergeNodesRule); the returned
        stats carry `sink_map` so the caller splits results per widget.

        `explain=True` (EXPLAIN ANALYZE) annotates whatever path ACTUALLY
        served the query — plan tree, measured phase breakdown, per-op ns,
        cache/matview/batch/failover provenance — into stats["explain"] +
        stats["profile"], without changing execution (a matview hit is
        explained AS a matview hit, not bypassed).
        """
        import time as _time

        from pixie_tpu_torch import observe as _observe
        from pixie_tpu_torch import metrics as _metrics
        from pixie_tpu_torch.serving import slo as _slo

        tenant = str(tenant or DEFAULT_TENANT)
        _metrics.counter_inc("px_broker_queries_total",
                             help_="ExecuteScript requests received")
        # In-process callers (cron, tests) get their own trace root; under
        # the networked path _run_query's root is already active and this is
        # a no-op.  Shipping happens only when this frame owns the root.
        owns_root = trace.enabled() and trace.current() is None
        #: flight recorder: assemble a per-query profile when tracing is on
        #: (recorded into self_telemetry.*) or explain was requested (the
        #: per-query opt-in works with tracing off, without recording)
        prof_on = trace.enabled() or explain
        t0 = _time.perf_counter()
        t0_unix_ns = _time.time_ns()
        shed = False
        ok_query = False
        qid = None
        cls = None  # rate-model plan class, set once admission classifies
        wait_ns = 0
        try:
            with trace.maybe_root(self.tracer, "query"):
                # captured while the trace root is live: the except block
                # below runs AFTER the cm unwinds, and an error profile
                # must still join this query's spans on query_id==trace_id
                qid = self._query_trace_id() if prof_on else None
                ticket, cls = self._admit(script, func, func_args,
                                          default_limit, tenant)
                wait_ns = ticket.wait_ns if ticket is not None else 0
                ok = False
                try:
                    results, stats = self._execute_script_inner(
                        script, func, func_args, now, default_limit, analyze,
                        funcs, tenant=tenant, ticket=ticket, explain=explain,
                    )
                    ok = True
                    ok_query = True
                    if prof_on:
                        self._record_profile(
                            qid, stats, tenant, t0_unix_ns,
                            int((_time.perf_counter() - t0) * 1e9),
                            explain=explain)
                    return results, stats
                finally:
                    self.serving.release(ticket, ok=ok)
        except ShedError:
            # admission rejections are flow control, not query failures —
            # they are counted under px_serving_shed_total instead
            shed = True
            raise
        except Exception as e:
            _metrics.counter_inc("px_broker_query_errors_total",
                                 help_="ExecuteScript requests that failed")
            if trace.enabled():
                # failed queries are profile rows too (status=error): an
                # error budget burning down must be visible in the same
                # table the latency dashboards read
                prow, _ops = _observe.build_profile(
                    qid or self._query_trace_id(), tenant, "broker",
                    t0_unix_ns, int((_time.perf_counter() - t0) * 1e9), {},
                    status="error", error=str(e))
                self._telemetry.add(_observe.PROFILES_TABLE, [prow])
            raise
        finally:
            latency_s = _time.perf_counter() - t0
            if not shed:
                # sheds stay out of the latency SLO histogram: a flood of
                # sub-ms rejections (or 30s queue-timeout sheds) during
                # overload would swamp the distribution of queries that
                # actually EXECUTED — exactly when the SLO signal matters
                _metrics.histogram_observe(
                    "px_broker_query_latency_seconds",
                    latency_s, QUERY_LATENCY_BOUNDS,
                    help_="broker end-to-end ExecuteScript latency "
                          "(executed queries; sheds excluded)")
            # the serving front's SLO loop eats every outcome — completed,
            # failed, AND shed (a shed is a client-visible availability
            # failure; hiding it from the burn rate would defeat the alert)
            _slo.record_query(tenant, latency_s, ok_query)
            # the rate model eats SERVICE time only (queue wait excluded —
            # it measures how fast the engine serves, not the line length);
            # sheds never executed, so they feed arrival counts only
            if cls is not None and not shed:
                self.ratemodel.observe(tenant, cls,
                                       latency_s - wait_ns / 1e9, ok_query)
            if _slo.configured():
                mon = _slo.monitor()
                mon.maybe_evaluate()
                self._telemetry.add(_observe.ALERTS_TABLE,
                                    mon.drain_alerts())
            if owns_root:
                self._ship_spans()

    def _query_trace_id(self) -> str:
        """Query id for profile rows: the active trace root's trace_id (so
        profiles JOIN against self_telemetry.spans), else a fresh token."""
        c = trace.current()
        if c is not None:
            return c[1].trace_id
        import secrets as _secrets

        return _secrets.token_hex(16)

    def _record_profile(self, qid, stats: dict, tenant: str,
                        t0_unix_ns: int, wall_ns: int,
                        explain: bool) -> None:
        """Assemble this query's flight-recorder profile from its stats and
        attach it (stats["profile"], stats["explain"]); recording into the
        data plane only happens with tracing enabled."""
        from pixie_tpu_torch import observe as _observe

        profile, op_rows = _observe.build_profile(
            qid or self._query_trace_id(), tenant, "broker", t0_unix_ns,
            wall_ns, stats)
        stats["profile"] = profile
        if explain:
            stats["explain"] = _observe.render_explain(
                profile, op_rows, plan_text=stats.pop("plan_explain", None))
        if trace.enabled():
            self._telemetry.add(_observe.PROFILES_TABLE, [profile])
            self._telemetry.add(_observe.OP_STATS_TABLE, op_rows)
            if _autotune.enabled():
                at_rows = _autotune.rows_from_stats(
                    stats, profile.get("query_id", ""))
                if at_rows:
                    self._telemetry.add(_observe.AUTOTUNE_TABLE, at_rows)

    def _execute_script_inner(
        self, script, func, func_args, now, default_limit, analyze,
        funcs=None, tenant: str = DEFAULT_TENANT, ticket=None,
        explain: bool = False,
    ) -> tuple[dict[str, QueryResult], dict]:
        import time as _time

        from pixie_tpu_torch import metrics as _metrics
        from pixie_tpu_torch.compiler import compile_pxl, compile_pxl_funcs
        from pixie_tpu_torch.status import Internal, Unavailable

        if self.elector is not None and not self.elector.is_leader():
            leader = self.elector.leader()
            raise Unavailable(
                f"this broker is not the leader (current leader: {leader})")
        if _autotune.enabled():
            # arrival-rate signal for the batch-window controller
            _autotune.MODEL.observe_arrival()
        # Hold for shards whose agent died moments ago and may re-register
        # (kill-and-restart): planning through the gap would silently serve
        # a reduced topology
        self._await_rejoin_grace()
        # Epoch BEFORE cluster_spec: a registration landing between the two
        # reads must not let a split computed from the agent-less spec be
        # cached under the post-registration epoch (sticky wrong results).
        # The inverse race — cluster_spec's live_agents() expiring an agent
        # and bumping the epoch after our read — only caches the fresh split
        # under the stale epoch: one redundant miss, never a poisoned hit.
        topo_epoch = self.registry.epoch
        spec = self.registry.cluster_spec()
        if not any(a.has_data_store for a in spec.agents):
            e = Unavailable("no live data agents registered")
            # nothing compiled, nothing executed: always safe to retry
            # once an agent (re-)registers
            e.retryable = True
            e.retry_after_s = 1.0
            raise e
        sink_map = None
        entry = None
        plan_cache_hit = False
        t_compile0 = _time.perf_counter_ns()
        if funcs:
            # multi-widget fusion stays on the slow path: its sink_map and
            # per-widget arg sets make the cache key explode for no warm win
            with trace.span("compile"):
                q, sink_map = compile_pxl_funcs(
                    script, self.registry.combined_schemas(),
                    [(p, f, a) for p, f, a in funcs],
                    registry=self.udf_registry, now=now,
                    default_limit=default_limit,
                )
        else:
            def _compile():
                with trace.span("compile"):
                    return compile_pxl(
                        script, self.registry.combined_schemas(), func=func,
                        func_args=func_args, registry=self.udf_registry,
                        now=now, default_limit=default_limit,
                    )

            key = self.plan_cache.key(script, func, func_args, default_limit,
                                      ("reg", topo_epoch), tenant=tenant)
            q, entry, plan_cache_hit = self.plan_cache.get_query(key, _compile)
        compile_ns = _time.perf_counter_ns() - t_compile0
        plan_text = None
        if explain:
            from pixie_tpu_torch.plan.debug import explain as _plan_explain

            plan_text = _plan_explain(q.plan)
        if q.mutations:
            raise Unimplemented("tracepoint mutations are not ported yet "
                                "(ROADMAP Queue 1 item 6e)")
        if not analyze and funcs is None \
                and not getattr(q, "now_sensitive", True):
            # Concurrent-query batching (PL_QUERY_BATCHING): groupable
            # concurrent queries over the same (table, scan window,
            # topology epoch) rendezvous at the serving front's dispatch
            # seam and execute as ONE fused distributed query; results
            # demux back per member.  None = run the normal path.
            got = self._maybe_batched(q, key, spec, topo_epoch, tenant,
                                      ticket)
            if got is not None:
                results, stats = got
                if plan_text is not None or trace.enabled():
                    # a batched member's profile carries ITS OWN compile
                    # time and logical plan (the fused plan is the
                    # leader's implementation detail) beside the fused
                    # run's measured phases + batch slot
                    stats = dict(stats)
                    stats["phases"] = dict(stats.get("phases") or {},
                                           compile_ns=compile_ns)
                    if plan_text is not None:
                        stats["plan_explain"] = plan_text
                return results, stats
        return self._run_distributed(
            q, entry, spec, topo_epoch, analyze, tenant, ticket,
            plan_cache_hit, sink_map=sink_map, compile_ns=compile_ns,
            plan_text=plan_text)

    # ------------------------------------------------------ query batching
    def _maybe_batched(self, q, key, spec, topo_epoch, tenant, ticket):
        """Pass one compiled, cache-eligible query through the shared
        batching gate (serving/batching.gate).  Returns (results, stats)
        when the query was served through a fused batch, or None to run
        the normal path (batching off, non-groupable plan, matview-shaped
        member, solo leader)."""
        from pixie_tpu_torch.serving import batching

        reg = self.udf_registry
        if reg is None:
            from pixie_tpu_torch.udf import registry as reg
        window_s = float(_flags.get("PL_BATCH_WINDOW_MS")) / 1e3
        max_n = int(_flags.get("PL_BATCH_MAX_QUERIES"))
        at_dec = None
        if _autotune.enabled():
            # rendezvous window from measured wave RTT, member cap from the
            # measured arrival rate (engine/autotune.py batch controller);
            # both clamped to a 4x band around the operator's constants
            window_s, max_n, at_dec = _autotune.MODEL.batch_window(
                window_s, max_n)
        got = batching.gate(
            self._batcher, q.plan, key, topo_epoch, window_s, max_n,
            lambda members: self._execute_batch(members, spec, topo_epoch,
                                                reg),
            wait_timeout_s=self.query_timeout_s + 30.0,
            tenant=tenant, ticket=ticket, registry=reg,
            # concurrent-traffic signal: other queries executing past
            # admission right now (members waiting in a batch hold their
            # slots, so sustained concurrency keeps this ≥ 2; a lone
            # sequential client sees only itself and never waits)
            concurrency=lambda: (self.serving.enabled()
                                 and self.serving.inflight >= 2))
        if got is None:
            return None
        results, stats = got
        if at_dec is not None and isinstance(stats, dict):
            # fresh list, not setdefault: fused-member stats share inner
            # structures across the batch — appending in place would leak
            # this member's decision into every sibling's stats
            stats = dict(stats)
            stats["autotune"] = list(stats.get("autotune") or []) + [at_dec]
        b = (stats or {}).get("batch") or {}
        if b.get("t0_unix_ns"):
            # ONE batch_exec span under every member's query root (leaders
            # and waiters alike): the cross-query group marker
            trace.event_span("batch_exec", b["t0_unix_ns"],
                             b.get("wall_ns", 0),
                             size=b.get("size"), slot=b.get("slot"))
        return results, stats

    def _execute_batch(self, members, spec, topo_epoch, reg):
        """Batch-leader path: merge the member plans (shared scans, deduped
        chains, per-slot renamed sinks; identical members share ONE
        computed slot), split+verify once per batch signature riding the
        split cache, run ONE fault-tolerant distributed dispatch (an
        evicted agent's WHOLE fused fragment re-dispatches — the pinned
        mid-batch recovery semantic), and demux per-member
        (results, stats)."""
        import time as _time
        import types

        from pixie_tpu_torch.check import planverify
        from pixie_tpu_torch.serving import batching

        k = len(members)
        slot, plans, slot_of = batching.fused_slot(
            self._batch_splits, self._qlock, members,
            spec.combined_schemas())
        # DRR cost-accounting: each member was admitted at the full plan
        # cost estimate; the batch executes ~one dispatch, so charge the
        # amortized share (refunds queued members' deficit — batching must
        # not distort tenant fairness)
        for m in members:
            if m.ticket is not None:
                self.serving.rebate(m.ticket, m.ticket.cost / k)
        fused_q = types.SimpleNamespace(plan=slot.fused, mutations=[],
                                        now_sensitive=False)
        # the batch_exec span lands on EVERY member root (leader included)
        # via the event emission in _maybe_batched — no cm span here, or
        # the leader's root would carry it twice
        t0_ns = _time.time_ns()
        results, stats = self._run_distributed(
            fused_q, slot, spec, topo_epoch, False,
            "__batch__", None, plan_cache_hit=False,
            extra_verify=lambda dp: planverify.maybe_verify_fused_batch(
                dp, slot.sink_map))
        wall_ns = _time.time_ns() - t0_ns
        if _autotune.enabled():
            # measured fused-wave wall → the batch-window controller
            _autotune.MODEL.observe_batch_wave(wall_ns / 1e9, k)
        batching.note_formed(k)
        out = []
        for i, m in enumerate(members):
            res = batching.demux_results(results, slot.sink_map,
                                         f"q{slot_of[i]}")
            st = dict(stats)
            st["batch"] = {"size": k, "slots": len(plans),
                           "slot": slot_of[i], "t0_unix_ns": t0_ns,
                           "wall_ns": wall_ns}
            st["serving"] = {
                "tenant": m.tenant,
                "queued_ms": (round(m.ticket.wait_ns / 1e6, 3)
                              if m.ticket is not None and m.ticket.queued
                              else 0.0),
                "cost": m.ticket.cost if m.ticket is not None else None,
                "degraded": stats.get("serving", {}).get("degraded", False),
            }
            for qr in res.values():
                qr.exec_stats["batch"] = st["batch"]
            out.append((res, st))
        return out

    def _run_distributed(
        self, q, entry, spec, topo_epoch, analyze, tenant,
        ticket, plan_cache_hit, sink_map=None, extra_verify=None,
        compile_ns: int = 0, plan_text=None,
    ) -> tuple[dict[str, QueryResult], dict]:
        """Split (cached per topology epoch), dispatch to agents with the
        fault-tolerant machinery, fold/merge, run the merger plan, and
        assemble per-query stats — the shared back half of
        `_execute_script_inner` and the fused-batch leader path
        (`_execute_batch`, which passes the merged plan as `q` and the
        batch-signature slot as `entry` so warm batches ride the same
        split cache)."""
        import time as _time

        from pixie_tpu_torch import metrics as _metrics
        from pixie_tpu_torch.status import Internal, Unavailable

        def _split():
            with trace.span("plan_split"):
                dp = DistributedPlanner(spec).plan(q.plan)
                # pre-dispatch verification rides the split computation, so
                # a cached split IS a verified split: warm queries skip it
                # entirely (check/planverify.py, PX_PLAN_VERIFY)
                from pixie_tpu_torch.check import planverify

                planverify.maybe_verify(dp, spec.combined_schemas(),
                                        self.udf_registry)
                if extra_verify is not None:
                    extra_verify(dp)
                # pre-serialize the per-agent plan dicts: the dispatch loop
                # splices these cached JSON fragments into each execute
                # frame instead of re-walking + re-dumping the plan per query
                extras = {"plan_json": {
                    a: _json.dumps(p.to_dict())
                    for a, p in dp.agent_plans.items()
                }}
                return dp, extras

        from pixie_tpu_torch.engine.plancache import QueryPlanCache as _QPC

        #: flight-recorder phase anchors (observe.build_profile): one
        #: perf_counter read per phase boundary — cheap enough to measure
        #: unconditionally; the dict only ships when profiles are on
        t_split0 = _time.perf_counter_ns()
        (dp, split_extras), split_hit = _QPC.get_split(
            entry, ("split", topo_epoch), _split)
        split_ns = _time.perf_counter_ns() - t_split0

        reg = self.udf_registry
        if reg is None:
            from pixie_tpu_torch.udf import registry as reg
        # Broker-side view matcher: which agent fragments have a standing-
        # query shape?  The agents decide (and do) the actual serving — this
        # is the control-plane ledger that makes hit/miss observable per
        # query (stats["matview"], px_broker_matview_* counters, and a
        # matview_hit span when the whole query answered from views).
        # Disabled subsystem = no ledger: otherwise every query would pay
        # the canonicalize+hash and count as a "miss" for a feature that
        # is off.
        import pixie_tpu_torch.matview  # noqa: F401 — defines the PL_MATVIEW_* flags

        with self._qlock:
            self._req_counter += 1
            req_id = f"q{self._req_counter}"
            ctx = _QueryCtx(set(dp.channels))
            ctx.needed_agents = set(dp.agent_plans)
            ctx.configure_folds(dp, reg)
            self._queries[req_id] = ctx
        # Degradation hints ride each execute frame: past the shed
        # watermark, matview hits serve standing state WITHOUT folding
        # their delta (stale-while-revalidate) and the agents' chunk ack
        # window narrows so producers throttle at the source.  Read at
        # dispatch time (not admit time) so a queue that drained while
        # this query waited dispatches at full quality.
        degraded = self.serving.enabled() and self.serving.degraded()
        base_meta = {
            "msg": "execute",
            "analyze": analyze,
            # tenant rides to the agents: matview state namespaces
            # per tenant under PL_TENANT_ISOLATION
            "tenant": tenant,
            # distributed fan-out: agents route CPU/card by the
            # query's total size, not their local shard's
            "route_scale": len(dp.agent_plans),
        }
        if degraded:
            base_meta["stale_ok"] = True
            dw = int(_flags.get("PL_SERVING_DEGRADED_WINDOW"))
            if dw > 0:
                base_meta["stream_window"] = dw
        #: per-query fault/recovery ledger → stats["fault"]
        fault = {"rounds": 0, "evictions": 0, "hedged": 0,
                 "chunks_discarded": 0, "redispatched": []}
        retries = int(_flags.get("PL_QUERY_RETRIES"))
        t_exec0 = _time.perf_counter_ns()
        try:
            for agent_name in dp.agent_plans:
                pj = (split_extras["plan_json"].get(agent_name)
                      or _json.dumps(dp.agent_plans[agent_name].to_dict()))
                try:
                    self._send_execute(ctx, req_id, agent_name, pj, base_meta)
                except Unavailable:
                    if retries <= 0:
                        raise
                    # the retry loop below re-plans around (or waits out)
                    # the missing agent
                    with ctx.lock:
                        ctx.evictions.append((agent_name, "not connected"))
                        ctx.wake.set()
            if dp.agent_plans:
                dp, split_extras = self._await_agents(
                    ctx, req_id, entry, q, dp, split_extras, base_meta,
                    reg, fault, retries, extra_verify=extra_verify)
            if ctx.error:
                raise Unavailable(ctx.error)
            mv_keys = {}
            if _flags.get("PL_MATVIEW_ENABLED"):
                from pixie_tpu_torch.matview.registry import plan_view_key

                mv_keys = {
                    name: k for name, plan in dp.agent_plans.items()
                    if (k := plan_view_key(plan, reg)) is not None
                }

            t_merge0 = _time.perf_counter_ns()
            with trace.span("merge"):
                from pixie_tpu_torch.parallel.repartition import (
                    bucket_channels,
                    run_join_stages,
                    stage_output_inputs,
                )

                # chunk folds ran on the reader threads (no trace context
                # there): emit them as spans now, under this query's root —
                # their start times preceding last_terminal_ns is the direct
                # evidence that merge work overlapped agent compute
                for t0_ns, dur_ns, cid, agent in ctx.fold_events:
                    trace.event_span("incremental_fold", t0_ns, dur_ns,
                                     channel=cid, agent=agent)
                # only the ACCEPTED sources (first answer per agent) merge;
                # everything else — evicted agents' partial streams, losing
                # hedge attempts, late duplicates — is discarded here and
                # counted, never folded into the answer.  Losing/superseded
                # producers may STILL be streaming into ctx on their reader
                # threads, so every shared structure is read under its lock
                # (an unguarded dict iteration here would raise mid-merge
                # and fail a query that succeeded).
                with ctx.lock:
                    accepted_srcs = set(ctx.accepted.values())
                    buckets = {cid: {s: list(chunks)
                                     for s, chunks in by_src.items()}
                               for cid, by_src in ctx.bucket_payloads.items()}
                discarded = 0
                payloads: dict[str, list] = {cid: [] for cid in dp.channels}
                for cid, by_src in buckets.items():
                    for s, chunks in sorted(by_src.items()):
                        if s in accepted_srcs and cid in payloads:
                            payloads[cid].extend(chunks)
                        else:
                            discarded += len(chunks)
                if dp.join_stages:
                    # repartitioned joins run partition-parallel on the merger
                    # (the Kelvin role); bucket channels are consumed here, with
                    # the same payload-shape contract as rows channels
                    run_join_stages(dp, payloads, reg,
                                    store=self.merger_store, analyze=analyze)
                consumed = bucket_channels(dp)
                inputs: dict[str, HostBatch] = {}
                folded_total = 0
                for cid, ch in dp.channels.items():
                    if cid in consumed:
                        continue
                    fold = ctx.folds.get(cid)
                    flock = ctx.fold_locks.get(cid)
                    if fold is None or flock is None:
                        raise Internal(f"channel {cid} received no payloads")
                    # the channel's fold lock serializes against loser/
                    # superseded producers still folding on reader threads
                    with flock:
                        total = sum(fold.count_for(s)
                                    for s in accepted_srcs)
                        if total == 0:
                            raise Internal(
                                f"channel {cid} received no payloads")
                        # every chunk an accepted producer SENT must have
                        # folded: a dropped frame means a silently-partial
                        # answer, so fail instead
                        for s in sorted(accepted_srcs):
                            exp = ctx.expected_chunks.get((cid, s))
                            if exp is not None and fold.count_for(s) != exp:
                                raise Internal(
                                    f"channel {cid}: folded "
                                    f"{fold.count_for(s)} of "
                                    f"{exp} chunk frames")
                        folded_total += total
                        discarded += fold.discarded_chunks(accepted_srcs)
                        # the running per-src folds already combined every
                        # chunk on arrival; finish() pays one cross-source
                        # combine (deterministic sorted-source order) + the
                        # finalize
                        with trace.span("merge_finish", channel=cid,
                                        kind=ch.kind, chunks=total,
                                        incremental=True):
                            inputs[cid] = fold.finish(accepted_srcs)
                if discarded:
                    _metrics.counter_inc(
                        "px_chunks_discarded_total", float(discarded),
                        help_="producer chunks discarded at merge (evicted "
                              "agents' partial streams, losing hedge "
                              "attempts, late duplicates)")
                fault["chunks_discarded"] = discarded
                inputs.update(stage_output_inputs(dp, payloads))

                from pixie_tpu_torch.udf.udtf import UDTFContext

                ex = PlanExecutor(
                    dp.merger_plan, self.merger_store, self.udf_registry,
                    device=self.device, inputs=inputs, analyze=analyze,
                    udtf_ctx=UDTFContext(
                        table_store=self.merger_store, registry=reg,
                        agent_registry=self.registry,
                    ),
                )
                results = ex.run()
                # The merger plan's sources are channels (no STs); the LOGICAL
                # plan + agent schemas determine them.
                from pixie_tpu_torch.engine.semantics import SchemaStore, restamp_result

                sstore = SchemaStore(self.registry.combined_schemas())
                for r in results.values():
                    restamp_result(r, q.plan, sstore, reg)
                stats = {"agents": ctx.agent_stats, "merger": dict(ex.stats)}
                #: fast-path observability: did this query skip compile /
                #: split work?  (PL_QUERY_FASTPATH off ⇒ both always False)
                stats["fastpath"] = {"plan_cache_hit": plan_cache_hit,
                                     "split_cache_hit": split_hit}
                #: serving-front observability per query: its tenant, the
                #: queue wait it paid, and whether it dispatched degraded
                #: (stale matview serving + narrowed ack window)
                stats["serving"] = {
                    "tenant": tenant,
                    "queued_ms": (round(ticket.wait_ns / 1e6, 3)
                                  if ticket is not None and ticket.queued
                                  else 0.0),
                    "cost": ticket.cost if ticket is not None else None,
                    "degraded": degraded,
                }
                if mv_keys:
                    served = {
                        a: s["matview"] for a, s in ctx.agent_stats.items()
                        if isinstance(s, dict) and s.get("matview")
                    }
                    hits = sum(1 for i in served.values() if i.get("hit"))
                    stats["matview"] = {
                        "eligible_agents": len(mv_keys),
                        "agents_hit": hits,
                        "rows_folded": sum(
                            int(i.get("rows_folded", 0))
                            for i in served.values()),
                        "keys": sorted(set(mv_keys.values())),
                    }
                    if hits and hits == len(dp.agent_plans):
                        # the ENTIRE scan side answered from standing state:
                        # this query's cost was delta folds + one finalize
                        _metrics.counter_inc(
                            "px_broker_matview_hit_queries_total",
                            help_="queries fully answered from standing "
                                  "view state on every agent")
                        trace.event_span(
                            "matview_hit", _time.time_ns(), 0,
                            agents=hits,
                            rows_folded=stats["matview"]["rows_folded"])
                    else:
                        _metrics.counter_inc(
                            "px_broker_matview_miss_queries_total",
                            help_="view-eligible queries that rescanned on "
                                  "at least one agent")
                #: streaming-merge observability: merge_overlapped=True means
                #: the first chunk folded BEFORE the last agent's terminal
                #: frame — merge cost hid under the slowest agent's compute
                stats["stream"] = {
                    "chunks_folded": folded_total,
                    "first_fold_unix_ns": ctx.first_fold_ns,
                    "last_terminal_unix_ns": ctx.last_terminal_ns,
                    "merge_overlapped": bool(
                        ctx.first_fold_ns is not None
                        and ctx.last_terminal_ns is not None
                        and ctx.first_fold_ns < ctx.last_terminal_ns),
                }
                #: fault-recovery observability per query: re-dispatch
                #: rounds paid, agents evicted mid-query, hedged duplicate
                #: dispatches, and chunks discarded at merge — all zero on
                #: the fault-free path.  Row-completeness accounting: the
                #: rows each accepted source actually scanned (0 for
                #: standing-view serves) — the audit trail for "did this
                #: answer cover every shard".  (No failover replicas serve
                #: without replication: that map stays empty.)
                fault["failover"] = {}
                fault["rows_scanned"] = {
                    a: int(s.get("rows_scanned", 0))
                    for a, s in ctx.agent_stats.items()
                    if isinstance(s, dict)
                }
                stats["fault"] = fault
                if sink_map is not None:
                    stats["sink_map"] = sink_map
                    stats["merger"]["operators"] = ex.op_stats
                for r in results.values():
                    r.exec_stats["agents"] = ctx.agent_stats
            if trace.enabled() or plan_text is not None:
                # where the time went, measured at the phase seams the
                # spans already mark — observe.build_profile sums these
                # into the per-query attribution row
                stats["phases"] = {
                    "compile_ns": int(compile_ns),
                    "plan_split_ns": int(split_ns),
                    "exec_ns": int(t_merge0 - t_exec0),
                    "merge_ns": int(_time.perf_counter_ns() - t_merge0),
                }
                if plan_text is not None:
                    stats["plan_explain"] = plan_text
            return results, stats
        finally:
            # span hygiene: a timeout / disconnect / error leaves dispatch
            # spans without an exec_done to close them
            for src in list(ctx.dispatch_spans):
                self._finish_dispatch_span(ctx, src,
                                           error=ctx.error or "unresolved")
            with self._qlock:
                self._queries.pop(req_id, None)


def _jsonable(obj):
    import numpy as np

    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
