"""Agent runtime: a PEM analog — local TableStore (+ collectors) that dials
the broker, registers its schemas, heartbeats, and executes plan fragments.

Reference: src/vizier/services/agent/ Manager (registration handshake +
heartbeats every 5s, manager/manager.h:100-266, heartbeat.h:79) and
ExecuteQueryMessageHandler running plans on a threadpool (manager/exec.cc:38-98).
PEM wiring of collector→store mirrors pem/pem_manager.cc:47.

Copied from the reference package (pixie_tpu/services/agent.py).  Each agent
runs its plan fragments through the port's PlanExecutor on its `device`:
the CUDA card unless the caller passes another (`device="cpu"`, `--device
cpu`); with no card and no device given it raises.  Its standing views
(MatViewManager) live on the same device.  What stays refused, with
Unimplemented: sealed-batch replication (PL_REPLICATION > 1) and its
takeover serves, shard re-homing and the retire drain audit (ROADMAP Queue 1
item 6d, part 2), and dynamic tracepoints (item 6e): a deploy_tracepoint
frame is answered with tracepoint_error.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Optional

import numpy as np

from pixie_tpu_torch import flags, observe, trace
from pixie_tpu_torch.engine.executor import HostBatch, PlanExecutor, resolve_device
from pixie_tpu_torch.matview import MatViewManager
from pixie_tpu_torch.parallel.partial import PartialAggBatch
from pixie_tpu_torch.plan.plan import Plan
from pixie_tpu_torch.services import wire
from pixie_tpu_torch.ops import _build as _kernels
from pixie_tpu_torch.services.registry import refuse_replication
from pixie_tpu_torch.status import Unimplemented
from pixie_tpu_torch.services.transport import Connection, dial
from pixie_tpu_torch.table import heat as _heat
from pixie_tpu_torch.table import journal as _journal
from pixie_tpu_torch.table.table import TableStore

DEFAULT_HEARTBEAT_S = 5.0  # reference manager/heartbeat.h:79

flags.define_int(
    "PL_STREAM_WINDOW", 4,
    "max unacked in-flight result chunk frames per query (the agent blocks "
    "further chunk sends until the broker acks; 0 = unbounded)")
flags.define_int(
    "PL_STREAM_AGG_CHUNK_GROUPS", 65536,
    "split an agg_state channel payload into chunks of at most this many "
    "groups so the broker's incremental fold starts early; 0 = one chunk")
#: give up waiting for chunk acks after this long and degrade to unbounded
#: streaming — a slow broker must throttle us, a broken one must not hang us
ACK_STALL_S = 10.0


def _chunk_view_state(channel: str, pb: PartialAggBatch, agg_chunk_groups: int):
    """Yield a standing view's state as the same chunk stream shape the
    executor produces, honoring the agg-chunk split so the broker's
    incremental fold and ack window behave identically on view answers."""
    from pixie_tpu_torch.parallel.partial import slice_partial

    n = pb.num_groups
    if agg_chunk_groups > 0 and n > agg_chunk_groups:
        for a in range(0, n, agg_chunk_groups):
            idx = np.arange(a, min(a + agg_chunk_groups, n))
            yield channel, slice_partial(pb, idx)
    else:
        yield channel, pb


class Agent:
    def __init__(
        self,
        name: str,
        broker_host: str,
        broker_port: int,
        store: Optional[TableStore] = None,
        collector=None,
        registry=None,
        heartbeat_s: float = DEFAULT_HEARTBEAT_S,
        n_devices: Optional[int] = None,
        auth_token: Optional[str] = None,
        healthz_port: Optional[int] = None,
        healthz_host: str = "127.0.0.1",
        device=None,
    ):
        refuse_replication()
        #: the device this agent's executors and standing views run on
        self.device = resolve_device(device)
        self.auth_token = auth_token
        self.healthz = None
        if healthz_port is not None:
            from pixie_tpu_torch.services.health import HealthzServer

            self.healthz = HealthzServer(checks={
                "broker_conn": lambda: (self.conn is not None
                                        and not self.conn.closed),
                "registered": lambda: self._registered.is_set(),
            }, host=healthz_host, port=healthz_port,
                detail={"journal": self._journal_detail})
        self.name = name
        self.broker = (broker_host, broker_port)
        self.store = store or (collector.store if collector else TableStore())
        #: shard identity for the heat model (table/heat.py): executor feeds
        #: over this store account as this agent's shard
        self.store.node_name = name
        self.collector = collector
        self.registry = registry
        self.heartbeat_s = heartbeat_s
        self.n_devices = n_devices
        self.conn: Optional[Connection] = None
        self.asid: Optional[int] = None
        self._registered = threading.Event()
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        #: self-telemetry: this agent's exec spans + broker-shipped spans
        #: land in the local spans table, created BEFORE registration so the
        #: broker's registry knows the schema from the first handshake
        self.tracer = trace.Tracer(name)
        trace.ensure_table(self.store)
        #: flight-recorder tables (query profiles, op stats, metrics,
        #: alerts) exist before registration too: the broker ships its
        #: per-query rows here and PxL dashboards scan them like any table
        observe.ensure_self_tables(self.store)
        self._self_metrics = None
        #: standing materialized views over this agent's store: repeated
        #: scan→filter→map→partial-agg plans answer from incrementally
        #: refreshed state instead of rescanning (pixie_tpu_torch.matview)
        self.matviews = MatViewManager(self.store, registry, device=self.device)
        #: req_id → in-flight window semaphore; chunk_ack frames release it
        self._windows: dict[str, threading.Semaphore] = {}
        self._windows_lock = threading.Lock()
        #: durable data plane (PL_DATA_DIR): set in start()
        self.rehydrate_stats: dict = {}
        self._owns_journal = False
        self.pod_killed = threading.Event()

    # ---------------------------------------------------------------- lifecycle
    def start(self, timeout: float = 10.0) -> "Agent":
        trace.register_gauges()
        if self.collector is not None:
            self.collector.start()
        self.conn = dial(*self.broker, on_frame=self._on_frame)
        # fault-injection target (services/faultinject.py): chaos plans
        # address this agent's broker link as "agent:<name>"; kill rules
        # (true pod loss) route back into _pod_kill through the handler
        # registry so the store drops with the connection
        self.conn.label = f"agent:{self.name}"
        from pixie_tpu_torch.services import faultinject as _faultinject

        _faultinject.register_kill_handler(self.conn.label, self._pod_kill)
        if self.auth_token is not None:
            self.conn.send(wire.encode_json(
                {"msg": "auth", "token": self.auth_token}))
        self._rehydrate()
        self._register()
        if not self._registered.wait(timeout=timeout):
            raise TimeoutError(f"agent {self.name}: broker did not ack registration")
        self._hb_thread = threading.Thread(
            target=self._hb_loop, daemon=True, name=f"pixie-agent-hb-{self.name}"
        )
        self._hb_thread.start()
        if self.healthz is not None:
            self.healthz.start()
        self.matviews.start_refresher()  # no-op unless PL_MATVIEW_REFRESH_S>0
        period = float(flags.get("PL_SELF_METRICS_S"))
        if period > 0:
            from pixie_tpu_torch.services.cron import Ticker

            # metrics-as-data on the agent side: this process's registry
            # folds into the LOCAL store (no hop — the agent IS the data
            # plane), stamped with the agent's own service name
            self._self_metrics = Ticker(
                f"self_metrics_{self.name}", period,
                self._fold_self_metrics).start()
        return self

    def _journal_detail(self) -> dict:
        """Per-table journal disk usage for the /healthz detail payload:
        PL_JOURNAL_MAX_MB pruning pressure, visible before it bites."""
        from pixie_tpu_torch.table.table import Table

        tables = {}
        total = 0
        for name in self.store.names():
            t = self.store._tables.get(name)
            j = getattr(t, "journal", None) if isinstance(t, Table) else None
            if j is None:
                continue
            nbytes, nsegs = j.disk_usage()
            tables[name] = {"bytes": nbytes, "segments": nsegs}
            total += nbytes
        return {"tables": tables, "total_bytes": total,
                "budget_mb": int(flags.get("PL_JOURNAL_MAX_MB"))}

    def _fold_self_metrics(self) -> None:
        """PL_SELF_METRICS_S cron body: the metrics registry plus the
        storage observatory (decayed shard heat + per-table storage state,
        table/heat.py) fold into the local store."""
        observe.write_rows(self.store, observe.METRICS_TABLE,
                           observe.sample_metrics_rows(self.name))
        _heat.fold_into(self.store, self.name, matviews=self.matviews)
        from pixie_tpu_torch.engine import autotune as _autotune

        if _autotune.enabled():
            # adaptive-gate events raised in THIS process (fallback trips,
            # fitted-threshold changes) land in the local store's slice of
            # the autotune table on the same cadence as the metrics fold
            rows = _autotune.MODEL.drain_rows()
            if rows:
                observe.write_rows(self.store, observe.AUTOTUNE_TABLE, rows)

    def stop(self):
        self._stop.set()
        if self._self_metrics is not None:
            self._self_metrics.stop()
            self._self_metrics = None
        self.matviews.stop_refresher()
        if self.healthz is not None:
            self.healthz.stop()
        if self.collector is not None:
            self.collector.stop()
        from pixie_tpu_torch.services import faultinject as _faultinject

        # only OUR handler: a restarted successor owns the label now
        _faultinject.unregister_kill_handler(f"agent:{self.name}",
                                             fn=self._pod_kill)
        if self._owns_journal:
            _journal.detach_store(self.store)
            self._owns_journal = False
        if self.conn is not None:
            self.conn.close()

    # ------------------------------------------------------------- durability
    def _rehydrate(self) -> None:
        """Restore durable state BEFORE registration, so the broker never
        dispatches to a store that is still catching up: journal replay
        into the local store (acked rows survive restart), and the matview
        snapshot dir arms so standing state resumes at O(delta).  A no-op
        with PL_DATA_DIR unset.  (The reference's peer fetch of replicated
        sealed batches comes with replication, item 6d part 2.)"""
        ndir = _journal.node_dir(self.name)
        if ndir is not None:
            self.rehydrate_stats["journal"] = _journal.attach_store(
                self.store, ndir)
            self._owns_journal = True
            self.matviews.set_snapshot_dir(os.path.join(ndir, "matview"))

    def _pod_kill(self) -> None:
        """True pod loss (faultinject `kill:` rule): drop every in-memory
        table — recovery must come from the journal and the replica peers,
        never from preserved process state."""
        self.pod_killed.set()
        self._stop.set()
        if self._owns_journal:
            _journal.detach_store(self.store)
            self._owns_journal = False
        for n in list(self.store.names()):
            self.store.drop(n)

    def _register(self):
        self.conn.send(wire.encode_json({
            "msg": "register",
            "agent": self.name,
            "schemas": {t: r.to_dict() for t, r in self.store.schemas().items()},
            "n_devices": self.n_devices,
            "repl_addr": None,
        }))

    def _hb_loop(self):
        while not self._stop.wait(timeout=self.heartbeat_s):
            if self.conn is None or self.conn.closed:
                return
            self.conn.send(wire.encode_json({"msg": "heartbeat", "agent": self.name}))

    # ------------------------------------------------------------------- frames
    def _on_frame(self, conn: Connection, frame: bytes):
        kind, payload = wire.decode_frame(frame)
        if kind != "json":
            return
        msg = payload.get("msg")
        if msg == "registered":
            self.asid = payload.get("asid")
            self._registered.set()
        elif msg == "chunk_ack":
            # broker consumed (folded) one of our chunk frames: open the
            # in-flight window by one.  MUST stay on the read loop — it's a
            # lone semaphore release, and a thread per ack would cost more
            # than the fold it acknowledges.  Keyed per (req_id, attempt,
            # source agent): a hedged duplicate dispatch runs concurrently
            # with its twin, and a failover replica may stream its OWN
            # fragment beside a takeover fragment of the same query —
            # neither must drain the other's window.
            key = (f"{payload.get('req_id', '')}"
                   f"#{int(payload.get('attempt') or 0)}"
                   f"#{payload.get('agent') or self.name}")
            with self._windows_lock:
                sem = self._windows.get(key)
            if sem is not None:
                sem.release()
        elif msg == "reregister":
            self._register()
        elif msg == "execute":
            threading.Thread(
                target=self._execute, args=(payload,), daemon=True,
                name=f"pixie-agent-exec-{self.name}",
            ).start()
        elif msg == "spans":
            # broker-shipped spans (the merger holds no scanned store):
            # append into the local spans table so one distributed scan
            # returns the full trace.  Off the read loop — a table write
            # must not queue execute/heartbeat frames behind telemetry.
            threading.Thread(
                target=self._write_shipped_spans,
                args=(payload.get("spans") or [],), daemon=True,
                name=f"pixie-agent-spans-{self.name}",
            ).start()
        elif msg == "telemetry_rows":
            # broker-shipped flight-recorder rows (query profiles, op
            # stats, sampled metrics, SLO alerts): same contract as spans
            threading.Thread(
                target=self._write_telemetry_rows,
                args=(payload.get("table"), payload.get("rows") or []),
                daemon=True,
                name=f"pixie-agent-telemetry-{self.name}",
            ).start()
        elif msg == "storage_report":
            # on-demand storage observatory read (broker heat_map RPC):
            # current decayed heat + storage state, NOT a fold — nothing is
            # written.  Off the read loop: the state walk takes table locks.
            threading.Thread(
                target=self._answer_storage_report,
                args=(payload.get("req_id"),), daemon=True,
                name=f"pixie-agent-storage-{self.name}",
            ).start()
        elif msg == "deploy_tracepoint":
            # dynamic tracepoints come with ROADMAP Queue 1 item 6e
            self.conn.send(wire.encode_json({
                "msg": "tracepoint_error", "req_id": payload.get("req_id"),
                "qtoken": payload.get("qtoken"), "agent": self.name,
                "error": "Unimplemented: tracepoint deployment is not ported "
                         "yet (ROADMAP Queue 1 item 6e)",
            }))

    def _answer_storage_report(self, req_id) -> None:
        """One storage_report RPC answer: this agent's decayed shard-heat
        snapshot + storage-state rows (table/heat.py), as JSON."""
        try:
            report = {
                "shard_heat": _heat.snapshot_rows(),
                "storage_state": _heat.storage_state_rows(
                    self.store, self.name, matviews=self.matviews),
            }
        except Exception as e:
            report = {"error": str(e)}
        self.conn.send(wire.encode_json({
            "msg": "storage_report", "req_id": req_id,
            "agent": self.name, **report}))

    def _execute(self, meta: dict):
        import contextlib

        req_id = meta.get("req_id", "")
        # echoed on every result frame; the broker drops frames whose token
        # doesn't match the live dispatch (per-dispatch result-stream auth,
        # reference carnotpb/carnot.proto:30-96).  `attempt` distinguishes
        # re-dispatches and hedged duplicates of the same query.
        qtoken = meta.get("qtoken")
        attempt = int(meta.get("attempt") or 0)
        # a failover takeover (`serve_for`, a dead primary's fragment served
        # from replicated sealed batches) comes with replication (ROADMAP
        # Queue 1 item 6d, part 2): such a dispatch fails with exec_error
        serve_for = meta.get("serve_for")
        src_name = str(serve_for) if serve_for else self.name
        # the window key carries the SOURCE name, as the broker's acks do
        wkey = f"{req_id}#{attempt}#{src_name}"
        # cross-process trace context: parent this agent's exec spans under
        # the broker's dispatch span for the same query
        tctx = meta.get("trace")
        cm = (trace.root(self.tracer, "exec", ctx=tctx, agent=self.name,
                         req_id=req_id)
              if tctx else contextlib.nullcontext())
        # a degraded broker narrows the in-flight chunk window per query
        # (serving-front backpressure: admitted queries throttle harder
        # instead of queueing frames at a merge that can't keep up)
        window = int(meta.get("stream_window")
                     or flags.get("PL_STREAM_WINDOW"))
        sem = threading.Semaphore(window) if window > 0 else None
        if sem is not None:
            with self._windows_lock:
                self._windows[wkey] = sem
        try:
            with cm, _kernels.launch_tally() as launches:
                plan = Plan.from_dict(meta["plan"])
                if serve_for:
                    raise Unimplemented(
                        f"takeover dispatch for {serve_for}: replication is "
                        "not ported yet (ROADMAP Queue 1 item 6d, part 2)")
                # Standing-view fast path: an eligible repeated plan answers
                # from incrementally refreshed partial-agg state (first sight
                # only registers and runs the normal path below).  analyze
                # runs bypass views — they exist to measure the real scan.
                served = None
                if not meta.get("analyze"):
                    served = self.matviews.serve(
                        plan, route_scale=int(meta.get("route_scale", 1)),
                        tenant=str(meta.get("tenant") or ""),
                        stale_ok=bool(meta.get("stale_ok")))
                if served is not None:
                    cid, pb, mv_info = served
                    ex = None
                    stream = _chunk_view_state(cid, pb, int(
                        flags.get("PL_STREAM_AGG_CHUNK_GROUPS")))
                else:
                    mv_info = None
                    ex = PlanExecutor(
                        plan, self.store, self.registry, device=self.device,
                        analyze=bool(meta.get("analyze", False)),
                        route_scale=int(meta.get("route_scale", 1)),
                    )
                    stream = ex.run_agent_stream(
                        agg_chunk_groups=int(
                            flags.get("PL_STREAM_AGG_CHUNK_GROUPS")))
                t0 = time.perf_counter()
                # Chunk stream: each wave/slice ships as its own frame the
                # moment the executor yields it, so the broker's incremental
                # fold (and the NEXT wave's D2H) overlap this agent's compute
                # instead of queueing behind a terminal result frame.
                counts: dict[str, int] = {}
                stalled = False
                for channel, payload in stream:
                    if not stalled:
                        stalled = not self._await_window(sem)
                    seq = counts.get(channel, 0)
                    counts[channel] = seq + 1
                    extra = {"msg": "chunk", "req_id": req_id,
                             "channel": channel, "seq": seq,
                             "agent": src_name, "qtoken": qtoken,
                             "attempt": attempt}
                    if isinstance(payload, PartialAggBatch):
                        frame = wire.encode_partial_agg(payload, extra)
                    elif isinstance(payload, HostBatch):
                        frame = wire.encode_host_batch(payload, extra)
                    else:
                        raise TypeError(f"unexpected payload {type(payload)}")
                    self.conn.send(frame)
                stats = dict(ex.stats) if ex is not None else {}
                if mv_info is not None:
                    stats["matview"] = mv_info
                stats["exec_s"] = time.perf_counter() - t0
                # where this fragment ran and the kernels it launched there
                # (this thread's launches: the views' folds included)
                stats["torch_device"] = str(self.device)
                stats["kernel_launches"] = dict(sorted(launches.items()))
            # spans persist BEFORE the ack: when exec_done lands at the
            # broker, this query's spans are already scannable
            self._flush_trace()
            from pixie_tpu_torch.services.broker import _jsonable

            self.conn.send(wire.encode_json({
                "msg": "exec_done", "req_id": req_id, "agent": src_name,
                "qtoken": qtoken, "attempt": attempt,
                "stats": _jsonable(stats),
                # per-channel chunk counts: the broker verifies its folds saw
                # every frame (a dropped chunk must fail loudly, not merge a
                # silently-partial answer)
                "chunks": counts,
            }))
        except Exception as e:
            self._flush_trace()
            self.conn.send(wire.encode_json({
                "msg": "exec_error", "req_id": req_id, "agent": src_name,
                "qtoken": qtoken, "attempt": attempt, "error": str(e),
            }))
        finally:
            if sem is not None:
                with self._windows_lock:
                    self._windows.pop(wkey, None)

    def _await_window(self, sem: Optional[threading.Semaphore]) -> bool:
        """Block until the in-flight chunk window opens; False on stall.
        After one stall the caller stops waiting for the rest of the query
        (degraded to unbounded, counted): TCP still backpressures a
        slow-but-alive broker, and a broker that stopped acking — typically
        because this query already died there — must not wedge this
        executor thread for stall-budget × remaining-chunks."""
        if sem is None:
            return True
        deadline = time.monotonic() + ACK_STALL_S
        while not self._stop.is_set():
            if sem.acquire(timeout=0.2):
                return True
            if self.conn is None or self.conn.closed:
                return False
            if time.monotonic() >= deadline:
                from pixie_tpu_torch import metrics as _metrics

                _metrics.counter_inc(
                    "px_agent_chunk_ack_stalls_total",
                    help_="chunk sends that proceeded without an ack "
                          "(broker stopped acking within the stall budget)")
                return False
        return False

    def _write_shipped_spans(self, rows: list) -> None:
        try:
            trace.write_spans(self.store, rows)
        except Exception:
            from pixie_tpu_torch import metrics as _metrics

            _metrics.counter_inc(
                "px_agent_span_write_errors_total",
                help_="spans that failed to persist to the local store")

    def _write_telemetry_rows(self, table, rows: list) -> None:
        try:
            if table in observe.SELF_TABLES:
                observe.write_rows(self.store, str(table), rows)
        except Exception:
            from pixie_tpu_torch import metrics as _metrics

            _metrics.counter_inc(
                "px_agent_telemetry_write_errors_total",
                help_="flight-recorder rows that failed to persist to the "
                      "local store")

    def _flush_trace(self) -> None:
        """Persist buffered spans; never let telemetry failure block the
        exec_done/exec_error ack (an unacked query stalls the broker for
        the full query timeout)."""
        try:
            self.tracer.flush(store=self.store)
        except Exception:
            from pixie_tpu_torch import metrics as _metrics

            _metrics.counter_inc(
                "px_agent_span_write_errors_total",
                help_="spans that failed to persist to the local store")


def main(argv=None):
    """`python -m pixie_tpu_torch.services.agent --name pem1 --broker host:port
    [--connector seq_gen] [--device cpu]` — standalone agent process (the
    pem_main analog).  It runs on the CUDA card unless `--device` names
    another device; with no card and no `--device` it exits with the
    error."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--name", required=True)
    ap.add_argument("--broker", required=True, help="host:port")
    ap.add_argument("--connector", action="append", default=[],
                    help="seq_gen | proc_stats | perf_profiler | "
                         "access_log:/path/to/log (repeatable)")
    ap.add_argument("--heartbeat-s", type=float, default=DEFAULT_HEARTBEAT_S)
    ap.add_argument("--auth-token", default=None,
                    help="shared secret; required if the broker enables auth")
    ap.add_argument("--healthz-port", type=int, default=None,
                    help="serve HTTP /healthz + /metrics on this port")
    ap.add_argument("--healthz-host", default="127.0.0.1",
                    help="bind address for the healthz listener (use the "
                         "pod IP / 0.0.0.0 for remote k8s probes)")
    ap.add_argument("--proc-scan-s", type=float, default=0.0,
                    help="scan /proc every N seconds, binding live PIDs to "
                         "UPIDs (+pods via cgroup) in the metadata state "
                         "(reference pids.cc); 0 disables")
    ap.add_argument("--device", default=None,
                    help="torch device the agent executes on (default: the "
                         "CUDA card; 'cpu' runs on the host)")
    ap.add_argument("--watch-feed", default=None,
                    help="JSONL file of ResourceUpdates to tail into the "
                         "metadata state (the k8s watch fanout analog)")
    args = ap.parse_args(argv)
    host, port = args.broker.rsplit(":", 1)

    from pixie_tpu_torch.collect.core import Collector

    collector = Collector()
    for cname in args.connector:
        if cname == "seq_gen":
            from pixie_tpu_torch.collect.seq_gen import SeqGenConnector

            collector.register(SeqGenConnector())
        elif cname == "proc_stats":
            from pixie_tpu_torch.collect.proc_stats import ProcessStatsConnector

            collector.register(ProcessStatsConnector())
        elif cname == "perf_profiler":
            from pixie_tpu_torch.collect.perf_profiler import PerfProfilerConnector

            collector.register(PerfProfilerConnector())
        elif cname.startswith("access_log:"):
            from pixie_tpu_torch.collect.access_log import AccessLogConnector

            collector.register(AccessLogConnector(cname.split(":", 1)[1]))
        elif cname.startswith("capture:"):
            # Replay a socket-event capture through the protocol parsers
            # (socket_tracer): capture:/path/to/capture.jsonl
            from pixie_tpu_torch.collect.tracer import (
                CaptureFileSource,
                SocketTraceConnector,
            )

            path = cname.split(":", 1)[1]
            collector.register(SocketTraceConnector(
                CaptureFileSource(path), name=f"socket_tracer:{path}"))
        elif cname.startswith("tap:"):
            # Live tap proxy: tap:<listen_port>:<upstream_host>:<upstream_port>
            # — proxies traffic and traces every connection through it.
            from pixie_tpu_torch.collect.tap import TapProxy
            from pixie_tpu_torch.collect.tracer import SocketTraceConnector

            lport, uhost, uport = cname.split(":", 1)[1].split(":")
            tap = TapProxy(uhost, int(uport), listen_port=int(lport),
                           pid=os.getpid()).start()
            collector.register(SocketTraceConnector(
                tap.source, name=f"socket_tracer:tap:{tap.port}"))
        else:
            raise SystemExit(f"unknown connector {cname!r}")
    md_jobs = []
    if args.proc_scan_s > 0 or args.watch_feed:
        from pixie_tpu_torch.metadata.state import global_manager

        mgr = global_manager()
        if args.proc_scan_s > 0:
            from pixie_tpu_torch.metadata.proc_scanner import ProcScanner

            md_jobs.append((args.proc_scan_s,
                            ProcScanner(asid=mgr.current().asid).scan_into,
                            mgr))
        if args.watch_feed:
            from pixie_tpu_torch.metadata.watch import ResourceUpdateFeed

            feed = ResourceUpdateFeed(mgr, args.watch_feed)
            md_jobs.append((1.0, lambda _m, feed=feed: feed.poll(), mgr))

    def _md_loop(period, fn, mgr):
        while True:
            try:
                fn(mgr)
            except Exception:
                pass  # metadata refresh must never kill the agent
            time.sleep(period)

    for period, fn, mgr in md_jobs:
        threading.Thread(target=_md_loop, args=(period, fn, mgr),
                         daemon=True).start()

    agent = Agent(args.name, host, int(port), collector=collector,
                  heartbeat_s=args.heartbeat_s, auth_token=args.auth_token,
                  healthz_port=args.healthz_port,
                  healthz_host=args.healthz_host, device=args.device)
    agent.start()
    try:
        while True:
            time.sleep(1.0)
            if agent.conn is None or agent.conn.closed:
                raise SystemExit("broker connection lost")
    except KeyboardInterrupt:
        pass
    finally:
        agent.stop()


if __name__ == "__main__":
    main()
