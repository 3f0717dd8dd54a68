"""Distributed self-tracing of the query path (spans, not logs).

The engine observes everything except itself: per-op exec stats exist, but
the broker → agents → kernels → readback → merge pipeline has no end-to-end
timeline.  This module closes that loop with the system's own machinery:

  * a lightweight span API (trace_id / span_id / parent_span_id, wall-clock
    ns bounds, attributes) with a thread-safe bounded buffer per `Tracer`;
  * contextvars-based propagation inside a process and an explicit wire
    context (`wire_context()` / `root(..., ctx=...)`) across the framed-TCP
    hop between broker and agents, so every agent's spans parent under the
    broker's per-agent dispatch span;
  * finished spans land in the table store as `self_telemetry.spans` —
    the same path user data takes — so PxL queries them like any table
    (the bundled `px/self_query_latency` script), and a span→HostBatch
    adapter feeds the existing engine/otel.py resourceSpans encoder so
    traces ship to any OTLP collector.

Tracing is on by default and disabled via PL_TRACING_ENABLED=0; the disabled
fast path is a single ContextVar read per instrumentation site (no span is
ever created because no root is ever opened), which the span-hygiene ratchet
test bounds at <5% of query wall time.

Reference analogs: opentelemetry-go's span/context split, and the reference
platform's own query profiling hooks (src/carnot/exec exec stats + the
plugin OTLP export path, exec/otel_export_sink_node.*).

Copied from the reference package (pixie_tpu/trace.py), host only.  The
port's standing views (matview/) open spans under an active root; the
executor and the cluster open none yet (they wait for observe.py, ROADMAP
Queue 1 item 6a).  The OTLP encoder (engine/otel.py, Queue 1 item 6e) is
not ported: `spans_to_otlp` and `Tracer(exporter=...)` raise Unimplemented,
and the reference's PL_TRACE_OTLP_URL comes with that item.
"""
from __future__ import annotations

import contextvars
import json
import secrets
import threading
import time
import weakref
from typing import Callable, Optional

from pixie_tpu_torch import flags, metrics
from pixie_tpu_torch.status import Unimplemented
from pixie_tpu_torch.types import DataType as DT, Relation, SemanticType as ST

#: master switch; the disabled path never opens a root, so every child-site
#: check is one ContextVar read
flags.define_bool("PL_TRACING_ENABLED", True,
                  "record spans for the query path into self_telemetry.spans")
flags.define_int("PL_TRACE_BUFFER_SPANS", 4096,
                 "max finished spans buffered per tracer before dropping")

#: the dogfood table: every service writes its finished spans here, in its
#: own table store, so the normal distributed scan path picks them up
SPANS_TABLE = "self_telemetry.spans"
SPANS_RELATION = Relation.of(
    ("time_", DT.TIME64NS, ST.ST_TIME_NS),
    ("trace_id", DT.STRING),
    ("span_id", DT.STRING),
    ("parent_span_id", DT.STRING),
    ("name", DT.STRING),
    ("service", DT.STRING),
    ("duration_ns", DT.INT64, ST.ST_DURATION_NS),
    ("attributes", DT.STRING),
)


def enabled() -> bool:
    return bool(flags.get("PL_TRACING_ENABLED"))


class Span:
    __slots__ = ("trace_id", "span_id", "parent_span_id", "name", "service",
                 "start_ns", "end_ns", "attributes")

    def __init__(self, trace_id: str, span_id: str, parent_span_id: str,
                 name: str, service: str, start_ns: int,
                 attributes: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_span_id = parent_span_id
        self.name = name
        self.service = service
        self.start_ns = start_ns
        self.end_ns = 0  # 0 = still open
        self.attributes = attributes if attributes is not None else {}

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns

    def to_row(self) -> dict:
        """JSON-safe row in the self_telemetry.spans schema (also the wire
        form the broker ships to an agent for table insertion)."""
        return {
            "time_": int(self.start_ns),
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
            "name": self.name,
            "service": self.service,
            "duration_ns": int(self.end_ns - self.start_ns),
            "attributes": (json.dumps(self.attributes, default=str)
                           if self.attributes else ""),
        }


#: live tracers for the span-buffer health gauges (weak: a stopped service's
#: tracer must not be pinned by the metrics registry)
_LIVE: "weakref.WeakSet[Tracer]" = weakref.WeakSet()
_GAUGE_LOCK = threading.Lock()


class Tracer:
    """Per-service span factory + bounded finished-span buffer.

    Thread-safe: query threads, completion handlers, and the flush path all
    touch it concurrently.  `started == finished` after a query is the
    hygiene invariant the ratchet test enforces.
    """

    def __init__(self, service: str, max_spans: Optional[int] = None,
                 exporter: Optional[Callable[[dict], None]] = None):
        if exporter is not None:
            raise Unimplemented(
                "exporting spans needs the OTLP encoder (engine/otel.py), which is "
                "not ported yet (ROADMAP Queue 1 item 6e)")
        self.service = service
        self.max_spans = int(max_spans if max_spans is not None
                             else flags.get("PL_TRACE_BUFFER_SPANS"))
        self._lock = threading.Lock()
        self._finished: list[Span] = []
        self.started = 0
        self.finished = 0
        self.dropped = 0
        _LIVE.add(self)

    # ------------------------------------------------------------- span api
    def start_span(self, name: str, trace_id: Optional[str] = None,
                   parent_span_id: str = "",
                   attributes: Optional[dict] = None,
                   start_ns: Optional[int] = None) -> Span:
        sp = Span(
            trace_id=trace_id or secrets.token_hex(16),
            span_id=secrets.token_hex(8),
            parent_span_id=parent_span_id,
            name=name,
            service=self.service,
            start_ns=start_ns if start_ns is not None else time.time_ns(),
            attributes=attributes,
        )
        with self._lock:
            self.started += 1
        return sp

    def finish(self, span: Span, end_ns: Optional[int] = None) -> None:
        span.end_ns = end_ns if end_ns is not None else time.time_ns()
        with self._lock:
            self.finished += 1
            if len(self._finished) >= self.max_spans:
                self.dropped += 1
            else:
                self._finished.append(span)

    def drain(self) -> list[Span]:
        with self._lock:
            out, self._finished = self._finished, []
        return out

    @property
    def open_spans(self) -> int:
        return self.started - self.finished

    @property
    def buffered(self) -> int:
        with self._lock:
            return len(self._finished)

    # ---------------------------------------------------------------- flush
    def flush(self, store=None, send: Optional[Callable[[list], None]] = None,
              ) -> list[dict]:
        """Drain finished spans; write them into `store`'s spans table and/or
        hand the row dicts to `send`.  Returns the drained rows (callers may
        forward them further)."""
        spans = self.drain()
        if not spans:
            return []
        rows = [s.to_row() for s in spans]
        if store is not None:
            write_spans(store, rows)
        if send is not None:
            send(rows)
        return rows


# ----------------------------------------------------------------- context

_CTX: "contextvars.ContextVar[Optional[tuple]]" = contextvars.ContextVar(
    "pixie_tpu_torch_trace_ctx", default=None)


def current() -> Optional[tuple]:
    """(tracer, span) of the active trace context, or None."""
    return _CTX.get()


def wire_context() -> Optional[dict]:
    """The propagation envelope carried in framed-TCP message metadata."""
    c = _CTX.get()
    if c is None:
        return None
    return {"trace_id": c[1].trace_id, "span_id": c[1].span_id}


def set_attr(**attributes) -> None:
    """Stamp attributes onto the CURRENT span (no-op without an active
    trace).  The broker uses it to mark the query root with its tenant and
    admission outcome — facts only known after the root span opened."""
    c = _CTX.get()
    if c is not None:
        c[1].attributes.update(attributes)


def start_child(name: str, **attributes) -> Optional[Span]:
    """Child span of the current context that is NOT made current — for
    spans finished on another thread (e.g. per-agent dispatch spans closed
    by the exec_done handler).  Finish with `tracer.finish(span)`."""
    c = _CTX.get()
    if c is None:
        return None
    tracer, parent = c
    return tracer.start_span(name, trace_id=parent.trace_id,
                             parent_span_id=parent.span_id,
                             attributes=attributes or None)


def event_span(name: str, start_unix_ns: int, duration_ns: int,
               **attributes) -> None:
    """Record an already-measured interval as a finished child span (the
    near-zero-cost adapter for existing exec stats / readback waves)."""
    c = _CTX.get()
    if c is None:
        return
    tracer, parent = c
    sp = tracer.start_span(name, trace_id=parent.trace_id,
                           parent_span_id=parent.span_id,
                           attributes=attributes or None,
                           start_ns=start_unix_ns)
    tracer.finish(sp, end_ns=start_unix_ns + max(0, int(duration_ns)))


class _SpanCm:
    """Context manager for a child span of the current context; a no-op
    (returns None) when no trace is active."""

    __slots__ = ("name", "attributes", "tracer", "span", "token")

    def __init__(self, name: str, attributes: Optional[dict]):
        self.name = name
        self.attributes = attributes

    def __enter__(self) -> Optional[Span]:
        c = _CTX.get()
        if c is None:
            self.span = None
            return None
        tracer, parent = c
        sp = tracer.start_span(self.name, trace_id=parent.trace_id,
                               parent_span_id=parent.span_id,
                               attributes=self.attributes)
        self.tracer = tracer
        self.span = sp
        self.token = _CTX.set((tracer, sp))
        return sp

    def __exit__(self, et, ev, tb):
        if self.span is not None:
            _CTX.reset(self.token)
            if et is not None:
                self.span.attributes["error"] = str(ev)[:200]
            self.tracer.finish(self.span)
        return False


def span(name: str, **attributes) -> _SpanCm:
    return _SpanCm(name, attributes or None)


class _RootCm:
    """Open a root span on `tracer` — a fresh trace, or a remote-parented one
    when `ctx` carries a wire context.  No-op when tracing is disabled or
    (for `only_if_idle`) a trace is already active on this thread."""

    __slots__ = ("tracer", "name", "ctx", "attributes", "span", "token",
                 "only_if_idle")

    def __init__(self, tracer: Tracer, name: str, ctx: Optional[dict],
                 attributes: Optional[dict], only_if_idle: bool):
        self.tracer = tracer
        self.name = name
        self.ctx = ctx
        self.attributes = attributes
        self.only_if_idle = only_if_idle

    def __enter__(self) -> Optional[Span]:
        self.span = None
        if not enabled():
            return None
        if self.only_if_idle and _CTX.get() is not None:
            return None
        trace_id = parent = None
        if self.ctx:
            trace_id = self.ctx.get("trace_id")
            parent = self.ctx.get("span_id")
        sp = self.tracer.start_span(self.name, trace_id=trace_id,
                                    parent_span_id=parent or "",
                                    attributes=self.attributes)
        self.span = sp
        self.token = _CTX.set((self.tracer, sp))
        return sp

    def __exit__(self, et, ev, tb):
        if self.span is not None:
            _CTX.reset(self.token)
            if et is not None:
                self.span.attributes["error"] = str(ev)[:200]
            self.tracer.finish(self.span)
        return False


def root(tracer: Tracer, name: str, ctx: Optional[dict] = None,
         **attributes) -> _RootCm:
    return _RootCm(tracer, name, ctx, attributes or None, only_if_idle=False)


def maybe_root(tracer: Tracer, name: str, **attributes) -> _RootCm:
    """Root span only when no trace is active — lets the in-process
    execute_script callers (cron, tests) get traces while the networked
    path's outer root stays the single trace root."""
    return _RootCm(tracer, name, None, attributes or None, only_if_idle=True)


def propagating_call(fn, *args, **kwargs):
    """Run fn under THIS thread's trace context — pass to thread pools whose
    workers must inherit the active span (contextvars don't cross threads)."""
    ctx = contextvars.copy_context()
    return lambda: ctx.run(fn, *args, **kwargs)


# ----------------------------------------------------------- table storage


def ensure_table(store):
    """Get-or-create the spans table in a TableStore (raced creations fold
    into the winner)."""
    if not store.has(SPANS_TABLE):
        try:
            store.create(SPANS_TABLE, SPANS_RELATION, batch_rows=1024)
        except Exception:
            pass  # lost a creation race; the table exists now
    return store.table(SPANS_TABLE)


def write_spans(store, rows: list[dict]) -> int:
    """Append span rows (Span.to_row dicts) into the store's spans table —
    the same write path user telemetry takes."""
    if not rows:
        return 0
    import numpy as np

    t = ensure_table(store)
    t.write({
        "time_": np.asarray([r["time_"] for r in rows], dtype=np.int64),
        "trace_id": [r["trace_id"] for r in rows],
        "span_id": [r["span_id"] for r in rows],
        "parent_span_id": [r["parent_span_id"] for r in rows],
        "name": [r["name"] for r in rows],
        "service": [r["service"] for r in rows],
        "duration_ns": np.asarray([r["duration_ns"] for r in rows],
                                  dtype=np.int64),
        "attributes": [r["attributes"] for r in rows],
    })
    return len(rows)


# -------------------------------------------------------------- OTLP export

#: engine/otel.py spans config for the span-row HostBatch below
OTLP_SPANS_CONFIG = {
    "resource": {"service.name": {"column": "service"},
                 "service.instance.id": {"column": "service"}},
    "spans": [{
        "name_column": "name",
        "start_time_column": "time_",
        "end_time_column": "end_time_",
        "trace_id_column": "trace_id",
        "span_id_column": "span_id",
        "parent_span_id_column": "parent_span_id",
        "attributes": [{"name": "attributes", "column": "attributes"}],
    }],
}


def spans_to_host_batch(rows: list[dict]):
    """Span rows → HostBatch in the spans schema (+ an end_time_ column),
    ready for engine.otel.batch_to_otlp / any sink that eats HostBatch."""
    import numpy as np

    from pixie_tpu_torch.engine.executor import HostBatch
    from pixie_tpu_torch.table.dictionary import Dictionary

    dtypes = {c.name: c.data_type for c in SPANS_RELATION}
    dtypes["end_time_"] = DT.TIME64NS
    dicts: dict = {}
    cols: dict = {}
    for name, dt in dtypes.items():
        if name == "end_time_":
            vals = [r["time_"] + r["duration_ns"] for r in rows]
        else:
            vals = [r[name] for r in rows]
        if dt == DT.STRING:
            d = Dictionary()
            cols[name] = d.encode(vals)
            dicts[name] = d
        else:
            cols[name] = np.asarray(vals, dtype=np.int64)
    return HostBatch(dtypes, dicts, cols)


def spans_to_otlp(rows: list[dict]) -> dict:
    """Span rows → OTLP/JSON resourceSpans via engine/otel.py's encoder,
    which the port does not have yet."""
    if not rows:
        return {}
    raise Unimplemented("OTLP span export needs engine/otel.py, which is not ported yet "
                        "(ROADMAP Queue 1 item 6e)")


# ------------------------------------------------------------ health gauges


def register_gauges() -> None:
    """Span-buffer health as lazy gauges (idempotent; called by broker and
    agent start).  A leaking or overflowing trace buffer is itself
    observable on /metrics.  Keyed off the metrics registry itself, so a
    metrics.reset_for_testing() followed by another service start
    re-registers instead of silently losing the gauges."""
    with _GAUGE_LOCK:
        if metrics.has_gauge_fn("px_trace_spans_started"):
            return

    def by_service(attr):
        def read():
            out: dict = {}
            for t in list(_LIVE):
                k = (("service", t.service),)
                out[k] = out.get(k, 0.0) + float(getattr(t, attr))
            return out
        return read

    metrics.register_gauge_fn("px_trace_spans_started", by_service("started"),
                              "spans started per tracer service")
    metrics.register_gauge_fn("px_trace_spans_finished",
                              by_service("finished"),
                              "spans finished per tracer service")
    metrics.register_gauge_fn("px_trace_spans_dropped", by_service("dropped"),
                              "finished spans dropped by full buffers")
    metrics.register_gauge_fn("px_trace_buffer_spans", by_service("buffered"),
                              "finished spans currently buffered (occupancy)")
