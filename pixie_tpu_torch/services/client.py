"""Python client for the broker's ExecuteScript API.

Reference: src/api/python/pxapi/client.py:100-262 (Conn/ScriptExecutor) — a
streaming client that connects, runs a script, and receives per-table row
batches + exec stats.

Fault tolerance: idempotent (non-mutation) scripts auto-retry with jittered
backoff (`PL_CLIENT_RETRIES`) when the broker sheds them (retry-after), marks
an infrastructure failure retryable (agent eviction past the broker's own
retry budget), or the broker connection itself drops — the client redials
with backoff instead of dying on the stale socket, so a broker restart is a
latency blip, not an error.  Mutation scripts (tracepoint deploys) are NEVER
auto-retried: a re-issued mutation is not idempotent.

Copied from the reference package (pixie_tpu/services/client.py), but for
`rehome` (shard re-homing, ROADMAP Queue 1 item 6d, part 2).
"""
from __future__ import annotations

import random
import threading
import time
from typing import Optional

from pixie_tpu_torch import flags
from pixie_tpu_torch.engine.result import QueryResult
from pixie_tpu_torch.services import wire
from pixie_tpu_torch.services.transport import Connection, dial
from pixie_tpu_torch.status import PxError, Unavailable
from pixie_tpu_torch.types import ColumnSchema, Relation

flags.define_int(
    "PL_CLIENT_RETRIES", 3,
    "client-side auto-retries for idempotent (non-mutation) scripts on "
    "shed (retry-after), retryable infrastructure errors, or a lost broker "
    "connection (redialed with backoff); 0 disables")

#: base/cap for the client's jittered exponential backoff (seconds)
RETRY_BACKOFF_BASE_S = 0.1
RETRY_BACKOFF_MAX_S = 5.0

#: tokens whose presence marks a script as a MUTATION — never auto-retried
#: (the broker's error envelope is authoritative when one arrives; this
#: lexical check covers the conn-lost path where no envelope exists)
_MUTATION_TOKENS = ("UpsertTracepoint", "DeleteTracepoint")


class QueryError(PxError):
    """Query failed at the broker.  `retry_after_s` is non-None when the
    failure was an admission-control shed (back off and retry); `retryable`
    marks an infrastructure failure of an idempotent query (agent eviction
    past the broker's retry budget, no live agents) that is safe to
    re-issue.  Both None/False means a real error (compile/exec) that
    retrying won't fix."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None,
                 retryable: bool = False):
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.retryable = retryable


def _is_mutation(script: str) -> bool:
    return any(tok in script for tok in _MUTATION_TOKENS)


class _Pending:
    def __init__(self):
        self.chunks: list = []
        self.stats: dict = {}
        self.schemas: Optional[dict] = None
        self.reply: Optional[dict] = None
        self.error: Optional[str] = None
        self.retry_after_s: Optional[float] = None
        self.retryable: bool = False
        self.done = threading.Event()


class Client:
    """Blocking client (the pxapi Conn analog).

    `tenant` identifies this client to the broker's admission controller
    (quotas, fair-share scheduling, per-tenant cache namespaces); it rides
    every execute_script frame and can be overridden per call.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 120.0,
                 auth_token: Optional[str] = None,
                 tenant: Optional[str] = None):
        self.timeout_s = timeout_s
        self.tenant = tenant
        self._addr = (host, port)
        self._auth_token = auth_token
        self._pending: dict[str, _Pending] = {}
        self._lock = threading.Lock()
        self._req = 0
        #: retries the LAST execute_script paid (the CLI surfaces
        #: "retried N×" from this instead of a stack trace)
        self.last_retries = 0
        self.conn: Connection = self._dial()

    def _dial(self) -> Connection:
        conn = dial(*self._addr, on_frame=self._on_frame,
                    on_close=self._on_close)
        conn.label = "client"  # fault-injection target (faultinject.py)
        if self._auth_token is not None:
            conn.send(wire.encode_json(
                {"msg": "auth", "token": self._auth_token}))
        return conn

    def _ensure_conn(self) -> None:
        """Redial a dead broker connection (one attempt; the retry loop
        provides the backoff).  A broker restart invalidates the old
        socket — dying on it would turn every restart into client errors."""
        if self.conn is not None and not self.conn.closed:
            return
        self.conn = self._dial()

    def close(self):
        self.conn.close()

    # ------------------------------------------------------------------ frames
    def _on_frame(self, conn: Connection, frame: bytes):
        kind, payload = wire.decode_frame(frame)
        meta = payload if kind == "json" else payload.wire_meta
        p = self._pending.get(meta.get("req_id", ""))
        if p is None:
            return
        msg = meta.get("msg")
        if kind == "host_batch" and msg == "result_chunk":
            p.chunks.append((meta["table"], payload))
        elif msg == "done":
            p.stats = meta.get("stats", {})
            p.done.set()
        elif msg == "schemas":
            p.schemas = meta["schemas"]
            p.done.set()
        elif msg in ("quota_ok", "quotas", "heat_map"):
            p.reply = meta
            p.done.set()
        elif msg == "error":
            p.error = meta.get("error", "unknown error")
            ra = meta.get("retry_after_s")
            p.retry_after_s = float(ra) if ra is not None else None
            p.retryable = bool(meta.get("retryable", False))
            p.done.set()

    def _on_close(self, conn: Connection):
        with self._lock:
            for p in self._pending.values():
                if not p.done.is_set():
                    p.error = "connection to broker lost"
                    p.retryable = True  # the redial path owns this
                    p.done.set()

    def _new_pending(self) -> tuple[str, _Pending]:
        with self._lock:
            self._req += 1
            rid = f"c{self._req}"
            p = _Pending()
            self._pending[rid] = p
            return rid, p

    # --------------------------------------------------------------------- api
    def execute_script(
        self, script: str, func=None, func_args=None, now=None,
        default_limit=None, analyze: bool = False, funcs=None,
        tenant: Optional[str] = None, explain: bool = False,
    ) -> dict[str, QueryResult]:
        """funcs=[(prefix, func_name, func_args)] runs a multi-widget
        request as ONE fused broker query; results key by fused sink name,
        with exec_stats['sink_map'] mapping widget → sinks.

        Idempotent scripts transparently retry/reconnect (see module doc);
        the retry count lands in every result's exec_stats["client_retries"]
        and in `self.last_retries`."""
        budget = int(flags.get("PL_CLIENT_RETRIES"))
        mutation = _is_mutation(script)
        rng = random.Random()
        attempt = 0
        self.last_retries = 0
        while True:
            try:
                out = self._execute_once(
                    script, func=func, func_args=func_args, now=now,
                    default_limit=default_limit, analyze=analyze,
                    funcs=funcs, tenant=tenant, explain=explain)
                self.last_retries = attempt
                if attempt:
                    from pixie_tpu_torch import metrics as _metrics

                    _metrics.counter_inc(
                        "px_client_retries_total", float(attempt),
                        help_="client-side query retries that led to a "
                              "successful answer")
                for r in out.values():
                    r.exec_stats["client_retries"] = attempt
                return out
            except QueryError as e:
                retriable = (e.retry_after_s is not None or e.retryable)
                if mutation or not retriable or attempt >= budget:
                    raise
                delay = (e.retry_after_s if e.retry_after_s is not None
                         else min(RETRY_BACKOFF_BASE_S * (2 ** attempt),
                                  RETRY_BACKOFF_MAX_S))
                time.sleep(delay * (0.5 + rng.random()))
            except Unavailable as e:
                # reconnect-and-retry ONLY when the request never reached a
                # live broker (stale socket / dial refused after a restart);
                # a response timeout is NOT auto-retried — the query may
                # still be executing and retries would double the load
                if (mutation or attempt >= budget
                        or not getattr(e, "reconnect", False)):
                    raise
                time.sleep(min(RETRY_BACKOFF_BASE_S * (2 ** attempt),
                               RETRY_BACKOFF_MAX_S) * (0.5 + rng.random()))
            attempt += 1
            # kept current even when the budget ends in a raise: the CLI
            # reports "query failed (retried Nx)" from this
            self.last_retries = attempt

    def _execute_once(
        self, script: str, func=None, func_args=None, now=None,
        default_limit=None, analyze: bool = False, funcs=None,
        tenant: Optional[str] = None, explain: bool = False,
    ) -> dict[str, QueryResult]:
        rid, p = self._new_pending()
        try:
            try:
                self._ensure_conn()
            except OSError as e:
                # broker still down (restart in progress): retryable
                ua = Unavailable(f"broker unreachable: {e}")
                ua.reconnect = True
                raise ua from e
            ok = self.conn.send(wire.encode_json({
                "msg": "execute_script", "req_id": rid, "script": script,
                "func": func, "func_args": func_args, "now": now,
                "default_limit": default_limit, "analyze": analyze,
                "explain": explain,
                "funcs": [list(f) for f in funcs] if funcs else None,
                "tenant": tenant if tenant is not None else self.tenant,
            }))
            if not ok:
                ua = Unavailable("broker connection closed")
                ua.reconnect = True
                raise ua
            if not p.done.wait(timeout=self.timeout_s):
                raise Unavailable(f"query timed out after {self.timeout_s}s")
            if p.error:
                raise QueryError(p.error, retry_after_s=p.retry_after_s,
                                 retryable=p.retryable)
            out: dict[str, QueryResult] = {}
            for table, hb in p.chunks:
                meta_rel = getattr(hb, "wire_meta", {}).get("relation")
                rel = (Relation.from_dict(meta_rel) if meta_rel else
                       Relation([ColumnSchema(n, hb.dtypes[n])
                                 for n in hb.cols]))
                out[table] = QueryResult(
                    name=table, relation=rel, columns=hb.cols,
                    dictionaries=hb.dicts, exec_stats=dict(p.stats),
                )
            return out
        finally:
            with self._lock:
                self._pending.pop(rid, None)

    # ------------------------------------------------------------ control plane
    def set_quota(self, tenant: str, qps=None, concurrency=None,
                  weight=None) -> dict:
        """Write one tenant's LIVE quota record (broker control plane):
        fields left None keep the PL_TENANT_* env-spec default for that
        field; qps/concurrency 0 = explicitly unlimited.  The broker
        validates (malformed specs raise QueryError), applies it to the
        scheduler in place, and persists it in its KV — the record
        survives broker restart.  Returns the tenant's effective quotas."""
        reply = self._control_rpc({
            "msg": "set_quota", "tenant": tenant, "qps": qps,
            "concurrency": concurrency, "weight": weight})
        return reply.get("effective") or {}

    def clear_quota(self, tenant: str) -> dict:
        """Drop a tenant's live quota record (back to env-spec defaults)."""
        reply = self._control_rpc({"msg": "set_quota", "tenant": tenant})
        return reply.get("effective") or {}

    def get_quotas(self) -> dict:
        """{tenants: {tenant: effective quota}, rate_model: snapshot} —
        the control plane's read side."""
        reply = self._control_rpc({"msg": "get_quotas"})
        return {"tenants": reply.get("quotas") or {},
                "rate_model": reply.get("rate_model") or {}}

    def heat_map(self) -> dict:
        """The cluster storage observatory ("df for the data plane"):
        {agents: {name: {shard_heat, storage_state}}, tables: {name:
        {shards, skew, rows_scanned, bytes}}} aggregated by the broker from
        live agents' storage_report RPCs."""
        reply = self._control_rpc({"msg": "heat_map"})
        return {"agents": reply.get("agents") or {},
                "tables": reply.get("tables") or {}}

    def _control_rpc(self, meta: dict) -> dict:
        rid, p = self._new_pending()
        try:
            self._ensure_conn()
            if not self.conn.send(wire.encode_json(dict(meta, req_id=rid))):
                raise Unavailable("broker connection closed")
            if not p.done.wait(timeout=self.timeout_s):
                raise Unavailable(
                    f"{meta.get('msg')} timed out after {self.timeout_s}s")
            if p.error:
                raise QueryError(p.error)
            return p.reply or {}
        finally:
            with self._lock:
                self._pending.pop(rid, None)

    def schemas(self) -> dict[str, Relation]:
        rid, p = self._new_pending()
        try:
            if not self.conn.send(
                wire.encode_json({"msg": "list_schemas", "req_id": rid})
            ):
                raise Unavailable("broker connection closed")
            if not p.done.wait(timeout=self.timeout_s):
                raise Unavailable("schema request timed out")
            if p.error:
                raise QueryError(p.error)
            return {t: Relation.from_dict(r) for t, r in (p.schemas or {}).items()}
        finally:
            with self._lock:
                self._pending.pop(rid, None)
