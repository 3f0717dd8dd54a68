"""ServingFront: the broker's admission gate + deficit-round-robin scheduler.

Every ExecuteScript passes through `admit()` before any compile or dispatch
work happens and through `release()` when it finishes.  Three outcomes:

  * ADMIT — capacity is free (global in-flight below `PL_SERVING_MAX_INFLIGHT`
    and the tenant below its own cap with nothing of its queued ahead): the
    query proceeds immediately.
  * QUEUE — capacity is busy: the query waits in its tenant's bounded FIFO
    queue.  `release()` dispatches queued queries with deficit round robin
    (Shreedhar & Varghese): each tenant accrues `quantum × weight` deficit
    per scheduling round and dispatches when its head-of-line query's
    estimated cost is covered, so a tenant flooding expensive cold compiles
    drains slower than an interactive tenant issuing cheap warm queries —
    by exactly the cost ratio — instead of starving it.
  * SHED — the token bucket is dry (per-tenant QPS), the tenant queue is
    full, the wait timed out, or the broker is past its degradation
    watermark and the query is cold: `ShedError` carries a retry-after
    hint back to the client.

Degradation is a separate, observable state: total queue depth at or past
`PL_SERVING_SHED_WATERMARK` flips `ready()` (the broker's /readyz check)
while liveness stays green, sheds cold queries at the door, and marks
dispatched queries `degraded` so the broker serves matview hits stale and
narrows the chunk ack window (backpressure through the existing streaming
protocol instead of unbounded frame queues).

Copied from the reference package (pixie_tpu/serving/scheduler.py), but
for its replication catch-up state (`set_catchup`, `catching_up`), which
comes with replication (ROADMAP Queue 1 item 6d, part 2).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from pixie_tpu_torch import flags, metrics
from pixie_tpu_torch.serving.admission import (
    COST_COLD,
    ShedError,
    TokenBucket,
    spec_value,
)

#: deficit added per eligible tenant per scheduling round (cost units);
#: weights multiply it, so a weight-2 tenant affords a COST_COLD query in
#: half the rounds a weight-1 tenant does
QUANTUM = 1.0

#: pxlint lock-discipline: every *_locked member of ServingFront is owned
#: by the front's one mutex (checked by pixie_tpu_torch.check.pxlint)
_pxlint_locks_ = {
    "_retry_hint_locked": "self._lock",
    "_effective_quota_locked": "self._lock",
    "_shed_locked": "self._lock",
    "_run_locked": "self._lock",
    "_eligible_locked": "self._lock",
    "_dispatch_locked": "self._lock",
}


def enabled() -> bool:
    return bool(flags.get("PL_SERVING_ENABLED"))


class Ticket:
    """One admitted-or-queued query's pass through the front."""

    __slots__ = ("tenant", "cost", "outcome", "event", "enqueue_ns",
                 "wait_ns", "accounted", "degraded", "queued", "retry_after",
                 "reason")

    def __init__(self, tenant: str, cost: float):
        self.tenant = tenant
        self.cost = cost
        self.outcome: Optional[str] = None  # run | shed (None = waiting)
        self.event = threading.Event()
        self.enqueue_ns = time.time_ns()
        self.wait_ns = 0
        self.accounted = False  # counted into inflight totals
        self.degraded = False
        self.queued = False
        self.retry_after = 1.0
        self.reason = ""


class _TenantState:
    __slots__ = ("name", "bucket", "max_conc", "weight", "inflight",
                 "deficit", "queue")

    def __init__(self, name: str, override: Optional[dict] = None):
        self.name = name
        self.inflight = 0
        self.deficit = 0.0
        self.queue: deque[Ticket] = deque()
        self.configure(override)

    def configure(self, override: Optional[dict] = None) -> None:
        """(Re-)resolve this tenant's quotas: a LIVE override record (the
        control-plane `set_quota` path, persisted in the broker KV) wins
        field-by-field over the PL_TENANT_* env specs, which are demoted
        to defaults.  Called in place on a quota update — inflight
        accounting, DRR deficit and the queue are untouched, so the new
        share applies from the very next scheduling round.  A changed QPS
        mints a fresh token bucket (burst resets — an updated rate limit
        starts from its own burst budget, not the old bucket's debt)."""
        ov = override or {}
        name = self.name
        rate = ov.get("qps")
        if rate is None:
            rate = spec_value(flags.get("PL_TENANT_QPS"), name, float)
        self.bucket = TokenBucket(rate) if rate else None
        conc = ov.get("concurrency")
        if conc is None:
            conc = spec_value(flags.get("PL_TENANT_CONCURRENCY"), name, int)
        self.max_conc = int(conc) if conc else 0  # 0 = unlimited
        # clamped: the dispatch loop's round budget is O(cost/min_weight)
        # UNDER THE FRONT'S LOCK, so a configured weight of 1e-6 must not
        # turn one dispatch into minutes of lock-held sweeping — 0.01 still
        # deprioritizes a tenant 100:1 against the default
        w = ov.get("weight")
        if w is None:
            w = spec_value(flags.get("PL_TENANT_WEIGHTS"), name, float) or 1.0
        self.weight = min(max(float(w), 0.01), 100.0)


class ServingFront:
    """Admission + fair-share scheduling state for one broker."""

    def __init__(self, service: str = "broker"):
        self.service = service
        self._lock = threading.Lock()
        self._tenants: dict[str, _TenantState] = {}
        #: live per-tenant quota overrides (the control plane's `set_quota`
        #: records, persisted by the broker in its KV): resolved ahead of
        #: the PL_TENANT_* env specs field-by-field
        self._quota_overrides: dict[str, dict] = {}
        #: measured service-rate model (serving/ratemodel.py), set by the
        #: broker; None keeps every retry hint on the static heuristic
        self.rate_model = None
        self._rr: list[str] = []  # stable DRR visit order
        self._rr_idx = 0
        self.inflight = 0
        self.total_queued = 0
        #: high-watermark latching for observability: peak queue depth and
        #: peak inflight since start (the load harness asserts boundedness)
        self.peak_queued = 0
        self.peak_inflight = 0
        self._gauges = False

    #: idle tenant states above this count are pruned (a flood of distinct
    #: tenant ids must not grow scheduler memory without bound; a pruned
    #: tenant's next query simply re-reads its quota spec — the only state
    #: lost is unused token-bucket burst and DRR deficit, both ≈ empty
    #: when idle)
    MAX_IDLE_TENANTS = 1024

    #: distinct tenant ids that get their OWN metric label series; ids past
    #: the cap share the "__other__" label — counter series in the metrics
    #: registry are immortal, so an id flood must not grow them per tenant
    #: the way the (pruned) scheduler states don't.  The cap now lives in
    #: metrics.capped_label, shared with the broker's per-agent series.
    MAX_LABELED_TENANTS = metrics.MAX_LABEL_IDS

    def _label(self, tenant: str) -> str:
        return metrics.capped_label("tenant", tenant,
                                    cap=self.MAX_LABELED_TENANTS)

    # ------------------------------------------------------------------ state
    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            if len(self._tenants) >= self.MAX_IDLE_TENANTS:
                idle = [n for n, s in self._tenants.items()
                        if not s.queue and s.inflight == 0]
                for n in idle[:max(1, len(idle) // 2)]:
                    self._tenants.pop(n, None)
                self._rr = [n for n in self._rr if n in self._tenants]
                self._rr_idx = 0
            st = self._tenants[tenant] = _TenantState(
                tenant, self._quota_overrides.get(tenant))
            self._rr.append(tenant)
        return st

    #: live quota records arrive on the wire (set_quota frames), so their
    #: count is bounded like every other wire-supplied id space — past the
    #: cap new tenants are rejected with a clean error (clears always work)
    MAX_QUOTA_RECORDS = 4096

    # ------------------------------------------------------------ live quotas
    def set_quota(self, tenant: str, record: Optional[dict]) -> dict:
        """Apply one live quota record (already normalized by
        admission.normalize_quota; None or an all-None record clears the
        override back to the env-spec defaults).  An existing tenant state
        reconfigures IN PLACE — queue, inflight accounting and DRR deficit
        survive, so the new share takes effect within one scheduling
        round — and the dispatch loop runs immediately (a raised
        concurrency cap or weight may unblock queued work right now).
        Returns the tenant's effective quotas after the update."""
        if record is not None and all(v is None for v in record.values()):
            record = None
        with self._lock:
            if record is None:
                self._quota_overrides.pop(tenant, None)
            else:
                if (tenant not in self._quota_overrides
                        and len(self._quota_overrides)
                        >= self.MAX_QUOTA_RECORDS):
                    from pixie_tpu_torch.status import Unavailable

                    raise Unavailable(
                        f"live quota records capped at "
                        f"{self.MAX_QUOTA_RECORDS}; clear unused tenants "
                        "first")
                self._quota_overrides[tenant] = dict(record)
            st = self._tenants.get(tenant)
            if st is not None:
                st.configure(self._quota_overrides.get(tenant))
                self._dispatch_locked()
            eff = self._effective_quota_locked(tenant, st)
        metrics.counter_inc(
            "px_serving_quota_updates_total",
            labels={"tenant": self._label(tenant)},
            help_="live tenant quota records applied via the control plane")
        return eff

    def _effective_quota_locked(self, tenant: str,
                                st: Optional[_TenantState]) -> dict:
        ov = self._quota_overrides.get(tenant, {})
        if st is not None:
            rate = st.bucket.rate if st.bucket is not None else 0
            conc, weight = st.max_conc, st.weight
        else:
            probe = _TenantState(tenant, ov or None)
            rate = probe.bucket.rate if probe.bucket is not None else 0
            conc, weight = probe.max_conc, probe.weight
        return {"qps": rate, "concurrency": conc, "weight": weight,
                "live": bool(ov)}

    def quotas(self) -> dict[str, dict]:
        """Effective quotas per tenant (every override plus every active
        tenant state) — the `get_quotas` control-plane read."""
        with self._lock:
            names = sorted(set(self._quota_overrides) | set(self._tenants))
            return {n: self._effective_quota_locked(n, self._tenants.get(n))
                    for n in names}

    def quota_overrides(self) -> dict[str, dict]:
        """The raw live override records (what the broker persists)."""
        with self._lock:
            return {t: dict(r) for t, r in self._quota_overrides.items()}

    def enabled(self) -> bool:
        return enabled()

    def degraded(self) -> bool:
        wm = int(flags.get("PL_SERVING_SHED_WATERMARK"))
        return wm > 0 and self.total_queued >= wm

    def ready(self) -> bool:
        """Readiness: past the shed watermark the broker is alive but must
        not receive new traffic (the /readyz check; /healthz stays green)."""
        return not self.degraded()

    def reset_for_testing(self) -> None:
        with self._lock:
            self._tenants.clear()
            self._quota_overrides.clear()
            self._rr.clear()
            self._rr_idx = 0
            self.inflight = self.total_queued = 0
            self.peak_queued = self.peak_inflight = 0

    # ------------------------------------------------------------------ admit
    def admit(self, tenant: str, cost: float,
              timeout_s: Optional[float] = None) -> Ticket:
        """Gate one query.  Returns a Ticket (queued tickets block until
        dispatched) or raises ShedError with a retry-after hint."""
        t = Ticket(tenant, float(cost))
        if not enabled():
            return t  # pass-through: no accounting, release() is a no-op
        cap = int(flags.get("PL_SERVING_MAX_INFLIGHT"))
        depth = int(flags.get("PL_SERVING_QUEUE_DEPTH"))
        with self._lock:
            st = self._state(tenant)
            if st.bucket is not None:
                ra = st.bucket.try_take()
                if ra > 0:
                    self._shed_locked(t, "qps", ra)
            if self.degraded() and cost >= COST_COLD:
                self._shed_locked(t, "overload", self._retry_hint_locked(cap))
            if (self.inflight < cap and not st.queue
                    and (st.max_conc <= 0 or st.inflight < st.max_conc)):
                self._run_locked(t, st)
                return t
            if len(st.queue) >= max(1, depth):
                self._shed_locked(t, "queue_full",
                                  self._retry_hint_locked(cap))
            st.queue.append(t)
            t.queued = True
            self.total_queued += 1
            self.peak_queued = max(self.peak_queued, self.total_queued)
            metrics.counter_inc(
                "px_serving_queued_total",
                labels={"tenant": self._label(tenant)},
                help_="queries that waited in the admission queue")
            # capacity may be free with only tenant-cap-blocked queues (or a
            # flag may have changed): give the new arrival a dispatch chance
            self._dispatch_locked()
        if timeout_s is None:
            timeout_s = float(flags.get("PL_SERVING_QUEUE_TIMEOUT_S"))
        if not t.event.wait(timeout=timeout_s):
            with self._lock:
                if t.outcome is None:  # still queued: pull it out and shed
                    try:
                        st.queue.remove(t)
                        self.total_queued -= 1
                    except ValueError:
                        pass  # a dispatch raced the timeout; honor it below
                    else:
                        # shed under the SAME lock hold that dequeued: the
                        # retry hint reads total_queued, and deciding
                        # outside the lock let a racing dispatch's "run"
                        # outcome be overwritten with "shed" (leaking its
                        # inflight slot)
                        self._shed_locked(t, "timeout",
                                          self._retry_hint_locked(cap),
                                          raise_=False)
            t.event.wait()  # raced dispatch: the outcome is set by now
        t.wait_ns = time.time_ns() - t.enqueue_ns
        if t.outcome == "shed":
            raise ShedError(
                f"tenant {tenant!r} shed ({t.reason}); "
                f"retry after {t.retry_after:.2f}s",
                retry_after_s=t.retry_after, reason=t.reason)
        return t

    def release(self, ticket: Optional[Ticket], ok: bool = True) -> None:
        """Return a query's capacity and dispatch queued work."""
        if ticket is None or not ticket.accounted:
            return
        ticket.accounted = False
        with self._lock:
            st = self._tenants.get(ticket.tenant)
            self.inflight -= 1
            if st is not None:
                st.inflight -= 1
            if ok:
                metrics.counter_inc(
                    "px_serving_tenant_goodput_queries_total",
                    labels={"tenant": self._label(ticket.tenant)},
                    help_="successfully completed queries per tenant")
            self._dispatch_locked()

    def rebate(self, ticket: Optional[Ticket], new_cost: float) -> None:
        """Re-price an admitted query DOWN to `new_cost` (its amortized
        share of a fused batch dispatch — serving/batching.py).  A queued
        member paid its full estimated cost out of its tenant's DRR
        deficit at dispatch; refunding the difference keeps fair-share
        drain rates honest: a batch of k warm queries consumed ~one
        dispatch of broker work, not k.  The refund is capped at the same
        deficit bound `_dispatch_locked` tops up against (no banking past
        the anti-burst cap)."""
        if ticket is None or not ticket.accounted or not enabled():
            return
        new_cost = max(float(new_cost), 0.0)
        refund = ticket.cost - new_cost
        if refund <= 0:
            return
        with self._lock:
            ticket.cost = new_cost
            st = self._tenants.get(ticket.tenant)
            if st is not None and ticket.queued:
                st.deficit = min(
                    st.deficit + refund,
                    max(2.0 * COST_COLD * st.weight, COST_COLD))
        metrics.counter_inc(
            "px_serving_batch_rebates_total",
            labels={"tenant": self._label(ticket.tenant)},
            help_="admitted queries re-priced to their amortized batch "
                  "share (DRR deficit refunded for queued members)")

    # --------------------------------------------------------------- internals
    def _retry_hint_locked(self, cap: int) -> float:
        # measured drain time when the rate model is warm (queued work over
        # the measured completion rate, serving/ratemodel.py); the crude
        # queued-over-capacity estimate floored at 0.5s only while cold
        if self.rate_model is not None:
            ra = self.rate_model.retry_after_s(self.total_queued, cap)
            if ra is not None:
                return ra
        return min(30.0, 0.5 + self.total_queued / max(1, cap))

    def _shed_locked(self, t: Ticket, reason: str, retry_after: float,
                     raise_: bool = True):
        t.outcome = "shed"
        t.reason = reason
        t.retry_after = round(max(retry_after, 0.05), 3)
        t.event.set()
        metrics.counter_inc(
            "px_serving_shed_total",
            labels={"tenant": self._label(t.tenant), "reason": reason},
            help_="queries rejected by admission control")
        metrics.counter_inc(
            "px_serving_retry_after_total",
            help_="shed responses that carried a retry-after hint")
        if raise_:
            raise ShedError(
                f"tenant {t.tenant!r} shed ({reason}); "
                f"retry after {t.retry_after:.2f}s",
                retry_after_s=t.retry_after, reason=reason)

    def _run_locked(self, t: Ticket, st: _TenantState) -> None:
        t.outcome = "run"
        t.accounted = True
        t.degraded = self.degraded()
        st.inflight += 1
        self.inflight += 1
        self.peak_inflight = max(self.peak_inflight, self.inflight)
        t.event.set()
        metrics.counter_inc(
            "px_serving_admitted_total",
            labels={"tenant": self._label(t.tenant)},
            help_="queries admitted to execute")

    def _eligible_locked(self, st: _TenantState) -> bool:
        return bool(st.queue) and (st.max_conc <= 0
                                   or st.inflight < st.max_conc)

    def _dispatch_locked(self) -> None:
        """Deficit round robin over tenant queues (lock held)."""
        cap = int(flags.get("PL_SERVING_MAX_INFLIGHT"))
        while self.inflight < cap:
            eligible = [self._tenants[n] for n in self._rr
                        if self._eligible_locked(self._tenants[n])]
            if not eligible:
                break
            dispatched = False
            # bounded top-up: each round adds QUANTUM × weight to every
            # eligible tenant; the round budget and the deficit cap both
            # scale with the SMALLEST eligible weight, so a fractional-
            # weight tenant's cold query is merely slow to afford, never
            # permanently unaffordable (a cap below COST_COLD would starve
            # it forever — it would shed on timeout with a free broker)
            min_w = min(st.weight for st in eligible)
            rounds = int(COST_COLD / max(QUANTUM * min_w, 1e-6)) + 2
            for _round in range(rounds):
                n = len(self._rr)
                for k in range(n):
                    st = self._tenants[self._rr[(self._rr_idx + k) % n]]
                    if (self._eligible_locked(st)
                            and st.deficit >= st.queue[0].cost):
                        t = st.queue.popleft()
                        st.deficit -= t.cost
                        if not st.queue:
                            # classic DRR: an emptied queue forfeits its
                            # unused deficit (no banking while idle)
                            st.deficit = 0.0
                        self.total_queued -= 1
                        self._rr_idx = (self._rr_idx + k + 1) % n
                        self._run_locked(t, st)
                        dispatched = True
                        break
                if dispatched:
                    break
                for st in eligible:
                    st.deficit = min(
                        st.deficit + QUANTUM * st.weight,
                        max(2.0 * COST_COLD * st.weight, COST_COLD))
            if not dispatched:  # pragma: no cover — top-up bound guarantees
                break

    # ------------------------------------------------------------ observability
    def queue_depths(self) -> dict[str, int]:
        with self._lock:
            return {n: len(st.queue) for n, st in self._tenants.items()}

    def stats(self) -> dict:
        with self._lock:
            return {
                "inflight": self.inflight,
                "queued": self.total_queued,
                "peak_inflight": self.peak_inflight,
                "peak_queued": self.peak_queued,
                "degraded": self.degraded(),
                "tenants": {
                    n: {"inflight": st.inflight, "queued": len(st.queue),
                        "deficit": round(st.deficit, 3),
                        "weight": st.weight}
                    for n, st in self._tenants.items()
                },
            }

    def attach_gauges(self) -> None:
        if self._gauges:
            return
        self._gauges = True
        metrics.register_gauge_fn(
            "px_serving_queue_depth",
            lambda: {(("tenant", n),): float(v)
                     for n, v in self.queue_depths().items()} or {(): 0.0},
            "admission queue depth per tenant")
        metrics.register_gauge_fn(
            "px_serving_inflight",
            lambda: {(): float(self.inflight)},
            "queries currently executing past admission")

    def detach_gauges(self) -> None:
        if not self._gauges:
            return
        self._gauges = False
        metrics.unregister_gauge_fn("px_serving_queue_depth")
        metrics.unregister_gauge_fn("px_serving_inflight")
