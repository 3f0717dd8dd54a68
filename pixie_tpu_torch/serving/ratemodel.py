"""ServiceRateModel: measured per-(tenant, plan-class) service rates.

The serving front's static form runs on two hard-coded numbers — the warm=1/cold=4
DRR cost ratio and a `queued / max_inflight` drain guess behind every
retry-after hint — and the broker's straggler model measures only per-AGENT
dispatch times.  This module generalizes that EWMA infrastructure into the
control-plane model the elasticity loop (serving/elastic.py) closes
against, fed from the same per-query completion stream the flight
recorder profiles:

  * **Plan classes.**  ``warm`` — the plan cache already holds the
    compiled split, so the query is dispatch+merge only (the serving
    front's *interactive* population); ``cold`` — full
    trace/optimize/split compile on top (the *batch* population: in this
    engine the warm/cold axis IS the interactive/batch axis, because the
    DRR scheduler already prices exactly that distinction); ``mutation``
    — tracepoint deploys, tracked separately so deploy round-trips skew
    neither.
  * **Per-key state** (tenant ids ride a capped label family, like every
    other wire-supplied id space): service-time EWMA + mean-absolute
    deviation (p99 estimate = ewma + 4·dev, the hedge estimator), a
    bounded ring of recent samples for honest p50/p99 readbacks, and
    1-second arrival bins for windowed arrival rates.
  * **Derived signals.**  ``cost_of(warm)`` — the measured cold/warm
    service-time ratio replacing the static ``COST_WARM``/``COST_COLD``
    estimates once both classes have enough samples;
    ``retry_after_s(queued, cap)`` — honest drain time: queued work over
    the measured completion rate ``cap / mean service time``;
    ``offered_load(cap)`` — Little's-law offered concurrency (arrival
    rate × mean service time) over capacity, the autoscaler's demand
    signal.

Every signal degrades to ``None`` (callers keep their legacy heuristics)
until ``MIN_SAMPLES`` observations arrive — a cold model must never steer
admission off one noisy sample.  ``PL_RATE_MODEL=0`` disables every read
path; observation becomes a no-op.

Copied from the reference package (pixie_tpu/serving/ratemodel.py).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from pixie_tpu_torch import flags, metrics
from pixie_tpu_torch.serving.admission import COST_COLD, COST_WARM

flags.define_bool(
    "PL_RATE_MODEL", True,
    "measured service-rate model (serving/ratemodel.py): replaces the "
    "static warm/cold DRR cost estimates and the heuristic shed "
    "retry-after with rates measured from the completion stream; 0 "
    "restores the static constants everywhere")

#: plan classes the model tracks (warm ≡ interactive, cold ≡ batch —
#: the axis the DRR scheduler already prices; mutations are kept apart)
CLASS_WARM = "warm"
CLASS_COLD = "cold"
CLASS_MUTATION = "mutation"

#: observations a (tenant, class) key needs before its measured signals
#: arm — below this every read path returns None and callers fall back
MIN_SAMPLES = 8

#: recent service-time samples kept per key for p50/p99 readback
RING = 128

#: arrival-rate window (seconds of 1-second bins kept per key)
ARRIVAL_WINDOW_S = 60

#: measured DRR cost ratio clamp: a pathological compile (or a 0ms warm
#: p50) must not mint an unpayable cost or invert the warm/cold order
COST_MIN, COST_MAX = 1.0, 32.0

#: retry-after clamp (the static heuristic's bounds)
RETRY_MIN_S, RETRY_MAX_S = 0.05, 30.0

#: EWMA smoothing factor for service times (matches the broker's per-agent model)
ALPHA = 0.2

#: pxlint lock-discipline: every *_locked member of ServiceRateModel is
#: owned by the model's one mutex
_pxlint_locks_ = {
    "_key_locked": "self._lock",
    "_mean_service_locked": "self._lock",
}


def enabled() -> bool:
    return bool(flags.get("PL_RATE_MODEL"))


def plan_class(warm: bool, mutation: bool = False) -> str:
    """The class a query observes under: its admission cost signal."""
    if mutation:
        return CLASS_MUTATION
    return CLASS_WARM if warm else CLASS_COLD


class _KeyState:
    """One (tenant, class) stream: service-time model + arrival bins."""

    __slots__ = ("n", "ewma", "dev", "ring", "bins")

    def __init__(self):
        self.n = 0
        self.ewma = 0.0
        self.dev = 0.0
        #: recent service seconds (bounded ring; p50/p99 readback)
        self.ring: deque = deque(maxlen=RING)
        #: (sec, arrivals) 1-second bins, ascending, bounded by the window
        self.bins: deque = deque()

    def observe(self, service_s: float) -> None:
        if self.n == 0:
            self.ewma = service_s
            self.dev = service_s / 2
        else:
            self.ewma += ALPHA * (service_s - self.ewma)
            self.dev += ALPHA * (abs(service_s - self.ewma) - self.dev)
        self.n += 1
        self.ring.append(service_s)

    def arrive(self, sec: int) -> None:
        if self.bins and self.bins[-1][0] == sec:
            self.bins[-1][1] += 1
        else:
            self.bins.append([sec, 1])
        while self.bins and self.bins[0][0] < sec - ARRIVAL_WINDOW_S:
            self.bins.popleft()

    def arrival_qps(self, now_sec: int, window_s: int) -> float:
        since = now_sec - window_s
        n = sum(c for s, c in self.bins if s >= since)
        return n / max(window_s, 1)

    def quantile(self, q: float) -> Optional[float]:
        if not self.ring:
            return None
        xs = sorted(self.ring)
        return xs[min(len(xs) - 1, int(q * len(xs)))]


class ServiceRateModel:
    """Thread-safe measured service-rate model for one serving front."""

    def __init__(self):
        self._lock = threading.Lock()
        self._keys: dict[tuple[str, str], _KeyState] = {}
        self._gauges = False

    def _label(self, tenant: str) -> str:
        # tenant ids arrive on the wire: the model's key space must stay
        # bounded the same way the metric label space does
        return metrics.capped_label("rate_tenant", str(tenant or ""))

    def _key_locked(self, tenant: str, cls: str) -> _KeyState:
        k = (tenant, cls)
        st = self._keys.get(k)
        if st is None:
            st = self._keys[k] = _KeyState()
        return st

    # ------------------------------------------------------------- observe
    def observe_arrival(self, tenant: str, cls: str,
                        now: Optional[float] = None) -> None:
        """One query arrived (admitted, queued, or shed — demand is demand)."""
        sec = int(time.time() if now is None else now)
        tenant = self._label(tenant)
        with self._lock:
            self._key_locked(tenant, cls).arrive(sec)

    def observe(self, tenant: str, cls: str, service_s: float,
                ok: bool = True) -> None:
        """One completed query's SERVICE time (queue wait excluded — the
        model measures how fast the engine serves, not how long the line
        was).  Failed queries are excluded: an error's latency measures
        the failure path, not the service rate."""
        if not ok or service_s < 0:
            return
        tenant = self._label(tenant)
        with self._lock:
            self._key_locked(tenant, cls).observe(float(service_s))

    # ---------------------------------------------------------------- reads
    def class_stats(self, cls: str) -> dict:
        """Aggregated (sample-weighted across tenants) stats for one class:
        {n, mean_s, p50_s, p99_s}.  n may be 0."""
        with self._lock:
            states = [s for (_t, c), s in self._keys.items()
                      if c == cls and s.n > 0]
            n = sum(s.n for s in states)
            if not n:
                return {"n": 0, "mean_s": None, "p50_s": None, "p99_s": None}
            mean = sum(s.ewma * s.n for s in states) / n
            rings = sorted(x for s in states for x in s.ring)
        p50 = rings[min(len(rings) - 1, int(0.5 * len(rings)))]
        p99 = rings[min(len(rings) - 1, int(0.99 * len(rings)))]
        return {"n": n, "mean_s": mean, "p50_s": p50, "p99_s": p99}

    def _class_mean(self, cls: str) -> tuple[int, Optional[float]]:
        """(n, sample-weighted mean service seconds) for one class WITHOUT
        touching the sample rings — the admission hot path (`cost_of` runs
        per cold query) must not sort quantile rings under the model lock;
        `class_stats` pays that only for snapshot/gauge readers."""
        with self._lock:
            n = 0
            num = 0.0
            for (_t, c), s in self._keys.items():
                if c == cls and s.n > 0:
                    n += s.n
                    num += s.ewma * s.n
        return n, (num / n if n else None)

    def cost_of(self, warm: bool) -> float:
        """The DRR cost estimate for a warm/cold query: the MEASURED
        cold/warm mean-service ratio (warm normalized to 1.0) once both
        classes are warm, else the static constants."""
        if warm or not enabled():
            return COST_WARM if warm else COST_COLD
        wn, wmean = self._class_mean(CLASS_WARM)
        cn, cmean = self._class_mean(CLASS_COLD)
        if wn < MIN_SAMPLES or cn < MIN_SAMPLES or not wmean or wmean <= 0:
            return COST_COLD
        return min(max(cmean / wmean, COST_MIN), COST_MAX)

    def _mean_service_locked(self) -> Optional[tuple[float, int]]:
        """(arrival-weighted mean service seconds, total samples) across
        warm+cold classes, or None while cold.  Mutations excluded: deploy
        round-trips are control-plane, not query service."""
        now_sec = int(time.time())
        num = den = 0.0
        n_total = 0
        for (_t, cls), s in self._keys.items():
            if cls == CLASS_MUTATION or s.n == 0:
                continue
            # weight each key's service time by its recent arrival rate so
            # the drain estimate reflects the CURRENT mix, not history
            w = s.arrival_qps(now_sec, ARRIVAL_WINDOW_S) or s.n / 1e6
            num += s.ewma * w
            den += w
            n_total += s.n
        if n_total < MIN_SAMPLES or den <= 0:
            return None
        return num / den, n_total

    def drain_qps(self, inflight_cap: int) -> Optional[float]:
        """Measured completion rate at full capacity: cap concurrent slots
        each finishing every mean-service-time seconds."""
        if not enabled():
            return None
        with self._lock:
            got = self._mean_service_locked()
        if got is None:
            return None
        mean_s, _n = got
        return max(1, int(inflight_cap)) / max(mean_s, 1e-6)

    def retry_after_s(self, queued: int, inflight_cap: int
                      ) -> Optional[float]:
        """Honest retry-after: the measured time for `queued` queries to
        drain at the measured service rate (None while the model is cold —
        callers keep the static heuristic)."""
        rate = self.drain_qps(inflight_cap)
        if rate is None:
            return None
        return min(max((queued + 1) / rate, RETRY_MIN_S), RETRY_MAX_S)

    def arrival_qps(self, window_s: int = 30) -> float:
        """Measured demand (queries/s over the window), mutations excluded."""
        now_sec = int(time.time())
        with self._lock:
            return sum(
                s.arrival_qps(now_sec, window_s)
                for (_t, cls), s in self._keys.items()
                if cls != CLASS_MUTATION)

    def offered_load(self, inflight_cap: int,
                     window_s: int = 30) -> Optional[float]:
        """Little's law: offered concurrency (arrival rate × mean service
        time) over capacity.  >1 means demand exceeds the fleet's measured
        service rate; the autoscaler's primary pressure signal."""
        if not enabled():
            return None
        with self._lock:
            got = self._mean_service_locked()
        if got is None:
            return None
        mean_s, _n = got
        return (self.arrival_qps(window_s) * mean_s) / max(1, int(inflight_cap))

    def snapshot(self) -> dict:
        """Per-class model state for telemetry/ops surfaces."""
        out = {}
        for cls in (CLASS_WARM, CLASS_COLD, CLASS_MUTATION):
            st = self.class_stats(cls)
            out[cls] = {
                "n": st["n"],
                "mean_ms": (round(st["mean_s"] * 1e3, 3)
                            if st["mean_s"] is not None else None),
                "p50_ms": (round(st["p50_s"] * 1e3, 3)
                           if st["p50_s"] is not None else None),
                "p99_ms": (round(st["p99_s"] * 1e3, 3)
                           if st["p99_s"] is not None else None),
            }
        out["cost_cold"] = round(self.cost_of(False), 3)
        out["arrival_qps"] = round(self.arrival_qps(), 3)
        return out

    # ------------------------------------------------------- observability
    def attach_gauges(self) -> None:
        if self._gauges:
            return
        self._gauges = True

        def read():
            out = {}
            for cls in (CLASS_WARM, CLASS_COLD):
                st = self.class_stats(cls)
                for q in ("p50_s", "p99_s"):
                    if st[q] is not None:
                        out[(("class", cls), ("q", q[:-2]))] = float(st[q])
            return out or {(): 0.0}

        metrics.register_gauge_fn(
            "px_rate_model_service_seconds", read,
            "measured per-class service-time quantiles (seconds)")
        metrics.register_gauge_fn(
            "px_rate_model_cost_cold",
            lambda: {(): float(self.cost_of(False))},
            "measured DRR cost of a cold query (warm = 1.0)")
        metrics.register_gauge_fn(
            "px_rate_model_arrival_qps",
            lambda: {(): float(self.arrival_qps())},
            "measured query arrival rate (30s window, mutations excluded)")

    def detach_gauges(self) -> None:
        if not self._gauges:
            return
        self._gauges = False
        metrics.unregister_gauge_fn("px_rate_model_service_seconds")
        metrics.unregister_gauge_fn("px_rate_model_cost_cold")
        metrics.unregister_gauge_fn("px_rate_model_arrival_qps")

    def reset_for_testing(self) -> None:
        with self._lock:
            self._keys.clear()
