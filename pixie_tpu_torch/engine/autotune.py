"""Profile-fed adaptive gates: the hot path's hand-tuned constants become
online cost models.

The engine's dispatch seams are gated by constants tuned once on one box —
`PX_CPU_CROSSOVER_ROWS`, the device-join H2D gate, the multi-query fusion
choice — while the executor already measures the ground truth those
constants are guessing at.  This module closes that loop (Tailwind's framing
in PAPERS.md: route each fragment to the backend the MEASUREMENTS favor, not
the one a build-time constant picked):

  * **Per-gate cost models.**  Each gate keeps, per (plan class, size
    bucket) key, one `_Arm` per choice (service-time EWMA + mean-absolute
    deviation + a bounded sample ring).  `decide()` returns the arm with
    the lowest predicted cost once every arm is warm
    (`PX_AUTOTUNE_MIN_SAMPLES`), else the gate's static default — a cold
    model must never steer dispatch off one noisy sample.
  * **Guarded exploration.**  A small deterministic epsilon of decisions
    (`PX_AUTOTUNE_EPSILON`; counter-paced, never random — replays and
    restarts stay reproducible) probes the least-sampled non-favored arm so
    the model keeps a live baseline for the road not taken.  Cold
    non-static arms probe at a faster fixed cadence so a fresh model warms
    in bounded decisions; a KV-warmed model skips that burst entirely.
  * **Tail guard.**  Whenever the model favors a non-static arm, the
    favored arm's recent-sample p99 is compared against the static arm's:
    past `PX_AUTOTUNE_GUARD_FACTOR`× the gate snaps back to its static
    default for `PX_AUTOTUNE_GUARD_HOLDOFF` decisions, the drifted arm's
    stats reset, and an `autotune_fallback` event row is buffered
    (`drain_rows`) — a drifted model can never hold a tail hostage.
  * **Persistence.**  `save_kv`/`load_kv` round-trip the per-arm (n, ewma,
    dev) triples through a KV store (`autotune/model`) so a restarted
    process starts warm; a corrupt record degrades to static defaults
    (counted, never fatal).
  * **Attribution.**  Every decision dict lands in `stats["autotune"]` of
    the query that ran under it, so "why did this query take this path" is
    always answerable.

The port's copy of the reference's pixie_tpu/engine/autotune.py, the whole
model.  Its seams in the port: `cpu_crossover` (executor `_backend_for`:
arms "cpu" — the host fast paths — and "device" — the card route),
`device_join` (executor `_run_join`), `mq_fusion` (record-only) and
`observe_arrival` (LocalCluster.query).  `hedge` and `batch_window` come
with the broker; `sketch_sort` has no seam: the card's sketch update (K2)
has one formulation and routes by the sketch's bytes, not by a sort/GEMM
choice.

`PX_AUTOTUNE=0` removes every model read AND write: gates run their
original static logic bit-identically, no decision is recorded anywhere.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from pixie_tpu_torch import flags, metrics

flags.define_bool(
    "PX_AUTOTUNE", True,
    "profile-fed adaptive gates (engine/autotune.py): the CPU/card "
    "crossover and the device-join gate route through online cost models "
    "fit from measured completions instead of their static constants; 0 "
    "restores every static default bit-identically")
flags.define_float(
    "PX_AUTOTUNE_EPSILON", 0.0625,
    "fraction of warm-model decisions that probe the non-favored arm "
    "(deterministic counter pacing, not random) so the model keeps a live "
    "baseline for the road not taken")
flags.define_int(
    "PX_AUTOTUNE_MIN_SAMPLES", 8,
    "observations every arm of a gate key needs before the fitted model "
    "may override the static default")
flags.define_int(
    "PX_AUTOTUNE_GUARD_WINDOW", 8,
    "recent samples per arm the p99 tail guard needs before it compares a "
    "model-favored arm against the static arm")
flags.define_float(
    "PX_AUTOTUNE_GUARD_FACTOR", 2.0,
    "tail-guard trip ratio: a model-favored arm whose recent p99 exceeds "
    "factor * the static arm's p99 reverts the gate to its static default")
flags.define_int(
    "PX_AUTOTUNE_GUARD_HOLDOFF", 256,
    "decisions a tripped gate key stays pinned to its static default "
    "before the (reset) model may re-learn the non-favored arm")

#: the gates this module models (mq_fusion is record-only: the gang's
#: choice is PX_MQ_FUSION's, recorded per query but never flipped by the
#: model)
GATE_CPU_CROSSOVER = "cpu_crossover"
GATE_DEVICE_JOIN = "device_join"
GATE_SKETCH_SORT = "sketch_sort"
GATE_HEDGE = "hedge"
GATE_BATCH_WINDOW = "batch_window"
GATE_MQ_FUSION = "mq_fusion"

#: recent service samples kept per arm (tail-guard p99 readback)
RING = 64

#: cold non-static arms probe every Nth decision until warm — bounded
#: warmup without randomness (a KV-warmed model never enters this phase)
COLD_PROBE_PERIOD = 4

#: arrival-rate window (seconds of 1-second bins) for the batch controller
ARRIVAL_WINDOW_S = 30

#: bounded fallback/decision event buffer (drain_rows; the reference drains
#: it into self_telemetry.autotune, which comes with the port's host layers)
MAX_EVENTS = 512

#: keys tracked per gate — size buckets are intrinsically bounded (log
#: scale), but the cap keeps a pathological key stream from growing the
#: model without bound (same discipline as metric label families)
MAX_KEYS_PER_GATE = 64

#: EWMA smoothing factor (the service-time estimators' own)
ALPHA = 0.2

#: the KV record the model persists under
KV_KEY = "autotune/model"

#: lock discipline: every *_locked member of AutotuneModel is owned by the
#: model's one mutex


def enabled() -> bool:
    return bool(flags.get("PX_AUTOTUNE"))


def size_bucket(n: int) -> str:
    """Log-scale size bucket (powers of 4): inputs within a 4x band share
    one model key — fine enough to separate the crossover regions, coarse
    enough that every bucket warms from real traffic."""
    n = int(n)
    if n <= 0:
        return "4^0"
    return f"4^{(n.bit_length() + 1) // 2}"


class _Arm:
    """One (gate, key, arm) completion stream: cost EWMA + tail ring."""

    __slots__ = ("n", "ewma", "dev", "ring")

    def __init__(self, n: int = 0, ewma: float = 0.0, dev: float = 0.0):
        self.n = int(n)
        self.ewma = float(ewma)
        self.dev = float(dev)
        self.ring: deque = deque(maxlen=RING)

    def observe(self, secs: float) -> None:
        if self.n == 0:
            self.ewma = secs
            self.dev = secs / 2
        else:
            self.ewma += ALPHA * (secs - self.ewma)
            self.dev += ALPHA * (abs(secs - self.ewma) - self.dev)
        self.n += 1
        self.ring.append(secs)

    def ring_q(self, q: float) -> Optional[float]:
        if not self.ring:
            return None
        xs = sorted(self.ring)
        return xs[min(len(xs) - 1, int(q * len(xs)))]


class _GateState:
    """One gate's model: per-key arms + decision pacing + guard holdoff."""

    __slots__ = ("arms", "count", "holdoff", "last_arm", "fallbacks")

    def __init__(self):
        #: key -> {arm_name: _Arm}
        self.arms: dict[str, dict[str, _Arm]] = {}
        #: key -> decisions taken (paces the deterministic epsilon probe)
        self.count: dict[str, int] = {}
        #: key -> decisions left pinned to static after a guard trip
        self.holdoff: dict[str, int] = {}
        #: key -> arm of the most recent decision (observation routing for
        #: call sites whose completion callback has no decision handle)
        self.last_arm: dict[str, str] = {}
        self.fallbacks = 0


class AutotuneModel:
    """Thread-safe per-process model over every adaptive gate."""

    def __init__(self):
        self._lock = threading.Lock()
        self._gates: dict[str, _GateState] = {}
        #: pending autotune event rows (fallbacks, fitted-
        #: threshold changes) — drained on the self-metrics cron
        self._events: list[dict] = []
        self._events_dropped = 0
        #: fleet-wide dispatch service times (hedge-floor fit)
        self._service: deque = deque(maxlen=256)
        #: recent fused-batch wave walls (batch-window fit)
        self._waves: deque = deque(maxlen=128)
        #: (sec, arrivals) 1-second bins, ascending (batch-window fit)
        self._bins: deque = deque()
        #: fitted sketch thresholds last reported per backend (event dedup)
        self._sketch_fit: dict[str, int] = {}
        self.loaded_from_kv = False

    # ------------------------------------------------------------- internals
    def _gate_locked(self, gate: str) -> _GateState:
        g = self._gates.get(gate)
        if g is None:
            g = self._gates[gate] = _GateState()
        return g

    def _arm_locked(self, g: _GateState, key: str, arm: str) -> _Arm:
        arms = g.arms.get(key)
        if arms is None:
            if len(g.arms) >= MAX_KEYS_PER_GATE:
                # bounded like a metric label family: evict the least-
                # decided key (a re-appearing workload just re-warms)
                lru = min(g.count, key=g.count.get, default=None)
                if lru is not None:
                    g.arms.pop(lru, None)
                    g.count.pop(lru, None)
                    g.holdoff.pop(lru, None)
                    g.last_arm.pop(lru, None)
            arms = g.arms[key] = {}
        a = arms.get(arm)
        if a is None:
            a = arms[arm] = _Arm()
        return a

    def _event_locked(self, row: dict) -> None:
        if len(self._events) >= MAX_EVENTS:
            self._events_dropped += 1
            return
        self._events.append(row)

    def _guard_locked(self, gate: str, g: _GateState, key: str,
                      favored: str, static_arm: str) -> bool:
        """p99 tail guard: True = trip (revert to static, reset the
        drifted arm, record the fallback event)."""
        window = int(flags.get("PX_AUTOTUNE_GUARD_WINDOW"))
        factor = float(flags.get("PX_AUTOTUNE_GUARD_FACTOR"))
        arms = g.arms.get(key) or {}
        fav, sta = arms.get(favored), arms.get(static_arm)
        if fav is None or sta is None:
            return False
        if len(fav.ring) < window or len(sta.ring) < window:
            return False
        fp99, sp99 = fav.ring_q(0.99), sta.ring_q(0.99)
        if fp99 is None or sp99 is None or fp99 <= factor * max(sp99, 1e-9):
            return False
        g.holdoff[key] = int(flags.get("PX_AUTOTUNE_GUARD_HOLDOFF"))
        g.fallbacks += 1
        # the drifted arm re-learns from scratch: its history is exactly
        # what the guard just falsified
        arms[favored] = _Arm()
        cls, _, bucket = key.partition("|")
        self._event_locked({
            "time_": time.time_ns(), "query_id": "", "gate": gate,
            "plan_class": cls, "size_bucket": bucket, "arm": static_arm,
            "static_arm": static_arm, "source": "fallback",
            "model_ms": round(fp99 * 1e3, 3),
            "static_ms": round(sp99 * 1e3, 3), "observed_ms": 0.0,
            "reason": f"autotune_fallback p99 {fp99 * 1e3:.1f}ms > "
                      f"{factor:g}x {sp99 * 1e3:.1f}ms"})
        return True

    # ------------------------------------------------------------- decisions
    def decide(self, gate: str, plan_class: str, bucket: str,
               static_arm: str, arms: tuple) -> dict:
        """One gate decision for (plan_class, bucket): the fitted favorite
        when every arm is warm, the static default while cold or held off,
        a deterministic epsilon probe of the least-sampled other arm at the
        pacing counter's beat.  Callers gate on enabled() — this method
        assumes autotune is on."""
        key = f"{plan_class}|{bucket}"
        min_n = int(flags.get("PX_AUTOTUNE_MIN_SAMPLES"))
        eps = float(flags.get("PX_AUTOTUNE_EPSILON"))
        with self._lock:
            dec = self._decide_locked(gate, key, static_arm, tuple(arms),
                                      min_n, eps)
        dec["gate"] = gate
        dec["plan_class"] = plan_class
        dec["size_bucket"] = bucket
        dec["static_arm"] = static_arm
        if dec["source"] in ("fallback", "explore"):
            metrics.counter_inc(
                "px_autotune_decisions_total", labels={
                    "gate": gate, "source": dec["source"]},
                help_="adaptive-gate decisions by source "
                      "(model/static/cold/explore/fallback)")
        return dec

    def _decide_locked(self, gate: str, key: str, static_arm: str,
                       arms: tuple, min_n: int, eps: float) -> dict:
        g = self._gate_locked(gate)
        states = {a: self._arm_locked(g, key, a) for a in arms}
        count = g.count.get(key, 0)
        g.count[key] = count + 1
        hold = g.holdoff.get(key, 0)
        static_ms = (round(states[static_arm].ewma * 1e3, 3)
                     if static_arm in states and states[static_arm].n
                     else None)

        def _dec(arm, source, model_ms=None):
            g.last_arm[key] = arm
            return {"arm": arm, "source": source, "model_ms": model_ms,
                    "static_ms": static_ms, "n": count + 1}

        if hold > 0:
            g.holdoff[key] = hold - 1
            return _dec(static_arm, "fallback")
        warm = all(s.n >= min_n for s in states.values())
        if not warm:
            # bounded cold warmup: every COLD_PROBE_PERIODth decision runs
            # the least-sampled cold arm; everything else stays static.
            # A KV-warmed model (n restored) never enters this branch —
            # the "no cold exploration burst" restart contract.
            if count % COLD_PROBE_PERIOD == COLD_PROBE_PERIOD - 1:
                cold = [a for a in arms if states[a].n < min_n]
                probe = min(cold, key=lambda a: states[a].n)
                return _dec(probe, "explore")
            return _dec(static_arm, "cold")
        favored = min(arms, key=lambda a: states[a].ewma)
        model_ms = round(states[favored].ewma * 1e3, 3)
        if favored != static_arm and self._guard_locked(
                gate, g, key, favored, static_arm):
            return _dec(static_arm, "fallback", model_ms)
        period = max(2, int(round(1.0 / max(eps, 1e-6))))
        if count % period == period - 1 and len(arms) > 1:
            others = [a for a in arms if a != favored]
            probe = min(others, key=lambda a: states[a].n)
            return _dec(probe, "explore", model_ms)
        return _dec(favored, "model" if favored != static_arm else "static",
                    model_ms)

    def observe(self, gate: str, plan_class: str, bucket: str, arm: str,
                secs: float) -> None:
        """Fold one measured completion into (gate, key, arm)."""
        if secs < 0:
            return
        key = f"{plan_class}|{bucket}"
        with self._lock:
            g = self._gate_locked(gate)
            self._arm_locked(g, key, arm).observe(float(secs))

    def observe_decision(self, dec: dict, secs: float) -> None:
        """Fold the completion that a decide() dict routed (also stamps
        the measured cost onto the decision for telemetry rows)."""
        dec["observed_ms"] = round(float(secs) * 1e3, 3)
        self.observe(dec["gate"], dec["plan_class"], dec["size_bucket"],
                     dec["arm"], secs)

    def observe_last(self, gate: str, plan_class: str, bucket: str,
                     secs: float) -> None:
        """Fold a completion into whatever arm the gate key last decided —
        for call sites whose completion callback has no decision handle
        (hedge exec_done, batch wave close)."""
        key = f"{plan_class}|{bucket}"
        with self._lock:
            g = self._gate_locked(gate)
            arm = g.last_arm.get(key)
            if arm is None:
                return
            self._arm_locked(g, key, arm).observe(float(secs))

    # ----------------------------------------------------------- hedge model
    def observe_service(self, secs: float) -> None:
        """One dispatch→exec_done service time (broker completion stream):
        feeds the fleet-wide hedge floor and the hedge gate's active arm."""
        if secs < 0:
            return
        with self._lock:
            self._service.append(float(secs))
        self.observe_last(GATE_HEDGE, "dispatch", "fleet", secs)

    def _quantile_locked(self, ring, q: float) -> Optional[float]:
        if not ring:
            return None
        xs = sorted(ring)
        return xs[min(len(xs) - 1, int(q * len(xs)))]

    def hedge_floor_s(self, static_floor_s: float
                      ) -> tuple[float, Optional[dict]]:
        """The hedge deadline floor (no seam until the broker is ported):
        the measured fleet service p99 (with headroom) instead of the fixed
        PL_HEDGE_MIN_MS — a fast fleet hedges
        its stragglers in tens of ms instead of waiting out a half-second
        constant tuned for another box.  The measured floor only LOWERS the
        static one (hedging later than the operator's floor would widen the
        tail the flag exists to cap)."""
        dec = self.decide(GATE_HEDGE, "dispatch", "fleet", "static",
                          ("static", "model"))
        min_n = int(flags.get("PX_AUTOTUNE_MIN_SAMPLES"))
        with self._lock:
            p99 = (self._quantile_locked(self._service, 0.99)
                   if len(self._service) >= min_n else None)
        if dec["arm"] != "model" or p99 is None:
            dec["model_ms"] = None if p99 is None else round(p99 * 1e3, 3)
            dec["static_ms"] = round(static_floor_s * 1e3, 3)
            return float(static_floor_s), dec
        floor = min(float(static_floor_s), max(1.5 * p99, 0.01))
        dec["model_ms"] = round(floor * 1e3, 3)
        dec["static_ms"] = round(static_floor_s * 1e3, 3)
        return floor, dec

    # ---------------------------------------------------- batch-window model
    def observe_arrival(self, now: Optional[float] = None) -> None:
        """One query arrived at the dispatch seam (batch-window demand)."""
        sec = int(time.time() if now is None else now)
        with self._lock:
            if self._bins and self._bins[-1][0] == sec:
                self._bins[-1][1] += 1
            else:
                self._bins.append([sec, 1])
            while self._bins and self._bins[0][0] < sec - ARRIVAL_WINDOW_S:
                self._bins.popleft()

    def arrival_qps(self, window_s: int = 10,
                    now: Optional[float] = None) -> float:
        sec = int(time.time() if now is None else now)
        with self._lock:
            n = sum(c for s, c in self._bins if s >= sec - window_s)
        return n / max(window_s, 1)

    def observe_batch_wave(self, wall_s: float, size: int) -> None:
        """One fused batch executed: its wave wall feeds the window
        controller and the batch gate's active arm."""
        if wall_s < 0:
            return
        with self._lock:
            self._waves.append(float(wall_s))
        self.observe_last(GATE_BATCH_WINDOW, "batch", "global", wall_s)

    def batch_window(self, static_window_s: float, static_max_n: int
                     ) -> tuple[float, int, Optional[dict]]:
        """The batching rendezvous parameters (no seam until the broker is
        ported): window from measured wave RTT (half a wave — waiting longer than the work takes trades
        latency for no extra fusion), max members from the measured arrival
        rate over that window.  Static values until the model is warm; both
        outputs clamped to a 4x band around the static constants so a
        drifted fit can only mistune, never wedge, the collector."""
        dec = self.decide(GATE_BATCH_WINDOW, "batch", "global", "static",
                          ("static", "model"))
        min_n = int(flags.get("PX_AUTOTUNE_MIN_SAMPLES"))
        with self._lock:
            wave_p50 = (self._quantile_locked(self._waves, 0.5)
                        if len(self._waves) >= min_n else None)
        dec["static_ms"] = round(static_window_s * 1e3, 3)
        if dec["arm"] != "model" or wave_p50 is None:
            dec["model_ms"] = (None if wave_p50 is None
                               else round(wave_p50 * 1e3, 3))
            return float(static_window_s), int(static_max_n), dec
        window = min(max(0.5 * wave_p50, 0.25 * static_window_s),
                     4.0 * static_window_s)
        qps = self.arrival_qps()
        max_n = int(min(max(static_max_n, qps * window * 2.0),
                        4.0 * static_max_n))
        dec["model_ms"] = round(window * 1e3, 3)
        return window, max(2, max_n), dec

    # --------------------------------------------------------- sketch model
    def observe_sketch(self, backend: str, groups: int, dense_ms: float,
                       sorted_ms: float) -> None:
        """One measured dense-vs-sorted point: both formulations' costs at
        `groups` fold into the kernel-choice model for `backend` (no seam
        in the port: K2 has one formulation)."""
        self.observe(GATE_SKETCH_SORT, backend, str(int(groups)), "dense",
                     dense_ms / 1e3)
        self.observe(GATE_SKETCH_SORT, backend, str(int(groups)), "sorted",
                     sorted_ms / 1e3)

    def sketch_threshold(self, backend: str) -> Optional[int]:
        """The fitted sorted-kernel crossover for `backend`: the smallest
        measured group count where the sorted kernel beats the dense one,
        or None while unmeasured (callers keep the static default).  The
        sketch dispatch happens at kernel-trace time and is baked into the
        compiled program, so this gate is model-only — no per-query
        exploration (probing would churn compiled programs), the fit comes from
        the explicit crossover probe the bench runs each round."""
        min_n = int(flags.get("PX_AUTOTUNE_MIN_SAMPLES"))
        fitted = None
        with self._lock:
            g = self._gates.get(GATE_SKETCH_SORT)
            if g is not None:
                for key, arms in g.arms.items():
                    cls, _, bucket = key.partition("|")
                    if cls != backend or not bucket.isdigit():
                        continue
                    d, s = arms.get("dense"), arms.get("sorted")
                    if (d is None or s is None or d.n < min_n
                            or s.n < min_n or s.ewma >= d.ewma):
                        continue
                    gval = int(bucket)
                    if fitted is None or gval < fitted:
                        fitted = gval
            if fitted is not None and \
                    self._sketch_fit.get(backend) != fitted:
                self._sketch_fit[backend] = fitted
                self._event_locked({
                    "time_": time.time_ns(), "query_id": "",
                    "gate": GATE_SKETCH_SORT, "plan_class": backend,
                    "size_bucket": str(fitted), "arm": "sorted",
                    "static_arm": "dense", "source": "model",
                    "model_ms": 0.0, "static_ms": 0.0, "observed_ms": 0.0,
                    "reason": f"fitted sort crossover {fitted} groups"})
        return fitted

    # ------------------------------------------------------------ telemetry
    def record_row(self, dec: dict, query_id: str = "") -> None:
        """Push a completed decision straight into the event buffer — for
        call sites whose stats dict never reaches a telemetry sink (the
        join gate runs inside repartition-stage executors whose stats are
        consumed, not forwarded).  Marks the decision so rows_from_stats
        won't emit it twice when the stats DO flow."""
        dec["_recorded"] = True
        row = {
            "time_": time.time_ns(), "query_id": str(query_id),
            "gate": str(dec.get("gate", "")),
            "plan_class": str(dec.get("plan_class", "")),
            "size_bucket": str(dec.get("size_bucket", "")),
            "arm": str(dec.get("arm", "")),
            "static_arm": str(dec.get("static_arm", "")),
            "source": str(dec.get("source", "")),
            "model_ms": float(dec.get("model_ms") or 0.0),
            "static_ms": float(dec.get("static_ms") or 0.0),
            "observed_ms": float(dec.get("observed_ms") or 0.0),
            "reason": str(dec.get("reason", "")),
        }
        with self._lock:
            self._event_locked(row)

    def drain_rows(self) -> list[dict]:
        """Pending event rows (fallback trips, fitted-threshold changes)
        (the reference's self_telemetry.autotune rows)."""
        with self._lock:
            out, self._events = self._events, []
            dropped, self._events_dropped = self._events_dropped, 0
        if dropped:
            metrics.counter_inc(
                "px_autotune_events_dropped_total", float(dropped),
                help_="autotune event rows dropped by a full bounded "
                      "buffer")
        return out

    def snapshot(self) -> dict:
        """Per-gate model state for bench reports and ops surfaces."""
        out = {}
        with self._lock:
            for gate, g in self._gates.items():
                out[gate] = {
                    "keys": len(g.arms),
                    "decisions": sum(g.count.values()),
                    "fallbacks": g.fallbacks,
                    "samples": sum(a.n for arms in g.arms.values()
                                   for a in arms.values()),
                }
        return out

    # ---------------------------------------------------------- persistence
    def save_kv(self, kv) -> None:
        """Persist every arm's (n, ewma, dev) under autotune/model (rings
        stay volatile: the tail guard must re-earn its window from live
        traffic after a restart, not from another epoch's tail)."""
        with self._lock:
            gates = {
                gate: {
                    key: {arm: {"n": a.n, "ewma": a.ewma, "dev": a.dev}
                          for arm, a in arms.items()}
                    for key, arms in g.arms.items()
                }
                for gate, g in self._gates.items()
            }
        try:
            kv.set_json(KV_KEY, {"v": 1, "gates": gates})
        except Exception:
            metrics.counter_inc(
                "px_autotune_persist_errors_total",
                help_="failed attempts to persist the autotune model to "
                      "the broker KV")

    def load_kv(self, kv) -> bool:
        """Recall a persisted model (broker restart).  A corrupt record is
        counted and ignored — the model starts cold on static defaults,
        never fails the broker."""
        try:
            doc = kv.get_json(KV_KEY)
            if doc is None:
                return False
            if int(doc["v"]) != 1:
                raise ValueError(f"unknown model version {doc['v']}")
            gates = doc["gates"]
            loaded: dict[str, _GateState] = {}
            for gate, keys in gates.items():
                g = _GateState()
                for key, arms in keys.items():
                    g.arms[str(key)] = {
                        str(arm): _Arm(int(st["n"]), float(st["ewma"]),
                                       float(st["dev"]))
                        for arm, st in arms.items()}
                loaded[str(gate)] = g
        except Exception:
            metrics.counter_inc(
                "px_autotune_recall_errors_total",
                help_="persisted autotune model records skipped at broker "
                      "startup (corrupt or unknown version)")
            return False
        with self._lock:
            for gate, g in loaded.items():
                self._gates[gate] = g
            self.loaded_from_kv = True
        return True

    def reset_for_testing(self) -> None:
        with self._lock:
            self._gates.clear()
            self._events.clear()
            self._events_dropped = 0
            self._service.clear()
            self._waves.clear()
            self._bins.clear()
            self._sketch_fit.clear()
            self.loaded_from_kv = False


#: the process-wide model (gates live in executor/cluster seams all over the
#: process; one model sees the whole completion stream)
MODEL = AutotuneModel()


# -------------------------------------------------------- stats/row plumbing


def decisions_from_stats(stats: dict) -> list[dict]:
    """Every decision dict a query's stats carry: the broker/cluster-level
    list plus each agent executor's list."""
    out = [d for d in (stats.get("autotune") or []) if isinstance(d, dict)]
    for s in (stats.get("agents") or {}).values():
        if isinstance(s, dict):
            out.extend(d for d in (s.get("autotune") or [])
                       if isinstance(d, dict))
    return out


def rows_from_stats(stats: dict, query_id: str,
                    now_ns: Optional[int] = None) -> list[dict]:
    """stats["autotune"] decisions → self_telemetry.autotune rows."""
    now_ns = int(now_ns if now_ns is not None else time.time_ns())
    rows = []
    for d in decisions_from_stats(stats):
        if d.get("_recorded"):
            continue
        rows.append({
            "time_": now_ns,
            "query_id": str(query_id),
            "gate": str(d.get("gate", "")),
            "plan_class": str(d.get("plan_class", "")),
            "size_bucket": str(d.get("size_bucket", "")),
            "arm": str(d.get("arm", "")),
            "static_arm": str(d.get("static_arm", "")),
            "source": str(d.get("source", "")),
            "model_ms": float(d.get("model_ms") or 0.0),
            "static_ms": float(d.get("static_ms") or 0.0),
            "observed_ms": float(d.get("observed_ms") or 0.0),
            "reason": str(d.get("reason", "")),
        })
    return rows


def summary_from_stats(stats: dict) -> str:
    """Compact per-query provenance: one "gate:arm(source)" token per
    decision, for profile rows and EXPLAIN ANALYZE."""
    toks = []
    for d in decisions_from_stats(stats):
        tok = (f"{d.get('gate', '?')}:{d.get('arm', '?')}"
               f"({d.get('source', '?')})")
        if tok not in toks:
            toks.append(tok)
    return " ".join(toks[:16])
