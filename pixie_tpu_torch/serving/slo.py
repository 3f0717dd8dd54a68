"""Per-tenant SLO burn-rate monitoring over the query-profile stream.

The serving front's admission/fairness machinery had no measured
per-tenant objective to close its loop against; this module supplies it.
SLOs are declared in the ``PL_SLO`` spec grammar:

    PL_SLO = "<slo>[;<slo>...]"
    <slo>  = "<name>:latency<<N>ms@<objective-pct>"     latency SLO: a query
             is GOOD when its end-to-end latency is <= N milliseconds
           | "<name>:errors@<objective-pct>"            availability SLO: a
             query is GOOD when it completed without error or shed

    e.g. PL_SLO="interactive:latency<500ms@99;availability:errors@99.9"

Every completed (or failed/shed) query feeds one observation per declared
SLO, bucketed per tenant.  Burn rate over a window is the classic SRE
ratio::

    burn = (bad_fraction over window) / (1 - objective)

evaluated over TWO windows — fast (``PL_SLO_FAST_S``, default 5m, page
threshold ``PL_SLO_BURN_FAST`` = 14.4) and slow (``PL_SLO_SLOW_S``, default
1h, threshold ``PL_SLO_BURN_SLOW`` = 6) — so a sudden total outage and a
slow budget bleed both alert, and a brief blip alerts on neither.

Exports: ``px_slo_burn_rate{slo,tenant,window}`` gauges (lazy, read at
scrape time), rising/falling-edge alert rows for
``self_telemetry.alerts`` (the broker ships them through the normal
telemetry write path), and per-SLO observation counters.  With ``PL_SLO``
empty the record path is one truthiness check per query.

Copied from the reference package (pixie_tpu/serving/slo.py).  In the
port its per-query hook is LocalCluster's flight recorder.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

from pixie_tpu_torch import flags, metrics

flags.define_str(
    "PL_SLO", "",
    "SLO spec: '<name>:latency<Nms@PCT' / '<name>:errors@PCT' joined by "
    "';' — per-tenant burn rates over the query-profile stream, exported "
    "as px_slo_burn_rate gauges and self_telemetry.alerts rows")
flags.define_float("PL_SLO_FAST_S", 300.0,
                   "fast burn-rate window (seconds)")
flags.define_float("PL_SLO_SLOW_S", 3600.0,
                   "slow burn-rate window (seconds)")
flags.define_float("PL_SLO_BURN_FAST", 14.4,
                   "alert threshold for the fast-window burn rate")
flags.define_float("PL_SLO_BURN_SLOW", 6.0,
                   "alert threshold for the slow-window burn rate")

#: evaluate() is cheap but not free; the broker's per-query hook throttles
#: through maybe_evaluate at this cadence
EVAL_MIN_INTERVAL_S = 1.0


@dataclasses.dataclass(frozen=True)
class SLODef:
    name: str
    kind: str  # "latency" | "errors"
    threshold_s: Optional[float]  # latency SLOs only
    objective: float  # good-event target fraction, e.g. 0.99

    @property
    def budget(self) -> float:
        return max(1.0 - self.objective, 1e-9)


def parse_slo_spec(spec: str) -> list[SLODef]:
    """Parse the PL_SLO grammar; malformed entries are skipped with a
    counter (ops env typos must not take the broker down)."""
    out: list[SLODef] = []
    for part in (spec or "").split(";"):
        part = part.strip()
        if not part:
            continue
        try:
            name, rest = part.split(":", 1)
            body, obj = rest.rsplit("@", 1)
            objective = float(obj) / 100.0
            if not 0.0 < objective < 1.0:
                raise ValueError(f"objective {obj}% outside (0, 100)")
            if body.strip() == "errors":
                out.append(SLODef(name.strip(), "errors", None, objective))
                continue
            kind, thr = body.split("<", 1)
            if kind.strip() != "latency" or not thr.endswith("ms"):
                raise ValueError(f"unknown SLO body {body!r}")
            out.append(SLODef(name.strip(), "latency",
                              float(thr[:-2]) / 1e3, objective))
        except ValueError:
            metrics.counter_inc(
                "px_slo_spec_parse_errors_total",
                help_="malformed PL_SLO entries skipped at parse")
    return out


class _Series:
    """One (slo, tenant) observation stream as 1-second bins of
    (sec, total, bad) — bounded by the slow window, never by traffic."""

    __slots__ = ("bins",)

    def __init__(self):
        self.bins: deque = deque()  # (sec, total, bad), ascending sec

    def add(self, sec: int, bad: bool) -> None:
        if self.bins and self.bins[-1][0] == sec:
            s, t, b = self.bins[-1]
            self.bins[-1] = (s, t + 1, b + (1 if bad else 0))
        else:
            self.bins.append((sec, 1, 1 if bad else 0))

    def prune(self, horizon_sec: int) -> None:
        while self.bins and self.bins[0][0] < horizon_sec:
            self.bins.popleft()

    def window(self, since_sec: float) -> tuple[int, int]:
        total = bad = 0
        for s, t, b in reversed(self.bins):
            if s < since_sec:
                break
            total += t
            bad += b
        return total, bad


class SLOMonitor:
    """Burn-rate evaluation over per-tenant good/bad query observations.

    Thread-safe; `record` is called from query completion paths, `evaluate`
    from the self-metrics ticker (and throttled per query), `burn_rates`
    from the lazy gauge at scrape time."""

    def __init__(self, spec: Optional[str] = None,
                 fast_s: Optional[float] = None,
                 slow_s: Optional[float] = None):
        self.slos = parse_slo_spec(
            spec if spec is not None else flags.get("PL_SLO"))
        self.fast_s = float(fast_s if fast_s is not None
                            else flags.get("PL_SLO_FAST_S"))
        self.slow_s = float(slow_s if slow_s is not None
                            else flags.get("PL_SLO_SLOW_S"))
        self._lock = threading.Lock()
        self._series: dict[tuple[str, str], _Series] = {}
        #: (slo, tenant, window) currently past threshold (edge detection)
        self._firing: set[tuple] = set()
        self._alerts: list[dict] = []
        self._last_eval = 0.0

    # ------------------------------------------------------------- observe
    def record(self, tenant: str, latency_s: float, ok: bool,
               now: Optional[float] = None) -> None:
        """Feed one completed query (the profile stream's summary): each
        declared SLO classifies it good/bad independently."""
        if not self.slos:
            return
        now = time.time() if now is None else now
        sec = int(now)
        tenant = metrics.capped_label("slo_tenant", str(tenant or ""))
        with self._lock:
            for slo in self.slos:
                if slo.kind == "latency":
                    bad = (not ok) or latency_s > slo.threshold_s
                else:
                    bad = not ok
                s = self._series.get((slo.name, tenant))
                if s is None:
                    s = self._series[(slo.name, tenant)] = _Series()
                s.add(sec, bad)
                s.prune(sec - int(self.slow_s) - 1)

    # ------------------------------------------------------------ evaluate
    def burn_rates(self, now: Optional[float] = None) -> dict[tuple, float]:
        """{(slo, tenant, window): burn} for both windows of every series
        with observations.  burn 1.0 = spending exactly the error budget."""
        now = time.time() if now is None else now
        out: dict[tuple, float] = {}
        with self._lock:
            defs = {s.name: s for s in self.slos}
            for (name, tenant), series in self._series.items():
                slo = defs.get(name)
                if slo is None:
                    continue
                for window, span in (("fast", self.fast_s),
                                     ("slow", self.slow_s)):
                    total, bad = series.window(now - span)
                    if total == 0:
                        continue
                    out[(name, tenant, window)] = (
                        (bad / total) / slo.budget)
        return out

    def evaluate(self, now: Optional[float] = None) -> list[dict]:
        """Edge-detected alert rows (state firing/resolved) for
        self_telemetry.alerts; also keeps px_slo_alerts_total counted.
        Burn thresholds: fast window vs PL_SLO_BURN_FAST, slow window vs
        PL_SLO_BURN_SLOW."""
        now = time.time() if now is None else now
        rates = self.burn_rates(now)
        thresholds = {"fast": float(flags.get("PL_SLO_BURN_FAST")),
                      "slow": float(flags.get("PL_SLO_BURN_SLOW"))}
        defs = {s.name: s for s in self.slos}
        rows: list[dict] = []
        with self._lock:
            seen: set[tuple] = set()
            for (name, tenant, window), burn in sorted(rates.items()):
                thr = thresholds[window]
                key = (name, tenant, window)
                if burn >= thr:
                    seen.add(key)
                    if key not in self._firing:
                        self._firing.add(key)
                        rows.append(self._alert_row(
                            now, defs[name], tenant, window, burn, thr,
                            "firing"))
            for key in sorted(self._firing - seen):
                name, tenant, window = key
                self._firing.discard(key)
                if name in defs:
                    rows.append(self._alert_row(
                        now, defs[name], tenant, window,
                        rates.get(key, 0.0), thresholds[window],
                        "resolved"))
            self._alerts.extend(rows)
        for r in rows:
            if r["state"] == "firing":
                metrics.counter_inc(
                    "px_slo_alerts_total",
                    labels={"slo": r["slo"], "window": r["window"]},
                    help_="SLO burn-rate alerts fired (rising edges)")
        return rows

    @staticmethod
    def _alert_row(now, slo: SLODef, tenant, window, burn, thr,
                   state) -> dict:
        return {"time_": int(now * 1e9), "slo": slo.name, "tenant": tenant,
                "window": window, "burn_rate": round(float(burn), 4),
                "threshold": thr, "objective": slo.objective,
                "state": state}

    def maybe_evaluate(self, now: Optional[float] = None) -> list[dict]:
        """Throttled evaluate for per-query hooks (at most once per
        EVAL_MIN_INTERVAL_S)."""
        now = time.time() if now is None else now
        with self._lock:
            if now - self._last_eval < EVAL_MIN_INTERVAL_S:
                return []
            self._last_eval = now
        return self.evaluate(now)

    def drain_alerts(self) -> list[dict]:
        with self._lock:
            out, self._alerts = self._alerts, []
        return out


# ------------------------------------------------------------- module state

_MONITOR: Optional[SLOMonitor] = None
_MONITOR_LOCK = threading.Lock()


def monitor() -> SLOMonitor:
    """The process-wide monitor (lazy; spec read from PL_SLO at first use).
    One instance serves broker and LocalCluster alike — like the metrics
    registry, SLO state is per process, not per server object."""
    global _MONITOR
    with _MONITOR_LOCK:
        if _MONITOR is None:
            _MONITOR = SLOMonitor()
        if not metrics.has_gauge_fn("px_slo_burn_rate"):
            # keyed off the registry (not a local bool): a metrics
            # reset_for_testing followed by another use re-registers
            # instead of silently losing the gauge
            _register_gauge()
        return _MONITOR


def _register_gauge() -> None:
    def read():
        m = _MONITOR
        if m is None:
            return {}
        return {(("slo", n), ("tenant", t), ("window", w)): v
                for (n, t, w), v in m.burn_rates().items()}

    metrics.register_gauge_fn(
        "px_slo_burn_rate", read,
        "error-budget burn rate per SLO/tenant/window (1.0 = spending "
        "exactly the budget)")


def record_query(tenant: str, latency_s: float, ok: bool) -> None:
    """The profile-stream hook: no-op (one flag read + truthiness check)
    when PL_SLO is empty."""
    if not flags.get("PL_SLO"):
        return
    monitor().record(tenant, latency_s, ok)


def configured() -> bool:
    return bool(flags.get("PL_SLO"))


def reset_for_testing() -> None:
    """Drop the singleton so the next use re-reads PL_SLO (tests toggle
    the spec via flags.set_for_testing)."""
    global _MONITOR
    with _MONITOR_LOCK:
        _MONITOR = None
