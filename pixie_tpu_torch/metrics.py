"""Self-observability: Prometheus-text metrics registry + structured logging.

Reference: the C++ Prometheus registry (src/common/metrics/metrics.h), per-table
gauges (table/table_metrics.h), and the Go services' /metrics endpoints
(src/shared/services/metrics/).  Services expose `render()` over their
transport ({"msg": "metrics"} on the broker) and anything in-process can
scrape via the module API.

Copied whole from the reference package (pixie_tpu/metrics.py).  In the port
its writers include query batching (serving/batching.py), plan verification
(px_plan_verify_total), the journal and the cold tier (px_journal_*,
px_cold_*), the views and the SLO monitor; observe.sample_metrics_rows
folds it into self_telemetry.metrics, and the broker renders it (the
`metrics` frame, services/broker.py) as the health server does (/metrics,
services/health.py).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

_lock = threading.Lock()
_counters: dict[tuple, float] = {}
_gauges: dict[tuple, float] = {}
_gauge_fns: dict[str, tuple[str, Callable[[], dict]]] = {}
#: key -> {"bounds": tuple, "counts": per-bucket (non-cumulative), "sum", "count"}
_hists: dict[tuple, dict] = {}
_help: dict[str, str] = {}


def _key(name: str, labels: Optional[dict]) -> tuple:
    return (name, tuple(sorted((labels or {}).items())))


#: per-family capped label-id sets (see capped_label)
_label_ids: dict[str, set] = {}
MAX_LABEL_IDS = 256
OTHER_LABEL = "__other__"


def capped_label(family: str, ident: str, cap: int = MAX_LABEL_IDS) -> str:
    """Bound the distinct label values one id-space (tenant ids, agent
    names) can mint: the first `cap` ids get their own series, everything
    after shares OTHER_LABEL.  Counter series in this registry are
    immortal, so an unbounded id flood would otherwise grow process memory
    (and /metrics output) forever."""
    ident = str(ident)
    with _lock:
        s = _label_ids.setdefault(family, set())
        if ident in s:
            return ident
        if len(s) < cap:
            s.add(ident)
            return ident
    return OTHER_LABEL


def counter_inc(name: str, value: float = 1.0, labels: Optional[dict] = None,
                help_: str = "") -> None:
    with _lock:
        k = _key(name, labels)
        _counters[k] = _counters.get(k, 0.0) + value
        if help_:
            _help.setdefault(name, help_)


def gauge_set(name: str, value: float, labels: Optional[dict] = None,
              help_: str = "") -> None:
    with _lock:
        _gauges[_key(name, labels)] = float(value)
        if help_:
            _help.setdefault(name, help_)


def histogram_observe(name: str, value: float, bounds: tuple,
                      labels: Optional[dict] = None, help_: str = "") -> None:
    """Record one observation into a histogram with DECLARED bucket bounds
    (Prometheus text `_bucket`/`_sum`/`_count` rendering; bounds are upper
    bounds, +Inf is implicit).  First observation fixes the bounds for that
    (name, labels) series; later calls must pass the same bounds."""
    bounds = tuple(float(b) for b in bounds)
    with _lock:
        k = _key(name, labels)
        h = _hists.get(k)
        if h is None:
            if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
                raise ValueError(f"histogram {name}: bounds must increase")
            h = {"bounds": bounds, "counts": [0] * len(bounds),
                 "sum": 0.0, "count": 0}
            _hists[k] = h
            if help_:
                _help.setdefault(name, help_)
        elif h["bounds"] != bounds:
            raise ValueError(f"histogram {name}: bounds redeclared")
        h["sum"] += float(value)
        h["count"] += 1
        for i, b in enumerate(h["bounds"]):
            if value <= b:
                h["counts"][i] += 1
                break


def counter_value(name: str, labels: Optional[dict] = None) -> float:
    """Current value of a counter series (0.0 when never incremented) —
    the in-process read side tests and the serving load harness use to
    audit admitted/shed/goodput accounting without scraping /metrics."""
    with _lock:
        return _counters.get(_key(name, labels), 0.0)


def counter_series(name: str) -> dict[tuple, float]:
    """All label-series of one counter: {labels-tuple: value}."""
    with _lock:
        return {labels: v for (n, labels), v in _counters.items()
                if n == name}


def hist_quantile(name: str, q: float,
                  labels: Optional[dict] = None) -> Optional[float]:
    """Quantile estimate from a registered histogram's bucket counts
    (linear interpolation inside the covering bucket — the
    histogram_quantile() semantic).  Returns None for an unknown or empty
    series; observations past the last finite bound clamp to it.  This is
    the read side the load harness and the self-metrics sampler use, so
    reported percentiles come from the SAME registry ops scrape."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"hist_quantile: q={q} outside [0, 1]")
    with _lock:
        h = _hists.get(_key(name, labels))
        if h is None or h["count"] == 0:
            return None
        bounds, counts, total = h["bounds"], list(h["counts"]), h["count"]
    rank = q * total
    cum, lo = 0, 0.0
    for b, c in zip(bounds, counts):
        if c > 0 and cum + c >= rank:
            frac = min(max((rank - cum) / c, 0.0), 1.0)
            return lo + (b - lo) * frac
        cum += c
        lo = b
    # the remaining mass sits in the implicit +Inf bucket: the honest
    # answer without an upper bound is the last finite boundary
    return bounds[-1]


def snapshot() -> list[tuple]:
    """Everything registered, as (kind, name, labels_tuple, value) rows —
    the metrics-as-data read surface (observe.sample_metrics_rows folds it
    into self_telemetry.metrics).  Histograms contribute their sum/count
    plus interpolated p50/p99; lazy gauge fns are evaluated OUTSIDE the
    registry lock (they run user code), like render()."""
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        gauge_fns = dict(_gauge_fns)
        hist_keys = [k for k, h in _hists.items() if h["count"] > 0]
        hist_sums = {k: (_hists[k]["sum"], _hists[k]["count"])
                     for k in hist_keys}
    out: list[tuple] = []
    for (name, labels), v in sorted(counters.items()):
        out.append(("counter", name, labels, v))
    for (name, labels), v in sorted(gauges.items()):
        out.append(("gauge", name, labels, v))
    for name, (_help, fn) in sorted(gauge_fns.items()):
        try:
            vals = fn()
        except Exception:
            continue
        for labels, v in sorted(vals.items()):
            lt = (labels if isinstance(labels, tuple)
                  else tuple(sorted(labels.items())))
            out.append(("gauge", name, lt, float(v)))
    for name, labels in sorted(hist_keys):
        s, c = hist_sums[(name, labels)]
        out.append(("hist_sum", name, labels, s))
        out.append(("hist_count", name, labels, float(c)))
        for q, kind in ((0.5, "hist_p50"), (0.99, "hist_p99")):
            v = hist_quantile(name, q, dict(labels))
            if v is not None:
                out.append((kind, name, labels, v))
    return out


def register_gauge_fn(name: str, fn: Callable[[], dict], help_: str = "") -> None:
    """Lazy gauge: fn() -> {labels-tuple-or-frozen-dict: value} evaluated at
    render time (per-table sizes, registry liveness, ...)."""
    with _lock:
        _gauge_fns[name] = (help_, fn)


def has_gauge_fn(name: str) -> bool:
    with _lock:
        return name in _gauge_fns


def unregister_gauge_fn(name: str) -> None:
    """Drop a lazy gauge (service shutdown — keeps the module-global registry
    from pinning dead objects alive)."""
    with _lock:
        _gauge_fns.pop(name, None)


def _fmt_labels(labels: tuple) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def render() -> str:
    """Prometheus text exposition of everything registered."""
    lines = []
    with _lock:
        counters = dict(_counters)
        gauges = dict(_gauges)
        gauge_fns = dict(_gauge_fns)
        hists = {k: {"bounds": h["bounds"], "counts": list(h["counts"]),
                     "sum": h["sum"], "count": h["count"]}
                 for k, h in _hists.items()}
        helps = dict(_help)
    seen = set()
    for (name, labels), v in sorted(counters.items()):
        if name not in seen:
            seen.add(name)
            if name in helps:
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} counter")
        lines.append(f"{name}{_fmt_labels(labels)} {v:g}")
    for (name, labels), v in sorted(gauges.items()):
        if name not in seen:
            seen.add(name)
            if name in helps:
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name}{_fmt_labels(labels)} {v:g}")
    for (name, labels), h in sorted(hists.items()):
        if name not in seen:
            seen.add(name)
            if name in helps:
                lines.append(f"# HELP {name} {helps[name]}")
            lines.append(f"# TYPE {name} histogram")
        cum = 0
        for b, c in zip(h["bounds"], h["counts"]):
            cum += c
            lt = labels + (("le", f"{b:g}"),)
            lines.append(f"{name}_bucket{_fmt_labels(lt)} {cum}")
        lines.append(
            f"{name}_bucket{_fmt_labels(labels + (('le', '+Inf'),))} "
            f"{h['count']}")
        lines.append(f"{name}_sum{_fmt_labels(labels)} {h['sum']:g}")
        lines.append(f"{name}_count{_fmt_labels(labels)} {h['count']}")
    for name, (help_, fn) in sorted(gauge_fns.items()):
        try:
            vals = fn()
        except Exception:
            continue
        if name not in seen:
            seen.add(name)
            if help_:
                lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} gauge")
        for labels, v in sorted(vals.items()):
            lt = labels if isinstance(labels, tuple) else tuple(sorted(labels.items()))
            lines.append(f"{name}{_fmt_labels(lt)} {v:g}")
    return "\n".join(lines) + "\n"


def reset_for_testing() -> None:
    with _lock:
        _counters.clear()
        _gauges.clear()
        _gauge_fns.clear()
        _hists.clear()
        _help.clear()
        _label_ids.clear()


# ------------------------------------------------------------------- logging


def log(level: str, msg: str, **fields) -> None:
    """Structured log line (glog/logrus analog): level, ts, msg, k=v fields."""
    import json
    import sys

    rec = {"ts": time.time(), "level": level, "msg": msg, **fields}
    print(json.dumps(rec), file=sys.stderr, flush=True)


def info(msg: str, **fields) -> None:
    log("info", msg, **fields)


def warn(msg: str, **fields) -> None:
    log("warn", msg, **fields)


def error(msg: str, **fields) -> None:
    log("error", msg, **fields)
