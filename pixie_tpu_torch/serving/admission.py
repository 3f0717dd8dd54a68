"""Admission primitives: per-tenant token buckets and quota specs.

Reference shape: the cloud control plane fronts Vizier with per-org rate
limits (PAPER.md layer map L5 → L3); in-cluster the query broker is the
choke point every ExecuteScript passes through, so quotas live there.

Quota flags use one spec grammar — a default value plus per-tenant
overrides:

    PL_TENANT_QPS="10"              every tenant gets a 10 qps bucket
    PL_TENANT_QPS="10,vip=50,batch=2"   overrides per tenant id
    PL_TENANT_QPS=""                unlimited (the default: serving is a
                                    pass-through until quotas are set)

`PL_TENANT_CONCURRENCY` (ints) and `PL_TENANT_WEIGHTS` (floats, scheduler
shares) parse the same way.  Values ≤ 0 mean unlimited for quotas and
weight 1 for shares.

Copied from the reference package (pixie_tpu/serving/admission.py).
"""
from __future__ import annotations

import time

from pixie_tpu_torch import flags
from pixie_tpu_torch.status import PxError

flags.define_bool(
    "PL_SERVING_ENABLED", True,
    "broker-side admission control + fair-share scheduling for "
    "ExecuteScript; off = every query races straight to the agent fleet "
    "(results are identical either way)")
flags.define_str(
    "PL_TENANT_QPS", "",
    "per-tenant token-bucket rate: 'default[,tenant=rate...]'; empty/0 = "
    "unlimited.  Over-rate queries shed immediately with retry-after")
flags.define_str(
    "PL_TENANT_CONCURRENCY", "",
    "per-tenant in-flight query cap: 'default[,tenant=n...]'; empty/0 = "
    "unlimited.  Over-cap queries queue behind the admission gate")
flags.define_str(
    "PL_TENANT_WEIGHTS", "",
    "deficit-round-robin shares: 'default[,tenant=w...]'; a weight-2 "
    "tenant drains its queue twice as fast as a weight-1 tenant")
flags.define_int(
    "PL_SERVING_MAX_INFLIGHT", 32,
    "global cap on concurrently executing queries; admitted queries past "
    "the cap wait in bounded per-tenant queues")
flags.define_int(
    "PL_SERVING_QUEUE_DEPTH", 256,
    "bounded per-tenant admission queue; a full queue sheds with "
    "retry-after instead of growing without bound")
flags.define_float(
    "PL_SERVING_QUEUE_TIMEOUT_S", 30.0,
    "max seconds a query may wait in the admission queue before it is "
    "shed with retry-after")
flags.define_int(
    "PL_SERVING_SHED_WATERMARK", 128,
    "total queued queries at which the broker degrades: readyz flips, "
    "cold queries shed with retry-after, matview hits serve stale state; "
    "0 disables degradation")
flags.define_int(
    "PL_SERVING_DEGRADED_WINDOW", 1,
    "chunk ack window pushed to agents for queries dispatched while "
    "degraded (narrower window = producers throttle harder); 0 keeps "
    "the agents' own PL_STREAM_WINDOW")

#: estimated cost units the scheduler charges per query.  Warm = the plan
#: cache already holds the compiled split (dispatch + merge only); cold =
#: full trace/optimize/split compile on top.  The 4x ratio is the measured
#: shape of interactive_1m: warm p50 ≈ ¼ of cold p50.
COST_WARM = 1.0
COST_COLD = 4.0


class ShedError(PxError):
    """Query rejected by admission control; retry after `retry_after_s`."""

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 reason: str = "overload"):
        super().__init__(msg)
        self.retry_after_s = round(float(retry_after_s), 3)
        self.reason = reason


def parse_tenant_spec(raw: str, cast=float) -> tuple[float | None, dict]:
    """'default[,tenant=value...]' → (default or None, {tenant: value}).

    Values ≤ 0 (and a missing/empty default) mean "unset"; malformed parts
    are ignored rather than raised — a typo in an ops env var must degrade
    to the default, not take the broker down on startup.
    """
    default = None
    overrides: dict[str, float] = {}
    for part in (raw or "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            if "=" in part:
                tenant, _, val = part.partition("=")
                v = cast(val)
                if tenant.strip() and v > 0:
                    overrides[tenant.strip()] = v
            else:
                v = cast(part)
                default = v if v > 0 else None
        except (TypeError, ValueError):
            continue
    return default, overrides


def spec_value(raw: str, tenant: str, cast=float):
    """Resolve one tenant's value from a spec string (None = unset)."""
    default, overrides = parse_tenant_spec(raw, cast)
    return overrides.get(tenant, default)


#: live-quota weight clamp (same bound _TenantState applies to env-spec
#: weights: the DRR round budget is O(cost/min_weight) under the lock)
WEIGHT_MIN, WEIGHT_MAX = 0.01, 100.0


def normalize_quota(tenant, qps=None, concurrency=None, weight=None) -> dict:
    """Validate one live quota record (the control-plane write path —
    broker `set_quota` frames and the CLI).  Unlike `parse_tenant_spec`
    (an ops ENV surface, where a typo must degrade, not crash the broker),
    a malformed API write is REJECTED with a clean error: the caller is
    interactive and must learn its spec was wrong.

    Field semantics: None = no override (the PL_TENANT_* env spec stays
    the default for that field); 0 = explicitly unlimited (qps /
    concurrency only); weight must be positive when given.  Returns the
    normalized record {qps, concurrency, weight}."""
    from pixie_tpu_torch.status import InvalidArgument

    if not isinstance(tenant, str) or not tenant.strip():
        raise InvalidArgument("quota: tenant must be a non-empty string")

    def num(name, v, cast, allow_zero):
        if v is None or v == "":
            return None
        if isinstance(v, bool):
            raise InvalidArgument(f"quota: {name} must be a number")
        try:
            v = cast(v)
        except (TypeError, ValueError):
            raise InvalidArgument(
                f"quota: {name} must be a number, got {v!r}") from None
        if v < 0 or (v == 0 and not allow_zero):
            raise InvalidArgument(
                f"quota: {name} must be {'>= 0' if allow_zero else '> 0'}, "
                f"got {v!r}")
        return v

    w = num("weight", weight, float, allow_zero=False)
    if w is not None:
        w = min(max(w, WEIGHT_MIN), WEIGHT_MAX)
    return {
        "qps": num("qps", qps, float, allow_zero=True),
        "concurrency": num("concurrency", concurrency, int, allow_zero=True),
        "weight": w,
    }


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill, `capacity` burst.

    Not thread-safe on its own — the ServingFront calls it under its lock.
    """

    __slots__ = ("rate", "capacity", "tokens", "last")

    def __init__(self, rate: float, capacity: float | None = None):
        self.rate = float(rate)
        # default burst: one second's worth of tokens, at least one query
        self.capacity = float(capacity if capacity is not None
                              else max(1.0, rate))
        self.tokens = self.capacity
        self.last = time.monotonic()

    def try_take(self, now: float | None = None) -> float:
        """Take one token.  Returns 0.0 on success, else the seconds until
        a token will be available (the retry-after hint)."""
        now = time.monotonic() if now is None else now
        if now > self.last:
            self.tokens = min(self.capacity,
                              self.tokens + (now - self.last) * self.rate)
            self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return 0.0
        return (1.0 - self.tokens) / self.rate
