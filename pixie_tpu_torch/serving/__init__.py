"""Multi-tenant serving front: admission control + fair-share scheduling,
and the batching and SLO pieces the broker and LocalCluster share.

Copied from the reference package (pixie_tpu/serving/):

  admission.py  — per-tenant token-bucket quotas (PL_TENANT_QPS,
                  PL_TENANT_CONCURRENCY), quota-spec parsing, ShedError
                  (the retry-after envelope)
  scheduler.py  — ServingFront: global in-flight cap, bounded per-tenant
                  queues, deficit-round-robin dispatch weighted by tenant
                  share and estimated query cost (plan-cache warm vs cold
                  compile), degradation state (readyz flip, cold-query
                  shedding, stale matview serving, narrowed chunk ack
                  windows)
  ratemodel.py  — measured per-(tenant, plan-class) service-rate model:
                  replaces the static warm/cold DRR costs and heuristic
                  retry-after with measured rates (PL_RATE_MODEL)
  batching.py   — concurrent-query batching (PL_QUERY_BATCHING): fused
                  plans, one G1 gang launch a feed on the agents
  slo.py        — the SLO burn-rate monitor

Live quotas: `ServingFront.set_quota` applies control-plane records
(`admission.normalize_quota`) ahead of the PL_TENANT_* env specs; the
broker persists them in its KV and exposes `set_quota`/`get_quotas`
frames.

Flag-off (`PL_SERVING_ENABLED=0`) the front is a pass-through: no
accounting, no queueing, bit-identical results.

Not ported yet: the agent autoscaler (elastic.py) and the load, elastic
harnesses (ROADMAP Queue 1 item 6d, part 2).
"""
from pixie_tpu_torch.serving import batching
from pixie_tpu_torch.serving.admission import (
    COST_COLD,
    COST_WARM,
    ShedError,
    TokenBucket,
    normalize_quota,
    parse_tenant_spec,
)
from pixie_tpu_torch.serving.scheduler import ServingFront, Ticket

__all__ = [
    "COST_COLD",
    "COST_WARM",
    "ServingFront",
    "ShedError",
    "Ticket",
    "TokenBucket",
    "batching",
    "normalize_quota",
    "parse_tenant_spec",
]
