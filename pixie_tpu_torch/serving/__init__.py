"""The serving layer: concurrent-query batching (`batching`) and the SLO
burn-rate monitor (`slo`, fed by LocalCluster's flight recorder).

Admission control, the fair-share scheduler and the load harnesses of the
reference's serving package come with the host-layer slice (services).
"""
from pixie_tpu_torch.serving import batching

__all__ = ["batching"]
