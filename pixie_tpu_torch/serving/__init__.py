"""The serving layer: concurrent-query batching (`batching`).

Admission control, the fair-share scheduler and the load harnesses of the
reference's serving package come with the host-layer slice.
"""
from pixie_tpu_torch.serving import batching

__all__ = ["batching"]
