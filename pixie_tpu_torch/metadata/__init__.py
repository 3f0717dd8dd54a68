from pixie_tpu_torch.metadata.state import (
    ContainerInfo,
    K8sSnapshot,
    MetadataStateManager,
    PodInfo,
    ServiceInfo,
    global_manager,
    set_global_manager,
    snapshot,
)
from pixie_tpu_torch.metadata.funcs import CTX_KEYS, register_metadata_funcs

__all__ = [
    "ContainerInfo",
    "K8sSnapshot",
    "MetadataStateManager",
    "PodInfo",
    "ServiceInfo",
    "global_manager",
    "set_global_manager",
    "snapshot",
    "CTX_KEYS",
    "register_metadata_funcs",
]
