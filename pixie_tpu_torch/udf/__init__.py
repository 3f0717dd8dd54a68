from pixie_tpu_torch.udf.udf import UDA, ScalarUDF, Registry
from pixie_tpu_torch.udf import builtins as _builtins

#: Process-global registry preloaded with builtins (reference carnot registers
#: funcs/ builtins into the Registry at startup, src/carnot/funcs/funcs.cc).
#: UDTFs join it with their slice.
registry = Registry()
_builtins.register_all(registry)

from pixie_tpu_torch.ml.request_path import (  # noqa: E402
    register_request_path_funcs as _reg_rp,
)

_reg_rp(registry)

__all__ = ["UDA", "ScalarUDF", "Registry", "registry"]
