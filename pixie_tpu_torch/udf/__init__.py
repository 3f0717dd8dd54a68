from pixie_tpu_torch.udf.udf import UDA, ScalarUDF, Registry
from pixie_tpu_torch.udf import builtins as _builtins

#: Process-global registry preloaded with builtins (reference carnot registers
#: funcs/ builtins into the Registry at startup, src/carnot/funcs/funcs.cc).
#: UDTFs and the ml/ request-path functions join it with their slices.
registry = Registry()
_builtins.register_all(registry)

__all__ = ["UDA", "ScalarUDF", "Registry", "registry"]
