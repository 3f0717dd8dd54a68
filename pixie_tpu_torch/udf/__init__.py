from pixie_tpu_torch.udf.udf import UDA, ScalarUDF, Registry
from pixie_tpu_torch.udf import builtins as _builtins

#: Process-global registry preloaded with builtins (reference carnot registers
#: funcs/ builtins into the Registry at startup, src/carnot/funcs/funcs.cc),
#: the metadata functions and the introspection UDTFs.  The reference
#: registers its metadata functions when pixie_tpu/__init__ imports
#: pixie_tpu.metadata; here the registry's own package registers them, so
#: every route to it sees all of them whatever was imported first
#: (metadata.funcs imports nothing of this package at its top).
registry = Registry()
_builtins.register_all(registry)

from pixie_tpu_torch.metadata.funcs import (  # noqa: E402
    register_metadata_funcs as _reg_md,
)
from pixie_tpu_torch.udf.udtf import register_builtin_udtfs as _reg_udtfs  # noqa: E402

_reg_md(registry)
_reg_udtfs(registry)

from pixie_tpu_torch.ml.request_path import (  # noqa: E402
    register_request_path_funcs as _reg_rp,
)

_reg_rp(registry)

__all__ = ["UDA", "ScalarUDF", "Registry", "registry"]
