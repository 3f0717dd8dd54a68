"""pixie_tpu_torch: the PyTorch/CUDA port of pixie_tpu.

Telemetry enters an in-memory columnar table store where variable-width values
(strings, 128-bit UPIDs) are dictionary-encoded to dense int32 codes at ingest.
Plans run through a chain executor whose device work is torch tensor code
around hand-written CUDA kernels for Hopper (`csrc/`, built with nvcc on first
use): the masked segment reductions behind every aggregate and the per-group
log-histogram sketch behind the quantiles.

Entry points run on the CUDA device unless the caller passes device="cpu";
on a CPU tensor every kernel wrapper runs its plain PyTorch version.  The
package never imports JAX or pixie_tpu: it carries its own copies of what it
needs from the reference package.
"""
from pixie_tpu_torch.types import DataType, SemanticType, Relation  # noqa: F401
from pixie_tpu_torch.table import Table, TableStore, RowBatch  # noqa: F401

__version__ = "0.1.0"
