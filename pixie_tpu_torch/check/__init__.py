"""Static analysis: plan verification before dispatch.

Copied from the reference package (pixie_tpu/check/).  ``check.planverify``
is a typed dataflow pass over compiled plans that LocalCluster runs before
every dispatch of a freshly computed split (PX_PLAN_VERIFY, default on):
schema/dtype flow op to op, shard-axis consistency across shuffle
boundaries, partial-agg mergeability, matview prefix consistency, and
limit/window sanity.  Violations raise a structured :class:`PlanVerifyError`
naming the op and the invariant.  Verified splits ride the whole-query plan
cache, so warm queries pay zero re-verification.

The reference's second checker, the repository linter ``check.pxlint``, is
not ported yet: it comes with the services layer whose locks it checks.
"""
from __future__ import annotations

from pixie_tpu_torch.check.planverify import (  # noqa: F401
    PlanVerifyError,
    verify_distributed,
    verify_plan,
)
