"""View-key canonicalization: a compiled plan prefix → stable view key.

The matchable shape is exactly the distributed planner's partial-agg cut
(parallel.distributed.cut_agg): an agent plan whose single sink is a
ResultSinkOp(payload="agg_state") fed by AggOp(partial=True) over a pure
MemorySource→(Filter|Map)* chain.  The same plan dict reaches the broker's
matcher (dp.agent_plans) and the agent's maintainer (the `execute` frame),
so one canonicalization function serves both sides — no protocol addition
is needed for them to agree on the key.

Eligibility is conservative; anything a delta fold cannot reproduce exactly
misses and takes the normal full-rescan path:

  * time-bounded scans (start/stop_time) — a sliding window changes the
    constant per run, so the key would never repeat; windowed aggs over
    UNBOUNDED scans (`px.bin(time_)` group keys) are the supported
    dashboard shape, finalized per-window downstream.
  * row-id-bounded / streaming scans — those ARE delta cursors already.
  * chains containing LimitOp — head(n) over a scan is order-dependent and
    cannot be folded incrementally.
  * volatile (metadata-reading) UDFs — their LUTs change per metadata
    epoch, so yesterday's folded rows used yesterday's snapshot.

Copied from the reference package (pixie_tpu/matview/registry.py), with the
reference executor's volatile-UDF check (`_chain_uses_volatile`) kept here,
its one user in the port.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

from pixie_tpu_torch.plan.plan import (
    AggOp,
    Call,
    FilterOp,
    MapOp,
    MemorySourceOp,
    Plan,
    ResultSinkOp,
)


@dataclasses.dataclass(frozen=True)
class ViewPrefix:
    """The matched standing-query prefix of one agent plan."""

    head: MemorySourceOp
    chain: tuple  # (FilterOp | MapOp, ...) in source→agg order
    agg: AggOp
    channel: str  # the agg_state channel the result ships on


def _iter_call_fns(expr):
    """Yield every Call fn name in an expression tree."""
    if isinstance(expr, Call):
        yield expr.fn
        for a in expr.args:
            yield from _iter_call_fns(a)


def _chain_uses_volatile(chain, registry) -> bool:
    """True if any chain expression calls a volatile (metadata-reading) UDF."""
    for op in chain:
        exprs = []
        if isinstance(op, MapOp):
            exprs = [e for _n, e in op.exprs]
        elif isinstance(op, FilterOp):
            exprs = [op.expr]
        for e in exprs:
            for fn in _iter_call_fns(e):
                if registry.is_volatile(fn):
                    return True
    return False


def _op_sig(op) -> dict:
    d = op.to_dict()
    d.pop("id", None)
    return d


def match_prefix(plan: Plan, registry=None) -> Optional[ViewPrefix]:
    """Return the plan's standing-query prefix, or None when ineligible."""
    sinks = plan.sinks()
    if len(sinks) != 1:
        return None
    sink = sinks[0]
    if not isinstance(sink, ResultSinkOp) or sink.payload != "agg_state":
        return None
    parents = plan.parents(sink)
    if len(parents) != 1 or not isinstance(parents[0], AggOp):
        return None
    agg = parents[0]
    if not agg.partial:
        return None
    chain = []
    cur = agg
    while True:
        ps = plan.parents(cur)
        if len(ps) != 1:
            return None
        cur = ps[0]
        if isinstance(cur, (FilterOp, MapOp)):
            chain.append(cur)
            continue
        break
    if not isinstance(cur, MemorySourceOp):
        return None
    head = cur
    if head.streaming or head.since_row_id is not None or head.stop_row_id is not None:
        return None
    if head.start_time is not None or head.stop_time is not None:
        return None
    chain = tuple(reversed(chain))
    if registry is None:
        from pixie_tpu_torch.udf import registry as registry  # noqa: PLW0127

    try:
        if _chain_uses_volatile(chain, registry):
            return None
    except Exception:
        return None  # unknown UDF etc. — let the normal path raise it
    return ViewPrefix(head=head, chain=chain, agg=agg, channel=sink.channel)


def view_key(prefix: ViewPrefix) -> str:
    """Stable content key of the prefix (what the state is a function of).

    The key deliberately EXCLUDES runtime identifiers (op ids, channel
    names, table uids): two compilations of the same dashboard script must
    collide.  Table identity/schema churn is handled by the maintainer's
    DeltaCursor status, not the key."""
    agg_sig = _op_sig(prefix.agg)
    agg_sig.pop("partial", None)
    agg_sig.pop("finalize", None)
    canon = {
        "table": prefix.head.table,
        "tablet": prefix.head.tablet,
        "columns": prefix.head.columns,
        "chain": [_op_sig(op) for op in prefix.chain],
        "agg": agg_sig,
    }
    blob = json.dumps(canon, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def plan_view_key(plan: Plan, registry=None) -> Optional[str]:
    """view key of an agent plan, or None when it has no matchable prefix
    (the broker-side matcher's one call)."""
    pref = match_prefix(plan, registry)
    return view_key(pref) if pref is not None else None
