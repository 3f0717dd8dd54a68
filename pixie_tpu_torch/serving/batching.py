"""Concurrent-query batching: shared scans + fused multi-query dispatch.

Thousands of concurrent queries over the SAME hot tables each paid their
own plan split, their own execute frames, their own device waves and their
own H2D — which is why measured MFU sat at ~0.2% even with the resident
tier (ROADMAP item 2).  This module is the collection point shared by the
broker and LocalCluster: admitted queries whose plans share a group key
(table, tablet, scan time window, schema epoch) rendezvous in a bounded
window and dispatch as ONE fused query.

The fusion itself is `plan.fusion.merge_plans` (the MergeNodesRule
machinery the multi-widget `funcs` path already uses): member plans merge
into one DAG with per-member sinks renamed `q{slot}/{name}`, identical
chains hash-cons away, pruned scans widen to the column union, and sibling
aggregates collapse into multi-value kernels.  Downstream, the agent-side
executor runs the surviving distinct filter→map→partial-agg chains as one
multi-query gang (engine/executor.py `_multi_partial_agg`): one launch of
kernel G1 (ops/gang.py) per feed updates every member's state, so launches,
feed reads and readback waves amortize across the whole batch.  Results demux back
per member by sink prefix — each query's client sees its normal stream.

Groupability is conservative; anything else falls back to the unbatched
path untouched (counted under px_batch_fallback_total):

  * mutations and now-sensitive plans (batch members must be pure and
    cacheable — the same bar the plan cache applies);
  * joins, unions, UDTF sources and OTel export sinks (shuffle stages and
    side effects do not compose across members);
  * streaming / row-id-bounded scans (those carry per-query cursor state);
  * plans whose scans disagree on (table, tablet, time window);
  * standing-view-shaped plans while matviews are enabled — a member that
    would hit a matview LEAVES the batch and takes the O(delta) view serve
    instead (batching exists for the long tail the views don't cover).

Flag-off (`PL_QUERY_BATCHING=0`) every query takes the pre-batching path
bit-identically.

Copied from the reference package (pixie_tpu/serving/batching.py).  The port
has no standing views yet, so it runs as the reference does with
PL_MATVIEW_ENABLED off: `leaves_for_matview` is always False (`view_shaped`
is kept, and tested, for the slice that brings the views).
"""
from __future__ import annotations

import copy
import threading
from collections import deque
from typing import Optional

from pixie_tpu_torch import flags as _flags
from pixie_tpu_torch import metrics as _metrics
from pixie_tpu_torch.plan.plan import (
    AggOp,
    FilterOp,
    LimitOp,
    MapOp,
    MemorySinkOp,
    MemorySourceOp,
    Plan,
)

_flags.define_bool(
    "PL_QUERY_BATCHING", True,
    "batch concurrent groupable queries over the same (table, scan window, "
    "schema epoch) into ONE fused dispatch with a shared scan and a fused "
    "multi-query device program per wave; results demux per query.  0 "
    "restores the per-query dispatch path bit-identically")
_flags.define_int(
    "PL_BATCH_MAX_QUERIES", 16,
    "maximum member queries per batch — a full batch dispatches "
    "immediately without waiting out the collection window")
_flags.define_float(
    "PL_BATCH_WINDOW_MS", 8.0,
    "batch collection window: how long the first groupable query waits for "
    "siblings before dispatching.  Only paid when other queries are in "
    "flight (a lone interactive query never waits), so it trades a few ms "
    "of saturated-path latency for batch depth")

#: batch-size histogram buckets (member queries per formed batch)
BATCH_SIZE_BOUNDS = (2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0)

#: recent formed-batch sizes (exact, bounded): the load harness reads
#: batch_size_p50 from here — the histogram buckets are too coarse for a
#: guarded percentile
_RECENT_SIZES: deque = deque(maxlen=4096)


def enabled() -> bool:
    return bool(_flags.get("PL_QUERY_BATCHING"))


# ------------------------------------------------------------- groupability

#: op kinds a batchable plan may contain (whitelist: anything else —
#: joins, unions, UDTFs, OTel sinks, remote sources — falls back)
_BATCHABLE_OPS = (MemorySourceOp, MapOp, FilterOp, LimitOp, AggOp,
                  MemorySinkOp)


def group_key(plan: Plan) -> Optional[tuple]:
    """The plan's batch group key — (table, tablet, start_time, stop_time)
    of its one scan shape — or None when the plan is not groupable.  The
    caller appends its schema epoch / topology fingerprint; two queries
    batch only under equal keys."""
    key = None
    saw_sink = False
    for op in plan.ops():
        if not isinstance(op, _BATCHABLE_OPS):
            return None
        if isinstance(op, MemorySinkOp):
            saw_sink = True
        if isinstance(op, MemorySourceOp):
            if (op.streaming or op.since_row_id is not None
                    or op.stop_row_id is not None):
                return None
            k = (op.table, op.tablet, op.start_time, op.stop_time)
            if key is None:
                key = k
            elif k != key:
                return None
    if key is None or not saw_sink:
        return None
    return key


def view_shaped(plan: Plan, registry=None) -> bool:
    """Whether the LOGICAL plan has the standing-view shape the matview
    maintainer would serve (single sink over agg over a pure scan chain) —
    the broker-side mirror of matview.registry.match_prefix, applied before
    the distributed split exists.  Such members leave the batch while
    matviews are enabled: the O(delta) view serve beats a shared rescan,
    and a fused multi-sink fragment would never match the view prefix."""
    sinks = plan.sinks()
    if len(sinks) != 1 or not isinstance(sinks[0], MemorySinkOp):
        return False
    parents = plan.parents(sinks[0])
    if len(parents) != 1 or not isinstance(parents[0], AggOp):
        return False
    agg = parents[0]
    cur = agg
    while True:
        ps = plan.parents(cur)
        if len(ps) != 1:
            return False
        cur = ps[0]
        if isinstance(cur, (FilterOp, MapOp)):
            continue
        break
    if not isinstance(cur, MemorySourceOp):
        return False
    if (cur.streaming or cur.since_row_id is not None
            or cur.stop_row_id is not None
            or cur.start_time is not None or cur.stop_time is not None):
        return False
    if registry is None:
        from pixie_tpu_torch.udf import registry as registry  # noqa: PLW0127
    # the planner ships dict-carrying aggs as rows channels — those never
    # register as views either
    for ae in agg.values:
        try:
            if registry.uda(ae.fn).dict_ok:
                return False
        except Exception:
            return False
    return True


def leaves_for_matview(plan: Plan, registry=None) -> bool:
    """True when matviews are enabled and this plan would take the
    standing-view serve — the member leaves the batch.  The port has no
    standing views yet (the reference with PL_MATVIEW_ENABLED off), so no
    member leaves."""
    return False


# -------------------------------------------------------- fused-plan helpers


def _sink_columns_walk(plan: Plan, sink: MemorySinkOp,
                       schemas: dict) -> Optional[list]:
    """The natural output column list of a columns-less sink, derived by
    walking up to the first op with an explicit output schema.  Must
    reproduce the executor's natural order exactly (groups then values for
    an agg; expr order for a map; scan columns / table relation for a
    source), so pinning the list onto the sink changes nothing about the
    result — it only tells plan fusion that widening upstream outputs
    (merged scans, merged sibling aggs) cannot leak extra columns in."""
    cur = plan.parents(sink)[0]
    while True:
        if isinstance(cur, AggOp):
            return list(cur.groups) + [v.out_name for v in cur.values]
        if isinstance(cur, MapOp):
            return [n for n, _e in cur.exprs]
        if isinstance(cur, (FilterOp, LimitOp)):
            cur = plan.parents(cur)[0]
            continue
        if isinstance(cur, MemorySourceOp):
            if cur.columns is not None:
                return list(cur.columns)
            rel = schemas.get(cur.table)
            return list(rel.names()) if rel is not None else None
        return None


def pin_sink_columns(plan: Plan, schemas: dict) -> Plan:
    """Rebuild `plan` with every columns-less MemorySinkOp given its
    derived natural column list.  Input plans are CACHED and immutable —
    every op is copied, never mutated in place."""
    out = Plan()
    new_of: dict[int, object] = {}
    for op in plan.topo_sorted():
        parents = [new_of[p.id] for p in plan.parents(op)]
        c = copy.copy(op)
        # plan ops memoize their serialized signature on the instance
        # (executor._op_sig); a copy we are about to mutate must drop it
        c.__dict__.pop("_op_sig_cache", None)
        c.id = -1
        if isinstance(c, MemorySinkOp) and c.columns is None:
            c.columns = _sink_columns_walk(plan, op, schemas)
        out.add(c, parents=parents)
        new_of[op.id] = c
    return out


def fuse_members(plans: list, schemas: dict) -> tuple[Plan, dict]:
    """[(slot prefix, member logical plan)] → (fused plan, sink_map) with
    sinks pinned to explicit column lists first so scan widening and
    sibling-agg merging engage (plan.fusion guards both on explicit
    downstream projection)."""
    from pixie_tpu_torch.plan.fusion import merge_plans

    return merge_plans([(p, pin_sink_columns(pl, schemas))
                        for p, pl in plans])


def demux_results(results: dict, sink_map: dict, prefix: str) -> dict:
    """One member's {original sink name: QueryResult} out of the fused
    run's results, with names restored."""
    out = {}
    for orig, fused_name in sink_map.get(prefix, {}).items():
        r = copy.copy(results[fused_name])
        r.name = orig
        r.exec_stats = dict(r.exec_stats)
        out[orig] = r
    return out


# ------------------------------------------------------------- observability


def note_formed(size: int) -> None:
    _RECENT_SIZES.append(int(size))
    _metrics.counter_inc(
        "px_batch_formed_total",
        help_="fused multi-query batches dispatched (≥2 members)")
    _metrics.counter_inc(
        "px_batch_queries_total", float(size),
        help_="member queries served through fused batches")
    _metrics.histogram_observe(
        "px_batch_size", float(size), BATCH_SIZE_BOUNDS,
        help_="member queries per formed batch")


def note_fallback(reason: str) -> None:
    """A query that reached the batching gate but executed unbatched:
    reason 'ineligible' (non-groupable plan), 'matview' (left the batch for
    the standing-view serve), or 'solo' (no sibling arrived in window)."""
    _metrics.counter_inc(
        "px_batch_fallback_total", labels={"reason": reason},
        help_="queries that fell back to the unbatched path at the "
              "batching gate, by reason")


def recent_size_p50() -> float:
    """Median formed-batch size over the recent window (load harness)."""
    xs = sorted(_RECENT_SIZES)
    return float(xs[len(xs) // 2]) if xs else 0.0


def reset_for_testing() -> None:
    _RECENT_SIZES.clear()


# ---------------------------------------------------------------- collector


class Member:
    """One query waiting at the batching rendezvous."""

    __slots__ = ("key", "plan", "tenant", "ticket", "event", "results",
                 "stats", "error", "seq")

    def __init__(self, key, plan, tenant: str = "", ticket=None):
        #: plan-cache key — the member's identity in the batch signature
        self.key = key
        self.plan = plan
        self.tenant = tenant
        self.ticket = ticket
        self.event = threading.Event()
        self.results = None
        self.stats = None
        self.error: Optional[BaseException] = None
        self.seq = 0

    def deliver(self, results, stats) -> None:
        self.results = results
        self.stats = stats
        self.event.set()

    def deliver_error(self, exc: BaseException) -> None:
        self.error = exc
        self.event.set()

    def wait(self, timeout_s: float):
        """Block for the leader's outcome; returns (results, stats) or
        re-raises the leader's error."""
        if not self.event.wait(timeout=timeout_s):
            from pixie_tpu_torch.status import Internal

            raise Internal("batch leader never delivered (timeout)")
        if self.error is not None:
            raise self.error
        return self.results, self.stats


class _Pending:
    __slots__ = ("members", "closed", "full")

    def __init__(self):
        self.members: list[Member] = []
        self.closed = False
        self.full = threading.Event()


class BatchCollector:
    """The rendezvous: first groupable query per key becomes the LEADER
    and waits out the collection window (or a full batch); later arrivals
    join as members and block for the leader's demuxed results.  One
    instance per broker / LocalCluster."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: dict = {}
        self._seq = 0
        self._n_active = 0
        #: test seam: force leaders to wait their window regardless of
        #: `busy()` — deterministic batch formation for single-round tests
        self.force_wait = False

    def active(self):
        """Context manager the caller holds for its WHOLE pass through the
        batching gate (collect → execute/wait → deliver).  The leader's
        decision to wait out the collection window keys off it: a lone
        interactive query (no concurrent traffic at the gate) never waits."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            with self._lock:
                self._n_active += 1
            try:
                yield
            finally:
                with self._lock:
                    self._n_active -= 1

        return cm()

    def busy(self) -> bool:
        with self._lock:
            return self._n_active >= 2

    def collect(self, key, member: Member, window_s: float, max_n: int,
                wait: Optional[bool] = None) -> Optional[list]:
        """Returns the member list when this caller is the batch leader
        (always including `member`, in deterministic slot order), or None
        when it joined an open batch — the caller then blocks on
        `member.wait()`.  `wait` None = wait the window only when other
        queries are concurrently at the gate (`busy()`) — a lone client's
        sequential queries (each leaving the gate before the next arrives)
        never wait, whatever thread they arrive on.  Under sustained
        concurrency this converges after one round: the first leader runs
        solo while later arrivals see it active, wait, and batch."""
        with self._lock:
            self._seq += 1
            member.seq = self._seq
            b = self._pending.get(key)
            if b is not None and not b.closed:
                b.members.append(member)
                if len(b.members) >= max_n:
                    b.closed = True
                    b.full.set()
                return None
            b = _Pending()
            b.members.append(member)
            self._pending[key] = b
        if wait is None:
            wait = self.force_wait or self.busy()
        if wait and window_s > 0 and max_n > 1:
            b.full.wait(timeout=window_s)
        with self._lock:
            b.closed = True
            if self._pending.get(key) is b:
                del self._pending[key]
            # deterministic slot order: members sort by plan-cache key then
            # arrival, so the same member multiset always produces the same
            # batch signature (and hits the same cached fused split)
            b.members.sort(key=lambda m: (repr(m.key), m.seq))
            return list(b.members)


def dedup_slots(members: list) -> tuple[list, list]:
    """(distinct member plans, per-member slot index).

    Identical member queries (same plan-cache key — the common case when
    hundreds of clients poll the same dashboards) share ONE slot: the
    fused plan carries each distinct query once, the execution computes it
    once, and every duplicate member receives its own copy of the slot's
    results at demux.  This also collapses the batch-signature space to
    subsets of the active script set, so the fused split cache warms after
    one round instead of one per member multiset."""
    slot_of_key: dict = {}
    plans: list = []
    slots: list[int] = []
    for m in members:
        k = repr(m.key)
        i = slot_of_key.get(k)
        if i is None:
            i = slot_of_key[k] = len(plans)
            plans.append(m.plan)
        slots.append(i)
    return plans, slots


def batch_signature(members: list) -> tuple:
    """Content signature of a batch: the slot-ordered DISTINCT member
    plan-cache keys (duplicates share a slot — see dedup_slots).  Warm
    repeats of the same distinct-member set ride the fused split cache —
    zero re-merge / re-split / re-verification."""
    seen: dict = {}
    for m in members:
        seen.setdefault(repr(m.key), None)
    return tuple(seen)


#: cached fused batch splits per broker/cluster (distinct member multisets
#: a dashboard workload cycles through)
MAX_BATCH_SPLITS = 32


def gate(collector: "BatchCollector", plan, key, epoch, window_s: float,
         max_n: int, execute_batch, wait_timeout_s: float, tenant: str = "",
         ticket=None, registry=None, concurrency=None):
    """The shared batching gate (broker AND LocalCluster drive this): check
    groupability, rendezvous, and either

      * return None — the caller runs its normal unbatched path (batching
        off, non-groupable plan, matview-shaped member, solo leader), or
      * return the member's outcome from `execute_batch(members)` — the
        caller's leader path, which must return one outcome per member in
        member order (an exception fans out to every member and re-raises).

    `key` is the member's plan-cache key; `epoch` is the caller's
    schema/topology fingerprint — it joins the collect key, so epoch
    changes never share a batch.  `concurrency` is the caller's "other
    queries are executing right now" signal (broker: serving-front
    in-flight ≥ 2; LocalCluster: its own query() counter) — solo leaders
    run OUTSIDE the collector's active window, so without it only
    already-waiting members would count as traffic and a steady stream of
    just-missed concurrent queries would never converge into batches."""
    if not enabled():
        return None
    gk = group_key(plan)
    if gk is None:
        note_fallback("ineligible")
        return None
    if leaves_for_matview(plan, registry):
        # a member that would hit a matview leaves the batch: the O(delta)
        # standing-view serve beats a shared rescan
        note_fallback("matview")
        return None
    member = Member(key, plan, tenant=tenant, ticket=ticket)
    with collector.active():
        wait = None
        if not collector.force_wait and concurrency is not None:
            try:
                wait = bool(concurrency()) or collector.busy()
            except Exception:  # a broken signal must not fail the query
                wait = None
        members = collector.collect((gk, epoch), member, window_s, max_n,
                                    wait=wait)
        if members is None:
            return member.wait(timeout_s=wait_timeout_s)
        if len(members) == 1:
            note_fallback("solo")
            return None
        try:
            per_member = execute_batch(members)
        except BaseException as e:
            for m in members:
                if m is not member:
                    m.deliver_error(e)
            raise
        out = None
        for m, res in zip(members, per_member):
            if m is member:
                out = res
            else:
                m.deliver(*(res if isinstance(res, tuple) else (res, None)))
        return out


def fused_slot(splits, lock, members: list, schemas: dict):
    """Fetch-or-build the batch signature's cached fusion from `splits`
    (an OrderedDict guarded by `lock`).  Returns (slot, plans, slot_of):
    the BatchSlot whose split slot rides QueryPlanCache.get_split, the
    DISTINCT member plans, and each member's slot index (duplicates share
    one computed slot — see dedup_slots)."""
    plans, slot_of = dedup_slots(members)
    sig = batch_signature(members)
    with lock:
        slot = splits.get(sig)
        if slot is not None:
            splits.move_to_end(sig)
    if slot is None:
        fused, sink_map = fuse_members(
            [(f"q{i}", p) for i, p in enumerate(plans)], schemas)
        slot = BatchSlot(fused, sink_map)
        with lock:
            splits[sig] = slot
            while len(splits) > MAX_BATCH_SPLITS:
                splits.popitem(last=False)
    return slot, plans, slot_of


class BatchSlot:
    """One batch signature's cached fusion: the merged plan, the per-slot
    sink map, and the split slot `QueryPlanCache.get_split` fills (duck-
    typed `_Entry`) — a warm batch pays zero re-merge/re-split/re-verify."""

    __slots__ = ("fused", "sink_map", "split")

    def __init__(self, fused, sink_map):
        self.fused = fused
        self.sink_map = sink_map
        self.split = None
