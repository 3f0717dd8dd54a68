"""Standing-view maintainer: registration, O(delta) refresh, invalidation.

One MatViewManager per table store (per agent).  Lifecycle of a view:

  1. FIRST sight of an eligible plan registers the view — no extra work on
     that query's path; it anchors a DeltaCursor at the table's current
     retention frontier and runs the normal full rescan.
  2. LATER sights (or a cron tick via refresh_all) fold only rows appended
     since the watermark into the standing value-keyed partial-agg state:
     the delta runs through the SAME executor partial path as a cold query
     (np_partial fast loop / jitted kernels / sorted fallback), and the
     fold reuses parallel.partial.combine_partials — the broker's merge
     path — so state layout and merge semantics are identical to the
     distributed cold path by construction.
  3. A match on a refreshed view serves the standing PartialAggBatch: the
     consumer (broker fold → finalize) sees exactly what a partial agg over
     the full retained table would have produced, for one tiny readback's
     worth of work.

Invalidation (checked before AND after every fold, so expiry racing a
refresh loses): table dropped/recreated (uid change — also covers schema
change), retention trimmed past the state's base row (state would cover
rows a cold scan can't see), or a dead cursor (unread rows expired).  All
reset the view and rebuild from the live retention frontier — the "fall
back to full rescan" behavior, made incremental again afterwards.

State budget: PL_MATVIEW_MAX_STATE_MB caps a manager's standing-state
bytes; cold views evict LRU.  A single view larger than the whole budget is
never retained (it would just thrash).

Copied from the reference package (pixie_tpu/matview/maintainer.py).  A
manager runs its folds on its device (`MatViewManager(store, registry,
device)`: the card unless the caller asks for another): the delta is a
row-id-bounded scan, which the executor uploads fresh (a delta cursor never
takes the resident tier or the feed cache), through the same chain and
aggregate kernels as a cold query (C1, K1, K2), and its state comes back
to the host as a PartialAggBatch (P1 where it has several leaves); the
fold is parallel/partial.combine_partials on the host.  A fold retries
once, and falls back to a rescan, only where the table went away under it
(NotFound, Unavailable); any other error of the fold (a kernel's, a
torch error) propagates.  What the port leaves out: no query routing by
size (no `route_scale`), no tenant namespaces (every view is in the
reference's no-tenant namespace, so one budget), no tablets (a tablet head
never matches), and no durable snapshots: they need table/journal.py's
record framing (ROADMAP Queue 1 item 6b), so `set_snapshot_dir` with a path
raises Unimplemented.
"""
from __future__ import annotations

import copy
import threading
import time
import weakref
from typing import Optional

import numpy as np

from pixie_tpu_torch import flags, metrics, trace
from pixie_tpu_torch.matview.registry import ViewPrefix, match_prefix, view_key
from pixie_tpu_torch.plan.plan import Plan, ResultSinkOp
from pixie_tpu_torch.status import NotFound, Unavailable, Unimplemented
from pixie_tpu_torch.table.delta import OK as CURSOR_OK, DeltaCursor
from pixie_tpu_torch.table.table import Table

flags.define_bool(
    "PL_MATVIEW_ENABLED", True,
    "maintain materialized views for repeated scan→filter→map→partial-agg "
    "queries and answer later runs from standing state (O(delta) refresh); "
    "off = every query rescans (results are identical either way)")
flags.define_int(
    "PL_MATVIEW_MAX_STATE_MB", 256,
    "budget for the sum of standing view state bytes per store; cold views "
    "evict LRU, and a single view over the whole budget is never retained")
flags.define_float(
    "PL_MATVIEW_REFRESH_S", 0.0,
    "background refresh cadence for registered views (the cron-tick "
    "maintainer); 0 = refresh only on query (lazily)")

# Lock discipline: the refresh path is owned by the per-VIEW lock
# (StandingView.lock), NOT the manager's _lock — the manager lock only
# guards the _views dict.

#: live managers, for the process-wide state gauges
_MANAGERS: "weakref.WeakSet" = weakref.WeakSet()
_GAUGES_ONCE = threading.Lock()
_gauges_registered = False


def _register_gauges() -> None:
    global _gauges_registered
    with _GAUGES_ONCE:
        if _gauges_registered:
            return
        _gauges_registered = True
        metrics.register_gauge_fn(
            "px_matview_views",
            lambda: {(): float(sum(len(m._views) for m in _MANAGERS))},
            "standing materialized views registered across live managers")
        metrics.register_gauge_fn(
            "px_matview_state_bytes",
            lambda: {(): float(sum(m.state_bytes() for m in _MANAGERS))},
            "bytes of standing partial-agg state across live managers")


def _pb_nbytes(pb) -> int:
    """Approximate byte size of a PartialAggBatch (object-dtype key columns
    count their string payloads, not just pointers)."""
    if pb is None:
        return 0
    total = 0

    def arr_bytes(a) -> int:
        a = np.asarray(a)
        if a.dtype == object:
            return int(a.nbytes) + sum(len(str(v)) for v in a.ravel())
        return int(a.nbytes)

    for v in pb.key_cols.values():
        total += arr_bytes(v)

    def walk(tree):
        nonlocal total
        if isinstance(tree, dict):
            for v in tree.values():
                walk(v)
        else:
            total += arr_bytes(tree)

    for tree in pb.states.values():
        walk(tree)
    return total


class StandingView:
    """One registered view: prefix + delta cursor + accumulated state."""

    __slots__ = ("key", "prefix", "cursor", "state", "lock",
                 "state_bytes", "refreshes", "rows_folded", "hits",
                 "rebuilds", "stale_serves", "last_access", "created_at")

    def __init__(self, key: str, prefix: ViewPrefix, table):
        self.key = key
        self.stale_serves = 0
        self.prefix = prefix
        self.cursor = DeltaCursor(table)
        self.state = None  # PartialAggBatch once first refreshed
        self.lock = threading.Lock()
        self.state_bytes = 0
        self.refreshes = 0
        self.rows_folded = 0
        self.hits = 0
        self.rebuilds = 0
        self.last_access = time.monotonic()
        self.created_at = time.time()

    def stats(self) -> dict:
        return {
            "key": self.key,
            "ns": "",
            "stale_serves": self.stale_serves,
            "table": self.prefix.head.table,
            "tablet": self.prefix.head.tablet,
            "groups": self.prefix.agg.groups,
            "watermark": self.cursor.watermark,
            "base_row_id": self.cursor.base_row_id,
            "state_bytes": self.state_bytes,
            "state_groups": (self.state.num_groups
                             if self.state is not None else 0),
            "refreshes": self.refreshes,
            "rows_folded": self.rows_folded,
            "hits": self.hits,
            "rebuilds": self.rebuilds,
        }


class MatViewManager:
    """Standing views over ONE table store (one agent's data)."""

    def __init__(self, store, registry=None, device=None):
        from pixie_tpu_torch.engine.executor import resolve_device

        if registry is None:
            from pixie_tpu_torch.udf import registry as registry  # noqa: PLW0127
        self.store = store
        self.registry = registry
        #: the device every fold's executor runs on
        self.device = resolve_device(device)
        self._views: dict[str, StandingView] = {}
        self._lock = threading.Lock()
        self._ticker = None
        _MANAGERS.add(self)
        _register_gauges()

    def set_snapshot_dir(self, path: Optional[str]) -> None:
        """Durable standing-state snapshots: refused (None is a no-op)."""
        if path:
            raise Unimplemented(
                "standing-view snapshots need table/journal.py's record framing, which "
                "is not ported yet (ROADMAP Queue 1 item 6b)")

    # ---------------------------------------------------------------- lookup
    def _resolve_table(self, head) -> Optional[Table]:
        try:
            t = self.store.table(head.table)
        except Exception:
            return None
        if head.tablet is not None:
            return None  # tablets are not ported (a non-TabletsGroup table)
        # Only plain Tables expose the row-id delta surface.
        return t if isinstance(t, Table) else None

    # ----------------------------------------------------------------- serve
    def serve(self, plan: Plan, mesh="auto", stale_ok: bool = False,
              miss: Optional[dict] = None):
        """Answer an eligible agent plan from standing state.

        Returns (channel, PartialAggBatch, info) on a view answer, or None
        when the caller must run the plan normally: matview disabled, plan
        ineligible, FIRST sight (registration only — the cold query path
        stays untouched), or a refresh that failed twice (fallback to full
        rescan; `miss`, where given, then receives {"hit": False, "reason":
        "refresh_failed", "error": ...}).  The returned batch is shared with
        the view and must be treated as immutable — every consumer (wire
        encode, combine, slice, finalize) already copies rather than
        mutates.

        `stale_ok` is the serving front's degradation hint: a
        view with standing state answers WITHOUT folding its pending delta
        (stale-while-revalidate — the next non-degraded sight or cron tick
        folds it), trading bounded staleness for zero scan work under load.
        """
        if not flags.get("PL_MATVIEW_ENABLED"):
            return None
        pref = match_prefix(plan, self.registry)
        if pref is None:
            return None
        table = self._resolve_table(pref.head)
        if table is None:
            return None
        key = view_key(pref)
        with self._lock:
            view = self._views.get(key)
            if view is None:
                # first sight: register only.  Anchoring the cursor NOW means
                # the second run folds [frontier-at-first-sight, head) — the
                # same rows the first run scanned plus whatever arrived since.
                self._views[key] = StandingView(key, pref, table)
                metrics.counter_inc(
                    "px_matview_misses_total",
                    labels={"reason": "register"},
                    help_="view lookups that could not serve standing state")
                return None
        t0 = time.perf_counter()
        errors: list = []
        with view.lock:
            info = self._refresh_locked(view, table, mesh=mesh, stale_ok=stale_ok,
                                        errors=errors)
            if info is None:
                with self._lock:
                    self._views.pop(key, None)
                metrics.counter_inc("px_matview_misses_total",
                                    labels={"reason": "refresh_failed"})
                if miss is not None:
                    miss.update(hit=False, reason="refresh_failed",
                                error=repr(errors[-1]) if errors else None)
                return None
            view.hits += 1
            view.last_access = time.monotonic()
            state = view.state
        self._evict_over_budget(keep=key)
        info["hit"] = True
        info["serve_ms"] = round((time.perf_counter() - t0) * 1000, 3)
        metrics.counter_inc("px_matview_hits_total",
                            help_="queries answered from standing view state")
        trace.event_span("matview_hit", time.time_ns(), 0, view=key,
                         rows_folded=info["rows_folded"],
                         groups=info["groups"])
        return pref.channel, state, info

    # --------------------------------------------------------------- refresh
    def _refresh_locked(self, view: StandingView, table, mesh="auto",
                        stale_ok: bool = False,
                        errors: Optional[list] = None) -> Optional[dict]:
        """Fold the unread delta into the standing state (view.lock held).
        Returns the refresh info dict, or None after two failed attempts
        (caller falls back to a full rescan through the normal path).  Only
        a fold that lost its table (NotFound, Unavailable) counts as failed,
        appended to `errors`; every other error propagates."""
        from pixie_tpu_torch.parallel.partial import combine_partials

        rebuilt = None
        for _attempt in range(2):
            st = view.cursor.status(table)
            if stale_ok and st == CURSOR_OK and view.state is not None:
                # stale-while-revalidate: serve the standing state as-is; the
                # pending delta stays unread for the next healthy refresh.
                # Only a CURSOR_OK view may do this — an invalidated cursor
                # means the state covers rows a cold scan couldn't see.
                lo, hi = view.cursor.delta_bounds(table)
                view.stale_serves += 1
                metrics.counter_inc(
                    "px_matview_stale_serves_total",
                    help_="degraded-mode view answers that skipped the "
                          "delta fold (stale-while-revalidate)")
                return {
                    "view": view.key,
                    "rows_folded": 0,
                    "stale": True,
                    "stale_pending_rows": int(max(hi - lo, 0)),
                    "refresh_ms": 0.0,
                    "groups": view.state.num_groups,
                    "state_bytes": view.state_bytes,
                    "watermark": view.cursor.watermark,
                    "rebuilt": rebuilt,
                }
            if st != CURSOR_OK:
                rebuilt = st
                metrics.counter_inc(
                    "px_matview_invalidations_total",
                    labels={"reason": st},
                    help_="standing views reset (schema change, "
                          "retention trimming, dead cursor)")
                table = self._resolve_table(view.prefix.head)
                if table is None:
                    return None
                view.cursor.rebase(table)
                view.state = None
                view.rebuilds += 1
            lo, hi = view.cursor.delta_bounds(table)
            rows = h2d = 0
            tr0 = time.perf_counter()
            folded = hi > lo or view.state is None
            if folded:
                with trace.span("matview_refresh", view=view.key,
                                since_row_id=lo, stop_row_id=hi):
                    try:
                        delta, rows, h2d = self._compute_partial(
                            view.prefix, lo, hi, mesh)
                    except (NotFound, Unavailable) as e:
                        if errors is not None:
                            errors.append(e)
                        return None
                    view.state = (
                        delta if view.state is None else combine_partials(
                            view.prefix.agg, [view.state, delta],
                            self.registry))
                view.cursor.advance(hi)
                view.refreshes += 1
                view.rows_folded += rows
                metrics.counter_inc(
                    "px_matview_refresh_rows_total", float(rows),
                    help_="delta rows folded into standing view state")
            # post-fold check: if expiry raced the fold (trimmed past base
            # while we scanned), the state is tainted — rebuild once.
            if view.cursor.status(table) == CURSOR_OK:
                out = {
                    "view": view.key,
                    "rows_folded": rows,
                    "refresh_ms": round((time.perf_counter() - tr0) * 1000, 3),
                    "groups": view.state.num_groups,
                    "state_bytes": view.state_bytes,
                    "watermark": view.cursor.watermark,
                    "rebuilt": rebuilt,
                    "h2d_bytes": h2d,
                }
                if folded:
                    # only re-walk the state when it actually changed: the
                    # size walk is O(groups) Python (str() per object key),
                    # too slow for the empty-delta poll hot path
                    view.state_bytes = _pb_nbytes(view.state)
                    out["state_bytes"] = view.state_bytes
                return out
            rebuilt = view.cursor.status(table)
        return None

    def _compute_partial(self, pref: ViewPrefix, lo: int, hi: int, mesh) -> tuple:
        """Run the prefix over rows [lo, hi) on the manager's device →
        (PartialAggBatch on the host, rows scanned, bytes uploaded)."""
        from pixie_tpu_torch.engine.executor import PlanExecutor

        p = Plan()
        head = copy.copy(pref.head)
        head.id = -1
        head.since_row_id = lo
        head.stop_row_id = hi
        node = p.add(head)
        for op in pref.chain:
            c = copy.copy(op)
            c.id = -1
            node = p.add(c, parents=[node])
        agg = copy.copy(pref.agg)
        agg.id = -1
        agg.partial = True
        p.add(agg, parents=[node])
        p.add(ResultSinkOp(channel="mv", payload="agg_state"), parents=[agg])
        ex = PlanExecutor(p, self.store, self.registry, device=self.device, mesh=mesh)
        out = ex.run_agent()
        return (out["mv"], int(ex.stats.get("rows_scanned", 0)),
                int(ex.stats.get("h2d_bytes", 0)))

    def refresh_all(self) -> int:
        """Fold pending deltas for every registered view (the cron tick).
        Returns how many views refreshed cleanly; failing views drop (they
        re-register on next sight)."""
        with self._lock:
            views = list(self._views.values())
        ok = 0
        for view in views:
            table = self._resolve_table(view.prefix.head)
            with view.lock:
                info = (self._refresh_locked(view, table)
                        if table is not None else None)
                if info is None:
                    with self._lock:
                        self._views.pop(view.key, None)
                    continue
            ok += 1
        self._evict_over_budget()
        return ok

    # -------------------------------------------------------------- eviction
    def state_bytes(self) -> int:
        with self._lock:
            return sum(v.state_bytes for v in self._views.values())

    def _evict_over_budget(self, keep: Optional[str] = None) -> None:
        """LRU eviction down to the PL_MATVIEW_MAX_STATE_MB budget."""
        budget = int(flags.get("PL_MATVIEW_MAX_STATE_MB")) << 20
        with self._lock:
            total = sum(v.state_bytes for v in self._views.values())
            for v in sorted(self._views.values(), key=lambda v: v.last_access):
                if total <= budget:
                    break
                # the just-served view survives LRU unless it ALONE busts the
                # budget — retaining an oversized view would evict everything
                # else and still be over budget on its next refresh
                if v.key == keep and v.state_bytes <= budget:
                    continue
                self._views.pop(v.key, None)
                total -= v.state_bytes
                metrics.counter_inc(
                    "px_matview_evictions_total",
                    help_="standing views evicted by the state byte budget")

    # --------------------------------------------------------------- ambient
    def stats(self) -> list[dict]:
        with self._lock:
            return [v.stats() for v in self._views.values()]

    def start_refresher(self, interval_s: Optional[float] = None):
        """Background cron-tick refresh (services.cron.Ticker)."""
        from pixie_tpu_torch.services.cron import Ticker

        if interval_s is None:
            interval_s = float(flags.get("PL_MATVIEW_REFRESH_S"))
        if interval_s <= 0 or self._ticker is not None:
            return self
        self._ticker = Ticker("matview-refresh", interval_s,
                              self.refresh_all).start()
        return self

    def stop_refresher(self) -> None:
        if self._ticker is not None:
            self._ticker.stop()
            self._ticker = None
