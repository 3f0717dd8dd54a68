"""Whole-query plan cache: the interactive warm-query fast path.

Flare's lesson (PAPERS.md): once kernels are fast, the remaining interactive
latency is per-query host overhead — for us, re-exec'ing the PxL script
against tracer objects, re-running optimizer passes, re-splitting the plan
across agents, and re-serializing the per-agent plan dicts on EVERY query of
a dashboard that reissues the same script every few seconds.  All of that is
a pure function of (script text, entry-point params, schema set), so the
broker and LocalCluster memoize it here.

Soundness:

  * The compiled plan is cached only when compilation never read the query
    timestamp (``CompiledQuery.now_sensitive`` — relative time ranges and
    px.now() bake ``now`` into the plan) and produced no mutations
    (tracepoint deploys have registration side effects).
  * The cache key carries a schema fingerprint supplied by the caller
    (broker: registry epoch; LocalCluster: per-store ``TableStore.epoch``),
    so any table create/drop/re-register misses.  DATA changes never matter:
    plans reference tables by name, not contents.
  * Distributed splits are cached per (plan, split fingerprint) inside the
    entry — the split depends only on the plan and the cluster topology.
  * Cached plans are immutable by construction (the executor and planner
    only read them), so a cache hit is bit-identical to a recompile; the
    ``PL_QUERY_FASTPATH`` flag turns the whole cache off for A/B proof.

Copied from the reference package (pixie_tpu/engine/plancache.py): the
QueryPlanCache, with its per-tenant namespaces (PL_TENANT_ISOLATION: the
broker's tenants, services/broker.py), the admission gate's `contains` peek
and the hit/miss counters, kept on the instance and exported as metrics.
Also here: the native whole-plan program cache (`native_programs`,
native/codegen.py).
"""
from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Callable, Optional

from pixie_tpu_torch import flags as _flags
from pixie_tpu_torch import metrics as _metrics

_flags.define_bool(
    "PL_QUERY_FASTPATH", True,
    "whole-query plan cache: warm interactive queries skip re-trace/"
    "re-analyze/re-split (bit-equal to the slow path by construction)",
)
_flags.define_bool(
    "PL_TENANT_ISOLATION", True,
    "namespace plan-cache state per tenant (key prefix + per-namespace LRU "
    "budgets) so one tenant's warm plans cannot be evicted by another's; 0 "
    "restores the shared cache",
)

#: entries per tenant NAMESPACE per cache instance; a dashboard rotates
#: through a handful of scripts, so this is generous.  A noisy tenant fills
#: only its own namespace — other tenants' entries never evict for it.
MAX_ENTRIES = 64

#: hard global bound across all namespaces (memory safety against a flood
#: of distinct tenant ids)
MAX_TOTAL_ENTRIES = MAX_ENTRIES * 8


def enabled() -> bool:
    return bool(_flags.get("PL_QUERY_FASTPATH"))


def _freeze(obj) -> str:
    """Canonical hashable form of entry-point params (wire-json shaped)."""
    try:
        return json.dumps(obj, sort_keys=True, default=repr)
    except Exception:
        return repr(obj)


class _Entry:
    __slots__ = ("query", "split")

    def __init__(self, query):
        self.query = query
        #: (split fingerprint, (dp, extras dict built by the caller's
        #: split_fn — e.g. pre-serialized per-agent plan JSON)).  Both call
        #: sites bake the fingerprint into the entry's cache key too, so a
        #: single slot suffices; storing the fp keeps that invariant
        #: checked (a mismatched fp recomputes) instead of assumed.
        self.split: Optional[tuple] = None


class QueryPlanCache:
    """One per broker / LocalCluster instance (schema fingerprints are
    caller-scoped, so instances must not share entries)."""

    def __init__(self, max_entries: int = MAX_ENTRIES):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._max = max_entries
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(source: str, func, func_args, default_limit, schemas_fp,
            tenant=None) -> tuple:
        """Cache key; the leading slot is the tenant NAMESPACE ("" = shared).
        With PL_TENANT_ISOLATION on, tenants never share entries (and never
        evict each other's — see get_query's per-namespace budget)."""
        ns = (tenant if tenant and _flags.get("PL_TENANT_ISOLATION") else "")
        return (ns, source, func, _freeze(func_args), default_limit,
                _freeze(schemas_fp))

    def contains(self, key: tuple) -> bool:
        """Non-mutating peek (no LRU touch, no counters): the admission
        gate's warm/cold cost estimate must not skew hit/miss accounting."""
        if not enabled():
            return False
        with self._lock:
            return key in self._entries

    def get_query(self, key: tuple, compile_fn: Callable):
        """→ (CompiledQuery, _Entry | None, hit: bool).

        On miss, runs ``compile_fn()`` and caches the result when it is
        cacheable (now-insensitive, mutation-free).  The returned entry is
        None when fastpath is off or the query is uncacheable — callers then
        skip split caching too.
        """
        if not enabled():
            return compile_fn(), None, False
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
        if entry is not None:
            _metrics.counter_inc(
                "px_query_plan_cache_hits_total",
                help_="warm queries served from the whole-query plan cache")
            return entry.query, entry, True
        _metrics.counter_inc(
            "px_query_plan_cache_misses_total",
            help_="queries that paid the full compile/optimize path")
        q = compile_fn()
        if getattr(q, "now_sensitive", True) or getattr(q, "mutations", None):
            return q, None, False
        entry = _Entry(q)
        with self._lock:
            self._entries[key] = entry
            # per-namespace LRU budget: evict the oldest entry of THIS
            # key's namespace when it outgrows its own allowance, so one
            # tenant's churn cannot evict another tenant's warm plans
            ns = key[0]
            ns_keys = [k for k in self._entries if k[0] == ns]
            if len(ns_keys) > self._max:
                self._entries.pop(ns_keys[0], None)
            while len(self._entries) > MAX_TOTAL_ENTRIES:
                self._entries.popitem(last=False)
        return q, entry, False

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    @staticmethod
    def get_split(entry: Optional[_Entry], split_fp, split_fn: Callable):
        """→ ((dp, extras), hit).  ``split_fn()`` must return (dp, extras);
        cached per entry keyed by the caller's topology fingerprint."""
        if entry is None:
            return split_fn(), False
        got = entry.split
        if got is not None and got[0] == split_fp:
            return got[1], True
        val = split_fn()
        # last-writer-wins on a race: both racers computed identical values
        entry.split = (split_fp, val)
        return val, False


class NativeProgramCache:
    """Lowered whole-plan micro-programs (native/codegen.py) keyed by the
    executor's structural signature of the chain, the aggregate and its
    group keys (`executor._native_sig`): everything a program bakes in —
    column names and dtypes, predicates, key kinds, cards, widths and LUT
    names, the UDAs and their input dtypes.  `None` results are cached too:
    an ineligible plan must not pay the lowering walk on every query."""

    MAX = 256

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()

    def get_or_lower(self, sig, lower_fn):
        """→ lowered program or None.  Uncacheable signatures (sig None)
        lower fresh every call — the walk is cheap relative to a query."""
        if sig is None:
            return lower_fn()
        with self._lock:
            if sig in self._entries:
                self._entries.move_to_end(sig)
                return self._entries[sig]
        prog = lower_fn()
        with self._lock:
            self._entries[sig] = prog
            while len(self._entries) > self.MAX:
                self._entries.popitem(last=False)
        return prog

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


#: process-wide program cache (programs are structural — no per-store data)
native_programs = NativeProgramCache()
