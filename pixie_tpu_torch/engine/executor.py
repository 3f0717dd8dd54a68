"""Plan executor, aggregate path: Source → (Map|Filter|Limit)* → Agg → Sink.

This replaces the reference's push-based ExecutionGraph interpreter
(src/carnot/exec/exec_graph.cc:177-295): every maximal Source→(Map|Filter|
Limit)*→Agg chain becomes ONE chain kernel — chain programs (kernel C1) feeding
the hand-written CUDA kernels (K1 masked segment reductions, K2 sketch update)
— run over coalesced column feeds.  Filters never compact on the device: they
refine a validity mask.  The aggregate state lives on the device and
accumulates IN PLACE across feeds (every UDA update writes into its state
tensors); then one launch of kernel F2 (ops/finalize.py) finalizes it where a
UDA can (sketch → quantiles) and packs the results and the rest of the state
into one buffer, read back in one copy.  A query whose snapshot is one feed
runs whole as one launch of kernel F1: the chain, the updates of a fresh
state, the finalize and the pack (stat fused_single_feed).  Limit queries
keep K3 for the quantiles.

Group-by strategy (see ops/groupby.py): every key must be reducible to a dense
code — dictionary columns natively, raw int columns via a query-time dictionary
built in a host pre-scan of the cursor snapshot, and `px.bin(time)`-derived
window keys via range arithmetic.

Select sinks (a chain of map/filter/limit feeding a sink) run the same chain
through an output step: kernel K4 (ops/compact.py) compacts the kept rows of
every output column to the front on the device, and the host reads back
exactly `count` rows per feed, pipelined (engine/transfer.py).  Joins
materialize both parents on the host, factorize the keys there, and match
either on the host or, past the reference's size gate, with kernels J1-J3
(ops/join_device.py).

Sealed feeds are served first from the device-resident tier
(engine/resident.py), then from the HBM feed cache below, and only then
uploaded: a warm query moves zero host→device bytes.  Group keys with no
bounded dense code (computed numeric keys, float keys, more than MAX_GROUPS
groups) take the sorted fallback: the host factorizes the composite key and
the device reduces over exact group ids in SORT_AGG_CHUNK-row chunks.

Agent plans of a distributed query (parallel/cluster.py) run through
`run_agent`: each agg_state channel ships its partial aggregate as seen-group
key VALUES plus raw UDA state (`_partial_agg_batch`), never finalized; a raw
state reads back packed by kernel P1 into one buffer (transfer.pull_states).
With `defer_agg_pull` set the state stays on the device (`_DeferredPartial`)
and the cluster merges every agent's state there in one launch of kernel M1
(`gang_merge_states`, ops/merge.py) when their layouts agree; M1 writes the
merged state packed, so its readback is one copy with no P1.  The merger
plan reads the merged channels through RemoteSourceOps (`inputs`).

Every chain's row mask, group ids and computed columns come from chain
programs (ops/chain.py): kernel C1 on the card, one launch per chain segment
and feed, the plain interpreter on the CPU.  A LimitOp splits a chain into
segments joined by a torch cumsum.  A value that cannot lower to a program
enters C1 as a leaf column computed by its torch closure
(exec_stats["chain_leaves"]).

Ported so far are the aggregate, select, join, sorted-fallback and
distributed agent paths of the reference executor
(pixie_tpu/engine/executor.py), with `run_agent_stream` (the chunk stream
the streaming fold consumes) and the streaming polls of engine/stream.py.
A union materializes each parent on the host (a filtered scan through C1
and K4), maps every dictionary column onto the first parent's dictionary
and concatenates the parts; an aggregate over a union uploads that host
batch.  UDTF sources raise Unimplemented and name the slice that brings
them.  The agent plan of a batched query (serving/batching.py) holds several
partial aggregates over one shared scan: they run as a multi-query gang
(`_gang_agg_payloads`, `_multi_partial_agg`), one launch of kernel G1
(ops/gang.py) per feed for every member, under PX_MQ_FUSION (auto: on for a
CUDA executor).

With a mesh (parallel/spmd.py: `mesh=make_mesh(n)`, or "auto" for the
default mesh, None by default), every unlimited aggregate shards each feed
row-wise over the mesh's co-located shards: each shard runs its chain
program (C1) and UDA kernels (K1, K2) — or, in a gang, G1 — into its own
state, in place across the query's feeds, and F2 merges the shards'
states as it finalizes them (a partial aggregate's shards merge by M1).
The reference instead merges once per feed; add, min and max are
associative, so the results agree.  Sealed feeds come from the resident
tier's sharded entry (keyed by the mesh width).  A partition sink (the producer half of a repartitioned
join) exchanges its rows in the mesh (kernels X1, X2) when the mesh width is
the partition count, else on the host (parallel/repartition.py).

The host layers (pixie_tpu/engine/executor.py's own hooks): every sink's
relation carries the semantic types the plan propagates from its sources
(engine/semantics.py `sink_relation`).  With tracing on (PL_TRACING_ENABLED)
every scan path bumps the shard-heat model (table/heat.py) with the tier that
served each feed — resident, hbm_cache (the feed cache), stream or cold —
from host metadata only, and the operator frames become trace spans;
`sync_op_timing` (EXPLAIN ANALYZE) synchronizes a CUDA device at both ends
of every frame.  A tabletized table (table/tablets.py) is read one tablet at
a time (`MemorySourceOp.tablet`: the tablet's own Table) or chained, its
gens (tablet, gen) pairs, so the feed cache never answers one tablet with
another's feed and the resident tier declines the chain.  A cold-tier batch
(table/lifecycle.py) is decoded when the scan reaches it, fed apart from the
RAM batches, uploaded fresh every scan (never cached) and counted toward its
promotion back to RAM.

Routing (the reference's `_route_backend` / `_backend_for`): an aggregate
whose input rows times `route_scale` (the agents running the fragment) are
at most PX_CPU_CROSSOVER_ROWS takes the CPU arm, and under PX_AUTOTUNE the
cpu_crossover cost model (engine/autotune.py) picks the arm with that
static decision as its default.  The CPU arm is the reference's host fast
paths and nothing else: the np_partial loop (engine/np_partial.py), then
the native whole-plan loop (native/codegen.py); a CPU-routed query neither
admits runs the card route.  Neither runs over a mesh, and a multi-query
gang declines when its first member is CPU-routed.  On a CUDA device the
host arms (the CPU route and the join gate's host arm) stay off while the
crossover is 0, the H100 sweep's answer: no size routes there and no
autotune probe runs there.  `force_backend` ("cpu" or "device") pins the
arm, the join gate's static decision with it; streaming polls pin the
card.  exec_stats carries the decisions ("autotune"), the fast-path
counts (np_fast_polls, wholeplan_native) and a route for each aggregate
chain ("routes").  On the card no query runs the plain PyTorch versions of
the kernels: those are a CPU executor's card route (the tests').
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import hashlib
import json
import threading
import time as _time
from typing import Callable, Optional

import numpy as np
import torch

from pixie_tpu_torch import flags as _flags
from pixie_tpu_torch.engine import autotune as _autotune
from pixie_tpu_torch.engine import np_partial, resident, transfer
from pixie_tpu_torch.engine.eval import ExprCompiler, SVal, apply_lut_np
from pixie_tpu_torch.engine.result import QueryResult
from pixie_tpu_torch.engine.semantics import sink_relation
from pixie_tpu_torch.native import build as _native_build
from pixie_tpu_torch.native import codegen as _codegen
from pixie_tpu_torch.ops import chain as _chain
from pixie_tpu_torch.ops import finalize as _fin
from pixie_tpu_torch.ops import gang as _gang
from pixie_tpu_torch.ops import join_device as _jd
from pixie_tpu_torch.ops.compact import compact
from pixie_tpu_torch.ops.groupby import next_pow2, split_codes
from pixie_tpu_torch.ops.merge import merge_states
from pixie_tpu_torch.plan.plan import (
    AggOp,
    Call,
    Column,
    FilterOp,
    JoinOp,
    LimitOp,
    Literal,
    MapOp,
    MemorySinkOp,
    MemorySourceOp,
    PartitionSinkOp,
    Plan,
    RemoteSourceOp,
    ResultSinkOp,
    UnionOp,
)
from pixie_tpu_torch.status import CompilerError, Internal, InvalidArgument, Unavailable, Unimplemented
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.table.table import Table
from pixie_tpu_torch.types import STORAGE_DTYPE, DataType as DT
from pixie_tpu_torch.udf.udf import CountUDA, to_torch_dtype, tree_map

INT64_MIN = int(np.iinfo(np.int64).min)
INT64_MAX = int(np.iinfo(np.int64).max)
MAX_GROUPS = 1 << 22
#: Sorted-fallback device reduction chunk (rows per update step).
SORT_AGG_CHUNK = 1 << 20
#: Minimum window-bin bucket: keeps the group space stable across streaming
#: polls whose deltas span few windows.
MIN_WINDOW_BINS = 1 << 6

#: All-null sentinel for dict-valued pickers: equals the int32 min identity so
#: an all-null group's state stays at the identity and decodes null.
PICKER_NULL_SENTINEL = int(np.iinfo(np.int32).max)

#: Feed coalescing target: sealed storage batches (64K rows, the reference's
#: compaction granularity) are merged into large device feeds, as in the
#: reference (PX_FEED_ROWS, 16M rows).
FEED_ROWS = _flags.define_int(
    "PX_FEED_ROWS", 1 << 24, "feed coalescing target (rows per device feed)"
)


#: multi-query gang: the distinct partial aggregates of one shared scan (the
#: fused-batch agent-plan shape, serving/batching.py) run as ONE launch of
#: kernel G1 per feed, and the whole gang reads back in one transfer wave
_flags.define_int(
    "PX_MQ_FUSION", -1,
    "run sibling partial-agg chains sharing one scan as one multi-query gang "
    "(kernel G1, one launch per feed): -1 = auto (on iff the executor's "
    "device is CUDA), 0 = never, 1 = always (the plain version of G1 on the "
    "CPU: tests)")


def mq_fusion_enabled(device) -> bool:
    """Whether an executor on `device` runs the multi-query gang
    (PX_MQ_FUSION): auto means the executor's own device is CUDA, the port's
    counterpart of the reference's "a real accelerator backs the dispatch"."""
    v = int(_flags.get("PX_MQ_FUSION"))
    if v == 0:
        return False
    if v >= 1:
        return True
    return torch.device(device).type == "cuda"


# --------------------------------------------------------------- CPU route
#: Inputs of at most this many rows (times the executor's route_scale) run
#: on the CPU route: the host fast paths (engine/np_partial.py, the native
#: whole-plan loop native/codegen.py), with no upload, no launch and no
#: readback.  The value is the largest size of chip_smoke.py's cpu_route
#: sweep (config #1 over 2^14 ... 2^24 rows) at which the CPU route's warm
#: median beat the card's, and the card won at every size: 0 (at 2^14 rows
#: 2.17 ms on the CPU route against 1.66 on the card), on "NVIDIA H100 80GB
#: HBM3, 700.00 W" (PERF.md, the cpu_route sweep).  So only an empty input
#: takes the CPU route by default, and a CUDA executor consults no autotune
#: model for its host arms while the value is 0 (PlanExecutor._host_arms_live).
CPU_CROSSOVER_ROWS = _flags.define_int(
    "PX_CPU_CROSSOVER_ROWS", 0,
    "inputs at/below this row count (times the executor's route_scale) run "
    "on the CPU route: the host fast paths, no card")

#: the two arms of the route (autotune's cpu_crossover gate)
CPU, DEVICE = "cpu", "device"


def _src_rows(src) -> Optional[int]:
    if isinstance(src, HostBatch):
        return src.num_rows
    try:
        return src.num_rows()
    except Exception:
        return None


def _route_backend(src, scale: int = 1) -> str:
    """Arm for this input by size.  `scale` is the distributed fan-out (the
    agents running the same fragment): routing must consider the QUERY's
    size, not the local shard's — 8 agents each holding 2M rows are a
    16M-row query."""
    n = _src_rows(src)
    if n is not None and n * max(1, scale) <= int(_flags.get("PX_CPU_CROSSOVER_ROWS")):
        return CPU
    return DEVICE


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another device.  With no device given and no CUDA card it raises — it
    never carries on on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise Unavailable(
                "no CUDA device is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _dict_fingerprint(d) -> int:
    """Content hash of a Dictionary (process-local, as the state merge that
    reads it is)."""
    return hash(tuple(str(v) for v in d.values()))


def _decode_picker_codes(vals, d: Dictionary) -> np.ndarray:
    """Picker state codes → int32 dictionary codes; out-of-range (all-null
    sentinel) becomes -1 (null)."""
    codes = np.asarray(vals, dtype=np.int64)
    return np.where((codes < 0) | (codes >= d.size), -1, codes).astype(np.int32)


class GroupKeyFallback(Unimplemented):
    """Raised when group keys are not expressible as bounded dense codes
    (computed numeric keys, float keys, cardinality beyond MAX_GROUPS).
    The executor catches it and reruns the aggregate through the sort-based
    path (`_run_agg_sorted`)."""


# ------------------------------------------------------------ key uniques
#: (table uid, column) → (sorted unique values, scanned-from row id,
#: scanned-to row id).  Tables are append-only (expiry only drops rows), so
#: the set is maintained incrementally: each refresh scans only rows past the
#: watermark.
_KEY_UNIQUES: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_KEY_UNIQUES_MAX = 64
#: beyond this cardinality the set stops being tracked; monotonic, so the
#: overflow mark is permanent
_KEY_UNIQUES_CAP = MAX_GROUPS
_KEY_OVERFLOW = "overflow"
_CACHE_LOCK = threading.Lock()


def _int_key_uniques(table, col: str, src) -> Optional[np.ndarray]:
    """Cumulative sorted unique values of `col` over a contiguous covered
    row-id range [lo, hi), extended/rebased from THIS query's snapshot cursor.

    Scanning the live table instead of the snapshot would race ring-buffer
    expiry: a value pinned in the query's feed could be missing from the
    fresh scan and searchsorted would silently fold its rows into a
    neighboring group.  Rows are immutable and row ids monotone, so values
    inside [lo, hi) were observed live by the scan that covered them — any
    snapshot whose rows all sit in [lo, hi) gets a valid (possibly strict
    superset) value set.  Returns None when the set overflows
    _KEY_UNIQUES_CAP (caller prescans this query's snapshot instead).

    Coverage rules:
      * time-bounded cursors skip whole live batches — they neither consult
        nor update the cache (caller prescans this query's own snapshot);
      * a cursor reaching BELOW lo (an old pinned snapshot after a rebase)
        gets None — its rows may hold values the cache never saw;
      * a cursor starting past hi (expiry gap [hi, start) was never scanned)
        REBASES the entry to its own contiguous coverage.
    """
    if (getattr(src, "start_time", None) is not None
            or getattr(src, "stop_time", None) is not None):
        return None
    if getattr(src, "since_row_id", None) is None:
        return None  # not a table Cursor — no coverage guarantee
    items = [(rb, rid) for rb, rid, _gen in src]
    key = (table.uid, col)
    with _CACHE_LOCK:
        entry = _KEY_UNIQUES.get(key)
    vals, lo, hi = entry if entry is not None else (None, 0, 0)
    if vals is _KEY_OVERFLOW:
        return None
    cfirst = min((rid for _rb, rid in items), default=None)
    if cfirst is None:  # empty snapshot: nothing to encode, superset is fine
        return vals if vals is not None else np.empty(0, dtype=np.int64)
    if vals is not None and cfirst < lo:
        return None  # pinned rows below cached coverage: prescan, keep entry
    rebase = vals is None or cfirst > hi
    parts = [] if rebase else [vals]
    cover = cfirst if rebase else hi
    base_lo = cfirst if rebase else lo
    changed = rebase
    for rb, rid in items:  # a cursor's batches are row-contiguous
        end = rid + rb.num_valid
        if end <= cover:
            continue
        if rid > cover:
            return None  # non-contiguous cursor (unexpected): refuse
        off = max(0, cover - rid)
        arr = rb.columns[col][off: rb.num_valid]
        if len(arr):
            parts.append(np.unique(arr))
            changed = True
        cover = end
    if changed:
        vals = (np.unique(np.concatenate(parts)) if parts
                else np.empty(0, dtype=np.int64))
        with _CACHE_LOCK:
            if len(vals) > _KEY_UNIQUES_CAP:
                _KEY_UNIQUES[key] = (_KEY_OVERFLOW, base_lo, cover)
                return None
            _KEY_UNIQUES[key] = (vals, base_lo, cover)
            while len(_KEY_UNIQUES) > _KEY_UNIQUES_MAX:
                _KEY_UNIQUES.popitem(last=False)
    return vals


# ------------------------------------------------------------ device feed cache
# Sealed batches are immutable, so their assembled, padded device feeds are
# cached keyed by the seal gens (and the columns and device): a repeat query
# then moves ZERO bytes host→device.  The resident tier (engine/resident.py)
# sits above it and is tried first.
_DEVICE_CACHE: "collections.OrderedDict[tuple, dict]" = collections.OrderedDict()
_DEVICE_CACHE_BYTES = 0
_flags.define_int(
    "PIXIE_TPU_DEVICE_CACHE_MB", 4096,
    "HBM feed cache budget (MB); the PEM table-memory-budget analog")


def _cols_nbytes(cols: dict) -> int:
    return sum(v.numel() * v.element_size() for v in cols.values())


def _device_cache_max() -> int:
    return int(_flags.get("PIXIE_TPU_DEVICE_CACHE_MB")) << 20


def _device_cache_get(key):
    with _CACHE_LOCK:
        got = _DEVICE_CACHE.get(key)
        if got is not None:
            _DEVICE_CACHE.move_to_end(key)
        return got


def _device_cache_put(key, cols: dict):
    global _DEVICE_CACHE_BYTES
    nbytes = _cols_nbytes(cols)
    cap = _device_cache_max()
    if nbytes > cap:
        return
    with _CACHE_LOCK:
        old = _DEVICE_CACHE.pop(key, None)  # (two queries may race to put a key)
        if old is not None:
            _DEVICE_CACHE_BYTES -= _cols_nbytes(old)
        _DEVICE_CACHE[key] = cols
        _DEVICE_CACHE_BYTES += nbytes
        while _DEVICE_CACHE_BYTES > cap and _DEVICE_CACHE:
            _k, v = _DEVICE_CACHE.popitem(last=False)
            _DEVICE_CACHE_BYTES -= _cols_nbytes(v)


def _device_cache_pop(key):
    """Drop one entry (the resident tier adopted its buffers — keeping both
    would pin the same bytes twice)."""
    global _DEVICE_CACHE_BYTES
    with _CACHE_LOCK:
        got = _DEVICE_CACHE.pop(key, None)
        if got is not None:
            _DEVICE_CACHE_BYTES -= _cols_nbytes(got)


def clear_device_cache():
    global _DEVICE_CACHE_BYTES
    with _CACHE_LOCK:
        _DEVICE_CACHE.clear()
        _DEVICE_CACHE_BYTES = 0


def device_luts(luts: dict, device: torch.device) -> dict:
    """A chain's LUTs ({name: numpy array}) on `device`.  On a CUDA device
    each is an entry of the feed cache, keyed by its contents (a digest):
    a warm query's LUTs (a group key's sorted values, a dictionary's
    translation) are the last query's, so it uploads none; under the
    cache's budget, counted in its stats, off with it.  LUTs are read-only
    on the device."""
    if device.type != "cuda":
        return {k: torch.as_tensor(v).to(device) for k, v in luts.items()}
    out = {}
    for name, v in luts.items():
        a = np.ascontiguousarray(v)
        key = ("lut", str(device), a.dtype.str, a.shape,
               hashlib.blake2b(a, digest_size=16).digest())
        got = _device_cache_get(key)
        if got is None:
            got = {"lut": torch.as_tensor(a).to(device)}
            _device_cache_put(key, got)
        out[name] = got["lut"]
    return out


def device_cache_stats() -> dict:
    with _CACHE_LOCK:
        return {"entries": len(_DEVICE_CACHE), "bytes": _DEVICE_CACHE_BYTES}


# --------------------------------------------------------------------- batches


@dataclasses.dataclass
class HostBatch:
    """Materialized intermediate (compacted, host numpy)."""

    dtypes: dict[str, DT]
    dicts: dict[str, Dictionary]
    cols: dict[str, np.ndarray]

    @property
    def num_rows(self) -> int:
        for v in self.cols.values():
            return len(v)
        return 0


# ----------------------------------------------------------------- group keys


@dataclasses.dataclass
class GroupKey:
    name: str
    kind: str  # "dict" | "intdevice" | "window"
    card: int  # pow2-bucketed static cardinality
    out_dtype: DT
    dictionary: Optional[Dictionary] = None  # dict/intdevice
    #: source column the intdevice key reads (differs from `name` when a Map
    #: renamed the column).
    src_name: str = ""
    # window params
    width: int = 0
    t0_bin: int = 0
    key_sval: Optional[SVal] = None  # device codes builder (dict/window)
    #: intdevice: the luts entry holding the sorted unique values (a binary
    #: search in it maps value → code on the device); window: the name of
    #: the runtime scalar holding the window origin
    lut_name: str = ""


class _ChainCtx:
    """Symbolic column environment threaded through a chain of transforms."""

    def __init__(
        self,
        dtypes: dict[str, DT],
        dicts: dict[str, Dictionary],
        registry,
        device,
        visible: Optional[list[str]] = None,
    ):
        self.sym: dict[str, SVal] = {}
        self.provenance: dict[str, object] = {}
        #: default output columns — the fed columns minus internals (e.g. a
        #: time_ column fetched only to evaluate row-level time bounds).
        self.visible: list[str] = list(visible) if visible is not None else list(dtypes)
        self.registry = registry
        self.ec = ExprCompiler(dtypes, dicts, registry, device)
        # Seed with input columns.
        for name, dt in dtypes.items():
            self.sym[name] = self.ec.compile(Column(name))
            self.provenance[name] = Column(name)
        # Redirect column resolution to the evolving symbolic env.
        self.ec._compile_column = self._resolve_column  # type: ignore[method-assign]

    def _resolve_column(self, expr: Column) -> SVal:
        v = self.sym.get(expr.name)
        if v is None:
            raise CompilerError(f"column {expr.name!r} not found; have {sorted(self.sym)}")
        return v

    def apply_map(self, op: MapOp):
        new_sym = {}
        new_prov = {}
        for name, expr in op.exprs:
            new_sym[name] = self.ec.compile(expr)
            # Track one level of provenance for window-key detection, resolving
            # pass-through renames to their origin.
            if isinstance(expr, Column):
                new_prov[name] = self.provenance.get(expr.name, expr)
            else:
                new_prov[name] = expr
        self.ec._memo.clear()  # column meanings changed; don't reuse SVals
        self.sym = new_sym
        self.provenance = new_prov
        self.visible = [n for n, _ in op.exprs]

    def compile_predicate(self, op: FilterOp) -> SVal:
        v = self.ec.compile(op.expr)
        if v.dtype != DT.BOOLEAN:
            raise CompilerError(f"filter expression has type {v.dtype.name}, want BOOLEAN")
        return v


# ---------------------------------------------------------------- chain kernel


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """A per-row tensor of length n (a literal's 0-dim value is broadcast and
    made contiguous, as the kernels take only contiguous rows)."""
    return t.expand(n).contiguous() if t.dim() == 0 else t


#: binding names of the inputs a chain segment reads besides the feed: the
#: previous segment's mask and its running count, and the limit budgets
_MASK_IN, _CSUM_IN, _LIMITS = "__mask_in", "__csum", "__limits"


@dataclasses.dataclass
class _Segment:
    """One C1 launch of a chain: its interned program and what its slots
    bind to."""

    prog: _chain.Program
    binding: _chain.Binding


class ChainKernel:
    """Compiles Source → transforms → agg (or an output step) into chain
    programs run by kernel C1 (ops/chain.py).

    Each LimitOp splits the chain into segments, one C1 launch each: the
    first forms the base mask (valid rows, time bounds) and applies the
    filters before the first limit; a limit takes a torch cumsum of the mask
    and the next segment admits the rows whose running count fits the
    limit's remaining budget (a device vector: no host sync), then applies
    its own filters.  The last segment also builds the group ids and every
    computed value column; plain column references pass through."""

    def __init__(
        self,
        in_dtypes: dict[str, DT],
        in_dicts: dict[str, Dictionary],
        transforms: list,
        registry,
        time_col: Optional[str],
        device,
        visible: Optional[list[str]] = None,
        nan_bin: int = 1,
    ):
        self.device = torch.device(device)
        #: the sketch bin of a NaN value (ops/sketch.py bin_index)
        self.nan_bin = nan_bin
        self.ctx = _ChainCtx(in_dtypes, in_dicts, registry, self.device, visible)
        self.in_dtypes = dict(in_dtypes)
        self.registry = registry
        self.time_col = time_col
        self.steps = []  # ("filter", sval); ("limit", i)
        #: per-LimitOp budgets, in chain order — each limit step tracks its OWN
        #: remaining budget (a single min-collapsed budget under-returns when a
        #: filter between two limits drops admitted rows).
        self.limit_ns: list[int] = []
        #: values of the lowered programs computed outside C1 (see
        #: ops/chain.py emit_value); exec_stats["chain_leaves"]
        self.n_leaves = 0
        #: the segments the last make_*_step lowered
        self.segments: list[_Segment] = []
        for op in transforms:
            if isinstance(op, MapOp):
                self.ctx.apply_map(op)
            elif isinstance(op, FilterOp):
                self.steps.append(("filter", self.ctx.compile_predicate(op)))
            elif isinstance(op, LimitOp):
                self.steps.append(("limit", len(self.limit_ns)))
                self.limit_ns.append(int(op.n))
            else:
                raise Internal(f"non-streamable op {op.kind} in chain")

    @property
    def has_limit(self) -> bool:
        return bool(self.limit_ns)

    def init_limits(self) -> Optional[torch.Tensor]:
        """Initial per-limit remaining budgets on the device, or None for a
        chain without limits."""
        if not self.limit_ns:
            return None
        return torch.as_tensor(np.asarray(self.limit_ns, dtype=np.int64)).to(self.device)

    @property
    def luts(self) -> dict[str, np.ndarray]:
        return self.ctx.ec.luts

    # ------------------------------------------------------------ lowering
    def _lower(self, tail: Callable, has_gid: bool) -> list[_Segment]:
        """The chain's programs, one per segment; tail(builder) emits the
        last segment's group ids and value columns."""
        segs = []
        b = _chain.ProgramBuilder()
        b.row()
        b.scalar("n_valid")
        b.op("LT_I")
        b.mask_and()
        if self.time_col is not None and self.time_col in self.in_dtypes:
            for bound, cmp in (("t_lo", "GE_I"), ("t_hi", "LT_I")):
                b.col(self.time_col, _chain.I64)
                b.scalar(bound)
                b.op(cmp)
                b.mask_and()
        for kind, sv in self.steps:
            if kind == "filter":
                _chain.emit_value(b, sv)
                b.mask_and()
                continue
            segs.append(_Segment(*b.finish()))
            # the rows a limit admits: running count within its budget
            b = _chain.ProgramBuilder()
            b.col(_CSUM_IN, _chain.I64)
            b.const(sv, _chain.I64)
            b.lut(_LIMITS, _chain.I64, 0)
            b.op("LE_I")
            b.mask_and()
            b.col(_MASK_IN, _chain.B)
            b.mask_and()
        tail(b)
        segs.append(_Segment(*b.finish(has_gid=has_gid)))
        self.n_leaves = sum(len(s.binding.leaves) for s in segs)
        self.segments = segs
        return segs

    def run_segments(self, segs, cols, n, n_valid, t_lo, t_hi, limits, luts, scalars,
                     runner=None):
        """Run the segments over one feed → (mask, gid, outputs, consumed).
        `runner` runs one program (ops/chain.py run, or run_plain to hold C1
        against its plain interpreter on the same tensors)."""
        runner = runner or _chain.run
        env = {"cols": cols, "luts": luts}
        vals = {"n_valid": n_valid, "t_lo": t_lo, "t_hi": t_hi, **(scalars or {})}
        consumed = (torch.zeros(len(self.limit_ns), dtype=torch.int64,
                                device=self.device) if self.limit_ns else None)
        mask = gid = outs = None
        for i, seg in enumerate(segs):
            extra = {}
            if i > 0:
                csum = torch.cumsum(mask, 0, dtype=torch.int64)
                reaching = csum[-1] if n else torch.zeros((), dtype=torch.int64,
                                                         device=self.device)
                consumed[i - 1] = torch.minimum(reaching, limits[i - 1])
                extra = {_MASK_IN: mask, _CSUM_IN: csum}
            in_cols, in_luts, in_scalars = self._bind(seg, env, n, vals, limits, extra)
            mask, gid, outs = runner(seg.prog, in_cols, in_luts, in_scalars, n, self.device)
        return mask, gid, outs, consumed

    @staticmethod
    def _bind(seg, env, n, vals, limits=None, extra=None):
        """A segment's program inputs over one feed, in binding order: its
        columns (leaf values computed here by their closures), LUTs and
        scalar values."""
        bnd = seg.binding
        extra = extra or {}
        in_cols = []
        for name in bnd.cols:
            if name in bnd.leaves:
                in_cols.append(_rows(bnd.leaves[name](env), n))
            else:
                in_cols.append(extra[name] if name in extra else env["cols"][name])
        in_luts = [limits if name == _LIMITS else env["luts"][name] for name in bnd.luts]
        return in_cols, in_luts, [vals[name] for name in bnd.scalars]

    @staticmethod
    def _passthrough(sv) -> Optional[str]:
        """The feed column an SVal reads unchanged, or None if computed."""
        b = _chain.ProgramBuilder()
        _chain.emit_value(b, sv)
        if len(b.code) == 1 and not b.leaves and b.code[0][0] == _chain.OP["LOAD_COL"]:
            return next(iter(b.cols))
        return None

    def _value_tail(self, svals: list):
        """→ (tail emitting the computed values, per value: feed column name
        or output index)."""
        where = []
        computed = []
        for sv in svals:
            src = self._passthrough(sv)
            if src is None:
                where.append(len(computed))
                computed.append(sv)
            else:
                where.append(src)

        def tail(b):
            for sv in computed:
                _chain.emit_value(b, sv)
                b.store()

        return tail, where

    def make_output_step(self, out_names: list[str]):
        """→ (fn(cols, n_valid, t_lo, t_hi, limit_remaining, luts, scalars) →
        (out_cols, count, consumed), out_dtypes, out_dicts).  The selected
        rows are COMPACTED to the front of every output column on the device
        (K4, a stable partition by the mask), so the host reads back exactly
        `count` rows; count stays on the device."""
        sym = self.ctx.sym
        missing = [n for n in out_names if n not in sym]
        if missing:
            raise CompilerError(f"output columns {missing} not found; have {sorted(sym)}")
        out_dtypes = {n: sym[n].dtype for n in out_names}
        out_dicts = {n: sym[n].dictionary for n in out_names if sym[n].dictionary is not None}
        tail, where = self._value_tail([sym[n] for n in out_names])
        segs = self._lower(tail, has_gid=False)

        def step(cols, n_valid, t_lo, t_hi, limit_remaining, luts, scalars=None):
            n = _first_len(cols)
            mask, _gid, outs, consumed = self.run_segments(
                segs, cols, n, n_valid, t_lo, t_hi, limit_remaining, luts, scalars)
            vals = [cols[w] if isinstance(w, str) else outs[w] for w in where]
            compacted, count = compact(mask, vals)
            return dict(zip(out_names, compacted)), count, consumed

        return step, out_dtypes, out_dicts

    def make_agg_step(self, keys: list[GroupKey], udas: list, num_groups: int):
        """→ fn(cols, n_valid, t_lo, t_hi, limit_remaining, luts, state, scalars)
        → (state, consumed), the state updated in place.
        udas: list of (out_name, UDA, value SVal|None).  Also sets
        `raw_agg_step`, the same step → (state, passed-row count, consumed)
        (the form parallel/spmd.py lifts, as the reference's)."""
        vals = [vb for _o, _u, vb in udas if vb is not None]
        value_tail, where = self._value_tail(vals)

        def tail(b):
            for k in keys:
                if k.kind == "intdevice":
                    b.col(k.src_name, _chain.value_kind(self.in_dtypes[k.src_name]))
                    b.search(k.lut_name)
                elif k.kind == "dict":
                    # Null keys (code -1, e.g. unmatched left-join fills)
                    # drop out of the aggregate (pandas dropna semantics)
                    # before the combine clamps them into group 0.  A literal
                    # key's code is one value for every row.
                    _chain.emit_value(b, k.key_sval)
                    b.dup()
                    b.const(0, _chain.I64)
                    b.op("GE_I")
                    b.mask_and()
                else:  # window: the origin is a runtime scalar (streaming)
                    _chain.emit_value(b, k.key_sval)
                    b.window(k.width, k.lut_name)
                b.combine(k.card)
            value_tail(b)

        segs = self._lower(tail, has_gid=True)
        #: what gang_member needs of this aggregate
        self._agg = (udas, where, num_groups)

        nan_kw = [{"nan_bin": self.nan_bin} if uda.bins_nan else {} for _o, uda, _v in udas]

        def run(cols, n_valid, t_lo, t_hi, limit_remaining, luts, state, scalars):
            n = _first_len(cols)
            mask, gid, outs, consumed = self.run_segments(
                segs, cols, n, n_valid, t_lo, t_hi, limit_remaining, luts, scalars)
            j = 0
            for (out_name, uda, vb), kw in zip(udas, nan_kw):
                v = None
                if vb is not None:
                    w = where[j]
                    j += 1
                    v = cols[w] if isinstance(w, str) else outs[w]
                state[out_name] = uda.update(state[out_name], gid, v, mask, num_groups, **kw)
            return state, mask, consumed

        def step(cols, n_valid, t_lo, t_hi, limit_remaining, luts, state, scalars=None):
            state, _mask, consumed = run(cols, n_valid, t_lo, t_hi, limit_remaining, luts,
                                         state, scalars)
            return state, consumed

        def raw_step(cols, n_valid, t_lo, t_hi, limit_remaining, luts, state, scalars=None):
            state, mask, consumed = run(cols, n_valid, t_lo, t_hi, limit_remaining, luts,
                                        state, scalars)
            return state, mask.sum(dtype=torch.int64), consumed

        self.raw_agg_step = raw_step
        return step

    def gang_member(self, cols, n_valid, t_lo, t_hi, luts, state, scalars=None):
        """This aggregate as a member of a multi-query gang over one feed
        (ops/gang.py): the chain's one program (a chain with limits never
        joins a gang) with its inputs, and a leaf update per state leaf of
        each UDA, reading the values make_agg_step's step would pass to
        `update`."""
        udas, where, num_groups = self._agg
        (seg,) = self.segments
        n = _first_len(cols)
        vals = {"n_valid": n_valid, "t_lo": t_lo, "t_hi": t_hi, **(scalars or {})}
        in_cols, in_luts, in_scalars = self._bind(seg, {"cols": cols, "luts": luts}, n, vals)
        leaves = []
        j = 0
        for out_name, uda, vb in udas:
            v = None
            if vb is not None:
                w = where[j]
                j += 1
                v = cols[w] if isinstance(w, str) else w
            for op, leaf, sketch in uda.gang_leaves(state[out_name]):
                leaves.append(_gang.Leaf(op, leaf, None if op == "count" else v, sketch,
                                         self.nan_bin))
        return _gang.Member(seg.prog, in_cols, in_luts, in_scalars, num_groups, leaves)


def _picker_codes(sv: SVal) -> SVal:
    """A dict-valued picker's input: the codes, with null (-1) replaced by
    PICKER_NULL_SENTINEL, the min identity, so that it never wins."""
    def build(env):
        v = sv.build(env)
        return torch.where(v >= 0, v, PICKER_NULL_SENTINEL)

    def emit(b):
        _chain.emit_value(b, sv)
        b.const(0, _chain.I64)
        b.op("GE_I")
        _chain.emit_value(b, sv)
        b.const(PICKER_NULL_SENTINEL, _chain.I64)
        b.op("SELECT")

    return SVal(sv.dtype, build, emit=emit)


def _first_len(cols: dict) -> int:
    for v in cols.values():
        return v.shape[0]
    return 0


def _feed_batches(src, target: int):
    """The feed policy: a cursor's batches → (list of (batch, gen), cold) per
    feed.  Empty batches are skipped; sealed batches coalesce until the feed
    holds `target` rows; the hot remainder (gen None) never joins the sealed
    rows before it — sealed feeds are immutable and cached, the hot tail
    changes every write, so mixing them would re-upload the feed per query.
    Cold-tier batches (the cursor's `cold_gens`, table/lifecycle.py) never
    share a feed with RAM batches either: a cold feed is decoded on read and
    never cached, so a cold batch in a RAM feed would keep the whole feed out
    of the caches (and a RAM batch in a cold feed would stream every query).
    A cold batch decodes from disk when the scan reaches it
    (Cursor.__iter__), one at a time.  `_feed_count_at_most_one` applies the
    same policy to the cursor's metadata."""
    cold_gens = getattr(src, "cold_gens", None) or frozenset()
    pend, nrows, pend_cold = [], 0, False
    for rb, _row_id, gen in src:
        n = rb.num_valid
        if n == 0:
            continue
        is_cold = gen in cold_gens
        if pend and (gen is None or is_cold != pend_cold):
            yield pend, pend_cold
            pend, nrows = [], 0
        pend_cold = is_cold
        pend.append((rb, gen))
        nrows += n
        if nrows >= target:
            yield pend, pend_cold
            pend, nrows = [], 0
    if pend:
        yield pend, pend_cold


def _feed_count_at_most_one(src, target: int) -> bool:
    """Whether _feed_batches makes at most one feed of `src`, from its
    batches' row counts alone: sizing feeds must never decode a cold batch,
    so a cursor with `iter_meta` (table.Cursor) answers from metadata."""
    if hasattr(src, "iter_meta"):
        meta = src.iter_meta()
    else:
        meta = ((rb.num_valid, rid, gen) for rb, rid, gen in src)
    cold_gens = getattr(src, "cold_gens", None) or frozenset()
    feeds, nrows, pend_cold = 0, 0, False
    for n, _rid, gen in meta:
        if n == 0:
            continue
        is_cold = gen in cold_gens
        if nrows and (gen is None or is_cold != pend_cold):
            feeds, nrows = feeds + 1, 0
        pend_cold = is_cold
        nrows += n
        if nrows >= target:
            feeds, nrows = feeds + 1, 0
        if feeds > 1:
            return False
    return feeds + (nrows > 0) <= 1


def _note_cold_reads(src, gens) -> None:
    """The cold tier's read-heat promotion hook, once per cold feed: enough
    decodes of one cold batch move it back to RAM (PL_COLD_PROMOTE_READS).
    Data plane, not gated on tracing."""
    tier = getattr(src.table, "cold", None)
    if tier is not None:
        tier.note_reads(gens)


def f1_key(num_groups: int, init_specs) -> tuple:
    """An aggregate's shape for F1: its group count and each state's (name,
    UDA class, input dtype), from which the state's structure follows."""
    return (num_groups, tuple((name, type(uda), str(dt)) for name, uda, dt in init_specs))


#: f1_key → (whether every state has a gang update, so that F1 can run the
#: aggregate; its gang leaf updates; its finalized sketches)
_F1_SHAPES: dict = {}


def f1_shape(num_groups: int, init_specs, udas) -> tuple[bool, int, int]:
    """An aggregate's F1 table, from its states' shapes alone (cached per
    f1_key): (every state has a gang update, the leaf updates, the
    sketches the device finalizes)."""
    key = f1_key(num_groups, init_specs)
    got = _F1_SHAPES.get(key)
    if got is None:
        template = {name: uda.init(num_groups, dt, "meta") for name, uda, dt in init_specs}
        leaves = [uda.gang_leaves(template[name]) for name, uda, _dt in init_specs]
        finals = _fin.finals_of((name, uda) for name, uda, _vb in udas)
        got = (all(lv is not None for lv in leaves),
               sum(len(lv) for lv in leaves if lv is not None), len(finals))
        if len(_F1_SHAPES) > 256:
            _F1_SHAPES.clear()
        _F1_SHAPES[key] = got
    return got


# ------------------------------------------------------------ column pruning
def _expr_columns(e) -> set:
    if isinstance(e, Column):
        return {e.name}
    if isinstance(e, Call):
        out = set()
        for a in e.args:
            out |= _expr_columns(a)
        return out
    return set()


def _prune_to_needed(head, chain, dtypes, dicts, names, visible, time_col,
                     needed_end: set):
    """Narrow the feed (and the chain's Map projections) to the columns the
    consumer actually reads.  The hidden time column stays whenever the source
    has time bounds (names carries it beyond `visible` in that case).

    Returns (dtypes, dicts, names, visible, chain') — chain' has Map exprs
    for dropped outputs removed, since the kernel evaluates every listed
    expr (an unneeded expr over a pruned input would fail to resolve).
    """
    chain, req = _chain_required_columns(chain, set(needed_end))
    keep_visible = [n for n in visible if n in req]
    if not keep_visible and visible:
        keep_visible = [visible[0]]  # row count still needs one column
    keep = list(keep_visible)
    has_bounds = (getattr(head, "start_time", None) is not None
                  or getattr(head, "stop_time", None) is not None)
    if has_bounds and time_col is not None and time_col not in keep \
            and time_col in names:
        keep.append(time_col)
    dtypes = {n: dtypes[n] for n in keep}
    dicts = {n: dicts[n] for n in keep if n in dicts}
    return dtypes, dicts, keep, keep_visible, chain


def _chain_required_columns(chain, needed: set):
    """Backward dataflow through Map (full-list projection semantics) and
    Filter: -> (pruned_chain, required_source_columns)."""
    new_rev = []
    for op in reversed(chain):
        if isinstance(op, MapOp):
            defined = {name for name, _ in op.exprs}
            kept = [(name, ex) for name, ex in op.exprs if name in needed]
            out = set()
            for _name, ex in kept:
                out |= _expr_columns(ex)
            needed = out | (needed - defined)
            op = (dataclasses.replace(op, exprs=kept)
                  if len(kept) != len(op.exprs) else op)
        elif isinstance(op, FilterOp):
            needed = needed | _expr_columns(op.expr)
        new_rev.append(op)
    return list(reversed(new_rev)), needed


# -------------------------------------------------------------------- executor


@dataclasses.dataclass
class _FinalizedCol:
    """An output column finalized ON DEVICE and already pulled: the agg
    finalize step runs finalize_from_device on it instead of finalize_host
    on state bytes."""

    col: np.ndarray


@dataclasses.dataclass
class _DeferredState:
    """Un-pulled partial-agg state (distributed agents, `defer_agg_pull`).
    The feed loop accumulates in place, so `partials` holds exactly one device
    state; `reduce_tree` names each leaf's merge op."""

    partials: list
    reduce_tree: dict


@dataclasses.dataclass
class _DeferredPartial:
    """An agg_state channel payload whose readback is deferred: the cluster
    pulls `partials` (for ALL agents in one transfer wave) and then calls
    finish(pulled) -> PartialAggBatch.

    When every agent's `layout_fp` matches (same group-key value sets /
    dictionaries / UDA layout), the cluster instead merges ALL agents' states
    ON DEVICE (gang_merge_states, kernel M1) and finishes once on the merged
    state: one readback of one state instead of N."""

    partials: list
    finish: Callable
    #: state-layout fingerprint; None = never gang-merge
    layout_fp: object = None
    #: finish on an ALREADY-MERGED pulled state (gang path)
    finish_state: Optional[Callable] = None
    #: {out_name: reduce-op tree} for the device merge
    reduce_tree: object = None


def gang_merge_states(deferred: list) -> object:
    """Merge every agent's device state into ONE device state (kernel M1 on
    CUDA), written packed (`pack.Packed`, which transfer.pull_states reads
    back in one copy with no P1 launch).  An agent's state may itself be
    packed (a mesh agent's merged shards).  The caller guarantees an equal
    layout_fp across `deferred`."""
    flat: list = []
    for d in deferred:
        flat.extend(d.partials)
    return merge_states(deferred[0].reduce_tree, flat)


@dataclasses.dataclass
class _AggSetup:
    """One aggregate's prepared execution state (see _agg_setup)."""

    op: AggOp
    head: object
    chain: list
    src: object
    names: list
    cap: int
    kern: ChainKernel
    keys: list
    udas: list
    in_types: dict
    init_specs: list
    num_groups: int
    seen_name: str
    step: Callable
    val_dicts: dict
    #: window origins of this run (chain program scalars)
    origins: dict
    #: the pruned feed's types and dictionaries, and the source's time
    #: column (what the whole-plan lowering reads)
    dtypes: dict
    dicts: dict
    time_col: Optional[str]


class PlanExecutor:
    def __init__(self, plan: Plan, table_store, registry=None, device=None,
                 analyze: bool = False, inputs=None, mesh="auto", nan_bin: int = 1,
                 route_scale: int = 1, force_backend: Optional[str] = None):
        from pixie_tpu_torch.udf import registry as default_registry

        self.plan = plan
        #: distributed fan-out: how many agents run this same fragment.  The
        #: CPU/card routing multiplies local input sizes by it, so a sharded
        #: query routes by its TOTAL size (see _route_backend).
        self.route_scale = max(1, int(route_scale))
        #: pin the arm regardless of input size: "cpu" (the host fast paths
        #: where they admit the query) or "device" (the card route); None
        #: routes by size.  A pinned executor's joins take the gate's static
        #: decision (no autotune probe)
        if force_backend not in (None, CPU, DEVICE):
            raise Internal(f"force_backend {force_backend!r}: want 'cpu' or 'device'")
        self.force_backend = force_backend
        #: adaptive-routing decisions taken for this query, one per size
        #: bucket (engine/autotune.py; empty with PX_AUTOTUNE=0)
        self._at_route: dict[str, dict] = {}
        #: the arm the last aggregate ran on (CPU: its state is numpy)
        self._route_of_last_agg = DEVICE
        #: (src, arm, t0_ns) of the last aggregate, folded into its routing
        #: decision once its state is on the host (_fold_route_wall)
        self._route_wall = None
        #: the sketch bin of a NaN value: 1 as the reference's device route
        #: bins it (a batch query), 0 as its CPU routes do (a streaming
        #: poll, engine/stream.py); ops/sketch.py bin_index
        self.nan_bin = nan_bin
        self.store = table_store
        self.registry = registry or default_registry
        self.device = resolve_device(device)
        #: channel id → HostBatch injected by the cluster layer (remote edges;
        #: reference: GRPCRouter demuxing inbound streams, grpc_router.h:52)
        self.inputs: dict[str, HostBatch] = inputs or {}
        #: colocated-agent mode (LocalCluster): agg_state channels return
        #: device-resident state (_DeferredPartial) instead of pulling, so the
        #: cluster merges all agents' states on the device and reads back once
        self.defer_agg_pull = False
        self._defer_active = False
        self._materialized: dict[int, HostBatch] = {}
        self.stats = {"rows_scanned": 0, "rows_output": 0, "batches": 0, "chain_leaves": 0,
                      "feeds": 0, "h2d_bytes": 0}
        #: analyze mode (reference ExecutePlan(analyze=true), carnot.cc:318):
        #: synchronizes the device after every feed and records its wall time.
        self.analyze = analyze
        #: one wall-time frame per operator chain or blocking op (see _timed)
        self.op_stats: list[dict] = []
        #: EXPLAIN ANALYZE timing: synchronize a CUDA device at every
        #: frame's boundaries, so a frame's ns hold its device work and not
        #: only its enqueue (set by LocalCluster.query(explain=True) only)
        self.sync_op_timing = False
        self._stat_stack: list[dict] = []
        # Mesh of co-located shards for SPMD aggregation (parallel/spmd.py):
        # every unlimited agg shards its feeds over it.  "auto" = the default
        # mesh of this device (None unless PIXIE_TORCH_VIRTUAL_SHARDS > 1).
        from pixie_tpu_torch.parallel import spmd as _spmd

        if mesh == "auto":
            mesh = _spmd.default_mesh(self.device)
        if mesh is not None and mesh.spans_processes:
            # the reference keeps the executor per process on this path
            # (parallel/shard_bench.py: each process feeds the chain kernel)
            raise Unimplemented(
                f"a mesh over {len(set(mesh.processes))} processes for an executor: "
                "parallel/multihost.py runs such a mesh under the chain kernel "
                "(shard_bench.run_multihost); the executor over it waits for a later slice")
        if mesh is not None and any(d != self.device for d in mesh.devices):
            raise Unimplemented(
                f"a mesh over {sorted({str(d) for d in mesh.devices})} for an executor on "
                f"{self.device}: one process over distinct devices waits for the multi-card slice "
                "(parallel/multihost.py spans cards with one process a card)")
        self.mesh = mesh
        if mesh is not None:
            # the collective-serialization decision, recorded per query as
            # the reference records it
            gate = {k: v for k, v in _spmd.collective_gate(mesh).items() if k != "_key"}
            self.stats.setdefault("device", {})["collective_gate"] = gate

    # -------------------------------------------------------------- exec stats
    @contextlib.contextmanager
    def _timed(self, label: str, ops: list[int]):
        """Record a wall-time frame; nesting attributes child time so
        self_ns = wall_ns - nested frames.  The parent is captured at enter
        and the frame removed by identity: frames opened inside generators
        close at exhaustion, not in LIFO order.

        Kernel launches are asynchronous, so by default a frame times what
        the host enqueued.  With `sync_op_timing` (EXPLAIN ANALYZE) a CUDA
        executor synchronizes the device at both ends of every frame, so
        the frame holds its device work too."""
        rec = {"ops": ops, "label": label, "wall_ns": 0, "rows_out": 0,
               "bytes_out": 0, "_child_ns": 0,
               # wall-clock anchor so the frame adapts into a trace span
               # and a flight-recorder op row without extra timing calls
               "t0_unix_ns": _time.time_ns()}
        parent = self._stat_stack[-1] if self._stat_stack else None
        self._stat_stack.append(rec)
        sync = self.sync_op_timing and self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = _time.perf_counter_ns()
        try:
            yield rec
        finally:
            if sync:
                torch.cuda.synchronize(self.device)
            rec["wall_ns"] = _time.perf_counter_ns() - t0
            self._stat_stack = [r for r in self._stat_stack if r is not rec]
            if parent is not None and "_child_ns" in parent:
                parent["_child_ns"] += rec["wall_ns"]
            rec["self_ns"] = rec["wall_ns"] - rec.pop("_child_ns")
            self.op_stats.append(rec)

    def _emit_op_spans(self) -> None:
        """Adapt the per-op exec stats into trace spans (the frames already
        carry wall-clock anchors; under no active trace this is one
        ContextVar read)."""
        from pixie_tpu_torch import trace

        if not self.op_stats or trace.current() is None:
            return
        for rec in self.op_stats:
            t0 = rec.get("t0_unix_ns")
            if t0 is None:
                continue
            trace.event_span(rec["label"], t0, rec["wall_ns"],
                             rows_out=rec.get("rows_out", 0))

    def _heat_recorder(self, src):
        """Shard-heat accounting hook shared by every scan path (the
        coalescing `_feed`, the CPU route's `_host_feed`, np_partial's fused
        window loop): a per-stream FeedRecorder (table/heat.py), or None
        when tracing is off or `src` is not a storage cursor — flag-off
        never touches the model.  It reads only host-side batch metadata."""
        from pixie_tpu_torch import observe as _observe

        table = getattr(src, "table", None)
        if table is None or not _observe.enabled():
            return None
        from pixie_tpu_torch.table import heat as _heat

        return _heat.FeedRecorder(
            table, getattr(self.store, "node_name", "") or "local")

    @staticmethod
    def _chain_label(head, chain, terminal: str = "") -> str:
        parts = [f"scan({head.table})" if isinstance(head, MemorySourceOp) else head.kind]
        parts.extend(op.kind for op in chain)
        if terminal:
            parts.append(terminal)
        return "->".join(parts)

    # ------------------------------------------------------------ plan walking
    def _upstream_chain(self, op):
        """Walk up through streamable transforms. Returns (head, [transforms...])."""
        chain = []
        cur = op
        while isinstance(cur, (MapOp, FilterOp, LimitOp)):
            chain.append(cur)
            parents = self.plan.parents(cur)
            if len(parents) != 1:
                raise Internal(f"transform {cur.kind} must have exactly one parent")
            cur = parents[0]
        return cur, list(reversed(chain))

    def _input_of(self, head):
        """head is a Source or blocking op.

        Returns (dtypes, dicts, src, feed_names, visible_names, time_col, cap).
        feed_names may include a hidden time_ column fetched only so row-level
        time bounds can be applied; visible_names excludes it.
        """
        if isinstance(head, MemorySourceOp):
            table = self.store.table(head.table)
            if head.tablet is not None:
                from pixie_tpu_torch.table.tablets import TabletsGroup

                if not isinstance(table, TabletsGroup):
                    raise InvalidArgument(
                        f"table {head.table!r} is not tabletized (tablet="
                        f"{head.tablet!r} requested)"
                    )
                table = table.tablet(head.tablet)
            if head.since_row_id is not None or head.stop_row_id is not None:
                cursor = table.cursor_since(
                    head.since_row_id or 0, head.stop_row_id,
                    head.start_time, head.stop_time,
                )
            else:
                cursor = table.cursor(head.start_time, head.stop_time)
            visible = list(head.columns or table.relation.names())
            names = list(visible)
            has_bounds = head.start_time is not None or head.stop_time is not None
            if has_bounds and table.time_col is not None and table.time_col not in names:
                names.append(table.time_col)
            dtypes = {n: table.relation.dtype(n) for n in names}
            dicts = {n: table.dictionaries[n] for n in names if n in table.dictionaries}
            return dtypes, dicts, cursor, names, visible, table.time_col, table.batch_rows
        hb = self._eval_blocking(head)
        return hb.dtypes, hb.dicts, hb, list(hb.cols), list(hb.cols), None, 1

    # ------------------------------------------------------------- stream feed
    def _upload(self, parts: list[dict], names, n: int) -> dict[str, torch.Tensor]:
        """One feed's columns on the device.  On CUDA each column is assembled
        straight into pinned host memory and copied with non_blocking=True, so
        the host assembles the next feed while this one copies and runs."""
        cols = {}
        for k in names:
            arrs = [p[k] for p in parts]
            if self.device.type == "cuda":
                host = torch.empty(n, dtype=to_torch_dtype(arrs[0].dtype),
                                   pin_memory=True)
                np.concatenate(arrs, out=host.numpy())
                cols[k] = host.to(self.device, non_blocking=True)
            else:
                cols[k] = torch.from_numpy(np.concatenate(arrs)).to(self.device)
            self.stats["h2d_bytes"] += n * arrs[0].itemsize
        return cols

    def _note_shard_rows(self, per_shard) -> None:
        """Per-shard placement accounting for SPMD feeds: accumulates each
        feed's per-shard valid rows and keeps the skew ratio (max/mean shard
        rows) visible — stats["shard_rows"] / ["shard_skew_frac"] plus the
        px_shard_skew_frac gauge.  1.0 = perfectly even placement; row-block
        sharding stays near 1 except at uneven tails."""
        from pixie_tpu_torch import metrics as _metrics

        rows = [int(x) for x in np.asarray(per_shard).reshape(-1)]
        acc = self.stats.get("shard_rows")
        if not isinstance(acc, list) or len(acc) != len(rows):
            acc = [0] * len(rows)
        acc = [a + r for a, r in zip(acc, rows)]
        self.stats["shard_rows"] = acc
        mean = sum(acc) / max(len(acc), 1)
        skew = (max(acc) / mean) if mean > 0 else 1.0
        self.stats["shard_skew_frac"] = round(skew, 4)
        _metrics.gauge_set(
            "px_shard_skew_frac", skew,
            help_="max/mean rows per mesh shard over this process's latest "
                  "SPMD query feeds (placement-skew visibility; 1.0 = even)")

    # ------------------------------------------------------------- routing
    def _backend_for(self, src) -> str:
        """The arm of this input: CPU (the host fast paths) or DEVICE (the
        card route).  force_backend pins it; else the static crossover
        decides, or, under PX_AUTOTUNE, the cpu_crossover gate's cost model
        with the crossover as its static arm."""
        if self.force_backend is not None:
            return self.force_backend
        static = _route_backend(src, self.route_scale)
        if not _autotune.enabled() or not self._host_arms_live():
            return static
        n = _src_rows(src)
        if n is None:
            return static
        # one decision per size bucket per executor: every _backend_for
        # call for this query's inputs routes consistently, and
        # stats["autotune"] carries exactly the decisions it ran under
        bucket = _autotune.size_bucket(n * self.route_scale)
        dec = self._at_route.get(bucket)
        if dec is None:
            dec = _autotune.MODEL.decide(_autotune.GATE_CPU_CROSSOVER, "agg", bucket, static,
                                         (CPU, DEVICE))
            self._at_route[bucket] = dec
            self.stats.setdefault("autotune", []).append(dec)
        return dec["arm"]

    def _host_arms_live(self) -> bool:
        """Whether autotune may send this executor's work to a host arm (the
        CPU route, the join gate's host match).  Always on a CPU device, where
        the host fast paths are the fast paths.  On a CUDA device only while
        PX_CPU_CROSSOVER_ROWS is above 0: at 0 (the H100 sweep: the card won
        at every size, and J1-J3 beat the native join 14x at 2^16 rows a
        side, PERF.md) no probe sends card work to the host."""
        return (self.device.type != "cuda"
                or int(_flags.get("PX_CPU_CROSSOVER_ROWS")) > 0)

    def _fold_route_wall(self) -> None:
        """Fold the last aggregate's wall, from its start to its state on the
        host, into the routing decision that picked its arm — only when the
        chain ran on that arm (a CPU decision whose query no fast path admits
        runs the card route, whose cost is not the CPU arm's).  Callers call
        it once the state is pulled; a deferred partial's state stays on the
        card for the cluster's merge, so its wall ends at a sync."""
        obs, self._route_wall = self._route_wall, None
        if obs is None or not self._at_route:
            return
        src, arm, t0 = obs
        n = _src_rows(src)
        if n is None:
            return
        dec = self._at_route.get(_autotune.size_bucket(n * self.route_scale))
        if dec is None or dec["arm"] != arm:
            return
        if arm == DEVICE and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        _autotune.MODEL.observe_decision(dec, (_time.perf_counter_ns() - t0) / 1e9)

    def _host_feed(self, src, names, cap):
        """Yield (cols dict of host numpy arrays, n_valid) feeds for the CPU
        route: the same coalescing as _feed (_feed_batches), with nothing
        uploaded."""
        if isinstance(src, HostBatch):
            yield {k: np.asarray(src.cols[k]) for k in names}, src.num_rows
            return
        target = max(cap, int(_flags.get("PX_FEED_ROWS")))
        heat_rec = self._heat_recorder(src)
        for batches, cold in _feed_batches(src, target):
            nrows = sum(rb.num_valid for rb, _gen in batches)
            self.stats["rows_scanned"] += nrows
            self.stats["batches"] += len(batches)
            parts = [{k: rb.columns[k][:rb.num_valid] for k in names} for rb, _g in batches]
            gens = [gen for _rb, gen in batches]
            if heat_rec is not None:
                heat_rec.record(parts, gens, "cold" if cold else "stream", rows=nrows)
            if cold:
                _note_cold_reads(src, gens)
            if len(parts) == 1:
                yield parts[0], nrows
            else:
                yield {k: np.concatenate([p[k] for p in parts]) for k in names}, nrows

    def _feed(self, src, names, cap, spmd: bool = False):
        """Yield (cols dict of device tensors, n_valid) feeds.

        Cursor batches (storage granularity) are coalesced into ~FEED_ROWS
        feeds (_feed_batches): fewer, larger kernel launches and transfers.
        A sealed-only feed is served from the resident tier, else from the
        HBM feed cache, else uploaded into padded buffers that the cache
        keeps; either way the step sees exact-length views `buf[:n]`.  Feeds
        touching the hot remainder (gen None) or a delta cursor stream fresh
        every query.

        spmd=True (an SPMD consumer over the mesh): every feed is its whole
        zero-padded power-of-two buffer, which splits row-block-wise into the
        mesh's shards, and sealed feeds come from the resident tier's and
        the cache's entries for the mesh width (the keys carry n_dev).
        """
        n_dev = self.mesh.size if (spmd and self.mesh is not None) else 1

        def fresh(parts, n):
            if n_dev == 1:
                return self._upload(parts, names, n)
            cols, h2d = resident.upload_padded(parts, names, n, resident.bucket_rows(n),
                                               self.device)
            self.stats["h2d_bytes"] += h2d
            return cols

        def rows_of(cols, n):
            return cols if n_dev > 1 else {k: v[:n] for k, v in cols.items()}

        if isinstance(src, HostBatch):
            self.stats["feeds"] += 1
            yield fresh([src.cols], src.num_rows), src.num_rows
            return
        target = max(cap, int(_flags.get("PX_FEED_ROWS")))
        table_id = src.table.uid
        is_delta = getattr(src, "is_delta", False)
        dev = str(self.device)
        # Shard-heat accounting (table/heat.py): one recorder per feed
        # stream, bumped per coalesced feed with the tier that served it.
        # Gated on the tracing master switch, and host metadata only.
        heat_rec = self._heat_recorder(src)

        def emit(parts, gens, n, cold):
            self.stats["feeds"] += 1
            if cold:
                # A cold-tier feed is decoded on read and uploaded fresh:
                # caching it (resident or feed cache) would promote it
                # through the back door and pin the demoted window on the
                # device.  Promotion is the cold tier's own call, by read
                # heat (PL_COLD_PROMOTE_READS).  fresh() copies the decoded
                # arrays into a pinned buffer before its non-blocking copy,
                # so they may be freed at once; its bytes count in h2d_bytes.
                cols = fresh(parts, n)
                if heat_rec is not None:
                    heat_rec.record(parts, gens, "cold", rows=n)
                _note_cold_reads(src, gens)
                return cols, n
            if is_delta or any(g is None for g in gens):
                if heat_rec is not None:
                    heat_rec.record(parts, gens, "stream", rows=n)
                return fresh(parts, n), n
            key = (table_id, tuple(gens), tuple(names), dev, n_dev)
            # Resident tier first: a new seal FOLDS into its buffers (only
            # the delta rows cross the link) instead of invalidating the
            # whole feed.  A cache entry for this exact feed is handed over
            # for ADOPTION and then dropped, so its bytes are never uploaded
            # or pinned twice.
            got = resident.feed(table_id, tuple(names), gens, cap, parts, n,
                                self.device, prewarmed=_device_cache_get(key), n_dev=n_dev)
            if got is not None:
                _device_cache_pop(key)
                rcols, h2d = got
                self.stats["resident_feeds"] = self.stats.get("resident_feeds", 0) + 1
                self.stats["h2d_bytes"] += h2d
                if heat_rec is not None:
                    heat_rec.record(parts, gens, "resident", rows=n)
                return rows_of(rcols, n), n
            cached = _device_cache_get(key)
            if cached is not None:
                self.stats["feed_cache_hits"] = self.stats.get("feed_cache_hits", 0) + 1
                if heat_rec is not None:
                    heat_rec.record(parts, gens, "hbm_cache", rows=n)
                return rows_of(cached, n), n
            if heat_rec is not None:
                heat_rec.record(parts, gens, "stream", rows=n)
            bucket = resident.bucket_rows(n)
            if bucket * sum(parts[0][k].dtype.itemsize for k in names) > _device_cache_max():
                return fresh(parts, n), n  # the cache cannot keep it
            cols, h2d = resident.upload_padded(parts, names, n, bucket, self.device)
            self.stats["h2d_bytes"] += h2d
            _device_cache_put(key, cols)
            return rows_of(cols, n), n

        for batches, cold in _feed_batches(src, target):
            nrows = sum(rb.num_valid for rb, _gen in batches)
            self.stats["rows_scanned"] += nrows
            self.stats["batches"] += len(batches)
            yield emit([{k: rb.columns[k][:rb.num_valid] for k in names} for rb, _gen in batches],
                       [gen for _rb, gen in batches], nrows, cold)

    # ---------------------------------------------------------------- blocking
    def _eval_blocking(self, op) -> HostBatch:
        got = self._materialized.get(op.id)
        if got is not None:
            return got
        if isinstance(op, AggOp):
            label = f"agg(by={op.groups})"
        elif isinstance(op, RemoteSourceOp):
            label = f"remote({op.channel})"
        else:
            label = op.kind
        with self._timed(label, [op.id]) as rec:
            if isinstance(op, AggOp):
                out = self._run_agg(op)
            elif isinstance(op, JoinOp):
                out = self._run_join(op)
            elif isinstance(op, MemorySourceOp):
                out = self._consume_to_batch(op, [])
            elif isinstance(op, UnionOp):
                out = self._run_union(op)
            elif isinstance(op, RemoteSourceOp):
                got = self.inputs.get(op.channel)
                if got is None:
                    raise Internal(f"no input injected for channel {op.channel!r}")
                out = got
            else:
                raise Unimplemented(
                    f"operator {op.kind!r} is not ported yet: UDTF sources come with the "
                    "host-layer slice (ROADMAP Queue 1 item 6c)")
            rec["rows_out"] = out.num_rows
            rec["bytes_out"] = sum(v.nbytes for v in out.cols.values())
        self._materialized[op.id] = out
        return out

    def _consume_chain(self, terminal_parent, out_names=None):
        """Run the chain feeding `terminal_parent` through an output step.

        Returns (out_dtypes, out_dicts, out_names, iterator of (np_cols,
        count))."""
        head, chain = self._upstream_chain(terminal_parent)

        # A bare blocking op feeding a sink (the common shape for aggregated
        # results) is already a host batch: plain column selection, no kernel.
        if not chain and not isinstance(head, MemorySourceOp):
            hb = self._eval_blocking(head)
            sel = out_names if out_names is not None else list(hb.cols)
            missing = [n for n in sel if n not in hb.cols]
            if missing:
                raise CompilerError(f"output columns {missing} not found")
            out_dtypes = {n: hb.dtypes[n] for n in sel}
            out_dicts = {n: hb.dicts[n] for n in sel if n in hb.dicts}

            def gen_direct():
                yield {n: hb.cols[n] for n in sel}, hb.num_rows

            return out_dtypes, out_dicts, sel, gen_direct()

        dtypes, dicts, src, names, visible, time_col, cap = self._input_of(head)
        if out_names is not None:
            dtypes, dicts, names, visible, chain = _prune_to_needed(
                head, chain, dtypes, dicts, names, visible, time_col,
                set(out_names),
            )
        kern = ChainKernel(dtypes, dicts, chain, self.registry, time_col,
                           self.device, visible)
        if out_names is None:
            out_names = list(kern.ctx.visible)
        step, out_dtypes, out_dicts = kern.make_output_step(out_names)
        self.stats["chain_leaves"] = self.stats.get("chain_leaves", 0) + kern.n_leaves
        t_lo, t_hi = _time_bounds(head)
        luts = device_luts(kern.luts, self.device)
        label = self._chain_label(head, chain, "select")
        op_ids = [head.id] + [op.id for op in chain]

        def gen():
            # Double-buffered readback: every feed's step is enqueued without
            # a host sync (limit budgets stay a device vector).  One feed
            # behind, the previous feed's count (its copy started right after
            # its step) lands and its count-sliced outputs start their D2H
            # copy, in flight while the current feed computes; two feeds
            # behind, the sliced outputs materialize and are yielded.
            with self._timed(label, op_ids) as rec:
                remaining = kern.init_limits()
                computing: collections.deque = collections.deque()  # (outs, count pull)
                pulling: collections.deque = collections.deque()    # (AsyncPull, rows)
                feed_ns = []

                def start_readback(overlapped: bool):
                    outs, cnt = computing.popleft()
                    c = int(cnt.wait())
                    pulling.append(
                        (transfer.pull_async({k: v[:c] for k, v in outs.items()}), c))
                    if overlapped:
                        rec["pipelined_waves"] = rec.get("pipelined_waves", 0) + 1
                        self.stats["pipelined_waves"] = (
                            self.stats.get("pipelined_waves", 0) + 1)

                def emit_ready():
                    h, c = pulling.popleft()
                    cols_np = h.wait()
                    rec["rows_out"] += c
                    rec["bytes_out"] += sum(v.nbytes for v in cols_np.values())
                    return cols_np, c

                for cols, n_valid in self._feed(src, names, cap):
                    tf0 = _time.perf_counter_ns()
                    outs, cnt, consumed = step(cols, n_valid, t_lo, t_hi, remaining, luts)
                    if kern.has_limit:
                        remaining = remaining - consumed
                    if self.analyze:
                        if self.device.type == "cuda":
                            torch.cuda.synchronize(self.device)
                        feed_ns.append(_time.perf_counter_ns() - tf0)
                    # the count rides home under this feed's own compute
                    computing.append((outs, transfer.pull_async(cnt)))
                    if len(computing) >= 2:
                        start_readback(overlapped=True)
                    while len(pulling) >= 2:
                        yield emit_ready()
                if self.analyze and feed_ns:
                    rec["feed_ns"] = feed_ns
                if kern.has_limit:
                    # each LimitOp's remaining budget, in chain order
                    rec["limit_remaining"] = [int(x) for x in transfer.pull(remaining)]
                while computing:
                    start_readback(overlapped=False)
                while pulling:
                    yield emit_ready()

        return out_dtypes, out_dicts, out_names, gen()

    def _consume_to_batch(self, terminal_parent, out_names=None) -> HostBatch:
        out_dtypes, out_dicts, out_names, gen = self._consume_chain(terminal_parent, out_names)
        return HostBatch(out_dtypes, out_dicts, _concat_parts(gen, out_names, out_dtypes))

    def _run_union(self, op: UnionOp) -> HostBatch:
        """Concatenate the parents' rows (reference exec/union_node.*): each
        dictionary column maps onto a copy of the first parent's dictionary,
        extended with the other parents' values.  A parent whose codes
        already are the target's (the first, and every scan of the same
        table) keeps its column as it is."""
        batches = [self._materialize_parent(p) for p in self.plan.parents(op)]
        first = batches[0]
        cols: dict[str, np.ndarray] = {}
        dicts: dict[str, Dictionary] = {}
        for name in first.dtypes:
            parts = [b.cols[name] for b in batches]
            if name in first.dicts:
                target = dicts[name] = Dictionary(first.dicts[name].values())
                for i, b in enumerate(batches):
                    lut = b.dicts[name].translate_to(target, insert=True)
                    if not np.array_equal(lut, np.arange(len(lut))):
                        parts[i] = apply_lut_np(lut, parts[i])
            cols[name] = np.concatenate(parts)
        return HostBatch(dict(first.dtypes), dicts, cols)

    def _materialize_parent(self, parent) -> HostBatch:
        head, chain = self._upstream_chain(parent)
        if not chain and not isinstance(head, MemorySourceOp):
            return self._eval_blocking(head)
        return self._consume_to_batch(parent)

    # --------------------------------------------------------------------- agg
    def _plan_group_keys(self, op: AggOp, kern: ChainKernel, src, head) -> list[GroupKey]:
        keys = []
        for name in op.groups:
            sv = kern.ctx.sym.get(name)
            if sv is None:
                raise CompilerError(f"group key {name!r} not found")
            if sv.dictionary is not None:
                keys.append(
                    GroupKey(
                        name,
                        "dict",
                        next_pow2(max(sv.dictionary.size, 1)),
                        sv.dtype,
                        sv.dictionary,
                        key_sval=sv,
                    )
                )
                continue
            # A bin key gets window-range semantics ONLY over the source time
            # column — px.bin over a value column must go through the generic
            # paths or it would collapse into bogus time-range bins.
            wk = _window_key(kern.ctx.provenance.get(name), kern.time_col)
            if wk is not None and sv.dtype in (DT.TIME64NS, DT.INT64):
                width = wk
                t_min, t_max = _source_time_range(src, head)
                t0_bin = t_min // width
                nbins = int(t_max // width - t0_bin) + 1
                # The window ORIGIN is a runtime scalar of the chain program
                # (see _refresh_window_keys); only the bin-count bucket is
                # static.
                t0name = f"__origin{len(keys)}"
                keys.append(
                    GroupKey(
                        name,
                        "window",
                        next_pow2(max(nbins, MIN_WINDOW_BINS)),
                        sv.dtype,
                        width=width,
                        t0_bin=int(t0_bin),
                        key_sval=sv,
                        lut_name=t0name,
                    )
                )
                continue
            if sv.dtype in (DT.INT64, DT.TIME64NS, DT.BOOLEAN):
                prov = kern.ctx.provenance.get(name)
                if not isinstance(prov, Column):
                    raise GroupKeyFallback(
                        f"group key {name!r} is a computed numeric column"
                    )
                # Device-side encoding: the uniques come from the per-table
                # incremental union when available; otherwise one prescan
                # over this query's cursor.  Sorted, so dictionary code ==
                # sorted position; the kernel maps value→code against a
                # small runtime array — no per-batch host encode.
                qd = Dictionary()
                u = None
                if isinstance(head, MemorySourceOp) and head.tablet is None:
                    t = self.store.table(head.table)
                    if type(t) is Table and prov.name in t.relation:
                        u = _int_key_uniques(t, prov.name, src)
                if u is None:
                    u = _sorted_uniques(src, prov.name)
                if len(u) > MAX_GROUPS:
                    # the bound below would refuse it: fall back before
                    # building a dictionary of every distinct value
                    raise GroupKeyFallback(
                        f"group cardinality bound {next_pow2(len(u))} exceeds {MAX_GROUPS}")
                qd.encode(u.tolist())
                vals = np.asarray(qd.values(), dtype=np.int64)
                lut_name = kern.ctx.ec._add_lut(vals)
                keys.append(
                    GroupKey(
                        name,
                        "intdevice",
                        next_pow2(max(qd.size, 1)),
                        sv.dtype,
                        qd,
                        src_name=prov.name,
                        lut_name=lut_name,
                    )
                )
                continue
            raise GroupKeyFallback(f"group key {name!r} has type {sv.dtype.name}")
        total = 1
        for k in keys:
            total *= k.card
        if total > MAX_GROUPS:
            raise GroupKeyFallback(
                f"group cardinality bound {total} exceeds {MAX_GROUPS}"
            )
        return keys

    def _run_agg(self, op: AggOp) -> HostBatch:
        try:
            keys, udas, state_np, seen_name, in_types, val_dicts = self._agg_state(
                op, finalize=True)
        except GroupKeyFallback:
            return self._run_agg_sorted(op)
        self._fold_route_wall()  # the finalize route's state is pulled
        return self._finalize_agg(op, keys, udas, state_np, seen_name, in_types,
                                  val_dicts)

    # -------------------------------------------------- sort-based agg fallback
    def _sorted_group_reduce(self, op: AggOp):
        """Sort-based group-by for keys with no bounded dense code space.

        Two phases, as in the reference: (1) the chain runs through its
        output step and the group-key and value columns come back to the
        host (`_consume_to_batch`); (2) the host factorizes the composite
        key (np.unique per key, then a mixed radix or a record unique) and
        the per-group reduction goes back to the device as UDA updates over
        exact group ids, SORT_AGG_CHUNK rows at a time, into state of
        Gb = next_pow2(G) groups.

        Returns (group_cols, dtypes, dicts, udas, in_types, state, G,
        val_dicts): `state` is the device state; val_dicts maps dict-valued
        picker outputs to the dictionary their code state decodes through.
        """
        self.stats["sorted_agg_fallbacks"] = self.stats.get("sorted_agg_fallbacks", 0) + 1
        parent = self.plan.parents(op)[0]
        need = list(dict.fromkeys(
            [*op.groups, *[ae.arg for ae in op.values if ae.arg is not None]]
        ))
        hb = self._consume_to_batch(parent, need)
        cols, out_dtypes, out_dicts = hb.cols, hb.dtypes, hb.dicts
        n = hb.num_rows

        # ---- composite key factorization (host sort)
        valid = np.ones(n, dtype=bool)
        per_inv, per_card = [], []
        for g in op.groups:
            arr = cols[g]
            if g in out_dicts:
                valid &= arr >= 0  # null keys drop out (pandas dropna)
            elif arr.dtype.kind == "f":
                valid &= ~np.isnan(arr)  # NaN keys drop out (pandas dropna)
            u, inv = np.unique(arr, return_inverse=True)
            per_inv.append(inv.reshape(-1).astype(np.int64))
            per_card.append(len(u))
        total_card = 1
        for c in per_card:
            total_card *= max(c, 1)
        if total_card < (1 << 62):
            comp = per_inv[0]
            for inv, card in zip(per_inv[1:], per_card[1:]):
                comp = comp * card + inv
            space = total_card
        else:
            # a mixed radix would overflow int64: unique over the record rows
            _u, comp = np.unique(np.rec.fromarrays(per_inv), return_inverse=True)
            comp = comp.reshape(-1).astype(np.int64)
            space = len(_u)
        vrows = np.nonzero(valid)[0]
        if space <= 2 * n:
            # a composite code space about the size of the rows (one key, or
            # few): the present codes, one row of each and the exact group
            # ids by scatter and gather instead of a sort and a binary search
            # (the same ids: groups in ascending code order)
            cv = comp[vrows]
            present = np.zeros(space, dtype=bool)
            present[cv] = True
            uniq_comp = np.flatnonzero(present)
            rep = np.zeros(space, dtype=np.int64)
            rep[cv] = vrows  # any row of a group holds its key values
            rep_rows = rep[uniq_comp]
            G = len(uniq_comp)
            gid_np = (np.cumsum(present) - 1)[comp].clip(0, None).astype(np.int32)
        else:
            uniq_comp, first_in_valid = (
                np.unique(comp[vrows], return_index=True)
                if len(vrows)
                else (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
            )
            G = len(uniq_comp)
            rep_rows = vrows[first_in_valid]  # one representative row per group
            gid_np = np.searchsorted(uniq_comp, comp).clip(0, max(G - 1, 0)).astype(np.int32)
        group_cols = {g: cols[g][rep_rows] for g in op.groups}
        Gb = max(next_pow2(max(G, 1)), 1)

        # ---- device reduction over exact gids, chunked
        udas, in_types, init_pairs = [], {}, []
        val_dicts: dict[str, Dictionary] = {}
        dict_val_cols: set[str] = set()
        for ae in op.values:
            uda = self.registry.uda(ae.fn)
            in_dt = None
            in_types[ae.out_name] = None
            if ae.arg is not None:
                if ae.arg in out_dicts:
                    if not uda.dict_ok:
                        raise Unimplemented(
                            f"aggregate {ae.fn} over string column {ae.arg!r}"
                        )
                    in_types[ae.out_name] = out_dtypes[ae.arg]
                    in_dt = np.int32
                    val_dicts[ae.out_name] = out_dicts[ae.arg]
                    dict_val_cols.add(ae.arg)
                else:
                    if uda.needs_dict:
                        raise Unimplemented(
                            f"aggregate {ae.fn} requires a string "
                            f"(dictionary-encoded) input column, got "
                            f"{ae.arg!r}"
                        )
                    in_types[ae.out_name] = out_dtypes[ae.arg]
                    in_dt = STORAGE_DTYPE[out_dtypes[ae.arg]]
            elif not uda.nullary:
                raise CompilerError(f"aggregate {ae.fn} requires an input column")
            udas.append((ae.out_name, uda, ae.arg))
            init_pairs.append((ae.out_name, uda, in_dt))
        val_names = sorted({vn for _o, _u, vn in udas if vn is not None})
        # null codes must never win the picker's min-reduction
        for vn in dict_val_cols:
            c = cols[vn]
            cols = {**cols,
                    vn: np.where(c >= 0, c, PICKER_NULL_SENTINEL).astype(np.int32)}

        with self._timed(f"sorted_agg(by={op.groups}, G={G})", [op.id]):
            state = {name: uda.init(Gb, in_dt, self.device)
                     for name, uda, in_dt in init_pairs}
            for off in range(0, n, SORT_AGG_CHUNK):
                end = min(off + SORT_AGG_CHUNK, n)
                # keyed by position: a value column may be named like anything
                host = [gid_np[off:end], valid[off:end],
                        *(cols[vn][off:end] for vn in val_names)]
                dev = self._upload([dict(enumerate(host))], range(len(host)), end - off)
                gid, mask = dev[0], dev[1]
                vals = {vn: dev[2 + i] for i, vn in enumerate(val_names)}
                for out_name, uda, vn in udas:
                    v = vals[vn] if vn is not None else None
                    kw = {"nan_bin": self.nan_bin} if uda.bins_nan else {}
                    state[out_name] = uda.update(state[out_name], gid, v, mask, Gb, **kw)
                if self.analyze and self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        return (group_cols, out_dtypes, out_dicts, udas, in_types, state, G,
                val_dicts)

    def _run_agg_sorted(self, op: AggOp) -> HostBatch:
        (group_cols, in_dtypes, in_dicts, udas, in_types, state, G,
         val_dicts) = self._sorted_group_reduce(op)
        dtypes: dict[str, DT] = {}
        dicts: dict[str, Dictionary] = {}
        cols: dict[str, np.ndarray] = {}
        for g in op.groups:
            dtypes[g] = in_dtypes[g]
            cols[g] = group_cols[g]
            if g in in_dicts:
                dicts[g] = in_dicts[g]
        for out_name, uda, _vn in udas:
            # device finalize where the UDA has one (sketch → quantiles, K3),
            # as the dense path does; else one readback and the host finalize
            if uda.device_finalize:
                full = uda.finalize_from_device(
                    uda.finalize_device(state[out_name]).cpu().numpy())
            elif uda.needs_dict:
                # model-fit UDA: finalize over the input DICTIONARY (unique
                # values + multiplicities), emitting fresh strings
                full = uda.finalize_dict(state[out_name].cpu().numpy(),
                                         val_dicts[out_name])
            else:
                full = uda.finalize_host(tree_map(lambda t: t.cpu().numpy(),
                                                  state[out_name]))
            vals = np.asarray(full)[:G]
            out_dt = (uda.out_type(None) if uda.nullary
                      else uda.out_type(in_types[out_name]))
            if out_name in val_dicts and not uda.needs_dict:
                cols[out_name] = _decode_picker_codes(vals, val_dicts[out_name])
                dicts[out_name] = val_dicts[out_name]
                dtypes[out_name] = out_dt
                continue
            if out_dt == DT.STRING:
                d = Dictionary()
                cols[out_name] = d.encode(vals)
                dicts[out_name] = d
            else:
                cols[out_name] = vals.astype(STORAGE_DTYPE[out_dt], copy=False)
            dtypes[out_name] = out_dt
        return HostBatch(dtypes, dicts, cols)

    def _agg_setup(self, op: AggOp) -> _AggSetup:
        """Chain walk, pruning, the chain kernel and its group keys, and the
        per-run window-origin refresh — everything before the feed loop."""
        head, chain = self._upstream_chain(self.plan.parents(op)[0])
        dtypes, dicts, src, names, visible, time_col, cap = self._input_of(head)
        needed = set(op.groups) | {ae.arg for ae in op.values
                                   if ae.arg is not None}
        dtypes, dicts, names, visible, chain = _prune_to_needed(
            head, chain, dtypes, dicts, names, visible, time_col, needed,
        )
        (kern, keys, udas, in_types, init_specs, num_groups, seen_name, step,
         val_dicts) = self._agg_kernel(op, dtypes, dicts, chain, time_col,
                                       visible, src, head)
        ok, keys, origins = self._refresh_window_keys(keys, src, head)
        if not ok:
            # Concurrent ingest grew the time span between the key planning
            # and the refresh: running with a stale bucket would silently
            # alias windows — fail loudly.
            raise Internal("window-bin bucket overflowed (concurrent ingest); "
                           "retry the query")
        return _AggSetup(
            op=op, head=head, chain=chain, src=src, names=names, cap=cap,
            kern=kern, keys=keys, udas=udas, in_types=in_types,
            init_specs=init_specs, num_groups=num_groups, seen_name=seen_name,
            step=step, val_dicts=val_dicts, origins=origins, dtypes=dtypes, dicts=dicts,
            time_col=time_col)

    def _agg_state(self, op: AggOp, finalize: bool = False):
        """Run the aggregation; returns the device state (a _DeferredState
        under the distributed partial path's deferral), or with `finalize`
        the pulled state with its device-finalized outputs (the local
        route), and what finalizing it needs."""
        s = self._agg_setup(op)
        t_lo, t_hi = _time_bounds(s.head)
        t0 = _time.perf_counter_ns()
        with self._timed(self._chain_label(s.head, s.chain, "partial_agg"),
                         ([s.head.id] if s.head.id >= 0 else []) + [o.id for o in s.chain]):
            route, state = self._cpu_route_state(s, t_lo, t_hi)
            if not route:
                # LUTs come from the device LUT cache (device_luts)
                luts = device_luts(s.kern.luts, self.device)
                state = self._agg_feed_loop(s.kern, s.step, s.init_specs, s.num_groups,
                                            s.src, s.names, s.cap, t_lo, t_hi, luts,
                                            s.origins, s.udas, finalize=finalize,
                                            fuse=not s.val_dicts)
                if self._defer_active:
                    state = _DeferredState(
                        [state], {name: uda.reduce_ops() for name, uda, _vb in s.udas})
        arm = CPU if route else DEVICE
        self._route_of_last_agg = arm
        self.stats.setdefault("routes", []).append(
            {"chain": self._chain_label(s.head, s.chain, "agg"), "arm": arm,
             "route": route or "device"})
        self._route_wall = (s.src, arm, t0)
        return s.keys, s.udas, state, s.seen_name, s.in_types, s.val_dicts

    def _cpu_route_state(self, s: _AggSetup, t_lo: int, t_hi: int) -> tuple:
        """→ (the host fast path that ran, the aggregate's state as numpy),
        or (None, None) when the query is routed to the card, or routed to
        the CPU but admitted by neither fast path (it then runs the card
        route).  The np_partial loop first, then the whole-plan loop, as the
        reference tries them; neither runs over a mesh.  Counted in
        np_fast_polls and wholeplan_native."""
        if self.mesh is not None or self._backend_for(s.src) != CPU:
            return None, None
        if _native_build.load_native() is None and _native_build.build_error():
            self.stats["native_build_error"] = _native_build.build_error()
        # the host paths read each window key's origin from luts[name][0]
        luts = {**s.kern.luts,
                **{k: np.asarray([v], dtype=np.int64) for k, v in s.origins.items()}}
        if (np_partial.eligible(s.kern, s.keys, s.udas, s.val_dicts, t_lo, t_hi, s.src)
                and np_partial.value_args_ok(s.kern, s.op, s.names)):
            state = np_partial.run(self, s.src, s.names, s.cap, s.kern, s.keys, s.init_specs,
                                   s.num_groups, t_lo, t_hi, luts,
                                   np_partial.value_args(s.kern, s.op))
            self.stats["np_fast_polls"] = self.stats.get("np_fast_polls", 0) + 1
            return "np_partial", state
        prog = self._wholeplan_program(s)
        if prog is None or not _codegen.applicable(prog, t_lo, t_hi):
            return None, None
        state = _codegen.run(self, prog, s.src, s.num_groups, s.init_specs, t_lo, t_hi, luts)
        self.stats["wholeplan_native"] = self.stats.get("wholeplan_native", 0) + 1
        return "wholeplan_native", state

    def _wholeplan_program(self, s: _AggSetup):
        """Fetch-or-lower the native whole-plan micro-program for this agg
        chain (engine.plancache.native_programs, keyed by `_native_sig`).
        None = out of scope: the query runs the card route instead."""
        if s.val_dicts or not hasattr(s.src, "__iter__"):
            return None
        # the flag is re-read HERE, outside the program cache: a cached
        # program must not outlive an operator flipping the kill switch,
        # and flag-off-at-first-query must not poison the sig with None
        if not _flags.get("PX_WHOLEPLAN_NATIVE"):
            return None
        from pixie_tpu_torch.engine.plancache import native_programs

        return native_programs.get_or_lower(
            _native_sig(s),
            lambda: _codegen.lower(s.kern, s.chain, s.op, s.keys, s.init_specs, s.dtypes,
                                   s.dicts, s.names, s.time_col))

    def _refresh_window_keys(self, keys, src, head):
        """Per-run window-origin resolution.

        Returns (ok, keys', origins).  keys' holds GroupKey copies with this
        run's t0_bin, and origins maps each window key's scalar name to its
        origin (a runtime scalar of the chain program, so a new origin
        reuses the program).  ok=False means the static bin bucket can't
        hold this run's span."""
        if not any(k.kind == "window" for k in keys):
            return True, keys, {}
        t_min, t_max = _source_time_range(src, head)
        out, over = [], {}
        for k in keys:
            if k.kind != "window":
                out.append(k)
                continue
            t0 = int(t_min // k.width)
            nbins = int(t_max // k.width) - t0 + 1
            if nbins > k.card:
                return False, keys, {}
            out.append(dataclasses.replace(k, t0_bin=t0))
            over[k.lut_name] = t0
        return True, out, over

    def _agg_kernel(self, op, dtypes, dicts, chain, time_col, visible, src, head):
        """Build the chain kernel, group keys and UDA specs for `op`."""
        kern = ChainKernel(dtypes, dicts, chain, self.registry, time_col,
                           self.device, visible, self.nan_bin)
        keys = self._plan_group_keys(op, kern, src, head)
        num_groups = 1
        for k in keys:
            num_groups *= k.card

        # UDA instances + value builders (+ implicit row counter for
        # seen-groups).
        udas = []
        init_specs = []
        seen_name = "__seen"
        val_dicts: dict[str, Dictionary] = {}
        in_types: dict[str, DT | None] = {}
        for ae in op.values:
            uda = self.registry.uda(ae.fn)
            vb = None
            in_dtype = None
            in_types[ae.out_name] = None
            if ae.arg is not None:
                sv = kern.ctx.sym.get(ae.arg)
                if sv is None:
                    raise CompilerError(f"agg input column {ae.arg!r} not found")
                if sv.dictionary is not None:
                    if not uda.dict_ok:
                        raise Unimplemented(
                            f"aggregate {ae.fn} over string column {ae.arg!r}"
                        )
                    # Dict-valued picker: aggregate over CODES (null code -1
                    # masked to the min-identity so it never wins); the
                    # finalize step decodes back through the dictionary.
                    vb = _picker_codes(sv)
                    in_dtype = np.int32
                    in_types[ae.out_name] = sv.dtype
                    val_dicts[ae.out_name] = sv.dictionary
                else:
                    if uda.needs_dict:
                        raise Unimplemented(
                            f"aggregate {ae.fn} requires a string "
                            f"(dictionary-encoded) input column, got "
                            f"{ae.arg!r}"
                        )
                    vb = sv
                    in_dtype = STORAGE_DTYPE[sv.dtype]
                    in_types[ae.out_name] = sv.dtype
            elif not uda.nullary:
                raise CompilerError(f"aggregate {ae.fn} requires an input column")
            udas.append((ae.out_name, uda, vb))
            init_specs.append((ae.out_name, uda, in_dtype))
        seen_uda = CountUDA()
        udas.append((seen_name, seen_uda, None))
        init_specs.append((seen_name, seen_uda, None))

        step = kern.make_agg_step(keys, udas, num_groups)
        self.stats["chain_leaves"] = self.stats.get("chain_leaves", 0) + kern.n_leaves
        return (kern, keys, udas, in_types, init_specs, num_groups, seen_name,
                step, val_dicts)

    def _init_states(self, init_specs, num_groups, n: int) -> list:
        """n identity states (one per mesh shard, or one)."""
        return [{name: uda.init(num_groups, in_dt, self.device)
                 for name, uda, in_dt in init_specs} for _ in range(n)]

    def _spmd_feed(self, cols, n_valid) -> Optional[np.ndarray]:
        """Per-shard valid rows of an SPMD feed, counted in spmd_feeds and the
        shard placement stats — or None when the feed's rows do not split
        into the mesh's shards (a mesh whose width is not a power of two):
        that feed runs the single-device step into shard 0's state, as the
        reference runs it, counted in spmd_skipped_feeds."""
        from pixie_tpu_torch.parallel.spmd import per_shard_valid

        n_dev = self.mesh.size
        bucket = _first_len(cols)
        if bucket % n_dev:
            self.stats["spmd_skipped_feeds"] = self.stats.get("spmd_skipped_feeds", 0) + 1
            return None
        nv = per_shard_valid(n_valid, bucket, n_dev)
        self.stats["spmd_feeds"] = self.stats.get("spmd_feeds", 0) + 1
        self._note_shard_rows(nv)
        return nv

    def _agg_feed_loop(self, kern, step, init_specs, num_groups, src, names,
                       cap, t_lo, t_hi, luts, origins=None, udas=None,
                       finalize: bool = False, fuse: bool = False):
        """Drive the feeds through the agg step.

        The state is created on the device before the first feed runs and
        every feed's UDA updates accumulate into it IN PLACE (the kernels add
        into the state tensors), so feeds allocate no per-feed partial state
        and need no merge.  Over a mesh (an unlimited agg) each shard keeps
        its own state in place.  Without `finalize` this returns the device
        state, the shards' states merged by one collective merge (M1).

        With `finalize` (the local route of an unlimited agg) it returns the
        pulled state, device-finalized outputs as _FinalizedCol: one F2
        launch (ops/finalize.py) merges the shards' states (N = 1 without a
        mesh), finalizes the sketches and packs the output for one readback.
        When the snapshot predicts exactly one feed (the interactive warm
        query: no limit, not analyze, no mesh) the feed is held back and F1
        runs the whole query in one launch: the chain, every UDA's update of
        a fresh identity state, the finalize and the pack (stat
        fused_single_feed).  A second feed that does arrive sends the held
        one down the ordinary route first (a safety net: the prediction is
        exact for a cursor snapshot).  `fuse` is False when the aggregate
        cannot run as one gang member (a dictionary-valued aggregate).
        """
        spmd = self.mesh is not None and not kern.has_limit
        fin = finalize and not kern.has_limit
        fuse_ok = (fin and fuse and not spmd and not self.analyze
                   and self._predicted_single_feed(src, cap,
                                                   f1_shape(num_groups, init_specs, udas)))
        states = None
        held = None
        remaining = kern.init_limits()
        if spmd:
            from pixie_tpu_torch.parallel.spmd import shard_step

            run_shards = shard_step(
                lambda c, v, st: step(c, v, t_lo, t_hi, None, luts, st, origins), self.mesh)
        for cols, n_valid in self._feed(src, names, cap, spmd=spmd):
            if fuse_ok and held is None and states is None:
                held = (cols, n_valid)
                continue
            tf0 = _time.perf_counter_ns()
            if states is None:
                states = self._init_states(init_specs, num_groups,
                                           self.mesh.size if spmd else 1)
            if held is not None:
                states[0], _consumed = step(*held, t_lo, t_hi, remaining, luts, states[0],
                                            origins)
                held = None
            nv = self._spmd_feed(cols, n_valid) if spmd else None
            if nv is not None:
                run_shards(cols, nv, states)
            else:
                states[0], consumed = step(cols, n_valid, t_lo, t_hi, remaining, luts,
                                           states[0], origins)
                if kern.has_limit:
                    remaining = remaining - consumed
            if self.analyze:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.stats.setdefault("feed_ns", []).append(
                    _time.perf_counter_ns() - tf0)
        if held is not None:
            got = self._fused_finalize(kern, init_specs, num_groups, udas, held, t_lo, t_hi,
                                       luts, origins)
            if got is not None:
                return got
            states = self._init_states(init_specs, num_groups, 1)
            states[0], _consumed = step(*held, t_lo, t_hi, remaining, luts, states[0], origins)
        if states is None:  # no feed at all: the identity state
            states = self._init_states(init_specs, num_groups, self.mesh.size if spmd else 1)
        rt = {name: uda.reduce_ops() for name, uda, _vb in udas}
        if fin:
            return self._pull_finalized(_fin.merge_finalize(
                states, rt, _fin.finals_of((name, uda) for name, uda, _vb in udas)))
        if finalize:  # a limit query keeps its route: K3, then one readback
            return self._device_finalized_k3(states[0], udas)
        if len(states) == 1:
            return states[0]
        from pixie_tpu_torch.parallel.spmd import collective_merge

        return collective_merge(states, rt)

    def _fused_finalize(self, kern, init_specs, num_groups, udas, held, t_lo, t_hi, luts,
                        origins) -> Optional[dict]:
        """The single-feed query in one F1 launch → the pulled, finalized
        state; None when a UDA's state has no gang update (the caller runs the
        held feed on the ordinary route)."""
        def init(device):
            return {name: uda.init(num_groups, dt, device) for name, uda, dt in init_specs}

        key = f1_key(num_groups, init_specs)
        if not f1_shape(num_groups, init_specs, udas)[0]:
            return None
        cols, n_valid = held
        res = _fin.fused_partial_finalize(
            lambda st: kern.gang_member(cols, n_valid, t_lo, t_hi, luts, st, origins),
            init, {name: uda.reduce_ops() for name, uda, _vb in udas},
            _fin.finals_of((name, uda) for name, uda, _vb in udas),
            _first_len(cols), self.device, key)
        self.stats["fused_single_feed"] = self.stats.get("fused_single_feed", 0) + 1
        return self._pull_finalized(res)

    @staticmethod
    def _pull_finalized(res) -> dict:
        """An F1 / F2 output → one readback → {name: numpy state tree, or
        _FinalizedCol for a device-finalized output}."""
        finals, rest = res.unpack(transfer.pull(res.buf))
        return {**rest, **{k: _FinalizedCol(v) for k, v in finals.items()}}

    def _predicted_single_feed(self, src, cap, f1_table=None) -> bool:
        """At most one feed, predicted from the snapshot's batches by _feed's
        own policy (_feed_batches).  Cursors are immutable snapshots, so a
        concurrent write cannot invalidate it.  With `f1_table` (f1_shape's
        triple) an aggregate whose F1 table does not fit one launch
        (ops/finalize.py f1_fits) is declined before any launch: it takes
        the multi-feed route, counted in exec_stats["f1_declined"]."""
        if isinstance(src, HostBatch):
            one = True
        else:
            one = _feed_count_at_most_one(src, max(cap, int(_flags.get("PX_FEED_ROWS"))))
        if one and f1_table is not None and f1_table[0] and \
                not _fin.f1_fits(f1_table[1], f1_table[2]):
            self.stats["f1_declined"] = self.stats.get("f1_declined", 0) + 1
            return False
        return one

    @staticmethod
    def _device_finalized_k3(state, udas) -> dict:
        """The limit route's finalize: K3 on each device-finalized output, then
        one readback of the results and the remaining state."""
        finals = {out_name: uda.finalize_device(state[out_name])
                  for out_name, uda, _vb in udas if uda.device_finalize}
        rest, finals = transfer.pull(({k: v for k, v in state.items() if k not in finals},
                                      finals))
        return {**rest, **{k: _FinalizedCol(v) for k, v in finals.items()}}

    def _finalize_agg(self, op, keys, udas, state_np, seen_name, in_types=None,
                      val_dicts=None) -> HostBatch:
        """The host finalize of a pulled state (device-finalized outputs
        arrive as _FinalizedCol) into output columns."""
        seen_counts = np.asarray(state_np[seen_name])
        if keys:
            gids = np.nonzero(seen_counts > 0)[0]
        else:
            gids = np.array([0])  # group-by-none always emits one row
        dtypes: dict[str, DT] = {}
        dicts: dict[str, Dictionary] = {}
        cols: dict[str, np.ndarray] = {}
        if keys:
            codes = split_codes(gids, [k.card for k in keys])
            for k, kc in zip(keys, codes):
                dtypes[k.name] = k.out_dtype
                cols[k.name], d = self._decode_key_column(k, kc)
                if d is not None:
                    dicts[k.name] = d
        for out_name, uda, _vb in udas:
            if out_name == seen_name:
                continue
            st = state_np[out_name]
            if isinstance(st, _FinalizedCol):
                full = uda.finalize_from_device(st.col)
            elif uda.needs_dict:
                full = uda.finalize_dict(st, val_dicts[out_name])
            else:
                full = uda.finalize_host(st)
            vals = np.asarray(full)[gids]
            # Use the DECLARED input DataType so e.g. min(time_) stays TIME64NS
            if uda.nullary:
                out_dt = uda.out_type(None)
            elif in_types is not None and out_name in in_types:
                out_dt = uda.out_type(in_types[out_name])
            else:
                out_dt = uda.out_type(_dtype_of(full))
            if val_dicts and out_name in val_dicts and not uda.needs_dict:
                # dict-valued picker: the state holds CODES; out-of-range
                # (all-null group sentinel) decodes to null
                cols[out_name] = _decode_picker_codes(vals, val_dicts[out_name])
                dicts[out_name] = val_dicts[out_name]
                dtypes[out_name] = out_dt
                continue
            if out_dt == DT.STRING:
                d = Dictionary()
                cols[out_name] = d.encode(vals)
                dicts[out_name] = d
            else:
                cols[out_name] = vals.astype(STORAGE_DTYPE[out_dt], copy=False)
            dtypes[out_name] = out_dt
        return HostBatch(dtypes, dicts, cols)

    @staticmethod
    def _decode_key_column(k: GroupKey, codes: np.ndarray):
        """Seen-group codes → (np column, dictionary|None) for key k."""
        if k.kind == "dict":
            return codes.astype(np.int32), k.dictionary
        if k.kind == "intdevice":
            vals = k.dictionary.decode(codes)
            return np.asarray(vals, dtype=STORAGE_DTYPE[k.out_dtype]), None
        return ((codes.astype(np.int64) + k.t0_bin) * k.width).astype(np.int64), None

    # ------------------------------------------------------ distributed agent
    def _partial_agg_batch(self, op: AggOp):
        """Distributed partial path: seen groups as VALUES + raw UDA state
        (see pixie_tpu_torch.parallel.partial.PartialAggBatch), or a
        _DeferredPartial holding the device state under `defer_agg_pull`."""
        self._defer_active = self.defer_agg_pull
        try:
            keys, udas, state, seen_name, in_types, val_dicts = self._agg_state(op)
        except GroupKeyFallback:
            return self._sorted_partial_batch(op)
        finally:
            self._defer_active = False
        if val_dicts:
            raise Internal(
                "dict-valued aggregates must ship rows, not partial state "
                "(the distributed planner cuts them as rows channels)"
            )
        finish_state = functools.partial(self._finish_partial_batch, keys, udas,
                                         seen_name=seen_name, in_types=in_types)
        if isinstance(state, _DeferredState):
            self._fold_route_wall()
            return self._deferred_partial(state.partials, state.reduce_tree, keys, udas,
                                          seen_name, in_types, finish_state)
        if self._route_of_last_agg != CPU:  # else a host fast path's numpy state
            state = transfer.pull_states([state])[0]
        self._fold_route_wall()
        return finish_state(state)

    def _deferred_partial(self, partials, reduce_tree, keys, udas, seen_name, in_types,
                          finish_state) -> _DeferredPartial:
        """A partial whose device state the cluster pulls (or merges with M1)
        together with every other agent's."""
        return _DeferredPartial(
            partials,
            # one state per agent (the feed loop accumulates in place)
            lambda pulled: finish_state(pulled[0]),
            layout_fp=self._partial_layout_fp(keys, udas, in_types, seen_name),
            finish_state=finish_state,
            reduce_tree=reduce_tree,
        )

    @staticmethod
    def _partial_layout_fp(keys, udas, in_types, seen_name):
        """Fingerprint of the partial state's LAYOUT + key code spaces.  Two
        agents with equal fingerprints produce states indexed identically
        (same composite group-code meaning), so their states may merge on
        device BEFORE decode.  Dictionaries fingerprint by CONTENT — two
        stores ingesting different values hash apart and take the host
        value-keyed merge instead."""
        key_fp = []
        for k in keys:
            d_fp = (_dict_fingerprint(k.dictionary)
                    if k.dictionary is not None else None)
            key_fp.append((k.name, k.kind, k.card, int(k.out_dtype), d_fp,
                           k.width, k.t0_bin))
        uda_fp = tuple((name, type(uda).__name__) for name, uda, _vb in udas)
        return (tuple(key_fp), uda_fp, seen_name,
                tuple(sorted((k, -1 if v is None else int(v))
                             for k, v in in_types.items())))

    def _finish_partial_batch(self, keys, udas, state_np, seen_name, in_types):
        from pixie_tpu_torch.parallel.partial import PartialAggBatch

        seen_counts = np.asarray(state_np[seen_name])
        if keys:
            gids = np.nonzero(seen_counts > 0)[0]
        else:
            gids = np.array([0])
        key_cols: dict = {}
        key_dtypes: dict = {}
        if keys:
            codes = split_codes(gids, [k.card for k in keys])
            for k, kc in zip(keys, codes):
                key_dtypes[k.name] = k.out_dtype
                col, d = self._decode_key_column(k, kc)
                if d is not None:
                    # ship VALUES — each agent has a private code space
                    key_cols[k.name] = np.asarray(d.decode(col), dtype=object)
                else:
                    key_cols[k.name] = col
        states = {}
        for out_name, _uda, _vb in udas:
            if out_name == seen_name:
                continue
            states[out_name] = tree_map(lambda x: np.asarray(x)[gids],
                                        state_np[out_name])
        return PartialAggBatch(
            key_cols=key_cols, key_dtypes=key_dtypes, states=states,
            in_types=dict(in_types),
        )

    def _sorted_partial_batch(self, op: AggOp):
        """Distributed partial for the sorted path: group key VALUES + dense
        state sliced to the seen groups (same wire shape as
        _partial_agg_batch; never deferred)."""
        from pixie_tpu_torch.parallel.partial import PartialAggBatch

        (group_cols, in_dtypes, in_dicts, udas, in_types, state, G,
         val_dicts) = self._sorted_group_reduce(op)
        if val_dicts:
            raise Internal(
                "dict-valued aggregates must ship rows, not partial state "
                "(the distributed planner cuts them as rows channels)"
            )
        key_cols, key_dtypes = {}, {}
        for g in op.groups:
            key_dtypes[g] = in_dtypes[g]
            if g in in_dicts:
                key_cols[g] = np.asarray(in_dicts[g].decode(group_cols[g]), dtype=object)
            else:
                key_cols[g] = group_cols[g]
        state_np = transfer.pull_states([state])[0]
        states = {
            out_name: tree_map(lambda x: np.asarray(x)[:G], state_np[out_name])
            for out_name, _uda, _vn in udas
        }
        return PartialAggBatch(
            key_cols=key_cols, key_dtypes=key_dtypes, states=states,
            in_types=dict(in_types),
        )

    # ------------------------------------------------- multi-query gang
    def _gang_agg_payloads(self) -> dict:
        """{channel: payload} for the agg_state sinks executed as ONE
        multi-query gang — two or more distinct partial aggs reading a single
        MemorySourceOp (the fused-batch agent-plan shape).  Empty when the
        gang is off (PX_MQ_FUSION, analyze) or does not apply; such sinks run
        one by one as before."""
        if not mq_fusion_enabled(self.device) or self.analyze:
            return {}
        groups: dict[int, list] = {}
        for sink in self.plan.sinks():
            if not isinstance(sink, ResultSinkOp) or sink.payload != "agg_state":
                continue
            parent = self.plan.parents(sink)[0]
            if not (isinstance(parent, AggOp) and parent.partial):
                continue
            try:
                head, _ops = self._upstream_chain(self.plan.parents(parent)[0])
            except Internal:
                continue
            if isinstance(head, MemorySourceOp):
                groups.setdefault(head.id, []).append((sink.channel, parent))
        out: dict = {}
        for g in groups.values():
            # one agg feeding several channels computes ONCE: dedup by op
            # identity before the gang, then fan the payload out per channel
            uniq, seen = [], set()
            for _c, p in g:
                if id(p) not in seen:
                    seen.add(id(p))
                    uniq.append(p)
            if len(uniq) < 2:
                continue
            got = self._multi_partial_agg(uniq)
            if got is None:
                continue
            for cid, parent in g:
                out[cid] = got[parent.id]
        if out and _autotune.enabled():
            # record-only gate: the gang's choice is PX_MQ_FUSION's; the
            # model attributes it but never flips it per query
            self.stats.setdefault("autotune", []).append({
                "gate": _autotune.GATE_MQ_FUSION, "plan_class": "agg",
                "size_bucket": _autotune.size_bucket(len(out)),
                "arm": "fused", "static_arm": "fused", "source": "static",
                "model_ms": None, "static_ms": None, "n": len(out)})
        return out

    def _multi_partial_agg(self, ops: list) -> Optional[dict]:
        """Execute N partial aggregates over ONE shared scan as a gang: each
        feed is one launch of kernel G1 (ops/gang.py) that runs every
        member's chain program and folds its kept rows into its state, in
        place; then the whole gang reads back in one transfer wave, or, under
        `defer_agg_pull`, each member's state stays on the device for the
        cluster's merge (M1).  Returns {op.id: payload}, or None when a
        member is out of scope (a key that takes the sorted fallback, a
        limit, a dictionary-valued aggregate, a UDA whose state G1 cannot
        update): the caller then runs the sinks one by one.  The earliest
        member's cursor snapshot feeds the gang over the union of the
        members' columns; a later member's key sets cover at least its rows
        (tables are append-only).  Over a mesh each shard runs G1 into its
        own member states, and M1 merges each member's shard states once
        after the last feed."""
        leaves0 = self.stats.get("chain_leaves", 0)
        setups = []
        for op in ops:
            try:
                s = self._agg_setup(op)
            except GroupKeyFallback:
                s = None
            if s is None or s.kern.has_limit or s.val_dicts:
                self.stats["chain_leaves"] = leaves0
                return None
            if not setups and self.mesh is None and self._backend_for(s.src) != DEVICE:
                # CPU-routed queries keep the per-member np_partial /
                # whole-plan loops (memory-speed host paths); the gang
                # amortizes the card's launches and readback wave — decided
                # on the FIRST setup so a decline wastes only one
                self.stats["chain_leaves"] = leaves0
                return None
            setups.append(s)
        spmd = self.mesh is not None
        n_shards = self.mesh.size if spmd else 1
        per_member = [self._init_states(s.init_specs, s.num_groups, n_shards)
                      for s in setups]
        # shard_states[i][j]: member j's state on shard i
        shard_states = [[pm[i] for pm in per_member] for i in range(n_shards)]
        if any(uda.gang_leaves(st[name]) is None
               for s, st in zip(setups, shard_states[0])
               for name, uda, _dt in s.init_specs):
            self.stats["chain_leaves"] = leaves0
            return None
        union_names: list[str] = []
        for s in setups:
            union_names.extend(n for n in s.names if n not in union_names)
        t_lo, t_hi = _time_bounds(setups[0].head)
        # LUTs come from the device LUT cache (device_luts)
        luts = [device_luts(s.kern.luts, self.device) for s in setups]

        def run_gang(cols, n_valid, states):
            members = [s.kern.gang_member(cols, n_valid, t_lo, t_hi, lut, st, s.origins)
                       for s, lut, st in zip(setups, luts, states)]
            _gang.run(members, _first_len(cols), self.device)

        if spmd:
            from pixie_tpu_torch.parallel.spmd import collective_merge, reduce_tree_for, shard_step

            run_shards = shard_step(run_gang, self.mesh)
        with self._timed(f"mq_gang[{len(setups)}]", [op.id for op in ops]):
            waves = 0
            for cols, n_valid in self._feed(setups[0].src, union_names, setups[0].cap,
                                            spmd=spmd):
                nv = self._spmd_feed(cols, n_valid) if spmd else None
                if nv is not None:
                    run_shards(cols, nv, shard_states)
                else:
                    run_gang(cols, n_valid, shard_states[0])
                waves += 1
            self.stats["mq_waves"] = self.stats.get("mq_waves", 0) + waves
            states = shard_states[0]
            if spmd:
                states = [collective_merge([sh[j] for sh in shard_states],
                                           reduce_tree_for(s.udas))
                          for j, s in enumerate(setups)]
            finishers = [functools.partial(self._finish_partial_batch, s.keys, s.udas,
                                           seen_name=s.seen_name, in_types=s.in_types)
                         for s in setups]
            if self.defer_agg_pull:
                got = [self._deferred_partial(
                    [st], {name: uda.reduce_ops() for name, uda, _vb in s.udas},
                    s.keys, s.udas, s.seen_name, s.in_types, fin)
                    for s, st, fin in zip(setups, states, finishers)]
            else:
                got = [fin(pulled) for fin, pulled in
                       zip(finishers, transfer.pull_states(states))]
        self.stats["mq_fused"] = self.stats.get("mq_fused", 0) + len(setups)
        return {s.op.id: g for s, g in zip(setups, got)}

    def _partition_buckets(self, sink: PartitionSinkOp) -> list:
        """A partition sink's hash buckets, one HostBatch per partition (the
        producer half of a repartitioned join's shuffle edge).  With a mesh
        whose width is the partition count the exchange runs in the mesh
        (kernels X1, X2: parallel/repartition.py mesh_partition_exchange),
        else on the host; both assign partitions by the same value hash, so
        mixed producers interoperate."""
        from pixie_tpu_torch.parallel.repartition import (
            mesh_partition_exchange,
            partition_ids,
            split_host_batch,
        )

        hb = self._materialize_parent(self.plan.parents(sink)[0])
        if self.mesh is not None and self.mesh.size == sink.n_parts and hb.num_rows > 0:
            self.stats["mesh_shuffles"] = self.stats.get("mesh_shuffles", 0) + 1
            return mesh_partition_exchange(hb, sink.keys, sink.n_parts, self.mesh)
        return split_host_batch(hb, partition_ids(hb, sink.keys, sink.n_parts),
                                sink.n_parts)

    def run_agent(self) -> dict:
        """Execute an AGENT plan: returns {channel: payload} where payload is a
        HostBatch (rows channels and partition buckets), a PartialAggBatch
        (agg_state channels) or, under `defer_agg_pull`, a _DeferredPartial.
        Partial aggregates over one shared scan run as a multi-query gang
        (`_gang_agg_payloads`)."""
        out = {}
        t0 = _time.perf_counter_ns()
        gang = self._gang_agg_payloads()
        for sink in self.plan.sinks():
            if isinstance(sink, PartitionSinkOp):
                for p, bucket in enumerate(self._partition_buckets(sink)):
                    out[f"{sink.prefix}{p}"] = bucket
                continue
            if not isinstance(sink, ResultSinkOp):
                raise Internal(f"agent plan sink {sink.kind} is not a ResultSink")
            parent = self.plan.parents(sink)[0]
            if sink.payload == "agg_state":
                if not (isinstance(parent, AggOp) and parent.partial):
                    raise Internal("agg_state channel must be fed by a partial AggOp")
                out[sink.channel] = (gang[sink.channel] if sink.channel in gang
                                     else self._partial_agg_batch(parent))
            else:
                out[sink.channel] = self._materialize_parent(parent)
        self.stats["wall_ns"] = _time.perf_counter_ns() - t0
        self.stats["operators"] = self.op_stats
        self._emit_op_spans()
        return out

    def run_agent_stream(self, agg_chunk_groups: int = 0):
        """Execute an AGENT plan as a chunk stream: yields (channel, payload)
        in wave order — one HostBatch per readback wave for rows channels
        (each wave's D2H rode under a later wave's compute, engine.transfer),
        per group-slice for agg_state channels (`agg_chunk_groups` > 0 caps
        the slice).  A consumer folds each yield as it arrives
        (parallel.partial.PartialAggFold, parallel.cluster.HostBatchUnion);
        run_agent is the barrier shape of the same walk.

        Chunks of one channel are yielded in order, but consumers must not
        rely on it: the folds are order-insensitive by construction.  Partial
        aggregates over one shared scan run as a multi-query gang, computed
        before the first yield, as in run_agent; a partition sink yields one
        chunk per bucket.
        """
        from pixie_tpu_torch.parallel.partial import slice_partial

        t0 = _time.perf_counter_ns()
        gang = self._gang_agg_payloads()
        for sink in self.plan.sinks():
            if isinstance(sink, PartitionSinkOp):
                for p, bucket in enumerate(self._partition_buckets(sink)):
                    yield f"{sink.prefix}{p}", bucket
                continue
            if not isinstance(sink, ResultSinkOp):
                raise Internal(f"agent plan sink {sink.kind} is not a ResultSink")
            parent = self.plan.parents(sink)[0]
            if sink.payload == "agg_state":
                if not (isinstance(parent, AggOp) and parent.partial):
                    raise Internal("agg_state channel must be fed by a partial AggOp")
                pb = (gang[sink.channel] if sink.channel in gang
                      else self._partial_agg_batch(parent))
                n = pb.num_groups
                if agg_chunk_groups > 0 and n > agg_chunk_groups:
                    for a in range(0, n, agg_chunk_groups):
                        idx = np.arange(a, min(a + agg_chunk_groups, n))
                        yield sink.channel, slice_partial(pb, idx)
                else:
                    yield sink.channel, pb
            else:
                out_dtypes, out_dicts, out_names, gen = self._consume_chain(parent)
                sent = False
                for cols, _c in gen:
                    sent = True
                    yield sink.channel, HostBatch(
                        dict(out_dtypes), dict(out_dicts),
                        {name: cols[name] for name in out_names})
                if not sent:
                    # the channel contract is >= 1 payload: an empty scan still
                    # ships one zero-row chunk carrying the dtypes/dicts
                    yield sink.channel, HostBatch(
                        dict(out_dtypes), dict(out_dicts),
                        {name: np.empty(0, STORAGE_DTYPE[out_dtypes[name]])
                         for name in out_names})
        self.stats["wall_ns"] = _time.perf_counter_ns() - t0
        self.stats["operators"] = self.op_stats
        self._emit_op_spans()

    # -------------------------------------------------------------------- join
    def _run_join(self, op: JoinOp) -> HostBatch:
        """Equijoin with full many-to-many expansion, inner/left/right/outer.

        Both parents are materialized on the host and their keys factorized
        into one shared int64 code space (`_composite_codes`); the match
        phase then runs on the host (`_match_pairs`) or, when both sides
        reach 2^16 rows and the gate is on, as kernels J1-J3 on this
        executor's device — on a CPU device, where the native library loads,
        as the native host join (ops/join_device.py).  Null keys (dict code
        -1 or untranslatable values) never match but their rows still
        surface as unmatched in left/right/outer joins (pandas semantics).
        Under PX_AUTOTUNE the gate's decision is the static arm of the
        device_join cost model (engine/autotune.py), except on an executor
        whose force_backend pins it, and on a CUDA device while its host arms
        are off (_host_arms_live).
        """
        parents = self.plan.parents(op)
        if len(parents) != 2:
            raise Internal("join needs two parents")
        left = self._materialize_parent(parents[0])
        right = self._materialize_parent(parents[1])
        if len(op.left_on) != len(op.right_on):
            raise CompilerError("join requires equal-length key lists")
        if op.how not in ("inner", "left", "right", "outer"):
            raise Unimplemented(f"join how={op.how!r}")
        nl, nr = left.num_rows, right.num_rows

        if not op.left_on:
            # Empty key lists = cross join.  When either side is empty,
            # left/right/outer keep the other side's rows with null fills.
            lidx = np.repeat(np.arange(nl, dtype=np.int64), nr)
            ridx = np.tile(np.arange(nr, dtype=np.int64), nl)
            if nr == 0 and op.how in ("left", "outer"):
                lidx = np.arange(nl, dtype=np.int64)
                ridx = np.full(nl, -1, dtype=np.int64)
            elif nl == 0 and op.how in ("right", "outer"):
                ridx = np.arange(nr, dtype=np.int64)
                lidx = np.full(nr, -1, dtype=np.int64)
            return self._join_output(op, left, right, lidx, ridx)

        # Factorize each key pair into a shared integer code space; nulls
        # (dict code -1) are tracked separately and excluded from matching.
        t_codes0 = _time.perf_counter_ns()
        lcodes, rcodes = [], []
        lnull = np.zeros(nl, dtype=bool)
        rnull = np.zeros(nr, dtype=bool)
        for lk, rk in zip(op.left_on, op.right_on):
            lv, rv = left.cols[lk], right.cols[rk]
            ld, rd = left.dicts.get(lk), right.dicts.get(rk)
            if (ld is None) != (rd is None):
                raise CompilerError(f"join key {lk}/{rk}: dictionary/plain mismatch")
            if ld is not None:
                lnull |= lv < 0
                if rd is not ld:
                    rv = apply_lut_np(rd.translate_to(ld, insert=False), rv)
                rnull |= rv < 0
            lcodes.append(np.asarray(lv))
            rcodes.append(np.asarray(rv))
        lc, rc = _composite_codes(lcodes, rcodes)
        split = {"composite_codes": (_time.perf_counter_ns() - t_codes0) / 1e9}

        at_dec = None
        if min(nl, nr) >= (1 << 16):
            # the gate decides from the measured H2D link on the card, the
            # native join's availability on a CPU device (or a forced flag),
            # and its decision is recorded, not silent
            gate = _jd.device_join_gate(self.device)
            self.stats.setdefault("device", {})["join_gate"] = {
                k: v for k, v in gate.items() if k != "flag"}
            if (_autotune.enabled() and gate.get("flag") == -1
                    and self.force_backend is None and self._host_arms_live()):
                # under autotune the gate's decision becomes the STATIC arm
                # of a measured device-vs-host cost model; epsilon probes
                # keep the unfavored arm's cost current.  Both arms return
                # the same matched-pair SET (pair ORDER is unspecified by
                # the join contract either way).  Forced flag settings (0/1)
                # are never overridden.
                at_dec = _autotune.MODEL.decide(
                    _autotune.GATE_DEVICE_JOIN, "join", _autotune.size_bucket(min(nl, nr)),
                    "device" if gate["enabled"] else "host", ("device", "host"))
                self.stats.setdefault("autotune", []).append(at_dec)
        else:
            gate = {"enabled": False}
        use_device = at_dec["arm"] == "device" if at_dec is not None else gate["enabled"]
        t_match0 = _time.perf_counter_ns()
        if use_device:
            # the nulls become sentinels that cannot match (-1 build vs -2
            # probe); then the native host join on a CPU device where the
            # gate took it, else J1-J3 on this executor's device, or raise
            lcx = np.where(lnull, np.int64(-1), lc)
            rcx = np.where(rnull, np.int64(-2), rc)
            if gate.get("path") == "native_cpu":
                lidx, ridx, l_matched, r_matched = _jd.native_join_codes(lcx, rcx)
            else:
                lidx, ridx, l_matched, r_matched = _jd.device_join_codes(
                    lcx, rcx, device=self.device, timings=split if self.analyze else None)
            self.stats["device_joins"] = self.stats.get("device_joins", 0) + 1
        else:
            lidx, ridx, l_matched, r_matched = _match_pairs(lc, rc, lnull, rnull)
        split["match"] = (_time.perf_counter_ns() - t_match0) / 1e9
        if at_dec is not None:
            _autotune.MODEL.observe_decision(at_dec, split["match"])
            # joins often run inside repartition-stage executors whose stats
            # are consumed, not forwarded: the event buffer keeps the record
            _autotune.MODEL.record_row(at_dec)
        lsel, rsel = [lidx], [ridx]
        if op.how in ("left", "outer"):
            lum = np.nonzero(~l_matched)[0]
            lsel.append(lum)
            rsel.append(np.full(len(lum), -1, dtype=np.int64))
        if op.how in ("right", "outer"):
            rum = np.nonzero(~r_matched)[0]
            lsel.append(np.full(len(rum), -1, dtype=np.int64))
            rsel.append(rum)
        lsel = np.concatenate(lsel)
        rsel = np.concatenate(rsel)
        t_out0 = _time.perf_counter_ns()
        out = self._join_output(op, left, right, lsel, rsel)
        split["output"] = (_time.perf_counter_ns() - t_out0) / 1e9
        self.stats.setdefault("join_split_s", []).append(split)
        return out

    def _join_output(self, op, left, right, lsel, rsel) -> HostBatch:
        dtypes, dicts, cols = {}, {}, {}
        outputs = op.output or _default_join_output(left, right)
        for side, col, out_name in outputs:
            src_b = left if side == "left" else right
            sel = lsel if side == "left" else rsel
            cols[out_name] = _take_with_nulls(
                src_b.cols[col], sel, src_b.dtypes[col]
            )
            dtypes[out_name] = src_b.dtypes[col]
            if col in src_b.dicts:
                dicts[out_name] = src_b.dicts[col]
        return HostBatch(dtypes, dicts, cols)

    # -------------------------------------------------------------------- run
    def run(self) -> dict[str, QueryResult]:
        results = {}
        t0 = _time.perf_counter_ns()
        for sink in self.plan.sinks():
            if not isinstance(sink, MemorySinkOp):
                raise Unimplemented(
                    f"plan sink {sink.kind} is not ported yet (only MemorySink "
                    "is; result/partition/OTel sinks come with later slices)")
            parent = self.plan.parents(sink)[0]
            out_dtypes, out_dicts, out_names, gen = self._consume_chain(
                parent, sink.columns)
            cols = _concat_parts(gen, out_names, out_dtypes)
            # physical dtypes + the semantic types the plan propagates from
            # the source schemas (engine/semantics.py)
            rel = sink_relation(self.plan, sink, out_names, out_dtypes,
                                self.store, self.registry)
            nrows = len(next(iter(cols.values()))) if cols else 0
            self.stats["rows_output"] += nrows
            results[sink.name] = QueryResult(
                name=sink.name,
                relation=rel,
                columns=cols,
                dictionaries=dict(out_dicts),
                exec_stats=dict(self.stats),
            )
        self.stats["wall_ns"] = _time.perf_counter_ns() - t0
        self.stats["operators"] = self.op_stats
        self._emit_op_spans()
        for r in results.values():
            r.exec_stats["wall_ns"] = self.stats["wall_ns"]
            r.exec_stats["operators"] = self.op_stats
        return results


# --------------------------------------------------------------------- helpers


def _native_sig(s: _AggSetup) -> tuple:
    """Structural key of an aggregate's whole-plan program: everything
    native/codegen.py lower() bakes in (the chain's and the aggregate's
    operator fields, the pruned feed's column names, types and dictionary
    columns, the time column, each key's kind, card, width and LUT name,
    each UDA and its input dtype)."""
    def op_sig(o):
        d = o.to_dict()
        d.pop("id", None)
        return json.dumps(d, sort_keys=True, default=repr)

    return (tuple(op_sig(o) for o in s.chain), op_sig(s.op),
            tuple(sorted((n, str(dt)) for n, dt in s.dtypes.items())), tuple(sorted(s.dicts)),
            tuple(s.names), s.time_col,
            tuple((k.name, k.kind, k.card, k.width, k.lut_name, k.src_name) for k in s.keys),
            tuple((n, type(u).__name__, None if d is None else str(np.dtype(d)))
                  for n, u, d in s.init_specs))


def _time_bounds(head) -> tuple[int, int]:
    if isinstance(head, MemorySourceOp):
        lo = INT64_MIN if head.start_time is None else int(head.start_time)
        hi = INT64_MAX if head.stop_time is None else int(head.stop_time)
        return lo, hi
    return INT64_MIN, INT64_MAX


def _window_key(expr, time_col: Optional[str]) -> Optional[int]:
    """Detect Call(bin, (Column(time_col), Literal w)) → window width, else
    None.  The binned argument must be the source's time column — only then do
    the t0_bin/nbins range semantics hold."""
    if (
        isinstance(expr, Call)
        and expr.fn == "bin"
        and len(expr.args) == 2
        and time_col is not None
        and isinstance(expr.args[0], Column)
        and expr.args[0].name == time_col
    ):
        w = expr.args[1]
        if isinstance(w, Literal) and isinstance(w.value, int) and w.value > 0:
            return int(w.value)
    return None


def _source_time_range(src, head) -> tuple[int, int]:
    if isinstance(src, HostBatch):
        raise Unimplemented("window group keys require a table source")
    if src.table.time_col is None:
        raise Unimplemented("window group keys require a time_ column")
    rng = src.time_range()  # O(batches): sealed bounds cached at seal time
    t_min, t_max = rng if rng is not None else (0, 0)
    if isinstance(head, MemorySourceOp):
        if head.start_time is not None:
            t_min = max(t_min, int(head.start_time))
        if head.stop_time is not None:
            t_max = min(t_max, int(head.stop_time) - 1)
    return t_min, max(t_min, t_max)


def _sorted_uniques(src, col: str) -> np.ndarray:
    """The column's sorted unique values over a cursor or host batch (a
    dictionary built from them assigns codes in sorted order, as the
    intdevice searchsorted encoding requires)."""
    if isinstance(src, HostBatch):
        return np.unique(src.cols[col])
    parts = [rb.columns[col][: rb.num_valid] for rb, _rid, _gen in src]
    parts = [np.unique(p) for p in parts if len(p)]
    return np.unique(np.concatenate(parts)) if parts else np.empty(0, dtype=np.int64)


def _concat_parts(gen, out_names, out_dtypes) -> dict[str, np.ndarray]:
    """The (np_cols, count) parts of a consumed chain, joined per column."""
    parts = [c for c, _ in gen]
    return {
        n: (np.concatenate([p[n] for p in parts]) if parts
            else np.empty(0, STORAGE_DTYPE[out_dtypes[n]]))
        for n in out_names
    }


def _composite_codes(
    lkeys: list[np.ndarray], rkeys: list[np.ndarray]
) -> tuple[np.ndarray, np.ndarray]:
    """Factorize both sides' (multi-)key rows into one shared int64 code space
    so matching reduces to integer comparison.

    Each key pair factorizes separately FIRST (np.unique collapses NaN on 1-D
    float arrays, giving pandas' NaN==NaN merge semantics), then the per-key
    code columns combine — structured-array comparison over floats would treat
    NaNs as distinct and make join behavior depend on key count.
    """
    nl = len(lkeys[0]) if lkeys else 0
    per = []
    for l, r in zip(lkeys, rkeys):
        _u, inv = np.unique(np.concatenate([l, r]), return_inverse=True)
        per.append(inv.astype(np.int64))
    if len(per) == 1:
        comb = per[0]
    else:
        _u, comb = np.unique(np.rec.fromarrays(per), return_inverse=True)
        comb = comb.astype(np.int64)
    return comb[:nl], comb[nl:]


def _match_pairs(
    lc: np.ndarray, rc: np.ndarray, lnull: np.ndarray, rnull: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """All matching (left_row, right_row) pairs with m:n expansion.

    Returns (lidx, ridx, l_matched[nl], r_matched[nr]).  Sort the valid left
    rows by code; each valid right row finds its [lo, hi) match range by
    binary search and contributes hi-lo pairs.
    """
    nl, nr = len(lc), len(rc)
    lvalid = np.nonzero(~lnull)[0]
    order = lvalid[np.argsort(lc[lvalid], kind="stable")]
    sorted_keys = lc[order]
    if nr >= (1 << 20):
        # Large probe sides: binary-searching random keys over a big sorted
        # array is memory-latency-bound; sorting the probes first makes
        # consecutive searches cache-local.
        rorder = np.argsort(rc, kind="stable")
        rs = rc[rorder]
        lo = np.empty(nr, np.int64)
        hi = np.empty(nr, np.int64)
        lo[rorder] = np.searchsorted(sorted_keys, rs, side="left")
        hi[rorder] = np.searchsorted(sorted_keys, rs, side="right")
    else:
        lo = np.searchsorted(sorted_keys, rc, side="left")
        hi = np.searchsorted(sorted_keys, rc, side="right")
    counts = np.where(rnull, 0, hi - lo)
    total = int(counts.sum())
    ridx = np.repeat(np.arange(nr, dtype=np.int64), counts)
    offsets = np.cumsum(counts) - counts
    within = np.arange(total, dtype=np.int64) - np.repeat(offsets, counts)
    lidx = order[np.repeat(lo, counts) + within]
    l_matched = np.zeros(nl, dtype=bool)
    l_matched[lidx] = True
    r_matched = counts > 0
    return lidx, ridx, l_matched, r_matched


def _take_with_nulls(arr: np.ndarray, sel: np.ndarray, dt: DT) -> np.ndarray:
    """arr[sel] with sel == -1 producing the type's null fill."""
    if len(arr) == 0:
        out = np.zeros(len(sel), dtype=arr.dtype)
        miss = np.ones(len(sel), dtype=bool)
    else:
        out = arr[np.clip(sel, 0, len(arr) - 1)]
        miss = sel < 0
    if miss.any():
        out = out.copy()
        out[miss] = _null_value(dt)
    return out


def _default_join_output(left: HostBatch, right: HostBatch):
    out = []
    for c in right.cols:
        out.append(("right", c, c))
    for c in left.cols:
        if c not in right.cols:
            out.append(("left", c, c))
    return out


def _null_value(dt: DT):
    if dt == DT.FLOAT64:
        return np.nan
    if dt in (DT.STRING, DT.UINT128):
        return -1  # code -1 decodes to None
    return 0


def _dtype_of(arr) -> DT:
    d = np.asarray(arr).dtype
    if d.kind == "f":
        return DT.FLOAT64
    if d.kind in "iu":
        return DT.INT64
    if d.kind == "b":
        return DT.BOOLEAN
    return DT.STRING


def execute_plan(plan: Plan, table_store, registry=None, device=None,
                 analyze: bool = False, mesh="auto",
                 force_backend: Optional[str] = None) -> dict[str, QueryResult]:
    """Run a plan against a table store on `device` (CUDA unless given),
    over `mesh`, routed by size unless `force_backend` pins the arm (see
    PlanExecutor); returns {sink_name: QueryResult}."""
    return PlanExecutor(plan, table_store, registry, device=device,
                        analyze=analyze, mesh=mesh, force_backend=force_backend).run()
