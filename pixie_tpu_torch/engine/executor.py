"""Plan executor, aggregate path: Source → (Map|Filter|Limit)* → Agg → Sink.

This replaces the reference's push-based ExecutionGraph interpreter
(src/carnot/exec/exec_graph.cc:177-295): every maximal Source→(Map|Filter|
Limit)*→Agg chain becomes ONE chain kernel — torch tensor code around the
hand-written CUDA kernels (K1 masked segment reductions, K2 sketch update, K3
sketch quantiles) — run over coalesced column feeds.  Filters never compact on
the device: they refine a validity mask.  The aggregate state lives on the
device and accumulates IN PLACE across feeds (every UDA update writes into its
state tensors); it is finalized on the device where a UDA can (sketch →
quantiles) and read back once, small.

Group-by strategy (see ops/groupby.py): every key must be reducible to a dense
code — dictionary columns natively, raw int columns via a query-time dictionary
built in a host pre-scan of the cursor snapshot, and `px.bin(time)`-derived
window keys via range arithmetic.

Ported so far is the aggregate path of the reference executor
(pixie_tpu/engine/executor.py).  Plain select sinks, joins, unions, UDTF
sources, the sorted high-cardinality fallback, multi-query fusion and the
distributed (SPMD/partial) paths raise Unimplemented and name the slice that
brings them.  Unlike the reference, no query is routed to the CPU by size:
on the card every query runs the device path.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time as _time
from typing import Callable, Optional

import numpy as np
import torch

from pixie_tpu_torch import flags as _flags
from pixie_tpu_torch.engine.eval import ExprCompiler, SVal
from pixie_tpu_torch.engine.result import QueryResult
from pixie_tpu_torch.ops.groupby import combine_codes, encode_against, next_pow2, split_codes
from pixie_tpu_torch.plan.plan import (
    AggOp,
    Call,
    Column,
    FilterOp,
    LimitOp,
    Literal,
    MapOp,
    MemorySinkOp,
    MemorySourceOp,
    Plan,
)
from pixie_tpu_torch.status import CompilerError, Internal, Unavailable, Unimplemented
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.table.table import Table
from pixie_tpu_torch.types import STORAGE_DTYPE, ColumnSchema, DataType as DT, Relation
from pixie_tpu_torch.udf.udf import CountUDA, to_torch_dtype, tree_map

INT64_MIN = int(np.iinfo(np.int64).min)
INT64_MAX = int(np.iinfo(np.int64).max)
MAX_GROUPS = 1 << 22
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


def _decode_picker_codes(vals, d: Dictionary) -> np.ndarray:
    """Picker state codes → int32 dictionary codes; out-of-range (all-null
    sentinel) becomes -1 (null)."""
    codes = np.asarray(vals, dtype=np.int64)
    return np.where((codes < 0) | (codes >= d.size), -1, codes).astype(np.int32)


class GroupKeyFallback(Unimplemented):
    """Group keys not expressible as bounded dense codes (computed numeric
    keys, float keys, cardinality beyond MAX_GROUPS).  The reference reruns
    such aggregates through its sort-based path; the port has not ported it
    yet (a later slice), so the query is refused."""


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
    #: luts entry holding the sorted unique values (intdevice: searchsorted
    #: against it maps value → code on the device).
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


class ChainKernel:
    """Compiles Source → transforms → agg into one step function."""

    def __init__(
        self,
        in_dtypes: dict[str, DT],
        in_dicts: dict[str, Dictionary],
        transforms: list,
        registry,
        time_col: Optional[str],
        device,
        visible: Optional[list[str]] = None,
    ):
        self.device = torch.device(device)
        self.ctx = _ChainCtx(in_dtypes, in_dicts, registry, self.device, visible)
        self.registry = registry
        self.time_col = time_col
        self.steps = []  # ("filter", sval); ("limit", i)
        #: per-LimitOp budgets, in chain order — each limit step tracks its OWN
        #: remaining budget (a single min-collapsed budget under-returns when a
        #: filter between two limits drops admitted rows).
        self.limit_ns: list[int] = []
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

    def _base_mask(self, env, n, n_valid, t_lo, t_hi):
        if n_valid >= n:
            mask = torch.ones(n, dtype=torch.bool, device=self.device)
        else:
            mask = torch.arange(n, device=self.device) < n_valid
        if self.time_col is not None and self.time_col in env["cols"]:
            t = env["cols"][self.time_col]
            mask = mask & (t >= t_lo) & (t < t_hi)
        return mask

    def _apply_steps(self, env, mask, limits):
        """Apply filter/limit steps. Returns (mask, consumed[n_limits]).

        `limits` is the per-limit remaining-budget vector (a device tensor of
        shape [n_limits]).  consumed[i] counts limit i's slots used by THIS
        batch — rows reaching that limit step, capped at its remaining
        budget.  The caller subtracts the whole vector from `remaining`.
        Without limits both are None.
        """
        consumed = (torch.zeros(len(self.limit_ns), dtype=torch.int64,
                                device=self.device) if self.limit_ns else None)
        for kind, sv in self.steps:
            if kind == "filter":
                mask = mask & sv.build(env)
            else:  # limit; sv = budget index
                rem = limits[sv]
                reaching = torch.sum(mask, dtype=torch.int64)
                mask = mask & (torch.cumsum(mask, 0, dtype=torch.int64) <= rem)
                consumed[sv] = torch.minimum(reaching, rem)
        return mask, consumed

    def make_agg_step(self, keys: list[GroupKey], udas: list, num_groups: int):
        """→ fn(cols, n_valid, t_lo, t_hi, limit_remaining, luts, state)
        → (state, consumed), the state updated in place.
        udas: list of (out_name, UDA, value_builder|None)."""
        key_builders = []
        for k in keys:
            if k.kind == "intdevice":
                src_name, lut_name = k.src_name, k.lut_name
                key_builders.append(
                    lambda env, s=src_name, l=lut_name: encode_against(
                        env["luts"][l], env["cols"][s]
                    )
                )
            elif k.kind == "dict":
                key_builders.append(k.key_sval.build)
            else:  # window: origin is a runtime scalar in luts (streaming)
                sv, w, t0name = k.key_sval, k.width, k.lut_name
                key_builders.append(
                    lambda env, sv=sv, w=w, t0name=t0name: (
                        torch.div(sv.build(env), w, rounding_mode="floor")
                        - env["luts"][t0name][0]
                    ).to(torch.int32)
                )
        cards = [k.card for k in keys]

        def step(cols, n_valid, t_lo, t_hi, limit_remaining, luts, state):
            env = {"cols": cols, "luts": luts}
            n = _first_len(cols)
            mask = self._base_mask(env, n, n_valid, t_lo, t_hi)
            mask, consumed = self._apply_steps(env, mask, limit_remaining)
            if keys:
                # literal group keys build scalar codes — broadcast to rows
                code_arrays = [_rows(kb(env), n) for kb in key_builders]
                # Null keys (code -1, e.g. unmatched left-join fills) drop out
                # of the aggregate (pandas dropna semantics); without this,
                # combine_codes would clamp them into group 0.
                for k, c in zip(keys, code_arrays):
                    if k.kind == "dict":
                        mask = mask & (c >= 0)
                gid, _ = combine_codes(code_arrays, cards)
            else:
                gid = torch.zeros(n, dtype=torch.int32, device=self.device)
            for out_name, uda, vb in udas:
                v = _rows(vb(env), n) if vb is not None else None
                state[out_name] = uda.update(state[out_name], gid, v, mask, num_groups)
            return state, consumed

        return step


def _first_len(cols: dict) -> int:
    for v in cols.values():
        return v.shape[0]
    return 0


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
    lut_over: dict


class PlanExecutor:
    def __init__(self, plan: Plan, table_store, registry=None, device=None,
                 analyze: bool = False):
        from pixie_tpu_torch.udf import registry as default_registry

        self.plan = plan
        self.store = table_store
        self.registry = registry or default_registry
        self.device = resolve_device(device)
        self._materialized: dict[int, HostBatch] = {}
        self.stats = {"rows_scanned": 0, "rows_output": 0, "batches": 0,
                      "feeds": 0, "h2d_bytes": 0}
        #: analyze mode (reference ExecutePlan(analyze=true), carnot.cc:318):
        #: synchronizes the device after every feed and records its wall time.
        self.analyze = analyze

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
            if head.tablet is not None:
                raise Unimplemented("tablet sources are not ported yet (slice 6)")
            table = self.store.table(head.table)
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

    def _feed(self, src, names, cap):
        """Yield (cols dict of device tensors, n_valid) feeds.

        Cursor batches (storage granularity) are coalesced into ~FEED_ROWS
        feeds: fewer, larger kernel launches and transfers.
        """
        if isinstance(src, HostBatch):
            self.stats["feeds"] += 1
            yield self._upload([src.cols], names, src.num_rows), src.num_rows
            return
        target = max(cap, int(_flags.get("PX_FEED_ROWS")))
        pend, nrows = [], 0
        for rb, _row_id, _gen in src:  # cursor
            n = rb.num_valid
            if n == 0:
                continue
            pend.append({k: rb.columns[k][:n] for k in names})
            nrows += n
            self.stats["rows_scanned"] += n
            self.stats["batches"] += 1
            if nrows >= target:
                self.stats["feeds"] += 1
                yield self._upload(pend, names, nrows), nrows
                pend, nrows = [], 0
        if pend:
            self.stats["feeds"] += 1
            yield self._upload(pend, names, nrows), nrows

    # ---------------------------------------------------------------- blocking
    def _eval_blocking(self, op) -> HostBatch:
        got = self._materialized.get(op.id)
        if got is not None:
            return got
        if not isinstance(op, AggOp):
            raise Unimplemented(
                f"operator {op.kind!r} is not ported yet: joins come with "
                "slice 3, unions, UDTF sources and remote sources with later "
                "slices")
        out = self._run_agg(op)
        self._materialized[op.id] = out
        return out

    def _consume_chain(self, terminal_parent, out_names=None):
        """Output columns of the chain feeding a sink: (dtypes, dicts, names,
        cols).  Only a bare blocking op (an aggregate) feeding the sink is
        ported — it is already a host batch."""
        head, chain = self._upstream_chain(terminal_parent)
        if chain or isinstance(head, MemorySourceOp):
            raise Unimplemented(
                "select sinks (a chain of map/filter/limit feeding a sink) are "
                "not ported yet: the output-compaction kernel comes with a "
                "later slice")
        hb = self._eval_blocking(head)
        sel = out_names if out_names is not None else list(hb.cols)
        missing = [n for n in sel if n not in hb.cols]
        if missing:
            raise CompilerError(f"output columns {missing} not found")
        out_dtypes = {n: hb.dtypes[n] for n in sel}
        out_dicts = {n: hb.dicts[n] for n in sel if n in hb.dicts}
        return out_dtypes, out_dicts, sel, {n: hb.cols[n] for n in sel}

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
                # The window ORIGIN is a runtime parameter (fed through the
                # luts dict, see _refresh_window_keys); only the bin-count
                # bucket is static.
                t0name = kern.ctx.ec._add_lut(np.asarray([t0_bin], dtype=np.int64))
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
                        f"group key {name!r} is a computed numeric column "
                        "(the sorted group-by fallback is not ported yet)"
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
                if u is not None:
                    qd.encode(u.tolist())
                else:
                    _prescan_unique(src, prov.name, qd, sort=True)
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
            raise GroupKeyFallback(
                f"group key {name!r} has type {sv.dtype.name} (the sorted "
                "group-by fallback is not ported yet)")
        total = 1
        for k in keys:
            total *= k.card
        if total > MAX_GROUPS:
            raise GroupKeyFallback(
                f"group cardinality bound {total} exceeds {MAX_GROUPS} (the "
                "sorted group-by fallback is not ported yet)"
            )
        return keys

    def _run_agg(self, op: AggOp) -> HostBatch:
        if op.partial or op.finalize:
            raise Unimplemented(
                "partial/finalize aggregates (distributed plans) are not ported "
                "yet (slice 4)")
        keys, udas, state, seen_name, in_types, val_dicts = self._agg_state(op)
        return self._finalize_agg(op, keys, udas, state, seen_name, in_types,
                                  val_dicts)

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
        ok, keys, lut_over = self._refresh_window_keys(keys, src, head)
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
            step=step, val_dicts=val_dicts, lut_over=lut_over)

    def _agg_state(self, op: AggOp):
        """Run the aggregation; returns the device state (and what
        finalizing it needs)."""
        s = self._agg_setup(op)
        t_lo, t_hi = _time_bounds(s.head)
        luts_np = {**s.kern.luts, **s.lut_over}
        # LUTs are uploaded once per query
        luts = {k: torch.as_tensor(v).to(self.device) for k, v in luts_np.items()}
        state = self._agg_feed_loop(s.kern, s.step, s.init_specs, s.num_groups,
                                    s.src, s.names, s.cap, t_lo, t_hi, luts)
        return s.keys, s.udas, state, s.seen_name, s.in_types, s.val_dicts

    def _refresh_window_keys(self, keys, src, head):
        """Per-run window-origin resolution.

        Returns (ok, keys', lut_overrides).  keys' holds GroupKey copies with
        this run's t0_bin, and lut_overrides carries the runtime origin
        scalars.  ok=False means the static bin bucket can't hold this run's
        span."""
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
            over[k.lut_name] = np.asarray([t0], dtype=np.int64)
        return True, out, over

    def _agg_kernel(self, op, dtypes, dicts, chain, time_col, visible, src, head):
        """Build the chain kernel, group keys and UDA specs for `op`."""
        kern = ChainKernel(dtypes, dicts, chain, self.registry, time_col,
                           self.device, visible)
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
                    b = sv.build

                    def vb(env, b=b):
                        v = b(env)
                        return torch.where(v >= 0, v, PICKER_NULL_SENTINEL)

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
                    vb = sv.build
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
        return (kern, keys, udas, in_types, init_specs, num_groups, seen_name,
                step, val_dicts)

    def _agg_feed_loop(self, kern, step, init_specs, num_groups, src, names,
                       cap, t_lo, t_hi, luts):
        """Drive the feeds through the agg step.

        The state is created once on the device and every feed's UDA updates
        accumulate into it IN PLACE (the kernels add into the state tensors),
        so feeds allocate no per-feed partial state and need no merge.
        """
        state = {name: uda.init(num_groups, in_dt, self.device)
                 for name, uda, in_dt in init_specs}
        remaining = kern.init_limits()
        for cols, n_valid in self._feed(src, names, cap):
            tf0 = _time.perf_counter_ns()
            state, consumed = step(cols, n_valid, t_lo, t_hi, remaining, luts, state)
            if kern.has_limit:
                remaining = remaining - consumed
            if self.analyze:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self.stats.setdefault("feed_ns", []).append(
                    _time.perf_counter_ns() - tf0)
        return state

    def _finalize_agg(self, op, keys, udas, state, seen_name, in_types=None,
                      val_dicts=None) -> HostBatch:
        """Device finalize where a UDA has one (sketch → quantiles), one
        readback of the small results and the remaining state, then the host
        finalize into output columns."""
        finals = {out_name: uda.finalize_device(state[out_name])
                  for out_name, uda, _vb in udas
                  if uda.device_finalize and out_name != seen_name}
        pulled = tree_map(lambda t: t.cpu().numpy(),
                          {k: v for k, v in state.items() if k not in finals})
        state_np = {**pulled, **{k: _FinalizedCol(v.cpu().numpy())
                                 for k, v in finals.items()}}
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
                if k.kind == "dict":
                    cols[k.name] = kc.astype(np.int32)
                    dicts[k.name] = k.dictionary
                elif k.kind == "intdevice":
                    vals = k.dictionary.decode(kc)
                    cols[k.name] = np.asarray(vals, dtype=STORAGE_DTYPE[k.out_dtype])
                else:  # window
                    cols[k.name] = ((kc.astype(np.int64) + k.t0_bin) * k.width).astype(
                        np.int64
                    )
        for out_name, uda, _vb in udas:
            if out_name == seen_name:
                continue
            st = state_np[out_name]
            if isinstance(st, _FinalizedCol):
                full = uda.finalize_from_device(st.col)
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
            if val_dicts and out_name in val_dicts:
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
            out_dtypes, out_dicts, out_names, cols = self._consume_chain(
                parent, sink.columns)
            # Semantic types (engine/semantics.py) come with the host-layer
            # slice; the port's relation carries the physical types.
            rel = Relation([ColumnSchema(n, out_dtypes[n]) for n in out_names])
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
        for r in results.values():
            r.exec_stats["wall_ns"] = self.stats["wall_ns"]
        return results


# --------------------------------------------------------------------- helpers


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


def _prescan_unique(src, col: str, qd: Dictionary, sort: bool = False):
    """Populate qd with the column's unique values; sort=True assigns codes in
    sorted order (required by the intdevice searchsorted encoding)."""
    if isinstance(src, HostBatch):
        vals = np.unique(src.cols[col]) if sort else src.cols[col]
        qd.encode(vals)
        return
    if sort:
        parts = [rb.columns[col][: rb.num_valid] for rb, _rid, _gen in src]
        parts = [p for p in parts if len(p)]
        if parts:
            qd.encode(np.unique(np.concatenate([np.unique(p) for p in parts])))
        return
    for rb, _rid, _gen in src:
        arr = rb.columns[col][: rb.num_valid]
        if len(arr):
            qd.encode(np.unique(arr))


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
                 analyze: bool = False) -> dict[str, QueryResult]:
    """Run a plan against a table store on `device` (CUDA unless given);
    returns {sink_name: QueryResult}."""
    return PlanExecutor(plan, table_store, registry, device=device,
                        analyze=analyze).run()
