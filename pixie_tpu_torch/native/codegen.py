"""Whole-plan native codegen for the sub-crossover CPU route.

Lowers a fused scan→filter→map→partial-agg chain into the micro-program
`native/wholeplan.cc` executes as ONE compiled loop (Flare, PAPERS.md: below
the accelerator crossover, per-op kernels with intermediate arrays lose to a
single fused loop).  The lowering is conservative and total: anything it
cannot reproduce EXACTLY (computed map expressions, dict-column predicates,
limits, unsupported UDAs) returns None and the executor runs the query on
its card route — so the native loop is a pure fast path, never a semantics
fork.

The port's copy of the reference's pixie_tpu/native/codegen.py: `lower()`
reads the port's ChainKernel (ops/chain.py programs on the card) through the
attributes the reference's has too — `has_limit`, `time_col`, `luts` and the
source-column map `ctx.provenance` — and returns None exactly where the
reference's does; `run()` gives the reference's state bit for bit at the
same PX_WHOLEPLAN_THREADS.

Supported shapes (the interactive dashboard family):
  * chain: Filter steps of ``Column <cmp> Literal`` (or a bare BOOLEAN
    column) over numeric source columns, Map steps that are pure renames —
    plus the planner's ``time_ = px.bin(time_, w)`` window rewrite when the
    binned name is consumed ONLY as a window group key and the query is
    time-unbounded (the np_partial admission rule);
  * group keys: dict codes (null-drop), intdevice (searchsorted against the
    kernel's sorted-unique LUT), window bins;
  * UDAs: count/sum/mean/min/max/any/variance/stddev + the log-histogram
    quantile sketch (p50/p99/quantiles) — state layouts leaf-identical to
    the card route's states, accumulated in row order, int64 sums wrapping
    mod 2^64.

Programs are structural (column names + op codes); per-run values (window
origins, intdevice LUTs) resolve from the luts at run time, so one lowered
program serves every poll/range that reuses the chain.  Lowered programs
are cached per plan signature in `engine.plancache.native_programs`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import threading
from typing import Optional

import numpy as np

from pixie_tpu_torch import flags as _flags

_flags.define_bool(
    "PX_WHOLEPLAN_NATIVE", True,
    "fuse sub-crossover scan->filter->map->partial-agg chains into the "
    "native whole-plan loop (pixie_tpu_torch/native/wholeplan.cc); 0 = "
    "the card route only")

# column dtype tags (wholeplan.cc DT_*)
_DT_I64, _DT_F64, _DT_I32, _DT_U8 = 0, 1, 2, 3
_NP_TO_TAG = {np.dtype(np.int64): _DT_I64, np.dtype(np.float64): _DT_F64,
              np.dtype(np.int32): _DT_I32, np.dtype(np.bool_): _DT_U8}

_CMP_OPS = {"equal": 0, "not_equal": 1, "less": 2, "less_equal": 3,
            "greater": 4, "greater_equal": 5}
#: literal-on-the-left flip: lit < col  ==  col > lit
_FLIP = {0: 0, 1: 1, 2: 4, 3: 5, 4: 2, 5: 3}

_UNBOUNDED_LO, _UNBOUNDED_HI = -(1 << 62), (1 << 62)

#: sentinel for map outputs produced by the window-bin rewrite: readable
#: ONLY as a window group key
_WINDOW_ONLY = object()


@dataclasses.dataclass
class Program:
    """A lowered whole-plan micro-program (structural; run-time bindings —
    LUTs, window origins, state buffers — resolve per run)."""

    cols: list          # ordered source column names the loop reads
    col_tags: list      # wholeplan.cc dtype tag per column
    filters: list       # (col_idx, op, is_float, ival, fval)
    time_idx: int       # column index for time bounds, -1 = never bounded
    keys: list          # (kind, col_idx, card, width, lut_name)
    aggs: list          # (kind, out_name, value_col_idx)
    requires_unbounded: bool
    hist_width: int
    inv_log_gamma: float
    min_value: float


def _native():
    from pixie_tpu_torch.native.build import load_native

    lib = load_native()
    if lib is not None and hasattr(lib, "px_wholeplan_run"):
        return lib
    return None


def _resolve_filter(expr, env, dtypes, dicts):
    """Lower one FilterOp expression under the rename env `env`
    (post-map name -> source column name).  → (col, op, isf, ival, fval)
    or None."""
    from pixie_tpu_torch.plan.plan import Call, Column, Literal
    from pixie_tpu_torch.types import DataType as DT

    if isinstance(expr, Column):  # bare boolean column: col != 0
        src = env.get(expr.name)
        if src is None or src is _WINDOW_ONLY or src in dicts:
            return None
        if dtypes.get(src) != DT.BOOLEAN:
            return None
        return (src, _CMP_OPS["not_equal"], 0, 0, 0.0)
    if not isinstance(expr, Call) or expr.fn not in _CMP_OPS \
            or len(expr.args) != 2:
        return None
    a, b = expr.args
    op = _CMP_OPS[expr.fn]
    if isinstance(a, Literal) and isinstance(b, Column):
        a, b, op = b, a, _FLIP[op]
    if not (isinstance(a, Column) and isinstance(b, Literal)):
        return None
    src = env.get(a.name)
    if src is None or src is _WINDOW_ONLY or src in dicts:
        return None
    if dtypes.get(src) not in (DT.INT64, DT.TIME64NS, DT.FLOAT64, DT.BOOLEAN):
        return None
    v = b.value
    if isinstance(v, bool):
        v = int(v)
    if not isinstance(v, (int, float)):
        return None
    col_f = dtypes[src] == DT.FLOAT64
    isf = 1 if (col_f or isinstance(v, float)) else 0
    return (src, op, isf, int(v) if not isf else 0,
            float(v) if isf else 0.0)


def _lower_chain(chain, names, dtypes, dicts, time_col):
    """Walk the chain: → (filters lowered to source columns, final rename
    env, window_bin {name: width}) or None when any step is out of scope."""
    from pixie_tpu_torch.plan.plan import Call, Column, Literal, FilterOp, LimitOp, MapOp

    env = {n: n for n in names}
    filters = []
    window_bin: dict = {}
    for op_ in chain:
        if isinstance(op_, MapOp):
            new_env = {}
            new_windows = {}
            for name, e in op_.exprs:
                if isinstance(e, Column):
                    got = env.get(e.name)
                    if got is None:
                        return None
                    new_env[name] = got
                    if e.name in window_bin:
                        new_windows[name] = window_bin[e.name]
                elif (isinstance(e, Call) and e.fn == "bin"
                        and len(e.args) == 2
                        and isinstance(e.args[0], Column)
                        and env.get(e.args[0].name) == time_col
                        and isinstance(e.args[1], Literal)
                        and isinstance(e.args[1].value, int)):
                    # the planner's window rewrite: consumable only as a
                    # window group key (codegen bins the RAW time column)
                    new_env[name] = _WINDOW_ONLY
                    new_windows[name] = int(e.args[1].value)
                else:
                    return None
            env = new_env
            window_bin = new_windows
        elif isinstance(op_, FilterOp):
            f = _resolve_filter(op_.expr, env, dtypes, dicts)
            if f is None:
                return None
            filters.append(f)
        elif isinstance(op_, LimitOp):
            return None
        else:
            return None
    return filters, env, window_bin


def lower(kern, chain, op, keys, init_specs, dtypes, dicts, names,
          time_col) -> Optional[Program]:
    """Lower one agg chain into a Program, or None when out of scope."""
    from pixie_tpu_torch.engine.np_partial import source_col, value_args
    from pixie_tpu_torch.ops.sketch import LogHistogram
    from pixie_tpu_torch.udf.udf import (
        AnyUDA, CountUDA, MaxUDA, MeanUDA, MinUDA, QuantileUDA, QuantilesUDA,
        StddevUDA, SumUDA, VarianceUDA,
    )

    # NOTE: the PX_WHOLEPLAN_NATIVE kill switch is checked by the CALLER
    # (executor._wholeplan_program) outside the program cache — a cached
    # program must not bypass a live flag flip in either direction; native
    # availability IS safe to bake (process-constant).
    if _native() is None:
        return None
    if kern.has_limit:
        return None
    lowered = _lower_chain(chain, names, dtypes, dicts, time_col)
    if lowered is None:
        return None
    filters, env, window_bin = lowered

    cols: list = []
    tags: list = []

    def col_idx(src_name) -> Optional[int]:
        if src_name not in names:
            return None
        from pixie_tpu_torch.types import STORAGE_DTYPE

        tag = _NP_TO_TAG.get(STORAGE_DTYPE[dtypes[src_name]])
        if tag is None:
            return None
        if src_name in cols:
            return cols.index(src_name)
        cols.append(src_name)
        tags.append(tag)
        return len(cols) - 1

    f_rows = []
    for src, fop, isf, iv, fv in filters:
        ci = col_idx(src)
        if ci is None:
            return None
        f_rows.append((ci, fop, isf, iv, fv))

    requires_unbounded = False
    k_rows = []
    for k in keys:
        if k.kind == "dict":
            src = source_col(kern, k.name)
            if src is None or src not in dicts:
                return None
            ci = col_idx(src)
            if ci is None:
                return None
            k_rows.append((0, ci, k.card, 0, ""))
        elif k.kind == "intdevice":
            src = source_col(kern, k.src_name or k.name)
            if src is None:
                return None
            ci = col_idx(src)
            if ci is None:
                return None
            k_rows.append((1, ci, k.card, 0, k.lut_name))
        elif k.kind == "window":
            if env.get(k.name) is not _WINDOW_ONLY \
                    or window_bin.get(k.name) != k.width:
                return None
            ci = col_idx(time_col)
            if ci is None:
                return None
            requires_unbounded = True  # raw-time binning ≠ bounded post-map
            k_rows.append((2, ci, k.card, k.width, k.lut_name))
        else:
            return None

    vargs = value_args(kern, op)
    a_rows = []
    for name, uda, in_dt in init_specs:
        src = vargs.get(name)  # None for the implicit __seen counter
        if src is None and not isinstance(uda, CountUDA):
            return None
        ci = 0
        if src is not None:
            # value columns must be plain pass-through source columns (the
            # np_partial rule); dict-coded values never reach here
            # (executor gates on val_dicts)
            if src is _WINDOW_ONLY or src not in names or src in dicts:
                return None
            ci = col_idx(src)
            if ci is None:
                return None
        if isinstance(uda, CountUDA):
            kind = 0
        elif isinstance(uda, SumUDA):
            kind = 1 if np.dtype(in_dt).kind != "f" else 2
        elif isinstance(uda, MeanUDA):
            kind = 3
        elif isinstance(uda, (MinUDA, AnyUDA, MaxUDA)):
            is_max = isinstance(uda, MaxUDA)
            if np.dtype(in_dt).kind == "f":
                kind = 7 if is_max else 6
            else:
                kind = 5 if is_max else 4
        elif isinstance(uda, (QuantileUDA, QuantilesUDA)):
            kind = 8
        elif isinstance(uda, (VarianceUDA, StddevUDA)):
            kind = 9
        else:
            return None
        a_rows.append((kind, name, ci))

    # time bounds: applicable only when the raw time column rides the feed
    time_idx = -1
    if time_col is not None and time_col in names and not requires_unbounded:
        ti = col_idx(time_col)
        if ti is not None:
            time_idx = ti
    lh = LogHistogram()
    return Program(
        cols=cols, col_tags=tags, filters=f_rows, time_idx=time_idx,
        keys=k_rows, aggs=a_rows, requires_unbounded=requires_unbounded,
        hist_width=lh.width, inv_log_gamma=1.0 / math.log(lh.gamma),
        min_value=lh.min_value,
    )


def applicable(prog: Optional[Program], t_lo, t_hi) -> bool:
    """Per-run admission: a cached program still refuses runs it cannot
    reproduce (bounded time with no time column / window raw-binning)."""
    if prog is None:
        return False
    unbounded = int(t_lo) <= _UNBOUNDED_LO and int(t_hi) >= _UNBOUNDED_HI
    if unbounded:
        return True
    return not prog.requires_unbounded and prog.time_idx >= 0


def _acc_np(in_dt) -> np.dtype:
    d = np.dtype(in_dt)
    return np.dtype(np.int64) if d.kind == "b" else d


def _ident_np(dtype, op: str):
    d = np.dtype(dtype)
    if d.kind == "f":
        return np.inf if op == "min" else -np.inf
    info = np.iinfo(d)
    return info.max if op == "min" else info.min


def _alloc_state(prog: Program, init_specs, num_groups):
    """Identity state with the EXACT leaf layout of uda.init (dtypes,
    dict keys, identity fills — udf.udf + ops/groupby._identity_for), as
    writable numpy the native loop accumulates in place.  Pure numpy on
    purpose: uda.init builds torch tensors, a measurable per-query cost at
    interactive latencies; parity with the card route's layouts is pinned
    by tests/test_torch_wholeplan.py."""
    G = num_groups
    kinds = {name: kind for kind, name, _ci in prog.aggs}
    state = {}
    for name, _uda, in_dt in init_specs:
        kind = kinds[name]
        if kind == 0:
            state[name] = np.zeros(G, np.int64)
        elif kind in (1, 2):
            state[name] = np.zeros(G, _acc_np(in_dt))
        elif kind == 3:
            state[name] = {"sum": np.zeros(G, np.float64),
                           "count": np.zeros(G, np.int64)}
        elif kind in (4, 6):
            acc = _acc_np(in_dt)
            state[name] = np.full(G, _ident_np(acc, "min"), acc)
        elif kind in (5, 7):
            acc = _acc_np(in_dt)
            state[name] = np.full(G, _ident_np(acc, "max"), acc)
        elif kind == 8:
            state[name] = np.zeros((G, prog.hist_width), np.float32)
        else:
            state[name] = {"sum": np.zeros(G, np.float64),
                           "sumsq": np.zeros(G, np.float64),
                           "count": np.zeros(G, np.int64)}
    return state


def _merge_into(prog: Program, dst: dict, src: dict) -> None:
    """Fold one batch partial into the accumulated state, in place.
    Reduction op per leaf mirrors uda.reduce_ops (add everywhere except
    the min/max extrema)."""
    for kind, name, _ci in prog.aggs:
        d, s = dst[name], src[name]
        if kind in (4, 6):
            np.minimum(d, s, out=d)
        elif kind in (5, 7):
            np.maximum(d, s, out=d)
        elif isinstance(d, dict):
            for leaf in d:
                d[leaf] += s[leaf]
        else:
            d += s


def _agg_ptrs(prog: Program, state: dict):
    """→ (kinds i32[n], cols i32[n], s0 void*[n], s1, s2)."""
    n = len(prog.aggs)
    kinds = np.zeros(n, np.int32)
    acols = np.zeros(n, np.int32)
    s0 = (ctypes.c_void_p * n)()
    s1 = (ctypes.c_void_p * n)()
    s2 = (ctypes.c_void_p * n)()
    for i, (kind, name, ci) in enumerate(prog.aggs):
        kinds[i] = kind
        acols[i] = ci
        st = state[name]
        if kind == 3:  # mean
            s0[i] = st["sum"].ctypes.data
            s1[i] = st["count"].ctypes.data
        elif kind == 9:  # variance
            s0[i] = st["sum"].ctypes.data
            s1[i] = st["sumsq"].ctypes.data
            s2[i] = st["count"].ctypes.data
        else:
            s0[i] = st.ctypes.data
    return kinds, acols, s0, s1, s2


#: above this many rows the batch fan-out engages (the pool + per-batch
#: partial states only pay off once the loop dominates)
_PARALLEL_MIN_ROWS = 1 << 17

_THREADS = _flags.define_int(
    "PX_WHOLEPLAN_THREADS", 0,
    "whole-plan loop worker threads (batches fan out, partial states "
    "merge in batch order); 0 = min(8, cpu_count)")


def _nthreads() -> int:
    import os

    v = int(_flags.get("PX_WHOLEPLAN_THREADS"))
    return v if v > 0 else min(8, os.cpu_count() or 1)


_POOL = None
_POOL_LOCK = threading.Lock()


def _pool():
    """Persistent worker pool: creating one per query is measurable at
    interactive latencies.  Sized for the flag's current value; workers are
    daemon threads, so process exit never blocks on it."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _POOL = ThreadPoolExecutor(
                max_workers=max(_nthreads() - 1, 1),
                thread_name_prefix="px-wholeplan")
        return _POOL


class _Bound:
    """The per-run constant arguments of px_wholeplan_run, converted to
    ctypes ONCE (per-batch conversion was measurable at interactive
    latencies)."""

    def __init__(self, prog: Program, luts, t_lo, t_hi, num_groups):
        P = ctypes.POINTER

        def as_p(a, ct):
            return a.ctypes.data_as(P(ct))

        nk = len(prog.keys)
        k_kind = np.zeros(nk, np.int32)
        k_col = np.zeros(nk, np.int32)
        k_card = np.zeros(nk, np.int64)
        k_width = np.zeros(nk, np.int64)
        k_t0 = np.zeros(nk, np.int64)
        k_lut = (ctypes.c_void_p * max(nk, 1))()
        k_lut_len = np.zeros(max(nk, 1), np.int64)
        self._keep = [k_kind, k_col, k_card, k_width, k_t0, k_lut_len]
        for i, (kind, ci, card, width, lut_name) in enumerate(prog.keys):
            k_kind[i], k_col[i], k_card[i], k_width[i] = \
                kind, ci, card, width
            if kind == 1:
                lut = np.ascontiguousarray(np.asarray(luts[lut_name]),
                                           dtype=np.int64)
                self._keep.append(lut)
                k_lut[i] = lut.ctypes.data
                k_lut_len[i] = len(lut)
            elif kind == 2:
                k_t0[i] = int(np.asarray(luts[lut_name])[0])

        nf = len(prog.filters)
        f_col = np.zeros(max(nf, 1), np.int32)
        f_op = np.zeros(max(nf, 1), np.int32)
        f_isf = np.zeros(max(nf, 1), np.int32)
        f_ival = np.zeros(max(nf, 1), np.int64)
        f_fval = np.zeros(max(nf, 1), np.float64)
        self._keep += [f_col, f_op, f_isf, f_ival, f_fval]
        for i, (ci, fop, isf, iv, fv) in enumerate(prog.filters):
            f_col[i], f_op[i], f_isf[i], f_ival[i], f_fval[i] = \
                ci, fop, isf, iv, fv

        unbounded = int(t_lo) <= _UNBOUNDED_LO and int(t_hi) >= _UNBOUNDED_HI
        col_tags = np.asarray(prog.col_tags, np.int32)
        self._keep.append(col_tags)
        self.ncols = len(prog.cols)
        # the argument tuple up to (but excluding) the per-batch
        # (n, col_ptrs) pair and the per-state agg pointers
        self.mid_args = (
            as_p(col_tags, ctypes.c_int32),
            ctypes.c_int32(nf), as_p(f_col, ctypes.c_int32),
            as_p(f_op, ctypes.c_int32), as_p(f_isf, ctypes.c_int32),
            as_p(f_ival, ctypes.c_int64), as_p(f_fval, ctypes.c_double),
            ctypes.c_int32(-1 if unbounded else prog.time_idx),
            ctypes.c_int64(int(t_lo)), ctypes.c_int64(int(t_hi)),
            ctypes.c_int32(nk), as_p(k_kind, ctypes.c_int32),
            as_p(k_col, ctypes.c_int32), as_p(k_card, ctypes.c_int64),
            as_p(k_width, ctypes.c_int64), as_p(k_t0, ctypes.c_int64),
            k_lut, as_p(k_lut_len, ctypes.c_int64),
            ctypes.c_int64(num_groups),
        )
        self.tail_args = (
            ctypes.c_int64(prog.hist_width),
            ctypes.c_float(prog.inv_log_gamma),
            ctypes.c_float(prog.min_value),
        )


def _run_batch(lib, prog, bound, batch_cols, n, agg_args):
    kinds, acols, s0, s1, s2 = agg_args
    # min length 1: a count-only program reads no columns at all, but the
    # pointer array itself must stay a valid allocation
    col_ptrs = (ctypes.c_void_p * max(bound.ncols, 1))()
    for i, a in enumerate(batch_cols):
        col_ptrs[i] = a.ctypes.data
    lib.px_wholeplan_run(
        ctypes.c_int64(n), ctypes.c_int32(bound.ncols), col_ptrs,
        *bound.mid_args,
        ctypes.c_int32(len(prog.aggs)),
        kinds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        acols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        s0, s1, s2, *bound.tail_args)


def run(executor, prog: Program, src, num_groups, init_specs, t_lo, t_hi,
        luts) -> dict:
    """Drive the whole-plan loop straight off the storage batches (no
    coalescing, no padding, no masks) → accumulated partial state dict,
    leaf-identical to the card route's pulled state.

    Batches fan out over a small thread pool (the ctypes call releases the
    GIL) with per-batch partial states merged IN BATCH ORDER — results are
    deterministic regardless of scheduling."""
    lib = _native()
    bound = _Bound(prog, luts, t_lo, t_hi, num_groups)
    batches = []
    total = 0
    for rb, _row_id, _gen in src:
        n = rb.num_valid
        if n == 0:
            continue
        cols = []
        for cname in prog.cols:
            a = rb.columns[cname][:n]
            if not a.flags.c_contiguous:
                a = np.ascontiguousarray(a)
            cols.append(a)
        batches.append((cols, n))
        total += n
    executor.stats["rows_scanned"] += total
    executor.stats["batches"] += len(batches)

    if not batches:
        return _alloc_state(prog, init_specs, num_groups)
    nthreads = min(_nthreads(), len(batches))
    if total < _PARALLEL_MIN_ROWS or nthreads == 1:
        state = _alloc_state(prog, init_specs, num_groups)
        agg_args = _agg_ptrs(prog, state)
        for cols, n in batches:
            _run_batch(lib, prog, bound, cols, n, agg_args)
        return state

    # one contiguous batch RANGE per worker, each into its own state,
    # merged in range order — deterministic regardless of scheduling, and
    # only nthreads partial states to allocate/merge
    per = -(-len(batches) // nthreads)
    ranges = [batches[i: i + per] for i in range(0, len(batches), per)]
    partials = [None] * len(ranges)

    def work(i):
        st = _alloc_state(prog, init_specs, num_groups)
        args = _agg_ptrs(prog, st)
        for cols, n in ranges[i]:
            _run_batch(lib, prog, bound, cols, n, args)
        partials[i] = st

    futs = [_pool().submit(work, i) for i in range(1, len(ranges))]
    work(0)
    for f in futs:
        f.result()
    state = partials[0]
    for st in partials[1:]:
        _merge_into(prog, state, st)
    return state
