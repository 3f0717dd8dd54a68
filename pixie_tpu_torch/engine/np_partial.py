"""Numpy/native fast path for CPU partial aggregation.

Reference bar: `Table::TransferRecordBatch` + AggNode's row-at-a-time hash
update keep the reference's streaming pipeline at memory speed
(src/table_store/table/table.h:152-166, exec/agg_node.h:140).  Below the
CPU/card crossover (engine/executor.py `_route_backend`) a query on the card
would pay the upload, the launches and the readback for a few microseconds
of work; this module computes the SAME partial state with bincount-shaped
numpy (and a fused native kernel for the log-histogram,
native/stream_agg.cc) at memory speed on the host, for the plan shapes it
can reproduce exactly: a passthrough chain (no filters/limits; renames
only) into a windowed/keyed aggregate of reduce-op UDAs.

The port's copy of the reference's pixie_tpu/engine/np_partial.py, over the
port's UDAs (udf/udf.py): `eligible()` gives the reference's answer and the
states are the reference's bit for bit.  Eligibility is conservative:
anything it can't reproduce EXACTLY (chain steps, dict-input aggregates,
computed keys, a mesh) falls back to the card route.  State layouts match
the card route's leaf for leaf, so merge, finalize, P1/M1 and the wire
format downstream cannot tell the difference.  A NaN sketch value lands in
bin 0 here (the reference's CPU routes bin it there), in bin 1 on the card
route of a batch query.
"""
from __future__ import annotations

import math

import numpy as np

from pixie_tpu_torch.udf.udf import (
    AnyUDA,
    CountUDA,
    MaxUDA,
    MeanUDA,
    MinUDA,
    QuantileUDA,
    QuantilesUDA,
    StddevUDA,
    SumUDA,
    VarianceUDA,
)

_SUPPORTED = (CountUDA, SumUDA, MeanUDA, MinUDA, MaxUDA, AnyUDA,
              QuantileUDA, QuantilesUDA, VarianceUDA, StddevUDA)


def source_col(kern, name: str):
    """Resolve a post-chain column name to its untransformed SOURCE column,
    or None when it is computed (chain provenance tracks renames)."""
    from pixie_tpu_torch.plan.plan import Column

    prov = kern.ctx.provenance.get(name)
    if prov is None:
        return name  # never touched by a map
    return prov.name if isinstance(prov, Column) else None


def eligible(kern, keys, udas, val_dicts, t_lo=None, t_hi=None,
             src=None) -> bool:
    """True if this agg can run through the numpy partial loop.  Maps are
    fine as long as every column the loop READS is a pass-through of a
    source column (window binning is already planner-resolved into the
    GroupKey).  Chains with filter/limit steps take the whole-plan loop
    (native/codegen.py) or the card route, as the reference's take its
    whole-plan loop or its kernel path (this loop's edge is the
    scatter-free bincount shapes)."""
    if kern.steps or kern.has_limit or val_dicts:
        return False
    if src is not None and not hasattr(src, "__iter__"):
        return False  # blocking-op HostBatch intermediates use _feed
    if kern.time_col is not None and source_col(
            kern, kern.time_col) != kern.time_col:
        # A map REWROTE the time column.  The kernel's WINDOW key builds on
        # the post-map sval, this loop bins the raw source — only the
        # planner's own `time_ = px.bin(time_, w)` rewrite is bin-
        # equivalent to raw ((t//w*w)//w == t//w), and even then only the
        # BIN INDEX: a bounded time mask compares the post-map (binned)
        # value in the kernel vs raw time here, which diverges at window
        # edges — so the rewrite is admitted only with unbounded time.
        wkey = next((k for k in keys if k.kind == "window"), None)
        if wkey is None or not _is_bin_of_raw_time(kern, wkey):
            return False
        unbounded = (t_lo is not None and t_hi is not None
                     and t_lo <= -(1 << 62) and t_hi >= (1 << 62))
        if not unbounded:
            return False
    for k in keys:
        if k.kind not in ("dict", "intdevice", "window"):
            return False
        if k.kind == "window" and kern.time_col is None:
            return False
        if k.kind == "dict" and source_col(kern, k.name) is None:
            return False
        if (k.kind == "intdevice"
                and source_col(kern, k.src_name or k.name) is None):
            return False
    for _name, uda, _vb in udas:
        if not isinstance(uda, _SUPPORTED):
            return False
    return True


def _is_bin_of_raw_time(kern, wkey) -> bool:
    """True when time_'s provenance is `px.bin(<raw time col>, wkey.width)`
    (the rolling/stream planner's rewrite)."""
    from pixie_tpu_torch.plan.plan import Call, Column, Literal

    prov = kern.ctx.provenance.get(kern.time_col)
    if not isinstance(prov, Call) or prov.fn != "bin":
        return False
    if len(prov.args) != 2:
        return False
    col, width = prov.args
    return (isinstance(col, Column) and col.name == kern.time_col
            and isinstance(width, Literal) and int(width.value) == wkey.width)


def _gid_and_mask(cols, n_valid, keys, kern, t_lo, t_hi, luts):
    """→ (gid[n], mask[n], prefix_n).  prefix_n is set when the mask is
    exactly rows [0, prefix_n) — callers then use zero-copy slices instead
    of 64 MB boolean gathers."""
    n = len(next(iter(cols.values())))
    prefix = int(n_valid)
    mask = np.zeros(n, dtype=bool)
    mask[:n_valid] = True
    unbounded = t_lo <= -(1 << 62) and t_hi >= (1 << 62)
    if (not unbounded and kern.time_col is not None
            and kern.time_col in cols):
        t = np.asarray(cols[kern.time_col])
        mask &= (t >= t_lo) & (t < t_hi)
        prefix = None
    gid = None
    for k in keys:
        if k.kind == "dict":
            c = np.asarray(cols[source_col(kern, k.name)]).astype(
                np.int64, copy=False)
            if (c[:n_valid] < 0).any():
                mask &= c >= 0  # null codes drop (pandas dropna semantics)
                prefix = None
        elif k.kind == "intdevice":
            lut = np.asarray(luts[k.lut_name])
            src = np.asarray(cols[source_col(kern, k.src_name or k.name)])
            c = np.searchsorted(lut, src).astype(np.int64)
        else:  # window
            t0 = int(np.asarray(luts[k.lut_name])[0])
            c = (np.asarray(cols[kern.time_col]) // k.width - t0).astype(
                np.int64)
        # mixed-radix combine with the SAME clamp as ops.groupby.combine_codes
        c = np.clip(c, 0, k.card - 1)
        gid = c if gid is None else gid * k.card + c
    if gid is None:
        gid = np.zeros(n, dtype=np.int64)
    return gid, mask, prefix


def update_state(state, init_specs, gid, mask, vals_by_name, num_groups,
                 hist_cls, prefix=None):
    """Accumulate one feed into `state` in place-ish (returns new dict).
    `prefix` marks a pure-prefix mask: selections become zero-copy slices."""
    sel = slice(0, prefix) if prefix is not None else mask
    g = gid[sel]
    if len(g) == 0:
        return state  # feed contributed nothing; identity state stands
    out = dict(state)
    counts = None  # shared count-by-gid for count/mean
    hist_bins = {}  # value-column name -> bin codes (shared across sketches)
    order = starts = gs = None  # shared argsort for min/max/any
    for name, uda, _in_dt in init_specs:
        v = vals_by_name.get(name)
        if isinstance(uda, CountUDA):
            if counts is None:
                counts = np.bincount(g, minlength=num_groups)
            out[name] = out[name] + counts.astype(np.int64)
        elif isinstance(uda, MeanUDA):
            if counts is None:
                counts = np.bincount(g, minlength=num_groups)
            vm = v[sel].astype(np.float64, copy=False)
            out[name] = {
                "sum": out[name]["sum"] + np.bincount(
                    g, weights=vm, minlength=num_groups),
                "count": out[name]["count"] + counts.astype(np.int64),
            }
        elif isinstance(uda, SumUDA):
            if out[name].dtype.kind in "iu":
                # EXACT 64-bit sums (matching ops.groupby's limb GEMM):
                # 16-bit limbs are exact in f64 bincount up to 2^37 rows
                # per group; the shifted uint64 adds wrap mod 2^64.
                u = v[sel].astype(np.uint64)
                total = np.zeros(num_groups, dtype=np.uint64)
                for k16 in range(4):
                    limb = ((u >> np.uint64(16 * k16))
                            & np.uint64(0xFFFF)).astype(np.float64)
                    s = np.bincount(g, weights=limb, minlength=num_groups)
                    total = total + (s.astype(np.uint64)
                                     << np.uint64(16 * k16))
                out[name] = out[name] + total.astype(out[name].dtype)
            else:
                vm = v[sel].astype(np.float64, copy=False)
                out[name] = out[name] + np.bincount(
                    g, weights=vm, minlength=num_groups)
        elif isinstance(uda, (VarianceUDA, StddevUDA)):
            if counts is None:
                counts = np.bincount(g, minlength=num_groups)
            vm = v[sel].astype(np.float64, copy=False)
            out[name] = {
                "sum": out[name]["sum"] + np.bincount(
                    g, weights=vm, minlength=num_groups),
                "sumsq": out[name]["sumsq"] + np.bincount(
                    g, weights=vm * vm, minlength=num_groups),
                "count": out[name]["count"] + counts.astype(np.int64),
            }
        elif isinstance(uda, (MinUDA, MaxUDA, AnyUDA)):
            vm = v[sel].astype(out[name].dtype, copy=False)
            # sort-based segmented extremum: orders of magnitude faster than
            # np.minimum.at's per-element dispatch; the argsort is shared
            # across every min/max/any in the aggregate
            if order is None:
                order = np.argsort(g, kind="stable")
                gs = g[order]
                starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
            vs = vm[order]
            op = (np.minimum if isinstance(uda, (MinUDA, AnyUDA))
                  else np.maximum)
            seg = (np.minimum.reduceat(vs, starts)
                   if op is np.minimum else np.maximum.reduceat(vs, starts))
            cur = out[name].copy()
            cur[gs[starts]] = op(cur[gs[starts]], seg)
            out[name] = cur
        elif isinstance(uda, (QuantileUDA, QuantilesUDA)):
            lh = hist_cls
            # p50/p99/quantiles over the SAME column share one histogram
            # accumulation
            key = id(v)
            add = hist_bins.get(key)
            if add is None:
                add = _hist_update(lh, gid, mask, v, num_groups, prefix)
                hist_bins[key] = add
            out[name] = out[name] + add
        else:  # pragma: no cover - guarded by eligible()
            raise AssertionError(type(uda))
    return out


def _bin_index_np(lh, v) -> np.ndarray:
    vf = np.asarray(v, dtype=np.float32)
    lg = np.log(np.maximum(vf, np.float32(lh.min_value))) / np.float32(
        math.log(lh.gamma))
    idx = np.ceil(lg).astype(np.int32) + 1
    idx[np.asarray(v) <= lh.min_value] = 0
    return np.clip(idx, 0, lh.width - 1)


def _hist_update(lh, gid, mask, v_full, num_groups, prefix=None) -> np.ndarray:
    """[G, width] histogram of one feed's values (fused native pass when
    available; numpy bin + flat bincount otherwise).  gid/mask are per-ROW."""
    lib = _native()
    if lib is not None and v_full.dtype == np.float64:
        import ctypes

        out = np.zeros((num_groups, lh.width), dtype=np.float32)
        if prefix is not None:
            gid_rows, v_full = gid[:prefix], v_full[:prefix]
        else:
            gid_rows = np.where(mask, gid, np.int64(-1))
        lib.px_hist_update(
            ctypes.c_int64(len(v_full)),
            np.ascontiguousarray(gid_rows, dtype=np.int64).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)),
            np.ascontiguousarray(v_full).ctypes.data_as(
                ctypes.POINTER(ctypes.c_double)),
            ctypes.c_float(1.0 / math.log(lh.gamma)),
            ctypes.c_float(lh.min_value),
            ctypes.c_int64(lh.width),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out
    sel = slice(0, prefix) if prefix is not None else mask
    bins = _bin_index_np(lh, v_full[sel])
    flat = gid[sel] * lh.width + bins.astype(np.int64)
    return np.bincount(flat, minlength=num_groups * lh.width).astype(
        np.float32).reshape(num_groups, lh.width)


_NATIVE = None
_NATIVE_TRIED = False


def _native():
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    from pixie_tpu_torch.native.build import load_native

    lib = load_native()
    if lib is not None and hasattr(lib, "px_hist_accumulate"):
        _NATIVE = lib
    return _NATIVE


def value_args_ok(kern, op, names) -> bool:
    """Every aggregate input must resolve to a PLAIN source column present
    in the feed (no computed value expressions in the fast path)."""
    for ae in op.values:
        if ae.arg is None:
            continue
        src = source_col(kern, ae.arg)
        if src is None or src not in names:
            return False
    return True


def value_args(kern, op) -> dict:
    """out_name -> SOURCE column name for each aggregate input."""
    return {ae.out_name: (source_col(kern, ae.arg)
                          if ae.arg is not None else None)
            for ae in op.values}


def _window_fused_ok(kern, keys, init_specs, value_args, t_lo, t_hi) -> bool:
    """True when the FULLY fused native single-pass applies: one window
    key, unbounded time, and count/mean/quantile UDAs over at most one f64
    value column."""
    if _native() is None or not hasattr(_native(), "px_window_agg"):
        return False
    if len(keys) != 1 or keys[0].kind != "window":
        return False
    if not (t_lo <= -(1 << 62) and t_hi >= (1 << 62)):
        return False
    vcols = {a for a in value_args.values() if a is not None}
    if len(vcols) > 1:
        return False
    for _name, uda, _dt in init_specs:
        if not isinstance(uda, (CountUDA, MeanUDA, QuantileUDA,
                                QuantilesUDA)):
            return False
    return True


class _FusedWindowAcc:
    """Preallocated accumulators driven straight off STORAGE batches: the
    native px_window_agg accumulates count+sum+hist IN PLACE per batch, so
    a query does zero feed coalescing, zero padding, zero masks, zero
    intermediate arrays — and the ctypes call releases the GIL, so the
    ingest writer runs concurrently."""

    def __init__(self, lh, k, t0, time_col, init_specs, value_args,
                 num_groups):
        self.lh, self.k, self.t0 = lh, k, t0
        self.time_col = time_col
        self.init_specs = init_specs
        self.vcol = next((a for a in value_args.values() if a is not None),
                         None)
        self.num_groups = num_groups
        self.counts = np.zeros(num_groups, dtype=np.int64)
        self.need_sum = any(isinstance(u, MeanUDA)
                            for _n, u, _d in init_specs)
        self.need_hist = any(isinstance(u, (QuantileUDA, QuantilesUDA))
                             for _n, u, _d in init_specs)
        self.sums = (np.zeros(num_groups, dtype=np.float64)
                     if self.need_sum else None)
        self.hist = (np.zeros((num_groups, lh.width), dtype=np.float32)
                     if self.need_hist else None)

    def add(self, cols, n_valid):
        import ctypes

        t = cols[self.time_col][:n_valid]
        if not t.flags.c_contiguous:
            t = np.ascontiguousarray(t)
        if self.vcol is not None:
            v = cols[self.vcol][:n_valid]
            if v.dtype != np.float64 or not v.flags.c_contiguous:
                v = np.ascontiguousarray(v, dtype=np.float64)
        else:
            v = np.zeros(1)
        lib = _native()
        P = ctypes.POINTER
        lib.px_window_agg(
            ctypes.c_int64(len(t)),
            t.ctypes.data_as(P(ctypes.c_int64)),
            ctypes.c_int64(self.k.width), ctypes.c_int64(self.t0),
            ctypes.c_int64(self.num_groups),
            v.ctypes.data_as(P(ctypes.c_double)),
            ctypes.c_int64(self.lh.width),
            ctypes.c_float(1.0 / math.log(self.lh.gamma)),
            ctypes.c_float(self.lh.min_value),
            self.counts.ctypes.data_as(P(ctypes.c_int64)),
            self.sums.ctypes.data_as(P(ctypes.c_double))
            if self.sums is not None else None,
            self.hist.ctypes.data_as(P(ctypes.c_float))
            if self.hist is not None else None,
        )

    def merge_into(self, state):
        out = dict(state)
        for name, uda, _dt in self.init_specs:
            if isinstance(uda, CountUDA):
                out[name] = out[name] + self.counts
            elif isinstance(uda, MeanUDA):
                out[name] = {"sum": out[name]["sum"] + self.sums,
                             "count": out[name]["count"] + self.counts}
            else:
                out[name] = out[name] + self.hist
        return out


def run(executor, src, names, cap, kern, keys, init_specs, num_groups,
        t_lo, t_hi, luts, value_args: dict):
    """The whole partial loop in numpy: feeds → accumulated state dict.

    value_args: out_name -> source column name (from the AggExprs).
    """
    from pixie_tpu_torch.ops.sketch import LogHistogram
    from pixie_tpu_torch.udf.udf import tree_map

    lh = LogHistogram()
    state = {}
    for name, uda, in_dt in init_specs:
        state[name] = tree_map(lambda t: t.numpy(), uda.init(num_groups, in_dt, "cpu"))
    fused = _window_fused_ok(kern, keys, init_specs, value_args, t_lo, t_hi)
    if fused:
        t0 = int(np.asarray(luts[keys[0].lut_name])[0])
        acc = _FusedWindowAcc(lh, keys[0], t0, kern.time_col, init_specs,
                              value_args, num_groups)
        # straight off the STORAGE batches — no coalescing/padding copies
        heat_rec = executor._heat_recorder(src)
        for rb, _row_id, _gen in src:
            n = rb.num_valid
            if n:
                acc.add(rb.columns, n)
                executor.stats["rows_scanned"] += n
                executor.stats["batches"] += 1
                if heat_rec is not None:
                    heat_rec.record_batch(rb, n, _gen)
        return acc.merge_into(state)
    for cols, n_valid in executor._host_feed(src, names, cap):
        gid, mask, prefix = _gid_and_mask(
            cols, n_valid, keys, kern, t_lo, t_hi, luts)
        vals_by_name = {
            name: cols[arg] for name, arg in value_args.items()
            if arg is not None
        }
        state = update_state(state, init_specs, gid, mask, vals_by_name,
                             num_groups, lh, prefix=prefix)
    return state
