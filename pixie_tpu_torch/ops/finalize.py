"""F2 and F1: an aggregate's device finalize, one launch and one readback.

Reference: pixie_tpu/engine/executor.py `_merge_finalize_fn` (:982) and
`_fused_partial_finalize` (:1004), over `_device_finalize_split` (:967).

`merge_finalize(states, reduce_tree, finals)` — F2: N >= 1 states of one
tree merged leaf by leaf (M1's merge, ops/merge.py, in state order), each
output named in `finals` (a UDA with a device finalize: the sketch
quantiles, `finals_of`) turned into its quantiles by K3's rank rule
(ops/sketch.py), and the finals and the other merged leaves packed into one
uint8 buffer (`output_layout`, P1's layout, ops/pack.py).  `Finalized.unpack`
turns the pulled bytes into (finals, rest), the reference's pair.  With
`finals` empty (the reference's finalize_ok=False) it is the merge and the
pack alone.

`fused_partial_finalize(build_member, init_state, reduce_tree, finals, n,
device)` — F1: one feed's aggregate from its columns: a fresh identity state
updated by the aggregate's gang member (ops/gang.py: the chain program and
one leaf update per state leaf), then F2's finalize and pack of that one
state.  `build_member(state)` makes the member over the state's tensors and
`init_state(device)` the identity state (on the "meta" device it gives the
shapes alone).

On CUDA tensors each launches its kernel in csrc/finalize.cu
(`px_merge_finalize`, `px_fused_partial_finalize`), its table passed by
value in the launch's parameters: nothing is uploaded on a call.  What a
shape alone decides is built once and cached — F2's rows per (tree, leaf
spec, finals, N, device) (`F2Plan`, split into launches of whole rows past
F2_WORDS), F1's rows per aggregate shape (`F1Plan`) and its member encoding
and block plan per plan and member shape (`F1Launch`) — and the quantiles and bin values the quantile
rows read sit in a device buffer uploaded once per finals and device
(`Consts`).  A call checks its tensors, writes their addresses into its
thread's rows and makes one C call a launch.  On CPU tensors each runs its
plain version beside it (`merge_finalize_plain`: merge_states_plain,
quantile_plain and pack_plain; F1's plain version: the gang's plain
version, which is the per-sink route's plain steps, then F2's).  The
choice follows the device only; a CUDA tensor never reaches a plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from pixie_tpu_torch.ops import _build
from pixie_tpu_torch.ops import gang as _gang
from pixie_tpu_torch.ops.groupby import _identity_for
from pixie_tpu_torch.ops.merge import merge_states_plain
from pixie_tpu_torch.ops.pack import (NUMPY_DTYPES, Layout, flatten, leaf_nbytes,
                                      pack_plain, unflatten)
from pixie_tpu_torch.ops.sketch import LogHistogram
from pixie_tpu_torch.status import Internal

_F = "finalize"
#: csrc/finalize.cuh: row kinds, the header words of a row, the widest sketch
_MERGE, _QUANTILE, _FILL = 0, 1, 2
_ROW = 6
MAX_WIDTH = 1024
#: the int64 words one F2 launch's table may hold, smallest first
#: (csrc/finalize.cu FinalizeTable capacities, kMaxWords the last)
F2_WORDS = (64, 512, 4064)
#: one F1 launch's table: leaf updates, and fill plus quantile rows
#: (csrc/finalize.cu kF1Leaves, kF1Rows)
F1_LEAVES, F1_ROWS = 32, 48
#: csrc/merge.cuh Op and Dtype
_OPS = {"add": 0, "min": 1, "max": 2}
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int64: 2, torch.int32: 3}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@dataclasses.dataclass(frozen=True)
class Final:
    """An output the device finalizes: a LogHistogram sketch's quantiles,
    [G] for one quantile that drops its axis (QuantileUDA), else [G, nq]."""

    sketch: LogHistogram
    qs: tuple
    squeeze: bool


def finals_of(udas, finalize_ok: bool = True) -> dict:
    """{name: Final} for the (name, uda) pairs whose UDA finalizes on the
    device (`_device_finalize_split`); empty when not finalize_ok."""
    out = {}
    for name, uda in udas:
        if finalize_ok and uda.device_finalize:
            qs, squeeze = uda.device_quantiles()
            out[name] = Final(LogHistogram(), tuple(float(q) for q in qs), bool(squeeze))
    return out


def output_layout(state, finals: dict) -> Layout:
    """The output buffer of a state shaped like `state`: each final's f64
    quantiles ("finals", name), then every other leaf ("rest", *path)."""
    items = []
    for name, f in finals.items():
        g = int(state[name].shape[0])
        items.append((("finals", name), torch.float64, (g,) if f.squeeze else (g, len(f.qs))))
    rest = {k: v for k, v in state.items() if k not in finals}
    items.extend((("rest",) + path, leaf.dtype, tuple(leaf.shape))
                 for path, leaf in flatten(rest))
    return Layout.of(items)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@dataclasses.dataclass
class Finalized:
    """The packed output on its device (uint8) and its layout."""

    buf: torch.Tensor
    layout: Layout

    def unpack(self, raw: np.ndarray) -> tuple[dict, dict]:
        """The pulled bytes → (finals, rest) of numpy arrays."""
        tree = self.layout.unpack(raw)
        return tree.get("finals", {}), tree.get("rest", {})


# ------------------------------------------------- the per-plan constants


@functools.lru_cache(maxsize=8)
def _bin_values(sketch: LogHistogram) -> tuple:
    """gamma^(idx - 1.5) per bin, the host finalize's values (K3's table)."""
    return tuple(sketch.bin_value(np.arange(sketch.width)).tolist())


@dataclasses.dataclass(frozen=True, eq=False)
class Consts:
    """The f64 words the quantile rows point to, the same on every call: each
    final's quantiles and each sketch's bin values, in one buffer on the
    device, uploaded once (`consts_for`).  at: {name: (address of its
    quantiles, address of its sketch's bin values)}."""

    buf: torch.Tensor
    at: dict


_CONSTS: dict = {}
_CONSTS_LOCK = threading.Lock()


def consts_for(finals: dict, device) -> Consts:
    """The cached Consts of `finals` on `device` (one upload per finals and
    device)."""
    device = torch.device(device)
    key = (tuple(finals.items()), str(device))
    got = _CONSTS.get(key)
    if got is not None:
        return got
    words, where, binv = [], {}, {}
    for name, f in finals.items():
        qi = len(words)
        words.extend(f.qs)
        if f.sketch not in binv:
            binv[f.sketch] = len(words)
            words.extend(_bin_values(f.sketch))
        where[name] = (qi, binv[f.sketch])
    buf = torch.tensor(words or [0.0], dtype=torch.float64).to(device)
    base = buf.data_ptr()
    got = Consts(buf, {k: (base + 8 * q, base + 8 * b) for k, (q, b) in where.items()})
    with _CONSTS_LOCK:
        if len(_CONSTS) > 64:
            _CONSTS.clear()
        return _CONSTS.setdefault(key, got)


class _Table:
    """A row table (csrc/finalize.cuh): rows of _ROW + n_states int64."""

    def __init__(self, n_states: int):
        self.width = _ROW + n_states
        self.rows: list = []

    def quantile(self, f: Final, groups: int, dst: int, srcs: list, qs_at: int,
                 binv_at: int) -> None:
        """A quantile row: the sketch at srcs into [groups, nq] f64 at dst,
        its quantiles and bin values at the device addresses qs_at,
        binv_at (Consts)."""
        self.rows.append(([_QUANTILE, groups, dst, f.sketch.width | (len(f.qs) << 16), qs_at,
                           binv_at], srcs))

    def merge(self, op: str, dtype, n: int, dst: int, srcs: list, vec: bool = True) -> int:
        """A merge row; → the blocks it can use."""
        per_vec = 16 // dtype.itemsize
        units = -(-n // per_vec) if vec else n
        flags = _MERGE | (_OPS[op] << 4) | (_DTYPES[dtype] << 8) | (int(vec) << 16)
        self.rows.append(([flags, n, dst, 0, 0, 0], srcs))
        return -(-units // 256)

    def fill(self, dtype, n: int, dst: int, bits: int) -> None:
        self.rows.append(([_FILL | (_DTYPES[dtype] << 8), n, dst, bits, 0, 0], []))

    def array(self) -> np.ndarray:
        t = np.zeros((len(self.rows), self.width), dtype=np.int64)
        for i, (head, srcs) in enumerate(self.rows):
            t[i, :_ROW] = head
            t[i, _ROW:_ROW + len(srcs)] = srcs
        return t.reshape(-1)

    def pointer_mask(self) -> np.ndarray:
        """1 at the words of array() that hold an address in the launch
        buffer (a row's destination and sources), else 0."""
        m = np.zeros((len(self.rows), self.width), dtype=np.int64)
        for i, (_head, srcs) in enumerate(self.rows):
            m[i, 2] = 1
            m[i, _ROW:_ROW + len(srcs)] = 1
        return m.reshape(-1)


# ------------------------------------------------------------------ F2


def merge_finalize(states: list, reduce_tree: dict, finals: dict) -> Finalized:
    """F2 over N >= 1 states: kernel px_merge_finalize on CUDA tensors, the
    plain version on CPU tensors."""
    if not states:
        raise ValueError("merge_finalize: no states")
    leaves = [leaf for st in states for _p, leaf in flatten(st)]
    if any(x.is_cuda for x in leaves):
        if not all(x.is_cuda for x in leaves):
            raise ValueError("merge_finalize: states on the CPU and on a CUDA device")
        return _launch_f2(states, reduce_tree, finals, leaves[0].device)
    return merge_finalize_plain(states, reduce_tree, finals)


def _finals_plain(state, finals: dict) -> list:
    out = []
    for name, f in finals.items():
        q = f.sketch.quantile_plain(state[name], list(f.qs))
        out.append(q[:, 0].contiguous() if f.squeeze else q)
    return out


def merge_finalize_plain(states: list, reduce_tree: dict, finals: dict) -> Finalized:
    """The plain version of F2: merge_states_plain, quantile_plain for each
    final, pack_plain."""
    layout = output_layout(states[0], finals)
    merged = merge_states_plain(reduce_tree, states)
    leaves = _finals_plain(merged, finals)
    leaves += [_get(merged, p[1:]) for p in layout.paths[len(finals):]]
    return Finalized(pack_plain(leaves, layout), layout)


def _check_sketch(name: str, f: Final, x: torch.Tensor, want) -> None:
    if (x.dtype != torch.float32 or tuple(x.shape) != want or not x.is_contiguous()
            or f.sketch.width > MAX_WIDTH):
        raise TypeError(f"finalize: sketch {name} must be a contiguous float32 "
                        f"{want} tensor of at most {MAX_WIDTH} cells a group")


@dataclasses.dataclass(frozen=True, eq=False)
class F2Plan:
    """What F2 launches for N states of one tree and finals on one device,
    decided once: the output layout; per row the state path it reads and
    what each source must be (dtype, shape, contiguous); `template`, the
    [rows, _ROW + N] table with flags (vector flag set), counts, output
    offsets and the Consts addresses in place; the split into launches of
    whole rows (at most F2_WORDS[-1] words each) with each launch's blocks
    when every merge row is vectorized and when one is not."""

    layout: Layout
    n_states: int
    paths: tuple
    sigs: tuple
    template: np.ndarray
    is_merge: np.ndarray
    launches: tuple
    consts: Consts
    local: threading.local = dataclasses.field(default_factory=threading.local, repr=False)

    @classmethod
    def of(cls, state, reduce_tree, finals: dict, n_states: int, device) -> "F2Plan":
        layout = output_layout(state, finals)
        consts = consts_for(finals, device)
        table = _Table(n_states)
        paths, sigs, vec_blocks, scalar_blocks = [], [], [], []
        zeros = [0] * n_states
        for path, d, s, off in zip(layout.paths, layout.dtypes, layout.shapes, layout.offsets):
            if path[0] == "finals":
                name, f = path[1], finals[path[1]]
                x = state[name]
                _check_sketch(name, f, x, (s[0], f.sketch.width))
                table.quantile(f, s[0], off, zeros, *consts.at[name])
                paths.append((name,))
                sigs.append((x.dtype, x.shape, True))
                vec_blocks.append(s[0])
                scalar_blocks.append(s[0])
                continue
            if d not in _DTYPES:
                raise TypeError(f"merge_finalize: no merge for dtype {d}")
            op = _get(reduce_tree, path[1:])
            if op not in _OPS:
                raise ValueError(f"unknown reduce op {op!r}")
            n = 1
            for k in s:
                n *= k
            vec_blocks.append(table.merge(op, d, n, off, zeros))
            scalar_blocks.append(-(-n // 256))
            paths.append(path[1:])
            sigs.append((d, torch.Size(s), True))
        if len(table.rows) > 65535:
            raise ValueError("merge_finalize: more than 65535 output leaves")
        width = _ROW + n_states
        if width > F2_WORDS[-1]:
            raise ValueError(f"merge_finalize: {n_states} states, at most "
                             f"{F2_WORDS[-1] - _ROW}")
        per = F2_WORDS[-1] // width
        n_rows = len(table.rows)
        launches = tuple((a, min(a + per, n_rows), max([1, *vec_blocks[a:a + per]]),
                          max([1, *scalar_blocks[a:a + per]]))
                         for a in range(0, n_rows, per))
        template = table.array().reshape(n_rows, width)
        is_merge = (template[:, 0] & 0xF) == _MERGE
        return cls(layout, n_states, tuple(paths), tuple(sigs), template, is_merge, launches,
                   consts)

    def rows(self, states: list, base: int, device: int) -> tuple[np.ndarray, bool]:
        """The calling thread's rows for `states` into the buffer at `base`
        (every source checked against the plan, its pointer written, the
        vector flag cleared on a merge row with a source not 16-byte
        aligned) and whether every merge row kept it."""
        rows = getattr(self.local, "rows", None)
        if rows is None:
            rows = self.local.rows = self.template.copy()
        ptrs, low = [], 0
        for st in states:
            for path, sig in zip(self.paths, self.sigs):
                x = _get(st, path)
                if (x.dtype, x.shape, x.is_contiguous()) != sig or x.get_device() != device:
                    raise TypeError(f"merge_finalize: leaf {'/'.join(map(str, path))}: states "
                                    "differ in device, dtype or shape, or are not contiguous")
                p = x.data_ptr()
                low |= p
                ptrs.append(p)
        ins = np.array(ptrs, dtype=np.int64).reshape(len(states), -1).T
        rows[:, _ROW:] = ins
        np.add(self.template[:, 2], base, out=rows[:, 2])
        if not low & 15:
            rows[:, 0] = self.template[:, 0]
            return rows, True
        low = np.bitwise_or.reduce(ins, axis=1) & 15
        keep = ~self.is_merge | (low == 0)
        rows[:, 0] = np.where(keep, self.template[:, 0], self.template[:, 0] & ~(1 << 16))
        return rows, False


_F2_PLANS: dict = {}
_F2_LOCK = threading.Lock()


def f2_plan_for(states: list, reduce_tree, finals: dict, device) -> F2Plan:
    """The cached F2Plan for `states` (their tree and leaves' dtypes and
    shapes, N), `reduce_tree` and `finals` on `device`."""
    spec = tuple((path, x.dtype, tuple(x.shape)) for path, x in flatten(states[0]))
    key = (spec, repr(reduce_tree), tuple(finals.items()), len(states), device.index)
    plan = _F2_PLANS.get(key)
    if plan is None:
        plan = F2Plan.of(states[0], reduce_tree, finals, len(states), device)
        with _F2_LOCK:
            if len(_F2_PLANS) > 256:
                _F2_PLANS.clear()
            plan = _F2_PLANS.setdefault(key, plan)
    return plan


def _launch_f2(states, reduce_tree, finals, dev) -> Finalized:
    plan = f2_plan_for(states, reduce_tree, finals, dev)
    out = torch.empty(plan.layout.nbytes, dtype=torch.uint8, device=dev)
    rows, vec = plan.rows(states, out.data_ptr(), dev.index)
    fn = _build.function(_F, "px_merge_finalize", [_P, _I, _I, _L, _I, _P])
    stream = _build.raw_stream(dev.index)
    addr, row_bytes = rows.ctypes.data, rows.shape[1] * 8
    for a, b, vec_blocks, scalar_blocks in plan.launches:
        err = fn(addr + a * row_bytes, b - a, plan.n_states,
                 vec_blocks if vec else scalar_blocks, dev.index, stream)
        _build.check(_F, err, "merge_finalize")
        _build.KERNELS[_F].count("px_merge_finalize")
    return Finalized(out, plan.layout)


# ------------------------------------------------------------------ F1


def _identity_bits(op: str, dtype) -> int:
    """A leaf update's identity as the int64 the fill row writes (its low
    4 bytes for a 4-byte dtype)."""
    if op not in ("min", "max"):
        return 0
    v = np.array([_identity_for(dtype, op)], dtype=NUMPY_DTYPES[dtype])
    return int(v.view(np.int64 if v.itemsize == 8 else np.int32)[0])


def f1_fits(n_leaves: int, n_finals: int) -> bool:
    """Whether an aggregate of n_leaves gang leaf updates and n_finals
    finalized sketches fits one F1 launch's table (csrc/finalize.cu
    kF1Leaves, kF1Rows: a fill row a leaf, a quantile row a final)."""
    return n_leaves <= F1_LEAVES and n_leaves + n_finals <= F1_ROWS


@dataclasses.dataclass(frozen=True)
class F1Plan:
    """What an F1 launch needs that depends on the aggregate's shape alone,
    cached per shape key and device: the output layout; the launch buffer's
    size (the output, then scratch for the sketches that are finalized);
    each state leaf's (path, dtype, shape, byte offset) in that buffer; the
    member's leaf updates as (op, byte offset), in its order; the fill and
    quantile rows (csrc/finalize.cuh) with buffer offsets in the words
    `is_ptr` marks and the Consts addresses in place; the Consts."""

    layout: Layout
    total: int
    leaves: tuple
    fills: tuple
    table: np.ndarray
    is_ptr: np.ndarray
    n_fill: int
    n_rows: int
    consts: Consts

    def table_at(self, base: int) -> np.ndarray:
        """The row table for a launch buffer at device address `base`."""
        return self.table + self.is_ptr * base


def _views(buf: torch.Tensor, leaves: tuple):
    """The state tree as views of the launch buffer `buf`."""
    return unflatten([p for p, _d, _s, _o in leaves],
                     [buf[o:o + leaf_nbytes(d, s)].view(d).view(s) for _p, d, s, o in leaves])


def _state_leaves(template, finals: dict) -> tuple[Layout, tuple, int]:
    """→ (the output layout, each state leaf's (path, dtype, shape, offset)
    in the launch buffer, the buffer's bytes): the raw leaves live in the
    output at their packed offsets, the finalized sketches past it."""
    layout = output_layout(template, finals)
    leaves = [(p[1:], d, s, o) for p, d, s, o in
              zip(layout.paths, layout.dtypes, layout.shapes, layout.offsets) if p[0] == "rest"]
    total = layout.nbytes
    for name in finals:
        x = template[name]
        leaves.append(((name,), x.dtype, tuple(x.shape), total))
        total += -(-leaf_nbytes(x.dtype, x.shape) // 16) * 16
    return layout, tuple(leaves), total


def f1_plan(layout: Layout, leaves: tuple, total: int, finals: dict, member, base: int,
            device) -> F1Plan:
    """The plan of an F1 launch from its first member, built over a buffer
    at address `base` whose state views (_views) the member updates:
    fill rows for every leaf update, then a quantile row per final."""
    offs = sorted(o for _p, _d, _s, o in leaves)
    fills = tuple((lf.op, lf.state.data_ptr() - base) for lf in member.leaves)
    if sorted(o for _op, o in fills) != offs:
        raise Internal("fused finalize: the member's leaf updates do not cover its state "
                       "once each")
    if not f1_fits(len(member.leaves), len(finals)):
        raise ValueError(f"fused finalize: {len(member.leaves)} leaves and {len(finals)} "
                         "finals do not fit one launch's table (f1_fits)")
    consts = consts_for(finals, device)
    table = _Table(1)
    for lf, (_op, off) in zip(member.leaves, fills):
        table.fill(lf.state.dtype, lf.state.numel(), off, _identity_bits(lf.op, lf.state.dtype))
    n_fill = len(table.rows)
    sketch_at = {p[0]: o for p, _d, _s, o in leaves[len(leaves) - len(finals):]}
    for path, s, off in zip(layout.paths, layout.shapes, layout.offsets):
        if path[0] == "finals":
            f = finals[path[1]]
            table.quantile(f, s[0], off, [sketch_at[path[1]]], *consts.at[path[1]])
    return F1Plan(layout, total, leaves, fills, table.array(), table.pointer_mask(), n_fill,
                  len(table.rows), consts)


@dataclasses.dataclass(frozen=True, eq=False)
class F1Launch:
    """F1's launch for one plan: the member pass (ops/gang.py plan_f1_pass)
    and the member's encoding; `head(member, base, n)` the calling thread's
    host rows: the member and its leaves, then the plan's rows at `base`."""

    plan: F1Plan
    pass_plan: object
    codec: object
    local: threading.local = dataclasses.field(default_factory=threading.local, repr=False)

    def head(self, member, base: int, n: int, device: int) -> np.ndarray:
        buf = getattr(self.local, "buf", None)
        cut = self.codec.template.nbytes
        if buf is None:
            buf = self.local.buf = np.zeros(cut + self.plan.table.nbytes, dtype=np.uint8)
            buf[:cut] = self.codec.template
        buf[:cut].view(np.int64)[self.codec.patch] = self.codec.values([member], n, device)
        np.add(self.plan.table, self.plan.is_ptr * base, out=buf[cut:].view(np.int64))
        return buf


#: (shape key, finals, device index) → F1Plan; (that, the member's
#: ops/gang.py gang_key) → F1Launch: the member's encoding holds its
#: program (code, constants, depth, kinds), so two aggregates of one state
#: shape but different chains (a filter's literal, a deeper expression)
#: share the plan and never the launch
_F1_PLANS: dict = {}
_F1_LAUNCHES: dict = {}


def _cache(cache: dict, key, value):
    if len(cache) > 256:
        cache.clear()
    return cache.setdefault(key, value)


def fused_partial_finalize(build_member, init_state, reduce_tree: dict, finals: dict, n: int,
                           device, key=None) -> Finalized:
    """F1 over one feed of n rows: kernel px_fused_partial_finalize on a CUDA
    device, the plain version on the CPU.  `key`, when given, names the
    aggregate's shape (its state structure); the launch's F1Plan is then
    built once per key, finals and device, and its F1Launch once per plan
    and member shape (gang_key: program, inputs, leaf updates, NaN bin).
    The member pass keeps the state in a block's private shared
    accumulators where it fits (ops/gang.py plan_f1_pass)."""
    device = torch.device(device)
    if device.type != "cuda":
        state = init_state(device)
        _gang.run_plain([build_member(state)], n, device)
        return merge_finalize_plain([state], reduce_tree, finals)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = None if key is None else (key, tuple(finals.items()), device.index)
    plan = None if key is None else _F1_PLANS.get(key)
    if plan is None:
        layout, leaves, total = _state_leaves(init_state("meta"), finals)
    else:
        layout, leaves, total = plan.layout, plan.leaves, plan.total
    buf = torch.empty(total, dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    state = _views(buf, leaves)
    member = build_member(state)
    if plan is None:
        plan = f1_plan(layout, leaves, total, finals, member, base, device)
        for name, f in finals.items():
            _check_sketch(name, f, state[name], (int(state[name].shape[0]), f.sketch.width))
        if key is not None:
            plan = _cache(_F1_PLANS, key, plan)
    elif tuple((lf.op, lf.state.data_ptr() - base) for lf in member.leaves) != plan.fills:
        raise Internal("fused finalize: the member's leaf updates differ from its plan's")
    lkey = None if key is None else (key, _gang.gang_key([member], device))
    launch = None if lkey is None else _F1_LAUNCHES.get(lkey)
    if launch is None:
        _gang.check_sizes()
        pp = _gang.plan_f1_pass(member)
        launch = F1Launch(plan, pp, _gang.MemberCodec.of([member], pp, device))
        if lkey is not None:
            launch = _cache(_F1_LAUNCHES, lkey, launch)
    pp = launch.pass_plan
    head = launch.head(member, base, n, device.index)
    fn = _build.function(_F, "px_fused_partial_finalize",
                         [_P, _I, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P])
    err = fn(head.ctypes.data, launch.codec.n_leaves, n, pp.depth, pp.outs, pp.acc_bytes,
             pp.rows_per_thread, pp.block, int(pp.combine), plan.n_fill, plan.n_rows,
             device.index, _build.raw_stream(device.index))
    _build.check(_F, err, "fused_partial_finalize")
    _build.KERNELS[_F].count("px_fused_partial_finalize")
    return Finalized(buf[:plan.layout.nbytes], plan.layout)
