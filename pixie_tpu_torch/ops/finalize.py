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
(`px_merge_finalize`, `px_fused_partial_finalize`: one launch, its table
uploaded in one pinned non_blocking copy); on CPU tensors each runs its
plain version beside it (`merge_finalize_plain`: merge_states_plain,
quantile_plain and pack_plain; F1's plain version: the gang's plain
version, which is the per-sink route's plain steps, then F2's).  The
choice follows the device only; a CUDA tensor never reaches a plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

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


# ------------------------------------------------------------------ F2


def merge_finalize(states: list, reduce_tree: dict, finals: dict) -> Finalized:
    """F2 over N >= 1 states: kernel px_merge_finalize on CUDA tensors, the
    plain version on CPU tensors."""
    if not states:
        raise ValueError("merge_finalize: no states")
    layout = output_layout(states[0], finals)
    leaves = [leaf for st in states for _p, leaf in flatten(st)]
    if any(x.is_cuda for x in leaves):
        if not all(x.is_cuda for x in leaves):
            raise ValueError("merge_finalize: states on the CPU and on a CUDA device")
        return Finalized(_launch_f2(states, reduce_tree, finals, layout), layout)
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


@functools.lru_cache(maxsize=8)
def _bin_values(sketch: LogHistogram) -> tuple:
    """gamma^(idx - 1.5) per bin, the host finalize's values (K3's table)."""
    return tuple(sketch.bin_value(np.arange(sketch.width)).tolist())


class _Table:
    """A row table (csrc/finalize.cuh) and the f64 words its quantile rows
    index (the quantiles, one bin-value table per sketch)."""

    def __init__(self, n_states: int):
        self.width = _ROW + n_states
        self.rows: list = []
        self.extra: list = []
        self._binv: dict = {}

    def quantile(self, f: Final, groups: int, dst: int, srcs: list) -> None:
        qi = len(self.extra)
        self.extra.extend(f.qs)
        if f.sketch not in self._binv:
            self._binv[f.sketch] = len(self.extra)
            self.extra.extend(_bin_values(f.sketch))
        self.rows.append(([_QUANTILE, groups, dst, f.sketch.width | (len(f.qs) << 16)],
                          (qi, self._binv[f.sketch]), srcs))

    def merge(self, op: str, dtype, n: int, dst: int, srcs: list) -> int:
        """→ the blocks the row can use."""
        vec = not any(p & 15 for p in [dst, *srcs])
        per_vec = 16 // dtype.itemsize
        units = -(-n // per_vec) if vec else n
        flags = _MERGE | (_OPS[op] << 4) | (_DTYPES[dtype] << 8) | (int(vec) << 16)
        self.rows.append(([flags, n, dst, 0], None, srcs))
        return -(-units // 256)

    def fill(self, dtype, n: int, dst: int, bits: int) -> None:
        self.rows.append(([_FILL | (_DTYPES[dtype] << 8), n, dst, bits], None, []))

    def array(self) -> np.ndarray:
        base = len(self.rows) * self.width
        t = np.zeros(base + len(self.extra), dtype=np.int64)
        for i, (head, extra_at, srcs) in enumerate(self.rows):
            row = t[i * self.width:(i + 1) * self.width]
            row[:4] = head
            if extra_at is not None:
                row[4], row[5] = base + extra_at[0], base + extra_at[1]
            row[_ROW:_ROW + len(srcs)] = srcs
        t[base:].view(np.float64)[:] = self.extra
        return t

    def pointer_mask(self) -> np.ndarray:
        """1 at the words of array() that hold a device address (a row's
        destination and sources), else 0."""
        m = np.zeros(len(self.rows) * self.width + len(self.extra), dtype=np.int64)
        for i, (_head, _extra_at, srcs) in enumerate(self.rows):
            m[i * self.width + 2] = 1
            m[i * self.width + _ROW:i * self.width + _ROW + len(srcs)] = 1
        return m


def _launch_f2(states, reduce_tree, finals, layout) -> torch.Tensor:
    dev = next(leaf for _p, leaf in flatten(states[0])).device
    out = torch.empty(layout.nbytes, dtype=torch.uint8, device=dev)
    base = out.data_ptr()
    table = _Table(len(states))
    max_blocks = 1
    for path, d, s, off in zip(layout.paths, layout.dtypes, layout.shapes, layout.offsets):
        if path[0] == "finals":
            name, f = path[1], finals[path[1]]
            xs = [st[name] for st in states]
            for x in xs:
                _check_sketch(name, f, x, (s[0], f.sketch.width))
                if x.device != dev:
                    raise ValueError("merge_finalize: states on different devices")
            table.quantile(f, s[0], base + off, [x.data_ptr() for x in xs])
            max_blocks = max(max_blocks, s[0])
            continue
        xs = [_get(st, path[1:]) for st in states]
        sig = (d, s, dev)
        if any((x.dtype, tuple(x.shape), x.device) != sig or not x.is_contiguous() for x in xs):
            raise TypeError(f"merge_finalize: leaf {'/'.join(map(str, path[1:]))}: states "
                            "differ in device, dtype or shape, or are not contiguous")
        if d not in _DTYPES:
            raise TypeError(f"merge_finalize: no merge for dtype {d}")
        op = _get(reduce_tree, path[1:])
        if op not in _OPS:
            raise ValueError(f"unknown reduce op {op!r}")
        n = 1
        for k in s:
            n *= k
        max_blocks = max(max_blocks, table.merge(op, d, n, base + off,
                                                 [x.data_ptr() for x in xs]))
    if len(table.rows) > 65535:
        raise ValueError("merge_finalize: more than 65535 output leaves")
    t = torch.from_numpy(table.array()).pin_memory().to(dev, non_blocking=True)
    fn = _build.function(_F, "px_merge_finalize", [_P, _I, _I, _L, _P])
    with torch.cuda.device(dev):
        err = fn(_build.ptr(t), len(table.rows), len(states), max_blocks, _build.stream_of(t))
    _build.check(_F, err, "merge_finalize")
    _build.KERNELS[_F].count("px_merge_finalize")
    return out


# ------------------------------------------------------------------ F1


def _identity_bits(op: str, dtype) -> int:
    """A leaf update's identity as the int64 the fill row writes (its low
    4 bytes for a 4-byte dtype)."""
    if op not in ("min", "max"):
        return 0
    v = np.array([_identity_for(dtype, op)], dtype=NUMPY_DTYPES[dtype])
    return int(v.view(np.int64 if v.itemsize == 8 else np.int32)[0])


@dataclasses.dataclass(frozen=True)
class F1Plan:
    """What an F1 launch needs that depends on the aggregate's shape alone,
    cached per shape key: the output layout; the launch buffer's size (the
    output, then scratch for the sketches that are finalized); each state
    leaf's (path, dtype, shape, byte offset) in that buffer; the member's
    leaf updates as (op, byte offset), in its order; the fill and quantile
    rows (csrc/finalize.cuh) with buffer offsets in the words `is_ptr`
    marks; and whether the sketches fit a block's private accumulators."""

    layout: Layout
    total: int
    leaves: tuple
    fills: tuple
    table: np.ndarray
    is_ptr: np.ndarray
    n_fill: int
    n_rows: int
    hist_shared: bool

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


def f1_plan(layout: Layout, leaves: tuple, total: int, finals: dict, member,
            base: int) -> F1Plan:
    """The plan of an F1 launch from its first member, built over a buffer
    at address `base` whose state views (_views) the member updates:
    fill rows for every leaf update, then a quantile row per final."""
    offs = sorted(o for _p, _d, _s, o in leaves)
    fills = tuple((lf.op, lf.state.data_ptr() - base) for lf in member.leaves)
    if sorted(o for _op, o in fills) != offs:
        raise Internal("fused finalize: the member's leaf updates do not cover its state "
                       "once each")
    table = _Table(1)
    for lf, (_op, off) in zip(member.leaves, fills):
        table.fill(lf.state.dtype, lf.state.numel(), off, _identity_bits(lf.op, lf.state.dtype))
    n_fill = len(table.rows)
    sketch_at = {p[0]: o for p, _d, _s, o in leaves[len(leaves) - len(finals):]}
    for path, s, off in zip(layout.paths, layout.shapes, layout.offsets):
        if path[0] == "finals":
            f = finals[path[1]]
            table.quantile(f, s[0], off, [sketch_at[path[1]]])
    need = sum(_gang.leaf_shared_bytes(lf, member.num_groups) for lf in member.leaves)
    return F1Plan(layout, total, leaves, fills, table.array(), table.pointer_mask(), n_fill,
                  len(table.rows), need <= _gang.SHARED_STATE_BYTES)


_F1_PLANS: dict = {}


def fused_partial_finalize(build_member, init_state, reduce_tree: dict, finals: dict, n: int,
                           device, key=None) -> Finalized:
    """F1 over one feed of n rows: kernel px_fused_partial_finalize on a CUDA
    device, the plain version on the CPU.  `key`, when given, names the
    aggregate's shape (its state structure); the launch's plan (F1Plan) is
    then built once per key and finals.  A state within G1's budget
    (SHARED_STATE_BYTES) keeps every leaf in a block's private shared
    accumulators; past it the sketches take global atomics and the small
    leaves stay private."""
    device = torch.device(device)
    if device.type != "cuda":
        state = init_state(device)
        _gang.run_plain([build_member(state)], n, device)
        return merge_finalize_plain([state], reduce_tree, finals)
    key = None if key is None else (key, tuple(finals.items()))
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
        plan = f1_plan(layout, leaves, total, finals, member, base)
        for name, f in finals.items():
            _check_sketch(name, f, state[name], (int(state[name].shape[0]), f.sketch.width))
        if key is not None:
            if len(_F1_PLANS) > 256:
                _F1_PLANS.clear()
            _F1_PLANS[key] = plan
    elif tuple((lf.op, lf.state.data_ptr() - base) for lf in member.leaves) != plan.fills:
        raise Internal("fused finalize: the member's leaf updates differ from its plan's")
    # G1's budget: config #1's 64-group sketch (131,584 B) privatized leaves
    # one block of 256 threads a SM, slower than its global atomics (PERF.md)
    budget = _gang.SHARED_STATE_BYTES
    enc = _gang.encode([member], n, device, budget, max(_gang.BLOCK_SMEM, budget + 64 * 1024),
                       hist_shared=plan.hist_shared)
    head = enc.blob + bytes(-len(enc.blob) % 16)
    # one upload: the member, its leaves and the row table
    dev_buf = torch.frombuffer(bytearray(head + plan.table_at(base).tobytes()),
                               dtype=torch.uint8).pin_memory().to(device, non_blocking=True)
    at = dev_buf.data_ptr()
    fn = _build.function(_F, "px_fused_partial_finalize",
                         [_P, _P, _I, _L, _I, _I, _I, _I, _P, _I, _I, _P])
    with torch.cuda.device(device):
        err = fn(ctypes.c_void_p(at), ctypes.c_void_p(at + enc.leaves_at), enc.n_leaves, n,
                 enc.depth, enc.outs, enc.acc_bytes, enc.rows_per_thread,
                 ctypes.c_void_p(at + len(head)), plan.n_fill, plan.n_rows,
                 _build.stream_of(buf))
    _build.check(_F, err, "fused_partial_finalize")
    _build.KERNELS[_F].count("px_fused_partial_finalize")
    return Finalized(buf[:plan.layout.nbytes], plan.layout)
