"""M1: the cross-agent merge of aggregate states.

Reference: pixie_tpu/engine/executor.py `ChainKernel.merge_states_fn` — one
stacked sum, min or max per state leaf over N states of the same tree, the
op of each leaf from its UDA's `reduce_ops()` — which `gang_merge_states`
runs over the agents of one LocalCluster query when their state layouts
agree.

`merge_states(reduce_tree, states)` returns one state: leaf j of the output
reduces leaf j of states 0..N-1 in that order.  Integer adds wrap (two's
complement), float adds run in agent order, and min / max propagate NaN as
jnp.min / jnp.max do.  The merged state is written packed: every leaf at
its offset of the P1 layout of the merged tree (ops/pack.py `Layout`, in
the reduce tree's key order), in one uint8 buffer from one allocation.  It
comes back as `pack.Packed`, which `transfer.pull_states` reads back in one
copy with no P1 launch; with `packed=False`, or when the tree does not
pack (`pack.worth_packing`: no more leaves than dtypes), as the tree of
views of that buffer.  A state may itself be a `Packed` (M1's own output,
or P1's), so a mesh agent's merged partial enters the cross-agent merge as
it is.

On CUDA tensors it launches kernel M1 (csrc/merge.cu `px_merge_states`):
one launch for all leaves while the descriptor table fits one launch's
parameter block (M1_WORDS), else one per block of whole rows, the table
passed by value (no upload).  What the tree and N alone decide -- the
output layout, each row's op / dtype / count / offset, the split into
launches and their grids -- is computed once per (reduce tree, leaf spec,
N) (`M1Plan`); a call checks each input against it, writes the pointers
into its thread's row buffer and makes one C call a launch.  On CPU
tensors it runs the plain PyTorch version beside it (a loop of torch.add /
torch.minimum / torch.maximum, which propagate NaN), packed by P1's plain
version into the same form.  The choice follows the states' device only;
a CUDA tensor never reaches the plain version.

`collective_merge(reduce_tree, shard_states)` is the same merge over the
shards of one mesh (row 13: parallel/spmd.py's psum / pmin / pmax of each
state leaf over the mesh axis), used by the port's co-located shards.
`merge_packed` returns the merged state as a Packed whatever the tree (one
state packed by P1 when it is not one already): the buffer a mesh across
processes gathers and merges again (parallel/multihost.py world_merge).
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading

import numpy as np
import torch

from pixie_tpu_torch.ops import _build
from pixie_tpu_torch.ops.pack import (
    Layout, Packed, pack, pack_plain, unflatten, worth_packing,
)

_M1 = "merge"
_OPS = {"add": 0, "min": 1, "max": 2}
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int64: 2, torch.int32: 3}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PLAIN = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}
#: the int64 words one M1 launch's descriptor table may hold, smallest first
#: (csrc/merge.cu: the struct's capacities, kMaxWords the last)
M1_WORDS = (64, 512, 4064)
#: words of a row before its input pointers: flags, count, output pointer
_HEADER = 3
#: the most states one merge takes (one row must fit one launch)
MAX_STATES = M1_WORDS[-1] - _HEADER
_VEC = 1 << 16


def _ops(reduce_tree, path=()) -> tuple:
    """((path, op), ...) of a reduce tree, in its key order."""
    if isinstance(reduce_tree, dict):
        return tuple(x for k, v in reduce_tree.items() for x in _ops(v, path + (k,)))
    if reduce_tree not in _OPS:
        raise ValueError(f"unknown reduce op {reduce_tree!r}")
    return ((path, reduce_tree),)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(reduce_tree, states, path=()):
    """[(path, op, [leaf of each state])] in the tree's key order."""
    if isinstance(reduce_tree, dict):
        out = []
        for k in reduce_tree:
            out.extend(_leaves(reduce_tree[k], [s[k] for s in states], path + (k,)))
        return out
    if reduce_tree not in _OPS:
        raise ValueError(f"unknown reduce op {reduce_tree!r}")
    return [(path, reduce_tree, list(states))]


def _rebuild(reduce_tree, merged: dict, path=()):
    if isinstance(reduce_tree, dict):
        return {k: _rebuild(v, merged, path + (k,)) for k, v in reduce_tree.items()}
    return merged[path]


def _tree(state):
    return state.tree() if isinstance(state, Packed) else state


def merge_states_plain(reduce_tree, states: list):
    """The plain PyTorch version: per leaf, fold the states in order (each
    leaf its own tensor)."""
    merged = {}
    for path, op, xs in _leaves(reduce_tree, [_tree(s) for s in states]):
        acc = xs[0]
        for x in xs[1:]:
            acc = _PLAIN[op](acc, x)
        merged[path] = acc.clone() if len(xs) == 1 else acc
    return _rebuild(reduce_tree, merged)


@dataclasses.dataclass(frozen=True, eq=False)
class M1Plan:
    """What merging N states of one reduce tree and leaf spec launches,
    decided once.

    layout: the merged tree's packed layout (the output buffer), in the
      reduce tree's key order; packs: whether the merged state is returned
      as a Packed (pack.worth_packing);
    sigs: per leaf (path, (dtype, shape, contiguous)), what each input
      must be;
    template: [leaves, 3 + N] int64 rows with each leaf's flags (vector
      flag set), element count and output offset in place; a call adds the
      buffer's address to the offsets and writes the N input pointers;
    launches: (first row, end row, most units of a leaf) of each launch, at
      most M1_WORDS[-1] words each, in leaf order."""

    ops: tuple
    layout: Layout
    packs: bool
    n_states: int
    sigs: tuple
    template: np.ndarray
    launches: tuple
    local: threading.local = dataclasses.field(default_factory=threading.local,
                                               repr=False)

    @classmethod
    def of(cls, ops: tuple, spec: tuple, n_states: int) -> "M1Plan":
        """ops: ((path, op), ...); spec: ((dtype, shape), ...) along them."""
        if n_states > MAX_STATES:
            raise ValueError(f"merge_states: {n_states} states, at most {MAX_STATES}")
        items = [(path, d, s) for (path, _op), (d, s) in zip(ops, spec)]
        for path, d, _s in items:
            if d not in _DTYPES:
                raise TypeError(f"leaf {'/'.join(path)}: no merge for dtype {d}")
        layout = Layout.of(items)
        width = _HEADER + n_states
        template = np.zeros((len(items), width), dtype=np.int64)
        units = []
        for i, ((_path, op), (d, _s), n, off) in enumerate(zip(ops, spec, layout.sizes(),
                                                             layout.offsets)):
            numel = n // d.itemsize
            template[i, :_HEADER] = (_OPS[op] | (_DTYPES[d] << 8) | _VEC, numel, off)
            units.append(-(-numel // (16 // d.itemsize)))
        per = M1_WORDS[-1] // width
        launches = tuple((a, min(a + per, len(items)), max([1, *units[a:a + per]]))
                         for a in range(0, len(items), per))
        sigs = tuple((path, (d, torch.Size(s), True)) for path, d, s in items)
        return cls(ops, layout, worth_packing(items), n_states, sigs, template, launches)

    def rows(self, states: list, base: int, device: int) -> np.ndarray:
        """The calling thread's descriptor rows for merging `states` (trees
        or Packed) into the buffer at address `base`: every input checked
        against the plan (dtype, shape, device index, contiguous; a Packed
        by its layout), its pointer written, and each row's vector flag
        cleared where one of its pointers is not 16-byte aligned.  The
        buffer is this thread's own and is rewritten by its next call."""
        rows = getattr(self.local, "rows", None)
        if rows is None:
            rows = self.local.rows = self.template.copy()
        layout = self.layout
        ptrs, low = [], 0
        for st in states:
            if isinstance(st, Packed):
                if st.layout != layout or st.buf.get_device() != device:
                    raise TypeError("merge_states: a packed state's layout or device differs")
                b = st.buf.data_ptr()
                low |= b
                ptrs.extend(b + o for o in layout.offsets)
                continue
            for path, sig in self.sigs:
                x = _at(st, path)
                # (one tuple compare a tensor: the check is most of the
                # host's time a call at config #4's state)
                if (x.dtype, x.shape, x.is_contiguous()) != sig or x.get_device() != device:
                    raise TypeError(f"leaf {'/'.join(path)}: states differ in device, dtype "
                                    "or shape, or are not contiguous")
                p = x.data_ptr()
                low |= p
                ptrs.append(p)
        ins = np.array(ptrs, dtype=np.int64).reshape(len(states), -1)
        rows[:, _HEADER:] = ins.T
        np.add(self.template[:, 2], base, out=rows[:, 2])
        # every output offset is 16-byte aligned: only an input can clear a
        # row's vector flag
        if low & 15:
            vec = (np.bitwise_or.reduce(ins, axis=0) & 15) == 0
            rows[:, 0] = np.where(vec, self.template[:, 0], self.template[:, 0] & ~_VEC)
        else:
            rows[:, 0] = self.template[:, 0]
        return rows


_PLANS: dict = {}
#: repr of a reduce tree -> its _ops (a tree is str leaves in nested dicts,
#: so equal reprs are equal trees with the same key order)
_TREE_OPS: dict = {}
_PLANS_LOCK = threading.Lock()


def plan_for(reduce_tree, states: list) -> M1Plan:
    """The cached M1Plan for `states` (trees or Packed) under `reduce_tree`."""
    tree_key = repr(reduce_tree)
    ops = _TREE_OPS.get(tree_key)
    if ops is None:
        ops = _ops(reduce_tree)
        with _PLANS_LOCK:
            if len(_TREE_OPS) > 256:
                _TREE_OPS.clear()
            _TREE_OPS[tree_key] = ops
    first = states[0]
    if isinstance(first, Packed):
        if first.layout.paths != tuple(p for p, _op in ops):
            raise TypeError("merge_states: a packed state's leaves are not the reduce tree's")
        spec = tuple(zip(first.layout.dtypes, first.layout.shapes))
    else:
        spec = tuple((x.dtype, tuple(x.shape)) for x in (_at(first, p) for p, _op in ops))
    key = (ops, spec, len(states))
    plan = _PLANS.get(key)
    if plan is None:
        plan = M1Plan.of(ops, spec, len(states))
        with _PLANS_LOCK:
            if len(_PLANS) > 256:
                _PLANS.clear()
            plan = _PLANS.setdefault(key, plan)
    return plan


def _result(plan: M1Plan, buf: torch.Tensor, packed: bool):
    if packed and plan.packs:
        return Packed(buf, plan.layout)
    return unflatten(plan.layout.paths, plan.layout.views(buf))


def _device_of(state) -> torch.device:
    if isinstance(state, Packed):
        return state.buf.device
    while isinstance(state, dict):
        state = next(iter(state.values()))
    return state.device


def _launch_m1(plan: M1Plan, states: list, dev: torch.device) -> torch.Tensor:
    out = torch.empty(plan.layout.nbytes, dtype=torch.uint8, device=dev)
    rows = plan.rows(states, out.data_ptr(), dev.index)
    fn = _build.function(_M1, "px_merge_states", [_P, _I, _I, _L, _I, _P])
    stream = _build.raw_stream(dev.index)
    addr, row_bytes = rows.ctypes.data, rows.shape[1] * 8
    for a, b, max_units in plan.launches:
        err = fn(addr + a * row_bytes, b - a, plan.n_states, max_units, dev.index, stream)
        _build.check(_M1, err, "merge_states")
        _build.KERNELS[_M1].count("px_merge_states")
    return out


def _merge_buffer(reduce_tree, plan: M1Plan, states: list) -> torch.Tensor:
    """N >= 2 states merged into one uint8 buffer of plan.layout: kernel M1
    on CUDA states, the plain version packed by P1's plain version on CPU
    states."""
    dev = _device_of(states[0])
    if dev.type == "cuda":
        return _launch_m1(plan, states, dev)
    trees = [_tree(s) for s in states]
    if any(x.is_cuda for _p, _o, xs in _leaves(reduce_tree, trees) for x in xs):
        raise ValueError("merge_states: states on the CPU and on a CUDA device")
    merged = merge_states_plain(reduce_tree, trees)
    return pack_plain([_at(merged, path) for path in plan.layout.paths], plan.layout)


def merge_states(reduce_tree, states: list, packed: bool = True):
    """→ one state: every leaf reduced over `states` (N >= 1 trees shaped
    like `reduce_tree`, whose leaves name the op, or Packed states of its
    layout), written into one packed buffer: a Packed, or with
    `packed=False` (or a tree that does not pack) the tree of views of it.
    One state comes back as it is."""
    if not states:
        raise ValueError("merge_states: no states")
    if len(states) == 1:
        return states[0]
    plan = plan_for(reduce_tree, states)
    if not plan.ops:
        return {}
    return _result(plan, _merge_buffer(reduce_tree, plan, states), packed)


def merge_packed(reduce_tree, states: list) -> Packed:
    """→ the merged state as a Packed whatever the tree, the buffer that
    crosses processes (parallel/multihost.py `world_merge`): M1 over N >= 2
    states; one state as it is when it is a Packed, else its leaves packed
    into the same layout (P1)."""
    if not states:
        raise ValueError("merge_states: no states")
    plan = plan_for(reduce_tree, states)
    if len(states) > 1:
        return Packed(_merge_buffer(reduce_tree, plan, states), plan.layout)
    if isinstance(states[0], Packed):
        return states[0]
    leaves = [_at(states[0], path).contiguous() for path in plan.layout.paths]
    return Packed(pack(leaves, plan.layout), plan.layout)


def collective_merge(reduce_tree, shard_states: list, packed: bool = True):
    """Row 13, the collective merge of a mesh's shard states (reference
    parallel/spmd.py `collective_merge`: psum / pmin / pmax of each leaf over
    the mesh axis) → one state, as merge_states returns it.  Kernel M1 on
    CUDA tensors, the plain version on CPU tensors; one shard comes back as
    it is."""
    return merge_states(reduce_tree, shard_states, packed)
