"""M1: the cross-agent merge of aggregate states.

Reference: pixie_tpu/engine/executor.py `ChainKernel.merge_states_fn` — one
stacked sum, min or max per state leaf over N states of the same tree, the
op of each leaf from its UDA's `reduce_ops()` — which `gang_merge_states`
runs over the agents of one LocalCluster query when their state layouts
agree.

`merge_states(reduce_tree, states)` returns one state: leaf j of the output
reduces leaf j of states 0..N-1 in that order.  Integer adds wrap (two's
complement), float adds run in agent order, and min / max propagate NaN as
jnp.min / jnp.max do.  On CUDA tensors it launches kernel M1
(csrc/merge.cu `px_merge_states`): one launch for every leaf, driven by a
descriptor table that reaches the device in one pinned non_blocking copy.  On
CPU tensors it runs the plain PyTorch version beside it (a loop of
torch.add / torch.minimum / torch.maximum, which propagate NaN).  The choice
follows the states' device only; a CUDA tensor never reaches the plain version.

`collective_merge(reduce_tree, shard_states)` is the same merge over the
shards of one mesh (row 13: parallel/spmd.py's psum / pmin / pmax of each
state leaf over the mesh axis), used by the port's co-located shards.
"""
from __future__ import annotations

import ctypes

import torch

from pixie_tpu_torch.ops import _build

_M1 = "merge"
_OPS = {"add": 0, "min": 1, "max": 2}
_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int64: 2, torch.int32: 3}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PLAIN = {"add": torch.add, "min": torch.minimum, "max": torch.maximum}


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


def merge_states_plain(reduce_tree, states: list):
    """The plain PyTorch version: per leaf, fold the states in order."""
    merged = {}
    for path, op, xs in _leaves(reduce_tree, states):
        acc = xs[0]
        for x in xs[1:]:
            acc = _PLAIN[op](acc, x)
        merged[path] = acc.clone() if len(xs) == 1 else acc
    return _rebuild(reduce_tree, merged)


def _launch_m1(leaves: list) -> dict:
    n = len(leaves[0][2])
    dev = leaves[0][2][0].device
    rows, outs, max_units = [], {}, 1
    if any(xs[0].get_device() != dev.index for _p, _o, xs in leaves):
        raise ValueError("merge_states: leaves on different devices")
    for path, op, xs in leaves:
        x0 = xs[0]
        # (the wrapper's host time is most of M1's at small states: one
        # signature tuple per tensor is the cheapest complete check)
        sig = (x0.dtype, x0.shape, x0.get_device())
        if any((x.dtype, x.shape, x.get_device()) != sig or not x.is_contiguous()
               for x in xs):
            raise TypeError(f"leaf {'/'.join(path)}: states differ in device, dtype "
                            "or shape, or are not contiguous")
        if x0.dtype not in _DTYPES:
            raise TypeError(f"leaf {'/'.join(path)}: no merge for dtype {x0.dtype}")
        out = torch.empty_like(x0)
        outs[path] = out
        ptrs = [out.data_ptr(), *(x.data_ptr() for x in xs)]
        vec = not any(q & 15 for q in ptrs)
        per_vec = 16 // x0.element_size()
        units = -(-x0.numel() // per_vec) if vec else x0.numel()
        max_units = max(max_units, units)
        flags = _OPS[op] | (_DTYPES[x0.dtype] << 8) | (int(vec) << 16)
        rows.append([flags, x0.numel(), *ptrs])
    # one small pinned copy of the descriptor table (device pointers stay
    # below 2^63, so int64 holds them)
    desc = torch.tensor(rows, dtype=torch.int64).pin_memory().to(dev, non_blocking=True)
    fn = _build.function(_M1, "px_merge_states", [_P, _I, _I, _L, _P])
    with torch.cuda.device(dev):
        err = fn(_build.ptr(desc), len(rows), n, max_units, _build.stream_of(desc))
    _build.check(_M1, err, "merge_states")
    _build.KERNELS[_M1].count("px_merge_states")
    return outs


def merge_states(reduce_tree, states: list):
    """→ one state: every leaf reduced over `states` (N >= 1 trees shaped
    like `reduce_tree`, whose leaves name the op).  One state comes back as
    it is."""
    if not states:
        raise ValueError("merge_states: no states")
    if len(states) == 1:
        return states[0]
    leaves = _leaves(reduce_tree, states)
    if not leaves:
        return {}
    if leaves[0][2][0].is_cuda:
        return _rebuild(reduce_tree, _launch_m1(leaves))
    if any(x.is_cuda for _p, _o, xs in leaves for x in xs):
        raise ValueError("merge_states: states on the CPU and on a CUDA device")
    return merge_states_plain(reduce_tree, states)


def collective_merge(reduce_tree, shard_states: list):
    """Row 13, the collective merge of a mesh's shard states (reference
    parallel/spmd.py `collective_merge`: psum / pmin / pmax of each leaf over
    the mesh axis) → one state.  Kernel M1 on CUDA tensors, the plain version
    on CPU tensors; one shard comes back as it is."""
    return merge_states(reduce_tree, shard_states)
