"""G1: the multi-query gang — every member's partial aggregate step over one
shared feed in one launch.

Replaces the reference's `_multi_partial_agg` / `fused_fn`
(pixie_tpu/engine/executor.py:2807, :2852), which traced the gang members'
own partial steps into one XLA program per feed.  A gang member is one
partial aggregate of a batched query (engine/executor.py
`_multi_partial_agg`): its chain program (ops/chain.py, the same Program and
binding C1 runs), the program's inputs over this feed, and a table of leaf
updates — one per state leaf of each of its UDAs, naming the op, the value
(a feed column, or an output slot of the program) and the state tensor the
update folds into, in place.

`run` updates every member's states over one feed of n rows.  On CUDA
tensors it launches kernel G1 (csrc/gang.cu `px_gang_partial`) once: the
members' ChainParams (packed as ops/chain.py packs them for C1) and the
leaf table travel in one small device buffer.  On CPU tensors it runs the
plain version beside it: each member's program through the plain
interpreter, then each leaf through the plain form of the kernel the
per-sink route would launch (K1's segment count / sum / min / max, K2's
sketch update), so on the CPU the gang is bit for bit the per-sink route.
The choice follows the tensors' device only; a CUDA tensor never reaches
the plain version, and a missing nvcc or a failed build raises.

Leaf ops (`Leaf.op`): "count", "sum", "sumsq" (sum of the value's square
in float64), "min", "max" and "hist" (a LogHistogram sketch's cell count).
The state's dtype picks the typed update; values convert to it as torch's
`.to()` does.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from pixie_tpu_torch.ops import _build
from pixie_tpu_torch.ops import chain as _chain
from pixie_tpu_torch.ops import groupby as _gb
from pixie_tpu_torch.status import Internal

_G1 = "gang"

#: csrc/gang.cu LeafOp, by (op, state dtype)
LEAF_CODES = {
    ("count", torch.int64): 0,
    ("sum", torch.int64): 1,
    ("sum", torch.float64): 2,
    ("sumsq", torch.float64): 3,
    ("min", torch.int32): 4,
    ("max", torch.int32): 5,
    ("min", torch.int64): 6,
    ("max", torch.int64): 7,
    ("min", torch.float64): 8,
    ("max", torch.float64): 9,
    ("hist", torch.float32): 10,
}
_KIND_OF = {dt: kind for kind, dt in _chain.DTYPE.items()}

#: a block's private accumulators for the members whose states fit (bytes)
SHARED_STATE_BYTES = 48 * 1024
#: shared memory a block aims at, so that two blocks fit on one SM
BLOCK_SMEM = 112 * 1024
#: threads per block (csrc/chain.cuh kBlock)
BLOCK = 256


@dataclasses.dataclass
class Leaf:
    """One state leaf's update."""

    op: str
    #: the leaf tensor, updated in place: [G], or [G, width] for "hist"
    state: torch.Tensor
    #: the value: a feed column (a tensor of n rows), an output slot of the
    #: member's program (int), or None for "count"
    value: object = None
    #: "hist": the LogHistogram whose cells the state holds
    sketch: object = None


@dataclasses.dataclass
class Member:
    """One gang member over one feed: its program and the program's inputs
    in binding order (ops/chain.py Binding), its group count and its leaf
    updates."""

    prog: _chain.Program
    cols: list
    luts: list
    scalars: list
    num_groups: int
    leaves: list


def run(members: list, n: int, device) -> None:
    """Update every member's states over one feed of n rows: kernel G1 on a
    CUDA device, the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        _launch_g1(members, n, device)
    else:
        run_plain(members, n, device)


# ------------------------------------------------------------ plain version


def _value(leaf: Leaf, outs: list) -> torch.Tensor:
    return outs[leaf.value] if isinstance(leaf.value, int) else leaf.value


def run_plain(members: list, n: int, device) -> None:
    """The plain version of G1: per member, its program through the plain
    interpreter, then each leaf through the plain version of the kernel the
    per-sink route launches for it."""
    for m in members:
        mask, gid, outs = _chain.run_plain(m.prog, m.cols, m.luts, m.scalars, n, device)
        if gid is None:
            gid = torch.zeros(n, dtype=torch.int32, device=device)
        g = m.num_groups
        for leaf in m.leaves:
            st = leaf.state
            if leaf.op == "count":
                _gb.segment_count_plain(gid, g, mask, st)
            elif leaf.op == "sum":
                _gb.segment_sum_plain(_value(leaf, outs).to(st.dtype), gid, g, mask, st)
            elif leaf.op == "sumsq":
                v = _value(leaf, outs).to(torch.float64)
                _gb.segment_sum_plain(v * v, gid, g, mask, st)
            elif leaf.op in ("min", "max"):
                _gb.segment_pick_plain(_value(leaf, outs).to(st.dtype), gid, g, mask, st,
                                       leaf.op)
            elif leaf.op == "hist":
                leaf.sketch.update_plain(st, gid, _value(leaf, outs), mask, g)
            else:
                raise Internal(f"gang: unknown leaf op {leaf.op!r}")


# ------------------------------------------------------------- G1 (CUDA)

_P, _I = ctypes.c_void_p, ctypes.c_int


class _Member(ctypes.Structure):
    """csrc/gang.cu GangMember."""

    _fields_ = [("chain", _chain._Params), ("groups", _I), ("leaf0", _I), ("nleaf", _I),
                ("pad", _I)]


class _Leaf(ctypes.Structure):
    """csrc/gang.cu GangLeaf."""

    _fields_ = [("state", _P), ("col", _P), ("min_d", ctypes.c_double), ("op", _I),
                ("kind", _I), ("slot", _I), ("groups", _I), ("shared_off", _I),
                ("width", _I), ("log_gamma", ctypes.c_float), ("min_f", ctypes.c_float)]


_sizes_checked = False


def _check_sizes() -> None:
    global _sizes_checked
    if _sizes_checked:
        return
    fn = _build.function(_G1, "px_gang_struct_size", [_I])
    for which, cls in ((0, _Member), (1, _Leaf)):
        if fn(which) != ctypes.sizeof(cls):
            raise Internal(f"G1 {cls.__name__} is {fn(which)} bytes on the card, "
                           f"{ctypes.sizeof(cls)} in the wrapper")
    _sizes_checked = True


def leaf_shared_bytes(leaf: Leaf, num_groups: int, hist_shared: bool = True) -> int:
    """Bytes of a block's private accumulators for one leaf (K1's 32-bit
    counters for counts, 8 B for int64 and float64 sums, min and max, K2's
    32-bit counts per sketch cell), rounded up to 8; 0 for a sketch that
    takes global atomics (hist_shared False)."""
    st = leaf.state
    if leaf.op == "hist" and not hist_shared:
        return 0
    if leaf.op == "hist":
        b = 4 * num_groups * st.shape[1]
    elif leaf.op == "count" or st.dtype == torch.int32:
        b = 4 * num_groups
    else:
        b = 8 * num_groups
    return (b + 7) // 8 * 8


def plan_shared(members: list, budget: int = SHARED_STATE_BYTES,
                hist_shared: bool = True) -> tuple[list, int]:
    """→ (per member: the byte offset of its accumulators, or None for
    global atomics; total accumulator bytes).  Members take shared memory in
    order while their states fit `budget`; with hist_shared False a
    member's sketches take global atomics and no shared memory."""
    offs, total = [], 0
    for m in members:
        need = sum(leaf_shared_bytes(leaf, m.num_groups, hist_shared) for leaf in m.leaves)
        if total + need <= budget:
            offs.append(total)
            total += need
        else:
            offs.append(None)
    return offs, total


def rows_per_thread(depth: int, outs: int, acc_bytes: int, smem: int = BLOCK_SMEM) -> int:
    """R, the rows a thread owns in a tile: the largest of 4, 2, 1 whose
    stack, slots and accumulators fit `smem` (1 beyond it; the launch
    opts in to the card's maximum and refuses more)."""
    for r in (4, 2):
        if (max(depth, 1) + outs) * r * BLOCK * 8 + acc_bytes <= smem:
            return r
    return 1


def _check_leaf(leaf: Leaf, m: Member, n: int, device) -> tuple[int, int]:
    """→ (LeafOp code, value kind); raises on what G1 does not take."""
    st = leaf.state
    code = LEAF_CODES.get((leaf.op, st.dtype))
    if code is None:
        raise TypeError(f"gang: no G1 update {leaf.op!r} into a {st.dtype} state")
    want = (m.num_groups, leaf.sketch.width) if leaf.op == "hist" else (m.num_groups,)
    if st.device != device or tuple(st.shape) != want or not st.is_contiguous():
        raise TypeError(f"gang: {leaf.op} state must be a contiguous {want} tensor on "
                        f"{device}, got {tuple(st.shape)} on {st.device}")
    if leaf.op == "count":
        return code, _chain.I64
    if isinstance(leaf.value, int):
        if not 0 <= leaf.value < len(m.prog.out_kinds):
            raise TypeError(f"gang: output slot {leaf.value} of a program with "
                            f"{len(m.prog.out_kinds)}")
        kind = m.prog.out_kinds[leaf.value]
    else:
        v = leaf.value
        kind = _KIND_OF.get(v.dtype) if isinstance(v, torch.Tensor) else None
        if kind is None:
            raise TypeError(f"gang: {leaf.op} value must be a feed column or an output slot")
        _chain._check_tensor(v, kind, f"{leaf.op} value", device, n)
    if st.dtype == torch.int32 and kind != _chain.I32:
        raise TypeError(f"gang: {leaf.op} into int32 from a value of kind {kind}")
    if st.dtype == torch.int64 and kind == _chain.F64:
        raise TypeError(f"gang: {leaf.op} into int64 from a float64 value")
    return code, kind


@dataclasses.dataclass
class Encoded:
    """The members and their leaves as the card reads them (csrc/gang.cuh
    GangMember[], then GangLeaf[] at `leaves_at`), with the pass's shape."""

    blob: bytes
    leaves_at: int
    n_members: int
    n_leaves: int
    depth: int
    outs: int
    acc_bytes: int
    rows_per_thread: int


def encode(members: list, n: int, device, state_budget: int = SHARED_STATE_BYTES,
           smem: int = BLOCK_SMEM, hist_shared: bool = True) -> Encoded:
    """Check and encode the members over a feed of n rows; each member's
    state takes a block's private accumulators while the states fit
    `state_budget` (with hist_shared False its sketches take global atomics
    whatever the budget), and R is chosen to fit `smem`."""
    _check_sizes()
    offs, acc_bytes = plan_shared(members, state_budget, hist_shared)
    depth = max(m.prog.depth for m in members)
    outs = max(len(m.prog.out_kinds) for m in members)
    r = rows_per_thread(depth, outs, acc_bytes, smem)
    c_members, c_leaves = [], []
    for m, off in zip(members, offs):
        p = _chain.pack_params(m.prog, m.cols, m.luts, m.scalars, n, device)
        c_members.append(_Member(chain=p, groups=m.num_groups, leaf0=len(c_leaves),
                                 nleaf=len(m.leaves)))
        for leaf in m.leaves:
            code, kind = _check_leaf(leaf, m, n, device)
            lf = _Leaf(state=leaf.state.data_ptr(), op=code, kind=kind, slot=-1,
                       groups=m.num_groups, width=1)
            if leaf.op != "count":
                if isinstance(leaf.value, int):
                    lf.slot = leaf.value
                else:
                    lf.col = leaf.value.data_ptr()
            if leaf.op == "hist":
                sk = leaf.sketch
                lf.width = sk.width
                lf.log_gamma = sk._log_gamma_f32()
                lf.min_f = float(np.float32(sk.min_value))
                lf.min_d = sk.min_value
            if off is None or not leaf_shared_bytes(leaf, m.num_groups, hist_shared):
                lf.shared_off = -1
            else:
                lf.shared_off = off
                off += leaf_shared_bytes(leaf, m.num_groups, hist_shared)
            c_leaves.append(lf)
    mem = bytes((_Member * len(c_members))(*c_members))
    return Encoded(mem + bytes((_Leaf * len(c_leaves))(*c_leaves)), len(mem), len(c_members),
                   len(c_leaves), depth, outs, acc_bytes, r)


def _launch_g1(members: list, n: int, device) -> None:
    if n <= 0 or not members:
        return  # (px_gang_partial launches nothing for an empty feed)
    enc = encode(members, n, device)
    # one upload per launch, in stream order; the pinned staging buffer is
    # not reused before the copy has run (torch's caching host allocator)
    dev_buf = torch.frombuffer(bytearray(enc.blob), dtype=torch.uint8).pin_memory().to(
        device, non_blocking=True)
    fn = _build.function(_G1, "px_gang_partial",
                         [_P, _I, _P, _I, ctypes.c_longlong, _I, _I, _I, _I, _P])
    base = dev_buf.data_ptr()
    with torch.cuda.device(device):
        err = fn(ctypes.c_void_p(base), enc.n_members, ctypes.c_void_p(base + enc.leaves_at),
                 enc.n_leaves, n, enc.depth, enc.outs, enc.acc_bytes, enc.rows_per_thread,
                 ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _build.check(_G1, err, "gang")
    _build.KERNELS[_G1].count("px_gang_partial")
