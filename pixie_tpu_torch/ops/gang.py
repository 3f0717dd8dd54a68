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
tensors it launches kernel G1 (csrc/gang.cu `px_gang_partial`): the
members' ChainParams (laid out as ops/chain.py lays them out for C1) and
the leaf table travel in the launch's parameter block, by value, so
nothing is uploaded.  What the gang's shape alone decides — each member's
fixed fields, the leaves' ops and shared-memory offsets, the split into
launches past one table's capacity (G1_CAPACITY: whole members a launch,
exact since members share no state), each launch's R and shared memory —
is encoded once per shape (`G1Plan`, cached); a call checks each tensor,
writes the pointers, LUT lengths, scalars and n into its thread's copy of
the encoding and makes one C call a launch.  On CPU tensors it runs the
plain version beside it: each member's program through the plain
interpreter, then each leaf through the plain form of the kernel the
per-sink route would launch (K1's segment count / sum / min / max, K2's
sketch update), so on the CPU the gang is bit for bit the per-sink route.
The choice follows the tensors' device only; a CUDA tensor never reaches
the plain version, and a missing nvcc or a failed build raises.

Leaf ops (`Leaf.op`): "count", "sum", "sumsq" (sum of the value's square
in float64), "min", "max" and "hist" (a LogHistogram sketch's cell count,
NaN in bin `Leaf.nan_bin`).  The state's dtype picks the typed update;
values convert to it as torch's `.to()` does.
"""
from __future__ import annotations

import ctypes
import dataclasses
import threading

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

#: G1: a block's private accumulators for the members whose states fit
#: (bytes), and the shared memory a block aims at, so that two or three
#: blocks share a SM
SHARED_STATE_BYTES = 48 * 1024
BLOCK_SMEM = 112 * 1024
#: the most dynamic shared memory a block may opt in to on the H100 (227 KB;
#: the card's own value is checked by the kernel, which refuses more)
SMEM_OPTIN = 232_448
#: threads per block (csrc/chain.cuh kBlock)
BLOCK = 256
#: the most members and leaves one G1 launch's table carries (csrc/gang.cu
#: kMaxMembers, kMaxLeaves); a larger gang splits into launches of whole
#: members
G1_CAPACITY = (16, 96)
#: F1: a member of at most this many groups in a 1024-thread layout folds a
#: warp's rows of one group before the shared atomic (csrc/gang.cuh,
#: Combine).  G1 never does: its four dashboard members ran 0.37 ms slower
#: with it on an H100 (PERF.md row 16).
COMBINE_GROUPS = 64


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
    #: "hist": the bin of a NaN value (ops/sketch.py: 1 for a batch query,
    #: 0 for a streaming poll)
    nan_bin: int = 1


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
                leaf.sketch.update_plain(st, gid, _value(leaf, outs), mask, g,
                                         nan_bin=leaf.nan_bin)
            else:
                raise Internal(f"gang: unknown leaf op {leaf.op!r}")


# ------------------------------------------------------------- G1 (CUDA)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class _Member(ctypes.Structure):
    """csrc/gang.cuh GangMember."""

    _fields_ = [("chain", _chain._Params), ("groups", _I), ("leaf0", _I), ("nleaf", _I),
                ("pad", _I)]


class _Leaf(ctypes.Structure):
    """csrc/gang.cuh GangLeaf."""

    _fields_ = [("state", _P), ("col", _P), ("min_d", ctypes.c_double), ("op", _I),
                ("kind", _I), ("slot", _I), ("groups", _I), ("shared_off", _I),
                ("width", _I), ("log_gamma", ctypes.c_float), ("min_f", ctypes.c_float),
                ("nan_bin", _I), ("pad", _I)]


MEMBER_BYTES = ctypes.sizeof(_Member)
LEAF_BYTES = ctypes.sizeof(_Leaf)
#: int64 word of each patched field within its struct
_W_COL = _chain._Params.col.offset // 8
_W_LUT = _chain._Params.lut.offset // 8
_W_LUT_LEN = _chain._Params.lut_len.offset // 8
_W_SCALAR = _chain._Params.scalar.offset // 8
_W_N = _chain._Params.n.offset // 8
_W_STATE = _Leaf.state.offset // 8
_W_VALUE = _Leaf.col.offset // 8

_sizes_checked = False


def check_sizes() -> None:
    """Hold the card's ChainParams, GangMember and GangLeaf sizes against
    the ctypes mirrors (once)."""
    global _sizes_checked
    if _sizes_checked:
        return
    _chain.check_params_size()
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


@dataclasses.dataclass(frozen=True)
class PassPlan:
    """How a block runs the member pass of one launch: its width, R, the
    stack depth and output slots, the private accumulators (each member's
    offset, or None for global atomics; their total bytes) and whether
    sketches are private."""

    block: int
    rows_per_thread: int
    depth: int
    outs: int
    offs: tuple
    acc_bytes: int
    hist_shared: bool
    #: F1: the warps fold their rows of one group before the shared atomic
    combine: bool = False

    @property
    def smem(self) -> int:
        """The block's dynamic shared memory (csrc/gang.cuh gang_smem_bytes)."""
        return ((max(self.depth, 1) + self.outs) * self.rows_per_thread * self.block * 8
                + self.acc_bytes)


def plan_pass(members: list) -> PassPlan:
    """G1's pass: the members' states private, in order, while they fit
    SHARED_STATE_BYTES; 256 threads of the most rows (4, 2, 1) whose
    stack, slots and private states fit BLOCK_SMEM (1 row otherwise; the
    launch opts in to the card's maximum and refuses more).  1024 threads
    of 2 rows ran the four dashboard members 0.07 ms slower on an H100
    (PERF.md row 16)."""
    depth = max(m.prog.depth for m in members)
    outs = max(len(m.prog.out_kinds) for m in members)
    offs, acc = plan_shared(members)
    r = next((r for r in (4, 2) if (max(depth, 1) + outs) * r * BLOCK * 8 + acc <= BLOCK_SMEM),
             1)
    return PassPlan(BLOCK, r, depth, outs, tuple(offs), acc, True)


def plan_f1_pass(member: Member) -> PassPlan:
    """F1's pass over one member (csrc/finalize.cu), the first layout that
    fits the 227 KB a block may opt in to beside the stack and slots: every leaf private at 1024 threads of 2 rows, then of 1 row;
    else the small leaves private and the sketches on global atomics at 256
    threads of 4 rows, then of 1 row (every leaf on global atomics if even
    that does not fit).  A 1024-thread layout combines a warp's rows of
    one group for a member of at most COMBINE_GROUPS groups."""
    depth, outs = member.prog.depth, len(member.prog.out_kinds)
    g = member.num_groups
    small = sum(leaf_shared_bytes(lf, g, False) for lf in member.leaves)
    whole = sum(leaf_shared_bytes(lf, g, True) for lf in member.leaves)

    def room(block, r):
        return SMEM_OPTIN - (max(depth, 1) + outs) * r * block * 8

    for block, r, hist_shared, need in ((1024, 2, True, whole), (1024, 1, True, whole),
                                        (BLOCK, 4, False, small), (BLOCK, 1, False, small)):
        if need <= room(block, r):
            offs, acc = plan_shared([member], room(block, r), hist_shared)
            return PassPlan(block, r, depth, outs, tuple(offs), acc, hist_shared,
                            block == 1024 and g <= COMBINE_GROUPS)
    return PassPlan(BLOCK, 1, depth, outs, (None,), 0, False)


def _check_leaf(leaf: Leaf, m: Member, device) -> tuple[int, int]:
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
    if st.dtype == torch.int32 and kind != _chain.I32:
        raise TypeError(f"gang: {leaf.op} into int32 from a value of kind {kind}")
    if st.dtype == torch.int64 and kind == _chain.F64:
        raise TypeError(f"gang: {leaf.op} into int64 from a float64 value")
    return code, kind


def _value_sig(leaf: Leaf):
    v = leaf.value
    return v if v is None or isinstance(v, int) else v.dtype


def gang_key(members: list, device: torch.device) -> tuple:
    """A gang's shape: what G1Plan encodes once (programs, group counts,
    input counts, each leaf's op, state dtype, value slot or dtype, sketch
    and NaN bin), on one device.  The states' shapes follow from the group
    counts and sketches; each call checks them (MemberCodec.values)."""
    return (device.index, tuple(
        (id(m.prog), m.num_groups, len(m.cols), len(m.luts), len(m.scalars),
         tuple((lf.op, lf.state.dtype, _value_sig(lf), lf.sketch, lf.nan_bin)
               for lf in m.leaves))
        for m in members))


@dataclasses.dataclass(frozen=True, eq=False)
class MemberCodec:
    """Members and their leaves as a launch's table reads them (csrc/gang.cuh
    GangMember[], then GangLeaf[]), encoded once: `template` holds every
    field a shape fixes (the program's device code and constants, kinds,
    groups, leaf ops and offsets), and `patch` the int64 words a call fills,
    in the order `values` produces them: per member its column pointers, LUT
    pointers, LUT lengths, scalars and n, then per leaf its state pointer
    and, for a feed-column value, the column's pointer."""

    template: np.ndarray
    patch: np.ndarray
    n_members: int
    n_leaves: int
    #: per member: its column kinds' dtypes, its LUT kinds' dtypes; per leaf
    #: of all members in order: its state's shape, the value column's dtype
    #: or None
    col_dtypes: tuple
    lut_dtypes: tuple
    state_shapes: tuple
    value_dtypes: tuple
    #: the members' programs, held so that gang_key's ids stay theirs
    progs: tuple

    @classmethod
    def of(cls, members: list, plan: PassPlan, device) -> "MemberCodec":
        c_members, c_leaves, patch = [], [], []
        for mi, (m, off) in enumerate(zip(members, plan.offs)):
            p = _chain.fixed_params(m.prog, device)
            c_members.append(_Member(chain=p, groups=m.num_groups, leaf0=len(c_leaves),
                                     nleaf=len(m.leaves)))
            w = mi * MEMBER_BYTES // 8
            patch.extend(w + _W_COL + i for i in range(len(m.prog.col_kinds)))
            patch.extend(w + _W_LUT + i for i in range(len(m.prog.lut_kinds)))
            patch.extend(w + _W_LUT_LEN + i for i in range(len(m.prog.lut_kinds)))
            patch.extend(w + _W_SCALAR + i for i in range(m.prog.n_scalars))
            patch.append(w + _W_N)
            for leaf in m.leaves:
                code, kind = _check_leaf(leaf, m, device)
                lf = _Leaf(op=code, kind=kind, slot=-1, groups=m.num_groups, width=1,
                           nan_bin=int(leaf.nan_bin))
                lw = (len(members) * MEMBER_BYTES + len(c_leaves) * LEAF_BYTES) // 8
                patch.append(lw + _W_STATE)
                if leaf.op != "count":
                    if isinstance(leaf.value, int):
                        lf.slot = leaf.value
                    else:
                        patch.append(lw + _W_VALUE)
                if leaf.op == "hist":
                    sk = leaf.sketch
                    lf.width = sk.width
                    lf.log_gamma = sk._log_gamma_f32()
                    lf.min_f = float(np.float32(sk.min_value))
                    lf.min_d = sk.min_value
                need = leaf_shared_bytes(leaf, m.num_groups, plan.hist_shared)
                if off is None or not need:
                    lf.shared_off = -1
                else:
                    lf.shared_off = off
                    off += need
                c_leaves.append(lf)
        raw = bytes((_Member * len(c_members))(*c_members)) + \
            bytes((_Leaf * len(c_leaves))(*c_leaves))
        template = np.frombuffer(raw, dtype=np.uint8).copy()
        dt = _chain.DTYPE
        return cls(template, np.asarray(patch, dtype=np.int64), len(c_members), len(c_leaves),
                   tuple(tuple(dt[k] for k in m.prog.col_kinds) for m in members),
                   tuple(tuple(dt[k] for k in m.prog.lut_kinds) for m in members),
                   tuple(lf.state.shape for m in members for lf in m.leaves),
                   tuple(None if lf.op == "count" or isinstance(lf.value, int)
                         else lf.value.dtype for m in members for lf in m.leaves),
                   tuple(m.prog for m in members))

    def values(self, members: list, n: int, device: int) -> list:
        """The patched words of one call, each tensor checked once (a column
        several members read, once): a feed column a contiguous [n] tensor
        of its kind, a LUT a contiguous 1-D one, a state contiguous and of
        its shape (its dtype is in the shape key), all on device `device`."""
        out = []
        seen = set()
        rows = (n,)
        shapes = iter(self.state_shapes)
        vdt = iter(self.value_dtypes)
        for m, cdt, ldt in zip(members, self.col_dtypes, self.lut_dtypes):
            if len(m.cols) != len(cdt) or len(m.luts) != len(ldt):
                raise TypeError("gang: a program bound to the wrong number of inputs")
            for c, dt in zip(m.cols, cdt):
                if id(c) not in seen:
                    if (c.dtype, c.shape, c.is_contiguous(), c.get_device()) != (
                            dt, rows, True, device):
                        raise TypeError(f"gang: a column must be a contiguous [{n}] {dt} "
                                        f"tensor on cuda:{device}, got {c.dtype} "
                                        f"{tuple(c.shape)} on {c.device}")
                    seen.add(id(c))
                out.append(c.data_ptr())
            for t, dt in zip(m.luts, ldt):
                if (t.dtype, t.dim(), t.is_contiguous(), t.get_device()) != (dt, 1, True,
                                                                             device):
                    raise TypeError(f"gang: a LUT must be a contiguous 1-D {dt} tensor on "
                                    f"cuda:{device}")
                out.append(t.data_ptr())
            out.extend(t.shape[0] for t in m.luts)
            out.extend(int(s) for s in m.scalars)
            out.append(n)
            for leaf in m.leaves:
                st = leaf.state
                if (st.shape, st.is_contiguous(), st.get_device()) != (next(shapes), True,
                                                                       device):
                    raise TypeError(f"gang: a {leaf.op} state must be contiguous, of its "
                                    f"plan's shape, on cuda:{device}")
                out.append(st.data_ptr())
                dt = next(vdt)
                if dt is not None:
                    v = leaf.value
                    if id(v) not in seen:
                        if (v.dtype, v.shape, v.is_contiguous(), v.get_device()) != (
                                dt, rows, True, device):
                            raise TypeError(f"gang: a {leaf.op} value must be a contiguous "
                                            f"[{n}] {dt} tensor on cuda:{device}")
                        seen.add(id(v))
                    out.append(v.data_ptr())
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class G1Plan:
    """What one gang shape launches, decided once: per launch (at most
    G1_CAPACITY members and leaves, whole members, in order) its members'
    range, its pass plan and its encoding; `rows` gives a call's tables."""

    launches: tuple  # ((first member, end member, PassPlan, MemberCodec), ...)
    local: threading.local = dataclasses.field(default_factory=threading.local, repr=False)

    @classmethod
    def of(cls, members: list, device) -> "G1Plan":
        cap_m, cap_l = G1_CAPACITY
        groups, cur, leaves = [], [], 0
        for i, m in enumerate(members):
            if len(m.leaves) > cap_l:
                raise ValueError(f"gang: a member of {len(m.leaves)} leaves, one launch "
                                 f"carries at most {cap_l}")
            if cur and (len(cur) == cap_m or leaves + len(m.leaves) > cap_l):
                groups.append(cur)
                cur, leaves = [], 0
            cur.append(i)
            leaves += len(m.leaves)
        groups.append(cur)
        launches = []
        for idx in groups:
            part = [members[i] for i in idx]
            plan = plan_pass(part)
            launches.append((idx[0], idx[-1] + 1, plan, MemberCodec.of(part, plan, device)))
        return cls(tuple(launches))

    def rows(self, members: list, n: int, device: int) -> list:
        """The calling thread's tables for this call, one per launch (its
        own buffers, rewritten by its next call)."""
        bufs = getattr(self.local, "bufs", None)
        if bufs is None:
            bufs = self.local.bufs = [codec.template.copy() for *_x, codec in self.launches]
        for buf, (a, b, _plan, codec) in zip(bufs, self.launches):
            buf.view(np.int64)[codec.patch] = codec.values(members[a:b], n, device)
        return bufs


_PLANS: dict = {}
_PLANS_LOCK = threading.Lock()


def plan_for(members: list, device: torch.device) -> G1Plan:
    """The cached G1Plan of the members' shape on `device`."""
    key = gang_key(members, device)
    plan = _PLANS.get(key)
    if plan is None:
        check_sizes()
        plan = G1Plan.of(members, device)
        with _PLANS_LOCK:
            if len(_PLANS) > 256:
                _PLANS.clear()
            plan = _PLANS.setdefault(key, plan)
    return plan


def _launch_g1(members: list, n: int, device) -> None:
    if n <= 0 or not members:
        return  # (px_gang_partial launches nothing for an empty feed)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    plan = plan_for(members, device)
    bufs = plan.rows(members, n, device.index)
    fn = _build.function(_G1, "px_gang_partial",
                         [_P, _I, _I, _L, _I, _I, _I, _I, _I, _I, _P])
    stream = _build.raw_stream(device.index)
    for buf, (_a, _b, pp, codec) in zip(bufs, plan.launches):
        err = fn(buf.ctypes.data, codec.n_members, codec.n_leaves, n, pp.depth, pp.outs,
                 pp.acc_bytes, pp.rows_per_thread, pp.block, device.index, stream)
        _build.check(_G1, err, "gang")
        _build.KERNELS[_G1].count("px_gang_partial")
