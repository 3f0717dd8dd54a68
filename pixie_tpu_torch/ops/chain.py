"""C1: a chain's row mask, group ids and computed columns as one program.

Replaces the reference's ChainKernel fragment (pixie_tpu/engine/executor.py
`_base_mask`, `_apply_steps`'s filters and the key and value builders of
`make_agg_step` / `make_output_step` / `make_partial_agg_step`, :566-765),
`combine_codes` / `encode_against` (pixie_tpu/ops/groupby.py:21, :73) and
`apply_lut` (pixie_tpu/engine/eval.py:57), which XLA fused into the program
of the UDA updates.

A chain lowers (engine/eval.py emitters, engine/executor.py ChainKernel) to
a small postfix program over a stack of per-row values: opcodes with two
int32 arguments, a pool of int64 constants, and the kinds of the columns,
LUTs and outputs it names.  `intern` keeps one Program per chain shape;
runtime scalars (the valid-row count, the time bounds, window origins) are
not part of it, so a new feed, poll or window origin reuses the program.

`run` executes a program over one feed.  On CUDA tensors it launches kernel
C1 (csrc/chain.cu `px_chain_run`): the program is uploaded once per shape
and device, and the feed's column, LUT and output pointers and its scalars
travel in the launch's parameter struct.  On CPU tensors it runs the plain
PyTorch interpreter beside it, one torch op per opcode over whole columns
(each op the expression the reference's closures compute).  The choice
follows the tensors' device only; a CUDA tensor never reaches the plain
interpreter, and a missing nvcc or a failed build raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import struct
import threading
from typing import Callable, Optional

import numpy as np
import torch

from pixie_tpu_torch.ops import _build
from pixie_tpu_torch.status import Internal
from pixie_tpu_torch.types import STORAGE_DTYPE

_C1 = "chain"

#: opcodes, in csrc/chain.cu's order
OPS = (
    "LOAD_COL", "LOAD_CONST", "LOAD_SCALAR", "LOAD_ROW", "DUP", "STORE", "MASK_AND",
    "GID_COMBINE", "LUT", "LUT_DOMAIN", "PAIR", "SEARCH", "WINDOW", "CAST_I2F", "CAST_F2I",
    "CAST_I64", "NOT", "AND", "OR",
    "ADD_I", "SUB_I", "MUL_I", "ADD_F", "SUB_F", "MUL_F", "DIV_F", "MOD_I", "MOD_F",
    "FDIV_I", "FDIV_F", "POW_F", "ABS_I", "ABS_F", "NEG_I", "NEG_F", "LOG", "LOG2",
    "LOG10", "EXP", "SQRT", "CEIL", "FLOOR", "RINT", "BIN_I",
    "EQ_I", "NE_I", "LT_I", "LE_I", "GT_I", "GE_I", "EQ_F", "NE_F", "LT_F", "LE_F",
    "GT_F", "GE_F", "SELECT", "APPROX_EQ",
)
OP = {name: i for i, name in enumerate(OPS)}

#: value kinds (csrc/chain.cu Kind)
B, I32, I64, F64 = 0, 1, 2, 3
DTYPE = {B: torch.bool, I32: torch.int32, I64: torch.int64, F64: torch.float64}
_NP_KIND = {np.dtype(np.bool_): B, np.dtype(np.int32): I32, np.dtype(np.int64): I64,
            np.dtype(np.float64): F64}

#: limits of one launch (csrc/chain.cu kMax*)
MAX_COLS, MAX_LUTS, MAX_OUTS, MAX_SCALARS = 32, 32, 16, 16

_UNARY = {"CAST_I2F", "CAST_F2I", "CAST_I64", "NOT", "ABS_I", "ABS_F", "NEG_I", "NEG_F",
          "LOG", "LOG2", "LOG10", "EXP", "SQRT", "CEIL", "FLOOR", "RINT", "LUT",
          "LUT_DOMAIN", "SEARCH", "WINDOW"}
_CMP = {"EQ_I", "NE_I", "LT_I", "LE_I", "GT_I", "GE_I", "EQ_F", "NE_F", "LT_F",
        "LE_F", "GT_F", "GE_F", "APPROX_EQ", "AND", "OR"}
_BINARY_I = {"ADD_I", "SUB_I", "MUL_I", "MOD_I", "FDIV_I", "BIN_I"}
_BINARY_F = {"ADD_F", "SUB_F", "MUL_F", "DIV_F", "MOD_F", "FDIV_F", "POW_F"}
#: stack effect of each opcode
_DELTA = {**{o: 0 for o in _UNARY}, **{o: -1 for o in _CMP | _BINARY_I | _BINARY_F},
          "LOAD_COL": 1, "LOAD_CONST": 1, "LOAD_SCALAR": 1, "LOAD_ROW": 1, "DUP": 1,
          "STORE": -1, "MASK_AND": -1, "GID_COMBINE": -1, "PAIR": -1, "SELECT": -2}
#: operands each opcode pops (DUP reads the top and pops nothing)
_POPS = {**{o: 1 for o in _UNARY}, **{o: 2 for o in _CMP | _BINARY_I | _BINARY_F},
         "LOAD_COL": 0, "LOAD_CONST": 0, "LOAD_SCALAR": 0, "LOAD_ROW": 0, "DUP": 0,
         "STORE": 1, "MASK_AND": 1, "GID_COMBINE": 1, "PAIR": 2, "SELECT": 3}
_RESULT = {**{o: B for o in _CMP | {"NOT"}}, **{o: I64 for o in _BINARY_I},
           **{o: F64 for o in _BINARY_F}, "CAST_I2F": F64, "CAST_F2I": I64,
           "CAST_I64": I64, "ABS_I": I64, "NEG_I": I64, "PAIR": I32, "SEARCH": I32,
           "WINDOW": I32, **{o: F64 for o in ("ABS_F", "NEG_F", "LOG", "LOG2", "LOG10",
                                              "EXP", "SQRT", "CEIL", "FLOOR", "RINT")}}


class CannotLower(Exception):
    """A value the program cannot express; its SVal enters C1 as a leaf."""


def kind_of_np(dtype) -> int:
    k = _NP_KIND.get(np.dtype(dtype))
    if k is None:
        raise CannotLower(f"no chain kind for {np.dtype(dtype)}")
    return k


def _bits(value, kind: int) -> int:
    """A constant's 8-byte slot (int64 bit pattern; int32 values sign-extended,
    as the kernel loads them)."""
    if kind == F64:
        return struct.unpack("<q", struct.pack("<d", float(value)))[0]
    if kind == B:
        return int(bool(value))
    if kind == I32:
        return ((int(value) & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000
    return ((int(value) & 0xFFFFFFFFFFFFFFFF) ^ (1 << 63)) - (1 << 63)


def _unbits(bits: int, kind: int):
    if kind == F64:
        return struct.unpack("<d", struct.pack("<q", bits))[0]
    if kind == B:
        return bool(bits)
    return bits


@dataclasses.dataclass(frozen=True)
class Program:
    """One chain shape: instructions, constants and the kinds it binds."""

    code: tuple  # (op, a, b) triples
    consts: tuple  # (bits, kind) pairs
    col_kinds: tuple
    lut_kinds: tuple
    out_kinds: tuple
    n_scalars: int
    depth: int
    #: the program writes the row mask / the group ids
    has_mask: bool
    has_gid: bool

    def listing(self) -> list[str]:
        return [f"{OPS[op]} {a} {b}" for op, a, b in self.code]


@dataclasses.dataclass
class Binding:
    """What a program's slots mean for one chain: column, LUT and scalar
    names, and the leaves (name → closure computing the column)."""

    cols: list
    luts: list
    scalars: list
    leaves: dict


class ProgramBuilder:
    """Emits one program.  Emitters push values in postfix order; the
    builder tracks the kind of every stack entry and the deepest stack."""

    def __init__(self):
        self.code: list = []
        self.consts: list = []
        self.cols: dict[str, int] = {}
        self.col_kinds: list = []
        self.luts: dict[str, int] = {}
        self.lut_kinds: list = []
        self.scalars: dict[str, int] = {}
        self.out_kinds: list = []
        self.leaves: dict[str, Callable] = {}
        self.kinds: list = []
        self.depth = 0

    # ------------------------------------------------------------ stack
    def _emit(self, op: str, a: int = 0, b: int = 0, kind: Optional[int] = None) -> None:
        pops = _POPS[op]
        if len(self.kinds) < max(pops, op == "DUP"):
            raise Internal(f"chain program: {op} needs {pops} operands")
        args = self.kinds[len(self.kinds) - pops:]
        del self.kinds[len(self.kinds) - pops:]
        if op == "DUP":
            kind = self.kinds[-1]
        elif op == "SELECT":
            kind = args[1]
        elif kind is None:
            kind = _RESULT.get(op)
        if _DELTA[op] + pops > 0:
            self.kinds.append(kind)
        self.code.append((OP[op], int(a), int(b)))
        self.depth = max(self.depth, len(self.kinds))

    @property
    def top(self) -> int:
        return self.kinds[-1]

    def _const_index(self, value, kind: int) -> int:
        self.consts.append((_bits(value, kind), kind))
        return len(self.consts) - 1

    # ------------------------------------------------------------ loads
    def col(self, name: str, kind: int) -> None:
        idx = self.cols.get(name)
        if idx is None:
            idx = self.cols[name] = len(self.cols)
            self.col_kinds.append(kind)
        elif self.col_kinds[idx] != kind:
            raise Internal(f"column {name!r} bound with two kinds")
        self._emit("LOAD_COL", idx, kind=kind)

    def leaf(self, build: Callable, kind: int) -> None:
        """A value the program cannot compute: its closure runs in torch and
        the column enters the launch as an input."""
        name = f"__leaf{len(self.leaves)}"
        self.leaves[name] = build
        self.col(name, kind)

    def const(self, value, kind: int) -> None:
        self._emit("LOAD_CONST", self._const_index(value, kind), kind=kind)

    def scalar(self, name: str) -> None:
        idx = self.scalars.setdefault(name, len(self.scalars))
        self._emit("LOAD_SCALAR", idx, kind=I64)

    def row(self) -> None:
        self._emit("LOAD_ROW", kind=I64)

    def _lut_index(self, name: str, kind: int) -> int:
        idx = self.luts.get(name)
        if idx is None:
            idx = self.luts[name] = len(self.luts)
            self.lut_kinds.append(kind)
        return idx

    # ------------------------------------------------------------ ops
    def op(self, name: str) -> None:
        self._emit(name)

    def dup(self) -> None:
        self._emit("DUP")

    def cast_to(self, kind: int) -> None:
        """Convert the top value to `kind` as torch's .to() would."""
        k = self.top
        if k == kind:
            return
        if kind == F64:
            self._emit("CAST_I2F")
        elif kind == I64:
            self._emit("CAST_F2I" if k == F64 else "CAST_I64")
        else:
            raise CannotLower(f"no cast to kind {kind}")

    def lut(self, name: str, kind: int, fill) -> None:
        """apply_lut: top = lut[code], the fill for a code < 0."""
        self._emit("LUT", self._lut_index(name, kind), self._const_index(fill, kind), kind=kind)

    def lut_domain(self, name: str, kind: int, lo: int, hi: int, oob) -> None:
        """top = lut[x - lo] for x in [lo, hi], else oob."""
        c = self._const_index(lo, I64)
        self._const_index(hi, I64)
        self._const_index(oob, kind)
        self._emit("LUT_DOMAIN", self._lut_index(name, kind), c, kind=kind)

    def pair(self, nb: int) -> None:
        self._emit("PAIR", nb)

    def search(self, name: str) -> None:
        self._emit("SEARCH", self._lut_index(name, I64))

    def window(self, width: int, origin: str) -> None:
        idx = self.scalars.setdefault(origin, len(self.scalars))
        self._emit("WINDOW", self._const_index(width, I64), idx)

    def store(self) -> int:
        """Pop the top into a new output column; → its index."""
        self.out_kinds.append(self.top)
        self._emit("STORE", len(self.out_kinds) - 1)
        return len(self.out_kinds) - 1

    def mask_and(self) -> None:
        self._emit("MASK_AND")

    def combine(self, card: int) -> None:
        self._emit("GID_COMBINE", card)

    def finish(self, has_mask: bool = True, has_gid: bool = False):
        """→ (the interned Program, its Binding)."""
        if self.kinds:
            raise Internal(f"chain program left {len(self.kinds)} values on its stack")
        if (len(self.cols) > MAX_COLS or len(self.luts) > MAX_LUTS
                or len(self.out_kinds) > MAX_OUTS or len(self.scalars) > MAX_SCALARS):
            raise Internal("chain program binds more columns, LUTs, outputs or scalars "
                           "than one C1 launch takes")
        prog = Program(tuple(self.code), tuple(self.consts), tuple(self.col_kinds),
                       tuple(self.lut_kinds), tuple(self.out_kinds), len(self.scalars),
                       max(self.depth, 1), has_mask, has_gid)
        return intern(prog), Binding(list(self.cols), list(self.luts), list(self.scalars),
                                     dict(self.leaves))


def emit_value(b: ProgramBuilder, sv) -> None:
    """Push an SVal: its program fragment, or its closure as a leaf."""
    if sv.emit is not None:
        try:
            mark = (len(b.code), len(b.kinds))
            sv.emit(b)
            return
        except CannotLower:
            del b.code[mark[0]:]
            del b.kinds[mark[1]:]
    b.leaf(sv.build, value_kind(sv.dtype))


def value_kind(dt) -> int:
    """The kind of a DataType's device values (types.STORAGE_DTYPE)."""
    return kind_of_np(STORAGE_DTYPE[dt])


# -------------------------------------------------- the `_dev` UDF opcodes

_ARITH = {"add": "ADD", "subtract": "SUB", "multiply": "MUL", "modulo": "MOD",
          "floordiv": "FDIV"}
_CMPS = {"eq": "EQ", "ne": "NE", "lt": "LT", "le": "LE", "gt": "GT", "ge": "GE"}
_FLOAT_FNS = {"log": "LOG", "log2": "LOG2", "log10": "LOG10", "exp": "EXP", "sqrt": "SQRT"}
_ROUNDING = {"ceil": "CEIL", "floor": "FLOOR", "round": "RINT"}
#: every opcode a `_dev` registration may name (udf/builtins.py)
DEV_OPS = frozenset({*_ARITH, *_CMPS, *_FLOAT_FNS, *_ROUNDING, "divide", "pow", "abs",
                     "negate", "invert", "bin", "and", "or", "not", "select",
                     "approx_eq", "identity"})


def lower_call(b: ProgramBuilder, op: str, kinds: list, emits: list) -> None:
    """Push op(args) for a `_dev` registration, with torch's promotions
    written out as casts.  kinds[i] is arg i's kind; emits[i](b) pushes it."""
    if any(k == I32 for k in kinds) and op not in ("eq", "ne", "select", "identity"):
        raise CannotLower(f"{op} over int32 codes")

    def args(target=None):
        for e in emits:
            e(b)
            if target is not None:
                b.cast_to(target)

    if op in _ARITH:
        t = F64 if F64 in kinds else I64
        args(t)
        b.op(_ARITH[op] + ("_F" if t == F64 else "_I"))
    elif op in ("divide", "pow"):
        args(F64)
        b.op("DIV_F" if op == "divide" else "POW_F")
    elif op in ("abs", "negate"):
        args()
        b.op(("ABS" if op == "abs" else "NEG") + ("_F" if kinds[0] == F64 else "_I"))
    elif op in _FLOAT_FNS:
        args(F64)
        b.op(_FLOAT_FNS[op])
    elif op in _ROUNDING:
        args()
        if kinds[0] == F64:
            b.op(_ROUNDING[op])
    elif op == "invert":
        b.const(1.0, F64)
        args(F64)
        b.op("DIV_F")
    elif op == "bin":
        args(I64)
        b.op("BIN_I")
    elif op in _CMPS:
        if F64 in kinds:
            args(F64)
            b.op(_CMPS[op] + "_F")
        else:
            args()
            b.op(_CMPS[op] + "_I")
    elif op == "approx_eq":
        args(F64)
        b.op("APPROX_EQ")
    elif op in ("and", "or"):
        args()
        b.op(op.upper())
    elif op == "not":
        args()
        b.op("NOT")
    elif op == "select":
        if kinds[1] != kinds[2]:
            raise CannotLower("select over two kinds")
        args()
        b.op("SELECT")
    elif op == "identity":
        args()
    else:
        raise CannotLower(f"unknown opcode {op!r}")


def op_program(op: str, kinds: list, consts: Optional[list] = None):
    """The program of one `_dev` opcode over columns a0, a1, ... of `kinds`
    (consts[i], where given and not None, replaces column i by a constant),
    storing its result: → (Program, Binding).  The opcode checks of the
    tests and of chip_smoke.py use it."""
    b = ProgramBuilder()
    emits = []
    for i, k in enumerate(kinds):
        c = None if consts is None else consts[i]
        if c is None:
            emits.append(lambda pb, i=i, k=k: pb.col(f"a{i}", k))
        else:
            emits.append(lambda pb, c=c, k=k: pb.const(c, k))
    lower_call(b, op, list(kinds), emits)
    b.store()
    return b.finish(has_mask=False)


# ------------------------------------------------------------ the programs

_lock = threading.Lock()
_programs: dict[Program, Program] = {}
_device_programs: dict[tuple, tuple] = {}
#: distinct programs lowered in this process (one per chain shape)
stats = {"programs": 0}


def intern(prog: Program) -> Program:
    with _lock:
        got = _programs.get(prog)
        if got is None:
            got = _programs[prog] = prog
            stats["programs"] += 1
        return got


def _device_program(prog: Program, device: torch.device):
    """The program's code and constants on `device`, uploaded once."""
    key = (prog, str(device))
    with _lock:
        got = _device_programs.get(key)
    if got is None:
        code = torch.tensor(np.asarray(prog.code, dtype=np.int32).reshape(-1), device=device)
        consts = torch.tensor(np.asarray([c for c, _k in prog.consts] or [0], dtype=np.int64),
                              device=device)
        with _lock:
            got = _device_programs.setdefault(key, (code, consts))
    return got


# ------------------------------------------------------ the plain interpreter


def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.expand(n).contiguous() if t.dim() == 0 else t


def apply_lut(lut: torch.Tensor, codes: torch.Tensor, fill):
    """Safe LUT gather: codes may be -1 (null / no-translation) → fill.
    An EMPTY lut (no dictionary values yet — empty table) yields all-fill."""
    if lut.shape[0] == 0:
        return torch.full(codes.shape, fill, dtype=lut.dtype, device=codes.device)
    safe = torch.clamp(codes, 0, lut.shape[0] - 1).long()
    return torch.where(codes >= 0, lut[safe], fill)


def remainder(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Python's (and torch's) floor modulo, x % y, for a nonzero divisor.
    Floats take fmod and then the divisor's sign, as torch's remainder does;
    torch's vectorized CPU fmod returns NaN where x / y overflows the double
    range, so those rows take numpy's exact fmod (the card's is exact)."""
    if not (x.dtype.is_floating_point or y.dtype.is_floating_point):
        return x % y
    m = torch.fmod(x, y)
    if m.device.type == "cpu":
        bad = torch.isnan(m) & torch.isfinite(x) & torch.isfinite(y)
        if bool(bad.any()):
            xs, ys = np.broadcast_arrays(x.numpy(), y.numpy())
            with np.errstate(invalid="ignore"):
                m = torch.from_numpy(np.fmod(xs, ys)).to(m.dtype)
    return torch.where((m != 0) & ((y < 0) != (m < 0)), m + y, m)


_PLAIN_BINARY = {
    "ADD_I": lambda x, y: x + y, "SUB_I": lambda x, y: x - y, "MUL_I": lambda x, y: x * y,
    "ADD_F": lambda x, y: x + y, "SUB_F": lambda x, y: x - y, "MUL_F": lambda x, y: x * y,
    "DIV_F": lambda x, y: x / y,
    "MOD_I": lambda x, y: torch.where(y != 0, remainder(x, torch.where(y == 0, 1, y)), 0),
    "MOD_F": lambda x, y: torch.where(y != 0, remainder(x, torch.where(y == 0, 1, y)), 0),
    "FDIV_I": lambda x, y: torch.where(y != 0, x // torch.where(y == 0, 1, y), 0),
    "FDIV_F": lambda x, y: torch.where(y != 0, x // torch.where(y == 0, 1., y), 0.),
    "POW_F": torch.pow,
    "BIN_I": lambda t, s: t - t % torch.where(s == 0, 1, s),
    "EQ_I": torch.eq, "NE_I": torch.ne, "LT_I": torch.lt, "LE_I": torch.le,
    "GT_I": torch.gt, "GE_I": torch.ge, "EQ_F": torch.eq, "NE_F": torch.ne,
    "LT_F": torch.lt, "LE_F": torch.le, "GT_F": torch.gt, "GE_F": torch.ge,
    "AND": torch.logical_and, "OR": torch.logical_or,
    "APPROX_EQ": lambda x, y: torch.abs(x - y) < 1e-9,
}
_PLAIN_UNARY = {
    "CAST_I2F": lambda x: x.to(torch.float64), "CAST_F2I": lambda x: x.to(torch.int64),
    "CAST_I64": lambda x: x.to(torch.int64), "NOT": torch.logical_not,
    "ABS_I": torch.abs, "ABS_F": torch.abs, "NEG_I": torch.neg, "NEG_F": torch.neg,
    "LOG": torch.log, "LOG2": torch.log2, "LOG10": torch.log10, "EXP": torch.exp,
    "SQRT": torch.sqrt, "CEIL": torch.ceil, "FLOOR": torch.floor, "RINT": torch.round,
}


def run_plain(prog: Program, cols: list, luts: list, scalars: list, n: int,
              device) -> tuple:
    """The plain PyTorch interpreter: one torch op per opcode over whole
    columns.  → (mask | None, gid | None, [output columns])."""
    device = torch.device(device)
    st: list = []
    mask = torch.ones(n, dtype=torch.bool, device=device)
    gid = torch.zeros(n, dtype=torch.int32, device=device)
    outs: list = [None] * len(prog.out_kinds)
    for op_i, a, b in prog.code:
        op = OPS[op_i]
        if op == "LOAD_COL":
            st.append(cols[a])
        elif op == "LOAD_CONST":
            bits, kind = prog.consts[a]
            st.append(torch.tensor(_unbits(bits, kind), dtype=DTYPE[kind], device=device))
        elif op == "LOAD_SCALAR":
            st.append(torch.tensor(int(scalars[a]), dtype=torch.int64, device=device))
        elif op == "LOAD_ROW":
            st.append(torch.arange(n, device=device))
        elif op == "DUP":
            st.append(st[-1])
        elif op == "STORE":
            outs[a] = _rows(st.pop(), n).to(DTYPE[prog.out_kinds[a]]).contiguous()
        elif op == "MASK_AND":
            mask = mask & st.pop()
        elif op == "GID_COMBINE":
            gid = gid * a + torch.clamp(st.pop().to(torch.int32), 0, a - 1)
        elif op == "LUT":
            bits, kind = prog.consts[b]
            st.append(apply_lut(luts[a], st.pop(), _unbits(bits, kind)))
        elif op == "LUT_DOMAIN":
            lo, hi = prog.consts[b][0], prog.consts[b + 1][0]
            oob = _unbits(*prog.consts[b + 2])
            x = st.pop()
            in_dom = (x >= lo) & (x <= hi)
            idx = torch.clamp(x - lo, 0, hi - lo).long()
            st.append(torch.where(in_dom, luts[a][idx], oob))
        elif op == "PAIR":
            cb, ca = st.pop(), st.pop()
            st.append(torch.where((ca >= 0) & (cb >= 0),
                                  ca.to(torch.int32) * a + cb.to(torch.int32), -1))
        elif op == "SEARCH":
            lut = luts[a]
            st.append(torch.searchsorted(lut, _rows(st.pop(), n).to(lut.dtype),
                                         out_int32=True))
        elif op == "WINDOW":
            w = prog.consts[a][0]
            st.append((torch.div(st.pop(), w, rounding_mode="floor")
                       - int(scalars[b])).to(torch.int32))
        elif op == "SELECT":
            y, x, c = st.pop(), st.pop(), st.pop()
            st.append(torch.where(c, x, y))
        elif op in _PLAIN_UNARY:
            st.append(_PLAIN_UNARY[op](st.pop()))
        else:
            y, x = st.pop(), st.pop()
            st.append(_PLAIN_BINARY[op](x, y))
    return (mask if prog.has_mask else None, gid if prog.has_gid else None, outs)


# ------------------------------------------------------------- C1 (CUDA)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class _Params(ctypes.Structure):
    """csrc/chain.cu ChainParams."""

    _fields_ = [("code", _P), ("consts", _P), ("col", _P * MAX_COLS),
                ("lut", _P * MAX_LUTS), ("lut_len", _L * MAX_LUTS), ("out", _P * MAX_OUTS),
                ("scalar", _L * MAX_SCALARS), ("mask_out", _P), ("gid_out", _P), ("n", _L),
                ("ncode", _I), ("depth", _I), ("col_kind", _I * MAX_COLS),
                ("lut_kind", _I * MAX_LUTS), ("out_kind", _I * MAX_OUTS)]


_size_checked = False


def _check_tensor(t: torch.Tensor, kind: int, what: str, device, n=None) -> None:
    if t.device != device:
        raise ValueError(f"{what} on {t.device}, the feed on {device}")
    if t.dtype != DTYPE[kind] or t.dim() != 1 or not t.is_contiguous():
        raise TypeError(f"{what}: want a contiguous 1-D {DTYPE[kind]} tensor, got "
                        f"{t.dtype} of shape {tuple(t.shape)}")
    if n is not None and t.shape[0] != n:
        raise TypeError(f"{what}: {t.shape[0]} rows, the feed has {n}")


def check_params_size() -> None:
    """Hold the card's ChainParams size against the ctypes mirror (once)."""
    global _size_checked
    if not _size_checked:
        size = _build.function(_C1, "px_chain_params_size", [])()
        if size != ctypes.sizeof(_Params):
            raise Internal(f"C1 parameter struct is {size} bytes on the card, "
                           f"{ctypes.sizeof(_Params)} in the wrapper")
        _size_checked = True


def fixed_params(prog: Program, device) -> "_Params":
    """The ChainParams fields a program fixes on `device` (its code and
    constants there, uploaded once per shape and device; its counts and
    kinds); the feed's pointers, scalars and n are left 0.  G1 and F1
    (ops/gang.py) encode their members from it once per shape."""
    code, consts = _device_program(prog, device)
    p = _Params()
    p.code, p.consts = code.data_ptr(), consts.data_ptr()
    for i, k in enumerate(prog.col_kinds):
        p.col_kind[i] = k
    for i, k in enumerate(prog.lut_kinds):
        p.lut_kind[i] = k
    for i, k in enumerate(prog.out_kinds):
        p.out_kind[i] = k
    p.ncode, p.depth = len(prog.code), prog.depth
    return p


def pack_params(prog: Program, cols: list, luts: list, scalars: list, n: int, device):
    """Check a program's inputs over one feed of n rows and pack them, with
    the program (fixed_params), into the ChainParams of a C1 launch;
    outputs, mask and group ids are left null."""
    for i, (c, k) in enumerate(zip(cols, prog.col_kinds)):
        _check_tensor(c, k, f"column {i}", device, n)
    for i, (t, k) in enumerate(zip(luts, prog.lut_kinds)):
        _check_tensor(t, k, f"LUT {i}", device)
    if len(cols) != len(prog.col_kinds) or len(luts) != len(prog.lut_kinds) \
            or len(scalars) != prog.n_scalars:
        raise TypeError("chain program bound to the wrong number of inputs")
    check_params_size()
    p = fixed_params(prog, device)
    for i, c in enumerate(cols):
        p.col[i] = c.data_ptr()
    for i, t in enumerate(luts):
        p.lut[i], p.lut_len[i] = t.data_ptr(), t.shape[0]
    for i, s in enumerate(scalars):
        p.scalar[i] = int(s)
    p.n = n
    return p


def _launch_c1(prog: Program, cols: list, luts: list, scalars: list, n: int, device):
    p = pack_params(prog, cols, luts, scalars, n, device)
    mask = torch.empty(n, dtype=torch.bool, device=device) if prog.has_mask else None
    gid = torch.empty(n, dtype=torch.int32, device=device) if prog.has_gid else None
    outs = [torch.empty(n, dtype=DTYPE[k], device=device) for k in prog.out_kinds]
    for i, o in enumerate(outs):
        p.out[i] = o.data_ptr()
    p.mask_out = mask.data_ptr() if mask is not None else None
    p.gid_out = gid.data_ptr() if gid is not None else None
    fn = _build.function(_C1, "px_chain_run", [_P, _P])
    with torch.cuda.device(device):
        err = fn(ctypes.byref(p), ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    _build.check(_C1, err, "chain")
    if n > 0:  # (px_chain_run launches nothing for an empty feed)
        _build.KERNELS[_C1].count("px_chain_run")
    return mask, gid, outs


def run(prog: Program, cols: list, luts: list, scalars: list, n: int, device) -> tuple:
    """Run a program over one feed of n rows: kernel C1 on a CUDA device,
    the plain interpreter on the CPU.  cols / luts follow the program's
    binding order, scalars are host ints.  → (mask | None, gid | None,
    [output columns])."""
    device = torch.device(device)
    if device.type == "cuda":
        return _launch_c1(prog, cols, luts, scalars, n, device)
    return run_plain(prog, cols, luts, scalars, n, device)
