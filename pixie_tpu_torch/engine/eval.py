"""Expression compiler: plan Expr trees → device value builders.

The replacement for the reference's two scalar-expression evaluators
(src/carnot/exec/expression_evaluator.h:135,157).  Where the reference walks the
expression per batch calling UDF Exec loops, we compile the expression ONCE per
query into a closure of torch ops over column tensors, and do all string work
at compile time against dictionary snapshots:

  * numeric ops → torch ops on column tensors (device);
  * string scalar UDFs → host evaluation over dictionary values producing LUT
    arrays, applied on device with one gather;
  * string equality / select → dictionary code translation at compile time,
    integer compare / where on device.

Compile-time value = SVal(dtype, dictionary, build, emit) where build(env)
computes the device tensor with torch ops (env = {"cols": {...}, "luts":
{...}}) and emit(builder) pushes the same value in a chain program
(ops/chain.py): the chain kernel runs the programs (kernel C1 on the card, the
plain interpreter on the CPU), and `build` serves the per-dictionary-value
evaluation of composed origins and any value that cannot lower (a leaf).
LUTs are uploaded to the device once per query (ExprCompiler.luts holds them
as numpy until then); literals are made on the compiler's device once, at
compile time.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from pixie_tpu_torch.ops import chain as _c
from pixie_tpu_torch.ops.chain import apply_lut, emit_value
from pixie_tpu_torch.plan.plan import Call, Column, Expr, Literal
from pixie_tpu_torch.status import CompilerError
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.types import DataType as DT
from pixie_tpu_torch.types import STORAGE_DTYPE

TORCH_DTYPE = {
    DT.BOOLEAN: torch.bool,
    DT.INT64: torch.int64,
    DT.FLOAT64: torch.float64,
    DT.TIME64NS: torch.int64,
    DT.STRING: torch.int32,
    DT.UINT128: torch.int32,
}


@dataclasses.dataclass
class SVal:
    dtype: DT
    build: Callable  # env -> torch.Tensor
    dictionary: Optional[Dictionary] = None  # for STRING / UINT128 values
    #: (root_dict, root_col, fn, root) when this value is a PURE
    #: per-dictionary-value function of one dict-encoded source column:
    #: value_for_row = fn(root_dict.value(root.build(env)[row])), root being
    #: the column's SVal.  Lets a
    #: later host call with several non-literal args that all derive from the
    #: same column (px.substring(s, px.find(s, a)+8, ...)) still compile to
    #: one LUT over the root dictionary instead of failing.
    origin: Optional[tuple] = None
    #: pushes this value in a chain program (ops/chain.py ProgramBuilder);
    #: None makes the value a leaf of the chain
    emit: Optional[Callable] = None


def apply_lut_np(lut: np.ndarray, codes: np.ndarray, fill=-1) -> np.ndarray:
    """Host (numpy) twin of apply_lut for join/union code translation."""
    if len(lut) == 0:
        return np.full_like(codes, fill)
    out = lut[np.clip(codes, 0, len(lut) - 1)]
    return np.where(codes >= 0, out, fill)


#: placeholder for Literal positions when probing composed origins (never read)
_LIT_SVAL = SVal(DT.INT64, lambda env: None)


def _as_tensor(v):
    """A Python value as a CPU 0-dim tensor for eager per-dictionary-value
    evaluation of device fns (strings pass through)."""
    if isinstance(v, (bool, int, float)):
        return torch.tensor(v)
    return v


class ExprCompiler:
    """Compiles Exprs against a column environment (dtypes + dictionaries).

    Collects LUT arrays into self.luts; the runner ships them to device once per
    query and passes them via env["luts"].  Literals live on `device`.
    """

    def __init__(self, col_dtypes: dict[str, DT], col_dicts: dict[str, Dictionary],
                 registry, device):
        self.device = torch.device(device)
        self.col_dtypes = col_dtypes
        self.col_dicts = col_dicts
        self.registry = registry
        self.luts: dict[str, np.ndarray] = {}
        self._n = 0
        # Memo holds (expr, SVal): the strong ref to expr is REQUIRED — keying
        # by id() of a dead object would let a newly allocated Expr reuse the
        # address and silently hit the wrong cache entry.
        self._memo: dict[int, tuple[Expr, SVal]] = {}

    # ---------------------------------------------------------------- helpers
    def _add_lut(self, arr: np.ndarray) -> str:
        name = f"lut{self._n}"
        self._n += 1
        self.luts[name] = arr
        return name

    def _cast(self, v: SVal, target: DT) -> SVal:
        if v.dtype == target:
            return v
        if target in (DT.FLOAT64, DT.INT64, DT.TIME64NS) and v.dtype in (
            DT.BOOLEAN,
            DT.INT64,
            DT.FLOAT64,
            DT.TIME64NS,
        ):
            dt = TORCH_DTYPE[target]
            b = v.build
            o = v.origin
            if o is not None:
                d0, root, g, cb = o
                py = float if target == DT.FLOAT64 else int
                o = (d0, root, lambda x, g=g, py=py: py(g(x)), cb)
            k = _c.value_kind(target)

            def emit(pb, v=v, k=k):
                emit_value(pb, v)
                pb.cast_to(k)

            return SVal(target, lambda env, b=b, dt=dt: b(env).to(dt),
                        origin=o, emit=emit)
        raise CompilerError(f"cannot cast {v.dtype.name} to {target.name}")

    # ------------------------------------------------------------------ entry
    def compile(self, expr: Expr) -> SVal:
        # Memoized so type-discovery passes don't duplicate LUT/dictionary work
        # for nested host calls (and shared subexpressions compile once).
        got = self._memo.get(id(expr))
        if got is not None:
            return got[1]
        if isinstance(expr, Column):
            out = self._compile_column(expr)
        elif isinstance(expr, Literal):
            out = self._compile_literal(expr)
        elif isinstance(expr, Call):
            out = self._compile_call(expr)
        else:
            raise CompilerError(f"unknown expression node {type(expr).__name__}")
        self._memo[id(expr)] = (expr, out)
        return out

    def _compile_column(self, expr: Column) -> SVal:
        name = expr.name
        if name not in self.col_dtypes:
            raise CompilerError(f"column {name!r} not found; have {sorted(self.col_dtypes)}")
        dt = self.col_dtypes[name]
        build = lambda env, name=name: env["cols"][name]  # noqa: E731
        d = self.col_dicts.get(name)
        k = _c.value_kind(dt)
        sv = SVal(dt, build, d, emit=lambda pb, name=name, k=k: pb.col(name, k))
        if d is not None:
            sv.origin = (d, name, lambda v: v, sv)
        return sv

    def _compile_literal(self, expr: Literal) -> SVal:
        if expr.dtype == DT.STRING:
            # Bare string literal outside a recognized string context: make a
            # single-value dictionary; code 0 broadcast.
            d = Dictionary([expr.value])
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            return SVal(DT.STRING, lambda env, zero=zero: zero, d,
                        emit=lambda pb: pb.const(0, _c.I32))
        k = _c.value_kind(expr.dtype)
        v = np.asarray(expr.value, dtype=STORAGE_DTYPE[expr.dtype]).item()
        # the tensor is made when a value is first built in torch, never for
        # a chain program (which holds the constant): on a CUDA device that
        # is a host-to-device copy
        made: list = []

        def build(env, value=expr.value, dtype=TORCH_DTYPE[expr.dtype], device=self.device):
            if not made:
                made.append(torch.tensor(value, dtype=dtype, device=device))
            return made[0]

        return SVal(expr.dtype, build, emit=lambda pb, v=v, k=k: pb.const(v, k))

    # ------------------------------------------------------------------ calls
    def _compile_call(self, call: Call) -> SVal:
        fn = call.fn
        arg_types = []
        for a in call.args:
            if isinstance(a, Literal):
                arg_types.append(a.dtype)
            else:
                arg_types.append(self.compile(a).dtype)  # cheap: SVals are tiny

        # String-aware structural forms handled before registry dispatch.
        if fn in ("equal", "not_equal") and all(
            t in (DT.STRING, DT.UINT128) for t in arg_types
        ):
            return self._string_equality(call, negate=(fn == "not_equal"))
        if fn == "select" and len(call.args) == 3 and arg_types[1] == DT.STRING:
            return self._string_select(call)

        udf = self.registry.scalar(fn, arg_types)
        if udf.device:
            return self._device_call(call, udf, arg_types)
        return self._host_call(call, udf, arg_types)

    def _device_call(self, call: Call, udf, arg_types) -> SVal:
        svals = []
        for a, declared in zip(call.args, udf.arg_types):
            v = self.compile(a)
            if v.dtype != declared and declared in (DT.FLOAT64, DT.INT64):
                v = self._cast(v, declared)
            svals.append(v)
        builders = [v.build for v in svals]
        f = udf.fn

        def build(env, f=f, builders=builders):
            return f(*[b(env) for b in builders])

        emit = None
        if udf.op is not None:
            kinds = [_c.value_kind(v.dtype) for v in svals]
            emits = [lambda pb, v=v: emit_value(pb, v) for v in svals]

            def emit(pb, op=udf.op, kinds=kinds, emits=emits):
                _c.lower_call(pb, op, kinds, emits)

        return SVal(udf.out_type, build,
                    origin=self._composed_origin(call.args, svals, f), emit=emit)

    @staticmethod
    def _composed_origin(args, svals, f) -> Optional[tuple]:
        """Origin of f(args) when every non-literal arg is a per-value
        function of the SAME dict-encoded root column; None otherwise."""
        non_lit = [v for a, v in zip(args, svals) if not isinstance(a, Literal)]
        if not non_lit or any(v.origin is None for v in non_lit):
            return None
        d0, root, _, cb = non_lit[0].origin
        if any(v.origin[0] is not d0 or v.origin[1] != root
               for v in non_lit[1:]):
            return None

        def fn(v, f=f, spec=tuple(zip(args, svals))):
            vals = []
            for a, sv in spec:
                if isinstance(a, Literal):
                    vals.append(a.value)
                else:
                    vals.append(sv.origin[2](v))
            out = f(*[_as_tensor(x) for x in vals])
            # device fns return 0-dim tensors here (eager per-dict-value
            # eval); normalize to python so downstream host fns see native
            # types
            return out.item() if isinstance(out, torch.Tensor) else out

        return (d0, root, fn, cb)

    def _host_call(self, call: Call, udf, arg_types) -> SVal:
        """Host UDF → device LUT.

        Two evaluation strategies (both O(domain), not O(rows)):
          * dictionary UDFs: exactly one argument is a dict-encoded column (any
            position); remaining args must be literals.  fn runs over the
            dictionary values → LUT applied by code.
          * bounded-int-domain UDFs (udf.int_domain): the column argument is a
            plain integer; fn runs over the [lo, hi] domain → LUT applied by
            clamped value (enum decoders: http_resp_message, protocol_name...).
        """
        if udf.int_domain is not None:
            return self._int_domain_call(call, udf)
        non_lit = [i for i, a in enumerate(call.args) if not isinstance(a, Literal)]
        if len(non_lit) == 2:
            sa = self.compile(call.args[non_lit[0]])
            sb = self.compile(call.args[non_lit[1]])
            if sa.dictionary is not None and sb.dictionary is not None:
                return self._host_pair_call(call, udf, non_lit, sa, sb)
        if not non_lit:
            # all-literal (incl. nullary) host call — environment constants
            # like px.asid() / px.vizier_id(): evaluate ONCE at compile time
            # and broadcast as a plain literal (volatile fns re-evaluate per
            # compile, which is per query — the reference evaluates per row
            # batch within the same state epoch).
            val = udf.fn(*[a.value for a in call.args])
            return self._compile_literal(Literal(val, udf.out_type))
        if len(non_lit) != 1:
            # NOTE: compiling the args may register intermediate LUTs that
            # the composed-origin LUT then supersedes; they still ship with
            # the kernel (bounded by the arg dictionaries' sizes).  Accepted
            # cost — pruning would need a reachability pass over builders.
            svals = [self.compile(a) if not isinstance(a, Literal) else None
                     for a in call.args]
            origin = self._composed_origin(
                call.args, [s if s is not None else _LIT_SVAL for s in svals],
                udf.fn)
            if origin is not None:
                return self._origin_call(udf, origin)
            raise CompilerError(
                f"{udf.name}: host UDFs take one column argument "
                "(or two dictionary-encoded columns, or several values "
                "derived from ONE dictionary column); others must be literals"
            )
        col_idx = non_lit[0]
        s = self.compile(call.args[col_idx])
        if s.dictionary is None:
            if s.origin is not None:
                # non-dict value (e.g. an int from px.find) that is still a
                # pure function of one dict column: compose over its root
                origin = self._composed_origin(call.args, [
                    s if i == col_idx else _LIT_SVAL
                    for i in range(len(call.args))
                ], udf.fn)
                return self._origin_call(udf, origin)
            raise CompilerError(
                f"{udf.name}: column argument must be dictionary-encoded (STRING/UINT128)"
            )
        consts = [a.value for i, a in enumerate(call.args) if i != col_idx]

        def call_fn(v, fn=udf.fn, idx=col_idx, consts=consts):
            args = list(consts)
            args.insert(idx, v)
            return fn(*args)

        size = s.dictionary.size
        b = s.build
        # the result is itself a pure per-value function of s's root column
        origin = None
        if s.origin is not None:
            d0, root, g, cb = s.origin
            origin = (d0, root,
                      lambda v, g=g, call_fn=call_fn: call_fn(g(v)), cb)
        if udf.out_type == DT.STRING:
            out_dict = Dictionary()
            lut = s.dictionary.lut(lambda v: out_dict.code(call_fn(v)), np.int32, size=size)
            name = self._add_lut(lut)
            return SVal(
                DT.STRING,
                lambda env, name=name, b=b: apply_lut(env["luts"][name], b(env), -1),
                out_dict,
                origin=origin,
                emit=_lut_emit(s, name, lut, -1),
            )
        np_out = STORAGE_DTYPE[udf.out_type]
        lut = s.dictionary.lut(call_fn, np_out, size=size)
        name = self._add_lut(lut)
        fill = False if udf.out_type == DT.BOOLEAN else 0
        return SVal(
            udf.out_type,
            lambda env, name=name, b=b, fill=fill: apply_lut(env["luts"][name], b(env), fill),
            origin=origin,
            emit=_lut_emit(s, name, lut, fill),
        )

    #: compile-time cap on per-dictionary-value composed evaluation (each
    #: value may run several eager device ops — keep python work bounded)
    ORIGIN_CAP = 1 << 16

    def _origin_call(self, udf, origin) -> SVal:
        """Host UDF whose value is a pure per-dict-value function of one root
        column (origin tuple): evaluate over the root dictionary into a LUT
        applied to the ROOT column's codes."""
        root_dict, _root, fn, root = origin
        codes_build = root.build
        size = root_dict.size
        if size > self.ORIGIN_CAP:
            raise CompilerError(
                f"{udf.name}: root dictionary has {size} values, beyond the "
                f"composed-evaluation cap {self.ORIGIN_CAP}"
            )
        if udf.out_type == DT.STRING:
            out_dict = Dictionary()
            lut = root_dict.lut(lambda v: out_dict.code(fn(v)), np.int32,
                                size=size)
            name = self._add_lut(lut)
            return SVal(
                DT.STRING,
                lambda env, name=name, b=codes_build: apply_lut(
                    env["luts"][name], b(env), -1),
                out_dict,
                origin=origin,
                emit=_lut_emit(root, name, lut, -1),
            )
        np_out = STORAGE_DTYPE[udf.out_type]
        lut = root_dict.lut(fn, np_out, size=size)
        name = self._add_lut(lut)
        fill = False if udf.out_type == DT.BOOLEAN else 0
        return SVal(
            udf.out_type,
            lambda env, name=name, b=codes_build, fill=fill: apply_lut(
                env["luts"][name], b(env), fill),
            origin=origin,
            emit=_lut_emit(root, name, lut, fill),
        )

    #: cross-product bound for two-dictionary host calls (compile-time python
    #: work + LUT bytes; typical script usage is tiny enum×enum / id×id spaces)
    PAIR_CAP = 1 << 16

    def _host_pair_call(self, call: Call, udf, non_lit, sa: SVal, sb: SVal) -> SVal:
        """Host UDF over TWO dictionary columns: evaluate over the value
        cross-product into a flattened 2D LUT indexed by a_code * |b| + b_code.
        Bounded by PAIR_CAP — O(|a|·|b|) compile work instead of O(rows)."""
        na, nb = max(sa.dictionary.size, 1), max(sb.dictionary.size, 1)
        if na * nb > self.PAIR_CAP:
            raise CompilerError(
                f"{udf.name}: dictionary cross-product {na}x{nb} exceeds "
                f"{self.PAIR_CAP}; pre-aggregate or reduce cardinality"
            )
        ia, ib = non_lit

        def call_fn(va, vb, fn=udf.fn, args_spec=tuple(call.args)):
            args = []
            for i, a in enumerate(args_spec):
                if i == ia:
                    args.append(va)
                elif i == ib:
                    args.append(vb)
                else:
                    args.append(a.value)
            return fn(*args)

        va_list = sa.dictionary.values()
        vb_list = sb.dictionary.values()
        ab, bb = sa.build, sb.build
        if udf.out_type == DT.STRING:
            out_dict = Dictionary()
            lut = np.fromiter(
                (out_dict.code(call_fn(va, vb)) for va in va_list for vb in vb_list),
                dtype=np.int32, count=na * nb,
            ) if va_list and vb_list else np.empty(0, np.int32)
            fill = -1
        else:
            np_out = STORAGE_DTYPE[udf.out_type]
            lut = np.asarray(
                [call_fn(va, vb) for va in va_list for vb in vb_list], dtype=np_out
            )
            out_dict = None
            fill = False if udf.out_type == DT.BOOLEAN else 0
        name = self._add_lut(lut)

        def build(env, name=name, ab=ab, bb=bb, nb=nb, fill=fill):
            ca, cb = ab(env), bb(env)
            pair = torch.where(
                (ca >= 0) & (cb >= 0),
                ca.to(torch.int32) * nb + cb.to(torch.int32),
                -1,
            )
            return apply_lut(env["luts"][name], pair, fill)

        def emit(pb, name=name, nb=nb, fill=fill, k=_c.kind_of_np(lut.dtype)):
            emit_value(pb, sa)
            emit_value(pb, sb)
            pb.pair(nb)
            pb.lut(name, k, fill)

        return SVal(udf.out_type, build, out_dict, emit=emit)

    def _int_domain_call(self, call: Call, udf) -> SVal:
        lo, hi = udf.int_domain
        v = self.compile(call.args[0])
        if v.dtype not in (DT.INT64, DT.TIME64NS):
            raise CompilerError(f"{udf.name}: argument must be an integer column")
        consts = []
        for a in call.args[1:]:
            if not isinstance(a, Literal):
                raise CompilerError(f"{udf.name}: trailing arguments must be literals")
            consts.append(a.value)
        vals = [udf.fn(i, *consts) for i in range(lo, hi + 1)]
        b = v.build
        if udf.out_type == DT.STRING:
            out_dict = Dictionary()
            lut = np.asarray([out_dict.code(x) for x in vals], dtype=np.int32)
            oob = out_dict.code(udf.fn(lo - 1, *consts))  # out-of-domain value
            name = self._add_lut(lut)

            def build(env, name=name, b=b, lo=lo, hi=hi, oob=oob):
                x = b(env)
                in_dom = (x >= lo) & (x <= hi)
                idx = torch.clamp(x - lo, 0, hi - lo).long()
                return torch.where(in_dom, env["luts"][name][idx], oob)

            return SVal(DT.STRING, build, out_dict,
                        emit=_domain_emit(v, name, lut, lo, hi, oob))
        np_out = STORAGE_DTYPE[udf.out_type]
        lut = np.asarray(vals, dtype=np_out)
        oob_v = udf.fn(lo - 1, *consts)
        name = self._add_lut(lut)

        def build_n(env, name=name, b=b, lo=lo, hi=hi, oob_v=oob_v):
            x = b(env)
            in_dom = (x >= lo) & (x <= hi)
            idx = torch.clamp(x - lo, 0, hi - lo).long()
            return torch.where(in_dom, env["luts"][name][idx], oob_v)

        return SVal(udf.out_type, build_n,
                    emit=_domain_emit(v, name, lut, lo, hi, oob_v))

    def _string_equality(self, call: Call, negate: bool) -> SVal:
        lhs_e, rhs_e = call.args
        # literal vs column: compare against the column dictionary's code.
        if isinstance(rhs_e, Literal) or isinstance(lhs_e, Literal):
            col_e, lit_e = (lhs_e, rhs_e) if isinstance(rhs_e, Literal) else (rhs_e, lhs_e)
            v = self.compile(col_e)
            if v.dictionary is None:
                raise CompilerError("string equality against non-dictionary value")
            code = v.dictionary.get_code(lit_e.value, -2)  # -2 never matches any code
            b = v.build

            def build(env, b=b, code=code, negate=negate):
                eq = b(env) == code
                return torch.logical_not(eq) if negate else eq

            def emit(pb, v=v, code=code, negate=negate):
                emit_value(pb, v)
                pb.const(code, _c.I64)
                _eq(pb, negate)

            return SVal(DT.BOOLEAN, build, emit=emit)
        lv, rv = self.compile(lhs_e), self.compile(rhs_e)
        if lv.dictionary is None or rv.dictionary is None:
            raise CompilerError("string equality requires dictionary-encoded operands")
        if lv.dictionary is rv.dictionary:
            lb, rb = lv.build, rv.build

            def build_same(env, lb=lb, rb=rb, negate=negate):
                eq = lb(env) == rb(env)
                return torch.logical_not(eq) if negate else eq

            def emit_same(pb, lv=lv, rv=rv, negate=negate):
                emit_value(pb, lv)
                emit_value(pb, rv)
                _eq(pb, negate)

            return SVal(DT.BOOLEAN, build_same, emit=emit_same)
        trans = rv.dictionary.translate_to(lv.dictionary, insert=False)
        name = self._add_lut(trans)
        lb, rb = lv.build, rv.build

        def build_trans(env, lb=lb, rb=rb, name=name, negate=negate):
            r = apply_lut(env["luts"][name], rb(env), -1)
            eq = lb(env) == r
            return torch.logical_not(eq) if negate else eq

        def emit_trans(pb, lv=lv, rv=rv, name=name, k=_c.kind_of_np(trans.dtype),
                       negate=negate):
            emit_value(pb, lv)
            emit_value(pb, rv)
            pb.lut(name, k, -1)
            _eq(pb, negate)

        return SVal(DT.BOOLEAN, build_trans, emit=emit_trans)

    def _string_select(self, call: Call) -> SVal:
        cond = self.compile(call.args[0])
        a = self.compile(call.args[1])
        b = self.compile(call.args[2])
        if a.dictionary is None or b.dictionary is None:
            raise CompilerError("select on strings requires dictionary operands")
        # Output dictionary: copy of a's snapshot, then b's values appended.
        out = Dictionary(a.dictionary.values())
        tb = b.dictionary.translate_to(out, insert=True)
        name = self._add_lut(tb)
        cb, ab, bb = cond.build, a.build, b.build

        def build(env, cb=cb, ab=ab, bb=bb, name=name):
            bc = apply_lut(env["luts"][name], bb(env), -1)
            return torch.where(cb(env), ab(env), bc)

        def emit(pb, name=name, k=_c.kind_of_np(tb.dtype)):
            emit_value(pb, cond)
            emit_value(pb, a)
            emit_value(pb, b)
            pb.lut(name, k, -1)
            pb.op("SELECT")

        return SVal(DT.STRING, build, out, emit=emit)


def _eq(pb, negate: bool) -> None:
    """Compare the two codes on top of a chain program's stack (== or !=)."""
    pb.op("EQ_I")
    if negate:
        pb.op("NOT")


def _lut_emit(codes: SVal, name: str, lut: np.ndarray, fill):
    """Emitter of apply_lut(luts[name], codes, fill)."""
    def emit(pb, k=_c.kind_of_np(lut.dtype)):
        emit_value(pb, codes)
        pb.lut(name, k, fill)

    return emit


def _domain_emit(x: SVal, name: str, lut: np.ndarray, lo: int, hi: int, oob):
    """Emitter of a bounded-int-domain LUT (see _int_domain_call)."""
    def emit(pb, k=_c.kind_of_np(lut.dtype)):
        emit_value(pb, x)
        pb.lut_domain(name, k, lo, hi, oob)

    return emit
