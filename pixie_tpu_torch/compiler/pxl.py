"""PxL tracer objects: Scalar expressions and the DataFrame compile-time object.

The reference reimplements a Python front end in C++ (pypa parser + QLObject
layer, src/carnot/planner/objects/dataframe.h:112-416).  We get the parser for
free: a PxL script IS Python, executed against these tracer objects; every
DataFrame method appends operators to the Plan under construction, and every
scalar operation builds a plan Expr tree with its type inferred eagerly
(the reference's analyzer type-resolution rules, folded into trace time).
"""
from __future__ import annotations

from typing import Optional, Sequence

from pixie_tpu_torch.metadata.funcs import CTX_KEYS
from pixie_tpu_torch.plan.plan import (
    AggExpr,
    AggOp,
    Call,
    Column,
    Expr,
    FilterOp,
    JoinOp,
    LimitOp,
    Literal,
    MapOp,
    MemorySinkOp,
    MemorySourceOp,
    Plan,
    UnionOp,
    lit,
)
from pixie_tpu_torch.status import CompilerError
from pixie_tpu_torch.types import DataType as DT
from pixie_tpu_torch.types import Relation

_COMPARISONS = {"equal", "not_equal", "less", "less_equal", "greater", "greater_equal"}


class CompileCtx:
    """Per-compilation state: the Plan being built + environment."""

    def __init__(self, schemas: dict[str, Relation], registry, now: int):
        self.plan = Plan()
        self.schemas = dict(schemas)  # pxtrace may add probe output tables
        self.registry = registry
        self._now = now
        #: True once any compilation step READ the query timestamp — the
        #: compiled plan then bakes `now` (relative time ranges, px.now())
        #: and must not be served from a whole-query plan cache, where a
        #: later query would silently reuse an old timestamp.
        self.now_consumed = False
        self.sinks: list[MemorySinkOp] = []
        #: tracepoint deployments etc. (reference CompileMutations path)
        self.mutations: list[dict] = []

    @property
    def now(self) -> int:
        self.now_consumed = True
        return self._now

    # ------------------------------------------------------------------ types
    def infer_type(self, fn: str, arg_dtypes: list[DT]) -> DT:
        """Result type of fn(args) — mirrors engine/eval.py's structural cases
        ahead of registry dispatch so STRING ops type-check at trace time."""
        if fn in _COMPARISONS:
            return DT.BOOLEAN
        if fn == "select" and len(arg_dtypes) == 3:
            return arg_dtypes[1]
        return self.registry.scalar(fn, arg_dtypes).out_type


class Scalar:
    """A typed expression bound to a DataFrame's column space."""

    __slots__ = ("expr", "dtype", "df")

    def __init__(self, expr: Expr, dtype: DT, df: "DataFrame"):
        self.expr = expr
        self.dtype = dtype
        self.df = df

    # -------------------------------------------------------------- operators
    def _call(self, fn: str, *others) -> "Scalar":
        args, dts, df = [self.expr], [self.dtype], self.df
        for o in others:
            s = as_scalar(o, df)
            args.append(s.expr)
            dts.append(s.dtype)
            df = df or s.df
        out = df._ctx.infer_type(fn, dts)
        return Scalar(Call(fn, tuple(args)), out, df)

    def _rcall(self, fn: str, other) -> "Scalar":
        s = as_scalar(other, self.df)
        out = self.df._ctx.infer_type(fn, [s.dtype, self.dtype])
        return Scalar(Call(fn, (s.expr, self.expr)), out, self.df)

    def __eq__(self, o):  # noqa: A003
        return self._call("equal", o)

    def __ne__(self, o):
        return self._call("not_equal", o)

    __hash__ = None  # Scalars are expression builders, not values.

    def __lt__(self, o):
        return self._call("less", o)

    def __le__(self, o):
        return self._call("less_equal", o)

    def __gt__(self, o):
        return self._call("greater", o)

    def __ge__(self, o):
        return self._call("greater_equal", o)

    def __add__(self, o):
        return self._call("add", o)

    def __radd__(self, o):
        return self._rcall("add", o)

    def __sub__(self, o):
        return self._call("subtract", o)

    def __rsub__(self, o):
        return self._rcall("subtract", o)

    def __mul__(self, o):
        return self._call("multiply", o)

    def __rmul__(self, o):
        return self._rcall("multiply", o)

    def __truediv__(self, o):
        return self._call("divide", o)

    def __rtruediv__(self, o):
        return self._rcall("divide", o)

    def __floordiv__(self, o):
        return self._call("floordiv", o)

    def __mod__(self, o):
        return self._call("modulo", o)

    def __and__(self, o):
        return self._call("logical_and", o)

    def __rand__(self, o):
        return self._rcall("logical_and", o)

    def __or__(self, o):
        return self._call("logical_or", o)

    def __ror__(self, o):
        return self._rcall("logical_or", o)

    def __invert__(self):
        return self._call("logical_not")

    def __neg__(self):
        return as_scalar(0, self.df)._call("subtract", self)

    def __bool__(self):
        raise CompilerError(
            "a DataFrame expression has no boolean value at compile time; "
            "use df[cond] for filters and px.select(cond, a, b) for branches"
        )


def as_scalar(v, df: "DataFrame") -> Scalar:
    if isinstance(v, Scalar):
        return v
    lv = lit(v)
    return Scalar(lv, lv.dtype, df)


class _MetadataResolver:
    """df.ctx['pod'] → metadata UDF call (reference: the analyzer's metadata
    conversion rule; objects/dataframe.h:416 MetadataAttribute)."""

    __slots__ = ("_df",)

    def __init__(self, df: "DataFrame"):
        self._df = df

    def __getitem__(self, key: str) -> Scalar:
        candidates = CTX_KEYS.get(key)
        if candidates is None:
            raise CompilerError(f"unknown metadata key {key!r}; have {sorted(CTX_KEYS)}")
        df = self._df
        for fn, src_col in candidates:
            if src_col in df._schema:
                out = df._ctx.infer_type(fn, [df._schema[src_col]])
                return Scalar(Call(fn, (Column(src_col),)), out, df)
        needed = sorted({c for _fn, c in candidates})
        raise CompilerError(
            f"ctx[{key!r}] needs one of columns {needed}, none of which is in "
            f"the DataFrame (have {list(df._schema)})"
        )


class AggMarker:
    """px.sum / px.mean / ... — names a UDA in agg tuples."""

    __slots__ = ("uda_name",)

    def __init__(self, uda_name: str):
        self.uda_name = uda_name

    def __repr__(self):
        return f"px.{self.uda_name}"


class DataFrame:
    """The PxL DataFrame tracer (reference objects/dataframe.h:112).

    Mutable: attribute assignment adds a Map operator; transformations return
    new DataFrames.  Internal state is underscore-prefixed so __setattr__ can
    route everything else to column creation.
    """

    def __init__(self, ctx: CompileCtx, node, schema: dict[str, DT], window: Optional[int] = None):
        object.__setattr__(self, "_ctx", ctx)
        object.__setattr__(self, "_node", node)
        object.__setattr__(self, "_schema", dict(schema))
        object.__setattr__(self, "_window", window)

    # ------------------------------------------------------------ construction
    @staticmethod
    def _from_table(
        ctx: CompileCtx,
        table: str,
        select: Optional[Sequence[str]] = None,
        start_time=None,
        end_time=None,
    ) -> "DataFrame":
        from pixie_tpu_torch.compiler.timeparse import resolve_time

        rel = ctx.schemas.get(table)
        if rel is None:
            raise CompilerError(f"table {table!r} not found; have {sorted(ctx.schemas)}")
        cols = list(select) if select else rel.names()
        for c in cols:
            if c not in rel:
                raise CompilerError(f"column {c!r} not in table {table!r}")
        st = resolve_time(start_time, ctx.now) if start_time is not None else None
        et = resolve_time(end_time, ctx.now) if end_time is not None else None
        op = ctx.plan.add(
            MemorySourceOp(table=table, columns=cols, start_time=st, stop_time=et)
        )
        return DataFrame(ctx, op, {c: rel.dtype(c) for c in cols})

    def _derive(self, op, parents, schema, window="inherit") -> "DataFrame":
        node = self._ctx.plan.add(op, parents=parents)
        w = self._window if window == "inherit" else window
        return DataFrame(self._ctx, node, schema, w)

    # ---------------------------------------------------------------- columns
    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        schema = object.__getattribute__(self, "_schema")
        if name in schema:
            return Scalar(Column(name), schema[name], self)
        raise AttributeError(f"DataFrame has no column or method {name!r} (columns: {list(schema)})")

    def __setattr__(self, name: str, value):
        if name.startswith("_"):
            object.__setattr__(self, name, value)
            return
        s = as_scalar(value, self)
        # Reassignment keeps the column's position (pandas/PxL column order);
        # a new column appends.
        exprs = [
            (n, s.expr if n == name else Column(n)) for n in self._schema
        ]
        schema = {
            n: (s.dtype if n == name else self._schema[n]) for n in self._schema
        }
        if name not in self._schema:
            exprs.append((name, s.expr))
            schema[name] = s.dtype
        node = self._ctx.plan.add(MapOp(exprs=exprs), parents=[self._node])
        # In-place update (PxL assignment semantics).
        object.__setattr__(self, "_node", node)
        object.__setattr__(self, "_schema", schema)

    @property
    def ctx(self) -> _MetadataResolver:
        return _MetadataResolver(self)

    @property
    def columns(self) -> list[str]:
        return list(self._schema)

    def __getitem__(self, key):
        # df[cond] → filter; df['a'] → column; df['a','b'] / df[['a','b']] → projection.
        if isinstance(key, bool):
            # A filter condition folded to a plain flag at compile time
            # (e.g. `df[df.x == 1 and some_module_flag]`): True keeps all
            # rows (no-op), False keeps none.
            if key:
                return self
            return self._derive(
                FilterOp(expr=lit(False)), [self._node], self._schema
            )
        if isinstance(key, Scalar):
            if key.dtype != DT.BOOLEAN:
                raise CompilerError("df[expr] filter requires a boolean expression")
            return self._derive(FilterOp(expr=key.expr), [self._node], self._schema)
        if isinstance(key, str):
            return getattr(self, key)
        if isinstance(key, (tuple, list)):
            names = list(key)
            for n in names:
                if n not in self._schema:
                    raise CompilerError(f"column {n!r} not found (have {list(self._schema)})")
            exprs = [(n, Column(n)) for n in names]
            return self._derive(
                MapOp(exprs=exprs), [self._node], {n: self._schema[n] for n in names}
            )
        raise CompilerError(f"bad DataFrame subscript {key!r}")

    def __setitem__(self, key, value):
        if not isinstance(key, str):
            raise CompilerError("df[...] assignment requires a column name")
        setattr(self, key, value)

    # --------------------------------------------------------------- operators
    def drop(self, columns) -> "DataFrame":
        if isinstance(columns, str):
            columns = [columns]
        missing = [c for c in columns if c not in self._schema]
        if missing:
            raise CompilerError(f"drop: columns {missing} not found")
        keep = [n for n in self._schema if n not in set(columns)]
        exprs = [(n, Column(n)) for n in keep]
        return self._derive(MapOp(exprs=exprs), [self._node], {n: self._schema[n] for n in keep})

    def head(self, n: int = 5) -> "DataFrame":
        return self._derive(LimitOp(n=int(n)), [self._node], self._schema)

    def groupby(self, by) -> "GroupedDataFrame":
        if isinstance(by, str):
            by = [by]
        for c in by:
            if c not in self._schema:
                raise CompilerError(f"groupby: column {c!r} not found")
        return GroupedDataFrame(self, list(by))

    def agg(self, **kwargs) -> "DataFrame":
        return GroupedDataFrame(self, []).agg(**kwargs)

    def rolling(self, window, on: str = "time_") -> "DataFrame":
        from pixie_tpu_torch.compiler.timeparse import parse_duration_ns

        if on != "time_":
            raise CompilerError("rolling is only supported on 'time_'")
        w = parse_duration_ns(window) if isinstance(window, str) else int(window)
        if w <= 0:
            raise CompilerError("rolling window must be positive")
        return DataFrame(self._ctx, self._node, self._schema, window=w)

    def stream(self) -> "DataFrame":
        # Mark every upstream memory source as streaming (reference
        # objects/dataframe.h stream → MemorySource streaming flag).
        seen, stack = set(), [self._node]
        while stack:
            op = stack.pop()
            if op.id in seen:
                continue
            seen.add(op.id)
            if isinstance(op, MemorySourceOp):
                op.streaming = True
            stack.extend(self._ctx.plan.parents(op))
        return self

    def append(self, other: "DataFrame") -> "DataFrame":
        if set(other._schema) != set(self._schema):
            raise CompilerError(
                f"append: schemas differ ({list(self._schema)} vs {list(other._schema)})"
            )
        right = other
        if list(other._schema) != list(self._schema):
            exprs = [(n, Column(n)) for n in self._schema]
            right = other._derive(
                MapOp(exprs=exprs), [other._node], {n: other._schema[n] for n in self._schema}
            )
        for n, dt in self._schema.items():
            if right._schema[n] != dt:
                raise CompilerError(f"append: column {n!r} type mismatch")
        return self._derive(UnionOp(), [self._node, right._node], self._schema)

    def merge(
        self,
        right: "DataFrame",
        how: str = "inner",
        left_on=None,
        right_on=None,
        suffixes=("_x", "_y"),
    ) -> "DataFrame":
        if not isinstance(right, DataFrame):
            raise CompilerError("merge: right operand must be a DataFrame")
        if left_on is None or right_on is None:
            raise CompilerError("merge requires left_on and right_on")
        lon = [left_on] if isinstance(left_on, str) else list(left_on)
        ron = [right_on] if isinstance(right_on, str) else list(right_on)
        for c in lon:
            if c not in self._schema:
                raise CompilerError(f"merge: left key {c!r} not found")
        for c in ron:
            if c not in right._schema:
                raise CompilerError(f"merge: right key {c!r} not found")

        sx, sy = suffixes
        collisions = set(self._schema) & set(right._schema)
        output: list[tuple[str, str, str]] = []
        schema: dict[str, DT] = {}
        for n in self._schema:
            out = n + sx if n in collisions else n
            if out in schema:
                raise CompilerError(f"merge: output column {out!r} collides (rename or drop)")
            output.append(("left", n, out))
            schema[out] = self._schema[n]
        for n in right._schema:
            out = n + sy if n in collisions else n
            if out in schema:
                raise CompilerError(f"merge: output column {out!r} collides (rename or drop)")
            output.append(("right", n, out))
            schema[out] = right._schema[n]

        # Engine join (executor._run_join) is symmetric with full m:n
        # expansion and inner/left/right/outer, so `how` maps straight
        # through (reference planpb JoinOperator, plan.proto:301-316).
        if how not in ("inner", "left", "right", "outer"):
            raise CompilerError(
                f"merge: how={how!r} not supported (inner/left/right/outer)"
            )
        op = JoinOp(how=how, left_on=lon, right_on=ron, output=output)
        return self._derive(op, [self._node, right._node], schema, window=None)

    def display(self, name: str = "output") -> None:
        sink = MemorySinkOp(name=name, columns=list(self._schema))
        self._ctx.plan.add(sink, parents=[self._node])
        self._ctx.sinks.append(sink)

    def __repr__(self):
        inner = ", ".join(f"{n}:{t.name}" for n, t in self._schema.items())
        return f"DataFrame[{inner}]"


class GroupedDataFrame:
    """df.groupby([...]) result; only .agg is valid (reference
    objects/dataframe.h groupby → agg)."""

    def __init__(self, df: DataFrame, by: list[str]):
        self._df = df
        self._by = by

    def agg(self, **kwargs) -> DataFrame:
        df = self._df
        ctx = df._ctx
        groups = list(self._by)
        parent_node = df._node
        schema_in = dict(df._schema)
        windowed = False

        # rolling(...).agg → bin time_ into windows and group by it
        # (reference planpb windowed agg + rolling, objects/dataframe.h:375).
        if df._window:
            if "time_" not in schema_in:
                raise CompilerError("rolling agg requires a time_ column")
            exprs = []
            for n in schema_in:
                if n == "time_":
                    exprs.append(
                        ("time_", Call("bin", (Column("time_"), Literal(df._window, DT.INT64))))
                    )
                else:
                    exprs.append((n, Column(n)))
            parent_node = ctx.plan.add(MapOp(exprs=exprs), parents=[parent_node])
            if "time_" not in groups:
                groups = ["time_"] + groups
            windowed = True

        values: list[AggExpr] = []
        out_schema: dict[str, DT] = {g: schema_in[g] for g in groups}
        if not kwargs and not groups:
            raise CompilerError("agg() requires at least one aggregate")
        # groupby(...).agg() with no aggregates = DISTINCT over the group keys
        # (reference objects/dataframe.h: agg with empty kwargs).
        for out_name, spec in kwargs.items():
            if not (isinstance(spec, tuple) and len(spec) == 2):
                raise CompilerError(
                    f"agg {out_name}: expected tuple (column, px.fn), got {spec!r}"
                )
            col, marker = spec
            if isinstance(col, Scalar):
                if not isinstance(col.expr, Column):
                    raise CompilerError(
                        f"agg {out_name}: argument must be a plain column reference"
                    )
                col = col.expr.name
            if not isinstance(marker, AggMarker):
                raise CompilerError(f"agg {out_name}: second element must be a px aggregate fn")
            uda = ctx.registry.uda(marker.uda_name)
            if uda.nullary:
                arg = None
                in_type = None
            else:
                if col not in schema_in:
                    raise CompilerError(f"agg {out_name}: column {col!r} not found")
                arg = col
                in_type = schema_in[col]
            values.append(AggExpr(out_name, marker.uda_name, arg))
            out_schema[out_name] = uda.out_type(in_type)

        op = ctx.plan.add(
            AggOp(groups=groups, values=values, windowed=windowed), parents=[parent_node]
        )
        return DataFrame(ctx, op, out_schema, window=None)
