"""The `px` module surface presented to PxL scripts (reference
src/carnot/planner/objects/pixie_module.cc).

One PxModule instance exists per compilation and is injected as `px` into the
script's namespace (and sys.modules during exec, so `import px` works).  Any
attribute not explicitly defined falls through to the scalar-UDF registry,
giving every builtin (px.abs, px.contains, px.upid_to_pod_name, ...) for free.

Copied from the reference package (pixie_tpu/compiler/pxmodule.py).  Not
ported yet, each raising Unimplemented where a script reaches it: the OTel
export objects (px.otel, px.export), which come with the host-layer slice
(ROADMAP Queue 1 item 6e).
"""
from __future__ import annotations

import types
from typing import Optional

from pixie_tpu_torch.compiler import timeparse
from pixie_tpu_torch.compiler.pxl import AggMarker, CompileCtx, DataFrame, Scalar, as_scalar
from pixie_tpu_torch.plan.plan import Call, Literal
from pixie_tpu_torch.status import CompilerError, Unimplemented
from pixie_tpu_torch.types import DataType as DT

_AGG_NAMES = (
    "sum",
    "mean",
    "count",
    "min",
    "max",
    "quantiles",
    "stddev",
    "variance",
    "any",
    "sample",
    "count_distinct",
    # model-fit aggregates (reference ml_ops.cc:38, request_path_ops.cc:40)
    "_kmeans_fit",
    "_build_request_path_clusters",
) + tuple(f"p{q:02d}" for q in (1, 10, 25, 50, 75, 90, 95, 99))


class _SemanticStr(str):
    """Semantic-typed script parameter annotation (px.Pod, px.Namespace, ...) —
    physically a string; the semantic type drives UI autocomplete in the
    reference (vispb), and arg coercion here.  Calling one on a column
    expression (px.Node(df.x)) is a semantic CAST: identity on the Scalar."""

    def __new__(cls, v=""):
        if isinstance(v, Scalar):
            return v
        return super().__new__(cls, v)


class Namespace(_SemanticStr):
    pass


class Pod(_SemanticStr):
    pass


class Service(_SemanticStr):
    pass


class Node(_SemanticStr):
    pass


class Container(_SemanticStr):
    pass


class PxModule(types.ModuleType):
    Namespace = Namespace
    Pod = Pod
    Service = Service
    Node = Node
    Container = Container

    def __init__(self, ctx: CompileCtx):
        super().__init__("px", "Pixie PxL standard module (PyTorch/CUDA port)")
        self._ctx = ctx
        for name in _AGG_NAMES:
            if ctx.registry.has_uda(name):
                setattr(self, name, AggMarker(name))

    # ------------------------------------------------------------- dataframes
    def DataFrame(self, table: str, select=None, start_time=None, end_time=None):
        return DataFrame._from_table(
            self._ctx, table, select=select, start_time=start_time, end_time=end_time
        )

    def display(self, df: DataFrame, name: str = "output") -> None:
        if not isinstance(df, DataFrame):
            raise CompilerError("px.display takes a DataFrame")
        df.display(name)

    def debug(self, df: DataFrame, name: str = "debug") -> None:
        self.display(df, "_" + name)

    # ------------------------------------------------------------------- time
    def now(self) -> int:
        return self._ctx.now

    def nanos(self, n) -> int:
        return int(n)

    def micros(self, n) -> int:
        return int(n) * timeparse.US

    def millis(self, n) -> int:
        return int(n) * timeparse.MS

    def seconds(self, n) -> int:
        return int(n) * timeparse.SECOND

    def minutes(self, n) -> int:
        return int(n) * timeparse.MINUTE

    def hours(self, n) -> int:
        return int(n) * timeparse.HOUR

    def days(self, n) -> int:
        return int(n) * timeparse.DAY

    def parse_duration(self, s: str) -> int:
        return timeparse.parse_duration_ns(s)

    def parse_time(self, v) -> int:
        return timeparse.resolve_time(v, self._ctx.now)

    # ------------------------------------------------- type constructors/casts
    def DurationNanos(self, v):
        """Semantic cast → ST_DURATION_NS; physically int64 ns (pass-through)."""
        return v

    def Time(self, v):
        return v

    def uint128(self, s):
        return s

    def Bytes(self, v):
        return v

    def Percent(self, v):
        return v

    # ---------------------------------------------------------------- helpers
    def select(self, cond, a, b):
        for v in (cond, a, b):
            if isinstance(v, Scalar):
                df = v.df
                break
        else:
            # all-literal select folds at compile time
            return a if cond else b
        c, av, bv = as_scalar(cond, df), as_scalar(a, df), as_scalar(b, df)
        out = df._ctx.infer_type("select", [c.dtype, av.dtype, bv.dtype])
        return Scalar(Call("select", (c.expr, av.expr, bv.expr)), out, df)

    def equals_any(self, col, values) -> Scalar:
        if not isinstance(col, Scalar):
            raise CompilerError("px.equals_any requires a column expression")
        out = None
        for v in values:
            e = col == v
            out = e if out is None else (out | e)
        if out is None:
            raise CompilerError("px.equals_any requires at least one value")
        return out

    def script_reference(self, label, script: str, args: Optional[dict] = None) -> Scalar:
        """UI deeplink (reference builtins _script_reference). The engine keeps
        the label column value; link metadata is a presentation concern carried
        in the vis spec, not the data plane."""
        if not isinstance(label, Scalar):
            raise CompilerError("px.script_reference requires a column expression")
        return label

    def vis(self):  # pragma: no cover - placeholder namespace
        raise CompilerError("px.vis is declarative; use the vis.json spec")

    # ------------------------------------------------------------ otel export
    @property
    def otel(self):
        raise Unimplemented("px.otel: OTel export objects are not ported yet "
                            "(the host-layer slice)")

    def export(self, df: DataFrame, data) -> None:
        """px.export(df, px.otel.Data(...)) — an OTel export sink in the
        reference (objects/otel.cc); not ported yet."""
        raise Unimplemented("px.export: OTel export sinks are not ported yet "
                            "(the host-layer slice)")

    def normalize_mysql(self, q, cmd=None):
        """2-arg form (reference sql_ops.cc NormalizeMySQLUDF) takes the int
        command code column; normalization yields the JSON query-struct.  The
        command gate is folded: all commands normalize (non-query bodies are
        unaffected by the literal/number scrubbing)."""
        if cmd is None:
            return self.__getattr__("normalize_mysql")(q)
        return self.__getattr__("normalize_sql_struct")(q)

    def normalize_pgsql(self, q, cmd=None):
        if cmd is None:
            return self.__getattr__("normalize_pgsql")(q)
        if isinstance(cmd, Scalar):
            return self.__getattr__("normalize_sql_struct")(q)
        return self.__getattr__("normalize_pgsql")(q, cmd)

    # Nullary context helpers (reference metadata_ops.h ASIDUDF etc.)
    def asid(self) -> int:
        from pixie_tpu_torch.metadata import snapshot

        return snapshot().asid

    def node_name(self) -> str:
        from pixie_tpu_torch.metadata import snapshot

        return snapshot().node_name

    # Exec-context UDFs (reference funcs/metadata/metadata_ops.h HostnameUDF /
    # HostNumCPUsUDF).  DIVERGENCE: the reference evaluates these on each
    # executing agent; here they fold to the COMPILING node's view (scripts
    # use them for per-node drilldowns where the value is constant anyway).
    def _exec_hostname(self) -> str:
        from pixie_tpu_torch.metadata import snapshot

        return snapshot().node_name or "localhost"

    def _exec_host_num_cpus(self) -> int:
        import os

        return os.cpu_count() or 1

    # Cluster identity (reference vizier_id/vizier_name UDFs backed by flags)
    def vizier_id(self) -> str:
        from pixie_tpu_torch import flags

        return flags.define_str("PX_VIZIER_ID", "00000000-0000-0000-0000-000000000000",
                                "cluster id")

    def vizier_name(self) -> str:
        from pixie_tpu_torch import flags

        return flags.define_str("PX_VIZIER_NAME", "pixie-tpu-cluster", "cluster name")

    # ------------------------------------------------------ registry fallback
    def __getattr__(self, name: str):
        # Fallback: any scalar UDF in the registry becomes px.<name>(...),
        # any UDTF becomes px.<Name>(...) returning a DataFrame.
        ctx = object.__getattribute__(self, "_ctx")
        if ctx.registry.has_udtf(name):
            from pixie_tpu_torch.plan.plan import UDTFSourceOp

            def call_udtf(_name=name, **kwargs):
                u = ctx.registry.udtf(_name)
                op = ctx.plan.add(
                    UDTFSourceOp(name=_name, args=dict(kwargs),
                                 schema=u.relation.to_dict())
                )
                return DataFrame(ctx, op, {c.name: c.data_type for c in u.relation})

            call_udtf.__name__ = name
            return call_udtf
        if ctx.registry.has_scalar(name):
            def call(*args, _name=name):
                df = None
                for a in args:
                    if isinstance(a, Scalar):
                        df = a.df
                        break
                if df is None:
                    # All-literal call: constant-fold host UDFs at compile
                    # time (e.g. px.nslookup('10.0.0.1') in a script header).
                    from pixie_tpu_torch.plan.plan import lit as _lit

                    dts = [_lit(a).dtype for a in args]
                    o = ctx.registry.scalar(_name, dts)
                    if not o.device:
                        # Folds against the CURRENT metadata snapshot — the
                        # same epoch a column-path LUT of this query would
                        # bake.  Caveat: a StreamQuery compiles its plan once,
                        # so volatile folds resolve at stream creation, not
                        # per poll (batch queries recompile per execution and
                        # are unaffected).
                        return o.fn(*args)
                    raise CompilerError(
                        f"px.{_name} requires at least one column expression argument"
                    )
                svals = [as_scalar(a, df) for a in args]
                out = ctx.infer_type(_name, [s.dtype for s in svals])
                return Scalar(Call(_name, tuple(s.expr for s in svals)), out, df)

            call.__name__ = name
            return call
        raise AttributeError(f"px has no attribute {name!r}")
