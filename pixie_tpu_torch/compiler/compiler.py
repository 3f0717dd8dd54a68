"""PxL compiler entry point (reference src/carnot/planner/compiler/compiler.cc:59
Compiler::CompileToIR → Analyze → Optimize, collapsed into: trace the Python
script against px tracer objects, then run plan-level optimizer passes).

compile_pxl(source, schemas) → CompiledQuery{plan, sink names}.

Scripts come in two shapes (mirroring the bundled pxl_scripts):
  * module-level: build DataFrames and call px.display(df, name);
  * function-based: def fn(start_time: str, ...) returning a DataFrame —
    the caller passes `func`/`func_args`; typed parameters are coerced.
"""
from __future__ import annotations

import ast
import dataclasses
import threading
from typing import Optional

from pixie_tpu_torch.compiler import timeparse
from pixie_tpu_torch.compiler.optimizer import optimize
from pixie_tpu_torch.compiler.pxl import CompileCtx, DataFrame
from pixie_tpu_torch.compiler.pxmodule import PxModule
from pixie_tpu_torch.plan.plan import Plan
from pixie_tpu_torch.status import CompilerError, Unimplemented
from pixie_tpu_torch.types import Relation

_exec_lock = threading.Lock()

#: Builtins exposed to PxL scripts.  PxL is a restricted dialect — scripts are
#: query text, not trusted host code (the reference parses PxL in its own C++
#: front end for the same reason).  This is defense-in-depth, not isolation:
#: no file/process/import machinery, just the pure helpers scripts reasonably
#: use.  `__import__` is allowed solely for `import px`.
#: `format` (builtin and str method) is excluded: its replacement-field
#: mini-language performs attribute traversal from string constants
#: ("{0.__class__}"), bypassing the AST-level dunder rules.  f-strings remain
#: available — their expressions are real AST nodes and get validated.
_SAFE_BUILTIN_NAMES = [
    "abs", "all", "any", "bool", "dict", "divmod", "enumerate", "filter",
    "float", "frozenset", "hash", "int", "isinstance", "issubclass",
    "iter", "len", "list", "map", "max", "min", "next", "print", "range",
    "repr", "reversed", "round", "set", "slice", "sorted", "str", "sum",
    "tuple", "zip", "True", "False", "None", "ValueError", "TypeError",
    "KeyError", "Exception",
]


def _safe_builtins(px_module) -> dict:
    import builtins as _b

    def _import(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "px":
            return px_module
        if name == "pxtrace":
            raise Unimplemented("pxtrace (tracepoint deploys) is not ported "
                                "yet (the host-layer slice)")
        raise ImportError(
            f"PxL scripts may only import px / pxtrace (attempted {name!r})"
        )

    out = {n: getattr(_b, n) for n in _SAFE_BUILTIN_NAMES if hasattr(_b, n)}
    out["__import__"] = _import
    return out


#: AST node types a PxL script may contain.  PxL is a dataframe-building
#: dialect: expressions, assignments, function defs (typed script entry
#: points), conditionals, loops over literals, and comprehensions.  Everything
#: that reaches host machinery — while/with/try, class bodies, async, del,
#: global/nonlocal — is rejected up front, and any identifier or attribute
#: starting with "_" (the attribute-traversal escape hatch:
#: ().__class__.__base__...) fails validation before exec ever runs.
_ALLOWED_PXL_NODES = frozenset(
    n
    for n in (
        "Module", "Expr", "Assign", "AugAssign", "AnnAssign", "FunctionDef",
        "Return", "Import", "alias", "If", "For", "Break", "Continue", "Pass",
        "arguments", "arg", "keyword", "Lambda", "Call", "Attribute",
        "Subscript", "Slice", "Starred", "Name",
        "Constant", "IfExp", "BinOp", "BoolOp",
        "UnaryOp", "Compare", "List", "Tuple", "Dict", "Set", "JoinedStr",
        "FormattedValue", "ListComp", "DictComp", "SetComp", "GeneratorExp",
        "comprehension", "Load", "Store", "Del", "And", "Or", "Not", "Add",
        "Sub", "Mult", "Div", "FloorDiv", "Mod", "Pow", "LShift", "RShift",
        "BitOr", "BitXor", "BitAnd", "MatMult", "UAdd", "USub", "Invert",
        "Eq", "NotEq", "Lt", "LtE", "Gt", "GtE", "Is", "IsNot", "In", "NotIn",
        "Assert", "Raise", "expr_context", "withitem", "TypeIgnore",
    )
    if hasattr(ast, n)
)


#: underscore attributes that are real PxL API, not traversal (the reference
#: registers several underscore-prefixed UDFs scripts call as px._name).
#: Exact single-underscore names only — never dunders or internal state.
_ALLOWED_UNDERSCORE_ATTRS = frozenset({
    "_exec_hostname", "_exec_host_num_cpus",
    "_match_regex_rule", "_match_endpoint",
    # reference-named ML funcs (ml_ops.cc, request_path_ops.cc)
    "_kmeans_fit", "_kmeans_inference", "_build_request_path_clusters",
    "_predict_request_path_cluster", "_text_embedding",
    "_encode_sentence_piece",
})


class _BoolOpRewrite(ast.NodeTransformer):
    """Rewrite `and`/`or`/`not` into runtime helpers that build column
    expressions when an operand is a DataFrame Scalar.

    The reference's own front end compiles these operators to logical_and/or/
    not IR calls (planner ast_visitor); plain Python exec would instead call
    Scalar.__bool__ and fail.  Python semantics for non-Scalar operands are
    preserved (incl. short-circuit via thunks).
    """

    def visit_BoolOp(self, node: ast.BoolOp):
        self.generic_visit(node)
        fn = "__pxl_and__" if isinstance(node.op, ast.And) else "__pxl_or__"
        out = node.values[0]
        for v in node.values[1:]:
            out = ast.Call(
                func=ast.Name(id=fn, ctx=ast.Load()),
                args=[out, ast.Lambda(
                    args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                       kw_defaults=[], defaults=[]),
                    body=v,
                )],
                keywords=[],
            )
        return ast.copy_location(out, node)

    def visit_UnaryOp(self, node: ast.UnaryOp):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            return ast.copy_location(
                ast.Call(func=ast.Name(id="__pxl_not__", ctx=ast.Load()),
                         args=[node.operand], keywords=[]),
                node,
            )
        return node


def _pxl_and(a, b_thunk):
    from pixie_tpu_torch.compiler.pxl import Scalar

    if isinstance(a, Scalar):
        b = b_thunk()
        return a & b if isinstance(b, Scalar) else (a if b else False)
    return a and b_thunk()


def _pxl_or(a, b_thunk):
    from pixie_tpu_torch.compiler.pxl import Scalar

    if isinstance(a, Scalar):
        b = b_thunk()
        return a | b if isinstance(b, Scalar) else (True if b else a)
    return a or b_thunk()


def _pxl_not(a):
    from pixie_tpu_torch.compiler.pxl import Scalar

    return ~a if isinstance(a, Scalar) else (not a)


def validate_pxl_source(source: str) -> ast.Module:
    """Parse + validate untrusted PxL text; raises CompilerError on anything
    outside the dialect.  The reference parses PxL in its own front end
    (planner/parser/parser.cc) precisely so query text never executes as host
    code; this whitelist is our equivalent gate."""
    try:
        tree = ast.parse(source, "<pxl>")
    except SyntaxError as e:
        raise CompilerError(f"PxL syntax error: {e}") from None
    for node in ast.walk(tree):
        name = type(node).__name__
        if name not in _ALLOWED_PXL_NODES:
            raise CompilerError(f"PxL does not allow {name} statements")
        if isinstance(node, ast.Attribute) and (
            (node.attr.startswith("_") and node.attr not in _ALLOWED_UNDERSCORE_ATTRS)
            or node.attr in ("format", "format_map")
        ):
            raise CompilerError(
                f"PxL does not allow access to attribute {node.attr!r}"
            )
        if isinstance(node, ast.Name) and node.id.startswith("_"):
            raise CompilerError(
                f"PxL does not allow underscored identifier {node.id!r}"
            )
        if isinstance(node, ast.FunctionDef):
            if node.decorator_list:
                raise CompilerError("PxL does not allow decorators")
        if isinstance(node, ast.alias) and node.name not in ("px", "pxtrace"):
            raise CompilerError("PxL scripts may only import px / pxtrace")
    return tree


@dataclasses.dataclass
class CompiledQuery:
    plan: Plan
    sink_names: list[str]
    now: int
    #: tracepoint deployments the caller must apply before/with execution
    #: (reference: CompileMutations → MutationExecutor, mutation_executor.go:84)
    mutations: list = dataclasses.field(default_factory=list)
    #: True when the compilation READ the query timestamp (relative time
    #: ranges, px.now()) — such plans bake `now` and are never plan-cacheable.
    #: Defaults True so callers constructing CompiledQuery directly stay safe.
    now_sensitive: bool = True


def _coerce_arg(value, annotation):
    if isinstance(annotation, str):
        annotation = {"int": int, "float": float, "str": str, "bool": bool}.get(annotation)
    if annotation is int:
        return int(value)
    if annotation is float:
        return float(value)
    if annotation is str:
        return str(value)
    if annotation is bool:
        return value in (True, "true", "True", "1", 1)
    return value


def compile_pxl(
    source: str,
    schemas: dict[str, Relation],
    func: Optional[str] = None,
    func_args: Optional[dict] = None,
    registry=None,
    now: Optional[int] = None,
    default_limit: Optional[int] = None,
) -> CompiledQuery:
    if registry is None:
        from pixie_tpu_torch.udf import registry as registry_mod

        registry = registry_mod
    ctx = CompileCtx(schemas, registry, now if now is not None else timeparse.now_ns())
    px = PxModule(ctx)
    glb: dict = {"__name__": "pxl_script", "px": px, "__builtins__": _safe_builtins(px)}

    # dont_inherit: this module uses `from __future__ import annotations`, which
    # compile() would otherwise leak into the script, stringifying the typed
    # function parameters we coerce below.
    tree = validate_pxl_source(source)
    tree = ast.fix_missing_locations(_BoolOpRewrite().visit(tree))
    glb["__pxl_and__"] = _pxl_and
    glb["__pxl_or__"] = _pxl_or
    glb["__pxl_not__"] = _pxl_not
    code = compile(tree, "<pxl>", "exec", dont_inherit=True)
    # `import px` resolves through the restricted __import__ hook to THIS
    # compilation's module instance — no sys.modules juggling needed.
    exec(code, glb)
    result_df = None
    if func is not None:
        fn = glb.get(func)
        if fn is None or not callable(fn):
            raise CompilerError(f"script has no function {func!r}")
        anns = getattr(fn, "__annotations__", {})
        kwargs = {}
        for k, v in (func_args or {}).items():
            kwargs[k] = _coerce_arg(v, anns.get(k))
        result_df = fn(**kwargs)

    if isinstance(result_df, DataFrame):
        # A vis func's RETURN value is always the widget's result table —
        # px.debug drawers inside the func are additional sinks, not a
        # substitute (reference: the UI renders the func result regardless).
        # Skip when the returned frame itself was already displayed, or when
        # the script claimed the "output" name for a DIFFERENT frame (two
        # same-named sinks would silently shadow one another in results).
        sunk = {id(p) for s in ctx.sinks for p in ctx.plan.parents(s)}
        names = {getattr(s, "name", None) for s in ctx.sinks}
        if id(result_df._node) not in sunk:
            if "output" not in names:
                result_df.display("output")
            else:
                # The script already claimed "output" for a DIFFERENT frame.
                # Dropping the returned frame would silently lose the
                # widget's table and mask a script bug — emit it under a
                # deterministic fallback name instead.
                i = 1
                while f"output_{i}" in names:
                    i += 1
                result_df.display(f"output_{i}")
    if not ctx.sinks:
        raise CompilerError(
            "script produced no output: call px.display(df, name) or return a DataFrame"
        )

    plan = optimize(ctx.plan, default_limit=default_limit)
    return CompiledQuery(plan=plan,
                         sink_names=[s.name for s in ctx.sinks if hasattr(s, "name")],
                         now=ctx._now, mutations=list(ctx.mutations),
                         now_sensitive=ctx.now_consumed)
