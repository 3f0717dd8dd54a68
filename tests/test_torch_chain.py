"""Chain programs (ops/chain.py, kernel C1's plain interpreter) against the
reference's closures.

Every `_dev` registration of the port's registry (name x argument types) is
lowered through the port's ExprCompiler into a chain program and run by the
plain interpreter on numpy inputs with edge values (INT64_MIN / INT64_MAX,
zero divisors, negative % and // operands, NaN, +-inf, +-0, half-way values
for round); the reference's registered jnp function runs on the same inputs.
They agree exactly for integer, bool and comparison results and for float
results that involve no transcendental (a subnormal result may meet the
reference's 0: XLA-CPU flushes subnormals); log, log2, log10, exp, sqrt and
pow are held to 1 ulp, since XLA-CPU's and libm's last bit may differ.  Whole chains (two limits, a string-LUT predicate, a
literal group key, a null dictionary key) run through both packages'
execute_plan; a chain's program is lowered once per chain shape across feeds
and polls (a new window origin reuses it); and the config #1-#5 plans lower
with no leaf.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu import plan as ref_plan
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.udf import registry as ref_registry

from pixie_tpu_torch import plan as port_plan
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.engine.eval import ExprCompiler
from pixie_tpu_torch.engine.stream import stream_pxl
from pixie_tpu_torch.ops import chain as c1
from pixie_tpu_torch.plan.plan import Call, Column
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation
from pixie_tpu_torch.udf import registry

SEC = 1_000_000_000
_I64 = np.iinfo(np.int64)
_INT_EDGES = np.array([_I64.min, _I64.max, 0, -1, 1, -7, 7, 2, -2, 3, -3, 10 ** 12,
                       -(10 ** 12), 1 << 40], dtype=np.int64)
_FLT_EDGES = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, 1.5, 2.5, -0.5, -1.5,
                       -2.5, 1e-300, 1e300, -7.25, 3.0, -3.0, 1e-9, 2.0 ** 53 + 1],
                      dtype=np.float64)
N = 512
#: results held to 1 ulp: XLA-CPU's transcendentals may differ from libm's
#: in the last bit (ROADMAP Queue 3, sketch)
_ULP_FNS = {"log", "ln", "log2", "log10", "exp", "sqrt", "pow"}


def _dev_registrations():
    out = []
    for name, udf in registry.scalar_overloads():
        if udf.device:
            out.append(pytest.param(name, udf.arg_types,
                                    id=f"{name}-{'-'.join(t.name for t in udf.arg_types)}"))
    return out


def _inputs(arg_types, seed):
    """One numpy column per argument: every pair of edge values meets (the
    edges, then the edges against each other shifted), the rest random."""
    rng = np.random.default_rng(seed)
    cols = []
    for i, t in enumerate(arg_types):
        if t == DT.BOOLEAN:
            cols.append(rng.random(N) < 0.5)
            continue
        edges = _FLT_EDGES if t == DT.FLOAT64 else _INT_EDGES
        if t == DT.FLOAT64:
            v = rng.normal(0, 100, N)
        else:
            v = rng.integers(-1000, 1000, N).astype(np.int64)
        e = len(edges)
        # argument i walks the edge list i times as fast: all e*e pairs
        idx = np.arange(e * e)
        v[: e * e] = edges[(idx // e ** i) % e] if i < 2 else edges[idx % e]
        cols.append(v)
    return cols


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ai = a.view(np.int64).astype(object)
    bi = b.view(np.int64).astype(object)
    return np.abs(np.array([x - y for x, y in zip(ai, bi)], dtype=object))


def _lower_and_run(name, arg_types, cols):
    """The port: Call(name, a0, a1, ...) compiled by ExprCompiler, lowered
    into a program and run by the plain interpreter."""
    col_names = [f"a{i}" for i in range(len(arg_types))]
    ec = ExprCompiler(dict(zip(col_names, arg_types)), {}, registry, "cpu")
    sv = ec.compile(Call(name, tuple(Column(c) for c in col_names)))
    b = c1.ProgramBuilder()
    c1.emit_value(b, sv)
    b.store()
    prog, bnd = b.finish(has_mask=False)
    assert not bnd.leaves, f"{name}: lowered with a leaf"
    env = dict(zip(col_names, (torch.from_numpy(c) for c in cols)))
    _m, _g, (out,) = c1.run(prog, [env[n] for n in bnd.cols], [], [], N, "cpu")
    return out.numpy(), sv.dtype


@pytest.mark.parametrize("name,arg_types", _dev_registrations())
def test_dev_registration_program_equals_reference(name, arg_types):
    cols = _inputs(arg_types, 11)
    got, out_dt = _lower_and_run(name, arg_types, cols)
    ref_udf = ref_registry.scalar(name, [RefDT[t.name] for t in arg_types])
    assert ref_udf.out_type.name == out_dt.name
    want = np.asarray(ref_udf.fn(*[jnp.asarray(c) for c in cols]))
    if want.shape == ():
        want = np.broadcast_to(want, got.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if got.dtype.kind != "f":
        assert np.array_equal(got, want), np.nonzero(got != want)[0][:5]
        return
    both_nan = np.isnan(got) & np.isnan(want)
    # XLA-CPU flushes subnormal results to zero; torch (and CUDA) keep them
    flushed = (want == 0) & (np.abs(got) < np.finfo(np.float64).tiny)
    same = both_nan | (got == want) | flushed
    if name in _ULP_FNS:
        bad = ~same
        assert (_ulps(got[bad], want[bad]) <= 1).all(), (name, got[bad][:4], want[bad][:4])
    else:
        assert same.all(), (np.nonzero(~same)[0][:5], got[~same][:4], want[~same][:4])


def test_every_dev_registration_names_an_opcode():
    ops = {udf.op for _n, udf in registry.scalar_overloads() if udf.device}
    assert None not in ops and ops <= c1.DEV_OPS


def test_a_value_that_cannot_lower_is_a_counted_leaf():
    """A device fn with no opcode enters C1 as a leaf column computed by its
    torch closure; the result is unchanged and exec_stats counts it."""
    from pixie_tpu_torch.udf import Registry, ScalarUDF
    from pixie_tpu_torch.udf import builtins as port_builtins

    reg = Registry()
    port_builtins.register_all(reg)
    reg.register(ScalarUDF(name="twice", arg_types=(DT.INT64,), out_type=DT.INT64,
                           fn=lambda a: a * 2, device=True))
    ts = TableStore()
    ts.create("t", Relation.of(("time_", DT.TIME64NS), ("x", DT.INT64))).write(
        {"time_": np.arange(50, dtype=np.int64), "x": np.arange(50, dtype=np.int64) - 7})
    P = port_plan
    p = P.Plan()
    n = p.add(P.MapOp(exprs=[("y", P.Call("add", (P.Call("twice", (P.Column("x"),)),
                                                   P.lit(1))))]),
              parents=[p.add(P.MemorySourceOp(table="t"))])
    n = p.add(P.FilterOp(expr=P.Call("greater", (P.Column("y"), P.lit(0)))), parents=[n])
    p.add(P.MemorySinkOp(name="out"), parents=[n])
    res = execute_plan(p, ts, registry=reg, device="cpu")["out"]
    want = 2 * (np.arange(50) - 7) + 1
    assert res.columns["y"].tolist() == want[want > 0].tolist()
    assert res.exec_stats["chain_leaves"] == 2  # the filter's and the output's


def test_invert_of_an_int_is_float64():
    """1.0 / an int64 tensor would be float32 in torch; the reference's
    invert(INT64) is float64 (a repaired port fault)."""
    got, out_dt = _lower_and_run("invert", (DT.INT64,), [np.array([3, -7, 0], np.int64)])
    assert out_dt == DT.FLOAT64 and got.dtype == np.float64
    fn = registry.scalar("invert", [DT.INT64]).fn
    assert fn(torch.tensor([3])).dtype == torch.float64
    assert got[0] == 1.0 / 3.0


# ------------------------------------------------------------ whole chains


def _stores(seed=4, n=30_000):
    rng = np.random.default_rng(seed)
    cols = {"time_": np.arange(n, dtype=np.int64) * 1_000_000,
            "service": rng.choice(["cart", "auth", "web", "pay"], n).tolist(),
            "path": rng.choice(["/a", "/b/c", "/dd", "/x/y/z"], n).tolist(),
            "latency": rng.exponential(20.0, n),
            "status": rng.choice([200, 404, 500], n)}
    out = {}
    for pkg, (ts, rel_cls, dt) in (("ref", (RefStore(), RefRelation, RefDT)),
                                   ("port", (TableStore(), Relation, DT))):
        rel = rel_cls.of(("time_", dt.TIME64NS), ("service", dt.STRING),
                         ("path", dt.STRING), ("latency", dt.FLOAT64),
                         ("status", dt.INT64))
        ts.create("http_events", rel, batch_rows=4096).write(cols)
        out[pkg] = ts
    return out


def _both(stores, build):
    """Build the same plan with each package's plan API; → (ref, port)
    results of its 'out' sink."""
    ref = ref_execute(build(ref_plan), stores["ref"])["out"]
    port = execute_plan(build(port_plan), stores["port"], device="cpu")["out"]
    assert port.exec_stats["chain_leaves"] == 0
    return ref, port


def _frame(res, keys):
    df = res.to_pandas()
    return df.sort_values(keys).reset_index(drop=True) if keys else df


def _equal(ref, port, keys=None, float_cols=()):
    a, b = _frame(ref, keys), _frame(port, keys)
    assert list(a.columns) == list(b.columns) and len(a) == len(b)
    for c in a.columns:
        if c in float_cols:
            np.testing.assert_allclose(b[c], a[c], rtol=1e-12)
        else:
            assert list(a[c]) == list(b[c]), c


def test_chain_two_limits_string_lut_predicate_and_computed_column():
    def build(P):
        p = P.Plan()
        n = p.add(P.MemorySourceOp(table="http_events"))
        n = p.add(P.FilterOp(expr=P.Call("not_equal", (P.Column("service"),
                                                      P.lit("auth")))), parents=[n])
        n = p.add(P.LimitOp(n=9000), parents=[n])
        n = p.add(P.MapOp(exprs=[
            ("service", P.Column("service")), ("path", P.Column("path")),
            ("status", P.Column("status")),
            ("plen", P.Call("length", (P.Column("path"),))),
            ("ms", P.Call("multiply", (P.Column("latency"), P.lit(0.001)))),
            ("slow", P.Call("greater", (P.Column("latency"), P.lit(30.0))))]),
            parents=[n])
        n = p.add(P.FilterOp(expr=P.Call("contains", (P.Column("path"), P.lit("/b")))),
                  parents=[n])
        n = p.add(P.LimitOp(n=700), parents=[n])
        p.add(P.MemorySinkOp(name="out"), parents=[n])
        return p

    ref, port = _both(_stores(), build)
    assert port.num_rows == 700
    _equal(ref, port)


def test_chain_literal_group_key_and_null_dict_key():
    """A literal group key (one code for every row) and a key column whose
    string function maps some values to null: null keys drop out."""
    def build(P):
        p = P.Plan()
        n = p.add(P.MemorySourceOp(table="http_events"))
        n = p.add(P.MapOp(exprs=[
            ("k", P.lit("all")),
            ("svc", P.Call("select", (P.Call("equal", (P.Column("status"), P.lit(500))),
                                      P.Column("service"), P.Column("path")))),
            ("latency", P.Column("latency"))]), parents=[n])
        n = p.add(P.AggOp(groups=["k", "svc"], values=[
            P.AggExpr("cnt", "count", None), P.AggExpr("m", "mean", "latency"),
            P.AggExpr("p50", "p50", "latency")]), parents=[n])
        p.add(P.MemorySinkOp(name="out"), parents=[n])
        return p

    ref, port = _both(_stores(), build)
    _equal(ref, port, keys=["k", "svc"], float_cols=("m",))


def test_chain_null_dict_key_from_a_left_join():
    """A left join leaves code -1 in the right side's string column for
    unmatched rows; grouping by it drops those rows (pandas dropna), in
    both packages."""
    stores = _stores()
    owners = {"service": ["cart", "web"], "team": ["shop", "front"]}
    for pkg, ts in stores.items():
        dt = RefDT if pkg == "ref" else DT
        rel = (RefRelation if pkg == "ref" else Relation).of(("service", dt.STRING),
                                                            ("team", dt.STRING))
        ts.create("owners", rel).write(owners)

    def build(P):
        p = P.Plan()
        j = p.add(P.JoinOp(how="left", left_on=["service"], right_on=["service"], output=[
            ("left", "latency", "latency"), ("right", "team", "team")]),
            parents=[p.add(P.MemorySourceOp(table="http_events")),
                     p.add(P.MemorySourceOp(table="owners"))])
        n = p.add(P.AggOp(groups=["team"], values=[P.AggExpr("cnt", "count", None),
                                                   P.AggExpr("m", "mean", "latency")]),
                  parents=[j])
        p.add(P.MemorySinkOp(name="out"), parents=[n])
        return p

    ref, port = _both(stores, build)
    assert sorted(port.decoded("team")) == ["front", "shop"]
    _equal(ref, port, keys=["team"], float_cols=("m",))


def test_chain_null_dict_codes_drop_out_of_groups():
    """Rows whose dictionary key code is -1 (a left join's unmatched fill)
    are dropped before the group-id combine clamps them into group 0."""
    from pixie_tpu_torch.engine.executor import ChainKernel, GroupKey

    kern = ChainKernel({"svc": DT.STRING, "v": DT.INT64}, {}, [], registry, None, "cpu")
    sv = kern.ctx.sym["svc"]
    key = GroupKey("svc", "dict", 4, DT.STRING, key_sval=sv)
    from pixie_tpu_torch.udf.udf import CountUDA

    uda = CountUDA()
    step = kern.make_agg_step([key], [("c", uda, None)], 4)
    codes = torch.tensor([0, -1, 2, -1, 3, 0], dtype=torch.int32)
    state = {"c": uda.init(4, None, "cpu")}
    state, _ = step({"svc": codes, "v": torch.zeros(6, dtype=torch.int64)}, 6,
                    -2 ** 63, 2 ** 63 - 1, None, {}, state)
    assert state["c"].tolist() == [2, 0, 1, 1]


def test_one_program_per_chain_shape_across_feeds_and_polls():
    """A windowed stream polled many times (each poll a new window origin,
    several feeds a poll) lowers its chain into the same programs: after the
    first poll no new program appears."""
    from pixie_tpu_torch import flags

    saved = flags.get("PX_FEED_ROWS")
    flags.set_for_testing("PX_FEED_ROWS", 256)
    try:
        ts = TableStore()
        ts.create("http_events", Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                                             ("latency", DT.FLOAT64)), batch_rows=256)
        sq = stream_pxl("""
df = px.DataFrame(table='http_events').stream()
df = df[df.latency > 0.5]
df = df.rolling('1s').agg(cnt=('latency', px.count), m=('latency', px.mean))
px.display(df, 'out')
""", ts, device="cpu")
        rng = np.random.default_rng(2)
        counts = []
        for poll in range(6):
            t0 = poll * 2 * SEC
            ts.table("http_events").write({
                "time_": t0 + np.sort(rng.integers(0, 2 * SEC, 1000)),
                "service": rng.choice(["a", "b"], 1000).tolist(),
                "latency": rng.exponential(1.0, 1000)})
            sq.poll()
            counts.append(c1.stats["programs"])
        assert sq.stats["feeds"] >= 6 * 4
        assert counts[1:] == [counts[0]] * 5, counts
        assert sq.stats["chain_leaves"] == 0
    finally:
        flags.set_for_testing("PX_FEED_ROWS", saved)


# ------------------------------------------- the bench configs lower whole


def _http_store(n=20_000, seed=12):
    rng = np.random.default_rng(seed)
    ts = TableStore()
    ts.create("http_events", Relation.of(
        ("time_", DT.TIME64NS), ("service", DT.STRING), ("latency", DT.FLOAT64),
        ("status", DT.INT64)), batch_rows=4096).write({
            "time_": np.arange(n, dtype=np.int64) * 10_000_000,
            "service": np.array([f"svc-{i}" for i in range(16)])[rng.integers(0, 16, n)],
            "latency": rng.exponential(50.0, n),
            "status": rng.choice([200, 404, 500], n, p=[0.85, 0.05, 0.10])})
    return ts


def _http_plan(windowed_ns=None, quantiles=False):
    """bench.http_plan with the port's plan API."""
    P = port_plan
    p = P.Plan()
    node = p.add(P.FilterOp(expr=P.Call("not_equal", (P.Column("status"), P.lit(404)))),
                 parents=[p.add(P.MemorySourceOp(table="http_events"))])
    groups = ["service", "status"]
    if windowed_ns:
        node = p.add(P.MapOp(exprs=[
            ("time_", P.Call("bin", (P.Column("time_"), P.lit(windowed_ns)))),
            ("service", P.Column("service")), ("status", P.Column("status")),
            ("latency", P.Column("latency"))]), parents=[node])
        groups = ["time_", "service"]
    values = [P.AggExpr("cnt", "count", None), P.AggExpr("avg_lat", "mean", "latency"),
              P.AggExpr("p50", "p50", "latency")]
    if quantiles:
        values.append(P.AggExpr("p99", "p99", "latency"))
    agg = p.add(P.AggOp(groups=groups, values=values, windowed=bool(windowed_ns)),
                parents=[node])
    p.add(P.MemorySinkOp(name="output"), parents=[agg])
    return p


def test_bench_configs_lower_with_no_leaf():
    ts = _http_store()
    for plan in (_http_plan(), _http_plan(10 * SEC, quantiles=True)):  # configs #1, #2
        res = execute_plan(plan, ts, device="cpu")["output"]
        assert res.num_rows > 0 and res.exec_stats["chain_leaves"] == 0
    # config #3: sums per pod, joined with pods, sums per service
    P = port_plan
    rng = np.random.default_rng(5)
    ts3 = TableStore()
    ts3.create("network_stats", Relation.of(
        ("time_", DT.TIME64NS), ("pod_id", DT.STRING), ("rx_bytes", DT.INT64),
        ("tx_bytes", DT.INT64))).write({
            "time_": np.arange(5000, dtype=np.int64),
            "pod_id": [f"pod-{i}" for i in rng.integers(0, 32, 5000)],
            "rx_bytes": rng.integers(0, 1 << 20, 5000),
            "tx_bytes": rng.integers(0, 1 << 20, 5000)})
    ts3.create("pods", Relation.of(("pod_id", DT.STRING), ("service", DT.STRING))).write({
        "pod_id": [f"pod-{i}" for i in range(32)],
        "service": [f"svc-{i % 6}" for i in range(32)]})
    p = P.Plan()
    agg = p.add(P.AggOp(groups=["pod_id"], values=[P.AggExpr("rx", "sum", "rx_bytes"),
                                                   P.AggExpr("tx", "sum", "tx_bytes")]),
                parents=[p.add(P.MemorySourceOp(table="network_stats"))])
    join = p.add(P.JoinOp(how="inner", left_on=["pod_id"], right_on=["pod_id"], output=[
        ("left", "pod_id", "pod_id"), ("left", "rx", "rx"), ("left", "tx", "tx"),
        ("right", "service", "service")]),
        parents=[agg, p.add(P.MemorySourceOp(table="pods"))])
    agg2 = p.add(P.AggOp(groups=["service"], values=[P.AggExpr("rx", "sum", "rx"),
                                                     P.AggExpr("tx", "sum", "tx")]),
                 parents=[join])
    p.add(P.MemorySinkOp(name="output"), parents=[agg2])
    res = execute_plan(p, ts3, device="cpu")["output"]
    assert res.num_rows == 6 and res.exec_stats["chain_leaves"] == 0
    # config #4: bench's script through LocalCluster
    from pixie_tpu_torch.parallel import LocalCluster

    cluster = LocalCluster({"a": _http_store(seed=1), "b": _http_store(seed=2)},
                           device="cpu")
    res = cluster.query("""
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(df, 'output')
""")["output"]
    assert res.num_rows > 0
    assert all(a["chain_leaves"] == 0 for a in res.exec_stats["agents"].values())
    # config #5: bench's streaming script
    ts5 = TableStore()
    ts5.create("http_events", Relation.of(("time_", DT.TIME64NS), ("service_id", DT.INT64),
                                          ("latency", DT.FLOAT64)))
    sq = stream_pxl("""
df = px.DataFrame(table='http_events').stream()
df = df.rolling('10s').agg(cnt=('latency', px.count), p50=('latency', px.p50))
px.display(df, 'win')
""", ts5, device="cpu")
    ts5.table("http_events").write({"time_": np.arange(4000, dtype=np.int64) * 10 ** 7,
                                    "service_id": np.arange(4000) % 16,
                                    "latency": np.linspace(1, 100, 4000)})
    assert sq.poll() and sq.stats["chain_leaves"] == 0
    # compile_pxl is how the smoke's PxL phases reach the chain too
    q = compile_pxl("df = px.DataFrame(table='http_events')\npx.display(df, 'o')\n",
                    ts.schemas())
    assert execute_plan(q.plan, ts, device="cpu")["o"].exec_stats["chain_leaves"] == 0
