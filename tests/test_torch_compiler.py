"""The PxL compiler: pixie_tpu_torch against pixie_tpu.

The cases of tests/test_compiler.py that need no metadata, UDTF, union or
OTel objects, plus bench config #4's script and config #2's windowed
quantiles from PxL text: each script compiles in both packages to an equal
`Plan.to_dict()`, and each plan runs through both packages' executors (the
reference on the JAX CPU, the port with device="cpu") to equal results:
counts, ints, strings and sketch quantiles exactly, float64 to rtol 1e-12.
The restricted-dialect and error cases raise the same CompilerError (or NameError) in
both.  The metadata and UDTF cases are tests/test_torch_metadata.py's and
tests/test_torch_udtf.py's; the OTel cases wait for their slice.
"""
import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.status import CompilerError as RefCompilerError
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, UInt128 as RefU128

from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.plan.plan import LimitOp, MapOp, MemorySourceOp
from pixie_tpu_torch.status import CompilerError, Unimplemented
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation, UInt128

N = 4000
NOW = 1_700_000_000_000_000_000


def _cols(u128):
    rng = np.random.default_rng(3)
    upids = [u128.make_upid(1, 100 + i, 5000 + i) for i in range(4)]
    return {
        "time_": NOW - np.arange(N, dtype=np.int64)[::-1] * 1_000_000,
        "upid": rng.choice(upids, N).tolist(),
        "service": rng.choice(["cart", "checkout", "frontend"], N).tolist(),
        "req_path": rng.choice(["/api/a", "/api/b", "/healthz"], N).tolist(),
        "remote_addr": rng.choice(["10.0.0.1", "10.0.0.2", "8.8.8.8"], N).tolist(),
        "latency": rng.exponential(20.0, N),
        "resp_status": rng.choice([200, 404, 500], N, p=[0.7, 0.2, 0.1]),
        "trace_role": rng.choice([1, 2], N),
    }


def _store(ts, rel_cls, dt, u128):
    rel = rel_cls.of(
        ("time_", dt.TIME64NS), ("upid", dt.UINT128), ("service", dt.STRING),
        ("req_path", dt.STRING), ("remote_addr", dt.STRING),
        ("latency", dt.FLOAT64), ("resp_status", dt.INT64), ("trace_role", dt.INT64))
    ts.create("http_events", rel, batch_rows=2048).write(_cols(u128))
    return ts


@pytest.fixture(scope="module")
def stores():
    return (_store(RefStore(), RefRelation, RefDT, RefU128),
            _store(TableStore(), Relation, DT, UInt128))


def _sorted(res):
    df = res.to_pandas()
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def run_both(stores, src, sink="output", sort=True, **kw):
    """Compile in both packages (equal plan dicts), run both plans; → (port
    QueryResult, port CompiledQuery) after holding the results equal."""
    ref_ts, ts = stores
    rq = ref_compile(src, ref_ts.schemas(), now=NOW, **kw)
    q = compile_pxl(src, ts.schemas(), now=NOW, **kw)
    assert q.plan.to_dict() == rq.plan.to_dict()
    assert q.sink_names == rq.sink_names and q.now_sensitive == rq.now_sensitive
    want = ref_execute(rq.plan, ref_ts)[sink]
    got = execute_plan(q.plan, ts, device="cpu")[sink]
    assert got.relation.names() == want.relation.names()
    assert [int(c.data_type) for c in got.relation] == [int(c.data_type) for c in want.relation]
    g, w = (_sorted(got), _sorted(want)) if sort else (got.to_pandas(), want.to_pandas())
    assert len(g) == len(w)
    for c in g.columns:
        a, b = g[c].to_numpy(), w[c].to_numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=c)
        else:
            assert [str(x) for x in a] == [str(x) for x in b], c
    return got, q


def test_filter_groupby_count(stores):
    src = """
import px
df = px.DataFrame(table='http_events', start_time='-1h')
df = df[df.resp_status != 200]
df = df.groupby(['service', 'resp_status']).agg(cnt=('latency', px.count))
px.display(df, 'out')
"""
    got, q = run_both(stores, src, sink="out")
    assert q.now_sensitive and int(got.to_pandas().cnt.sum()) > 0


def test_column_assignment_and_projection(stores):
    src = """
import px
df = px.DataFrame(table='http_events')
df.latency_ms = df.latency / 1000.0
df.is_error = df.resp_status >= 400
df = df['time_', 'service', 'latency_ms', 'is_error']
px.display(df)
"""
    got, q = run_both(stores, src)
    assert got.relation.names() == ["time_", "service", "latency_ms", "is_error"]
    assert len([o for o in q.plan.ops() if isinstance(o, MapOp)]) == 1


def test_column_pruning_narrows_source(stores):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(cnt=('latency', px.count))
px.display(df)
"""
    _got, q = run_both(stores, src)
    assert [o for o in q.plan.ops() if isinstance(o, MemorySourceOp)][0].columns == ["service"]


def test_select_and_string_fns(stores):
    src = """
import px
df = px.DataFrame(table='http_events')
df.bucket = px.select(df.resp_status >= 400, 'error', 'ok')
df = df[px.contains(df.req_path, 'api')]
df = df.groupby('bucket').agg(cnt=('time_', px.count))
px.display(df)
"""
    run_both(stores, src)


def test_head_and_default_limit(stores):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df.head(17)
px.display(df)
"""
    got, _q = run_both(stores, src, sort=False)
    assert got.num_rows == 17
    src2 = """
import px
df = px.DataFrame(table='http_events')
px.display(df)
"""
    got2, q2 = run_both(stores, src2, sort=False, default_limit=100)
    limits = [o for o in q2.plan.ops() if isinstance(o, LimitOp)]
    assert limits and limits[0].n == 100 and got2.num_rows == 100


def test_merge_and_agg_math(stores):
    src = """
import px
df = px.DataFrame(table='http_events')
tw = df.agg(t_min=('time_', px.min), t_max=('time_', px.max))
tw.join_key = 1
tw.span = tw.t_max - tw.t_min
stats = df.groupby('service').agg(total=('latency', px.sum), cnt=('time_', px.count))
stats.join_key = 1
out = stats.merge(tw, how='inner', left_on='join_key', right_on='join_key')
out = out.drop(['join_key_x', 'join_key_y', 't_min', 't_max'])
px.display(out)
"""
    got, _q = run_both(stores, src)
    assert (got.to_pandas().span == (N - 1) * 1_000_000).all()


def test_rolling_windowed_agg(stores):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df.rolling('1s').groupby('service').agg(cnt=('time_', px.count))
px.display(df)
"""
    got, _q = run_both(stores, src)
    assert int(got.to_pandas().cnt.sum()) == N


def test_windowed_quantiles_from_pxl(stores):
    """Config #2's shape from PxL text: px.bin over the time column (a
    window key) with per-window quantiles."""
    src = """
import px
df = px.DataFrame(table='http_events')
df = df[df.resp_status != 404]
df.timestamp = px.bin(df.time_, px.DurationNanos(500 * 1000 * 1000))
df = df.groupby(['timestamp', 'service']).agg(
    cnt=('latency', px.count), p50=('latency', px.p50), p99=('latency', px.p99))
px.display(df)
"""
    got, _q = run_both(stores, src)
    assert got.num_rows > 0


def test_bench_config4_script(stores):
    """bench.py config #4's script, as LocalCluster.query compiles it (no
    `import px`: px is in the script's namespace)."""
    src = """
df = px.DataFrame(table='http_events')
df = df[df.resp_status != 404]
df = df.groupby(['service', 'resp_status']).agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(df, 'output')
"""
    got, q = run_both(stores, src)
    assert not q.now_sensitive and got.num_rows == 6


def test_function_script_with_args(stores):
    src = """
import px

def http_data(start_time: str, status_min: int, num_head: int):
    df = px.DataFrame(table='http_events', start_time=start_time)
    df = df[df.resp_status >= status_min]
    df = df.head(num_head)
    return df
"""
    got, _q = run_both(stores, src, sort=False, func="http_data",
                       func_args={"start_time": "-30m", "status_min": "400",
                                  "num_head": "25"})
    assert got.num_rows == 25


def test_time_range(stores):
    src = """
import px
df = px.DataFrame(table='http_events', start_time='-1s')
df = df.agg(cnt=('time_', px.count))
px.display(df)
"""
    got, _q = run_both(stores, src)
    assert int(got.to_pandas().cnt[0]) == 1001  # times NOW - 1s .. NOW, inclusive


def test_left_join_null_keys_dropped_in_groupby():
    src = """
import px
l = px.DataFrame(table='l')
r = px.DataFrame(table='r')
j = l.merge(r, how='left', left_on='k', right_on='k')
out = j.groupby('owner').agg(cnt=('time_', px.count))
px.display(out)
"""
    pair = []
    for ts, rel_cls, dt in ((RefStore(), RefRelation, RefDT), (TableStore(), Relation, DT)):
        ts.create("l", rel_cls.of(("time_", dt.TIME64NS), ("k", dt.STRING))).write(
            {"time_": np.arange(3, dtype=np.int64), "k": ["a", "b", "c"]})
        ts.create("r", rel_cls.of(("k", dt.STRING), ("owner", dt.STRING))).write(
            {"k": ["a"], "owner": ["team-x"]})
        pair.append(ts)
    got, _q = run_both(tuple(pair), src)
    out = got.to_pandas()
    assert dict(zip(out.owner, out.cnt)) == {"team-x": 1}


def test_min_time_keeps_time_dtype(stores):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df.agg(first=('time_', px.min))
px.display(df)
"""
    got, _q = run_both(stores, src)
    assert got.relation.dtype("first") == DT.TIME64NS


def test_nullary_count_after_projection(stores):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df[['service']]
df = df.agg(cnt=('service', px.count))
px.display(df)
"""
    got, _q = run_both(stores, src)
    assert int(got.to_pandas().cnt[0]) == N


def test_column_reassignment_keeps_order(stores):
    src = """
import px
df = px.DataFrame(table='http_events')
df = df['time_', 'service', 'latency']
df.service = px.to_upper(df.service)
px.display(df)
"""
    got, _q = run_both(stores, src)
    assert got.relation.names() == ["time_", "service", "latency"]


def _same_error(stores, src, port_exc, ref_exc):
    ref_ts, ts = stores
    with pytest.raises(ref_exc) as want:
        ref_compile(src, ref_ts.schemas(), now=NOW)
    with pytest.raises(port_exc) as got:
        compile_pxl(src, ts.schemas(), now=NOW)
    assert str(got.value) == str(want.value)


RESTRICTED = [
    ("import os\n", "compiler"),
    ("open('/etc/passwd')\n", "name"),
    ("x = ().__class__.__base__.__subclasses__()\n", "compiler"),
    ("x = __builtins__\n", "compiler"),
    ("while True:\n    pass\n", "compiler"),
    ("with open('x') as f:\n    pass\n", "compiler"),
    ("try:\n    x = 1\nexcept Exception:\n    pass\n", "compiler"),
    ("class A:\n    pass\n", "compiler"),
    ("global x\n", "compiler"),
    ("x = '{0.a}'.format(1)\n", "compiler"),
    ("x = format(1, 'd')\n", "name"),
]


@pytest.mark.parametrize("src,kind", RESTRICTED)
def test_script_dialect_restrictions(stores, src, kind):
    if kind == "name":
        _same_error(stores, src, NameError, NameError)
    else:
        _same_error(stores, src, CompilerError, RefCompilerError)


@pytest.mark.parametrize("src", [
    "import px\ndf = px.DataFrame(table='nope')\npx.display(df)",
    "import px\nx = 1\n",
    "import px\ndf = px.DataFrame(table='http_events')\ndf = df[df.latency]\npx.display(df)",
])
def test_errors(stores, src):
    _same_error(stores, src, CompilerError, RefCompilerError)


def test_unported_px_surfaces_raise_unimplemented(stores):
    _ref_ts, ts = stores
    for src in ("import px\nx = px.otel\n",
                "import pxtrace\n"):
        with pytest.raises(Unimplemented):
            compile_pxl(src, ts.schemas(), now=NOW)
    # px.asid() reads the port's metadata state
    compile_pxl("import px\ndf = px.DataFrame(table='http_events')\ndf.a = px.asid()\n"
                "px.display(df)\n", ts.schemas(), now=NOW)
