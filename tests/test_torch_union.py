"""Unions: the port's UnionOp against the reference's, through both
packages' execute_plan (device="cpu" for the port) and LocalCluster.

tests/test_executor.py `test_union` (a plan: two filtered scans of one table
into a sink) and tests/test_compiler.py `test_append_union` (PxL
`a.append(b)` grouped by a column) run through both packages over the same
rows; so do a union of two tables whose dictionaries hold different values
(each parent's codes map onto a copy of the first parent's dictionary,
which gains the values it lacks: `translate_to(..., insert=True)`), a union
fed straight from two scans, and the distributed union over agents with
private dictionaries.  Rows compare as sorted records, exactly; aggregates
exactly, the mean to rtol 1e-12.
"""
import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.plan import Call, Column, FilterOp, MemorySinkOp, MemorySourceOp, Plan, lit
from pixie_tpu.plan.plan import UnionOp
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation

import pixie_tpu_torch.interop as interop
import pixie_tpu_torch.matview  # noqa: F401  (defines PL_MATVIEW_ENABLED)
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation

NOW = 1_700_000_000_000_000_000
N = 6000


@pytest.fixture(autouse=True)
def _views_off():
    """Each query runs once: the reference without standing views and
    tracing, as every parity file runs it, and the port alike."""
    saved = {f: ref_flags.get(f) for f in ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")}
    port_saved = port_flags.get("PL_MATVIEW_ENABLED")
    for f in saved:
        ref_flags.set_for_testing(f, False)
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    yield
    for f, v in saved.items():
        ref_flags.set_for_testing(f, v)
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", port_saved)


def _cols(seed: int, services, n: int = N) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "time_": NOW - np.arange(n, dtype=np.int64)[::-1] * 1_000_000,
        "service": rng.choice(services, n).tolist(),
        "latency": rng.exponential(10.0, n),
        "status": rng.choice([200, 404, 500], n),
    }


def _stores(tables: dict, batch_rows: int = 1024):
    """(reference store, port store) holding the same tables."""
    ref, port = RefStore(), TableStore()
    for ts, rel_cls, dt in ((ref, RefRelation, RefDT), (port, Relation, DT)):
        rel = rel_cls.of(("time_", dt.TIME64NS), ("service", dt.STRING),
                         ("latency", dt.FLOAT64), ("status", dt.INT64))
        for name, cols in tables.items():
            ts.create(name, rel, batch_rows=batch_rows).write(
                {k: (v.copy() if isinstance(v, np.ndarray) else list(v))
                 for k, v in cols.items()})
    return ref, port


@pytest.fixture(scope="module")
def stores():
    return _stores({"http_events": _cols(1, ["cart", "auth", "web"])})


def _records(res) -> list:
    return sorted(tuple(r.values()) for r in res.to_records())


def assert_same(got, want, by):
    """Equal results sorted by `by`: floats to rtol 1e-12, else exactly."""
    g = got.to_pandas().sort_values(by).reset_index(drop=True)
    w = want.to_pandas().sort_values(by).reset_index(drop=True)
    assert list(g.columns) == list(w.columns) and len(g) == len(w)
    for c in g.columns:
        if g[c].dtype.kind == "f":
            np.testing.assert_allclose(g[c].to_numpy(), w[c].to_numpy(), rtol=1e-12,
                                       atol=0, err_msg=c)
        else:
            assert g[c].tolist() == w[c].tolist(), c


def _union_plan(left="http_events", right="http_events", a=404, b=500):
    p = Plan()
    s1 = p.add(MemorySourceOp(table=left))
    f1 = p.add(FilterOp(expr=Call("equal", (Column("status"), lit(a)))), parents=[s1])
    s2 = p.add(MemorySourceOp(table=right))
    f2 = p.add(FilterOp(expr=Call("equal", (Column("status"), lit(b)))), parents=[s2])
    u = p.add(UnionOp(), parents=[f1, f2])
    p.add(MemorySinkOp(name="output"), parents=[u])
    return p


def _both_plan(stores, plan, sink="output"):
    ref, port = stores
    want = ref_execute(plan, ref)[sink]
    got = execute_plan(interop.plan_from_dict(plan.to_dict()), port, device="cpu")[sink]
    return got, want


def _both_pxl(stores, src, sink="output"):
    ref, port = stores
    want = ref_execute(ref_compile(src, ref.schemas(), now=NOW).plan, ref)[sink]
    got = execute_plan(compile_pxl(src, port.schemas(), now=NOW).plan, port,
                       device="cpu")[sink]
    return got, want


def test_union(stores):
    """tests/test_executor.py: two filtered scans of one table."""
    got, want = _both_plan(stores, _union_plan())
    cols = _cols(1, ["cart", "auth", "web"])
    assert got.num_rows == int(np.isin(cols["status"], [404, 500]).sum())
    assert got.relation.names() == want.relation.names()
    assert _records(got) == _records(want)


def test_append_union(stores):
    """tests/test_compiler.py: PxL append, grouped by a column."""
    src = """
import px
a = px.DataFrame(table='http_events')
a = a[a.status == 200]
b = px.DataFrame(table='http_events')
b = b[b.status == 500]
u = a.append(b)
u = u.groupby('status').agg(cnt=('time_', px.count))
px.display(u)
"""
    got, want = _both_pxl(stores, src)
    cols = _cols(1, ["cart", "auth", "web"])
    exp = {s: int((cols["status"] == s).sum()) for s in (200, 500)}
    assert dict(zip(got.decoded("status"), got.decoded("cnt"))) == exp
    assert_same(got, want, ["status"])


def test_union_of_unfiltered_scans(stores):
    """A union whose parents are bare scans (no chain): each parent is
    materialized whole."""
    p = Plan()
    s1 = p.add(MemorySourceOp(table="http_events", columns=["service", "status"]))
    s2 = p.add(MemorySourceOp(table="http_events", columns=["service", "status"]))
    u = p.add(UnionOp(), parents=[s1, s2])
    p.add(MemorySinkOp(name="output"), parents=[u])
    got, want = _both_plan(stores, p)
    assert got.num_rows == 2 * N
    assert _records(got) == _records(want)


@pytest.fixture(scope="module")
def differing():
    """Two tables whose dictionaries hold different values (and the shared
    ones at different codes)."""
    return _stores({"a_events": _cols(2, ["cart", "auth"]),
                    "b_events": _cols(3, ["web", "pay", "auth"])})


def test_union_of_differing_dictionaries(differing):
    got, want = _both_plan(differing, _union_plan("a_events", "b_events", 200, 500))
    assert _records(got) == _records(want)
    values = got.dictionaries["service"].values()
    # the first parent's values keep their codes; the second's new ones follow
    assert values[:2] == differing[1].table("a_events").dictionaries["service"].values()
    assert sorted(values) == ["auth", "cart", "pay", "web"]


def test_union_of_differing_dictionaries_into_an_aggregate(differing):
    src = """
import px
a = px.DataFrame(table='a_events')
a = a[a.status == 200]
b = px.DataFrame(table='b_events')
b = b[b.status != 200]
u = a.append(b)
u = u.groupby('service').agg(cnt=('latency', px.count), avg=('latency', px.mean),
                             hi=('latency', px.max))
px.display(u)
"""
    got, want = _both_pxl(differing, src)
    assert sorted(got.decoded("service")) == ["auth", "cart", "pay", "web"]
    assert_same(got, want, ["service"])


def test_distributed_union_over_private_dictionaries():
    """Agents with private code spaces: each agent's parents ship as rows,
    the merger unions them and aggregates."""
    tables = {a: _cols(10 + i, s) for i, (a, s) in
              enumerate({"pem0": ["cart"], "pem1": ["web", "cart"]}.items())}
    ref = RefCluster({a: _stores({"http_events": c})[0] for a, c in tables.items()},
                     n_devices_per_agent=1)
    port = LocalCluster({a: _stores({"http_events": c})[1] for a, c in tables.items()},
                        device="cpu")
    src = """
import px
a = px.DataFrame(table='http_events')
a = a[a.status == 404]
b = px.DataFrame(table='http_events')
b = b[b.status == 500]
u = a.append(b)
u = u.groupby(['service', 'status']).agg(cnt=('latency', px.count),
                                         avg=('latency', px.mean))
px.display(u)
"""
    rq = ref_compile(src, ref.schemas(), now=NOW)
    pq = compile_pxl(src, port.schemas(), now=NOW)
    assert port.planner.plan(pq.plan).to_dict() == ref.planner.plan(rq.plan).to_dict()
    got, want = port.execute(pq.plan)["output"], ref.execute(rq.plan)["output"]
    assert_same(got, want, ["service", "status"])
    assert sorted(set(got.decoded("service"))) == ["cart", "web"]
