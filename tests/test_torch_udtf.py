"""The port's UDTF sources (udf/udtf.py, PlanExecutor._run_udtf, px.<UDTF>())
against the reference's: the 8 introspection UDTFs' frames over the same
store, exactly, through each package's compile_pxl and executor, and
through the port's LocalCluster (merger scope, its schema catalog).  The
port's scalar and UDTF name sets equal the reference's (135 and 8)."""
from __future__ import annotations

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (JAX first: x64 on)
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.metadata import state as ref_state
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RDT, Relation as RRel
from pixie_tpu.udf import registry as ref_registry
from pixie_tpu.udf.udtf import UDTFContext as RefContext

from pixie_tpu_torch import flags
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.engine.executor import PlanExecutor
from pixie_tpu_torch.metadata import state as md_state
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation
from pixie_tpu_torch.udf import registry
from pixie_tpu_torch.udf.udtf import UDTFContext

UDTFS = ["GetAgentStatus", "GetDebugTableInfo", "GetSchemas", "GetTables",
         "GetTracepointStatus", "GetUDAList", "GetUDFList", "GetUDTFList"]


def _fill(store, Rel, T):
    store.create("http_events", Rel.of(("time_", T.TIME64NS), ("service", T.STRING),
                                       ("latency", T.INT64)), batch_rows=64).write(
        {"time_": np.arange(200, dtype=np.int64), "service": ["a", "b"] * 100,
         "latency": np.arange(200, dtype=np.int64)})
    store.create("conns", Rel.of(("time_", T.TIME64NS), ("bytes", T.FLOAT64))).write(
        {"time_": np.arange(10, dtype=np.int64), "bytes": np.ones(10)})
    return store


@pytest.fixture
def same_state():
    old_r, old_t = ref_state.global_manager(), md_state.global_manager()
    ref_state.set_global_manager(ref_state.MetadataStateManager(asid=4, node_name="node-4"))
    md_state.set_global_manager(md_state.MetadataStateManager(asid=4, node_name="node-4"))
    try:
        yield
    finally:
        ref_state.set_global_manager(old_r)
        md_state.set_global_manager(old_t)


def _script(name: str) -> str:
    return f"import px\ndf = px.{name}()\npx.display(df, 'o')\n"


def _rows(res) -> list:
    df = res.to_pandas()
    return [tuple(str(v) for v in row) for row in df.itertuples(index=False)]


def test_name_sets_equal_the_references():
    got, want = registry.names(), ref_registry.names()
    assert got["scalar"] == want["scalar"] and len(got["scalar"]) == 135
    assert got["udtf"] == want["udtf"] == UDTFS
    assert got["uda"] == want["uda"]


@pytest.mark.parametrize("name", UDTFS)
def test_udtf_frame_equals_the_references(name, same_state):
    """px.<UDTF>() through compile_pxl and execute_plan: the same relation
    and the same rows, in order."""
    rs, ts = _fill(RefStore(), RRel, RDT), _fill(TableStore(), Relation, DT)
    want = ref_execute(ref_compile(_script(name), rs.schemas()).plan, rs)["o"]
    got = execute_plan(compile_pxl(_script(name), ts.schemas()).plan, ts, device="cpu")["o"]
    assert [(c.name, c.data_type.name) for c in got.relation] == [
        (c.name, c.data_type.name) for c in want.relation]
    assert got.num_rows == want.num_rows > (0 if name != "GetTracepointStatus" else -1)
    assert _rows(got) == _rows(want)


def test_udtf_context_from_the_caller(same_state):
    """A UDTFContext passed to the executor wins over the local view: a
    schema catalog answers GetTables when no store is given."""
    from pixie_tpu.engine.executor import PlanExecutor as RefExecutor

    cat = {"x": Relation.of(("a", DT.INT64)), "y": Relation.of(("b", DT.STRING))}
    ref_cat = {"x": RRel.of(("a", RDT.INT64)), "y": RRel.of(("b", RDT.STRING))}
    ts, rs = TableStore(), RefStore()
    q = compile_pxl(_script("GetSchemas"), {})
    got = PlanExecutor(q.plan, ts, device="cpu",
                       udtf_ctx=UDTFContext(registry=registry, schema_catalog=cat)).run()["o"]
    rq = ref_compile(_script("GetSchemas"), {})
    want = RefExecutor(rq.plan, rs, udtf_ctx=RefContext(registry=ref_registry,
                                                       schema_catalog=ref_cat)).run()["o"]
    assert _rows(got) == _rows(want) and got.num_rows == 2


def test_udtf_feeds_a_chain_and_an_aggregate(same_state):
    """A UDTF's batch is a blocking source like any other: a filter and a
    group by over GetSchemas' rows, equal to the reference's."""
    src = """
import px
df = px.GetSchemas()
df = df[df.column_type == 'INT64']
df = df.groupby('table_name').agg(n=('column_name', px.count))
px.display(df, 'o')
"""
    rs, ts = _fill(RefStore(), RRel, RDT), _fill(TableStore(), Relation, DT)
    want = ref_execute(ref_compile(src, rs.schemas()).plan, rs)["o"].to_pandas()
    got = execute_plan(compile_pxl(src, ts.schemas()).plan, ts, device="cpu")["o"].to_pandas()
    key = "table_name"
    assert (got.sort_values(key).values.tolist() == want.sort_values(key).values.tolist()
            == [["http_events", 1]])


def test_cluster_udtfs_and_context_helpers(same_state):
    """Through a 2-agent LocalCluster the UDTFs run on the merger with the
    agents' schema catalog, and px.asid() / px.node_name() fold from the
    snapshot; GetUDFList lists every one of the 135 scalar names."""
    from pixie_tpu.parallel import LocalCluster as RefCluster
    from pixie_tpu_torch.parallel import LocalCluster

    src = """
import px
px.display(px.GetAgentStatus(), 'agents')
px.display(px.GetTables(), 'tables')
px.display(px.GetSchemas(), 'schemas')
px.display(px.GetUDFList(), 'udfs')
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(cnt=('latency', px.count))
df.asid = px.asid()
df.node = px.node_name()
px.display(df, 'ctx')
"""
    import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
    import pixie_tpu_torch.matview  # noqa: F401  (defines PL_MATVIEW_ENABLED)
    from pixie_tpu import flags as ref_flags

    saved = {f: ref_flags.get(f) for f in ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")}
    port_saved = {f: flags.get(f) for f in ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")}
    for f in saved:
        ref_flags.set_for_testing(f, False)
        flags.set_for_testing(f, False)
    try:
        got = LocalCluster({f"pem{i}": _fill(TableStore(), Relation, DT) for i in range(2)},
                           device="cpu").query(src)
        want = RefCluster({f"pem{i}": _fill(RefStore(), RRel, RDT) for i in range(2)},
                          n_devices_per_agent=1).query(src)
    finally:
        for f, v in saved.items():
            ref_flags.set_for_testing(f, v)
        for f, v in port_saved.items():
            flags.set_for_testing(f, v)
    for sink in ("agents", "tables", "schemas", "udfs"):
        assert [c.name for c in got[sink].relation] == [c.name for c in want[sink].relation]
        assert _rows(got[sink]) == _rows(want[sink]), sink
    assert len(set(got["udfs"].to_pandas()["name"])) == 135
    assert got["tables"].to_pandas()["table_name"].tolist() == ["conns", "http_events"]
    ctx = got["ctx"].to_pandas().sort_values("service")
    assert ctx["asid"].tolist() == [4, 4] and ctx["node"].tolist() == ["node-4"] * 2
    assert ctx["cnt"].tolist() == [200, 200]
