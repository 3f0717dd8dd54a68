"""Plans carried across: Plan.to_dict of the reference → the port's
Plan.from_dict → to_dict gives the same dict, and the port's explain()
renders it the same way."""
import pytest

import bench
import pixie_tpu  # noqa: F401
from pixie_tpu.compiler import compile_pxl
from pixie_tpu.types import DataType as DT, Relation

from pixie_tpu_torch.interop import plan_from_dict
from pixie_tpu_torch.plan import Plan

SCHEMAS = {
    "http_events": Relation.of(
        ("time_", DT.TIME64NS), ("service", DT.STRING), ("latency", DT.FLOAT64),
        ("status", DT.INT64), ("req_path", DT.STRING)),
}
NOW = 1_700_000_000_000_000_000

PXL = {
    "http_data": """
import px
df = px.DataFrame(table='http_events', start_time='-5m')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    cnt=('latency', px.count), avg_lat=('latency', px.mean),
    p50=('latency', px.p50))
px.display(df, 'out')
""",
    "windowed_quantiles": """
import px
df = px.DataFrame(table='http_events', start_time='-10m')
df.timestamp = px.bin(df.time_, px.seconds(10))
df = df.groupby(['timestamp', 'service']).agg(
    p50=('latency', px.p50), p99=('latency', px.p99))
px.display(df, 'out')
""",
    "map_filter_limit": """
import px
df = px.DataFrame(table='http_events', start_time='-1m')
df.slow = df.latency > 100.0
df = df[df.slow]
df.path = px.substring(df.req_path, 0, 4)
df = df.head(50)
px.display(df[['time_', 'service', 'path']], 'out')
""",
}


def _round_trip(ref_plan):
    d = ref_plan.to_dict()
    port = plan_from_dict(d)
    assert isinstance(port, Plan)
    assert port.to_dict() == d
    assert port.explain() == ref_plan.explain()


@pytest.mark.parametrize("kw", [{}, {"windowed_ns": 10_000_000_000},
                                {"windowed_ns": 10_000_000_000, "quantiles": True}])
def test_bench_http_plan_round_trip(kw):
    _round_trip(bench.http_plan(**kw))


@pytest.mark.parametrize("name", sorted(PXL))
def test_compiled_pxl_plan_round_trip(name):
    _round_trip(compile_pxl(PXL[name], SCHEMAS, now=NOW).plan)
