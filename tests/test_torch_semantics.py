"""Semantic types: pixie_tpu_torch.engine.semantics against pixie_tpu's.

The same PxL over tables declared with semantic types (latency
ST_DURATION_NS, service ST_SERVICE_NAME, time_ ST_TIME_NS, bytes ST_BYTES)
runs through both packages' entry points — `execute_plan`,
`LocalCluster.query`, `stream_pxl` and the cluster stream
(`ClusterStreamQuery`) — over stores written from the same numpy seeds.
Each result's relation must equal the reference's exactly: column names,
physical dtypes and semantic types.  The values agree as the other parity
files hold them (counts exactly, float sums to rtol 1e-12).

The UDFs and UDAs both packages register declare the same `out_st` and
`st_preserve` (what the propagation reads), overload by overload.
"""
from __future__ import annotations

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.engine import stream as ref_stream
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.parallel.streaming import ClusterStreamQuery as RefClusterStream
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation, SemanticType as RefST
from pixie_tpu.udf import registry as ref_registry

import pixie_tpu_torch.matview  # noqa: F401
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.engine import semantics
from pixie_tpu_torch.engine import stream as port_stream
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.parallel.streaming import ClusterStreamQuery
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation, SemanticType as ST
from pixie_tpu_torch.udf import registry as port_registry

SEC = 1_000_000_000
NOW = 1_700_000_000_000_000_000


@pytest.fixture(scope="module", autouse=True)
def _views_off():
    """The rescan route in both packages (standing views off)."""
    saved = [(f, f.get("PL_MATVIEW_ENABLED")) for f in (ref_flags, port_flags)]
    for f, _v in saved:
        f.set_for_testing("PL_MATVIEW_ENABLED", False)
    yield
    for f, v in saved:
        f.set_for_testing("PL_MATVIEW_ENABLED", v)


class Pkg:
    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.DT = DT if port else RefDT
        self.ST = ST if port else RefST
        self.Relation = Relation if port else RefRelation
        self.Store = TableStore if port else RefStore

    def http_rel(self):
        D, S = self.DT, self.ST
        return self.Relation.of(("time_", D.TIME64NS, S.ST_TIME_NS),
                                ("service", D.STRING, S.ST_SERVICE_NAME),
                                ("latency", D.FLOAT64, S.ST_DURATION_NS),
                                ("status", D.INT64),
                                ("bytes", D.INT64, S.ST_BYTES))

    def store(self, seed, n=3000, t0=None):
        ts = self.Store()
        rng = np.random.default_rng(seed)
        t0 = NOW - n * 1_000_000 if t0 is None else t0
        ts.create("http_events", self.http_rel(), batch_rows=1024).write({
            "time_": t0 + np.arange(n, dtype=np.int64) * 1_000_000,
            "service": rng.choice(["cart", "frontend", "checkout"], n).tolist(),
            "latency": rng.exponential(10.0, n),
            "status": rng.choice([200, 404, 500], n),
            "bytes": rng.integers(0, 1 << 20, n),
        })
        conn = self.Relation.of(("time_", self.DT.TIME64NS, self.ST.ST_TIME_NS),
                                ("service", self.DT.STRING, self.ST.ST_SERVICE_NAME),
                                ("rx", self.DT.INT64, self.ST.ST_BYTES))
        ts.create("conn_stats", conn, batch_rows=1024).write({
            "time_": t0 + np.arange(200, dtype=np.int64) * 1_000_000,
            "service": rng.choice(["cart", "frontend", "checkout"], 200).tolist(),
            "rx": rng.integers(0, 1000, 200),
        })
        return ts

    def execute(self, src, ts):
        if self.name == "port":
            q = compile_pxl(src, ts.schemas(), now=NOW)
            return execute_plan(q.plan, ts, device="cpu")
        q = ref_compile(src, ts.schemas(), now=NOW)
        return ref_execute(q.plan, ts)

    def cluster(self, stores):
        if self.name == "port":
            return LocalCluster(stores, device="cpu")
        return RefCluster(stores, n_devices_per_agent=1)

    def stream(self, src, ts):
        if self.name == "port":
            return port_stream.stream_pxl(src, ts, device="cpu")
        return ref_stream.stream_pxl(src, ts)

    def cstream(self, cluster, src):
        return (ClusterStreamQuery if self.name == "port" else RefClusterStream)(cluster, src)


PKGS = [Pkg("ref"), Pkg("port")]

SCRIPTS = {
    "agg": """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(
    n=('latency', px.count), m=('latency', px.mean), p=('latency', px.quantiles),
    p50=('latency', px.p50), mx=('bytes', px.max), lo=('time_', px.min))
px.display(df, 'out')
""",
    "select": """
df = px.DataFrame(table='http_events')
df = df[df.latency > 5.0]
df.kb = df.bytes / 1024
df.t = px.bin(df.time_, px.seconds(1))
df.later = df.time_ + 5
df = df[['t', 'later', 'service', 'latency', 'bytes', 'kb']]
px.display(df, 'out')
""",
    "window": """
df = px.DataFrame(table='http_events')
df.time_ = px.bin(df.time_, px.seconds(1))
df = df.groupby(['time_', 'service']).agg(s=('bytes', px.sum), lat=('latency', px.max))
px.display(df, 'out')
""",
    "join": """
a = px.DataFrame(table='http_events')
a = a.groupby('service').agg(lat=('latency', px.mean))
b = px.DataFrame(table='conn_stats')
b = b.groupby('service').agg(rx=('rx', px.sum))
j = a.merge(b, how='inner', left_on=['service'], right_on=['service'],
            suffixes=['', '_r'])
px.display(j, 'out')
""",
}


def _rel(res) -> list:
    return [(c.name, c.data_type.name, c.semantic_type.name) for c in res.relation]


def _frame(res):
    df = res.to_pandas()
    return df.sort_values(list(df.columns[:2])).reset_index(drop=True)


def _same_values(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in got.columns:
        g, w = got[c].to_numpy(), want[c].to_numpy()
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w.astype(np.float64), rtol=1e-12, err_msg=c)
        elif c not in ("p",):  # quantiles compared by the finalize parity files
            assert g.tolist() == w.tolist(), c


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_execute_plan_relation_equals_reference(script):
    out = {pk.name: pk.execute(SCRIPTS[script], pk.store(5))["out"] for pk in PKGS}
    assert _rel(out["port"]) == _rel(out["ref"])
    assert any(st != "ST_NONE" for _n, _d, st in _rel(out["port"]))
    _same_values(_frame(out["port"]), _frame(out["ref"]))


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_local_cluster_relation_equals_reference(script):
    out = {}
    for pk in PKGS:
        c = pk.cluster({f"pem{i}": pk.store(10 + i) for i in range(3)})
        out[pk.name] = c.query(SCRIPTS[script])["out"]
    assert _rel(out["port"]) == _rel(out["ref"])
    _same_values(_frame(out["port"]), _frame(out["ref"]))


def test_duration_quantiles_are_duration_quantiles():
    """quantiles of an ST_DURATION_NS column stamp ST_DURATION_NS_QUANTILES
    (the typespb type that exists for it); p50 of durations is a duration;
    a count is a plain number; a group key keeps its source's type."""
    c = PKGS[1].cluster({"pem0": PKGS[1].store(1)})
    sts = {c_.name: c_.semantic_type for c_ in c.query(SCRIPTS["agg"])["out"].relation}
    assert sts["p"] == ST.ST_DURATION_NS_QUANTILES
    assert sts["p50"] == sts["m"] == ST.ST_DURATION_NS
    assert sts["n"] == ST.ST_NONE and sts["service"] == ST.ST_SERVICE_NAME
    assert sts["mx"] == ST.ST_BYTES and sts["lo"] == ST.ST_TIME_NS


STREAM_SCRIPT = """
df = px.DataFrame(table='http_events').stream()
df = df.rolling('1s').agg(cnt=('latency', px.count), lat=('latency', px.max),
                           b=('bytes', px.sum))
px.display(df, 'win')
"""


def _stream_log(pk, make):
    """Relations and rows of every emission: 3 s of rows in 3 writes, a
    poll after each, then close."""
    ts_list, q = make(pk)
    rels, rows = [], 0
    for step in range(3):
        for i, ts in enumerate(ts_list):
            rng = np.random.default_rng(100 * step + i)
            n = 300
            ts.table("http_events").write({
                "time_": step * SEC + np.sort(rng.integers(0, SEC, n)),
                "service": rng.choice(["cart", "frontend"], n).tolist(),
                "latency": rng.exponential(5.0, n),
                "status": rng.choice([200, 500], n),
                "bytes": rng.integers(0, 4096, n),
            })
        for res in q.poll().values():
            rels.append(_rel(res))
            rows += res.num_rows
    for res in q.close().values():
        rels.append(_rel(res))
        rows += res.num_rows
    return rels, rows


def _empty_store(pk):
    ts = pk.Store()
    ts.create("http_events", pk.http_rel(), batch_rows=256)
    return ts


@pytest.mark.parametrize("where", ["single_store", "cluster"])
def test_stream_emissions_carry_the_references_types(where):
    def make(pk):
        if where == "single_store":
            ts = _empty_store(pk)
            return [ts], pk.stream(STREAM_SCRIPT, ts)
        stores = {f"pem{i}": _empty_store(pk) for i in range(2)}
        return list(stores.values()), pk.cstream(pk.cluster(stores), STREAM_SCRIPT)

    ref_rels, ref_rows = _stream_log(PKGS[0], make)
    port_rels, port_rows = _stream_log(PKGS[1], make)
    assert port_rels and port_rels == ref_rels
    assert port_rows == ref_rows
    assert dict((n, st) for n, _d, st in port_rels[0])["lat"] == "ST_DURATION_NS"


def test_restamp_and_sink_relation_agree_with_the_reference():
    """The plan walk itself: semantic_types of every op of a compiled plan
    equals the reference's, and restamp_result overwrites only STs."""
    from pixie_tpu.engine import semantics as ref_sem

    src = SCRIPTS["select"]
    port_ts, ref_ts = PKGS[1].store(3), PKGS[0].store(3)
    pq = compile_pxl(src, port_ts.schemas(), now=NOW)
    rq = ref_compile(src, ref_ts.schemas(), now=NOW)
    port_ops, ref_ops = pq.plan.topo_sorted(), rq.plan.topo_sorted()
    assert [o.kind for o in port_ops] == [o.kind for o in ref_ops]
    for po, ro in zip(port_ops, ref_ops):
        got = semantics.semantic_types(pq.plan, po, port_ts, port_registry)
        want = ref_sem.semantic_types(rq.plan, ro, ref_ts, ref_registry)
        assert {k: v.name for k, v in got.items()} == {k: v.name for k, v in want.items()}
    res = execute_plan(pq.plan, port_ts, device="cpu")["out"]
    res.relation = Relation([type(c)(c.name, c.data_type) for c in res.relation])
    semantics.restamp_result(res, pq.plan, semantics.SchemaStore(port_ts.schemas()),
                             port_registry)
    assert [c.semantic_type.name for c in res.relation] == [
        st for _n, _d, st in _rel(PKGS[0].execute(src, ref_ts)["out"])]


def _overloads(registry):
    out = {}
    for name, ovs in sorted(registry._scalar.items()):
        for o in ovs:
            key = (name, tuple(t.name for t in o.arg_types))
            out[key] = ((o.out_st.name if o.out_st is not None else None), bool(o.st_preserve))
    return out


def test_scalar_udfs_declare_the_references_semantic_types():
    """Every scalar overload the port registers declares the reference's
    out_st and st_preserve."""
    port, ref = _overloads(port_registry), _overloads(ref_registry)
    shared = set(port) & set(ref)
    assert len(shared) >= len(port) * 0.9
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    # the ST-carrying overloads the reference declares outside metadata/
    # (whose UDFs come with a later slice) are all in the port
    metadata = {k for k in ref if k[0] not in {n for n, _a in port}}
    carrying = {k for k, v in ref.items() if (v[0] or v[1]) and k not in metadata}
    assert carrying and carrying <= set(port)


@pytest.mark.parametrize("name", sorted(ref_registry.uda_names()))
def test_udas_declare_the_references_semantic_types(name):
    r, p = ref_registry.uda(name), port_registry.uda(name)
    assert (p.out_st.name if p.out_st is not None else None) == \
        (r.out_st.name if r.out_st is not None else None)
    assert bool(p.st_preserve) == bool(r.st_preserve)
