"""Model-fitting aggregates through the executor: pixie_tpu_torch against
pixie_tpu.

Every case of tests/test_fit_udas.py runs through both packages'
`compile_pxl` + `execute_plan` (the reference on the JAX CPU, the port with
device="cpu"): equal `Plan.to_dict()`, and equal results — clustering models
as equal JSON strings, k-means centroids within 1e-4 (the model JSON rounds
to 6 decimals; the port sums Lloyd's centers in float64, the reference in
float32) with JAX's uniforms fed through the port's draw function
(tests/test_torch_ml.py says how).  The DictHist state (K1's count over
gid * 256 + code; int64 where the reference's is int32) holds the same
values, sentinel and overflow codes dropped, and merges by "add".  Each fit
UDA also runs through both packages' LocalCluster over 4 agent stores (one
device per agent for the reference, views and tracing off), with the same
distributed split and results.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.ml.fit import RequestPathClusteringFitUDA as RefRPFit
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.status import Unimplemented as RefUnimplemented
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation

from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.ml import kmeans as km
from pixie_tpu_torch.ml.fit import KMeansFitUDA, RequestPathClusteringFitUDA
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.status import Internal, Unimplemented
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation

NOW = 1_700_000_000_000_000_000
SENTINEL = int(np.iinfo(np.int32).max)


def _http_cols(seed=11, n=3000, services=("cart", "web")):
    rng = np.random.default_rng(seed)
    paths = [f"/api/v1/products/sku-{i % 40}" for i in range(n)]
    for i in range(0, n, 7):
        paths[i] = "/healthz"
    return {
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "service": rng.choice(list(services), n).tolist(),
        "req_path": paths,
        "latency": rng.exponential(10.0, n),
    }


def _emb_cols(seed=3, n=600):
    rng = np.random.default_rng(seed)
    centers = np.array([[0.0, 0.0], [30.0, 30.0]])
    pts = centers[rng.integers(0, 2, n)] + rng.normal(0, 0.3, (n, 2))
    return {
        "time_": np.arange(n, dtype=np.int64),
        "embedding": [json.dumps([round(float(a), 3) for a in p]) for p in pts],
    }


def _http_store(pkg, cols):
    ts, rel_cls, dt = ((RefStore(), RefRelation, RefDT) if pkg == "ref"
                       else (TableStore(), Relation, DT))
    rel = rel_cls.of(("time_", dt.TIME64NS), ("service", dt.STRING),
                     ("req_path", dt.STRING), ("latency", dt.FLOAT64))
    ts.create("http_events", rel, batch_rows=1024).write(dict(cols))
    return ts


def _emb_store(pkg, cols):
    ts, rel_cls, dt = ((RefStore(), RefRelation, RefDT) if pkg == "ref"
                       else (TableStore(), Relation, DT))
    rel = rel_cls.of(("time_", dt.TIME64NS), ("embedding", dt.STRING))
    ts.create("embs", rel, batch_rows=512).write(dict(cols))
    return ts


@pytest.fixture(scope="module")
def stores():
    cols = _http_cols()
    return _http_store("ref", cols), _http_store("port", cols)


@pytest.fixture(scope="module")
def emb_stores():
    cols = _emb_cols()
    return _emb_store("ref", cols), _emb_store("port", cols)


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's k-means++ draws become the reference's (PRNGKey(seed),
    split once per draw), for any k."""
    def uniforms(gen, shape, device):
        key = jax.random.PRNGKey(gen.initial_seed())
        k0, key = jax.random.split(key)
        us = [jax.random.uniform(k0, (), dtype=jnp.float32)]
        for _ in range(1, shape[0]):
            kc, key = jax.random.split(key)
            us.append(jax.random.uniform(kc, (), dtype=jnp.float32))
        return torch.tensor(np.array(us, dtype=np.float32), device=device)

    monkeypatch.setattr(km, "_uniforms", uniforms)


def _values(res, name):
    return res.decoded(name) if name in res.dictionaries else res.columns[name].tolist()


def run_both(pair, src, sink="out"):
    """(port result, reference result) after holding the plans equal and the
    relations equal."""
    ref_ts, ts = pair
    rq = ref_compile(src, ref_ts.schemas(), now=NOW)
    q = compile_pxl(src, ts.schemas(), now=NOW)
    assert q.plan.to_dict() == rq.plan.to_dict()
    want = ref_execute(rq.plan, ref_ts)[sink]
    got = execute_plan(q.plan, ts, device="cpu")[sink]
    assert got.relation.names() == want.relation.names()
    assert [int(c.data_type) for c in got.relation] == [int(c.data_type) for c in want.relation]
    return got, want


def _centroids(res):
    return [np.asarray(json.loads(m)["centroids"]) for m in res.decoded("model")]


CLUSTER_NONE = """
import px
df = px.DataFrame(table='http_events', start_time=0)
df = df.agg(clustering=('req_path', px._build_request_path_clusters))
px.display(df, 'out')
"""
SERVICE_ENDPOINTS = """
import px
df = px.DataFrame(table='http_events', start_time=0)
cl = df.agg(clustering=('req_path', px._build_request_path_clusters))
m = df.merge(cl, how='outer', left_on=[], right_on=[], suffixes=['', ''])
m.endpoint = px._predict_request_path_cluster(m.req_path, m.clustering)
m = m.groupby('endpoint').agg(n=('latency', px.count))
px.display(m, 'out')
"""
CLUSTER_GROUPED = """
import px
df = px.DataFrame(table='http_events', start_time=0)
df = df.groupby('service').agg(clustering=('req_path', px._build_request_path_clusters))
px.display(df, 'out')
"""
KMEANS_NONE = """
import px
df = px.DataFrame(table='embs', start_time=0)
df = df.agg(model=('embedding', px._kmeans_fit))
px.display(df, 'out')
"""


def test_build_request_path_clusters_group_by_none(stores):
    got, want = run_both(stores, CLUSTER_NONE)
    assert got.num_rows == 1
    assert _values(got, "clustering") == _values(want, "clustering")
    templates = {c["template"] for c in json.loads(got.decoded("clustering")[0])}
    assert {"/api/v1/products/*", "/healthz"} <= templates


def test_clustering_feeds_predict_udf_like_service_endpoints(stores):
    got, want = run_both(stores, SERVICE_ENDPOINTS)
    g = dict(zip(got.decoded("endpoint"), got.columns["n"].tolist()))
    w = dict(zip(want.decoded("endpoint"), want.columns["n"].tolist()))
    assert g == w
    assert g["/healthz"] == len(range(0, 3000, 7)) and sum(g.values()) == 3000


def test_build_request_path_clusters_grouped(stores):
    got, want = run_both(stores, CLUSTER_GROUPED)
    assert got.num_rows == 2
    assert (sorted(zip(_values(got, "service"), _values(got, "clustering")))
            == sorted(zip(_values(want, "service"), _values(want, "clustering"))))


def test_build_request_path_clusters_sorted_route(stores):
    """A computed key takes the sort-based group-by (`_run_agg_sorted`),
    whose finalize calls finalize_dict too."""
    src = """
import px
df = px.DataFrame(table='http_events', start_time=0)
df.bucket = px.floor(df.latency / 4.0)
df = df.groupby('bucket').agg(clustering=('req_path', px._build_request_path_clusters))
px.display(df, 'out')
"""
    got, want = run_both(stores, src)
    assert got.num_rows == want.num_rows > 3
    assert (sorted(zip(_values(got, "bucket"), _values(got, "clustering")))
            == sorted(zip(_values(want, "bucket"), _values(want, "clustering"))))


def test_kmeans_fit_uda_matches_reference(emb_stores, jax_draws):
    got, want = run_both(emb_stores, KMEANS_NONE)
    (g,), (w,) = _centroids(got), _centroids(want)
    assert g.shape == w.shape == (8, 2)
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    for c in ([0.0, 0.0], [30.0, 30.0]):
        assert np.min(np.linalg.norm(g - np.asarray(c), axis=1)) < 2.0


def test_kmeans_fit_uda_recovers_blobs_with_the_ports_draws(emb_stores):
    """The port's own generator: the model recovers both blobs and
    _kmeans_inference consumes it (tests/test_fit_udas.py's criteria)."""
    from pixie_tpu_torch.udf.builtins import _kmeans_inference

    q = compile_pxl(KMEANS_NONE, emb_stores[1].schemas(), now=NOW)
    res = execute_plan(q.plan, emb_stores[1], device="cpu")["out"]
    (cents,) = _centroids(res)
    for c in ([0.0, 0.0], [30.0, 30.0]):
        assert np.min(np.linalg.norm(cents - np.asarray(c), axis=1)) < 2.0
    model = res.decoded("model")[0]
    a = _kmeans_inference(json.dumps([0.1, -0.1]), model)
    b = _kmeans_inference(json.dumps([29.9, 30.2]), model)
    assert a != b and a >= 0 and b >= 0


def test_kmeans_fit_grouped_and_empty_models(jax_draws):
    """Groups with fewer distinct points than k fit k = their count; a group
    whose values are not vectors gets an empty model, as in the reference."""
    cols = {"time_": np.arange(12, dtype=np.int64),
            "g": ["a"] * 5 + ["b"] * 4 + ["c"] * 3,
            "embedding": ["[1, 2]", "[1, 2]", "[3, 4]", "[5, 6]", "[7, 8.5]",
                          "[0]", "[2]", "[2]", "[4]", "nope", "{}", "[]"]}

    def store(pkg):
        ts, rel_cls, dt = ((RefStore(), RefRelation, RefDT) if pkg == "ref"
                           else (TableStore(), Relation, DT))
        rel = rel_cls.of(("time_", dt.TIME64NS), ("g", dt.STRING), ("embedding", dt.STRING))
        ts.create("embs", rel, batch_rows=8).write(dict(cols))
        return ts

    src = """
import px
df = px.DataFrame(table='embs', start_time=0)
df = df.groupby('g').agg(model=('embedding', px._kmeans_fit))
px.display(df, 'out')
"""
    got, want = run_both((store("ref"), store("port")), src)
    g = dict(zip(got.decoded("g"), got.decoded("model")))
    w = dict(zip(want.decoded("g"), want.decoded("model")))
    assert set(g) == set(w) == {"a", "b", "c"}
    assert g["c"] == w["c"] == json.dumps({"centroids": []})
    for key in ("a", "b"):
        np.testing.assert_allclose(np.asarray(json.loads(g[key])["centroids"]),
                                   np.asarray(json.loads(w[key])["centroids"]), atol=1e-4)


def test_registry_names_equal_the_reference_minus_metadata():
    """The port registers every reference UDA and every scalar but the
    metadata functions (slice 6)."""
    from pixie_tpu.metadata.funcs import register_metadata_funcs
    from pixie_tpu.udf import registry as ref_registry
    from pixie_tpu.udf.udf import Registry as RefRegistry

    from pixie_tpu_torch.udf import registry

    meta = RefRegistry()
    register_metadata_funcs(meta)
    metadata = set(meta.names()["scalar"]) | {"asid", "_exec_hostname"}
    ref, port = ref_registry.names(), registry.names()
    assert port["uda"] == ref["uda"]
    assert set(port["scalar"]) == set(ref["scalar"]) - metadata
    assert {"request_path_endpoint", "_match_endpoint",
            "_predict_request_path_cluster"} <= set(port["scalar"])


@pytest.mark.parametrize("fn", ["_kmeans_fit", "_build_request_path_clusters"])
def test_fit_uda_over_numeric_column_is_the_same_error(stores, fn):
    src = f"""
import px
df = px.DataFrame(table='http_events', start_time=0)
df = df.agg(m=('latency', px.{fn}))
px.display(df, 'out')
"""
    ref_ts, ts = stores
    with pytest.raises(RefUnimplemented) as want:
        ref_execute(ref_compile(src, ref_ts.schemas(), now=NOW).plan, ref_ts)
    with pytest.raises(Unimplemented) as got:
        execute_plan(compile_pxl(src, ts.schemas(), now=NOW).plan, ts, device="cpu")
    assert str(got.value) == str(want.value)
    assert "dictionary-encoded" in str(got.value)


def test_dict_hist_state_equals_the_reference():
    """Counts per (group, code), the null sentinel and overflow codes dropped,
    masked rows ignored, and the "add" merge."""
    rng = np.random.default_rng(4)
    g, n = 3, 5000
    gid = rng.integers(0, g, n).astype(np.int32)
    code = rng.integers(-5, 300, n).astype(np.int32)
    code[rng.random(n) < 0.05] = SENTINEL
    mask = rng.random(n) < 0.9
    ref_uda, uda = RefRPFit(), RequestPathClusteringFitUDA()
    want = np.asarray(ref_uda.update(ref_uda.init(g), jnp.asarray(gid), jnp.asarray(code),
                                     jnp.asarray(mask), g))
    got = uda.update(uda.init(g, np.int32, "cpu"), torch.from_numpy(gid),
                     torch.from_numpy(code), torch.from_numpy(mask), g)
    assert got.dtype == torch.int64 and got.shape == (g, uda.CAP)
    assert np.array_equal(got.numpy(), want)
    assert uda.reduce_ops() == ref_uda.reduce_ops() == "add"
    merged_ref = np.asarray(ref_uda.merge(jnp.asarray(want), jnp.asarray(want)))
    assert np.array_equal((got + got).numpy(), merged_ref)


def test_dict_hist_finalize_needs_the_dictionary():
    from pixie_tpu_torch.status import NotFound

    with pytest.raises(NotFound, match="finalize_dict"):
        RequestPathClusteringFitUDA().finalize_host(np.zeros((1, 256), np.int64))


def test_kmeans_fit_uda_needs_init_for_its_device():
    uda = KMeansFitUDA()
    with pytest.raises(Internal, match="device"):
        uda.fit_group(["[1, 2]"], [1])
    uda.init(1, np.int32, "cpu")
    assert json.loads(uda.fit_group(["[1, 2]"], [3]))["centroids"] == [[1.0, 2.0]]


@pytest.fixture(scope="module")
def reference_flags():
    """The port has no standing views or flight recorder yet: run the
    reference as it runs with both off."""
    saved = {f: ref_flags.get(f) for f in ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")}
    for f in saved:
        ref_flags.set_for_testing(f, False)
    yield
    for f, v in saved.items():
        ref_flags.set_for_testing(f, v)


@pytest.mark.parametrize("src,table", [(CLUSTER_GROUPED, "http"), (KMEANS_NONE, "embs")])
def test_local_cluster_runs_fit_udas_like_the_reference(reference_flags, jax_draws,
                                                        src, table):
    """4 agent stores with private dictionaries: the planner ships rows to
    the merger, which fits the models, in both packages."""
    if table == "http":
        parts = [_http_cols(20 + a, 700, ("cart", "web", f"svc{a}")) for a in range(4)]
        build = _http_store
    else:
        parts = [_emb_cols(30 + a, 150) for a in range(4)]
        build = _emb_store
    ref = RefCluster({f"pem{a}": build("ref", c) for a, c in enumerate(parts)},
                     n_devices_per_agent=1)
    port = LocalCluster({f"pem{a}": build("port", c) for a, c in enumerate(parts)},
                        device="cpu")
    rq = ref_compile(src, ref.schemas(), now=NOW)
    pq = compile_pxl(src, port.schemas(), now=NOW)
    rdp, pdp = ref.planner.plan(rq.plan), port.planner.plan(pq.plan)
    assert pdp.to_dict() == rdp.to_dict()
    assert {c.kind for c in pdp.channels.values()} == {"rows"}
    want = ref.query(src, now=NOW)["out"]
    got = port.query(src, now=NOW)["out"]
    if table == "http":
        assert (sorted(zip(_values(got, "service"), _values(got, "clustering")))
                == sorted(zip(_values(want, "service"), _values(want, "clustering"))))
        assert got.num_rows == 6
    else:
        (g,), (w,) = _centroids(got), _centroids(want)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
