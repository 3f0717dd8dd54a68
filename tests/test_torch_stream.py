"""Streaming and windowed queries: pixie_tpu_torch against pixie_tpu.

Every case of tests/test_stream.py and tests/test_cluster_stream.py runs
through both packages: the same writes and the same poll sequence, the
reference on the JAX CPU (its LocalCluster with one device per agent and
tracing off), the port with device="cpu", both with standing views off.  The emitted
frames must be equal: counts and int64 sums exactly, float sums and means to
rtol 1e-12, quantiles in the same sketch bin.  Each case also keeps the
reference test's own assertions, checked on both packages.

Beyond them: the PartialAggFold / HostBatchUnion cases of
tests/test_streaming_merge.py that need no Broker (the chunk streams come
from each package's `run_agent_stream`), `split_closing_windows`, bench
config #2 (windowed p50/p99) and config #5 (the streaming replay) at small
sizes — config #5 once sequentially through both packages and once with a
writer and a poller thread on the port, checked against a numpy oracle.
"""
import random
import threading
import time

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu import plan as ref_plan
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.engine import stream as ref_stream
from pixie_tpu.engine.executor import PlanExecutor as RefExecutor
from pixie_tpu.parallel import partial as ref_partial
from pixie_tpu.parallel.cluster import HostBatchUnion as RefUnion
from pixie_tpu.parallel.cluster import LocalCluster as RefCluster
from pixie_tpu.parallel.streaming import ClusterStreamQuery as RefClusterStream
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation
from pixie_tpu.udf import registry as ref_registry

from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch import plan as port_plan
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.engine import stream as port_stream
from pixie_tpu_torch.engine.executor import PlanExecutor
from pixie_tpu_torch.ops import _build
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.parallel import partial as port_partial
from pixie_tpu_torch.parallel.cluster import HostBatchUnion
from pixie_tpu_torch.parallel.streaming import ClusterStreamQuery
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.table.delta import GAP, OK, STALE_TABLE, TRIMMED, DeltaCursor
from pixie_tpu_torch.types import DataType as DT, Relation
from pixie_tpu_torch.udf import registry

MS = 1_000_000
SEC = 1_000_000_000
GAMMA = 1.0404
#: quantile outputs: compared as sketch bins
QUANTILES = {"p50", "p99"}


@pytest.fixture(scope="module", autouse=True)
def reference_flags():
    """These cases measure the rescan route: both packages run with standing
    views off (tests/test_torch_matview.py runs them on), and the reference
    without its flight recorder, which the port does not have."""
    saved = {f: ref_flags.get(f) for f in ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")}
    for f in saved:
        ref_flags.set_for_testing(f, False)
    port_views = port_flags.get("PL_MATVIEW_ENABLED")
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    yield
    for f, v in saved.items():
        ref_flags.set_for_testing(f, v)
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", port_views)


class _Pkg:
    """One package's streaming surface, as a case drives it."""

    def __init__(self, name):
        self.name = name
        port = name == "port"
        self.TableStore = TableStore if port else RefStore
        self.Relation = Relation if port else RefRelation
        self.DT = DT if port else RefDT
        self.StreamQuery = port_stream.StreamQuery if port else ref_stream.StreamQuery
        self.P = port_plan if port else ref_plan

    def store(self, batch_rows=1024):
        ts = self.TableStore()
        rel = self.Relation.of(("time_", self.DT.TIME64NS), ("service", self.DT.STRING),
                               ("latency", self.DT.FLOAT64))
        ts.create("http_events", rel, batch_rows=batch_rows)
        return ts

    def stream(self, src, ts, **kw):
        if self.name == "port":
            return port_stream.stream_pxl(src, ts, device="cpu", **kw)
        return ref_stream.stream_pxl(src, ts, **kw)

    def cluster(self, stores):
        if self.name == "port":
            return LocalCluster(stores, device="cpu")
        return RefCluster(stores, n_devices_per_agent=1)

    def cstream(self, cluster, src):
        cls = ClusterStreamQuery if self.name == "port" else RefClusterStream
        return cls(cluster, src)

    def execute(self, plan, ts):
        if self.name == "port":
            return execute_plan(plan, ts, device="cpu")
        return ref_execute(plan, ts)


REF, PORT = _Pkg("ref"), _Pkg("port")


def _write(ts, t0, n, svc="a", lat=1.0):
    ts.table("http_events").write({
        "time_": np.arange(t0, t0 + n, dtype=np.int64),
        "service": [svc] * n,
        "latency": np.full(n, lat),
    })


def _write_times(ts, times, lat=1.0):
    ts.table("http_events").write({
        "time_": np.asarray(times, dtype=np.int64),
        "service": ["a"] * len(times),
        "latency": np.full(len(times), lat),
    })


def _frames(got: dict) -> dict:
    """A poll's emissions as pandas frames in a canonical row order."""
    out = {}
    for sink, res in got.items():
        df = res.to_pandas()
        keys = [c for c in df.columns if df[c].dtype.kind in "iObU"]
        out[sink] = df.sort_values(keys).reset_index(drop=True) if keys else df
    return out


def _same_log(ref_log, port_log):
    assert len(ref_log) == len(port_log)
    for step, (a, b) in enumerate(zip(ref_log, port_log)):
        assert sorted(a) == sorted(b), (step, sorted(a), sorted(b))
        for sink in a:
            fa, fb = a[sink], b[sink]
            assert list(fa.columns) == list(fb.columns) and len(fa) == len(fb), (step, sink)
            for c in fa.columns:
                x, y = fa[c].to_numpy(), fb[c].to_numpy()
                if c in QUANTILES:
                    ratio = y / x
                    # the same bin's value (to the ulp that XLA's pow and
                    # libm's may differ by), or the next bin
                    assert (np.isclose(ratio, 1, rtol=1e-12) | np.isclose(ratio, GAMMA, rtol=1e-12)
                            | np.isclose(ratio, 1 / GAMMA, rtol=1e-12)).all(), (step, c)
                elif x.dtype.kind == "f":
                    np.testing.assert_allclose(y, x, rtol=1e-12)
                else:
                    assert list(x) == list(y), (step, sink, c)


# ------------------------------------------------- tests/test_stream.py


def case_chain_stream_incremental_polls(pk, log):
    ts = pk.store()
    sq = pk.stream("""
df = px.DataFrame(table='http_events')
df = df[df.latency > 0.5].stream()
px.display(df, 'out')
""", ts)
    assert log(sq.poll()) == {}
    _write(ts, 0, 100, lat=1.0)
    assert log(sq.poll())["out"].num_rows == 100
    assert log(sq.poll()) == {}
    _write(ts, 100, 50, lat=0.1)
    assert log(sq.poll()) == {}
    _write(ts, 150, 30, lat=2.0)
    assert log(sq.poll())["out"].num_rows == 30
    assert log(sq.close()) == {}


def case_chain_stream_limit_reaches_eos(pk, log):
    ts = pk.store()
    sq = pk.stream("""
df = px.DataFrame(table='http_events').stream()
df = df.head(25)
px.display(df, 'out')
""", ts)
    _write(ts, 0, 10)
    assert log(sq.poll())["out"].num_rows == 10
    _write(ts, 10, 40)
    assert log(sq.poll())["out"].num_rows == 15
    _write(ts, 50, 40)
    assert log(sq.poll()) == {}


def case_chain_stream_limit_then_filter_batch_parity(pk, log):
    ts = pk.store()
    sq = pk.stream("""
df = px.DataFrame(table='http_events').stream()
df = df.head(10)
df = df[df.latency > 0.5]
px.display(df, 'out')
""", ts)
    _write(ts, 0, 10, lat=0.1)
    assert log(sq.poll()) == {}
    _write(ts, 10, 10, lat=2.0)
    assert log(sq.poll()) == {}


def case_stream_bin_over_value_column_emits_at_close(pk, log):
    ts = pk.store()
    sq = pk.stream("""
df = px.DataFrame(table='http_events').stream()
df.lb = px.bin(df.time_ * 0 + 7, 100)
df = df.groupby('lb').agg(cnt=('latency', px.count))
px.display(df, 'out')
""", ts)
    _write(ts, 0, 5)
    assert log(sq.poll()) == {}
    _write(ts, 5, 3)
    assert log(sq.poll()) == {}
    assert list(log(sq.close())["out"].to_pandas()["cnt"]) == [8]


def case_windowed_stream_emits_closed_windows(pk, log):
    ts = pk.store()
    sq = pk.stream("""
df = px.DataFrame(table='http_events').stream()
df = df.rolling('1s').agg(cnt=('latency', px.count), s=('latency', px.sum))
px.display(df, 'out')
""", ts)
    t = ts.table("http_events")
    t.write({"time_": np.array([0, 100 * MS, 1 * SEC + 5, 1 * SEC + 10, 2 * SEC + 1]),
             "service": ["a"] * 5, "latency": [1.0, 2.0, 3.0, 4.0, 5.0]})
    df = log(sq.poll())["out"].to_pandas().sort_values("time_").reset_index(drop=True)
    assert list(df["time_"]) == [0, 1 * SEC] and list(df["cnt"]) == [2, 2]
    assert list(df["s"]) == [3.0, 7.0]
    t.write({"time_": np.array([100]), "service": ["a"], "latency": [99.0]})
    assert log(sq.poll()) == {}
    fin = log(sq.close())["out"].to_pandas()
    assert list(fin["time_"]) == [2 * SEC] and list(fin["cnt"]) == [1]
    assert list(fin["s"]) == [5.0]


def case_windowed_stream_string_groups_across_polls(pk, log):
    ts = pk.store()
    sq = pk.stream("""
df = px.DataFrame(table='http_events').stream()
df = df.rolling('1s').agg(cnt=('latency', px.count))
px.display(df, 'out')
""", ts)
    t = ts.table("http_events")
    t.write({"time_": np.array([1, 2]), "service": ["a", "b"], "latency": [1.0, 1.0]})
    assert log(sq.poll()) == {}
    t.write({"time_": np.array([3]), "service": ["a"], "latency": [1.0]})
    assert log(sq.poll()) == {}
    t.write({"time_": np.array([1 * SEC + 1]), "service": ["c"], "latency": [1.0]})
    got = log(sq.poll())["out"].to_pandas()
    assert got["cnt"].sum() == 3 and len(got) == 1
    assert list(log(sq.close())["out"].to_pandas()["cnt"]) == [1]


def case_nonwindowed_stream_agg_emits_at_close(pk, log):
    ts = pk.store()
    sq = pk.stream("""
df = px.DataFrame(table='http_events').stream()
df = df.groupby('service').agg(cnt=('latency', px.count), m=('latency', px.mean))
px.display(df, 'out')
""", ts)
    _write(ts, 0, 10, svc="x", lat=2.0)
    assert log(sq.poll()) == {}
    _write(ts, 10, 5, svc="y", lat=4.0)
    assert log(sq.poll()) == {}
    fin = log(sq.close())["out"].to_pandas().sort_values("service").reset_index(drop=True)
    assert list(fin["service"]) == ["x", "y"] and list(fin["cnt"]) == [10, 5]
    np.testing.assert_allclose(fin["m"], [2.0, 4.0])


def case_stream_while_writer_runs_interleaved(pk, log):
    """test_stream_while_writer_runs_snapshot_consistent with a fixed
    interleaving of writes and polls (the threaded version is below)."""
    ts = pk.store(batch_rows=256)
    sq = pk.stream("""
df = px.DataFrame(table='http_events').stream()
px.display(df, 'out')
""", ts)
    written = seen = 0
    for step in range(20):
        for _ in range(step % 3):
            _write(ts, written, 500)
            written += 500
        got = log(sq.poll())
        if got:
            seen += got["out"].num_rows
    assert seen == written


def case_post_agg_filter_applies_to_emissions(pk, log):
    ts = pk.store()
    sq = pk.stream("""
df = px.DataFrame(table='http_events').stream()
df = df.rolling('1s').agg(cnt=('latency', px.count))
df = df[df.cnt > 2]
px.display(df, 'out')
""", ts)
    ts.table("http_events").write({
        "time_": np.array([0, 1, 2, 1 * SEC + 1, 2 * SEC + 1]),
        "service": ["a"] * 5, "latency": [1.0] * 5})
    got = log(sq.poll())["out"].to_pandas()
    assert list(got["time_"]) == [0] and list(got["cnt"]) == [3]
    assert log(sq.close()) == {}


def case_close_drains_past_poll_cap(pk, log, monkeypatch):
    monkeypatch.setattr(pk.StreamQuery, "MAX_POLL_ROWS", 64)
    ts = pk.store(batch_rows=64)
    sq = pk.stream("""
df = px.DataFrame(table='http_events').stream()
df = df.groupby('service').agg(cnt=('latency', px.count))
px.display(df, 'out')
""", ts)
    _write(ts, 0, 1000, svc="x", lat=1.0)
    assert int(log(sq.close())["out"].to_pandas()["cnt"].sum()) == 1000


# ------------------------------------------ tests/test_cluster_stream.py

CLUSTER_SCRIPT = """
df = px.DataFrame(table='http_events').stream()
df = df.rolling('1s').agg(cnt=('latency', px.count), s=('latency', px.sum))
px.display(df, 'win')
"""


def case_min_watermark_holds_window_for_lagging_agent(pk, log):
    stores = {"pem0": pk.store(), "pem1": pk.store()}
    cs = pk.cstream(pk.cluster(stores), CLUSTER_SCRIPT)
    assert log(cs.poll()) == {}
    _write_times(stores["pem0"], [10, 20, 1 * SEC + 5])
    _write_times(stores["pem1"], [30])
    assert log(cs.poll()) == {}
    _write_times(stores["pem1"], [1 * SEC + 50])
    got = log(cs.poll())["win"].to_pandas()
    assert list(got["time_"]) == [0] and list(got["cnt"]) == [3]
    fin = log(cs.close())["win"].to_pandas()
    assert list(fin["time_"]) == [1 * SEC] and list(fin["cnt"]) == [2]


def case_cluster_stream_totals_match_batch(pk, log):
    import pandas as pd

    rng = np.random.default_rng(9)
    stores = {f"pem{i}": pk.store() for i in range(3)}
    cluster = pk.cluster(stores)
    cs = pk.cstream(cluster, CLUSTER_SCRIPT)
    emitted = []
    for step in range(4):
        for ts in stores.values():
            n = int(rng.integers(50, 150))
            _write_times(ts, step * SEC + np.sort(rng.integers(0, SEC, n)), lat=2.0)
        got = log(cs.poll())
        if "win" in got:
            emitted.append(got["win"].to_pandas())
    fin = log(cs.close())
    if "win" in fin:
        emitted.append(fin["win"].to_pandas())
    streamed = (pd.concat(emitted).groupby("time_").agg(cnt=("cnt", "sum"), s=("s", "sum"))
                .reset_index().sort_values("time_").reset_index(drop=True))
    batch = log(cluster.query(
        "df = px.DataFrame(table='http_events')\n"
        "df = df.rolling('1s').agg(cnt=('latency', px.count), s=('latency', px.sum))\n"
        "px.display(df, 'win')\n"))["win"].to_pandas().sort_values("time_").reset_index(
            drop=True)
    assert list(streamed["time_"]) == list(batch["time_"])
    assert list(streamed["cnt"]) == list(batch["cnt"])
    np.testing.assert_allclose(streamed["s"], batch["s"])
    assert pd.concat(emitted)["time_"].is_unique


def case_cluster_stream_collects_all_rows_exactly_once(pk, log):
    stores = {"pem0": pk.store(), "pem1": pk.store()}
    cs = pk.cstream(pk.cluster(stores), CLUSTER_SCRIPT)
    seen = total = 0
    rng = np.random.default_rng(3)
    for step in range(5):
        for ts in stores.values():
            n = int(rng.integers(20, 80))
            _write_times(ts, step * SEC + np.sort(rng.integers(0, SEC, n)))
            total += n
        got = log(cs.poll())
        if "win" in got:
            seen += int(got["win"].to_pandas()["cnt"].sum())
    fin = log(cs.close())
    if "win" in fin:
        seen += int(fin["win"].to_pandas()["cnt"].sum())
    assert seen == total


def case_silent_agent_holds_watermark_no_data_loss(pk, log):
    import pandas as pd

    stores = {"pem0": pk.store(), "pem1": pk.store()}
    cs = pk.cstream(pk.cluster(stores), CLUSTER_SCRIPT)
    _write_times(stores["pem0"], [10, 1 * SEC + 5, 2 * SEC + 5])
    assert log(cs.poll()) == {}
    _write_times(stores["pem1"], [20, 30])
    got = log(cs.poll())
    fin = log(cs.close())
    parts = [r["win"].to_pandas() for r in (got, fin) if "win" in r]
    allw = pd.concat(parts).groupby("time_")["cnt"].sum()
    assert int(allw.sum()) == 5 and int(allw.loc[0]) == 3


def case_heterogeneous_cluster_participation(pk, log):
    stores = {"pem0": pk.store(), "other": pk.TableStore()}
    stores["other"].create("unrelated", pk.Relation.of(("x", pk.DT.INT64)))
    cs = pk.cstream(pk.cluster(stores), CLUSTER_SCRIPT)
    assert set(cs._agent_sqs) == {"pem0"}
    _write_times(stores["pem0"], [1, 1 * SEC + 1])
    assert list(log(cs.poll())["win"].to_pandas()["cnt"]) == [1]


def case_cluster_stream_chain_unions_agents(pk, log):
    stores = {"pem0": pk.store(), "pem1": pk.store()}
    cs = pk.cstream(pk.cluster(stores), "df = px.DataFrame(table='http_events').stream()\n"
                                        "df = df[df.latency > 0.5]\n"
                                        "px.display(df, 'rows')\n")
    _write_times(stores["pem0"], [1, 2], lat=1.0)
    _write_times(stores["pem1"], [3], lat=0.1)
    assert log(cs.poll())["rows"].num_rows == 2
    _write_times(stores["pem1"], [4], lat=2.0)
    assert log(cs.poll())["rows"].num_rows == 1


NAN_SCRIPT = """
df = px.DataFrame(table='http_events').stream()
df = df.rolling('1s').agg(cnt=('latency', px.count), p10=('latency', px.p10),
                          p50=('latency', px.p50))
px.display(df, 'out')
"""


def _nan_latencies(rng, n):
    lat = rng.exponential(20.0, n)
    lat[rng.random(n) < 0.2] = np.nan
    return lat


def case_stream_quantiles_over_nan_latencies(pk, log):
    """A NaN latency counts in sketch bin 0 in a streaming poll, as the
    reference's CPU route bins it: over latencies that are 20% NaN, every
    window's p10 is 0.0 (bin 1 would give 0.980)."""
    ts = pk.store()
    sq = pk.stream(NAN_SCRIPT, ts)
    rng = np.random.default_rng(21)
    p10 = []
    for step in range(4):
        n = 700
        ts.table("http_events").write({
            "time_": step * SEC + np.sort(rng.integers(0, SEC, n)),
            "service": ["a"] * n, "latency": _nan_latencies(rng, n)})
        got = log(sq.poll())
        if "out" in got:
            p10.extend(got["out"].to_pandas()["p10"])
    p10.extend(log(sq.close())["out"].to_pandas()["p10"])
    assert len(p10) == 4 and all(v == 0.0 for v in p10)


def case_cluster_stream_quantiles_over_nan_latencies(pk, log):
    """The cluster stream's agent polls bin a NaN latency at 0 too."""
    stores = {"pem0": pk.store(), "pem1": pk.store()}
    cs = pk.cstream(pk.cluster(stores), NAN_SCRIPT)
    rng = np.random.default_rng(22)
    for step in range(3):
        for ts in stores.values():
            n = 400
            ts.table("http_events").write({
                "time_": step * SEC + np.sort(rng.integers(0, SEC, n)),
                "service": ["a"] * n, "latency": _nan_latencies(rng, n)})
        log(cs.poll())
    fin = log(cs.close())
    assert (fin["out"].to_pandas()["p10"] == 0.0).all()


def test_batch_query_bins_nan_as_the_reference_device_route():
    """A batch query keeps NaN in sketch bin 1, as the reference's device
    route (force_backend="tpu") bins it: p10 over latencies 20% NaN equals
    that route's, bin 1's value (a streaming poll's would be 0.0)."""
    script = ("df = px.DataFrame(table='http_events')\n"
              "df = df.groupby('service').agg(cnt=('latency', px.count), "
              "p10=('latency', px.p10), p50=('latency', px.p50))\n"
              "px.display(df, 'out')\n")
    rng = np.random.default_rng(23)
    n = 3000
    cols = {"time_": np.arange(n, dtype=np.int64),
            "service": rng.choice(["a", "b", "c"], n).tolist(),
            "latency": _nan_latencies(rng, n)}
    frames = {}
    for pk in (REF, PORT):
        ts = pk.store()
        ts.table("http_events").write(cols)
        if pk is PORT:
            frames["port"] = _frames(execute_plan(compile_pxl(script, ts.schemas()).plan, ts,
                                                  device="cpu", force_backend="device"))["out"]
            continue
        plan = ref_compile(script, ts.schemas()).plan
        frames["ref"] = _frames(RefExecutor(plan, ts, None, force_backend="tpu").run())["out"]
    port, dev_route = frames["port"], frames["ref"]
    assert list(port["service"]) == list(dev_route["service"])
    assert list(port["cnt"]) == list(dev_route["cnt"])
    bin1 = GAMMA ** -0.5
    np.testing.assert_allclose(port["p10"], bin1, rtol=1e-12)
    np.testing.assert_allclose(dev_route["p10"], bin1, rtol=1e-12)
    np.testing.assert_allclose(port["p50"], dev_route["p50"], rtol=1e-12)


# --------------------------------------------- bench config #5, small

CONFIG5_SCRIPT = """
df = px.DataFrame(table='http_events').stream()
df = df.rolling('10s').agg(cnt=('latency', px.count), p50=('latency', px.p50))
px.display(df, 'win')
"""
CONFIG5_CHUNK = 1 << 12


def _config5_store(pk):
    ts = pk.TableStore()
    ts.create("http_events", pk.Relation.of(("time_", pk.DT.TIME64NS),
                                            ("service_id", pk.DT.INT64),
                                            ("latency", pk.DT.FLOAT64)),
              batch_rows=1 << 10)
    return ts


def _config5_chunks(rows):
    """bench_config5's writer: one pre-generated chunk (seed 3) replayed
    with time advancing over 600 s of event time."""
    rng = np.random.default_rng(3)
    svc = rng.integers(0, 16, CONFIG5_CHUNK)
    lat = rng.exponential(50.0, CONFIG5_CHUNK)
    t_step = 600 * SEC // rows
    written = 0
    while written < rows:
        n = min(CONFIG5_CHUNK, rows - written)
        yield {"time_": np.arange(written, written + n, dtype=np.int64) * t_step,
               "service_id": svc[:n], "latency": lat[:n]}
        written += n


def case_config5_sequential(pk, log):
    rows = 12 * CONFIG5_CHUNK + 1000
    ts = _config5_store(pk)
    sq = pk.stream(CONFIG5_SCRIPT, ts)
    emitted = 0
    for chunk in _config5_chunks(rows):
        ts.table("http_events").write(chunk)
        got = log(sq.poll())
        if got:
            emitted += int(got["win"].to_pandas()["cnt"].sum())
    fin = log(sq.close())
    emitted += int(fin["win"].to_pandas()["cnt"].sum()) if fin else 0
    assert emitted == rows


CASES = [v for k, v in sorted(globals().items()) if k.startswith("case_")]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_stream_case_equals_reference(case, monkeypatch):
    logs = {}
    for pk in (REF, PORT):
        steps = []

        def log(got, steps=steps):
            steps.append(_frames(got))
            return got

        kw = {"monkeypatch": monkeypatch} if "monkeypatch" in case.__code__.co_varnames else {}
        case(pk, log, **kw)
        logs[pk.name] = steps
    _same_log(logs["ref"], logs["port"])


def test_stream_while_writer_runs_snapshot_consistent():
    """A writer thread and a polling reader: every row is seen exactly once
    (the reference case, on the port)."""
    ts = PORT.store(batch_rows=256)
    sq = PORT.stream("df = px.DataFrame(table='http_events').stream()\n"
                     "px.display(df, 'out')\n", ts)
    stop = threading.Event()
    written = [0]

    def writer():
        t0 = 0
        while not stop.is_set() and written[0] < 200_000:
            _write(ts, t0, 500)
            written[0] += 500
            t0 += 500

    th = threading.Thread(target=writer)
    th.start()
    seen = 0
    for _ in range(20):
        got = sq.poll()
        if got:
            seen += got["out"].num_rows
    stop.set()
    th.join()
    got = sq.poll()
    if got:
        seen += got["out"].num_rows
    assert seen == written[0]


def _config5_oracle(chunks):
    t = np.concatenate([c["time_"] for c in chunks])
    w = (t // (10 * SEC)) * (10 * SEC)
    u, cnt = np.unique(w, return_counts=True)
    return dict(zip(u.tolist(), cnt.tolist()))


def test_config5_threaded_writer_and_poller():
    """bench_config5's shape: a writer thread appends chunks while a poller
    thread polls on its own cadence; every 10 s window is emitted exactly
    once and its count equals the oracle's."""
    rows = 24 * CONFIG5_CHUNK
    ts = _config5_store(PORT)
    sq = PORT.stream(CONFIG5_SCRIPT, ts)
    chunks = list(_config5_chunks(rows))
    emitted, stop = [], threading.Event()

    def poller():
        while not stop.is_set():
            got = sq.poll()
            if got:
                emitted.append(got["win"].to_pandas())
            if not sq.lagging():
                stop.wait(0.005)

    th = threading.Thread(target=poller)
    th.start()
    for c in chunks:
        ts.table("http_events").write(c)
        time.sleep(0.001)
    stop.set()
    th.join()
    fin = sq.close()
    if fin:
        emitted.append(fin["win"].to_pandas())
    import pandas as pd

    allw = pd.concat(emitted)
    assert allw["time_"].is_unique
    want = _config5_oracle(chunks)
    assert dict(zip(allw["time_"].tolist(), allw["cnt"].tolist())) == want
    assert int(allw["cnt"].sum()) == rows


# ------------------------------------------------- bench config #2, small


def _config2_plan(P):
    """bench.http_plan(windowed_ns=10 s, quantiles=True) in a package's plan API."""
    p = P.Plan()
    node = p.add(P.FilterOp(expr=P.Call("not_equal", (P.Column("status"), P.lit(404)))),
                 parents=[p.add(P.MemorySourceOp(table="http_events"))])
    node = p.add(P.MapOp(exprs=[
        ("time_", P.Call("bin", (P.Column("time_"), P.lit(10 * SEC)))),
        ("service", P.Column("service")), ("status", P.Column("status")),
        ("latency", P.Column("latency"))]), parents=[node])
    agg = p.add(P.AggOp(groups=["time_", "service"], values=[
        P.AggExpr("cnt", "count", None), P.AggExpr("avg_lat", "mean", "latency"),
        P.AggExpr("p50", "p50", "latency"), P.AggExpr("p99", "p99", "latency")],
        windowed=True), parents=[node])
    p.add(P.MemorySinkOp(name="output"), parents=[agg])
    return p


def test_config2_windowed_quantiles_equal_reference():
    rng = np.random.default_rng(12)
    n = 60_000
    cols = {"time_": np.arange(n, dtype=np.int64) * (600 * SEC // n),
            "service": np.array([f"svc-{i}" for i in range(16)])[rng.integers(0, 16, n)],
            "latency": rng.exponential(50.0, n),
            "status": rng.choice([200, 404, 500], n, p=[0.85, 0.05, 0.10])}
    logs = {}
    for pk in (REF, PORT):
        ts = pk.TableStore()
        ts.create("http_events", pk.Relation.of(
            ("time_", pk.DT.TIME64NS), ("service", pk.DT.STRING), ("latency", pk.DT.FLOAT64),
            ("status", pk.DT.INT64)), batch_rows=4096).write(cols)
        logs[pk.name] = [_frames(pk.execute(_config2_plan(pk.P), ts))]
    assert len(logs["port"][0]["output"]) == 60 * 16
    _same_log(logs["ref"], logs["port"])


# --------------------------- PartialAggFold / HostBatchUnion (no Broker)

AGG_SCRIPT = """
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(cnt=('latency', px.count), m=('latency', px.mean))
px.display(df, 'out')
"""
ROWS_SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status == 500]
df = df[['service', 'latency']]
px.display(df, 'out')
"""


def _merge_stores(pk):
    out = {}
    for seed, name in ((1, "pem1"), (2, "pem2")):
        rng = np.random.default_rng(seed)
        n = 20_000
        ts = pk.TableStore()
        ts.create("http_events", pk.Relation.of(
            ("time_", pk.DT.TIME64NS), ("service", pk.DT.STRING), ("latency", pk.DT.FLOAT64),
            ("status", pk.DT.INT64)), batch_rows=4096).write({
                "time_": np.arange(n, dtype=np.int64) * 1000,
                "service": rng.choice(["cart", "auth", "web"], n).tolist(),
                "latency": rng.exponential(20.0, n),
                "status": rng.choice([200, 500], n)})
        out[name] = ts
    return out


def _agent_chunks(pk, script, agg_chunk_groups=1):
    """Each agent's plan fragment run through run_agent_stream: its chunk
    stream (channel, payload)."""
    stores = _merge_stores(pk)
    cluster = pk.cluster(stores)
    if pk.name == "port":
        q = compile_pxl(script, cluster.schemas())
        dp = cluster.planner.plan(q.plan)
        mk = lambda plan, ts: PlanExecutor(plan, ts, device="cpu")  # noqa: E731
    else:
        q = ref_compile(script, cluster.schemas())
        dp = cluster.planner.plan(q.plan)
        mk = lambda plan, ts: RefExecutor(plan, ts, None)  # noqa: E731
    chunks = {name: list(mk(plan, stores[name]).run_agent_stream(
        agg_chunk_groups=agg_chunk_groups)) for name, plan in dp.agent_plans.items()}
    return dp, chunks


def _fold_frame(hb):
    import pandas as pd

    svc = hb.dicts["service"].values()
    return (pd.DataFrame({"service": [svc[c] for c in hb.cols["service"]],
                          "cnt": hb.cols["cnt"], "m": hb.cols["m"]})
            .sort_values("service").reset_index(drop=True))


def test_out_of_order_chunks_fold_to_same_answer():
    frames = {}
    for pk, part_mod, reg in ((REF, ref_partial, ref_registry), (PORT, port_partial, registry)):
        dp, chunks = _agent_chunks(pk, AGG_SCRIPT)
        (cid, ch), = [(c, ch) for c, ch in dp.channels.items() if ch.kind == "agg_state"]
        payloads = [p for name in chunks for c, p in chunks[name] if c == cid]
        assert len(payloads) >= 6
        assert all(isinstance(p, part_mod.PartialAggBatch) for p in payloads)

        def folded(order, ch=ch, part_mod=part_mod, reg=reg):
            fold = part_mod.PartialAggFold(ch.agg, reg)
            for p in order:
                fold.add(p)
            assert fold.count == len(order)
            return _fold_frame(fold.finish())

        base = folded(payloads)
        for seed in (3, 7, 11):
            shuf = list(payloads)
            random.Random(seed).shuffle(shuf)
            out = folded(shuf)
            assert list(out["service"]) == list(base["service"])
            assert list(out["cnt"]) == list(base["cnt"])
            np.testing.assert_allclose(out["m"], base["m"], rtol=1e-12)
        # more chunks than one fold batch stage and combine
        many = folded(payloads * 3)
        assert list(many["cnt"]) == [3 * c for c in base["cnt"]]
        frames[pk.name] = base
    a, b = frames["ref"], frames["port"]
    assert list(a["service"]) == list(b["service"]) and list(a["cnt"]) == list(b["cnt"])
    np.testing.assert_allclose(b["m"], a["m"], rtol=1e-12)


def test_chunked_stream_folds_to_the_unchunked_answer():
    """agg_chunk_groups slices a partial into one chunk per group; folded,
    they equal the unsliced stream's fold and run_agent's payload."""
    dp, sliced = _agent_chunks(PORT, AGG_SCRIPT, agg_chunk_groups=1)
    _dp, whole = _agent_chunks(PORT, AGG_SCRIPT, agg_chunk_groups=0)
    (cid, ch), = [(c, ch) for c, ch in dp.channels.items() if ch.kind == "agg_state"]
    outs = []
    for chunks in (sliced, whole):
        fold = port_partial.PartialAggFold(ch.agg, registry)
        for name in chunks:
            for c, p in chunks[name]:
                if c == cid:
                    fold.add(p)
        outs.append(_fold_frame(fold.finish()))
    assert sum(len(v) for v in sliced.values()) > sum(len(v) for v in whole.values())
    assert outs[0].equals(outs[1])


def test_out_of_order_rows_union_same_multiset():
    rows = {}
    for pk, union, hb_name in ((REF, RefUnion, "HostBatch"), (PORT, HostBatchUnion, "HostBatch")):
        dp, chunks = _agent_chunks(pk, ROWS_SCRIPT)
        (cid,) = [c for c, ch in dp.channels.items() if ch.kind != "agg_state"]
        payloads = [p for name in chunks for c, p in chunks[name] if c == cid]
        assert all(type(p).__name__ == hb_name for p in payloads)

        def rows_of(order, union=union):
            u = union()
            for p in order:
                u.add(p)
            hb = u.finish()
            svc = hb.dicts["service"].values()
            return sorted((svc[c], float(v))
                          for c, v in zip(hb.cols["service"], hb.cols["latency"]))

        base = rows_of(payloads)
        shuf = list(payloads)
        random.Random(5).shuffle(shuf)
        assert rows_of(shuf) == base
        rows[pk.name] = base
    assert rows["ref"] == rows["port"]


def test_run_agent_stream_ships_an_empty_chunk_for_an_empty_scan():
    stores = _merge_stores(PORT)
    cluster = PORT.cluster(stores)
    q = compile_pxl("df = px.DataFrame(table='http_events')\n"
                    "df = df[df.status == 999]\npx.display(df, 'out')\n", cluster.schemas())
    dp = cluster.planner.plan(q.plan)
    name, plan = next(iter(dp.agent_plans.items()))
    got = list(PlanExecutor(plan, stores[name], device="cpu").run_agent_stream())
    # one chunk a readback wave (here one a feed), each empty
    assert got and all(p.num_rows == 0 and "service" in p.dicts for _c, p in got)
    empty = {name: PORT.store() for name in stores}  # no rows at all: no feed
    cluster = PORT.cluster(empty)
    dp = cluster.planner.plan(compile_pxl("df = px.DataFrame(table='http_events')\n"
                                          "px.display(df, 'out')\n", cluster.schemas()).plan)
    name, plan = next(iter(dp.agent_plans.items()))
    got = list(PlanExecutor(plan, empty[name], device="cpu").run_agent_stream())
    assert len(got) == 1 and got[0][1].num_rows == 0 and "service" in got[0][1].dicts


# ------------------------------------------------------ window close step


def test_split_closing_windows_equals_reference():
    def pb(mod):
        return mod.PartialAggBatch(
            key_cols={"w": np.array([0, 10, 20, 30], dtype=np.int64),
                      "s": np.array(["a", "b", "a", "c"], dtype=object)},
            key_dtypes={"w": DT.TIME64NS, "s": DT.STRING},
            states={"cnt": {"count": np.array([1, 2, 3, 4], dtype=np.int64)}},
            in_types={"cnt": None})

    for close_below, emitted_below in ((20, None), (35, 10), (5, None), (30, 30)):
        got = port_stream.split_closing_windows(pb(port_partial), "w", close_below,
                                                emitted_below)
        want = ref_stream.split_closing_windows(pb(ref_partial), "w", close_below,
                                                emitted_below)
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.key_cols["w"].tolist() == w.key_cols["w"].tolist()
                assert g.key_cols["s"].tolist() == w.key_cols["s"].tolist()
                assert (g.states["cnt"]["count"].tolist()
                        == w.states["cnt"]["count"].tolist())


def test_delta_cursor_classifies_expiry():
    ts = TableStore()
    t = ts.create("t", Relation.of(("time_", DT.TIME64NS), ("x", DT.INT64)),
                  batch_rows=4, max_bytes=200)
    dc = DeltaCursor(t)
    assert dc.status(t) == OK and dc.delta_bounds(t) == (0, 0)
    t.write({"time_": np.arange(4, dtype=np.int64), "x": np.arange(4)})
    lo, hi = dc.delta_bounds(t)
    dc.advance(hi)
    assert (lo, hi) == (0, 4) and dc.covered_rows() == 4 and dc.status(t) == OK
    for i in range(1, 4):
        t.write({"time_": np.arange(4 * i, 4 * i + 4, dtype=np.int64), "x": np.arange(4)})
    assert dc.status(t) in (TRIMMED, GAP)
    for i in range(4, 12):
        t.write({"time_": np.arange(4 * i, 4 * i + 4, dtype=np.int64), "x": np.arange(4)})
    assert dc.status(t) == GAP
    dc.rebase(t)
    assert dc.status(t) == OK
    ts.drop("t")
    assert dc.status(ts.create("t", Relation.of(("x", DT.INT64)))) == STALE_TABLE


def test_stream_polls_go_through_the_chain_programs():
    """On the CPU the polls run the plain interpreter (no kernel launch) and
    lower with no leaf; the stream's device is the one asked for."""
    before = _build.KERNELS["chain"].launches
    ts = PORT.store()
    sq = PORT.stream(CLUSTER_SCRIPT, ts)
    assert sq.device.type == "cpu"
    _write_times(ts, [1, 2, SEC + 1])
    assert sq.poll()["win"].num_rows == 1
    assert _build.KERNELS["chain"].launches == before
    assert sq.stats["chain_leaves"] == 0 and sq.stats["feeds"] >= 1
