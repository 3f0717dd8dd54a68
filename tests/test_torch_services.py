"""The port's networked deployment (pixie_tpu_torch/services/) against the
reference's (pixie_tpu/services/).

  * tests/test_services.py's cases of the same name, run against the port's
    broker, agents and client with device="cpu" (`Broker` and `Agent` below
    are the port's, defaulting to the CPU);
  * parity: the port's broker and agents and the reference's run the same
    PxL scripts over the same seeded numpy stores (the aggregate, a filter
    + group-by with p50, a join, a limit and a multi-widget request).
    Counts, integer sums, min, max and p50 match exactly, float sums and
    means to rtol 1e-12 (a different summation order);
  * the frames are the reference's: the reference's Client queries the
    port's Broker, and the port's Client queries the reference's Broker.

Every server binds port 0 and reads its port back.  The shared clusters are
module-scoped and stop their agents, then their broker (whose stop waits
for its connections' reader threads before it closes its KV).
"""
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu.services.agent import Agent as RefAgent
from pixie_tpu.services.broker import Broker as RefBroker
from pixie_tpu.services.client import Client as RefClient
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation

from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.engine.executor import HostBatch
from pixie_tpu_torch.parallel.cluster import LocalCluster
from pixie_tpu_torch.parallel.partial import PartialAggBatch
from pixie_tpu_torch.services import agent as _agent_mod
from pixie_tpu_torch.services import broker as _broker_mod
from pixie_tpu_torch.services import wire
from pixie_tpu_torch.services.client import Client, QueryError
from pixie_tpu_torch.services.kvstore import KVStore
from pixie_tpu_torch.services.registry import AgentRegistry
from pixie_tpu_torch.status import InvalidArgument, Unimplemented
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.types import DataType as DT, Relation


class Broker(_broker_mod.Broker):
    """The port's broker, on the CPU unless told otherwise."""

    def __init__(self, *a, device="cpu", **k):
        super().__init__(*a, device=device, **k)


class Agent(_agent_mod.Agent):
    """The port's agent, on the CPU unless told otherwise."""

    def __init__(self, *a, device="cpu", **k):
        super().__init__(*a, device=device, **k)


# ------------------------------------------------------------------ wire format


def test_wire_host_batch_roundtrip():
    d = Dictionary(["a", "b", "c"])
    hb = HostBatch(
        dtypes={"svc": DT.STRING, "lat": DT.FLOAT64, "n": DT.INT64},
        dicts={"svc": d},
        cols={
            "svc": np.array([0, 2, 1], dtype=np.int32),
            "lat": np.array([1.5, 2.5, 3.5]),
            "n": np.array([1, 2, 3], dtype=np.int64),
        },
    )
    kind, back = wire.decode_frame(wire.encode_host_batch(hb, {"msg": "chunk"}))
    assert kind == "host_batch"
    assert back.wire_meta["msg"] == "chunk"
    assert back.dtypes == hb.dtypes
    assert back.dicts["svc"].values() == ["a", "b", "c"]
    for c in hb.cols:
        np.testing.assert_array_equal(back.cols[c], hb.cols[c])


def test_wire_partial_agg_roundtrip_with_nested_state_and_upid_keys():
    pb = PartialAggBatch(
        key_cols={
            "svc": np.array(["x", None, "y"], dtype=object),
            "upid": np.array([(1, 2), (3, 4), None], dtype=object),
            "code": np.array([7, 8, 9], dtype=np.int64),
        },
        key_dtypes={"svc": DT.STRING, "upid": DT.UINT128, "code": DT.INT64},
        states={
            "m": {"sum": np.array([1.0, 2.0, 3.0]), "count": np.array([1, 1, 2])},
            "c": np.array([5, 6, 7], dtype=np.int64),
        },
        in_types={"m": DT.FLOAT64, "c": None},
    )
    kind, back = wire.decode_frame(pb.to_bytes())
    assert kind == "partial_agg"
    assert back.key_dtypes == pb.key_dtypes
    assert list(back.key_cols["svc"]) == ["x", None, "y"]
    from pixie_tpu_torch.types import UInt128

    assert list(back.key_cols["upid"]) == [UInt128(1, 2), UInt128(3, 4), None]
    np.testing.assert_array_equal(back.key_cols["code"], pb.key_cols["code"])
    np.testing.assert_array_equal(back.states["m"]["sum"], pb.states["m"]["sum"])
    np.testing.assert_array_equal(back.states["c"], pb.states["c"])
    assert back.in_types == pb.in_types


def test_wire_rejects_garbage():
    with pytest.raises(InvalidArgument):
        wire.decode_frame(b"NOPE" + b"\x00" * 20)
    with pytest.raises(InvalidArgument):
        wire.decode_frame(b"PXW1\xff\xff\xff\x7f")
    import inspect

    src = inspect.getsource(wire)
    assert "import pickle" not in src and "pickle.loads" not in src


def test_wire_rejects_overflowing_shape():
    import json as _json

    hdr = {"kind": "host_batch",
           "meta": {"dtypes": {"x": 2}, "dicts": {}, "order": ["x"]},
           "bufs": [{"name": "x", "dtype": "<i8", "nbytes": 0,
                     "shape": [2**62, 4]}]}
    hb = _json.dumps(hdr).encode()
    frame = wire._HDR.pack(wire.MAGIC, len(hb)) + hb
    with pytest.raises(InvalidArgument):
        wire.decode_frame(frame)


# --------------------------------------------------------------------- kvstore


def test_kvstore_durability(tmp_path):
    path = str(tmp_path / "ctl.db")
    kv = KVStore(path)
    kv.set("agent/a", b"111")
    kv.set_json("agent/b", {"x": 1})
    kv.set("other/z", b"zzz")
    assert [k for k, _ in kv.scan("agent/")] == ["agent/a", "agent/b"]
    kv.close()
    kv2 = KVStore(path)
    assert kv2.get("agent/a") == b"111"
    assert kv2.get_json("agent/b") == {"x": 1}
    kv2.delete("agent/a")
    assert kv2.get("agent/a") is None
    kv2.close()


# -------------------------------------------------------------------- registry


def test_registry_heartbeat_expiry_and_planning():
    rel = Relation.of(("time_", DT.TIME64NS), ("x", DT.INT64))
    reg = AgentRegistry(expiry_s=0.2)
    reg.register("pem1", {"t": rel})
    reg.register("pem2", {"t": rel})
    assert {a.name for a in reg.live_agents()} == {"pem1", "pem2"}
    spec = reg.cluster_spec()
    assert {a.name for a in spec.data_agents("t")} == {"pem1", "pem2"}
    t0 = time.monotonic()
    while time.monotonic() - t0 < 1.0:
        reg.heartbeat("pem1")
        time.sleep(0.05)
        if {a.name for a in reg.live_agents()} == {"pem1"}:
            break
    assert {a.name for a in reg.live_agents()} == {"pem1"}
    assert {a.name for a in reg.cluster_spec().data_agents("t")} == {"pem1"}
    reg.register("pem2", {"t": rel})
    assert {a.name for a in reg.live_agents()} == {"pem1", "pem2"}
    reg.kv.close()


def test_registry_persists_across_restart(tmp_path):
    path = str(tmp_path / "reg.db")
    rel = Relation.of(("x", DT.INT64))
    reg = AgentRegistry(KVStore(path))
    asid = reg.register("pem1", {"t": rel})
    reg.kv.close()
    reg2 = AgentRegistry(KVStore(path))
    assert reg2.live_agents() == []
    assert reg2.register("pem1", {"t": rel}) == asid
    reg2.kv.close()


# --------------------------------------------------- broker/agent/client (e2e)


def _mkstore(seed, n=20_000):
    rng = np.random.default_rng(seed)
    ts = TableStore()
    rel = Relation.of(
        ("time_", DT.TIME64NS), ("service", DT.STRING),
        ("latency", DT.FLOAT64), ("status", DT.INT64),
    )
    t = ts.create("http_events", rel, batch_rows=4096)
    t.write({
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "service": rng.choice(["cart", "auth", "web"], n).tolist(),
        "latency": rng.exponential(20.0, n),
        "status": rng.choice([200, 500], n),
    })
    return ts


SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status == 500]
df = df.groupby('service').agg(cnt=('latency', px.count), p50=('latency', px.p50))
px.display(df, 'out')
"""


def _start(stores, **broker_kw):
    broker = Broker(hb_expiry_s=1.0, query_timeout_s=30.0, **broker_kw).start()
    agents = [Agent(name, "127.0.0.1", broker.port, store=st, heartbeat_s=0.2).start()
              for name, st in stores.items()]
    return broker, agents


def _stop(client, agents, broker):
    client.close()
    for a in agents:
        a.stop()
    broker.stop()


@pytest.fixture(scope="module")
def cluster():
    stores = {"pem1": _mkstore(1), "pem2": _mkstore(2)}
    broker, agents = _start(stores)
    client = Client("127.0.0.1", broker.port, timeout_s=30.0)
    yield broker, stores, agents, client
    _stop(client, agents, broker)


def test_broker_distributed_query_matches_local(cluster):
    broker, stores, agents, client = cluster
    from pixie_tpu_torch import observe, trace
    expected = {"http_events", trace.SPANS_TABLE} | set(observe.SELF_TABLES)
    assert set(client.schemas()) == expected
    res = client.execute_script(SCRIPT)["out"]
    want = LocalCluster(stores, device="cpu").query(SCRIPT)["out"]
    got = res.to_pandas().sort_values("service").reset_index(drop=True)
    exp = want.to_pandas().sort_values("service").reset_index(drop=True)
    assert list(got["service"]) == list(exp["service"])
    assert list(got["cnt"]) == list(exp["cnt"])
    np.testing.assert_allclose(got["p50"], exp["p50"])
    assert "agents" in res.exec_stats
    # each agent ran its fragment on the device it was given
    for st in res.exec_stats["agents"].values():
        assert st["torch_device"] == "cpu" and st["kernel_launches"] == {}


def test_broker_plans_around_dead_agent():
    stores = {"pem1": _mkstore(1), "pem2": _mkstore(2)}
    broker, agents = _start(stores)
    client = Client("127.0.0.1", broker.port, timeout_s=30.0)
    try:
        res1 = client.execute_script(SCRIPT)["out"]
        total1 = res1.to_pandas()["cnt"].sum()
        agents[1].stop()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if {a.name for a in broker.registry.live_agents()} == {"pem1"}:
                break
            time.sleep(0.05)
        assert {a.name for a in broker.registry.live_agents()} == {"pem1"}
        res2 = client.execute_script(SCRIPT)["out"]
        total2 = res2.to_pandas()["cnt"].sum()
        assert 0 < total2 < total1  # pem1's rows only
        # exactly the surviving store's answer
        want = LocalCluster({"pem1": stores["pem1"]}, device="cpu").query(SCRIPT)["out"]
        got = res2.to_pandas().sort_values("service").reset_index(drop=True)
        exp = want.to_pandas().sort_values("service").reset_index(drop=True)
        assert got["cnt"].tolist() == exp["cnt"].tolist()
        assert got["p50"].tolist() == exp["p50"].tolist()
    finally:
        _stop(client, agents, broker)


def test_broker_compile_error_surfaces(cluster):
    _broker, _stores, _agents, client = cluster
    with pytest.raises(QueryError) as ei:
        client.execute_script("df = px.DataFrame(table='nope')\npx.display(df)")
    assert "nope" in str(ei.value)


SEQ_SCRIPT = """
df = px.DataFrame(table='seq0')
df = df.groupby('xmod10').agg(cnt=('x', px.count), s=('x', px.sum))
px.display(df, 'out')
"""


def test_two_process_demo():
    """Agent in a real subprocess (`--device cpu`) with a seq_gen collector;
    broker + client here."""
    broker = Broker(hb_expiry_s=2.0, query_timeout_s=60.0).start()
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "pixie_tpu_torch.services.agent",
            "--name", "pem-sub", "--broker", f"127.0.0.1:{broker.port}",
            "--connector", "seq_gen", "--heartbeat-s", "0.5", "--device", "cpu",
        ],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if any(a.name == "pem-sub" for a in broker.registry.live_agents()):
                break
            if proc.poll() is not None:
                raise AssertionError(
                    f"agent died: {proc.stderr.read().decode()[-2000:]}")
            time.sleep(0.1)
        assert any(a.name == "pem-sub" for a in broker.registry.live_agents())
        time.sleep(1.0)  # let seq_gen produce a few batches
        client = Client("127.0.0.1", broker.port, timeout_s=60.0)
        res = client.execute_script(SEQ_SCRIPT)["out"]
        df = res.to_pandas().sort_values("xmod10").reset_index(drop=True)
        assert len(df) == 10
        assert df["cnt"].sum() >= 1024  # at least one transfer landed
        n = int(df["cnt"].sum())
        xs = np.arange(n)
        want = {r: int(xs[xs % 10 == r].sum()) for r in range(10)}
        got = {int(r): int(s) for r, s in zip(df["xmod10"], df["s"])}
        assert got == want
        assert res.exec_stats["agents"]["pem-sub"]["torch_device"] == "cpu"
        client.close()
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
        broker.stop()


def test_agent_entry_point_without_a_card_raises():
    """With no card and no --device the agent exits with the error; it
    never carries on on the CPU."""
    out = subprocess.run(
        [sys.executable, "-m", "pixie_tpu_torch.services.agent", "--name", "x",
         "--broker", "127.0.0.1:9"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_broker_without_a_card_raises():
    with pytest.raises(Exception, match="no CUDA device"):
        _broker_mod.Broker()


# ------------------------------------------------------------------ auth + guards


def test_broker_auth_rejects_and_accepts():
    broker = Broker(hb_expiry_s=2.0, query_timeout_s=30.0, auth_token="s3cret").start()
    try:
        bad = Client("127.0.0.1", broker.port, timeout_s=5.0)
        with pytest.raises((QueryError, Exception)) as ei:
            bad.execute_script(SCRIPT)
        assert "auth" in str(ei.value).lower() or "closed" in str(ei.value).lower() \
            or "lost" in str(ei.value).lower()
        bad.close()
        bad2 = Client("127.0.0.1", broker.port, timeout_s=5.0, auth_token="wrong")
        with pytest.raises(Exception):
            bad2.schemas()
        bad2.close()
        agent = Agent("pem1", "127.0.0.1", broker.port, store=_mkstore(3),
                      heartbeat_s=0.2, auth_token="s3cret").start()
        ok = Client("127.0.0.1", broker.port, timeout_s=30.0, auth_token="s3cret")
        res = ok.execute_script(SCRIPT)["out"]
        assert res.to_pandas()["cnt"].sum() > 0
        ok.close()
        agent.stop()
    finally:
        broker.stop()


MUTATION_SCRIPT = '''
import pxtrace
import px

program = """kprobe:x { printf("time_:%llu pid:%u", nsecs, pid); }"""

def probe():
    pxtrace.UpsertTracepoint('p', 'p_table', program, pxtrace.kprobe(), "10m")
    return px.DataFrame(table='p_table')
'''


def test_tracepoint_mutations_are_refused_naming_their_item(cluster):
    broker = cluster[0]
    with pytest.raises(Unimplemented, match="item 6e"):
        broker.execute_script(MUTATION_SCRIPT, func="probe")


def test_part_two_entry_points_are_refused():
    with pytest.raises(Unimplemented, match="item 6d, part 2"):
        Broker.rehome_agent(None, "pem1")
    with pytest.raises(Unimplemented, match="item 6d, part 2"):
        Broker.retire_agent(None, "pem1")
    saved = port_flags.get("PL_REPLICATION")
    port_flags.set_for_testing("PL_REPLICATION", 2)
    try:
        with pytest.raises(Unimplemented, match="item 6d, part 2"):
            Broker()
        with pytest.raises(Unimplemented, match="item 6d, part 2"):
            Agent("pem1", "127.0.0.1", 9)
    finally:
        port_flags.set_for_testing("PL_REPLICATION", saved)
    port_flags.set_for_testing("PL_AUTOSCALE", True)
    b = Broker()
    try:
        with pytest.raises(Unimplemented, match="item 6d, part 2"):
            b.start()
    finally:
        port_flags.set_for_testing("PL_AUTOSCALE", False)
        b._server.stop()
        b.kv.close()


MULTI_FUNC_SCRIPT = """
import px

def widget_counts(start_time: str):
    df = px.DataFrame(table='http_events')
    df = df[df.status == 500]
    return df.groupby('service').agg(cnt=('latency', px.count))

def widget_p50(start_time: str):
    df = px.DataFrame(table='http_events')
    df = df[df.status == 500]
    return df.groupby('service').agg(p50=('latency', px.p50))
"""


def test_broker_multi_widget_fuses_shared_scan(cluster):
    broker, stores, agents, client = cluster
    funcs = [("w1", "widget_counts", {"start_time": "-5m"}),
             ("w2", "widget_p50", {"start_time": "-5m"})]
    results, stats = broker.execute_script(MULTI_FUNC_SCRIPT, funcs=funcs, analyze=True)
    sink_map = stats["sink_map"]
    assert set(sink_map) == {"w1", "w2"}
    for name, ag in stats["agents"].items():
        scans = [o for o in ag.get("operators", [])
                 if str(o.get("label", "")).startswith("scan(")]
        assert len(scans) == 1, (name, [o.get("label") for o in ag.get("operators", [])])
    for prefix, fn, fargs in funcs:
        solo, _ = broker.execute_script(MULTI_FUNC_SCRIPT, func=fn, func_args=fargs)
        for orig, fused_name in sink_map[prefix].items():
            got = results[fused_name].to_pandas().sort_values("service").reset_index(drop=True)
            exp = solo[orig].to_pandas().sort_values("service").reset_index(drop=True)
            for col in exp.columns:
                np.testing.assert_array_equal(got[col].to_numpy(), exp[col].to_numpy(),
                                              err_msg=col)
    wire_results = client.execute_script(MULTI_FUNC_SCRIPT, funcs=funcs)
    assert set(wire_results) == set(results)


# ------------------------------------------------------- parity: both packages


NOW = 1_700_000_000_000_000_000
PARITY_AGENTS = {"pem0": 0, "pem1": 1, "pem2": 2}


def _parity_tables(seed: int, n: int = 6000) -> dict:
    rng = np.random.default_rng(seed)
    services = ["cart", "auth", "web", "checkout"][: 2 + seed % 3]
    http = {
        "time_": NOW - np.arange(n, dtype=np.int64)[::-1] * 1_000_000,
        "service": rng.choice(services, n).tolist(),
        "latency": rng.exponential(20.0, n),
        "status": rng.choice([200, 404, 500], n),
        "resp_bytes": rng.integers(0, 1 << 20, n),
    }
    k = len(services)
    owners = {
        "time_": NOW - np.arange(k, dtype=np.int64)[::-1],
        "service": services,
        "team": [f"team{i % 2}" for i in range(k)],
    }
    return {"http_events": http, "owners": owners}


def _parity_store(pkg: str, tables: dict):
    ts, rel_cls, dt = ((RefStore(), RefRelation, RefDT) if pkg == "ref"
                       else (TableStore(), Relation, DT))
    ts.create("http_events", rel_cls.of(
        ("time_", dt.TIME64NS), ("service", dt.STRING), ("latency", dt.FLOAT64),
        ("status", dt.INT64), ("resp_bytes", dt.INT64)), batch_rows=1024
    ).write(tables["http_events"])
    ts.create("owners", rel_cls.of(
        ("time_", dt.TIME64NS), ("service", dt.STRING), ("team", dt.STRING)),
        batch_rows=64).write(tables["owners"])
    return ts


@pytest.fixture(scope="module")
def parity():
    """One port deployment and one reference deployment over the same
    seeded stores, standing views off in both (these cases measure the
    rescan route; tests/test_torch_serving.py runs views on)."""
    saved = (ref_flags.get("PL_MATVIEW_ENABLED"), port_flags.get("PL_MATVIEW_ENABLED"))
    ref_flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    tables = {a: _parity_tables(s) for a, s in PARITY_AGENTS.items()}
    port_broker, port_agents = _start({a: _parity_store("port", t) for a, t in tables.items()})
    ref_broker = RefBroker(hb_expiry_s=5.0, query_timeout_s=60.0).start()
    ref_agents = [RefAgent(a, "127.0.0.1", ref_broker.port, store=_parity_store("ref", t),
                           heartbeat_s=0.5, n_devices=1).start()
                  for a, t in tables.items()]
    clients = {"port": Client("127.0.0.1", port_broker.port, timeout_s=60.0),
               "ref": RefClient("127.0.0.1", ref_broker.port, timeout_s=60.0)}
    yield {"port": port_broker, "ref": ref_broker}, clients, tables
    for c in clients.values():
        c.close()
    for a in port_agents + ref_agents:
        a.stop()
    port_broker.stop()
    ref_broker.stop()
    ref_flags.set_for_testing("PL_MATVIEW_ENABLED", saved[0])
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", saved[1])


#: columns compared to rtol 1e-12 (float sums and means); every other
#: column, p50 included, exactly
APPROX = {"mean_lat", "sum_lat", "m"}


def assert_same_frame(got: pd.DataFrame, want: pd.DataFrame, by):
    got = got.sort_values(by).reset_index(drop=True)
    want = want.sort_values(by).reset_index(drop=True)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) > 0
    for c in got.columns:
        if c in APPROX:
            np.testing.assert_allclose(got[c].to_numpy(np.float64), want[c].to_numpy(np.float64),
                                       rtol=1e-12, atol=0, err_msg=c)
        else:
            assert got[c].tolist() == want[c].tolist(), c


PARITY_SCRIPTS = {
    "aggregate": ("""
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(cnt=('latency', px.count), sum_lat=('latency', px.sum),
                               mean_lat=('latency', px.mean), b=('resp_bytes', px.sum),
                               lo=('resp_bytes', px.min), hi=('resp_bytes', px.max))
px.display(df, 'out')
""", ["service"]),
    "filter_p50": ("""
df = px.DataFrame(table='http_events')
df = df[df.status != 200]
df = df.groupby(['service', 'status']).agg(cnt=('latency', px.count),
                                           p50=('latency', px.p50),
                                           hi=('latency', px.max))
px.display(df, 'out')
""", ["service", "status"]),
    "join": ("""
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(cnt=('latency', px.count), b=('resp_bytes', px.sum))
own = px.DataFrame(table='owners')
own = own.groupby(['service', 'team']).agg(n=('time_', px.count))
j = df.merge(own, how='inner', left_on='service', right_on='service', suffixes=['', '_o'])
j = j.groupby('team').agg(cnt=('cnt', px.sum), b=('b', px.sum))
px.display(j, 'out')
""", ["team"]),
}


@pytest.mark.parametrize("case", sorted(PARITY_SCRIPTS))
def test_port_broker_answers_as_the_reference_broker(parity, case):
    _brokers, clients, _tables = parity
    script, by = PARITY_SCRIPTS[case]
    got = clients["port"].execute_script(script)["out"].to_pandas()
    want = clients["ref"].execute_script(script)["out"].to_pandas()
    assert_same_frame(got, want, by)


LIMIT_SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status == 500]
df = df[['service', 'resp_bytes']]
px.display(df.head(25), 'out')
"""


def test_limit_gives_the_reference_count_of_real_rows(parity):
    """A limit over several agents keeps the first rows the merger sees
    (which agent's rows, the reference leaves open): both packages return
    the limit's count of rows, each one a row of the unlimited answer."""
    _brokers, clients, tables = parity
    full = set()
    for t in tables.values():
        h = t["http_events"]
        full.update((s, int(b)) for s, b, st in zip(h["service"], h["resp_bytes"], h["status"])
                    if st == 500)
    for pkg in ("port", "ref"):
        df = clients[pkg].execute_script(LIMIT_SCRIPT)["out"].to_pandas()
        assert len(df) == 25
        assert set(zip(df["service"], df["resp_bytes"].astype(int))) <= full


PARITY_WIDGETS = """
import px

def widget_counts(start_time: str):
    df = px.DataFrame(table='http_events')
    df = df[df.status == 500]
    return df.groupby('service').agg(cnt=('latency', px.count), b=('resp_bytes', px.sum))

def widget_p50(start_time: str):
    df = px.DataFrame(table='http_events')
    df = df[df.status == 500]
    return df.groupby('service').agg(p50=('latency', px.p50), m=('latency', px.mean))
"""


def test_multi_widget_request_answers_as_the_reference(parity):
    _brokers, clients, _tables = parity
    funcs = [("w1", "widget_counts", {"start_time": "-5m"}),
             ("w2", "widget_p50", {"start_time": "-5m"})]
    got = clients["port"].execute_script(PARITY_WIDGETS, funcs=funcs)
    want = clients["ref"].execute_script(PARITY_WIDGETS, funcs=funcs)
    assert set(got) == set(want) and len(got) == 2
    for name in got:
        assert_same_frame(got[name].to_pandas(), want[name].to_pandas(), ["service"])


def test_the_frames_are_the_references(parity):
    """The reference's Client against the port's Broker, and the port's
    Client against the reference's Broker: schemas and answers as each
    package's own client gets them."""
    brokers, clients, _tables = parity
    script, by = PARITY_SCRIPTS["aggregate"]
    ref_to_port = RefClient("127.0.0.1", brokers["port"].port, timeout_s=60.0)
    port_to_ref = Client("127.0.0.1", brokers["ref"].port, timeout_s=60.0)
    try:
        assert set(ref_to_port.schemas()) >= {"http_events", "owners"}
        assert set(port_to_ref.schemas()) >= {"http_events", "owners"}
        a = ref_to_port.execute_script(script)["out"].to_pandas()
        b = port_to_ref.execute_script(script)["out"].to_pandas()
        want = clients["ref"].execute_script(script)["out"].to_pandas()
        assert_same_frame(a, want, by)
        assert_same_frame(b, want, by)
        with pytest.raises(Exception, match="nope"):
            ref_to_port.execute_script("df = px.DataFrame(table='nope')\npx.display(df)")
    finally:
        ref_to_port.close()
        port_to_ref.close()


# ------------------------------------------------ standing views via the broker


MV_SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status == 500]
df = df.groupby('service').agg(
    cnt=('latency', px.count), s=('latency', px.sum),
    lo=('latency', px.min), hi=('latency', px.max))
px.display(df, 'out')
"""


def test_matview_spans_and_broker_stats():
    """tests/test_matview.py's spans-table case: the second query answers
    from the agent's standing view, the broker's per-query stats count
    the eligible and hit agents, and the view's spans land in the agent's
    spans table; the view's answer equals the rescan."""
    saved = port_flags.get("PL_MATVIEW_ENABLED")
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", True)
    store = _mkstore(14, n=30_000)
    broker, agents = _start({"pem1": store})
    try:
        cold, st0 = broker.execute_script(MV_SCRIPT)
        assert st0["matview"] == {"eligible_agents": 1, "agents_hit": 0,
                                  "rows_folded": 0, "keys": st0["matview"]["keys"]}
        warm, stats = broker.execute_script(MV_SCRIPT)
        assert stats["matview"]["eligible_agents"] == 1
        assert stats["matview"]["agents_hit"] == 1
        a, b = (r["out"].to_pandas().sort_values("service").reset_index(drop=True)
                for r in (cold, warm))
        for c in ("service", "cnt", "lo", "hi"):
            assert a[c].tolist() == b[c].tolist(), c
        np.testing.assert_allclose(a["s"], b["s"], rtol=1e-12, atol=0)
        names = set()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            t = store.table("self_telemetry.spans")
            d = t.dictionaries["name"]
            names = {str(d.decode([c])[0]) for rb, _rid, _gen in t.cursor()
                     for c in rb.columns["name"][: rb.num_valid]}
            if {"matview_refresh", "matview_hit"} <= names:
                break
            time.sleep(0.05)
        assert {"matview_refresh", "matview_hit"} <= names
    finally:
        for a_ in agents:
            a_.stop()
        broker.stop()
        port_flags.set_for_testing("PL_MATVIEW_ENABLED", saved)


def test_autotune_seams_set_the_hedge_floor_and_batch_window(cluster, monkeypatch):
    """With autotune on, the broker's hedge deadline takes the model's
    hedge floor and its batching gate the model's window
    (engine/autotune.py `hedge_floor_s`, `batch_window`)."""
    from pixie_tpu_torch.engine import autotune
    from pixie_tpu_torch.serving import batching

    broker = cluster[0]
    calls = {}
    monkeypatch.setattr(autotune, "enabled", lambda: True)
    monkeypatch.setattr(autotune.MODEL, "hedge_floor_s",
                        lambda floor: calls.setdefault("hedge", (0.0123, {"gate": "hedge"})))
    monkeypatch.setattr(autotune.MODEL, "batch_window",
                        lambda w, n: calls.setdefault("window", (0.004, 3, {"gate": "batch"})))
    seen = {}

    def gate(collector, plan, key, epoch, window_s, max_n, run, **kw):
        seen["window"] = (window_s, max_n)
        return None  # run the normal path

    monkeypatch.setattr(batching, "gate", gate)
    broker._svc["pemX"] = {"ewma": 0.001, "dev": 0.0, "n": 99, "at": 0.0}
    port_flags.set_for_testing("PL_HEDGE_FACTOR", 3.0)
    assert broker._hedge_deadline_s("pemX") == pytest.approx(0.0123)
    broker._svc.pop("pemX")
    broker.execute_script(SCRIPT)
    assert seen["window"] == (0.004, 3)
    assert set(calls) == {"hedge", "window"}


def test_heat_map_gathers_every_agents_storage_report(cluster):
    """The broker's heat_map RPC asks each live agent for its storage
    report (decayed shard heat and storage state) and rolls them up."""
    broker, stores, agents, client = cluster
    client.execute_script(SCRIPT)
    hm = client.heat_map()
    assert set(hm["agents"]) == set(stores)
    for name, rep in hm["agents"].items():
        assert "error" not in rep, rep
        assert any(r["table_name"] == "http_events" for r in rep["storage_state"])
    # the heat model is the process's: in-process agents of other clusters
    # (this module's others) report their shards too
    assert set(stores) <= set(hm["tables"]["http_events"]["shards"])
