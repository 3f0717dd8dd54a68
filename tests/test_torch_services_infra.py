"""G11 services infrastructure: healthz probes, per-query result-stream
tokens, leader election — tests/test_services_infra.py's cases (and the KV
cases of tests/test_durability.py) against the port's services, on the CPU.

Reference: src/shared/services/ (healthz, JWT auth context, election/) and
the per-query auth token on result streams (carnotpb/carnot.proto:30-96).
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from pixie_tpu_torch.services import wire
from test_torch_services import Agent  # the port's, on the CPU
from test_torch_services import Broker  # the port's, on the CPU
from pixie_tpu_torch.services.client import Client
from pixie_tpu_torch.services.election import LeaderElector
from pixie_tpu_torch.services.health import HealthzServer
from pixie_tpu_torch.services.kvstore import KVStore
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation

SCRIPT = """
df = px.DataFrame(table='http_events')
df = df.groupby('service').agg(cnt=('latency', px.count))
px.display(df, 'out')
"""


def _mkstore(seed):
    rng = np.random.default_rng(seed)
    ts = TableStore()
    rel = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                      ("latency", DT.FLOAT64))
    t = ts.create("http_events", rel, batch_rows=512)
    n = 500
    t.write({
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "service": rng.choice(["cart", "web"], n).tolist(),
        "latency": rng.exponential(20.0, n),
    })
    return ts


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=5) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


# ----------------------------------------------------------------- healthz
def test_healthz_server_checks_pass_and_fail():
    flag = {"ok": True}
    srv = HealthzServer(checks={
        "good": lambda: True,
        "toggle": lambda: flag["ok"],
    }).start()
    try:
        code, body = _get(srv.port, "/healthz")
        assert code == 200 and json.loads(body)["ok"] is True
        flag["ok"] = False
        code, body = _get(srv.port, "/healthz")
        out = json.loads(body)
        assert code == 503 and out["ok"] is False
        assert out["checks"]["toggle"] == "failed"
        assert out["checks"]["good"] == "ok"
    finally:
        srv.stop()


def test_healthz_metrics_endpoint():
    from pixie_tpu_torch import metrics

    metrics.counter_inc("px_test_healthz_counter", help_="test")
    srv = HealthzServer().start()
    try:
        code, body = _get(srv.port, "/metrics")
        assert code == 200
        assert "px_test_healthz_counter" in body
    finally:
        srv.stop()


def test_broker_and_agent_healthz_probes():
    broker = Broker(hb_expiry_s=2.0, healthz_port=0).start()
    agent = None
    try:
        code, body = _get(broker.healthz.port, "/healthz")
        assert code == 200 and json.loads(body)["ok"] is True
        agent = Agent("pem1", "127.0.0.1", broker.port, store=_mkstore(1),
                      heartbeat_s=0.2, healthz_port=0).start()
        code, body = _get(agent.healthz.port, "/healthz")
        out = json.loads(body)
        assert code == 200 and out["ok"] is True
        assert out["checks"]["broker_conn"] == "ok"
    finally:
        if agent is not None:
            agent.stop()
        broker.stop()
    # after stop, the agent's conn is closed → probe logic reports unhealthy
    ok, results = (agent.healthz.run_checks() if agent else (False, {}))
    assert ok is False


# ------------------------------------------------------- per-query tokens
@pytest.fixture
def cluster():
    """One deployment a test: the token cases replace the agent's
    `_execute` and the client's timeout."""
    broker = Broker(hb_expiry_s=2.0, query_timeout_s=30.0).start()
    agent = Agent("pem1", "127.0.0.1", broker.port, store=_mkstore(1),
                  heartbeat_s=0.2).start()
    client = Client("127.0.0.1", broker.port, timeout_s=30.0)
    yield broker, agent, client
    client.close()
    agent.stop()
    broker.stop()


def test_query_carries_token_and_results_flow(cluster):
    broker, agent, client = cluster
    res = client.execute_script(SCRIPT)["out"]
    assert res.to_pandas()["cnt"].sum() == 500


def test_stale_token_frames_are_dropped(cluster):
    """A producer echoing the wrong qtoken must not complete the query or
    inject payloads (the reference rejects result streams whose per-query
    auth token mismatches)."""
    broker, agent, client = cluster

    # intercept the execute frame and reply with a BAD token
    done = threading.Event()
    orig_execute = agent._execute

    def evil_execute(meta):
        meta = dict(meta)
        meta["qtoken"] = "forged-token"
        orig_execute(meta)
        done.set()

    agent._execute = evil_execute
    from pixie_tpu_torch import metrics as _metrics

    from pixie_tpu_torch.status import Unavailable

    client.timeout_s = 3.0
    with pytest.raises(Unavailable, match="timed out"):
        client.execute_script(SCRIPT)
    assert done.wait(5.0)  # the agent DID run and reply — frames dropped
    rendered = _metrics.render()
    assert "px_broker_stale_token_frames_total" in rendered


def test_exec_error_with_wrong_token_ignored(cluster):
    broker, agent, client = cluster
    # forge an exec_error for a live query with a bad token: query should
    # still complete successfully from the real agent
    orig_execute = agent._execute

    def racing_execute(meta):
        agent.conn.send(wire.encode_json({
            "msg": "exec_error", "req_id": meta.get("req_id"),
            "qtoken": "wrong", "agent": "evil", "error": "forged",
        }))
        orig_execute(meta)

    agent._execute = racing_execute
    res = client.execute_script(SCRIPT)["out"]
    assert res.to_pandas()["cnt"].sum() == 500


# --------------------------------------------------------------- election
def test_leader_election_acquire_renew_steal():
    kv = KVStore(":memory:")
    a = LeaderElector(kv, "broker", "a", ttl_s=0.5)
    b = LeaderElector(kv, "broker", "b", ttl_s=0.5)
    assert a.try_acquire() is True
    assert b.try_acquire() is False
    assert a.is_leader() and not b.is_leader()
    assert b.leader() == "a"
    # renewal keeps the lease
    assert a.try_acquire() is True
    # resign → immediate takeover
    a.resign()
    assert b.try_acquire() is True
    assert b.is_leader() and b.leader() == "b"
    # expiry → stealable
    time.sleep(0.6)
    assert a.try_acquire() is True
    assert a.leader() == "a"


def test_healthz_stop_before_start_does_not_hang():
    srv = HealthzServer()
    srv.stop()  # must return immediately, not block on shutdown()


def test_standby_passes_healthz_but_fails_readyz():
    """Leadership is a READINESS concern: a healthy standby must return 200
    on /healthz (else a liveness probe would restart it in a loop) and 503
    on /readyz."""
    kv = KVStore(":memory:")
    leader = LeaderElector(kv, "broker", "b1", ttl_s=5.0)
    standby = LeaderElector(kv, "broker", "b2", ttl_s=5.0)
    leader.try_acquire()
    standby.try_acquire()
    srv = HealthzServer(
        checks={"server": lambda: True},
        ready_checks={"leader": standby.is_leader}).start()
    try:
        code, _ = _get(srv.port, "/healthz")
        assert code == 200
        code, body = _get(srv.port, "/readyz")
        assert code == 503
        assert json.loads(body)["checks"]["leader"] == "failed"
    finally:
        srv.stop()


def test_broker_failed_init_leaks_nothing():
    """A constructor raise (election over :memory:) must not leave a bound
    server socket behind."""
    from pixie_tpu_torch.status import InvalidArgument

    with pytest.raises(InvalidArgument):
        Broker(election_id="b1")
    # constructing again on the same fixed port would fail if the socket
    # leaked; use a fixed port twice to prove cleanliness
    b = Broker(port=0)
    port = b.port
    b.stop()
    b2 = Broker(port=port)
    assert b2.port == port
    b2.stop()


def test_kv_cas_is_atomic_compare_and_set():
    kv = KVStore(":memory:")
    assert kv.cas("k", None, b"v1") is True
    assert kv.cas("k", None, b"v2") is False       # stale expectation
    assert kv.get("k") == b"v1"
    assert kv.cas("k", b"v1", b"v2") is True
    assert kv.get("k") == b"v2"


def test_election_racing_acquires_one_winner():
    """N threads racing for an expired lease: exactly one wins (the CAS
    split-brain regression)."""
    kv = KVStore(":memory:")
    electors = [LeaderElector(kv, "broker", f"b{i}", ttl_s=5.0)
                for i in range(8)]
    barrier = threading.Barrier(8)
    wins = []

    def race(el):
        barrier.wait()
        if el.try_acquire():
            wins.append(el.instance_id)

    ts = [threading.Thread(target=race, args=(e,)) for e in electors]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(wins) == 1


def test_election_resign_does_not_clobber_stolen_lease():
    kv = KVStore(":memory:")
    a = LeaderElector(kv, "broker", "a", ttl_s=0.2)
    b = LeaderElector(kv, "broker", "b", ttl_s=5.0)
    assert a.try_acquire() is True
    time.sleep(0.3)                    # a's lease expires
    assert b.try_acquire() is True     # b steals
    a.resign()                         # a's resign must not delete b's lease
    assert b.leader() == "b"


def test_broker_election_rejects_memory_datastore():
    from pixie_tpu_torch.status import InvalidArgument

    with pytest.raises(InvalidArgument, match="shared --datastore"):
        Broker(election_id="b1")


def test_standby_broker_rejects_queries_until_leader():
    from pixie_tpu_torch.status import Unavailable

    kv = KVStore(":memory:")
    leader_el = LeaderElector(kv, "broker", "b1", ttl_s=5.0)
    standby_el = LeaderElector(kv, "broker", "b2", ttl_s=5.0)
    leader_el.try_acquire()
    standby_el.try_acquire()

    standby = Broker(hb_expiry_s=2.0, elector=standby_el)
    agent_store = _mkstore(1)
    standby.registry.register("pem1", agent_store.schemas(), None)
    with pytest.raises(Unavailable, match="not the leader"):
        standby.execute_script(SCRIPT)
    # leader dies/resigns → standby takes over and serves
    leader_el.resign()
    assert standby_el.try_acquire() is True
    # (query now fails later in the pipeline — on the dead agent conn —
    # but NOT on leadership)
    with pytest.raises(Exception) as ei:
        standby.execute_script(SCRIPT)
    assert "not the leader" not in str(ei.value)
    standby.kv.close()


# ------------------------------------------- tests/test_durability.py's cases


def test_kvstore_wal_reopen_after_kill(tmp_path):
    path = str(tmp_path / "kv.db")
    kv = KVStore(path)
    assert kv._conn.execute("PRAGMA journal_mode").fetchone()[0] == "wal"
    for i in range(50):
        kv.set(f"k/{i}", str(i).encode())
    assert kv.cas("lease", None, b"owner-a")
    kv2 = KVStore(path)
    assert kv2.get("k/49") == b"49"
    assert sum(1 for _ in kv2.scan("k/")) == 50
    assert not kv2.cas("lease", None, b"owner-b")  # lease still held
    assert kv2.cas("lease", b"owner-a", b"owner-b")
    kv2.close()
    kv.close()


@pytest.mark.parametrize("path", [":memory:", "FILE"])
def test_kvstore_concurrent_cas_stress(tmp_path, path):
    kv = KVStore(str(tmp_path / "kv.db") if path == "FILE" else path)
    kv.set("ctr", b"0")
    wins = []

    def worker():
        w = 0
        for _ in range(200):
            while True:
                cur = kv.get("ctr")
                if kv.cas("ctr", cur, str(int(cur) + 1).encode()):
                    w += 1
                    break
        wins.append(w)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert int(kv.get("ctr")) == sum(wins) == 8 * 200
    kv.close()


def test_capped_label_bounds_id_space():
    from pixie_tpu_torch import metrics

    metrics.reset_for_testing()
    try:
        for i in range(metrics.MAX_LABEL_IDS):
            assert metrics.capped_label("agent", f"a{i}") == f"a{i}"
        assert metrics.capped_label("agent", "overflow") == "__other__"
        assert metrics.capped_label("agent", "a0") == "a0"
        assert metrics.capped_label("tenant", "overflow") == "overflow"
    finally:
        metrics.reset_for_testing()


def test_broker_stop_ends_every_thread_before_it_closes_the_kv(tmp_path):
    """stop() waits for the connections' reader threads, the expiry loop
    and the client query threads, so none of them writes the KV after it
    is closed (the reference's leaves "Cannot operate on a closed
    database" from a reader thread)."""
    broker = Broker(datastore_path=str(tmp_path / "ctl.db"), hb_expiry_s=0.3,
                    query_timeout_s=30.0).start()
    agent = Agent("pem1", "127.0.0.1", broker.port, store=_mkstore(1),
                  heartbeat_s=0.05).start()
    client = Client("127.0.0.1", broker.port, timeout_s=30.0)
    client.execute_script(SCRIPT)
    readers = [c._thread for c in broker._server._conns]
    assert readers
    broker.stop()  # the agent still heartbeats into it
    assert not broker._expiry_thread.is_alive()
    assert not any(t.is_alive() for t in readers)
    with broker._qlock:
        assert not broker._query_threads
    client.close()
    agent.stop()
