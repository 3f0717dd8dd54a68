"""Cron script runner (reference script_runner/script_runner.go:47-54):
tests/test_cron.py's cases against the port's CronScriptRunner and broker
(on the CPU)."""
import numpy as np

from pixie_tpu_torch.services.cron import CronScriptRunner
from pixie_tpu_torch.services.kvstore import KVStore


def test_run_due_and_state():
    ran = []

    def execute(script, func, func_args):
        ran.append((script, func))
        return {"out": "results"}

    got = []
    r = CronScriptRunner(execute, on_result=lambda n, res: got.append((n, res)))
    r.upsert("a", "script-a", interval_s=10)
    r.upsert("b", "script-b", interval_s=100)
    assert r.run_due(now=1000.0) == 2
    assert r.run_due(now=1005.0) == 0  # neither due
    assert r.run_due(now=1011.0) == 1  # only 'a'
    assert [n for n, _ in got] == ["a", "b", "a"]
    cs = {c.name: c for c in r.list()}
    assert cs["a"].run_count == 2 and cs["b"].run_count == 1
    assert cs["a"].last_error == ""


def test_errors_recorded_not_fatal():
    def execute(script, func, func_args):
        raise RuntimeError("compile failed")

    r = CronScriptRunner(execute)
    r.upsert("bad", "x", interval_s=1)
    assert r.run_due(now=10.0) == 1
    cs = r.list()[0]
    assert cs.error_count == 1 and "compile failed" in cs.last_error


def test_persistence_roundtrip(tmp_path):
    kv = KVStore(str(tmp_path / "c.db"))
    r = CronScriptRunner(lambda *a: {}, kv=kv)
    r.upsert("keeper", "import px", interval_s=30, func="f", func_args={"x": 1})
    r2 = CronScriptRunner(lambda *a: {}, kv=kv)
    cs = r2.list()[0]
    assert cs.name == "keeper" and cs.interval_s == 30
    assert cs.func == "f" and cs.func_args == {"x": 1}
    r2.delete("keeper")
    assert CronScriptRunner(lambda *a: {}, kv=kv).list() == []
    kv.close()


def test_broker_cron_end_to_end():
    """Cron script with an OTel export runs against live agents on schedule."""
    import time

    from pixie_tpu_torch.services import wire
    from pixie_tpu_torch.services.transport import recv_frame, send_frame
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import DataType as DT, Relation
    from test_torch_services import Agent, Broker  # the port's, on the CPU

    broker = Broker().start()
    ts = TableStore()
    ts.create("t", Relation.of(("time_", DT.TIME64NS), ("x", DT.INT64)))
    ts.table("t").write({"time_": np.arange(10, dtype=np.int64),
                         "x": np.arange(10)})
    agent = Agent("pem1", "127.0.0.1", broker.port, store=ts,
                  heartbeat_s=0.2).start()
    try:
        import socket

        s = socket.create_connection(("127.0.0.1", broker.port))
        send_frame(s, wire.encode_json({
            "msg": "cron_upsert", "req_id": "c1", "name": "counter",
            "script": (
                "import px\n"
                "df = px.DataFrame(table='t')\n"
                "df = df.agg(cnt=('x', px.count))\n"
                "px.display(df, 'o')\n"
            ),
            "interval_s": 0.2,
        }))
        _k, payload = wire.decode_frame(recv_frame(s))
        assert payload["msg"] == "ok"
        deadline = time.monotonic() + 15
        runs = 0
        while time.monotonic() < deadline:
            send_frame(s, wire.encode_json({"msg": "cron_list", "req_id": "c2"}))
            _k, payload = wire.decode_frame(recv_frame(s))
            runs = payload["scripts"][0]["run_count"]
            if runs >= 2:
                break
            time.sleep(0.2)
        assert runs >= 2, payload
        assert payload["scripts"][0]["error_count"] == 0
        s.close()
    finally:
        agent.stop()
        broker.stop()
