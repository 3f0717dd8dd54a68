"""The port's socket tracer (collect/tracer.py, collect/tap.py,
collect/protocols/) against the reference's, on the seeded traffic of
pixie_tpu_torch/testing/socket_traffic.py (every protocol's exchanges as
bytes, with the rows they must give), over chip_smoke.py's UPID topology
(1,088 UPIDs on 4 nodes).

Each protocol's stream, cut at three seeded segmentations, goes through
both packages' SocketTraceConnector (one a node, asid node + 1, as in the
smoke):

  * drained whole (every event in one drain): every table equals the
    reference's column by column, exactly and in order, and so do the
    connectors' stats (parse_errors among them); conn_stats' time_ is the
    drain's clock, compared only as non-decreasing; but for the PgSQL
    connections that start up, where the reference pairs the startup's
    ReadyForQuery with the first query and the port's rows are the
    generator's (test_startup_ready_for_query_answers_no_query pins it);
  * drained every 0.2 s of the traffic's clock, as a live tracer polls:
    the port's rows equal the generator's (every column it knows, time_
    and latency exactly) and parse_errors the garbage-led connections.
    Here the reference differs (ROADMAP Queue 3, known differences): a
    frame that starts a chunk appended to a drained buffer takes the
    previous chunk's time there, so its time_ and latency are another
    exchange's, and stitchers that match by time drop or mispair rows.
    test_reference_restamps_frames_after_a_drained_buffer pins that.

Then the reaped-connection guard, undecodable chatter, and the tapped
live process of tests/test_metadata_live.py (ctx['pod'] on the port's
CPU route)."""
from __future__ import annotations

import json
import os
import socket
import threading

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (JAX first: x64 on)
from pixie_tpu.collect import Collector as RefCollector
from pixie_tpu.collect import tracer as ref_tracer

from pixie_tpu_torch.collect import Collector
from pixie_tpu_torch.collect import tracer
from pixie_tpu_torch.collect.schemas import SCHEMAS
from pixie_tpu_torch.testing import socket_traffic as traffic

PROTOCOLS = ("http",) + traffic.PROTOCOLS
#: each UPID index's node: 1,024 bound UPIDs four to a pod, pod p on node
#: p % 4, and 64 unbound ones on node u % 4
NODES = 4
NODE_OF_UPID = np.where(np.arange(1088) < 1024, (np.arange(1088) // 4) % NODES,
                        np.arange(1088) % NODES)
SEGMENTATIONS = (11, 12, 13)
#: 32 connections of 16 exchanges a protocol; a tenth of the non-HTTP/1
#: connections garbage-led
CONNS, PER_CONN = 32, 16


def _traffic(proto: str):
    i = PROTOCOLS.index(proto)
    return traffic.Traffic(proto, CONNS, PER_CONN, seed=100 + i, node_of_upid=NODE_OF_UPID,
                           garbage_frac=0.0 if proto == "http" else 0.1, cid0=(i + 1) << 16)


def _collector(mod, coll_cls, sources: dict):
    col, conns = coll_cls(), []
    for node, src in sorted(sources.items()):
        conns.append(mod.SocketTraceConnector(src, asid=node + 1,
                                              name=f"socket_tracer_{node}"))
        col.register(conns[-1])
    return col, conns


def _drain(col) -> None:
    while col.connectors():
        col.transfer_once()


def _table_rows(table) -> list[tuple]:
    """Every column of every row, decoded; UPIDs as (high, low)."""
    names = [c.name for c in table.relation]
    parts = {c: [] for c in names}
    for rb, _rid, _gen in table.cursor():
        n = rb.num_valid
        for c in names:
            v = rb.columns[c][:n]
            d = table.dictionaries.get(c)
            vals = d.decode(v) if d is not None else np.asarray(v).tolist()
            if c == "upid":
                vals = [(u.high, u.low) for u in vals]
            parts[c].extend(vals)
    return list(zip(*(parts[c] for c in names)))


def _run(mod, coll_cls, gen, events, keys, windowed: bool, tmp_path=None):
    """Both packages drive the same events: a capture file a node for
    HTTP/1 (written by the package's own write_capture), else a queue a
    node; → (store, stats summed over the connectors)."""
    node_of = traffic.node_of([gen])
    if gen.protocol == "http":
        per_drain = 64 if windowed else len(events) + 1
        sources = {}
        for n in range(NODES):
            path = str(tmp_path / f"{mod.__name__}-{n}.jsonl")
            mod.write_capture(path, (ev for ev in events if node_of[ev["conn"]] == n))
            sources[n] = mod.CaptureFileSource(path, events_per_drain=per_drain)
        col, conns = _collector(mod, coll_cls, sources)
        _drain(col)
    else:
        sources = {n: mod.QueueEventSource() for n in range(NODES)}
        col, conns = _collector(mod, coll_cls, sources)
        if windowed:
            traffic.feed_windows(col, sources, node_of, events, keys)
        else:
            for ev in events:
                sources[node_of[ev["conn"]]].emit(ev)
            for src in sources.values():
                src.finish()
            _drain(col)
    stats = {k: sum(c.stats[k] for c in conns) for k in conns[0].stats}
    return col.store, stats


@pytest.mark.parametrize("seg", SEGMENTATIONS)
@pytest.mark.parametrize("proto", PROTOCOLS)
def test_tables_equal_the_reference_drained_whole(proto, seg, tmp_path):
    gen = _traffic(proto)
    events, keys = gen.events(seg_seed=seg)
    ref, ref_stats = _run(ref_tracer, RefCollector, gen, events, keys, False, tmp_path)
    got, stats = _run(tracer, Collector, gen, events, keys, False, tmp_path)
    assert stats == ref_stats
    assert stats["events"] == len(events) and stats["unknown_protocol_conns"] == 0
    table = traffic.TABLES[proto]
    assert sorted(got.schemas()) == sorted(ref.schemas())
    rows, want = _table_rows(got.table(table)), _table_rows(ref.table(table))
    # drained whole, a garbage lead shares its buffer with the frames after
    # it, so a resync may land on a false boundary: in both packages alike
    assert len(rows) >= sum(len(c.rows) for c in gen.conns if not c.garbage)
    if proto == "pgsql":
        rows, want = _pgsql_startups_apart(gen, got.table(table), rows, want)
    assert rows == want
    conn_rows = _table_rows(got.table("conn_stats"))
    ref_conn_rows = _table_rows(ref.table("conn_stats"))
    assert [r[1:] for r in conn_rows] == [r[1:] for r in ref_conn_rows]
    assert len(conn_rows) == CONNS
    t = [r[0] for r in conn_rows]
    assert t == sorted(t)
    if proto == "http":
        for n in range(NODES):
            a = tmp_path / f"{ref_tracer.__name__}-{n}.jsonl"
            b = tmp_path / f"{tracer.__name__}-{n}.jsonl"
            assert a.read_bytes() == b.read_bytes()


def _pgsql_startups_apart(gen, table, rows, want):
    """PgSQL connections that start up, where the reference pairs the
    startup's ReadyForQuery with the first query (ROADMAP Queue 3, known
    differences): there the port's rows are the generator's and the
    reference's are not.  → the other connections' rows, port and
    reference, for the column-by-column comparison."""
    startup = (196608).to_bytes(4, "big")
    started = {c.addr for c in gen.conns
               if any(d == "recv" and m[4:8] == startup for d, _ts, m, _cut in c.msgs)}
    assert 0 < len(started) < len(gen.conns)
    truth = [r for r in gen.truth() if r["remote_addr"] in started]
    cols = list(truth[0])
    port = [r for r in traffic.table_rows(table, cols, traffic.upid_index(NODE_OF_UPID))
            if r[cols.index("remote_addr")] in started]
    assert sorted(port) == sorted(tuple(r[c] for c in cols) for r in truth)
    at = [c.name for c in table.relation].index("remote_addr")
    assert [r for r in rows if r[at] in started] != [r for r in want if r[at] in started]
    return ([r for r in rows if r[at] not in started],
            [r for r in want if r[at] not in started])


def _truth_rows(store, table, want, upid_index) -> None:
    assert traffic.hold(table, store.table(table), want, upid_index) == len(want)


@pytest.mark.parametrize("seg", SEGMENTATIONS)
@pytest.mark.parametrize("proto", PROTOCOLS)
def test_windowed_rows_equal_the_generator(proto, seg, tmp_path):
    gen = _traffic(proto)
    events, keys = gen.events(seg_seed=seg)
    got, stats = _run(tracer, Collector, gen, events, keys, True, tmp_path)
    upid_index = traffic.upid_index(NODE_OF_UPID)
    _truth_rows(got, traffic.TABLES[proto], gen.truth(), upid_index)
    _truth_rows(got, "conn_stats", gen.conn_stats(), upid_index)
    assert stats["parse_errors"] == sum(c.garbage for c in gen.conns)
    assert stats["unknown_protocol_conns"] == 0 and stats["late_events_dropped"] == 0
    assert stats["records"] == len(gen.truth())


def test_generator_cuts_every_segmentation_differently():
    gen = _traffic("mysql")
    cuts = [[len(e.get("data", b"")) for e in gen.events(seg_seed=s)[0]] for s in SEGMENTATIONS]
    assert len({tuple(c) for c in cuts}) == 3
    assert len({sum(c) for c in cuts}) == 1


def test_reference_restamps_frames_after_a_drained_buffer():
    """A keep-alive connection's second exchange (sent at 1000, answered at
    1900): the reference stamps it with the first exchange's times, the
    port with its own."""
    from pixie_tpu.collect.protocols import ConnTracker as RefTracker
    from pixie_tpu.collect.protocols.http import HTTPParser as RefHTTP

    from pixie_tpu_torch.collect.protocols import ConnTracker
    from pixie_tpu_torch.collect.protocols.http import HTTPParser

    def rows(tr):
        out = []
        for k, (tq, tp) in enumerate([(100, 150), (1000, 1900)]):
            tr.add_data("recv", b"GET /%d HTTP/1.1\r\n\r\n" % k, tq)
            tr.process()
            tr.add_data("send", b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n", tp)
            out += [(r["time_"], r["latency"]) for r in map(tr.parser.record_row, tr.process())]
        return out

    assert rows(ConnTracker(HTTPParser(), role=2)) == [(150, 50), (1900, 900)]
    assert rows(RefTracker(RefHTTP(), role=2)) == [(150, 50), (150, 50)]


def test_startup_ready_for_query_answers_no_query():
    """A PgSQL startup answered as a server does (authentication ok, a
    parameter status, the backend key, ReadyForQuery), then two queries:
    the port pairs each query with its own response; the reference pairs
    the startup's ReadyForQuery with the first, and the first's response
    with the second."""
    from pixie_tpu.collect.protocols import ConnTracker as RefTracker
    from pixie_tpu.collect.protocols.pgsql import PgSQLParser as RefPgSQL

    from pixie_tpu_torch.collect.protocols import ConnTracker
    from pixie_tpu_torch.collect.protocols.pgsql import PgSQLParser

    def msg(tag, payload):
        return tag + (len(payload) + 4).to_bytes(4, "big") + payload

    def rows(tr):
        params = b"user\x00app\x00\x00"
        tr.add_data("recv", (8 + len(params)).to_bytes(4, "big")
                    + (196608).to_bytes(4, "big") + params, 1)
        tr.add_data("send", msg(b"R", bytes(4)) + msg(b"S", b"server_version\x0016.1\x00")
                    + msg(b"K", bytes(8)) + msg(b"Z", b"I"), 2)
        for q, tq, tp in ((b"SELECT 1;", 100, 150), (b"SELECT 2;", 1000, 1900)):
            tr.add_data("recv", msg(b"Q", q + b"\x00"), tq)
            tr.add_data("send", msg(b"C", q[:8] + b"\x00") + msg(b"Z", b"I"), tp)
        return [(r["req"], r["resp"], r["latency"])
                for r in map(tr.parser.record_row, tr.process())]

    assert rows(ConnTracker(PgSQLParser(), role=2)) == [
        ("SELECT 1;", "SELECT 1", 50), ("SELECT 2;", "SELECT 2", 900)]
    assert rows(RefTracker(RefPgSQL(), role=2)) == [
        ("SELECT 1;", "", 0), ("SELECT 2;", "SELECT 1", 0)]


def test_late_events_after_reaping_are_dropped_as_the_reference():
    """The reaped-connection guard: events of a connection already closed
    and reported neither resurrect it nor add a conn_stats row."""
    def run(mod, coll_cls):
        src = mod.QueueEventSource()
        conn = mod.SocketTraceConnector(src, asid=1)
        col = coll_cls()
        col.register(conn)
        src.emit({"ev": "open", "conn": 7, "pid": 3, "addr": "10.0.0.1", "port": 6379,
                  "role": 2, "protocol": "redis"})
        src.emit({"ev": "data", "conn": 7, "dir": "recv", "ts": 10,
                  "data": b"*1\r\n$4\r\nPING\r\n"})
        src.emit({"ev": "data", "conn": 7, "dir": "send", "ts": 20, "data": b"+PONG\r\n"})
        src.emit({"ev": "close", "conn": 7})
        col.transfer_once()
        src.emit({"ev": "data", "conn": 7, "dir": "send", "ts": 30, "data": b"+PONG\r\n"})
        src.emit({"ev": "close", "conn": 7})
        col.transfer_once()
        return (conn.stats, _table_rows(col.store.table("redis_events")),
                [r[1:] for r in _table_rows(col.store.table("conn_stats"))])

    got, want = run(tracer, Collector), run(ref_tracer, RefCollector)
    assert got == want
    assert got[0]["late_events_dropped"] == 2 and len(got[2]) == 1


def test_undecodable_chatter_is_counted_as_the_reference():
    """A connection with no hint whose bytes no signature matches: dropped
    after 64 pending events, one unknown_protocol_conns, and its
    conn_stats row carries protocol 0."""
    def run(mod, coll_cls):
        src = mod.QueueEventSource()
        conn = mod.SocketTraceConnector(src, asid=2)
        col = coll_cls()
        col.register(conn)
        src.emit({"ev": "open", "conn": 1, "pid": 5, "addr": "10.0.0.9", "port": 1234,
                  "role": 2})
        for i in range(70):
            src.emit({"ev": "data", "conn": 1, "dir": "recv", "ts": i, "data": b"\x00\x01\x02"})
        src.emit({"ev": "close", "conn": 1})
        src.finish()
        _drain(col)
        return conn.stats, [r[1:] for r in _table_rows(col.store.table("conn_stats"))]

    got, want = run(tracer, Collector), run(ref_tracer, RefCollector)
    assert got == want
    assert got[0]["unknown_protocol_conns"] == 1 and got[1][0][5] == 0


@pytest.mark.parametrize("proto", PROTOCOLS)
def test_protocol_inference_as_the_reference(proto):
    """infer_protocol over each generated connection's first bytes of each
    direction agrees with the reference's."""
    gen = _traffic(proto)
    for c in gen.conns:
        for d in ("recv", "send"):
            first = next((m[2] for m in c.msgs if m[0] == d), b"")
            assert tracer.infer_protocol(first, d) == ref_tracer.infer_protocol(first, d)


def test_tables_are_the_connectors_schemas():
    src = tracer.QueueEventSource()
    specs = tracer.SocketTraceConnector(src).tables()
    ref_specs = ref_tracer.SocketTraceConnector(ref_tracer.QueueEventSource()).tables()
    assert [s.name for s in specs] == [s.name for s in ref_specs]
    assert all(s.relation is SCHEMAS[s.name] for s in specs)
    assert {s.name for s in specs} == set(traffic.TABLES.values()) | {"conn_stats"}


def test_tapped_live_process_resolves_ctx_pod(tmp_path):
    """The full loop: a watch feed declares the pod, the /proc scanner binds
    THIS process's UPID to it, a TapProxy traces real HTTP traffic served by
    this process, and a PxL query's ctx['pod'] enrichment resolves — no
    synthetic state anywhere."""
    from pixie_tpu_torch.collect.tap import TapProxy
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.metadata.proc_scanner import ProcScanner
    from pixie_tpu_torch.metadata.state import (MetadataStateManager, global_manager,
                                                set_global_manager)
    from pixie_tpu_torch.metadata.watch import ResourceUpdateFeed

    me = os.getpid()
    mgr = MetadataStateManager(asid=3, node_name="this-node")
    # 1. pod + service arrive over the watch feed (the k8s fanout analog)
    path = tmp_path / "k8s.jsonl"
    with open(path, "w") as f:
        f.write(json.dumps({
            "kind": "pod", "uid": "pod-live-1", "name": "webserver-0",
            "namespace": "live", "node": "this-node", "ip": "127.0.0.1",
        }) + "\n")
        f.write(json.dumps({
            "kind": "service", "uid": "svc-live-1", "name": "web",
            "namespace": "live", "cluster_ip": "10.96.7.7",
            "pod_uids": ["pod-live-1"],
        }) + "\n")
    feed = ResourceUpdateFeed(mgr, str(path))
    assert feed.poll() == 2
    # 2. the /proc scanner binds this live process to the pod (classifier
    #    stands in for the cgroup reader on this non-k8s host)
    sc = ProcScanner(
        asid=3, classifier=lambda pid, cmd: "pod-live-1" if pid == me else None)
    sc.scan_into(mgr)

    # 3. a real HTTP exchange through the tap
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def serve():
        c, _ = srv.accept()
        c.recv(65536)
        c.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\n\r\nok")
        c.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    tap = TapProxy("127.0.0.1", srv.getsockname()[1], pid=me).start()
    old = global_manager()
    set_global_manager(mgr)
    try:
        cli = socket.create_connection(("127.0.0.1", tap.port))
        cli.sendall(b"GET /ctx HTTP/1.1\r\nHost: t\r\n\r\n")
        assert cli.recv(65536).endswith(b"ok")
        cli.close()
        th.join(timeout=2)
        conn = tracer.SocketTraceConnector(tap.source, asid=3)
        col = Collector()
        col.register(conn)
        for _ in range(50):
            col.transfer_once()
            t = col.store.table("http_events")
            if t.stats()["rows_written"] or t.stats()["hot_rows"]:
                break
        # 4. ctx['pod'] / ctx['service'] resolve from the scanned state
        q = compile_pxl(
            "import px\n"
            "df = px.DataFrame(table='http_events')\n"
            "df.pod = df.ctx['pod']\n"
            "df.service = df.ctx['service']\n"
            "df.cmd = px.upid_to_cmdline(df.upid)\n"
            "df = df[['req_path', 'pod', 'service', 'cmd']]\n"
            "px.display(df, 'o')\n",
            col.store.schemas(),
        )
        res = execute_plan(q.plan, col.store, device="cpu")["o"]
        assert res.num_rows >= 1
        assert res.decoded("req_path") == ["/ctx"]
        assert res.decoded("pod") == ["live/webserver-0"]
        assert res.decoded("service") == ["live/web"]
        assert "python" in res.decoded("cmd")[0]
    finally:
        set_global_manager(old)
        tap.stop()
        srv.close()


def test_tap_stop_leaves_no_thread(tmp_path):
    """After stop() the tap has closed every socket: no pump or accept
    thread of it is left running, with a client still connected."""
    from pixie_tpu_torch.collect.tap import TapProxy

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    tap = TapProxy("127.0.0.1", srv.getsockname()[1]).start()
    cli = socket.create_connection(("127.0.0.1", tap.port))
    peer, _ = srv.accept()
    cli.sendall(b"GET / HTTP/1.1\r\n\r\n")
    assert peer.recv(100).startswith(b"GET /")
    tap.stop()
    try:
        assert not [t.name for t in threading.enumerate()
                    if t.name.startswith("tap-") and t.is_alive()]
    finally:
        cli.close()
        peer.close()
        srv.close()


def test_inference_reads_the_directions_first_bytes():
    """A request whose first segment ("GE") is shorter than any signature,
    then a middle segment that starts with ':' and holds a CRLF: the port
    infers HTTP from the direction's first bytes and traces the exchange;
    the reference reads the middle segment alone as RESP (ROADMAP Queue 3,
    known differences) and the HTTP row is lost."""
    def run(mod, coll_cls):
        src = mod.QueueEventSource()
        conn = mod.SocketTraceConnector(src, asid=1)
        col = coll_cls()
        col.register(conn)
        src.emit({"ev": "open", "conn": 1, "pid": 4, "addr": "10.0.0.2", "port": 8080,
                  "role": 2})
        for part in (b"GE", b"T /x HTTP/1.1\r\nHost", b": svc.local\r\n\r\n"):
            src.emit({"ev": "data", "conn": 1, "dir": "recv", "ts": 10, "data": part})
        src.emit({"ev": "data", "conn": 1, "dir": "send", "ts": 30,
                  "data": b"HTTP/1.1 200 OK\r\nContent-Length: 0\r\n\r\n"})
        src.emit({"ev": "close", "conn": 1})
        src.finish()
        _drain(col)
        return {t: _table_rows(col.store.table(t)) for t in ("http_events", "redis_events")}

    got, ref = run(tracer, Collector), run(ref_tracer, RefCollector)
    names = SCHEMAS["http_events"].names()
    rows = [dict(zip(names, r)) for r in got["http_events"]]
    assert [(r["req_path"], r["latency"]) for r in rows] == [("/x", 20)]
    assert got["redis_events"] == []
    assert ref["http_events"] == []
