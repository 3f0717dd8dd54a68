"""The reference's protocol-parser cases (tests/test_protocols.py,
tests/test_http2.py, and the CQL and HPACK cases of tests/test_advisor_r4.py
and tests/test_advisor_r5.py) run on the port's collect/protocols/,
collect/tracer.py and collect/tap.py: captured byte streams → frames →
stitched records → tables, the same assertions.  The two bundled-script
cases run the port's engine on the CPU and skip where the reference's
pxl_scripts checkout is not mounted, as the reference's own do."""
from __future__ import annotations

import json
import socket
import struct
import threading
import time

import pytest

from tests.conftest import requires_reference as _requires_reference

from pixie_tpu_torch.collect.protocols import (
    ConnTracker,
    MessageType,
    ParseState,
    parser_registry,
)
from pixie_tpu_torch.collect.protocols.dns import DNSParser
from pixie_tpu_torch.collect.protocols.http import HTTPParser
from pixie_tpu_torch.collect.protocols.http2 import (
    DATA,
    F_END_HEADERS,
    F_END_STREAM,
    HEADERS,
    HTTP2Parser,
    HpackDecoder,
    PREFACE,
    huffman_decode,
    huffman_encode,
)
from pixie_tpu_torch.collect.protocols.kafka import KafkaParser
from pixie_tpu_torch.collect.protocols.mux import MuxParser
from pixie_tpu_torch.collect.protocols.mysql import (
    COM_QUERY,
    RESP_ERR,
    RESP_OK,
    MySQLParser,
)
from pixie_tpu_torch.collect.protocols.nats import NATSParser
from pixie_tpu_torch.collect.protocols.pgsql import PgSQLParser
from pixie_tpu_torch.collect.protocols.redis import RedisParser
from pixie_tpu_torch.collect.tracer import (
    CaptureFileSource,
    QueueEventSource,
    SocketTraceConnector,
    infer_protocol,
    write_capture,
)


def demo_metadata():
    """The reference's pixie_tpu.testing.demo_metadata snapshot (its
    services, namespaces and pods, a process a pod with pids from 100 and
    start times SEC + pid) in the port's metadata state."""
    from pixie_tpu.testing import datagen

    from pixie_tpu_torch.metadata.state import MetadataStateManager
    from pixie_tpu_torch.types import UInt128

    sec = 1_000_000_000
    m = MetadataStateManager(asid=1, node_name="node-1")
    updates, pid = [], 100
    for si, svc in enumerate(datagen._SERVICES):
        ns = datagen._NAMESPACES[si % len(datagen._NAMESPACES)]
        pod_uids = []
        for pi in range(datagen._PODS_PER_SVC):
            uid, cid = f"pod-uid-{si}-{pi}", f"ctr-{si}-{pi}"
            pod_uids.append(uid)
            updates += [
                {"kind": "pod", "uid": uid, "name": f"{svc}-{pi}", "namespace": ns,
                 "node": "node-1", "ip": f"10.0.{si}.{pi + 1}", "phase": "Running",
                 "create_time_ns": sec},
                {"kind": "container", "cid": cid, "name": f"{svc}-ctr", "pod_uid": uid,
                 "state": "Running"},
                {"kind": "process", "upid": UInt128.make_upid(1, pid, sec + pid),
                 "pod_uid": uid, "container_id": cid, "cmdline": f"/bin/{svc} --serve"}]
            pid += 1
        updates += [{"kind": "service", "uid": f"svc-uid-{si}", "name": svc, "namespace": ns,
                     "cluster_ip": f"10.96.0.{si + 1}", "pod_uids": pod_uids},
                    {"kind": "dns", "ip": f"10.96.0.{si + 1}",
                     "hostname": f"{svc}.{ns}.svc.cluster.local"}]
    m.apply_updates(updates)
    return m


US = 1_000  # ns per µs


def read_col(table, col: str) -> list:
    """Concatenate a table column across batches, decoding dictionary ids."""
    import numpy as np

    vals = []
    for rb, _, _ in table.cursor():
        v = rb.columns[col][: rb.num_valid]
        d = table.dictionaries.get(col)
        vals.extend(d.decode(v) if d is not None else list(np.asarray(v)))
    return vals


# ---------------------------------------------------------------- builders
def mysql_packet(seq: int, payload: bytes) -> bytes:
    return len(payload).to_bytes(3, "little") + bytes([seq]) + payload


def pg_msg(tag: bytes, payload: bytes) -> bytes:
    return tag + (len(payload) + 4).to_bytes(4, "big") + payload


def dns_query(txid: int, name: str) -> bytes:
    out = struct.pack(">HHHHHH", txid, 0x0100, 1, 0, 0, 0)
    for label in name.split("."):
        out += bytes([len(label)]) + label.encode()
    out += b"\x00" + struct.pack(">HH", 1, 1)  # type A, class IN
    return out


def dns_response(txid: int, name: str, addr: str) -> bytes:
    out = struct.pack(">HHHHHH", txid, 0x8180, 1, 1, 0, 0)
    qname = b""
    for label in name.split("."):
        qname += bytes([len(label)]) + label.encode()
    qname += b"\x00"
    out += qname + struct.pack(">HH", 1, 1)
    # answer with compression pointer to offset 12 (the question name)
    out += b"\xc0\x0c" + struct.pack(">HHIH", 1, 1, 60, 4)
    out += bytes(int(x) for x in addr.split("."))
    return out


def cql_frame(is_resp: bool, stream: int, opcode: int, body: bytes) -> bytes:
    ver = 0x84 if is_resp else 0x04
    return struct.pack(">BBhBI", ver, 0, stream, opcode, len(body)) + body


def kafka_req(corr: int, api_key: int = 3, client: str = "cli") -> bytes:
    p = struct.pack(">hhi", api_key, 5, corr)
    p += struct.pack(">h", len(client)) + client.encode()
    p += b"\x00" * 8
    return struct.pack(">i", len(p)) + p


def kafka_resp(corr: int) -> bytes:
    p = struct.pack(">i", corr) + b"\x00" * 12
    return struct.pack(">i", len(p)) + p


def mux_frame(type_: int, tag: int, body: bytes = b"") -> bytes:
    p = struct.pack(">b", type_) + tag.to_bytes(3, "big") + body
    return struct.pack(">i", len(p)) + p


# ------------------------------------------------------------------- HTTP
class TestHTTP:
    def test_request_response_roundtrip(self):
        p = HTTPParser()
        req = (b"POST /api/v1/pay HTTP/1.1\r\nHost: x\r\n"
               b"Content-Length: 7\r\nContent-Type: application/json\r\n\r\n"
               b'{"a":1}')
        st, frame, consumed = p.parse_frame(MessageType.REQUEST, req)
        assert st is ParseState.SUCCESS and consumed == len(req)
        assert frame.method == "POST" and frame.path == "/api/v1/pay"
        assert frame.body == '{"a":1}' and frame.body_size == 7

        resp = (b"HTTP/1.1 404 Not Found\r\nContent-Length: 2\r\n\r\nno")
        st, rf, consumed = p.parse_frame(MessageType.RESPONSE, resp)
        assert st is ParseState.SUCCESS and rf.status == 404
        assert rf.message == "Not Found"

    def test_chunked_body(self):
        p = HTTPParser()
        resp = (b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
                b"4\r\nWiki\r\n5\r\npedia\r\n0\r\n\r\n")
        st, frame, consumed = p.parse_frame(MessageType.RESPONSE, resp)
        assert st is ParseState.SUCCESS and consumed == len(resp)
        assert frame.body == "Wikipedia" and frame.body_size == 9

    def test_partial_needs_more(self):
        p = HTTPParser()
        full = b"GET / HTTP/1.1\r\nContent-Length: 10\r\n\r\n0123456789"
        for cut in (3, 17, 38, len(full) - 1):
            st, _, _ = p.parse_frame(MessageType.REQUEST, full[:cut])
            assert st is ParseState.NEEDS_MORE_DATA, cut

    def test_boundary_resync(self):
        p = HTTPParser()
        buf = b"garbage!!HTTP/1.1 200 OK\r\n\r\n"
        assert p.find_frame_boundary(MessageType.RESPONSE, buf, 1) == 9


# ------------------------------------------------------------------ MySQL
class TestMySQL:
    def _query_exchange(self):
        req = mysql_packet(0, bytes([COM_QUERY]) + b"SELECT * FROM t")
        resps = (
            mysql_packet(1, b"\x01")              # column count = 1
            + mysql_packet(2, b"\x03defcol")      # column def (fake)
            + mysql_packet(3, b"\xfe\x00\x00")    # EOF after col defs
            + mysql_packet(4, b"\x04row1")        # row
            + mysql_packet(5, b"\x04row2")        # row
            + mysql_packet(6, b"\xfe\x00\x00")    # EOF after rows
        )
        return req, resps

    def test_query_resultset(self):
        tr = ConnTracker(MySQLParser(), role=ConnTracker.ROLE_SERVER)
        req, resps = self._query_exchange()
        tr.add_data("recv", req, 100 * US)
        tr.add_data("send", resps, 300 * US)
        recs = tr.process()
        assert len(recs) == 1
        row = tr.parser.record_row(recs[0])
        assert row["req_cmd"] == COM_QUERY
        assert row["req_body"] == "SELECT * FROM t"
        assert row["resp_status"] == RESP_OK
        assert row["resp_body"] == "Resultset rows = 2"
        assert row["latency"] == 200 * US

    def test_error_response(self):
        tr = ConnTracker(MySQLParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("recv", mysql_packet(0, bytes([COM_QUERY]) + b"BAD SQL"), 0)
        err = b"\xff\x28\x04#42000Syntax error near BAD"
        tr.add_data("send", mysql_packet(1, err), 10)
        recs = tr.process()
        row = tr.parser.record_row(recs[0])
        assert row["resp_status"] == RESP_ERR
        assert "Syntax error" in row["resp_body"]

    def test_handshake_ignored(self):
        tr = ConnTracker(MySQLParser(), role=ConnTracker.ROLE_SERVER)
        greeting = mysql_packet(0, b"\x0a8.0.30\x00" + b"\x00" * 20)
        login = mysql_packet(1, b"\x85\xa6\xff\x01user\x00")
        tr.add_data("send", greeting, 1)
        tr.add_data("recv", login, 2)
        tr.add_data("recv", mysql_packet(0, bytes([COM_QUERY]) + b"SELECT 1"), 3)
        tr.add_data("send", mysql_packet(1, b"\x00\x00\x00\x02\x00\x00\x00"), 4)
        recs = tr.process()
        assert len(recs) == 1
        assert tr.parser.record_row(recs[0])["req_body"] == "SELECT 1"

    def test_split_delivery(self):
        tr = ConnTracker(MySQLParser(), role=ConnTracker.ROLE_SERVER)
        req, resps = self._query_exchange()
        blob = req
        for i in range(0, len(blob), 3):
            tr.add_data("recv", blob[i:i + 3], 50)
        for i in range(0, len(resps), 7):
            tr.add_data("send", resps[i:i + 7], 60)
        recs = tr.process()
        assert len(recs) == 1


# ------------------------------------------------------------------ PgSQL
class TestPgSQL:
    def test_simple_query(self):
        tr = ConnTracker(PgSQLParser(), role=ConnTracker.ROLE_SERVER)
        params = b"user\x00bob\x00db\x00d\x00"
        startup = struct.pack(">iI", 8 + len(params), 196608) + params
        tr.add_data("recv", startup, 1)
        tr.add_data("recv", pg_msg(b"Q", b"SELECT id FROM users;\x00"), 100)
        resp = (pg_msg(b"T", b"\x00\x01id" + b"\x00" * 19)
                + pg_msg(b"D", b"\x00\x01\x00\x00\x00\x0242")
                + pg_msg(b"D", b"\x00\x01\x00\x00\x00\x0243")
                + pg_msg(b"C", b"SELECT 2\x00")
                + pg_msg(b"Z", b"I"))
        tr.add_data("send", resp, 400)
        recs = tr.process()
        assert len(recs) == 1
        row = tr.parser.record_row(recs[0])
        assert row["req_cmd"] == "Query"
        assert row["req"] == "SELECT id FROM users;"
        assert row["resp"] == "SELECT 2 (2 rows)"
        assert row["latency"] == 300

    def test_error_response(self):
        tr = ConnTracker(PgSQLParser(), role=ConnTracker.ROLE_SERVER)
        tr.state.startup_done = True
        tr.add_data("recv", pg_msg(b"Q", b"SELECT bogus;\x00"), 10)
        err = pg_msg(b"E", b'SERROR\x00Mcolumn "bogus" does not exist\x00\x00')
        tr.add_data("send", err + pg_msg(b"Z", b"I"), 20)
        recs = tr.process()
        row = tr.parser.record_row(recs[0])
        assert "bogus" in row["resp"] and row["resp"].startswith("ERROR")

    def test_extended_protocol(self):
        tr = ConnTracker(PgSQLParser(), role=ConnTracker.ROLE_SERVER)
        tr.state.startup_done = True
        tr.add_data("recv", pg_msg(b"P", b"s1\x00INSERT INTO t VALUES ($1)\x00\x00\x00"), 5)
        tr.add_data("send", pg_msg(b"1", b"") + pg_msg(b"Z", b"I"), 9)
        recs = tr.process()
        row = tr.parser.record_row(recs[0])
        assert row["req_cmd"] == "Parse"
        assert row["req"] == "INSERT INTO t VALUES ($1)"


# -------------------------------------------------------------------- DNS
class TestDNS:
    def test_query_response(self):
        tr = ConnTracker(DNSParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("recv", dns_query(0x1234, "example.com"), 1000)
        tr.add_data("send", dns_response(0x1234, "example.com", "93.184.216.34"),
                    3000)
        recs = tr.process()
        assert len(recs) == 1
        row = tr.parser.record_row(recs[0])
        hdr = json.loads(row["resp_header"])
        assert hdr["txid"] == 0x1234 and hdr["qr"] == 1
        body = json.loads(row["resp_body"])
        assert body["answers"] == [
            {"name": "example.com", "type": "A", "addr": "93.184.216.34"}]
        req_body = json.loads(row["req_body"])
        assert req_body["queries"] == [{"name": "example.com", "type": "A"}]
        assert row["latency"] == 2000

    def test_txid_out_of_order(self):
        tr = ConnTracker(DNSParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("recv", dns_query(1, "a.com"), 10)
        # datagram streams: each message its own add_data + process round
        recs = tr.process()
        tr.add_data("recv", dns_query(2, "b.com"), 11)
        recs = tr.process()
        tr.add_data("send", dns_response(2, "b.com", "1.1.1.1"), 20)
        recs = tr.process()
        assert len(recs) == 1
        assert json.loads(tr.parser.record_row(recs[0])["req_body"])[
            "queries"][0]["name"] == "b.com"
        tr.add_data("send", dns_response(1, "a.com", "2.2.2.2"), 30)
        recs = tr.process()
        assert len(recs) == 1


# ------------------------------------------------------------------ Redis
class TestRedis:
    def test_command_reply(self):
        tr = ConnTracker(RedisParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("recv", b"*3\r\n$3\r\nSET\r\n$1\r\nk\r\n$5\r\nhello\r\n", 100)
        tr.add_data("send", b"+OK\r\n", 150)
        recs = tr.process()
        row = tr.parser.record_row(recs[0])
        assert row["req_cmd"] == "SET"
        assert json.loads(row["req_args"]) == ["k", "hello"]
        assert row["resp"] == "OK" and row["latency"] == 50

    def test_composite_command_and_nested_reply(self):
        tr = ConnTracker(RedisParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("recv", b"*3\r\n$6\r\nCONFIG\r\n$3\r\nGET\r\n$4\r\nsave\r\n", 1)
        tr.add_data("send", b"*2\r\n$4\r\nsave\r\n$4\r\n60 1\r\n", 2)
        recs = tr.process()
        row = tr.parser.record_row(recs[0])
        assert row["req_cmd"] == "CONFIG GET"
        assert json.loads(row["resp"]) == ["save", "60 1"]

    def test_null_and_error(self):
        tr = ConnTracker(RedisParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("recv", b"*2\r\n$3\r\nGET\r\n$7\r\nmissing\r\n", 1)
        tr.add_data("send", b"$-1\r\n", 2)
        recs = tr.process()
        assert tr.parser.record_row(recs[0])["resp"] == "<NULL>"
        tr.add_data("recv", b"*1\r\n$4\r\nOOPS\r\n", 3)
        tr.add_data("send", b"-ERR unknown command 'OOPS'\r\n", 4)
        recs = tr.process()
        assert "unknown command" in tr.parser.record_row(recs[0])["resp"]

    def test_pubsub_push(self):
        tr = ConnTracker(RedisParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("send",
                    b"*3\r\n$7\r\nmessage\r\n$2\r\nch\r\n$2\r\nhi\r\n", 5)
        recs = tr.process()
        assert len(recs) == 1
        row = tr.parser.record_row(recs[0])
        assert row["req_cmd"] == "PUSH PUB"

    def test_split_delivery(self):
        tr = ConnTracker(RedisParser(), role=ConnTracker.ROLE_SERVER)
        blob = b"*2\r\n$4\r\nINCR\r\n$3\r\nctr\r\n"
        for i in range(0, len(blob), 2):
            tr.add_data("recv", blob[i:i + 2], 1)
        tr.add_data("send", b":42\r\n", 2)
        recs = tr.process()
        assert tr.parser.record_row(recs[0])["resp"] == "42"


class TestReviewRegressions:
    """Regressions for stitcher/parser bugs found in review."""

    def test_dns_two_messages_one_chunk(self):
        tr = ConnTracker(DNSParser(), role=ConnTracker.ROLE_SERVER)
        # both queries arrive in ONE data event; both must parse
        tr.add_data("recv", dns_query(1, "a.com") + dns_query(2, "b.com"), 10)
        tr.add_data("send", dns_response(1, "a.com", "1.1.1.1")
                    + dns_response(2, "b.com", "2.2.2.2"), 20)
        recs = tr.process()
        assert len(recs) == 2

    def test_http_head_response_with_content_length(self):
        tr = ConnTracker(HTTPParser(), role=ConnTracker.ROLE_SERVER)
        # pipelined: both requests observed before the responses
        tr.add_data("recv", b"HEAD /x HTTP/1.1\r\nHost: t\r\n\r\n", 1)
        tr.add_data("recv", b"GET /y HTTP/1.1\r\nHost: t\r\n\r\n", 2)
        # HEAD reply declares a length but never sends a body (RFC 9110)
        tr.add_data("send", b"HTTP/1.1 200 OK\r\nContent-Length: 1234\r\n\r\n"
                    b"HTTP/1.1 404 NF\r\nContent-Length: 0\r\n\r\n", 3)
        recs = tr.process()
        assert len(recs) == 2
        rows = [tr.parser.record_row(r) for r in recs]
        assert rows[0]["req_method"] == "HEAD"
        assert rows[0]["resp_status"] == 200
        assert rows[1]["resp_status"] == 404

    def test_http_304_no_body(self):
        p = HTTPParser()
        resp = b"HTTP/1.1 304 Not Modified\r\nContent-Length: 99\r\n\r\n"
        st, frame, consumed = p.parse_frame(MessageType.RESPONSE, resp)
        assert st is ParseState.SUCCESS and consumed == len(resp)

    def test_cql_error_short_string(self):
        from pixie_tpu_torch.collect.protocols.cql import CQLParser, OP_ERROR, OP_QUERY

        tr = ConnTracker(CQLParser(), role=ConnTracker.ROLE_SERVER)
        q = struct.pack(">i", 1) + b"x"
        tr.add_data("recv", cql_frame(False, 3, OP_QUERY, q), 1)
        msg = b"Invalid query"
        body = struct.pack(">i", 0x2200) + struct.pack(">H", len(msg)) + msg
        tr.add_data("send", cql_frame(True, 3, OP_ERROR, body), 2)
        recs = tr.process()
        assert tr.parser.record_row(recs[0])["resp_body"] == "Invalid query"

    def test_mysql_pipelined_requests(self):
        tr = ConnTracker(MySQLParser(), role=ConnTracker.ROLE_SERVER)
        # two queries sent back-to-back BEFORE any response arrives
        tr.add_data("recv", mysql_packet(0, bytes([COM_QUERY]) + b"Q1")
                    + mysql_packet(0, bytes([COM_QUERY]) + b"Q2"), 10)
        tr.add_data("send", mysql_packet(1, b"\x00\x01\x00\x00\x00")
                    + mysql_packet(1, b"\x00\x02\x00\x00\x00"), 50)
        recs = tr.process()
        assert len(recs) == 2
        rows = [tr.parser.record_row(r) for r in recs]
        assert rows[0]["req_body"] == "Q1" and rows[1]["req_body"] == "Q2"
        assert all(r["resp_status"] == RESP_OK for r in rows)

    def test_pgsql_ssl_negotiation(self):
        tr = ConnTracker(PgSQLParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("recv", struct.pack(">iI", 8, 80877103), 1)  # SSLRequest
        tr.add_data("send", b"N", 2)  # server declines TLS, no length byte
        params = b"user\x00u\x00"
        tr.add_data("recv", struct.pack(">iI", 8 + len(params), 196608) + params, 3)
        tr.add_data("recv", pg_msg(b"Q", b"SELECT 1;\x00"), 4)
        tr.add_data("send", pg_msg(b"C", b"SELECT 1\x00") + pg_msg(b"Z", b"I"), 5)
        recs = tr.process()
        assert len(recs) == 1
        assert tr.resp_stream.invalid_frames == 0

    def test_unmatched_frames_expire(self):
        tr = ConnTracker(KafkaParser(), role=ConnTracker.ROLE_SERVER)
        for i in range(1500):  # responses whose requests were never seen
            tr.add_data("send", kafka_resp(i), i)
        tr.process()
        assert len(tr.resp_stream.frames) <= tr.MAX_PENDING_FRAMES


# -------------------------------------------------------------------- CQL
class TestCQL:
    def test_query_rows(self):
        from pixie_tpu_torch.collect.protocols.cql import CQLParser, OP_QUERY, OP_RESULT

        tr = ConnTracker(CQLParser(), role=ConnTracker.ROLE_SERVER)
        q = b"SELECT * FROM ks.t"
        body = struct.pack(">i", len(q)) + q + b"\x00\x01\x00"
        tr.add_data("recv", cql_frame(False, 7, OP_QUERY, body), 10)
        result = struct.pack(">iii", 2, 1, 3)  # kind=Rows, flags, 3 cols
        tr.add_data("send", cql_frame(True, 7, OP_RESULT, result), 25)
        recs = tr.process()
        row = tr.parser.record_row(recs[0])
        assert row["req_op"] == OP_QUERY
        assert row["req_body"] == "SELECT * FROM ks.t"
        assert row["resp_body"] == "Rows (3 columns)"
        assert row["latency"] == 15

    def test_stream_id_interleave(self):
        from pixie_tpu_torch.collect.protocols.cql import CQLParser, OP_QUERY, OP_READY

        tr = ConnTracker(CQLParser(), role=ConnTracker.ROLE_SERVER)
        qa = struct.pack(">i", 1) + b"a"
        tr.add_data("recv", cql_frame(False, 1, OP_QUERY, qa), 1)
        tr.add_data("recv", cql_frame(False, 2, OP_QUERY, qa), 2)
        # responses out of order
        tr.add_data("send", cql_frame(True, 2, OP_READY, b""), 3)
        tr.add_data("send", cql_frame(True, 1, OP_READY, b""), 4)
        recs = tr.process()
        assert len(recs) == 2
        streams = sorted(r[0].stream for r in recs)
        assert streams == [1, 2]


# ------------------------------------------------------------------ Kafka
class TestKafka:
    def test_correlation_matching(self):
        tr = ConnTracker(KafkaParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("recv", kafka_req(11, api_key=3, client="pixie"), 100)
        tr.add_data("recv", kafka_req(12, api_key=0), 110)
        tr.add_data("send", kafka_resp(12) + kafka_resp(11), 200)
        recs = tr.process()
        assert len(recs) == 2
        rows = [tr.parser.record_row(r) for r in recs]
        by_cmd = {r["req_cmd"]: r for r in rows}
        assert by_cmd[3]["client_id"] == "pixie"
        assert json.loads(by_cmd[0]["req_body"])["api"] == "Produce"


# ------------------------------------------------------------------- NATS
class TestNATS:
    def test_pub_msg_flow(self):
        tr = ConnTracker(NATSParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("recv", b"SUB updates 1\r\nPUB updates 5\r\nhello\r\n", 10)
        tr.add_data("send", b"MSG updates 1 5\r\nhello\r\n", 20)
        recs = tr.process()
        rows = [tr.parser.record_row(r) for r in recs]
        cmds = [r["cmd"] for r in rows]
        assert cmds == ["SUB", "PUB", "MSG"]
        pub = rows[1]
        assert json.loads(pub["body"]) == {"subject": "updates",
                                           "payload": "hello"}

    def test_verbose_ack(self):
        tr = ConnTracker(NATSParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("recv", b"PUB x 2\r\nok\r\n", 1)
        tr.add_data("send", b"+OK\r\n", 2)
        recs = tr.process()
        assert tr.parser.record_row(recs[0])["resp"] == "+OK"


# -------------------------------------------------------------------- Mux
class TestMux:
    def test_tdispatch_rdispatch(self):
        tr = ConnTracker(MuxParser(), role=ConnTracker.ROLE_SERVER)
        tr.add_data("recv", mux_frame(2, 5, b"payload"), 100)
        tr.add_data("send", mux_frame(-2, 5, b"result"), 170)
        recs = tr.process()
        row = tr.parser.record_row(recs[0])
        assert row["req_type"] == 2 and row["latency"] == 70


# -------------------------------------------------------- protocol inference
class TestInference:
    def test_signatures(self):
        assert infer_protocol(b"GET / HTTP/1.1\r\n\r\n", "recv") == "http"
        assert infer_protocol(b"*1\r\n$4\r\nPING\r\n", "recv") == "redis"
        assert infer_protocol(b"INFO {\"sid\":1}\r\n", "send") == "nats"
        assert infer_protocol(cql_frame(False, 0, 1, b""), "recv") == "cql"
        greeting = mysql_packet(0, b"\x0a8.0\x00")
        assert infer_protocol(greeting, "send") == "mysql"
        startup = struct.pack(">iI", 8, 196608)
        assert infer_protocol(startup, "recv") == "pgsql"
        assert infer_protocol(b"\x00\x01\x02\x03", "recv") is None


# --------------------------------------------------------------- tracer E2E
class TestTracer:
    def test_queue_to_tables(self, tmp_path):
        from pixie_tpu_torch.collect.core import Collector

        src = QueueEventSource()
        events = [
            {"ev": "open", "conn": 1, "pid": 7, "addr": "10.0.0.1",
             "port": 3306, "role": 2, "protocol": "mysql"},
            {"ev": "data", "conn": 1, "dir": "recv", "ts": 1000,
             "data": mysql_packet(0, bytes([COM_QUERY]) + b"SELECT 1")},
            {"ev": "data", "conn": 1, "dir": "send", "ts": 3000,
             "data": mysql_packet(1, b"\x00\x00\x00\x02\x00\x00\x00")},
            {"ev": "close", "conn": 1},
            {"ev": "open", "conn": 2, "pid": 8, "addr": "10.0.0.2",
             "port": 6379, "role": 2},
            {"ev": "data", "conn": 2, "dir": "recv", "ts": 1500,
             "data": b"*2\r\n$3\r\nGET\r\n$1\r\nk\r\n"},
            {"ev": "data", "conn": 2, "dir": "send", "ts": 1800,
             "data": b"$3\r\nval\r\n"},
            {"ev": "close", "conn": 2},
        ]
        for ev in events:
            src.emit(ev)
        src.finish()
        conn = SocketTraceConnector(src)
        col = Collector()
        col.register(conn)
        col.transfer_once()
        col.transfer_once()  # second pass reports closes + exhaustion
        assert read_col(col.store.table("mysql_events"), "req_body") == \
            ["SELECT 1"]
        redis_t = col.store.table("redis_events")
        assert read_col(redis_t, "req_cmd") == ["GET"]
        assert read_col(redis_t, "resp") == ["val"]
        assert len(read_col(col.store.table("conn_stats"), "bytes_sent")) == 2

    def test_capture_file_roundtrip(self, tmp_path):
        path = str(tmp_path / "capture.jsonl")
        events = [
            {"ev": "open", "conn": 1, "pid": 3, "addr": "1.2.3.4",
             "port": 53, "role": 2, "protocol": "dns"},
            {"ev": "data", "conn": 1, "dir": "recv", "ts": 100,
             "data": dns_query(9, "px.dev")},
            {"ev": "data", "conn": 1, "dir": "send", "ts": 300,
             "data": dns_response(9, "px.dev", "8.8.4.4")},
            {"ev": "close", "conn": 1},
        ]
        assert write_capture(path, events) == 4
        conn = SocketTraceConnector(CaptureFileSource(path))
        out = {}
        while not conn.exhausted:
            for t, cols in conn.transfer_data().items():
                out.setdefault(t, []).append(cols)
        assert "dns_events" in out
        body = json.loads(out["dns_events"][0]["resp_body"][0])
        assert body["answers"][0]["addr"] == "8.8.4.4"

    def test_live_tap_proxy_http(self):
        """Real sockets through the tap: an actual HTTP exchange is traced."""
        from pixie_tpu_torch.collect.tap import TapProxy

        # toy HTTP server
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        sport = srv.getsockname()[1]

        def serve():
            c, _ = srv.accept()
            c.recv(65536)
            c.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 5\r\n\r\nhello")
            c.close()

        t = threading.Thread(target=serve, daemon=True)
        t.start()
        tap = TapProxy("127.0.0.1", sport, pid=99).start()
        try:
            cli = socket.create_connection(("127.0.0.1", tap.port))
            cli.sendall(b"GET /live HTTP/1.1\r\nHost: t\r\n\r\n")
            got = cli.recv(65536)
            assert got.endswith(b"hello")
            cli.close()
            t.join(timeout=2)
            conn = SocketTraceConnector(tap.source)
            rows = {}
            for _ in range(50):
                for tbl, cols in conn.transfer_data().items():
                    rows.setdefault(tbl, []).append(cols)
                if "http_events" in rows:
                    break
            assert rows["http_events"][0]["req_path"] == ["/live"]
            assert list(rows["http_events"][0]["resp_status"]) == [200]
        finally:
            tap.stop()
            srv.close()

    @_requires_reference
    def test_raw_bytes_to_bundled_scripts(self):
        """VERDICT r2 task-2 'done' bar: px/{mysql,pgsql,dns,redis}_data
        execute against tables populated from RAW BYTES via the tracer —
        no synthetic table writes anywhere."""
        from pixie_tpu_torch.collect.core import Collector
        from pixie_tpu_torch.collect.schemas import all_schemas
        from pixie_tpu_torch.compiler import compile_pxl
        from pixie_tpu_torch.engine import execute_plan
        from pixie_tpu_torch.metadata.state import global_manager, set_global_manager

        SEC = 1_000_000_000
        NOW = 600 * SEC
        src = QueueEventSource()
        cid = 0
        for i in range(20):
            t0 = NOW - (120 - i) * SEC
            # pids 100..105 exist in demo_metadata with start time SEC+pid;
            # matching UPIDs make ctx['pod'] resolve, as in a real cluster.
            pid = 100 + (i % 6)
            start_ns = SEC + pid
            cid += 1
            src.emit({"ev": "open", "conn": cid, "pid": pid,
                      "pid_start_ns": start_ns,
                      "addr": f"10.0.0.{i % 5 + 1}", "port": 3306, "role": 2,
                      "protocol": "mysql"})
            src.emit({"ev": "data", "conn": cid, "dir": "recv", "ts": t0,
                      "data": mysql_packet(0, bytes([COM_QUERY])
                                           + f"SELECT {i} FROM t".encode())})
            src.emit({"ev": "data", "conn": cid, "dir": "send",
                      "ts": t0 + (i + 1) * 100_000,
                      "data": mysql_packet(1, b"\x00\x00\x00\x02\x00\x00\x00")})
            src.emit({"ev": "close", "conn": cid})
            cid += 1
            src.emit({"ev": "open", "conn": cid, "pid": pid,
                      "pid_start_ns": start_ns,
                      "addr": f"10.0.1.{i % 5 + 1}", "port": 5432, "role": 2,
                      "protocol": "pgsql"})
            src.emit({"ev": "data", "conn": cid, "dir": "recv", "ts": t0,
                      "data": pg_msg(b"Q", f"SELECT {i};\x00".encode())})
            src.emit({"ev": "data", "conn": cid, "dir": "send",
                      "ts": t0 + 50_000,
                      "data": pg_msg(b"C", b"SELECT 1\x00") + pg_msg(b"Z", b"I")})
            src.emit({"ev": "close", "conn": cid})
            cid += 1
            src.emit({"ev": "open", "conn": cid, "pid": pid,
                      "pid_start_ns": start_ns,
                      "addr": "10.96.0.10", "port": 53, "role": 2,
                      "protocol": "dns"})
            src.emit({"ev": "data", "conn": cid, "dir": "recv", "ts": t0,
                      "data": dns_query(i, f"svc-{i % 3}.example.com")})
            src.emit({"ev": "data", "conn": cid, "dir": "send",
                      "ts": t0 + 30_000,
                      "data": dns_response(i, f"svc-{i % 3}.example.com",
                                           f"10.1.0.{i % 9 + 1}")})
            src.emit({"ev": "close", "conn": cid})
            cid += 1
            src.emit({"ev": "open", "conn": cid, "pid": pid,
                      "pid_start_ns": start_ns,
                      "addr": f"10.0.2.{i % 5 + 1}", "port": 6379, "role": 2})
            src.emit({"ev": "data", "conn": cid, "dir": "recv", "ts": t0,
                      "data": b"*2\r\n$3\r\nGET\r\n$4\r\nk%03d\r\n"
                      % (i % 7)})
            src.emit({"ev": "data", "conn": cid, "dir": "send",
                      "ts": t0 + 20_000, "data": b"$2\r\nok\r\n"})
            src.emit({"ev": "close", "conn": cid})
        src.finish()
        conn = SocketTraceConnector(src, asid=1)
        col = Collector()
        col.register(conn)
        while not conn.exhausted:
            col.transfer_once()
        col.transfer_once()  # flush close reports

        old = global_manager()
        mgr = demo_metadata()
        set_global_manager(mgr)
        try:
            import tests.test_all_scripts as harness

            schemas = all_schemas()
            for script in ("mysql_data", "pgsql_data", "dns_data",
                           "redis_data"):
                d = harness.SCRIPTS / script
                vis = json.loads((d / "vis.json").read_text()) \
                    if (d / "vis.json").exists() else {}
                funcs = harness._funcs_to_compile(vis)
                source = harness._source_of(d)
                ran = 0
                for fname, fargs in (funcs or [(None, None)]):
                    q = compile_pxl(source, schemas, func=fname,
                                    func_args=fargs, now=NOW)
                    results = execute_plan(q.plan, col.store, device="cpu")
                    total = sum(
                        len(next(iter(r.columns.values())))
                        if r.columns else 0
                        for r in results.values())
                    ran += 1
                    assert total > 0, f"{script}:{fname} returned no rows"
                assert ran >= 1
        finally:
            set_global_manager(old)

    def test_garbage_then_valid(self):
        src = QueueEventSource()
        src.emit({"ev": "open", "conn": 1, "protocol": "redis", "role": 2})
        src.emit({"ev": "data", "conn": 1, "dir": "recv", "ts": 1,
                  "data": b"\x00\x00garbage*1\r\n$4\r\nPING\r\n"})
        src.emit({"ev": "data", "conn": 1, "dir": "send", "ts": 2,
                  "data": b"+PONG\r\n"})
        src.finish()
        conn = SocketTraceConnector(src)
        out = conn.transfer_data()
        assert out["redis_events"]["req_cmd"] == ["PING"]
        assert conn.stats["parse_errors"] >= 1


# ------------------------------------------------------------ wire builders
def frame(ftype: int, flags: int, sid: int, payload: bytes) -> bytes:
    return (len(payload).to_bytes(3, "big") + bytes([ftype, flags])
            + sid.to_bytes(4, "big") + payload)


def hp_int(value: int, prefix_bits: int, top: int) -> bytes:
    mask = (1 << prefix_bits) - 1
    if value < mask:
        return bytes([top | value])
    out = [top | mask]
    value -= mask
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def hp_str(s: str, huff: bool = False) -> bytes:
    if huff:
        enc = huffman_encode(s)
        return hp_int(len(enc), 7, 0x80) + enc
    raw = s.encode()
    return hp_int(len(raw), 7, 0x00) + raw


def hp_literal(name: str, value: str, huff: bool = False) -> bytes:
    """Literal with incremental indexing, new name (0x40 prefix)."""
    return b"\x40" + hp_str(name, huff) + hp_str(value, huff)


def hp_indexed(idx: int) -> bytes:
    return hp_int(idx, 7, 0x80)


# ----------------------------------------------------------------- HPACK
class TestHpack:
    def test_integer_prefix_coding(self):
        d = HpackDecoder()
        # RFC 7541 C.1.2: 1337 with 5-bit prefix = 1f 9a 0a
        v, pos = d._read_int(b"\x1f\x9a\x0a", 0, 5)
        assert (v, pos) == (1337, 3)
        v, pos = d._read_int(b"\x0a", 0, 5)
        assert (v, pos) == (10, 1)

    def test_static_table_indexed(self):
        d = HpackDecoder()
        assert d.decode(hp_indexed(2)) == [(":method", "GET")]
        assert d.decode(hp_indexed(8)) == [(":status", "200")]

    def test_literal_and_dynamic_table(self):
        d = HpackDecoder()
        block = hp_literal("x-custom", "v1") + hp_literal("x-other", "v2")
        assert d.decode(block) == [("x-custom", "v1"), ("x-other", "v2")]
        # newest dynamic entry is index 62
        assert d.decode(hp_indexed(62)) == [("x-other", "v2")]
        assert d.decode(hp_indexed(63)) == [("x-custom", "v1")]

    def test_dynamic_table_eviction(self):
        d = HpackDecoder(max_size=64)  # one small entry fits, two don't
        d.decode(hp_literal("aaaa", "1111"))
        d.decode(hp_literal("bbbb", "2222"))
        assert len(d.dynamic) == 1
        assert d.dynamic[0] == ("bbbb", "2222")

    def test_size_update(self):
        d = HpackDecoder()
        d.decode(hp_literal("n", "v"))
        assert len(d.dynamic) == 1
        d.decode(b"\x20")  # size update to 0: evict all
        assert d.dynamic == []

    def test_huffman_roundtrip(self):
        for s in ["www.example.com", "/grpc.health.v1.Health/Check",
                  "custom-value", "302", "a", ""]:
            assert huffman_decode(huffman_encode(s)) == s

    def test_huffman_rfc_vector(self):
        # RFC 7541 C.4.1: "www.example.com" huffman-encodes to
        # f1e3 c2e5 f23a 6ba0 ab90 f4ff
        assert huffman_encode("www.example.com").hex() == \
            "f1e3c2e5f23a6ba0ab90f4ff"
        assert huffman_decode(bytes.fromhex("f1e3c2e5f23a6ba0ab90f4ff")) == \
            "www.example.com"
        # C.6.1: ":status: 302" value "302" → 6402
        assert huffman_encode("302").hex() == "6402"

    def test_huffman_coded_header(self):
        d = HpackDecoder()
        got = d.decode(hp_literal(":path", "/api/v1/items", huff=True))
        assert got == [(":path", "/api/v1/items")]


# ------------------------------------------------------------ frame machine
def _tracker():
    return ConnTracker(HTTP2Parser(), role=ConnTracker.ROLE_SERVER)


def _req_headers_block(path="/svc/Method", extra=()):
    block = hp_indexed(3)  # :method POST
    block += b"\x40" + hp_str(":path") + hp_str(path)
    block += hp_indexed(7)  # :scheme https
    for n, v in extra:
        block += hp_literal(n, v)
    return block


class TestFrames:
    def test_preface_then_request_response(self):
        tr = _tracker()
        req = (PREFACE
               + frame(4, 0, 0, b"")  # SETTINGS
               + frame(HEADERS, F_END_HEADERS, 1, _req_headers_block())
               + frame(DATA, F_END_STREAM, 1, b"hello"))
        resp_block = hp_indexed(8)  # :status 200
        resp = (frame(4, 0, 0, b"")
                + frame(HEADERS, F_END_HEADERS, 1, resp_block)
                + frame(DATA, F_END_STREAM, 1, b"world"))
        tr.add_data("recv", req, 100)
        tr.add_data("send", resp, 200)
        recs = tr.process()
        assert len(recs) == 1
        row = tr.parser.record_row(recs[0])
        assert row["req_method"] == "POST"
        assert row["req_path"] == "/svc/Method"
        assert row["resp_status"] == 200
        assert row["req_body"] == "hello"
        assert row["resp_body"] == "world"
        assert row["major_version"] == 2
        assert row["latency"] == 100

    def test_continuation_frames(self):
        tr = _tracker()
        block = _req_headers_block(extra=[("x-long", "v" * 40)])
        cut = len(block) // 2
        req = (PREFACE
               + frame(HEADERS, 0, 1, block[:cut])  # no END_HEADERS
               + frame(9, F_END_HEADERS, 1, block[cut:])  # CONTINUATION
               + frame(DATA, F_END_STREAM, 1, b""))
        resp = (frame(HEADERS, F_END_HEADERS | F_END_STREAM, 1,
                      hp_indexed(8)))
        tr.add_data("recv", req, 1)
        tr.add_data("send", resp, 2)
        recs = tr.process()
        assert len(recs) == 1
        row = tr.parser.record_row(recs[0])
        assert '"x-long"' in row["req_headers"]

    def test_interleaved_streams(self):
        tr = _tracker()
        req = (PREFACE
               + frame(HEADERS, F_END_HEADERS, 1, _req_headers_block("/a"))
               + frame(HEADERS, F_END_HEADERS, 3, _req_headers_block("/b"))
               + frame(DATA, F_END_STREAM, 3, b"B")
               + frame(DATA, F_END_STREAM, 1, b"A"))
        resp = (frame(HEADERS, F_END_HEADERS, 3, hp_indexed(8))
                + frame(DATA, F_END_STREAM, 3, b"rb")
                + frame(HEADERS, F_END_HEADERS, 1, hp_indexed(13))
                + frame(DATA, F_END_STREAM, 1, b"ra"))
        tr.add_data("recv", req, 1)
        tr.add_data("send", resp, 2)
        recs = tr.process()
        rows = {r["req_path"]: r for r in map(tr.parser.record_row, recs)}
        assert rows["/a"]["resp_status"] == 404
        assert rows["/b"]["resp_status"] == 200
        assert rows["/a"]["req_body"] == "A"
        assert rows["/b"]["resp_body"] == "rb"

    def test_grpc_trailers_and_framing(self):
        tr = _tracker()
        msg = b"\x0a\x05hello"  # fake pb payload
        grpc_data = b"\x00" + len(msg).to_bytes(4, "big") + msg
        req = (PREFACE
               + frame(HEADERS, F_END_HEADERS, 1, _req_headers_block(
                   "/pkg.Svc/Do", extra=[("content-type", "application/grpc")]))
               + frame(DATA, F_END_STREAM, 1, grpc_data))
        trailer_block = hp_literal("grpc-status", "0")
        resp = (frame(HEADERS, F_END_HEADERS, 1, hp_indexed(8))
                + frame(DATA, 0, 1, grpc_data)
                + frame(HEADERS, F_END_HEADERS | F_END_STREAM, 1,
                        trailer_block))
        tr.add_data("recv", req, 1)
        tr.add_data("send", resp, 2)
        recs = tr.process()
        assert len(recs) == 1
        row = tr.parser.record_row(recs[0])
        assert row["content_type"] == 2
        assert row["req_body"] == msg.decode("latin-1")
        assert "grpc-status" in row["resp_headers"]
        assert row["resp_message"] == "grpc-status: 0"

    def test_rst_stream_closes(self):
        tr = _tracker()
        req = (PREFACE
               + frame(HEADERS, F_END_HEADERS, 1, _req_headers_block())
               + frame(3, 0, 1, (8).to_bytes(4, "big")))  # RST_STREAM
        tr.add_data("recv", req, 1)
        recs = tr.process()
        assert len(recs) == 1  # emitted with what we have

    def test_resync_past_garbage(self):
        tr = _tracker()
        tr.add_data("recv", PREFACE + b"\xde\xad\xbe\xef" * 4
                    + frame(HEADERS, F_END_HEADERS | F_END_STREAM, 1,
                            _req_headers_block()), 1)
        tr.add_data("send", frame(HEADERS, F_END_HEADERS | F_END_STREAM, 1,
                                  hp_indexed(8)), 2)
        recs = tr.process()
        assert len(recs) == 1


# ---------------------------------------------------- real-gRPC integration
class _RecordingProxy(threading.Thread):
    """TCP proxy recording both directions with timestamps."""

    def __init__(self, backend_port: int):
        super().__init__(daemon=True)
        self.backend_port = backend_port
        self.lsock = socket.socket()
        self.lsock.bind(("127.0.0.1", 0))
        self.lsock.listen(1)
        self.port = self.lsock.getsockname()[1]
        self.recv_chunks: list[tuple[bytes, int]] = []  # client->server
        self.send_chunks: list[tuple[bytes, int]] = []  # server->client

    def run(self):
        cli, _ = self.lsock.accept()
        srv = socket.create_connection(("127.0.0.1", self.backend_port))

        def pump(a, b, sink):
            while True:
                try:
                    data = a.recv(65536)
                except OSError:
                    break
                if not data:
                    break
                sink.append((data, time.monotonic_ns()))
                try:
                    b.sendall(data)
                except OSError:
                    break

        t1 = threading.Thread(target=pump, args=(cli, srv, self.recv_chunks),
                              daemon=True)
        t2 = threading.Thread(target=pump, args=(srv, cli, self.send_chunks),
                              daemon=True)
        t1.start(); t2.start()
        t1.join(); t2.join()


def test_real_grpc_capture_parses():
    """grpc-c's production HPACK encoder (Huffman, dynamic table, padding)
    must decode correctly: run a real grpcio unary call through a recording
    proxy and parse the captured bytes."""
    grpc = pytest.importorskip("grpc")
    from concurrent import futures

    ident = lambda x: x  # noqa: E731  (bytes-in/bytes-out service)

    def echo(request, context):
        context.set_trailing_metadata((("x-echo-len", str(len(request))),))
        return b"echo:" + request

    handler = grpc.method_handlers_generic_handler(
        "test.Echo",
        {"Call": grpc.unary_unary_rpc_method_handler(
            echo, request_deserializer=ident, response_serializer=ident)},
    )
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    server.add_generic_rpc_handlers((handler,))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    proxy = _RecordingProxy(port)
    proxy.start()
    try:
        with grpc.insecure_channel(f"127.0.0.1:{proxy.port}") as chan:
            stub = chan.unary_unary(
                "/test.Echo/Call", request_serializer=ident,
                response_deserializer=ident)
            assert stub(b"ping-payload") == b"echo:ping-payload"
        time.sleep(0.3)  # let the proxy drain
    finally:
        server.stop(None)

    tr = _tracker()
    for data, ts in proxy.recv_chunks:
        tr.add_data("recv", data, ts)
    for data, ts in proxy.send_chunks:
        tr.add_data("send", data, ts)
    recs = tr.process()
    rows = [tr.parser.record_row(r) for r in recs]
    calls = [r for r in rows if r["req_path"] == "/test.Echo/Call"]
    assert calls, f"no gRPC call decoded; rows={rows}, " \
                  f"errors={tr.stitch_errors}"
    row = calls[0]
    assert row["req_method"] == "POST"
    assert row["content_type"] == 2
    assert row["resp_status"] == 200
    assert "ping-payload" in row["req_body"]
    assert "echo:ping-payload" in row["resp_body"]
    assert row["resp_message"] == "grpc-status: 0"


@_requires_reference
def test_http2_raw_bytes_to_bundled_script():
    """http2 frames fed as RAW BYTES through the tracer populate http_events,
    and the bundled px/http_data script reads them (major_version=2 rows)."""
    import json as _json

    from pixie_tpu_torch.collect.core import Collector
    from pixie_tpu_torch.collect.schemas import all_schemas
    from pixie_tpu_torch.collect.tracer import SocketTraceConnector
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine import execute_plan
    from pixie_tpu_torch.metadata.state import global_manager, set_global_manager

    SEC = 1_000_000_000
    NOW = 600 * SEC
    src = QueueEventSource()
    for i in range(10):
        t0 = NOW - (60 - i) * SEC
        pid = 100 + (i % 6)
        cid = i + 1
        src.emit({"ev": "open", "conn": cid, "pid": pid,
                  "pid_start_ns": SEC + pid,
                  "addr": f"10.0.0.{i % 5 + 1}", "port": 8443, "role": 2,
                  "protocol": "http2"})
        req = (PREFACE
               + frame(HEADERS, F_END_HEADERS, 1,
                       _req_headers_block(f"/api/v{i % 2}/grpc",
                                          extra=[("content-type",
                                                  "application/grpc")]))
               + frame(DATA, F_END_STREAM, 1, b"\x00\x00\x00\x00\x02hi"))
        resp = (frame(HEADERS, F_END_HEADERS, 1, hp_indexed(8))
                + frame(DATA, F_END_STREAM, 1, b"\x00\x00\x00\x00\x02ok"))
        src.emit({"ev": "data", "conn": cid, "dir": "recv", "ts": t0,
                  "data": req})
        src.emit({"ev": "data", "conn": cid, "dir": "send",
                  "ts": t0 + 250_000, "data": resp})
        src.emit({"ev": "close", "conn": cid})
    src.finish()
    conn = SocketTraceConnector(src, asid=1)
    col = Collector()
    col.register(conn)
    while not conn.exhausted:
        col.transfer_once()
    col.transfer_once()

    old = global_manager()
    mgr = demo_metadata()
    set_global_manager(mgr)
    try:
        import tests.test_all_scripts as harness

        d = harness.SCRIPTS / "http_data"
        vis = _json.loads((d / "vis.json").read_text())
        fname, fargs = harness._funcs_to_compile(vis)[0]
        q = compile_pxl(harness._source_of(d), all_schemas(), func=fname,
                        func_args=fargs, now=NOW)
        res = next(iter(execute_plan(q.plan, col.store, device="cpu").values()))
        assert res.num_rows == 10
        assert set(res.decoded("major_version")) == {2}
        paths = set(res.decoded("req_path"))
        assert paths == {"/api/v0/grpc", "/api/v1/grpc"}
    finally:
        set_global_manager(old)


# ------------------------------------------------ advisor regressions
class TestCqlStreamReuse:
    def test_fifo_match_on_reused_stream_id(self):
        from pixie_tpu_torch.collect.protocols.cql import CQLParser, OP_QUERY, OP_RESULT

        p = CQLParser()

        def req(stream, q):
            body = len(q).to_bytes(4, "big") + q.encode()
            return (
                bytes([0x04, 0, (stream >> 8) & 0xFF, stream & 0xFF, OP_QUERY])
                + len(body).to_bytes(4, "big")
                + body
            )

        def resp(stream):
            body = (1).to_bytes(4, "big")  # Void result
            return (
                bytes([0x84, 0, (stream >> 8) & 0xFF, stream & 0xFF, OP_RESULT])
                + len(body).to_bytes(4, "big")
                + body
            )

        from collections import deque

        reqs, resps = deque(), deque()
        for raw, mt, sink in (
            (req(5, "SELECT one"), "req", reqs),
            (req(5, "SELECT two"), "req", reqs),
            (resp(5), "resp", resps),
            (resp(5), "resp", resps),
        ):
            from pixie_tpu_torch.collect.protocols.base import MessageType, ParseState

            st, frame, _ = p.parse_frame(
                MessageType.REQUEST if mt == "req" else MessageType.RESPONSE,
                memoryview(raw),
            )
            assert st is ParseState.SUCCESS
            sink.append(frame)
        records, errors = p.stitch(reqs, resps)
        assert errors == 0
        assert len(records) == 2
        # FIFO: the first response pairs with the FIRST in-flight request
        assert "one" in p._req_body(records[0][0])
        assert "two" in p._req_body(records[1][0])

    def test_lost_response_does_not_shift_pairings(self):
        """A dropped response frame must not permanently shift every later
        req/resp pairing on that stream id (code-review finding, round 4)."""
        from collections import deque

        from pixie_tpu_torch.collect.protocols.base import MessageType, ParseState
        from pixie_tpu_torch.collect.protocols.cql import CQLParser, OP_QUERY, OP_RESULT

        p = CQLParser()

        def parse(raw, mt, ts):
            st, frame, _ = p.parse_frame(mt, memoryview(raw))
            assert st is ParseState.SUCCESS
            frame.timestamp_ns = ts
            return frame

        def req(q):
            body = len(q).to_bytes(4, "big") + q.encode()
            return (
                bytes([0x04, 0, 0, 5, OP_QUERY])
                + len(body).to_bytes(4, "big")
                + body
            )

        def resp():
            body = (1).to_bytes(4, "big")
            return (
                bytes([0x84, 0, 0, 5, OP_RESULT])
                + len(body).to_bytes(4, "big")
                + body
            )

        # reqA at t=100 (its response was lost), reqB at t=200, respB at t=300
        reqs = deque(
            [
                parse(req("SELECT a"), MessageType.REQUEST, 100),
                parse(req("SELECT b"), MessageType.REQUEST, 200),
            ]
        )
        resps = deque([parse(resp(), MessageType.RESPONSE, 300)])
        records, errors = p.stitch(reqs, resps)
        assert errors == 1  # reqA abandoned
        assert len(records) == 1
        assert "b" in p._req_body(records[0][0])
        assert not reqs  # the stale head left the deque


def _size_update_block(sz: int) -> bytes:
    """Encode an HPACK §6.3 dynamic-table size update of `sz`."""
    if sz < 31:
        return bytes([0x20 | sz])
    out = [0x20 | 31]
    sz -= 31
    while sz >= 128:
        out.append((sz & 0x7F) | 0x80)
        sz >>= 7
    out.append(sz)
    return bytes(out)


def test_hpack_size_update_clamped():
    """An adversarial 2^32 size update must not unbound the dynamic table."""
    dec = HpackDecoder()
    dec.decode(_size_update_block(2**32 - 1))
    assert dec.max_size <= 64 * 1024
    # and the decoder still works after the clamp
    out = dec.decode(bytes([0x82]))  # indexed :method GET
    assert out == [(":method", "GET")]


def test_hpack_size_update_small_still_applies():
    dec = HpackDecoder()
    dec.decode(_size_update_block(128))
    assert dec.max_size == 128
