"""Seeded socket traffic for the socket tracer's checks: every protocol's
exchanges as the tracer's open / data / close events, with the rows they
must give.

chip_smoke.py's socket_tracer phase and the tracer's tests drive the port's
SocketTraceConnector with it and hold its tables against `Traffic.truth()`.
It is an oracle of its own: the bytes are built here from each protocol's
wire format (HTTP/2's header blocks by hand, with static-table indices and
plain literals), and nothing of the port's parsers or encoders is used.

A connection's process is UPID index u of a caller's topology
(`node_of_upid[u]` is its node): pid PID0 + u, started at START0_NS + u,
asid node + 1 (`upids`).

    traffic = Traffic("redis", conns=32, per_conn=16, seed=1,
                      node_of_upid=np.arange(64) % 4)
    events, keys = traffic.events(seg_seed=11)
"""
from __future__ import annotations

import json

import numpy as np

SEC = 1_000_000_000
#: a live tracer's drain period; the events are fed in windows of it
PERIOD_NS = 200_000_000
#: the traffic's clock starts here (the tracer attaches at T0; the first
#: request follows a period later)
T0 = 1_700_000_000 * SEC
#: mean gap between a response and the connection's next request: HTTP/1's
#: 128 exchanges span about a minute, the others' 64 about 6 s
HTTP_THINK_MS, THINK_MS = 420.0, 50.0
#: the odds that a message is cut at 0, 1 or 2 points
CUTS = (0.25, 0.5, 0.25)
#: the process of UPID index u
PID0, START0_NS = 1000, 1 << 60
PROTOCOLS = ("mysql", "pgsql", "dns", "redis", "cql", "kafka", "nats", "mux", "http2")
TABLES = {"http": "http_events", "http2": "http_events", "mysql": "mysql_events",
          "pgsql": "pgsql_events", "dns": "dns_events", "redis": "redis_events",
          "cql": "cql_events", "kafka": "kafka_events.beta", "nats": "nats_events.beta",
          "mux": "mux_events"}
#: reference bcc_bpf_intf/common.h traffic_protocol_t, conn_stats' protocol
PROTOCOL_IDS = {"http": 1, "http2": 2, "mysql": 3, "cql": 4, "pgsql": 5, "dns": 6,
                "redis": 7, "nats": 8, "kafka": 10, "mux": 11}
PORTS = {"http": 8080, "http2": 50051, "mysql": 3306, "pgsql": 5432, "dns": 53,
         "redis": 6379, "cql": 9042, "kafka": 9092, "nats": 4222, "mux": 9990}
#: bytes a garbage-led connection starts with: one INVALID frame for its
#: parser, and no plausible frame boundary inside them
GARBAGE = {"mysql": b"\x00\x00\x00" + b"\xff" * 5, "pgsql": b"\xfe" * 16,
           "dns": b"\xff" * 16, "redis": b"\x00\x01\x02garbage\x7f",
           "cql": b"\x00" * 10, "kafka": b"\xff" * 12, "nats": b"\x16\x03\x01garbage\r\n",
           "mux": b"\xff" * 12, "http2": b"\xff" * 16}
STATUS_MESSAGES = {200: "OK", 404: "Not Found", 500: "Internal Server Error"}


def _paths() -> list[str]:
    """HTTP/1's 64 endpoints."""
    return [f"/api/v{1 + e % 2}/svc{e // 8}/{('items', 'orders', 'users', 'carts')[e % 4]}"
            f"/{e}" for e in range(64)]


def _json_bodies(rng, n: int) -> list[str]:
    """n JSON bodies of 0-512 bytes (a few empty)."""
    out = []
    for i, size in enumerate(rng.integers(0, 513, n)):
        if size < 24:
            out.append("")
            continue
        body = json.dumps({"id": i, "pad": "x" * (int(size) - 23 - len(str(i)))})
        out.append(body[:512] if len(body) <= 512 else "")
    return out


def _chunked(body: bytes, pieces: int) -> bytes:
    """body in `pieces` chunks of Transfer-Encoding: chunked, then the end."""
    out, step = [], max(1, -(-len(body) // pieces))
    for i in range(0, len(body), step):
        part = body[i:i + step]
        out.append(b"%x\r\n%s\r\n" % (len(part), part))
    return b"".join(out) + b"0\r\n\r\n"


class Conn:
    """One generated connection: its UPID index, peer, protocol, the
    messages it carries in order as (direction, ts, bytes, cuttable) and
    the rows its exchanges must give."""

    __slots__ = ("cid", "node", "u", "addr", "port", "protocol", "msgs", "rows", "garbage")

    def __init__(self, cid: int, node: int, u: int, addr: str, protocol: str, garbage: bool):
        self.cid, self.node, self.u, self.addr, self.protocol = cid, node, u, addr, protocol
        self.port = PORTS[protocol]
        self.msgs: list = []
        self.rows: list = []
        self.garbage = garbage


# ---- protocol exchange builders: (rng, conn, k, t_req, t_resp) -> rows;
# each appends the exchange's messages to conn.msgs


def _http(g, c, k, t_req, t_resp):
    method = g.methods[k]
    path = g.paths[g.path_ix[k]]
    status = int(g.status[k])
    req_body = g.bodies[g.req_body_ix[k]] if method in ("POST", "PUT") else ""
    head = f"{method} {path} HTTP/1.1\r\nHost: svc.local\r\nUser-Agent: px-gen/1.0\r\n"
    if req_body:
        head += f"Content-Type: application/json\r\nContent-Length: {len(req_body)}\r\n"
    req = (head + "\r\n" + req_body).encode()
    body = g.bodies[g.resp_body_ix[k]]
    msg = STATUS_MESSAGES[status]
    if method == "HEAD":
        resp = (f"HTTP/1.1 {status} {msg}\r\nContent-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n\r\n").encode()
        body = ""
    elif g.chunked[k]:
        resp = (f"HTTP/1.1 {status} {msg}\r\nContent-Type: application/json\r\n"
                "Transfer-Encoding: chunked\r\n\r\n").encode() + _chunked(
                    body.encode(), 1 + int(g.pieces[k]))
    else:
        resp = (f"HTTP/1.1 {status} {msg}\r\nContent-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n\r\n" + body).encode()
    c.msgs += [("recv", t_req, req, True), ("send", t_resp, resp, True)]
    return [{"time_": t_resp, "latency": t_resp - t_req, "major_version": 1,
             "minor_version": 1, "content_type": 1, "req_method": method, "req_path": path,
             "req_body": req_body, "req_body_size": len(req_body), "resp_status": status,
             "resp_message": msg, "resp_body": body, "resp_body_size": len(body)}]


def _mysql_packet(seq: int, payload: bytes) -> bytes:
    return len(payload).to_bytes(3, "little") + bytes([seq]) + payload


def _mysql(g, c, k, t_req, t_resp):
    rng = g.rng
    kind = rng.choice(6, p=[0.5, 0.2, 0.1, 0.1, 0.05, 0.05])
    if kind == 0:  # COM_QUERY with a resultset
        ncols, nrows = int(rng.integers(1, 6)), int(rng.integers(0, 8))
        text = f"SELECT {', '.join(f'c{i}' for i in range(ncols))} FROM t{k % 7} LIMIT {nrows}"
        req = _mysql_packet(0, b"\x03" + text.encode())
        pk = [_mysql_packet(1, bytes([ncols]))]
        pk += [_mysql_packet(2 + i, b"\x03def\x02db\x01t\x01t" + f"\x02c{i}".encode())
               for i in range(ncols)]
        pk.append(_mysql_packet(2 + ncols, b"\xfe\x00\x00\x02\x00"))
        pk += [_mysql_packet(3 + ncols + r, b"".join(b"\x04r%03d" % (r % 1000)
                                                       for _ in range(ncols)))
               for r in range(nrows)]
        pk.append(_mysql_packet(3 + ncols + nrows, b"\xfe\x00\x00\x02\x00"))
        resp, cmd, status, body = b"".join(pk), 3, 2, f"Resultset rows = {nrows}"
    elif kind == 1:  # COM_QUERY, an update: OK
        text = f"UPDATE t{k % 7} SET v = v + 1 WHERE id = {int(rng.integers(0, 10 ** 6))}"
        req = _mysql_packet(0, b"\x03" + text.encode())
        resp, cmd, status, body = _mysql_packet(1, b"\x00\x01\x00\x02\x00\x00\x00"), 3, 2, ""
    elif kind == 2:  # COM_QUERY, an error
        text = f"SELEC broken {k}"
        msg = f"You have an error in your SQL syntax near 'broken {k}'"
        req = _mysql_packet(0, b"\x03" + text.encode())
        resp = _mysql_packet(1, b"\xff\x28\x04#42000" + msg.encode())
        cmd, status, body = 3, 3, msg
    elif kind == 3:  # COM_STMT_PREPARE
        text = f"SELECT v FROM t{k % 7} WHERE id = ?"
        req = _mysql_packet(0, b"\x16" + text.encode())
        resp = _mysql_packet(1, b"\x00\x01\x00\x00\x00\x01\x00\x01\x00\x00\x00")
        cmd, status, body = 0x16, 2, ""
    elif kind == 4:  # COM_PING
        text = ""
        req = _mysql_packet(0, b"\x0e")
        resp, cmd, status, body = _mysql_packet(1, b"\x00\x00\x00\x02\x00\x00\x00"), 0x0E, 2, ""
    else:  # COM_INIT_DB
        text = f"db{k % 3}"
        req = _mysql_packet(0, b"\x02" + text.encode())
        resp, cmd, status, body = _mysql_packet(1, b"\x00\x00\x00\x02\x00\x00\x00"), 2, 2, ""
    c.msgs += [("recv", t_req, req, True), ("send", t_resp, resp, True)]
    return [{"time_": t_req, "latency": t_resp - t_req, "req_cmd": cmd, "req_body": text,
             "resp_status": status, "resp_body": body}]


def _pg_msg(tag: bytes, payload: bytes) -> bytes:
    return tag + (len(payload) + 4).to_bytes(4, "big") + payload


def _pgsql(g, c, k, t_req, t_resp):
    rng = g.rng
    kind = rng.choice(5, p=[0.5, 0.2, 0.1, 0.1, 0.1])
    z = _pg_msg(b"Z", b"I")
    if kind == 0:  # a simple query with rows
        nrows = int(rng.integers(0, 6))
        text = f"SELECT id, name FROM users WHERE org = {k % 13};"
        req = _pg_msg(b"Q", text.encode() + b"\x00")
        resp = (_pg_msg(b"T", b"\x00\x02id\x00" + b"\x00" * 18 + b"name\x00" + b"\x00" * 18)
                + b"".join(_pg_msg(b"D", b"\x00\x02\x00\x00\x00\x02%02d\x00\x00\x00\x01a"
                                     % (r % 100)) for r in range(nrows))
                + _pg_msg(b"C", b"SELECT %d\x00" % nrows) + z)
        cmd, out = "Query", f"SELECT {nrows}" + (f" ({nrows} rows)" if nrows else "")
    elif kind == 1:  # an insert
        text = f"INSERT INTO events VALUES ({k}, 'e');"
        req = _pg_msg(b"Q", text.encode() + b"\x00")
        resp, cmd, out = _pg_msg(b"C", b"INSERT 0 1\x00") + z, "Query", "INSERT 0 1"
    elif kind == 2:  # an error
        text = f"SELECT bogus_{k % 5} FROM users;"
        msg = f'column "bogus_{k % 5}" does not exist'
        req = _pg_msg(b"Q", text.encode() + b"\x00")
        resp = _pg_msg(b"E", b"SERROR\x00C42703\x00M" + msg.encode() + b"\x00\x00") + z
        cmd, out = "Query", f"ERROR {msg}"
    elif kind == 3:  # an empty query
        text = ""
        req = _pg_msg(b"Q", b"\x00")
        resp, cmd, out = _pg_msg(b"I", b"") + z, "Query", "EmptyQueryResponse"
    else:  # the extended protocol's Parse
        text = f"SELECT name FROM users WHERE id = $1 AND org = {k % 13}"
        req = _pg_msg(b"P", b"s%d\x00" % k + text.encode() + b"\x00\x00\x00")
        resp, cmd, out = _pg_msg(b"1", b"") + z, "Parse", ""
    c.msgs += [("recv", t_req, req, True), ("send", t_resp, resp, True)]
    return [{"time_": t_resp, "latency": t_resp - t_req, "req_cmd": cmd, "req": text,
             "resp": out}]


def _pgsql_preamble(g, c, t):
    """A third of the connections negotiate SSL (refused) then start up, a
    third start up, the rest (and every garbage-led one) were attached
    mid-stream.  A startup is answered as a server does: authentication
    ok, a parameter status, the backend key, then ReadyForQuery."""
    kind = 2 if c.garbage else c.cid % 3
    if kind == 0:
        c.msgs += [("recv", t, (8).to_bytes(4, "big") + (80877103).to_bytes(4, "big"), True),
                   ("send", t + 1000, b"N", False)]
    if kind in (0, 1):
        params = b"user\x00app\x00database\x00orders\x00\x00"
        c.msgs.append(("recv", t + 2000, (8 + len(params)).to_bytes(4, "big")
                       + (196608).to_bytes(4, "big") + params, True))
        c.msgs.append(("send", t + 3000, _pg_msg(b"R", b"\x00\x00\x00\x00")
                       + _pg_msg(b"S", b"server_version\x0016.1\x00")
                       + _pg_msg(b"K", b"\x00\x00\x10\x00\x00\x00\x20\x00")
                       + _pg_msg(b"Z", b"I"), True))


def _dns_name(name: str) -> bytes:
    return b"".join(bytes([len(x)]) + x.encode() for x in name.split(".")) + b"\x00"


def _dns_header(txid, flags, nq, na) -> dict:
    return {"txid": txid, "qr": (flags >> 15) & 1, "opcode": (flags >> 11) & 0xF,
            "aa": (flags >> 10) & 1, "tc": (flags >> 9) & 1, "rd": (flags >> 8) & 1,
            "ra": (flags >> 7) & 1, "ad": (flags >> 5) & 1, "cd": (flags >> 4) & 1,
            "rcode": flags & 0xF, "num_queries": nq, "num_answers": na, "num_auth": 0,
            "num_addl": 0}


def _dns(g, c, k, t_req, t_resp):
    import ipaddress
    import struct

    rng = g.rng
    txid = int(rng.integers(0, 1 << 16))
    name = f"svc-{int(rng.integers(0, 64))}.ns-{k % 4}.svc.cluster.local"
    aaaa = rng.random() < 0.1
    nx = rng.random() < 0.05
    qtype = 28 if aaaa else 1
    q = struct.pack(">HHHHHH", txid, 0x0100, 1, 0, 0, 0) + _dns_name(name) + struct.pack(
        ">HH", qtype, 1)
    if nx:
        flags, answers, ans_bytes = 0x8183, [], b""
    else:
        flags, answers, ans_bytes = 0x8180, [], b""
        for _ in range(1 + int(rng.random() < 0.3)):
            if aaaa:
                raw = bytes([0xFD, 0] + list(rng.integers(0, 256, 14)))
                addr = str(ipaddress.IPv6Address(raw))
            else:
                raw = bytes([10] + list(rng.integers(0, 256, 3)))
                addr = ".".join(str(x) for x in raw)
            ans_bytes += b"\xc0\x0c" + struct.pack(">HHIH", qtype, 1, 30, len(raw)) + raw
            answers.append({"name": name, "type": "AAAA" if aaaa else "A", "addr": addr})
    r = struct.pack(">HHHHHH", txid, flags, 1, len(answers), 0, 0) + _dns_name(
        name) + struct.pack(">HH", qtype, 1) + ans_bytes
    c.msgs += [("recv", t_req, q, False), ("send", t_resp, r, False)]
    sep = (",", ":")
    return [{"time_": t_resp, "latency": t_resp - t_req,
             "req_header": json.dumps(_dns_header(txid, 0x0100, 1, 0), separators=sep),
             "req_body": json.dumps({"queries": [{"name": name, "type": "AAAA" if aaaa
                                                  else "A"}]}, separators=sep),
             "resp_header": json.dumps(_dns_header(txid, flags, 1, len(answers)),
                                       separators=sep),
             "resp_body": json.dumps({"answers": answers}, separators=sep)}]


def _resp_bulk(s) -> bytes:
    return b"$-1\r\n" if s is None else b"$%d\r\n%s\r\n" % (len(s), s.encode())


def _redis(g, c, k, t_req, t_resp):
    rng = g.rng
    key = f"user:{int(rng.integers(0, 1000))}"
    kind = int(rng.choice(9, p=[0.3, 0.2, 0.1, 0.05, 0.1, 0.05, 0.05, 0.05, 0.1]))
    val = f"v{int(rng.integers(0, 10 ** 6))}"
    if kind == 0:
        hit = rng.random() < 0.8
        toks, resp, out = ["GET", key], _resp_bulk(val if hit else None), (val if hit
                                                                             else "<NULL>")
    elif kind == 1:
        toks, resp, out = ["SET", key, val], b"+OK\r\n", "OK"
    elif kind == 2:
        n = int(rng.integers(1, 10 ** 5))
        toks, resp, out = ["INCR", f"ctr:{k % 9}"], b":%d\r\n" % n, str(n)
    elif kind == 3:
        toks, resp, out = ["DEL", key], b":1\r\n", "1"
    elif kind == 4:
        toks, resp, out = ["HGET", key, "name"], _resp_bulk(val), val
    elif kind == 5:
        n = int(rng.integers(1, 100))
        toks, resp, out = ["LPUSH", f"q:{k % 5}", val], b":%d\r\n" % n, str(n)
    elif kind == 6:
        toks = ["CONFIG", "GET", "maxmemory"]
        resp, out = b"*2\r\n$9\r\nmaxmemory\r\n$1\r\n0\r\n", '["maxmemory","0"]'
    elif kind == 7:
        msg = "WRONGTYPE Operation against a key holding the wrong kind of value"
        toks, resp, out = ["LPOP", key], b"-%s\r\n" % msg.encode(), msg
    else:
        toks, resp, out = ["PING"], b"+PONG\r\n", "PONG"
    req = b"*%d\r\n" % len(toks) + b"".join(_resp_bulk(t) for t in toks)
    c.msgs += [("recv", t_req, req, True), ("send", t_resp, resp, True)]
    cmd, args = (f"{toks[0]} {toks[1]}", toks[2:]) if toks[0] == "CONFIG" else (toks[0],
                                                                                toks[1:])
    return [{"time_": t_resp, "latency": t_resp - t_req, "req_cmd": cmd,
             "req_args": json.dumps(args, separators=(",", ":")), "resp": out}]


def _cql_frame(resp: bool, stream: int, opcode: int, body: bytes) -> bytes:
    return bytes([0x84 if resp else 0x04, 0]) + stream.to_bytes(2, "big") + bytes(
        [opcode]) + len(body).to_bytes(4, "big") + body


def _cql(g, c, k, t_req, t_resp):
    rng = g.rng
    stream = k % 32000 + 1
    if k == 0:
        body = b"\x00\x01\x00\x0bCQL_VERSION\x00\x053.0.0"
        req, op, text = _cql_frame(False, stream, 0x01, body), 0x01, "STARTUP"
        resp, rop, out = _cql_frame(True, stream, 0x02, b""), 0x02, "READY"
    else:
        kind = int(rng.choice(4, p=[0.6, 0.2, 0.1, 0.1]))
        op = 0x09 if kind == 3 else 0x07
        text = (f"SELECT * FROM ks.t{k % 11} WHERE id = {int(rng.integers(0, 10 ** 6))}"
                if kind != 1 else f"INSERT INTO ks.events (id, v) VALUES ({k}, 'x')")
        req = _cql_frame(False, stream, op, len(text).to_bytes(4, "big") + text.encode()
                           + b"\x00\x01\x00")
        if kind == 0:
            ncols = int(rng.integers(1, 9))
            resp = _cql_frame(True, stream, 0x08, (2).to_bytes(4, "big") + (1).to_bytes(
                4, "big") + ncols.to_bytes(4, "big") + b"\x00" * 8)
            rop, out = 0x08, f"Rows ({ncols} columns)"
        elif kind == 1:
            resp, rop, out = _cql_frame(True, stream, 0x08, (1).to_bytes(4, "big")), 0x08, "Void"
        elif kind == 2:
            msg = f"Undefined column name v{k % 4}"
            resp = _cql_frame(True, stream, 0x00, (0x2200).to_bytes(4, "big") + len(
                msg).to_bytes(2, "big") + msg.encode())
            rop, out = 0x00, msg
        else:
            resp = _cql_frame(True, stream, 0x08, (4).to_bytes(4, "big") + b"\x00\x10"
                                + bytes(16))
            rop, out = 0x08, "Prepared"
    c.msgs += [("recv", t_req, req, True), ("send", t_resp, resp, True)]
    return [{"time_": t_resp, "latency": t_resp - t_req, "req_op": op, "req_body": text,
             "resp_op": rop, "resp_body": out}]


KAFKA_APIS = {0: "Produce", 1: "Fetch", 3: "Metadata", 12: "Heartbeat", 18: "ApiVersions"}


def _kafka(g, c, k, t_req, t_resp):
    rng = g.rng
    api = int(rng.choice(list(KAFKA_APIS), p=[0.35, 0.35, 0.1, 0.1, 0.1]))
    ver = int(rng.integers(0, 13))
    client = "" if c.cid % 10 == 0 else f"px-client-{c.cid % 8}"
    cid_field = (b"\xff\xff" if not client else len(client).to_bytes(2, "big")
                 + client.encode())
    p = api.to_bytes(2, "big") + ver.to_bytes(2, "big") + (k + 1).to_bytes(4, "big") + \
        cid_field + bytes(int(rng.integers(0, 200)))
    rp = (k + 1).to_bytes(4, "big") + bytes(int(rng.integers(0, 300)))
    c.msgs += [("recv", t_req, len(p).to_bytes(4, "big") + p, True),
               ("send", t_resp, len(rp).to_bytes(4, "big") + rp, True)]
    sep = (",", ":")
    return [{"time_": t_resp, "latency": t_resp - t_req, "req_cmd": api, "client_id": client,
             "req_body": json.dumps({"api": KAFKA_APIS[api], "api_version": ver,
                                     "size": len(p)}, separators=sep),
             "resp": json.dumps({"size": len(rp)}, separators=sep)}]


def _nats(g, c, k, t_req, t_resp):
    """A PUB and the MSG the server delivers for it (the connection is
    subscribed): NATS has no request/response, so each is a row."""
    rng = g.rng
    subj = f"orders.{k % 6}"
    payload = "p" * int(rng.integers(0, 64))
    pub = f"PUB {subj} {len(payload)}\r\n{payload}\r\n".encode()
    msg = f"MSG {subj} 1 {len(payload)}\r\n{payload}\r\n".encode()
    c.msgs += [("recv", t_req, pub, True), ("send", t_resp, msg, True)]
    sep = (",", ":")
    return [{"time_": t_req, "cmd": "PUB", "resp": "",
             "body": json.dumps({"subject": subj, "payload": payload}, separators=sep)},
            {"time_": t_resp, "cmd": "MSG", "resp": "",
             "body": json.dumps({"subject": subj, "sid": "1", "payload": payload},
                                separators=sep)}]


def _nats_preamble(g, c, t):
    """The server's INFO, the client's CONNECT and SUB: a row each."""
    info = '{"server_id":"NATS1","version":"2.10.0","max_payload":1048576}'
    conn = '{"verbose":false,"pedantic":false,"name":"px-gen"}'
    c.msgs += [("send", t, f"INFO {info}\r\n".encode(), True),
               ("recv", t + 1000, f"CONNECT {conn}\r\nSUB orders.* 1\r\n".encode(), True)]
    sep = (",", ":")
    c.rows += [{"time_": t, "cmd": "INFO", "resp": "",
                "body": json.dumps({"options": info}, separators=sep)},
               {"time_": t + 1000, "cmd": "CONNECT", "resp": "",
                "body": json.dumps({"options": conn}, separators=sep)},
               {"time_": t + 1000, "cmd": "SUB", "resp": "",
                "body": json.dumps({"subject": "orders.*", "sid": "1"}, separators=sep)}]


def _mux(g, c, k, t_req, t_resp):
    rng = g.rng
    t = int(rng.choice([2, 1, 65], p=[0.8, 0.1, 0.1]))
    tag = (k + 1).to_bytes(3, "big")
    req = bytes([t]) + tag + bytes(int(rng.integers(0, 100)))
    resp = (256 - t).to_bytes(1, "big") + tag + bytes(int(rng.integers(0, 100)))
    c.msgs += [("recv", t_req, len(req).to_bytes(4, "big") + req, True),
               ("send", t_resp, len(resp).to_bytes(4, "big") + resp, True)]
    return [{"time_": t_resp, "latency": t_resp - t_req, "req_type": t}]


def _h2_int(value: int, prefix_bits: int, top: int) -> bytes:
    """HPACK integer (RFC 7541 §5.1)."""
    mask = (1 << prefix_bits) - 1
    if value < mask:
        return bytes([top | value])
    out = [top | mask]
    value -= mask
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(out + [value])


def _h2_str(s: str) -> bytes:
    """An HPACK string literal, not Huffman-coded."""
    return _h2_int(len(s), 7, 0) + s.encode()


def _h2_frame(ftype: int, flags: int, sid: int, payload: bytes) -> bytes:
    return len(payload).to_bytes(3, "big") + bytes([ftype, flags]) + sid.to_bytes(
        4, "big") + payload


H2_PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"
GRPC_CODES = (0, 5, 13)


def _http2(g, c, k, t_req, t_resp):
    """A gRPC unary call on stream 2k + 1.  Header blocks by hand: static
    indices, literals without Huffman; the first call adds content-type and
    te to each direction's dynamic table (62, then 63 and 62), later calls
    index them."""
    rng = g.rng
    sid = 2 * k + 1
    path = f"/px.svc{k % 8}.Orders/{('Get', 'List', 'Put', 'Delete')[k % 4]}"
    blk = b"\x83\x86" + b"\x04" + _h2_str(path) + b"\x01" + _h2_str("svc.local:50051")
    if k == 0:
        blk += b"\x5f" + _h2_str("application/grpc") + b"\x40" + _h2_str(
            "te") + _h2_str("trailers")
    else:
        blk += b"\xbf\xbe"
    req_msg = bytes(int(x) for x in rng.integers(32, 127, int(rng.integers(1, 120))))
    resp_msg = bytes(int(x) for x in rng.integers(32, 127, int(rng.integers(1, 200))))
    req_data = b"\x00" + len(req_msg).to_bytes(4, "big") + req_msg
    resp_data = b"\x00" + len(resp_msg).to_bytes(4, "big") + resp_msg
    if rng.random() < 0.1:  # the block split across a CONTINUATION
        cut = len(blk) // 2
        hdrs = _h2_frame(1, 0, sid, blk[:cut]) + _h2_frame(9, 4, sid, blk[cut:])
    else:
        hdrs = _h2_frame(1, 4, sid, blk)
    req = hdrs + _h2_frame(0, 1, sid, req_data)
    code = int(rng.choice(GRPC_CODES, p=[0.9, 0.05, 0.05]))
    rblk = b"\x88" + (b"\x5f" + _h2_str("application/grpc") if k == 0 else b"\xbe")
    tblk = b"\x00" + _h2_str("grpc-status") + _h2_str(str(code))
    if code:
        tblk += b"\x00" + _h2_str("grpc-message") + _h2_str(f"call failed {code}")
    resp = (_h2_frame(1, 4, sid, rblk) + _h2_frame(0, 0, sid, resp_data)
            + _h2_frame(1, 5, sid, tblk))
    c.msgs += [("recv", t_req, req, True), ("send", t_resp, resp, True)]
    return [{"time_": t_resp, "latency": t_resp - t_req, "major_version": 2,
             "minor_version": 0, "content_type": 2, "req_method": "POST", "req_path": path,
             "req_body": req_msg.decode("latin-1"), "req_body_size": len(req_data),
             "resp_status": 200, "resp_message": f"grpc-status: {code}",
             "resp_body": resp_msg.decode("latin-1"), "resp_body_size": len(resp_data)}]


def _http2_preamble(g, c, t):
    c.msgs += [("recv", t, H2_PREFACE + _h2_frame(4, 0, 0, b""), True),
               ("send", t + 1000, _h2_frame(4, 0, 0, b"") + _h2_frame(4, 1, 0, b""), True)]


def _mysql_preamble(g, c, t):
    """Half the connections show the handshake (greeting, login, its OK)."""
    if c.cid % 2:
        c.msgs += [("send", t, _mysql_packet(0, b"\x0a8.0.36\x00" + bytes(40)), True),
                   ("recv", t + 1000, _mysql_packet(1, b"\x85\xa6\xff\x01app\x00"), True),
                   ("send", t + 2000, _mysql_packet(2, b"\x00\x00\x00\x02\x00\x00\x00"), True)]


BUILDERS = {"http": _http, "mysql": _mysql, "pgsql": _pgsql, "dns": _dns,
            "redis": _redis, "cql": _cql, "kafka": _kafka, "nats": _nats,
            "mux": _mux, "http2": _http2}
PREAMBLES = {"mysql": _mysql_preamble, "pgsql": _pgsql_preamble,
             "nats": _nats_preamble, "http2": _http2_preamble}


class Traffic:
    """Seeded traffic of one protocol: connections spread over the nodes'
    UPIDs (`node_of_upid`: each UPID index's node; all on `node` if it is
    given), each a run of exchanges
    whose next request follows the last response; the truth rows and
    conn_stats rows it must give.
    `seg_seed` draws only where messages are cut, so one traffic seed cut
    three ways gives the same rows."""

    def __init__(self, protocol: str, conns: int, per_conn: int, seed: int,
                 node_of_upid: np.ndarray, garbage_frac: float = 0.0,
                 think_ms: float = THINK_MS, cid0: int = 0, node: int | None = None):
        self.protocol = protocol
        rng = self.rng = np.random.default_rng(seed)
        n = conns * per_conn
        if protocol == "http":
            self.paths = _paths()
            self.bodies = _json_bodies(rng, 1024)
            self.methods = rng.choice(np.array(["GET", "POST", "PUT", "DELETE", "HEAD"]), n,
                                      p=[0.6, 0.25, 0.09, 0.05, 0.01]).tolist()
            self.path_ix = rng.integers(0, len(self.paths), n)
            self.status = rng.choice(np.array([200, 404, 500]), n, p=[0.85, 0.05, 0.10])
            self.req_body_ix = rng.integers(0, len(self.bodies), n)
            self.resp_body_ix = rng.integers(0, len(self.bodies), n)
            self.chunked = rng.random(n) < 0.25
            self.pieces = rng.integers(0, 3, n)
        lat = (rng.exponential(50.0, n) * 1e6).astype(np.int64)
        think = (rng.exponential(think_ms, n) * 1e6).astype(np.int64) + 1000
        start = T0 + PERIOD_NS + rng.integers(0, int(think_ms * 1e6), conns)
        nodes = int(node_of_upid.max()) + 1
        on_node = [np.flatnonzero(node_of_upid == n) for n in range(nodes)]
        node = np.arange(conns) % nodes if node is None else np.full(conns, node)
        garbage = set(rng.choice(conns, max(1, round(conns * garbage_frac)), replace=False)
                      .tolist()) if garbage_frac else set()
        self.conns: list[Conn] = []
        build = BUILDERS[protocol]
        pre = PREAMBLES.get(protocol)
        for i in range(conns):
            upids = on_node[int(node[i])]
            u = int(upids[rng.integers(0, len(upids))])
            c = Conn(cid0 + i, int(node[i]), u,
                     f"10.{64 + int(node[i])}.{i // 250 % 256}.{i % 250 + 1}", protocol,
                     i in garbage)
            t = int(start[i])
            if c.garbage:
                c.msgs.append(("recv", T0, GARBAGE[protocol], False))
            if pre is not None:
                pre(self, c, t)
                t += 10_000
            for k in range(per_conn):
                j = i * per_conn + k
                t_req = t + int(think[j])
                t_resp = t_req + int(lat[j])
                c.rows += build(self, c, k, t_req, t_resp)
                t = t_resp
            self.conns.append(c)

    def events(self, seg_seed: int, cuts=CUTS) -> tuple[list[dict], np.ndarray]:
        """Every connection's open, data and close events in time order
        (stable: a connection's own events keep their order), and each
        event's time; a message is cut at 0, 1 or 2 random points
        (`cuts`: their odds) unless it is a datagram or a garbage lead."""
        rng = np.random.default_rng(seg_seed)
        evs, keys = [], []
        hint = None if self.protocol == "http" else self.protocol
        for c in self.conns:
            evs.append({"ev": "open", "conn": c.cid, "pid": PID0 + c.u,
                        "pid_start_ns": START0_NS + c.u, "addr": c.addr, "port": c.port,
                        "role": 2, "protocol": hint})
            keys.append(T0)
            m = len(c.msgs)
            n_cuts = rng.choice(len(cuts), m, p=cuts)
            lens = np.array([len(x[2]) for x in c.msgs])
            at = 1 + (rng.random((m, len(cuts) - 1)) * np.maximum(lens - 1, 0)[:, None]
                      ).astype(np.int64)
            for j, (d, ts, data, cuttable) in enumerate(c.msgs):
                nc = int(n_cuts[j])
                if cuttable and nc and len(data) > 1:
                    bounds = [0, *sorted(set(at[j, :nc].tolist())), len(data)]
                    for a, b in zip(bounds, bounds[1:]):
                        evs.append({"ev": "data", "conn": c.cid, "dir": d, "ts": ts,
                                    "data": data[a:b]})
                        keys.append(ts)
                else:
                    evs.append({"ev": "data", "conn": c.cid, "dir": d, "ts": ts, "data": data})
                    keys.append(ts)
            evs.append({"ev": "close", "conn": c.cid})
            keys.append(c.msgs[-1][1] + 1)
        keys = np.asarray(keys, dtype=np.int64)
        order = np.argsort(keys, kind="stable")
        return [evs[i] for i in order], keys[order]

    def truth(self) -> list[dict]:
        """The rows the protocol's table must hold, with the common columns."""
        out = []
        for c in self.conns:
            common = {"upid": c.u, "remote_addr": c.addr, "remote_port": c.port,
                      "trace_role": 2}
            out += [{**common, **r} for r in c.rows]
        return out

    def conn_stats(self) -> list[dict]:
        out = []
        for c in self.conns:
            out.append({"upid": c.u, "remote_addr": c.addr, "remote_port": c.port,
                        "trace_role": 2, "addr_family": 2,
                        "protocol": PROTOCOL_IDS[self.protocol], "ssl": False,
                        "conn_open": 1, "conn_close": 1, "conn_active": 0,
                        "bytes_sent": sum(len(m[2]) for m in c.msgs if m[0] == "send"),
                        "bytes_recv": sum(len(m[2]) for m in c.msgs if m[0] == "recv")})
        return out


def node_of(traffic: list) -> dict:
    """Each connection's node, over a list of Traffic."""
    return {c.cid: c.node for g in traffic for c in g.conns}


def drain(col) -> None:
    """transfer_once until every connector's source is exhausted."""
    while col.connectors():
        col.transfer_once()


def feed_windows(col, sources: dict, node_of: dict, evs, keys) -> None:
    """Emit the events a window of PERIOD_NS at a time (by their own
    clock) and drain after each, as a live tracer polling every period
    would; then finish the sources and drain to the end."""
    win = (keys - T0) // PERIOD_NS
    edges = np.flatnonzero(np.diff(win)) + 1
    for lo, hi in zip([0, *edges.tolist()], [*edges.tolist(), len(evs)]):
        for ev in evs[lo:hi]:
            sources[node_of[ev["conn"]]].emit(ev)
        col.transfer_once()
    for src in sources.values():
        src.finish()
    drain(col)


def table_rows(table, cols: list, upid_index: dict) -> list:
    """The table's rows as tuples of `cols`, strings decoded and UPIDs as
    their index (`upid_index`)."""
    parts = {c: [] for c in cols}
    for rb, _rid, _gen in table.cursor():
        n = rb.num_valid
        for c in cols:
            v = rb.columns[c][:n]
            d = table.dictionaries.get(c)
            parts[c].extend(d.decode(v) if d is not None else v.tolist())
    if "upid" in parts:
        parts["upid"] = [upid_index[(v.high, v.low)] for v in parts["upid"]]
    return list(zip(*(parts[c] for c in cols)))


def hold(label: str, table, want: list, upid_index: dict) -> int:
    """The table's rows against the generator's, as multisets over the
    generator's columns; → the rows."""
    cols = list(want[0])
    got = sorted(table_rows(table, cols, upid_index))
    exp = sorted(tuple(r[c] for c in cols) for r in want)
    if got != exp:
        bad = next((i for i, (a, b) in enumerate(zip(got, exp)) if a != b), min(len(got),
                                                                               len(exp)))
        raise AssertionError(f"{label}: {len(got)} rows against the generator's {len(exp)}; "
                             f"first difference at {bad}: "
                             f"{got[bad] if bad < len(got) else None} against "
                             f"{exp[bad] if bad < len(exp) else None} ({cols})")
    return len(got)


def upids(node_of_upid: np.ndarray) -> list:
    """Each UPID index's UPID: asid node + 1, pid PID0 + u, started at
    START0_NS + u."""
    from pixie_tpu_torch.types import UInt128

    return [UInt128.make_upid(int(n) + 1, PID0 + u, START0_NS + u)
            for u, n in enumerate(node_of_upid)]


def upid_index(node_of_upid: np.ndarray) -> dict:
    """(high, low) of each UPID → its index."""
    return {(v.high, v.low): u for u, v in enumerate(upids(node_of_upid))}
