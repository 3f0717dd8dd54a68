"""Socket-trace connector: byte streams → protocol records → event tables.

Reference: src/stirling/source_connectors/socket_tracer/
(socket_trace_connector.h:78 — the flagship connector; conn_tracker.h per
connection state; protocol_inference.h first-bytes protocol detection).

The kernel eBPF capture half is host-specific and unavailable here; byte
streams arrive through pluggable EventSources instead:

  * QueueEventSource  — programmatic feed (tests, in-process taps)
  * CaptureFileSource — JSONL capture replay (the reference unit-tests its
    parsers on captured byte streams the same way)
  * TapProxy (tap.py) — live TCP forward proxy emitting real traffic

Event dicts: {"ev": "open"|"data"|"close", "conn": id, "ts": ns,
"dir": "send"|"recv", "data": bytes, and on open: "pid", "addr", "port",
"role" (1=client-side, 2=server-side), "protocol" (optional hint)}.

Copied from the reference package (pixie_tpu/collect/tracer.py).
"""
from __future__ import annotations

import base64
import collections
import json
import os
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np

from pixie_tpu_torch.collect.core import SourceConnector, TableSpec, now_ns
from pixie_tpu_torch.collect.protocols import ConnTracker, parser_registry
from pixie_tpu_torch.collect.schemas import SCHEMAS
from pixie_tpu_torch.types import UInt128


def infer_protocol(data: bytes, direction: str) -> Optional[str]:
    """First-bytes protocol detection (reference protocol_inference.h).

    Only protocols with unambiguous signatures are inferred; length-prefixed
    binary protocols (kafka, mux, dns-over-tcp) need an explicit hint, which
    real deployments derive from the server port.
    """
    if not data:
        return None
    b0 = data[:1]
    if data.startswith(b"PRI * HTTP/2.0"):
        return "http2"  # connection preface (RFC 7540 §3.5)
    _http_starts = (b"GET ", b"POST ", b"PUT ", b"DELETE ", b"HEAD ",
                    b"OPTIONS ", b"PATCH ", b"HTTP/1.")
    if any(data.startswith(s) for s in _http_starts):
        return "http"
    if b0 in b"*+-:$" and b"\r\n" in data[:64 * 1024]:
        return "redis"
    if data[:5] == b"INFO " or data[:8] == b"CONNECT ":
        return "nats"
    if len(data) >= 5 and data[3] == 0 and data[4] == 0x0A \
            and int.from_bytes(data[:3], "little") == len(data) - 4:
        return "mysql"  # server greeting: seq 0, protocol version 10
    if len(data) >= 9 and (data[0] & 0x7F) in (3, 4, 5) and data[4] <= 0x10 \
            and int.from_bytes(data[5:9], "big") <= 1 << 28:
        return "cql"
    if len(data) >= 8:
        code = int.from_bytes(data[4:8], "big")
        if code in (196608, 80877103):
            return "pgsql"  # startup / SSLRequest
    return None


#: reference bcc_bpf_intf/common.h traffic_protocol_t values
_PROTOCOL_IDS = {"http": 1, "http2": 2, "mysql": 3, "cql": 4, "pgsql": 5,
                 "dns": 6, "redis": 7, "nats": 8, "kafka": 10, "mux": 11}


class _Conn:
    __slots__ = ("tracker", "pending", "meta", "bytes_sent", "bytes_recv",
                 "opened", "closed_reported")

    def __init__(self, meta: dict):
        self.tracker: Optional[ConnTracker] = None
        #: (direction, data, ts) buffered until the protocol is known
        self.pending: list = []
        self.meta = meta
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.opened = True
        self.closed_reported = False


class SocketTraceConnector(SourceConnector):
    """Drains socket events from a source, parses protocols, fills the
    canonical event tables + conn_stats."""

    name = "socket_tracer"

    def __init__(self, source: "EventSource", asid: int = 0,
                 sample_period_s: float = 0.2, protocols=None,
                 name: Optional[str] = None):
        self.source = source
        self.asid = asid
        self.sample_period_s = sample_period_s
        self._parsers = parser_registry()
        if protocols is not None:
            self._parsers = {k: v for k, v in self._parsers.items()
                             if k in protocols}
        self._conns: dict = {}
        #: recently reaped conn ids — late events (half-close races from live
        #: taps) must not resurrect a connection with dataless metadata
        self._reaped: collections.OrderedDict = collections.OrderedDict()
        self.stats = {"events": 0, "records": 0, "unknown_protocol_conns": 0,
                      "parse_errors": 0, "late_events_dropped": 0}
        if name is not None:
            self.name = name

    def tables(self) -> list[TableSpec]:
        names = sorted({p.table for p in self._parsers.values()})
        names.append("conn_stats")
        return [TableSpec(n, SCHEMAS[n], sample_period_s=self.sample_period_s)
                for n in names]

    # --------------------------------------------------------------- events
    def _handle_event(self, ev: dict) -> None:
        self.stats["events"] += 1
        cid = ev.get("conn")
        kind = ev.get("ev")
        if kind == "open":
            self._conns[cid] = _Conn(meta=dict(ev))
            return
        conn = self._conns.get(cid)
        if conn is None:
            if cid in self._reaped:
                self.stats["late_events_dropped"] += 1
                return
            conn = self._conns[cid] = _Conn(meta=dict(ev))
        if kind == "close":
            if conn.tracker is not None:
                conn.tracker.closed = True
            conn.opened = False
            return
        data = ev.get("data", b"")
        if isinstance(data, str):
            data = base64.b64decode(data)
        ts = int(ev.get("ts") or now_ns())
        direction = ev.get("dir", "send")
        if direction == "send":
            conn.bytes_sent += len(data)
        else:
            conn.bytes_recv += len(data)
        if conn.tracker is None:
            # The direction's first bytes, not this event's alone: after a
            # first segment shorter than any signature, a middle segment
            # (": svc\r\n" of a header) read alone looks like RESP.
            first = b"".join([b for d, b, _t in conn.pending if d == direction] + [data])
            proto = conn.meta.get("protocol") or infer_protocol(first, direction)
            if proto is None or proto not in self._parsers:
                conn.pending.append((direction, data, ts))
                if len(conn.pending) > 64:
                    conn.pending.clear()  # undecodable chatter: drop
                    self.stats["unknown_protocol_conns"] += 1
                return
            parser = self._parsers[proto]
            role = int(conn.meta.get("role", ConnTracker.ROLE_SERVER))
            conn.tracker = ConnTracker(
                parser, role=role,
                # UPID = (asid, pid, pid start time) — the reference resolves
                # start_time_ticks from /proc (src/shared/metadata/pids.cc);
                # capture sources supply it in the open event.
                upid=UInt128.make_upid(self.asid,
                                       int(conn.meta.get("pid", 0)),
                                       int(conn.meta.get("pid_start_ns", 0))),
                remote_addr=str(conn.meta.get("addr", "")),
                remote_port=int(conn.meta.get("port", 0)),
            )
            for d, b, t in conn.pending:
                conn.tracker.add_data(d, b, t)
            conn.pending.clear()
        conn.tracker.add_data(direction, data, ts)

    # ------------------------------------------------------------ transfers
    def transfer_data(self) -> dict[str, dict]:
        drained = self.source.drain()
        for ev in drained:
            self._handle_event(ev)
        if self.source.exhausted and not drained:
            self.exhausted = True
        rows_by_table: dict[str, list[dict]] = {}
        conn_stat_rows: list[dict] = []
        dead = []
        for cid, conn in self._conns.items():
            tr = conn.tracker
            if tr is not None:
                records = tr.process()
                self.stats["parse_errors"] += (
                    tr.req_stream.invalid_frames + tr.resp_stream.invalid_frames)
                tr.req_stream.invalid_frames = 0
                tr.resp_stream.invalid_frames = 0
                if records:
                    rows = rows_by_table.setdefault(tr.parser.table, [])
                    for rec in records:
                        row = tr.parser.record_row(rec)
                        row.setdefault("time_", now_ns())
                        row["upid"] = tr.upid
                        row["remote_addr"] = tr.remote_addr
                        row["remote_port"] = tr.remote_port
                        row["trace_role"] = tr.role
                        rows.append(row)
                    self.stats["records"] += len(records)
            if not conn.opened and not conn.closed_reported:
                conn.closed_reported = True
                conn_stat_rows.append(self._conn_stats_row(conn))
                dead.append(cid)
        for cid in dead:
            self._conns.pop(cid, None)
            self._reaped[cid] = True
        while len(self._reaped) > 4096:
            self._reaped.popitem(last=False)
        out = {}
        for table, rows in rows_by_table.items():
            out[table] = self._columnar(table, rows)
        if conn_stat_rows:
            out["conn_stats"] = self._columnar("conn_stats", conn_stat_rows)
        return out

    def _conn_stats_row(self, conn: _Conn) -> dict:
        tr = conn.tracker
        return {
            "time_": now_ns(),
            "upid": (tr.upid if tr is not None
                     else UInt128.make_upid(
                         self.asid, int(conn.meta.get("pid", 0)),
                         int(conn.meta.get("pid_start_ns", 0)))),
            "remote_addr": (tr.remote_addr if tr is not None
                            else str(conn.meta.get("addr", ""))),
            "remote_port": (tr.remote_port if tr is not None
                            else int(conn.meta.get("port", 0))),
            "trace_role": tr.role if tr is not None else 0,
            "addr_family": 2,  # AF_INET
            "protocol": _PROTOCOL_IDS.get(tr.parser.name, 0)
            if tr is not None else 0,
            "ssl": False,
            "conn_open": 1,
            "conn_close": 1,
            "conn_active": 0,
            "bytes_sent": conn.bytes_sent,
            "bytes_recv": conn.bytes_recv,
        }

    @staticmethod
    def _columnar(table: str, rows: list[dict]) -> dict:
        from pixie_tpu_torch.types import DataType

        rel = SCHEMAS[table]
        n = len(rows)
        out: dict[str, object] = {}
        for c in rel:
            vals = [r.get(c.name) for r in rows]
            fill = "" if c.data_type == DataType.STRING else 0
            if all(v is None for v in vals):
                out[c.name] = ([""] * n if c.data_type == DataType.STRING
                               else np.zeros(n, dtype=np.int64))
            else:
                out[c.name] = [v if v is not None else fill for v in vals]
        return out


# ---------------------------------------------------------------- sources
class EventSource:
    """Supplies socket events to the tracer; drain() -> list of event dicts."""

    exhausted: bool = False

    def drain(self) -> list[dict]:
        raise NotImplementedError


class QueueEventSource(EventSource):
    """Thread-safe programmatic source (tests, in-process taps)."""

    def __init__(self):
        self._q: "queue.Queue[dict]" = queue.Queue()
        self._done = threading.Event()

    def emit(self, ev: dict) -> None:
        self._q.put(ev)

    def finish(self) -> None:
        self._done.set()

    def drain(self) -> list[dict]:
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        if self._done.is_set() and not out:
            self.exhausted = True
        return out


class CaptureFileSource(EventSource):
    """Replays a JSONL capture file; `data` fields are base64.

    Format (one JSON object per line):
      {"ev":"open","conn":1,"pid":42,"addr":"1.2.3.4","port":3306,
       "role":2,"protocol":"mysql"}
      {"ev":"data","conn":1,"dir":"recv","ts":123,"data":"<base64>"}
      {"ev":"close","conn":1}
    """

    def __init__(self, path: str, events_per_drain: int = 4096):
        self.path = path
        self.events_per_drain = events_per_drain
        self._it: Optional[Iterator[str]] = None
        self._fh = None

    def drain(self) -> list[dict]:
        if self.exhausted:
            return []
        if self._fh is None:
            self._fh = open(self.path, "r")
        out = []
        for _ in range(self.events_per_drain):
            line = self._fh.readline()
            if not line:
                self.exhausted = True
                self._fh.close()
                break
            line = line.strip()
            if line:
                out.append(json.loads(line))
        return out


def write_capture(path: str, events: Iterable[dict]) -> int:
    """Serialize events (data as bytes) to the JSONL capture format."""
    n = 0
    with open(path, "w") as fh:
        for ev in events:
            ev = dict(ev)
            if isinstance(ev.get("data"), (bytes, bytearray)):
                ev["data"] = base64.b64encode(bytes(ev["data"])).decode()
            fh.write(json.dumps(ev) + "\n")
            n += 1
    return n
