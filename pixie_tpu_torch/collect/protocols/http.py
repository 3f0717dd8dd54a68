"""HTTP/1.x frame parser + stitcher.

Reference: src/stirling/source_connectors/socket_tracer/protocols/http/
(parse.cc pico-http-parser based frame parse; stitcher.cc FIFO req/resp
matching; http_table.h column semantics).

Copied from the reference package (pixie_tpu/collect/protocols/http.py).
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque

from pixie_tpu_torch.collect.protocols.base import (
    Frame,
    MessageType,
    ParseState,
    ProtocolParser,
)

_METHODS = (b"GET ", b"POST ", b"PUT ", b"DELETE ", b"HEAD ", b"OPTIONS ",
            b"PATCH ", b"TRACE ", b"CONNECT ")

#: reference http/types.h ContentType enum
CONTENT_TYPE_UNKNOWN = 0
CONTENT_TYPE_JSON = 1

#: cap stored bodies like the reference's FLAGS_http_body_limit_bytes default
BODY_LIMIT = 512


@dataclasses.dataclass
class HTTPMessage(Frame):
    is_request: bool = True
    major: int = 1
    minor: int = 1
    method: str = ""
    path: str = ""
    status: int = 0
    message: str = ""
    headers: dict = dataclasses.field(default_factory=dict)
    body: str = ""
    body_size: int = 0


def _parse_headers(lines: list[bytes]) -> dict:
    headers: dict[str, str] = {}
    for ln in lines:
        if b":" not in ln:
            continue
        k, v = ln.split(b":", 1)
        headers[k.decode("latin1").strip().lower()] = v.decode("latin1").strip()
    return headers


def _parse_chunked(buf: bytes, start: int):
    """-> (body_bytes, end_offset) or None if incomplete, or -1 invalid."""
    pos = start
    body = bytearray()
    while True:
        nl = buf.find(b"\r\n", pos)
        if nl < 0:
            return None
        size_tok = buf[pos:nl].split(b";", 1)[0].strip()
        try:
            size = int(size_tok, 16)
        except ValueError:
            return -1
        pos = nl + 2
        if size == 0:
            # trailers until blank line
            end = buf.find(b"\r\n", pos)
            if end < 0:
                return None
            while end != pos:  # skip trailer lines
                pos = end + 2
                end = buf.find(b"\r\n", pos)
                if end < 0:
                    return None
            return bytes(body), end + 2
        if len(buf) < pos + size + 2:
            return None
        body += buf[pos:pos + size]
        pos += size + 2


class _State:
    """Response body semantics depend on the REQUEST (RFC 9110: HEAD
    responses carry no body even with Content-Length) — track the in-flight
    request methods in order.  The request stream is processed before the
    response stream each round (ConnTracker.process), so order holds."""

    def __init__(self):
        from collections import deque as _dq

        self.pending_methods = _dq()


class HTTPParser(ProtocolParser):
    name = "http"
    table = "http_events"

    def new_state(self):
        return _State()

    def find_frame_boundary(self, msg_type, buf, start, state=None):
        if msg_type is MessageType.RESPONSE:
            pos = buf.find(b"HTTP/1.", start)
            return pos if pos > 0 else -1
        best = -1
        for m in _METHODS:
            pos = buf.find(m, start)
            if pos > 0 and (best < 0 or pos < best):
                best = pos
        return best

    def parse_frame(self, msg_type, buf, state=None):
        hdr_end = buf.find(b"\r\n\r\n")
        if hdr_end < 0:
            if len(buf) > 64 * 1024:  # header section too big: not HTTP
                return ParseState.INVALID, None, 0
            return ParseState.NEEDS_MORE_DATA, None, 0
        head = buf[:hdr_end]
        lines = head.split(b"\r\n")
        start_line = lines[0].split(b" ", 2)
        msg = HTTPMessage()
        try:
            if msg_type is MessageType.REQUEST:
                if len(start_line) != 3 or not start_line[2].startswith(b"HTTP/"):
                    return ParseState.INVALID, None, 0
                msg.is_request = True
                msg.method = start_line[0].decode("latin1")
                msg.path = start_line[1].decode("latin1")
                ver = start_line[2][5:]
            else:
                if not start_line[0].startswith(b"HTTP/"):
                    return ParseState.INVALID, None, 0
                msg.is_request = False
                msg.status = int(start_line[1])
                msg.message = (start_line[2].decode("latin1")
                               if len(start_line) > 2 else "")
                ver = start_line[0][5:]
            mj, _, mn = ver.partition(b".")
            msg.major, msg.minor = int(mj), int(mn or 0)
        except (ValueError, IndexError):
            return ParseState.INVALID, None, 0
        msg.headers = _parse_headers(lines[1:])
        body_start = hdr_end + 4

        if not msg.is_request:
            # Peek (pop happens only on SUCCESS): NEEDS_MORE_DATA re-parses.
            head_req = (state is not None and state.pending_methods
                        and state.pending_methods[0] == "HEAD")
            # Bodiless responses (HEAD, 1xx, 204, 304) end at the headers no
            # matter what Content-Length claims — waiting for the declared
            # body would stall the stream forever.
            if head_req or msg.status in (204, 304) or 100 <= msg.status < 200:
                if state is not None and state.pending_methods:
                    state.pending_methods.popleft()
                return ParseState.SUCCESS, msg, body_start

        te = msg.headers.get("transfer-encoding", "")
        if "chunked" in te:
            res = _parse_chunked(buf, body_start)
            if res is None:
                return ParseState.NEEDS_MORE_DATA, None, 0
            if res == -1:
                return ParseState.INVALID, None, 0
            body, end = res
        else:
            try:
                clen = int(msg.headers.get("content-length", "0"))
            except ValueError:
                return ParseState.INVALID, None, 0
            if clen < 0:
                return ParseState.INVALID, None, 0
            if len(buf) < body_start + clen:
                return ParseState.NEEDS_MORE_DATA, None, 0
            body = buf[body_start:body_start + clen]
            end = body_start + clen
        msg.body_size = len(body)
        msg.body = body[:BODY_LIMIT].decode("latin1")
        # Method bookkeeping only on SUCCESS: partial parses return
        # NEEDS_MORE_DATA and re-run, which must not double-count.
        if state is not None:
            if msg.is_request:
                state.pending_methods.append(msg.method)
            elif state.pending_methods:
                state.pending_methods.popleft()
        return ParseState.SUCCESS, msg, end

    def stitch(self, requests, responses, state=None):
        records = []
        errors = 0
        while requests and responses:
            req = requests.popleft()
            # Drop responses that predate the oldest request (lost request).
            while responses and responses[0].timestamp_ns < req.timestamp_ns:
                responses.popleft()
                errors += 1
            if not responses:
                requests.appendleft(req)
                break
            records.append((req, responses.popleft()))
        return records, errors

    def record_row(self, record):
        req, resp = record
        ctype = CONTENT_TYPE_UNKNOWN
        if "json" in resp.headers.get("content-type", ""):
            ctype = CONTENT_TYPE_JSON
        return {
            # reference socket_trace_connector.cc AppendMessage: time_ is the
            # RESPONSE timestamp; latency = resp_ts - req_ts
            "time_": resp.timestamp_ns,
            "latency": max(resp.timestamp_ns - req.timestamp_ns, 0),
            "major_version": req.major,
            "minor_version": req.minor,
            "content_type": ctype,
            "req_headers": json.dumps(req.headers, sort_keys=True),
            "req_method": req.method,
            "req_path": req.path,
            "req_body": req.body,
            "req_body_size": req.body_size,
            "resp_headers": json.dumps(resp.headers, sort_keys=True),
            "resp_status": resp.status,
            "resp_message": resp.message,
            "resp_body": resp.body,
            "resp_body_size": resp.body_size,
        }
