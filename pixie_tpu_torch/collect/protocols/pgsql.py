"""PostgreSQL wire-protocol parser + stitcher.

Reference: socket_tracer/protocols/pgsql/ (parse.cc tag+length framing,
stitcher.cc query→response-group matching up to ReadyForQuery).

Wire facts (PostgreSQL frontend/backend protocol v3): regular messages are
  [tag:1][len:4 big-endian, includes itself][payload:len-4].
The startup message and SSLRequest have no tag byte. Responses to a simple
Query run until ReadyForQuery ('Z').

Copied from the reference package (pixie_tpu/collect/protocols/pgsql.py),
but for one repair: the stitcher drops responses older than the oldest
request, as the MySQL stitcher does.
"""
from __future__ import annotations

import dataclasses
from collections import deque

from pixie_tpu_torch.collect.protocols.base import (
    Frame,
    MessageType,
    ParseState,
    ProtocolParser,
)

#: tag → reference-style command name (pgsql/types.h ToString(tag))
_REQ_TAGS = {
    b"Q": "Query", b"P": "Parse", b"B": "Bind", b"E": "Execute",
    b"D": "Describe", b"C": "Close", b"S": "Sync", b"F": "Fcall",
    b"X": "Terminate", b"H": "Flush", b"d": "CopyData", b"c": "CopyDone",
    b"f": "CopyFail", b"p": "Password",
}
_RESP_TAGS = {
    b"R": "Auth", b"K": "KeyData", b"S": "ParamStatus", b"T": "RowDesc",
    b"D": "DataRow", b"C": "CmdComplete", b"E": "ErrResp", b"N": "Notice",
    b"Z": "ReadyForQuery", b"I": "EmptyQuery", b"1": "ParseComplete",
    b"2": "BindComplete", b"3": "CloseComplete", b"n": "NoData",
    b"t": "ParamDesc", b"A": "Notification", b"G": "CopyIn", b"H": "CopyOut",
    b"d": "CopyData", b"c": "CopyDone", b"W": "CopyBoth", b"s": "PortalSuspend",
}

_SSL_REQUEST_CODE = 80877103
_PROTO_V3 = 196608


@dataclasses.dataclass
class PgMessage(Frame):
    tag: bytes = b""
    payload: bytes = b""


def _cstr(b: bytes) -> str:
    end = b.find(b"\x00")
    return (b[:end] if end >= 0 else b).decode("latin1", "replace")


def _err_fields(payload: bytes) -> str:
    """ErrorResponse payload: sequence of [code:1][value\\0]; return the
    human message (severity + M field) like the reference stitcher."""
    sev = msg = ""
    pos = 0
    while pos < len(payload) and payload[pos:pos + 1] != b"\x00":
        code = payload[pos:pos + 1]
        end = payload.find(b"\x00", pos + 1)
        if end < 0:
            break
        val = payload[pos + 1:end].decode("latin1", "replace")
        if code == b"S":
            sev = val
        elif code == b"M":
            msg = val
        pos = end + 1
    return f"{sev} {msg}".strip()


class _State:
    def __init__(self):
        self.startup_done = False   # request stream consumed the startup
        #: response stream saw its first bytes (the SSLRequest answer is a
        #: single tagless byte and may only be the FIRST thing the server
        #: sends — keyed per-stream, since the request stream processes
        #: first each round and must not flip response-side state)
        self.resp_started = False


class PgSQLParser(ProtocolParser):
    name = "pgsql"
    table = "pgsql_events"

    def new_state(self):
        return _State()

    def find_frame_boundary(self, msg_type, buf, start, state=None):
        tags = _REQ_TAGS if msg_type is MessageType.REQUEST else _RESP_TAGS
        for pos in range(start, max(len(buf) - 5, start)):
            if buf[pos:pos + 1] in tags:
                ln = int.from_bytes(buf[pos + 1:pos + 5], "big")
                if 4 <= ln <= 1 << 24:
                    return pos
        return -1

    def parse_frame(self, msg_type, buf, state=None):
        # Startup / SSLRequest (request stream, before startup_done): no tag.
        if (msg_type is MessageType.REQUEST and state is not None
                and not state.startup_done):
            if len(buf) < 8:
                return ParseState.NEEDS_MORE_DATA, None, 0
            ln = int.from_bytes(buf[:4], "big")
            code = int.from_bytes(buf[4:8], "big")
            if code in (_PROTO_V3, _SSL_REQUEST_CODE) and 8 <= ln <= 1 << 16:
                if len(buf) < ln:
                    return ParseState.NEEDS_MORE_DATA, None, 0
                if code == _PROTO_V3:
                    state.startup_done = True
                return ParseState.IGNORE, None, ln
            state.startup_done = True  # mid-stream attach: no startup seen
        # One server byte 'S'/'N' answers SSLRequest with NO length field.
        # This must be checked BEFORE the tagged-message path ('S' and 'N'
        # are also valid response tags), keyed on the response stream's OWN
        # first-bytes state plus an implausible would-be length.
        if msg_type is MessageType.RESPONSE and state is not None \
                and not state.resp_started:
            state.resp_started = True
            if buf[:1] in (b"S", b"N"):
                ln_guess = (int.from_bytes(buf[1:5], "big")
                            if len(buf) >= 5 else -1)
                if ln_guess < 4 or ln_guess > 1 << 24:
                    return ParseState.IGNORE, None, 1
        if len(buf) < 5:
            return ParseState.NEEDS_MORE_DATA, None, 0
        tag = buf[:1]
        tags = _REQ_TAGS if msg_type is MessageType.REQUEST else _RESP_TAGS
        if tag not in tags:
            return ParseState.INVALID, None, 0
        ln = int.from_bytes(buf[1:5], "big")
        if ln < 4 or ln > 1 << 24:
            return ParseState.INVALID, None, 0
        if len(buf) < 1 + ln:
            return ParseState.NEEDS_MORE_DATA, None, 0
        payload = bytes(buf[5:1 + ln])
        # Async/noise messages that are not part of any exchange.
        if msg_type is MessageType.RESPONSE and tag in (b"S", b"K", b"R",
                                                        b"N", b"A"):
            if state is not None and tag == b"R":
                state.startup_done = True
            return ParseState.IGNORE, None, 1 + ln
        return ParseState.SUCCESS, PgMessage(tag=tag, payload=payload), 1 + ln

    # ------------------------------------------------------------- stitching
    def stitch(self, requests, responses, state=None):
        records = []
        errors = 0
        while requests:
            req = requests[0]
            if req.tag in (b"X", b"c", b"d", b"f", b"H"):
                requests.popleft()  # no paired response
                continue
            # Responses older than the oldest request answer none of them:
            # the ReadyForQuery that ends a startup, or responses whose
            # request was lost.  (The reference keeps them, and pairs the
            # startup's ReadyForQuery with the first query: each later row
            # of the connection then takes the response before its own.)
            while responses and responses[0].timestamp_ns < req.timestamp_ns:
                responses.popleft()
            # The response group for the oldest request: frames up to and
            # including ReadyForQuery that belong to it (i.e. before the
            # next request's timestamp).
            nxt_ts = requests[1].timestamp_ns if len(requests) > 1 else None
            group = []
            done = False
            for m in responses:
                if nxt_ts is not None and m.timestamp_ns >= nxt_ts and group:
                    done = True  # next request started: close this group
                    break
                group.append(m)
                if m.tag == b"Z":
                    done = True
                    break
            if not done:
                break
            for _ in group:
                responses.popleft()
            requests.popleft()
            records.append((req, group))
        return records, errors

    def record_row(self, record):
        req, group = record
        req_text = ""
        if req.tag in (b"Q", b"P"):
            # Parse: [stmt\0][query\0]; Query: [query\0]
            p = req.payload
            if req.tag == b"P":
                first = p.find(b"\x00")
                p = p[first + 1:] if first >= 0 else p
            req_text = _cstr(p)
        resp_text = ""
        n_rows = 0
        end_ts = req.timestamp_ns
        for m in group:
            end_ts = max(end_ts, m.timestamp_ns)
            if m.tag == b"D":
                n_rows += 1
            elif m.tag == b"C":
                resp_text = _cstr(m.payload)
            elif m.tag == b"E":
                resp_text = _err_fields(m.payload)
            elif m.tag == b"I":
                resp_text = resp_text or "EmptyQueryResponse"
        if n_rows and resp_text:
            resp_text = f"{resp_text} ({n_rows} rows)"
        return {
            "time_": end_ts,
            "latency": max(end_ts - req.timestamp_ns, 0),
            "req_cmd": _REQ_TAGS.get(req.tag, "Unknown"),
            "req": req_text,
            "resp": resp_text,
        }
