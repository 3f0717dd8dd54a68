"""NATS text-protocol parser + stitcher.

Reference: socket_tracer/protocols/nats/ (parse.cc line-oriented command
parse with PUB/MSG payloads; nats_table.h columns cmd/body/resp).

Wire facts (NATS protocol): commands are CRLF-terminated lines —
INFO/CONNECT carry a JSON option block inline; PUB/HPUB/MSG/HMSG declare a
payload byte count on the line, followed by the payload and CRLF.

Copied from the reference package (pixie_tpu/collect/protocols/nats.py).
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

_PAYLOAD_CMDS = {"PUB", "HPUB", "MSG", "HMSG"}
_KNOWN = {"INFO", "CONNECT", "PUB", "HPUB", "SUB", "UNSUB", "MSG", "HMSG",
          "PING", "PONG", "+OK", "-ERR"}


@dataclasses.dataclass
class NATSCommand(Frame):
    cmd: str = ""
    args: list = dataclasses.field(default_factory=list)
    payload: str = ""


class NATSParser(ProtocolParser):
    name = "nats"
    table = "nats_events.beta"

    def find_frame_boundary(self, msg_type, buf, start, state=None):
        pos = buf.find(b"\r\n", start)
        return pos + 2 if pos >= 0 and pos + 2 < len(buf) else -1

    def parse_frame(self, msg_type, buf, state=None):
        nl = buf.find(b"\r\n")
        if nl < 0:
            if len(buf) > 1 << 16:
                return ParseState.INVALID, None, 0
            return ParseState.NEEDS_MORE_DATA, None, 0
        line = buf[:nl].decode("latin1", "replace")
        toks = line.split()
        if not toks:
            return ParseState.IGNORE, None, nl + 2
        cmd = toks[0].upper()
        if cmd not in _KNOWN:
            return ParseState.INVALID, None, 0
        frame = NATSCommand(cmd=cmd, args=toks[1:])
        end = nl + 2
        if cmd in _PAYLOAD_CMDS:
            try:
                size = int(toks[-1])
            except (ValueError, IndexError):
                return ParseState.INVALID, None, 0
            if size < 0 or size > 1 << 26:
                return ParseState.INVALID, None, 0
            if len(buf) < end + size + 2:
                return ParseState.NEEDS_MORE_DATA, None, 0
            frame.payload = buf[end:end + size].decode("latin1", "replace")
            end += size + 2
        return ParseState.SUCCESS, frame, end

    def new_state(self):
        class _State:
            #: id() of a request already held back one round awaiting its ack
            held = None
            #: connection has shown +OK/-ERR acks (CONNECT verbose mode)
            verbose = False

        return _State()

    # ------------------------------------------------------------- stitching
    def stitch(self, requests, responses, state=None):
        """NATS is not strictly request/response: most commands are one-way.
        Each frame (either direction) becomes a record; +OK/-ERR responses
        attach to the most recent unacked client command (verbose mode).
        On VERBOSE connections (ones that have shown acks) the newest
        unanswered command is held back for one round so an ack landing in
        the next transfer interval can still attach; non-verbose connections
        (the common mode — servers never ack) emit immediately."""
        records = []
        errors = 0
        if state is not None and not state.verbose:
            state.verbose = any(r.cmd in ("+OK", "-ERR") for r in responses)
        while requests:
            req = requests[0]
            resp = ""
            if responses and responses[0].cmd in ("+OK", "-ERR") \
                    and responses[0].timestamp_ns >= req.timestamp_ns:
                r = responses.popleft()
                resp = r.cmd if not r.args else f"{r.cmd} {' '.join(r.args)}"
            elif len(requests) == 1 and state is not None and state.verbose \
                    and state.held != id(req):
                state.held = id(req)
                break  # wait one round for a possible late ack
            requests.popleft()
            if state is not None and state.held == id(req):
                state.held = None
            records.append((req, resp))
        while responses:
            r = responses.popleft()
            if r.cmd in ("+OK",):  # stray ack with no visible command
                continue
            records.append((r, ""))
        return records, errors

    def record_row(self, record):
        frame, resp = record
        body: dict[str, object] = {}
        c, a = frame.cmd, frame.args
        if c in ("INFO", "CONNECT") and a:
            body["options"] = " ".join(a)
        elif c in ("PUB", "HPUB") and a:
            body = {"subject": a[0], "payload": frame.payload}
            if len(a) > 2:
                body["reply_to"] = a[1]
        elif c in ("MSG", "HMSG") and len(a) >= 2:
            body = {"subject": a[0], "sid": a[1], "payload": frame.payload}
            if len(a) > 3:
                body["reply_to"] = a[2]
        elif c == "SUB" and a:
            body = {"subject": a[0], "sid": a[-1]}
        elif c == "UNSUB" and a:
            body = {"sid": a[0]}
        elif c == "-ERR" and a:
            body = {"error": " ".join(a)}
        return {
            "time_": frame.timestamp_ns,
            "cmd": c,
            "body": json.dumps(body, separators=(",", ":")),
            "resp": resp,
        }
