"""Cassandra (CQL native protocol) parser + stream-id stitcher.

Reference: socket_tracer/protocols/cql/ (frame_body_decoder.cc, stitcher
matching by stream id; cass_table.h columns req_op/req_body/resp_op/resp_body).

Wire facts (CQL native protocol v3/v4): 9-byte header
  [version:1][flags:1][stream:2 BE][opcode:1][length:4 BE] + body.
Request frames have version 0x03/0x04; responses have the 0x80 bit set.

Copied from the reference package (pixie_tpu/collect/protocols/cql.py).
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

# opcodes (cql spec §2.4; reference cql/types.h ReqOp/RespOp)
OP_ERROR = 0x00
OP_STARTUP = 0x01
OP_READY = 0x02
OP_AUTHENTICATE = 0x03
OP_OPTIONS = 0x05
OP_SUPPORTED = 0x06
OP_QUERY = 0x07
OP_RESULT = 0x08
OP_PREPARE = 0x09
OP_EXECUTE = 0x0A
OP_REGISTER = 0x0B
OP_EVENT = 0x0C
OP_BATCH = 0x0D
OP_AUTH_CHALLENGE = 0x0E
OP_AUTH_RESPONSE = 0x0F
OP_AUTH_SUCCESS = 0x10

_RESULT_KINDS = {1: "Void", 2: "Rows", 3: "Set keyspace", 4: "Prepared",
                 5: "Schema change"}


@dataclasses.dataclass
class CQLFrame(Frame):
    version: int = 0
    stream: int = 0
    opcode: int = 0
    body: bytes = b""


def _long_string(b: bytes) -> str:
    if len(b) < 4:
        return ""
    n = int.from_bytes(b[:4], "big")
    return b[4:4 + n].decode("latin1", "replace")


class CQLParser(ProtocolParser):
    name = "cql"
    table = "cql_events"

    def find_frame_boundary(self, msg_type, buf, start, state=None):
        want_resp = msg_type is MessageType.RESPONSE
        for pos in range(start, max(len(buf) - 9, start)):
            v = buf[pos]
            base = v & 0x7F
            if base not in (3, 4, 5) or bool(v & 0x80) != want_resp:
                continue
            ln = int.from_bytes(buf[pos + 5:pos + 9], "big")
            if ln <= 1 << 28:
                return pos
        return -1

    def parse_frame(self, msg_type, buf, state=None):
        if len(buf) < 9:
            return ParseState.NEEDS_MORE_DATA, None, 0
        version = buf[0]
        base = version & 0x7F
        is_resp = bool(version & 0x80)
        if base not in (3, 4, 5) or is_resp != (msg_type is MessageType.RESPONSE):
            return ParseState.INVALID, None, 0
        opcode = buf[4]
        if opcode > 0x10:
            return ParseState.INVALID, None, 0
        ln = int.from_bytes(buf[5:9], "big")
        if ln > 1 << 28:
            return ParseState.INVALID, None, 0
        if len(buf) < 9 + ln:
            return ParseState.NEEDS_MORE_DATA, None, 0
        frame = CQLFrame(
            version=base,
            stream=int.from_bytes(buf[2:4], "big", signed=True),
            opcode=opcode,
            body=bytes(buf[9:9 + ln]),
        )
        return ParseState.SUCCESS, frame, 9 + ln

    # ------------------------------------------------------------- stitching
    def stitch(self, requests, responses, state=None):
        records = []
        errors = 0
        # FIFO queue per stream id: two in-flight requests reusing one stream
        # id within a round must match their responses in order (latest-wins
        # would pair the newer request with the older response's latency).
        pending: dict[int, deque] = {}
        for r in requests:
            pending.setdefault(r.stream, deque()).append(r)
        matched_req = set()
        for resp in responses:
            if resp.opcode == OP_EVENT:  # server push, no request
                records.append((None, resp))
                continue
            q = pending.get(resp.stream)
            if not q:
                errors += 1
                continue
            req = q.popleft()
            # Self-heal after a lost response: a NEWER request strictly older
            # than this response on the same stream id means the head's
            # response was dropped (CQL forbids two in-flight per id) — the
            # stale head must not shift every later pairing on this stream.
            while q and req.timestamp_ns and \
                    req.timestamp_ns < q[0].timestamp_ns <= resp.timestamp_ns:
                errors += 1
                matched_req.add(id(req))  # abandoned: leave the deque too
                req = q.popleft()
            matched_req.add(id(req))
            records.append((req, resp))
        # Every response resolves this round (matched, push, or orphan);
        # rebuild the request deque once — O(n), not per-item remove.
        responses.clear()
        if matched_req:
            kept = [r for r in requests if id(r) not in matched_req]
            requests.clear()
            requests.extend(kept)
        return records, errors

    @staticmethod
    def _req_body(frame: CQLFrame) -> str:
        if frame.opcode in (OP_QUERY, OP_PREPARE):
            return _long_string(frame.body)
        if frame.opcode == OP_STARTUP:
            return "STARTUP"
        return ""

    @staticmethod
    def _resp_body(frame: CQLFrame) -> str:
        if frame.opcode == OP_RESULT and len(frame.body) >= 4:
            kind = int.from_bytes(frame.body[:4], "big")
            out = _RESULT_KINDS.get(kind, f"kind={kind}")
            if kind == 2 and len(frame.body) >= 12:
                # Rows: [metadata flags:4][col count:4] … row count follows
                # metadata; report column count which is cheap to decode.
                ncols = int.from_bytes(frame.body[8:12], "big")
                out = f"Rows ({ncols} columns)"
            return out
        if frame.opcode == OP_ERROR and len(frame.body) >= 6:
            # [code:4][message: SHORT string — 2-byte length (spec §3)]
            n = int.from_bytes(frame.body[4:6], "big")
            return frame.body[6:6 + n].decode("latin1", "replace")
        if frame.opcode == OP_READY:
            return "READY"
        return ""

    def record_row(self, record):
        req, resp = record
        req_ts = req.timestamp_ns if req is not None else resp.timestamp_ns
        return {
            "time_": resp.timestamp_ns,
            "latency": max(resp.timestamp_ns - req_ts, 0),
            "req_op": req.opcode if req is not None else -1,
            "req_body": self._req_body(req) if req is not None else "",
            "resp_op": resp.opcode,
            "resp_body": self._resp_body(resp),
        }
