"""Twitter Mux (Finagle RPC) protocol parser + tag stitcher.

Reference: socket_tracer/protocols/mux/ (parse.cc 4-byte-length framing,
stitcher by 3-byte tag; mux_table.h columns req_type + latency only).

Wire facts (mux spec): every message is [length:4 BE][type:1 signed][tag:3].
Positive types are sent Tmessages (requests); their negative counterpart is
the Rmessage reply carrying the same tag.

Copied from the reference package (pixie_tpu/collect/protocols/mux.py).
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

#: mux message types (spec; reference mux/types.h)
T_TYPES = {1: "Treq", 2: "Tdispatch", 64: "Tinit", 65: "Tping",
           66: "Tdiscarded", 67: "Tlease", 68: "Tdrain"}
_VALID_TYPES = set(T_TYPES) | {-t for t in T_TYPES} | {127, -128, -62}


@dataclasses.dataclass
class MuxFrame(Frame):
    type_: int = 0
    tag: int = 0
    length: int = 0


class MuxParser(ProtocolParser):
    name = "mux"
    table = "mux_events"

    def find_frame_boundary(self, msg_type, buf, start, state=None):
        for pos in range(start, max(len(buf) - 8, start)):
            ln = int.from_bytes(buf[pos:pos + 4], "big")
            t = int.from_bytes(buf[pos + 4:pos + 5], "big", signed=True)
            if 4 <= ln <= 1 << 24 and t in _VALID_TYPES:
                return pos
        return -1

    def parse_frame(self, msg_type, buf, state=None):
        if len(buf) < 8:
            return ParseState.NEEDS_MORE_DATA, None, 0
        ln = int.from_bytes(buf[:4], "big")
        if not 4 <= ln <= 1 << 24:
            return ParseState.INVALID, None, 0
        t = int.from_bytes(buf[4:5], "big", signed=True)
        if t not in _VALID_TYPES:
            return ParseState.INVALID, None, 0
        if len(buf) < 4 + ln:
            return ParseState.NEEDS_MORE_DATA, None, 0
        frame = MuxFrame(
            type_=t,
            tag=int.from_bytes(buf[5:8], "big"),
            length=ln,
        )
        return ParseState.SUCCESS, frame, 4 + ln

    # ------------------------------------------------------------- stitching
    def stitch(self, requests, responses, state=None):
        records = []
        errors = 0
        pending: dict[int, MuxFrame] = {}
        for req in requests:
            pending[req.tag] = req
        matched_req = set()
        for resp in responses:
            req = pending.pop(resp.tag, None)
            if req is None:
                errors += 1
                continue
            # The tag is answered either way; a type mismatch is an error
            # record dropped, and the request must not linger forever.
            matched_req.add(id(req))
            if resp.type_ != -req.type_:
                errors += 1
                continue
            records.append((req, resp))
        responses.clear()
        if matched_req:
            kept = [r for r in requests if id(r) not in matched_req]
            requests.clear()
            requests.extend(kept)
        return records, errors

    def record_row(self, record):
        req, resp = record
        return {
            "time_": resp.timestamp_ns,
            "latency": max(resp.timestamp_ns - req.timestamp_ns, 0),
            "req_type": req.type_,
        }
