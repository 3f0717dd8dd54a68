"""Kafka wire-protocol parser + correlation-id stitcher.

Reference: socket_tracer/protocols/kafka/ (decoder framework under
decoder/, stitcher by correlation_id; kafka_table.h columns req_cmd,
client_id, req_body, resp).

Wire facts (Kafka protocol): every message is [length:4 BE][payload].
Request payload: [api_key:2][api_version:2][correlation_id:4]
[client_id: int16-length string (nullable, -1)] [request body].
Response payload: [correlation_id:4][response body].

Copied from the reference package (pixie_tpu/collect/protocols/kafka.py).
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

#: api_key → name (Kafka protocol spec; reference kafka/common/types.h)
API_KEYS = {
    0: "Produce", 1: "Fetch", 2: "ListOffsets", 3: "Metadata",
    8: "OffsetCommit", 9: "OffsetFetch", 10: "FindCoordinator",
    11: "JoinGroup", 12: "Heartbeat", 13: "LeaveGroup", 14: "SyncGroup",
    15: "DescribeGroups", 16: "ListGroups", 17: "SaslHandshake",
    18: "ApiVersions", 19: "CreateTopics", 20: "DeleteTopics",
    22: "InitProducerId", 32: "DescribeConfigs", 36: "SaslAuthenticate",
}


@dataclasses.dataclass
class KafkaFrame(Frame):
    is_request: bool = True
    api_key: int = 0
    api_version: int = 0
    correlation_id: int = 0
    client_id: str = ""
    body_size: int = 0


class _State:
    """Stitching needs request api metadata to interpret responses, and the
    set of outstanding correlation ids to frame the response stream."""

    def __init__(self):
        self.outstanding: dict[int, KafkaFrame] = {}


class KafkaParser(ProtocolParser):
    name = "kafka"
    table = "kafka_events.beta"

    def new_state(self):
        return _State()

    def find_frame_boundary(self, msg_type, buf, start, state=None):
        for pos in range(start, max(len(buf) - 8, start)):
            ln = int.from_bytes(buf[pos:pos + 4], "big")
            if not 8 <= ln <= 1 << 24:
                continue
            if msg_type is MessageType.REQUEST:
                api_key = int.from_bytes(buf[pos + 4:pos + 6], "big")
                if api_key in API_KEYS:
                    return pos
            else:
                return pos
        return -1

    def parse_frame(self, msg_type, buf, state=None):
        if len(buf) < 4:
            return ParseState.NEEDS_MORE_DATA, None, 0
        ln = int.from_bytes(buf[:4], "big")
        if not 4 <= ln <= 1 << 26:
            return ParseState.INVALID, None, 0
        if len(buf) < 4 + ln:
            return ParseState.NEEDS_MORE_DATA, None, 0
        p = bytes(buf[4:4 + ln])
        frame = KafkaFrame(body_size=ln)
        if msg_type is MessageType.REQUEST:
            if len(p) < 8:
                return ParseState.INVALID, None, 0
            frame.is_request = True
            frame.api_key = int.from_bytes(p[0:2], "big", signed=True)
            frame.api_version = int.from_bytes(p[2:4], "big", signed=True)
            frame.correlation_id = int.from_bytes(p[4:8], "big", signed=True)
            if frame.api_key not in API_KEYS or frame.api_version > 20:
                return ParseState.INVALID, None, 0
            cid_len = int.from_bytes(p[8:10], "big", signed=True) \
                if len(p) >= 10 else -1
            if cid_len > 0 and len(p) >= 10 + cid_len:
                frame.client_id = p[10:10 + cid_len].decode("latin1", "replace")
        else:
            if len(p) < 4:
                return ParseState.INVALID, None, 0
            frame.is_request = False
            frame.correlation_id = int.from_bytes(p[0:4], "big", signed=True)
        return ParseState.SUCCESS, frame, 4 + ln

    # ------------------------------------------------------------- stitching
    def stitch(self, requests, responses, state=None):
        records = []
        errors = 0
        pending: dict[int, KafkaFrame] = {}
        for req in requests:
            pending[req.correlation_id] = req
        matched_req = set()
        for resp in responses:
            req = pending.pop(resp.correlation_id, None)
            if req is None:
                errors += 1
                continue
            matched_req.add(id(req))
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
            "req_cmd": req.api_key,
            "client_id": req.client_id,
            "req_body": json.dumps(
                {"api": API_KEYS.get(req.api_key, str(req.api_key)),
                 "api_version": req.api_version,
                 "size": req.body_size},
                separators=(",", ":")),
            "resp": json.dumps({"size": resp.body_size},
                               separators=(",", ":")),
        }
