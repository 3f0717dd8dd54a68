"""Redis RESP protocol parser + stitcher.

Reference: socket_tracer/protocols/redis/ (parse.cc recursive RESP decode,
stitcher matching with pub/sub push handling, cmd table formatting.cc).

Wire facts (RESP2): values are
  +simple\r\n  -error\r\n  :int\r\n  $len\r\n<bytes>\r\n  *n\r\n<values>
A client request is an array of bulk strings; `$-1` / `*-1` are nulls.

Copied from the reference package (pixie_tpu/collect/protocols/redis.py).
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

#: two-token commands (subset of reference redis/cmd_args.json keys)
_COMPOSITE_CMDS = {
    "CLUSTER", "CLIENT", "CONFIG", "COMMAND", "MEMORY", "LATENCY", "OBJECT",
    "SCRIPT", "SLOWLOG", "XGROUP", "XINFO", "ACL", "DEBUG", "FUNCTION",
    "PUBSUB",
}
#: server→client push message kinds (reference stitcher: published messages)
_PUSH_KINDS = {"message", "pmessage", "subscribe", "unsubscribe",
               "psubscribe", "punsubscribe"}


@dataclasses.dataclass
class RedisValue(Frame):
    #: decoded python value: str | int | None | list
    value: object = None
    is_error: bool = False


def _parse_value(buf: bytes, pos: int, depth: int = 0):
    """-> (value, is_error, next_pos) or None (need more) or False (invalid)."""
    if depth > 32:
        return False
    if pos >= len(buf):
        return None
    t = buf[pos:pos + 1]
    nl = buf.find(b"\r\n", pos + 1)
    if t not in b"+-:$*":
        return False
    if nl < 0:
        return None if len(buf) - pos < 1 << 16 else False
    head = buf[pos + 1:nl]
    if t == b"+":
        return head.decode("latin1", "replace"), False, nl + 2
    if t == b"-":
        return head.decode("latin1", "replace"), True, nl + 2
    if t == b":":
        try:
            return int(head), False, nl + 2
        except ValueError:
            return False
    try:
        n = int(head)
    except ValueError:
        return False
    if t == b"$":
        if n == -1:
            return None, False, nl + 2
        if n < 0 or n > 512 * 1024 * 1024:
            return False
        end = nl + 2 + n
        if len(buf) < end + 2:
            return None
        if buf[end:end + 2] != b"\r\n":
            return False
        return buf[nl + 2:end].decode("latin1", "replace"), False, end + 2
    # array
    if n == -1:
        return None, False, nl + 2
    if n < 0 or n > 1 << 20:
        return False
    items = []
    p = nl + 2
    for _ in range(n):
        got = _parse_value(buf, p, depth + 1)
        if got is None or got is False:
            return got
        v, _err, p = got
        items.append(v)
    return items, False, p


def _fmt(value) -> str:
    """Human formatting like the reference's formatting.cc."""
    if value is None:
        return "<NULL>"
    if isinstance(value, list):
        return json.dumps([_fmt(v) if not isinstance(v, str) else v
                           for v in value], separators=(",", ":"))
    return str(value)


class RedisParser(ProtocolParser):
    name = "redis"
    table = "redis_events"

    def find_frame_boundary(self, msg_type, buf, start, state=None):
        for pos in range(start, len(buf)):
            if buf[pos:pos + 1] in b"+-:$*":
                return pos
        return -1

    def parse_frame(self, msg_type, buf, state=None):
        got = _parse_value(bytes(buf), 0)
        if got is None:
            return ParseState.NEEDS_MORE_DATA, None, 0
        if got is False:
            return ParseState.INVALID, None, 0
        value, is_err, consumed = got
        return ParseState.SUCCESS, RedisValue(value=value, is_error=is_err), consumed

    # ------------------------------------------------------------- stitching
    @staticmethod
    def _is_push(resp: RedisValue) -> bool:
        v = resp.value
        return (isinstance(v, list) and v
                and isinstance(v[0], str) and v[0].lower() in _PUSH_KINDS)

    def stitch(self, requests, responses, state=None):
        records = []
        errors = 0
        while responses:
            resp = responses[0]
            if self._is_push(resp) and (
                    not requests
                    or requests[0].timestamp_ns > resp.timestamp_ns):
                # Server push with no outstanding request (reference: the
                # stitcher emits pub/sub messages with an empty request).
                responses.popleft()
                records.append((None, resp))
                continue
            if not requests:
                break
            req = requests.popleft()
            responses.popleft()
            records.append((req, resp))
        return records, errors

    def record_row(self, record):
        req, resp = record
        cmd = ""
        args = []
        ts_req = resp.timestamp_ns
        if req is not None:
            ts_req = req.timestamp_ns
            v = req.value
            if isinstance(v, list) and v:
                toks = [str(x) for x in v]
                cmd = toks[0].upper()
                rest = toks[1:]
                if cmd in _COMPOSITE_CMDS and rest:
                    cmd = f"{cmd} {rest[0].upper()}"
                    rest = rest[1:]
                args = rest
            else:
                cmd = _fmt(v)
        elif self._is_push(resp):
            cmd = "PUSH PUB"
        return {
            "time_": resp.timestamp_ns,
            "latency": max(resp.timestamp_ns - ts_req, 0),
            "req_cmd": cmd,
            "req_args": json.dumps(args, separators=(",", ":")),
            "resp": _fmt(resp.value),
        }
