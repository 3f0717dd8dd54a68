"""MySQL client/server protocol parser + stitcher.

Reference: socket_tracer/protocols/mysql/ (parse.cc packet framing — 3-byte
LE length + sequence id; stitcher.cc command→response-set matching;
types.h command codes and RespStatus).

Wire facts (MySQL protocol spec): every packet is
  [len:3 little-endian][seq:1][payload:len].
A request is a command packet (seq 0 from the client) whose first payload
byte is the command code; the response is a packet run terminated by an
OK (0x00) / ERR (0xff) / EOF (0xfe, len<9) packet or a complete resultset.

Copied from the reference package (pixie_tpu/collect/protocols/mysql.py).
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

# command codes (mysql protocol; reference mysql/types.h Command)
COM_QUIT = 0x01
COM_INIT_DB = 0x02
COM_QUERY = 0x03
COM_FIELD_LIST = 0x04
COM_PING = 0x0E
COM_STMT_PREPARE = 0x16
COM_STMT_EXECUTE = 0x17
COM_STMT_CLOSE = 0x19

#: commands whose payload after the code byte is human-readable text
_TEXT_COMMANDS = {COM_QUERY, COM_INIT_DB, COM_FIELD_LIST, COM_STMT_PREPARE}

# reference mysql/types.h RespStatus {kUnknown, kNone, kOK, kErr}
RESP_UNKNOWN = 0
RESP_NONE = 1
RESP_OK = 2
RESP_ERR = 3


@dataclasses.dataclass
class MySQLPacket(Frame):
    seq: int = 0
    payload: bytes = b""


class _State:
    """Cross-frame state: handshake progress, tracked per direction (the
    greeting lives on the response stream, the login on the request stream,
    and stream processing order must not couple them)."""

    def __init__(self):
        self.handshake_done = False  # client login seen or inferred
        self.greeting_done = False   # server greeting consumed


class MySQLParser(ProtocolParser):
    name = "mysql"
    table = "mysql_events"

    def new_state(self):
        return _State()

    def find_frame_boundary(self, msg_type, buf, start, state=None):
        # A request boundary is a packet with seq==0 and a valid command
        # byte; scan for that shape (reference mysql/parse.cc does the same
        # plausibility scan).
        for pos in range(start, max(len(buf) - 5, start)):
            ln = int.from_bytes(buf[pos:pos + 3], "little")
            seq = buf[pos + 3]
            if seq != 0 or ln == 0 or ln > 1 << 24:
                continue
            if msg_type is MessageType.REQUEST and buf[pos + 4] > 0x20:
                continue
            return pos
        return -1

    def parse_frame(self, msg_type, buf, state=None):
        if len(buf) < 4:
            return ParseState.NEEDS_MORE_DATA, None, 0
        ln = int.from_bytes(buf[:3], "little")
        seq = buf[3]
        if ln == 0:
            return ParseState.INVALID, None, 0
        if len(buf) < 4 + ln:
            return ParseState.NEEDS_MORE_DATA, None, 0
        payload = buf[4:4 + ln]
        # Handshake traffic: server greeting (protocol version 10, seq 0 on
        # the response stream) and the client login packet (seq 1 on the
        # request stream) — consume without emitting frames.
        if state is not None and msg_type is MessageType.RESPONSE \
                and not state.greeting_done:
            state.greeting_done = True
            if seq == 0 and payload[:1] == b"\x0a":
                return ParseState.IGNORE, None, 4 + ln
        if state is not None and not state.handshake_done:
            if msg_type is MessageType.REQUEST and seq == 1:
                state.handshake_done = True
                return ParseState.IGNORE, None, 4 + ln
        if msg_type is MessageType.REQUEST:
            if seq != 0 or payload[0] > 0x20:
                return ParseState.INVALID, None, 0
            if state is not None:
                state.handshake_done = True
        pkt = MySQLPacket(seq=seq, payload=bytes(payload))
        return ParseState.SUCCESS, pkt, 4 + ln

    # ------------------------------------------------------------- stitching
    @staticmethod
    def _is_eof(p: bytes) -> bool:
        return len(p) < 9 and p[:1] == b"\xfe"

    def _summarize_response(self, req_cmd: int, resps: list[MySQLPacket]):
        """Response packet run -> (status, body) per reference handler.cc."""
        if not resps:
            return RESP_NONE, ""
        first = resps[0].payload
        if first[:1] == b"\xff":
            # ERR packet: [0xff][code:2][#sqlstate:6][message]
            msg = first[9:].decode("latin1", "replace") if len(first) > 9 else ""
            return RESP_ERR, msg
        if first[:1] == b"\x00":
            return RESP_OK, ""
        if self._is_eof(first):
            return RESP_OK, ""
        # Resultset: [col_count][col defs...][EOF][rows...][EOF/OK]
        n_rows = 0
        seen_col_eof = False
        for p in resps[1:]:
            if self._is_eof(p.payload) or p.payload[:1] == b"\x00":
                if not seen_col_eof:
                    seen_col_eof = True
                continue
            if seen_col_eof:
                n_rows += 1
        return RESP_OK, f"Resultset rows = {n_rows}"

    def stitch(self, requests, responses, state=None):
        records = []
        errors = 0
        while requests:
            req = requests[0]
            # Responses predating the oldest request are orphans (the auth
            # ack to the login packet, or responses whose request was lost).
            while responses and responses[0].timestamp_ns < req.timestamp_ns:
                responses.popleft()
            cmd = req.payload[0]
            # Commands with no response at all.
            if cmd in (COM_QUIT, COM_STMT_CLOSE):
                requests.popleft()
                records.append((req, cmd, RESP_NONE, "", req.timestamp_ns))
                continue
            # This command's response run = the MINIMAL response-packet
            # prefix that forms a complete response (OK/ERR/EOF or full
            # resultset).  Packet SHAPE, not timestamps, frames the run:
            # MySQL serializes responses per connection, so shape framing
            # stays correct when the client pipelines requests (responses
            # arriving after the next request's timestamp).
            run = []
            complete = False
            terminators = 0
            for p in responses:
                run.append(p)
                if len(run) == 1:
                    first = p.payload
                    if first[:1] in (b"\xff", b"\x00") or self._is_eof(first):
                        complete = True
                        break
                    continue
                # resultset: column-def EOF then row-section EOF/OK
                if self._is_eof(p.payload) or p.payload[:1] == b"\x00":
                    terminators += 1
                    if terminators >= 2:
                        complete = True
                        break
            if not complete:
                break  # wait for more response packets
            for _ in run:
                responses.popleft()
            requests.popleft()
            status, body = self._summarize_response(cmd, run)
            end_ts = run[-1].timestamp_ns if run else req.timestamp_ns
            records.append((req, cmd, status, body, end_ts))
        return records, errors

    def record_row(self, record):
        req, cmd, status, body, end_ts = record
        req_body = ""
        if cmd in _TEXT_COMMANDS:
            req_body = req.payload[1:].decode("latin1", "replace")
        return {
            "time_": req.timestamp_ns,
            "latency": max(end_ts - req.timestamp_ns, 0),
            "req_cmd": cmd,
            "req_body": req_body,
            "resp_status": status,
            "resp_body": body,
        }
