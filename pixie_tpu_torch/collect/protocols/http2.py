"""HTTP/2 + gRPC wire parser: frame state machine, HPACK (static + dynamic
table, Huffman), gRPC message framing, stream multiplexing.

Reference counterparts: socket_tracer/protocols/http2/ (stitcher.cc matches
req/resp by stream id; grpc.cc decodes gRPC framing; http2_streams_container
accumulates per-stream header/data events).  The reference collects HTTP/2
headers ALREADY-DECODED via Go-runtime uprobes (bcc_bpf/go_http2_trace.c) and
so never touches HPACK; this build captures raw bytes (tap/replay), so the
full RFC 7540 frame layer and RFC 7541 HPACK decoder live here.

Wire facts implemented (all standard):
  * RFC 7540 §4.1 frame header: [length:24][type:8][flags:8][R+stream:32].
  * Connection preface "PRI * HTTP/2.0\\r\\n\\r\\nSM\\r\\n\\r\\n" (client side).
  * HEADERS/CONTINUATION header-block assembly with END_HEADERS; PADDED and
    PRIORITY field stripping; DATA with padding; RST_STREAM; trailers.
  * RFC 7541 HPACK: indexed (§6.1), literal with/without incremental indexing
    (§6.2), dynamic-table size update (§6.3), static table (Appendix A),
    integer prefix coding (§5.1), Huffman-coded strings (§5.2, Appendix B —
    the printable-ASCII code set; a code outside it marks the string
    undecodable instead of desyncing).
  * gRPC: length-prefixed messages [compressed:1][len:4] (PROTOCOL-HTTP2.md),
    grpc-status from trailers, content-type application/grpc detection.

Copied from the reference package (pixie_tpu/collect/protocols/http2.py).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

from pixie_tpu_torch.collect.protocols.base import (
    Frame,
    MessageType,
    ParseState,
    ProtocolParser,
)

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types (RFC 7540 §6)
DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

# flags
F_END_STREAM = 0x1
F_END_HEADERS = 0x4
F_PADDED = 0x8
F_PRIORITY = 0x20

#: max frame length we accept (default SETTINGS_MAX_FRAME_SIZE is 16384; a
#: peer may raise it to 2^24-1 — cap at 1 MiB as a plausibility rail)
MAX_FRAME_LEN = 1 << 20

# ------------------------------------------------------------------- HPACK

#: RFC 7541 Appendix A static table (index 1..61)
STATIC_TABLE = [
    (":authority", ""),
    (":method", "GET"),
    (":method", "POST"),
    (":path", "/"),
    (":path", "/index.html"),
    (":scheme", "http"),
    (":scheme", "https"),
    (":status", "200"),
    (":status", "204"),
    (":status", "206"),
    (":status", "304"),
    (":status", "400"),
    (":status", "404"),
    (":status", "500"),
    ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"),
    ("accept-language", ""),
    ("accept-ranges", ""),
    ("accept", ""),
    ("access-control-allow-origin", ""),
    ("age", ""),
    ("allow", ""),
    ("authorization", ""),
    ("cache-control", ""),
    ("content-disposition", ""),
    ("content-encoding", ""),
    ("content-language", ""),
    ("content-length", ""),
    ("content-location", ""),
    ("content-range", ""),
    ("content-type", ""),
    ("cookie", ""),
    ("date", ""),
    ("etag", ""),
    ("expect", ""),
    ("expires", ""),
    ("from", ""),
    ("host", ""),
    ("if-match", ""),
    ("if-modified-since", ""),
    ("if-none-match", ""),
    ("if-range", ""),
    ("if-unmodified-since", ""),
    ("last-modified", ""),
    ("link", ""),
    ("location", ""),
    ("max-forwards", ""),
    ("proxy-authenticate", ""),
    ("proxy-authorization", ""),
    ("range", ""),
    ("referer", ""),
    ("refresh", ""),
    ("retry-after", ""),
    ("server", ""),
    ("set-cookie", ""),
    ("strict-transport-security", ""),
    ("transfer-encoding", ""),
    ("user-agent", ""),
    ("vary", ""),
    ("via", ""),
    ("www-authenticate", ""),
]

#: RFC 7541 Appendix B Huffman codes for the printable-ASCII symbols (32-126)
#: — the complete code space reachable by header NAMES and textual VALUES.
#: Control/obs-text symbols (rare; gRPC base64s binary metadata) are omitted:
#: hitting one of their (all-ones-prefixed) codes flags the string
#: undecodable rather than emitting garbage.
_HUFF_PRINTABLE = {
    ord(" "): (0x14, 6), ord("!"): (0x3F8, 10), ord('"'): (0x3F9, 10),
    ord("#"): (0xFFA, 12), ord("$"): (0x1FF9, 13), ord("%"): (0x15, 6),
    ord("&"): (0xF8, 8), ord("'"): (0x7FA, 11), ord("("): (0x3FA, 10),
    ord(")"): (0x3FB, 10), ord("*"): (0xF9, 8), ord("+"): (0x7FB, 11),
    ord(","): (0xFA, 8), ord("-"): (0x16, 6), ord("."): (0x17, 6),
    ord("/"): (0x18, 6), ord("0"): (0x0, 5), ord("1"): (0x1, 5),
    ord("2"): (0x2, 5), ord("3"): (0x19, 6), ord("4"): (0x1A, 6),
    ord("5"): (0x1B, 6), ord("6"): (0x1C, 6), ord("7"): (0x1D, 6),
    ord("8"): (0x1E, 6), ord("9"): (0x1F, 6), ord(":"): (0x5C, 7),
    ord(";"): (0xFB, 8), ord("<"): (0x7FFC, 15), ord("="): (0x20, 6),
    ord(">"): (0xFFB, 12), ord("?"): (0x3FC, 10), ord("@"): (0x3FFA, 14),
    ord("A"): (0x21, 6), ord("B"): (0x5D, 7), ord("C"): (0x5E, 7),
    ord("D"): (0x5F, 7), ord("E"): (0x60, 7), ord("F"): (0x61, 7),
    ord("G"): (0x62, 7), ord("H"): (0x63, 7), ord("I"): (0x64, 7),
    ord("J"): (0x65, 7), ord("K"): (0x66, 7), ord("L"): (0x67, 7),
    ord("M"): (0x68, 7), ord("N"): (0x69, 7), ord("O"): (0x6A, 7),
    ord("P"): (0x6B, 7), ord("Q"): (0x6C, 7), ord("R"): (0x6D, 7),
    ord("S"): (0x6E, 7), ord("T"): (0x6F, 7), ord("U"): (0x70, 7),
    ord("V"): (0x71, 7), ord("W"): (0x72, 7), ord("X"): (0xFC, 8),
    ord("Y"): (0x73, 7), ord("Z"): (0xFD, 8), ord("["): (0x1FFB, 13),
    ord("\\"): (0x7FFF0, 19), ord("]"): (0x1FFC, 13), ord("^"): (0x3FFC, 14),
    ord("_"): (0x22, 6), ord("`"): (0x7FFD, 15), ord("a"): (0x3, 5),
    ord("b"): (0x23, 6), ord("c"): (0x4, 5), ord("d"): (0x24, 6),
    ord("e"): (0x5, 5), ord("f"): (0x25, 6), ord("g"): (0x26, 6),
    ord("h"): (0x27, 6), ord("i"): (0x6, 5), ord("j"): (0x74, 7),
    ord("k"): (0x75, 7), ord("l"): (0x28, 6), ord("m"): (0x29, 6),
    ord("n"): (0x2A, 6), ord("o"): (0x7, 5), ord("p"): (0x2B, 6),
    ord("q"): (0x76, 7), ord("r"): (0x2C, 6), ord("s"): (0x8, 5),
    ord("t"): (0x9, 5), ord("u"): (0x2D, 6), ord("v"): (0x77, 7),
    ord("w"): (0x78, 7), ord("x"): (0x79, 7), ord("y"): (0x7A, 7),
    ord("z"): (0x7B, 7), ord("{"): (0x7FFE, 15), ord("|"): (0x7FC, 11),
    ord("}"): (0x3FFD, 14), ord("~"): (0x1FFD, 13),
}


def _build_huff_decode() -> dict:
    """(code, nbits) → symbol decode map."""
    out = {}
    for sym, (code, nbits) in _HUFF_PRINTABLE.items():
        out[(code, nbits)] = sym
    return out


_HUFF_DECODE = _build_huff_decode()
_HUFF_MAX_BITS = 19


def huffman_decode(data: bytes) -> Optional[str]:
    """RFC 7541 §5.2 decode; None when a code outside the printable set (or
    a non-EOS-padded tail) appears."""
    out = []
    code = 0
    nbits = 0
    for byte in data:
        for bit in range(7, -1, -1):
            code = (code << 1) | ((byte >> bit) & 1)
            nbits += 1
            sym = _HUFF_DECODE.get((code, nbits))
            if sym is not None:
                out.append(sym)
                code = 0
                nbits = 0
            elif nbits > _HUFF_MAX_BITS:
                return None
    # padding must be the EOS prefix: all ones, < 8 bits
    if nbits >= 8 or code != (1 << nbits) - 1:
        return None
    return "".join(chr(c) for c in out)


def huffman_encode(s: str) -> bytes:
    """Encoder twin (tests + tap fixtures)."""
    acc = 0
    nbits = 0
    for ch in s:
        code, n = _HUFF_PRINTABLE[ord(ch)]
        acc = (acc << n) | code
        nbits += n
    # pad with EOS prefix (all ones) to a byte boundary
    pad = (-nbits) % 8
    acc = (acc << pad) | ((1 << pad) - 1)
    nbits += pad
    return acc.to_bytes(nbits // 8, "big") if nbits else b""


class HpackDecoder:
    """RFC 7541 decoder with a bounded dynamic table."""

    def __init__(self, max_size: int = 4096):
        self.dynamic: list[tuple[str, str]] = []  # newest first
        self.max_size = max_size
        self.size = 0

    @staticmethod
    def _entry_size(name: str, value: str) -> int:
        return len(name) + len(value) + 32  # §4.1

    def _evict(self) -> None:
        while self.size > self.max_size and self.dynamic:
            n, v = self.dynamic.pop()
            self.size -= self._entry_size(n, v)

    def _add(self, name: str, value: str) -> None:
        self.dynamic.insert(0, (name, value))
        self.size += self._entry_size(name, value)
        self._evict()

    def _lookup(self, idx: int) -> tuple[str, str]:
        if 1 <= idx <= len(STATIC_TABLE):
            return STATIC_TABLE[idx - 1]
        didx = idx - len(STATIC_TABLE) - 1
        if 0 <= didx < len(self.dynamic):
            return self.dynamic[didx]
        raise ValueError(f"HPACK index {idx} out of range")

    @staticmethod
    def _read_int(data, pos: int, prefix_bits: int) -> tuple[int, int]:
        """§5.1 integer: returns (value, new_pos)."""
        mask = (1 << prefix_bits) - 1
        v = data[pos] & mask
        pos += 1
        if v < mask:
            return v, pos
        shift = 0
        while True:
            if pos >= len(data):
                raise ValueError("truncated HPACK integer")
            b = data[pos]
            pos += 1
            v += (b & 0x7F) << shift
            shift += 7
            if not (b & 0x80):
                return v, pos

    def _read_string(self, data, pos: int) -> tuple[str, int]:
        if pos >= len(data):
            raise ValueError("truncated HPACK string")
        huff = bool(data[pos] & 0x80)
        ln, pos = self._read_int(data, pos, 7)
        if pos + ln > len(data):
            raise ValueError("truncated HPACK string body")
        raw = bytes(data[pos: pos + ln])
        pos += ln
        if huff:
            s = huffman_decode(raw)
            if s is None:
                s = "<huffman:" + raw.hex() + ">"
            return s, pos
        return raw.decode("latin-1"), pos

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        """Header block fragment → [(name, value)].  MUST be called exactly
        once per block in connection order (the dynamic table is stateful)."""
        out = []
        pos = 0
        data = memoryview(block)
        while pos < len(data):
            b = data[pos]
            if b & 0x80:  # §6.1 indexed
                idx, pos = self._read_int(data, pos, 7)
                if idx == 0:
                    raise ValueError("HPACK indexed field with index 0")
                out.append(self._lookup(idx))
            elif b & 0x40:  # §6.2.1 literal with incremental indexing
                idx, pos = self._read_int(data, pos, 6)
                name = (self._lookup(idx)[0] if idx
                        else None)
                if name is None:
                    name, pos = self._read_string(data, pos)
                value, pos = self._read_string(data, pos)
                self._add(name, value)
                out.append((name, value))
            elif b & 0x20:  # §6.3 dynamic table size update
                sz, pos = self._read_int(data, pos, 5)
                # Clamp: a corrupt/adversarial stream could raise max_size
                # to 2^32 and grow the table unboundedly in a passive
                # observer; rail it like MAX_FRAME_LEN rails frame lengths.
                self.max_size = min(sz, 64 * 1024)
                self._evict()
            else:  # §6.2.2/§6.2.3 literal without indexing / never indexed
                idx, pos = self._read_int(data, pos, 4)
                name = self._lookup(idx)[0] if idx else None
                if name is None:
                    name, pos = self._read_string(data, pos)
                value, pos = self._read_string(data, pos)
                out.append((name, value))
        return out


# ------------------------------------------------------------ frame objects


@dataclasses.dataclass
class H2Frame(Frame):
    type: int = 0
    flags: int = 0
    stream_id: int = 0
    #: decoded headers for HEADERS (+ absorbed CONTINUATIONs); None otherwise
    headers: Optional[list] = None
    #: DATA payload (padding stripped); None otherwise
    data: Optional[bytes] = None


@dataclasses.dataclass
class _StreamHalf:
    headers: dict = dataclasses.field(default_factory=dict)
    trailers: dict = dataclasses.field(default_factory=dict)
    data: bytearray = dataclasses.field(default_factory=bytearray)
    saw_headers: bool = False
    ended: bool = False
    t_first: int = 0
    t_last: int = 0


@dataclasses.dataclass
class _Stream:
    req: _StreamHalf = dataclasses.field(default_factory=_StreamHalf)
    resp: _StreamHalf = dataclasses.field(default_factory=_StreamHalf)
    reset: bool = False


class _ConnState:
    """Shared connection state: per-direction HPACK decoders + pending
    header-block assembly + the stream map."""

    def __init__(self):
        self.hpack = {MessageType.REQUEST: HpackDecoder(),
                      MessageType.RESPONSE: HpackDecoder()}
        #: per-direction in-flight header block (HEADERS without END_HEADERS)
        self.pending_block: dict = {MessageType.REQUEST: None,
                                    MessageType.RESPONSE: None}
        self.preface_seen = False
        self.streams: dict[int, _Stream] = {}
        self.hpack_errors = 0

    def stream(self, sid: int) -> _Stream:
        st = self.streams.get(sid)
        if st is None:
            st = self.streams[sid] = _Stream()
        return st


#: drop streams beyond this many concurrently tracked (lost-END safety rail,
#: mirrors ConnTracker.MAX_PENDING_FRAMES)
MAX_TRACKED_STREAMS = 512


class HTTP2Parser(ProtocolParser):
    """RFC 7540 frame parser + stream stitcher producing http_events rows
    (major_version=2; gRPC fields filled when content-type is grpc)."""

    name = "http2"
    table = "http_events"

    def new_state(self):
        return _ConnState()

    # ------------------------------------------------------------- parsing
    def find_frame_boundary(self, msg_type, buf, start, state=None):
        # resync on a plausible frame header: known type, sane length.
        # A header needs bytes pos..pos+8, so the last scannable position is
        # len(buf) - 9 inclusive.
        for pos in range(start, len(buf) - 8):
            ln = int.from_bytes(buf[pos:pos + 3], "big")
            ftype = buf[pos + 3]
            if ftype <= CONTINUATION and ln <= MAX_FRAME_LEN:
                return pos
        return -1

    def parse_frame(self, msg_type, buf, state=None):
        if state is None:
            state = _ConnState()
        b = bytes(buf[:24])
        if msg_type is MessageType.REQUEST and not state.preface_seen:
            if PREFACE.startswith(b[: len(PREFACE)]) or b[:3] == b"PRI":
                if len(buf) < len(PREFACE):
                    return ParseState.NEEDS_MORE_DATA, None, 0
                if bytes(buf[: len(PREFACE)]) == PREFACE:
                    state.preface_seen = True
                    return ParseState.IGNORE, None, len(PREFACE)
        if len(buf) < 9:
            return ParseState.NEEDS_MORE_DATA, None, 0
        ln = int.from_bytes(buf[0:3], "big")
        ftype = buf[3]
        flags = buf[4]
        sid = int.from_bytes(buf[5:9], "big") & 0x7FFFFFFF
        if ftype > CONTINUATION or ln > MAX_FRAME_LEN:
            return ParseState.INVALID, None, 0
        if len(buf) < 9 + ln:
            return ParseState.NEEDS_MORE_DATA, None, 0
        payload = bytes(buf[9: 9 + ln])
        consumed = 9 + ln

        if ftype in (SETTINGS, PING, GOAWAY, WINDOW_UPDATE, PRIORITY,
                     PUSH_PROMISE):
            return ParseState.IGNORE, None, consumed

        if ftype == DATA:
            pad = payload[0] if (flags & F_PADDED) and payload else 0
            body = payload[1: len(payload) - pad] if (flags & F_PADDED) \
                else payload
            return ParseState.SUCCESS, H2Frame(
                type=DATA, flags=flags, stream_id=sid, data=body), consumed

        if ftype == RST_STREAM:
            return ParseState.SUCCESS, H2Frame(
                type=RST_STREAM, flags=flags, stream_id=sid), consumed

        if ftype == HEADERS:
            frag = payload
            if flags & F_PADDED:
                pad = frag[0] if frag else 0
                frag = frag[1: len(frag) - pad]
            if flags & F_PRIORITY:
                frag = frag[5:]
            if not (flags & F_END_HEADERS):
                state.pending_block[msg_type] = (sid, flags, bytearray(frag))
                return ParseState.IGNORE, None, consumed
            return self._emit_headers(state, msg_type, sid, flags, frag,
                                      consumed)

        if ftype == CONTINUATION:
            pend = state.pending_block[msg_type]
            if pend is None or pend[0] != sid:
                return ParseState.IGNORE, None, consumed
            pend[2].extend(payload)
            if not (flags & F_END_HEADERS):
                return ParseState.IGNORE, None, consumed
            state.pending_block[msg_type] = None
            return self._emit_headers(state, msg_type, sid, pend[1],
                                      bytes(pend[2]), consumed)

        return ParseState.IGNORE, None, consumed

    def _emit_headers(self, state, msg_type, sid, flags, frag, consumed):
        try:
            hdrs = state.hpack[msg_type].decode(bytes(frag))
        except ValueError:
            state.hpack_errors += 1
            return ParseState.IGNORE, None, consumed
        return ParseState.SUCCESS, H2Frame(
            type=HEADERS, flags=flags, stream_id=sid, headers=hdrs), consumed

    # ----------------------------------------------------------- stitching
    def stitch(self, requests, responses, state=None):
        if state is None:
            state = _ConnState()
        for deque_, half_name in ((requests, "req"), (responses, "resp")):
            while deque_:
                fr = deque_.popleft()
                st = state.stream(fr.stream_id)
                half = getattr(st, half_name)
                if half.t_first == 0:
                    half.t_first = fr.timestamp_ns
                half.t_last = max(half.t_last, fr.timestamp_ns)
                if fr.type == RST_STREAM:
                    st.reset = True
                    st.req.ended = st.resp.ended = True
                elif fr.type == HEADERS:
                    hd = dict(fr.headers)
                    if half.saw_headers:
                        half.trailers.update(hd)  # trailers (gRPC status)
                    else:
                        half.headers = hd
                        half.saw_headers = True
                    if fr.flags & F_END_STREAM:
                        half.ended = True
                elif fr.type == DATA:
                    half.data.extend(fr.data or b"")
                    if fr.flags & F_END_STREAM:
                        half.ended = True
        records = []
        errors = state.hpack_errors
        state.hpack_errors = 0
        done = [sid for sid, st in state.streams.items()
                if (st.req.ended and st.resp.ended)
                or (st.reset and st.req.saw_headers)]
        for sid in done:
            st = state.streams.pop(sid)
            if st.req.saw_headers or st.resp.saw_headers:
                records.append((sid, st))
            else:
                errors += 1
        # lost-END safety: evict oldest half-open streams beyond the rail
        if len(state.streams) > MAX_TRACKED_STREAMS:
            for sid in sorted(state.streams)[:-MAX_TRACKED_STREAMS]:
                del state.streams[sid]
                errors += 1
        return records, errors

    # ------------------------------------------------------------- records
    @staticmethod
    def _grpc_messages(data: bytes) -> list[bytes]:
        """Split gRPC length-prefixed messages (PROTOCOL-HTTP2.md framing)."""
        out = []
        pos = 0
        while pos + 5 <= len(data):
            ln = int.from_bytes(data[pos + 1: pos + 5], "big")
            if pos + 5 + ln > len(data):
                break
            out.append(data[pos + 5: pos + 5 + ln])
            pos += 5 + ln
        return out

    def record_row(self, record):
        sid, st = record
        req_h = dict(st.req.headers)
        resp_h = dict(st.resp.headers)
        resp_h.update({k: v for k, v in st.resp.trailers.items()})
        is_grpc = "grpc" in req_h.get("content-type", "")
        req_body = bytes(st.req.data)
        resp_body = bytes(st.resp.data)
        if is_grpc:
            req_msgs = self._grpc_messages(req_body)
            resp_msgs = self._grpc_messages(resp_body)
            req_body = b"".join(req_msgs) or req_body
            resp_body = b"".join(resp_msgs) or resp_body
        try:
            status = int(resp_h.get(":status", "0"))
        except ValueError:
            status = 0
        t_req = st.req.t_first or st.resp.t_first
        t_resp = st.resp.t_last or st.req.t_last
        return {
            "time_": t_resp,
            "latency": max(t_resp - t_req, 0),
            "major_version": 2,
            "minor_version": 0,
            "content_type": 2 if is_grpc else 0,
            "req_headers": json.dumps(req_h, sort_keys=True),
            "req_method": req_h.get(":method", ""),
            "req_path": req_h.get(":path", ""),
            "req_body": req_body.decode("latin-1"),
            "req_body_size": len(st.req.data),
            "resp_headers": json.dumps(resp_h, sort_keys=True),
            "resp_status": status,
            "resp_message": ("grpc-status: " + resp_h["grpc-status"]
                             if "grpc-status" in resp_h else ""),
            "resp_body": resp_body.decode("latin-1"),
            "resp_body_size": len(st.resp.data),
        }
