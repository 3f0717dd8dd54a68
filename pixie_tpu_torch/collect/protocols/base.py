"""Core abstractions for protocol stream parsing.

Reference counterparts:
  * ParseState / message_type — src/stirling/utils/parse_state.h,
    socket_tracer/bcc_bpf_intf/common.h (message_type_t).
  * DataStream — socket_tracer/data_stream.h:50 (per-direction reassembly
    buffer that repeatedly parses frames and resyncs past garbage).
  * ConnTracker — socket_tracer/conn_tracker.h:87 (per-connection state:
    two DataStreams + stitching + conn stats).

Redesign notes: the reference parses into protocol-templated C++ deques and
transfers via per-protocol TransferSpecs; here frames are plain dataclasses
and stitched records are dict rows appended columnarly by the tracer
(collect/tracer.py), which matches this build's columnar ingest path.

Copied from the reference package (pixie_tpu/collect/protocols/base.py).
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Any, Deque, Optional


class MessageType(enum.Enum):
    REQUEST = "request"
    RESPONSE = "response"


class ParseState(enum.Enum):
    #: frame parsed; consume `consumed` bytes and keep the frame
    SUCCESS = "success"
    #: not enough bytes yet; stop parsing this stream until more data
    NEEDS_MORE_DATA = "needs_more_data"
    #: bytes are not a valid frame start; resync via find_frame_boundary
    INVALID = "invalid"
    #: valid frame but not interesting (e.g. handshake); consume and drop
    IGNORE = "ignore"


@dataclasses.dataclass
class Frame:
    """Base parsed frame; protocol modules subclass with their own fields."""

    timestamp_ns: int = 0


class ProtocolParser:
    """The per-protocol contract (reference protocols/common/interface.h).

    Stateless w.r.t. connections: any cross-frame state lives in the object
    returned by new_state(), owned by the ConnTracker (reference state_type
    with global/send/recv members).
    """

    #: registry key, e.g. "mysql"
    name: str = ""
    #: destination table in collect/schemas.py
    table: str = ""
    #: True for datagram protocols (each data event is one message — DNS)
    datagram: bool = False

    def new_state(self) -> Any:
        return None

    def find_frame_boundary(self, msg_type: MessageType, buf: bytes,
                            start: int, state: Any = None) -> int:
        """Position > 0 of a plausible frame start, or -1 if none found."""
        return -1

    def parse_frame(self, msg_type: MessageType, buf: bytes,
                    state: Any = None):
        """-> (ParseState, frame_or_None, consumed_bytes)."""
        raise NotImplementedError

    def stitch(self, requests: Deque[Frame], responses: Deque[Frame],
               state: Any = None):
        """Match frames into records -> (list_of_records, error_count).

        Must consume matched/abandoned frames from the deques; unmatched
        trailing frames stay for the next round (streaming semantics).
        """
        raise NotImplementedError

    def record_row(self, record: Any) -> dict:
        """One stitched record -> column dict for `self.table` (protocol
        columns only; the tracer adds time_/upid/remote_addr/... common
        columns)."""
        raise NotImplementedError


#: safety rails mirroring the reference's buffer/retention limits
MAX_BUFFER_BYTES = 1 << 20
MAX_PARSED_FRAMES = 4096


class DataStream:
    """One direction of one connection: reassembly buffer + parsed frames.

    Timestamps: each appended chunk carries its capture timestamp; a frame
    gets the timestamp of the chunk containing its first byte (reference
    DataStream attaches BPF event timestamps the same way).
    """

    def __init__(self, parser: ProtocolParser, msg_type: MessageType):
        self.parser = parser
        self.msg_type = msg_type
        self._buf = bytearray()
        #: (offset_in_buf, timestamp_ns) markers, ascending offsets
        self._ts_marks: Deque[tuple[int, int]] = deque()
        self.frames: Deque[Frame] = deque()
        self.bytes_seen = 0
        self.invalid_frames = 0
        self.truncated_bytes = 0

    def add_data(self, data: bytes, timestamp_ns: int) -> None:
        if not data:
            return
        if not self._buf:
            # A mark describes bytes still buffered: once every byte was
            # consumed, the next frame starts in this chunk.  (The reference
            # keeps the last chunk's mark at offset 0 here, so each frame
            # after a drained buffer took the previous chunk's time.)
            self._ts_marks.clear()
        self._ts_marks.append((len(self._buf), timestamp_ns))
        self._buf += data
        self.bytes_seen += len(data)
        if len(self._buf) > MAX_BUFFER_BYTES:
            # Drop the oldest bytes (reference: retention-capped stream).
            drop = len(self._buf) - MAX_BUFFER_BYTES
            self._advance(drop)
            self.truncated_bytes += drop

    def _ts_at_head(self) -> int:
        return self._ts_marks[0][1] if self._ts_marks else 0

    def _advance(self, n: int) -> None:
        del self._buf[:n]
        marks = self._ts_marks
        while len(marks) > 1 and marks[1][0] <= n:
            marks.popleft()
        self._ts_marks = deque((max(off - n, 0), ts) for off, ts in marks)

    def process(self, state: Any = None) -> None:
        """Parse as many frames as possible off the buffer."""
        parser = self.parser
        while self._buf and len(self.frames) < MAX_PARSED_FRAMES:
            view = bytes(self._buf)
            st, frame, consumed = parser.parse_frame(self.msg_type, view, state)
            if st is ParseState.NEEDS_MORE_DATA:
                break
            if st in (ParseState.SUCCESS, ParseState.IGNORE):
                if consumed <= 0:  # defensive: a parser bug must not loop
                    break
                if st is ParseState.SUCCESS and frame is not None:
                    if frame.timestamp_ns == 0:
                        frame.timestamp_ns = self._ts_at_head()
                    self.frames.append(frame)
                self._advance(consumed)
                continue
            # INVALID: skip to the next plausible boundary.
            self.invalid_frames += 1
            pos = parser.find_frame_boundary(self.msg_type, view, 1, state)
            if pos <= 0:
                self._advance(len(self._buf))
            else:
                self._advance(pos)


class ConnTracker:
    """Per-connection state machine (reference conn_tracker.h:87).

    role: 1 = client-side capture (send = requests), 2 = server-side capture
    (recv = requests) — reference endpoint_role_t kRoleClient/kRoleServer.
    """

    ROLE_CLIENT = 1
    ROLE_SERVER = 2

    def __init__(self, parser: ProtocolParser, role: int = ROLE_SERVER,
                 upid=None, remote_addr: str = "", remote_port: int = 0):
        self.parser = parser
        self.role = role
        self.upid = upid
        self.remote_addr = remote_addr
        self.remote_port = remote_port
        self.state = parser.new_state()
        req_dir = MessageType.REQUEST
        resp_dir = MessageType.RESPONSE
        if role == self.ROLE_CLIENT:
            self.send = DataStream(parser, req_dir)
            self.recv = DataStream(parser, resp_dir)
        else:
            self.send = DataStream(parser, resp_dir)
            self.recv = DataStream(parser, req_dir)
        self.records_emitted = 0
        self.stitch_errors = 0
        self.closed = False

    @property
    def req_stream(self) -> DataStream:
        return self.send if self.role == self.ROLE_CLIENT else self.recv

    @property
    def resp_stream(self) -> DataStream:
        return self.recv if self.role == self.ROLE_CLIENT else self.send

    def add_data(self, direction: str, data: bytes, timestamp_ns: int) -> None:
        stream = self.send if direction == "send" else self.recv
        stream.add_data(data, timestamp_ns)

    #: unmatched frames kept after a stitch round; beyond this the oldest are
    #: expired (a lost peer event must not wedge the connection at
    #: MAX_PARSED_FRAMES and halt parsing forever)
    MAX_PENDING_FRAMES = 1024

    def process(self) -> list:
        """Parse both streams and stitch -> list of (record, row_dict)."""
        self.req_stream.process(self.state)
        self.resp_stream.process(self.state)
        records, errors = self.parser.stitch(
            self.req_stream.frames, self.resp_stream.frames, self.state
        )
        for frames in (self.req_stream.frames, self.resp_stream.frames):
            while len(frames) > self.MAX_PENDING_FRAMES:
                frames.popleft()
                errors += 1
        self.stitch_errors += errors
        self.records_emitted += len(records)
        return records
