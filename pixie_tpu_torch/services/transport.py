"""Length-prefixed framed messaging over TCP sockets.

The reference runs a dual fabric — NATS for control, gRPC streaming for data
(SURVEY.md §5).  Here both ride one framed-TCP transport: each message is
`u32 length | wire frame` (services.wire), and a lightweight envelope in the
frame's JSON meta carries routing (`msg`, `req_id`).  Connections are
full-duplex: either side sends at any time; a reader thread per connection
dispatches by handler.

Copied from the reference package (pixie_tpu/services/transport.py). `Server.stop` also waits for
the connections' reader threads, so no frame handler outlives it.
"""
from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Callable, Optional

from pixie_tpu_torch.services import faultinject
from pixie_tpu_torch.status import Internal

_LEN = struct.Struct("<I")
MAX_FRAME = 1 << 30


def send_frame(sock: socket.socket, frame: bytes) -> None:
    if len(frame) > MAX_FRAME:
        raise Internal(f"frame too large ({len(frame)} bytes)")
    sock.sendall(_LEN.pack(len(frame)) + frame)


def recv_frame(sock: socket.socket) -> Optional[bytes]:
    """One frame, or None on clean EOF."""
    hdr = _recv_exact(sock, _LEN.size)
    if hdr is None:
        return None
    (n,) = _LEN.unpack(hdr)
    if n > MAX_FRAME:
        raise Internal(f"peer announced oversized frame ({n} bytes)")
    body = _recv_exact(sock, n)
    if body is None:
        return None
    return body


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    got = 0
    while got < n:
        try:
            b = sock.recv(min(n - got, 1 << 20))
        except (ConnectionResetError, OSError):
            return None
        if not b:
            return None
        chunks.append(b)
        got += len(b)
    return b"".join(chunks)


class Connection:
    """One framed full-duplex connection with a background reader thread."""

    def __init__(self, sock: socket.socket, on_frame: Callable[["Connection", bytes], None],
                 on_close: Optional[Callable[["Connection"], None]] = None,
                 name: str = "?"):
        self.sock = sock
        self.name = name
        #: fault-injection target key (services/faultinject.py): endpoints
        #: that want to be addressable by a chaos plan set a logical label
        #: (agents: "agent:<name>", clients: "client"); defaults to the
        #: peer-addr name so unlabeled conns still match wildcard rules
        self.label = name
        self._on_frame = on_frame
        self._on_close = on_close
        self._wlock = threading.Lock()
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._read_loop, name=f"pixie-conn-{name}", daemon=True
        )
        #: arbitrary per-connection state for the owning service
        self.state: dict = {}

    def start(self):
        self._thread.start()

    def _apply_fault(self, direction: str) -> str:
        """Consult the installed fault injector (if any) for one frame.
        Returns "proceed", "drop" (swallow the frame), or "closed" (the
        injector killed this connection)."""
        inj = faultinject.active()
        if inj is None:
            return "proceed"
        d = inj.on_frame(id(self), self.label, direction)
        if d is None:
            return "proceed"
        if d.action == "delay":
            time.sleep(d.delay_s)
            return "proceed"
        if d.action == "drop":
            return "drop"
        if d.action == "reset":
            self.abort()
            return "closed"
        if d.action == "kill":
            # true pod loss: the label's registered handler drops the
            # owner's in-memory state FIRST, then the socket RSTs — the
            # peer observes exactly what a reaped pod leaves behind
            faultinject.fire_kill(self.label)
            self.abort()
            return "closed"
        self.close()  # crash: the peer sees a dead socket mid-stream
        return "closed"

    def abort(self) -> None:
        """Close with SO_LINGER 0 — the peer gets an RST, not a clean FIN
        (the injected-fault analog of a kernel reaping a crashed process)."""
        try:
            self.sock.setsockopt(
                socket.SOL_SOCKET, socket.SO_LINGER,
                struct.pack("ii", 1, 0))
        except OSError:
            pass
        self.close()

    def _read_loop(self):
        from pixie_tpu_torch import metrics as _metrics

        while True:
            frame = recv_frame(self.sock)
            if frame is None:
                break
            fate = self._apply_fault("recv")
            if fate == "drop":
                continue
            if fate == "closed":
                break
            _metrics.counter_inc(
                "px_transport_frames_received_total",
                help_="frames received over framed-TCP connections")
            _metrics.counter_inc(
                "px_transport_bytes_received_total", float(len(frame)),
                help_="frame bytes received over framed-TCP connections")
            try:
                self._on_frame(self, frame)
            except Exception:
                # handler bugs must not kill the connection reader
                import traceback

                traceback.print_exc()
        self.close()

    def send(self, frame: bytes) -> bool:
        from pixie_tpu_torch import metrics as _metrics

        fate = self._apply_fault("send")
        if fate == "drop":
            # the frame vanishes but the caller sees success — exactly what
            # a crashed peer's kernel buffer does to an un-acked write
            return True
        if fate == "closed":
            return False
        with self._wlock:
            try:
                send_frame(self.sock, frame)
            except OSError:
                return False
        _metrics.counter_inc(
            "px_transport_frames_sent_total",
            help_="frames sent over framed-TCP connections")
        _metrics.counter_inc(
            "px_transport_bytes_sent_total", float(len(frame)),
            help_="frame bytes sent over framed-TCP connections")
        return True

    def close(self):
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if self._on_close is not None:
            cb, self._on_close = self._on_close, None
            cb(self)

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait for the reader thread to end (never from that thread)."""
        if self._thread.is_alive() and self._thread is not threading.current_thread():
            self._thread.join(timeout)


class Server:
    """Accept-loop TCP server handing Connections to a handler factory."""

    def __init__(self, host: str, port: int,
                 on_frame: Callable[[Connection, bytes], None],
                 on_close: Optional[Callable[[Connection], None]] = None):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._on_frame = on_frame
        self._on_close = on_close
        self._stop = threading.Event()
        self._conns: list[Connection] = []
        self._thread = threading.Thread(
            target=self._accept_loop, name="pixie-server", daemon=True
        )

    def start(self) -> "Server":
        self._thread.start()
        return self

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return
            if self._stop.is_set():
                # a dial that completed in the backlog as stop() ran: close
                # it instead of servicing it — a STOPPED server answering
                # (e.g. "no live agents") wedges clients that would
                # otherwise redial the restarted instance on this port
                try:
                    sock.close()
                except OSError:
                    pass
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

            def on_close(c, _user=self._on_close):
                try:
                    self._conns.remove(c)
                except ValueError:
                    pass
                if _user is not None:
                    _user(c)

            conn = Connection(
                sock, self._on_frame, on_close, name=f"{addr[0]}:{addr[1]}"
            )
            self._conns.append(conn)
            conn.start()

    def stop(self):
        """Stop accepting, close every connection and wait (up to 5 s each)
        for their reader threads: no frame handler runs once this returns
        (so the owner may close what the handlers write, its KV)."""
        timeout = 5.0
        self._stop.set()
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread.is_alive() and self._thread is not threading.current_thread():
            self._thread.join(timeout)
        conns = list(self._conns)
        for c in conns:
            c.close()
        for c in conns:
            c.join(timeout)


def dial(host: str, port: int,
         on_frame: Callable[[Connection, bytes], None],
         on_close: Optional[Callable[[Connection], None]] = None,
         timeout: float = 10.0) -> Connection:
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    conn = Connection(sock, on_frame, on_close, name=f"{host}:{port}")
    conn.start()
    return conn
