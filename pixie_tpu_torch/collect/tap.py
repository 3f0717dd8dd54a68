"""Live traffic tap: a TCP forward proxy that mirrors both directions of
every connection into a SocketTraceConnector event source.

Reference role: the kernel half of the socket tracer (bcc_bpf/socket_trace.c
kprobes on send/recv) captures traffic invisibly; without kernel eBPF the
userspace equivalent is an explicit tap in the traffic path. Point clients
at the tap port instead of the server and every byte is observed with
timestamps, exactly like the perf-buffer events the reference drains
(socket_trace_connector.cc TransferDataImpl).

Copied from the reference package (pixie_tpu/collect/tap.py).
"""
from __future__ import annotations

import socket
import threading
from typing import Optional

from pixie_tpu_torch.collect.core import now_ns
from pixie_tpu_torch.collect.tracer import QueueEventSource


class TapProxy:
    """Forwards 127.0.0.1:<listen_port> → <upstream>, emitting open/data/close
    events for each proxied connection."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 source: Optional[QueueEventSource] = None,
                 listen_host: str = "127.0.0.1", listen_port: int = 0,
                 protocol: Optional[str] = None, pid: int = 0):
        self.upstream = (upstream_host, upstream_port)
        self.source = source or QueueEventSource()
        self.protocol = protocol
        self.pid = pid
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((listen_host, listen_port))
        self._lsock.listen(16)
        self.port = self._lsock.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._socks: set[socket.socket] = set()
        self._next_conn = 0
        self._lock = threading.Lock()

    def _pid_start_ns(self) -> int:
        if self.pid <= 0:
            return 0
        if not hasattr(self, "_start_ns"):
            from pixie_tpu_torch.metadata.proc_scanner import pid_start_time_ns

            self._start_ns = pid_start_time_ns(self.pid)
        return self._start_ns

    def start(self) -> "TapProxy":
        t = threading.Thread(target=self._accept_loop, name="tap-accept",
                             daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def _accept_loop(self) -> None:
        self._lsock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                cli, addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                self._next_conn += 1
                cid = self._next_conn
            try:
                up = socket.create_connection(self.upstream, timeout=5.0)
            except OSError:
                cli.close()
                continue
            self.source.emit({
                "ev": "open", "conn": cid, "pid": self.pid,
                # real start time from /proc so the traffic's UPID matches
                # the ProcScanner-fed metadata state (ctx['pod'] joins on
                # the exact UInt128)
                "pid_start_ns": self._pid_start_ns(),
                "addr": addr[0], "port": self.upstream[1],
                # tap sits in front of the server: server-side semantics
                "role": 2, "protocol": self.protocol,
            })
            with self._lock:
                self._socks.update((cli, up))
                # prune finished pump threads so long-lived taps serving many
                # short connections don't accumulate dead Thread objects
                self._threads = [t for t in self._threads if t.is_alive()]
            for name, src, dst, direction in (
                    ("c2s", cli, up, "recv"),   # client→server = server recv
                    ("s2c", up, cli, "send")):  # server→client = server send
                t = threading.Thread(
                    target=self._pump, name=f"tap-{cid}-{name}",
                    args=(cid, src, dst, direction), daemon=True)
                t.start()
                self._threads.append(t)

    def _pump(self, cid: int, src: socket.socket, dst: socket.socket,
              direction: str) -> None:
        try:
            while not self._stop.is_set():
                try:
                    data = src.recv(65536)
                except OSError:
                    break
                if not data:
                    break
                self.source.emit({"ev": "data", "conn": cid,
                                  "dir": direction, "ts": now_ns(),
                                  "data": data})
                try:
                    dst.sendall(data)
                except OSError:
                    break
        finally:
            # Half-close propagation; the peer pump thread emits no
            # duplicate close (tracer treats repeats as idempotent).
            try:
                dst.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            if direction == "send":
                self.source.emit({"ev": "close", "conn": cid})
                with self._lock:
                    self._socks.discard(src)
                    self._socks.discard(dst)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._lsock.close()
        except OSError:
            pass
        # Shut down, then close, per-connection sockets so pump threads
        # blocked in recv() wake immediately: close() alone does not wake a
        # recv() in another thread, which then outlives stop() for as long as
        # its peer keeps the connection open.
        with self._lock:
            socks = list(self._socks)
            self._socks.clear()
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=1.0)
