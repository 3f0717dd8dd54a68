"""Healthz endpoint for services (broker/agent).

Reference: src/shared/services/ — every Go service exposes an HTTP
`/healthz` (and `/metrics`) used by k8s liveness/readiness probes.  The
framed-TCP data port stays auth-gated; health lives on its own HTTP
listener so probes need no protocol client or credentials.

GET /healthz  → 200 `{"ok": true, "checks": {...}}` when every registered
check passes, else 503 with the failing checks' errors (liveness).
GET /readyz   → same over checks + ready_checks (readiness — e.g. leader
election or serving-front overload: a healthy standby / a broker past its
queue-depth watermark is alive but must not receive traffic).
GET /metrics  → the Prometheus-style text rendering of pixie_tpu_torch.metrics.

The liveness/readiness split matters operationally: a k8s liveness probe
restarts a failing pod, a readiness probe only pulls it from the service
endpoints — an overloaded broker that fails BOTH gets restarted in a loop
and sheds its queues, so overload may only ever flip /readyz.

Copied from the reference package (pixie_tpu/services/health.py).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional


class HealthzServer:
    """checks: name -> callable returning truthy (healthy) or raising."""

    def __init__(self, checks: Optional[dict[str, Callable]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 ready_checks: Optional[dict[str, Callable]] = None,
                 detail: Optional[dict[str, Callable]] = None):
        self.checks: dict[str, Callable] = dict(checks or {})
        #: extra checks for /readyz only (e.g. leadership): failing them
        #: means "alive but not serving", which must NOT fail liveness
        self.ready_checks: dict[str, Callable] = dict(ready_checks or {})
        #: informational payloads (name -> callable returning a JSON-able
        #: value) merged into the /healthz body under "detail" — never
        #: affect the verdict (journal disk usage, queue depths, ...)
        self.detail: dict[str, Callable] = dict(detail or {})
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/healthz", "/readyz"):
                    ok, results = outer.run_checks(
                        ready=self.path == "/readyz")
                    doc = {"ok": ok, "checks": results}
                    det = outer.run_detail()
                    if det:
                        doc["detail"] = det
                    body = json.dumps(doc).encode()
                    return self._send(200 if ok else 503, body,
                                      "application/json")
                if self.path == "/metrics":
                    from pixie_tpu_torch import metrics as _metrics

                    return self._send(200, _metrics.render().encode(),
                                      "text/plain; version=0.0.4")
                return self._send(404, b"not found", "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None

    def run_detail(self) -> dict:
        """Evaluate the informational payloads; a failing provider reports
        its error in place rather than failing the probe."""
        out = {}
        for name, fn in self.detail.items():
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = f"error: {e}"
        return out

    def add_ready_check(self, name: str, fn: Callable) -> None:
        """Register a READINESS-ONLY check: failing it flips /readyz while
        /healthz stays green (overload, leadership, warmup...)."""
        self.ready_checks[name] = fn

    def run_checks(self, ready: bool = False) -> tuple[bool, dict]:
        checks = dict(self.checks)
        if ready:
            checks.update(self.ready_checks)
        results = {}
        ok = True
        for name, fn in checks.items():
            try:
                good = bool(fn())
                results[name] = "ok" if good else "failed"
                ok = ok and good
            except Exception as e:
                results[name] = f"error: {e}"
                ok = False
        return ok, results

    def start(self) -> "HealthzServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="pixie-healthz")
        self._thread.start()
        return self

    def stop(self) -> None:
        # shutdown() blocks forever unless serve_forever() is running —
        # a stop() after a FAILED service start must not hang cleanup
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
