"""Access-log connector: tail web-server logs into `http_events`.

Reference role: the socket tracer's HTTP path (src/stirling/source_connectors/
socket_tracer/, http parser under protocols/http/) fills `http_events` from
kernel capture.  Kernel eBPF is host-specific; this connector provides the
same table from the ubiquitous userland source — Common/Combined Log Format
access logs (nginx/apache/envoy file output), tailed incrementally with
offset resume.

Lines parse with one compiled regex per batch; unparseable lines are counted,
not fatal (the reference's parser also drops unparseable frames).

Copied from the reference package (pixie_tpu/collect/access_log.py).
"""
from __future__ import annotations

import os
import re
from datetime import datetime

import numpy as np

from pixie_tpu_torch.collect.core import SourceConnector, TableSpec
from pixie_tpu_torch.collect.schemas import SCHEMAS
from pixie_tpu_torch.types import UInt128

#: Combined Log Format, optionally with a trailing request-time seconds field
#: (nginx `$request_time`): host ident user [time] "method path proto"
#: status bytes "referer" "ua" [rt]
_LINE_RE = re.compile(
    r'^(?P<addr>\S+) \S+ \S+ \[(?P<time>[^\]]+)\] '
    r'"(?P<method>\S+) (?P<path>\S+)(?: (?P<proto>[^"]*))?" '
    r'(?P<status>\d{3}) (?P<size>\d+|-)'
    r'(?: "(?P<referer>[^"]*)" "(?P<ua>[^"]*)")?'
    r'(?: (?P<rt>\d+(?:\.\d+)?))?\s*$'
)

_TIME_FMT = "%d/%b/%Y:%H:%M:%S %z"


def parse_line(line: str):
    """One log line → dict of http_events fields, or None if unparseable."""
    m = _LINE_RE.match(line)
    if m is None:
        return None
    try:
        t = datetime.strptime(m.group("time"), _TIME_FMT)
    except ValueError:
        return None
    size = m.group("size")
    rt = m.group("rt")
    proto = m.group("proto") or "HTTP/1.1"
    major = 2 if proto.startswith("HTTP/2") else 1
    return {
        "time_": int(t.timestamp() * 1_000_000_000),
        "remote_addr": m.group("addr"),
        "req_method": m.group("method"),
        "req_path": m.group("path"),
        "resp_status": int(m.group("status")),
        "resp_body_size": 0 if size == "-" else int(size),
        "latency": int(float(rt) * 1_000_000_000) if rt else 0,
        "major_version": major,
    }


class AccessLogConnector(SourceConnector):
    """Tails one access-log file into the canonical http_events table."""

    name = "access_log"

    def __init__(self, path: str, sample_period_s: float = 1.0,
                 asid: int = 0, follow: bool = True):
        self.path = path
        #: unique per path so several logs can feed one collector
        self.name = f"access_log:{path}"
        self.sample_period_s = sample_period_s
        self.follow = follow
        self._offset = 0
        self._partial = ""
        self._ino: int | None = None
        self._upid = UInt128.make_upid(asid, os.getpid(), 0)
        self.lines_parsed = 0
        self.lines_dropped = 0
        self.read_errors = 0

    def tables(self) -> list[TableSpec]:
        return [TableSpec("http_events", SCHEMAS["http_events"],
                          sample_period_s=self.sample_period_s)]

    def transfer_data(self) -> dict[str, dict]:
        try:
            # Rotation/truncation: a new inode (logrotate) or a size below our
            # offset (in-place truncation) restarts from the top and drops the
            # stale partial.  (A same-size in-place rewrite is undetectable
            # without content checksums — standard tail behavior.)
            st = os.stat(self.path)
            if st.st_ino != self._ino or st.st_size < self._offset:
                if self._ino is not None or st.st_size < self._offset:
                    self._offset = 0
                    self._partial = ""
                self._ino = st.st_ino
            with open(self.path, "r", errors="replace") as f:
                f.seek(self._offset)
                chunk = f.read()
                self._offset = f.tell()
        except OSError:
            # Missing path: one-shot (follow=False) connectors are done; a
            # tailing connector keeps waiting but counts the misses so a
            # typo'd path is visible in stats.
            self.read_errors += 1
            if not self.follow:
                self.exhausted = True
            return {}
        if not chunk:
            if not self.follow:
                self.exhausted = True
            return {}
        text = self._partial + chunk
        lines = text.split("\n")
        self._partial = lines.pop()  # trailing incomplete line
        rows = []
        for line in lines:
            if not line.strip():
                continue
            rec = parse_line(line)
            if rec is None:
                self.lines_dropped += 1
            else:
                rows.append(rec)
        self.lines_parsed += len(rows)
        if not rows:
            if not self.follow:
                self.exhausted = True
            return {}
        n = len(rows)
        rel = SCHEMAS["http_events"]
        out: dict[str, object] = {}
        for c in rel:
            if c.name in rows[0]:
                out[c.name] = [r[c.name] for r in rows]
            elif c.name == "upid":
                out[c.name] = [self._upid] * n
            elif c.name in ("req_headers", "resp_headers", "req_body",
                            "resp_body", "resp_message"):
                out[c.name] = [""] * n
            elif c.name == "remote_port":
                out[c.name] = np.zeros(n, dtype=np.int64)
            elif c.name == "trace_role":
                out[c.name] = np.full(n, 2, dtype=np.int64)  # responder side
            else:
                out[c.name] = np.zeros(n, dtype=np.int64)
        return {"http_events": out}
