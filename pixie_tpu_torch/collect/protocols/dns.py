"""DNS message parser + txid stitcher.

Reference: socket_tracer/protocols/dns/ (parse.cc full message decode with
name compression; stitcher.cc txid matching + rapidjson record formatting —
the JSON shapes here mirror stitcher.cc:37-130 so `px/dns_data` renders
identically).

Datagram protocol: each capture event is one complete DNS message (header
12 bytes: txid, flags, qd/an/ns/ar counts, then sections).

Copied from the reference package (pixie_tpu/collect/protocols/dns.py).
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

_TYPE_A = 1
_TYPE_NS = 2
_TYPE_CNAME = 5
_TYPE_SOA = 6
_TYPE_PTR = 12
_TYPE_MX = 15
_TYPE_TXT = 16
_TYPE_AAAA = 28


@dataclasses.dataclass
class DNSMessage(Frame):
    txid: int = 0
    flags: int = 0
    num_queries: int = 0
    num_answers: int = 0
    num_auth: int = 0
    num_addl: int = 0
    #: [(name, qtype)] questions
    queries: list = dataclasses.field(default_factory=list)
    #: [{"name":…, "type":…, "addr"/"cname":…}] answers
    answers: list = dataclasses.field(default_factory=list)

    @property
    def is_response(self) -> bool:
        return bool(self.flags >> 15)


def _read_name(buf: bytes, pos: int, depth: int = 0):
    """DNS name with compression pointers -> (name, next_pos) or None."""
    if depth > 10:
        return None
    labels = []
    while True:
        if pos >= len(buf):
            return None
        ln = buf[pos]
        if ln == 0:
            pos += 1
            break
        if ln & 0xC0 == 0xC0:  # compression pointer
            if pos + 2 > len(buf):
                return None
            ptr = int.from_bytes(buf[pos:pos + 2], "big") & 0x3FFF
            if ptr >= pos:
                return None
            tail = _read_name(buf, ptr, depth + 1)
            if tail is None:
                return None
            labels.append(tail[0])
            pos += 2
            return ".".join(x for x in labels if x), pos
        if ln & 0xC0:
            return None
        if pos + 1 + ln > len(buf):
            return None
        labels.append(buf[pos + 1:pos + 1 + ln].decode("latin1", "replace"))
        pos += 1 + ln
    return ".".join(labels), pos


def _type_name(t: int) -> str:
    # reference DNSRecordTypeName: A/AAAA from addr family, "" otherwise
    return {_TYPE_A: "A", _TYPE_AAAA: "AAAA", _TYPE_CNAME: "CNAME"}.get(t, "")


def _ipv4(b: bytes) -> str:
    return ".".join(str(x) for x in b)


def _ipv6(b: bytes) -> str:
    import ipaddress

    return str(ipaddress.IPv6Address(b))


class DNSParser(ProtocolParser):
    name = "dns"
    table = "dns_events"
    datagram = True

    def parse_frame(self, msg_type, buf, state=None):
        if len(buf) < 12:
            return ParseState.NEEDS_MORE_DATA, None, 0
        msg = DNSMessage(
            txid=int.from_bytes(buf[0:2], "big"),
            flags=int.from_bytes(buf[2:4], "big"),
            num_queries=int.from_bytes(buf[4:6], "big"),
            num_answers=int.from_bytes(buf[6:8], "big"),
            num_auth=int.from_bytes(buf[8:10], "big"),
            num_addl=int.from_bytes(buf[10:12], "big"),
        )
        if msg.num_queries > 100 or msg.num_answers > 1000:
            return ParseState.INVALID, None, 0
        pos = 12
        for _ in range(msg.num_queries):
            got = _read_name(buf, pos)
            if got is None or got[1] + 4 > len(buf):
                return ParseState.INVALID, None, 0
            name, pos = got
            qtype = int.from_bytes(buf[pos:pos + 2], "big")
            pos += 4  # type + class
            msg.queries.append((name, qtype))
        for _ in range(msg.num_answers):
            got = _read_name(buf, pos)
            if got is None or got[1] + 10 > len(buf):
                return ParseState.INVALID, None, 0
            name, pos = got
            rtype = int.from_bytes(buf[pos:pos + 2], "big")
            rdlen = int.from_bytes(buf[pos + 8:pos + 10], "big")
            pos += 10
            if pos + rdlen > len(buf):
                return ParseState.INVALID, None, 0
            rdata = buf[pos:pos + rdlen]
            pos += rdlen
            ans = {"name": name, "type": _type_name(rtype)}
            if rtype == _TYPE_A and rdlen == 4:
                ans["addr"] = _ipv4(rdata)
            elif rtype == _TYPE_AAAA and rdlen == 16:
                ans["addr"] = _ipv6(rdata)
            elif rtype == _TYPE_CNAME:
                got = _read_name(buf, pos - rdlen)
                ans["cname"] = got[0] if got else ""
            msg.answers.append(ans)
        # Authority/additional sections are counted in the header and SKIPPED
        # (not decoded into records — reference behavior), but must still be
        # walked so `consumed` lands on the true message end: consuming
        # len(buf) would swallow any further messages queued in the stream.
        for _ in range(msg.num_auth + msg.num_addl):
            got = _read_name(buf, pos)
            if got is None or got[1] + 10 > len(buf):
                return ParseState.INVALID, None, 0
            _name, pos = got
            rdlen = int.from_bytes(buf[pos + 8:pos + 10], "big")
            pos += 10 + rdlen
            if pos > len(buf):
                return ParseState.INVALID, None, 0
        return ParseState.SUCCESS, msg, pos

    # ------------------------------------------------------------- stitching
    def stitch(self, requests, responses, state=None):
        records = []
        errors = 0
        by_txid = {}
        for req in requests:
            by_txid.setdefault(req.txid, deque()).append(req)
        matched_reqs = set()
        for resp in responses:
            q = by_txid.get(resp.txid)
            if not q:
                errors += 1  # orphan response (request lost / mid-attach)
                continue
            req = q.popleft()
            matched_reqs.add(id(req))
            records.append((req, resp))
        # Rebuild (O(n)) instead of per-item remove (O(n^2)); ALL responses
        # drain — matched ones are recorded, orphans counted and dropped.
        responses.clear()
        if matched_reqs:
            kept = [r for r in requests if id(r) not in matched_reqs]
            requests.clear()
            requests.extend(kept)
        return records, errors

    @staticmethod
    def _header_json(msg: DNSMessage) -> str:
        f = msg.flags
        d = {
            "txid": msg.txid,
            "qr": (f >> 15) & 1, "opcode": (f >> 11) & 0xF,
            "aa": (f >> 10) & 1, "tc": (f >> 9) & 1, "rd": (f >> 8) & 1,
            "ra": (f >> 7) & 1, "ad": (f >> 5) & 1, "cd": (f >> 4) & 1,
            "rcode": f & 0xF,
            "num_queries": msg.num_queries, "num_answers": msg.num_answers,
            "num_auth": msg.num_auth, "num_addl": msg.num_addl,
        }
        return json.dumps(d, separators=(",", ":"))

    def record_row(self, record):
        req, resp = record
        queries = [{"name": n, "type": _type_name(t)} for n, t in req.queries]
        return {
            "time_": resp.timestamp_ns,
            "latency": max(resp.timestamp_ns - req.timestamp_ns, 0),
            "req_header": self._header_json(req),
            "req_body": json.dumps({"queries": queries}, separators=(",", ":")),
            "resp_header": self._header_json(resp),
            "resp_body": json.dumps({"answers": resp.answers},
                                    separators=(",", ":")),
        }
