"""Protocol traffic parsers — the userspace half of the reference's socket
tracer (src/stirling/source_connectors/socket_tracer/protocols/).

Each protocol module implements the three-function contract of the reference
(protocols/common/interface.h:75-103) as a ProtocolParser subclass:

  * find_frame_boundary — resync position after garbage bytes
  * parse_frame         — one frame off the front of a byte stream
  * stitch              — match request/response frames into records

The kernel eBPF capture half is host-specific and out of environment; byte
streams arrive instead from capture replays, live tap proxies, or test
fixtures (the reference itself unit-tests this layer on captured byte
streams — protocols/http/parse_test.cc).

Copied from the reference package (pixie_tpu/collect/protocols/__init__.py).
"""
from __future__ import annotations

from pixie_tpu_torch.collect.protocols.base import (
    ConnTracker,
    DataStream,
    MessageType,
    ParseState,
    ProtocolParser,
)


def parser_registry():
    """name → ProtocolParser instance for every supported protocol."""
    from pixie_tpu_torch.collect.protocols import (
        cql,
        dns,
        http,
        http2,
        kafka,
        mux,
        mysql,
        nats,
        pgsql,
        redis,
    )

    parsers = [
        http.HTTPParser(),
        http2.HTTP2Parser(),
        mysql.MySQLParser(),
        pgsql.PgSQLParser(),
        dns.DNSParser(),
        redis.RedisParser(),
        cql.CQLParser(),
        kafka.KafkaParser(),
        nats.NATSParser(),
        mux.MuxParser(),
    ]
    return {p.name: p for p in parsers}


__all__ = [
    "ConnTracker",
    "DataStream",
    "MessageType",
    "ParseState",
    "ProtocolParser",
    "parser_registry",
]
