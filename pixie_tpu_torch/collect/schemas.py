"""Canonical telemetry table schemas.

These are the public data contracts of the reference's collection layer — the
tables every bundled PxL script queries.  Column lists/types/semantic types are
transcribed from the reference's Stirling table definitions (cited per table);
they are wire-format facts, not code.

Used by: the script-parity tests (compile all bundled scripts), the collection
connectors that will eventually populate them, and schema introspection UDTFs.

Copied from the reference package (pixie_tpu/collect/schemas.py).
"""
from __future__ import annotations

from pixie_tpu_torch.types import DataType as DT, Relation, SemanticType as ST


def _rel(*cols) -> Relation:
    return Relation.of(*cols)


#: reference src/stirling/core/canonical_types.h + socket_tracer/canonical_types.h
_TIME = ("time_", DT.TIME64NS, ST.ST_TIME_NS)
_UPID = ("upid", DT.UINT128, ST.ST_UPID)
_REMOTE_ADDR = ("remote_addr", DT.STRING, ST.ST_IP_ADDRESS)
_REMOTE_PORT = ("remote_port", DT.INT64, ST.ST_PORT)
_TRACE_ROLE = ("trace_role", DT.INT64)
_LATENCY = ("latency", DT.INT64, ST.ST_DURATION_NS)


SCHEMAS: dict[str, Relation] = {
    # reference src/stirling/source_connectors/socket_tracer/http_table.h:41
    "http_events": _rel(
        _TIME, _UPID, _REMOTE_ADDR, _REMOTE_PORT, _TRACE_ROLE,
        ("major_version", DT.INT64),
        ("minor_version", DT.INT64),
        ("content_type", DT.INT64),
        ("req_headers", DT.STRING),
        ("req_method", DT.STRING, ST.ST_HTTP_REQ_METHOD),
        ("req_path", DT.STRING),
        ("req_body", DT.STRING),
        ("req_body_size", DT.INT64, ST.ST_BYTES),
        ("resp_headers", DT.STRING),
        ("resp_status", DT.INT64, ST.ST_HTTP_RESP_STATUS),
        ("resp_message", DT.STRING, ST.ST_HTTP_RESP_MESSAGE),
        ("resp_body", DT.STRING),
        ("resp_body_size", DT.INT64, ST.ST_BYTES),
        _LATENCY,
    ),
    # reference socket_tracer/conn_stats_table.h:29
    "conn_stats": _rel(
        _TIME, _UPID, _REMOTE_ADDR, _REMOTE_PORT, _TRACE_ROLE,
        ("addr_family", DT.INT64),
        ("protocol", DT.INT64),
        ("ssl", DT.BOOLEAN),
        ("conn_open", DT.INT64),
        ("conn_close", DT.INT64),
        ("conn_active", DT.INT64),
        ("bytes_sent", DT.INT64, ST.ST_BYTES),
        ("bytes_recv", DT.INT64, ST.ST_BYTES),
    ),
    # reference socket_tracer/mysql_table.h:37
    "mysql_events": _rel(
        _TIME, _UPID, _REMOTE_ADDR, _REMOTE_PORT, _TRACE_ROLE,
        ("req_cmd", DT.INT64),
        ("req_body", DT.STRING),
        ("resp_status", DT.INT64),
        ("resp_body", DT.STRING),
        _LATENCY,
    ),
    # reference socket_tracer/pgsql_table.h:29
    "pgsql_events": _rel(
        _TIME, _UPID, _REMOTE_ADDR, _REMOTE_PORT, _TRACE_ROLE,
        ("req_cmd", DT.STRING),
        ("req", DT.STRING),
        ("resp", DT.STRING),
        _LATENCY,
    ),
    # reference socket_tracer/redis_table.h:32
    "redis_events": _rel(
        _TIME, _UPID, _REMOTE_ADDR, _REMOTE_PORT, _TRACE_ROLE,
        ("req_cmd", DT.STRING),
        ("req_args", DT.STRING),
        ("resp", DT.STRING),
        _LATENCY,
    ),
    # reference socket_tracer/cass_table.h:37
    "cql_events": _rel(
        _TIME, _UPID, _REMOTE_ADDR, _REMOTE_PORT, _TRACE_ROLE,
        ("req_op", DT.INT64),
        ("req_body", DT.STRING),
        ("resp_op", DT.INT64),
        ("resp_body", DT.STRING),
        _LATENCY,
    ),
    # reference socket_tracer/dns_table.h:32
    "dns_events": _rel(
        _TIME, _UPID, _REMOTE_ADDR, _REMOTE_PORT, _TRACE_ROLE,
        ("req_header", DT.STRING),
        ("req_body", DT.STRING),
        ("resp_header", DT.STRING),
        ("resp_body", DT.STRING),
        _LATENCY,
    ),
    # reference socket_tracer/kafka_table.h:35
    "kafka_events.beta": _rel(
        _TIME, _UPID, _REMOTE_ADDR, _REMOTE_PORT, _TRACE_ROLE,
        ("req_cmd", DT.INT64),
        ("client_id", DT.STRING),
        ("req_body", DT.STRING),
        ("resp", DT.STRING),
        _LATENCY,
    ),
    # reference socket_tracer/nats_table.h:29
    "nats_events.beta": _rel(
        _TIME, _UPID, _REMOTE_ADDR, _REMOTE_PORT, _TRACE_ROLE,
        ("cmd", DT.STRING),
        ("body", DT.STRING),
        ("resp", DT.STRING),
    ),
    # reference socket_tracer/mux_table.h:32
    "mux_events": _rel(
        _TIME, _UPID, _REMOTE_ADDR, _REMOTE_PORT, _TRACE_ROLE,
        ("req_type", DT.INT64),
        _LATENCY,
    ),
    # reference source_connectors/process_stats/process_stats_table.h:38
    "process_stats": _rel(
        _TIME, _UPID,
        ("major_faults", DT.INT64),
        ("minor_faults", DT.INT64),
        ("cpu_utime_ns", DT.INT64, ST.ST_DURATION_NS),
        ("cpu_ktime_ns", DT.INT64, ST.ST_DURATION_NS),
        ("num_threads", DT.INT64),
        ("vsize_bytes", DT.INT64, ST.ST_BYTES),
        ("rss_bytes", DT.INT64, ST.ST_BYTES),
        ("rchar_bytes", DT.INT64, ST.ST_BYTES),
        ("wchar_bytes", DT.INT64, ST.ST_BYTES),
        ("read_bytes", DT.INT64, ST.ST_BYTES),
        ("write_bytes", DT.INT64, ST.ST_BYTES),
    ),
    # reference source_connectors/network_stats/network_stats_table.h:38
    "network_stats": _rel(
        _TIME,
        ("pod_id", DT.STRING),
        ("rx_bytes", DT.INT64, ST.ST_BYTES),
        ("rx_packets", DT.INT64),
        ("rx_errors", DT.INT64),
        ("rx_drops", DT.INT64),
        ("tx_bytes", DT.INT64, ST.ST_BYTES),
        ("tx_packets", DT.INT64),
        ("tx_errors", DT.INT64),
        ("tx_drops", DT.INT64),
    ),
    # reference source_connectors/jvm_stats/jvm_stats_table.h:36
    "jvm_stats": _rel(
        _TIME, _UPID,
        ("young_gc_time", DT.INT64, ST.ST_DURATION_NS),
        ("full_gc_time", DT.INT64, ST.ST_DURATION_NS),
        ("used_heap_size", DT.INT64, ST.ST_BYTES),
        ("total_heap_size", DT.INT64, ST.ST_BYTES),
        ("max_heap_size", DT.INT64, ST.ST_BYTES),
    ),
    # reference source_connectors/perf_profiler/stack_traces_table.h:31
    "stack_traces.beta": _rel(
        _TIME, _UPID,
        ("stack_trace_id", DT.INT64),
        ("stack_trace", DT.STRING),
        ("count", DT.INT64),
    ),
    # reference source_connectors/proc_exit/proc_exit_events_table.h:36
    "proc_exit_events": _rel(
        _TIME, _UPID,
        ("exit_code", DT.INT64),
        ("signal", DT.INT64),
        ("comm", DT.STRING),
    ),
    # TCP monitor tables.  The reference materializes these dynamically from
    # bpftrace programs embedded in px/tcp_drops/data.pxl:90 and
    # px/tcp_retransmits/data.pxl:92-93 (columns = the programs' printf
    # fields); this build declares them as canonical connector schemas so the
    # scripts run against a netlink//proc-based drops monitor or replayed
    # captures without a kernel probe.
    "tcp_drop_table": _rel(
        _TIME,
        ("pid", DT.INT64),
        ("pid_start_time", DT.INT64),
        ("src_ip", DT.STRING, ST.ST_IP_ADDRESS),
        ("src_port", DT.INT64, ST.ST_PORT),
        ("dst_ip", DT.STRING, ST.ST_IP_ADDRESS),
        ("dst_port", DT.INT64, ST.ST_PORT),
        ("state", DT.STRING),
    ),
    "tcp_retransmissions": _rel(
        _TIME,
        ("pid", DT.INT64),
        ("pid_start_time", DT.INT64),
        ("src_ip", DT.STRING, ST.ST_IP_ADDRESS),
        ("src_port", DT.INT64, ST.ST_PORT),
        ("dst_ip", DT.STRING, ST.ST_IP_ADDRESS),
        ("dst_port", DT.INT64, ST.ST_PORT),
        ("state", DT.STRING),
    ),
}


def _self_telemetry_schemas() -> dict[str, Relation]:
    # self-telemetry (the engine observing itself): trace spans of the query
    # path (pixie_tpu_torch.trace) plus the query flight recorder's tables
    # (pixie_tpu_torch.observe: per-query profiles, per-op stats, sampled
    # metrics, SLO alerts) — all written on agent stores through the
    # normal ingest path and queryable like any connector table
    from pixie_tpu_torch.observe import SELF_TABLES
    from pixie_tpu_torch.trace import SPANS_RELATION, SPANS_TABLE

    return {SPANS_TABLE: SPANS_RELATION, **SELF_TABLES}


def all_schemas() -> dict[str, Relation]:
    return {**SCHEMAS, **_self_telemetry_schemas()}
