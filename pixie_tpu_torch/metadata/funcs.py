"""Metadata scalar UDFs (reference src/carnot/funcs/metadata/metadata_ops.h).

All are *host* UDFs: they evaluate over dictionary values (unique UPIDs /
strings), never over rows — see engine/eval.py's host-call path, which turns
each into a LUT over the argument dictionary's codes that the chain kernel C1
applies on the card.  Each resolves against the current K8sSnapshot at
query-compile time, which matches the reference's semantics of resolving
against the agent's metadata state at execution time (state is epoch-swapped;
a query sees one epoch).

Copied from the reference package (pixie_tpu/metadata/funcs.py).  The
reference registers these into its global registry when this module is
imported; here `pixie_tpu_torch.udf` calls `register_metadata_funcs` as it
builds the registry, so every route to the registry sees them.  This module
therefore imports nothing of `pixie_tpu_torch.udf` at its top (that package
imports it).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from pixie_tpu_torch.metadata import state as mdstate
from pixie_tpu_torch.types import DataType as DT, SemanticType as ST
from pixie_tpu_torch.types import UInt128

if TYPE_CHECKING:
    from pixie_tpu_torch.udf.udf import Registry

_S = DT.STRING
_U = DT.UINT128
_I = DT.INT64

#: declared output semantic types (reference metadata_ops.h declares these on
#: each UDF's ExecOutputType) — drives entity-aware result formatting
_OUT_STS = {
    "upid_to_pod_name": ST.ST_POD_NAME,
    "pod_id_to_pod_name": ST.ST_POD_NAME,
    "upid_to_namespace": ST.ST_NAMESPACE_NAME,
    "pod_id_to_namespace": ST.ST_NAMESPACE_NAME,
    "pod_name_to_namespace": ST.ST_NAMESPACE_NAME,
    "upid_to_node_name": ST.ST_NODE_NAME,
    "pod_id_to_node_name": ST.ST_NODE_NAME,
    "upid_to_hostname": ST.ST_NODE_NAME,
    "upid_to_service_name": ST.ST_SERVICE_NAME,
    "pod_id_to_service_name": ST.ST_SERVICE_NAME,
    "pod_name_to_service_name": ST.ST_SERVICE_NAME,
    "service_id_to_service_name": ST.ST_SERVICE_NAME,
    "ip_to_svc_name": ST.ST_SERVICE_NAME,
    "ip_to_service_name": ST.ST_SERVICE_NAME,
    "upid_to_container_name": ST.ST_CONTAINER_NAME,
    "container_id_to_status": ST.ST_CONTAINER_STATUS,
    "upid_to_pod_status": ST.ST_POD_STATUS,
    "pod_name_to_pod_status": ST.ST_POD_STATUS,
    "pod_name_to_status": ST.ST_POD_STATUS,
    "pod_name_to_pod_ip": ST.ST_IP_ADDRESS,
    "pod_name_to_start_time": ST.ST_TIME_NS,
}


def _pod(upid: UInt128):
    return mdstate.snapshot().pod_of_upid(upid)


def _svc(upid: UInt128):
    return mdstate.snapshot().service_of_upid(upid)


def _host(name, args, out, fn, volatile=True):
    # volatile: fns reading the ambient K8sSnapshot.  Their LUTs are built
    # anew for every query and reach the card through device_luts, keyed by
    # the LUT's contents, so a new epoch uploads new LUTs; a standing view
    # refuses a chain that calls one (matview/registry.py).  Pure fns (upid
    # field extractors, string splitters) pass volatile=False.
    from pixie_tpu_torch.udf.udf import ScalarUDF

    return ScalarUDF(name=name, arg_types=args, out_type=out, fn=fn, device=False,
                     volatile=volatile, out_st=_OUT_STS.get(name))


def register_metadata_funcs(r: Registry) -> None:
    # ---- upid_to_* (reference metadata_ops.h UPIDTo*UDF)
    r.register(_host("upid_to_pod_name", (_U,), _S,
                     lambda u: (_pod(u).qualified_name if _pod(u) else "")))
    r.register(_host("upid_to_pod_id", (_U,), _S,
                     lambda u: (_pod(u).uid if _pod(u) else "")))
    r.register(_host("upid_to_namespace", (_U,), _S,
                     lambda u: (_pod(u).namespace if _pod(u) else "")))
    r.register(_host("upid_to_node_name", (_U,), _S,
                     lambda u: (_pod(u).node if _pod(u) else "")))
    r.register(_host("upid_to_service_name", (_U,), _S,
                     lambda u: (_svc(u).qualified_name if _svc(u) else "")))
    r.register(_host("upid_to_service_id", (_U,), _S,
                     lambda u: (_svc(u).uid if _svc(u) else "")))
    r.register(_host("upid_to_container_id", (_U,), _S,
                     lambda u: mdstate.snapshot().upid_to_container_id.get(u, "")))
    r.register(_host("upid_to_container_name", (_U,), _S, _upid_to_container_name))
    r.register(_host("upid_to_deployment_name", (_U,), _S,
                     lambda u: (_pod(u).owner_deployment if _pod(u) else "")))
    r.register(_host("upid_to_cmdline", (_U,), _S,
                     lambda u: mdstate.snapshot().upid_to_cmdline.get(u, "")))
    r.register(_host("upid_to_pid", (_U,), _I, lambda u: u.pid, volatile=False))
    r.register(_host("upid_to_asid", (_U,), _I, lambda u: u.asid, volatile=False))
    r.register(_host("upid_to_string", (_U,), _S, str, volatile=False))

    # ---- pod/service/ip lookups
    r.register(_host("pod_id_to_pod_name", (_S,), _S,
                     lambda uid: _qname(mdstate.snapshot().pods_by_uid.get(uid))))
    r.register(_host("pod_id_to_namespace", (_S,), _S,
                     lambda uid: _attr(mdstate.snapshot().pods_by_uid.get(uid), "namespace")))
    r.register(_host("pod_id_to_node_name", (_S,), _S,
                     lambda uid: _attr(mdstate.snapshot().pods_by_uid.get(uid), "node")))
    r.register(_host("pod_id_to_service_name", (_S,), _S, _pod_id_to_service_name))
    r.register(_host("pod_name_to_pod_id", (_S,), _S, _pod_name_to_pod_id))
    r.register(_host("pod_name_to_namespace", (_S,), _S, _qn_namespace,
                     volatile=False))
    r.register(_host("pod_name_to_service_name", (_S,), _S,
                     lambda qn: _pod_id_to_service_name(_pod_name_to_pod_id(qn))))
    r.register(_host("pod_name_to_pod_status", (_S,), _S,
                     lambda qn: _attr(mdstate.snapshot().pods_by_uid.get(_pod_name_to_pod_id(qn)), "phase")))
    r.register(_host("pod_name_to_pod_ip", (_S,), _S,
                     lambda qn: _attr(mdstate.snapshot().pods_by_uid.get(_pod_name_to_pod_id(qn)), "ip")))
    r.register(_host("service_id_to_service_name", (_S,), _S,
                     lambda uid: _qname(mdstate.snapshot().services_by_uid.get(uid))))
    r.register(_host("service_name_to_service_id", (_S,), _S, _service_name_to_service_id))
    r.register(_host("ip_to_pod_id", (_S,), _S,
                     lambda ip: _attr(mdstate.snapshot().pod_of_ip(ip), "uid")))
    r.register(_host("ip_to_svc_name", (_S,), _S,
                     lambda ip: _qname(mdstate.snapshot().service_of_ip(ip))))
    r.register(_host("nslookup", (_S,), _S, lambda ip: mdstate.snapshot().nslookup(ip)))
    r.register(_host("pod_name_to_start_time", (_S,), DT.TIME64NS,
                     lambda qn: _attr(mdstate.snapshot().pods_by_uid.get(_pod_name_to_pod_id(qn)),
                                      "create_time_ns", 0)))
    # Aliases + remaining lookups the bundled scripts call
    # (reference metadata_ops.h PodNameToPodStatusUDF, IPToServiceIDUDF,
    # ContainerIDToContainerStatusUDF, ServiceIDToClusterIPUDF).
    r.register(_host("pod_name_to_status", (_S,), _S,
                     lambda qn: _attr(mdstate.snapshot().pods_by_uid.get(_pod_name_to_pod_id(qn)), "phase")))
    r.register(_host("ip_to_service_id", (_S,), _S,
                     lambda ip: _attr(mdstate.snapshot().service_of_ip(ip), "uid")))
    r.register(_host("ip_to_service_name", (_S,), _S,
                     lambda ip: _qname(mdstate.snapshot().service_of_ip(ip))))
    r.register(_host("container_id_to_status", (_S,), _S,
                     lambda cid: _attr(mdstate.snapshot().containers_by_id.get(cid), "state")))

    # ---- remaining reference lookup set (metadata_ops.h: start/stop times,
    # qos/status, hostname, service ids/ips, container name index)
    r.register(_host("upid_to_pod_status", (_U,), _S,
                     lambda u: _attr(_pod(u), "phase")))
    r.register(_host("upid_to_pod_qos", (_U,), _S,
                     lambda u: _attr(_pod(u), "qos_class")))
    r.register(_host("upid_to_hostname", (_U,), _S,
                     lambda u: _attr(_pod(u), "node")))
    r.register(_host("pod_id_to_start_time", (_S,), DT.TIME64NS,
                     lambda uid: _attr(mdstate.snapshot().pods_by_uid.get(uid), "create_time_ns", 0)))
    r.register(_host("pod_id_to_stop_time", (_S,), DT.TIME64NS,
                     lambda uid: _attr(mdstate.snapshot().pods_by_uid.get(uid), "stop_time_ns", 0)))
    r.register(_host("pod_name_to_stop_time", (_S,), DT.TIME64NS,
                     lambda qn: _attr(mdstate.snapshot().pods_by_uid.get(_pod_name_to_pod_id(qn)), "stop_time_ns", 0)))
    r.register(_host("pod_id_to_service_id", (_S,), _S, _first_svc_uid))
    r.register(_host("pod_name_to_service_id", (_S,), _S,
                     lambda qn: _first_svc_uid(_pod_name_to_pod_id(qn))))
    r.register(_host("service_id_to_cluster_ip", (_S,), _S,
                     lambda uid: _attr(mdstate.snapshot().services_by_uid.get(uid), "cluster_ip")))
    r.register(_host("service_id_to_external_ips", (_S,), _S,
                     lambda uid: ",".join(_attr(mdstate.snapshot().services_by_uid.get(uid), "external_ips", ()))))
    r.register(_host("service_name_to_namespace", (_S,), _S, _qn_namespace,
                     volatile=False))
    r.register(_host("container_name_to_container_id", (_S,), _S, _cname_to_cid))
    r.register(_host("container_id_to_start_time", (_S,), DT.TIME64NS,
                     lambda cid: _attr(mdstate.snapshot().containers_by_id.get(cid), "start_time_ns", 0)))
    r.register(_host("container_id_to_stop_time", (_S,), DT.TIME64NS,
                     lambda cid: _attr(mdstate.snapshot().containers_by_id.get(cid), "stop_time_ns", 0)))
    r.register(_host("container_name_to_start_time", (_S,), DT.TIME64NS,
                     lambda n: _attr(mdstate.snapshot().containers_by_id.get(_cname_to_cid(n)), "start_time_ns", 0)))
    r.register(_host("container_name_to_stop_time", (_S,), DT.TIME64NS,
                     lambda n: _attr(mdstate.snapshot().containers_by_id.get(_cname_to_cid(n)), "stop_time_ns", 0)))

    # has_service_name/has_service_id: 1-arg form tests non-emptiness; the
    # 2-arg form used by drilldown scripts (px.has_service_name(col, 'ns/svc'))
    # tests membership, including the reference's grouped "svc1,svc2" encoding.
    r.register(_host("has_service_name", (_S,), DT.BOOLEAN, lambda qn: qn != "",
                     volatile=False))
    r.register(_host("has_service_id", (_S,), DT.BOOLEAN, lambda uid: uid != "",
                     volatile=False))
    r.register(_host("has_service_name", (_S, _S), DT.BOOLEAN, _has_value,
                     volatile=False))
    r.register(_host("has_service_id", (_S, _S), DT.BOOLEAN, _has_value,
                     volatile=False))

    # Current-context nullary helpers are provided by the compiler (px module)
    # because they need no column input: px.asid(), px.node_name().


def _has_value(col_val: str, target: str) -> bool:
    """Membership test tolerating the reference's multi-value encodings
    (comma-joined or JSON-list strings of qualified names)."""
    if not col_val:
        return False
    if col_val == target:
        return True
    if col_val.startswith("["):
        import json

        try:
            return target in json.loads(col_val)
        except ValueError:
            return False
    return target in col_val.split(",")


def _qname(obj) -> str:
    return obj.qualified_name if obj else ""


def _attr(obj, name, default=""):
    return getattr(obj, name) if obj else default


def _upid_to_container_name(u: UInt128) -> str:
    s = mdstate.snapshot()
    cid = s.upid_to_container_id.get(u, "")
    c = s.containers_by_id.get(cid)
    return c.name if c else ""


def _pod_id_to_service_name(uid: str) -> str:
    s = mdstate.snapshot()
    for suid in s.pod_uid_to_service_uids.get(uid, ()):
        svc = s.services_by_uid.get(suid)
        if svc:
            return svc.qualified_name
    return ""


def _qn_namespace(qualified: str) -> str:
    """'ns/name' → 'ns' (pod and service qualified names share the format)."""
    return qualified.split("/", 1)[0] if "/" in qualified else ""


def _first_svc_uid(pod_uid: str) -> str:
    for suid in mdstate.snapshot().pod_uid_to_service_uids.get(pod_uid, ()):
        return suid
    return ""


def _cname_to_cid(name: str) -> str:
    return mdstate.snapshot().container_name_to_cid.get(name, "")


def _pod_name_to_pod_id(qualified: str) -> str:
    return mdstate.snapshot().pod_name_to_uid.get(qualified, "")


def _service_name_to_service_id(qualified: str) -> str:
    return mdstate.snapshot().service_name_to_uid.get(qualified, "")


#: ctx key → (udf name, required input column). Reference: the analyzer's
#: metadata-conversion rule rewrites df.ctx['pod'] into upid_to_pod_name(upid)
#: (planner/compiler/analyzer, metadata resolution).
#: ctx key → candidate (udf, source column) chain, tried in order against the
#: DataFrame's columns.  The reference's metadata-conversion rule does the
#: same: it picks whichever metadata key column the table carries (upid for
#: traced tables, pod_id for network_stats — metadata_ir.cc ResolveMetadata).
CTX_KEYS = {
    "pod": [("upid_to_pod_name", "upid"), ("pod_id_to_pod_name", "pod_id")],
    "pod_name": [("upid_to_pod_name", "upid"), ("pod_id_to_pod_name", "pod_id")],
    "pod_id": [("upid_to_pod_id", "upid"), ("pod_name_to_pod_id", "pod_name")],
    "service": [("upid_to_service_name", "upid"),
                ("pod_id_to_service_name", "pod_id")],
    "service_name": [("upid_to_service_name", "upid"),
                     ("pod_id_to_service_name", "pod_id")],
    "service_id": [("upid_to_service_id", "upid")],
    "namespace": [("upid_to_namespace", "upid"),
                  ("pod_id_to_namespace", "pod_id")],
    "node": [("upid_to_node_name", "upid"), ("pod_id_to_node_name", "pod_id")],
    "node_name": [("upid_to_node_name", "upid"),
                  ("pod_id_to_node_name", "pod_id")],
    "container": [("upid_to_container_name", "upid")],
    "container_name": [("upid_to_container_name", "upid")],
    "container_id": [("upid_to_container_id", "upid")],
    "deployment": [("upid_to_deployment_name", "upid")],
    "cmdline": [("upid_to_cmdline", "upid")],
    "cmd": [("upid_to_cmdline", "upid")],
    "pid": [("upid_to_pid", "upid")],
    "asid": [("upid_to_asid", "upid")],
}
