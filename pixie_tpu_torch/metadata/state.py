"""K8s metadata state — per-agent view of cluster objects.

Parity with the reference's AgentMetadataState (src/shared/metadata/
metadata_state.h, k8s_objects.h): pods/services/namespaces/containers plus the
PID→UPID and IP→pod indexes that the metadata UDFs consult.  What differs is
*where* it is read: the reference resolves metadata per row inside UDF Exec
loops; here the resolution happens host-side over UPID/string dictionary values
only (O(unique), see table/dictionary.py), so this state never needs to be
device-resident: on the card a metadata UDF is a LUT over a dictionary's
codes, which the chain kernel C1 applies with its LUT opcodes.

Updates arrive as ResourceUpdate-like dicts (reference
src/shared/k8s/metadatapb/metadata.proto) and are applied copy-on-write: readers
grab an immutable snapshot via `current()`; a swap publishes the next epoch
(reference state_manager.h:84 PerformMetadataStateUpdate's atomic swap).

Copied from the reference package (pixie_tpu/metadata/state.py).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

from pixie_tpu_torch.types import UInt128


@dataclasses.dataclass(frozen=True)
class PodInfo:
    uid: str
    name: str
    namespace: str
    node: str = ""
    ip: str = ""
    phase: str = "RUNNING"
    labels: str = ""
    create_time_ns: int = 0
    stop_time_ns: int = 0
    owner_deployment: str = ""
    qos_class: str = ""  # Guaranteed | Burstable | BestEffort

    @property
    def qualified_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclasses.dataclass(frozen=True)
class ServiceInfo:
    uid: str
    name: str
    namespace: str
    cluster_ip: str = ""
    external_ips: tuple = ()

    @property
    def qualified_name(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclasses.dataclass(frozen=True)
class ContainerInfo:
    cid: str
    name: str
    pod_uid: str
    state: str = "RUNNING"
    start_time_ns: int = 0
    stop_time_ns: int = 0


@dataclasses.dataclass(frozen=True)
class K8sSnapshot:
    """Immutable metadata epoch. All maps are plain dicts, never mutated."""

    asid: int = 0
    pods_by_uid: dict = dataclasses.field(default_factory=dict)
    services_by_uid: dict = dataclasses.field(default_factory=dict)
    containers_by_id: dict = dataclasses.field(default_factory=dict)
    upid_to_pod_uid: dict = dataclasses.field(default_factory=dict)
    upid_to_container_id: dict = dataclasses.field(default_factory=dict)
    upid_to_cmdline: dict = dataclasses.field(default_factory=dict)
    ip_to_pod_uid: dict = dataclasses.field(default_factory=dict)
    ip_to_service_uid: dict = dataclasses.field(default_factory=dict)
    pod_uid_to_service_uids: dict = dataclasses.field(default_factory=dict)
    #: qualified ("ns/name") AND bare name → uid reverse indexes, so per-dict-value
    #: UDF lookups are O(1) instead of scanning all pods per unique string.
    pod_name_to_uid: dict = dataclasses.field(default_factory=dict)
    service_name_to_uid: dict = dataclasses.field(default_factory=dict)
    #: container name → cid.  Names duplicate across pods (sidecars); the
    #: qualified "pod_uid/name" key disambiguates, bare name keeps
    #: last-writer (documented ambiguity of the bare lookup).
    container_name_to_cid: dict = dataclasses.field(default_factory=dict)
    dns: dict = dataclasses.field(default_factory=dict)  # ip -> hostname
    node_name: str = ""

    # ------------------------------------------------------------- resolution
    def pod_of_upid(self, upid: UInt128) -> Optional[PodInfo]:
        uid = self.upid_to_pod_uid.get(upid)
        return self.pods_by_uid.get(uid) if uid else None

    def service_of_upid(self, upid: UInt128) -> Optional[ServiceInfo]:
        uid = self.upid_to_pod_uid.get(upid)
        if not uid:
            return None
        suids = self.pod_uid_to_service_uids.get(uid, ())
        for s in suids:
            svc = self.services_by_uid.get(s)
            if svc:
                return svc
        return None

    def pod_of_ip(self, ip: str) -> Optional[PodInfo]:
        uid = self.ip_to_pod_uid.get(ip)
        return self.pods_by_uid.get(uid) if uid else None

    def service_of_ip(self, ip: str) -> Optional[ServiceInfo]:
        uid = self.ip_to_service_uid.get(ip)
        return self.services_by_uid.get(uid) if uid else None

    def nslookup(self, ip: str) -> str:
        pod = self.pod_of_ip(ip)
        if pod:
            return pod.qualified_name
        svc = self.service_of_ip(ip)
        if svc:
            return svc.qualified_name
        return self.dns.get(ip, ip)


class MetadataStateManager:
    """Copy-on-write holder of the current K8sSnapshot (reference
    AgentMetadataStateManager, state_manager.h:60-139)."""

    def __init__(self, asid: int = 0, node_name: str = ""):
        self._lock = threading.Lock()
        self._snap = K8sSnapshot(asid=asid, node_name=node_name)
        self.epoch = 0

    def current(self) -> K8sSnapshot:
        return self._snap

    def apply_updates(self, updates: list[dict]) -> None:
        """Apply a batch of resource updates and publish a new epoch.

        Update kinds mirror metadata.proto ResourceUpdate: pod, service,
        container, process (upid binding), dns.
        """
        with self._lock:
            s = self._snap
            pods = dict(s.pods_by_uid)
            svcs = dict(s.services_by_uid)
            ctrs = dict(s.containers_by_id)
            upid_pod = dict(s.upid_to_pod_uid)
            upid_ctr = dict(s.upid_to_container_id)
            upid_cmd = dict(s.upid_to_cmdline)
            ip_pod = dict(s.ip_to_pod_uid)
            ip_svc = dict(s.ip_to_service_uid)
            pod_svc = dict(s.pod_uid_to_service_uids)
            pod_names = dict(s.pod_name_to_uid)
            svc_names = dict(s.service_name_to_uid)
            ctr_names = dict(s.container_name_to_cid)
            dns = dict(s.dns)
            for u in updates:
                kind = u["kind"]
                if kind == "pod":
                    p = PodInfo(**{k: v for k, v in u.items() if k != "kind"})
                    pods[p.uid] = p
                    if p.ip:
                        ip_pod[p.ip] = p.uid
                    pod_names[p.qualified_name] = p.uid
                    pod_names[p.name] = p.uid
                elif kind == "service":
                    sv = ServiceInfo(**{k: v for k, v in u.items() if k not in ("kind", "pod_uids")})
                    svcs[sv.uid] = sv
                    if sv.cluster_ip:
                        ip_svc[sv.cluster_ip] = sv.uid
                    svc_names[sv.qualified_name] = sv.uid
                    svc_names[sv.name] = sv.uid
                    for puid in u.get("pod_uids", ()):
                        pod_svc[puid] = tuple(set(pod_svc.get(puid, ())) | {sv.uid})
                elif kind == "container":
                    c = ContainerInfo(**{k: v for k, v in u.items() if k != "kind"})
                    ctrs[c.cid] = c
                    ctr_names[c.name] = c.cid
                    ctr_names[f"{c.pod_uid}/{c.name}"] = c.cid
                elif kind == "process":
                    upid = u["upid"]
                    if not isinstance(upid, UInt128):
                        upid = UInt128(*upid)
                    if "pod_uid" in u:
                        upid_pod[upid] = u["pod_uid"]
                    if "container_id" in u:
                        upid_ctr[upid] = u["container_id"]
                    if "cmdline" in u:
                        upid_cmd[upid] = u["cmdline"]
                elif kind == "dns":
                    dns[u["ip"]] = u["hostname"]
                else:
                    raise ValueError(f"unknown resource update kind {kind!r}")
            self._snap = K8sSnapshot(
                asid=s.asid,
                pods_by_uid=pods,
                services_by_uid=svcs,
                containers_by_id=ctrs,
                container_name_to_cid=ctr_names,
                upid_to_pod_uid=upid_pod,
                upid_to_container_id=upid_ctr,
                upid_to_cmdline=upid_cmd,
                ip_to_pod_uid=ip_pod,
                ip_to_service_uid=ip_svc,
                pod_uid_to_service_uids=pod_svc,
                pod_name_to_uid=pod_names,
                service_name_to_uid=svc_names,
                dns=dns,
                node_name=s.node_name,
            )
            self.epoch += 1


# Process-global manager, swapped in by the agent at startup; tests install
# their own fixture state (reference: ExecState carries the metadata state into
# UDF evaluation — ours is ambient because host UDF eval is single-process).
_manager = MetadataStateManager()


def global_manager() -> MetadataStateManager:
    return _manager


def set_global_manager(m: MetadataStateManager) -> None:
    global _manager
    _manager = m


def snapshot() -> K8sSnapshot:
    return _manager.current()
