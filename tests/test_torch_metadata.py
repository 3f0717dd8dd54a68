"""The port's metadata state and its 52 scalar functions against the
reference's (pixie_tpu/metadata/, udf/builtins.py asid / _exec_hostname).

Both packages get the same K8s snapshot (each its own global manager, its
own UInt128), and every function is called on the same UPIDs and strings;
then the ctx query (filter, df.ctx['service'] / ['namespace'], group by
service and status: count, int64 sum, mean, p50) runs through both
packages' compile_pxl and executors, before and after an epoch change.
Tolerances: counts, int64 sums, keys and every function's value exact;
means to rtol 1e-12; p50 in the same sketch bin (its value to rtol 1e-12,
the ulp that XLA's pow and libm's may differ by).  Then the
/proc scanner and the watch feed cases of tests/test_metadata_live.py.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import pathlib

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (JAX first: x64 on)
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.metadata import state as ref_state
from pixie_tpu.metadata.funcs import register_metadata_funcs as ref_register
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RDT, Relation as RRel, UInt128 as RU
from pixie_tpu.udf import registry as ref_registry
from pixie_tpu.udf.udf import Registry as RefRegistry

from pixie_tpu_torch import flags
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.metadata import CTX_KEYS, state as md_state
from pixie_tpu_torch.metadata.proc_scanner import ProcScanner, pid_cmdline, pid_start_time_ns
from pixie_tpu_torch.metadata.state import MetadataStateManager
from pixie_tpu_torch.metadata.watch import ResourceUpdateFeed, apply_updates_json
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation, UInt128
from pixie_tpu_torch.udf import registry

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: the reference's 52 metadata names: its metadata module's, and the two
#: ambient builtins that read the state
_REF_MD = RefRegistry()
ref_register(_REF_MD)
MD_NAMES = sorted(set(_REF_MD.names()["scalar"]) | {"asid", "_exec_hostname"})


def _updates(U) -> list[dict]:
    """4 namespaces x 16 services x 4 pods, 2 nodes, a container a pod, 40
    UPIDs (32 bound to pods, 8 with only a cmdline), DNS for each service
    ip."""
    ups = []
    for p in range(64):
        s = p // 4
        ups.append({"kind": "pod", "uid": f"pod-{p}", "name": f"web-{p}",
                    "namespace": f"ns{s % 4}", "node": f"node-{p % 2}",
                    "ip": f"10.0.{s}.{p % 4 + 1}", "phase": "Running",
                    "create_time_ns": 1000 + p, "stop_time_ns": 2000 + p,
                    "owner_deployment": f"dep-{s}", "qos_class": "Burstable"})
        ups.append({"kind": "container", "cid": f"ctr-{p}", "name": f"c{s}",
                    "pod_uid": f"pod-{p}", "start_time_ns": 10 + p,
                    "stop_time_ns": 20 + p})
    for s in range(16):
        ups.append({"kind": "service", "uid": f"svc-{s}", "name": f"svc{s}",
                    "namespace": f"ns{s % 4}", "cluster_ip": f"10.96.0.{s + 1}",
                    "external_ips": (f"34.0.0.{s}",),
                    "pod_uids": [f"pod-{p}" for p in range(4 * s, 4 * s + 4)]})
        ups.append({"kind": "dns", "ip": f"10.96.0.{s + 1}",
                    "hostname": f"svc{s}.cluster.local"})
    for u in range(40):
        d = {"kind": "process", "upid": U.make_upid(1 + u % 4, 100 + u, 5000 + u),
             "cmdline": f"/bin/app{u}"}
        if u < 32:
            d["pod_uid"] = f"pod-{u * 2}"
            d["container_id"] = f"ctr-{u * 2}"
        ups.append(d)
    return ups


def _epoch_updates(U) -> list[dict]:
    """The epoch change: the 16 pods of UPIDs 16-31 (services 8-15) are
    recreated as pods of service 3 (new pod uids, their processes rebound
    to them), and service 2 is renamed."""
    ups = []
    for u in range(16, 32):
        ups.append({"kind": "pod", "uid": f"moved-{u}", "name": f"moved-{u}",
                    "namespace": "ns3", "node": "node-0", "ip": f"10.2.0.{u}"})
        ups.append({"kind": "process", "upid": U.make_upid(1 + u % 4, 100 + u, 5000 + u),
                    "pod_uid": f"moved-{u}"})
    ups.append({"kind": "service", "uid": "svc-3", "name": "svc3", "namespace": "ns3",
                "cluster_ip": "10.96.0.4",
                "pod_uids": [f"moved-{u}" for u in range(16, 32)]})
    ups.append({"kind": "service", "uid": "svc-2", "name": "renamed", "namespace": "ns2",
                "cluster_ip": "10.96.0.3"})
    return ups


def _managers():
    r = ref_state.MetadataStateManager(asid=3, node_name="node-1")
    r.apply_updates(_updates(RU))
    t = MetadataStateManager(asid=3, node_name="node-1")
    t.apply_updates(_updates(UInt128))
    return r, t


@pytest.fixture
def same_state():
    """The same snapshot in both packages' global managers, restored after."""
    old_r, old_t = ref_state.global_manager(), md_state.global_manager()
    r, t = _managers()
    ref_state.set_global_manager(r)
    md_state.set_global_manager(t)
    try:
        yield r, t
    finally:
        ref_state.set_global_manager(old_r)
        md_state.set_global_manager(old_t)


def _string_inputs() -> list[str]:
    out = ["", "unknown", "a,b", '["ns1/svc1", "x"]', "ns0/svc0,ns1/svc1"]
    for p in (0, 5, 63):
        out += [f"pod-{p}", f"web-{p}", f"ns{(p // 4) % 4}/web-{p}",
                f"10.0.{p // 4}.{p % 4 + 1}", f"ctr-{p}", f"c{p // 4}",
                f"pod-{p}/c{p // 4}"]
    for s in (0, 7):
        out += [f"svc-{s}", f"svc{s}", f"ns{s % 4}/svc{s}", f"10.96.0.{s + 1}"]
    return out + ["10.9.9.9"]


def _upid_inputs(U) -> list:
    return [U.make_upid(1 + u % 4, 100 + u, 5000 + u) for u in (0, 1, 17, 31, 32, 39)] + [
        U.make_upid(9, 9, 9)]


def _args_for(arg_types, U) -> list[tuple]:
    if not arg_types:
        return [()]
    if len(arg_types) == 2:
        return [(a, b) for a in _string_inputs()
                for b in ("ns1/svc1", "svc-0", "x", "")]
    if arg_types[0].name == "UINT128":
        return [(u,) for u in _upid_inputs(U)]
    return [(s,) for s in _string_inputs()]


def test_the_port_has_the_references_52_metadata_names():
    assert len(MD_NAMES) == 52
    assert set(MD_NAMES) <= set(registry.names()["scalar"])


@pytest.mark.parametrize("name", MD_NAMES)
def test_metadata_function_matches_the_reference(name, same_state):
    """Each overload: its types, volatile flag and output semantic type, and
    its value on every input, exactly."""
    ref = [o for n, o in ref_registry.scalar_overloads() if n == name]
    got = [o for n, o in registry.scalar_overloads() if n == name]
    assert len(got) == len(ref)
    for r, t in zip(ref, got):
        assert [a.name for a in t.arg_types] == [a.name for a in r.arg_types]
        assert t.out_type.name == r.out_type.name
        assert t.volatile == r.volatile and t.device == r.device
        assert (t.out_st.name if t.out_st else None) == (r.out_st.name if r.out_st else None)
        r_args, t_args = _args_for(r.arg_types, RU), _args_for(t.arg_types, UInt128)
        for ra, ta in zip(r_args, t_args):
            assert t.fn(*ta) == r.fn(*ra), (name, ta)


#: (name, overload index) of every metadata function, from the reference
MD_OVERLOADS = [(n, i) for n in MD_NAMES
                for i, _o in enumerate(o for m, o in ref_registry.scalar_overloads() if m == n)]


def _md_stores():
    """Both packages' table `m`: time_, a UINT128 `upid` and a STRING `s`
    cycling through the UPID and string inputs."""
    strings = _string_inputs()
    n = 4 * len(strings)
    cols = {"time_": np.arange(n, dtype=np.int64), "s": [strings[i % len(strings)]
                                                        for i in range(n)]}
    rs, ts = RefStore(), TableStore()
    for store, Rel, T, U in ((rs, RRel, RDT, RU), (ts, Relation, DT, UInt128)):
        ups = _upid_inputs(U)
        store.create("m", Rel.of(("time_", T.TIME64NS), ("upid", T.UINT128),
                                 ("s", T.STRING))).write(
            {**cols, "upid": [ups[i % len(ups)] for i in range(n)]})
    return rs, ts


@pytest.mark.parametrize("name,index", MD_OVERLOADS)
def test_metadata_function_through_both_engines(name, index, same_state):
    """px.<name>(...) over a table's UPID or string column (a LUT over the
    dictionary's codes in the port's chain) through each package's
    compile_pxl and executor: the same column, exactly."""
    o = [o for m, o in ref_registry.scalar_overloads() if m == name][index]
    kinds = [t.name for t in o.arg_types]
    args = ("" if not kinds else "df.upid" if kinds == ["UINT128"]
            else "df.s" if kinds == ["STRING"] else "df.s, 'ns1/svc1'")
    src = (f"import px\ndf = px.DataFrame(table='m')\ndf.out = px.{name}({args})\n"
           "px.display(df[['time_', 's', 'out']], 'o')\n")
    rs, ts = _md_stores()
    want = ref_execute(ref_compile(src, rs.schemas()).plan, rs)["o"].to_pandas()
    got = execute_plan(compile_pxl(src, ts.schemas()).plan, ts, device="cpu")["o"].to_pandas()
    assert got["out"].tolist() == want["out"].tolist()
    assert got["time_"].tolist() == want["time_"].tolist()


def test_new_metadata_lookups():
    """tests/test_builtins.py test_new_metadata_lookups, on the port."""
    old = md_state.global_manager()
    m = MetadataStateManager(asid=1, node_name="n1")
    u = UInt128.make_upid(1, 42, 1000)
    m.apply_updates([
        {"kind": "pod", "uid": "p1", "name": "web-0", "namespace": "default",
         "node": "n1", "ip": "10.0.0.1", "phase": "Running",
         "create_time_ns": 5, "stop_time_ns": 9, "qos_class": "Burstable"},
        {"kind": "container", "cid": "c1", "name": "web-ctr", "pod_uid": "p1",
         "start_time_ns": 6, "stop_time_ns": 8},
        {"kind": "service", "uid": "s1", "name": "web", "namespace": "default",
         "cluster_ip": "10.96.0.1", "pod_uids": ["p1"]},
        {"kind": "process", "upid": u, "pod_uid": "p1", "container_id": "c1"},
    ])
    md_state.set_global_manager(m)
    try:
        def call(name, *args, types=(DT.STRING,)):
            return registry.scalar(name, types).fn(*args)

        assert call("upid_to_pod_status", u, types=(DT.UINT128,)) == "Running"
        assert call("upid_to_pod_qos", u, types=(DT.UINT128,)) == "Burstable"
        assert call("upid_to_hostname", u, types=(DT.UINT128,)) == "n1"
        assert call("pod_id_to_start_time", "p1") == 5
        assert call("pod_id_to_stop_time", "p1") == 9
        assert call("pod_name_to_stop_time", "default/web-0") == 9
        assert call("pod_id_to_service_id", "p1") == "s1"
        assert call("pod_name_to_service_id", "default/web-0") == "s1"
        assert call("service_id_to_cluster_ip", "s1") == "10.96.0.1"
        assert call("service_name_to_namespace", "default/web") == "default"
        assert call("container_name_to_container_id", "web-ctr") == "c1"
        assert call("container_id_to_start_time", "c1") == 6
        assert call("container_name_to_stop_time", "web-ctr") == 8
        assert call("asid", types=()) == 1 and call("_exec_hostname", types=()) == "n1"
    finally:
        md_state.set_global_manager(old)


def test_ctx_keys_are_the_references():
    from pixie_tpu.metadata.funcs import CTX_KEYS as REF_KEYS
    from pixie_tpu_torch.compiler import pxl

    assert CTX_KEYS == REF_KEYS
    assert pxl.CTX_KEYS is CTX_KEYS  # one copy: the compiler's is metadata's


@pytest.mark.parametrize("first", ["pixie_tpu_torch.metadata", "pixie_tpu_torch.metadata.funcs",
                                   "pixie_tpu_torch.udf.udf", "pixie_tpu_torch.udf.udtf",
                                   "pixie_tpu_torch.compiler", "pixie_tpu_torch.collect",
                                   "pixie_tpu_torch.engine.executor"])
def test_every_import_route_sees_all_names(first):
    """Whatever is imported first, the registry holds the reference's 135
    scalar names and 8 UDTFs, with no import cycle."""
    code = (f"import importlib\nimportlib.import_module({first!r})\n"
            "from pixie_tpu_torch.udf import registry\n"
            "n = registry.names()\n"
            "print(len(n['scalar']), len(n['udtf']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(ref_registry.names()["scalar"])),
                                  str(len(ref_registry.names()["udtf"]))] == ["135", "8"]


# ------------------------------------------------------------ the ctx query
N_ROWS = 6000

CTX_SCRIPT = """
import px
df = px.DataFrame(table='http_events')
df = df[df.resp_status != 404]
df.service = df.ctx['service']
df.namespace = df.ctx['namespace']
df = df.groupby(['service', 'resp_status']).agg(
    cnt=('latency', px.count), total=('latency', px.sum),
    avg_lat=('latency', px.mean), p50=('latency', px.p50))
px.display(df, 'output')
"""


def _http_columns(U, seed=7) -> dict:
    """The canonical http_events relation's 18 columns: UPIDs over the 40
    of _updates plus unknown ones, status 200/404/500 at .85/.05/.10,
    latency int64 ns exponential(50 ms)."""
    rng = np.random.default_rng(seed)
    n = N_ROWS
    up = rng.integers(0, 44, n)
    return {
        "time_": np.arange(n, dtype=np.int64) * 1000,
        "upid": [U.make_upid(1 + u % 4, 100 + u, 5000 + u) for u in up],
        "remote_addr": [f"10.1.0.{i % 7}" for i in range(n)],
        "remote_port": rng.integers(1, 65535, n),
        "trace_role": np.full(n, 2, dtype=np.int64),
        "major_version": np.ones(n, dtype=np.int64),
        "minor_version": np.ones(n, dtype=np.int64),
        "content_type": np.zeros(n, dtype=np.int64),
        "req_headers": ["{}"] * n,
        "req_method": [("GET", "POST")[i % 2] for i in range(n)],
        "req_path": [f"/api/{i % 5}" for i in range(n)],
        "req_body": [""] * n,
        "req_body_size": rng.integers(0, 4096, n),
        "resp_headers": ["{}"] * n,
        "resp_status": rng.choice(np.array([200, 404, 500]), n, p=[0.85, 0.05, 0.10]),
        "resp_message": ["OK"] * n,
        "resp_body": [""] * n,
        "resp_body_size": rng.integers(0, 4096, n),
        "latency": (rng.exponential(50e6, n)).astype(np.int64),
    }


def _stores():
    from pixie_tpu.collect.schemas import SCHEMAS as REF_SCHEMAS
    from pixie_tpu_torch.collect.schemas import SCHEMAS

    rs, ts = RefStore(), TableStore()
    rs.create("http_events", REF_SCHEMAS["http_events"]).write(_http_columns(RU))
    ts.create("http_events", SCHEMAS["http_events"]).write(_http_columns(UInt128))
    return rs, ts


def _frame(res, keys):
    return res.to_pandas().sort_values(keys).reset_index(drop=True)


def _same(got, want, keys):
    g, w = _frame(got, keys), _frame(want, keys)
    assert list(g.columns) == list(w.columns)
    for k in keys:
        assert g[k].tolist() == w[k].tolist()
    assert g["cnt"].tolist() == w["cnt"].tolist()
    assert g["total"].tolist() == w["total"].tolist()
    np.testing.assert_allclose(g["avg_lat"], w["avg_lat"], rtol=1e-12, atol=0)
    # the same sketch bin's value, to the ulp that XLA's pow and libm's may
    # differ by
    np.testing.assert_allclose(g["p50"], w["p50"], rtol=1e-12, atol=0)
    return g


def _epoch_change(r, t):
    r.apply_updates(_epoch_updates(RU))
    t.apply_updates(_epoch_updates(UInt128))


def test_ctx_query_equals_the_reference_across_an_epoch(same_state):
    r, t = same_state
    rs, ts = _stores()
    keys = ["service", "resp_status"]
    want = ref_execute(ref_compile(CTX_SCRIPT, rs.schemas()).plan, rs)["output"]
    q = compile_pxl(CTX_SCRIPT, ts.schemas())
    first = execute_plan(q.plan, ts, device="cpu")["output"]
    before = _same(first, want, keys)
    assert "" in before["service"].tolist()  # UPIDs with no pod
    warm = execute_plan(q.plan, ts, device="cpu")["output"]
    _same(warm, want, keys)
    epoch = t.epoch
    _epoch_change(r, t)
    assert t.epoch == epoch + 1
    want2 = ref_execute(ref_compile(CTX_SCRIPT, rs.schemas()).plan, rs)["output"]
    after = _same(execute_plan(q.plan, ts, device="cpu")["output"], want2, keys)
    assert "ns2/renamed" in after["service"].tolist()
    assert "ns2/svc2" not in after["service"].tolist()
    assert after["service"].tolist() != before["service"].tolist()


def test_metadata_map_of_every_output_type(same_state):
    """A select that calls metadata functions of each output type (STRING,
    INT64, TIME64NS, BOOLEAN) over a UINT128 and a STRING column."""
    rs, ts = _stores()
    src = """
import px
df = px.DataFrame(table='http_events', select=['time_', 'upid', 'remote_addr'])
df.pod = px.upid_to_pod_name(df.upid)
df.node = df.ctx['node']
df.pid = px.upid_to_pid(df.upid)
df.asid2 = px.upid_to_asid(df.upid)
df.cmd = px.upid_to_cmdline(df.upid)
df.started = px.pod_name_to_start_time(df.pod)
df.has_svc = px.has_service_name(px.upid_to_service_name(df.upid))
df.host = px.nslookup(df.remote_addr)
df.here = px.asid()
df = df.head(500)
px.display(df, 'o')
"""
    want = ref_execute(ref_compile(src, rs.schemas()).plan, rs)["o"].to_pandas()
    got = execute_plan(compile_pxl(src, ts.schemas()).plan, ts, device="cpu")["o"].to_pandas()
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        if c == "upid":
            assert [str(v) for v in got[c]] == [str(v) for v in want[c]]
        else:
            assert got[c].tolist() == want[c].tolist(), c


def test_epoch_change_misses_every_cache_on_each_route(same_state):
    """After a new epoch a warm query returns the new grouping on the card
    route (one feed: F1, through its cached plan and launch) and through
    LocalCluster, whose plan and split caches still hit (they hold no LUT:
    each query builds its LUTs anew); the registry's uid is unchanged.  The
    CPU route (np_partial, the whole-plan loop whose programs
    plancache.native_programs caches) declines a computed key, as the
    reference's does, so a metadata chain never reaches those caches."""
    from pixie_tpu_torch.parallel import LocalCluster

    r, t = same_state
    rs, ts = _stores()
    keys = ["service", "resp_status"]
    uid = registry.uid
    q = compile_pxl(CTX_SCRIPT, ts.schemas())
    flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    cluster = LocalCluster({"pem0": ts}, device="cpu")

    def runs():
        return {
            "card": execute_plan(q.plan, ts, device="cpu", force_backend="device")["output"],
            "cpu": execute_plan(q.plan, ts, device="cpu", force_backend="cpu")["output"],
            "cluster": cluster.query(CTX_SCRIPT)["output"],
        }

    try:
        want = ref_execute(ref_compile(CTX_SCRIPT, rs.schemas()).plan, rs)["output"]
        for _ in range(2):  # cold, then warm
            for res in runs().values():
                _same(res, want, keys)
        _epoch_change(r, t)
        want2 = ref_execute(ref_compile(CTX_SCRIPT, rs.schemas()).plan, rs)["output"]
        got = runs()
        for res in got.values():
            _same(res, want2, keys)
        assert [r["route"] for r in got["cpu"].exec_stats["routes"]] == ["device"]
        assert got["card"].exec_stats.get("fused_single_feed")
        prof = got["cluster"].exec_stats["profile"]
        assert prof["plan_cache_hit"] == 1 and prof["split_cache_hit"] == 1
        assert registry.uid == uid
    finally:
        flags.set_for_testing("PL_MATVIEW_ENABLED", True)


def test_px_context_helpers(same_state):
    _r, t = same_state
    ts = TableStore()
    ts.create("t", Relation.of(("time_", DT.TIME64NS), ("v", DT.INT64))).write(
        {"time_": np.arange(3, dtype=np.int64), "v": np.arange(3, dtype=np.int64)})
    src = """
import px
df = px.DataFrame(table='t')
df.a = px.asid()
df.n = px.node_name()
df.h = px._exec_hostname()
px.display(df, 'o')
"""
    got = execute_plan(compile_pxl(src, ts.schemas()).plan, ts, device="cpu")["o"].to_pandas()
    assert got["a"].tolist() == [3] * 3
    assert got["n"].tolist() == ["node-1"] * 3 and got["h"].tolist() == ["node-1"] * 3


# ------------------------------------------- tests/test_metadata_live.py's cases
class TestProcScanner:
    def test_own_pid_start_time(self):
        import time

        start = pid_start_time_ns(os.getpid())
        assert 1_500_000_000 * 10**9 < start < time.time_ns()

    def test_own_cmdline(self):
        assert "python" in pid_cmdline(os.getpid())

    def test_scan_binds_live_pids(self):
        mgr = MetadataStateManager(asid=7)
        sc = ProcScanner(asid=7)
        assert sc.scan_into(mgr) >= 1  # at least this process
        assert "python" in mgr.current().upid_to_cmdline.get(sc.upid_of(os.getpid()), "")

    def test_classifier_binds_pod(self):
        mgr = MetadataStateManager(asid=7)
        me = os.getpid()
        sc = ProcScanner(asid=7, classifier=lambda pid, cmd: "pod-uid-x" if pid == me else None)
        mgr.apply_updates([{"kind": "pod", "uid": "pod-uid-x", "name": "self",
                            "namespace": "test", "ip": "127.0.0.1"}])
        sc.scan_into(mgr)
        pod = mgr.current().pod_of_upid(sc.upid_of(me))
        assert pod is not None and pod.qualified_name == "test/self"

    def test_same_upid_as_the_reference(self):
        from pixie_tpu.metadata.proc_scanner import ProcScanner as RefScanner

        me = os.getpid()
        got, want = ProcScanner(asid=5).upid_of(me), RefScanner(asid=5).upid_of(me)
        assert (got.high, got.low) == (want.high, want.low)

    def test_rescan_without_change_applies_nothing(self):
        """Idle periodic scans must not bump the metadata epoch."""
        mgr = MetadataStateManager(asid=7)
        sc = ProcScanner(asid=7)
        assert sc.scan_into(mgr) >= 1
        assert sc.scan_into(mgr) <= 5  # only processes new since the first scan
        assert "python" in mgr.current().upid_to_cmdline.get(sc.upid_of(os.getpid()), "")


class TestWatchFeed:
    def test_jsonl_tail(self, tmp_path):
        mgr = MetadataStateManager(asid=1)
        path = tmp_path / "updates.jsonl"
        path.write_text("")
        feed = ResourceUpdateFeed(mgr, str(path))
        assert feed.poll() == 0
        with open(path, "a") as f:
            f.write(json.dumps({"kind": "pod", "uid": "u1", "name": "a",
                                "namespace": "ns", "ip": "10.1.2.3"}) + "\n")
        assert feed.poll() == 1
        assert mgr.current().pod_of_ip("10.1.2.3").name == "a"
        with open(path, "a") as f:  # a partial line waits for its newline
            f.write('{"kind": "dns", "ip": "10.9.9.9",')
        assert feed.poll() == 0
        with open(path, "a") as f:
            f.write(' "hostname": "db.internal"}\n')
        assert feed.poll() == 1
        assert mgr.current().nslookup("10.9.9.9") == "db.internal"

    def test_process_upid_wire_form(self, tmp_path):
        mgr = MetadataStateManager(asid=1)
        path = tmp_path / "u.jsonl"
        u = UInt128.make_upid(1, 42, 1234)
        path.write_text(json.dumps({"kind": "process", "upid": [u.high, u.low],
                                    "cmdline": "/bin/thing"}) + "\n")
        feed = ResourceUpdateFeed(mgr, str(path))
        assert feed.poll() == 1
        assert mgr.current().upid_to_cmdline[u] == "/bin/thing"
        apply_updates_json(mgr, [{"kind": "process", "upid": [u.high, u.low],
                                  "cmdline": "/bin/other"}])
        assert mgr.current().upid_to_cmdline[u] == "/bin/other" and mgr.epoch == 2

    def test_bad_line_does_not_lose_batch(self, tmp_path):
        mgr = MetadataStateManager(asid=1)
        path = tmp_path / "u.jsonl"
        with open(path, "w") as f:
            f.write(json.dumps({"kind": "pod", "uid": "a", "name": "a",
                                "namespace": "n", "ip": "10.0.0.1"}) + "\n")
            f.write('{"kind": "not-a-kind"}\n')
            f.write("[1, 2, 3]\n")  # non-dict JSON
            f.write(json.dumps({"kind": "pod", "uid": "b", "name": "b",
                                "namespace": "n", "ip": "10.0.0.2"}) + "\n")
        feed = ResourceUpdateFeed(mgr, str(path))
        assert feed.poll() == 2 and feed.errors == 2
        snap = mgr.current()
        assert snap.pod_of_ip("10.0.0.1") and snap.pod_of_ip("10.0.0.2")

    def test_same_state_as_the_reference_feed(self, tmp_path):
        from pixie_tpu.metadata.watch import ResourceUpdateFeed as RefFeed

        path = tmp_path / "k8s.jsonl"
        with open(path, "w") as f:
            for u in _updates(UInt128):
                if u["kind"] == "process":
                    u = {**u, "upid": [u["upid"].high, u["upid"].low]}
                f.write(json.dumps(u) + "\n")
        mine, ref = MetadataStateManager(asid=1), ref_state.MetadataStateManager(asid=1)
        assert ResourceUpdateFeed(mine, str(path)).poll() == RefFeed(ref, str(path)).poll()
        a, b = mine.current(), ref.current()
        assert a.pods_by_uid.keys() == b.pods_by_uid.keys()
        assert {str(k): v for k, v in a.upid_to_pod_uid.items()} == {
            str(k): v for k, v in b.upid_to_pod_uid.items()}
        assert a.pod_uid_to_service_uids == b.pod_uid_to_service_uids
        assert a.dns == b.dns and mine.epoch == ref.epoch
