"""The flight recorder: pixie_tpu_torch.observe and serving.slo against the
reference's.

Both packages' LocalClusters run the same queries over stores written from
the same numpy seeds, with tracing on (PL_TRACING_ENABLED, the default), the
card route pinned in both (PX_CPU_CROSSOVER_ROWS 0; the port's CPU device
runs the kernels' plain versions) and standing views off.  Each query's
profile row equals the reference's key by key, except:

  * the timers (time_, wall_ns and the phase ns) and the random query_id;
  * h2d_bytes, a known bounded difference (ROADMAP, known differences,
    resident tier and views): the port counts the rows it copies, the
    reference its padded power-of-two buffers, so the port's count is at
    most the reference's and at least half of it.

The op_stats rows agree on (agent, op, rows_out); the self_telemetry tables
have the reference's relations (semantic types included) and receive the
same rows; the EXPLAIN ANALYZE text has the reference's sections, operator
rows and provenance lines, plus one line saying how the port timed its
operators.  `sample_metrics_rows` folds the same registry contents into the
same rows, the SLO monitor fires and resolves the same alerts at the same
explicit clock, and a query's results are bit-identical with tracing off.
"""
from __future__ import annotations

import re

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu import metrics as ref_metrics
from pixie_tpu import observe as ref_observe
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.serving import slo as ref_slo
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation

import pixie_tpu_torch.matview  # noqa: F401
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch import metrics as port_metrics
from pixie_tpu_torch import observe
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.serving import slo
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.types import DataType as DT, Relation

NOW = 1_700_000_000_000_000_000
TIMERS = {"time_", "query_id", "wall_ns", "admission_wait_ns", "compile_ns",
          "plan_split_ns", "exec_ns", "merge_ns", "accounted_ns"}

SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service', 'status']).agg(n=('latency', px.count),
                                           m=('latency', px.mean))
px.display(df, 'out')
"""

SELECT = """
df = px.DataFrame(table='http_events')
df = df[df.status == 500]
df = df[['service', 'latency']]
px.display(df, 'out')
"""


@pytest.fixture(autouse=True)
def _flags():
    names = ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED", "PX_CPU_CROSSOVER_ROWS",
             "PL_SLO", "PX_AUTOTUNE")
    saved = [(f, n, f.get(n)) for f in (ref_flags, port_flags) for n in names]
    for f in (ref_flags, port_flags):
        f.set_for_testing("PL_MATVIEW_ENABLED", False)
        f.set_for_testing("PL_TRACING_ENABLED", True)
        f.set_for_testing("PX_CPU_CROSSOVER_ROWS", 0)
        f.set_for_testing("PX_AUTOTUNE", False)
    yield
    for f, n, v in saved:
        f.set_for_testing(n, v)
    ref_slo.reset_for_testing()
    slo.reset_for_testing()


def _store(pkg, seed, n=5000):
    store_cls, rel_cls, dt = ((RefStore, RefRelation, RefDT) if pkg == "ref"
                              else (TableStore, Relation, DT))
    rng = np.random.default_rng(seed)
    ts = store_cls()
    ts.create("http_events", rel_cls.of(
        ("time_", dt.TIME64NS), ("service", dt.STRING), ("latency", dt.FLOAT64),
        ("status", dt.INT64)), batch_rows=1024).write({
            "time_": NOW - np.arange(n, dtype=np.int64)[::-1] * 1_000_000,
            "service": rng.choice(["a", "b", "c"], n).tolist(),
            "latency": rng.exponential(10.0, n),
            "status": rng.choice([200, 404, 500], n)})
    return ts


def _clusters(agents=3):
    ref = RefCluster({f"pem{i}": _store("ref", i) for i in range(agents)},
                     n_devices_per_agent=1)
    port = LocalCluster({f"pem{i}": _store("port", i) for i in range(agents)}, device="cpu")
    return ref, port


def _profiles(script=SCRIPT, runs=2, **kw):
    ref, port = _clusters()
    out = []
    for _ in range(runs):
        r = ref.query(script, **kw)["out"]
        p = port.query(script, **kw)["out"]
        out.append((r, p))
    return ref, port, out


@pytest.mark.parametrize("script", ["agg", "select"])
def test_profile_rows_equal_the_references_key_by_key(script):
    _ref, _port, runs = _profiles(SCRIPT if script == "agg" else SELECT)
    for i, (r, p) in enumerate(runs):
        rp, pp = r.exec_stats["profile"], p.exec_stats["profile"]
        assert set(pp) == set(rp)
        diff = {k: (rp[k], pp[k]) for k in rp if k not in TIMERS and rp[k] != pp[k]}
        h2d = diff.pop("h2d_bytes", None)
        assert diff == {}, (i, diff)
        if h2d is not None:  # rows copied against padded buffers
            ref_b, port_b = h2d
            assert ref_b / 2 <= port_b <= ref_b, (i, h2d)
        assert pp["plan_cache_hit"] == pp["split_cache_hit"] == int(i > 0)
        assert pp["rows_scanned"] == 15_000 and pp["agents"] == 3
        for k in TIMERS - {"query_id"}:
            assert isinstance(pp[k], int) and pp[k] >= 0, k


def test_op_stats_rows_agree():
    _ref, _port, runs = _profiles()
    for r, p in runs:
        rows = {}
        for name, res in (("ref", r), ("port", p)):
            _prof, op_rows = (ref_observe if name == "ref" else observe).build_profile(
                "q", "", "cluster", 0, 1, {
                    "agents": res.exec_stats["agents"],
                    "merger": {"operators": res.exec_stats["operators"],
                               "rows_output": res.exec_stats["rows_output"]}})
            rows[name] = sorted((o["agent"], o["op"], o["rows_out"]) for o in op_rows)
        assert rows["port"] == rows["ref"]
        assert any(op.endswith("partial_agg") for _a, op, _n in rows["port"])


def test_self_telemetry_tables_have_the_references_relations():
    assert set(observe.SELF_TABLES) == set(ref_observe.SELF_TABLES)
    for name, rel in observe.SELF_TABLES.items():
        want = ref_observe.SELF_TABLES[name]
        assert [(c.name, c.data_type.name, c.semantic_type.name) for c in rel] == \
            [(c.name, c.data_type.name, c.semantic_type.name) for c in want], name


def test_flushed_telemetry_lands_through_the_write_path():
    ref, port, runs = _profiles(runs=3)
    counts = {}
    for name, c in (("ref", ref), ("port", port)):
        c.flush_telemetry()
        store = c.stores["pem0"]
        counts[name] = {t: store.table(t).stats()["rows_written"]
                        for t in (observe.PROFILES_TABLE, observe.OP_STATS_TABLE)}
    assert counts["port"] == counts["ref"]
    assert counts["port"][observe.PROFILES_TABLE] == 3
    # the telemetry is queryable data: a PxL query over the profiles table
    got = port.query("df = px.DataFrame(table='self_telemetry.query_profiles')\n"
                     "df = df.groupby('status').agg(n=('rows_scanned', px.count),\n"
                     "    rows=('rows_scanned', px.sum))\npx.display(df, 'out')\n")
    df = got["out"].to_pandas()
    assert df["status"].tolist() == ["ok"] and df["rows"].tolist() == [45_000]


def test_explain_text_has_the_references_structure():
    _ref, _port, runs = _profiles(runs=1, explain=True)
    r, p = runs[0]
    rt, pt = r.exec_stats["explain"], p.exec_stats["explain"]

    def skeleton(text):
        keep = []
        for line in text.splitlines():
            if line.startswith(("==", "-- ")):
                # the io line's h2d count is the bounded difference above
                keep.append(re.sub(r"h2d \d+B", "h2d ?B", line.split("(")[0].strip()))
            elif line.startswith("  ") and line.split()[0] in ("pem0", "pem1", "pem2",
                                                                 "merger"):
                parts = line.split()
                keep.append((parts[0], parts[1], parts[-1]))  # agent, op, rows
        return keep

    assert skeleton(pt) == skeleton(rt)
    assert "  timing: host wall time (CPU device" in pt
    assert "timing:" not in rt
    plan_r = rt.split("-- phases")[0]
    plan_p = pt.split("-- phases")[0]
    assert plan_p == plan_r
    prov = [ln for ln in pt.split("-- provenance:")[1].splitlines()
            if ln.startswith("  ") and "resident tier" not in ln]
    prov_r = [ln for ln in rt.split("-- provenance:")[1].splitlines()
              if ln.startswith("  ") and "resident tier" not in ln]
    assert prov == prov_r


def test_explain_works_with_tracing_off_and_records_nothing():
    for f in (ref_flags, port_flags):
        f.set_for_testing("PL_TRACING_ENABLED", False)
    port = LocalCluster({"pem0": _store("port", 0)}, device="cpu")
    res = port.query(SCRIPT, explain=True)["out"]
    assert res.exec_stats["explain"].startswith("== EXPLAIN ANALYZE ==")
    assert not port.stores["pem0"].has(observe.PROFILES_TABLE)
    assert port.flush_telemetry() == 0


def test_results_bit_identical_with_tracing_off():
    out = {}
    for on in (True, False):
        port_flags.set_for_testing("PL_TRACING_ENABLED", on)
        port = LocalCluster({f"pem{i}": _store("port", i) for i in range(3)}, device="cpu")
        res = port.query(SCRIPT)["out"]
        out[on] = res
        assert ("profile" in res.exec_stats) == on
        assert port.stores["pem0"].has(observe.PROFILES_TABLE) == on
    df_on, df_off = (out[k].to_pandas().sort_values(["service", "status"]) for k in (True, False))
    for c in df_on.columns:
        a, b = df_on[c].to_numpy(), df_off[c].to_numpy()
        if a.dtype.kind == "f":
            assert a.tobytes() == b.tobytes(), c
        else:
            assert a.tolist() == b.tolist(), c


def test_a_failed_query_records_an_error_profile():
    port = LocalCluster({"pem0": _store("port", 0)}, device="cpu")
    with pytest.raises(Exception):
        port.query("df = px.DataFrame(table='no_such_table')\npx.display(df, 'out')\n")
    port.flush_telemetry()
    t = port.stores["pem0"].table(observe.PROFILES_TABLE)
    rows = port.query("df = px.DataFrame(table='self_telemetry.query_profiles')\n"
                      "px.display(df[['status', 'error']], 'out')\n")["out"].to_pandas()
    assert t.stats()["rows_written"] >= 1
    assert "error" in rows["status"].tolist()


def test_sample_metrics_rows_equal_the_references():
    name = "px_test_observe_parity"
    rows = {}
    for pkg, m, obs in (("ref", ref_metrics, ref_observe), ("port", port_metrics, observe)):
        m.counter_inc(f"{name}_total", 3.0, labels={"k": "v"}, help_="t")
        m.gauge_set(f"{name}_gauge", 2.5, help_="t")
        for v in (0.001, 0.02, 0.3):
            m.histogram_observe(f"{name}_seconds", v, (0.01, 0.1, 1.0), help_="t")
        got = obs.sample_metrics_rows("svc", now_ns=123)
        rows[pkg] = sorted((r["name"], r["labels"], r["kind"], r["value"], r["time_"],
                            r["service"]) for r in got if r["name"].startswith(name))
    assert rows["port"] == rows["ref"]
    assert len(rows["port"]) >= 4


def test_row_buffer_is_bounded_and_counts_drops():
    out = {}
    for pkg, obs in (("ref", ref_observe), ("port", observe)):
        buf = obs.RowBuffer(flush_rows=4, max_rows=5)
        buf.add(obs.ALERTS_TABLE, [{"slo": str(i)} for i in range(8)])
        out[pkg] = (len(buf), buf.dropped)
    assert out["port"] == out["ref"] == (5, 3)


def test_slo_alerts_fire_and_resolve_as_the_references():
    """Same observations at the same explicit clock → the same burn rates
    and the same firing/resolved alert rows, in both packages."""
    spec = "interactive:latency<500ms@99;availability:errors@99.9"
    logs = {}
    for pkg, mod in (("ref", ref_slo), ("port", slo)):
        mon = mod.SLOMonitor(spec, fast_s=60.0, slow_s=600.0)
        t0 = 1_000_000.0
        rows = []
        for i in range(200):  # a burst of slow and failed queries
            mon.record("t1", 0.9 if i % 3 else 0.1, ok=i % 7 != 0, now=t0 + i * 0.1)
        rows += mon.evaluate(now=t0 + 20)
        rates = sorted((k, round(v, 9)) for k, v in mon.burn_rates(now=t0 + 20).items())
        for i in range(2000):  # recovery: fast, healthy traffic
            mon.record("t1", 0.01, ok=True, now=t0 + 700 + i * 0.05)
        rows += mon.evaluate(now=t0 + 800)
        logs[pkg] = (rows, rates, [(s.name, s.kind, s.threshold_s, s.objective)
                                   for s in mon.slos])
    assert logs["port"] == logs["ref"]
    states = [r["state"] for r in logs["port"][0]]
    assert "firing" in states and "resolved" in states


def test_cluster_queries_feed_slo_alerts_into_the_telemetry_store():
    port_flags.set_for_testing("PL_SLO", "strict:latency<0ms@99.9")
    slo.reset_for_testing()
    port = LocalCluster({"pem0": _store("port", 0)}, device="cpu")
    port.query(SCRIPT)
    port.flush_telemetry()
    t = port.stores["pem0"].table(observe.ALERTS_TABLE)
    assert t.stats()["rows_written"] >= 1
    got = port.query("df = px.DataFrame(table='self_telemetry.alerts')\n"
                     "px.display(df[['slo', 'state', 'window']], 'out')\n")["out"].to_pandas()
    assert set(got["slo"]) == {"strict"} and "firing" in set(got["state"])


def test_explain_local_renders_one_executor():
    from pixie_tpu_torch.compiler import compile_pxl
    from pixie_tpu_torch.engine.executor import PlanExecutor

    ts = _store("port", 0)
    q = compile_pxl(SCRIPT, ts.schemas(), now=NOW)
    ex = PlanExecutor(q.plan, ts, device="cpu")
    ex.run()
    text = observe.explain_local(q.plan, ex.stats, 1_000_000, op_timing="host")
    assert "scan(http_events)->filter->partial_agg" in text
    assert "-- io: scanned 5000 rows on 1 agents" in text
