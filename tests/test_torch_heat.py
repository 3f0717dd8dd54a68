"""Shard heat: pixie_tpu_torch.table.heat against pixie_tpu.table.heat.

The model's math is replayed at explicit `now_ns` in both packages (the
same bumps, the same decay trajectory, the same folded rows, skew and
top_shards).  Then both packages' executors scan the same stores written
from the same numpy seeds (card route pinned, views off, tracing on) and
their models must hold the same cells: (table, shard, tier, age bucket)
with the same rows and bytes.  The tier labels (`resident`, `hbm_cache`,
`stream`, `cold`) are data the cells are keyed by, so they are compared
as data.  Heat's rows summed over the cells equal the rows the queries
scanned, `storage_state_rows` folds each store's holdings as the
reference's does, and with tracing off the model is never touched.
"""
from __future__ import annotations

import itertools
import time

import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview  # noqa: F401
import pixie_tpu.trace  # noqa: F401
from pixie_tpu import flags as ref_flags
from pixie_tpu.compiler import compile_pxl as ref_compile
from pixie_tpu.engine import execute_plan as ref_execute
from pixie_tpu.engine import resident as ref_resident
from pixie_tpu.engine.executor import clear_device_cache as ref_clear_cache
from pixie_tpu.parallel import LocalCluster as RefCluster
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.table import heat as ref_heat
from pixie_tpu.types import DataType as RefDT, Relation as RefRelation

import pixie_tpu_torch.matview  # noqa: F401
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch import observe
from pixie_tpu_torch.compiler import compile_pxl
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.engine import resident as port_resident
from pixie_tpu_torch.engine.executor import clear_device_cache as port_clear_cache
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.table import heat
from pixie_tpu_torch.types import DataType as DT, Relation

SEC = 1_000_000_000
T0 = 1_700_000_000 * SEC

SCRIPT = """
df = px.DataFrame(table='http_events')
df = df[df.status != 404]
df = df.groupby(['service']).agg(n=('latency', px.count), m=('latency', px.max))
px.display(df, 'out')
"""


@pytest.fixture(autouse=True)
def _clean():
    names = ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED", "PX_CPU_CROSSOVER_ROWS",
             "PL_HEAT_HALF_LIFE_S")
    saved = [(f, n, f.get(n)) for f in (ref_flags, port_flags) for n in names]
    for f in (ref_flags, port_flags):
        f.set_for_testing("PL_MATVIEW_ENABLED", False)
        f.set_for_testing("PL_TRACING_ENABLED", True)
        f.set_for_testing("PX_CPU_CROSSOVER_ROWS", 0)
    for mod in (ref_heat, heat):
        mod.reset_for_testing()
    for clear in (ref_resident.clear_for_testing, port_resident.clear_for_testing,
                  ref_clear_cache, port_clear_cache):
        clear()
    yield
    for f, n, v in saved:
        f.set_for_testing(n, v)
    for mod in (ref_heat, heat):
        mod.reset_for_testing()


# ------------------------------------------------------------ model math


def _replay(mod, half_life):
    m = mod.HeatModel()
    for i in range(40):
        shard = f"pem{i % 3}"
        m.record_feed("http_events", shard, 1000 + 37 * i, 8 * (1000 + 37 * i),
                      tier=("resident", "stream", "hbm_cache", "cold")[i % 4],
                      bucket=mod.age_bucket(i * 97.0), now_ns=T0 + i * 13 * SEC)
    out = []
    for dt in (0, 60, 600, 3600):
        now = T0 + (40 * 13 + dt) * SEC
        out.append((m.snapshot_rows(now), sorted(m.skew(now).items()),
                    m.top_shards(2, now), sorted(m.shard_heat(now).items())))
    return out


@pytest.mark.parametrize("half_life", [600.0, 30.0, 0.0])
def test_decay_trajectory_equals_the_references(half_life):
    for f in (ref_flags, port_flags):
        f.set_for_testing("PL_HEAT_HALF_LIFE_S", half_life)
    got, want = _replay(heat, half_life), _replay(ref_heat, half_life)
    assert got == want
    rows = got[0][0]
    assert {r["tier"] for r in rows} == {"resident", "stream", "hbm_cache", "cold"}
    if half_life > 0:  # an hour later every cell has decayed
        assert all(a["heat"] > b["heat"] for a, b in zip(got[0][0], got[3][0]))


@pytest.mark.parametrize("age", [None, 0.0, 59.9, 60.0, 599.0, 3599.0, 86399.0, 86400.0, 1e9])
def test_age_buckets_equal_the_references(age):
    assert heat.age_bucket(age) == ref_heat.age_bucket(age)
    assert heat.AGE_BUCKETS == ref_heat.AGE_BUCKETS


# ------------------------------------------------------- executor cells


def _store(pkg, seed, n=6000, batch_rows=1024, t0=None):
    store_cls, rel_cls, dt = ((RefStore, RefRelation, RefDT) if pkg == "ref"
                              else (TableStore, Relation, DT))
    rng = np.random.default_rng(seed)
    ts = store_cls()
    t0 = T0 if t0 is None else t0
    ts.create("http_events", rel_cls.of(
        ("time_", dt.TIME64NS), ("service", dt.STRING), ("latency", dt.FLOAT64),
        ("status", dt.INT64)), batch_rows=batch_rows).write({
            "time_": t0 + np.arange(n, dtype=np.int64) * 1_000_000,
            "service": rng.choice(["a", "b", "c"], n).tolist(),
            "latency": rng.exponential(10.0, n),
            "status": rng.choice([200, 404, 500], n)})
    return ts


def _cells(mod):
    return sorted((r["table_name"], r["shard"], r["tier"], r["age_bucket"],
                   r["rows_scanned"], r["bytes"]) for r in mod.snapshot_rows())


def _run_plan(pkg, ts, runs):
    for _ in range(runs):
        if pkg == "ref":
            ref_execute(ref_compile(SCRIPT, ts.schemas()).plan, ts)
        else:
            execute_plan(compile_pxl(SCRIPT, ts.schemas()).plan, ts, device="cpu")


@pytest.mark.parametrize("runs", [1, 3])
def test_executor_feeds_bump_the_same_cells(runs):
    """execute_plan: sealed feeds through the resident tier, the hot
    remainder streamed — the same (tier, bucket) cells with the same rows
    and bytes."""
    for pkg, mod in (("ref", ref_heat), ("port", heat)):
        _run_plan(pkg, _store(pkg, 1), runs)
    got, want = _cells(heat), _cells(ref_heat)
    assert got == want
    assert sum(c[4] for c in got) == 6000 * runs
    assert {"resident", "stream"} <= {c[2] for c in got}


def test_feed_cache_tier_when_the_resident_tier_is_off():
    """With the resident tier off, a warm sealed feed is served from the
    device feed cache: the `hbm_cache` tier, in both packages."""
    saved = [(f, f.get("PL_HBM_RESIDENT")) for f in (ref_flags, port_flags)]
    for f, _v in saved:
        f.set_for_testing("PL_HBM_RESIDENT", False)
    try:
        for pkg, mod in (("ref", ref_heat), ("port", heat)):
            _run_plan(pkg, _store(pkg, 2), 2)
    finally:
        for f, v in saved:
            f.set_for_testing("PL_HBM_RESIDENT", v)
    got = _cells(heat)
    assert got == _cells(ref_heat)
    assert {c[2] for c in got} == {"stream", "hbm_cache"}


def test_cluster_heat_is_per_shard_and_sums_to_the_rows_scanned():
    """LocalCluster stamps each agent store's node_name: heat cells are per
    shard, and their rows sum to the rows the query scanned.  The top
    shards are one set in both packages; their order is held only where two
    heats differ by more than the decay since the first query (the three
    shards' heats tie within that)."""
    t0 = time.monotonic_ns()
    clusters = {
        "ref": RefCluster({f"pem{i}": _store("ref", i) for i in range(3)},
                          n_devices_per_agent=1),
        "port": LocalCluster({f"pem{i}": _store("port", i) for i in range(3)}, device="cpu"),
    }
    scanned = {}
    for pkg, c in clusters.items():
        res = c.query(SCRIPT)["out"]
        scanned[pkg] = sum(s["rows_scanned"] for s in res.exec_stats["agents"].values())
    got = _cells(heat)
    assert got == _cells(ref_heat)
    assert {c[1] for c in got} == {"pem0", "pem1", "pem2"}
    assert sum(c[4] for c in got) == scanned["port"] == 18_000
    top, ref_top = heat.top_shards(3), ref_heat.top_shards(3)
    slack = 6000 * (1 - heat._decay_factor(time.monotonic_ns() - t0))
    assert top and {s for _t, s, _h in top} == {s for _t, s, _h in ref_top}
    heats = {"port": {s: h for _t, s, h in top}, "ref": {s: h for _t, s, h in ref_top}}
    for a, b in itertools.combinations(heats["port"], 2):
        for pkg, other in (("port", "ref"), ("ref", "port")):
            if abs(heats[pkg][a] - heats[pkg][b]) > slack:
                assert (heats[pkg][a] > heats[pkg][b]) == (heats[other][a] > heats[other][b])
    # the fold: shard_heat and storage_state rows land in the first store
    n = clusters["port"].fold_storage_observatory()
    m = clusters["ref"].fold_storage_observatory()
    assert n == m > 0
    store = clusters["port"].stores["pem0"]
    assert store.table(observe.SHARD_HEAT_TABLE).stats()["rows_written"] == len(got)
    assert store.table(observe.STORAGE_STATE_TABLE).stats()["rows_written"] == \
        clusters["ref"].stores["pem0"].table(observe.STORAGE_STATE_TABLE).stats()["rows_written"]


def test_storage_state_rows_equal_the_references():
    """Per (agent, table): hot rows, sealed batches and bytes, the age
    histogram (at an explicit now), journal and cold columns (none here).
    The resident bytes are each package's own device holdings: both report
    the table's pinned entry after a query, the port's exact rows, the
    reference's padded buffer."""
    stores = {"ref": _store("ref", 4, n=5000), "port": _store("port", 4, n=5000)}
    for pkg, ts in stores.items():
        _run_plan(pkg, ts, 1)
    now = T0 + 120 * SEC
    rows = {"ref": ref_heat.storage_state_rows(stores["ref"], "pem0", now_ns=now),
            "port": heat.storage_state_rows(stores["port"], "pem0", now_ns=now)}
    res_b = {k: [r.pop("resident_bytes") for r in v] for k, v in rows.items()}
    assert rows["port"] == rows["ref"]
    (r,) = rows["port"]
    assert (r["hot_rows"], r["sealed_batches"]) == (5000 - 4 * 1024, 4)
    assert r["age_histogram"] == '{"<10m": 4}'
    assert 0 < res_b["port"][0] <= res_b["ref"][0]


def test_tracing_off_never_touches_the_model():
    port_flags.set_for_testing("PL_TRACING_ENABLED", False)
    _run_plan("port", _store("port", 5), 2)
    assert heat.snapshot_rows() == []
    assert observe.enabled() is False


def test_feed_recorder_reads_only_host_metadata():
    """FeedRecorder maps sealed gens to age buckets from the table's sealed
    list once, and attributes a feed from its host parts: same cells as the
    reference's recorder over the same table."""
    ts = {"ref": _store("ref", 6, n=4096 + 10), "port": _store("port", 6, n=4096 + 10)}
    now = T0 + 30 * SEC
    cells = {}
    for pkg, mod in (("ref", ref_heat), ("port", heat)):
        t = ts[pkg].table("http_events")
        model = mod.HeatModel()
        rec = mod.FeedRecorder(t, "pem9", model=model, now_ns=now)
        sealed = list(t._sealed)
        parts = [{k: sb.batch.columns[k][:sb.batch.num_valid] for k in ("latency",)}
                 for sb in sealed]
        rec.record(parts, [sb.gen for sb in sealed], "resident")
        rec.record([{"latency": np.zeros(10)}], [None], "stream")
        cells[pkg] = sorted((r["tier"], r["age_bucket"], r["rows_scanned"], r["bytes"])
                            for r in model.snapshot_rows(now))
    assert cells["port"] == cells["ref"] == [
        ("resident", "<1m", 4096, 4096 * 8), ("stream", "hot", 10, 80)]
