"""The adaptive gates (pixie_tpu_torch/engine/autotune.py) against the
reference's model (pixie_tpu/engine/autotune.py).

The cases of tests/test_autotune.py that need no broker: size buckets, a
cold model that stays static with paced probes, a warm model that routes to
its measured favorite, deterministic epsilon probes, the tail guard and its
hold-off, record_row de-duplication, a KV round trip through a dict KV and
a corrupt KV record, and PX_AUTOTUNE=0 being bit-identical and silent.
Where the reference's model can run the same sequence, the port's
decisions are held equal to its decisions.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from pixie_tpu.engine import autotune as ref_autotune

import pixie_tpu_torch.matview  # noqa: F401  (defines PL_MATVIEW_ENABLED)
from pixie_tpu_torch import flags, metrics
from pixie_tpu_torch.engine import autotune
from pixie_tpu_torch.engine.autotune import (
    GATE_CPU_CROSSOVER, KV_KEY, AutotuneModel, size_bucket,
)
from pixie_tpu_torch.engine.autotune_bench import SCRIPTS, _mkstore, answers_agree, canonical
from pixie_tpu_torch.parallel.cluster import LocalCluster

AT_FLAGS = (
    "PX_AUTOTUNE", "PX_AUTOTUNE_EPSILON", "PX_AUTOTUNE_MIN_SAMPLES",
    "PX_AUTOTUNE_GUARD_WINDOW", "PX_AUTOTUNE_GUARD_FACTOR",
    "PX_AUTOTUNE_GUARD_HOLDOFF", "PX_CPU_CROSSOVER_ROWS",
    "PL_MATVIEW_ENABLED",
)


@pytest.fixture(autouse=True)
def _isolated_model():
    import pixie_tpu_torch.engine.executor  # noqa: F401  (defines the routing flags)

    saved = {n: flags.get(n) for n in AT_FLAGS}
    autotune.MODEL.reset_for_testing()
    yield
    for n, v in saved.items():
        flags.set_for_testing(n, v)
    autotune.MODEL.reset_for_testing()


class DictKV:
    """The KV surface the model persists through (set / get_json / set_json)."""

    def __init__(self):
        self.data: dict[str, bytes] = {}

    def set(self, key: str, value: bytes) -> None:
        self.data[key] = bytes(value)

    def set_json(self, key: str, doc) -> None:
        self.data[key] = json.dumps(doc).encode()

    def get_json(self, key: str):
        raw = self.data.get(key)
        return None if raw is None else json.loads(raw)


def _warm(model, gate, arms_ms, plan_class="agg", bucket="4^8", n=None):
    """Feed `n` observations per arm (ms costs from arms_ms)."""
    n = n if n is not None else int(flags.get("PX_AUTOTUNE_MIN_SAMPLES"))
    for arm, ms in arms_ms.items():
        for _ in range(n):
            model.observe(gate, plan_class, bucket, arm, ms / 1e3)


def _decide(m, static="device"):
    return m.decide(GATE_CPU_CROSSOVER, "agg", "4^8", static, ("device", "cpu"))


def test_size_bucket_is_log_scale():
    assert size_bucket(0) == "4^0"
    assert size_bucket(5) == size_bucket(15)
    assert size_bucket(100) != size_bucket(100_000)
    assert size_bucket((1 << 20) - 1) == "4^10"
    assert size_bucket(1 << 20) == "4^11"
    for n in [0, 1, 3, 4, 17, 1 << 14, (1 << 22) + 1, 2_097_152, 10 ** 9]:
        assert size_bucket(n) == ref_autotune.size_bucket(n)


def test_cold_model_stays_static_with_paced_probes():
    def run(mod):
        m = mod.AutotuneModel()
        return [_decide(m) for _ in range(8)]

    seq = [d["source"] for d in run(autotune)]
    assert seq == [d["source"] for d in run(autotune)]  # deterministic
    probes = [i for i, s in enumerate(seq) if s == "explore"]
    assert probes == [autotune.COLD_PROBE_PERIOD - 1, 2 * autotune.COLD_PROBE_PERIOD - 1]
    assert all(s == "cold" for i, s in enumerate(seq) if i not in probes)
    assert run(autotune) == run(ref_autotune)


def test_warm_model_routes_to_measured_favorite():
    m = AutotuneModel()
    _warm(m, GATE_CPU_CROSSOVER, {"device": 90.0, "cpu": 2.0})
    dec = _decide(m)
    assert dec["arm"] == "cpu" and dec["source"] == "model"
    assert dec["model_ms"] < dec["static_ms"]
    r = ref_autotune.AutotuneModel()
    _warm(r, GATE_CPU_CROSSOVER, {"device": 90.0, "cpu": 2.0})
    assert _decide(r) == dec


def test_warm_model_epsilon_probes_deterministically():
    flags.set_for_testing("PX_AUTOTUNE_EPSILON", 0.0625)  # every 16th
    m = AutotuneModel()
    _warm(m, GATE_CPU_CROSSOVER, {"device": 90.0, "cpu": 2.0})
    srcs = [_decide(m)["source"] for _ in range(32)]
    assert srcs.count("explore") == 2
    assert srcs[15] == "explore" and srcs[31] == "explore"


def _tail(m, window):
    """Warm both arms, then give the favored cpu arm a tail the mean hides:
    one 500 ms spike and fast samples after it."""
    _warm(m, GATE_CPU_CROSSOVER, {"device": 50.0, "cpu": 2.0},
          n=max(window, int(flags.get("PX_AUTOTUNE_MIN_SAMPLES"))))
    m.observe(GATE_CPU_CROSSOVER, "agg", "4^8", "cpu", 500.0 / 1e3)
    for _ in range(window):
        m.observe(GATE_CPU_CROSSOVER, "agg", "4^8", "cpu", 2.0 / 1e3)


def test_tail_guard_trips_resets_arm_and_emits_fallback_row():
    m = AutotuneModel()
    window = int(flags.get("PX_AUTOTUNE_GUARD_WINDOW"))
    _tail(m, window)
    dec = _decide(m)
    assert dec["arm"] == "device" and dec["source"] == "fallback"
    dec2 = _decide(m)
    assert dec2["source"] == "fallback" and dec2["arm"] == "device"
    assert m.snapshot()[GATE_CPU_CROSSOVER]["fallbacks"] == 1
    rows = m.drain_rows()
    assert len(rows) == 1 and rows[0]["source"] == "fallback"
    assert "autotune_fallback" in rows[0]["reason"]
    assert m.drain_rows() == []


def test_guard_holdoff_expires_and_model_relearns():
    flags.set_for_testing("PX_AUTOTUNE_GUARD_HOLDOFF", 3)
    m = AutotuneModel()
    _tail(m, int(flags.get("PX_AUTOTUNE_GUARD_WINDOW")))
    srcs = [_decide(m)["source"] for _ in range(4)]
    assert srcs == ["fallback"] * 4  # trip + 3 held-off decisions
    assert {_decide(m)["source"] for _ in range(8)} <= {"cold", "explore"}


def test_record_row_dedupes_against_stats_path():
    m = AutotuneModel()
    dec = _decide(m)
    m.record_row(dec, query_id="q1")
    assert [r["query_id"] for r in m.drain_rows()] == ["q1"]
    assert autotune.rows_from_stats({"autotune": [dec]}, "q1") == []


def test_same_decisions_as_the_reference_model_on_one_stream():
    """A seeded stream of decisions and measured completions over several
    keys: the port's model decides what the reference's decides."""
    rng = np.random.default_rng(17)
    models = (AutotuneModel(), ref_autotune.AutotuneModel())
    got = ([], [])
    for step in range(600):
        bucket = f"4^{rng.integers(6, 9)}"
        cost = {"cpu": rng.exponential(2.0), "device": rng.exponential(3.0)}
        for i, m in enumerate(models):
            dec = m.decide(GATE_CPU_CROSSOVER, "agg", bucket, "device", ("cpu", "device"))
            got[i].append((dec["arm"], dec["source"]))
            m.observe_decision(dec, cost[dec["arm"]] / 1e3)
    assert got[0] == got[1]


def test_kv_round_trip_warm_first_decision():
    m = AutotuneModel()
    _warm(m, GATE_CPU_CROSSOVER, {"device": 90.0, "cpu": 2.0})
    kv = DictKV()
    m.save_kv(kv)
    m2 = AutotuneModel()
    assert m2.load_kv(kv) and m2.loaded_from_kv
    srcs = [_decide(m2)["source"] for _ in range(8)]
    assert srcs[0] == "model" and "cold" not in srcs


def test_corrupt_kv_record_degrades_to_static():
    kv = DictKV()
    kv.set(KV_KEY, b"{not json")
    before = metrics.counter_value("px_autotune_recall_errors_total")
    m = AutotuneModel()
    assert m.load_kv(kv) is False and not m.loaded_from_kv
    assert metrics.counter_value("px_autotune_recall_errors_total") == before + 1
    kv.set_json(KV_KEY, {"v": 99, "gates": {}})
    assert m.load_kv(kv) is False
    dec = _decide(m)
    assert dec["arm"] == "device" and dec["source"] == "cold"


def test_autotune_off_is_bit_identical_and_silent():
    """PX_AUTOTUNE=0 removes every model read AND write; with the flag on,
    decisions appear in stats and the answers agree (bit for bit on this
    CPU: both arms there are host code, but the card route's float adds
    run in another order, so the harness's tolerance is what holds them)."""
    flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    stores = {f"pem{i}": _mkstore(i, 8_000) for i in range(2)}
    cluster = LocalCluster(stores, device="cpu")

    flags.set_for_testing("PX_AUTOTUNE", False)
    base = canonical(cluster.query(SCRIPTS[0]))
    assert answers_agree(canonical(cluster.query(SCRIPTS[0])), base)
    assert autotune.MODEL.snapshot() == {}  # no writes anywhere

    flags.set_for_testing("PX_AUTOTUNE", True)
    flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", 64)  # mis-set
    seen = []
    arms = set()
    for _ in range(12):
        res = cluster.query(SCRIPTS[0])
        assert answers_agree(canonical(res), base)
        qr = next(iter(res.values()))
        seen += autotune.decisions_from_stats(qr.exec_stats)
        for st in qr.exec_stats["agents"].values():
            arms.update(r["arm"] for r in st.get("routes", []))
    assert any(d["gate"] == GATE_CPU_CROSSOVER for d in seen)
    assert arms == {"cpu", "device"}  # the cold probes ran the CPU arm
    assert autotune.MODEL.snapshot()[GATE_CPU_CROSSOVER]["samples"] > 0
