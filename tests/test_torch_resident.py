"""The device-resident tier and the HBM feed cache: pixie_tpu against
pixie_tpu_torch (device="cpu") over the same writes and queries.

The six scenarios of tests/test_resident.py run through both packages: the
reference with mesh=None and force_backend="tpu" on the JAX CPU, as its own
tests run it, the port on the CPU.  Each compares the results (counts exact;
means to rtol 1e-12, a different summation order; p50 to rtol 1e-12, i.e.
the same sketch bin) and the routes: the executors' resident_feeds and
feed_cache_hits, the tiers' hit, fold, rebase, admission, fallback and trim
counts and pinned bytes, and the port's h2d_bytes: 0 on a warm hit, exactly
the delta's bytes on a fold, and exactly the feed's rows on a fresh upload
(the reference counts its padded buckets there; the port pads on the
device).  R1 and R2's plain versions are held against the reference's own
fold, grow and shift kernels.
"""
import numpy as np
import pytest
import torch

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
from pixie_tpu import flags as ref_flags
from pixie_tpu.engine import resident as ref_resident
from pixie_tpu.engine.executor import PlanExecutor as RefExecutor
from pixie_tpu.engine.executor import clear_device_cache as ref_clear_cache
from pixie_tpu.plan import AggExpr, AggOp, MemorySinkOp, MemorySourceOp, Plan
from pixie_tpu.table import TableStore as RefStore
from pixie_tpu.types import DataType as DT, Relation

import pixie_tpu_torch.interop as interop
from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.engine import resident
from pixie_tpu_torch.engine.executor import PlanExecutor, clear_device_cache
from pixie_tpu_torch.ops import resident as rk
from pixie_tpu_torch.table import TableStore as PortStore
from pixie_tpu_torch.types import Relation as PortRelation

#: the agg's pruned feed: service (int32 code) + latency (f64)
ROW_BYTES = 12
REL = Relation.of(("time_", DT.TIME64NS), ("service", DT.STRING),
                  ("latency", DT.FLOAT64), ("status", DT.INT64))
TIER_KEYS = ("entries", "bytes", "hits", "folds", "rebases", "admissions",
             "fallbacks", "trims")
FLAGS = ("PL_HBM_RESIDENT", "PL_HBM_RESIDENT_MB", "PX_FEED_ROWS")


@pytest.fixture(autouse=True)
def _clean_tiers():
    saved = {f: (ref_flags.get(f), port_flags.get(f)) for f in FLAGS}
    for clear in (ref_resident.clear_for_testing, ref_clear_cache,
                  resident.clear_for_testing, clear_device_cache):
        clear()
    yield
    for f, (r, p) in saved.items():
        ref_flags.set_for_testing(f, r)
        port_flags.set_for_testing(f, p)
    for clear in (ref_resident.clear_for_testing, ref_clear_cache,
                  resident.clear_for_testing, clear_device_cache):
        clear()


def _set_flag(name, value):
    ref_flags.set_for_testing(name, value)
    port_flags.set_for_testing(name, value)


class Both:
    """One `events` table in each package, written with the same rows."""

    def __init__(self, rows, batch_rows=1 << 14, max_bytes=1 << 36, seed=0):
        self.rng = np.random.default_rng(seed)
        self.ref = RefStore()
        self.ref.create("events", REL, batch_rows=batch_rows, max_bytes=max_bytes)
        self.port = PortStore()
        self.port.create("events", PortRelation.from_dict(REL.to_dict()),
                         batch_rows=batch_rows, max_bytes=max_bytes)
        self.t0 = 0
        self.write(rows)
        plan = Plan()
        src = plan.add(MemorySourceOp(table="events"))
        agg = plan.add(AggOp(groups=["service"], values=[
            AggExpr("cnt", "count", None), AggExpr("avg", "mean", "latency"),
            AggExpr("p50", "p50", "latency")]), parents=[src])
        plan.add(MemorySinkOp(name="out"), parents=[agg])
        self.ref_plan = plan
        self.port_plan = interop.plan_from_dict(plan.to_dict())

    def write(self, n):
        cols = {
            "time_": np.arange(self.t0, self.t0 + n, dtype=np.int64),
            "service": np.array([f"svc-{i % 8}" for i in range(n)]),
            "latency": self.rng.exponential(50.0, n),
            "status": self.rng.choice([200, 404, 500], n).astype(np.int64),
        }
        self.t0 += n
        self.ref.table("events").write({k: v.copy() for k, v in cols.items()})
        self.port.table("events").write({k: v.copy() for k, v in cols.items()})

    def run(self):
        """Both executors over the current rows; → (ref stats, port stats)
        after checking that results and tier counters agree."""
        rex = RefExecutor(self.ref_plan, self.ref, mesh=None, force_backend="tpu")
        want = rex.run()["out"]
        pex = PlanExecutor(self.port_plan, self.port, device="cpu")
        got = pex.run()["out"]
        _results_equal(got, want)
        ref_tier, port_tier = ref_resident.tier_stats(), resident.tier_stats()
        assert {k: port_tier[k] for k in TIER_KEYS} == {k: ref_tier[k] for k in TIER_KEYS}
        for k in ("resident_feeds", "feed_cache_hits"):
            assert pex.stats.get(k, 0) == rex.stats.get(k, 0), k
        return rex.stats, pex.stats


def _results_equal(got, want):
    def by_service(res):
        names = np.asarray(res.decoded("service") if hasattr(res, "decoded")
                           else res.to_pandas()["service"], dtype=object)
        order = np.argsort(names)
        return names[order], {c: np.asarray(res.columns[c])[order]
                              for c in ("cnt", "avg", "p50")}

    gn, g = by_service(got)
    wn, w = by_service(want)
    assert list(gn) == list(wn)
    np.testing.assert_array_equal(g["cnt"], w["cnt"])
    np.testing.assert_allclose(g["avg"], w["avg"], rtol=1e-12, atol=0)
    np.testing.assert_allclose(g["p50"], w["p50"], rtol=1e-12, atol=0)


def _stream_equal(both):
    """The same query with the tier off matches the tier's route."""
    _set_flag("PL_HBM_RESIDENT", False)
    try:
        both.run()
    finally:
        _set_flag("PL_HBM_RESIDENT", True)


def test_warm_query_zero_h2d_1m():
    both = Both(1 << 20, batch_rows=1 << 16)
    ref_st, st = both.run()
    assert st["resident_feeds"] == 1 and ref_st["resident_feeds"] == 1
    assert st["h2d_bytes"] == (1 << 20) * ROW_BYTES  # admission uploads once
    ref_st, st = both.run()
    assert st["resident_feeds"] == 1
    assert st["h2d_bytes"] == 0 and ref_st["h2d_bytes"] == 0
    assert resident.tier_stats()["hits"] == 1


def test_ingest_delta_folds_in_place():
    both = Both(1 << 16, batch_rows=1 << 14)
    both.run()
    both.write(1 << 14)  # exactly one new sealed batch
    ref_st, st = both.run()
    assert st["h2d_bytes"] == ref_st["h2d_bytes"] == (1 << 14) * ROW_BYTES
    assert resident.tier_stats()["folds"] == 1
    _stream_equal(both)


def test_retention_trim_rebases_then_evicts():
    rows_per_batch = 1 << 10
    both = Both(8 * rows_per_batch, batch_rows=rows_per_batch,
                max_bytes=8 * rows_per_batch * 28)
    both.run()
    assert resident.tier_stats()["entries"] == 1
    lo = both.port.table("events").first_row_id()
    both.write(2 * rows_per_batch)
    assert both.port.table("events").first_row_id() > lo  # expiry trimmed
    ref_st, st = both.run()
    assert resident.tier_stats()["rebases"] == 1
    # the retained rows did not re-cross the link: only the two new batches
    assert st["h2d_bytes"] == ref_st["h2d_bytes"] == 2 * rows_per_batch * ROW_BYTES
    _stream_equal(both)
    # full expiry: the entry is freed outright by the write itself
    both.write(32 * rows_per_batch)
    port_tier, ref_tier = resident.tier_stats(), ref_resident.tier_stats()
    assert port_tier["entries"] == ref_tier["entries"] == 0
    assert port_tier["bytes"] == 0 and port_tier["trims"] == ref_tier["trims"] >= 1


def test_budget_exceeded_falls_back_then_adopts_the_cache():
    _set_flag("PL_HBM_RESIDENT_MB", 0)
    both = Both(1 << 15)
    _ref, st = both.run()
    assert "resident_feeds" not in st
    assert resident.tier_stats()["fallbacks"] >= 1
    assert st["h2d_bytes"] == (1 << 15) * ROW_BYTES
    _ref, st = both.run()  # the feed cache serves the warm query
    assert st["feed_cache_hits"] >= 1 and st["h2d_bytes"] == 0
    # the budget recovers: admission ADOPTS the cache's buffers
    _set_flag("PL_HBM_RESIDENT_MB", 2048)
    _ref, st = both.run()
    assert st["resident_feeds"] == 1 and st["h2d_bytes"] == 0
    assert resident.tier_stats()["admissions"] == 1
    from pixie_tpu_torch.engine.executor import device_cache_stats
    assert device_cache_stats()["entries"] == 0  # pinned once, not twice


def test_flag_off_identical_results():
    both = Both(1 << 15)
    both.run()
    _set_flag("PL_HBM_RESIDENT", False)
    for clear in (ref_resident.clear_for_testing, ref_clear_cache,
                  resident.clear_for_testing, clear_device_cache):
        clear()
    _ref, st = both.run()
    assert "resident_feeds" not in st
    assert resident.tier_stats()["entries"] == 0


def test_hot_remainder_stays_unpinned():
    both = Both((1 << 14) + 100, batch_rows=1 << 14)
    _ref, st = both.run()
    assert st["resident_feeds"] == 1 and st["h2d_bytes"] > 0
    _ref, st = both.run()
    # warm: the sealed prefix moves zero bytes, the hot rows re-upload
    assert st["h2d_bytes"] == 100 * ROW_BYTES


def test_hot_remainder_never_joins_a_sealed_feed():
    """A sealed run shorter than the feed target is flushed before the hot
    tail, so it stays cacheable: two feeds, and on a warm query only the hot
    rows cross the link, from the resident tier or from the feed cache."""
    both = Both(3 * (1 << 12) + 700, batch_rows=1 << 12)
    _ref, st = both.run()
    assert st["feeds"] == 2 and st["resident_feeds"] == 1
    _set_flag("PL_HBM_RESIDENT", False)
    _ref, st = both.run()  # the sealed feed from the feed cache
    assert st["feeds"] == 2 and st.get("feed_cache_hits", 0) == 0
    _ref, st = both.run()
    assert st["feed_cache_hits"] == 1 and st["h2d_bytes"] == 700 * ROW_BYTES


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64, np.uint8])
def test_fold_and_move_plain_match_reference_kernels(dtype):
    """R1 and R2's plain versions against the reference's _kernels():
    fold (dynamic_update_slice), grow (jnp.pad) and shift (jnp.roll), on
    [0, rows)."""
    import jax.numpy as jnp

    fold_k, grow_k, shift_k = ref_resident._kernels()
    rng = np.random.default_rng(4)
    bucket, rows, d = 1 << 12, 3000, 900

    def vals(n):
        return rng.integers(0, 200, n).astype(dtype)

    host = np.zeros(bucket, dtype=dtype)
    host[:rows] = vals(rows)
    delta = vals(d)
    # fold at row `rows`, past the bucket after a grow to 2x
    grown_ref = np.asarray(grow_k(jnp.asarray(host), extra=bucket))
    grown = rk.move_plain(torch.from_numpy(host.copy()), 0, rows, 2 * bucket)
    np.testing.assert_array_equal(grown.numpy()[:rows], grown_ref[:rows])
    np.testing.assert_array_equal(grown.numpy(), grown_ref)  # both zero the tail
    folded_ref = np.asarray(fold_k(jnp.asarray(grown_ref), jnp.asarray(delta),
                                   np.int64(rows)))
    folded = rk.fold_plain(grown, torch.from_numpy(delta), rows)
    np.testing.assert_array_equal(folded.numpy()[:rows + d], folded_ref[:rows + d])
    # rebase after a trim of 1024 rows: the retained rows lead
    drop, n = 1024, rows + d - 1024
    shifted_ref = np.asarray(shift_k(jnp.asarray(folded_ref), np.int64(drop)))
    shifted = rk.move_plain(folded, drop, n, 2 * bucket)
    np.testing.assert_array_equal(shifted.numpy()[:n], shifted_ref[:n])
    assert not shifted.numpy()[n:].any()  # R2 zeroes what jnp.roll wraps


def test_fold_and_move_wrappers_on_cpu():
    """The wrappers take the plain versions on CPU tensors: a fold of a
    chunked host delta and the bytes it reports, a grow and a rebase."""
    bufs = [torch.zeros(1 << 10, dtype=torch.int32), torch.zeros(1 << 10, dtype=torch.float64)]
    parts = [[np.arange(5, dtype=np.int32), np.arange(5, 9, dtype=np.int32)],
             [np.full(4, 2.5), np.full(5, 3.5)]]
    assert rk.fold(bufs, parts, 100) == 9 * 4 + 9 * 8
    assert bufs[0][100:109].tolist() == list(range(9))
    assert bufs[1][100:109].tolist() == [2.5] * 4 + [3.5] * 5
    grown = rk.move(bufs, 0, 109, 1 << 11)
    assert grown[0].shape == (1 << 11,) and torch.equal(grown[0][:109], bufs[0][:109])
    rebased = rk.move(grown, 100, 9, 1 << 11)
    assert rebased[0][:9].tolist() == list(range(9)) and not rebased[0][9:].any()
    with pytest.raises(ValueError):
        rk.move(bufs, 1000, 100, 1 << 10)
