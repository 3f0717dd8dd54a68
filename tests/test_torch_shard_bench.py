"""shard_bench's one-process arms: pixie_tpu_torch against pixie_tpu.

`run_local` over 8 co-located CPU shards (PIXIE_TORCH_VIRTUAL_SHARDS = 8)
and `run_shuffled_join` over one agent's 8-shard mesh, at the sizes of
tests/test_sharded_parity.py, each with its own bit-equality check against
the port's single-device executor; their reports must equal the
reference's runs of the same arms on its 8 virtual JAX CPU devices (the
timings and the padding of the warm hot remainder's upload aside).  Each workload's decoded answer on the port's mesh must
equal the reference's single-device answer: exactly, the mean to rtol
1e-12 (a different summation order).  The multi-process arm is refused.
"""
import numpy as np
import pytest

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu.engine import resident as ref_resident
from pixie_tpu.engine.executor import PlanExecutor as RefExecutor
from pixie_tpu.engine.executor import clear_device_cache as ref_clear_cache
from pixie_tpu.parallel import shard_bench as ref_sb

from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.engine import resident
from pixie_tpu_torch.engine.executor import PlanExecutor, clear_device_cache
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.parallel import shard_bench as sb
from pixie_tpu_torch.parallel.spmd import make_mesh
from pixie_tpu_torch.status import Unimplemented

N_DEV = 8
TIMINGS = ("rows_per_sec", "p50_ms")


@pytest.fixture(autouse=True)
def _mesh_env():
    """8 co-located CPU shards for the port; standing views off in both
    packages and tracing off in the reference, as every parity file runs
    them; empty tiers.  Every flag is restored to what it was."""
    ref_saved = {f: ref_flags.get(f) for f in ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")}
    port_saved = {f: port_flags.get(f)
                  for f in ("PL_MATVIEW_ENABLED", "PIXIE_TORCH_VIRTUAL_SHARDS")}
    for f in ref_saved:
        ref_flags.set_for_testing(f, False)
    port_flags.set_for_testing("PL_MATVIEW_ENABLED", False)
    port_flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", N_DEV)
    clears = (ref_resident.clear_for_testing, ref_clear_cache,
              resident.clear_for_testing, clear_device_cache)
    for clear in clears:
        clear()
    yield
    for f, v in port_saved.items():
        port_flags.set_for_testing(f, v)
    for f, v in ref_saved.items():
        ref_flags.set_for_testing(f, v)
    for clear in clears:
        clear()


def _same_answer(got, want, keys):
    """Decoded columns by value, rows ordered by `keys`: the mean to rtol
    1e-12, everything else exactly."""
    g, w = sb._result_cols(got), sb._result_cols(want)
    assert sorted(g) == sorted(w)

    def order(cols):
        return np.lexsort(tuple(cols[k].astype(str) if cols[k].dtype == object else cols[k]
                                for k in reversed(keys)))

    go, wo = order(g), order(w)
    for name in sorted(w):
        a, b = g[name][go], w[name][wo]
        assert a.shape == b.shape, name
        if name.startswith("avg"):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=name)
        else:
            assert a.tolist() == b.tolist(), name


@pytest.mark.parametrize("rows", [96_000, 99_997])
def test_run_local_bit_equal_and_matches_reference(rows):
    """filter→map→partial-agg shard-local over the mesh == single-device,
    bit for bit, including the uneven tail (99_997 rows: a short last shard
    and a hot remainder); the report equals the reference's."""
    out = sb.run_local(rows, repeats=2, n_devices=N_DEV, device="cpu")
    assert out["bit_equal"] is True
    assert out["spmd_feeds"] >= 1 and out["shard_skew_frac"] >= 1.0
    resident.clear_for_testing()
    want = ref_sb.run_local(rows, repeats=2, n_devices=N_DEV)
    # warm_h2d_bytes: a warm query uploads only the hot remainder (99_997 =
    # one sealed 65,536-row batch + 34,461 hot rows of 28 bytes); the port
    # counts the rows it copies, the reference its padded buffer
    skip = TIMINGS + ("warm_h2d_bytes",)
    assert {k: v for k, v in out.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert out["warm_h2d_bytes"] == ((rows % (1 << 16)) * 28 if rows % 16 else 0)
    assert want["warm_h2d_bytes"] >= out["warm_h2d_bytes"]
    # the decoded answer on the mesh equals the reference's single device
    ts = sb.build_store(rows)
    got = PlanExecutor(sb.agg_plan(), ts, device="cpu",
                       mesh=make_mesh(N_DEV, device="cpu")).run()["output"]
    single = RefExecutor(ref_sb.agg_plan(), ref_sb.build_store(rows), mesh=None,
                         force_backend="tpu").run()["output"]
    assert "service" in got.dictionaries
    _same_answer(got, single, ("service", "status"))


def test_run_shuffled_join_bit_equal_and_matches_reference():
    rows = 20_000
    out = sb.run_shuffled_join(rows, n_devices=N_DEV, device="cpu")
    assert out["bit_equal"] is True
    assert out["n_parts"] == N_DEV and out["all_to_all_exchanges"] >= 2
    want = ref_sb.run_shuffled_join(rows, n_devices=N_DEV)
    assert {k: v for k, v in out.items() if k != "rows_per_sec"} == \
        {k: v for k, v in want.items() if k != "rows_per_sec"}
    cluster = LocalCluster({"pem0": sb.build_join_store(rows)}, device="cpu",
                           n_devices_per_agent=N_DEV)
    got = cluster.execute(sb.join_plan())["out"]
    assert got.exec_stats["transfer"]["mesh_shuffles"] == 2
    single = RefExecutor(ref_sb.join_plan(), ref_sb.build_join_store(rows),
                         mesh=None).run()["out"]
    _same_answer(got, single, ("n",))


def test_workload_and_plans_match_reference():
    """The same generator, store and plans as the reference's module."""
    for shard in range(3):
        a, b = sb.shard_cols(30_000, shard, 3), ref_sb.shard_cols(30_000, shard, 3)
        assert all(np.array_equal(a[k], b[k]) for k in b)
    assert sb.agg_plan().to_dict() == ref_sb.agg_plan().to_dict()
    assert sb.join_plan().to_dict() == ref_sb.join_plan().to_dict()
    assert sb._p50([3.0, 1.0, 2.0]) == ref_sb._p50([3.0, 1.0, 2.0]) == 2.0


def test_assert_bitequal_names_the_first_differing_column():
    ts = sb.build_store(4096, batch_rows=1024)
    plan = sb.agg_plan()
    a = PlanExecutor(plan, ts, device="cpu", mesh=None).run()["output"]
    b = PlanExecutor(plan, ts, device="cpu", mesh=None).run()["output"]
    sb.assert_bitequal(a, b)
    b.columns["cnt"] = b.columns["cnt"] + 1
    with pytest.raises(AssertionError, match="cnt"):
        sb.assert_bitequal(a, b)


def test_mesh_wider_than_the_virtual_shards_is_refused():
    port_flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", 2)
    with pytest.raises(RuntimeError, match="need 4 devices"):
        sb.run_local(4096, repeats=1, n_devices=4, device="cpu")


@pytest.mark.parametrize("call", [
    lambda: sb.run_multihost(1024, 1, None),
    lambda: sb.run_subprocess(1024),
    lambda: sb._worker_env(4),
    lambda: sb.main(["--worker", "--rows", "1024"]),
], ids=["run_multihost", "run_subprocess", "worker_env", "main_worker"])
def test_multi_process_arm_is_refused(call):
    with pytest.raises(Unimplemented, match="item 5"):
        call()
