"""shard_bench's one-process arms: pixie_tpu_torch against pixie_tpu.

`run_local` over 8 co-located CPU shards (PIXIE_TORCH_VIRTUAL_SHARDS = 8)
and `run_shuffled_join` over one agent's 8-shard mesh, at the sizes of
tests/test_sharded_parity.py, each with its own bit-equality check against
the port's single-device executor; their reports must equal the
reference's runs of the same arms on its 8 virtual JAX CPU devices (the
timings and the padding of the warm hot remainder's upload aside).  Each workload's decoded answer on the port's mesh must
equal the reference's single-device answer: exactly, the mean to rtol
1e-12 (a different summation order).  The multi-process arm runs as 2
spawned CPU ranks over gloo (its own timeout), bit-equal on rank 0 and the
same bytes on both ranks, and a failed worker raises.
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

N_DEV = 8
TIMINGS = ("rows_per_sec", "p50_ms")
#: the multihost chain's groups: 16 services x 4 status slots
N_SERVICES_X4 = 64


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


def test_run_subprocess_two_ranks_bit_equal():
    """The multi-process arm: 2 spawned CPU ranks x 2 shards over gloo, each
    feeding only its own shards; rank 0 bit-equal to the single-device step
    over the full data, both ranks' merged states the same bytes, and never
    a one-process "local" run."""
    out = sb.run_subprocess(20_000, repeats=2, processes=2, devices_per_proc=2,
                            device="cpu", timeout=180.0, exchange_rows=2048)
    assert out["mode"] == "multihost" and out["n_devices"] == 4
    assert out["processes"] == 2 and out["shards_per_process"] == 2
    assert out["bit_equal"] is True and out["ranks_equal"] is True
    assert out["backend"] == "gloo" and [r["rank"] for r in out["ranks"]] == [0, 1]
    assert all(r["gathered_bytes"] == out["gathered_bytes"] > 0 for r in out["ranks"])
    assert all(r["exchange"]["rows_equal"] for r in out["ranks"])
    assert sum(r["exchange"]["sent_bytes"] for r in out["ranks"]) == 2 * 2048 * 20


def test_run_subprocess_raises_when_a_worker_fails(monkeypatch):
    """A worker that exits non-zero makes run_subprocess raise with its
    stderr: no fallback to a one-process run."""
    from pixie_tpu_torch.status import Internal

    env = sb._worker_env

    def failing(devices_per_proc):
        return {**env(devices_per_proc), "PX_TORCH_DIST_BACKEND": "nccl"}

    monkeypatch.setattr(sb, "_worker_env", failing)
    with pytest.raises(Internal, match="NCCL needs CUDA devices"):
        sb.run_subprocess(4096, repeats=1, processes=2, devices_per_proc=2, device="cpu",
                          timeout=120.0)


def test_worker_env_carries_the_flags():
    """The flags this process overrode cross the spawn (the card-route pin
    included); the worker's shards and the checkout are set, and no
    rendezvous flag leaks from this process."""
    import os

    saved = port_flags.get("PX_CPU_CROSSOVER_ROWS")
    port_flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", 12345)
    try:
        env = sb._worker_env(4)
    finally:
        port_flags.set_for_testing("PX_CPU_CROSSOVER_ROWS", saved)
    assert env["PX_CPU_CROSSOVER_ROWS"] == "12345" and env["PX_AUTOTUNE"] == "0"
    assert env["PIXIE_TORCH_VIRTUAL_SHARDS"] == "4"
    assert sb._repo_root() in env["PYTHONPATH"].split(os.pathsep)
    assert not any(k.startswith("PX_JAX_") for k in env)


def test_main_worker_without_rendezvous_runs_one_process(capsys):
    """`main --worker` with no rendezvous runs one process over its local
    shards and prints its report, bit-equal to the single-device step."""
    import json

    assert sb.main(["--worker", "--rows", "4096", "--repeats", "1", "--device", "cpu"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["bit_equal"] is True and doc["n_devices"] == N_DEV and doc["processes"] == 1


def test_multihost_chain_kernel_matches_reference():
    """The multihost fragment kernel is the reference's: the same chain,
    keys, aggregates and state layout."""
    import torch

    kern, udas, specs, groups = sb._chain_kernel(torch.device("cpu"))
    rk, rudas, rspecs, rgroups = ref_sb._chain_kernel()
    assert groups == rgroups == N_SERVICES_X4
    assert [n for n, _u, _v in udas] == [n for n, _u, _v in rudas]
    assert [(n, dt) for n, _u, dt in specs] == [(n, dt) for n, _u, dt in rspecs]
    assert len(kern.limit_ns) == len(rk.limit_ns) == 0
