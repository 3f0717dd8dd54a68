"""Multi-process execution (pixie_tpu_torch/parallel/multihost.py) against
pixie_tpu/parallel/multihost.py.

In one process the port's counterparts of tests/test_multihost.py hold:
the no-op init, a global mesh equal to the default mesh with
host_local_slice (0, n), and the executor over it.  The backend follows
the topology (gloo on the CPU and on a shared card, NCCL a card a rank).
Then one gloo job of two spawned CPU ranks of 2 shards each (its own
timeout) runs shard_bench's chain through spmd_partial_step, the carry form
spmd_agg_step and a layout mismatch; its results are held here against the
reference's one-process mesh of 4 virtual devices on the same seeded data:
counts, int sums, min / max and sketch counts exactly, float sums to rtol
1e-12, and both ranks' merged states equal bit for bit.
"""
import json

import numpy as np
import pytest
import torch

import pixie_tpu  # noqa: F401  (jax x64 on, as the reference runs)
import pixie_tpu.matview.maintainer  # noqa: F401  (defines PL_MATVIEW_ENABLED)
import pixie_tpu.trace  # noqa: F401  (defines PL_TRACING_ENABLED)
from pixie_tpu import flags as ref_flags
from pixie_tpu.engine.executor import INT64_MAX, INT64_MIN
from pixie_tpu.engine.executor import PlanExecutor as RefExecutor
from pixie_tpu.parallel import multihost as ref_mh
from pixie_tpu.parallel import shard_bench as ref_sb
from pixie_tpu.parallel import spmd as ref_spmd

from pixie_tpu_torch import flags as port_flags
from pixie_tpu_torch.engine.executor import PlanExecutor
from pixie_tpu_torch.parallel import multihost, shard_bench, spmd
from pixie_tpu_torch.status import InvalidArgument

N_DEV = 8
#: the two-rank job: 2 ranks x 2 shards, its rows (an uneven tail)
RANKS, SHARDS = 2, 2
ROWS = 9_999
CARRY_ROWS = 4_096
JOB_TIMEOUT = 180.0


@pytest.fixture(autouse=True)
def _flags_env():
    saved = {f: ref_flags.get(f) for f in ("PL_MATVIEW_ENABLED", "PL_TRACING_ENABLED")}
    for f in saved:
        ref_flags.set_for_testing(f, False)
    port_saved = {f: port_flags.get(f) for f in ("PIXIE_TORCH_VIRTUAL_SHARDS",
                                                 "PX_TORCH_DIST_BACKEND")}
    port_flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", N_DEV)
    yield
    for f, v in port_saved.items():
        port_flags.set_for_testing(f, v)
    for f, v in saved.items():
        ref_flags.set_for_testing(f, v)


# ------------------------------------------------------------ one process
def test_init_is_noop_without_coordinator():
    assert multihost.init_multihost() is False is ref_mh.init_multihost()
    got, want = multihost.describe(), ref_mh.describe()
    assert got["initialized"] is False and got["backend"] is None
    for k in ("initialized", "process_index", "process_count", "local_devices",
              "global_devices", "platform"):
        assert got[k] == want[k], k


def test_global_mesh_equals_default_mesh_and_runs_collectives():
    mesh = multihost.global_mesh(device="cpu")
    ref_mesh = ref_mh.global_mesh()
    assert mesh == spmd.default_mesh("cpu") and mesh.size == ref_mesh.devices.size == N_DEV
    assert multihost.host_local_slice(mesh) == ref_mh.host_local_slice(ref_mesh) == (0, N_DEV)
    assert mesh.processes == (0,) * N_DEV and not mesh.spans_processes
    # the reference's psum of per-shard sums, as M1 over the shards' sums
    x = np.arange(64, dtype=np.float64)
    sums = [{"s": torch.tensor([b.sum()])} for b in x.reshape(N_DEV, -1)]
    got = spmd.collective_merge(sums, {"s": "add"}, packed=False, mesh=mesh)
    assert float(got["s"][0]) == float(x.sum())


def test_executor_accepts_global_mesh():
    """The engine's agg path runs SPMD over the global mesh, as the
    reference's does, with the same answer."""
    from pixie_tpu.plan import AggExpr as RAgg, AggOp as RAggOp
    from pixie_tpu.plan import MemorySinkOp as RSink, MemorySourceOp as RSrc, Plan as RPlan
    from pixie_tpu.table import TableStore as RStore
    from pixie_tpu.types import DataType as DT, Relation as RRel

    from pixie_tpu_torch.plan import AggExpr, AggOp, MemorySinkOp, MemorySourceOp, Plan
    from pixie_tpu_torch.table import TableStore
    from pixie_tpu_torch.types import Relation

    rng = np.random.default_rng(0)
    cols = {"k": np.array(["a", "b"])[rng.integers(0, 2, 8192)], "v": np.ones(8192)}
    results = []
    for store_cls, rel_of, plan_cls, src, agg_op, agg, sink, run in (
            (RStore, RRel.of, RPlan, RSrc, RAggOp, RAgg, RSink,
             lambda p, ts: RefExecutor(p, ts, mesh=ref_mh.global_mesh())),
            (TableStore, Relation.of, Plan, MemorySourceOp, AggOp, AggExpr, MemorySinkOp,
             lambda p, ts: PlanExecutor(p, ts, device="cpu",
                                        mesh=multihost.global_mesh(device="cpu")))):
        ts = store_cls()
        ts.create("t", rel_of(("k", DT.STRING), ("v", DT.FLOAT64)), batch_rows=1024).write(
            {k: v.copy() for k, v in cols.items()})
        p = plan_cls()
        s = p.add(src(table="t"))
        a = p.add(agg_op(groups=["k"], values=[agg("s", "sum", "v")]), parents=[s])
        p.add(sink(name="o"), parents=[a])
        ex = run(p, ts)
        res = ex.run()["o"].to_pandas().sort_values("k").reset_index(drop=True)
        assert ex.stats.get("spmd_feeds", 0) >= 1
        results.append(res)
    assert results[0]["s"].sum() == results[1]["s"].sum() == 8192
    assert results[0]["k"].tolist() == results[1]["k"].tolist()
    assert results[0]["s"].tolist() == results[1]["s"].tolist()


@pytest.mark.parametrize("device,cards,local_rank,forced,want", [
    ("cpu", 0, 1, "", ("gloo", "cpu", "cpu")),
    ("cuda", 1, 1, "", ("gloo", "cuda:0", "shared_card")),
    ("cuda", 2, 1, "", ("nccl", "cuda:1", "distinct_cards")),
    ("cuda", 2, 1, "gloo", ("gloo", "cuda:1", "forced")),
    ("cuda:0", 2, 1, "", ("gloo", "cuda:0", "shared_card")),
], ids=["cpu", "shared_card", "card_a_rank", "forced_gloo", "pinned_card"])
def test_backend_follows_topology(monkeypatch, device, cards, local_rank, forced, want):
    """gloo on the CPU and for ranks sharing a card, NCCL when each rank of
    the host owns a distinct card (rank → cuda:local rank)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    port_flags.set_for_testing("PX_TORCH_DIST_BACKEND", forced)
    backend, dev, reason = multihost.choose_backend(device, local_rank, 2)
    assert (backend, str(dev), reason) == want


@pytest.mark.parametrize("device,cards", [("cpu", 0), ("cuda", 1)], ids=["cpu", "shared"])
def test_forced_nccl_never_switches_quietly(monkeypatch, device, cards):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    port_flags.set_for_testing("PX_TORCH_DIST_BACKEND", "nccl")
    with pytest.raises(InvalidArgument, match="NCCL"):
        multihost.choose_backend(device, 1, 2)


def test_launch_kills_ranks_past_the_deadline(tmp_path):
    """Every wait of a job is bounded: a rank that outlives the deadline is
    killed with its peers and the job raises."""
    from pixie_tpu_torch.status import Internal

    with pytest.raises(Internal, match="did not finish"):
        multihost.launch(lambda rank: ["-c", "import time; time.sleep(60)"], 2,
                         shard_bench._worker_env(1), timeout=2.0)


@pytest.mark.parametrize("lost", ["[W socket.cpp:207] [c10d] The hostname of the client "
                                  "socket cannot be retrieved. err=-3",
                                  "RuntimeError: The server socket has failed to listen on any "
                                  "local network address. port: 1 (errno: 98 - Address "
                                  "already in use)."])
def test_launch_runs_a_job_whose_rendezvous_failed_again(tmp_path, lost):
    """A rank that dies in the rendezvous (the c10d store lost, its port
    taken) sends the whole job to a new port; a job whose every attempt
    fails so raises with the last stderr, and one that fails otherwise
    raises at once."""
    from pixie_tpu_torch.status import Internal

    tries = tmp_path / "tries"
    script = ("import os, sys\n"
              f"p = {str(tries)!r} + '.' + sys.argv[1]\n"
              "n = len(open(p).read()) if os.path.exists(p) else 0\n"
              "open(p, 'a').write('x')\n"
              "if sys.argv[1] == '1' and n < int(sys.argv[2]):\n"
              f"    sys.stderr.write({lost!r} + '\\n'); sys.stderr.flush(); os.abort()\n"
              "print('rank', sys.argv[1], *(['attempt', n] if sys.argv[1] == '1' else []))\n")
    env = shard_bench._worker_env(1)
    outs = multihost.launch(lambda rank: ["-c", script, str(rank), "2"], 2, env, timeout=60.0)
    assert outs == ["rank 0\n", "rank 1 attempt 2\n"]
    for f in tmp_path.iterdir():
        f.unlink()
    with pytest.raises(Internal, match="rendezvous failed 3 times"):
        multihost.launch(lambda rank: ["-c", script, str(rank), "3"], 2, env, timeout=60.0)
    assert len((tmp_path / "tries.1").read_text()) == 3
    with pytest.raises(Internal, match="(?s)rank 1 exited with 1: .*ValueError: no"):
        multihost.launch(lambda rank: ["-c", f"import sys; sys.exit(0) if {rank} == 0 else "
                                       "exec('raise ValueError(\"no\")')"], 2, env, timeout=60.0)


# ------------------------------------------------------- the two-rank job
WORKER = r'''
import json, sys
import numpy as np
import torch

from pixie_tpu_torch.engine.executor import (
    INT64_MAX, INT64_MIN, ChainKernel, GroupKey, PlanExecutor, device_luts)
from pixie_tpu_torch.ops.pack import flatten
from pixie_tpu_torch.parallel import multihost, shard_bench
from pixie_tpu_torch.parallel.spmd import (
    per_shard_valid, reduce_tree_for, spmd_agg_step, spmd_partial_step, collective_merge)
from pixie_tpu_torch.plan import Call, Column, FilterOp, Plan, lit
from pixie_tpu_torch.status import InvalidArgument, Unimplemented
from pixie_tpu_torch.table import TableStore
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.types import DataType as DT
from pixie_tpu_torch.udf import registry

out_dir, rows, carry_rows = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
CPU = torch.device("cpu")
assert multihost.init_multihost(device="cpu")
mesh = multihost.global_mesh(device="cpu")
rank = mesh.rank
lo, hi = multihost.host_local_slice(mesh)
doc = {"describe": multihost.describe(), "size": mesh.size, "slice": [lo, hi],
       "processes": list(mesh.processes)}
save = {}

def keep(prefix, state):
    for path, leaf in flatten(state):
        save[prefix + "/" + "/".join(path)] = np.asarray(leaf).copy()

try:
    PlanExecutor(Plan(), TableStore(), device="cpu", mesh=mesh)
    doc["executor"] = "accepted"
except Unimplemented as e:
    doc["executor"] = str(e)

# shard_bench's chain over this rank's shards, spmd_partial_step
kern, udas, init_specs, num_groups = shard_bench._chain_kernel(CPU)
n_dev = mesh.size
per = -(-rows // n_dev)
padded = per * n_dev
cols = {k: torch.from_numpy(np.concatenate([shard_bench.shard_cols(padded, i, n_dev)[k]
                                            for i in range(lo, hi)]))
        for k in ("time_", "service", "status", "bytes", "latency")}
nv = per_shard_valid(rows, padded, n_dev)
luts = device_luts(kern.luts, CPU)
init = lambda: {n: u.init(num_groups, dt, CPU) for n, u, dt in init_specs}
step = spmd_partial_step(kern.raw_agg_step, init, reduce_tree_for(udas),
                         len(kern.limit_ns), mesh)
multihost.reset_exec_stats()
keep("partial", step(cols, nv, INT64_MIN, INT64_MAX, luts))
doc["partial_stats"] = multihost.exec_stats()

# the carry form over tests/test_torch_spmd.py's kernel: a carry from the
# single-device step over batch A, batch B sharded over the mesh
d = Dictionary(["a", "b", "c"])
dtypes = {"service": DT.STRING, "status": DT.INT64, "latency": DT.FLOAT64}
ck = ChainKernel(dtypes, {"service": d},
                 [FilterOp(expr=Call("equal", (Column("status"), lit(200))))],
                 registry, None, CPU)
cudas, carry = [], {}
for out, fn, arg in [("cnt", "count", None), ("total", "sum", "latency"),
                     ("lo", "min", "latency"), ("hi", "max", "latency"),
                     ("avg", "mean", "latency")]:
    u = registry.uda(fn)
    cudas.append((out, u, ck.ctx.sym[arg] if arg else None))
    carry[out] = u.init(4, np.float64, CPU)
ck.make_agg_step([GroupKey("service", "dict", 4, DT.STRING, d,
                           key_sval=ck.ctx.sym["service"])], cudas, 4)
rng = np.random.default_rng(5)
def batch(n):
    return {"service": torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)),
            "status": torch.from_numpy(rng.choice([200, 500], n).astype(np.int64)),
            "latency": torch.from_numpy(rng.exponential(10.0, n))}
a, b = batch(carry_rows), batch(carry_rows)
cl = {k: torch.as_tensor(v) for k, v in ck.luts.items()}
carry = ck.raw_agg_step(a, carry_rows, INT64_MIN, INT64_MAX, None, cl, carry)[0]
block = carry_rows // n_dev
mine = {k: v.view(n_dev, block)[lo:hi] for k, v in b.items()}
nvb = per_shard_valid(carry_rows - 100, carry_rows, n_dev)
merged, total = spmd_agg_step(ck.raw_agg_step, reduce_tree_for(cudas), mesh)(
    mine, nvb, INT64_MIN, INT64_MAX, None, cl, carry)
keep("carry", merged)
doc["total"] = int(total)

# a layout mismatch: rank 1's states have twice the groups
g = 4 if rank == 0 else 8
states = [{"c": torch.ones(g, dtype=torch.int64), "x": torch.zeros(g)} for _ in range(hi - lo)]
try:
    collective_merge(states, {"c": "add", "x": "max"}, mesh=mesh)
    doc["mismatch"] = "merged"
except InvalidArgument as e:
    doc["mismatch"] = str(e)

np.savez(f"{out_dir}/rank{rank}.npz", **save)
print(json.dumps(doc), flush=True)
multihost.shutdown()
'''


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """One gloo job of 2 CPU ranks x 2 shards; → (each rank's report, each
    rank's saved states)."""
    out = tmp_path_factory.mktemp("multihost")
    script = out / "worker.py"
    script.write_text(WORKER)
    outs = multihost.launch(lambda rank: [str(script), str(out), str(ROWS), str(CARRY_ROWS)],
                            RANKS, shard_bench._worker_env(SHARDS), JOB_TIMEOUT)
    docs = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    states = [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]
    return docs, states


def _tree(flat: dict, prefix: str) -> dict:
    out = {}
    for key, v in flat.items():
        head, *path = key.split("/")
        if head != prefix:
            continue
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _same_states(got, want, exact_floats=False):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same_states(got[k], want[k], exact_floats)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    if w.dtype.kind == "f" and not exact_floats:
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(g, w)


def test_two_rank_mesh_spans_both_processes(job):
    docs, _ = job
    for r, doc in enumerate(docs):
        d = doc["describe"]
        assert d["initialized"] and d["process_index"] == r and d["process_count"] == RANKS
        assert d["global_devices"] == RANKS * SHARDS and d["local_devices"] == SHARDS
        assert d["backend"] == "gloo" and d["backend_reason"] == "cpu"
        assert doc["size"] == RANKS * SHARDS
        assert doc["slice"] == [r * SHARDS, (r + 1) * SHARDS]
        assert doc["processes"] == [0, 0, 1, 1]


def test_two_rank_partial_step_equals_reference(job):
    """shard_bench's chain over 2 x 2 shards equals the reference's
    one-process spmd_partial_step over 4 virtual devices: every leaf of
    this workload exactly (counts, int sums, min / max, sketch counts)."""
    _, states = job
    kern, udas, init_specs, num_groups = ref_sb._chain_kernel()
    n_dev = RANKS * SHARDS
    per = -(-ROWS // n_dev)
    padded = per * n_dev
    full = {k: np.concatenate([ref_sb.shard_cols(padded, i, n_dev)[k] for i in range(n_dev)])
            for k in ("time_", "service", "status", "bytes", "latency")}

    def init():
        return {n: u.init(num_groups, dt) for n, u, dt in init_specs}

    step = ref_spmd.spmd_partial_step(kern.raw_agg_step, init, ref_spmd.reduce_tree_for(udas),
                                      len(kern.limit_ns), ref_spmd.make_mesh(n_dev))
    want = _np(step(full, ref_spmd.per_shard_valid(ROWS, padded, n_dev), np.int64(INT64_MIN),
                    np.int64(INT64_MAX), kern.luts))
    _same_states(_tree(states[0], "partial"), want, exact_floats=True)
    assert int(np.sum(_tree(states[0], "partial")["cnt"])) == int(np.sum(want["cnt"])) > 0


def test_two_rank_states_equal_bit_for_bit(job):
    """Every rank holds the same merged bytes, as psum's replicated output."""
    _, states = job
    assert sorted(states[0]) == sorted(states[1])
    for k in states[0]:
        a, b = states[0][k], states[1][k]
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k


def test_two_rank_carry_form_and_total_equal_reference(job):
    """spmd_agg_step with a replicated carry: the carry counted once and the
    passed-row total summed over both ranks (one int64 all_reduce), equal to
    the reference's in-mesh collective_merge_carry and psum over 4 devices."""
    import jax.numpy as jnp
    from pixie_tpu.engine.executor import ChainKernel as RefKernel, GroupKey as RefKey
    from pixie_tpu.plan import Call, Column, FilterOp, lit
    from pixie_tpu.table.dictionary import Dictionary as RefDictionary
    from pixie_tpu.types import DataType as DT
    from pixie_tpu.udf import registry as ref_registry

    docs, states = job
    d = RefDictionary(["a", "b", "c"])
    kern = RefKernel({"service": DT.STRING, "status": DT.INT64, "latency": DT.FLOAT64},
                     {"service": d}, [FilterOp(expr=Call("equal", (Column("status"), lit(200))))],
                     ref_registry, time_col=None)
    udas, carry = [], {}
    for out, fn, arg in [("cnt", "count", None), ("total", "sum", "latency"),
                         ("lo", "min", "latency"), ("hi", "max", "latency"),
                         ("avg", "mean", "latency")]:
        uda = ref_registry.uda(fn)
        udas.append((out, uda, kern.ctx.sym[arg].build if arg else None))
        carry[out] = uda.init(4, np.float64)
    kern.make_agg_step([RefKey("service", "dict", 4, DT.STRING, d,
                               key_sval=kern.ctx.sym["service"])], udas, 4)
    rng = np.random.default_rng(5)

    def batch(n):
        return {"service": rng.integers(0, 3, n).astype(np.int32),
                "status": rng.choice([200, 500], n).astype(np.int64),
                "latency": rng.exponential(10.0, n)}

    a, b = batch(CARRY_ROWS), batch(CARRY_ROWS)
    lim = np.full((1,), INT64_MAX, dtype=np.int64)
    carry = kern.raw_agg_step(a, np.int64(CARRY_ROWS), np.int64(INT64_MIN), np.int64(INT64_MAX),
                              lim, kern.luts, carry)[0]
    carry = {k: jnp.asarray(v) if not isinstance(v, dict) else v for k, v in carry.items()}
    n_dev = RANKS * SHARDS
    step = ref_spmd.spmd_agg_step(kern.raw_agg_step, ref_spmd.reduce_tree_for(udas),
                                  ref_spmd.make_mesh(n_dev))
    nv = ref_spmd.per_shard_valid(CARRY_ROWS - 100, CARRY_ROWS, n_dev)
    want, want_total = step({k: v.reshape(n_dev, -1) for k, v in b.items()}, nv,
                            np.int64(INT64_MIN), np.int64(INT64_MAX), np.int64(INT64_MAX),
                            kern.luts, carry)
    sel = (b["status"][:CARRY_ROWS - 100] == 200).sum()
    assert docs[0]["total"] == docs[1]["total"] == int(want_total) == sel
    for r in range(RANKS):
        _same_states(_tree(states[r], "carry"), _np(want))


def test_two_rank_world_merge_moves_one_buffer_a_rank(job):
    """The partial step's world merge: one layout check, one all_gather of
    each rank's packed buffer (no staging on the CPU)."""
    docs, _ = job
    for doc in docs:
        st = doc["partial_stats"]
        assert st["world_merges"] == 1 and st["layout_checks"] == 1
        assert st["gathered_bytes"] > 0 and st["gathered_bytes"] % RANKS == 0
        assert st["staged_bytes"] == 0
    assert docs[0]["partial_stats"]["gathered_bytes"] == docs[1]["partial_stats"]["gathered_bytes"]


def test_two_rank_layout_mismatch_raises_on_every_rank(job):
    docs, _ = job
    for doc in docs:
        assert "layouts differ" in doc["mismatch"]


def test_executor_refuses_a_mesh_over_processes(job):
    docs, _ = job
    for doc in docs:
        assert "2 processes" in doc["executor"] and "multihost.py" in doc["executor"]
