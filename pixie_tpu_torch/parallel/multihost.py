"""Multi-process execution: torch.distributed and a mesh across processes.

Reference: pixie_tpu/parallel/multihost.py, which joins one process per host
through `jax.distributed` and builds a global mesh over every process's
devices; each process feeds only its host-local shards and the jitted psum
over the mesh spans processes.

The port's counterpart is a process group: one process per card (or several
sharing a card), joined by `torch.distributed` through a TCP rendezvous.

  * `init_multihost(coordinator, num_processes, process_id, device)` joins
    the group (the PX_JAX_* flags are kept, so one launch line drives either
    package); with no coordinator it returns False, as the reference does.
  * The backend is decided by topology and recorded (`describe()`): NCCL
    when every rank of the host owns a distinct CUDA card (rank → cuda:local
    rank); gloo on the CPU and when ranks share one card, which NCCL refuses.
    PX_TORCH_DIST_BACKEND forces either; NCCL forced onto a shared card or
    the CPU raises.
  * `global_mesh()` lists every process's local shards in process order,
    with the reference's power-of-two clamp applied per host; each
    process's shards are its device repeated PIXIE_TORCH_VIRTUAL_SHARDS
    times (read when the process joins).  In a one-process world it equals
    spmd.default_mesh().
  * `world_merge` is the collective merge of a mesh that spans processes
    (parallel/spmd.py `collective_merge`): M1 merges the local shards into
    its packed buffer, one all_gather moves the buffers, and M1 merges them
    in mesh order, so every rank holds the same bytes, as psum's replicated
    output.  The reduce stays in M1; the collective only moves bytes.
  * `all_gather_bytes` and `all_to_all_rows` are the transports.  NCCL moves
    device buffers.  Gloo with CUDA tensors stages them through pinned host
    buffers (that is the gloo transport's form, counted in `exec_stats()`).

`launch` starts the ranks of a job as fresh processes (`subprocess`, never a
fork) and waits for them with a deadline; a failed rank raises with its
stderr and its peers are killed.
"""
from __future__ import annotations

import datetime
import hashlib
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from pixie_tpu_torch import flags
from pixie_tpu_torch.ops import merge as _merge
from pixie_tpu_torch.ops.pack import Packed, worth_packing
from pixie_tpu_torch.parallel import spmd as _spmd
from pixie_tpu_torch.status import Internal, InvalidArgument

COORD_FLAG = flags.define_str(
    "PX_JAX_COORDINATOR", "", "host:port of the process group's TCP rendezvous "
    "(empty = single-process)")
NPROC_FLAG = flags.define_int(
    "PX_JAX_NUM_PROCESSES", 1, "process count in the distributed job")
PROC_ID_FLAG = flags.define_int(
    "PX_JAX_PROCESS_ID", 0, "this process's id in the distributed job")
BACKEND_FLAG = flags.define_str(
    "PX_TORCH_DIST_BACKEND", "", "torch.distributed backend: '' = by topology "
    "(nccl when every rank of the host owns a distinct CUDA card, else gloo), "
    "'nccl' or 'gloo' forces it")
#: seconds a rendezvous or a collective may wait for a peer
DIST_TIMEOUT_S = 300

_lock = threading.Lock()
#: the joined world: backend, device, rank, world size and the topology
#: every rank reported when it joined
_world: dict = {}
#: transport and merge counters since the last reset_exec_stats()
_STATS_ZERO = {"world_merges": 0, "layout_checks": 0, "gathered_bytes": 0,
               "merge_wall_s": 0.0, "exchanges": 0, "all_to_all_calls": 0,
               "exchange_sent_bytes": 0, "exchange_recv_bytes": 0,
               "exchange_wall_s": 0.0, "staged_bytes": 0, "all_reduces": 0}
_stats = dict(_STATS_ZERO)
#: layout digests already checked across the world
_checked: set = set()


def _local_rank(process_id: int, num_processes: int) -> tuple[int, int]:
    """(local rank, ranks on this host): torchrun's LOCAL_RANK /
    LOCAL_WORLD_SIZE when set, else one host holds every rank."""
    if "LOCAL_RANK" in os.environ and "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_RANK"]), int(os.environ["LOCAL_WORLD_SIZE"])
    return process_id, num_processes


def choose_backend(device, process_id: int, local_world: int) -> tuple:
    """→ (backend, this rank's device, reason).  `device` None or "cuda"
    (no index) follows the topology: a distinct card a rank (cuda:local
    rank) when the host has at least `local_world` cards, which NCCL
    serves, else the current card shared by every rank, over gloo.  An
    explicit "cuda:k" is that card over gloo.  The CPU is gloo.
    PX_TORCH_DIST_BACKEND forces the backend; NCCL forced onto the CPU or a
    shared card raises."""
    from pixie_tpu_torch.engine.executor import resolve_device

    forced = str(flags.get("PX_TORCH_DIST_BACKEND")).lower()
    if forced not in ("", "nccl", "gloo"):
        raise InvalidArgument(f"PX_TORCH_DIST_BACKEND={forced!r}: '', 'nccl' or 'gloo'")
    dev = resolve_device(device)
    if dev.type != "cuda":
        if forced == "nccl":
            raise InvalidArgument(f"NCCL needs CUDA devices, the job runs on {dev}")
        return "gloo", dev, "cpu"
    explicit = device is not None and torch.device(device).index is not None
    distinct = not explicit and torch.cuda.device_count() >= local_world
    if distinct:
        dev = torch.device("cuda", process_id % max(1, local_world))
    elif dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if forced == "nccl" and not distinct:
        raise InvalidArgument(
            f"NCCL refuses two ranks on one card: {local_world} ranks on this host, "
            f"{torch.cuda.device_count()} cards visible" + (f", {dev} pinned" if explicit
                                                            else ""))
    if forced == "gloo":
        return "gloo", dev, "forced"
    if distinct:
        return "nccl", dev, "distinct_cards"
    return "gloo", dev, "shared_card"


def init_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, device=None) -> bool:
    """Join (or skip) a multi-process job.  Args default to the PX_JAX_*
    flags; returns True when this process is in a process group.  `device`
    None: the card (engine/executor.py resolve_device); "cpu" runs the job
    on the CPU."""
    import torch.distributed as dist

    coordinator = coordinator or flags.get("PX_JAX_COORDINATOR")
    if not coordinator:
        return False
    with _lock:
        if _world:
            return True
        n = int(num_processes or flags.get("PX_JAX_NUM_PROCESSES"))
        pid = int(process_id if process_id is not None else flags.get("PX_JAX_PROCESS_ID"))
        local_rank, local_world = _local_rank(pid, n)
        backend, dev, reason = choose_backend(device, local_rank, local_world)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=n,
                                rank=pid, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        shards = max(1, int(flags.get("PIXIE_TORCH_VIRTUAL_SHARDS")))
        topo = [None] * n
        dist.all_gather_object(topo, (str(dev), shards))
        _world.update(backend=backend, reason=reason, device=dev, rank=pid, size=n,
                      coordinator=coordinator,
                      devices=[torch.device(d) for d, _s in topo],
                      shards=[s for _d, s in topo])
        return True


def shutdown() -> None:
    """Leave the process group (every rank calls it) and forget the world."""
    import torch.distributed as dist

    with _lock:
        if _world and dist.is_initialized():
            dist.destroy_process_group()
        _world.clear()
        _checked.clear()


def global_mesh(axis: str = _spmd.AGENT_AXIS, device=None):
    """The mesh over every process's shards, in process order, or None when
    that is one shard.  Without a process group it is spmd.default_mesh()
    of `device`.

    The pow2 clamp applies PER HOST, never to the global list (a global
    clamp could leave a process with no position): every process keeps the
    same number of its own shards, the fewest any process reported."""
    if not _world:
        return _spmd.default_mesh(device)
    n_proc = _world["size"]
    per_host = min(_world["shards"])
    per_host = 1 << (per_host.bit_length() - 1)
    if flags.get("PIXIE_TPU_SPMD") == "0" or per_host * n_proc <= 1:
        return None
    import torch.distributed as dist

    devices, procs = [], []
    for r, d in enumerate(_world["devices"]):
        devices.extend([d] * per_host)
        procs.extend([r] * per_host)
    return _spmd.Mesh(tuple(devices), (axis,), tuple(procs), dist.group.WORLD)


def host_local_slice(mesh) -> tuple[int, int]:
    """[start, stop) positions of THIS process's shards along the mesh axis:
    the data-placement contract of multi-process feeds (each process feeds
    only its own shards)."""
    if mesh is None:
        return (0, 0)
    return mesh.local_slice


def describe() -> dict:
    """Topology snapshot for logs and metrics: the reference's keys and the
    backend."""
    if not _world:
        from pixie_tpu_torch.engine.executor import resolve_device
        from pixie_tpu_torch.status import Unavailable

        try:
            dev = resolve_device(None)
        except Unavailable:  # no card: the single-process CPU job
            dev = torch.device("cpu")
        shards = max(1, int(flags.get("PIXIE_TORCH_VIRTUAL_SHARDS")))
        return {"initialized": False, "process_index": 0, "process_count": 1,
                "local_devices": shards, "global_devices": shards,
                "platform": "gpu" if dev.type == "cuda" else dev.type, "backend": None}
    dev = _world["device"]
    return {"initialized": True, "process_index": _world["rank"],
            "process_count": _world["size"], "local_devices": _world["shards"][_world["rank"]],
            "global_devices": sum(_world["shards"]),
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "backend": _world["backend"], "backend_reason": _world["reason"],
            "device": str(dev)}


# ------------------------------------------------------------- transports
def exec_stats() -> dict:
    """Counters of the world merges, exchanges and the bytes they moved and
    staged, since the last reset."""
    with _lock:
        return dict(_stats)


def reset_exec_stats() -> None:
    with _lock:
        _stats.clear()
        _stats.update(_STATS_ZERO)


def _count(**kw) -> None:
    with _lock:
        for k, v in kw.items():
            _stats[k] += v


def _comm_device() -> torch.device:
    """Where small control tensors (counts, digests, totals) live for a
    collective: the rank's card for NCCL, the host for gloo."""
    return _world["device"] if _world.get("backend") == "nccl" else torch.device("cpu")


def _staged(t: torch.Tensor) -> bool:
    """Whether a collective on `t` goes through pinned host buffers: gloo
    with a CUDA tensor."""
    return t.is_cuda and _world.get("backend") == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_gather_bytes(buf: torch.Tensor, mesh) -> torch.Tensor:
    """→ [world * buf.numel()] uint8 on buf's device: every rank's buffer in
    rank order.  One all_gather; gloo with a CUDA buffer stages it through
    pinned host memory."""
    import torch.distributed as dist

    world = dist.get_world_size(mesh.group)
    n = buf.numel()
    staged = _staged(buf)
    src = _to_host(buf) if staged else buf.contiguous()
    out = (torch.empty(world * n, dtype=torch.uint8, pin_memory=True) if staged
           else torch.empty(world * n, dtype=torch.uint8, device=buf.device))
    dist.all_gather(list(out.view(world, n).unbind(0)), src, group=mesh.group)
    _count(gathered_bytes=world * n, staged_bytes=(world + 1) * n if staged else 0)
    return out.to(buf.device, non_blocking=True) if staged else out


def all_to_all_rows(col: torch.Tensor, send: list, recv: list, mesh) -> torch.Tensor:
    """One all_to_all_single of a 1-D column: send[r] rows to rank r (its
    rows in rank order), recv[r] rows from rank r → the received rows, on
    col's device."""
    import torch.distributed as dist

    staged = _staged(col)
    src = _to_host(col) if staged else col.contiguous()
    total = int(sum(recv))
    out = (torch.empty(total, dtype=col.dtype, pin_memory=True) if staged
           else torch.empty(total, dtype=col.dtype, device=col.device))
    dist.all_to_all_single(out, src, output_split_sizes=[int(x) for x in recv],
                           input_split_sizes=[int(x) for x in send], group=mesh.group)
    width = col.element_size()
    _count(all_to_all_calls=1, exchange_sent_bytes=int(sum(send)) * width,
           exchange_recv_bytes=total * width,
           staged_bytes=(src.numel() + total) * width if staged else 0)
    return out.to(col.device, non_blocking=True) if staged else out


def all_to_all_counts(counts: np.ndarray, mesh) -> np.ndarray:
    """counts: int64 [world, k] (row r for rank r) → [world, k], row r from
    rank r.  One small all_to_all_single, on the host for gloo and on the
    card for NCCL."""
    import torch.distributed as dist

    world = dist.get_world_size(mesh.group)
    t = torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int64)).reshape(-1)
    t = t.to(_comm_device())
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=mesh.group)
    return out.cpu().numpy().reshape(world, -1)


def all_reduce_int(value: int, mesh) -> int:
    """The sum of an int over the mesh's processes (the reference's
    lax.psum of the passed-row count): one int64 all_reduce."""
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64, device=_comm_device())
    dist.all_reduce(t, group=mesh.group)
    _count(all_reduces=1)
    return int(t.item())


# ------------------------------------------------------------ world merge
def layout_digest(layout) -> int:
    """A 63-bit fingerprint of a packed layout: its leaves' paths, dtypes,
    shapes and offsets."""
    text = repr((layout.paths, tuple(str(d) for d in layout.dtypes), layout.shapes,
                 layout.offsets, layout.nbytes))
    return int.from_bytes(hashlib.blake2b(text.encode(), digest_size=8).digest(),
                          "little") >> 1


def check_layout(layout, mesh) -> None:
    """Every rank's merged layout must be this one: checked once a layout
    (one all_gather of its digest), as the reference's psum would fail to
    trace states of different shapes.  Raises InvalidArgument on a
    mismatch (on every rank)."""
    import torch.distributed as dist

    digest = layout_digest(layout)
    key = (digest, id(mesh.group))
    if key in _checked:
        return
    world = dist.get_world_size(mesh.group)
    mine = torch.tensor([digest, layout.nbytes], dtype=torch.int64, device=_comm_device())
    got = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(got, mine, group=mesh.group)
    got = [tuple(int(v) for v in g.cpu()) for g in got]
    _count(layout_checks=1)
    if any(g != got[0] for g in got):
        raise InvalidArgument(
            f"world merge: the ranks' state layouts differ (digest, bytes by rank: {got})")
    _checked.add(key)


def world_merge(reduce_tree, local_states: list, mesh, packed: bool = True):
    """The collective merge of a mesh that spans processes: this process's
    shard states merged by M1 into one packed buffer, that buffer gathered
    from every rank (one all_gather), and the world's buffers merged by M1
    in rank order, which is mesh order.  Every rank returns the same bytes:
    a Packed, or with `packed=False` the tree of views of its buffer."""
    t0 = time.perf_counter()
    local = _merge.merge_packed(reduce_tree, list(local_states))
    layout = local.layout
    check_layout(layout, mesh)
    gathered = all_gather_bytes(local.buf, mesh)
    n = layout.nbytes
    world = gathered.numel() // n if n else 1
    states = [Packed(gathered[r * n:(r + 1) * n], layout) for r in range(world)]
    merged = _merge.merge_packed(reduce_tree, states)
    _count(world_merges=1, merge_wall_s=time.perf_counter() - t0)
    if packed and worth_packing(list(zip(layout.paths, layout.dtypes, layout.shapes))):
        return merged
    return merged.tree()


# ------------------------------------------------------------- the launch
def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: a rank's stderr naming one of these: the rendezvous itself failed (its
#: port taken by another process, or the c10d store that rank 0 serves not
#: coming up or going away while the ranks joined), not the job
_RENDEZVOUS_ERRORS = ("address already in use", "eaddrinuse", "[c10d]", "tcpstore",
                      "diststoreerror", "distnetworkerror")
#: attempts at a job whose rendezvous failed, each on a new port
RENDEZVOUS_ATTEMPTS = 3


def _rendezvous_failed(err: str) -> bool:
    err = err.lower()
    return any(s in err for s in _RENDEZVOUS_ERRORS)


def launch(argv_of: Callable[[int], list], processes: int, env: dict,
           timeout: float) -> list[str]:
    """Run `processes` ranks of one job, each `[sys.executable, *argv_of(rank)]`
    started fresh (never forked), with `env` and the PX_JAX_* flags of its
    rank (a rendezvous on a free localhost port, bound as late as possible).
    → each rank's stdout.  Every wait shares one deadline of `timeout`
    seconds; a rank that exits non-zero or outlives it raises Internal with
    its stderr, after its peers are killed.  A job whose rendezvous failed
    (its port taken, the store lost) is run again on a new port, up to
    RENDEZVOUS_ATTEMPTS times in all."""
    for attempt in range(RENDEZVOUS_ATTEMPTS):
        coord = f"127.0.0.1:{free_port()}"
        procs = []
        try:
            for rank in range(processes):
                # one host: gloo's pairs on the loopback, as the rendezvous
                rank_env = {"GLOO_SOCKET_IFNAME": "lo", **env, "PX_JAX_COORDINATOR": coord,
                            "PX_JAX_NUM_PROCESSES": str(processes),
                            "PX_JAX_PROCESS_ID": str(rank)}
                procs.append(subprocess.Popen(
                    [sys.executable, *argv_of(rank)], stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, env=rank_env, text=True))
            return _wait_all(procs, timeout)
        except _RendezvousFailed as e:
            if attempt == RENDEZVOUS_ATTEMPTS - 1:
                raise Internal(f"the rendezvous failed {RENDEZVOUS_ATTEMPTS} times (last on "
                               f"{coord}): {e}") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    raise Internal("unreachable")


class _RendezvousFailed(Exception):
    pass


def _wait_all(procs: list, timeout: float) -> list[str]:
    """Collect every rank's output under one deadline; a failed rank's
    stderr raises (peers are killed by the caller)."""
    deadline = time.monotonic() + timeout
    outs: list = [None] * len(procs)
    errs: list = [None] * len(procs)

    def reader(i, p):
        outs[i], errs[i] = p.communicate()

    threads = [threading.Thread(target=reader, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    while True:
        done = [p.poll() is not None for p in procs]
        failed = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
        if failed or all(done) or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    if failed:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in threads:
            t.join(30)
        if any(_rendezvous_failed(errs[i] or "") for i in failed):
            raise _RendezvousFailed("; ".join(f"rank {i}: {(errs[i] or '')[-1000:]}"
                                              for i in failed))
        raise Internal("; ".join(f"rank {i} exited with {procs[i].returncode}: "
                                 f"{(errs[i] or '')[-3000:]}" for i in failed))
    if not all(done):
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in threads:
            t.join(30)
        late = [i for i, d in enumerate(done) if not d]
        raise Internal(f"ranks {late} did not finish in {timeout} s; rank {late[0]} "
                       f"stderr: {(errs[late[0]] or '')[-4000:]}")
    for t in threads:
        t.join(30)
    return [o or "" for o in outs]
