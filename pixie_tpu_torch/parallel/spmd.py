"""SPMD aggregation over a mesh of shards co-located on one device.

Reference: pixie_tpu/parallel/spmd.py, which runs one plan fragment as an SPMD
program over a `jax.sharding.Mesh` axis ("agents") and merges the UDA state
inside the program with psum / pmin / pmax.  The reference's mesh is one
process with one controller: `make_mesh` is `Mesh(jax.devices()[:n])` and
`shard_map` runs every shard from that process.

The port's mesh is the same shape on one card: each shard owns a row block of
every feed and its own state, and the collective merge is kernel M1
(ops/merge.py `collective_merge`) over the shards' states — a leaf-wise add,
min or max of N states in one launch, which is what psum, pmin and pmax are.
The local device list is the executor's device (a card, or the CPU) repeated
PIXIE_TORCH_VIRTUAL_SHARDS times, the port's counterpart of XLA's
`--xla_force_host_platform_device_count`.

A mesh may also span processes (parallel/multihost.py `global_mesh`): each
position carries its process index, each process runs only its own
positions (`host_local_slice`), and the collective merge becomes M1 over the
local shards, one all_gather of the packed buffer and M1 over the world's
buffers (multihost.world_merge); the passed-row total is one int64
all_reduce.  One process over several distinct cards waits for a later
slice.

Correctness requirement, as in the reference: UDA init states are reduction
identities (zeros for add, +-inf for min/max), so a shard that gets no valid
row contributes nothing to the merge.
"""
from __future__ import annotations

import dataclasses
import os as _os
import threading as _threading
from typing import Callable, Optional

import numpy as np
import torch

from pixie_tpu_torch import flags as _flags
from pixie_tpu_torch import metrics as _metrics
from pixie_tpu_torch.ops.merge import collective_merge as _m1_merge
from pixie_tpu_torch.status import InvalidArgument

AGENT_AXIS = "agents"

#: The reference serializes collective-bearing executions on an all-CPU mesh
#: (XLA-CPU's rendezvous can deadlock two concurrent programs).  The port has
#: no rendezvous; it keeps the decision and its recorded reason for parity,
#: and a serialized call takes this lock and synchronizes (cheap, harmless).
_COLLECTIVE_EXEC_LOCK = _threading.Lock()

_flags.define_int(
    "PX_SERIALIZE_CPU_COLLECTIVES", -1,
    "serialize collective-bearing mesh executions through one process lock: "
    "-1 = auto (on iff every mesh device is a CPU), 0 = never, 1 = always")

_flags.define_str(
    "PIXIE_TPU_SPMD", "auto",
    "default-mesh gate: 0 disables SPMD over local devices (single-device "
    "execution); anything else auto-builds the pow2-clamped mesh.  Live: "
    "read at every default_mesh() call", live=True)

_flags.define_int(
    "PIXIE_TORCH_VIRTUAL_SHARDS", 1,
    "local device list length: the executor's device repeated this many "
    "times, so make_mesh(n) builds n co-located shards (the port's "
    "counterpart of --xla_force_host_platform_device_count)", live=True)

_gate_lock = _threading.Lock()
_gate_cache: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One mesh axis of `size` shards; `devices[i]` holds shard i and
    `processes[i]` is the process that runs it (default: every position on
    process 0, co-located shards of one device).  `group` is the
    torch.distributed group a mesh over processes spans (multihost.py), else
    None; it takes no part in equality."""

    devices: tuple
    axis_names: tuple = (AGENT_AXIS,)
    processes: tuple = ()
    group: object = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if not self.processes:
            object.__setattr__(self, "processes", (0,) * len(self.devices))
        if len(self.processes) != len(self.devices):
            raise InvalidArgument(f"{len(self.devices)} positions, "
                                  f"{len(self.processes)} process indices")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    @property
    def rank(self) -> int:
        """This process's index in the mesh's group (0 without one)."""
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    @property
    def spans_processes(self) -> bool:
        return len(set(self.processes)) > 1

    @property
    def local_slice(self) -> tuple[int, int]:
        """[start, stop) of this process's positions (contiguous: a mesh
        lists the processes' positions in process order)."""
        me = self.rank
        idx = [i for i, p in enumerate(self.processes) if p == me]
        return (idx[0], idx[-1] + 1) if idx else (0, 0)

    @property
    def local_size(self) -> int:
        lo, hi = self.local_slice
        return hi - lo

    @property
    def device(self) -> torch.device:
        """The device of this process's positions."""
        return self.devices[self.local_slice[0]]


def local_devices(device=None) -> list:
    """The port's local device list: `device` (default: the current CUDA
    card; without one it raises, see resolve_device) repeated
    PIXIE_TORCH_VIRTUAL_SHARDS times."""
    from pixie_tpu_torch.engine.executor import resolve_device

    dev = resolve_device(device)
    return [dev] * max(1, int(_flags.get("PIXIE_TORCH_VIRTUAL_SHARDS")))


def make_mesh(n_devices: Optional[int] = None, axis: str = AGENT_AXIS,
              device=None) -> Mesh:
    devs = local_devices(device)
    if n_devices is not None:
        if len(devs) < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices, have {len(devs)} ({devs[0].type}; "
                f"PIXIE_TORCH_VIRTUAL_SHARDS={len(devs)})")
        devs = devs[:n_devices]
    return Mesh(tuple(devs), (axis,))


def default_mesh(device=None) -> Optional[Mesh]:
    """The mesh over ALL local devices of `device`, clamped to a power of two,
    or None when that is one shard or PIXIE_TPU_SPMD=0.  This is what an
    executor built with mesh="auto" shards over; the flags are read at every
    call."""
    devs = local_devices(device)
    # Clamp to a power of two: feed buckets are pow2-sized, so a 6-shard
    # mesh would fail every `bucket % n_dev == 0` gate; a 4-shard one runs.
    n = 1 << (len(devs).bit_length() - 1)
    if _flags.get("PIXIE_TPU_SPMD") == "0" or n <= 1:
        return None
    return Mesh(tuple(devs[:n]))


def collective_gate(mesh: Optional[Mesh] = None, refresh: bool = False) -> dict:
    """The process-wide collective-serialization decision, decided once per
    (flag, platform, mesh width) and recorded: → {"serialize", "reason",
    "flag", "platform", "mesh_devices", "host_cores"}.
    PX_SERIALIZE_CPU_COLLECTIVES forces it (0/1); -1 = auto: serialize iff
    every mesh device is a CPU (the reference's "xla_cpu_shared_pool"
    decision, kept for parity), else not ("accelerator_hw_queues").  The
    executor records it in stats["device"]["collective_gate"]."""
    global _gate_cache
    devices = list(mesh.devices) if mesh is not None else local_devices()
    platform = devices[0].type
    n_mesh = mesh.size if mesh is not None else len(devices)
    with _gate_lock:
        flag = _flags.get("PX_SERIALIZE_CPU_COLLECTIVES")
        key = (flag, platform, n_mesh)
        if _gate_cache is not None and not refresh and _gate_cache.get("_key") == key:
            return _gate_cache
        all_cpu = all(d.type == "cpu" for d in devices)
        out = {"_key": key, "flag": flag, "platform": platform,
               "mesh_devices": int(n_mesh), "host_cores": _os.cpu_count() or 1}
        if flag == 0:
            out.update(serialize=False, reason="forced_off")
        elif flag == 1:
            out.update(serialize=True, reason="forced_on")
        elif all_cpu:
            out.update(serialize=True, reason="xla_cpu_shared_pool")
        else:
            out.update(serialize=False, reason="accelerator_hw_queues")
        _metrics.gauge_set(
            "px_collective_serialize_enabled", float(out["serialize"]),
            help_="1 when collective-bearing mesh executions serialize "
                  "through one process lock (PX_SERIALIZE_CPU_COLLECTIVES; "
                  "off on accelerators)")
        _gate_cache = out
        return out


def serialize_cpu_collectives(fn: Callable, mesh: Mesh) -> Callable:
    """`fn` as it is, or, when the gate says serialize, `fn` under the
    process lock followed by a synchronize of the mesh's device."""
    if not collective_gate(mesh)["serialize"]:
        return fn

    def run(*args, **kwargs):
        with _COLLECTIVE_EXEC_LOCK:
            out = fn(*args, **kwargs)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            return out

    return run


def reduce_tree_for(udas: list) -> dict:
    """State-structure-matching tree of reduce ops for a list of
    (out_name, UDA, value) triples (the executor's agg spec)."""
    return {name: uda.reduce_ops() for name, uda, _vb in udas}


def collective_merge(shard_states: list, reduce_tree, packed: bool = True, mesh=None):
    """Merge the shards' partial agg states into one (row 13: psum / pmin /
    pmax of each leaf over the mesh axis): kernel M1 on the card, its plain
    version on the CPU.  The merged state is packed (ops/merge.py): a
    `pack.Packed` for a readback, or with `packed=False` the tree of views
    of its buffer.  Over a `mesh` in a process group `shard_states` are this
    process's shards and the merge spans the group (multihost.world_merge):
    every rank gets the same bytes."""
    if mesh is not None and mesh.group is not None:
        from pixie_tpu_torch.parallel import multihost

        return multihost.world_merge(reduce_tree, list(shard_states), mesh, packed)
    return _m1_merge(reduce_tree, list(shard_states), packed)


def _map2(tree, carry, states, fn):
    if isinstance(tree, dict):
        return {k: _map2(tree[k], carry[k], [s[k] for s in states], fn) for k in tree}
    return fn(tree, carry, states)


def collective_merge_carry(carry, new_states: list, reduce_tree, mesh=None):
    """Merge shard states that were each seeded from a REPLICATED carry.

    Summing the full states would count the carried prefix once per shard,
    so an add leaf is `c + sum_i (x_i - c)`: M1 sums the per-shard deltas
    (integer deltas wrap, as the adds do).  Min and max are idempotent over
    the replicated carry, so M1 merges the full states.  Over a mesh in a
    process group the deltas merge across it (collective_merge)."""
    deltas = [_map2(reduce_tree, carry, [s], lambda op, c, xs: xs[0] - c if op == "add"
                    else xs[0]) for s in new_states]
    merged = collective_merge(deltas, reduce_tree, packed=False, mesh=mesh)
    return _map2(reduce_tree, carry, [merged],
                 lambda op, c, xs: c + xs[0] if op == "add" else xs[0])


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def shard_views(cols: dict, n_dev: int) -> list:
    """[cols of shard i] for i < n_dev: each column a contiguous row block of
    a padded 1-D column (length % n_dev == 0) or row i of an [n_dev, rows]
    one."""
    out = [dict() for _ in range(n_dev)]
    for k, v in cols.items():
        blocks = v if v.dim() == 2 else v.view(n_dev, v.shape[0] // n_dev)
        if blocks.shape[0] != n_dev:
            raise InvalidArgument(f"{k}: {blocks.shape[0]} shards, mesh has {n_dev}")
        for i in range(n_dev):
            out[i][k] = blocks[i]
    return out


def local_valid(n_valid, mesh: Mesh) -> list:
    """This process's per-shard valid counts from counts of every mesh
    position or of this process's alone."""
    nv = [int(x) for x in np.asarray(n_valid).reshape(-1)]
    lo, hi = mesh.local_slice
    if len(nv) == mesh.size and mesh.size != hi - lo:
        return nv[lo:hi]
    if len(nv) != hi - lo:
        raise InvalidArgument(f"{len(nv)} valid counts for a mesh of {mesh.size} "
                              f"positions, {hi - lo} of them local")
    return nv


def shard_step(fn: Callable, mesh: Mesh) -> Callable:
    """Lift fn(cols, n_valid, state) over this process's shards of the
    mesh: every shard runs it over its own row block and its own state (the
    executor keeps one state per shard, updated in place across a query's
    feeds, and merges them once, with `collective_merge`, after the last
    feed).

      lifted(cols, n_valid, states) → [fn's result per local shard]
        cols:    this process's shards: 1-D padded columns (length %
                 n_local == 0) or [n_local, rows]
        n_valid: per-shard valid counts (per_shard_valid) of every mesh
                 position or of this process's
        states:  one state per local shard
    """
    n_local = mesh.local_size

    def lifted(cols, n_valid, states):
        nv = local_valid(n_valid, mesh)
        return [fn(c, v, st) for c, v, st in zip(shard_views(cols, n_local), nv, states)]

    return serialize_cpu_collectives(lifted, mesh)


def spmd_agg_step(raw_step: Callable, reduce_tree, mesh: Mesh) -> Callable:
    """Lift a single-device agg step into an SPMD step over `mesh` (the carry
    form).

    raw_step(cols, n_valid, t_lo, t_hi, limits, luts, state, scalars=None)
    -> (state, count, consumed) is ChainKernel.raw_agg_step.  The lifted
    step takes [n_dev, rows_per_dev] (or padded 1-D) columns, int64[n_dev]
    per-shard valid counts and a REPLICATED state; every shard updates its
    own copy of it, and the lifted step returns the merged state (see
    collective_merge_carry) and the global passed-row count (over a mesh in
    a process group: one int64 all_reduce, the reference's lax.psum(cnt))."""
    def lifted(cols, n_valid, t_lo, t_hi, limits, luts, state, scalars=None):
        outs = shard_step(lambda c, v, st: raw_step(c, v, t_lo, t_hi, limits, luts, st, scalars),
                          mesh)(cols, n_valid, [_clone(state) for _ in range(mesh.local_size)])
        merged = collective_merge_carry(state, [o[0] for o in outs], reduce_tree, mesh)
        total = sum(int(o[1]) for o in outs)
        if mesh.group is not None:
            from pixie_tpu_torch.parallel import multihost

            total = multihost.all_reduce_int(total, mesh)
        return merged, total

    return lifted


def _identity_limits(n_limits: int, device) -> torch.Tensor:
    return torch.full((max(1, n_limits),), np.iinfo(np.int64).max, dtype=torch.int64,
                      device=device)


def spmd_partial_step(raw_step: Callable, init_state_fn: Callable, reduce_tree,
                      n_limits: int, mesh: Mesh) -> Callable:
    """Lift an agg step into an independent per-feed SPMD partial step: every
    shard starts from an identity state (init_state_fn()), runs over its row
    block, and the shards' states merge into one (across the processes of a
    mesh in a process group: cols are then this process's shards).

      lifted(cols, n_valid, t_lo, t_hi, luts, scalars=None) -> merged state
    """
    def lifted(cols, n_valid, t_lo, t_hi, luts, scalars=None):
        limits = _identity_limits(n_limits, mesh.device)
        outs = shard_step(lambda c, v, st: raw_step(c, v, t_lo, t_hi, limits, luts, st, scalars),
                          mesh)(cols, n_valid, [init_state_fn() for _ in range(mesh.local_size)])
        return collective_merge([o[0] for o in outs], reduce_tree, packed=False, mesh=mesh)

    return lifted


def spmd_multi_partial_step(members: list, mesh: Mesh) -> Callable:
    """Fuse N sibling agg steps over ONE shared sharded feed (the
    multi-query gang's mesh variant): members are (raw_step, init_state_fn,
    reduce_tree, n_limits); every member runs over each shard and its
    shards' states merge into one.  (The executor's own gang runs kernel G1
    per shard instead, see PlanExecutor._multi_partial_agg.)

      lifted(cols, n_valid, t_lo, t_hi, luts_tuple) -> tuple(states)
    """
    lifted = [spmd_partial_step(raw, init, rt, nl, mesh) for raw, init, rt, nl in members]

    def run(cols, n_valid, t_lo, t_hi, luts_tuple, scalars=None):
        return tuple(f(cols, n_valid, t_lo, t_hi, luts, scalars)
                     for f, luts in zip(lifted, luts_tuple))

    return run


def shard_batches(cols: dict, n_devices: int) -> dict:
    """Host helper: split padded columns into [n_dev, rows/n_dev] blocks.

    Rows must already be padded to a multiple of n_devices. Pair with
    `per_shard_valid` for the matching per-shard valid counts.
    """
    out = {}
    for k, v in cols.items():
        n = len(v)
        if n % n_devices:
            raise InvalidArgument(f"{k}: {n} rows not divisible by {n_devices}")
        out[k] = v.reshape(n_devices, n // n_devices)
    return out


def per_shard_valid(n_valid: int, total_rows: int, n_devices: int) -> np.ndarray:
    """Valid counts per shard for a prefix-valid padded batch split row-major."""
    per = total_rows // n_devices
    starts = np.arange(n_devices) * per
    return np.clip(n_valid - starts, 0, per).astype(np.int64)
