"""Value-keyed partial aggregate transport + merge.

Reference: the splitter rewrites Agg into partial_agg (PEM) whose output rows
carry serialized UDA state strings, merged by finalize_results on Kelvin
(planpb/plan.proto:250-257, udf/udf.h:326-368 Serialize/Deserialize).

Copied from the reference package (pixie_tpu/parallel/partial.py).  UDA state
is a tree of dense arrays, so "serialization" is just numpy — a
PartialAggBatch holds the seen groups' key VALUES (decoded out of the
producing agent's private dictionary space) plus each UDA's state leaves
sliced to those groups.  Merging re-groups by key values and reduces each leaf
with the UDA's declared reduce op — no per-UDA merge code; the same reduce
tree drives the device gang merge (ops/merge.py, kernel M1).
PartialAggFold folds a stream of partial chunks as they arrive (the
executor's `run_agent_stream` yields them).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from pixie_tpu_torch.engine.executor import HostBatch
from pixie_tpu_torch.plan.plan import AggOp
from pixie_tpu_torch.status import Internal, InvalidArgument
from pixie_tpu_torch.table.dictionary import Dictionary
from pixie_tpu_torch.types import STORAGE_DTYPE, DataType as DT


@dataclasses.dataclass
class PartialAggBatch:
    """Seen-group key values + per-UDA state leaves for one producer."""

    #: group key name -> np array of VALUES (object array for strings/UPIDs)
    key_cols: dict
    #: group key name -> DataType
    key_dtypes: dict
    #: uda out_name -> pytree of np arrays, leading dim = num seen groups
    states: dict
    #: uda out_name -> input DataType (None for nullary)
    in_types: dict

    @property
    def num_groups(self) -> int:
        for v in self.key_cols.values():
            return len(v)
        for tree in self.states.values():
            leaves = _leaves(tree)
            return len(leaves[0]) if leaves else 0
        return 0

    # Wire format (the TransferResultChunk analog for state channels): the
    # services.wire binary frame — self-describing header + raw buffers, no
    # pickle (untrusted bytes never reach an unpickler).
    def to_bytes(self) -> bytes:
        from pixie_tpu_torch.services.wire import encode_partial_agg

        return encode_partial_agg(self)

    @staticmethod
    def from_bytes(b: bytes) -> "PartialAggBatch":
        from pixie_tpu_torch.services.wire import decode_frame

        kind, pb = decode_frame(b)
        if kind != "partial_agg":
            raise InvalidArgument(f"expected partial_agg frame, got {kind}")
        return pb


def _leaves(tree):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves(tree[k]))
        return out
    return [tree]


def _tree_map2(fn, ops_tree, state_tree):
    if isinstance(ops_tree, dict):
        return {k: _tree_map2(fn, ops_tree[k], state_tree[k]) for k in ops_tree}
    return fn(ops_tree, state_tree)


_NP_REDUCE = {
    "add": np.add,
    "min": np.minimum,
    "max": np.maximum,
}


def combine_partials(
    agg: AggOp, partials: list[PartialAggBatch], registry
) -> PartialAggBatch:
    """Reduce value-keyed partials from N producers into ONE partial batch.

    Host-side segment reduction over the concatenated group rows — states are
    tiny (seen groups only), so this stays off-device; the heavy per-row work
    already happened on each producer's device.  The result is still raw state
    (use finalize_partial), which is what lets the streaming executor carry
    open-window state across polls and keep merging into it.
    """
    parts = [p for p in partials if p.num_groups > 0]
    if not parts:
        parts = [p for p in partials[:1]]
    if not parts:
        raise InvalidArgument("combine_partials: no partial batches")
    first = parts[0]
    keys = list(first.key_cols)

    # Composite group identity across producers (VALUES, not codes).
    if keys:
        cols_cat = {
            k: np.concatenate([np.asarray(p.key_cols[k], dtype=object) if first.key_dtypes[k] in (DT.STRING, DT.UINT128) else np.asarray(p.key_cols[k]) for p in parts])
            for k in keys
        }
        if len(keys) == 1:
            comp = cols_cat[keys[0]]
        else:
            comp = np.array(list(zip(*[cols_cat[k] for k in keys])), dtype=object)
            comp = np.fromiter((tuple(r) for r in comp), dtype=object, count=len(comp))
        uniq, inverse = np.unique(comp, return_inverse=True)
        g = len(uniq)
        first_idx = np.full(g, -1, np.int64)
        first_idx[inverse[::-1]] = np.arange(len(inverse))[::-1]
    else:
        total = sum(p.num_groups for p in parts)
        inverse = np.zeros(total, np.int64)
        g = 1
        first_idx = np.zeros(1, np.int64)

    key_cols = {k: cols_cat[k][first_idx] for k in keys}

    states: dict = {}
    for ae in agg.values:
        uda = registry.uda(ae.fn)
        ops_tree = uda.reduce_ops()
        # Concatenate each leaf across producers, then segment-reduce by the
        # merged group id.
        def merge_leaf(op, leaf_list):
            cat = np.concatenate(leaf_list, axis=0)
            shape = (g,) + cat.shape[1:]
            if op == "add":
                out = np.zeros(shape, dtype=cat.dtype)
                np.add.at(out, inverse, cat)
            elif op == "min":
                out = np.full(shape, _np_identity(cat.dtype, "min"))
                np.minimum.at(out, inverse, cat)
            else:
                out = np.full(shape, _np_identity(cat.dtype, "max"))
                np.maximum.at(out, inverse, cat)
            return out

        def walk(ops_t, trees):
            if isinstance(ops_t, dict):
                return {k: walk(ops_t[k], [t[k] for t in trees]) for k in ops_t}
            return merge_leaf(ops_t, trees)

        states[ae.out_name] = walk(ops_tree, [p.states[ae.out_name] for p in parts])

    return PartialAggBatch(
        key_cols=key_cols,
        key_dtypes=dict(first.key_dtypes),
        states=states,
        in_types=dict(first.in_types),
    )


def slice_partial(pb: PartialAggBatch, idx: np.ndarray) -> PartialAggBatch:
    """Subset of a partial batch's groups (streaming window close/retain)."""
    return PartialAggBatch(
        key_cols={k: np.asarray(v)[idx] for k, v in pb.key_cols.items()},
        key_dtypes=dict(pb.key_dtypes),
        states={
            name: _map_tree(lambda x: np.asarray(x)[idx], tree)
            for name, tree in pb.states.items()
        },
        in_types=dict(pb.in_types),
    )


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def finalize_partial(
    agg: AggOp, pb: PartialAggBatch, registry
) -> HostBatch:
    """Finalize one (already combined) partial batch → result rows."""
    g = pb.num_groups
    out_cols: dict[str, np.ndarray] = {}
    out_dtypes: dict[str, DT] = {}
    out_dicts: dict[str, Dictionary] = {}
    for k, vals in pb.key_cols.items():
        dt = pb.key_dtypes[k]
        out_dtypes[k] = dt
        if dt in (DT.STRING, DT.UINT128):
            d = Dictionary()
            out_cols[k] = d.encode(np.asarray(vals, dtype=object).tolist())
            out_dicts[k] = d
        else:
            out_cols[k] = np.asarray(
                np.asarray(vals).tolist(), dtype=STORAGE_DTYPE[dt]
            )
    for ae in agg.values:
        uda = registry.uda(ae.fn)
        if getattr(uda, "needs_dict", False):
            # unreachable by plan construction: dict-input aggregates ship
            # ROWS across agents (distributed.py), never partial state
            raise Internal(
                f"UDA {ae.fn} needs its input dictionary; partial-state "
                "channels cannot carry dict-input aggregates")
        # finalize_host is host-pure by contract (no instance state from
        # init), so no device state is built here.
        col = uda.finalize_host(pb.states[ae.out_name])
        out_dt = uda.out_type(pb.in_types.get(ae.out_name))
        vals = np.asarray(col)
        out_dtypes[ae.out_name] = out_dt
        if out_dt == DT.STRING:
            d = Dictionary()
            out_cols[ae.out_name] = d.encode(vals.tolist())
            out_dicts[ae.out_name] = d
        else:
            out_cols[ae.out_name] = vals.astype(STORAGE_DTYPE[out_dt], copy=False)
    return HostBatch(out_dtypes, out_dicts, out_cols)


def merge_partials(
    agg: AggOp, partials: list[PartialAggBatch], registry
) -> HostBatch:
    """Merge value-keyed partials from N producers and finalize → HostBatch."""
    return finalize_partial(agg, combine_partials(agg, partials, registry), registry)


class PartialAggFold:
    """Running merge of partial-agg chunks, folded AS THEY ARRIVE.

    The streaming analog of merge_partials: a consumer calls add() for each
    producer chunk, so combine work happens under the slowest producer's
    compute instead of behind an all-producers barrier.  combine_partials
    re-groups by key VALUES, so folds commute — chunk arrival order
    (including cross-producer interleaving and out-of-order delivery) cannot
    change the result.

    Chunks stage in batches of FOLD_BATCH: each full batch combines on
    arrival (the incremental work), and finish() pays ONE combine over the
    staged results plus the finalize.  A per-chunk rolling accumulator would
    re-group the whole accumulated key set on every add — O(chunks x
    total_groups) for high-cardinality aggs; batching bounds the total work
    at ~2x the barrier merge while keeping the overlap.

    Thread model: callers serialize add() per channel; finish() runs after
    all producers completed.
    """

    FOLD_BATCH = 8

    __slots__ = ("agg", "registry", "count", "_staged", "_pending")

    def __init__(self, agg: AggOp, registry):
        self.agg = agg
        self.registry = registry
        self.count = 0
        self._staged: list[PartialAggBatch] = []
        self._pending: list[PartialAggBatch] = []

    def add(self, pb: PartialAggBatch) -> None:
        self.count += 1
        self._pending.append(pb)
        if len(self._pending) >= self.FOLD_BATCH:
            self._staged.append(
                combine_partials(self.agg, self._pending, self.registry))
            self._pending = []

    def finish(self) -> HostBatch:
        parts = self._staged + self._pending
        if not parts:
            raise InvalidArgument("PartialAggFold.finish: no chunks folded")
        acc = (parts[0] if len(parts) == 1
               else combine_partials(self.agg, parts, self.registry))
        return finalize_partial(self.agg, acc, self.registry)

    def raw_parts(self) -> list[PartialAggBatch]:
        """The accumulated state WITHOUT finalizing — staged combines plus
        the pending tail, so a caller can merge several independent folds
        (one per producer) into one finalize."""
        return self._staged + self._pending


def _np_identity(dtype, op: str):
    d = np.dtype(dtype)
    if d.kind == "f":
        return np.inf if op == "min" else -np.inf
    info = np.iinfo(d)
    return info.max if op == "min" else info.min
