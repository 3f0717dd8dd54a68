"""State carried across from the reference package, as plain data.

The system has no weights: what carries across is a plan, table contents and
partial-aggregate UDA states.  Every function here takes or returns plain
dicts and numpy arrays, so either package's output can feed the other without
one importing the other:

  * plan_from_dict(d)              — a Plan from `Plan.to_dict()` output;
  * store_from_columns(tables)     — a TableStore from {name: (relation spec,
                                     {column: numpy array})};
  * states_from_numpy(udas, s, device) — UDA states as tensors on `device`,
                                     with the reference's tree shapes and
                                     dtypes (MeanUDA {"sum": f64[G],
                                     "count": i64[G]}, QuantileUDA f32[G, 514]);
  * states_to_numpy(states)        — the inverse;
  * kmeans_from_numpy(k, max_iters, seed, centers) — a fitted KMeans
                                     holding the reference's centers;
  * coreset_tree_from_numpy(m, k, seed, levels, n_seen) — a CoresetTree
                                     holding the reference's levels
                                     ({level: (points, weights)}).
"""
from __future__ import annotations

import numpy as np
import torch

from pixie_tpu_torch.ml import CoresetTree, KMeans
from pixie_tpu_torch.plan.plan import Plan
from pixie_tpu_torch.status import InvalidArgument
from pixie_tpu_torch.table.table import DEFAULT_BATCH_ROWS, TableStore
from pixie_tpu_torch.types import Relation
from pixie_tpu_torch.udf.udf import UDA, tree_map


def plan_from_dict(d: dict) -> Plan:
    """Plan from its plain-dict form (`Plan.to_dict()` of either package)."""
    return Plan.from_dict(d)


def store_from_columns(tables: dict, batch_rows: int = DEFAULT_BATCH_ROWS,
                       max_bytes: int = 1 << 36) -> TableStore:
    """TableStore holding `tables`: name → (relation spec, {column: array}).
    The relation spec is `Relation.to_dict()` output (a list of {"name",
    "type", "st"} dicts); the columns are written in one write, so the same
    input gives the same dictionary codes and batches as the reference."""
    store = TableStore()
    for name, (spec, cols) in tables.items():
        rel = Relation.from_dict(spec)
        store.create(name, rel, batch_rows=batch_rows,
                     max_bytes=max_bytes).write(dict(cols))
    return store


def states_from_numpy(udas: dict[str, UDA], state_np: dict, device) -> dict:
    """{out_name: UDA} and {out_name: numpy state tree} → tensors on `device`.
    Each tree must have the UDA's structure (its reduce_ops tree); leaves keep
    their dtypes and shapes."""
    out = {}
    for name, uda in udas.items():
        if name not in state_np:
            raise InvalidArgument(f"no state for aggregate {name!r}")
        ops, st = uda.reduce_ops(), state_np[name]
        if isinstance(ops, dict) != isinstance(st, dict) or (
                isinstance(ops, dict) and set(ops) != set(st)):
            raise InvalidArgument(
                f"state of {name!r} does not have the {type(uda).__name__} layout")
        out[name] = tree_map(
            lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(device), st)
    return out


def states_to_numpy(states: dict) -> dict:
    """Inverse of states_from_numpy: every leaf as a host numpy array."""
    return {name: tree_map(lambda t: t.detach().cpu().numpy(), st)
            for name, st in states.items()}


def kmeans_from_numpy(k: int, max_iters: int, seed: int, centers,
                      device=None) -> KMeans:
    """A fitted KMeans whose model is `centers` ([k, d], e.g. the reference
    KMeans's `.centers`)."""
    c = np.asarray(centers, dtype=np.float32)
    if c.ndim != 2 or c.shape[0] != k:
        raise InvalidArgument(f"centers of shape {c.shape} for k={k}")
    return KMeans(k=k, max_iters=max_iters, seed=seed, centers=c, device=device)


def coreset_tree_from_numpy(m: int, k: int, seed: int, levels: dict, n_seen: int,
                            device=None) -> CoresetTree:
    """A CoresetTree holding `levels` ({level: (points [., d], weights [.])},
    e.g. the reference tree's `_levels`) after `n_seen` points."""
    tree = CoresetTree(m=m, k=k, seed=seed, device=device)
    for level, (pts, w) in levels.items():
        pts = np.asarray(pts, dtype=np.float32)
        w = np.asarray(w, dtype=np.float32)
        if pts.ndim != 2 or w.shape != (len(pts),):
            raise InvalidArgument(f"level {level}: points {pts.shape}, weights {w.shape}")
        tree._levels[int(level)] = (pts, w)
    tree._n_seen = int(n_seen)
    return tree
