"""UDF/UDA framework.

Parity with the reference's type-safe registry (src/carnot/udf/registry.h:101,
udf/udf.h): ScalarUDFs implement Exec, UDAs implement Update/Merge/Finalize with
optional partial-aggregate support (udf.h:326-368 SupportsPartial).  Here:

  * A *device* ScalarUDF is a torch function over column tensors — vectorized
    by construction (no per-row Exec loop).
  * A *host* ScalarUDF runs over dictionary values (unique strings) producing a
    LUT that the evaluator applies with one gather — O(unique) instead of
    O(rows).
  * A UDA's state is a tree (a tensor, or a dict of tensors) whose every leaf
    declares a reduction op ("add"|"min"|"max"); Merge is that reduction, which
    makes every UDA partial-aggregation-capable by construction.  State trees,
    shapes and dtypes are the reference's, so states carry across
    (pixie_tpu_torch.interop).

`update` accumulates IN PLACE into the state tensors (the kernels add into
them) and returns the state; the state lives on the device across feeds.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from pixie_tpu_torch.status import NotFound
from pixie_tpu_torch.types import DataType, SemanticType

# ---------------------------------------------------------------------- scalar


@dataclasses.dataclass(frozen=True)
class ScalarUDF:
    """One overload of a scalar function.

    fn signature:
      device: fn(*tensors) -> tensor                   (elementwise)
      host:   fn(*values: python) -> python            (applied over dict values)
    """

    name: str
    arg_types: tuple[DataType, ...]
    out_type: DataType
    fn: Callable
    device: bool = True
    #: host fns over a BOUNDED int domain (enum decoders like
    #: http_resp_message): (lo, hi) inclusive — evaluated once over the domain
    #: into a device LUT instead of needing a dictionary-encoded input.
    int_domain: tuple[int, int] | None = None
    #: True for host fns reading ambient mutable state (metadata snapshots)
    volatile: bool = False
    #: declared SEMANTIC type of the output (reference typespb ST_*), or None
    out_st: "object" = None
    #: True if the output keeps the semantic type of its first ST-typed
    #: argument
    st_preserve: bool = False
    #: device fns: the chain program opcode computing fn (ops/chain.py
    #: DEV_OPS); None makes a call of it a leaf of the chain kernel
    op: "str | None" = None

    def key(self) -> tuple:
        return (self.name, self.arg_types)


# ------------------------------------------------------------------- trees


def tree_map(fn: Callable, tree, *rest):
    """Map `fn` over the leaves of a UDA state tree (a leaf, or a dict of
    leaves); `rest` are trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def to_torch_dtype(dtype) -> torch.dtype:
    """numpy dtype (or type) → torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


# ------------------------------------------------------------------------- UDA


class UDA:
    """Aggregate function over groups.

    Contract (shapes: N rows, G groups):
      init(G, in_dtype, device)                   -> state tree, leaves [G, ...]
      update(state, gid[N], value[N], mask[N], G) -> state (updated in place)
      reduce_ops()                                -> same tree of "add"|"min"|"max"
      finalize_host(state_np)                     -> np column [G]
    Merge of two states is elementwise leaf-wise reduce_ops (the merge
    itself comes with the distributed slice).
    """

    name: str = "?"
    #: True if the UDA takes no value column (count).
    nullary: bool = False
    #: True if the UDA may consume a dictionary-encoded (STRING/UINT128)
    #: column: its update sees the CODES; the executor decodes at finalize.
    dict_ok: bool = False
    #: True if the aggregate's output keeps the input column's semantic type
    st_preserve: bool = False
    #: True if finalize needs the input column's Dictionary
    needs_dict: bool = False
    #: fixed output semantic type (e.g. quantiles → ST_QUANTILES), or None
    out_st = None
    #: True if `update` takes `nan_bin`, the bin of a NaN value (the sketch
    #: UDAs; ops/sketch.py bin_index)
    bins_nan: bool = False

    def out_type(self, in_type: DataType | None) -> DataType:
        raise NotImplementedError

    def init(self, num_groups: int, in_dtype, device) -> object:
        raise NotImplementedError

    def update(self, state, gid, value, mask, num_groups: int):
        raise NotImplementedError

    def reduce_ops(self):
        raise NotImplementedError

    def gang_leaves(self, state) -> list | None:
        """The updates of `state`'s leaves for the multi-query gang (kernel
        G1, ops/gang.py): [(op, leaf tensor, sketch | None)], each op one of
        G1's leaf updates applied to this UDA's value, doing what `update`
        does; None when G1 cannot update this state (the gang then runs the
        sinks one by one)."""
        return None

    def finalize_host(self, state_np) -> np.ndarray:
        raise NotImplementedError

    # ---- optional DEVICE finalize (large-state UDAs, e.g. sketches) ----
    #: When True the executor runs `finalize_device` on the device state and
    #: pulls only the (small) result instead of the state.
    device_finalize = False

    def finalize_device(self, state):
        """Device state → small device tensor the host can format cheaply."""
        raise NotImplementedError

    def finalize_from_device(self, pulled_np) -> np.ndarray:
        """Pulled `finalize_device` result → the output column."""
        return np.asarray(pulled_np)


def _acc_dtype(in_dtype) -> torch.dtype:
    d = to_torch_dtype(in_dtype)
    if d == torch.bool:
        return torch.int64
    return d


class CountUDA(UDA):
    name = "count"
    nullary = True

    def out_type(self, in_type):
        return DataType.INT64

    def init(self, num_groups, in_dtype, device):
        return torch.zeros((num_groups,), dtype=torch.int64, device=device)

    def update(self, state, gid, value, mask, num_groups):
        from pixie_tpu_torch.ops.groupby import masked_segment_count

        return masked_segment_count(gid, num_groups, mask, out=state)

    def reduce_ops(self):
        return "add"

    def gang_leaves(self, state):
        return [("count", state, None)]

    def finalize_host(self, state_np):
        return np.asarray(state_np, dtype=np.int64)


class SumUDA(UDA):
    name = "sum"
    st_preserve = True

    def out_type(self, in_type):
        return DataType.FLOAT64 if in_type == DataType.FLOAT64 else DataType.INT64

    def init(self, num_groups, in_dtype, device):
        return torch.zeros((num_groups,), dtype=_acc_dtype(in_dtype), device=device)

    def update(self, state, gid, value, mask, num_groups):
        from pixie_tpu_torch.ops.groupby import masked_segment_sum

        return masked_segment_sum(value.to(state.dtype), gid, num_groups, mask, out=state)

    def reduce_ops(self):
        return "add"

    def gang_leaves(self, state):
        return [("sum", state, None)]

    def finalize_host(self, state_np):
        return np.asarray(state_np)


class MeanUDA(UDA):
    name = "mean"
    st_preserve = True

    def out_type(self, in_type):
        return DataType.FLOAT64

    def init(self, num_groups, in_dtype, device):
        return {
            "sum": torch.zeros((num_groups,), dtype=torch.float64, device=device),
            "count": torch.zeros((num_groups,), dtype=torch.int64, device=device),
        }

    def update(self, state, gid, value, mask, num_groups):
        from pixie_tpu_torch.ops.groupby import masked_segment_count, masked_segment_sum

        masked_segment_sum(value.to(torch.float64), gid, num_groups, mask, out=state["sum"])
        masked_segment_count(gid, num_groups, mask, out=state["count"])
        return state

    def reduce_ops(self):
        return {"sum": "add", "count": "add"}

    def gang_leaves(self, state):
        return [("sum", state["sum"], None), ("count", state["count"], None)]

    def finalize_host(self, state_np):
        cnt = np.asarray(state_np["count"], dtype=np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(cnt > 0, np.asarray(state_np["sum"]) / cnt, np.nan)


class _PickUDA(UDA):
    """min / max / any: one [G] leaf folded with a segment min or max."""

    op = "min"
    st_preserve = True

    def out_type(self, in_type):
        return in_type

    def init(self, num_groups, in_dtype, device):
        from pixie_tpu_torch.ops.groupby import _identity_for

        d = _acc_dtype(in_dtype)
        return torch.full((num_groups,), _identity_for(d, self.op), dtype=d, device=device)

    def update(self, state, gid, value, mask, num_groups):
        from pixie_tpu_torch.ops.groupby import masked_segment_max, masked_segment_min

        fn = masked_segment_min if self.op == "min" else masked_segment_max
        return fn(value.to(state.dtype), gid, num_groups, mask, out=state)

    def reduce_ops(self):
        return self.op

    def gang_leaves(self, state):
        return [(self.op, state, None)]

    def finalize_host(self, state_np):
        return np.asarray(state_np)


class MinUDA(_PickUDA):
    name = "min"
    op = "min"


class MaxUDA(_PickUDA):
    name = "max"
    op = "max"


class AnyUDA(_PickUDA):
    """Pick a representative value per group (reference math_ops.cc AnyUDA).
    Implemented as segment-min, which is a correct 'any' and, unlike
    'first-seen', is order-independent across shards/batches."""

    name = "any"
    op = "min"
    dict_ok = True


class VarianceUDA(UDA):
    """Sample variance via (sum, sumsq, count) — linear, trivially mergeable
    state (reference math_ops.cc uses pairwise-merge Welford)."""

    name = "variance"

    def out_type(self, in_type):
        return DataType.FLOAT64

    def init(self, num_groups, in_dtype, device):
        return {
            "sum": torch.zeros((num_groups,), dtype=torch.float64, device=device),
            "sumsq": torch.zeros((num_groups,), dtype=torch.float64, device=device),
            "count": torch.zeros((num_groups,), dtype=torch.int64, device=device),
        }

    def update(self, state, gid, value, mask, num_groups):
        from pixie_tpu_torch.ops.groupby import masked_segment_count, masked_segment_sum

        v = value.to(torch.float64)
        masked_segment_sum(v, gid, num_groups, mask, out=state["sum"])
        masked_segment_sum(v * v, gid, num_groups, mask, out=state["sumsq"])
        masked_segment_count(gid, num_groups, mask, out=state["count"])
        return state

    def reduce_ops(self):
        return {"sum": "add", "sumsq": "add", "count": "add"}

    def gang_leaves(self, state):
        return [("sum", state["sum"], None), ("sumsq", state["sumsq"], None),
                ("count", state["count"], None)]

    def finalize_host(self, state_np):
        n = np.asarray(state_np["count"], dtype=np.float64)
        s = np.asarray(state_np["sum"])
        ss = np.asarray(state_np["sumsq"])
        with np.errstate(invalid="ignore", divide="ignore"):
            var = (ss - s * s / np.where(n > 0, n, 1)) / np.where(n > 1, n - 1, 1)
        return np.where(n > 1, np.maximum(var, 0.0), np.nan)


class StddevUDA(VarianceUDA):
    name = "stddev"

    def finalize_host(self, state_np):
        return np.sqrt(super().finalize_host(state_np))


class DictHistUDA(UDA):
    """Base for aggregates over a dictionary-encoded column whose FINALIZE
    needs the string values (model-fitting UDAs: kmeans, request-path
    clustering — reference funcs/builtins/ml_ops.cc, request_path_ops.cc).

    The state is a bounded per-group histogram of dictionary codes ([G, CAP]
    counts), "add"-mergeable, and the model fit runs once at finalize over
    the observed UNIQUE values with their multiplicities, not over rows.
    Codes beyond CAP are dropped (the reference's bounded budget, as its
    64-point coreset, exec/ml/coreset.h).  Distributed plans ship rows for
    dict-input aggregates (parallel/distributed.py), so cross-agent code
    spaces never mix.

    The update is K1's count over the flattened id gid * CAP + code, so the
    counts are int64 where the reference's are int32 (equal values).
    """

    dict_ok = True
    needs_dict = True  # executor must call finalize_dict, not finalize_host
    CAP = 256

    def out_type(self, in_type):
        return DataType.STRING

    def init(self, num_groups, in_dtype, device):
        return torch.zeros((num_groups, self.CAP), dtype=torch.int64, device=device)

    def update(self, state, gid, value, mask, num_groups):
        from pixie_tpu_torch.ops.groupby import masked_segment_count

        code = value.to(torch.int32)
        # null codes arrive as a huge sentinel (executor PICKER_NULL_SENTINEL)
        # and overflow codes are dropped, so `code < CAP` handles both
        ok = mask & (code >= 0) & (code < self.CAP)
        flat = gid.to(torch.int32) * self.CAP + code.clamp(0, self.CAP - 1)
        masked_segment_count(flat, num_groups * self.CAP, ok, out=state.view(-1))
        return state

    def reduce_ops(self):
        return "add"

    def finalize_host(self, state_np):
        raise NotFound(
            f"UDA {self.name} needs the input dictionary to finalize "
            "(needs_dict); the executor must call finalize_dict"
        )

    def finalize_dict(self, state_np, dictionary) -> np.ndarray:
        counts = np.asarray(state_np)
        out = np.empty(counts.shape[0], dtype=object)
        for g in range(counts.shape[0]):
            nz = np.nonzero(counts[g] > 0)[0]
            vals = dictionary.decode(nz.astype(np.int32)) if len(nz) else []
            out[g] = self.fit_group(list(vals), counts[g][nz])
        return out

    def fit_group(self, values: list, weights) -> str:
        """Fit one group's model over unique `values` with multiplicities
        `weights`; returns the serialized model (a JSON string)."""
        raise NotImplementedError


class _SketchUDA(UDA):
    """Base of the log-histogram sketch UDAs: a [G, 514] float32 state."""

    @property
    def _sketch(self):
        from pixie_tpu_torch.ops.sketch import LogHistogram

        return LogHistogram()

    bins_nan = True

    def init(self, num_groups, in_dtype, device):
        return self._sketch.init(num_groups, device)

    def update(self, state, gid, value, mask, num_groups, nan_bin: int = 1):
        return self._sketch.update(state, gid, value, mask, num_groups, nan_bin)

    def reduce_ops(self):
        return "add"

    def gang_leaves(self, state):
        return [("hist", state, self._sketch)]

    device_finalize = True

    def device_quantiles(self) -> tuple[tuple[float, ...], bool]:
        """(the quantiles finalize_device computes, True when it returns them
        as [G] rather than [G, nq]): what the fused device finalize
        (ops/finalize.py, F1 / F2) computes in its place."""
        raise NotImplementedError


class QuantileUDA(_SketchUDA):
    """Single quantile via mergeable log-histogram sketch (replaces t-digest,
    reference src/carnot/funcs/builtins/math_sketches.h:34-49)."""

    st_preserve = True

    def __init__(self, q: float, name: str | None = None):
        self.q = float(q)
        self.name = name or f"p{int(round(q * 100)):02d}"

    def out_type(self, in_type):
        return DataType.FLOAT64

    def finalize_host(self, state_np):
        from pixie_tpu_torch.ops.sketch import LogHistogram

        return LogHistogram().quantile(np.asarray(state_np), [self.q])[:, 0]

    def finalize_device(self, state):
        from pixie_tpu_torch.ops.sketch import LogHistogram

        return LogHistogram().quantile_device(state, [self.q])[:, 0]

    def device_quantiles(self):
        return (self.q,), True


class QuantilesUDA(_SketchUDA):
    """px.quantiles equivalent: ST_QUANTILES JSON column {p01,p10,p50,p90,p99}."""

    name = "quantiles"
    out_st = SemanticType.ST_QUANTILES
    QS = (0.01, 0.10, 0.50, 0.90, 0.99)

    def out_type(self, in_type):
        return DataType.STRING

    def finalize_host(self, state_np):
        from pixie_tpu_torch.ops.sketch import LogHistogram

        qv = LogHistogram().quantile(np.asarray(state_np), list(self.QS))
        return self._format(qv)

    def _format(self, qv: np.ndarray) -> np.ndarray:
        out = np.empty(qv.shape[0], dtype=object)
        for i in range(qv.shape[0]):
            out[i] = (
                "{" + ", ".join(f'"p{int(q*100):02d}": {v:.6g}' for q, v in zip(self.QS, qv[i])) + "}"
            )
        return out

    def finalize_device(self, state):
        from pixie_tpu_torch.ops.sketch import LogHistogram

        return LogHistogram().quantile_device(state, list(self.QS))

    def device_quantiles(self):
        return tuple(self.QS), False

    def finalize_from_device(self, pulled_np) -> np.ndarray:
        return self._format(np.asarray(pulled_np))


# -------------------------------------------------------------------- registry


_registry_uid = itertools.count(1)


class Registry:
    """Name → overloads (reference src/carnot/udf/registry.h:101)."""

    def __init__(self):
        self.uid = next(_registry_uid)
        self._scalar: dict[str, list[ScalarUDF]] = {}
        self._uda: dict[str, Callable[[], UDA]] = {}
        self._udtf: dict = {}

    # scalar
    def register(self, udf: ScalarUDF):
        self._scalar.setdefault(udf.name, []).append(udf)

    def scalar(self, name: str, arg_types: Sequence[DataType]) -> ScalarUDF:
        overloads = self._scalar.get(name)
        if not overloads:
            raise NotFound(f"no scalar UDF named {name!r}")
        args = tuple(arg_types)
        for o in overloads:
            if o.arg_types == args:
                return o
        # Numeric widening: allow INT64/TIME64NS/BOOLEAN args where FLOAT64 declared.
        for o in overloads:
            if len(o.arg_types) == len(args) and all(
                a == b or (b == DataType.FLOAT64 and a in (DataType.INT64, DataType.BOOLEAN, DataType.TIME64NS))
                or (b == DataType.INT64 and a in (DataType.BOOLEAN, DataType.TIME64NS))
                for a, b in zip(args, o.arg_types)
            ):
                return o
        raise NotFound(
            f"no overload of {name!r} for {tuple(t.name for t in args)}; "
            f"have {[tuple(t.name for t in o.arg_types) for o in overloads]}"
        )

    def has_scalar(self, name: str) -> bool:
        return name in self._scalar

    def is_volatile(self, name: str) -> bool:
        """Any overload of `name` reads ambient mutable state (metadata)."""
        return any(o.volatile for o in self._scalar.get(name, ()))

    # uda
    def register_uda(self, name: str, factory: Callable[[], UDA]):
        self._uda[name] = factory

    def uda(self, name: str) -> UDA:
        f = self._uda.get(name)
        if f is None:
            raise NotFound(f"no UDA named {name!r} (have {sorted(self._uda)})")
        return f()

    def has_uda(self, name: str) -> bool:
        return name in self._uda

    # udtf (reference src/carnot/udf/udtf.h; see pixie_tpu_torch.udf.udtf)
    def register_udtf(self, udtf):
        self._udtf[udtf.name] = udtf

    def udtf(self, name: str):
        u = self._udtf.get(name)
        if u is None:
            raise NotFound(f"no UDTF named {name!r} (have {sorted(self._udtf)})")
        return u

    def has_udtf(self, name: str) -> bool:
        return name in self._udtf

    # iteration accessors (introspection UDTFs; keeps internals private)
    def scalar_overloads(self):
        """Yield (name, ScalarUDF) in name order."""
        for name in sorted(self._scalar):
            for o in self._scalar[name]:
                yield name, o

    def uda_names(self) -> list[str]:
        return sorted(self._uda)

    def udtfs(self):
        """Yield UDTF specs in name order."""
        for name in sorted(self._udtf):
            yield self._udtf[name]

    def names(self) -> dict:
        return {
            "scalar": sorted(self._scalar),
            "uda": sorted(self._uda),
            "udtf": sorted(self._udtf),
        }
