"""Mergeable quantile sketch as a dense tensor.

Replaces the reference's t-digest UDA (src/carnot/funcs/builtins/math_sketches.h:34-49)
with a DDSketch-style log-bucketed histogram: fixed relative accuracy, fixed
memory, and merge is elementwise addition.

Layout per group: float32[NBINS + 2] — bin 0 counts values <= min_value ("zero
bin"), bins 1..NBINS count positive values by ceil(log_gamma(v)); the last bin
absorbs overflow. With gamma = 1.0404 and 512 bins the dynamic range is ~6.6e8
at ~2% relative error.

`update` launches kernel K2 (csrc/loghist_update.cu; in shared memory or on
global atomics by the sketch's bytes, `update_regime`) on a CUDA tensor and
`quantile_device` kernel K3 (csrc/loghist_quantile.cu); on a CPU tensor each
runs its plain PyTorch version beside it.  `quantile` and `bin_value` are the
host (numpy) versions.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from pixie_tpu_torch.ops import _build

_K2 = "loghist_update"
_K3 = "loghist_quantile"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_INT32_LIMIT = 2.0 ** 31
#: shared memory one block may opt in to on an H100 (227 KB)
H100_SMEM_OPTIN = 232_448


def update_regime(groups: int, width: int, smem_optin: int = H100_SMEM_OPTIN) -> int:
    """The blocks K2 holds a [groups, width] sketch's int32 counts in
    (csrc/loghist_update.cu px_loghist_regime): 1, one block's shared
    memory, while it fits what a block may opt in to; else 0, none (every
    row a global atomic)."""
    return 1 if groups * width * 4 <= smem_optin else 0


@dataclasses.dataclass(frozen=True)
class LogHistogram:
    nbins: int = 512
    gamma: float = 1.0404
    #: values below this are counted in the zero bin.
    min_value: float = 1e-9

    @property
    def width(self) -> int:
        return self.nbins + 2

    def _log_gamma_f32(self) -> float:
        """The reference divides its float32 log by log(gamma) rounded to
        float32 (a weakly typed Python float meeting a float32 array)."""
        return float(np.float32(math.log(self.gamma)))

    def bin_index(self, v: torch.Tensor, nan_bin: int = 1) -> torch.Tensor:
        """Bin index per value (int64; plain version of K2's bin).

        Follows the reference operation by operation: float32 log of
        max(float32(v), float32(min_value)) divided by float32 log(gamma),
        ceil, +1; the zero-bin test in the value's own dtype; clamp to
        [0, width-1].  The reference converts the ceiling to int32 as XLA
        does (+inf -> INT32_MAX, whose +1 wraps negative, so +inf and
        float32 overflow land in bin 0); those edge results are written out
        here and in the kernel.  NaN lands in `nan_bin`: the reference's
        device route converts its ceiling to 0 (bin 1, a batch query's),
        its CPU routes, which its streaming polls take, to INT32_MIN,
        clamped to bin 0 (csrc/loghist.cuh).
        """
        x = torch.clamp_min(v.to(torch.float32), np.float32(self.min_value).item())
        lg = torch.log(x) / torch.full_like(x, self._log_gamma_f32())
        c = torch.ceil(lg)
        idx = c.clamp(-2.0, float(self.width)).to(torch.int64) + 1
        idx = idx.clamp(0, self.width - 1)
        idx = torch.where(c >= _INT32_LIMIT, 0, idx)
        idx = torch.where(v <= self.min_value, 0, idx)
        return torch.where(torch.isnan(v), nan_bin, idx)

    def init(self, num_groups: int, device, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros((num_groups, self.width), dtype=dtype, device=device)

    # merge == elementwise add; no method needed.

    # ------------------------------------------------------------ update (K2)
    def update(
        self,
        hist: torch.Tensor,  # [num_groups, width] float32, updated in place
        gid: torch.Tensor,
        values: torch.Tensor,
        mask: torch.Tensor,
        num_groups: int,
        nan_bin: int = 1,
    ) -> torch.Tensor:
        """Add the masked values into the per-group histograms, in place;
        a NaN value counts in bin `nan_bin` (bin_index)."""
        if gid.is_cuda:
            self._launch_update(hist, gid, values.to(torch.float64).contiguous(),
                                mask, num_groups, nan_bin)
            return hist
        return self.update_plain(hist, gid, values, mask, num_groups, nan_bin)

    def update_plain(self, hist, gid, values, mask, num_groups, nan_bin: int = 1):
        """Plain version of K2: bin index, then one flat index_add_."""
        bins = self.bin_index(values.to(torch.float64), nan_bin)
        keep = mask & (gid >= 0) & (gid < num_groups)
        flat = gid.clamp(0, max(num_groups - 1, 0)).long() * self.width + bins
        hist.view(-1).index_add_(0, flat, keep.to(hist.dtype))
        return hist

    def _launch_update(self, hist, gid, values, mask, num_groups, nan_bin):
        n = gid.shape[0]
        if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous():
            raise TypeError("gid must be a contiguous 1-D int32 tensor")
        if mask.dtype != torch.bool or mask.shape != (n,) or not mask.is_contiguous():
            raise TypeError(f"mask must be a contiguous bool tensor of shape ({n},)")
        if values.shape != (n,):
            raise TypeError(f"values must have shape ({n},)")
        if (hist.dtype != torch.float32 or hist.shape != (num_groups, self.width)
                or not hist.is_contiguous()):
            raise TypeError(
                f"hist must be a contiguous float32 [{num_groups}, {self.width}] tensor")
        if any(t.device != gid.device for t in (mask, values, hist)):
            raise ValueError("tensors on different devices")
        if num_groups * self.width >= 2 ** 31:
            raise ValueError("histogram cells exceed the kernel's int32 index")
        fn = _build.function(_K2, "px_loghist_update",
                             [_P, _P, _P, _L, _P, _I, _I, ctypes.c_float,
                              ctypes.c_float, ctypes.c_double, _I, _P])
        with torch.cuda.device(gid.device):
            err = fn(_build.ptr(gid), _build.ptr(mask), _build.ptr(values), n,
                     _build.ptr(hist), num_groups, self.width,
                     self._log_gamma_f32(), float(np.float32(self.min_value)),
                     self.min_value, int(nan_bin), _build.stream_of(gid))
        _build.check(_K2, err, "loghist_update")
        _build.KERNELS[_K2].count("px_loghist_update")

    # -------------------------------------------------------- host finalize
    def bin_value(self, idx: np.ndarray) -> np.ndarray:
        """Representative value of a bin (host): geometric mean of bin bounds."""
        i = np.asarray(idx, dtype=np.float64) - 1.0
        val = np.power(self.gamma, i - 0.5)
        return np.where(np.asarray(idx) <= 0, 0.0, val)

    def quantile(self, hist: np.ndarray, qs: list[float]) -> np.ndarray:
        """Host-side finalize: quantiles per group. hist: [G, width] → [G, len(qs)]."""
        h = np.asarray(hist, dtype=np.float64)
        totals = h.sum(axis=-1, keepdims=True)
        cum = np.cumsum(h, axis=-1)
        out = np.empty((h.shape[0], len(qs)), dtype=np.float64)
        for j, q in enumerate(qs):
            target = np.clip(q, 0.0, 1.0) * totals[:, 0]
            # Per-row searchsorted: first bin where cum >= target.
            idx = (cum < target[:, None]).sum(axis=-1)
            idx = np.minimum(idx, h.shape[1] - 1)
            out[:, j] = self.bin_value(idx)
        out[totals[:, 0] == 0] = np.nan
        return out

    # ------------------------------------------------- device finalize (K3)
    def _bin_values(self, device) -> torch.Tensor:
        """gamma^(idx - 1.5) per bin in f64, computed on the host by
        bin_value, so the device finalize equals the host one bit for bit.
        Built per call: the finalize runs once per quantile UDA per query."""
        return torch.as_tensor(self.bin_value(np.arange(self.width)),
                               dtype=torch.float64, device=device)

    @staticmethod
    def _quantiles(qs, device) -> torch.Tensor:
        return torch.as_tensor([float(q) for q in qs], dtype=torch.float32, device=device)

    def quantile_device(self, hist: torch.Tensor, qs: list[float]) -> torch.Tensor:
        """DEVICE finalize (same rank rule as `quantile`): [G, width] float32
        → [G, len(qs)] f64, NaN for empty groups."""
        if hist.is_cuda:
            return self._launch_quantile(hist, qs)
        return self.quantile_plain(hist, qs)

    def quantile_plain(self, hist: torch.Tensor, qs: list[float]) -> torch.Tensor:
        """Plain version of K3: f32 cumsum and a broadcast compare-count."""
        h = hist.to(torch.float32)
        totals = h.sum(dim=-1, keepdim=True)
        cum = torch.cumsum(h, dim=-1)
        qv = self._quantiles(qs, h.device)
        target = torch.clamp(qv, 0.0, 1.0)[None, :] * totals  # [G, nq]
        idx = (cum[:, None, :] < target[:, :, None]).sum(dim=-1)
        idx = torch.clamp(idx, max=h.shape[-1] - 1)
        out = self._bin_values(h.device)[idx]
        return torch.where(totals > 0, out, float("nan"))

    def _launch_quantile(self, hist, qs):
        if (hist.dtype != torch.float32 or hist.dim() != 2
                or hist.shape[1] != self.width or not hist.is_contiguous()):
            raise TypeError(f"hist must be a contiguous float32 [G, {self.width}] tensor")
        if self.width > 1024:
            raise ValueError("the quantile kernel takes at most 1024 bins")
        groups = hist.shape[0]
        qv = self._quantiles(qs, hist.device)
        out = torch.empty((groups, len(qs)), dtype=torch.float64, device=hist.device)
        binv = self._bin_values(hist.device)
        fn = _build.function(_K3, "px_loghist_quantile",
                             [_P, _I, _I, _P, _I, _P, _P, _P])
        with torch.cuda.device(hist.device):
            err = fn(_build.ptr(hist), groups, self.width, _build.ptr(qv), len(qs),
                     _build.ptr(binv), _build.ptr(out), _build.stream_of(hist))
        _build.check(_K3, err, "loghist_quantile")
        _build.KERNELS[_K3].count("px_loghist_quantile")
        return out
