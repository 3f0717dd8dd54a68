"""KM1-KM3: the k-means kernels and their plain versions.

Reference: pixie_tpu/ml/kmeans.py — `_sq_dists` (one x @ c.T matmul in the
expansion |x|^2 - 2 x.c + |c|^2, clamped at 0) with argmin / min around it,
the `_lloyd` step (assign, then segment sums of w and x * w per center) and
the `_plusplus_init` step (the min distance to the chosen centers times w).

  * assign(x, c)                  -> (ids int64 [n], min sq. distance f32 [n])
                                     — KM1 `px_kmeans_assign`;
  * lloyd_step(x, w, c)           -> (wsum f32 [k], xsum f32 [k, d])
                                     — KM2 `px_kmeans_lloyd`;
  * seed_step(x, w, c, mind)      -> p f32 [n], with `mind` folded in place
                                     (mind = min(mind, d(x, c)), p = mind * w,
                                     non-finite p set to 0) — KM3
                                     `px_kmeans_seed_step`.

All in float32; KM2's sums run in float64 and round once to float32 (the
reference sums in float32), in a fixed order, so a fit repeats bit for bit.
On CUDA tensors each launches its kernel (csrc/kmeans.cu); on CPU tensors it
runs the plain PyTorch version beside it, which the CPU tests use and
chip_smoke.py holds the kernels against.  The choice follows the tensors'
device only; a CUDA tensor never reaches a plain version.
"""
from __future__ import annotations

import ctypes

import torch

from pixie_tpu_torch.ops import _build

_KM = "kmeans"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


# --------------------------------------------------------- plain versions


def sq_dists_plain(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[n, k] squared euclidean distances by the reference's matmul expansion
    |x|^2 - 2 x.c + |c|^2, clamped at 0 (pixie_tpu/ml/kmeans.py _sq_dists)."""
    x2 = torch.sum(x * x, dim=1, keepdim=True)
    c2 = torch.sum(c * c, dim=1)
    return torch.clamp_min(x2 - 2.0 * (x @ c.T) + c2[None, :], 0.0)


def assign_plain(x: torch.Tensor, c: torch.Tensor):
    d = sq_dists_plain(x, c)
    return torch.argmin(d, dim=1), torch.amin(d, dim=1)


def lloyd_step_plain(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor):
    ids, _ = assign_plain(x, c)
    k = c.shape[0]
    wsum = torch.zeros(k, dtype=torch.float64, device=x.device).index_add_(
        0, ids, w.double())
    xsum = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device).index_add_(
        0, ids, (x * w[:, None]).double())
    return wsum.float(), xsum.float()


def seed_step_plain(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
                    mind: torch.Tensor) -> torch.Tensor:
    d = sq_dists_plain(x, c[None, :])[:, 0]
    # jnp.min over the chosen centers: NaN propagates (torch.minimum does)
    torch.minimum(mind, d, out=mind)
    p = mind * w
    return torch.where(torch.isfinite(p), p, 0.0)


# ---------------------------------------------------------------- checks


def _check(x, c=None, w=None, mind=None):
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise TypeError("x must be a contiguous [n, d] float32 tensor")
    n, d = x.shape
    if d == 0:
        raise ValueError("x has no dimensions")
    if c is not None and (c.dtype != torch.float32 or not c.is_contiguous()
                          or c.shape[-1] != d or c.dim() not in (1, 2)):
        raise TypeError(f"centers must be a contiguous float32 tensor of width {d}")
    for name, t in (("w", w), ("mind", mind)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (n,)
                              or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous float32 tensor of shape ({n},)")
    for t in (c, w, mind):
        if t is not None and t.device != x.device:
            raise ValueError(f"tensors on {x.device} and {t.device}")
    if n >= 2 ** 40:
        raise ValueError(f"{n} points exceed the kernels' indexing")


# ------------------------------------------------------------------ API


def assign(x: torch.Tensor, c: torch.Tensor):
    """Nearest center of every point (ties to the lowest index) and its
    squared distance: (ids int64 [n], mind float32 [n])."""
    _check(x, c)
    if c.dim() != 2 or c.shape[0] == 0:
        raise TypeError("centers must be a non-empty [k, d] tensor")
    if not x.is_cuda:
        return assign_plain(x, c)
    n, d = x.shape
    k = c.shape[0]
    ids = torch.empty(n, dtype=torch.int64, device=x.device)
    mind = torch.empty(n, dtype=torch.float32, device=x.device)
    c2 = torch.empty(k, dtype=torch.float32, device=x.device)
    fn = _build.function(_KM, "px_kmeans_assign", [_P, _L, _I, _P, _I, _P, _P, _P, _P])
    with torch.cuda.device(x.device):
        err = fn(_build.ptr(x), n, d, _build.ptr(c), k, _build.ptr(c2), _build.ptr(ids),
                 _build.ptr(mind), _build.stream_of(x))
    _build.check(_KM, err, "kmeans assign")
    _build.KERNELS[_KM].count("px_kmeans_assign")
    return ids, mind


def lloyd_step(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor):
    """One Lloyd iteration's sums under the assignment to `c`: (wsum
    float32 [k], xsum float32 [k, d]) — the sum of w and of w * x over the
    points nearest each center."""
    _check(x, c, w)
    if c.dim() != 2 or c.shape[0] == 0:
        raise TypeError("centers must be a non-empty [k, d] tensor")
    if x.shape[0] == 0:
        raise ValueError("no points")
    if not x.is_cuda:
        return lloyd_step_plain(x, w, c)
    n, d = x.shape
    k = c.shape[0]
    elems = ctypes.c_longlong(0)
    scratch = _build.function(_KM, "px_kmeans_lloyd_scratch",
                              [_L, _I, _I, ctypes.POINTER(ctypes.c_longlong)])
    with torch.cuda.device(x.device):
        _build.check(_KM, scratch(n, d, k, ctypes.byref(elems)), "kmeans lloyd scratch")
    if elems.value <= 0:
        raise ValueError(f"d = {d}: one center's sums exceed the kernel's shared memory")
    partials = torch.empty(elems.value, dtype=torch.float64, device=x.device)
    wsum = torch.empty(k, dtype=torch.float32, device=x.device)
    xsum = torch.empty((k, d), dtype=torch.float32, device=x.device)
    c2 = torch.empty(k, dtype=torch.float32, device=x.device)
    fn = _build.function(_KM, "px_kmeans_lloyd", [_P, _P, _L, _I, _P, _I, _P, _P, _P, _P, _P])
    with torch.cuda.device(x.device):
        err = fn(_build.ptr(x), _build.ptr(w), n, d, _build.ptr(c), k, _build.ptr(c2),
                 _build.ptr(wsum), _build.ptr(xsum), _build.ptr(partials),
                 _build.stream_of(x))
    _build.check(_KM, err, "kmeans lloyd")
    _build.KERNELS[_KM].count("px_kmeans_lloyd")
    return wsum, xsum


def seed_step(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
              mind: torch.Tensor) -> torch.Tensor:
    """One k-means++ step for the center `c` ([d]) chosen last: folds its
    squared distances into `mind` in place and returns p = mind * w, with
    non-finite values set to 0."""
    _check(x, c, w, mind)
    if c.dim() != 1:
        raise TypeError("the center must be a [d] tensor")
    if not x.is_cuda:
        return seed_step_plain(x, w, c, mind)
    n, d = x.shape
    p = torch.empty(n, dtype=torch.float32, device=x.device)
    fn = _build.function(_KM, "px_kmeans_seed_step", [_P, _P, _L, _I, _P, _P, _P, _P])
    with torch.cuda.device(x.device):
        err = fn(_build.ptr(x), _build.ptr(w), n, d, _build.ptr(c), _build.ptr(mind),
                 _build.ptr(p), _build.stream_of(x))
    _build.check(_KM, err, "kmeans seed step")
    _build.KERNELS[_KM].count("px_kmeans_seed_step")
    return p
