"""Weighted k-means on the device.

Reference: pixie_tpu/ml/kmeans.py (itself after src/carnot/exec/ml/kmeans.h:
Eigen k-means with kmeans++ init over a WeightedPointSet).  The same
algorithm in float32: k-means++ seeding, then weighted Lloyd iterations,
then a final assignment.  The distance work runs in the kernels of
ops/kmeans.py — KM3 for each seeding step (a running min over the chosen
centers), KM2 for each Lloyd iteration, KM1 for the assignment — and the
sampling around them in torch ops: normalise, cumsum, searchsorted, gather.
No step syncs with the host; the chosen indices stay device tensors.

Random draws: each sample is drawn as `jax.random.choice(key, n, p=p)`
draws it (`p_cuml = cumsum(p)`, `r = p_cuml[-1] * (1 - u)`,
`searchsorted(p_cuml, r)` on the left), with its float32 uniforms `u` from
a `torch.Generator` seeded with `seed`.  Every uniform comes from
`_uniforms`; the streams differ from JAX's threefry for the same seed, so
the parity tests feed JAX's uniforms through it.

Every entry point takes `device=None`: the CUDA card unless the caller asks
for another device (`engine.executor.resolve_device`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pixie_tpu_torch.ops import kmeans as kops

#: [n, k] squared distances by the reference's expansion (the plain version
#: of what KM1-KM3 compute; nothing on the device path calls it)
_sq_dists = kops.sq_dists_plain


def _device(device) -> torch.device:
    from pixie_tpu_torch.engine.executor import resolve_device

    return resolve_device(device)


def _f32(a, device) -> torch.Tensor:
    """A contiguous float32 tensor on `device` from an array or tensor."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).contiguous()
    arr = np.ascontiguousarray(a, dtype=np.float32)
    if not arr.flags.writeable:  # torch takes no read-only memory
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _uniforms(gen: torch.Generator, shape: tuple, device) -> torch.Tensor:
    """float32 uniforms in [0, 1): every random draw of the package."""
    return torch.rand(shape, generator=gen, dtype=torch.float32, device=device)


def _choice(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Indices into p (int64, the shape of u) drawn with probabilities p
    from the uniforms u, as jax.random.choice(..., replace=True, p=p).

    The scan runs in float64 and rounds once to float32: CUDA's float32
    scan adds in an order that changes from run to run (its partial sums
    look back over neighbouring tiles), which would move a sample between
    two runs of one fit."""
    p_cuml = torch.cumsum(p, 0, dtype=torch.float64).to(torch.float32)
    r = p_cuml[-1] * (1 - u)
    return torch.searchsorted(p_cuml, r)


def _plusplus_init(gen: torch.Generator, x: torch.Tensor, w: torch.Tensor,
                   k: int) -> torch.Tensor:
    """kmeans++ seeding (kmeans.h kKMeansPlusPlus): each next center sampled
    proportional to w times the squared distance to the nearest chosen
    center.  The k draws come from one `_uniforms` call."""
    n, d = x.shape
    u = _uniforms(gen, (k,), x.device)
    wn = w / torch.sum(w)
    first = _choice(wn, u[:1])
    centers = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    centers[:1] = x.index_select(0, first)
    mind = torch.full((n,), float("inf"), dtype=torch.float32, device=x.device)
    for i in range(1, k):
        p = kops.seed_step(x, w, centers[i - 1], mind)
        total = torch.sum(p)
        p = torch.where(total > 0, p / total, wn)
        centers[i:i + 1] = x.index_select(0, _choice(p, u[i:i + 1]))
    return centers


def _lloyd_centers(x, w, centers, iters: int) -> torch.Tensor:
    c = centers
    for _ in range(iters):
        wsum, xsum = kops.lloyd_step(x, w, c)
        c = torch.where(wsum[:, None] > 0,
                        xsum / torch.clamp_min(wsum, 1e-30)[:, None], c)
    return c


def _lloyd(x, w, centers, iters: int = 10):
    """`iters` weighted Lloyd iterations, then the assignment:
    (centers [k, d], assign int64 [n])."""
    c = _lloyd_centers(x, w, centers, iters)
    assign, _ = kops.assign(x, c)
    return c, assign


def kmeans_fit(points, k: int, weights=None, max_iters: int = 10, seed: int = 0,
               device=None):
    """Fit weighted k-means; returns (centers [k,d], assignments [n]) as
    numpy arrays."""
    dev = _device(device)
    x = _f32(points, dev)
    n = x.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
         else _f32(weights, dev))
    if k <= 0 or k > n:
        raise ValueError(f"k={k} out of range for {n} points")
    centers = _plusplus_init(_generator(seed, dev), x, w, k)
    centers, assign = _lloyd(x, w, centers, max_iters)
    return centers.cpu().numpy(), assign.cpu().numpy()


@dataclasses.dataclass
class KMeans:
    """Stateful wrapper mirroring the reference API (kmeans.h KMeans::Fit /
    Transform): fit replaces the model; transform assigns cluster ids."""

    k: int
    max_iters: int = 10
    seed: int = 0
    centers: np.ndarray | None = None
    device: object = None

    def fit(self, points, weights=None) -> "KMeans":
        self.centers, _ = kmeans_fit(points, self.k, weights=weights,
                                     max_iters=self.max_iters, seed=self.seed,
                                     device=self.device)
        return self

    def _assign(self, points):
        if self.centers is None:
            raise ValueError("KMeans.transform before fit")
        dev = _device(self.device)
        return kops.assign(_f32(points, dev), _f32(self.centers, dev))

    def transform(self, points) -> np.ndarray:
        return self._assign(points)[0].cpu().numpy()

    def inertia(self, points, weights=None) -> float:
        mind = self._assign(points)[1]
        if weights is not None:
            mind = mind * _f32(weights, mind.device)
        return float(torch.sum(mind))
