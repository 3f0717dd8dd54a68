"""k-means coresets and the streaming coreset tree.

Reference: pixie_tpu/ml/coreset.py (itself after src/carnot/exec/ml/
coreset.h: KMeansCoreset, a sensitivity-sampled weighted subset that keeps
the k-means cost, and CoresetTree, merge-and-reduce over streaming batches
so an unbounded stream keeps a bounded summary).

The rough solution's distances come from KM1 (one assignment gives both the
cluster ids and the squared distances), the cluster masses from K1's sum,
and the m samples are one draw of m uniforms (`kmeans._uniforms`, a
generator seeded with seed + 1).  The tree stays host orchestration over
coresets computed on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from pixie_tpu_torch.ml import kmeans as _km
from pixie_tpu_torch.ops import kmeans as kops
from pixie_tpu_torch.ops.groupby import masked_segment_sum


def kmeans_coreset(points, weights, m: int, k: int = 8, seed: int = 0, device=None):
    """Sensitivity-sampled coreset of size m (coreset.h KMeansCoreset).

    Sensitivity of point p (Bachem-style lightweight coreset): proportional to
    w_p * (d(p, B)^2 / cost + 1/|B-cluster mass|), with B a rough k-means
    solution.  Returns (points [m,d], weights [m]) as numpy arrays."""
    dev = _km._device(device)
    x = _km._f32(points, dev)
    w = _km._f32(weights, dev)
    n = x.shape[0]
    if m >= n:
        return x.cpu().numpy(), w.cpu().numpy()
    kk = min(k, n)
    # kmeans_fit(x, kk, weights=w, max_iters=5, seed=seed), whose final
    # assignment also gives each point's squared distance
    c = _km._lloyd_centers(x, w, _km._plusplus_init(_km._generator(seed, dev), x, w, kk), 5)
    a, d2 = kops.assign(x, c)
    cost = torch.sum(w * d2) + 1e-30
    cluster_mass = masked_segment_sum(
        w.double(), a.to(torch.int32), kk, torch.ones(n, dtype=torch.bool, device=dev)
    ).float()
    mass_term = 1.0 / torch.clamp_min(cluster_mass[a], 1e-30)
    sens = w * (d2 / cost) + w * mass_term / torch.sum(w)
    p = sens / torch.sum(sens)
    idx = _km._choice(p, _km._uniforms(_km._generator(seed + 1, dev), (m,), dev))
    # unbiased estimator: sampled weight = w / (m * p)
    wout = w[idx] / (m * p[idx])
    return x[idx].cpu().numpy(), wout.cpu().numpy()


class CoresetTree:
    """Merge-and-reduce streaming summary (coreset.h CoresetTree/CoresetDriver).

    update(batch) buffers points; whenever two summaries of the same level
    exist they merge and re-compress to `m` points, so memory is
    O(m log(stream/batch)) and query() returns one coreset of the whole
    stream."""

    def __init__(self, m: int = 1024, k: int = 8, seed: int = 0, device=None):
        self.m = m
        self.k = k
        self.seed = seed
        self.device = device
        #: level -> (points, weights)
        self._levels: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._n_seen = 0

    def _coreset(self, pts, w, seed):
        return kmeans_coreset(pts, w, self.m, self.k, seed, device=self.device)

    def update(self, points, weights=None) -> None:
        pts = np.asarray(points, dtype=np.float32)
        w = (
            np.ones(len(pts), dtype=np.float32)
            if weights is None
            else np.asarray(weights, dtype=np.float32)
        )
        self._n_seen += len(pts)
        if len(pts) > self.m:
            pts, w = self._coreset(pts, w, self.seed)
        level = 0
        while level in self._levels:
            opts, ow = self._levels.pop(level)
            pts = np.concatenate([pts, opts])
            w = np.concatenate([w, ow])
            pts, w = self._coreset(pts, w, self.seed + level)
            level += 1
        self._levels[level] = (pts, w)

    def query(self) -> tuple[np.ndarray, np.ndarray]:
        """One coreset summarizing everything seen."""
        if not self._levels:
            return np.empty((0, 0), np.float32), np.empty((0,), np.float32)
        parts = [self._levels[lv] for lv in sorted(self._levels)]
        pts = np.concatenate([p for p, _ in parts])
        w = np.concatenate([x for _, x in parts])
        if len(pts) > self.m:
            pts, w = self._coreset(pts, w, self.seed)
        return pts, w

    @property
    def n_seen(self) -> int:
        return self._n_seen
