"""Model-fitting aggregates (`_kmeans_fit`, `_build_request_path_clusters`).

Reference: pixie_tpu/ml/fit.py (after src/carnot/funcs/builtins/ml_ops.cc:38,
KMeansUDA over a 64-point streaming coreset, and request_path_ops.cc:40,
RequestPathClusteringFitUDA): UDAs whose update consumes rows and whose
finalize serializes a model JSON for the matching inference scalar UDFs.

The state is udf.udf.DictHistUDA's per-group histogram of dictionary codes
(K1's count on the device, "add"-mergeable), and the model fit runs once at
finalize over the unique observed values with their multiplicities.  The
k-means fit runs on the device the aggregate's state lives on.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from pixie_tpu_torch import flags
from pixie_tpu_torch.status import Internal
from pixie_tpu_torch.udf.udf import DictHistUDA

flags.define_int("PX_KMEANS_K", 8,
                 "default k for the _kmeans_fit aggregate (the reference "
                 "passes k per Update call, ml_ops.h KMeansUDA)")


class RequestPathClusteringFitUDA(DictHistUDA):
    """`_build_request_path_clusters`: req_path column → endpoint-cluster
    model JSON `[{"template": "/a/*/c"}, ...]`, consumed by
    `_predict_request_path_cluster` (usage:
    pxbeta/service_endpoints/service_endpoints.pxl:126)."""

    name = "_build_request_path_clusters"

    def fit_group(self, values, weights):
        from pixie_tpu_torch.ml.request_path import RequestPathClustering

        paths = [v for v in values if v is not None]
        model = RequestPathClustering().fit(paths)
        return json.dumps([{"template": t} for t in model.templates])


class KMeansFitUDA(DictHistUDA):
    """`_kmeans_fit`: embedding-JSON column → kmeans model JSON
    `{"centroids": [[...], ...]}`, consumed by `_kmeans_inference`
    (reference ml_ops.h KMeansUDA; its second Update arg `k` is bound at
    construction here — default from PX_KMEANS_K — since the histogram
    state carries values, not per-row parameters).  The fit runs on the
    device `init` was given: the executor's."""

    name = "_kmeans_fit"

    def __init__(self, k: int | None = None):
        self.k = int(flags.get("PX_KMEANS_K") if k is None else k)
        self.device = None

    def init(self, num_groups, in_dtype, device):
        self.device = torch.device(device)
        return super().init(num_groups, in_dtype, device)

    def fit_group(self, values, weights):
        from pixie_tpu_torch.ml.kmeans import kmeans_fit

        if self.device is None:
            raise Internal("_kmeans_fit finalized before init gave it a device")
        pts, w = [], []
        for v, c in zip(values, np.asarray(weights, dtype=np.float64)):
            try:
                x = json.loads(v)
            except (TypeError, ValueError):
                continue
            if (isinstance(x, list) and x
                    and all(isinstance(f, (int, float)) for f in x)):
                pts.append([float(f) for f in x])
                w.append(c)
        if not pts:
            return json.dumps({"centroids": []})
        d = max(len(p) for p in pts)
        pts = [p + [0.0] * (d - len(p)) for p in pts]
        k = min(self.k, len(pts))
        centers, _assign = kmeans_fit(
            np.asarray(pts, dtype=np.float32), k,
            weights=np.asarray(w, dtype=np.float32), device=self.device)
        return json.dumps(
            {"centroids": np.round(np.asarray(centers, dtype=np.float64),
                                   6).tolist()})
