"""Request-path endpoint clustering.

Reference: src/carnot/funcs/builtins/request_path_ops.cc — a UDA clusters
observed request paths into endpoint templates ("/api/users/*"), plus scalar
predict/match UDFs.  Redesign for the dictionary-encoded engine: clustering
runs over the UNIQUE paths (dictionary values, typically thousands not
millions), entirely host-side; row-level application is the usual LUT gather.
"""
from __future__ import annotations

import re
from collections import defaultdict

_ID_SEGMENT = re.compile(
    r"^(?:\d+|[0-9a-fA-F]{8,}|[0-9a-fA-F]{8}-[0-9a-fA-F]{4}-[0-9a-fA-F]{4}-"
    r"[0-9a-fA-F]{4}-[0-9a-fA-F]{12})$"
)


def templatize(path: str) -> str:
    """Stateless template: id-like segments (numbers, hashes, uuids) → '*'
    (the scalar endpoint UDF; request_path_ops.cc kAnonymousSegment)."""
    if not path:
        return path
    base = path.split("?", 1)[0]
    parts = base.split("/")
    out = ["*" if _ID_SEGMENT.match(p) else p for p in parts]
    return "/".join(out)


class RequestPathClustering:
    """Fit endpoint templates from observed paths (the UDA analog).

    Paths group by (depth, stateless template); within a group, a segment
    position whose distinct-value count exceeds `branch_limit` generalizes to
    '*' — the same varying-segment idea as the reference's centroid clustering
    without needing the embedding model."""

    def __init__(self, branch_limit: int = 8):
        self.branch_limit = branch_limit
        self.templates: list[str] = []

    def fit(self, paths) -> "RequestPathClustering":
        by_depth: dict[int, list[list[str]]] = defaultdict(list)
        for p in set(paths):
            if p is None:
                continue
            segs = templatize(p).split("?", 1)[0].split("/")
            by_depth[len(segs)].append(segs)
        templates = set()
        for depth, seg_lists in by_depth.items():
            distinct = [set() for _ in range(depth)]
            for segs in seg_lists:
                for i, s in enumerate(segs):
                    distinct[i].add(s)
            wild = [len(d) > self.branch_limit for d in distinct]
            for segs in seg_lists:
                templates.add(
                    "/".join("*" if wild[i] else s for i, s in enumerate(segs))
                )
        self.templates = sorted(templates)
        return self

    def predict(self, path: str) -> str:
        """Most specific matching template; falls back to the stateless one."""
        t = templatize(path)
        segs = t.split("/")
        best = None
        for cand in self.templates:
            cs = cand.split("/")
            if len(cs) != len(segs):
                continue
            if all(c == "*" or c == s for c, s in zip(cs, segs)):
                score = sum(c != "*" for c in cs)
                if best is None or score > best[0]:
                    best = (score, cand)
        return best[1] if best else t


def register_request_path_funcs(registry) -> None:
    from pixie_tpu_torch.types import DataType as DT
    from pixie_tpu_torch.udf.udf import ScalarUDF

    registry.register(ScalarUDF(
        name="request_path_endpoint", arg_types=(DT.STRING,),
        out_type=DT.STRING, fn=templatize, device=False,
    ))
    registry.register(ScalarUDF(
        name="_match_endpoint", arg_types=(DT.STRING, DT.STRING),
        out_type=DT.BOOLEAN, device=False,
        fn=lambda path, tmpl: _match(templatize(path), tmpl),
    ))
    registry.register_uda("_build_request_path_clusters",
                          _fit_uda("RequestPathClusteringFitUDA"))
    registry.register_uda("_kmeans_fit", _fit_uda("KMeansFitUDA"))


def _fit_uda(cls_name: str):
    """A factory of ml.fit's `cls_name`, imported when first called: ml.fit
    imports the UDA base from the udf package, whose import registers these
    functions, so importing it here would be circular."""
    def make():
        from pixie_tpu_torch.ml import fit

        return getattr(fit, cls_name)()

    return make


def _match(t: str, tmpl: str) -> bool:
    a, b = t.split("/"), tmpl.split("/")
    return len(a) == len(b) and all(y == "*" or x == y for x, y in zip(a, b))
