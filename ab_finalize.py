#!/usr/bin/env python3
"""A/B of the aggregate routes end to end on one CUDA card: this checkout
against another, in alternating pairs of fresh processes.

    python3 ab_finalize.py OTHER_TREE [--pairs N] [--rows N] [--reps N]
                           [--measures NAME,...]

OTHER_TREE is another checkout of the repository (for example the parent
commit, unpacked with `git archive`).  Pair i runs one process of each
tree, the other tree first when i is even and this one first when i is
odd (default 10 pairs).  Each process imports its tree's pixie_tpu_torch
and chip_smoke.py and measures, warm (the median of --reps queries after 3
settling ones, ms):

  one_feed          config #1 over bench's build_http_table at --rows rows
                    (default 2^24), PX_FEED_ROWS = 2^24: one feed;
  four_feeds        the same table, PX_FEED_ROWS = rows / 4;
  four_feeds_mesh4  the same over a mesh of 4 co-located shards;
  config3           chip_smoke's config #3 phase (16M rows, 256 pods, two
                    aggregates and a join; its warm median of 5);
  config4           config #4 through LocalCluster (8 agent stores of 2M
                    rows, M1 once a query);
  batch_unbatched,  the four BATCH_SCRIPTS through LocalCluster over the
  batch_batched     --rows table from 16 threads, 4 queries each, query
                    batching off and on: goodput in queries per second;
  config2           config #2 (chip_smoke `config2_plan`: 10 s windows x
                    service, count, mean, p50, p99) over bench's
                    build_http_table at 64M rows (chip_smoke's slice table,
                    whatever --rows says), PX_FEED_ROWS = 2^24: four feeds;
  g1                kernel G1 alone (`gang.run`) on the four BATCH_SCRIPTS
                    members over the table's first 16M-row feed (chip_smoke
                    `gang_feed`): the median of 5 timings of 20 calls by
                    CUDA events, ms a call;
  c1, c1_config2    kernel C1 alone on config #1's and config #2's chains
                    over chip_smoke's 16M-row chain feed (`chain_programs`),
                    timed as g1 is;
  k2, k2_config2    kernel K2 alone on that feed's latency into the group
                    ids and mask the config #1 chain (64 groups) and the
                    config #2 chain (1,024 groups) give, timed as g1 is;
  km1, km2, km3     kernels KM1 (the assignment), KM2 (one Lloyd step's
                    sums) and KM3 (one k-means++ step) alone at 2^20 x 64
                    points, k = 64, on chip_smoke.check_kmeans_kernels'
                    seeded data, timed as g1 is;
  km1_leaf, km2_leaf, km3_leaf,
  km1_merge, km2_merge
                    the same at the coreset's shapes: a leaf (2^16 x 64,
                    k = 8) and a merge (2,048 points);
  j1, j1_phase, j1_half
                    kernel J1 (the join's build) alone on bench's 2^24
                    build codes uniform in [0, 2^24) (seed 11), on the device
                    join phase's 2^22 codes in [0, 2^20), and on the 2^24
                    codes with half the rows set to one code, timed as g1 is
                    (10 calls a timing);
  x2, x2_8, x2_skew kernel X2 (the mesh exchange's partition scatter) alone
                    on chip_smoke's x_inputs (2^24 rows: k int64, s int32
                    codes, v f64, w int64; seed 19) at 4 partitions, at 8,
                    and at 4 with one key on half the rows, timed as j1 is;
  x2_phase          X2 at the mesh exchange's shape: 2^21 rows of time_
                    int64, k int64, s int32 codes, lv int64, 4 partitions;
  j3, j3_phase, j3_heavy
                    kernel J3 (the join's pair expansion) alone after J1
                    and J2 on 2^24 x 2^24 codes uniform in [0, 2^24), on the
                    device join phase's 2^22 x 2^22 in [0, 2^20), and on one
                    key with 4,096 rows a side over 2^20 background rows,
                    timed as j1 is; where the tree's J2 gives its tiles
                    (`join_probe(..., tiles=True)`), J3 is given them and
                    skips its counts pass, as the device join runs it;
  j2, j2_phase      kernel J2 (the join's probe) alone, in the device
                    join's form (with its tiles where the tree has them), on
                    j3's and j3_phase's codes, timed as j1 is;
  j2_j3, j2_j3_phase, j2_j3_heavy
                    J2 then J3 as the device join runs them, on j3's three
                    shapes: the sum of work that the tiles move between the
                    two kernels;
  k3, k3_s2         kernel K3 (the sketch's quantile finalize) alone, one
                    quantile, on Poisson(8) counts (seed 7) of 64 groups
                    (config #1's) and of 4,096 (S2's), timed as g1 is;
  k3_dev, k3_s2_dev the same by device time (chip_smoke
                    `kernel_device_ms`: calls queued while the card sleeps,
                    so the host's launch path is hidden; a tree whose K3
                    uploads from pageable memory every call waits for the
                    card in each call and cannot be timed so);
  fit               the kmeans_fit wall at chip_smoke's ml.fit shape (2^20
                    x 64, k = 64, 10 iterations): the median of 5 fits
                    after 2 settling ones, ms;
  k1_min_sorted, k1_max_sorted, k1_count_sorted, k1_sum_i64_sorted,
  k1_sum_f64_sorted
                    kernel K1 alone at the sorted path's chunk (2^20 rows,
                    ids uniform in [0, 2^23), 95% kept, exponential(50)
                    values, int64 values in [0, 2^24); seed 8): f64 min,
                    f64 max, count, int64 sum and f64 sum, each call into
                    the same state, timed as g1 is;
  k1_min_g64, k1_max_g64
                    the same f64 min and max at config #1's feed shape
                    (2^24 rows into 64 groups: the shared route);
  k1_min_s1         K1's f64 min over S1's pattern: 16 different such
                    chunks into one fresh state (filled before the timed
                    launches), the median of 5 sequences, ms a chunk;
  k4, k4_half, k4_dense
                    kernel K4 alone on chip_smoke's 2^24 rows of int32,
                    int64, f64 and bool (seed 9) at mask density 0.1, 0.5
                    and 0.9, timed as g1 is.

--measures names the measures to take (default all; config4 and the batch
arms alone are the paths where P1 and M1 run).  It prints one JSON line
per process, then the card's name and power limit,
then for each measure: each tree's median and quartiles over its
processes, the pairs this tree won, and the verdict — "gain" or "loss" when
one tree won at least nine tenths of the pairs and the medians differ by
more than the other tree's quartile spread, else "unresolved".  It needs
one CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

CHILD = r"""
import json, sys, threading, time
import torch
tree, rows, reps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
measures = set(sys.argv[4].split(","))
sys.path.insert(0, tree)
import chip_smoke as cs
from pixie_tpu_torch import flags
from pixie_tpu_torch.engine import execute_plan
from pixie_tpu_torch.ops import _build
from pixie_tpu_torch.parallel import LocalCluster
from pixie_tpu_torch.parallel.spmd import make_mesh
from pixie_tpu_torch.serving import batching  # noqa: F401  (defines PL_QUERY_BATCHING)
from pixie_tpu_torch.table import TableStore

dev = torch.device("cuda", 0)
_build.build_all()
out = {"tree": tree}


def warm_ms(query):
    times = cs.warm_times(query, 3, reps)
    return times[len(times) // 2] * 1e3


ts = TableStore()
if measures & {"one_feed", "four_feeds", "four_feeds_mesh4", "batch_unbatched",
               "batch_batched", "g1"}:
    cs.build_http_table(ts, rows)
plan = cs.http_plan()
mesh = None


def query():
    execute_plan(plan, ts, device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)


for label, feed_rows in (("one_feed", 1 << 24), ("four_feeds", rows // 4),
                         ("four_feeds_mesh4", rows // 4)):
    if label not in measures:
        continue
    flags.set_for_testing("PX_FEED_ROWS", feed_rows)
    if label == "four_feeds_mesh4":
        flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", 4)
        mesh = make_mesh(4, device=dev)
    out[label] = warm_ms(query)
    _build.reset_launches()
    query()
    out[label + "_launches"] = {lib: dict(k.by_entry) for lib, k in _build.KERNELS.items()
                                if k.launches}
flags.set_for_testing("PIXIE_TORCH_VIRTUAL_SHARDS", 1)
flags.set_for_testing("PX_FEED_ROWS", 1 << 24)

if "config2" in measures:
    ts2 = TableStore()
    cs.build_http_table(ts2, cs.ROWS)
    plan2 = cs.config2_plan()

    def query2():
        execute_plan(plan2, ts2, device=dev)
        torch.cuda.synchronize(dev)

    out["config2"] = warm_ms(query2)
    del ts2

if measures & {"c1", "c1_config2", "k2", "k2_config2"}:
    from pixie_tpu_torch.ops import chain as c1
    from pixie_tpu_torch.ops.sketch import LogHistogram

    lh = LogHistogram()
    chains = cs.chain_programs(dev)
    for (c_label, k_label, groups), (_l, kern, cols, luts, scalars, _lim, _p) in zip(
            (("c1", "k2", 64), ("c1_config2", "k2_config2", 1024)), chains):
        n = cs.FEED

        def run(kern=kern, cols=cols, luts=luts, scalars=scalars, n=n):
            return kern.run_segments(kern.segments, cols, n, n, -(2 ** 63), 2 ** 63 - 1,
                                     None, luts, scalars, runner=c1.run)

        if c_label in measures:
            out[c_label] = sorted(cs.cuda_ms(run, 20) for _ in range(5))[2]
        if k_label in measures:
            mask, gid, _outs, _c = run()
            acc, lat = lh.init(groups, dev), cols["latency"]
            out[k_label] = sorted(cs.cuda_ms(lambda: lh.update(acc, gid, lat, mask, groups),
                                             20) for _ in range(5))[2]
    del chains

if "g1" in measures:
    from pixie_tpu_torch.ops import gang as g1

    fresh, members, _per_sink, cols, _n_valid = cs.gang_feed(dev, ts)
    n = next(iter(cols.values())).shape[0]
    ms = members(fresh())
    out["g1"] = sorted(cs.cuda_ms(lambda: g1.run(ms, n, dev), 20) for _ in range(5))[2]

KM = {"": (cs.ML_N, cs.ML_K, 41), "_leaf": (cs.TREE_BATCH, cs.TREE_K, 48),
      "_merge": (2 * cs.TREE_M, cs.TREE_K, 48)}
for label, (n, k, seed) in KM.items():
    if not measures & {"km1" + label, "km2" + label, "km3" + label}:
        continue
    from pixie_tpu_torch.ops import kmeans as kops

    # chip_smoke.check_kmeans_kernels' data (written out here: the parent's
    # chip_smoke may not have its helper)
    x, cent = cs.ml_blobs(dev, n, cs.ML_D, k, seed, 10.0)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    c = (cent + 0.5 * torch.randn(cent.shape, generator=g, device=dev)).contiguous()
    w = torch.rand(n, generator=g, device=dev) + 0.5
    if "km1" + label in measures:
        out["km1" + label] = sorted(cs.cuda_ms(lambda: kops.assign(x, c), 20)
                                    for _ in range(5))[2]
    if "km2" + label in measures:
        out["km2" + label] = sorted(cs.cuda_ms(lambda: kops.lloyd_step(x, w, c), 20)
                                    for _ in range(5))[2]
    if "km3" + label in measures:
        mind = torch.full((n,), float("inf"), device=dev)
        kops.seed_step(x, w, c[0], mind)
        out["km3" + label] = sorted(cs.cuda_ms(lambda: kops.seed_step(x, w, c[1], mind), 20)
                                    for _ in range(5))[2]
    del x, cent, c, w

if measures & {"j1", "j1_phase", "j1_half"}:
    import numpy as np
    from pixie_tpu_torch.ops import join_device as jd

    rng = np.random.default_rng(11)
    uni = rng.integers(0, 1 << 24, 1 << 24)
    half = np.where(rng.random(1 << 24) < 0.5, 777, uni)
    for label, codes, K in (("j1", uni, 1 << 24),
                            ("j1_phase", rng.integers(0, 1 << 20, 1 << 22), 1 << 20),
                            ("j1_half", half, 1 << 24)):
        if label in measures:
            b = torch.from_numpy(codes.astype(np.int64)).to(dev)
            out[label] = sorted(cs.cuda_ms(lambda: jd.join_build(b, K), 10)
                                for _ in range(5))[2]
            del b
    del uni, half

if measures & {"x2", "x2_8", "x2_skew", "x2_phase"}:
    import numpy as np
    from pixie_tpu_torch.ops import repartition as xr

    def x2_time(keys, cols, nv, n_dev):
        part, counts, tiles = xr.partition_count(keys, nv, n_dev)
        cap = int(counts.max())
        return sorted(cs.cuda_ms(lambda: xr.partition_scatter(part, tiles, counts, cols, n_dev,
                                                              cap), 10) for _ in range(5))[2]

    rng = np.random.default_rng(19)
    for label, n_dev, skew in (("x2", 4, False), ("x2_8", 8, False), ("x2_skew", 4, True)):
        if label in measures:
            keys, cols, nv = cs.x_inputs(dev, n_dev, skew, rng)
            out[label] = x2_time(keys, cols, nv, n_dev)
            del keys, cols
    if "x2_phase" in measures:
        # the mesh exchange's shape: one agent's left_t, 2^21 rows of time_
        # int64, k int64 in [0, 2^20), s int32 codes of 16 services, lv int64
        n = 1 << 21
        lut = torch.from_numpy(xr.value_hash_lut([f"svc-{i}" for i in range(16)])).to(dev)
        cols = [torch.from_numpy(a).to(dev) for a in (
            np.arange(n, dtype=np.int64), rng.integers(0, 1 << 20, n).astype(np.int64),
            rng.integers(0, 16, n).astype(np.int32), rng.integers(0, 1 << 40, n))]
        out["x2_phase"] = x2_time([(cols[1], None), (cols[2], lut)], cols,
                                  np.full(4, n // 4, dtype=np.int64), 4)
        del cols

if measures & {"k3", "k3_s2", "k3_dev", "k3_s2_dev"}:
    import numpy as np
    from pixie_tpu_torch.ops.sketch import LogHistogram

    lh = LogHistogram()
    rng = np.random.default_rng(7)
    for label, g in (("k3", 64), ("k3_s2", 4096)):
        h = torch.from_numpy(rng.poisson(8.0, (g, lh.width)).astype(np.float32)).to(dev)
        if label in measures:
            out[label] = sorted(cs.cuda_ms(lambda: lh.quantile_device(h, [0.5]), 20)
                                for _ in range(5))[2]
        if label + "_dev" in measures:
            out[label + "_dev"] = sorted(cs.kernel_device_ms(
                lambda: lh.quantile_device(h, [0.5]), 20) for _ in range(5))[2]
        del h

JOIN_MEASURES = {"j2", "j2_phase", "j3", "j3_phase", "j3_heavy", "j2_j3", "j2_j3_phase",
                 "j2_j3_heavy"}
if measures & JOIN_MEASURES:
    import inspect

    import numpy as np
    from pixie_tpu_torch.ops import join_device as jd

    # the device join's own form: J2 with its tiles and J3 given them, where
    # the tree's J2 gives them
    tiled = "tiles" in inspect.signature(jd.join_probe).parameters

    def probe(p, cnt, first):
        return jd.join_probe(p, cnt, first, tiles=True) if tiled else jd.join_probe(p, cnt, first)

    def expand(got, rbc, nb, total):
        tail = (got[3],) if tiled else ()
        return jd.join_expand(got[0], got[1], rbc, nb, total, *tail)

    rng = np.random.default_rng(11)
    bg = rng.integers(100, 1 << 22, 1 << 20)
    cases = {"": (rng.integers(0, 1 << 24, 1 << 24), rng.integers(0, 1 << 24, 1 << 24)),
             "_phase": (rng.integers(0, 1 << 20, 1 << 22), rng.integers(0, 1 << 20, 1 << 22)),
             # one key with 4,096 rows a side over 2^20 background rows
             "_heavy": (np.concatenate([np.full(4096, 7), bg]),
                        np.concatenate([np.full(4096, 7), bg[::-1]]))}
    for suffix, (bh, ph) in cases.items():
        if not measures & {m + suffix for m in ("j2", "j3", "j2_j3")}:
            continue
        b, p, K = jd._dense(torch.from_numpy(bh.astype(np.int64)).to(dev),
                            torch.from_numpy(ph.astype(np.int64)).to(dev))
        nb = b.shape[0]
        cnt, first, rbc = jd.join_build(b, K)
        got = probe(p, cnt, first)
        total = int(got[2])
        for label, fn in (("j2", lambda: probe(p, cnt, first)),
                          ("j3", lambda: expand(got, rbc, nb, total)),
                          ("j2_j3", lambda: expand(probe(p, cnt, first), rbc, nb, total))):
            if label + suffix in measures:
                out[label + suffix] = sorted(cs.cuda_ms(fn, 10) for _ in range(5))[2]
        del b, p, cnt, first, rbc, got
    del bg, cases

K1_MEASURES = {"k1_min_sorted", "k1_max_sorted", "k1_count_sorted", "k1_sum_i64_sorted",
               "k1_sum_f64_sorted", "k1_min_s1", "k1_min_g64", "k1_max_g64"}
if measures & K1_MEASURES:
    import numpy as np
    from pixie_tpu_torch.ops import groupby as gb

    n, g = 1 << 20, 1 << 23
    rng = np.random.default_rng(8)
    chunks = [tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, g, n).astype(np.int32), rng.random(n) < 0.95,
        rng.exponential(50.0, n))) for _ in range(16)]
    gid, mask, lat = chunks[0]
    nbytes = torch.from_numpy(rng.integers(0, 1 << 24, n)).to(dev)
    feed = tuple(torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 64, cs.FEED).astype(np.int32), rng.random(cs.FEED) < 0.95,
        rng.exponential(50.0, cs.FEED)))
    for label, op, (gi, m, v), groups in (
            ("k1_min_sorted", "min", chunks[0], g), ("k1_max_sorted", "max", chunks[0], g),
            ("k1_min_g64", "min", feed, 64), ("k1_max_g64", "max", feed, 64)):
        if label in measures:
            acc = torch.full((groups,), gb._identity_for(torch.float64, op),
                             dtype=torch.float64, device=dev)
            fn = getattr(gb, f"masked_segment_{op}")
            out[label] = sorted(cs.cuda_ms(lambda: fn(v, gi, groups, m, out=acc), 20)
                                for _ in range(5))[2]
    if "k1_count_sorted" in measures:
        acc = torch.zeros(g, dtype=torch.int64, device=dev)
        out["k1_count_sorted"] = sorted(cs.cuda_ms(lambda: gb.masked_segment_count(
            gid, g, mask, out=acc), 20) for _ in range(5))[2]
    for label, v in (("k1_sum_i64_sorted", nbytes), ("k1_sum_f64_sorted", lat)):
        if label in measures:
            acc = torch.zeros(g, dtype=v.dtype, device=dev)
            out[label] = sorted(cs.cuda_ms(lambda: gb.masked_segment_sum(
                v, gid, g, mask, out=acc), 20) for _ in range(5))[2]
    if "k1_min_s1" in measures:
        acc = torch.empty(g, dtype=torch.float64, device=dev)
        seqs = []
        for _ in range(7):
            acc.fill_(float("inf"))
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for gi, m, v in chunks:
                gb.masked_segment_min(v, gi, g, m, out=acc)
            stop.record()
            torch.cuda.synchronize()
            seqs.append(start.elapsed_time(stop) / len(chunks))
        out["k1_min_s1"] = sorted(seqs[2:])[2]
    del chunks, gid, mask, lat, nbytes, feed

if measures & {"k4", "k4_half", "k4_dense"}:
    import numpy as np
    from pixie_tpu_torch.ops import compact as k4

    # chip_smoke.check_new_kernels' K4 inputs (seed 9)
    rng = np.random.default_rng(9)
    n = cs.FEED
    cols = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32),
        rng.integers(-2 ** 62, 2 ** 62, n), rng.normal(size=n), rng.random(n) < 0.5)]
    u = torch.from_numpy(rng.random(n)).to(dev)
    for label, density in (("k4", 0.1), ("k4_half", 0.5), ("k4_dense", 0.9)):
        if label in measures:
            m = u < density
            out[label] = sorted(cs.cuda_ms(lambda: k4.compact(m, cols), 20)
                                for _ in range(5))[2]
    del cols, u

if "fit" in measures:
    from pixie_tpu_torch.ml import kmeans_fit

    x, _cent = cs.ml_blobs(dev, cs.ML_N, cs.ML_D, cs.ML_K, 17, cs.ML_SPREAD)
    walls = []
    for i in range(7):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        kmeans_fit(x, cs.ML_K, max_iters=cs.ML_ITERS, seed=5, device=dev)
        if i >= 2:
            walls.append((time.perf_counter() - t0) * 1e3)
    out["fit"] = sorted(walls)[2]
    del x, _cent

# the four BATCH_SCRIPTS from 16 threads, batching off and on
cl = LocalCluster({"pem0": ts}, device=dev)


def clients(nq):
    errs = []
    barrier = threading.Barrier(17, timeout=300)

    def run(i):
        try:
            barrier.wait()
            for _ in range(nq):
                cl.query(cs.BATCH_SCRIPTS[i])
            torch.cuda.synchronize(dev)
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i % 4,)) for i in range(16)]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errs or any(t.is_alive() for t in threads):
        raise AssertionError(f"batch clients failed: {errs[:3]}")
    return 16 * nq / wall


for arm, on in (("batch_unbatched", False), ("batch_batched", True)):
    if arm not in measures:
        continue
    flags.set_for_testing("PL_QUERY_BATCHING", on)
    flags.set_for_testing("PX_MQ_FUSION", -1 if on else 0)
    clients(1)
    out[arm] = clients(4)
del cl, ts

if "config3" in measures:
    out["config3"] = cs.run_config3(dev)["warm_median_s"] * 1e3

if "config4" in measures:
    stores, _tables = cs._agent_stores(cs.CONFIG4_ROWS // cs.CONFIG4_AGENTS)
    cluster_query = cs.cluster_query(LocalCluster(stores, device=dev), dev, m1_launches=1)
    out["config4"] = warm_ms(cluster_query)
print(json.dumps(out), flush=True)
"""

#: measure → True when higher is better
MEASURES = {"one_feed": False, "four_feeds": False, "four_feeds_mesh4": False,
            "config3": False, "config4": False, "batch_unbatched": True,
            "batch_batched": True, "config2": False, "g1": False, "c1": False,
            "c1_config2": False, "k2": False, "k2_config2": False, "km1": False,
            "km2": False, "km3": False, "km1_leaf": False, "km2_leaf": False,
            "km3_leaf": False, "km1_merge": False, "km2_merge": False, "j1": False,
            "j1_phase": False, "j1_half": False, "x2": False, "x2_8": False,
            "x2_skew": False, "x2_phase": False, "j3": False, "j3_phase": False,
            "j3_heavy": False, "k3": False, "k3_s2": False, "k3_dev": False,
            "k3_s2_dev": False, "j2": False, "j2_phase": False, "j2_j3": False,
            "j2_j3_phase": False, "j2_j3_heavy": False, "fit": False, "k1_min_sorted": False,
            "k1_max_sorted": False, "k1_count_sorted": False, "k1_sum_i64_sorted": False,
            "k1_sum_f64_sorted": False, "k1_min_s1": False, "k1_min_g64": False,
            "k1_max_g64": False,
            "k4": False, "k4_half": False, "k4_dense": False}


def quartiles(xs: list) -> tuple[float, float, float]:
    s = sorted(xs)

    def at(q):
        i = q * (len(s) - 1)
        lo = int(i)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (i - lo)

    return at(0.25), at(0.5), at(0.75)


def verdict(this: list, other: list, higher_better: bool) -> dict:
    """The medians and quartiles of both trees, the pairs this tree won and
    the verdict (see the module docstring)."""
    sign = 1.0 if higher_better else -1.0
    wins = sum(1 for a, b in zip(this, other) if sign * (a - b) > 0)
    losses = sum(1 for a, b in zip(this, other) if sign * (a - b) < 0)
    q_this, q_other = quartiles(this), quartiles(other)
    diff = abs(q_this[1] - q_other[1])
    spread = q_other[2] - q_other[0]
    pairs = len(this)
    if wins >= 0.9 * pairs and diff > spread:
        word = "gain"
    elif losses >= 0.9 * pairs and diff > spread:
        word = "loss"
    else:
        word = "unresolved"
    return {"this": {"median": q_this[1], "q1": q_this[0], "q3": q_this[2]},
            "other": {"median": q_other[1], "q1": q_other[0], "q3": q_other[2]},
            "pairs": pairs, "this_won": wins, "other_won": losses, "verdict": word}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="another checkout of the repository")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--rows", type=int, default=1 << 24)
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--measures", default=",".join(MEASURES),
                    help="comma-separated measures to take (default: all)")
    args = ap.parse_args()
    measures = args.measures.split(",")
    unknown = set(measures) - set(MEASURES)
    if unknown:
        ap.error(f"unknown measures: {sorted(unknown)}")
    import torch

    if not torch.cuda.is_available():
        print("ab_finalize: no CUDA device is available", file=sys.stderr)
        return 2
    here = str(pathlib.Path(__file__).resolve().parent)
    other = str(pathlib.Path(args.other).resolve())
    runs = {here: [], other: []}
    for i in range(args.pairs):
        for tree in ((other, here) if i % 2 == 0 else (here, other)):
            proc = subprocess.run([sys.executable, "-c", CHILD, tree, str(args.rows),
                                   str(args.reps), ",".join(measures)], cwd=tree, capture_output=True, text=True,
                                  # views off: each measure times the rescan route
                                  # (config4's second query would be a view hit)
                                  env=dict(os.environ, PYTHONPATH=tree,
                                           PL_MATVIEW_ENABLED="0"), timeout=900)
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode or 1
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs[tree].append(json.loads(line))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    for name, higher in MEASURES.items():
        if name not in measures:
            continue
        print(json.dumps({"measure": name, "unit": "q/s" if higher else "ms",
                          **verdict([r[name] for r in runs[here]],
                                    [r[name] for r in runs[other]], higher)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
