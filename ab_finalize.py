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
                    config #2 chain (1,024 groups) give, timed as g1 is.

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
            "c1_config2": False, "k2": False, "k2_config2": False}


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
                                  env=dict(os.environ, PYTHONPATH=tree), timeout=900)
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
