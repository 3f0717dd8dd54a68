#!/usr/bin/env python3
"""A/B of where G1's blocks read the launch's member and leaf table, in one
process on one CUDA card.

    python3 ab_gang.py [--pairs N] [--rows N]

csrc/gang.cuh `gang_pass` reads the table where the launch put it, in its
parameter space (a `__grid_constant__` struct).  The alternative has each
block copy the table into its shared memory first and read it there.  This
script builds gang.cu as it is and, from a copy of csrc/ with that copy
written in (`with_table_copy`), the alternative; makes the four
BATCH_SCRIPTS members over the first 16M-row feed of bench's
build_http_table at --rows rows (chip_smoke `gang_feed`); holds each
build's states against G1's plain version (chip_smoke `gang_compare`:
float64 sums to rtol 1e-12, every other leaf exactly); then times both on
the same host rows in --pairs alternating pairs (A B, then B A) of 20
launches by CUDA events.  It prints the card's name and power limit and one
JSON line: each build's median and quartiles (ms a launch) and the pairs
each won.  It needs one CUDA card and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

#: px_gang_partial (csrc/gang.cu): rows, members, leaves, n, depth, outs,
#: acc_bytes, rows_per_thread, threads, device, stream
ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong] + \
    [ctypes.c_int] * 6 + [ctypes.c_void_p]


#: gang.cuh, gang_pass: the stack at the start of shared memory → the table
#: copied there first, the stack after it
_PASS = "  long long* stk = smem;\n"
_PASS_COPY = """  const int mbytes = n_members * static_cast<int>(sizeof(GangMember));
  const int tbytes = mbytes + n_leaves * static_cast<int>(sizeof(GangLeaf));
  for (int w = threadIdx.x; w < tbytes / 8; w += B) {
    smem[w] = w < mbytes / 8 ? reinterpret_cast<const long long*>(members)[w]
                             : reinterpret_cast<const long long*>(leaves)[w - mbytes / 8];
  }
  __syncthreads();
  members = reinterpret_cast<const GangMember*>(smem);
  leaves = reinterpret_cast<const GangLeaf*>(reinterpret_cast<const unsigned char*>(smem) +
                                             mbytes);
  long long* stk = smem + tbytes / 8;
"""
#: gang.cu, launch: the dynamic shared memory → with the table's bytes
_SMEM = "  const size_t smem = gang_smem_bytes(R, B, depth, outs, acc_bytes);\n"
_SMEM_COPY = ("  const size_t smem = gang_smem_bytes(R, B, depth, outs, acc_bytes) +\n"
              "      sizeof(GangMember) * n_members + sizeof(GangLeaf) * n_leaves;\n")


def with_table_copy(csrc, out_dir):
    """csrc/ copied into out_dir with each block copying the table into its
    shared memory; → the path of the copy's gang.cu."""
    import shutil

    dst = out_dir / "csrc"
    shutil.copytree(csrc, dst, dirs_exist_ok=True)
    for name, old, new in (("gang.cuh", _PASS, _PASS_COPY), ("gang.cu", _SMEM, _SMEM_COPY)):
        text = (dst / name).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"ab_gang: {name} no longer has the line this A/B rewrites")
        (dst / name).write_text(text.replace(old, new))
    return dst / "gang.cu"


def build_table_copy():
    """px_gang_partial of gang.cu with the table copied into shared memory."""
    import hashlib
    import tempfile
    import pathlib

    from pixie_tpu_torch.ops import _build

    digest = hashlib.sha256((_build._digest("gang.cu") + _PASS_COPY + _SMEM_COPY).encode())
    out = _build.BUILD_DIR / f"libgang-table-copy-{digest.hexdigest()[:16]}.so"
    if not out.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory() as tmp:
            src = with_table_copy(_build.CSRC, pathlib.Path(tmp))
            subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                           check=True)
    fn = ctypes.CDLL(str(out)).px_gang_partial
    fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--rows", type=int, default=1 << 24)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_gang: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pixie_tpu_torch.ops import _build
    from pixie_tpu_torch.ops import gang as g1
    from pixie_tpu_torch.table import TableStore

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    builds = {"table_in_params": _build.function("gang", "px_gang_partial", ARGTYPES),
              "table_in_smem": build_table_copy()}
    ts = TableStore()
    cs.build_http_table(ts, args.rows)
    fresh, members, _per_sink, cols, _n_valid = cs.gang_feed(dev, ts)
    n = next(iter(cols.values())).shape[0]

    def runner(fn, ms):
        plan = g1.plan_for(ms, dev)

        def run():
            bufs = plan.rows(ms, n, dev.index)
            stream = _build.raw_stream(dev.index)
            for buf, (_a, _b, pp, codec) in zip(bufs, plan.launches):
                err = fn(buf.ctypes.data, codec.n_members, codec.n_leaves, n, pp.depth,
                         pp.outs, pp.acc_bytes, pp.rows_per_thread, pp.block, dev.index,
                         stream)
                _build.check("gang", err, "gang")

        return run

    for label, fn in builds.items():
        a, b = fresh(), fresh()
        runner(fn, members(a))()
        g1.run_plain(members(b), n, dev)
        torch.cuda.synchronize()
        cs.gang_compare(f"{label} against its plain version", members(a), members(b))
    ms = members(fresh())
    runs = {label: runner(fn, ms) for label, fn in builds.items()}
    times = {label: [] for label in builds}
    order = list(builds)
    for i in range(args.pairs):
        for label in (order if i % 2 == 0 else order[::-1]):
            times[label].append(cs.cuda_ms(runs[label], 20))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    a, b = order
    out = {"rows": n, "members": len(ms), "pairs": args.pairs,
           **{label: dict(zip(("q1", "median", "q3"), _quartiles(t)), ms=t)
              for label, t in times.items()},
           f"{a}_won": sum(x < y for x, y in zip(times[a], times[b])),
           f"{b}_won": sum(y < x for x, y in zip(times[a], times[b]))}
    print(json.dumps(out))
    return 0


def _quartiles(xs: list) -> tuple:
    s = sorted(xs)

    def at(q):
        i = q * (len(s) - 1)
        lo = int(i)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (i - lo)

    return at(0.25), at(0.5), at(0.75)


if __name__ == "__main__":
    sys.exit(main())
