#!/usr/bin/env python3
"""A/B of one design choice of C1 or K2 against its alternative, end to end
of the kernel, on one CUDA card.

    python3 ab_kernels.py CHOICE [--pairs N]

CHOICE names the alternative.  The script writes a copy of this checkout's
pixie_tpu_torch/ and chip_smoke.py with that one edit into
_archive/ab_kernels/CHOICE/ (gitignored) and runs `ab_finalize.py COPY
--pairs N --measures ...` on the measures the choice touches, in
alternating pairs of fresh processes; ab_finalize's "this" is the checkout,
its "other" the alternative.

  c1_rows4   C1 at 4 rows a thread where the checkout takes 8 (csrc/chain.cu
             px_chain_run) — measures c1, c1_config2;
  c1_locals2 C1 holding two columns in registers where the checkout holds
             one (csrc/chain.cu) — measures c1, c1_config2;
  c1_bounds2 C1 at 2 blocks a SM (128 registers a thread) where the
             checkout takes 3 (85) — measures c1, c1_config2;
  c1_search  SEARCH as a binary search at every LUT length, without the
             count over a LUT of at most kSmallLut entries (csrc/chain.cuh)
             — measure c1;
  k2_match   K2's shared-memory counts with a warp's rows of one cell added
             by one lane (`__match_any_sync`, a popcount;
             csrc/loghist_update.cu) — measure k2.

It needs one CUDA card (ab_finalize.py exits non-zero without one).
"""
from __future__ import annotations

import argparse
import pathlib
import shutil
import subprocess
import sys

#: choice → ([(file under pixie_tpu_torch/csrc, text, its replacement)], measures)
CHOICES = {
    "c1_rows4": ([("chain.cu",
                   "  if (slots * 8 * kBlock * 8 <= kSmallSmem) return launch<8>(*p, s);\n",
                   "")], "c1,c1_config2"),
    "c1_locals2": ([("chain.cu", "    run_tile<R, kBlock, 1>(p, base, stk, mask, gid, store);\n",
                     "    run_tile<R, kBlock, 2>(p, base, stk, mask, gid, store);\n")],
                   "c1,c1_config2"),
    "c1_bounds2": ([("chain.cu", "__launch_bounds__(kBlock, 3) chain_kernel(",
                     "__launch_bounds__(kBlock, 2) chain_kernel(")], "c1,c1_config2"),
    "c1_search": ([("chain.cuh", "        if (len <= kSmallLut) {\n",
                    "        if (false) {\n")], "c1"),
    "k2_match": ([("loghist_update.cu",
                   "    if (keep) atomicAdd(counts + g * width + bin, 1u);\n",
                   "    const unsigned peers = __match_any_sync(0xffffffffu, keep ? g * width + bin "
                   ": -1);\n"
                   "    if (keep && (peers & ((1u << (threadIdx.x & 31u)) - 1u)) == 0u)\n"
                   "      atomicAdd(counts + g * width + bin, static_cast<unsigned>(__popc(peers)));\n")],
                 "k2"),
}


def write_alternative(here: pathlib.Path, choice: str) -> pathlib.Path:
    """The checkout's package and chip_smoke.py with the choice's edits,
    under _archive/ab_kernels/<choice>; → its root."""
    out = here / "_archive" / "ab_kernels" / choice
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copytree(here / "pixie_tpu_torch", out / "pixie_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy2(here / "chip_smoke.py", out / "chip_smoke.py")
    for name, old, new in CHOICES[choice][0]:
        path = out / "pixie_tpu_torch" / "csrc" / name
        text = path.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"ab_kernels: {choice}: the text to replace is not in {name} "
                             "exactly once")
        path.write_text(text.replace(old, new))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("choice", choices=sorted(CHOICES))
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    here = pathlib.Path(__file__).resolve().parent
    other = write_alternative(here, args.choice)
    print(f"ab_kernels: {args.choice}: this checkout against {other}", flush=True)
    return subprocess.run([sys.executable, str(here / "ab_finalize.py"), str(other),
                           "--pairs", str(args.pairs), "--measures",
                           CHOICES[args.choice][1]], cwd=here).returncode


if __name__ == "__main__":
    sys.exit(main())
