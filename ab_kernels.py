#!/usr/bin/env python3
"""A/B of one design choice of C1, K2, KM1-KM3 or J1 against its
alternative, end to end of the kernel, on one CUDA card; and where KM2's
time goes.

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
             csrc/loghist_update.cu) — measure k2;
  km2_shared_sums
             KM2's float64 sums in shared memory where the checkout holds
             them in registers (k <= 64, d <= 64; csrc/kmeans.cu) —
             measures km2, km2_leaf;
  km2_tile8x8
             KM2 at 8 points x 8 centers a thread, 256-point tiles and 1
             block an SM, where the checkout takes 4 x 8, 128 and 2
             (csrc/kmeans.cu) — measures km2, km2_leaf, km2_merge;
  km3_staged KM3 over 128-row tiles staged in shared memory by cp.async,
             one thread a row, where the checkout's half-warps share rows
             (csrc/kmeans.cu) — measures km3, km3_leaf;
  km2_pairs  KM2's accumulate taking two points a warp-iteration, their
             loads in flight together — measures km2, km2_leaf;
  km1_tile8x8
             KM1 at 8 points x 8 centers a thread (2 x 4 at k <= 8) in
             128-thread blocks, where the checkout takes KM2's 4 x 8 (1 x 4)
             in 256-thread blocks (csrc/kmeans.cu) — measures km1, km1_leaf,
             km1_merge;
  j1_digits12
             J1's sort at 12 bits a pass (two passes at K = 2^24; the 4096
             digits' counts of 8 warps hold one 256-thread block an SM, 16
             rows a thread), where the checkout takes 8 bits (csrc/join.cu)
             — measures j1, j1_phase, j1_half;
  j1_match   J1's rank with __match_any_sync where the checkout takes a
             ballot a digit bit (csrc/join.cu) — measures j1, j1_phase.

Where KM2's time goes: these switch one part of KM2 off and compute wrong
sums, so only their times are read (measures km2, km2_leaf):

  km2_no_accumulate  the tile's w and w * x not added (the distances, the
                     ids and the last blocks' sums stay);
  km2_no_tail        the blocks' partials not summed (no tickets, no
                     output);
  km2_stream_only    neither distances nor the accumulate: x streamed into
                     shared memory, the tail kept.

Where KM1's time goes, the same way (measure km1; the distance pass is
KM2's, so these edit both):

  km1_stream_only    no distances: x streamed into shared memory, each
                     point's nearest left at its start;
  km1_no_x2          the |x|^2 chain off (distances without it).

It needs one CUDA card (ab_finalize.py exits non-zero without one).
"""
from __future__ import annotations

import argparse
import pathlib
import shutil
import subprocess
import sys

# KM3's staged design, written into kmeans.cu before launch_seed_lanes
_KM3_STAGED = """constexpr int kSeedTile = 128;  // rows of a staged tile

// x (16-byte aligned, d % 4 == 0) in tiles of kSeedTile rows by cp.async,
// double-buffered; thread r sums row r of the tile in dimension order.
__global__ void __launch_bounds__(kSeedTile) seed_step_staged(
    const float* __restrict__ x, const float* __restrict__ w, long long n, int d,
    const float* __restrict__ c, float* __restrict__ mind, float* __restrict__ p) {
  extern __shared__ __align__(16) float ssm[];
  const int xsd = d + 4;
  float* cs = ssm + 2 * kSeedTile * xsd;
  __shared__ float c2s;
  const int tid = threadIdx.x;
  for (int j = tid; j < d; j += kSeedTile) cs[j] = c[j];
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(cs[j], cs[j], s);
    c2s = s;
  }
  const long long tiles = (n + kSeedTile - 1) / kSeedTile;
  const long long stages =
      blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int per = d >> 2;
  auto issue = [&](long long s) {
    const long long p0 = (blockIdx.x + s * gridDim.x) * kSeedTile;
    const int np = static_cast<int>(min(static_cast<long long>(kSeedTile), n - p0));
    float* buf = ssm + (s & 1) * (kSeedTile * xsd);
    for (int i = tid; i < np * per; i += kSeedTile) {
      const int r = i / per, j = (i - r * per) << 2;
      cp_async16(buf + r * xsd + j, x + (p0 + r) * d + j);
    }
    cp_async_commit();
  };
  if (stages > 0) issue(0);
  __syncthreads();
  const float c2 = c2s;
  const float4* c4 = reinterpret_cast<const float4*>(cs);
  for (long long s = 0; s < stages; ++s) {
    if (s + 1 < stages) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const long long i = (blockIdx.x + s * gridDim.x) * kSeedTile + tid;
    if (i < n) {
      const float4* row = reinterpret_cast<const float4*>(ssm + (s & 1) * (kSeedTile * xsd) +
                                                          tid * xsd);
      float x2 = 0.f, dot = 0.f;
      for (int j = 0; j < per; ++j) {
        const float4 v = row[j], cv = c4[j];
        x2 = fmaf(v.x, v.x, x2);
        x2 = fmaf(v.y, v.y, x2);
        x2 = fmaf(v.z, v.z, x2);
        x2 = fmaf(v.w, v.w, x2);
        dot = fmaf(v.x, cv.x, dot);
        dot = fmaf(v.y, cv.y, dot);
        dot = fmaf(v.z, cv.z, dot);
        dot = fmaf(v.w, cv.w, dot);
      }
      seed_fold(i, x2, dot, c2, w, mind, p);
    }
    __syncthreads();
  }
}

int launch_seed_staged(const float* x, const float* w, long long n, int d, const float* c,
                       float* mind, float* p, cudaStream_t stream) {
  static size_t opted[PX_MAX_DEVICES] = {0};
  const size_t smem = sizeof(float) * (2 * kSeedTile * (d + 4) + d);
  const int err = opt_in(seed_step_staged, smem, opted);
  if (err != 0) return err;
  const long long grid = px_grid(seed_step_staged, n, kSeedTile, smem);
  seed_step_staged<<<static_cast<unsigned>(grid), kSeedTile, smem, stream>>>(x, w, n, d, c,
                                                                             mind, p);
  return static_cast<int>(cudaGetLastError());
}

"""
_KM3_LANES = "  return vec ? launch_seed_lanes<true>("
_KM3_BEFORE = "template <bool kVec>\nint launch_seed_lanes("
# KM2's accumulate in registers, one point a warp-iteration, and two
_KM2_ONE = """            while (bal) {
              const int q = q0 + __ffs(bal) - 1;
              bal &= bal - 1;
              const float wq = tile_w[q];
              const float* row = buf + q * kXS;
              // the float32 product x * w, rounded as the reference rounds
              // it (no FMA contraction into the float64 add)
              if (lane < d) rs[sl][0] += static_cast<double>(__fmul_rn(row[lane], wq));
              if (lane + 32 < d) rs[sl][1] += static_cast<double>(__fmul_rn(row[lane + 32], wq));
              if (lane == sl) rw += static_cast<double>(wq);
            }
"""
_KM2_TWO = """            while (bal) {
              const int qa = q0 + __ffs(bal) - 1;
              bal &= bal - 1;
              const bool two = bal != 0;
              const int qb = two ? q0 + __ffs(bal) - 1 : qa;
              bal &= bal - 1;
              const float wa = tile_w[qa], wb = tile_w[qb];
              const float a0 = buf[qa * kXS + lane], a1 = buf[qa * kXS + lane + 32];
              const float b0 = buf[qb * kXS + lane], b1 = buf[qb * kXS + lane + 32];
              if (lane < d) {
                rs[sl][0] += static_cast<double>(__fmul_rn(a0, wa));
                if (two) rs[sl][0] += static_cast<double>(__fmul_rn(b0, wb));
              }
              if (lane + 32 < d) {
                rs[sl][1] += static_cast<double>(__fmul_rn(a1, wa));
                if (two) rs[sl][1] += static_cast<double>(__fmul_rn(b1, wb));
              }
              if (lane == sl) {
                rw += static_cast<double>(wa);
                if (two) rw += static_cast<double>(wb);
              }
            }
"""
_KM2_ACC = ("kmeans.cu", "      accumulate(buf, p0);\n", "")
_KM2_TAIL = ("kmeans.cu",
             "    lloyd_finish(a.partials, a.gsums, a.tickets, rows, d, c_lo, a.wsum, a.xsum, flag);\n",
             "")
_KM2_DIST = ("kmeans.cu", "      for (int j = 0; j < dc4; j += 4) {",
             "      for (int j = 0; j < 0; j += 4) {")

# KM1's micro-tile, and J1's rank of a round's lanes by digit
_KM1_TILE = """  constexpr int PP = tile_points<KT>();
  static size_t opted[PX_MAX_DEVICES] = {0};
  const size_t smem = dist_smem<KT>(a.d, 0);"""
_J1_BALLOTS = """    unsigned peers = __ballot_sync(0xffffffffu, mine);
    if (!mine) peers = ~peers;
#pragma unroll
    for (int bit = 0; bit < kDigitBits; ++bit) {
      const bool on = (dg >> bit) & 1;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      peers &= on ? bal : ~bal;
    }"""

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
    "km2_shared_sums": ([("kmeans.cu",
                          "{ return k <= kWarps * kRegSlots && d <= kDT; }",
                          "{ return false; }")], "km2,km2_leaf"),
    "km2_tile8x8": ([("kmeans.cu", "constexpr int kTP = 128;", "constexpr int kTP = 256;"),
                     ("kmeans.cu", "constexpr int kPerSM = 2; ", "constexpr int kPerSM = 1; "),
                     ("kmeans.cu", "constexpr int tile_points() { return KT == 8 ? 1 : 4; }",
                      "constexpr int tile_points() { return KT == 8 ? 2 : 8; }")],
                    "km2,km2_leaf,km2_merge"),
    "km3_staged": ([("kmeans.cu", _KM3_BEFORE, _KM3_STAGED + _KM3_BEFORE),
                    ("kmeans.cu", _KM3_LANES,
                     "  if (vec && sizeof(float) * (2 * kSeedTile * (d + 4) + d) <=\n"
                     "                 static_cast<size_t>(px_smem_optin())) {\n"
                     "    return launch_seed_staged(x, w, n, d, c, mind, p, stream);\n"
                     "  }\n" + _KM3_LANES)], "km3,km3_leaf"),
    "km2_pairs": ([("kmeans.cu", _KM2_ONE, _KM2_TWO)], "km2,km2_leaf"),
    "km1_tile8x8": ([("kmeans.cu", _KM1_TILE,
                      _KM1_TILE.replace("tile_points<KT>()", "KT == 8 ? 2 : 8"))],
                    "km1,km1_leaf,km1_merge"),
    "j1_digits12": ([("join.cu", "constexpr int kDigitBits = 8;",
                      "constexpr int kDigitBits = 12;"),
                     ("join.cu", "constexpr int kSortBlock = 512; ",
                      "constexpr int kSortBlock = 256; "),
                     ("join.cu", "constexpr int kSortItems = 8; ",
                      "constexpr int kSortItems = 16; "),
                     ("join.cu", "constexpr int kScatterPerSM = 3; ",
                      "constexpr int kScatterPerSM = 1; ")], "j1,j1_phase,j1_half"),
    "j1_match": ([("join.cu", _J1_BALLOTS,
                   "    const unsigned peers = __match_any_sync(0xffffffffu, dg);")],
                 "j1,j1_phase"),
    "km2_no_accumulate": ([_KM2_ACC], "km2,km2_leaf"),
    "km2_no_tail": ([_KM2_TAIL], "km2,km2_leaf"),
    "km2_stream_only": ([_KM2_ACC, _KM2_DIST], "km2,km2_leaf"),
    "km1_stream_only": ([_KM2_DIST], "km1"),
    "km1_no_x2": ([("kmeans.cu", "        if (kt == 0) {\n", "        if (false) {\n")], "km1"),
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
