#!/usr/bin/env python3
"""A/B of one design choice of C1, K1-K4, KM1-KM3, J1-J3 or X2 against
its alternative, end to end of the kernel, on one CUDA card; and where KM2's,
KM1's, X2's and J3's time goes.

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
             ballot a digit bit (csrc/join.cu) — measures j1, j1_phase;
  x2_match   X2's rank with __match_any_sync where the checkout takes a
             ballot a bit of the target (csrc/repartition.cu);
  x2_no_overlap
             X2 waiting for the next column's copy before it writes the
             current one (no overlap of the two);
  x2_gather  X2 writing each column gathered through the tile's
             permutation straight from device memory, not staged in
             shared memory;
  x2_torch_scan
             the tiles' first ranks by torch.cumsum in the wrapper
             (ops/repartition.py), not X2's tile_scan launch — the x2
             choices measure x2, x2_8, x2_phase;
  j3_pairs4096, j3_pairs8192
             J3 at 4,096 or 8,192 pairs a block where the checkout takes
             2,048 (csrc/join.cu);
  j3_bounds3 J3's expand at 3 blocks a SM (2 in the checkout);
  j3_ilp     J3 taking 8 pairs a thread a round, their loads in flight
             together;
  j3_every_pair
             J3 setting a build row's bit from every pair, without first
             reading whether it is set;
  j3_owners  J3's counts pass claiming each matched code's run for one
             probe row (an atomicOr that returns the old bit), whose pairs
             alone set the bits (also ops/join_device.py) — the j3 choices
             measure j3, j3_phase, j3_heavy;
  k1_cas     K1's f64 min / max folding each row (and each block's flush)
             into device memory with the compare-and-swap loop of
             segment_ops.cuh, where the checkout loads the state word and
             folds a winning row with one non-returning integer min / max
             (csrc/segment_reduce.cu);
  k1_no_filter
             K1's f64 min / max folding every kept row with the
             non-returning integer min / max, without loading the state
             word first (a state's NaN of the other sign is then lost);
  k1_returning
             the same by a returning integer min / max, putting the op's
             NaN back where the old value was NaN (no load first);
  k1_batch2, k1_batch4, k1_batch8
             K1's f64 min / max loading 2, 4 or all 8 of a thread's state
             words at a time before folding those rows, where the checkout
             loads one, folds its row, then loads the next — the k1 choices
             measure k1_min_sorted, k1_max_sorted, k1_min_s1;
  k4_gather_only, k4_staged_only
             K4 gathering every tile's kept rows through its index list
             from device memory, or staging every tile's columns in shared
             memory by 16-byte cp.async, where the checkout stages a tile
             with half of its rows kept or more and gathers the rest
             (csrc/compact.cu);
  k4_dense4  K4 staging from a quarter of a tile's rows kept;
  k4_look_back
             K4's tile offsets by a decoupled look-back in one launch
             (after a memset of the tiles' status words and a ticket that
             hands out the tiles in the order blocks start), where the
             checkout takes three (the tiles' counts, a one-block scan, then
             the write; also ops/compact.py) — the k4 choices measure k4,
             k4_half, k4_dense;
  k3_block   K3 as first designed: one block a group, one thread a bin, a
             Hillis-Steele scan in shared memory and one __syncthreads_count
             a quantile, where the checkout takes a warp a group and
             shuffles (csrc/loghist_quantile.cu) — measures k3, k3_s2,
             k3_dev, k3_s2_dev;
  j2_unfused J2 without its tiles: J3 runs its own counts pass and scan,
             where the checkout's J2 hands J3 its tile offsets and
             probe_matched (ops/join_device.py) — measures j2, j2_phase,
             j3, j3_phase, j3_heavy, j2_j3, j2_j3_phase, j2_j3_heavy;
  j2_two_tables
             J1's code table as two tables, cnt and first apart, gathered
             by J2 in two loads, where the checkout interleaves them into
             one 8-byte (count, first) slot a code (csrc/join.cu,
             ops/join_device.py; J1's sort untouched) — measures j1,
             j1_phase, j2, j2_phase, j2_j3_phase;
  j2_block256
             J2 at 256 threads x 16 rows a 4,096-row tile, where the
             checkout takes 1,024 x 4 (csrc/join.cu) — measures j2,
             j2_phase.

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

Where X2's and J3's time goes, the same way (wrong outputs, times only):

  x2_stage_only      the columns staged but not written (x2, x2_8);
  j3_no_bits         build_matched's bits not set;
  j3_no_gather       the pairs' build rows not read from rows_by_code;
  j3_no_pairs        no pair written: the counts pass, the scan and the
                     expand blocks' search and tile scans alone.

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

# X2's rank of a round's lanes by target
_X2_BALLOTS = """    unsigned peers = __ballot_sync(0xffffffffu, mine);
    if (!mine) peers = ~peers;
    for (int bit = 0; bit < bits; ++bit) {
      const bool on = (p >> bit) & 1;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      peers &= on ? bal : ~bal;
    }"""

# J3: the pair loop's head (one pair a thread a round) and its ILP form
_J3_ONE = """    for (long long q = a + tid; q < b; q += kExpandBlock) {
      const long long local = q - base;"""
_J3_LOOP = """    for (long long q = a + tid; q < b; q += kExpandBlock) {
      const long long local = q - base;
      // the last row of the tile whose offset is at most local (its count
      // is not 0, since the next row's offset is past local)
      int x = 0;
#pragma unroll
      for (int step = px_scan::kTile / 2; step > 0; step >>= 1) {
        if (soff[x + step] <= local) x += step;
      }
      const long long r = r0 + x;
      const int bi = rows[lo_p[r] + static_cast<int>(local - soff[x])];
      bidx[q] = bi;
      pidx[q] = r;
"""
_J3_ILP = """    for (long long qa = a + tid; qa < b; qa += kExpandPairs) {
      int x[8], bi[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long local = qa + k * kExpandBlock - base;
        int y = 0;
#pragma unroll
        for (int step = px_scan::kTile / 2; step > 0; step >>= 1) {
          if (soff[y + step] <= local) y += step;
        }
        x[k] = y;
        bi[k] = static_cast<int>(local - soff[y]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (qa + k * kExpandBlock < b) bi[k] += lo_p[r0 + x[k]];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (qa + k * kExpandBlock < b) bi[k] = rows[bi[k]];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long q = qa + k * kExpandBlock;
        if (q < b) {
          bidx[q] = bi[k];
          pidx[q] = r0 + x[k];
          const unsigned bit = 1u << (bi[k] & 31);
          if ((bits[bi[k] >> 5] & bit) == 0) atomicOr(bits + (bi[k] >> 5), bit);
        }
      }
    }
    for (long long q = b; q < b; q += kExpandBlock) {
      const long long local = q - base;"""
_J3_CHECK = "      if ((bits[bi >> 5] & bit) == 0) atomicOr(bits + (bi >> 5), bit);"
# J3 with owners: each matched probe row claims its code's run in the counts
# pass (an atomicOr returning the old bit of its lo), and only the claiming
# row's pairs set build_matched bits
_J3_COUNT = """__global__ void __launch_bounds__(kCountBlock) count_tiles(const int* __restrict__ cnt_p,
                                                           long long n,
                                                           long long* __restrict__ partial,
                                                           uint8_t* __restrict__ pm) {
  const long long base = static_cast<long long>(blockIdx.x) * px_scan::kTile;
  long long sum = 0;
#pragma unroll
  for (int k = 0; k < px_scan::kTile / (4 * kCountBlock); ++k) {
    const long long i = base + (static_cast<long long>(k) * kCountBlock + threadIdx.x) * 4;
    if (i + 4 <= n) {
      const int4 c = __ldcs(reinterpret_cast<const int4*>(cnt_p + i));
      sum += static_cast<long long>(c.x) + c.y + c.z + c.w;
      *reinterpret_cast<uchar4*>(pm + i) = make_uchar4(c.x > 0, c.y > 0, c.z > 0, c.w > 0);
    } else {
      for (long long j = i; j < n; ++j) {
        const int c = cnt_p[j];
        sum += c;
        pm[j] = c > 0;
      }
    }
  }"""
_J3_COUNT_OWNERS = """__global__ void __launch_bounds__(kCountBlock) count_tiles(
    const int* __restrict__ cnt_p, const int* __restrict__ lo_p, long long n,
    long long* __restrict__ partial, uint8_t* __restrict__ pm, unsigned* __restrict__ runs,
    uint8_t* __restrict__ owner) {
  const long long base = static_cast<long long>(blockIdx.x) * px_scan::kTile;
  long long sum = 0;
  auto claim = [runs](int c, int lo) -> uint8_t {
    if (c <= 0) return 0;
    const unsigned bit = 1u << (lo & 31);
    return (atomicOr(runs + (lo >> 5), bit) & bit) == 0;
  };
#pragma unroll
  for (int k = 0; k < px_scan::kTile / (4 * kCountBlock); ++k) {
    const long long i = base + (static_cast<long long>(k) * kCountBlock + threadIdx.x) * 4;
    if (i + 4 <= n) {
      const int4 c = __ldcs(reinterpret_cast<const int4*>(cnt_p + i));
      const int4 lo = __ldcs(reinterpret_cast<const int4*>(lo_p + i));
      sum += static_cast<long long>(c.x) + c.y + c.z + c.w;
      *reinterpret_cast<uchar4*>(pm + i) = make_uchar4(c.x > 0, c.y > 0, c.z > 0, c.w > 0);
      *reinterpret_cast<uchar4*>(owner + i) = make_uchar4(
          claim(c.x, lo.x), claim(c.y, lo.y), claim(c.z, lo.z), claim(c.w, lo.w));
    } else {
      for (long long j = i; j < n; ++j) {
        const int c = cnt_p[j];
        sum += c;
        pm[j] = c > 0;
        owner[j] = claim(c, lo_p[j]);
      }
    }
  }"""
_J3_OWNERS = [
    ("join.cu", _J3_COUNT, _J3_COUNT_OWNERS),
    ("join.cu", "    long long total, long long* __restrict__ bidx, long long* __restrict__ pidx,\n"
                "    unsigned* __restrict__ bits) {",
     "    long long total, const uint8_t* __restrict__ owner, long long* __restrict__ bidx,\n"
     "    long long* __restrict__ pidx, unsigned* __restrict__ bits) {"),
    ("join.cu", _J3_CHECK, "      if (owner[r]) atomicOr(bits + (bi >> 5), bit);"),
    ("join.cu", "                              long long* bidx, long long* pidx, uint8_t* bm, uint8_t* pm,\n"
                "                              void* stream) {",
     "                              long long* bidx, long long* pidx, uint8_t* bm, uint8_t* pm,\n"
     "                              void* stream) {\n"
     "  uint8_t* owner = reinterpret_cast<uint8_t*>(bits + 2 * ((nb + 31) / 32));\n"
     "  counted = 0;  // the owners are claimed in J3's own counts pass"),
    ("join.cu", "  cudaError_t e = cudaMemsetAsync(bits, 0, static_cast<size_t>(words) * sizeof(unsigned), s);",
     "  cudaError_t e =\n      cudaMemsetAsync(bits, 0, static_cast<size_t>(2 * words) * sizeof(unsigned), s);"),
    ("join.cu", "    count_tiles<<<static_cast<unsigned>(nt), kCountBlock, 0, s>>>(cnt_p, npr, partial, pm);",
     "    count_tiles<<<static_cast<unsigned>(nt), kCountBlock, 0, s>>>(cnt_p, lo_p, npr, partial, pm,\n"
     "                                                                 bits + words, owner);"),
    ("join.cu", "                                                                  partial, nt, total, bidx, pidx,\n"
                "                                                                  bits);",
     "                                                                  partial, nt, total, owner, bidx,\n"
     "                                                                  pidx, bits);"),
    ("ops/join_device.py", "    bits = torch.empty(max(1, -(-nb // 32)), dtype=torch.int32, device=dev)",
     "    bits = torch.empty(2 * -(-nb // 32) + -(-max(1, npr) // 4) + 4, dtype=torch.int32,\n"
     "                       device=dev)"),
    ("ops/join_device.py", "    if cnt_p.data_ptr() % 16:  # J3 reads the counts in 16-byte vectors\n"
                           "        cnt_p = cnt_p.clone()",
     "    if cnt_p.data_ptr() % 16:  # J3 reads the counts in 16-byte vectors\n"
     "        cnt_p = cnt_p.clone()\n"
     "    if lo_p.data_ptr() % 16:\n"
     "        lo_p = lo_p.clone()"),
]

# K1's f64 fold of a row (csrc/segment_reduce.cu), and the same by a
# returning integer min / max whose old value, when NaN, puts the op's NaN
# back (no load of the state word first)
_K1_RED = """  if (isnan(cur) || !(isnan(v) || (kMin ? v < cur : v > cur))) return;
  const long long b = isnan(v) ? (kMin ? kMinNaN64 : kMaxNaN64) : __double_as_longlong(v);
  long long* sp = reinterpret_cast<long long*>(p);
  unsigned long long* up = reinterpret_cast<unsigned long long*>(p);
  if (b >= 0) {
    if (kMin) atomicMin(sp, b); else atomicMax(sp, b);
  } else {
    if (kMin) atomicMax(up, static_cast<unsigned long long>(b));
    else atomicMin(up, static_cast<unsigned long long>(b));
  }
"""
_K1_RETURNING = """  const long long b = isnan(v) ? (kMin ? kMinNaN64 : kMaxNaN64) : __double_as_longlong(v);
  long long* sp = reinterpret_cast<long long*>(p);
  unsigned long long* up = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old;
  if (b >= 0) {
    old = static_cast<unsigned long long>(kMin ? atomicMin(sp, b) : atomicMax(sp, b));
  } else {
    old = kMin ? atomicMax(up, static_cast<unsigned long long>(b))
               : atomicMin(up, static_cast<unsigned long long>(b));
  }
  if (isnan(__longlong_as_double(static_cast<long long>(old)))) {
    atomicExch(up, static_cast<unsigned long long>(kMin ? kMinNaN64 : kMaxNaN64));
  }
"""
_K1_LOAD = ("struct PickF64 : PickF64Op<kMin> {\n  static constexpr bool kLoad = true;",
            "struct PickF64 : PickF64Op<kMin> {\n  static constexpr bool kLoad = false;")

# K4's tile offsets by a decoupled look-back in the first launch
# (csrc/compact.cu, ops/compact.py): a memset of the tiles' status words and
# a ticket, then each block takes the next tile from the ticket, so every
# tile before it belongs to a block that already runs or has ended and the
# look-back cannot wait on a block that has not started; a later launch of
# more than 16 columns reads the offsets the first one wrote
_K4_STATUS = """// A tile's status word: the flag in the top two bits, a count below.
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Warp 0 of tile `tile` (tile > 0): the kept rows of every tile before it,
// from the status words of the tiles before it, 32 at a time, back to the
// nearest one that holds its inclusive prefix.  Every lane returns the sum.
__device__ __forceinline__ long long look_back(const unsigned long long* status, long long tile) {
  const int lane = threadIdx.x & 31;
  long long excl = 0;
  for (long long end = tile - 1;; end -= 32) {
    const long long i = end - lane;
    unsigned long long st = kPrefix;  // before tile 0: a prefix of 0
    if (i >= 0) {
      do {
        st = load_status(status + i);
      } while ((st & ~kValue) == 0);
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, (st & ~kValue) == kPrefix);
    const int first = prefixes ? __ffs(prefixes) - 1 : 32;
    long long v = lane <= first ? static_cast<long long>(st & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (prefixes) return excl;
  }
}

"""
_K4_LOOK_BACK = [
    ("compact.cu", "// Gathered: the kept rows", _K4_STATUS + "// Gathered: the kept rows"),
    ("compact.cu",
     "                                                        long long n, Columns cols,\n"
     "                                                        const long long* __restrict__ offset) {",
     "                                                        long long n, Columns cols,\n"
     "                                                        long long* __restrict__ offset,\n"
     "                                                        unsigned long long* __restrict__ status,\n"
     "                                                        unsigned long long* __restrict__ ticket,\n"
     "                                                        long long ntiles,\n"
     "                                                        long long* __restrict__ count) {"),
    ("compact.cu", "  const long long tile = blockIdx.x;\n",
     "  __shared__ long long s_tile;\n"
     "  if (tid == 0) s_tile = status ? static_cast<long long>(atomicAdd(ticket, 1ull)) : blockIdx.x;\n"
     "  __syncthreads();\n"
     "  const long long tile = s_tile;\n"),
    ("compact.cu", "  if (tid == 0) s_off = offset[tile];\n",
     """  if (status == nullptr) {
    if (tid == 0) s_off = offset[tile];
  } else if (tid < 32) {
    if (tile == 0) {
      if (tid == 0) {
        store_status(status, kPrefix | static_cast<unsigned long long>(kept));
        s_off = 0;
      }
    } else {
      if (tid == 0) store_status(status + tile, kAggregate | static_cast<unsigned long long>(kept));
      const long long excl = look_back(status, tile);
      if (tid == 0) {
        store_status(status + tile, kPrefix | static_cast<unsigned long long>(excl + kept));
        s_off = excl;
      }
    }
    if (tid == 0) {
      offset[tile] = s_off;
      if (tile == ntiles - 1) *count = s_off + kept;
    }
  }
"""),
    ("compact.cu",
     "  tile_counts<<<static_cast<unsigned>(nt), kCountBlock, 0, s>>>(mask, n, offset);\n"
     "  px_scan::scan_partials<<<1, px_scan::kPartialBlock, 0, s>>>(offset, nt, count);\n"
     "  // (with no column the count is all there is to do)\n"
     "  for (int c0 = 0; c0 < ncols; c0 += kMaxCols) {",
     "  unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + nt);\n"
     "  const cudaError_t e = cudaMemsetAsync(status, 0, sizeof(long long) * (nt + 1), s);\n"
     "  if (e != cudaSuccess) return static_cast<int>(e);\n"
     "  for (int c0 = 0; c0 < ncols || c0 == 0; c0 += kMaxCols) {"),
    ("compact.cu",
     "    compact_tiles<<<static_cast<unsigned>(nt), kBlock, 0, s>>>(mask, n, cols, offset);",
     "    compact_tiles<<<static_cast<unsigned>(nt), kBlock, 0, s>>>(\n"
     "        mask, n, cols, offset, c0 == 0 ? status : nullptr, status + nt, nt, count);"),
    ("ops/compact.py",
     "    scratch = torch.empty(-(-n // TILE_ROWS), dtype=torch.int64, device=mask.device)",
     "    scratch = torch.empty(2 * -(-n // TILE_ROWS) + 1, dtype=torch.int64, device=mask.device)"),
]

# K1's global route loading b of a run's state words before folding those
# rows (csrc/segment_reduce.cu), where the checkout loads one word, folds its
# row, then loads the next
_K1_ONE_ROW = """#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!keep[r]) continue;
      Out cur = Out(0);
      if constexpr (Op::kLoad) cur = load_state(out + g[r]);
      Op::row(out + g[r], x[r], cur);
    }"""
_K1_BATCH = """#pragma unroll
    for (int r0 = 0; r0 < kRows; r0 += {b}) {{
      Out cur[{b}];
      if constexpr (Op::kLoad) {{
#pragma unroll
        for (int r = 0; r < {b}; ++r) {{
          cur[r] = keep[r0 + r] ? load_state(out + g[r0 + r]) : Out(0);
        }}
      }}
#pragma unroll
      for (int r = 0; r < {b}; ++r) {{
        if (keep[r0 + r]) Op::row(out + g[r0 + r], x[r0 + r], cur[r]);
      }}
    }}"""

# K3 as it was designed first: one block a group, one thread a bin, a
# Hillis-Steele scan in shared memory and one __syncthreads_count a
# quantile (csrc/loghist_quantile.cu), taking the checkout's parameters
_K3_BLOCK = """__global__ void block_quantile_kernel(const float* __restrict__ hist, int width,
                                      const Quantiles qs, int nq,
                                      const double* __restrict__ bin_values,
                                      double* __restrict__ out, int stride, int col0) {
  extern __shared__ float cum[];
  const int g = blockIdx.x;
  const int t = threadIdx.x;
  cum[t] = t < width ? hist[static_cast<long long>(g) * width + t] : 0.0f;
  __syncthreads();
  for (int off = 1; off < blockDim.x; off <<= 1) {
    const float add = t >= off ? cum[t - off] : 0.0f;
    __syncthreads();
    cum[t] += add;
    __syncthreads();
  }
  const float total = cum[width - 1];
  const float mine = cum[t];
  for (int j = 0; j < nq; ++j) {
    const float target = fminf(fmaxf(qs.q[j], 0.0f), 1.0f) * total;
    const int below = __syncthreads_count(t < width && mine < target);
    if (t == 0) {
      const int idx = below < width - 1 ? below : width - 1;
      out[static_cast<long long>(g) * stride + col0 + j] =
          total > 0.0f ? bin_values[idx] : CUDART_NAN;
    }
  }
}

"""
_K3_LAUNCH = """  if (width <= 17 * 32) return launch<17>(hist, groups, width, q, nq, bin_values, out, stride,
                                          col0, s);"""
_K3_LAUNCH_BLOCK = """  const int block = (width + 31) / 32 * 32;
  block_quantile_kernel<<<groups, block, block * sizeof(float), s>>>(hist, width, q, nq,
                                                                   bin_values, out, stride, col0);
  return static_cast<int>(cudaGetLastError());"""
# J2 not giving J3 its tiles: J3 runs its own counts pass and scan
# (ops/join_device.py; ab_finalize's join measures then take the unfused
# form, since join_probe has no `tiles` parameter)
_J2_UNFUSED = [
    ("ops/join_device.py", "               tiles: bool = False):\n    \"\"\"J2",
     "               _tiles: bool = False):\n    \"\"\"J2"),
    ("ops/join_device.py", "    if not codes.is_cuda:\n        return join_probe_plain(codes, cnt, first, tiles)",
     "    tiles = _tiles\n    if not codes.is_cuda:\n        return join_probe_plain(codes, cnt, first, tiles)"),
    ("ops/join_device.py", "    cnt_p, lo_p, total, tiles = join_probe(p, cnt, first, tiles=True)",
     "    (cnt_p, lo_p, total), tiles = join_probe(p, cnt, first), None"),
]
# J1's code table as two tables, cnt and first apart (in the slot table's
# 2K ints: the counts, then the firsts), so that a probe row gathers two
# sectors, where the checkout's interleaved slot gathers one
# (csrc/join.cu, ops/join_device.py)
_J2_TWO_TABLES = [
    ("join.cu", "    slots[base + j] = make_int2(nx - f, f);",
     "    reinterpret_cast<int*>(slots)[base + j] = nx - f;\n"
     "    reinterpret_cast<int*>(slots)[K + base + j] = f;"),
    ("join.cu", "      const int2 slot = hit ? __ldg(slots + c[r][e]) : make_int2(0, 0);\n"
                "      k[r][e] = slot.x;\n      lo[r][e] = slot.y;",
     "      k[r][e] = hit ? __ldg(reinterpret_cast<const int*>(slots) + c[r][e]) : 0;\n"
     "      lo[r][e] = hit ? __ldg(reinterpret_cast<const int*>(slots) + K + c[r][e]) : 0;"),
    ("ops/join_device.py", "    return slots[:, 0], slots[:, 1], rows",
     "    return slots.view(-1)[:K], slots.view(-1)[K:], rows"),
    ("ops/join_device.py", "    K = cnt.shape[0]\n    if (cnt.device != dev",
     "    return cnt.data_ptr()\n    K = cnt.shape[0]\n    if (cnt.device != dev"),
]

#: choice → ([(file under pixie_tpu_torch/csrc, or a path under
#: pixie_tpu_torch with a "/", text, its replacement)], measures)
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
    "x2_match": ([("repartition.cu", _X2_BALLOTS,
                   "    const unsigned peers = __match_any_sync(0xffffffffu, p);")],
                 "x2,x2_8,x2_phase"),
    "x2_no_overlap": ([("repartition.cu", "      cp_async_wait<1>();", "      cp_async_wait<0>();")],
                      "x2,x2_8,x2_phase"),
    "x2_gather": ([("repartition.cu",
                    "  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {\n    const int nv",
                    "  if (false) {\n    const int nv"),
                   ("repartition.cu", "  for (int b = done + threadIdx.x * col.width; b < bytes;",
                    "  for (int b = bytes; b < bytes;"),
                   ("repartition.cu", "    const unsigned char* buf = sbuf[c & 1];",
                    "    const unsigned char* buf = col.src + (row0 + lo) * col.width;")],
                  "x2,x2_8,x2_phase"),
    "x2_torch_scan": ([("ops/repartition.py", "    tile_first = torch.empty_like(tile_counts)",
                        "    tile_first = (torch.cumsum(tile_counts, 1) - tile_counts).contiguous()"),
                       ("repartition.cu", "  tile_scan<<<dim3(", "  if (false) tile_scan<<<dim3(")],
                      "x2,x2_8,x2_phase"),
    "x2_stage_only": ([("repartition.cu", "    if (d < send[q]) dst[d] = sbuf[sperm[j]];",
                        "    if (d < 0) dst[d] = sbuf[sperm[j]];")], "x2,x2_8"),
    "j3_ilp": ([("join.cu", _J3_ONE, _J3_ILP)], "j3,j3_phase,j3_heavy"),
    "j3_pairs4096": ([("join.cu", "constexpr int kExpandPairs = 2048; ",
                       "constexpr int kExpandPairs = 4096; ")], "j3,j3_phase,j3_heavy"),
    "j3_pairs8192": ([("join.cu", "constexpr int kExpandPairs = 2048; ",
                       "constexpr int kExpandPairs = 8192; ")], "j3,j3_phase,j3_heavy"),
    "j3_bounds3": ([("join.cu", "constexpr int kExpandPerSM = 2; ",
                     "constexpr int kExpandPerSM = 3; ")], "j3,j3_phase,j3_heavy"),
    "j3_every_pair": ([("join.cu", _J3_CHECK, "      atomicOr(bits + (bi >> 5), bit);")],
                      "j3,j3_phase,j3_heavy"),
    "j3_owners": (_J3_OWNERS, "j3,j3_phase,j3_heavy"),
    "j3_no_bits": ([("join.cu", _J3_CHECK, "      if (bi < 0) atomicOr(bits + (bi >> 5), bit);")],
                   "j3,j3_phase,j3_heavy"),
    "j3_no_gather": ([("join.cu", "      const int bi = rows[lo_p[r] + static_cast<int>(local - soff[x])];",
                       "      const int bi = (lo_p[r] + static_cast<int>(local - soff[x])) % nb32;"),
                      ("join.cu", "  const long long q1 = min(q0 + kExpandPairs, total);\n",
                       "  const long long q1 = min(q0 + kExpandPairs, total);\n"
                       "  const int nb32 = 1 << 20;\n")],
                     "j3,j3_phase,j3_heavy"),
    "j3_no_pairs": ([("join.cu", _J3_ONE, _J3_ONE.replace("q < b;", "q < a;"))],
                    "j3,j3_phase,j3_heavy"),
    "k1_cas": ([("segment_reduce.cu",
                 "  __device__ static void global_add(double* p, long long key) {\n"
                 "    red_pick_f64<kMin>(p, f64_of_key(key, kMin), __ldcg(p));\n  }\n"
                 "  __device__ static void row(double* p, double x, double cur) "
                 "{ red_pick_f64<kMin>(p, x, cur); }",
                 "  __device__ static void global_add(double* p, long long key) {\n"
                 "    atomic_pick_f64<kMin>(p, f64_of_key(key, kMin));\n  }\n"
                 "  __device__ static void row(double* p, double x, double) "
                 "{ atomic_pick_f64<kMin>(p, x); }"),
                ("segment_reduce.cu", *_K1_LOAD)],
               "k1_min_sorted,k1_max_sorted,k1_min_s1"),
    "k1_no_filter": ([("segment_reduce.cu",
                       "  if (isnan(cur) || !(isnan(v) || (kMin ? v < cur : v > cur))) return;\n"
                       "  const long long b", "  const long long b"),
                      ("segment_reduce.cu", *_K1_LOAD)],
                     "k1_min_sorted,k1_max_sorted,k1_min_s1"),
    "k1_returning": ([("segment_reduce.cu", _K1_RED, _K1_RETURNING),
                      ("segment_reduce.cu", *_K1_LOAD)],
                     "k1_min_sorted,k1_max_sorted,k1_min_s1"),
    **{f"k1_batch{b}": ([("segment_reduce.cu", _K1_ONE_ROW, _K1_BATCH.format(b=b))],
                        "k1_min_sorted,k1_max_sorted,k1_min_s1") for b in (2, 4, 8)},
    "k4_gather_only": ([("compact.cu", "constexpr int kDense = 8;",
                         "constexpr int kDense = 17;")], "k4,k4_half,k4_dense"),
    "k4_staged_only": ([("compact.cu", "constexpr int kDense = 8;",
                         "constexpr int kDense = 0;")], "k4,k4_half,k4_dense"),
    "k4_dense4": ([("compact.cu", "constexpr int kDense = 8;",
                    "constexpr int kDense = 4;")], "k4,k4_half,k4_dense"),
    "k4_look_back": (_K4_LOOK_BACK, "k4,k4_half,k4_dense"),
    "k3_block": ([("loghist_quantile.cu", "template <int ROWS>\nint launch(",
                   _K3_BLOCK + "template <int ROWS>\nint launch("),
                  ("loghist_quantile.cu", _K3_LAUNCH, _K3_LAUNCH_BLOCK)],
                 "k3,k3_s2,k3_dev,k3_s2_dev"),
    "j2_unfused": (_J2_UNFUSED, "j2,j2_phase,j3,j3_phase,j3_heavy,j2_j3,j2_j3_phase,j2_j3_heavy"),
    "j2_two_tables": (_J2_TWO_TABLES, "j1,j1_phase,j2,j2_phase,j2_j3_phase"),
    "j2_block256": ([("join.cu", "constexpr int kProbeBlock = 1024;",
                      "constexpr int kProbeBlock = 256;")], "j2,j2_phase"),
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
    # the built libraries come along: each is named by a digest of its
    # sources, so only the edited one builds again
    shutil.copytree(here / "pixie_tpu_torch", out / "pixie_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy2(here / "chip_smoke.py", out / "chip_smoke.py")
    for name, old, new in CHOICES[choice][0]:
        path = out / "pixie_tpu_torch" / ("" if "/" in name else "csrc") / name
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
