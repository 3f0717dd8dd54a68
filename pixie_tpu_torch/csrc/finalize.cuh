// The device finalize shared by F2 (merge + finalize) and F1 (fused single-
// feed partial + finalize), both in finalize.cu: a table of rows, each one
// piece of work over one state leaf, run by the blocks of a grid.
//
// A row is kRow int64 words, then n_states source pointers:
//   [0] flags: kind | op << 4 | dtype << 8 | vec << 16
//   [1] n: elements (merge, fill) or groups (quantile)
//   [2] dst: a device pointer into the output (or, for fill, the state)
//   [3] quantile: width | nq << 16; fill: the identity's bits
//   [4] quantile: a device pointer to nq f64 quantiles
//   [5] quantile: a device pointer to width f64 bin values
// The rows travel in the launch's parameter block (finalize.cu); the
// quantiles and bin values, the same on every call, in a device buffer the
// wrapper uploads once and caches (ops/finalize.py).
// Kinds:
//   merge    — M1's merge (merge.cuh) of the leaf over the n_states sources,
//              in state order, written at dst: the leaf's place in the packed
//              output, so the merge is also the pack;
//   quantile — a [G, width] float32 sketch leaf (merged over the sources in
//              state order as it is read) into its [G, nq] f64 quantiles at
//              dst, by K3's rank rule (csrc/loghist_quantile.cu);
//   fill     — n elements of 4 or 8 bytes (the dtype) set to the identity.
//
// The quantile of one group runs on one block of NT threads (256 in F2,
// F1's block width in F1): the merged row is staged in shared memory with
// coalesced loads, each thread sums a run of consecutive bins (width <=
// kMaxWidth, at most kMaxWidth / NT each), the block scans the runs' sums
// (warp shuffles, then the warps' totals), and each thread finds its bins'
// inclusive cumulative counts.  For each quantile q the rank index is
// #(cum < clip(q, 0, 1) * total), the count summed over the block, capped at
// width - 1; the value is the f64 bin value table's entry, NaN for a group
// with no rows.  The counts are integers held in float32: every partial sum
// below 2^24 is exact in any order, so the answer equals K3's Hillis-Steele
// scan and the reference's sequential f32 cumsum.
#pragma once

#include <math_constants.h>

#include "merge.cuh"

namespace px_fin {

constexpr int kThreads = 256;
constexpr int kMaxWidth = 1024;
// shared scratch of a quantile row on NT threads: the staged row, the
// warps' sums and the warps' counts
__host__ __device__ constexpr int scratch_floats(int nt) { return kMaxWidth + 2 * (nt / 32); }

enum Kind { kMergeRow = 0, kQuantileRow = 1, kFillRow = 2 };
constexpr int kRow = 6;

// Group g of the sketch leaf at srcs[0..n_states) → out[g * nq, g * nq + nq).
template <int NT>
__device__ __forceinline__ void quantile_group(const long long* srcs, int n_states, long long g,
                                               int width, int nq, const double* qs,
                                               const double* binv, double* out, float* sh) {
  constexpr int kWarps = NT / 32;
  constexpr int kMaxPer = kMaxWidth / NT;
  float* row = sh;
  float* wsum = sh + kMaxWidth;
  int* wcnt = reinterpret_cast<int*>(sh + kMaxWidth + kWarps);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long base = g * width;
  // the first kHoist sources' addresses read once a group into registers
  // (the sources live in the launch's parameter space), so every bin's
  // loads are in flight together; the adds run in state order
  constexpr int kHoist = 8;
  const float* src[kHoist];
#pragma unroll
  for (int k = 0; k < kHoist; ++k) {
    src[k] = k < n_states ? reinterpret_cast<const float*>(srcs[k]) + base : nullptr;
  }
  for (int b = t; b < width; b += NT) {
    float acc = src[0][b];
#pragma unroll
    for (int k = 1; k < kHoist; ++k) {
      if (k < n_states) acc = acc + src[k][b];
    }
    for (int s = kHoist; s < n_states; ++s) {
      acc = acc + reinterpret_cast<const float*>(srcs[s])[base + b];
    }
    row[b] = acc;
  }
  __syncthreads();
  const int per = (width + NT - 1) / NT;
  const int b0 = t * per;
  float cum[kMaxPer];
  float local = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    if (i < per && b0 + i < width) local += row[b0 + i];
    cum[i] = local;
  }
  float incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  float before = incl - local;
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += wsum[w];
    total += wsum[w];
  }
  for (int j = 0; j < nq; ++j) {
    const float q = fminf(fmaxf(static_cast<float>(qs[j]), 0.0f), 1.0f);
    const float target = q * total;
    int c = 0;
#pragma unroll
    for (int i = 0; i < kMaxPer; ++i) {
      if (i < per && b0 + i < width && before + cum[i] < target) ++c;
    }
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) wcnt[warp] = c;
    __syncthreads();
    if (t == 0) {
      int below = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) below += wcnt[w];
      const int idx = below < width - 1 ? below : width - 1;
      out[g * nq + j] = total > 0.0f ? binv[idx] : CUDART_NAN;
    }
    __syncthreads();
  }
}

// Row `row` of the table (rows of kRow + n_states words), as block bx of the
// nbx blocks of NT threads that share it.  sh: scratch_floats(NT) floats of
// shared memory (a quantile row's only).
template <int NT>
__device__ __forceinline__ void run_row(const long long* table, int row, int n_states,
                                        long long bx, long long nbx, float* sh) {
  const long long* d = table + static_cast<long long>(row) * (kRow + n_states);
  const int flags = static_cast<int>(d[0]);
  const int kind = flags & 0xf;
  const int dtype = (flags >> 8) & 0xff;
  const long long n = d[1];
  const long long tid = bx * NT + threadIdx.x;
  const long long stride = nbx * NT;
  if (kind == kMergeRow) {
    px_merge::merge_any(dtype, (flags >> 4) & 0xf, reinterpret_cast<void*>(d[2]), d + kRow, n,
                        (flags >> 16) & 1, n_states, tid, stride);
  } else if (kind == kFillRow) {
    if (dtype == px_merge::kF64 || dtype == px_merge::kI64) {
      long long* p = reinterpret_cast<long long*>(d[2]);
      for (long long j = tid; j < n; j += stride) p[j] = d[3];
    } else {
      int* p = reinterpret_cast<int*>(d[2]);
      const int v = static_cast<int>(d[3]);
      for (long long j = tid; j < n; j += stride) p[j] = v;
    }
  } else {
    const int width = static_cast<int>(d[3] & 0xffff);
    const int nq = static_cast<int>((d[3] >> 16) & 0xffff);
    const double* qs = reinterpret_cast<const double*>(d[4]);
    const double* binv = reinterpret_cast<const double*>(d[5]);
    double* out = reinterpret_cast<double*>(d[2]);
    for (long long g = bx; g < n; g += nbx) {
      quantile_group<NT>(d + kRow, n_states, g, width, nq, qs, binv, out, sh);
    }
  }
}

}  // namespace px_fin
