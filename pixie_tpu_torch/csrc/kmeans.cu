// KM1-KM3: the k-means kernels (nearest-center assignment, one Lloyd
// iteration's weighted sums, one k-means++ seeding step).
//
// Replaces: pixie_tpu/ml/kmeans.py _sq_dists (:21, distances as one x @ c.T
// MXU matmul) with the argmin / min around it (:66, :73, :112, :119, and
// ml/coreset.py :35), the _lloyd step (:61-74: assign, then segment_sum of w
// and x * w per center) and the _plusplus_init step (:30-58: distances to the
// chosen centers, the min over them, times w).
//
// Every distance is the reference's expansion |x|^2 - 2 x.c + |c|^2, clamped
// at 0 (NaN passes through, as jnp.maximum lets it), in float32 with FMAs
// summed over the dimensions in order.  Ties go to the lowest center index,
// as argmin does.
//
// KM1 px_kmeans_assign: ids [n] int64 and the min squared distance [n] f32.
//   Bound on the H100: operations.  2 n k d float32 operations; at n = 2^20,
//   d = 64, k = 64 that is 8.6 GFLOP / 67 TFLOP/s = 0.13 ms, against 0.27 GB
//   of x at 3.35 TB/s = 0.08 ms.
//   Design: one thread per point, 256-point tiles strided over the grid.  The
//   centers reach shared memory in tiles of KT centers x 64 dimensions (with
//   their squared norms, computed once per call by a small first kernel);
//   each thread keeps KT dot products in registers, reads its row of x 16
//   bytes at a time where the rows allow it, and reads each center's four
//   values with one broadcast load.  More than KT centers, or more than 64
//   dimensions, loop over tiles.
// KM2 px_kmeans_lloyd: wsum [k] and xsum [k, d] of one Lloyd iteration.
//   Bound: as KM1 (the assignment), plus n (d + 1) additions.
//   Design: each block assigns a tile as KM1 does, then adds w and w * x of
//   each of the tile's points, in point order, into its own [k, d + 1]
//   float64 partial sums in shared memory (thread j owns column j: no
//   atomics).  The partials go to a [blocks, k, d + 1] buffer that a second
//   kernel sums over the blocks in block order.  No float atomics anywhere:
//   a fit gives the same bits run to run on one card.  Where [k, d + 1]
//   doubles do not fit in shared memory, the launch repeats over ranges of
//   centers.
// KM3 px_kmeans_seed_step: one k-means++ step.  mind = min(mind, d(x, c)) for
//   the center chosen last, and p = mind * w with non-finite values set to 0.
//   The reference recomputes all k distances each step and masks the unset
//   slots; the running min is the same minimum over the same distances in
//   O(n d) a step.
//   Bound: bytes.  x, w and mind read once, mind and p written once: at
//   n = 2^20, d = 64, 0.28 GB, 0.08 ms.
//   Design: one thread per point, the center read through the read-only
//   cache (every thread of a warp reads the same address).

#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kBlock = 256;
// dimensions per shared-memory tile of centers (a multiple of 4)
constexpr int kDT = 64;

__device__ __forceinline__ float clamp_dist(float v) {
  // max(v, 0) that lets NaN through, as jnp.maximum does
  return v < 0.f ? 0.f : v;
}

__device__ __forceinline__ bool better(float v, float best) {
  // argmin order: the first NaN wins, else strictly smaller
  return isnan(v) ? !isnan(best) : v < best;
}

template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int j, int dc) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(row + j));
  float4 v;
  v.x = row[j];
  v.y = j + 1 < dc ? row[j + 1] : 0.f;
  v.z = j + 2 < dc ? row[j + 2] : 0.f;
  v.w = j + 3 < dc ? row[j + 3] : 0.f;
  return v;
}

__global__ void center_norms(const float* __restrict__ c, int k, int d,
                             float* __restrict__ c2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const float* r = c + static_cast<long long>(i) * d;
  float s = 0.f;
  for (int j = 0; j < d; ++j) s = fmaf(r[j], r[j], s);
  c2[i] = s;
}

// Nearest center of point p (when `live`) among the k centers.  Every thread
// of the block calls it, live or not: it synchronizes the block around each
// tile of centers it stages in `cs` ([KT][kDT] floats).
template <int KT, bool kVec>
__device__ __forceinline__ void nearest(const float* __restrict__ x, long long p, bool live,
                                        int d, const float* __restrict__ c,
                                        const float* __restrict__ c2, int k,
                                        float* __restrict__ cs, int& best_i, float& best_d) {
  const float* row = x + p * d;
  float x2 = 0.f;
  best_i = 0;
  best_d = CUDART_INF_F;
  for (int k0 = 0; k0 < k; k0 += KT) {
    const int kc = min(KT, k - k0);
    float acc[KT];
#pragma unroll
    for (int t = 0; t < KT; ++t) acc[t] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kDT) {
      const int dc = min(kDT, d - d0);
      __syncthreads();  // the previous tile is consumed
      for (int i = threadIdx.x; i < KT * kDT; i += blockDim.x) {
        const int r = i / kDT, j = i % kDT;
        cs[i] = (r < kc && j < dc) ? c[static_cast<long long>(k0 + r) * d + d0 + j] : 0.f;
      }
      __syncthreads();
      if (live) {
        for (int j = 0; j < dc; j += 4) {
          const float4 xv = load4<kVec>(row + d0, j, dc);
          if (k0 == 0) {
            x2 = fmaf(xv.x, xv.x, x2);
            x2 = fmaf(xv.y, xv.y, x2);
            x2 = fmaf(xv.z, xv.z, x2);
            x2 = fmaf(xv.w, xv.w, x2);
          }
#pragma unroll
          for (int t = 0; t < KT; ++t) {
            const float4 cv = *reinterpret_cast<const float4*>(cs + t * kDT + j);
            acc[t] = fmaf(xv.x, cv.x, acc[t]);
            acc[t] = fmaf(xv.y, cv.y, acc[t]);
            acc[t] = fmaf(xv.z, cv.z, acc[t]);
            acc[t] = fmaf(xv.w, cv.w, acc[t]);
          }
        }
      }
    }
    if (live) {
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        if (t < kc) {
          const float dd = clamp_dist((x2 - 2.f * acc[t]) + c2[k0 + t]);
          if (better(dd, best_d)) {
            best_d = dd;
            best_i = k0 + t;
          }
        }
      }
    }
  }
}

template <int KT, bool kVec>
__global__ void __launch_bounds__(kBlock) assign_kernel(
    const float* __restrict__ x, long long n, int d, const float* __restrict__ c,
    const float* __restrict__ c2, int k, long long* __restrict__ ids,
    float* __restrict__ mind) {
  __shared__ __align__(16) float cs[KT * kDT];
  const long long tiles = (n + kBlock - 1) / kBlock;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p = tile * kBlock + threadIdx.x;
    const bool live = p < n;
    int bi;
    float bd;
    nearest<KT, kVec>(x, p, live, d, c, c2, k, cs, bi, bd);
    if (live) {
      ids[p] = bi;
      mind[p] = bd;
    }
  }
}

// Shared memory of a lloyd_partials block: the center tile, the tile's ids
// and weights, and `rows` x (d + 1) float64 partial sums.
template <int KT>
size_t lloyd_smem(int d, int rows) {
  return sizeof(float) * KT * kDT + (sizeof(int) + sizeof(float)) * kBlock +
         sizeof(double) * static_cast<size_t>(rows) * (d + 1);
}

template <int KT, bool kVec>
__global__ void __launch_bounds__(kBlock) lloyd_partials(
    const float* __restrict__ x, const float* __restrict__ w, long long n, int d,
    const float* __restrict__ c, const float* __restrict__ c2, int k, int c_lo, int rows,
    double* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cs = reinterpret_cast<float*>(smem_raw);
  int* tile_ids = reinterpret_cast<int*>(cs + KT * kDT);
  float* tile_w = reinterpret_cast<float*>(tile_ids + kBlock);
  double* acc = reinterpret_cast<double*>(
      smem_raw + ((sizeof(float) * KT * kDT + (sizeof(int) + sizeof(float)) * kBlock + 15) &
                  ~static_cast<size_t>(15)));
  const int width = d + 1;
  const int cells = rows * width;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.0;
  const long long tiles = (n + kBlock - 1) / kBlock;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p = tile * kBlock + threadIdx.x;
    const bool live = p < n;
    int bi;
    float bd;
    nearest<KT, kVec>(x, p, live, d, c, c2, k, cs, bi, bd);
    tile_ids[threadIdx.x] = live ? bi - c_lo : -1;
    tile_w[threadIdx.x] = live ? w[p] : 0.f;
    __syncthreads();
    // column j (j == d: the weight) of every point of the tile, in point
    // order; a column belongs to one thread, so no two threads add to one cell
    const long long base = tile * kBlock;
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
      for (int q = 0; q < kBlock; ++q) {
        const int r = tile_ids[q];
        if (r < 0 || r >= rows) continue;
        const float wq = tile_w[q];
        // the float32 product x * w, rounded as the reference rounds it
        // (no FMA contraction into the float64 add)
        const float v = j == d ? wq : __fmul_rn(x[(base + q) * d + j], wq);
        acc[r * width + j] += static_cast<double>(v);
      }
    }
    // (the next nearest() synchronizes before anyone rewrites the tile)
  }
  __syncthreads();
  double* out = partials + static_cast<long long>(blockIdx.x) * cells;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) out[i] = acc[i];
}

__global__ void lloyd_reduce(const double* __restrict__ partials, int blocks, int d,
                             int c_lo, int rows, float* __restrict__ wsum,
                             float* __restrict__ xsum) {
  const int width = d + 1;
  const int cells = rows * width;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cells) return;
  double s = 0.0;
  for (int b = 0; b < blocks; ++b) s += partials[static_cast<long long>(b) * cells + e];
  const int r = e / width, j = e % width;
  if (j == d) {
    wsum[c_lo + r] = static_cast<float>(s);
  } else {
    xsum[static_cast<long long>(c_lo + r) * d + j] = static_cast<float>(s);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kBlock) seed_step_kernel(
    const float* __restrict__ x, const float* __restrict__ w, long long n, int d,
    const float* __restrict__ c, float* __restrict__ mind, float* __restrict__ p) {
  float c2 = 0.f;
  for (int j = 0; j < d; ++j) c2 = fmaf(__ldg(c + j), __ldg(c + j), c2);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float* row = x + i * d;
    float x2 = 0.f, dot = 0.f;
    for (int j = 0; j < d; j += 4) {
      const float4 xv = load4<kVec>(row, j, d);
      float4 cv;
      cv.x = __ldg(c + j);
      cv.y = j + 1 < d ? __ldg(c + j + 1) : 0.f;
      cv.z = j + 2 < d ? __ldg(c + j + 2) : 0.f;
      cv.w = j + 3 < d ? __ldg(c + j + 3) : 0.f;
      x2 = fmaf(xv.x, xv.x, x2);
      x2 = fmaf(xv.y, xv.y, x2);
      x2 = fmaf(xv.z, xv.z, x2);
      x2 = fmaf(xv.w, xv.w, x2);
      dot = fmaf(xv.x, cv.x, dot);
      dot = fmaf(xv.y, cv.y, dot);
      dot = fmaf(xv.z, cv.z, dot);
      dot = fmaf(xv.w, cv.w, dot);
    }
    const float dd = clamp_dist((x2 - 2.f * dot) + c2);
    float m = mind[i];
    // jnp.min over the chosen centers: NaN propagates
    if (!isnan(m) && (isnan(dd) || dd < m)) m = dd;
    mind[i] = m;
    const float v = m * w[i];
    p[i] = isfinite(v) ? v : 0.f;
  }
}

bool rows_vectorizable(const float* x, int d) {
  return d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

template <int KT>
int launch_assign(const float* x, long long n, int d, const float* c, const float* c2, int k,
                  long long* ids, float* mind, bool vec, cudaStream_t stream) {
  const long long tiles = (n + kBlock - 1) / kBlock;
  if (vec) {
    const long long grid = px_grid(assign_kernel<KT, true>, tiles * kBlock, kBlock, 0);
    assign_kernel<KT, true><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
        x, n, d, c, c2, k, ids, mind);
  } else {
    const long long grid = px_grid(assign_kernel<KT, false>, tiles * kBlock, kBlock, 0);
    assign_kernel<KT, false><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
        x, n, d, c, c2, k, ids, mind);
  }
  return static_cast<int>(cudaGetLastError());
}

// Centers per shared-memory tile for k centers.
int tile_centers(int k) { return k <= 8 ? 8 : (k <= 32 ? 32 : 64); }

// Blocks of a lloyd_partials launch: a fixed function of n and the card, so
// the block order of the sums, and with it the result, is the same every run.
long long lloyd_grid(long long n) {
  const long long tiles = (n + kBlock - 1) / kBlock;
  const long long cap = 2LL * px_sm_count();
  const long long g = tiles < cap ? tiles : cap;
  return g < 1 ? 1 : g;
}

// Centers whose partial sums one launch holds in shared memory.
template <int KT>
int lloyd_rows(int d, int k) {
  const size_t fixed = lloyd_smem<KT>(d, 0) + 16;
  const size_t budget = static_cast<size_t>(px_smem_optin());
  if (budget <= fixed) return 0;
  const long long rows = static_cast<long long>((budget - fixed) / (sizeof(double) * (d + 1)));
  return static_cast<int>(rows < k ? rows : k);
}

template <int KT>
int launch_lloyd(const float* x, const float* w, long long n, int d, const float* c,
                 const float* c2, int k, float* wsum, float* xsum, double* partials,
                 bool vec, cudaStream_t stream) {
  const int rows = lloyd_rows<KT>(d, k);
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = lloyd_grid(n);
  for (int c_lo = 0; c_lo < k; c_lo += rows) {
    const int r = rows < k - c_lo ? rows : k - c_lo;
    const size_t smem = lloyd_smem<KT>(d, r) + 16;
    if (vec) {
      cudaFuncSetAttribute(lloyd_partials<KT, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      lloyd_partials<KT, true><<<static_cast<unsigned>(grid), kBlock, smem, stream>>>(
          x, w, n, d, c, c2, k, c_lo, r, partials);
    } else {
      cudaFuncSetAttribute(lloyd_partials<KT, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      lloyd_partials<KT, false><<<static_cast<unsigned>(grid), kBlock, smem, stream>>>(
          x, w, n, d, c, c2, k, c_lo, r, partials);
    }
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const int cells = r * (d + 1);
    lloyd_reduce<<<(cells + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
        partials, static_cast<int>(grid), d, c_lo, r, wsum, xsum);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

int launch_norms(const float* c, int k, int d, float* c2, cudaStream_t stream) {
  center_norms<<<(k + kBlock - 1) / kBlock, kBlock, 0, stream>>>(c, k, d, c2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// KM1.  c2: k floats of scratch for the centers' squared norms.
extern "C" int px_kmeans_assign(const float* x, long long n, int d, const float* c, int k,
                                float* c2, long long* ids, float* mind, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (d <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_norms(c, k, d, c2, stream);
  if (err != 0) return err;
  const bool vec = rows_vectorizable(x, d);
  switch (tile_centers(k)) {
    case 8: return launch_assign<8>(x, n, d, c, c2, k, ids, mind, vec, stream);
    case 32: return launch_assign<32>(x, n, d, c, c2, k, ids, mind, vec, stream);
    default: return launch_assign<64>(x, n, d, c, c2, k, ids, mind, vec, stream);
  }
}

// KM2's scratch: writes the float64 elements of the partial-sum buffer that
// px_kmeans_lloyd needs for n points, d dimensions and k centers (0 if its
// shared memory cannot hold even one center's sums).
extern "C" int px_kmeans_lloyd_scratch(long long n, int d, int k, long long* elems) {
  int rows = 0;
  switch (tile_centers(k)) {
    case 8: rows = lloyd_rows<8>(d, k); break;
    case 32: rows = lloyd_rows<32>(d, k); break;
    default: rows = lloyd_rows<64>(d, k); break;
  }
  *elems = rows > 0 ? lloyd_grid(n) * rows * static_cast<long long>(d + 1) : 0;
  return 0;
}

// KM2.  wsum [k] and xsum [k, d] are written (not added to); partials is
// px_kmeans_lloyd_scratch's buffer; c2 as for KM1.
extern "C" int px_kmeans_lloyd(const float* x, const float* w, long long n, int d,
                               const float* c, int k, float* c2, float* wsum, float* xsum,
                               double* partials, cudaStream_t stream) {
  if (d <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int err = launch_norms(c, k, d, c2, stream);
  if (err != 0) return err;
  const bool vec = rows_vectorizable(x, d);
  switch (tile_centers(k)) {
    case 8: return launch_lloyd<8>(x, w, n, d, c, c2, k, wsum, xsum, partials, vec, stream);
    case 32: return launch_lloyd<32>(x, w, n, d, c, c2, k, wsum, xsum, partials, vec, stream);
    default: return launch_lloyd<64>(x, w, n, d, c, c2, k, wsum, xsum, partials, vec, stream);
  }
}

// KM3.  c: the center chosen last ([d]); mind [n] is folded in place.
extern "C" int px_kmeans_seed_step(const float* x, const float* w, long long n, int d,
                                   const float* c, float* mind, float* p,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows_vectorizable(x, d)) {
    const long long grid = px_grid(seed_step_kernel<true>, n, kBlock, 0);
    seed_step_kernel<true><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
        x, w, n, d, c, mind, p);
  } else {
    const long long grid = px_grid(seed_step_kernel<false>, n, kBlock, 0);
    seed_step_kernel<false><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
        x, w, n, d, c, mind, p);
  }
  return static_cast<int>(cudaGetLastError());
}
