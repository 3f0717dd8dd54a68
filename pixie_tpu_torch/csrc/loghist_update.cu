// K2: per-group log-bucketed histogram update (the quantile sketch), with the
// bin index computed in the same pass as the count.
//
// Replaces: pixie_tpu/ops/sketch.py LogHistogram.bin_index + update (its three
// forms _update_gemm, _update_sorted and _update_segment).  The TPU form is a
// limb-factored one-hot GEMM; on Hopper the natural form is a histogram
// privatized in shared memory.
//
// Bound on the H100: bytes.  Each row is read once: gid 4 B + mask 1 B + value
// 8 B, 13 B/row, so a 16M-row feed needs at least 218 MB / 3.35 TB/s = 65 us;
// the arithmetic per row is one logf, one divide and one shared atomic.
//
// Design: 1024-thread blocks walk the rows with a grid stride, each thread
// two runs of 4 rows a step (a run: an int4 of group ids, a 32-bit word of
// mask bytes, two double2 of values; all loads of a step issued before its
// first atomic).  The regime follows the state's bytes, G x W x 4
// (px_loghist_regime, mirrored by ops/sketch.py update_regime):
// - shared: the histogram fits what one block may opt in to (227 KB: G <=
//   113 at W = 514; config #1's G = 64).  One block a SM counts each kept
//   row into its int32 [G, W] histogram in shared memory and flushes its
//   nonzero cells once, one float32 add each, below 2^24 as in the
//   reference.  A warp adding its rows of one cell together first
//   (`__match_any_sync`) ran 2x slower here: a warp's cells rarely
//   coincide.
// - global: past that, every kept row adds 1.0f into the state with a
//   global atomic.  At config #2's 1,024 groups a thread-block cluster of
//   16 blocks holding the histogram in distributed shared memory (each
//   row's count a DSMEM atomic to its owner) ran slower than these atomics
//   into the L2-resident state (ab_finalize.py against them, PERF.md row
//   3b), so no cluster regime is kept.

// The bin is px_bin (loghist.cuh, shared with G1 and F1), which follows
// sketch.py:103-106 operation by operation; the caller gives NaN's bin.

#include "common.cuh"
#include "loghist.cuh"

namespace {

constexpr int kBlock = 1024;

struct Sketch {
  double min_d;
  float log_gamma;
  float min_f;
  int width;
  int nan_bin;
};

// Calls cell(keep, g, bin) for every row of this thread's share: keep is
// mask set and gid in [0, groups), bin the row's bin when kept.  With
// 16-byte-aligned ids and values and 4-byte-aligned mask bytes a thread
// takes two runs of 4 rows a step, a grid stride apart so that each load of
// a warp is contiguous; the rows past the last whole run go one at a time.
// Every lane of a warp makes the same calls (rows past the end are not
// kept), so a cell may use the warp's collectives.
template <class Cell>
__device__ __forceinline__ void for_rows(const int* __restrict__ gid,
                                         const uint8_t* __restrict__ mask,
                                         const double* __restrict__ v, long long n, int groups,
                                         const Sketch& sk, Cell cell) {
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = static_cast<int>(threadIdx.x & 31u);
  auto bin = [&](double x) {
    return px_bin(x, sk.log_gamma, sk.min_f, sk.min_d, sk.width, sk.nan_bin);
  };
  long long done = 0;
  const bool wide = ((reinterpret_cast<uintptr_t>(gid) | reinterpret_cast<uintptr_t>(v)) & 15) ==
                        0 &&
                    (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  if (wide) {
    const long long runs = n / 4;
    // q - lane: the warp's first run, so the trip count is the warp's
    for (long long q = tid; q - lane < runs; q += 2 * stride) {
      int g[8];
      unsigned m[2];
      double x[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long run = q + h * stride;
        if (run < runs) {
          const int4 g4 = __ldg(reinterpret_cast<const int4*>(gid) + run);
          m[h] = __ldg(reinterpret_cast<const unsigned*>(mask) + run);
          const double2 a = __ldg(reinterpret_cast<const double2*>(v) + 2 * run);
          const double2 b = __ldg(reinterpret_cast<const double2*>(v) + 2 * run + 1);
          g[4 * h] = g4.x, g[4 * h + 1] = g4.y, g[4 * h + 2] = g4.z, g[4 * h + 3] = g4.w;
          x[4 * h] = a.x, x[4 * h + 1] = a.y, x[4 * h + 2] = b.x, x[4 * h + 3] = b.y;
        } else {
          m[h] = 0u;
#pragma unroll
          for (int k = 4 * h; k < 4 * h + 4; ++k) g[k] = -1, x[k] = 0.0;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const bool keep = ((m[k / 4] >> (8 * (k % 4))) & 0xffu) != 0 &&
                          static_cast<unsigned>(g[k]) < static_cast<unsigned>(groups);
        cell(keep, g[k], keep ? bin(x[k]) : 0);
      }
    }
    done = runs * 4;
  }
  for (long long i = done + tid; i - lane < n; i += stride) {
    const bool in = i < n;
    const int g = in ? gid[i] : -1;
    const bool keep = in && mask[i] && static_cast<unsigned>(g) < static_cast<unsigned>(groups);
    cell(keep, g, keep ? bin(v[i]) : 0);
  }
}

// The shared regime: the block's int32 [groups, width] counts in shared
// memory, flushed once into the float32 state.
__global__ void __launch_bounds__(kBlock, 1)
    hist_shared(const int* __restrict__ gid, const uint8_t* __restrict__ mask,
                const double* __restrict__ v, long long n, float* __restrict__ hist, int groups,
                Sketch sk) {
  extern __shared__ __align__(16) unsigned int counts[];
  const int width = sk.width;
  const int cells = groups * width;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) counts[i] = 0u;
  __syncthreads();
  for_rows(gid, mask, v, n, groups, sk, [&](bool keep, int g, int bin) {
    if (keep) atomicAdd(counts + g * width + bin, 1u);
  });
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const unsigned int k = counts[c];
    if (k) atomicAdd(&hist[c], static_cast<float>(k));
  }
}

__global__ void __launch_bounds__(kBlock) hist_global(
    const int* __restrict__ gid, const uint8_t* __restrict__ mask,
    const double* __restrict__ v, long long n, float* __restrict__ hist, int groups, Sketch sk) {
  for_rows(gid, mask, v, n, groups, sk, [&](bool keep, int g, int bin) {
    if (keep) atomicAdd(&hist[static_cast<long long>(g) * sk.width + bin], 1.0f);
  });
}

}  // namespace

// The blocks that hold a [groups, width] sketch's counts: 1 (one block's
// shared memory) or 0 (none: global atomics), on the current device
// (ops/sketch.py update_regime mirrors it).
extern "C" int px_loghist_regime(int groups, int width) {
  return static_cast<size_t>(groups) * width * sizeof(unsigned int) <=
                 static_cast<size_t>(px_smem_optin())
             ? 1
             : 0;
}

// hist is the [groups, width] float32 state, updated in place.  All pointers
// are device pointers; nan_bin: the bin of a NaN value (loghist.cuh).
// Returns a cudaError_t (0 = launched).
extern "C" int px_loghist_update(const int* gid, const uint8_t* mask,
                                 const double* values, long long n, float* hist,
                                 int groups, int width, float log_gamma,
                                 float min_value_f, double min_value, int nan_bin,
                                 void* stream) {
  if (n <= 0 || groups <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Sketch sk{min_value, log_gamma, min_value_f, width, nan_bin};
  if (px_loghist_regime(groups, width) == 1) {
    const size_t bytes = static_cast<size_t>(groups) * width * sizeof(unsigned int);
    if (bytes > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          hist_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    // one block a SM: each SM flushes its histogram once
    const long long want = (n + 8LL * kBlock - 1) / (8LL * kBlock);
    const long long sms = px_sm_count();
    const unsigned grid = static_cast<unsigned>(want < sms ? (want < 1 ? 1 : want) : sms);
    hist_shared<<<grid, kBlock, bytes, s>>>(gid, mask, values, n, hist, groups, sk);
  } else {
    const long long grid = px_grid(hist_global, (n + 7) / 8, kBlock, 0);
    hist_global<<<static_cast<unsigned>(grid), kBlock, 0, s>>>(gid, mask, values, n, hist,
                                                              groups, sk);
  }
  return static_cast<int>(cudaGetLastError());
}
