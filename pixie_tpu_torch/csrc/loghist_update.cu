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
// Design: grid-stride over rows; each block counts into a private int32
// [G, W] histogram in dynamic shared memory while it fits in what a block may
// opt in to (227 KB: G <= 113 at W = 514; the bench query has G = 64), then
// adds every non-zero count into the float32 state with one atomicAdd.  The
// counts are exact integers in float32 below 2^24 per cell, as in the
// reference.  Above that size, rows add 1.0f straight into the state with
// global atomics.
//
// The bin follows sketch.py:103-106 operation by operation: logf of
// max(float(v), float(min_value)), divided by the float constant
// (float)log(gamma), ceilf, +1; the zero-bin test v <= min_value in the value's
// own double; a clamp to [0, W-1].  The reference converts the float ceiling
// to int32 the way XLA does (NaN -> 0, +inf -> INT32_MAX, whose +1 wraps
// negative and clamps to bin 0); px_bin reproduces those edge results
// explicitly.  Built without --use_fast_math so logf stays the accurate logf.

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;

__device__ __forceinline__ int px_bin(double v, float log_gamma, float min_f,
                                      double min_d, int width) {
  if (isnan(v)) return 1;  // reference: NaN ceiling converts to 0, then +1
  if (v <= min_d) return 0;
  const float x = fmaxf(static_cast<float>(v), min_f);
  const float c = ceilf(logf(x) / log_gamma);
  if (!(c < 2147483648.0f)) return 0;  // INT32_MAX + 1 wraps negative -> 0
  const int idx = c < -1.0f ? 0 : static_cast<int>(c) + 1;
  return idx < width - 1 ? idx : width - 1;
}

__global__ void __launch_bounds__(kBlock) hist_shared(
    const int* __restrict__ gid, const uint8_t* __restrict__ mask,
    const double* __restrict__ v, long long n, float* __restrict__ hist,
    int groups, int width, float log_gamma, float min_f, double min_d) {
  extern __shared__ __align__(16) unsigned int counts[];
  const int cells = groups * width;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) counts[i] = 0u;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int g = gid[i];
    if (mask[i] && static_cast<unsigned>(g) < static_cast<unsigned>(groups)) {
      atomicAdd(&counts[g * width + px_bin(v[i], log_gamma, min_f, min_d, width)], 1u);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const unsigned int k = counts[c];
    if (k) atomicAdd(&hist[c], static_cast<float>(k));
  }
}

__global__ void __launch_bounds__(kBlock) hist_global(
    const int* __restrict__ gid, const uint8_t* __restrict__ mask,
    const double* __restrict__ v, long long n, float* __restrict__ hist,
    int groups, int width, float log_gamma, float min_f, double min_d) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int g = gid[i];
    if (mask[i] && static_cast<unsigned>(g) < static_cast<unsigned>(groups)) {
      const long long cell =
          static_cast<long long>(g) * width + px_bin(v[i], log_gamma, min_f, min_d, width);
      atomicAdd(&hist[cell], 1.0f);
    }
  }
}

}  // namespace

// hist is the [groups, width] float32 state, updated in place.  All pointers
// are device pointers.  Returns a cudaError_t (0 = launched).
extern "C" int px_loghist_update(const int* gid, const uint8_t* mask,
                                 const double* values, long long n, float* hist,
                                 int groups, int width, float log_gamma,
                                 float min_value_f, double min_value,
                                 void* stream) {
  if (n <= 0 || groups <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(groups) * width * sizeof(unsigned int);
  if (bytes <= static_cast<size_t>(px_smem_optin())) {
    if (bytes > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          hist_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    long long grid = px_grid(hist_shared, n, kBlock, bytes);
    hist_shared<<<static_cast<unsigned>(grid), kBlock, bytes, s>>>(
        gid, mask, values, n, hist, groups, width, log_gamma, min_value_f,
        min_value);
  } else {
    long long grid = px_grid(hist_global, n, kBlock, 0);
    hist_global<<<static_cast<unsigned>(grid), kBlock, 0, s>>>(
        gid, mask, values, n, hist, groups, width, log_gamma, min_value_f,
        min_value);
  }
  return static_cast<int>(cudaGetLastError());
}
