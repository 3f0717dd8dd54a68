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
// The bin is px_bin (loghist.cuh, shared with G1 and F1), which follows
// sketch.py:103-106 operation by operation; the caller gives NaN's bin.

#include "common.cuh"
#include "loghist.cuh"

namespace {

constexpr int kBlock = 1024;

__global__ void __launch_bounds__(kBlock) hist_shared(
    const int* __restrict__ gid, const uint8_t* __restrict__ mask,
    const double* __restrict__ v, long long n, float* __restrict__ hist,
    int groups, int width, float log_gamma, float min_f, double min_d, int nan_bin) {
  extern __shared__ __align__(16) unsigned int counts[];
  const int cells = groups * width;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) counts[i] = 0u;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int g = gid[i];
    if (mask[i] && static_cast<unsigned>(g) < static_cast<unsigned>(groups)) {
      atomicAdd(&counts[g * width + px_bin(v[i], log_gamma, min_f, min_d, width, nan_bin)], 1u);
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
    int groups, int width, float log_gamma, float min_f, double min_d, int nan_bin) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int g = gid[i];
    if (mask[i] && static_cast<unsigned>(g) < static_cast<unsigned>(groups)) {
      const long long cell =
          static_cast<long long>(g) * width +
          px_bin(v[i], log_gamma, min_f, min_d, width, nan_bin);
      atomicAdd(&hist[cell], 1.0f);
    }
  }
}

}  // namespace

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
        min_value, nan_bin);
  } else {
    long long grid = px_grid(hist_global, n, kBlock, 0);
    hist_global<<<static_cast<unsigned>(grid), kBlock, 0, s>>>(
        gid, mask, values, n, hist, groups, width, log_gamma, min_value_f,
        min_value, nan_bin);
  }
  return static_cast<int>(cudaGetLastError());
}
