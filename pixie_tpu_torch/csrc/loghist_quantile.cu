// K3: per-group quantiles of the log-histogram sketch (the device finalize).
//
// Replaces: pixie_tpu/ops/sketch.py LogHistogram.quantile_device, an f32
// cumsum over [G, W] followed by a broadcast compare-count per quantile.
//
// Bound on the H100: launch latency.  The work is G * W * 4 B of histogram
// (130 KB at the bench's G = 64) read once, a few microseconds of memory
// time at 3.35 TB/s, below the cost of a launch.
//
// Design: one block per group, one thread per bin (W <= 1024).  The block
// scans the counts in float32 in shared memory (Hillis-Steele); the counts are
// integers, so every partial sum below 2^24 is exact and equals the
// reference's sequential f32 cumsum.  For each quantile q the rank index is
// #(cum < clip(q, 0, 1) * total), counted with __syncthreads_count and capped
// at W - 1.  The value is read from bin_values[idx], a table of
// gamma^(idx - 1.5) computed in f64 on the host (0 for idx <= 0), so the device
// answer equals the reference's host finalize bit for bit; groups with no
// rows get NaN.

#include "common.cuh"

#include <math_constants.h>

namespace {

__global__ void quantile_kernel(const float* __restrict__ hist, int width,
                                const float* __restrict__ qs, int nq,
                                const double* __restrict__ bin_values,
                                double* __restrict__ out) {
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
    const float q = fminf(fmaxf(qs[j], 0.0f), 1.0f);
    const float target = q * total;
    const int below = __syncthreads_count(t < width && mine < target);
    if (t == 0) {
      const int idx = below < width - 1 ? below : width - 1;
      out[static_cast<long long>(g) * nq + j] =
          total > 0.0f ? bin_values[idx] : CUDART_NAN;
    }
  }
}

}  // namespace

// hist: [groups, width] float32; qs: [nq] float32; bin_values: [width] f64;
// out: [groups, nq] f64.  All pointers are device pointers.  Returns a
// cudaError_t (0 = launched).
extern "C" int px_loghist_quantile(const float* hist, int groups, int width,
                                   const float* qs, int nq,
                                   const double* bin_values, double* out,
                                   void* stream) {
  if (groups <= 0 || nq <= 0) return static_cast<int>(cudaSuccess);
  if (width < 1 || width > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int block = (width + 31) / 32 * 32;
  quantile_kernel<<<groups, block, block * sizeof(float),
                    static_cast<cudaStream_t>(stream)>>>(hist, width, qs, nq,
                                                         bin_values, out);
  return static_cast<int>(cudaGetLastError());
}
