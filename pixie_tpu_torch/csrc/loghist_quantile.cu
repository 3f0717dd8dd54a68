// K3: per-group quantiles of the log-histogram sketch (the device finalize).
//
// Replaces: pixie_tpu/ops/sketch.py LogHistogram.quantile_device, an f32
// cumsum over [G, W] followed by a broadcast compare-count per quantile.
//
// Bound on the H100: bytes at S2's shape, launch latency below it.  The work
// is G * W * 4 B of histogram read once (8.4 MB at S2's G = 4,096 and W =
// 514: 2.5 us at 3.35 TB/s; 130 KB at config #1's G = 64, below the cost of
// a launch) and G * nq * 8 B of results written.
//
// Design: one warp a group, kWarps groups a block, no block-wide barrier.
// The warp reads the group's counts in rows of 32 bins (bin r * 32 + lane),
// every row's load issued before the first is used, so each load is one
// coalesced 128-byte run and the warp has W / 32 of them in flight.  Each row
// is scanned by shuffles and carried onto the rows before it, which gives
// every bin's cumulative count.  The counts are integers, so every partial
// sum below 2^24 is exact in float32 in any order and equals the
// reference's sequential f32 cumsum (at or past 2^24 a rank boundary can
// move by a bin, as in the reference).  For quantile q the rank index is
// #(cum < clip(q, 0, 1) * total), clipped and multiplied in float32 as the
// reference does, counted by each lane over its bins and summed by
// __reduce_add_sync, capped at W - 1.  The value is bin_values[idx], a
// device table of gamma^(idx - 1.5) computed in f64 on the host (0 for
// idx <= 0) and cached by the wrapper, so the answer equals the host
// finalize bit for bit; a group with no rows gets NaN.  The quantiles travel
// in the launch's parameters (kMaxQ a launch), so a call uploads nothing.

#include "common.cuh"

#include <math_constants.h>

namespace {

constexpr int kWarps = 4;   // groups a block
constexpr int kMaxQ = 16;   // quantiles a launch

struct Quantiles {
  float q[kMaxQ];
};

// ROWS = the 32-bin rows a group spans (W <= 32 * ROWS).  out[g * stride +
// col0 + j] = quantile j of group g, j < nq.
template <int ROWS>
__global__ void __launch_bounds__(kWarps * 32) quantile_kernel(
    const float* __restrict__ hist, int groups, int width, const Quantiles qs, int nq,
    const double* __restrict__ bin_values, double* __restrict__ out, int stride, int col0) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= groups) return;
  const float* h = hist + static_cast<long long>(g) * width;
  float cum[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = r * 32 + lane;
    cum[r] = b < width ? __ldcs(h + b) : 0.0f;
  }
  float carry = 0.0f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float x = cum[r];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    cum[r] = carry + x;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  const float total = carry;
  int mine = 0;  // lane j keeps quantile j's rank index
  for (int j = 0; j < nq; ++j) {
    const float target = fminf(fmaxf(qs.q[j], 0.0f), 1.0f) * total;
    unsigned below = 0;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) below += (r * 32 + lane < width && cum[r] < target);
    const int idx = static_cast<int>(__reduce_add_sync(0xffffffffu, below));
    if (lane == j) mine = idx < width - 1 ? idx : width - 1;
  }
  if (lane < nq) {
    out[static_cast<long long>(g) * stride + col0 + lane] =
        total > 0.0f ? bin_values[mine] : CUDART_NAN;
  }
}

template <int ROWS>
int launch(const float* hist, int groups, int width, const Quantiles& qs, int nq,
           const double* bin_values, double* out, int stride, int col0, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((groups + kWarps - 1) / kWarps);
  quantile_kernel<ROWS><<<grid, kWarps * 32, 0, s>>>(hist, groups, width, qs, nq, bin_values,
                                                      out, stride, col0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hist: [groups, width] float32; qs: nq (<= 16) float32 quantiles, a host
// array copied into the launch's parameters; bin_values: [width] f64; out:
// [groups, stride] f64, columns col0 .. col0 + nq - 1 written.  hist,
// bin_values and out are device pointers.  Returns a cudaError_t
// (0 = launched).
extern "C" int px_loghist_quantile(const float* hist, int groups, int width, const float* qs,
                                   int nq, const double* bin_values, double* out, int stride,
                                   int col0, void* stream) {
  if (groups <= 0 || nq <= 0) return static_cast<int>(cudaSuccess);
  if (width < 1 || width > 1024 || nq > kMaxQ || col0 < 0 || col0 + nq > stride)
    return static_cast<int>(cudaErrorInvalidValue);
  Quantiles q{};
  for (int j = 0; j < nq; ++j) q.q[j] = qs[j];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 17 * 32) return launch<17>(hist, groups, width, q, nq, bin_values, out, stride,
                                          col0, s);
  return launch<32>(hist, groups, width, q, nq, bin_values, out, stride, col0, s);
}
