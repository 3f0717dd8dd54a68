// The log-histogram sketch's bin of one value, shared by K2
// (loghist_update.cu), G1 (gang.cu) and F1 (finalize.cu) so that all three
// bin with one code.
//
// The bin follows pixie_tpu/ops/sketch.py:103-106 operation by operation:
// logf of max(float(v), float(min_value)), divided by the float constant
// (float)log(gamma), ceilf, +1; the zero-bin test v <= min_value in the
// value's own double; a clamp to [0, W-1].  The reference converts the float
// ceiling to int32 the way XLA does (NaN -> 0, +inf -> INT32_MAX, whose +1
// wraps negative and clamps to bin 0); px_bin reproduces those edge results
// explicitly.  Built without --use_fast_math so logf stays the accurate logf.
//
// NaN is the one value whose bin depends on the reference's route: its
// device route converts the NaN ceiling to 0 and bins NaN at 1, its CPU
// routes (pixie_tpu/engine/np_partial.py:244-248, native/stream_agg.cc:33-36,
// which its streaming polls take) convert it to INT32_MIN and clamp to bin 0.
// The caller passes the bin (`nan_bin`): 1 for a batch query, 0 for a
// streaming poll.
#pragma once

#include <cuda_runtime.h>

static __device__ __forceinline__ int px_bin(double v, float log_gamma, float min_f,
                                             double min_d, int width, int nan_bin) {
  if (isnan(v)) return nan_bin;
  if (v <= min_d) return 0;
  const float x = fmaxf(static_cast<float>(v), min_f);
  const float c = ceilf(logf(x) / log_gamma);
  if (!(c < 2147483648.0f)) return 0;  // INT32_MAX + 1 wraps negative -> 0
  const int idx = c < -1.0f ? 0 : static_cast<int>(c) + 1;
  return idx < width - 1 ? idx : width - 1;
}
