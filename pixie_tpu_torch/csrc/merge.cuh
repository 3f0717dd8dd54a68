// M1's merge body: one leaf of N states reduced element by element, in state
// order.  Shared by kernel M1 (merge.cu) and the merge phase of F2
// (finalize.cu), so both merge with the same arithmetic.
//
// out[j] = in_0[j] (op) in_1[j] (op) ... (op) in_{N-1}[j], with op "add",
// "min" or "max".  Integer adds wrap mod 2^width (done in the unsigned type).
// min and max propagate NaN, as jnp.min / jnp.max do (fminf / fmaxf would
// drop it).  A thread reads element j of the N inputs (neighbouring threads
// on neighbouring elements, so every load is coalesced), 16 bytes at a time
// where every pointer of the leaf is 16-byte aligned, and keeps up to kBatch
// inputs' loads in flight before it reduces them in state order.
#pragma once

#include <cuda_runtime.h>

namespace px_merge {

// loads kept in flight per thread and round
constexpr int kBatch = 8;

enum Op { kAdd = 0, kMin = 1, kMax = 2 };
enum Dtype { kF32 = 0, kF64 = 1, kI64 = 2, kI32 = 3 };

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  return v != v;
}

template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  if (OP == kAdd) return a + b;
  if (OP == kMin) {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    return b < a ? b : a;
  }
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  return b > a ? b : a;
}

// integer adds wrap: add in the unsigned type of the same width
template <>
__device__ __forceinline__ long long combine<long long, kAdd>(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
template <>
__device__ __forceinline__ int combine<int, kAdd>(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// n elements of the n_states inputs at ins[0..n_states) (device pointers as
// int64) into out; vec: every pointer is 16-byte aligned.  Grid-stride over
// (tid, stride).
template <typename T, int OP>
__device__ void merge_leaf(T* out, const long long* ins, long long n, bool vec, int n_states,
                           long long tid, long long stride) {
  constexpr int V = 16 / sizeof(T);
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long v = tid; v < nv; v += stride) {
      union Vec {
        uint4 u;
        T t[V];
      };
      Vec acc;
      acc.u = __ldg(reinterpret_cast<const uint4*>(ins[0]) + v);
      for (int s0 = 1; s0 < n_states; s0 += kBatch) {
        Vec x[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (s0 + k < n_states) x[k].u = __ldg(reinterpret_cast<const uint4*>(ins[s0 + k]) + v);
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          if (s0 + k < n_states) {
#pragma unroll
            for (int e = 0; e < V; ++e) acc.t[e] = combine<T, OP>(acc.t[e], x[k].t[e]);
          }
      }
      reinterpret_cast<uint4*>(out)[v] = acc.u;
    }
    done = nv * V;
  }
  for (long long j = done + tid; j < n; j += stride) {
    T acc = __ldg(reinterpret_cast<const T*>(ins[0]) + j);
    for (int s0 = 1; s0 < n_states; s0 += kBatch) {
      T x[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (s0 + k < n_states) x[k] = __ldg(reinterpret_cast<const T*>(ins[s0 + k]) + j);
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (s0 + k < n_states) acc = combine<T, OP>(acc, x[k]);
    }
    out[j] = acc;
  }
}

template <typename T>
__device__ void merge_typed(int op, void* out, const long long* ins, long long n, bool vec,
                            int n_states, long long tid, long long stride) {
  T* o = static_cast<T*>(out);
  if (op == kAdd)
    merge_leaf<T, kAdd>(o, ins, n, vec, n_states, tid, stride);
  else if (op == kMin)
    merge_leaf<T, kMin>(o, ins, n, vec, n_states, tid, stride);
  else
    merge_leaf<T, kMax>(o, ins, n, vec, n_states, tid, stride);
}

// One leaf of dtype `dtype` (Dtype) merged with `op` (Op).
__device__ __forceinline__ void merge_any(int dtype, int op, void* out, const long long* ins,
                                          long long n, bool vec, int n_states, long long tid,
                                          long long stride) {
  switch (dtype) {
    case kF32:
      merge_typed<float>(op, out, ins, n, vec, n_states, tid, stride);
      break;
    case kF64:
      merge_typed<double>(op, out, ins, n, vec, n_states, tid, stride);
      break;
    case kI64:
      merge_typed<long long>(op, out, ins, n, vec, n_states, tid, stride);
      break;
    default:
      merge_typed<int>(op, out, ins, n, vec, n_states, tid, stride);
      break;
  }
}

}  // namespace px_merge
