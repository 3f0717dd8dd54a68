// M1: the cross-agent merge of aggregate states, every leaf in one launch.
//
// Replaces: pixie_tpu/engine/executor.py ChainKernel.merge_states_fn (a
// jnp.stack of N states and one sum/min/max over axis 0 per leaf), which
// gang_merge_states jits for the agents of one LocalCluster query.  Given N
// states with the same tree, leaf j of the output is
//   out[j] = in_0[j] (op) in_1[j] (op) ... (op) in_{N-1}[j]
// in agent order 0..N-1, with the leaf's op "add", "min" or "max".  Integer
// adds wrap mod 2^width (done in the unsigned type).  min and max propagate
// NaN, as jnp.min / jnp.max do (fminf / fmaxf would drop it).
//
// Bound on the H100: bytes.  Each input element is read once and each output
// element written once: (N + 1) x state bytes / 3.35 TB/s.  At bench config
// #4's state (64 groups: count, mean, p50 sketch, seen; ~135 KB) that is
// well under a microsecond, so the kernel is launch-bound there; at 2^16
// groups with a [G, 514] float32 sketch it is ~0.37 ms for N = 8.
//
// Design: one launch for all leaves.  The host writes a descriptor table --
// per leaf its op, dtype, vector flag, element count, output pointer and the
// N input pointers -- and copies it to the device in one pinned non_blocking
// copy.  blockIdx.y picks the leaf; the blocks of a leaf stride over its
// elements.  A thread reads element j of the N inputs (neighbouring threads on
// neighbouring elements, so every load is coalesced), 16 bytes at a time where
// all of the leaf's pointers are 16-byte aligned, and keeps up to 8 inputs'
// loads in flight before it reduces them in agent order.

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
// loads kept in flight per thread and round
constexpr int kBatch = 8;

enum Op { kAdd = 0, kMin = 1, kMax = 2 };
enum Dtype { kF32 = 0, kF64 = 1, kI64 = 2, kI32 = 3 };

// descriptor: [flags, n, out, in_0 .. in_{N-1}] as int64, flags =
// op | dtype << 8 | vec << 16
constexpr int kHeader = 3;

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

template <typename T, int OP>
__device__ void merge_leaf(const long long* __restrict__ d, int n_states,
                           long long tid, long long stride) {
  const long long n = d[1];
  T* out = reinterpret_cast<T*>(d[2]);
  const long long* ins = d + kHeader;
  constexpr int V = 16 / sizeof(T);
  long long done = 0;
  if ((d[0] >> 16) & 1) {
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
__device__ void merge_typed(const long long* d, int op, int n_states, long long tid,
                            long long stride) {
  if (op == kAdd)
    merge_leaf<T, kAdd>(d, n_states, tid, stride);
  else if (op == kMin)
    merge_leaf<T, kMin>(d, n_states, tid, stride);
  else
    merge_leaf<T, kMax>(d, n_states, tid, stride);
}

__global__ void __launch_bounds__(kBlock) merge_states(const long long* __restrict__ desc,
                                                       int n_states) {
  const long long* d = desc + static_cast<long long>(blockIdx.y) * (kHeader + n_states);
  const int flags = static_cast<int>(d[0]);
  const int op = flags & 0xff;
  const int dtype = (flags >> 8) & 0xff;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  switch (dtype) {
    case kF32:
      merge_typed<float>(d, op, n_states, tid, stride);
      break;
    case kF64:
      merge_typed<double>(d, op, n_states, tid, stride);
      break;
    case kI64:
      merge_typed<long long>(d, op, n_states, tid, stride);
      break;
    default:
      merge_typed<int>(d, op, n_states, tid, stride);
      break;
  }
}

}  // namespace

// desc: the device descriptor table, n_leaves rows of (3 + n_states) int64;
// max_units: the most vector (or scalar) units of any leaf, which sizes
// blockIdx.x.  Launches once on `stream`; returns the launch's CUDA error.
extern "C" int px_merge_states(const long long* desc, int n_leaves, int n_states,
                               long long max_units, cudaStream_t stream) {
  if (n_leaves <= 0 || n_states <= 0) return 0;
  if (n_leaves > 65535) return static_cast<int>(cudaErrorInvalidValue);
  long long gx = (max_units + kBlock - 1) / kBlock;
  const long long cap = 8LL * px_sm_count();
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(n_leaves));
  merge_states<<<grid, kBlock, 0, stream>>>(desc, n_states);
  return static_cast<int>(cudaGetLastError());
}
