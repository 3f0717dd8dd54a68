// K1: masked segment reductions (count, sum, min, max) accumulated in place
// into a per-group state vector.
//
// Replaces: pixie_tpu/ops/groupby.py masked_segment_count / masked_segment_sum
// (the _chunked_onehot_sum and _chunked_onehot_multi_sum one-hot MXU GEMMs with
// 8-bit limbs) and masked_segment_min / masked_segment_max.  The one-hot GEMM
// exists only because scatter was slow on the TPU; on Hopper the natural form
// is a scatter privatized in shared memory.
//
// Bound on the H100: bytes.  Each row is read once: gid 4 B + mask 1 B + value
// 8 B (f64/i64), 13 B/row, so a 16M-row feed needs at least 218 MB / 3.35 TB/s
// = 65 us.  The arithmetic is one atomic per masked row.
//
// Design: grid-stride over rows with coalesced loads; each block keeps
// private accumulators for all G groups in dynamic shared memory, replicated
// once per warp group (up to 8 copies while they fit in 48 KB) so that warps
// of one block rarely contend on the same address; at the end each block
// flushes its non-identity accumulators into the global state with one atomic
// per group.  When G accumulators exceed what a block may opt in to (227 KB),
// rows go straight to global atomics.  Counts use 32-bit shared counters
// flushed into the int64 state; int64 sums use unsigned 64-bit atomics, which
// wrap exactly mod 2^64; f64 sums use native atomicAdd(double) (the summation
// order varies between runs); float min/max use a compare-and-swap loop in
// which NaN wins, as in the reference (jax segment_min/max propagate NaN).
// Rows with gid outside [0, G) are dropped, as XLA's scatter drops them.

#include "common.cuh"

#include <limits.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 256;
constexpr size_t kReplicaBudget = 48 * 1024;
constexpr int kMaxReplicas = 8;

__device__ __forceinline__ bool min_wins_f64(double v, double cur) {
  return isnan(v) ? !isnan(cur) : v < cur;
}
__device__ __forceinline__ bool max_wins_f64(double v, double cur) {
  return isnan(v) ? !isnan(cur) : v > cur;
}
__device__ __forceinline__ bool min_wins_f32(float v, float cur) {
  return isnan(v) ? !isnan(cur) : v < cur;
}
__device__ __forceinline__ bool max_wins_f32(float v, float cur) {
  return isnan(v) ? !isnan(cur) : v > cur;
}

template <bool kMin>
__device__ __forceinline__ void atomic_pick_f64(double* p, double v) {
  unsigned long long* up = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *up;
  while (true) {
    double cur = __longlong_as_double(static_cast<long long>(old));
    if (!(kMin ? min_wins_f64(v, cur) : max_wins_f64(v, cur))) return;
    unsigned long long prev = atomicCAS(
        up, old, static_cast<unsigned long long>(__double_as_longlong(v)));
    if (prev == old) return;
    old = prev;
  }
}

template <bool kMin>
__device__ __forceinline__ void atomic_pick_f32(float* p, float v) {
  unsigned int* up = reinterpret_cast<unsigned int*>(p);
  unsigned int old = *up;
  while (true) {
    float cur = __uint_as_float(old);
    if (!(kMin ? min_wins_f32(v, cur) : max_wins_f32(v, cur))) return;
    unsigned int prev = atomicCAS(up, old, __float_as_uint(v));
    if (prev == old) return;
    old = prev;
  }
}

// ------------------------------------------------------------------ the ops
// Each op: In (value element), Acc (shared accumulator), Out (state element).

struct CountOp {
  using In = uint8_t;
  using Acc = unsigned int;
  using Out = long long;
  __device__ static Acc identity() { return 0u; }
  __device__ static Acc load(const In*, long long) { return 1u; }
  __device__ static void shared_add(Acc* p, Acc x) { atomicAdd(p, x); }
  __device__ static Acc combine(Acc a, Acc b) { return a + b; }
  __device__ static bool is_identity(Acc a) { return a == 0u; }
  __device__ static void global_add(Out* p, Acc a) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p),
              static_cast<unsigned long long>(a));
  }
};

struct SumI64Op {
  using In = long long;
  using Acc = unsigned long long;
  using Out = long long;
  __device__ static Acc identity() { return 0ull; }
  __device__ static Acc load(const In* v, long long i) {
    return static_cast<unsigned long long>(v[i]);
  }
  __device__ static void shared_add(Acc* p, Acc x) { atomicAdd(p, x); }
  __device__ static Acc combine(Acc a, Acc b) { return a + b; }
  __device__ static bool is_identity(Acc a) { return a == 0ull; }
  __device__ static void global_add(Out* p, Acc a) {
    atomicAdd(reinterpret_cast<unsigned long long*>(p), a);
  }
};

template <typename F>
struct SumFloatOp {
  using In = F;
  using Acc = F;
  using Out = F;
  __device__ static Acc identity() { return F(0); }
  __device__ static Acc load(const In* v, long long i) { return v[i]; }
  __device__ static void shared_add(Acc* p, Acc x) { atomicAdd(p, x); }
  __device__ static Acc combine(Acc a, Acc b) { return a + b; }
  __device__ static bool is_identity(Acc a) { return a == F(0); }
  __device__ static void global_add(Out* p, Acc a) { atomicAdd(p, a); }
};

template <typename I> struct IntLimits;
template <> struct IntLimits<int> {
  static constexpr int lo = INT_MIN;
  static constexpr int hi = INT_MAX;
};
template <> struct IntLimits<long long> {
  static constexpr long long lo = LLONG_MIN;
  static constexpr long long hi = LLONG_MAX;
};

template <typename I, bool kMin>
struct PickIntOp {
  using In = I;
  using Acc = I;
  using Out = I;
  __device__ static Acc identity() { return kMin ? IntLimits<I>::hi : IntLimits<I>::lo; }
  __device__ static Acc load(const In* v, long long i) { return v[i]; }
  __device__ static void shared_add(Acc* p, Acc x) {
    if (kMin) atomicMin(p, x); else atomicMax(p, x);
  }
  __device__ static Acc combine(Acc a, Acc b) {
    return kMin ? (b < a ? b : a) : (b > a ? b : a);
  }
  __device__ static bool is_identity(Acc a) { return a == identity(); }
  __device__ static void global_add(Out* p, Acc a) { shared_add(p, a); }
};

template <bool kMin>
struct PickF64Op {
  using In = double;
  using Acc = double;
  using Out = double;
  __device__ static Acc identity() { return kMin ? CUDART_INF : -CUDART_INF; }
  __device__ static Acc load(const In* v, long long i) { return v[i]; }
  __device__ static void shared_add(Acc* p, Acc x) { atomic_pick_f64<kMin>(p, x); }
  __device__ static Acc combine(Acc a, Acc b) {
    return (kMin ? min_wins_f64(b, a) : max_wins_f64(b, a)) ? b : a;
  }
  __device__ static bool is_identity(Acc a) { return a == identity(); }
  __device__ static void global_add(Out* p, Acc a) { atomic_pick_f64<kMin>(p, a); }
};

template <bool kMin>
struct PickF32Op {
  using In = float;
  using Acc = float;
  using Out = float;
  __device__ static Acc identity() { return kMin ? CUDART_INF_F : -CUDART_INF_F; }
  __device__ static Acc load(const In* v, long long i) { return v[i]; }
  __device__ static void shared_add(Acc* p, Acc x) { atomic_pick_f32<kMin>(p, x); }
  __device__ static Acc combine(Acc a, Acc b) {
    return (kMin ? min_wins_f32(b, a) : max_wins_f32(b, a)) ? b : a;
  }
  __device__ static bool is_identity(Acc a) { return a == identity(); }
  __device__ static void global_add(Out* p, Acc a) { atomic_pick_f32<kMin>(p, a); }
};

// ------------------------------------------------------------------ kernels

template <class Op>
__global__ void __launch_bounds__(kBlock) reduce_shared(
    const int* __restrict__ gid, const uint8_t* __restrict__ mask,
    const typename Op::In* __restrict__ v, long long n,
    typename Op::Out* __restrict__ out, int groups, int replicas) {
  using Acc = typename Op::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* acc = reinterpret_cast<Acc*>(smem_raw);
  const int total = groups * replicas;
  for (int i = threadIdx.x; i < total; i += blockDim.x) acc[i] = Op::identity();
  __syncthreads();
  Acc* mine = acc + ((threadIdx.x >> 5) % replicas) * groups;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int g = gid[i];
    if (mask[i] && static_cast<unsigned>(g) < static_cast<unsigned>(groups)) {
      Op::shared_add(mine + g, Op::load(v, i));
    }
  }
  __syncthreads();
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    Acc a = acc[g];
    for (int r = 1; r < replicas; ++r) a = Op::combine(a, acc[r * groups + g]);
    if (!Op::is_identity(a)) Op::global_add(out + g, a);
  }
}

template <class Op>
__global__ void __launch_bounds__(kBlock) reduce_global(
    const int* __restrict__ gid, const uint8_t* __restrict__ mask,
    const typename Op::In* __restrict__ v, long long n,
    typename Op::Out* __restrict__ out, int groups) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int g = gid[i];
    if (mask[i] && static_cast<unsigned>(g) < static_cast<unsigned>(groups)) {
      Op::global_add(out + g, Op::load(v, i));
    }
  }
}

template <class Op>
int launch(const int* gid, const uint8_t* mask, const typename Op::In* v,
           long long n, typename Op::Out* out, int groups, cudaStream_t stream) {
  if (n <= 0 || groups <= 0) return static_cast<int>(cudaSuccess);
  const size_t per = static_cast<size_t>(groups) * sizeof(typename Op::Acc);
  if (per <= static_cast<size_t>(px_smem_optin())) {
    int replicas = 1;
    if (per <= kReplicaBudget) {
      size_t fit = kReplicaBudget / per;
      replicas = static_cast<int>(fit < kMaxReplicas ? fit : kMaxReplicas);
    }
    const size_t bytes = per * replicas;
    if (bytes > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          reduce_shared<Op>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(bytes));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    long long grid = px_grid(reduce_shared<Op>, n, kBlock, bytes);
    reduce_shared<Op><<<static_cast<unsigned>(grid), kBlock, bytes, stream>>>(
        gid, mask, v, n, out, groups, replicas);
  } else {
    long long grid = px_grid(reduce_global<Op>, n, kBlock, 0);
    reduce_global<Op><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
        gid, mask, v, n, out, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

using SumF64 = SumFloatOp<double>;
using SumF32 = SumFloatOp<float>;
using MinI32 = PickIntOp<int, true>;
using MaxI32 = PickIntOp<int, false>;
using MinI64 = PickIntOp<long long, true>;
using MaxI64 = PickIntOp<long long, false>;
using MinF64 = PickF64Op<true>;
using MaxF64 = PickF64Op<false>;
using MinF32 = PickF32Op<true>;
using MaxF32 = PickF32Op<false>;

}  // namespace

// -------------------------------------------------------------- C interface
// All pointers are device pointers; `out` holds G accumulators that the call
// updates in place.  Returns a cudaError_t (0 = launched).

extern "C" int px_segment_count(const int* gid, const uint8_t* mask, long long n,
                                long long* out, int groups, void* stream) {
  return launch<CountOp>(gid, mask, nullptr, n, out, groups,
                         static_cast<cudaStream_t>(stream));
}

#define PX_SEGMENT_ENTRY(NAME, OP, T)                                          \
  extern "C" int NAME(const int* gid, const uint8_t* mask, const T* values,   \
                      long long n, T* out, int groups, void* stream) {         \
    return launch<OP>(gid, mask, values, n, out, groups,                       \
                      static_cast<cudaStream_t>(stream));                      \
  }

PX_SEGMENT_ENTRY(px_segment_sum_i64, SumI64Op, long long)
PX_SEGMENT_ENTRY(px_segment_sum_f64, SumF64, double)
PX_SEGMENT_ENTRY(px_segment_sum_f32, SumF32, float)
PX_SEGMENT_ENTRY(px_segment_min_i32, MinI32, int)
PX_SEGMENT_ENTRY(px_segment_max_i32, MaxI32, int)
PX_SEGMENT_ENTRY(px_segment_min_i64, MinI64, long long)
PX_SEGMENT_ENTRY(px_segment_max_i64, MaxI64, long long)
PX_SEGMENT_ENTRY(px_segment_min_f64, MinF64, double)
PX_SEGMENT_ENTRY(px_segment_max_f64, MaxF64, double)
PX_SEGMENT_ENTRY(px_segment_min_f32, MinF32, float)
PX_SEGMENT_ENTRY(px_segment_max_f32, MaxF32, float)
