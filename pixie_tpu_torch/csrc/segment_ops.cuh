// The masked segment reductions' per-row operations (count, sum, min, max),
// shared by K1 (segment_reduce.cu) and G1 (gang.cu) so that the two kernels
// update a state with one set of semantics.
//
// Each op: In (value element), Acc (shared accumulator), Out (state element);
// of(x) is a value's accumulator, load(v, i) row i's; shared_add folds into a
// block's private accumulator, combine merges two accumulators, global_add
// folds an accumulator (or one row's) into the state.  Counts use 32-bit
// shared counters flushed into the int64 state; int64 sums use unsigned
// 64-bit atomics, which wrap exactly mod 2^64; f64 sums use native
// atomicAdd(double) (the summation order varies between runs); float min/max
// fold into the state with a compare-and-swap loop in which NaN wins, as in
// the reference (jax segment_min/max propagate NaN), and f64 min/max fold
// into a block's accumulators as order-preserving int64 keys.  Which of
// -0.0 and +0.0 a group keeps when it holds both is unspecified, as in the
// plain version's scatter_reduce.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math_constants.h>
#include <stdint.h>

namespace px_seg {

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
  __device__ static Acc of(In) { return 1u; }
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
  __device__ static Acc of(In x) { return static_cast<unsigned long long>(x); }
  __device__ static Acc load(const In* v, long long i) { return of(v[i]); }
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
  __device__ static Acc of(In x) { return x; }
  __device__ static Acc load(const In* v, long long i) { return of(v[i]); }
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
  __device__ static Acc of(In x) { return x; }
  __device__ static Acc load(const In* v, long long i) { return of(v[i]); }
  __device__ static void shared_add(Acc* p, Acc x) {
    if (kMin) atomicMin(p, x); else atomicMax(p, x);
  }
  __device__ static Acc combine(Acc a, Acc b) {
    return kMin ? (b < a ? b : a) : (b > a ? b : a);
  }
  __device__ static bool is_identity(Acc a) { return a == identity(); }
  __device__ static void global_add(Out* p, Acc a) { shared_add(p, a); }
};

// A double as an int64 key that orders as the value does (-0.0 below +0.0),
// with NaN at the end where it wins a min (kMin) or a max.
__device__ __forceinline__ long long f64_key(double v, bool kmin) {
  if (isnan(v)) return kmin ? LLONG_MIN : LLONG_MAX;
  const long long b = __double_as_longlong(v);
  return b >= 0 ? b : (b ^ LLONG_MAX);
}

__device__ __forceinline__ double f64_of_key(long long k, bool kmin) {
  if (k == (kmin ? LLONG_MIN : LLONG_MAX)) return __longlong_as_double(0x7FF8000000000000LL);
  return __longlong_as_double(k >= 0 ? k : (k ^ LLONG_MAX));
}

// f64 min / max: the block's private accumulators hold f64_key keys, folded
// with native 64-bit atomicMin / atomicMax (a compare-and-swap loop in
// shared memory serialises the warps that reach it); the state is f64,
// folded with atomic_pick_f64.
template <bool kMin>
struct PickF64Op {
  using In = double;
  using Acc = long long;
  using Out = double;
  __device__ static Acc identity() { return f64_key(kMin ? CUDART_INF : -CUDART_INF, kMin); }
  __device__ static Acc of(In x) { return f64_key(x, kMin); }
  __device__ static Acc load(const In* v, long long i) { return of(v[i]); }
  __device__ static void shared_add(Acc* p, Acc x) {
    if (kMin) atomicMin(p, x); else atomicMax(p, x);
  }
  __device__ static Acc combine(Acc a, Acc b) { return kMin ? (b < a ? b : a) : (b > a ? b : a); }
  __device__ static bool is_identity(Acc a) { return a == identity(); }
  __device__ static void global_add(Out* p, Acc a) {
    atomic_pick_f64<kMin>(p, f64_of_key(a, kMin));
  }
};

template <bool kMin>
struct PickF32Op {
  using In = float;
  using Acc = float;
  using Out = float;
  __device__ static Acc identity() { return kMin ? CUDART_INF_F : -CUDART_INF_F; }
  __device__ static Acc of(In x) { return x; }
  __device__ static Acc load(const In* v, long long i) { return of(v[i]); }
  __device__ static void shared_add(Acc* p, Acc x) { atomic_pick_f32<kMin>(p, x); }
  __device__ static Acc combine(Acc a, Acc b) {
    return (kMin ? min_wins_f32(b, a) : max_wins_f32(b, a)) ? b : a;
  }
  __device__ static bool is_identity(Acc a) { return a == identity(); }
  __device__ static void global_add(Out* p, Acc a) { atomic_pick_f32<kMin>(p, a); }
};

}  // namespace px_seg
