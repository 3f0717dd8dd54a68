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
// = 65 us.  The arithmetic is one atomic per masked row.  Past shared memory
// (the global route) each touched group's state word is read and written
// once as well; a random atomic moves a whole 32-byte sector each way, so at
// the sorted path's chunk (2^20 rows into 2^23 groups, ~939k touched) the
// sectors alone take 939k x 64 B / 3.35 TB/s = 18 us, where the word-level
// bound is 8.6 us.
//
// Design: two routes, chosen by whether G accumulators fit in the shared
// memory a block may opt in to (227 KB).
//  - Shared: grid-stride over rows with coalesced loads; each block keeps
//    private accumulators for all G groups in dynamic shared memory,
//    replicated once per warp group (up to 8 copies while they fit in 48 KB)
//    so that warps of one block rarely contend on the same address; at the
//    end each block flushes its non-identity accumulators into the global
//    state with one non-returning atomic per group.
//  - Global: each thread takes kRows consecutive rows, its ids, mask and
//    values in 16-byte loads where the inputs are aligned.  Count and sum
//    are one non-returning atomic (RED) a row, kRows of a thread in flight.
//    Float min and max load a row's state word, drop the row if it cannot
//    win (a NaN state, or a value that does not beat it), and fold it with
//    one non-returning 64-bit (32-bit for f32) integer min or max on the
//    value's raw bits, split on its sign bit: a min is a signed min for
//    v >= +0 and an unsigned max for v < 0, a max a signed max for v >= +0
//    and an unsigned min for v < 0.  No loop, no compare-and-swap.  A
//    thread's rows go one after another (load, then atomic), so that the
//    atomic finds the word its load just brought into L2.  A NaN row writes its op's own NaN, the one that
//    wins under that split: a min the negative quiet NaN (0xFFF8... /
//    0xFFC00000), a max the positive one (0x7FF8... / 0x7FC00000).  The
//    load is what keeps a NaN (of either sign) that the state already held:
//    every row of that group sees it and skips, so no integer min or max
//    ever runs on it.  A stale load only lets more rows through, and the
//    atomic decides.
//  Rows with gid outside [0, G) are dropped, as XLA's scatter drops them.
//  The per-row operations (how each of count, sum, min and max accumulates,
//  and where NaN wins) live in segment_ops.cuh, shared with G1 (gang.cu);
//  K1's float min and max fold into device memory with their own ops
//  below, and G1 keeps segment_ops.cuh's compare-and-swap.  Which of -0.0
//  and +0.0 a group keeps when it holds both is unspecified.  Alternatives
//  (ab_kernels.py): the compare-and-swap loop for every row (k1_cas); the
//  atomic for every row without the load (k1_no_filter, which would lose a
//  state's NaN of the other sign), or returning, with the op's NaN put back
//  where the old value was NaN (k1_returning); and 2, 4 or 8 of a thread's
//  state words loaded before any of its rows fold (k1_batch2/4/8).

#include <type_traits>

#include "common.cuh"
#include "segment_ops.cuh"

namespace {

using namespace px_seg;

constexpr int kBlock = 256;
constexpr size_t kReplicaBudget = 48 * 1024;
constexpr int kMaxReplicas = 8;
// rows a thread on the global route: 2 x 16 B of ids, 8 B of mask, 64 B of
// f64 values
constexpr int kRows = 8;

// ---------------------------------------------- K1's float min / max in place

// The NaN each op writes: the one its sign split lets win.
constexpr long long kMinNaN64 = static_cast<long long>(0xFFF8000000000000ull);
constexpr long long kMaxNaN64 = 0x7FF8000000000000ll;
constexpr int kMinNaN32 = static_cast<int>(0xFFC00000u);
constexpr int kMaxNaN32 = 0x7FC00000;

// Folds v into *p given cur, an earlier load of *p: nothing when cur is NaN
// or v cannot win, else one non-returning integer min / max on the raw bits.
template <bool kMin>
__device__ __forceinline__ void red_pick_f64(double* p, double v, double cur) {
  if (isnan(cur) || !(isnan(v) || (kMin ? v < cur : v > cur))) return;
  const long long b = isnan(v) ? (kMin ? kMinNaN64 : kMaxNaN64) : __double_as_longlong(v);
  long long* sp = reinterpret_cast<long long*>(p);
  unsigned long long* up = reinterpret_cast<unsigned long long*>(p);
  if (b >= 0) {
    if (kMin) atomicMin(sp, b); else atomicMax(sp, b);
  } else {
    if (kMin) atomicMax(up, static_cast<unsigned long long>(b));
    else atomicMin(up, static_cast<unsigned long long>(b));
  }
}

template <bool kMin>
__device__ __forceinline__ void red_pick_f32(float* p, float v, float cur) {
  if (isnan(cur) || !(isnan(v) || (kMin ? v < cur : v > cur))) return;
  const int b = isnan(v) ? (kMin ? kMinNaN32 : kMaxNaN32) : __float_as_int(v);
  int* sp = reinterpret_cast<int*>(p);
  unsigned* up = reinterpret_cast<unsigned*>(p);
  if (b >= 0) {
    if (kMin) atomicMin(sp, b); else atomicMax(sp, b);
  } else {
    if (kMin) atomicMax(up, static_cast<unsigned>(b));
    else atomicMin(up, static_cast<unsigned>(b));
  }
}

// A state word loaded from L2 for a row's filter, ordered after this
// thread's earlier atomics (the compiler does not hoist it above them), so
// that each row's atomic follows its own load while the word is still in
// L2.
__device__ __forceinline__ double load_state(const double* p) {
  double v;
  asm volatile("ld.global.cg.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float load_state(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}

// The global route's row step of an op: `row` folds one kept row's value
// into its group's state word; kLoad says whether it needs that word loaded
// first (its `cur`), kValues whether it reads values.  Count, sum and the
// integer min / max: one RED a row.
template <class Op>
struct Global : Op {
  static constexpr bool kLoad = false;
  static constexpr bool kValues = !std::is_same<Op, CountOp>::value;
  __device__ static void row(typename Op::Out* p, typename Op::In x, typename Op::Out) {
    Op::global_add(p, Op::of(x));
  }
};

// K1's f64 min / max: shared accumulators as PickF64Op's int64 keys; the
// flush and the global route's rows through red_pick_f64.
template <bool kMin>
struct PickF64 : PickF64Op<kMin> {
  static constexpr bool kLoad = true;
  static constexpr bool kValues = true;
  __device__ static void global_add(double* p, long long key) {
    red_pick_f64<kMin>(p, f64_of_key(key, kMin), __ldcg(p));
  }
  __device__ static void row(double* p, double x, double cur) { red_pick_f64<kMin>(p, x, cur); }
};

template <bool kMin>
struct PickF32 : PickF32Op<kMin> {
  static constexpr bool kLoad = true;
  static constexpr bool kValues = true;
  __device__ static void global_add(float* p, float a) { red_pick_f32<kMin>(p, a, __ldcg(p)); }
  __device__ static void row(float* p, float x, float cur) { red_pick_f32<kMin>(p, x, cur); }
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

// Rows [i0, i0 + kRows) into g / keep / x: by 16-byte loads when kVec (every
// input aligned) and the run is whole, else row by row.  Count reads no
// values (v is null).
template <class Op, bool kVec>
__device__ __forceinline__ void load_run(const int* __restrict__ gid,
                                         const uint8_t* __restrict__ mask,
                                         const typename Op::In* __restrict__ v, long long i0,
                                         long long n, int groups, int (&g)[kRows],
                                         bool (&keep)[kRows], typename Op::In (&x)[kRows]) {
  using In = typename Op::In;
  constexpr bool kValues = Op::kValues;
  if (kVec && i0 + kRows <= n) {
    const int4 g0 = __ldcs(reinterpret_cast<const int4*>(gid + i0));
    const int4 g1 = __ldcs(reinterpret_cast<const int4*>(gid + i0) + 1);
    g[0] = g0.x; g[1] = g0.y; g[2] = g0.z; g[3] = g0.w;
    g[4] = g1.x; g[5] = g1.y; g[6] = g1.z; g[7] = g1.w;
    const uint2 m = __ldcs(reinterpret_cast<const uint2*>(mask + i0));
#pragma unroll
    for (int r = 0; r < kRows; ++r) keep[r] = ((r < 4 ? m.x : m.y) >> (8 * (r & 3))) & 0xffu;
    if constexpr (kValues) {
      constexpr int kVecs = sizeof(In) * kRows / 16;
      union {
        uint4 q[kVecs];
        In e[kRows];
      } u;
#pragma unroll
      for (int k = 0; k < kVecs; ++k) u.q[k] = __ldcs(reinterpret_cast<const uint4*>(v + i0) + k);
#pragma unroll
      for (int r = 0; r < kRows; ++r) x[r] = u.e[r];
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long i = i0 + r;
      keep[r] = i < n && mask[i];
      g[r] = keep[r] ? gid[i] : 0;
      if constexpr (kValues) x[r] = keep[r] ? v[i] : In(0);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    keep[r] = keep[r] && static_cast<unsigned>(g[r]) < static_cast<unsigned>(groups);
  }
}

// Past shared memory: each thread kRows consecutive rows of a kBlock * kRows
// tile, grid-stride over tiles.  The run's rows fold one after another; an
// op that needs its state word (kLoad) loads it just before its row.
template <class Op, bool kVec>
__global__ void __launch_bounds__(kBlock) reduce_global(
    const int* __restrict__ gid, const uint8_t* __restrict__ mask,
    const typename Op::In* __restrict__ v, long long n,
    typename Op::Out* __restrict__ out, int groups) {
  using Out = typename Op::Out;
  constexpr long long kTile = static_cast<long long>(kBlock) * kRows;
  for (long long t0 = static_cast<long long>(blockIdx.x) * kTile; t0 < n;
       t0 += static_cast<long long>(gridDim.x) * kTile) {
    int g[kRows];
    bool keep[kRows];
    typename Op::In x[kRows];
    load_run<Op, kVec>(gid, mask, v, t0 + static_cast<long long>(threadIdx.x) * kRows, n, groups,
                       g, keep, x);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (!keep[r]) continue;
      Out cur = Out(0);
      if constexpr (Op::kLoad) cur = load_state(out + g[r]);
      Op::row(out + g[r], x[r], cur);
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
    const bool vec = (reinterpret_cast<uintptr_t>(gid) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(mask) & 7) == 0 &&
                     (reinterpret_cast<uintptr_t>(v) & 15) == 0;
    const long long runs = (n + kRows - 1) / kRows;
    if (vec) {
      long long grid = px_grid(reduce_global<Op, true>, runs, kBlock, 0);
      reduce_global<Op, true><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
          gid, mask, v, n, out, groups);
    } else {
      long long grid = px_grid(reduce_global<Op, false>, runs, kBlock, 0);
      reduce_global<Op, false><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(
          gid, mask, v, n, out, groups);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

using Count = Global<CountOp>;
using SumI64 = Global<SumI64Op>;
using SumF64 = Global<SumFloatOp<double>>;
using SumF32 = Global<SumFloatOp<float>>;
using MinI32 = Global<PickIntOp<int, true>>;
using MaxI32 = Global<PickIntOp<int, false>>;
using MinI64 = Global<PickIntOp<long long, true>>;
using MaxI64 = Global<PickIntOp<long long, false>>;
using MinF64 = PickF64<true>;
using MaxF64 = PickF64<false>;
using MinF32 = PickF32<true>;
using MaxF32 = PickF32<false>;

}  // namespace

// -------------------------------------------------------------- C interface
// All pointers are device pointers; `out` holds G accumulators that the call
// updates in place.  Returns a cudaError_t (0 = launched).

extern "C" int px_segment_count(const int* gid, const uint8_t* mask, long long n,
                                long long* out, int groups, void* stream) {
  return launch<Count>(gid, mask, nullptr, n, out, groups,
                         static_cast<cudaStream_t>(stream));
}

#define PX_SEGMENT_ENTRY(NAME, OP, T)                                          \
  extern "C" int NAME(const int* gid, const uint8_t* mask, const T* values,   \
                      long long n, T* out, int groups, void* stream) {         \
    return launch<OP>(gid, mask, values, n, out, groups,                       \
                      static_cast<cudaStream_t>(stream));                      \
  }

PX_SEGMENT_ENTRY(px_segment_sum_i64, SumI64, long long)
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
