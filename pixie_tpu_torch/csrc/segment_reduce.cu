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
// rows go straight to global atomics.  Rows with gid outside [0, G) are
// dropped, as XLA's scatter drops them.  The per-row operations (how each
// of count, sum, min and max accumulates, and where NaN wins) live in
// segment_ops.cuh, shared with G1 (gang.cu).

#include "common.cuh"
#include "segment_ops.cuh"

namespace {

using namespace px_seg;

constexpr int kBlock = 256;
constexpr size_t kReplicaBudget = 48 * 1024;
constexpr int kMaxReplicas = 8;

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
