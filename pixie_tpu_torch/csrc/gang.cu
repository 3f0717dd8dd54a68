// G1: the multi-query gang — every member's partial aggregate step over one
// shared feed in one launch.
//
// Replaces: pixie_tpu/engine/executor.py `_multi_partial_agg` (:2807) and
// its `fused_fn` (:2852): per feed, XLA traced the gang members' own
// partial steps (chain mask, group ids, computed values, UDA updates)
// together into one program.  The per-sink route of the port runs each
// member's C1 launch and then one K1 or K2 launch per state leaf, each
// reading the shared feed columns again.
//
// Bound on the H100: bytes.  Each column of the members' union is read once
// and each state leaf written once; for the four dashboard scripts of the
// reference's load harness (service 4 B, status 8 B, latency 8 B) that is
// 20 B a row, 335 MB for a 16M-row feed, about 0.10 ms at 3.35 TB/s.  The
// arithmetic is a few integer operations, a logf for a sketch and one
// shared atomic per kept row and leaf.
//
// Design: blocks walk tiles of R x 256 rows with a grid stride, as C1 does.
// For each tile, every member's program runs in turn over the same rows
// through C1's interpreter (`px_chain::run_tile`, chain.cuh), so the second
// member's column loads hit L1 or L2 rather than HBM.  Nothing per row
// reaches device memory: the mask and the group ids stay in registers, and
// a program's STORE writes a tile slot in shared memory, not an output
// column.  Right after each member's program the block folds that member's
// kept rows into its state leaves with the per-row operations of K1
// (segment_ops.cuh) and K2's bin (loghist.cuh): count into int64, sums into
// int64 (wrapping) or f64, the f64 sum of squares, min and max over int32,
// int64 and f64 (NaN wins), the sketch's cell count into f32.  Each member
// whose state fits the block's budget (the wrapper decides, ops/gang.py)
// keeps private accumulators in shared memory, flushed with one atomic per
// group at the end as K1 and K2 flush theirs; a member whose state does not
// fit adds every row into its state with global atomics.  The states are
// the members' own tensors, updated in place across feeds.
//
// Shared memory: the deepest member's stack and the widest member's output
// slots (each R x 256 values of 8 B), then the private accumulators.  A
// thread touches only its own rows' stack and slots, so the only barriers
// are after the accumulators' initialisation and before their flush.

#include "chain.cuh"
#include "loghist.cuh"
#include "segment_ops.cuh"

namespace {

// Leaf updates; the order is ops/gang.py's LEAF_CODES.
enum LeafOp : int {
  L_COUNT, L_SUM_I64, L_SUM_F64, L_SUMSQ_F64, L_MIN_I32, L_MAX_I32, L_MIN_I64, L_MAX_I64,
  L_MIN_F64, L_MAX_F64, L_HIST
};

}  // namespace

// One leaf update: which state tensor it folds into, from which value, how.
// Mirrored by ctypes in ops/gang.py.
struct GangLeaf {
  void* state;      // [groups] or, for a sketch, [groups, width]; updated in place
  const void* col;  // the value's feed column, when slot < 0
  double min_d;     // sketch: min_value
  int op;           // LeafOp
  int kind;         // the value's kind (px_chain::Kind)
  int slot;         // the program's output slot holding the value, or -1
  int groups;
  int shared_off;   // byte offset of the block's private accumulators, or -1
  int width;        // sketch: cells per group
  float log_gamma;  // sketch: (float)log(gamma)
  float min_f;      // sketch: (float)min_value
};

// One member: its program over this feed (out, mask_out and gid_out unused)
// and its leaves, leaves[leaf0, leaf0 + nleaf).  Mirrored by ctypes.
struct GangMember {
  ChainParams chain;
  int groups;
  int leaf0;
  int nleaf;
  int pad;
};

namespace {

using namespace px_chain;
using namespace px_seg;

// The sketch's cells: 32-bit shared counts flushed as float adds, as in K2.
struct HistCellOp {
  using Acc = unsigned int;
  using Out = float;
  __device__ static Acc identity() { return 0u; }
  __device__ static bool is_identity(Acc a) { return a == 0u; }
  __device__ static void global_add(Out* p, Acc a) { atomicAdd(p, static_cast<float>(a)); }
};

// STORE: the row's value into tile slot `a` in shared memory, in its kind.
template <int R>
struct SlotStore {
  const ChainParams& p;
  long long* slots;
  __device__ __forceinline__ void operator()(int a, int r, long long, long long v) const {
    slots[static_cast<size_t>(a) * (R * kBlock) + r * kBlock + threadIdx.x] =
        as_kind(p.out_kind[a], v);
  }
};

template <class Op>
__device__ __forceinline__ void init_acc(unsigned char* acc, int cells) {
  typename Op::Acc* a = reinterpret_cast<typename Op::Acc*>(acc);
  for (int c = threadIdx.x; c < cells; c += blockDim.x) a[c] = Op::identity();
}

template <class Op>
__device__ __forceinline__ void flush_acc(const unsigned char* acc, void* state, int cells) {
  const typename Op::Acc* a = reinterpret_cast<const typename Op::Acc*>(acc);
  typename Op::Out* out = static_cast<typename Op::Out*>(state);
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    if (!Op::is_identity(a[c])) Op::global_add(out + c, a[c]);
  }
}

// Runs F<Op>::run(args...) for the leaf's op.
template <template <class> class F, class... Args>
__device__ __forceinline__ void dispatch(int op, Args&&... args) {
  switch (op) {
    case L_COUNT: F<CountOp>::run(args...); break;
    case L_SUM_I64: F<SumI64Op>::run(args...); break;
    case L_SUM_F64:
    case L_SUMSQ_F64: F<SumFloatOp<double>>::run(args...); break;
    case L_MIN_I32: F<PickIntOp<int, true>>::run(args...); break;
    case L_MAX_I32: F<PickIntOp<int, false>>::run(args...); break;
    case L_MIN_I64: F<PickIntOp<long long, true>>::run(args...); break;
    case L_MAX_I64: F<PickIntOp<long long, false>>::run(args...); break;
    case L_MIN_F64: F<PickF64Op<true>>::run(args...); break;
    case L_MAX_F64: F<PickF64Op<false>>::run(args...); break;
    case L_HIST: F<HistCellOp>::run(args...); break;
    default: break;  // ops/gang.py checks every leaf before the launch
  }
}

template <class Op>
struct Init {
  __device__ static void run(const GangLeaf& L, unsigned char* acc) {
    if (L.shared_off >= 0) init_acc<Op>(acc + L.shared_off, L.groups * L.width);
  }
};

template <class Op>
struct Flush {
  __device__ static void run(const GangLeaf& L, unsigned char* acc) {
    if (L.shared_off >= 0) flush_acc<Op>(acc + L.shared_off, L.state, L.groups * L.width);
  }
};

// Folds each kept row r (keep[r], gid[r] in [0, groups)) of value(r) into
// the leaf: its private accumulators, or the state with global atomics.
// All R values are loaded before the first atomic, so their loads overlap.
template <class Op, int R, class Value>
__device__ __forceinline__ void fold(const GangLeaf& L, const bool (&keep)[R],
                                     const int (&gid)[R], unsigned char* acc, Value value) {
  typename Op::Acc x[R];
  bool in[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    in[r] = keep[r] && static_cast<unsigned>(gid[r]) < static_cast<unsigned>(L.groups);
    x[r] = in[r] ? Op::of(value(r)) : Op::identity();
  }
  if (L.shared_off >= 0) {
    typename Op::Acc* sh = reinterpret_cast<typename Op::Acc*>(acc + L.shared_off);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (in[r]) Op::shared_add(sh + gid[r], x[r]);
    }
  } else {
    typename Op::Out* out = static_cast<typename Op::Out*>(L.state);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (in[r]) Op::global_add(out + gid[r], x[r]);
    }
  }
}

// The sketch: the row's cell is g * width + its bin.
template <int R, class Value>
__device__ __forceinline__ void fold_hist(const GangLeaf& L, const bool (&keep)[R],
                                          const int (&gid)[R], unsigned char* acc,
                                          Value value) {
  long long cell[R];
  bool in[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    in[r] = keep[r] && static_cast<unsigned>(gid[r]) < static_cast<unsigned>(L.groups);
    cell[r] = in[r] ? static_cast<long long>(gid[r]) * L.width +
                          px_bin(value(r), L.log_gamma, L.min_f, L.min_d, L.width)
                    : 0;
  }
  if (L.shared_off >= 0) {
    unsigned int* sh = reinterpret_cast<unsigned int*>(acc + L.shared_off);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (in[r]) atomicAdd(sh + cell[r], 1u);
    }
  } else {
    float* hist = static_cast<float*>(L.state);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (in[r]) atomicAdd(hist + cell[r], 1.0f);
    }
  }
}

// One leaf's update over the thread's kept rows of the tile at `base`.
// Values convert as torch's .to(state dtype) does: integer kinds are
// already their int64 values; to f64 by round to nearest.  The leaf is
// copied into registers first: the atomics below would otherwise make the
// compiler reload its fields for every row.
template <int R>
__device__ __forceinline__ void update_leaf(const GangLeaf& leaf, const bool (&keep)[R],
                                            const int (&gid)[R], long long base,
                                            const long long* slots, unsigned char* acc) {
  const GangLeaf L = leaf;
  auto raw = [&](int r) -> long long {
    if (L.slot >= 0) {
      return slots[static_cast<size_t>(L.slot) * (R * kBlock) + r * kBlock + threadIdx.x];
    }
    return load_kind(L.col, L.kind, base + r * kBlock + threadIdx.x);
  };
  auto i64 = [&](int r) -> long long { return raw(r); };
  auto i32 = [&](int r) -> int { return static_cast<int>(raw(r)); };
  auto f64 = [&](int r) -> double {
    const long long v = raw(r);
    return L.kind == kF64 ? as_f(v) : static_cast<double>(v);
  };
  switch (L.op) {
    case L_COUNT:
      fold<CountOp, R>(L, keep, gid, acc, [](int) -> uint8_t { return 1; });
      break;
    case L_SUM_I64: fold<SumI64Op, R>(L, keep, gid, acc, i64); break;
    case L_SUM_F64: fold<SumFloatOp<double>, R>(L, keep, gid, acc, f64); break;
    case L_SUMSQ_F64:
      // the square rounds once before the add, as torch's v * v does
      fold<SumFloatOp<double>, R>(L, keep, gid, acc, [&](int r) -> double {
        const double x = f64(r);
        return __dmul_rn(x, x);
      });
      break;
    case L_MIN_I32: fold<PickIntOp<int, true>, R>(L, keep, gid, acc, i32); break;
    case L_MAX_I32: fold<PickIntOp<int, false>, R>(L, keep, gid, acc, i32); break;
    case L_MIN_I64: fold<PickIntOp<long long, true>, R>(L, keep, gid, acc, i64); break;
    case L_MAX_I64: fold<PickIntOp<long long, false>, R>(L, keep, gid, acc, i64); break;
    case L_MIN_F64: fold<PickF64Op<true>, R>(L, keep, gid, acc, f64); break;
    case L_MAX_F64: fold<PickF64Op<false>, R>(L, keep, gid, acc, f64); break;
    case L_HIST: fold_hist<R>(L, keep, gid, acc, f64); break;
    default: break;
  }
}

template <int R>
__global__ void __launch_bounds__(kBlock) gang_kernel(
    const GangMember* __restrict__ members, int n_members,
    const GangLeaf* __restrict__ leaves, int n_leaves, long long n, int depth, int outs) {
  extern __shared__ __align__(16) long long smem[];
  constexpr int T = R * kBlock;
  long long* stk = smem;
  long long* slots = smem + static_cast<size_t>(depth) * T;
  unsigned char* acc = reinterpret_cast<unsigned char*>(slots + static_cast<size_t>(outs) * T);
  for (int l = 0; l < n_leaves; ++l) dispatch<Init>(leaves[l].op, leaves[l], acc);
  __syncthreads();
  const long long tiles = (n + T - 1) / T;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long base = tile * T;
    for (int m = 0; m < n_members; ++m) {
      const GangMember& M = members[m];
      bool mask[R];
      int gid[R];
      SlotStore<R> store{M.chain, slots};
      run_tile<R>(M.chain, base, stk, mask, gid, store);
#pragma unroll
      for (int r = 0; r < R; ++r) mask[r] = mask[r] && base + r * kBlock + threadIdx.x < n;
      for (int l = M.leaf0; l < M.leaf0 + M.nleaf; ++l) {
        update_leaf<R>(leaves[l], mask, gid, base, slots, acc);
      }
    }
  }
  __syncthreads();
  for (int l = 0; l < n_leaves; ++l) dispatch<Flush>(leaves[l].op, leaves[l], acc);
}

template <int R>
int launch(const GangMember* members, int n_members, const GangLeaf* leaves, int n_leaves,
           long long n, int depth, int outs, int acc_bytes, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(depth + outs) * R * kBlock * 8 + acc_bytes;
  if (smem > 48 * 1024) {
    if (smem > static_cast<size_t>(px_smem_optin())) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        gang_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = px_grid(gang_kernel<R>, (n + R - 1) / R, kBlock, smem);
  gang_kernel<R><<<static_cast<unsigned>(grid), kBlock, smem, s>>>(
      members, n_members, leaves, n_leaves, n, depth, outs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// -------------------------------------------------------------- C interface

// sizeof(GangMember) (which = 0) or sizeof(GangLeaf) (which = 1), which the
// wrapper holds against its ctypes mirrors
extern "C" int px_gang_struct_size(int which) {
  return static_cast<int>(which == 0 ? sizeof(GangMember) : sizeof(GangLeaf));
}

// members / leaves: device arrays of n_members GangMember and n_leaves
// GangLeaf, one feed of n rows; depth: the deepest member's stack; outs: the
// most output slots of a member; acc_bytes: the shared accumulators (their
// offsets are in the leaves); rows_per_thread: R (4, 2 or 1).  Returns a
// cudaError_t (0 = launched).
extern "C" int px_gang_partial(const void* members, int n_members, const void* leaves,
                               int n_leaves, long long n, int depth, int outs, int acc_bytes,
                               int rows_per_thread, void* stream) {
  if (n <= 0 || n_members <= 0) return 0;
  const GangMember* m = static_cast<const GangMember*>(members);
  const GangLeaf* l = static_cast<const GangLeaf*>(leaves);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = depth < 1 ? 1 : depth;
  switch (rows_per_thread) {
    case 4: return launch<4>(m, n_members, l, n_leaves, n, d, outs, acc_bytes, s);
    case 2: return launch<2>(m, n_members, l, n_leaves, n, d, outs, acc_bytes, s);
    case 1: return launch<1>(m, n_members, l, n_leaves, n, d, outs, acc_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
