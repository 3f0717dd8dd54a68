// The multi-query gang's member pass, shared by kernel G1 (gang.cu) and the
// fused single-feed partial + finalize F1 (finalize.cu).
//
// A block of B threads walks tiles of R x B rows with a grid stride, as C1
// does.  For each tile, every member's program runs in turn over the same
// rows through C1's interpreter (`px_chain::run_tile`, chain.cuh), so the
// second member's column loads hit L1 or L2 rather than HBM.  Nothing per
// row reaches device memory: the mask and the group ids stay in registers,
// and a program's STORE writes a tile slot in shared memory, not an output
// column.  Right after each member's program the block folds that member's
// kept rows into its state leaves with the per-row operations of K1
// (segment_ops.cuh) and K2's bin (loghist.cuh): count into int64, sums into
// int64 (wrapping) or f64, the f64 sum of squares, min and max over int32,
// int64 and f64 (NaN wins), the sketch's cell count into f32.  Each leaf
// whose state the wrapper placed in the block's budget (ops/gang.py
// `plan_pass`) keeps private accumulators in shared memory, flushed with one
// atomic per group at the end as K1 and K2 flush theirs; a leaf that does
// not fit adds every row into its state with global atomics.
//
// The members and their leaves arrive in the launch's parameter space (a
// `__grid_constant__` table, gang.cu and finalize.cu), so nothing of the
// table is uploaded, and the blocks read them there.
//
// Few groups, one address: with `Combine` (a template flag: F1 sets it for
// a member of at most a few dozen groups, ops/gang.py plan_f1_pass; G1
// never, where it cost more than it saved) the rows of one warp that share
// a group fold before the shared atomic.  `__match_any_sync` on the group
// id gives each lane its peers; a count adds their number (a popcount), the other
// ops combine the peers' values in log2(32) shuffle rounds; one lane per
// distinct group issues the atomic.  K1 instead keeps up to 8 per-warp
// replicas of the accumulators: those spread the warps of a block over
// addresses but leave the lanes of one warp on one address (32 lanes into 3
// to 64 groups), and they multiply the shared memory that F1 needs for its
// sketch.  Counts, int64 sums, min and max stay exact; an f64 sum changes
// only its order, as the atomics' order already varies.  The sketch's
// cells (a group times ~100 active bins) rarely share an address within a
// warp and are not combined.
//
// Shared memory: the deepest member's stack under the top the interpreter
// keeps in registers, and the widest member's output slots
// (each R x B values of 8 B), then the private accumulators.  A
// thread touches only its own rows' stack and slots, so the only barriers
// are after the accumulators' initialisation and before their flush.
#pragma once

#include <type_traits>

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
  int nan_bin;      // sketch: the bin of a NaN value (loghist.cuh)
  int pad;
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

// STORE: the thread's values into tile slot `a` in shared memory, in its
// kind.
template <int R, int B>
struct SlotStore {
  const ChainParams& p;
  long long* slots;
  __device__ __forceinline__ void operator()(int a, const long long (&v)[R], long long) const {
    const int kind = p.out_kind[a];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      slots[static_cast<size_t>(a) * (R * B) + r * B + threadIdx.x] = as_kind(kind, v[r]);
    }
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

// x combined over the lane's peers (the lanes of its warp whose rows share
// its key, `peers` from __match_any_sync), complete at the lowest lane of
// the peers.  Every lane of the warp calls it.  A tree over each lane's
// rank among its peers: in round k a lane adds the next remaining peer's
// partial, and the lanes whose rank has bit k set drop out.
template <class Op>
__device__ __forceinline__ typename Op::Acc combine_peers(unsigned peers, typename Op::Acc x) {
  const unsigned lane = threadIdx.x & 31u;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above);
    const typename Op::Acc t = __shfl_sync(0xffffffffu, x, (next - 1) & 31);
    if (next) x = Op::combine(x, t);
    above &= ~__ballot_sync(0xffffffffu, rank & 1u);
    rank >>= 1;
  }
  return x;
}

// Folds each kept row r (keep[r], gid[r] in [0, groups)) of value(r) into
// the leaf: its private accumulators, or the state with global atomics.
// All R values are loaded before the first atomic, so their loads overlap.
// With Combine, peers[r] holds row r's peers (gang_pass) and one lane per
// distinct group adds the combined value.
template <class Op, int R, bool Combine, class Value>
__device__ __forceinline__ void fold(const GangLeaf& L, const bool (&keep)[R],
                                     const int (&gid)[R], const unsigned (&peers)[R],
                                     unsigned char* acc, Value value) {
  typename Op::Acc x[R];
  bool in[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    in[r] = keep[r] && static_cast<unsigned>(gid[r]) < static_cast<unsigned>(L.groups);
    x[r] = in[r] ? Op::of(value(r)) : Op::identity();
  }
  if (L.shared_off >= 0) {
    typename Op::Acc* sh = reinterpret_cast<typename Op::Acc*>(acc + L.shared_off);
    if constexpr (Combine) {
      const unsigned below = (1u << (threadIdx.x & 31u)) - 1u;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        typename Op::Acc v;
        if constexpr (std::is_same<Op, CountOp>::value) {
          v = __popc(peers[r]);
        } else {
          v = combine_peers<Op>(peers[r], x[r]);
        }
        if (in[r] && (peers[r] & below) == 0u) Op::shared_add(sh + gid[r], v);
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (in[r]) Op::shared_add(sh + gid[r], x[r]);
      }
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
                          px_bin(value(r), L.log_gamma, L.min_f, L.min_d, L.width, L.nan_bin)
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
template <int R, int B, bool Combine>
__device__ __forceinline__ void update_leaf(const GangLeaf& leaf, const bool (&keep)[R],
                                            const int (&gid)[R], const unsigned (&peers)[R],
                                            long long base, long long n, const long long* slots,
                                            unsigned char* acc) {
  const GangLeaf L = leaf;
  // the value of each of the thread's rows: an output slot, or the feed
  // column's rows loaded wide (chain.cuh load_rows)
  long long vals[R];
  if (L.op != L_COUNT) {
    if (L.slot >= 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        vals[r] = slots[static_cast<size_t>(L.slot) * (R * B) + r * B + threadIdx.x];
      }
    } else {
      load_rows<R, B>(L.col, L.kind, base, n, vals);
    }
  }
  auto raw = [&](int r) -> long long { return vals[r]; };
  auto i64 = [&](int r) -> long long { return raw(r); };
  auto i32 = [&](int r) -> int { return static_cast<int>(raw(r)); };
  auto f64 = [&](int r) -> double {
    const long long v = raw(r);
    return L.kind == kF64 ? as_f(v) : static_cast<double>(v);
  };
  switch (L.op) {
    case L_COUNT:
      fold<CountOp, R, Combine>(L, keep, gid, peers, acc, [](int) -> uint8_t { return 1; });
      break;
    case L_SUM_I64: fold<SumI64Op, R, Combine>(L, keep, gid, peers, acc, i64); break;
    case L_SUM_F64: fold<SumFloatOp<double>, R, Combine>(L, keep, gid, peers, acc, f64); break;
    case L_SUMSQ_F64:
      // the square rounds once before the add, as torch's v * v does
      fold<SumFloatOp<double>, R, Combine>(L, keep, gid, peers, acc, [&](int r) -> double {
        const double x = f64(r);
        return __dmul_rn(x, x);
      });
      break;
    case L_MIN_I32:
      fold<PickIntOp<int, true>, R, Combine>(L, keep, gid, peers, acc, i32);
      break;
    case L_MAX_I32:
      fold<PickIntOp<int, false>, R, Combine>(L, keep, gid, peers, acc, i32);
      break;
    case L_MIN_I64:
      fold<PickIntOp<long long, true>, R, Combine>(L, keep, gid, peers, acc, i64);
      break;
    case L_MAX_I64:
      fold<PickIntOp<long long, false>, R, Combine>(L, keep, gid, peers, acc, i64);
      break;
    case L_MIN_F64: fold<PickF64Op<true>, R, Combine>(L, keep, gid, peers, acc, f64); break;
    case L_MAX_F64: fold<PickF64Op<false>, R, Combine>(L, keep, gid, peers, acc, f64); break;
    case L_HIST: fold_hist<R>(L, keep, gid, acc, f64); break;
    default: break;
  }
}

// The columns a member's program holds in registers (chain.cuh CACHE): the
// pass's launch bounds leave 80 registers a thread at 4 rows (G1) and 64 at
// 1024 threads (F1), which the leaves' folds need beside the interpreter.
template <int R>
constexpr int kGangLocals = R >= 4 ? 0 : 2 / R;

// One block's share of the gang pass over a feed of n rows.  The members
// and leaves are read where the launch put them, in its parameter space:
// the interpreter reads a member's fields at a warp-uniform index, and
// run_tile holds the ones its loop needs in registers.  (Each block
// copying the table into its shared memory first ran 0.005 ms slower on
// the four dashboard members, ab_gang.py, PERF.md row 16.)  The private
// accumulators of every leaf that has them are set to the identity, the
// block walks its tiles (grid stride) running each member's program and
// folding its kept rows, and flushes the accumulators into the states.
// smem: the block's dynamic shared memory, gang_smem_bytes(R, B, ...)
// bytes: the stack, the slots, the accumulators.
template <int R, int B, bool Combine>
__device__ __forceinline__ void gang_pass(const GangMember* __restrict__ members, int n_members,
                                          const GangLeaf* __restrict__ leaves, int n_leaves,
                                          long long n, int depth, int outs, long long* smem) {
  constexpr int T = R * B;
  long long* stk = smem;
  long long* slots = stk + static_cast<size_t>(shared_slots(depth)) * T;
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
      unsigned peers[R];
      SlotStore<R, B> store{M.chain, slots};
      run_tile<R, B, kGangLocals<R>>(M.chain, base, stk, mask, gid, store);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        mask[r] = mask[r] && base + Rows<R, B>::at(r) < n;
        peers[r] = 0u;
        // every lane of the warp takes part; a row that is not kept has key -1
        if constexpr (Combine) {
          const bool in =
              mask[r] && static_cast<unsigned>(gid[r]) < static_cast<unsigned>(M.groups);
          peers[r] = __match_any_sync(0xffffffffu, in ? gid[r] : -1);
        }
      }
      const int l0 = M.leaf0, l1 = M.leaf0 + M.nleaf;
      for (int l = l0; l < l1; ++l) {
        update_leaf<R, B, Combine>(leaves[l], mask, gid, peers, base, n, slots, acc);
      }
    }
  }
  __syncthreads();
  for (int l = 0; l < n_leaves; ++l) dispatch<Flush>(leaves[l].op, leaves[l], acc);
}

// Dynamic shared memory of gang_pass: the deepest member's stack past its
// registers (shared_slots) and the widest member's output slots (R x B
// values of 8 B each), then the private accumulators (ops/gang.py
// PassPlan.smem).
__host__ __device__ inline size_t gang_smem_bytes(int R, int B, int depth, int outs,
                                                  int acc_bytes) {
  return static_cast<size_t>(shared_slots(depth) + outs) * R * B * 8 + acc_bytes;
}

}  // namespace
