// F2 and F1: the device finalize of an aggregate, each in one launch.
//
// F2, px_merge_finalize, replaces pixie_tpu/engine/executor.py
// `_merge_finalize_fn` (:982-996): N >= 1 per-feed (here: per-shard, or the
// one in-place) states of one tree merged leaf by leaf (M1's merge), each
// UDA with a device finalize (the p50 / p99 / quantiles sketches) turned
// into its [G, nq] f64 quantiles (`_device_finalize_split`, :967-979), and
// the finals and the remaining merged leaves packed into one buffer (P1's
// layout, ops/pack.py), so one D2H copy returns everything the host
// finalize needs.  A table row per output leaf (finalize.cuh) — a merge row
// for a raw leaf, a quantile row for a finalized sketch — travels in the
// launch's parameter block, by value: a `__grid_constant__` table templated
// on its capacity in words (64, 512 or kMaxWords), as M1's (merge.cu); the
// quantiles and bin values it points to sit in a device buffer the wrapper
// uploads once per plan.  A table past kMaxWords is split by the wrapper
// into launches of whole rows: exact, since no row reads what another
// writes.  blockIdx.y picks the row; the blocks of a row stride over its
// elements or its groups.  No row reads what another writes (a quantile
// row merges the sketch's rows as it scans them), so F2 needs no grid
// barrier.
//
// Bound on the H100: bytes, (N x state + output) / 3.35 TB/s: launch-bound
// at bench config #1's 64-group state (133,632 B); ~0.32 ms for 8 states of
// 2^16 groups x 514 x 4 B (1.08 GB).
//
// F1, px_fused_partial_finalize, replaces `_fused_partial_finalize`
// (:1004-1022): one feed's whole aggregate — the chain (mask, filter, key
// codes, computed values), every UDA's update of a fresh identity state, and
// F2's finalize and pack — in one cooperative launch of three phases
// separated by cooperative_groups' grid.sync(), which orders every block's
// writes and atomics before the next phase's reads:
//   0. fill rows set every state leaf to its identity;
//   1. the gang pass of gang.cuh for one member (G1's): private shared
//      accumulators for the leaves the wrapper placed in the block's
//      shared memory, global atomics for the rest, flushed into the state;
//   2. quantile rows finalize the sketch leaves into the output.
// The member, its leaves and the rows travel by value in one
// `__grid_constant__` F1Table (kF1Leaves leaves, kF1Rows rows); an
// aggregate past it never reaches F1 (the executor's single-feed
// prediction declines it, engine/executor.py).  The raw leaves' states are
// views of the output buffer at their packed offsets, so phase 1 writes
// them in place and they need no pack row; the sketches that are finalized
// live in scratch past the output.
//
// The block width is the design's lever.  One block a SM may hold up to
// 227 KB of shared memory: bench config #1's whole state (count, mean, the
// 64 x 514 p50 sketch and seen: 132,864 B) then stays private beside the
// stack and slots, as K2 keeps the same sketch in one 1024-thread block a
// SM.  At 256 threads (G1's width) that block would have 8 warps to hide
// every load; the alternative is the sketch on global atomics, each kept
// row one float atomicAdd into a few thousand hot cells.  So a state kept
// whole runs 1024 threads of R = 2 rows (32 warps to hide the loads, the
// interpreter's cost a tile spread over 2 rows), or of 1 row, the first
// that fits (ops/gang.py plan_f1_pass; PERF.md row 7b compares the
// layouts).  A state that does not fit keeps its small leaves private and
// puts its sketches on global atomics, at 256 threads of 4 rows (of 1 for
// a program too deep for that): bench config #2's 1,024-group sketch
// (2.1 MB) is one.  A member of at most 64
// groups in a 1024-thread layout combines its warps' rows of one group
// before the shared atomic (gang.cuh, Combine): config #1's state ran 0.70
// ms with it and 0.78 without (PERF.md row 7b).
// The grid is the most blocks that are resident at once at the kernel's
// real dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// x SMs), as a cooperative launch requires; a launch that does not fit
// returns cudaErrorCooperativeLaunchTooLarge, which the wrapper raises.
//
// Bound on the H100: bytes.  At config #1's pruned feed (service int32,
// status and latency 8 B each: 20 B a row) 0.100 ms at 16M rows, 0.0063 ms
// at 1M rows.

#include <string.h>

#include <cooperative_groups.h>

#include "finalize.cuh"
#include "gang.cuh"

namespace cg = cooperative_groups;

namespace {

// F2's table capacities in int64 words (ops/finalize.py F2_WORDS)
constexpr int kMaxWords = 4064;
// F1's table: one member, its leaves and its fill and quantile rows (one
// source each: kRow + 1 words a row); ops/finalize.py F1_LEAVES, F1_ROWS
constexpr int kF1Leaves = 32;
constexpr int kF1Rows = 48;
constexpr int kF1RowWords = px_fin::kRow + 1;

template <int WORDS>
struct FinalizeTable {
  long long words[WORDS];
};

struct F1Table {
  GangMember member;
  GangLeaf leaves[kF1Leaves];
  long long rows[kF1Rows * kF1RowWords];
};

template <int WORDS>
__global__ void __launch_bounds__(px_fin::kThreads)
    merge_finalize_kernel(const __grid_constant__ FinalizeTable<WORDS> table, int n_states) {
  __shared__ float sh[px_fin::scratch_floats(px_fin::kThreads)];
  px_fin::run_row<px_fin::kThreads>(table.words, blockIdx.y, n_states, blockIdx.x, gridDim.x,
                                    sh);
}

template <int WORDS>
int launch_f2(const long long* rows, int n_rows, int n_states, long long max_blocks,
              cudaStream_t s) {
  FinalizeTable<WORDS> table;
  // words past the last row are never read: gridDim.y is n_rows
  memcpy(table.words, rows, sizeof(long long) * (px_fin::kRow + n_states) * n_rows);
  long long gx = max_blocks;
  const long long cap = 8LL * px_sm_count();
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  merge_finalize_kernel<WORDS><<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(n_rows)),
                                 px_fin::kThreads, 0, s>>>(table, n_states);
  return static_cast<int>(cudaGetLastError());
}

// (256-thread blocks: 3 a SM, as G1's; wider blocks: one a SM)
template <int R, int B, bool Combine>
__global__ void __launch_bounds__(B, B == px_chain::kBlock ? 3 : 1)
    fused_kernel(const __grid_constant__ F1Table table, int n_leaves, long long n, int depth,
                 int outs, int n_fill, int n_rows) {
  extern __shared__ __align__(16) long long smem[];
  cg::grid_group grid = cg::this_grid();
  for (int r = 0; r < n_fill; ++r) {
    px_fin::run_row<B>(table.rows, r, 1, blockIdx.x, gridDim.x, nullptr);
  }
  grid.sync();
  gang_pass<R, B, Combine>(&table.member, 1, table.leaves, n_leaves, n, depth, outs, smem);
  grid.sync();
  for (int r = n_fill; r < n_rows; ++r) {
    px_fin::run_row<B>(table.rows, r, 1, blockIdx.x, gridDim.x, reinterpret_cast<float*>(smem));
  }
}

template <int R, int B, bool Combine>
int launch_fused(const unsigned char* rows, int n_leaves, long long n, int depth, int outs,
                 int acc_bytes, int n_fill, int n_rows, cudaStream_t s) {
  F1Table table;
  memcpy(&table.member, rows, sizeof(GangMember));
  const unsigned char* at = rows + sizeof(GangMember);
  memcpy(table.leaves, at, sizeof(GangLeaf) * n_leaves);
  at += sizeof(GangLeaf) * n_leaves;
  memcpy(table.rows, at, sizeof(long long) * kF1RowWords * n_rows);
  size_t smem = gang_smem_bytes(R, B, depth, outs, acc_bytes);
  const size_t fin = px_fin::scratch_floats(B) * sizeof(float);
  if (smem < fin) smem = fin;
  if (smem > static_cast<size_t>(px_smem_optin())) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fused_kernel<R, B, Combine>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel<R, B, Combine>, B,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const dim3 grid(static_cast<unsigned>(per_sm * px_sm_count()));
  void* args[] = {&table, &n_leaves, &n, &depth, &outs, &n_fill, &n_rows};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&fused_kernel<R, B, Combine>),
                                  grid, dim3(B), args, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// -------------------------------------------------------------- C interface

// rows: n_rows host rows of 6 + n_states int64 (finalize.cuh), copied into
// the launch's parameter block before this returns (at most kMaxWords
// words); max_blocks: the most blocks any row can use (a merge row's
// 16-byte units / 256, a quantile row's groups), capped at 8 per SM;
// device: the index of the card the pointers and `stream` are on.  Returns
// a cudaError_t (0 = launched).
extern "C" int px_merge_finalize(const long long* rows, int n_rows, int n_states,
                                 long long max_blocks, int device, void* stream) {
  if (n_rows <= 0 || n_states <= 0) return 0;
  const long long words = static_cast<long long>(px_fin::kRow + n_states) * n_rows;
  if (n_rows > 65535 || words > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  PxDeviceScope on(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (words <= 64) return launch_f2<64>(rows, n_rows, n_states, max_blocks, s);
  if (words <= 512) return launch_f2<512>(rows, n_rows, n_states, max_blocks, s);
  return launch_f2<kMaxWords>(rows, n_rows, n_states, max_blocks, s);
}

// rows: a host buffer of one GangMember, its n_leaves GangLeaf (leaf0 0)
// and n_rows finalize rows of kRow + 1 int64 (rows [0, n_fill) fill the
// states, rows [n_fill, n_rows) finalize), copied into the launch's
// parameter block before this returns; one feed of n rows; depth, outs,
// acc_bytes and rows_per_thread as px_gang_partial takes them; threads: the
// block width and combine: fold a warp's rows of one group before the
// shared atomic (R, width and combine one of the layouts below,
// ops/gang.py plan_f1_pass); device: the index of
// the card the pointers and `stream` are on.  Launches once, cooperatively, even for
// n = 0 (the identity state is finalized).  Returns a cudaError_t (0 =
// launched).
extern "C" int px_fused_partial_finalize(const void* rows, int n_leaves, long long n, int depth,
                                         int outs, int acc_bytes, int rows_per_thread,
                                         int threads, int combine, int n_fill, int n_rows,
                                         int device, void* stream) {
  if (n < 0 || n_rows < n_fill || n_leaves > kF1Leaves || n_rows > kF1Rows)
    return static_cast<int>(cudaErrorInvalidValue);
  PxDeviceScope on(device);
  const unsigned char* r = static_cast<const unsigned char*>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = depth < 1 ? 1 : depth;
  // the layouts of ops/gang.py plan_f1_pass
#define PX_F1(R_, B_, C_)                                                              \
  if (rows_per_thread == R_ && threads == B_ && (combine != 0) == C_)                  \
    return launch_fused<R_, B_, C_>(r, n_leaves, n, d, outs, acc_bytes, n_fill, n_rows, s);
  PX_F1(2, 1024, true)
  PX_F1(2, 1024, false)
  PX_F1(1, 1024, true)
  PX_F1(1, 1024, false)
  PX_F1(4, 256, false)
  PX_F1(1, 256, false)
#undef PX_F1
  return static_cast<int>(cudaErrorInvalidValue);
}
