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
// for a raw leaf, a quantile row for a finalized sketch — reaches the device
// in one pinned copy with the quantiles and the bin-value tables.
// blockIdx.y picks the row; the blocks of a row stride over its elements or
// its groups.  No row reads what another writes (a quantile row merges the
// sketch's rows as it scans them), so F2 needs no grid barrier.
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
//   1. the gang pass of gang.cuh for one member (G1's, unchanged): private
//      shared accumulators where the state fits the block's budget, else
//      global atomics, flushed into the state;
//   2. quantile rows finalize the sketch leaves into the output.
// The raw leaves' states are views of the output buffer at their packed
// offsets, so phase 1 writes them in place and they need no pack row; the
// sketches that are finalized live in scratch past the output.  The grid is
// the most blocks that are resident at once at the kernel's real dynamic
// shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), as a
// cooperative launch requires; a launch that does not fit returns
// cudaErrorCooperativeLaunchTooLarge, which the wrapper raises.
//
// Bound on the H100: bytes.  At config #1's pruned feed (service int32,
// status and latency 8 B each: 20 B a row) 0.100 ms at 16M rows, 0.0063 ms
// at 1M rows.

#include <cooperative_groups.h>

#include "finalize.cuh"
#include "gang.cuh"

namespace cg = cooperative_groups;

namespace {

__global__ void __launch_bounds__(px_fin::kThreads)
    merge_finalize_kernel(const long long* __restrict__ table, int n_states) {
  __shared__ float sh[px_fin::kScratchFloats];
  px_fin::run_row(table, blockIdx.y, n_states, blockIdx.x, gridDim.x, sh);
}

template <int R>
__global__ void __launch_bounds__(px_chain::kBlock)
    fused_kernel(const GangMember* __restrict__ member, const GangLeaf* __restrict__ leaves,
                 int n_leaves, long long n, int depth, int outs, const long long* table,
                 int n_fill, int n_rows) {
  extern __shared__ __align__(16) long long smem[];
  cg::grid_group grid = cg::this_grid();
  for (int r = 0; r < n_fill; ++r) px_fin::run_row(table, r, 1, blockIdx.x, gridDim.x, nullptr);
  grid.sync();
  gang_pass<R>(member, 1, leaves, n_leaves, n, depth, outs, smem);
  grid.sync();
  for (int r = n_fill; r < n_rows; ++r) {
    px_fin::run_row(table, r, 1, blockIdx.x, gridDim.x, reinterpret_cast<float*>(smem));
  }
}

template <int R>
int launch_fused(const GangMember* member, const GangLeaf* leaves, int n_leaves, long long n,
                 int depth, int outs, int acc_bytes, const long long* table, int n_fill,
                 int n_rows, cudaStream_t s) {
  size_t smem = gang_smem_bytes(R, depth, outs, acc_bytes);
  const size_t fin = px_fin::kScratchFloats * sizeof(float);
  if (smem < fin) smem = fin;
  if (smem > static_cast<size_t>(px_smem_optin())) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(fused_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_kernel<R>, px_chain::kBlock,
                                                    smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const dim3 grid(static_cast<unsigned>(per_sm * px_sm_count()));
  void* args[] = {&member, &leaves, &n_leaves, &n, &depth, &outs, &table, &n_fill, &n_rows};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&fused_kernel<R>), grid,
                                  dim3(px_chain::kBlock), args, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// -------------------------------------------------------------- C interface

// table: the device row table (n_rows rows of 6 + n_states int64, then the
// quantiles and bin values the quantile rows index); max_blocks: the most
// blocks any row can use (a merge row's 16-byte units / 256, a quantile
// row's groups), capped at 8 per SM.  Returns a cudaError_t (0 = launched).
extern "C" int px_merge_finalize(const long long* table, int n_rows, int n_states,
                                 long long max_blocks, void* stream) {
  if (n_rows <= 0 || n_states <= 0) return 0;
  if (n_rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  long long gx = max_blocks;
  const long long cap = 8LL * px_sm_count();
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  merge_finalize_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(n_rows)),
                          px_fin::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(table,
                                                                                    n_states);
  return static_cast<int>(cudaGetLastError());
}

// member / leaves: one GangMember and its n_leaves GangLeaf (ops/gang.py's
// encoding) over one feed of n rows; depth, outs, acc_bytes and
// rows_per_thread (R: 4, 2 or 1) as px_gang_partial takes them; table: rows
// [0, n_fill) fill the states, rows [n_fill, n_rows) finalize (one source
// each).  Launches once, cooperatively, even for n = 0 (the identity state
// is finalized).  Returns a cudaError_t (0 = launched).
extern "C" int px_fused_partial_finalize(const void* member, const void* leaves, int n_leaves,
                                         long long n, int depth, int outs, int acc_bytes,
                                         int rows_per_thread, const long long* table,
                                         int n_fill, int n_rows, void* stream) {
  if (n < 0 || n_rows < n_fill) return static_cast<int>(cudaErrorInvalidValue);
  const GangMember* m = static_cast<const GangMember*>(member);
  const GangLeaf* l = static_cast<const GangLeaf*>(leaves);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = depth < 1 ? 1 : depth;
  switch (rows_per_thread) {
    case 4: return launch_fused<4>(m, l, n_leaves, n, d, outs, acc_bytes, table, n_fill, n_rows, s);
    case 2: return launch_fused<2>(m, l, n_leaves, n, d, outs, acc_bytes, table, n_fill, n_rows, s);
    case 1: return launch_fused<1>(m, l, n_leaves, n, d, outs, acc_bytes, table, n_fill, n_rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
