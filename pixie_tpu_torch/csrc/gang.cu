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
// Design: the gang pass of gang.cuh, one launch over the feed for every
// member.  The states are the members' own tensors, updated in place across
// feeds.

#include "gang.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(px_chain::kBlock) gang_kernel(
    const GangMember* __restrict__ members, int n_members,
    const GangLeaf* __restrict__ leaves, int n_leaves, long long n, int depth, int outs) {
  extern __shared__ __align__(16) long long smem[];
  gang_pass<R>(members, n_members, leaves, n_leaves, n, depth, outs, smem);
}

template <int R>
int launch(const GangMember* members, int n_members, const GangLeaf* leaves, int n_leaves,
           long long n, int depth, int outs, int acc_bytes, cudaStream_t s) {
  const size_t smem = gang_smem_bytes(R, depth, outs, acc_bytes);
  if (smem > 48 * 1024) {
    if (smem > static_cast<size_t>(px_smem_optin())) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(
        gang_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = px_grid(gang_kernel<R>, (n + R - 1) / R, px_chain::kBlock, smem);
  gang_kernel<R><<<static_cast<unsigned>(grid), px_chain::kBlock, smem, s>>>(
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
