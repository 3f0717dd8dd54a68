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
// shared atomic per kept row and leaf (fewer where a warp combines its rows
// of one group, gang.cuh).
//
// Design: the gang pass of gang.cuh, one launch over the feed for every
// member, in blocks of 256 threads of R = 4 rows, 3 blocks a SM (fewer rows
// for a deeper program; 1024 threads of 2 rows, F1's layout, ran 0.07 ms
// slower here, and the warps' combine 0.37 ms slower, PERF.md row 16).  The
// states are the members' own tensors, updated in place across feeds.  The
// members and their leaves travel in the launch's parameter block, by
// value, and the blocks read them there: a
// `__grid_constant__` GangTable templated on its capacity (4 members and 64
// leaves, or kMaxMembers and kMaxLeaves), so a launch carries no larger a
// block than it needs.  The entry point copies the caller's host rows into
// it, so the caller's buffer is free again when it returns, and nothing is
// uploaded.
// A gang past the largest table is split by the wrapper (ops/gang.py) into
// launches of whole members on the same feed: exact, since members share no
// state.

#include <string.h>

#include "gang.cuh"

namespace {

// the largest table one launch carries: 16 x 1,408 B of members and 96 x
// 64 B of leaves, 28,672 B of parameters beside the scalars (the H100 takes
// up to 32,764 with CUDA 12.1 and later); a gang of at most 4 members and
// 64 leaves (the dashboard batches) takes a 9,728-byte table.  ops/gang.py
// G1_CAPACITY holds the largest.
constexpr int kMaxMembers = 16;
constexpr int kMaxLeaves = 96;

template <int M, int L>
struct GangTable {
  GangMember members[M];
  GangLeaf leaves[L];
};

// 3 blocks a SM: the register budget that keeps 24 warps resident
template <int R, int B, int M, int L>
__global__ void __launch_bounds__(B, 3)
    gang_kernel(const __grid_constant__ GangTable<M, L> table, int n_members, int n_leaves,
                long long n, int depth, int outs) {
  extern __shared__ __align__(16) long long smem[];
  gang_pass<R, B, false>(table.members, n_members, table.leaves, n_leaves, n, depth, outs, smem);
}

template <int R, int B, int M, int L>
int launch(const unsigned char* rows, int n_members, int n_leaves, long long n, int depth,
           int outs, int acc_bytes, cudaStream_t s) {
  GangTable<M, L> table;
  // entries past n_members / n_leaves are never read
  memcpy(table.members, rows, sizeof(GangMember) * n_members);
  memcpy(table.leaves, rows + sizeof(GangMember) * n_members, sizeof(GangLeaf) * n_leaves);
  const size_t smem = gang_smem_bytes(R, B, depth, outs, acc_bytes);
  if (smem > 48 * 1024) {
    if (smem > static_cast<size_t>(px_smem_optin())) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t e = cudaFuncSetAttribute(gang_kernel<R, B, M, L>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long grid = px_grid(gang_kernel<R, B, M, L>, (n + R - 1) / R, B, smem);
  gang_kernel<R, B, M, L><<<static_cast<unsigned>(grid), B, smem, s>>>(
      table, n_members, n_leaves, n, depth, outs);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int B>
int launch_cap(const unsigned char* rows, int n_members, int n_leaves, long long n, int depth,
               int outs, int acc_bytes, cudaStream_t s) {
  if (n_members <= 4 && n_leaves <= 64)
    return launch<R, B, 4, 64>(rows, n_members, n_leaves, n, depth, outs, acc_bytes, s);
  return launch<R, B, kMaxMembers, kMaxLeaves>(rows, n_members, n_leaves, n, depth, outs,
                                               acc_bytes, s);
}

}  // namespace

// -------------------------------------------------------------- C interface

// sizeof(GangMember) (which = 0) or sizeof(GangLeaf) (which = 1), which the
// wrapper holds against its ctypes mirrors
extern "C" int px_gang_struct_size(int which) {
  return static_cast<int>(which == 0 ? sizeof(GangMember) : sizeof(GangLeaf));
}

// rows: a host buffer of n_members GangMember and then n_leaves GangLeaf
// (the leaves' leaf0 index this buffer), copied into the launch's
// parameter block before this returns; one feed of n rows; depth: the
// deepest member's stack; outs: the most output slots of a member;
// acc_bytes: the shared accumulators (their offsets are in the leaves);
// rows_per_thread and threads: R and the block width, one of the pairs
// below (ops/gang.py plan_pass); device: the index of the card the
// pointers and `stream` are on.  Returns a cudaError_t (0 = launched).
extern "C" int px_gang_partial(const void* rows, int n_members, int n_leaves, long long n,
                               int depth, int outs, int acc_bytes, int rows_per_thread,
                               int threads, int device, void* stream) {
  if (n <= 0 || n_members <= 0) return 0;
  if (n_members > kMaxMembers || n_leaves > kMaxLeaves)
    return static_cast<int>(cudaErrorInvalidValue);
  PxDeviceScope on(device);
  const unsigned char* r = static_cast<const unsigned char*>(rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = depth < 1 ? 1 : depth;
#define PX_G1(R_, B_)                                    \
  if (rows_per_thread == R_ && threads == B_)            \
    return launch_cap<R_, B_>(r, n_members, n_leaves, n, d, outs, acc_bytes, s);
  PX_G1(4, 256)
  PX_G1(2, 256)
  PX_G1(1, 256)
#undef PX_G1
  return static_cast<int>(cudaErrorInvalidValue);
}
