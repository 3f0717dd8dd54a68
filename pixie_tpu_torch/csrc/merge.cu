// M1: the cross-agent merge of aggregate states, every leaf in one launch.
//
// Replaces: pixie_tpu/engine/executor.py ChainKernel.merge_states_fn (a
// jnp.stack of N states and one sum/min/max over axis 0 per leaf), which
// gang_merge_states jits for the agents of one LocalCluster query.  Given N
// states with the same tree, leaf j of the output is
//   out[j] = in_0[j] (op) in_1[j] (op) ... (op) in_{N-1}[j]
// in agent order 0..N-1, with the leaf's op "add", "min" or "max".  Integer
// adds wrap mod 2^width (done in the unsigned type).  min and max propagate
// NaN, as jnp.min / jnp.max do (fminf / fmaxf would drop it).
//
// Bound on the H100: bytes.  Each input element is read once and each output
// element written once: (N + 1) x state bytes / 3.35 TB/s.  At bench config
// #4's state (64 groups: count, mean, p50 sketch, seen; ~135 KB) that is
// well under a microsecond, so the kernel is launch-bound there; at 2^16
// groups with a [G, 514] float32 sketch it is ~0.37 ms for N = 8.
//
// Design: one launch for all leaves.  The host writes a descriptor table --
// per leaf its op, dtype, vector flag, element count, output pointer and the
// N input pointers -- and copies it to the device in one pinned non_blocking
// copy.  blockIdx.y picks the leaf; the blocks of a leaf stride over its
// elements with the merge body of merge.cuh (coalesced, 16-byte loads where
// the leaf's pointers allow, up to 8 inputs' loads in flight).

#include "common.cuh"
#include "merge.cuh"

namespace {

constexpr int kBlock = 256;

// descriptor: [flags, n, out, in_0 .. in_{N-1}] as int64, flags =
// op | dtype << 8 | vec << 16
constexpr int kHeader = 3;

__global__ void __launch_bounds__(kBlock) merge_states(const long long* __restrict__ desc,
                                                       int n_states) {
  const long long* d = desc + static_cast<long long>(blockIdx.y) * (kHeader + n_states);
  const int flags = static_cast<int>(d[0]);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  px_merge::merge_any((flags >> 8) & 0xff, flags & 0xff, reinterpret_cast<void*>(d[2]),
                      d + kHeader, d[1], (flags >> 16) & 1, n_states, tid, stride);
}

}  // namespace

// desc: the device descriptor table, n_leaves rows of (3 + n_states) int64;
// max_units: the most vector (or scalar) units of any leaf, which sizes
// blockIdx.x.  Launches once on `stream`; returns the launch's CUDA error.
extern "C" int px_merge_states(const long long* desc, int n_leaves, int n_states,
                               long long max_units, cudaStream_t stream) {
  if (n_leaves <= 0 || n_states <= 0) return 0;
  if (n_leaves > 65535) return static_cast<int>(cudaErrorInvalidValue);
  long long gx = (max_units + kBlock - 1) / kBlock;
  const long long cap = 8LL * px_sm_count();
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(n_leaves));
  merge_states<<<grid, kBlock, 0, stream>>>(desc, n_states);
  return static_cast<int>(cudaGetLastError());
}
