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
// well under a microsecond, so the kernel is launch-bound there and the
// host's launch path is the cost to cut; at 2^16 groups with a [G, 514]
// float32 sketch it is ~0.37 ms for N = 8.
//
// Design: one launch for all leaves, and no host-to-device traffic of its
// own.  The descriptor table -- per leaf its op, dtype, vector flag, element
// count, output pointer and the N input pointers -- travels in the launch's
// parameter block as a `__grid_constant__` struct, templated on its capacity
// in words (64, 512 or kMaxWords) so a launch carries no larger a block than
// it needs.  The entry point copies the caller's host rows into it, so the
// caller's row buffer is free again when it returns; a table past kMaxWords
// is split by the caller (ops/merge.py) into launches of whole rows.  The
// output pointers are the leaves' offsets in one packed buffer (ops/pack.py
// Layout), all 16-byte aligned, and the padding after each leaf is written
// as zeros, so the buffer equals P1's pack of the merged tree byte for byte.
// blockIdx.y picks the leaf; every block of a leaf reads that row from the
// constant bank, and strides over the leaf's elements with the merge body of
// merge.cuh (coalesced, 16-byte loads where the leaf's pointers allow, up to
// 8 inputs' loads in flight), which F2 shares and which reads the input
// pointers through a `const long long*` -- here a pointer into the
// parameter block.

#include <string.h>

#include "common.cuh"
#include "merge.cuh"

namespace {

constexpr int kBlock = 256;

// descriptor: [flags, n, out, in_0 .. in_{N-1}] as int64, flags =
// op | dtype << 8 | vec << 16
constexpr int kHeader = 3;
// the largest table one launch carries, in int64 words (32,512 B of
// parameters beside n_states; the H100 takes up to 32,764 with CUDA 12.1
// and later).  ops/merge.py M1_WORDS holds the same capacities.
constexpr int kMaxWords = 4064;

template <int WORDS>
struct MergeTable {
  long long words[WORDS];
};

template <int WORDS>
__global__ void __launch_bounds__(kBlock)
    merge_states(const __grid_constant__ MergeTable<WORDS> table, int n_states) {
  const long long* d = table.words + static_cast<int>(blockIdx.y) * (kHeader + n_states);
  const int flags = static_cast<int>(d[0]);
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int dtype = (flags >> 8) & 0xff;
  unsigned char* out = reinterpret_cast<unsigned char*>(d[2]);
  px_merge::merge_any(dtype, flags & 0xff, out, d + kHeader, d[1], (flags >> 16) & 1, n_states,
                      tid, stride);
  // the bytes from the leaf's end to its next 16-byte offset are written as
  // zeros, as P1 writes them: the packed buffer is a function of the merged
  // leaves alone (the merge itself never touches them)
  if (blockIdx.x == 0) {
    const long long end = d[1] * (dtype == px_merge::kF64 || dtype == px_merge::kI64 ? 8 : 4);
    if (threadIdx.x < ((16 - (end & 15)) & 15)) out[end + threadIdx.x] = 0;
  }
}

template <int WORDS>
int launch(const long long* rows, int n_rows, int n_states, long long max_units,
           cudaStream_t stream) {
  MergeTable<WORDS> table;
  // words past the last row are never read: gridDim.y is n_rows
  memcpy(table.words, rows, sizeof(long long) * (kHeader + n_states) * n_rows);
  long long gx = (max_units + kBlock - 1) / kBlock;
  const long long cap = 8LL * px_sm_count();
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(n_rows));
  merge_states<WORDS><<<grid, kBlock, 0, stream>>>(table, n_states);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: n_rows host rows of (3 + n_states) int64, copied into the launch's
// parameter block before this returns; max_units: the most vector (or
// scalar) units of any of these leaves, which sizes blockIdx.x; device: the
// index of the card the pointers and `stream` are on.  Launches once on
// `stream`; returns the launch's CUDA error.
extern "C" int px_merge_states(const long long* rows, int n_rows, int n_states,
                               long long max_units, int device, cudaStream_t stream) {
  if (n_rows <= 0 || n_states <= 0) return 0;
  const long long words = static_cast<long long>(kHeader + n_states) * n_rows;
  if (n_rows > 65535 || words > kMaxWords) return static_cast<int>(cudaErrorInvalidValue);
  PxDeviceScope on(device);
  if (words <= 64) return launch<64>(rows, n_rows, n_states, max_units, stream);
  if (words <= 512) return launch<512>(rows, n_rows, n_states, max_units, stream);
  return launch<kMaxWords>(rows, n_rows, n_states, max_units, stream);
}
