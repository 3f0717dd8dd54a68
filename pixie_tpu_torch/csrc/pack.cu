// P1: the state packer — every leaf of a state tree into one byte buffer, so
// that the whole state reads back in one device-to-host copy.
//
// Replaces: pixie_tpu/engine/executor.py `_state_packer` (:912), whose jitted
// `pack` (:928-933) flattened the leaves and concatenated them per dtype,
// one buffer per dtype; the host `unpack` (:935-943) rebuilt the tree.  Here
// the layout is one uint8 buffer with every leaf at a 16-byte-aligned offset
// (ops/pack.py Layout); the bytes between a leaf's end and the next offset
// are written as zeros, so the buffer is a function of the leaves alone.
//
// Bound on the H100: bytes.  Each leaf is read once and the buffer written
// once: 2 x state bytes / 3.35 TB/s, ~0.02 ms for a 2^20-group state of
// count, f64 sum, count and seen (32 MB); bench config #4's 133,632 B state
// is launch-bound, so the host's launch path is the cost to cut there.
//
// Design: one launch per table of up to kMaxRows leaves, and no host-to-
// device traffic of its own.  A descriptor row per leaf (source pointer,
// byte count, destination pointer) travels in the launch's parameter block:
// the table is a `__grid_constant__` struct, templated on its capacity (8,
// 64 or kMaxRows rows) so a launch carries no larger a block than it needs;
// every block reads the row of its own blockIdx.y from the constant bank.
// The entry point copies the caller's host rows into that struct, so the
// caller's row buffer is free again when it returns.  The blocks of a leaf
// stride over its 16-byte words, each one uint4 load and one uint4 store
// where the source is 16-byte aligned; the word that holds the leaf's tail,
// and every word of a source that is not aligned, is assembled byte by byte.

#include <string.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
// descriptor: [src, nbytes, dst] as int64
constexpr int kRow = 3;
// the largest table one launch carries (24,576 B of parameters; the H100
// takes up to 32,764 with CUDA 12.1 and later).  ops/pack.py P1_CAPACITY
// splits a larger table into launches of at most this many rows.
constexpr int kMaxRows = 1024;

template <int CAP>
struct PackTable {
  long long rows[CAP * kRow];
};

template <int CAP>
__global__ void __launch_bounds__(kBlock) state_pack(const __grid_constant__ PackTable<CAP> table) {
  const long long* d = table.rows + static_cast<int>(blockIdx.y) * kRow;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(d[0]);
  const long long nbytes = d[1];
  uint4* dst = reinterpret_cast<uint4*>(d[2]);
  const long long words = (nbytes + 15) / 16;
  const long long full = (reinterpret_cast<uintptr_t>(src) & 15) ? 0 : nbytes / 16;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; w < words;
       w += stride) {
    if (w < full) {
      dst[w] = __ldg(reinterpret_cast<const uint4*>(src) + w);
      continue;
    }
    union {
      uint4 u;
      unsigned char b[16];
    } v;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const long long at = w * 16 + i;
      v.b[i] = at < nbytes ? src[at] : 0;
    }
    dst[w] = v.u;
  }
}

template <int CAP>
int launch(const long long* rows, int n_rows, long long max_words, cudaStream_t stream) {
  PackTable<CAP> table;
  // rows past n_rows are never read: gridDim.y is n_rows
  memcpy(table.rows, rows, sizeof(long long) * kRow * n_rows);
  long long gx = (max_words + kBlock - 1) / kBlock;
  const long long cap = 8LL * px_sm_count();
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(n_rows));
  state_pack<CAP><<<grid, kBlock, 0, stream>>>(table);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows: n_rows host rows of 3 int64 (src, nbytes, dst; every dst 16-byte
// aligned), copied into the launch's parameter block before this returns;
// max_words: the most 16-byte words of any of these leaves, which sizes
// blockIdx.x; device: the index of the card the pointers and `stream` are
// on.  Launches once on `stream`; returns the launch's CUDA error.
extern "C" int px_state_pack(const long long* rows, int n_rows, long long max_words,
                             int device, cudaStream_t stream) {
  if (n_rows <= 0) return 0;
  if (n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  PxDeviceScope on(device);
  if (n_rows <= 8) return launch<8>(rows, n_rows, max_words, stream);
  if (n_rows <= 64) return launch<64>(rows, n_rows, max_words, stream);
  return launch<kMaxRows>(rows, n_rows, max_words, stream);
}
