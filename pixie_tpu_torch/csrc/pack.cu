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
// is launch-bound.
//
// Design: one launch.  A descriptor row per leaf (source pointer, byte
// count, destination pointer) reaches the device in one pinned non_blocking
// copy, as M1's does.  blockIdx.y picks the leaf; the blocks of a leaf stride
// over its 16-byte words, each one uint4 load and one uint4 store where the
// source is 16-byte aligned; the word that holds the leaf's tail, and every
// word of a source that is not aligned, is assembled byte by byte.

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
// descriptor: [src, nbytes, dst] as int64
constexpr int kRow = 3;

__global__ void __launch_bounds__(kBlock) state_pack(const long long* __restrict__ desc) {
  const long long* d = desc + static_cast<long long>(blockIdx.y) * kRow;
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

}  // namespace

// desc: the device descriptor table, n_leaves rows of 3 int64; max_words:
// the most 16-byte words of any leaf, which sizes blockIdx.x.  Every dst is
// 16-byte aligned.  Launches once on `stream`; returns the launch's CUDA
// error.
extern "C" int px_state_pack(const long long* desc, int n_leaves, long long max_words,
                             cudaStream_t stream) {
  if (n_leaves <= 0) return 0;
  if (n_leaves > 65535) return static_cast<int>(cudaErrorInvalidValue);
  long long gx = (max_words + kBlock - 1) / kBlock;
  const long long cap = 8LL * px_sm_count();
  if (gx > cap) gx = cap;
  if (gx < 1) gx = 1;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(n_leaves));
  state_pack<<<grid, kBlock, 0, stream>>>(desc);
  return static_cast<int>(cudaGetLastError());
}
