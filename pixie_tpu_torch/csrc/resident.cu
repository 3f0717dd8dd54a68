// R1, R2: the resident tier's device buffer moves.
//
// Replaces: pixie_tpu/engine/resident.py _kernels (:111): `fold`
// (lax.dynamic_update_slice of an ingest delta into a column's padded
// buffer), `grow` (jnp.pad to a larger power-of-two bucket) and `shift`
// (jnp.roll that moves the retained rows to the front after a retention
// trim).
//
//  R1 px_resident_fold: the delta of k columns has crossed the link as ONE
//     staging buffer (each column's d rows back to back, every column at a
//     16-byte-aligned offset); one launch copies each column's slice to rows
//     [off, off + d) of its buffer.
//  R2 px_resident_move: for each of k columns dst[0, n) = src[lo, lo + n) and
//     dst[n, dst_rows) = 0, in one launch.  Grow is lo = 0 into a larger
//     bucket (jnp.pad also zeroes the new tail).  Rebase is lo = dropped rows
//     into a fresh buffer of the same bucket: out of place, as jnp.roll
//     returns a new array, because an in-place forward move would race
//     between blocks.  jnp.roll leaves the wrapped head rows past `rows`;
//     R2 zeroes them instead.  Every consumer reads only [0, rows), so the
//     results are the same.
//
// Bound on the H100: bytes, nothing else.  R1 reads and writes each delta
// byte once: 2 * sum(d * w_i) / 3.35 TB/s (1M rows x 20 B: 12.5 us; the
// delta's H2D, ~20 MB over the link, is what a fold costs).  R2 reads n rows
// and writes the whole destination bucket: sum((n + dst_rows) * w_i) / 3.35
// TB/s.
//
// Design: one 2-D grid, blockIdx.y = column, blocks striding over the
// column's bytes.  Where source and destination are both 16-byte aligned
// the copy and the zero fill move 16 bytes a thread per step (uint4); the
// one chunk that straddles the end of the copied bytes, and any tail past
// the last whole chunk, go byte by byte.  Otherwise (an offset row that is
// not 16-byte aligned) threads move one element of the column's width
// (1, 2, 4 or 8 bytes).  Up to kMaxCols columns ride in one launch's
// parameters; more take one launch per kMaxCols.

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kMaxCols = 16;

struct Segments {
  const unsigned char* src[kMaxCols];
  unsigned char* dst[kMaxCols];
  long long copy_bytes[kMaxCols];   // bytes taken from src
  long long total_bytes[kMaxCols];  // bytes written at dst: the copy, then zeros
  int width[kMaxCols];
  int n;
};

template <typename T>
__device__ __forceinline__ void move_elems(const unsigned char* src, unsigned char* dst,
                                           long long copy, long long total, long long start,
                                           long long stride) {
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  const long long ce = copy / static_cast<long long>(sizeof(T));
  const long long te = total / static_cast<long long>(sizeof(T));
  for (long long e = start; e < te; e += stride) d[e] = e < ce ? s[e] : T(0);
}

__global__ void __launch_bounds__(kBlock) copy_pad(Segments seg) {
  const int c = blockIdx.y;
  const unsigned char* src = seg.src[c];
  unsigned char* dst = seg.dst[c];
  const long long copy = seg.copy_bytes[c];
  const long long total = seg.total_bytes[c];
  const long long start = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kBlock;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15u) == 0;
  if (vec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const long long chunks = total >> 4;  // whole 16-byte chunks at dst
    const long long full = copy >> 4;     // chunks copied whole
    for (long long v = start; v < chunks; v += stride) {
      if (v < full) {
        d[v] = s[v];
      } else if ((v << 4) >= copy) {
        d[v] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        for (int b = 0; b < 16; ++b) {
          const long long i = (v << 4) + b;
          dst[i] = i < copy ? src[i] : 0;
        }
      }
    }
    for (long long i = (chunks << 4) + start; i < total; i += stride) {
      dst[i] = i < copy ? src[i] : 0;
    }
    return;
  }
  switch (seg.width[c]) {
    case 1: move_elems<uint8_t>(src, dst, copy, total, start, stride); break;
    case 2: move_elems<uint16_t>(src, dst, copy, total, start, stride); break;
    case 4: move_elems<uint32_t>(src, dst, copy, total, start, stride); break;
    default: move_elems<unsigned long long>(src, dst, copy, total, start, stride); break;
  }
}

bool valid_width(int w) { return w == 1 || w == 2 || w == 4 || w == 8; }

// Launch copy_pad over seg (seg.n >= 1 columns); the grid covers the widest
// column once, capped at what the card keeps resident.
void launch(const Segments& seg, cudaStream_t s) {
  long long most = 1;
  for (int c = 0; c < seg.n; ++c) {
    const long long units = seg.total_bytes[c] / 16 + 16;
    if (units > most) most = units;
  }
  const long long grid = px_grid(copy_pad, most, kBlock, 0);
  copy_pad<<<dim3(static_cast<unsigned>(grid), static_cast<unsigned>(seg.n)), kBlock, 0, s>>>(
      seg);
}

}  // namespace

// -------------------------------------------------------------- C interface
// Every entry point returns a cudaError_t (0 = launched).  Element widths
// must be 1, 2, 4 or 8.

// R1.  dst: ncols device pointers, each column buffer holding at least
// off + d elements of width[c] bytes.  staging: one device buffer; column c's
// d elements start stage_off[c] bytes into it.
extern "C" int px_resident_fold(int ncols, void* const* dst, const int* width,
                                const void* staging, const long long* stage_off, long long d,
                                long long off, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 0 || off < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < ncols; ++c) {
    if (!valid_width(width[c])) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d == 0) return 0;
  const unsigned char* base = static_cast<const unsigned char*>(staging);
  for (int c0 = 0; c0 < ncols; c0 += kMaxCols) {
    Segments seg;
    seg.n = ncols - c0 < kMaxCols ? ncols - c0 : kMaxCols;
    for (int c = 0; c < seg.n; ++c) {
      const int w = width[c0 + c];
      seg.src[c] = base + stage_off[c0 + c];
      seg.dst[c] = static_cast<unsigned char*>(dst[c0 + c]) + off * w;
      seg.copy_bytes[c] = d * w;
      seg.total_bytes[c] = d * w;
      seg.width[c] = w;
    }
    launch(seg, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// R2.  src: ncols device pointers, each holding at least lo + n elements;
// dst: ncols device pointers to fresh buffers of dst_rows elements (n <=
// dst_rows), written in full.
extern "C" int px_resident_move(int ncols, const void* const* src, void* const* dst,
                                const int* width, long long lo, long long n, long long dst_rows,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lo < 0 || n < 0 || n > dst_rows) return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < ncols; ++c) {
    if (!valid_width(width[c])) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dst_rows == 0) return 0;
  for (int c0 = 0; c0 < ncols; c0 += kMaxCols) {
    Segments seg;
    seg.n = ncols - c0 < kMaxCols ? ncols - c0 : kMaxCols;
    for (int c = 0; c < seg.n; ++c) {
      const int w = width[c0 + c];
      seg.src[c] = static_cast<const unsigned char*>(src[c0 + c]) + lo * w;
      seg.dst[c] = static_cast<unsigned char*>(dst[c0 + c]);
      seg.copy_bytes[c] = n * w;
      seg.total_bytes[c] = dst_rows * w;
      seg.width[c] = w;
    }
    launch(seg, s);
  }
  return static_cast<int>(cudaGetLastError());
}
