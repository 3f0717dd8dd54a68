// K4: stable front-compaction of a feed's output columns by a row mask.
//
// Replaces: pixie_tpu/engine/executor.py ChainKernel.make_output_step (the
// stable argsort of the negated mask and one take per output column).  The
// sort exists because XLA wants static shapes; on Hopper the same function is
// a stream compaction, and there is no sort.
//
// Bound on the H100: bytes.  The mask is read once (1 B/row), each selected
// row of each column is read and written once, so at 16M rows, 4 columns of
// 4 + 8 + 8 + 1 B and 90% kept: 16.8 MB + 2 x 317 MB = 651 MB / 3.35 TB/s
// = 0.19 ms.  At 10% kept the reads of the kept rows touch whole 32-byte
// sectors: about 57% of an int32 column's sectors, 34% of an 8-byte
// column's and all of a bool column's, so 159 MB read and 35 MB written, a
// sector-level floor of about 0.06 ms where the word-level bound is 0.026.
// There is no arithmetic to speak of.
//
// Design: a counting sort of two targets of which only the kept run is
// written, tiles of kTile rows, every column in one launch, in one C call
// of three launches.
//  1. count: one block a tile counts its kept rows, each thread 16 mask
//     bytes in one 16-byte load;
//  2. scan: one block turns the few thousand tile counts into each tile's
//     output offset and writes the total (the count, which stays on the
//     device);
//  3. compact: one 512-thread block a tile.  Each thread reads its kItems
//     consecutive mask bytes in one 8-byte load and counts its kept rows;
//     one scan of the threads' counts (scan.cuh block_excl_scan) gives each
//     thread its first rank in the tile, and the thread writes the tile
//     rows of its kept rows at their ranks: the tile's compacted index list
//     in shared memory.  Then each column's kept rows go to one contiguous
//     run at the tile's offset, neighbouring threads on neighbouring output
//     rows, in one of two ways chosen per tile by its density.  A sparse
//     tile (under half kept) gathers each kept row through the index list
//     from device memory, kUnroll reads of a thread in flight, so only the
//     sectors that hold kept rows are read.  A dense tile copies each
//     column's tile into shared memory by 16-byte cp.async and reads the
//     kept rows from there.  Column 0's first reads go out before the
//     tile's offset is read.
// The mask is read twice.  A decoupled look-back (single-pass scan: each
// tile publishes its count in a status word, then one warp sums the counts
// of the tiles before it back to the nearest published prefix) reads it
// once and makes it one launch after a memset, but its latency sits in
// every block's life, and it lost to the three launches at every density
// (ab_kernels.py k4_look_back, which keeps it).
// Up to kMaxCols columns of 1, 2, 4 or 8 bytes move in one launch (their
// pointers and widths ride in the launch's parameters); more columns take
// one more launch per kMaxCols, which reads the same tile offsets.  Kept
// rows come out in input order, so the result equals the reference's
// stable partition row for row and does not vary between runs.
// Alternatives (ab_kernels.py): every tile gathered
// (k4_gather_only) or staged (k4_staged_only), or staged from a quarter of
// its rows kept (k4_dense4).

#include "common.cuh"
#include "scan.cuh"

namespace {

constexpr int kBlock = 512;
constexpr int kItems = 8;                  // rows a thread: one 8-byte mask load
constexpr int kTile = kBlock * kItems;     // 4096 rows a block
constexpr int kMaxCols = 16;
constexpr int kStageBytes = kTile * 8;     // one staged column tile
constexpr int kUnroll = 4;                 // gathered reads of a thread in flight
// A tile whose kept rows reach kDense sixteenths of its rows is staged,
// sparser tiles are gathered.
constexpr int kDense = 8;

struct Columns {
  const void* src[kMaxCols];
  void* dst[kMaxCols];
  int width[kMaxCols];
  int n;
};

// partial[b] = the kept rows of tile b: 256 threads, each reading 16 mask
// bytes in one 16-byte load (row by row past the end or off alignment).
constexpr int kCountBlock = kTile / 16;

__global__ void __launch_bounds__(kCountBlock) tile_counts(const uint8_t* __restrict__ mask,
                                                           long long n,
                                                           long long* __restrict__ partial) {
  __shared__ int warp_counts[kCountBlock / 32];
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const long long i0 = base + threadIdx.x * 16;
  int c = 0;
  if (i0 + 16 <= n && (reinterpret_cast<uintptr_t>(mask) & 15) == 0) {
    const uint4 m = __ldcs(reinterpret_cast<const uint4*>(mask + i0));
    c = __popc(__vcmpne4(m.x, 0u) & 0x01010101u) + __popc(__vcmpne4(m.y, 0u) & 0x01010101u) +
        __popc(__vcmpne4(m.z, 0u) & 0x01010101u) + __popc(__vcmpne4(m.w, 0u) & 0x01010101u);
  } else {
    for (int r = 0; r < 16; ++r) c += i0 + r < n && mask[i0 + r] != 0;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kCountBlock / 32; ++w) total += warp_counts[w];
    partial[blockIdx.x] = total;
  }
}

// Gathered: the kept rows j0 + u * kBlock (u < kUnroll, below kept) of a
// column tile read through the index list into x, all in flight together;
// then written to the column's kept run.
template <typename T>
__device__ __forceinline__ void gather_round(const T* __restrict__ src, const unsigned short* sidx,
                                             int kept, int j0, unsigned long long (&x)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = j0 + u * kBlock;
    if (j < kept) x[u] = static_cast<unsigned long long>(__ldg(src + sidx[j]));
  }
}

template <typename T>
__device__ __forceinline__ void put_round(T* __restrict__ dst, int kept, int j0,
                                          const unsigned long long (&x)[kUnroll]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int j = j0 + u * kBlock;
    if (j < kept) dst[j] = static_cast<T>(x[u]);
  }
}

// A column's kept rows gathered from device memory; its first round already
// in x when `first_read`.
template <typename T>
__device__ __forceinline__ void gather_column(const T* __restrict__ src, T* __restrict__ dst,
                                              const unsigned short* sidx, int kept,
                                              bool first_read, unsigned long long (&x)[kUnroll]) {
  for (int j0 = threadIdx.x; j0 < kept; j0 += kUnroll * kBlock) {
    if (!(first_read && j0 == static_cast<int>(threadIdx.x))) gather_round(src, sidx, kept, j0, x);
    put_round(dst, kept, j0, x);
  }
}

// A column's kept rows from its tile staged in shared memory.
template <typename T>
__device__ __forceinline__ void write_staged(const T* buf, T* __restrict__ dst,
                                             const unsigned short* sidx, int kept) {
  for (int j = threadIdx.x; j < kept; j += kBlock) dst[j] = buf[sidx[j]];
}

// Rows [0, rows) of a column tile (width-byte elements from g) into buf:
// 16-byte cp.async where g is 16-byte aligned, else element by element;
// committed as one group, which the caller waits for.
__device__ __forceinline__ void stage_column(const unsigned char* g, int width, int rows,
                                             unsigned char* buf) {
  const int bytes = rows * width;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int nv = bytes >> 4;
    for (int v = threadIdx.x; v < nv; v += kBlock) cp_async16(buf + 16 * v, g + 16 * v);
    done = nv << 4;
  }
  for (int b = done + threadIdx.x * width; b < bytes; b += kBlock * width) {
    for (int k = 0; k < width; ++k) buf[b + k] = g[b + k];
  }
  cp_async_commit();
}

// Column c's kept rows of the tile at row `base` to its run at row `off`:
// gathered (the first round already in x when `first_read`) or from `buf`.
__device__ __forceinline__ void write_kept(const Columns& cols, int c, long long base,
                                           long long off, const unsigned short* sidx, int kept,
                                           bool staged, const unsigned char* buf,
                                           bool first_read, unsigned long long (&x)[kUnroll]) {
  const int w = cols.width[c];
  const unsigned char* src = static_cast<const unsigned char*>(cols.src[c]) + base * w;
  unsigned char* dst = static_cast<unsigned char*>(cols.dst[c]) + off * w;
  switch (w) {
    case 8: {
      using T = unsigned long long;
      if (staged) write_staged(reinterpret_cast<const T*>(buf), reinterpret_cast<T*>(dst), sidx, kept);
      else gather_column(reinterpret_cast<const T*>(src), reinterpret_cast<T*>(dst), sidx, kept,
                         first_read, x);
      break;
    }
    case 4: {
      using T = unsigned;
      if (staged) write_staged(reinterpret_cast<const T*>(buf), reinterpret_cast<T*>(dst), sidx, kept);
      else gather_column(reinterpret_cast<const T*>(src), reinterpret_cast<T*>(dst), sidx, kept,
                         first_read, x);
      break;
    }
    case 2: {
      using T = unsigned short;
      if (staged) write_staged(reinterpret_cast<const T*>(buf), reinterpret_cast<T*>(dst), sidx, kept);
      else gather_column(reinterpret_cast<const T*>(src), reinterpret_cast<T*>(dst), sidx, kept,
                         first_read, x);
      break;
    }
    default:
      if (staged) write_staged(buf, dst, sidx, kept);
      else gather_column(src, dst, sidx, kept, first_read, x);
  }
}

// Column 0's first gathered round of the tile at row `base`, into x.
__device__ __forceinline__ void first_round(const Columns& cols, long long base,
                                            const unsigned short* sidx, int kept,
                                            unsigned long long (&x)[kUnroll]) {
  const int w = cols.width[0];
  const unsigned char* src = static_cast<const unsigned char*>(cols.src[0]) + base * w;
  const int j0 = threadIdx.x;
  switch (w) {
    case 8: gather_round(reinterpret_cast<const unsigned long long*>(src), sidx, kept, j0, x); break;
    case 4: gather_round(reinterpret_cast<const unsigned*>(src), sidx, kept, j0, x); break;
    case 2: gather_round(reinterpret_cast<const unsigned short*>(src), sidx, kept, j0, x); break;
    default: gather_round(src, sidx, kept, j0, x);
  }
}

// Block t takes tile t, whose output offset is offset[t].  Column 0's first
// reads (its first gathered round, or its whole tile's copy into shared
// memory) go out before the offset is read.
__global__ void __launch_bounds__(kBlock) compact_tiles(const uint8_t* __restrict__ mask,
                                                        long long n, Columns cols,
                                                        const long long* __restrict__ offset) {
  __shared__ __align__(16) unsigned char stage[kStageBytes];
  __shared__ unsigned short sidx[kTile];
  __shared__ long long s_off;
  const int tid = threadIdx.x;
  const long long tile = blockIdx.x;
  const long long base = tile * kTile;
  const int rows = static_cast<int>(n - base < kTile ? n - base : kTile);
  // 1. rank: this thread's kItems flags, then its first rank in the tile
  unsigned flags = 0;
  const int r0 = tid * kItems;
  if (rows == kTile && (reinterpret_cast<uintptr_t>(mask) & 7) == 0) {
    const uint2 m = __ldcs(reinterpret_cast<const uint2*>(mask + base) + tid);
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      flags |= (((r < 4 ? m.x : m.y) >> (8 * (r & 3))) & 0xffu ? 1u : 0u) << r;
    }
  } else {
    for (int r = 0; r < kItems; ++r) {
      if (r0 + r < rows && mask[base + r0 + r]) flags |= 1u << r;
    }
  }
  long long kept64;
  int rank = static_cast<int>(px_scan::block_excl_scan(__popc(flags), &kept64));
  const int kept = static_cast<int>(kept64);
  for (unsigned f = flags; f; f &= f - 1) {
    sidx[rank++] = static_cast<unsigned short>(r0 + __ffs(f) - 1);
  }
  __syncthreads();
  const bool staged = kept * 16 >= kDense * kTile;
  unsigned long long x[kUnroll];
  if (cols.n > 0) {
    if (staged) {
      stage_column(static_cast<const unsigned char*>(cols.src[0]) + base * cols.width[0],
                   cols.width[0], rows, stage);
    } else {
      first_round(cols, base, sidx, kept, x);
    }
  }
  // 2. offset
  if (tid == 0) s_off = offset[tile];
  __syncthreads();
  // 3. write every column's kept run
  const long long off = s_off;
  for (int c = 0; c < cols.n; ++c) {
    if (staged) {
      if (c > 0) {
        stage_column(static_cast<const unsigned char*>(cols.src[c]) + base * cols.width[c],
                     cols.width[c], rows, stage);
      }
      cp_async_wait<0>();
      __syncthreads();
    }
    write_kept(cols, c, base, off, sidx, kept, staged, stage, c == 0, x);
    if (staged) __syncthreads();  // the buffer is free for the next column
  }
}

}  // namespace

// -------------------------------------------------------------- C interface
// mask: n bools (1 byte each) on the device.  src/dst/width: host arrays of
// ncols device pointers and element widths (1, 2, 4 or 8); dst[c] holds room
// for n elements, of which the first *count are written.  scratch: device
// int64[ceil(n / 4096)] (each tile's offset).  count: one device int64.
// Returns a cudaError_t (0 = launched).

extern "C" int px_compact(const uint8_t* mask, long long n, int ncols, const void* const* src,
                          void* const* dst, const int* width, long long* scratch,
                          long long* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int c = 0; c < ncols; ++c) {
    const int w = width[c];
    if (w != 1 && w != 2 && w != 4 && w != 8) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaMemsetAsync(count, 0, sizeof(long long), s));
  const long long nt = (n + kTile - 1) / kTile;
  if (nt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  long long* offset = scratch;
  tile_counts<<<static_cast<unsigned>(nt), kCountBlock, 0, s>>>(mask, n, offset);
  px_scan::scan_partials<<<1, px_scan::kPartialBlock, 0, s>>>(offset, nt, count);
  // (with no column the count is all there is to do)
  for (int c0 = 0; c0 < ncols; c0 += kMaxCols) {
    Columns cols;
    cols.n = ncols - c0 < kMaxCols ? ncols - c0 : kMaxCols;
    for (int c = 0; c < cols.n; ++c) {
      cols.src[c] = src[c0 + c];
      cols.dst[c] = dst[c0 + c];
      cols.width[c] = width[c0 + c];
    }
    compact_tiles<<<static_cast<unsigned>(nt), kBlock, 0, s>>>(mask, n, cols, offset);
  }
  return static_cast<int>(cudaGetLastError());
}
