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
// = 0.19 ms.  There is no arithmetic to speak of.
//
// Design, in one C call and three launches on the caller's stream:
//  1. count: one block per tile of 4096 rows counts its kept rows, one
//     __ballot_sync + __popc per warp and round;
//  2. scan: one block turns the few thousand tile counts into each tile's
//     output offset and writes the total (the count, which stays on the
//     device);
//  3. scatter: each block walks its tile again in 16 rounds of 256
//     consecutive rows; a row's output position is its tile offset plus its
//     rank among the kept rows before it (ballot + __popc within the warp, a
//     scan of the warp counts within the block), and the thread copies every
//     column's element there.  Up to kMaxCols columns of 1, 2, 4 or 8 bytes
//     move in one launch (their pointers and widths ride in the launch's
//     parameters); more columns take one more scatter launch per kMaxCols.
// Kept rows come out in input order, so the result equals the reference's
// stable partition row for row and does not vary between runs.

#include "common.cuh"
#include "scan.cuh"

namespace {

using px_scan::kBlock;
using px_scan::kItems;
using px_scan::kTile;

constexpr int kMaxCols = 16;

struct Columns {
  const void* src[kMaxCols];
  void* dst[kMaxCols];
  int width[kMaxCols];
  int n;
};

__global__ void __launch_bounds__(kBlock) tile_counts(const uint8_t* __restrict__ mask,
                                                      long long n,
                                                      long long* __restrict__ partial) {
  __shared__ int block_count;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  int warp_count = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kBlock + threadIdx.x;
    const bool keep = i < n && mask[i] != 0;
    warp_count += __popc(__ballot_sync(0xffffffffu, keep));
  }
  if ((threadIdx.x & 31) == 0) atomicAdd(&block_count, warp_count);
  __syncthreads();
  if (threadIdx.x == 0) partial[blockIdx.x] = block_count;
}

template <typename T>
__device__ __forceinline__ void copy_elem(const void* src, void* dst, long long i, long long pos) {
  static_cast<T*>(dst)[pos] = static_cast<const T*>(src)[i];
}

__global__ void __launch_bounds__(kBlock) scatter(const uint8_t* __restrict__ mask, long long n,
                                                  const long long* __restrict__ offset,
                                                  Columns cols) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  long long carry = offset[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kBlock + threadIdx.x;
    const bool keep = i < n && mask[i] != 0;
    int round_total;
    const long long pos = carry + px_scan::block_flag_scan(keep, &round_total);
    if (keep) {
      for (int c = 0; c < cols.n; ++c) {
        switch (cols.width[c]) {
          case 1: copy_elem<uint8_t>(cols.src[c], cols.dst[c], i, pos); break;
          case 2: copy_elem<uint16_t>(cols.src[c], cols.dst[c], i, pos); break;
          case 4: copy_elem<uint32_t>(cols.src[c], cols.dst[c], i, pos); break;
          default: copy_elem<unsigned long long>(cols.src[c], cols.dst[c], i, pos); break;
        }
      }
    }
    carry += round_total;
  }
}

}  // namespace

// -------------------------------------------------------------- C interface
// mask: n bools (1 byte each) on the device.  src/dst/width: host arrays of
// ncols device pointers and element widths (1, 2, 4 or 8); dst[c] holds room
// for n elements, of which the first *count are written.  partial: device
// scratch of ceil(n / 4096) int64.  count: one device int64.  Returns a
// cudaError_t (0 = launched).

extern "C" int px_compact(const uint8_t* mask, long long n, int ncols, const void* const* src,
                          void* const* dst, const int* width, long long* partial,
                          long long* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int c = 0; c < ncols; ++c) {
    const int w = width[c];
    if (w != 1 && w != 2 && w != 4 && w != 8) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaMemsetAsync(count, 0, sizeof(long long), s));
  const long long nt = px_scan::tiles(n);
  tile_counts<<<static_cast<unsigned>(nt), kBlock, 0, s>>>(mask, n, partial);
  px_scan::scan_partials<<<1, px_scan::kPartialBlock, 0, s>>>(partial, nt, count);
  for (int c0 = 0; c0 < ncols; c0 += kMaxCols) {
    Columns cols;
    cols.n = ncols - c0 < kMaxCols ? ncols - c0 : kMaxCols;
    for (int c = 0; c < cols.n; ++c) {
      cols.src[c] = src[c0 + c];
      cols.dst[c] = dst[c0 + c];
      cols.width[c] = width[c0 + c];
    }
    scatter<<<static_cast<unsigned>(nt), kBlock, 0, s>>>(mask, n, partial, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
