// Block- and device-wide exclusive prefix sums, shared by K4 (compact.cu) and
// J1-J3 (join.cu).
//
// A device-wide scan is three launches over tiles of kTile rows (one block per
// tile): the sum of every tile, an exclusive scan of those sums in one block,
// and a rescan of each tile from its offset.  A block walks its tile in kItems
// rounds of kBlock consecutive rows, so both the loads and the outputs of a
// round are coalesced and the result is in row order.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace px_scan {

constexpr int kBlock = 256;               // threads per tile block (a multiple of 32)
constexpr int kItems = 16;                // rounds per tile
constexpr int kTile = kBlock * kItems;    // 4096 rows per tile
constexpr int kPartialBlock = 1024;       // threads of the one-block scan

inline long long tiles(long long n) { return (n + kTile - 1) / kTile; }

// Exclusive prefix sum of v over the block, in thread order; *total gets the
// block's sum.  Every thread of the block must call it (it synchronizes).
__device__ __forceinline__ long long block_excl_scan(long long v, long long* total) {
  __shared__ long long warp_sum[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long t = lane < nwarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nwarps) warp_sum[lane] = t;
  }
  __syncthreads();
  const long long before = warp ? warp_sum[warp - 1] : 0;
  *total = warp_sum[nwarps - 1];
  __syncthreads();  // warp_sum is reused by the next call
  return before + x - v;
}

// Rank of a set flag among the block's set flags, in thread order, from one
// warp ballot (__popc of the lanes below) plus a scan of the warp counts;
// *total gets the block's count.  Every thread of the block must call it.
__device__ __forceinline__ int block_flag_scan(bool f, int* total) {
  __shared__ int warp_cnt[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, f);
  const int rank = __popc(ballot & ((1u << lane) - 1u));
  if (lane == 0) warp_cnt[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int c = lane < nwarps ? warp_cnt[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, c, o);
      if (lane >= o) c += y;
    }
    if (lane < nwarps) warp_cnt[lane] = c;
  }
  __syncthreads();
  const int before = warp ? warp_cnt[warp - 1] : 0;
  *total = warp_cnt[nwarps - 1];
  __syncthreads();
  return before + rank;
}

// partial[b] = sum of tile b of in[0, n).
template <typename In>
__global__ void __launch_bounds__(kBlock) tile_sums(const In* __restrict__ in, long long n,
                                                    long long* __restrict__ partial) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  long long s = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kBlock + threadIdx.x;
    if (i < n) s += static_cast<long long>(in[i]);
  }
  long long total;
  block_excl_scan(s, &total);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// In place: p[0, m) becomes its exclusive prefix sum; *total_out (if given)
// gets the sum of all m.  One block.
__global__ void __launch_bounds__(kPartialBlock) scan_partials(long long* __restrict__ p,
                                                               long long m,
                                                               long long* __restrict__ total_out) {
  long long carry = 0;
  for (long long base = 0; base < m; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    const long long v = i < m ? p[i] : 0;
    long long t;
    const long long e = block_excl_scan(v, &t);
    if (i < m) p[i] = carry + e;
    carry += t;
  }
  if (threadIdx.x == 0 && total_out != nullptr) *total_out = carry;
}

// out[i] = offset of i's tile + exclusive sum of in over the tile before i.
template <typename In, typename Out>
__global__ void __launch_bounds__(kBlock) tile_scan(const In* __restrict__ in, long long n,
                                                    const long long* __restrict__ partial,
                                                    Out* __restrict__ out) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  long long carry = partial[blockIdx.x];
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k * kBlock + threadIdx.x;
    const long long v = i < n ? static_cast<long long>(in[i]) : 0;
    long long t;
    const long long e = block_excl_scan(v, &t);
    if (i < n) out[i] = static_cast<Out>(carry + e);
    carry += t;
  }
}

// out[0, n) = exclusive prefix sum of in[0, n); *total (if given) = the sum.
// partial is scratch of tiles(n) int64.  Three launches on `stream`.
template <typename In, typename Out>
cudaError_t excl_scan(const In* in, long long n, Out* out, long long* partial,
                      long long* total, cudaStream_t stream) {
  const long long nt = tiles(n);
  if (nt == 0) {
    return total != nullptr ? cudaMemsetAsync(total, 0, sizeof(long long), stream)
                            : cudaSuccess;
  }
  tile_sums<In><<<static_cast<unsigned>(nt), kBlock, 0, stream>>>(in, n, partial);
  scan_partials<<<1, kPartialBlock, 0, stream>>>(partial, nt, total);
  tile_scan<In, Out><<<static_cast<unsigned>(nt), kBlock, 0, stream>>>(in, n, partial, out);
  return cudaGetLastError();
}

}  // namespace px_scan
