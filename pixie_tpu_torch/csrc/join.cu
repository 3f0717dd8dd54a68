// J1-J3: the equijoin's match phase over dense int64 key codes, as a
// direct-address counting join.
//
// Replaces: pixie_tpu/ops/join_device.py _pack_sort (J1), _bucket_match (J2)
// and _bucket_expand (J3), and with them _append_pad, match_ranges and
// _expand.  The reference packs code << idx_bits | row, sorts it and slices
// pow2 radix buckets, because XLA needs reusable static shapes and the TPU
// wants cache-sized working sets.  Neither holds on Hopper, and the
// executor's codes are dense (unique-inverse codes in [0, K), K <= nb + np),
// so a code indexes its own slot: no sort, no buckets, no padding.
//
//  J1 px_join_build:  histogram of the build codes into cnt[K] (privatized in
//     shared memory while K fits in 48 KB, global atomics above), its
//     exclusive scan into first[K] (scan.cuh), and a scatter of each build
//     row id to rows_by_code[first[code] + atomicAdd(fill[code], 1)].
//  J2 px_join_probe:  per probe row, count = cnt[code] and lo = first[code]
//     (0 and 0 for a code outside [0, K): the executor's null sentinels -1 and
//     -2 never match); each warp adds its partial count into one int64 total.
//  J3 px_join_expand: exclusive scan of the counts into each probe row's pair
//     offset, then ONE WARP PER PROBE ROW writes its pairs
//     (rows_by_code[lo + j], row) for j < count, lanes striding over j, so a
//     heavy key spreads over 32 lanes instead of one thread; build_matched is
//     set for every build row written, probe_matched for count > 0.
//
// Pair order: pairs come grouped by probe row in probe-row order, and within
// a probe row in the order of rows_by_code for its code.  That order is the
// order in which J1's atomics handed out the slots, which can change from run
// to run (the join contract leaves pair order unspecified; the set of pairs
// and both matched flags are exact).
//
// Bound on the H100: bytes.  At 16M x 16M codes uniform in [0, 16M) (K = 16M,
// ~16M pairs): J1 reads 128 MB of codes and writes cnt, first (64 MB each)
// and rows_by_code (64 MB); J2 reads 128 MB of codes plus the gathered slots
// and writes 128 MB of (count, lo); J3 reads (count, lo, offset) and
// rows_by_code and writes 256 MB of pairs and 32 MB of flags.  The
// histogram's and the scatter's atomics land on random addresses of a 64 MB
// table, larger than the 50 MB L2, so they, not the bytes, are expected to
// set J1's time.

#include "common.cuh"
#include "scan.cuh"

namespace {

constexpr int kBlock = 256;
constexpr size_t kSharedHist = 48 * 1024;

__global__ void __launch_bounds__(kBlock) hist_shared(const long long* __restrict__ codes,
                                                      long long n, int* __restrict__ cnt,
                                                      int K) {
  extern __shared__ int h[];
  for (int i = threadIdx.x; i < K; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long c = codes[i];
    if (c >= 0 && c < K) atomicAdd(&h[c], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    if (h[i]) atomicAdd(&cnt[i], h[i]);
  }
}

__global__ void __launch_bounds__(kBlock) hist_global(const long long* __restrict__ codes,
                                                      long long n, int* __restrict__ cnt,
                                                      long long K) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long c = codes[i];
    if (c >= 0 && c < K) atomicAdd(&cnt[c], 1);
  }
}

__global__ void __launch_bounds__(kBlock) fill_rows(const long long* __restrict__ codes,
                                                    long long n, long long K,
                                                    const int* __restrict__ first,
                                                    int* __restrict__ fill,
                                                    int* __restrict__ rows) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long c = codes[i];
    if (c >= 0 && c < K) rows[first[c] + atomicAdd(&fill[c], 1)] = static_cast<int>(i);
  }
}

__global__ void __launch_bounds__(kBlock) probe(const long long* __restrict__ codes,
                                                long long n, long long K,
                                                const int* __restrict__ cnt,
                                                const int* __restrict__ first,
                                                int* __restrict__ cnt_p, int* __restrict__ lo_p,
                                                long long* __restrict__ total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long mine = 0;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long c = codes[i];
    int k = 0, lo = 0;
    if (c >= 0 && c < K) {
      k = cnt[c];
      lo = first[c];
    }
    cnt_p[i] = k;
    lo_p[i] = lo;
    mine += k;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_down_sync(0xffffffffu, mine, o);
  if ((threadIdx.x & 31) == 0 && mine != 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(total),
              static_cast<unsigned long long>(mine));
  }
}

__global__ void __launch_bounds__(kBlock) expand(const int* __restrict__ cnt_p,
                                                 const int* __restrict__ lo_p,
                                                 const long long* __restrict__ offs,
                                                 long long npr, const int* __restrict__ rows,
                                                 long long* __restrict__ bidx,
                                                 long long* __restrict__ pidx,
                                                 uint8_t* __restrict__ bm,
                                                 uint8_t* __restrict__ pm) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long r = warp; r < npr; r += nwarps) {
    const int c = cnt_p[r];
    if (lane == 0) pm[r] = c > 0 ? 1 : 0;
    if (c == 0) continue;
    const long long at = offs[r];
    const int lo = lo_p[r];
    for (int j = lane; j < c; j += 32) {
      const int b = rows[lo + j];
      bidx[at + j] = b;
      pidx[at + j] = r;
      bm[b] = 1;
    }
  }
}

}  // namespace

// -------------------------------------------------------------- C interface
// All pointers are device pointers; every entry returns a cudaError_t
// (0 = launched) and launches on `stream`.  Codes are int64; K < 2^31 and the
// row counts < 2^31 (the wrapper checks).

// J1.  cnt, first, fill: K int32 each; rows: nb int32 (the first
// sum(cnt) are written); partial: ceil(K / 4096) int64 of scratch.
extern "C" int px_join_build(const long long* codes, long long nb, long long K, int* cnt,
                             int* first, int* fill, int* rows, long long* partial,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t e = cudaMemsetAsync(cnt, 0, static_cast<size_t>(K) * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaMemsetAsync(fill, 0, static_cast<size_t>(K) * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nb > 0) {
    const size_t hist_bytes = static_cast<size_t>(K) * sizeof(int);
    if (hist_bytes <= kSharedHist) {
      const long long grid = px_grid(hist_shared, nb, kBlock, hist_bytes);
      hist_shared<<<static_cast<unsigned>(grid), kBlock, hist_bytes, s>>>(
          codes, nb, cnt, static_cast<int>(K));
    } else {
      const long long grid = px_grid(hist_global, nb, kBlock, 0);
      hist_global<<<static_cast<unsigned>(grid), kBlock, 0, s>>>(codes, nb, cnt, K);
    }
  }
  e = px_scan::excl_scan<int, int>(cnt, K, first, partial, nullptr, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nb > 0) {
    const long long grid = px_grid(fill_rows, nb, kBlock, 0);
    fill_rows<<<static_cast<unsigned>(grid), kBlock, 0, s>>>(codes, nb, K, first, fill, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// J2.  cnt_p, lo_p: npr int32; total: one int64 (set to the number of pairs).
extern "C" int px_join_probe(const long long* codes, long long npr, long long K,
                             const int* cnt, const int* first, int* cnt_p, int* lo_p,
                             long long* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(total, 0, sizeof(long long), s);
  if (e != cudaSuccess || npr <= 0) return static_cast<int>(e);
  const long long grid = px_grid(probe, npr, kBlock, 0);
  probe<<<static_cast<unsigned>(grid), kBlock, 0, s>>>(codes, npr, K, cnt, first, cnt_p, lo_p,
                                                       total);
  return static_cast<int>(cudaGetLastError());
}

// J3.  offs: npr int64 of scratch (each probe row's pair offset); partial:
// ceil(npr / 4096) int64 of scratch; bidx, pidx: room for every pair (the
// total J2 returned); bm: nb bytes; pm: npr bytes.
extern "C" int px_join_expand(const int* cnt_p, const int* lo_p, long long npr,
                              const int* rows, long long nb, long long* offs,
                              long long* partial, long long* bidx, long long* pidx,
                              uint8_t* bm, uint8_t* pm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(bm, 0, static_cast<size_t>(nb), s);
  if (e != cudaSuccess || npr <= 0) return static_cast<int>(e);
  e = px_scan::excl_scan<int, long long>(cnt_p, npr, offs, partial, nullptr, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // one warp per probe row: kBlock / 32 rows per block and round
  const long long grid = px_grid(expand, npr * 32, kBlock, 0);
  expand<<<static_cast<unsigned>(grid), kBlock, 0, s>>>(cnt_p, lo_p, offs, npr, rows, bidx,
                                                        pidx, bm, pm);
  return static_cast<int>(cudaGetLastError());
}
