// J1-J3: the equijoin's match phase over dense int64 key codes, as a
// direct-address counting join.
//
// Replaces: pixie_tpu/ops/join_device.py _pack_sort (J1), _bucket_match (J2)
// and _bucket_expand (J3), and with them _append_pad, match_ranges and
// _expand.  The reference packs code << idx_bits | row, sorts it and slices
// pow2 radix buckets, because XLA needs reusable static shapes and the TPU
// wants cache-sized working sets.  Neither holds on Hopper, and the
// executor's codes are dense (unique-inverse codes in [0, K), K <= nb + np),
// so a code indexes its own slot: no buckets, no padding.
//
//  J1 px_join_build:  the build rows with a code in [0, K) sorted by code,
//     stably (a row's id is its index), by an LSD counting sort of kDigitBits
//     a pass (three passes at K = 2^24): one block a 4096-row tile counts its
//     digits in shared memory (16-byte loads), one scan over (digit, tile)
//     gives each tile its offset of each digit, and one block a tile ranks
//     the tile's rows in order (a ballot a digit bit, warps' counts summed in
//     warp order) and writes them out through shared memory.  The rows of
//     the last pass are rows_by_code.  Then each block of 4096 codes finds
//     its codes' run starts in the sorted codes (or binary searches, for a
//     window of many rows) and writes every code's slot (count, first):
//     one 8-byte pair a code, so that J2 gathers one sector a probe row.
//     No global atomics and no memsets; rows with a code outside [0, K) are
//     dropped by the first pass.  Within a code the rows come in ascending
//     order, the plain version's (a stable argsort), every run.  (12-bit
//     digits, two passes at 2^24, and __match_any_sync ranks ran slower:
//     ab_kernels.py j1_digits12, j1_match.)
//  J2 px_join_probe:  per probe row, (count, lo) = the slot of its code
//     ((0, 0) for a code outside [0, K): the executor's null sentinels -1
//     and -2 never match).  One block a 4,096-row tile: a thread loads its
//     4 codes in 16-byte loads, issues its 4 slot gathers (one 8-byte load
//     each) before its first store and writes count and lo in 16-byte
//     stores; the block sums its tile's counts, and one block scans the
//     tiles' sums into their offsets and the total (no atomic on one word,
//     no memset).  With probe_matched asked for, J2 writes it too, and its
//     tile offsets are J3's: J3 then skips its own counts pass and scan
//     (device_join_codes does this).
//  J3 px_join_expand: load-balanced over the pairs.  Unless J2 gave them,
//     one pass sums the counts of each 4,096-row tile of probe rows and
//     writes probe_matched, and one block scans the tiles' sums.  Then each
//     expand block takes 2,048 consecutive pairs, scans the counts of the
//     tile (or tiles) they come from in shared memory, and each thread
//     finds its pair's probe row by a binary search over those offsets and
//     writes (rows_by_code[lo + j], row).  A block's stores are one
//     contiguous run; a row of 1-4 pairs costs a thread, not a warp; a
//     heavy key (4,096 rows a side: 16M pairs) spreads over 8,192 blocks on
//     the whole card.  build_matched is kept as bits in the L2 (nb / 8
//     bytes), a bit set by an atomicOr from
//     the pairs that find it clear (a key met by many probe rows would
//     otherwise queue an atomic on the same word from each of its pairs),
//     then written out as bytes by a coalesced pass.  No per-row offsets in
//     device memory and no byte stores scattered over build_matched.
//     Alternatives (ab_kernels.py): 4,096 pairs a block lost at the heavy key
//     (j3_pairs4096); a bit set by every pair won at the uniform and phase
//     shapes and lost 20x at the heavy key (j3_every_pair); each matched
//     code's run claimed by one probe row in the counts pass, whose pairs
//     alone set the bits, won at the phase's shape and the heavy key and
//     lost at uniform, and its claims are atomics that return, which probe
//     rows sharing one code would queue on one word (j3_owners); eight
//     pairs a thread with their loads in flight together, 8,192 pairs a
//     block and three blocks a SM made no clear difference (j3_ilp,
//     j3_pairs8192, j3_bounds3).
//
// Pair order: pairs come grouped by probe row in probe-row order, and within
// a probe row in ascending build row (the order of rows_by_code).  The join
// contract leaves pair order unspecified; the set of pairs and both matched
// flags are exact.
//
// Bound on the H100: bytes.  At 16M x 16M codes uniform in [0, 16M) (K = 16M,
// ~16M pairs): J1 reads 128 MB of codes and writes the slots (128 MB)
// and rows_by_code (64 MB); J2 reads 128 MB of codes plus the gathered slots
// and writes 128 MB of (count, lo) and 16 MB of probe_matched; J3 reads
// (count, lo) and rows_by_code and writes 256 MB of pairs and 16 MB of
// build_matched.  J2's gathers of the slots are random, a 32-byte sector a
// row from device memory once the table misses the L2 (past K = 2^22 or
// so); at the device join phase's K = 2^20 its 8 MB stay in the L2, where
// the sectors' rate still sets J2's time.  J3's gather of
// rows_by_code is random (a probe row's lo), a 32-byte sector a pair.  J1's sort
// moves more than that: at K = 16M three passes each read the keys twice
// and write keys and rows once (about 20 bytes a row a pass).

#include "common.cuh"
#include "scan.cuh"

namespace {

// ------------------------------------------------------------------- J1
//
// A stable LSD counting sort of the valid build rows by code, kDigitBits a
// pass, then the code table from the sorted codes' run boundaries.

constexpr int kDigitBits = 8;
constexpr int kRadix = 1 << kDigitBits;
constexpr int kSortBlock = 512;                      // threads of a sort block
constexpr int kSortWarps = kSortBlock / 32;
constexpr int kSortItems = 8;                        // rows a thread
constexpr int kSortTile = kSortBlock * kSortItems;   // 4096 rows a tile (a block)
constexpr int kScatterPerSM = 3;                     // scatter blocks a SM
constexpr int kWindowBits = 12;                      // codes a table block: 4096
constexpr int kWindow = 1 << kWindowBits;
constexpr int kWindowBlock = 512;
constexpr int kWindowPer = kWindow / kWindowBlock;   // codes a thread
constexpr int kWindowStream = 4 * kWindow;           // rows a table block streams
constexpr int kNone = 0x7fffffff;                    // no run starts at this code

// The sort's shape for nb rows and K codes.
struct SortPlan {
  long long n, K;
  int passes;        // digits of K - 1 (at least one)
  long long tiles;   // kSortTile-row tiles of the rows: the blocks of a pass
  long long stride;  // int32 elements of a key or row buffer (n rounded up to 4)
  long long cells;   // kRadix * tiles counts a pass
  long long windows; // kWindow-code blocks of the table
};

SortPlan sort_plan(long long n, long long K) {
  SortPlan p{};
  p.n = n;
  p.K = K;
  int bits = 0;
  while (bits < 63 && (1LL << bits) < K) ++bits;  // bits of K - 1
  p.passes = bits <= kDigitBits ? 1 : (bits + kDigitBits - 1) / kDigitBits;
  p.tiles = (n + kSortTile - 1) / kSortTile;
  p.stride = (n + 3) & ~3LL;
  p.cells = static_cast<long long>(kRadix) * p.tiles;
  p.windows = (K + kWindow - 1) / kWindow;
  return p;
}

// int32 scratch: two key buffers, one row buffer, the counts and their
// offsets, and the windows' bounds; int64 scratch: the scan's partials and
// the number of valid rows.
long long sort_scratch32(const SortPlan& p) { return 3 * p.stride + 2 * p.cells + p.windows + 1; }
long long sort_scratch64(const SortPlan& p) { return px_scan::tiles(p.cells) + 1; }

template <typename Key>
__device__ __forceinline__ bool valid_code(Key c, long long K) {
  return c >= 0 && static_cast<long long>(c) < K;
}

__device__ __forceinline__ int digit_of(int key, int shift) {
  return (key >> shift) & (kRadix - 1);
}

// Counts of each digit over tile t's rows into hist[digit * tiles + t].  Key
// is long long for the first pass (the build codes, rows outside [0, K) not
// counted) and int after (the first *count of n rows are the sort's); kVec:
// 16-byte loads (the input is 16-byte aligned).  A thread adds a run of
// equal digits in its vector once.
template <typename Key, bool kVec>
__global__ void __launch_bounds__(kSortBlock) digit_hist(const Key* __restrict__ in, long long n,
                                                         const long long* __restrict__ count,
                                                         long long K, int shift, long long tiles,
                                                         int* __restrict__ hist) {
  __shared__ int h[kRadix];
  for (int i = threadIdx.x; i < kRadix; i += kSortBlock) h[i] = 0;
  if (count != nullptr) n = min(n, *count);
  const long long lo = static_cast<long long>(blockIdx.x) * kSortTile;
  // a tile past the rows of a later pass has none (hi = lo)
  const long long hi = max(lo, min(n, lo + kSortTile));
  constexpr int kV = kVec ? 16 / static_cast<int>(sizeof(Key)) : 1;
  constexpr int kLoads = kSortTile / (kSortBlock * kV);  // vectors a thread
  const long long vlo = lo / kV, vhi = hi / kV;
  // every vector of the thread loaded before any is counted
  Key c[kLoads][kV];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const long long v = vlo + u * kSortBlock + threadIdx.x;
#pragma unroll
    for (int e = 0; e < kV; ++e) c[u][e] = -1;
    if (v < vhi) {
      if constexpr (!kVec) {
        c[u][0] = __ldcs(in + v);
      } else if constexpr (sizeof(Key) == 8) {
        const longlong2 q = __ldcs(reinterpret_cast<const longlong2*>(in) + v);
        c[u][0] = q.x;
        c[u][1] = q.y;
      } else {
        const int4 q = __ldcs(reinterpret_cast<const int4*>(in) + v);
        c[u][0] = q.x;
        c[u][1] = q.y;
        c[u][2] = q.z;
        c[u][3] = q.w;
      }
    }
  }
  __syncthreads();  // h is zeroed
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    int run = -1, len = 0;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      if (!valid_code(c[u][e], K)) continue;
      const int dg = digit_of(static_cast<int>(c[u][e]), shift);
      if (dg != run) {
        if (len) atomicAdd(h + run, len);
        run = dg;
        len = 0;
      }
      ++len;
    }
    if (len) atomicAdd(h + run, len);
  }
  // the tile's last rows past a whole vector (the end of the input)
  for (long long i = vhi * kV + threadIdx.x; i < hi; i += kSortBlock) {
    const Key c1 = in[i];
    if (valid_code(c1, K)) atomicAdd(h + digit_of(static_cast<int>(c1), shift), 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRadix; i += kSortBlock) hist[i * tiles + blockIdx.x] = h[i];
}

// Shared memory of a digit_scatter block: each warp's count of each digit,
// the tile's offset and exclusive sum of each digit, and the tile's keys
// and rows in digit order.
constexpr size_t kScatterSmem =
    sizeof(int) * (static_cast<size_t>(kSortWarps) * kRadix + 2 * kRadix + 2 * kSortTile);

// One pass of the stable sort: tile t's rows go to out_keys / out_rows at
// offs[digit * tiles + t] onwards, in row order within a digit.  Key is long
// long for the first pass (the build codes; a row's id is its index, rows
// outside [0, K) dropped) and int after (the first *count of n rows, their
// ids from in_rows).  One block a tile: the blocks start about in tile
// order, so at any time they work on neighbouring tiles and each digit's
// rows land in a front that moves through its region (the L2 sees a sector
// filled while it is still there).
//
// A tile's rank: warp w takes its 32 * kSortItems consecutive rows in rounds
// of 32; in each round the lanes of one digit find each other (a ballot a
// digit bit) and rank themselves after that digit's earlier rows of the warp
// (wcnt).  The warps' counts are then summed in warp order, and the tile's
// digits scanned, so a row's place in the tile is its digit's start, its
// earlier warps' rows of the digit and its rank in the warp.  The tile is
// placed in shared memory in digit order and written out from there:
// neighbouring threads write neighbouring rows of one digit.
template <typename Key>
__global__ void __launch_bounds__(kSortBlock, kScatterPerSM) digit_scatter(
    const Key* __restrict__ in, const int* __restrict__ in_rows, long long n,
    const long long* __restrict__ count, long long K, int shift, long long tiles,
    const int* __restrict__ offs, int* __restrict__ out_keys, int* __restrict__ out_rows) {
  extern __shared__ __align__(16) int ssm[];
  int* wcnt = ssm;                              // [kSortWarps][kRadix]
  int* toff = wcnt + kSortWarps * kRadix;       // [kRadix]
  int* texcl = toff + kRadix;                   // [kRadix]
  int* skeys = texcl + kRadix;                  // [kSortTile]
  int* srows = skeys + kSortTile;               // [kSortTile]
  constexpr int kPer = kRadix / kSortBlock > 0 ? kRadix / kSortBlock : 1;  // digits a thread
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  if (count != nullptr) n = min(n, *count);
  // the tile's rows are loaded first, so their reads are in flight while
  // the counts are zeroed and the tile's offsets read
  const long long base = static_cast<long long>(blockIdx.x) * kSortTile + warp * (32 * kSortItems);
  // key -1: not a row of the sort (past the rows, or a code outside [0, K))
  int key[kSortItems], row[kSortItems], rank[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const long long i = base + r * 32 + lane;
    key[r] = -1;
    row[r] = 0;
    if (i < n) {
      const Key c = __ldcs(in + i);
      row[r] = in_rows != nullptr ? __ldcs(in_rows + i) : static_cast<int>(i);
      if (valid_code(c, K)) key[r] = static_cast<int>(c);
    }
  }
  auto digit = [shift](int k) { return k < 0 ? kRadix : digit_of(k, shift); };
  for (int i = tid; i < kSortWarps * kRadix; i += kSortBlock) wcnt[i] = 0;
  for (int i = tid; i < kRadix; i += kSortBlock) toff[i] = offs[i * tiles + blockIdx.x];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int dg = digit(key[r]);
    const bool mine = dg < kRadix;
    unsigned peers = __ballot_sync(0xffffffffu, mine);
    if (!mine) peers = ~peers;
#pragma unroll
    for (int bit = 0; bit < kDigitBits; ++bit) {
      const bool on = (dg >> bit) & 1;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      peers &= on ? bal : ~bal;
    }
    int* slot = wcnt + warp * kRadix + (mine ? dg : 0);
    rank[r] = mine ? *slot + __popc(peers & lt) : 0;
    __syncwarp();
    if (mine && (peers >> lane) == 1u) *slot += __popc(peers);  // the digit's last lane
    __syncwarp();
  }
  __syncthreads();
  // each digit's count over the warps; the warps' counts become their
  // exclusive sums in warp order, and the digits' counts are scanned
  int local[kPer], sum = 0;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int dd = tid * kPer + e;
    int c = 0;
    if (dd < kRadix) {
#pragma unroll
      for (int w = 0; w < kSortWarps; ++w) {
        const int v = wcnt[w * kRadix + dd];
        wcnt[w * kRadix + dd] = c;
        c += v;
      }
    }
    local[e] = c;
    sum += c;
  }
  long long total;
  int at = static_cast<int>(px_scan::block_excl_scan(sum, &total));
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int dd = tid * kPer + e;
    if (dd < kRadix) texcl[dd] = at;
    at += local[e];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int dg = digit(key[r]);
    if (dg < kRadix) {
      const int pos = texcl[dg] + wcnt[warp * kRadix + dg] + rank[r];
      skeys[pos] = key[r];
      srows[pos] = row[r];
    }
  }
  __syncthreads();
  const int tn = static_cast<int>(total);
  for (int j = tid; j < tn; j += kSortBlock) {
    const int k = skeys[j], dd = digit_of(k, shift);
    const long long g = static_cast<long long>(toff[dd]) + (j - texcl[dd]);
    out_keys[g] = k;
    out_rows[g] = srows[j];
  }
}

// bounds[h] = the first sorted position whose code is at least h * kWindow
// (bounds[windows] = the number of valid rows).
__global__ void __launch_bounds__(kSortBlock) window_bounds(const int* __restrict__ keys,
                                                            const long long* __restrict__ total,
                                                            long long windows,
                                                            int* __restrict__ bounds) {
  const long long h = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (h > windows) return;
  const long long target = h * kWindow;
  long long lo = 0, hi = *total;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  bounds[h] = static_cast<int>(lo);
}

// The slots (count, first) of window h's kWindow codes from the sorted
// codes: each code's first position (its run's start, or, without a run,
// the next run's start), and its count as the distance to the next code's
// first.  A window of up to kWindowStream rows is read once for its run
// starts; a larger one (a few heavy codes) is searched, a binary search a
// code, each thread's kWindowPer searches stepping together.
__global__ void __launch_bounds__(kWindowBlock) code_table(const int* __restrict__ keys,
                                                           const int* __restrict__ bounds,
                                                           long long K,
                                                           int2* __restrict__ slots) {
  __shared__ int start[kWindow];
  __shared__ int wmin[kWindowBlock / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kWindow;
  const int lo = bounds[blockIdx.x], hi = bounds[blockIdx.x + 1];
  if (hi - lo <= kWindowStream) {
    for (int j = tid; j < kWindow; j += kWindowBlock) start[j] = kNone;
    __syncthreads();
    // kWindowPer rows a thread a round, their loads in flight together
    for (int i0 = lo; i0 < hi; i0 += kWindowBlock * kWindowPer) {
      int c[kWindowPer], prev[kWindowPer];
#pragma unroll
      for (int e = 0; e < kWindowPer; ++e) {
        const int i = i0 + e * kWindowBlock + tid;
        c[e] = i < hi ? __ldcs(keys + i) : -1;
        prev[e] = i < hi && i > lo ? keys[i - 1] : -1;
      }
#pragma unroll
      for (int e = 0; e < kWindowPer; ++e) {
        const int i = i0 + e * kWindowBlock + tid;
        if (i < hi && c[e] != prev[e]) start[c[e] - base] = i;
      }
    }
  } else {
    int a[kWindowPer], b[kWindowPer];
#pragma unroll
    for (int e = 0; e < kWindowPer; ++e) {
      a[e] = lo;
      b[e] = hi;
    }
    for (int span = hi - lo; span > 0; span >>= 1) {
#pragma unroll
      for (int e = 0; e < kWindowPer; ++e) {
        if (a[e] < b[e]) {
          const int mid = (a[e] + b[e]) >> 1;
          if (keys[mid] < base + tid + e * kWindowBlock) {
            a[e] = mid + 1;
          } else {
            b[e] = mid;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kWindowPer; ++e) start[tid + e * kWindowBlock] = a[e];
  }
  __syncthreads();
  // suffix minimum over start (absent codes take the next code's first;
  // past the last code, hi): thread t's kWindowPer consecutive entries, then
  // the threads after it
  int m = kNone;
#pragma unroll
  for (int e = 0; e < kWindowPer; ++e) m = min(m, start[tid * kWindowPer + e]);
  int incl = m;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl = min(incl, y);
  }
  if (lane == 0) wmin[warp] = incl;
  __syncthreads();
  int after = hi;
  for (int w = warp + 1; w < kWindowBlock / 32; ++w) after = min(after, wmin[w]);
  const int nxt = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane < 31) after = min(after, nxt);
  __syncthreads();
#pragma unroll
  for (int e = kWindowPer - 1; e >= 0; --e) {
    after = min(after, start[tid * kWindowPer + e]);
    start[tid * kWindowPer + e] = after;
  }
  __syncthreads();
  const int wn = static_cast<int>(min(static_cast<long long>(kWindow), K - base));
  for (int j = tid; j < wn; j += kWindowBlock) {
    const int f = start[j];
    const int nx = j + 1 < kWindow ? start[j + 1] : hi;
    slots[base + j] = make_int2(nx - f, f);
  }
}

// The sort's passes and the code table on `s` (see px_join_build).
cudaError_t join_build_sort(const long long* codes, const SortPlan& p, int2* slots,
                            int* rows, int* scratch32, long long* scratch64, cudaStream_t s) {
  int* keys[2] = {scratch32, scratch32 + p.stride};
  int* spare = scratch32 + 2 * p.stride;
  int* hist = scratch32 + 3 * p.stride;
  int* offs = hist + p.cells;
  int* bounds = offs + p.cells;
  long long* partial = scratch64;
  long long* total = scratch64 + px_scan::tiles(p.cells);
  cudaError_t e = cudaSuccess;
  if (p.tiles == 0) {
    e = cudaMemsetAsync(total, 0, sizeof(long long), s);
  }
  static size_t opted[PX_MAX_DEVICES][2] = {{0}};
  int dev = 0;
  cudaGetDevice(&dev);
  for (int q = 0; q < 2 && p.tiles > 0 && dev < PX_MAX_DEVICES; ++q) {
    if (opted[dev][q] >= kScatterSmem) continue;
    e = q == 0 ? cudaFuncSetAttribute(digit_scatter<long long>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(kScatterSmem))
               : cudaFuncSetAttribute(digit_scatter<int>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      static_cast<int>(kScatterSmem));
    if (e != cudaSuccess) return e;
    opted[dev][q] = kScatterSmem;
  }
  const unsigned grid = static_cast<unsigned>(p.tiles);
  // the rows of the last pass land in `rows`; the passes before alternate
  // between `spare` and `rows`, so no pass reads the buffer it writes
  for (int pass = 0; pass < p.passes && p.tiles > 0; ++pass) {
    const int shift = pass * kDigitBits;
    int* out_keys = keys[pass & 1];
    int* out_rows = ((p.passes - 1 - pass) & 1) == 0 ? rows : spare;
    if (pass == 0) {
      if ((reinterpret_cast<uintptr_t>(codes) & 15) == 0) {
        digit_hist<long long, true><<<grid, kSortBlock, 0, s>>>(codes, p.n, nullptr, p.K, shift,
                                                                p.tiles, hist);
      } else {
        digit_hist<long long, false><<<grid, kSortBlock, 0, s>>>(codes, p.n, nullptr, p.K,
                                                                 shift, p.tiles, hist);
      }
    } else {
      digit_hist<int, true><<<grid, kSortBlock, 0, s>>>(keys[(pass - 1) & 1], p.n, total, p.K,
                                                        shift, p.tiles, hist);
    }
    e = px_scan::excl_scan<int, int>(hist, p.cells, offs, partial, total, s);
    if (e != cudaSuccess) return e;
    if (pass == 0) {
      digit_scatter<long long><<<grid, kSortBlock, kScatterSmem, s>>>(
          codes, nullptr, p.n, nullptr, p.K, shift, p.tiles, offs, out_keys, out_rows);
    } else {
      const int* in_rows = ((p.passes - pass) & 1) == 0 ? rows : spare;
      digit_scatter<int><<<grid, kSortBlock, kScatterSmem, s>>>(
          keys[(pass - 1) & 1], in_rows, p.n, total, p.K, shift, p.tiles, offs, out_keys,
          out_rows);
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int* sorted = keys[(p.passes - 1) & 1];
  window_bounds<<<static_cast<unsigned>((p.windows + 1 + kSortBlock - 1) / kSortBlock),
                  kSortBlock, 0, s>>>(sorted, total, p.windows, bounds);
  code_table<<<static_cast<unsigned>(p.windows), kWindowBlock, 0, s>>>(sorted, bounds, p.K,
                                                                     slots);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ J2, J3

// J2.  One block a tile of px_scan::kTile probe rows: kProbeRounds rounds
// of kProbeVec consecutive rows a thread.  A thread loads all of its codes
// (16-byte loads), then issues all of its rows' gathers of their slots (one
// 8-byte load a row: count and first side by side), then stores count and
// lo in 16-byte vectors (and, with pm, probe_matched as 4 bytes).
// partial[tile] = the tile's sum of counts, for px_scan::scan_partials.
// The gathers' 32-byte sectors are J2's time: with cnt and first apart, two
// a row, it took 1.6x (2^22 probe rows, K = 2^20) and 1.8x (2^24, K = 2^24)
// as long (ab_kernels.py j2_two_tables; j2_block256 for 256 threads x 16
// rows a tile).
constexpr int kProbeBlock = 1024;
constexpr int kProbeVec = 4;
constexpr int kProbeRounds = px_scan::kTile / (kProbeVec * kProbeBlock);  // 1

__global__ void __launch_bounds__(kProbeBlock) probe_tiles(
    const long long* __restrict__ codes, long long n, long long K, const int2* __restrict__ slots,
    int* __restrict__ cnt_p, int* __restrict__ lo_p,
    long long* __restrict__ partial, uint8_t* __restrict__ pm) {
  const long long base = static_cast<long long>(blockIdx.x) * px_scan::kTile;
  long long c[kProbeRounds][kProbeVec];
#pragma unroll
  for (int r = 0; r < kProbeRounds; ++r) {
    const long long i = base + (static_cast<long long>(r) * kProbeBlock + threadIdx.x) * kProbeVec;
    if (i + kProbeVec <= n) {
      const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(codes + i));
      const longlong2 b = __ldcs(reinterpret_cast<const longlong2*>(codes + i + 2));
      c[r][0] = a.x, c[r][1] = a.y, c[r][2] = b.x, c[r][3] = b.y;
    } else {
#pragma unroll
      for (int e = 0; e < kProbeVec; ++e) c[r][e] = i + e < n ? codes[i + e] : -1;
    }
  }
  int k[kProbeRounds][kProbeVec], lo[kProbeRounds][kProbeVec];
#pragma unroll
  for (int r = 0; r < kProbeRounds; ++r) {
#pragma unroll
    for (int e = 0; e < kProbeVec; ++e) {
      // one unsigned compare: a negative code (a null sentinel) is past K
      const bool hit = static_cast<unsigned long long>(c[r][e]) <
                       static_cast<unsigned long long>(K);
      const int2 slot = hit ? __ldg(slots + c[r][e]) : make_int2(0, 0);
      k[r][e] = slot.x;
      lo[r][e] = slot.y;
    }
  }
  long long sum = 0;
#pragma unroll
  for (int r = 0; r < kProbeRounds; ++r) {
    const long long i = base + (static_cast<long long>(r) * kProbeBlock + threadIdx.x) * kProbeVec;
    sum += static_cast<long long>(k[r][0]) + k[r][1] + k[r][2] + k[r][3];
    if (i + kProbeVec <= n) {
      *reinterpret_cast<int4*>(cnt_p + i) = make_int4(k[r][0], k[r][1], k[r][2], k[r][3]);
      *reinterpret_cast<int4*>(lo_p + i) = make_int4(lo[r][0], lo[r][1], lo[r][2], lo[r][3]);
      if (pm != nullptr) {
        *reinterpret_cast<uchar4*>(pm + i) =
            make_uchar4(k[r][0] > 0, k[r][1] > 0, k[r][2] > 0, k[r][3] > 0);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kProbeVec; ++e) {
        if (i + e < n) {
          cnt_p[i + e] = k[r][e];
          lo_p[i + e] = lo[r][e];
          if (pm != nullptr) pm[i + e] = k[r][e] > 0;
        }
      }
    }
  }
  long long tile_sum;
  px_scan::block_excl_scan(sum, &tile_sum);
  if (threadIdx.x == 0) partial[blockIdx.x] = tile_sum;
}

// J3.  Pair q of the join lies in probe row r where off[r] <= q < off[r] +
// cnt_p[r], off the exclusive sum of the counts.  Only the tiles' sums are
// scanned in device memory; an expand block takes kExpandPairs consecutive
// pairs, finds the tile of its first pair (a 32-way search a step over the
// tiles' offsets) and scans that tile's counts in shared memory; each
// thread then finds its pair's row by a binary search over the tile's
// offsets.  So a block's stores are one contiguous run of bidx and pidx
// (neighbouring threads on neighbouring pairs), a probe row of 1-4 pairs
// costs a thread, and a heavy row is spread over as many blocks as its
// pairs fill.

constexpr int kCountBlock = px_scan::kBlock;          // threads of a counts block
constexpr int kExpandBlock = 512;                     // threads of an expand block
constexpr int kExpandRows = px_scan::kTile / kExpandBlock;  // a tile's rows a thread: 8
constexpr int kExpandPairs = 2048;                    // pairs an expand block writes
constexpr int kExpandPerSM = 2;                       // expand blocks a SM

// partial[t] = the counts' sum over tile t of px_scan::kTile probe rows, and
// pm[i] = count > 0 for its rows; 4 rows a thread a round, 16-byte loads.
__global__ void __launch_bounds__(kCountBlock) count_tiles(const int* __restrict__ cnt_p,
                                                           long long n,
                                                           long long* __restrict__ partial,
                                                           uint8_t* __restrict__ pm) {
  const long long base = static_cast<long long>(blockIdx.x) * px_scan::kTile;
  long long sum = 0;
#pragma unroll
  for (int k = 0; k < px_scan::kTile / (4 * kCountBlock); ++k) {
    const long long i = base + (static_cast<long long>(k) * kCountBlock + threadIdx.x) * 4;
    if (i + 4 <= n) {
      const int4 c = __ldcs(reinterpret_cast<const int4*>(cnt_p + i));
      sum += static_cast<long long>(c.x) + c.y + c.z + c.w;
      *reinterpret_cast<uchar4*>(pm + i) = make_uchar4(c.x > 0, c.y > 0, c.z > 0, c.w > 0);
    } else {
      for (long long j = i; j < n; ++j) {
        const int c = cnt_p[j];
        sum += c;
        pm[j] = c > 0;
      }
    }
  }
  long long total;
  px_scan::block_excl_scan(sum, &total);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

// The last t in [0, n) with a[t] <= x, where a is nondecreasing and a[0] <=
// x: a 32-way search by one warp (each step a load a lane and a ballot).
__device__ __forceinline__ long long warp_last_le(const long long* __restrict__ a, long long n,
                                                  long long x) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, len = n;  // the answer lies in [lo, lo + len)
  while (len > 1) {
    const long long step = (len + 31) / 32;
    const long long i = lo + lane * step;
    const unsigned le = __ballot_sync(0xffffffffu, i < lo + len && a[i] <= x);
    const long long k = 31 - __clz(le);  // lane 0 always holds: a[lo] <= x
    const long long end = lo + len;
    lo += k * step;
    len = min(step, end - lo);
  }
  return lo;
}

__global__ void __launch_bounds__(kExpandBlock, kExpandPerSM) expand(
    const int* __restrict__ cnt_p, const int* __restrict__ lo_p, long long npr,
    const int* __restrict__ rows, const long long* __restrict__ partial, long long ntiles,
    long long total, long long* __restrict__ bidx, long long* __restrict__ pidx,
    unsigned* __restrict__ bits) {
  __shared__ long long soff[px_scan::kTile];  // the tile's rows' offsets, from its first pair
  __shared__ long long s_tile;
  const int tid = threadIdx.x;
  const long long q0 = static_cast<long long>(blockIdx.x) * kExpandPairs;
  const long long q1 = min(q0 + kExpandPairs, total);
  if (tid < 32) {
    const long long t = warp_last_le(partial, ntiles, q0);
    if (tid == 0) s_tile = t;
  }
  __syncthreads();
  for (long long t = s_tile;; ++t) {
    // the tile's offsets: thread tid's kExpandRows consecutive rows
    const long long r0 = t * px_scan::kTile;
    const long long first = r0 + tid * kExpandRows;
    int c[kExpandRows];
    if (first + kExpandRows <= npr) {
      const int4 a = *reinterpret_cast<const int4*>(cnt_p + first);
      const int4 b = *reinterpret_cast<const int4*>(cnt_p + first + 4);
      c[0] = a.x, c[1] = a.y, c[2] = a.z, c[3] = a.w;
      c[4] = b.x, c[5] = b.y, c[6] = b.z, c[7] = b.w;
    } else {
#pragma unroll
      for (int e = 0; e < kExpandRows; ++e) c[e] = first + e < npr ? cnt_p[first + e] : 0;
    }
    long long sum = 0;
#pragma unroll
    for (int e = 0; e < kExpandRows; ++e) sum += c[e];
    long long tile_total;
    long long at = px_scan::block_excl_scan(sum, &tile_total);
#pragma unroll
    for (int e = 0; e < kExpandRows; ++e) {
      soff[tid * kExpandRows + e] = at;
      at += c[e];
    }
    __syncthreads();
    const long long base = partial[t];
    const long long a = max(q0, base), b = min(q1, base + tile_total);
    for (long long q = a + tid; q < b; q += kExpandBlock) {
      const long long local = q - base;
      // the last row of the tile whose offset is at most local (its count
      // is not 0, since the next row's offset is past local)
      int x = 0;
#pragma unroll
      for (int step = px_scan::kTile / 2; step > 0; step >>= 1) {
        if (soff[x + step] <= local) x += step;
      }
      const long long r = r0 + x;
      const int bi = rows[lo_p[r] + static_cast<int>(local - soff[x])];
      bidx[q] = bi;
      pidx[q] = r;
      // a build row's bit is set by the first pairs to find it clear: the
      // rows of a key that many probe rows meet would otherwise take an
      // atomic on the same word from every one of them
      const unsigned bit = 1u << (bi & 31);
      if ((bits[bi >> 5] & bit) == 0) atomicOr(bits + (bi >> 5), bit);
    }
    if (base + tile_total >= q1) break;
    __syncthreads();  // soff is rewritten for the next tile
  }
}

// bm[i] = bit i of bits: a thread a 32-bit word, 32 flag bytes in two
// 16-byte stores (byte by byte past the last whole word).
__global__ void __launch_bounds__(kCountBlock) matched_bytes(const unsigned* __restrict__ bits,
                                                            long long nb,
                                                            uint8_t* __restrict__ bm) {
  const long long w = static_cast<long long>(blockIdx.x) * kCountBlock + threadIdx.x;
  const long long i = w * 32;
  if (i >= nb) return;
  const unsigned v = bits[w];
  if (i + 32 <= nb) {
    unsigned out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const unsigned n = v >> (4 * e);
      out[e] = (n & 1u) | ((n >> 1) & 1u) << 8 | ((n >> 2) & 1u) << 16 | ((n >> 3) & 1u) << 24;
    }
    reinterpret_cast<uint4*>(bm + i)[0] = make_uint4(out[0], out[1], out[2], out[3]);
    reinterpret_cast<uint4*>(bm + i)[1] = make_uint4(out[4], out[5], out[6], out[7]);
  } else {
    for (long long e = i; e < nb; ++e) bm[e] = (v >> (e - i)) & 1u;
  }
}

}  // namespace

// -------------------------------------------------------------- C interface
// All pointers are device pointers; every entry returns a cudaError_t
// (0 = launched) and launches on `stream`.  Codes are int64; K < 2^31 and the
// row counts < 2^31 (the wrapper checks).

// J1's scratch for nb build rows and K codes: out[0] the int32 elements,
// out[1] the int64 elements, out[2] the sort's passes, out[3] its tiles (the
// blocks of a pass).
extern "C" int px_join_build_scratch(long long nb, long long K, long long* out) {
  if (nb < 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const SortPlan p = sort_plan(nb, K);
  out[0] = sort_scratch32(p);
  out[1] = sort_scratch64(p);
  out[2] = p.passes;
  out[3] = p.tiles;
  return 0;
}

// J1.  slots: K (count, first) int32 pairs, 8-byte aligned, every slot
// written; rows: nb int32 (the first sum(count) are written: the rows of
// each code in ascending order, the codes in order); scratch32 and scratch64
// as px_join_build_scratch sizes them.  No global atomics: the rows are
// sorted by code (a stable LSD counting sort), then each code's first and
// count are read off the sorted codes.
extern "C" int px_join_build(const long long* codes, long long nb, long long K, int* slots,
                             int* rows, int* scratch32, long long* scratch64, void* stream) {
  if (K <= 0 || nb < 0 || (reinterpret_cast<uintptr_t>(slots) & 7) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(join_build_sort(codes, sort_plan(nb, K), reinterpret_cast<int2*>(slots),
                                          rows, scratch32, scratch64,
                                          static_cast<cudaStream_t>(stream)));
}

// J2.  slots: J1's K (count, first) pairs; cnt_p, lo_p: npr int32;
// partial: ceil(npr / 4096) int64, left holding each tile's offset (the
// exclusive sum of the counts before it); pm: npr bytes of probe_matched,
// or null for none; total: one int64 (set to the number of pairs).  codes,
// cnt_p, lo_p 16-byte aligned, slots 8-byte aligned.  Two launches: the
// tiles, then one block scanning their sums.
extern "C" int px_join_probe(const long long* codes, long long npr, long long K,
                             const int* slots, int* cnt_p, int* lo_p, long long* partial,
                             uint8_t* pm, long long* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (npr < 0 || (reinterpret_cast<uintptr_t>(slots) & 7) != 0 ||
      ((reinterpret_cast<uintptr_t>(codes) | reinterpret_cast<uintptr_t>(cnt_p) |
        reinterpret_cast<uintptr_t>(lo_p) | reinterpret_cast<uintptr_t>(pm)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nt = px_scan::tiles(npr);
  if (nt > 0) {
    probe_tiles<<<static_cast<unsigned>(nt), kProbeBlock, 0, s>>>(
        codes, npr, K, reinterpret_cast<const int2*>(slots), cnt_p, lo_p, partial, pm);
  }
  px_scan::scan_partials<<<1, px_scan::kPartialBlock, 0, s>>>(partial, nt, total);
  return static_cast<int>(cudaGetLastError());
}

// J3.  partial: ceil(npr / 4096) int64: with counted, J2's tile offsets
// (and pm already written by J2); else scratch (the tiles' sums, then their
// offsets, and pm written here); bits: ceil(nb / 32) uint32 of scratch
// (build_matched as bits); total: the pairs (J2's total); bidx, pidx: room
// for them; bm: nb bytes; pm: npr bytes.  cnt_p and bm 16-byte aligned.
extern "C" int px_join_expand(const int* cnt_p, const int* lo_p, long long npr,
                              const int* rows, long long nb, long long total,
                              long long* partial, int counted, unsigned* bits,
                              long long* bidx, long long* pidx, uint8_t* bm, uint8_t* pm,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (total < 0 ||
      ((reinterpret_cast<uintptr_t>(cnt_p) | reinterpret_cast<uintptr_t>(bm)) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long words = (nb + 31) / 32;
  cudaError_t e = cudaMemsetAsync(bits, 0, static_cast<size_t>(words) * sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (npr > 0) {
    const long long nt = px_scan::tiles(npr);
    if (!counted) {
      count_tiles<<<static_cast<unsigned>(nt), kCountBlock, 0, s>>>(cnt_p, npr, partial, pm);
    }
    if (total > 0) {
      if (!counted) {
        px_scan::scan_partials<<<1, px_scan::kPartialBlock, 0, s>>>(partial, nt, nullptr);
      }
      const long long grid = (total + kExpandPairs - 1) / kExpandPairs;
      if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
      expand<<<static_cast<unsigned>(grid), kExpandBlock, 0, s>>>(cnt_p, lo_p, npr, rows,
                                                                  partial, nt, total, bidx, pidx,
                                                                  bits);
    }
  }
  if (words > 0) {
    matched_bytes<<<static_cast<unsigned>((words + kCountBlock - 1) / kCountBlock), kCountBlock,
                    0, s>>>(bits, nb, bm);
  }
  return static_cast<int>(cudaGetLastError());
}
