// X1, X2: the in-mesh keyed repartition of a join side over co-located shards.
//
// Replaces: pixie_tpu/parallel/repartition.py `_device_key_fn` (:156, the
// per-row value hash) with `mesh_bucket_counts` (:358, the counts pass), and
// `_local_partition` (:335) with the scatter of `mesh_repartition` (:395)
// and its lax.all_to_all, which on shards that share one card is a layout
// written directly.
//
//  X1 px_partition_count: one pass over every shard's rows.  Per row
//     h = 0; h = h * GAMMA + ch for each key column (uint64, wrapping), where
//     ch = splitmix64(value) for a plain int64 column and ch = lut[code] for
//     a dictionary column (lut[c] = splitmix64(crc32(str(value c))), built
//     on the host; a code below 0, or any code of an empty dictionary,
//     hashes to 0x6E756C6C, "null"); part = splitmix64(h) % n_dev, unsigned.
//     This is parallel/repartition.py partition_ids bit for bit, so a
//     mesh-exchanged and a host-exchanged producer of one join stage agree.
//     Writes part (int32; n_dev for a row past the shard's valid count), each
//     tile's count per target and each shard's count per target.
//  X2 px_partition_scatter: given part and X1's tile counts, every column of
//     row r of shard i with target p goes to row (p * n_dev + i) * cap +
//     rank, rank = the rows of shard i with target p before r.  So row-block
//     p * n_dev + i holds shard i's rows for partition p in row order -- the
//     reference orders a bucket by (partition, row index) -- which is the
//     layout the reference's all_to_all delivers.  A row whose rank reaches
//     cap is not written: the received counts min(count, cap) then fall short
//     of the rows sent, and the host's conservation check fails loudly.  Rows
//     past a block's count are left as they were (the host reads only [0,
//     count)).
//
// Bound on the H100: bytes.  X1 reads the key columns and writes part: at
// one int64 and one int32 key, 16 B a row (2^24 rows: 0.080 ms at 3.35 TB/s).
// X2 reads part and every column and writes every column: 4 + 2 * (column
// bytes) a row.  The tile counts are 1/4096 of that.
//
// Design.  X1: a block covers one tile of kTile rows of one shard (blockIdx.y
// is the shard), in chunks of kBlock rows; in each chunk the lanes of a warp
// that share a target find each other with __match_any_sync and the lowest
// adds the group's size to the tile's shared-memory histogram.  X2 is two
// launches: `tile_scan` turns the tile counts into each tile's first rank per
// target (an exclusive scan over a shard's tiles), then `partition_scatter`,
// one pass of J1's counting sort (csrc/join.cu digit_scatter) with the
// target as the digit: one 512-thread block a tile ranks the tile's rows
// once (a ballot a bit of the target, the warps' counts summed in warp
// order) and places the tile's permutation in target order in shared
// memory; every column's tile is copied into shared memory by 16-byte
// cp.async, the next column's while the current one is written out, each
// target's run by neighbouring threads on neighbouring rows of the target's
// block.  All columns go in one launch: up to 32 by value in the launch,
// more from a device table.  No sort, no global atomics.  Alternatives
// (ab_kernels.py): the tiles' scan as a torch.cumsum along the tiles (one
// thread a column) lost by 0.26 ms at 2^24 rows and 4 partitions
// (x2_torch_scan); columns gathered through the permutation straight from
// device memory lost by 13% (x2_gather); __match_any_sync ranks and one
// column's copy at a time made no clear difference (x2_match,
// x2_no_overlap).

#include "common.cuh"
#include "scan.cuh"

namespace {

constexpr int kBlock = 256;
// rows of one shard that one block covers
constexpr int kTile = 4096;
constexpr int kMaxKeys = 8;
constexpr int kMaxParts = 1024;

constexpr unsigned long long kGamma = 0x9E3779B97F4A7C15ull;
constexpr unsigned long long kMix1 = 0xBF58476D1CE4E5B9ull;
constexpr unsigned long long kMix2 = 0x94D049BB133111EBull;
constexpr unsigned long long kNullHash = 0x6E756C6Cull;

struct Keys {
  const void* col[kMaxKeys];                // int64 values, or int32 codes
  const unsigned long long* lut[kMaxKeys];  // nullptr for a plain column
  long long lut_size[kMaxKeys];
  int n;
};

__device__ __forceinline__ unsigned long long splitmix64(unsigned long long x) {
  unsigned long long z = x + kGamma;
  z = (z ^ (z >> 30)) * kMix1;
  z = (z ^ (z >> 27)) * kMix2;
  return z ^ (z >> 31);
}

__device__ __forceinline__ int target_of(const Keys& k, long long r, int n_dev) {
  unsigned long long h = 0;
  for (int j = 0; j < k.n; ++j) {
    unsigned long long ch;
    if (k.lut[j] == nullptr) {
      ch = splitmix64(
          static_cast<unsigned long long>(static_cast<const long long*>(k.col[j])[r]));
    } else {
      const long long code = static_cast<const int*>(k.col[j])[r];
      const long long size = k.lut_size[j];
      ch = (code < 0 || size == 0) ? kNullHash : k.lut[j][code < size ? code : size - 1];
    }
    h = h * kGamma + ch;
  }
  h = splitmix64(h);
  const unsigned long long n = static_cast<unsigned long long>(n_dev);
  return static_cast<int>((n & (n - 1)) == 0 ? (h & (n - 1)) : (h % n));
}

__global__ void __launch_bounds__(kBlock)
    partition_count(Keys keys, const long long* __restrict__ n_valid, long long per, int n_dev,
                    int n_tiles, int* __restrict__ part, long long* __restrict__ tile_counts,
                    unsigned long long* __restrict__ counts) {
  extern __shared__ int hist[];  // [n_dev]
  const int s = blockIdx.y;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  for (int p = threadIdx.x; p < n_dev; p += kBlock) hist[p] = 0;
  __syncthreads();
  const long long nv = n_valid[s];
  const long long row0 = static_cast<long long>(s) * per;
  const long long lo = static_cast<long long>(t) * kTile;
  const long long hi = lo + kTile < per ? lo + kTile : per;
  for (long long i0 = lo; i0 < hi; i0 += kBlock) {
    const long long i = i0 + threadIdx.x;
    int p = n_dev;
    if (i < hi && i < nv) p = target_of(keys, row0 + i, n_dev);
    if (i < hi) part[row0 + i] = p;
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    if (p < n_dev && lane == __ffs(peers) - 1) atomicAdd(&hist[p], __popc(peers));
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_dev; p += kBlock) {
    const int c = hist[p];
    tile_counts[(static_cast<long long>(s) * n_tiles + t) * n_dev + p] = c;
    if (c) atomicAdd(&counts[static_cast<long long>(s) * n_dev + p],
                     static_cast<unsigned long long>(c));
  }
}

// ------------------------------------------------------------------- X2
//
// One pass of a stable counting sort, the target partition as the digit
// (the design of J1's digit_scatter, csrc/join.cu).

constexpr int kXBlock = 512;                  // threads of a scatter block
constexpr int kXWarps = kXBlock / 32;
constexpr int kXItems = kTile / kXBlock;      // rows a thread: 8
constexpr int kXPerSM = 2;                    // scatter blocks a SM
constexpr int kXBuf = kTile * 8;              // bytes of a staged column tile
// columns passed by value in the launch; more are read from a device table
constexpr int kMaxInline = 32;

struct ScatterCols {
  const unsigned char* src[kMaxInline];
  unsigned char* dst[kMaxInline];
  unsigned char width[kMaxInline];
  // past kMaxInline columns: 3 words a column on the device (src, dst,
  // width), else nullptr
  const unsigned long long* table;
  int n;
};

struct Column {
  const unsigned char* src;
  unsigned char* dst;
  int width;
};

__device__ __forceinline__ Column column(const ScatterCols& cols, int c) {
  if (cols.table != nullptr) {
    return {reinterpret_cast<const unsigned char*>(cols.table[3 * c]),
            reinterpret_cast<unsigned char*>(cols.table[3 * c + 1]),
            static_cast<int>(cols.table[3 * c + 2])};
  }
  return {cols.src[c], cols.dst[c], cols.width[c]};
}

// Dynamic shared memory of a scatter block: two column tiles, each place's
// tile row and target, and per target its output base and block end, each
// warp's count and the tile's exclusive sum.
size_t scatter_smem(int n_dev) {
  return static_cast<size_t>(2 * kXBuf) + static_cast<size_t>(kTile) * (2 + 2) +
         static_cast<size_t>(n_dev) * (2 * sizeof(long long) + sizeof(int) * (kXWarps + 1));
}

// Rows [start, start + rows) of a column of width-byte elements copied into
// buf: by 16-byte cp.async where the tile starts 16-byte aligned (committed
// as one group; the caller waits for it), else element by element.
__device__ __forceinline__ void stage_column(const Column& col, long long start, int rows,
                                             unsigned char* buf) {
  const unsigned char* g = col.src + start * col.width;
  const int bytes = rows * col.width;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int nv = bytes >> 4;
    for (int v = threadIdx.x; v < nv; v += kXBlock) cp_async16(buf + 16 * v, g + 16 * v);
    done = nv << 4;
  }
  for (int b = done + threadIdx.x * col.width; b < bytes; b += kXBlock * col.width) {
    switch (col.width) {
      case 8:
        *reinterpret_cast<unsigned long long*>(buf + b) =
            *reinterpret_cast<const unsigned long long*>(g + b);
        break;
      case 4:
        *reinterpret_cast<unsigned*>(buf + b) = *reinterpret_cast<const unsigned*>(g + b);
        break;
      case 2:
        *reinterpret_cast<unsigned short*>(buf + b) =
            *reinterpret_cast<const unsigned short*>(g + b);
        break;
      default:
        buf[b] = g[b];
    }
  }
  cp_async_commit();
}

// Place j of the tile's target order, staged in sbuf at its tile row
// sperm[j], written to row sbase[p] + j of its target p's block, unless
// that reaches the block's end (cap): neighbouring threads on neighbouring
// rows of one target's block.
template <typename T>
__device__ __forceinline__ void write_column(T* __restrict__ dst, int tn, const T* sbuf,
                                             const unsigned short* sperm,
                                             const unsigned short* stgt,
                                             const long long* sbase, const long long* send) {
  for (int j = threadIdx.x; j < tn; j += kXBlock) {
    const int q = stgt[j];
    const long long d = sbase[q] + j;
    if (d < send[q]) dst[d] = sbuf[sperm[j]];
  }
}

// tile_first[s][t][p] = the rows of shard s's tiles before t with target p
// (an exclusive scan of tile_counts over t): one block a shard and 32
// targets, lanes on targets, each warp a run of tiles.
__global__ void __launch_bounds__(1024) tile_scan(const long long* __restrict__ tile_counts,
                                                  long long* __restrict__ tile_first,
                                                  int n_dev, int n_tiles) {
  __shared__ long long run_sum[32][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int p = blockIdx.y * 32 + lane;
  const long long base = static_cast<long long>(blockIdx.x) * n_tiles;
  const int per_w = (n_tiles + warps - 1) / warps;
  const int t0 = w * per_w, t1 = min(t0 + per_w, n_tiles);
  long long sum = 0;
  if (p < n_dev) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) sum += tile_counts[(base + t) * n_dev + p];
  }
  run_sum[w][lane] = sum;
  __syncthreads();
  long long at = 0;
  for (int v = 0; v < w; ++v) at += run_sum[v][lane];
  if (p < n_dev) {
    for (int t = t0; t < t1; ++t) {
      const long long i = (base + t) * n_dev + p;
      const long long c = tile_counts[i];
      tile_first[i] = at;
      at += c;
    }
  }
}

// One block a kTile-row tile t of shard s.  The first column's tile is
// requested (cp.async) before anything else, so it arrives while the tile
// is ranked.  Rank: warp w takes its 32 * kXItems consecutive rows in rounds
// of 32; in each round the lanes of one target find each other (a ballot a
// bit of the target) and rank themselves after the target's earlier rows of
// the warp (wcnt).  The warps' counts are summed in warp order and the
// tile's targets scanned, so a row's place in the tile's target order is
// its target's start, its earlier warps' rows of that target and its rank
// in the warp; its output row is the tile's first rank of the target
// (tile_first) plus its place past the target's start.  The tile is ranked
// once; then each column is written out of shared memory while the next
// column's tile is copied into the other buffer.
__global__ void __launch_bounds__(kXBlock, kXPerSM)
    partition_scatter(ScatterCols cols, const int* __restrict__ part,
                      const long long* __restrict__ tile_first,
                      const unsigned long long* __restrict__ counts, long long per, int n_dev,
                      int bits, int n_tiles, long long cap, long long* __restrict__ recv) {
  extern __shared__ __align__(16) unsigned char xsm[];
  unsigned char* sbuf[2] = {xsm, xsm + kXBuf};                                // [2][kXBuf]
  unsigned short* sperm = reinterpret_cast<unsigned short*>(xsm + 2 * kXBuf);   // [kTile]
  unsigned short* stgt = sperm + kTile;                                       // [kTile]
  long long* sbase = reinterpret_cast<long long*>(stgt + kTile);              // [n_dev]
  long long* send = sbase + n_dev;                                            // [n_dev]
  int* wcnt = reinterpret_cast<int*>(send + n_dev);                           // [kXWarps][n_dev]
  int* texcl = wcnt + kXWarps * n_dev;                                        // [n_dev]
  const int s = blockIdx.y;
  const int t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const long long row0 = static_cast<long long>(s) * per;
  const long long lo = static_cast<long long>(t) * kTile;
  const int rows = static_cast<int>(per - lo < kTile ? per - lo : kTile);
  // the warp's targets are loaded first, then the first column's tile is
  // requested; n_dev: not a row of the exchange
  const int wrow = warp * (32 * kXItems);
  int tg[kXItems], rank[kXItems];
#pragma unroll
  for (int r = 0; r < kXItems; ++r) {
    const int i = wrow + r * 32 + lane;
    tg[r] = i < rows ? __ldcs(part + row0 + lo + i) : n_dev;
  }
  if (cols.n > 0) stage_column(column(cols, 0), row0 + lo, rows, sbuf[0]);
  for (int j = tid; j < kXWarps * n_dev; j += kXBlock) wcnt[j] = 0;
  if (t == 0) {
    for (int p = tid; p < n_dev; p += kXBlock) {
      const unsigned long long c = counts[static_cast<long long>(s) * n_dev + p];
      recv[static_cast<long long>(p) * n_dev + s] =
          c < static_cast<unsigned long long>(cap) ? static_cast<long long>(c) : cap;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kXItems; ++r) {
    const int p = tg[r];
    const bool mine = p < n_dev;
    unsigned peers = __ballot_sync(0xffffffffu, mine);
    if (!mine) peers = ~peers;
    for (int bit = 0; bit < bits; ++bit) {
      const bool on = (p >> bit) & 1;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      peers &= on ? bal : ~bal;
    }
    int* slot = wcnt + warp * n_dev + (mine ? p : 0);
    rank[r] = mine ? *slot + __popc(peers & lt) : 0;
    __syncwarp();
    if (mine && (peers >> lane) == 1u) *slot += __popc(peers);  // the target's last lane
    __syncwarp();
  }
  __syncthreads();
  // each target's count over the warps; the warps' counts become their
  // exclusive sums in warp order, and the tile's targets are scanned
  const int per_thread = (n_dev + kXBlock - 1) / kXBlock;  // targets a thread
  int sum = 0;
  for (int e = 0; e < per_thread; ++e) {
    const int q = tid * per_thread + e;
    if (q < n_dev) {
      int c = 0;
      for (int w = 0; w < kXWarps; ++w) {
        const int v = wcnt[w * n_dev + q];
        wcnt[w * n_dev + q] = c;
        c += v;
      }
      texcl[q] = c;
      sum += c;
    }
  }
  long long total;
  long long at = px_scan::block_excl_scan(sum, &total);
  for (int e = 0; e < per_thread; ++e) {
    const int q = tid * per_thread + e;
    if (q < n_dev) {
      const int c = texcl[q];
      const long long block = (static_cast<long long>(q) * n_dev + s) * cap;
      texcl[q] = static_cast<int>(at);
      sbase[q] = block + tile_first[(static_cast<long long>(s) * n_tiles + t) * n_dev + q] - at;
      send[q] = block + cap;
      at += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kXItems; ++r) {
    const int p = tg[r];
    if (p < n_dev) {
      const int pos = texcl[p] + wcnt[warp * n_dev + p] + rank[r];
      sperm[pos] = static_cast<unsigned short>(wrow + r * 32 + lane);
      stgt[pos] = static_cast<unsigned short>(p);
    }
  }
  const int tn = static_cast<int>(total);
  for (int c = 0; c < cols.n; ++c) {
    // the next column's tile goes into the other buffer, whose last
    // column was written before the previous iteration's barrier
    if (c + 1 < cols.n) {
      stage_column(column(cols, c + 1), row0 + lo, rows, sbuf[(c + 1) & 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const Column col = column(cols, c);
    const unsigned char* buf = sbuf[c & 1];
    switch (col.width) {
      case 8:
        write_column(reinterpret_cast<unsigned long long*>(col.dst), tn,
                     reinterpret_cast<const unsigned long long*>(buf), sperm, stgt, sbase, send);
        break;
      case 4:
        write_column(reinterpret_cast<unsigned*>(col.dst), tn,
                     reinterpret_cast<const unsigned*>(buf), sperm, stgt, sbase, send);
        break;
      case 2:
        write_column(reinterpret_cast<unsigned short*>(col.dst), tn,
                     reinterpret_cast<const unsigned short*>(buf), sperm, stgt, sbase, send);
        break;
      default:
        write_column(col.dst, tn, buf, sperm, stgt, sbase, send);
    }
    __syncthreads();
  }
}

bool valid_width(int w) { return w == 1 || w == 2 || w == 4 || w == 8; }

}  // namespace

// -------------------------------------------------------------- C interface
// Every entry point returns a cudaError_t (0 = launched).

// X1.  cols: nkeys device pointers to columns of n_dev * per rows (int64
// values where luts[j] is null, else int32 dictionary codes with lut_size[j]
// uint64 hashes at luts[j]); n_valid: int64[n_dev] device; part: int32[n_dev
// * per]; tile_counts: int64[n_dev][ceil(per / 4096)][n_dev]; counts:
// int64[n_dev][n_dev], zeroed by the caller.
extern "C" int px_partition_count(int nkeys, const void* const* cols, const void* const* luts,
                                  const long long* lut_size, const void* n_valid, long long per,
                                  int n_dev, void* part, void* tile_counts, void* counts,
                                  void* stream) {
  if (nkeys < 1 || nkeys > kMaxKeys || n_dev < 1 || n_dev > kMaxParts || per < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Keys k;
  k.n = nkeys;
  for (int j = 0; j < nkeys; ++j) {
    k.col[j] = cols[j];
    k.lut[j] = static_cast<const unsigned long long*>(luts[j]);
    k.lut_size[j] = lut_size[j];
  }
  const long long n_tiles = (per + kTile - 1) / kTile;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(n_dev));
  partition_count<<<grid, kBlock, n_dev * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      k, static_cast<const long long*>(n_valid), per, n_dev, static_cast<int>(n_tiles),
      static_cast<int*>(part), static_cast<long long*>(tile_counts),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// X2.  src: ncols device pointers to columns of n_dev * per rows of width[c]
// bytes; dst: ncols device pointers to columns of n_dev * n_dev * cap rows;
// table: past 32 columns, 3 * ncols int64 on the device (each column's src,
// dst and width), else ignored; part, tile_counts and counts as X1 wrote
// them; tile_first: int64 scratch shaped like tile_counts (each tile's first
// rank per target, written here); recv: int64[n_dev * n_dev].  Two launches
// (the tiles' scan, then the scatter of every column), whatever ncols.
extern "C" int px_partition_scatter(int ncols, const void* const* src, void* const* dst,
                                    const int* width, const void* table, const void* part,
                                    const void* tile_counts, void* tile_first,
                                    const void* counts, long long per, int n_dev, long long cap,
                                    void* recv, void* stream) {
  if (ncols < 0 || n_dev < 1 || n_dev > kMaxParts || per < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ncols > kMaxInline && table == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  ScatterCols cs;
  cs.n = ncols;
  cs.table = ncols > kMaxInline ? static_cast<const unsigned long long*>(table) : nullptr;
  for (int c = 0; c < ncols; ++c) {
    if (!valid_width(width[c])) return static_cast<int>(cudaErrorInvalidValue);
    if (c < kMaxInline && cs.table == nullptr) {
      cs.src[c] = static_cast<const unsigned char*>(src[c]);
      cs.dst[c] = static_cast<unsigned char*>(dst[c]);
      cs.width[c] = static_cast<unsigned char>(width[c]);
    }
  }
  const long long n_tiles = (per + kTile - 1) / kTile;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int bits = 0;
  while ((1 << bits) < n_dev) ++bits;  // bits of n_dev - 1
  const size_t smem = scatter_smem(n_dev);
  static size_t opted[PX_MAX_DEVICES] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && (dev >= PX_MAX_DEVICES || opted[dev] < smem)) {
    const cudaError_t e = cudaFuncSetAttribute(
        partition_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < PX_MAX_DEVICES) opted[dev] = smem;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int scan_warps = n_tiles < 32 ? static_cast<int>(n_tiles) : 32;
  tile_scan<<<dim3(static_cast<unsigned>(n_dev), static_cast<unsigned>((n_dev + 31) / 32)),
              32 * scan_warps, 0, st>>>(static_cast<const long long*>(tile_counts),
                                        static_cast<long long*>(tile_first), n_dev,
                                        static_cast<int>(n_tiles));
  dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(n_dev));
  partition_scatter<<<grid, kXBlock, smem, st>>>(
      cs, static_cast<const int*>(part), static_cast<const long long*>(tile_first),
      static_cast<const unsigned long long*>(counts), per, n_dev, bits,
      static_cast<int>(n_tiles), cap, static_cast<long long*>(recv));
  return static_cast<int>(cudaGetLastError());
}
