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
//  X2 px_partition_scatter: given part and each tile's first rank per target
//     (an exclusive scan of X1's tile counts over the tiles of a shard), every
//     column of row r of shard i with target p goes to row
//     (p * n_dev + i) * cap + rank, rank = the rows of shard i with target p
//     before r.  So row-block p * n_dev + i holds shard i's rows for
//     partition p in row order -- the reference orders a bucket by
//     (partition, row index) -- which is the layout the reference's
//     all_to_all delivers.  A row whose rank reaches cap is not written: the
//     received counts min(count, cap) then fall short of the rows sent, and
//     the host's conservation check fails loudly.  Rows past a block's count
//     are left as they were (the host reads only [0, count)).
//
// Bound on the H100: bytes.  X1 reads the key columns and writes part: at
// one int64 and one int32 key, 16 B a row (2^24 rows: 0.080 ms at 3.35 TB/s).
// X2 reads part and every column and writes every column: 4 + 2 * (column
// bytes) a row.  The tile counts are 1/4096 of that.
//
// Design: a block covers one tile of kTile rows of one shard (blockIdx.y is
// the shard), in chunks of kBlock rows.  In each chunk the lanes of a warp
// that share a target find each other with __match_any_sync: the lowest of
// them adds the group's size to the tile's shared-memory histogram (X1), or
// records it per warp (X2), where a lane's rank is its popcount among the
// lower lanes of its group, plus the counts of the lower warps, plus the
// ranks the tile's earlier chunks took.  No sort: one pass of X1, one scan
// of the tile counts (torch.cumsum) and one pass of X2 give the stable order.
// The scatter's stores are scattered (one row at a time per column); a
// simple kernel, right first.

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
// rows of one shard that one block covers
constexpr int kTile = 4096;
constexpr int kMaxKeys = 8;
constexpr int kMaxCols = 16;
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

struct Cols {
  const unsigned char* src[kMaxCols];
  unsigned char* dst[kMaxCols];
  int width[kMaxCols];
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

__device__ __forceinline__ void copy_row(const Cols& cols, long long src, long long dst) {
  for (int c = 0; c < cols.n; ++c) {
    switch (cols.width[c]) {
      case 8:
        reinterpret_cast<unsigned long long*>(cols.dst[c])[dst] =
            reinterpret_cast<const unsigned long long*>(cols.src[c])[src];
        break;
      case 4:
        reinterpret_cast<unsigned*>(cols.dst[c])[dst] =
            reinterpret_cast<const unsigned*>(cols.src[c])[src];
        break;
      case 2:
        reinterpret_cast<unsigned short*>(cols.dst[c])[dst] =
            reinterpret_cast<const unsigned short*>(cols.src[c])[src];
        break;
      default:
        cols.dst[c][dst] = cols.src[c][src];
    }
  }
}

__global__ void __launch_bounds__(kBlock)
    partition_scatter(Cols cols, const int* __restrict__ part,
                      const long long* __restrict__ tile_first,
                      const unsigned long long* __restrict__ counts, long long per, int n_dev,
                      int n_tiles, long long cap, long long* __restrict__ recv) {
  extern __shared__ long long smem[];
  long long* first = smem;                    // [n_dev] the tile's first rank per target
  int* taken = reinterpret_cast<int*>(first + n_dev);  // [n_dev] ranks taken so far
  int* wcnt = taken + n_dev;                  // [kWarps][n_dev] this chunk's rows per warp
  const int s = blockIdx.y;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = threadIdx.x; p < n_dev; p += kBlock) {
    first[p] = tile_first[(static_cast<long long>(s) * n_tiles + t) * n_dev + p];
    taken[p] = 0;
    if (t == 0) {
      const unsigned long long c = counts[static_cast<long long>(s) * n_dev + p];
      recv[static_cast<long long>(p) * n_dev + s] =
          c < static_cast<unsigned long long>(cap) ? static_cast<long long>(c) : cap;
    }
  }
  for (int j = threadIdx.x; j < kWarps * n_dev; j += kBlock) wcnt[j] = 0;
  __syncthreads();
  const long long row0 = static_cast<long long>(s) * per;
  const long long lo = static_cast<long long>(t) * kTile;
  const long long hi = lo + kTile < per ? lo + kTile : per;
  for (long long i0 = lo; i0 < hi; i0 += kBlock) {
    const long long i = i0 + threadIdx.x;
    const int p = i < hi ? part[row0 + i] : n_dev;
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    const bool leader = lane == __ffs(peers) - 1;
    if (p < n_dev && leader) wcnt[warp * n_dev + p] = __popc(peers);
    __syncthreads();
    if (p < n_dev) {
      long long rank = first[p] + taken[p] + __popc(peers & ((1u << lane) - 1u));
      for (int w = 0; w < warp; ++w) rank += wcnt[w * n_dev + p];
      if (rank < cap) copy_row(cols, row0 + i, (static_cast<long long>(p) * n_dev + s) * cap + rank);
    }
    __syncthreads();
    if (p < n_dev && leader) {
      atomicAdd(&taken[p], __popc(peers));
      wcnt[warp * n_dev + p] = 0;
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
// part and counts as X1 wrote them; tile_first: int64 like X1's tile_counts,
// each tile's first rank per target; recv: int64[n_dev * n_dev].
extern "C" int px_partition_scatter(int ncols, const void* const* src, void* const* dst,
                                    const int* width, const void* part, const void* tile_first,
                                    const void* counts, long long per, int n_dev, long long cap,
                                    void* recv, void* stream) {
  if (ncols < 0 || n_dev < 1 || n_dev > kMaxParts || per < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < ncols; ++c) {
    if (!valid_width(width[c])) return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_tiles = (per + kTile - 1) / kTile;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(n_dev));
  const size_t smem = n_dev * (sizeof(long long) + sizeof(int) * (1 + kWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // more than kMaxCols columns take one launch per kMaxCols (each launch
  // ranks the rows again; the ranks are the same)
  int c0 = 0;
  do {
    Cols cs;
    cs.n = ncols - c0 < kMaxCols ? ncols - c0 : kMaxCols;
    for (int c = 0; c < cs.n; ++c) {
      cs.src[c] = static_cast<const unsigned char*>(src[c0 + c]);
      cs.dst[c] = static_cast<unsigned char*>(dst[c0 + c]);
      cs.width[c] = width[c0 + c];
    }
    partition_scatter<<<grid, kBlock, smem, s>>>(
        cs, static_cast<const int*>(part), static_cast<const long long*>(tile_first),
        static_cast<const unsigned long long*>(counts), per, n_dev, static_cast<int>(n_tiles),
        cap, static_cast<long long*>(recv));
    c0 += cs.n;
  } while (c0 < ncols);
  return static_cast<int>(cudaGetLastError());
}
