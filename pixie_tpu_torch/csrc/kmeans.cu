// KM1-KM3: the k-means kernels (nearest-center assignment, one Lloyd
// iteration's weighted sums, one k-means++ seeding step).
//
// Replaces: pixie_tpu/ml/kmeans.py _sq_dists (:21, distances as one x @ c.T
// MXU matmul) with the argmin / min around it (:66, :73, :112, :119, and
// ml/coreset.py :35), the _lloyd step (:61-74: assign, then segment_sum of w
// and x * w per center) and the _plusplus_init step (:30-58: distances to the
// chosen centers, the min over them, times w).
//
// Every distance is the reference's expansion |x|^2 - 2 x.c + |c|^2, clamped
// at 0 (NaN passes through, as jnp.maximum lets it), in float32 with FMAs
// summed over the dimensions in order.  Ties go to the lowest center index,
// as argmin does.
//
// KM1 px_kmeans_assign: ids [n] int64 and the min squared distance [n] f32.
//   Bound on the H100: operations.  2 n k d float32 operations; at n = 2^20,
//   d = 64, k = 64 that is 8.6 GFLOP / 67 TFLOP/s = 0.13 ms, against 0.27 GB
//   of x at 3.35 TB/s = 0.08 ms.
//   Design: KM2's distance pass (below) without the sums, in one launch (no
//   norms kernel, no scratch): a persistent grid walks 128-point tiles
//   staged by cp.async, double-buffered; the centers sit transposed in
//   shared memory with their |c|^2, once a block when one tile of centers
//   holds all k; each thread register-tiles KM2's 4 points x 8 centers (1 x
//   4 at k <= 8) in 256-thread blocks, two a SM (8 x 8 in 128-thread blocks
//   ran slower: ab_kernels.py km1_tile8x8).  Each distance folds into the
//   nearest by an integer key (dist_key), one compare a distance; the lanes
//   sharing a point combine their nearest by shuffles and write ids and
//   distances.  The same fmaf chains give the same bits as KM2's
//   assignment.
// KM2 px_kmeans_lloyd: wsum [k] and xsum [k, d] of one Lloyd iteration.
//   Bound: as KM1 (the assignment), plus n (d + 1) additions.
//   Design: one launch.  Each block (two an SM) walks 128-point tiles
//   strided over a grid fixed by n and the card.  A tile's rows (64-column chunks, padded
//   by 16 bytes against bank conflicts) reach shared memory by cp.async,
//   double-buffered: the next tile lands while this one computes.  The
//   centers sit in shared memory a tile of them at a time, transposed
//   ([dim][center]), with the tile's squared norms computed where it is
//   staged (no separate launch; the fixed shared memory does not grow with
//   k).  Distances are register
//   tiled as an SGEMM micro-tile: each thread computes PP points x CC
//   centers (4 x 8 at k > 32; 8 x 8 in 256-point tiles, which loads fewer
//   floats an FMA but holds one block an SM, ran slower) out of shared
//   memory, its points a stride of GP rows apart (a warp's point groups read
//   neighbouring rows, in other banks), each dot product a
//   float32 fmaf chain over the dimensions in order, so ids and distances
//   equal KM1's bit for bit (one kernel template, dist_kernel, runs both);
//   the GC threads sharing a point (adjacent lanes)
//   combine their nearest by shuffles.  Then every warp takes centers and
//   its lanes take columns: for each of its centers a warp finds the tile's
//   points of that center by ballots and, in point order, adds w and the
//   float32 products x * w of each into float64 sums — in registers where
//   k <= 64 and d <= 64 (lane l: columns l and l + 32; lane s: the weight
//   of the warp's s-th center), else in shared memory, repeating the launch
//   over ranges of centers where even those cannot hold them.  No cell has
//   two writers and no float atomics are used.  Each block writes its
//   partial sums; the last block of each group of 16 (a __threadfence and
//   an atomic ticket) sums its group's partials in block order, and the last
//   group sums the groups in group order and writes wsum and xsum in
//   float32 (a thread loads 2 cells of 16 blocks before it adds any).  Each
//   cell thus sums its points in point order within a tile, tiles in the
//   block's order and blocks in a fixed order: a fit gives the same bits run
//   to run on one card.  Every ticket is reset to 0 by the block that takes
//   it last; the wrapper keeps one scratch a stream.
// KM3 px_kmeans_seed_step: one k-means++ step.  mind = min(mind, d(x, c)) for
//   the center chosen last, and p = mind * w with non-finite values set to 0.
//   The reference recomputes all k distances each step and masks the unset
//   slots; the running min is the same minimum over the same distances in
//   O(n d) a step.
//   Bound: bytes.  x, w and mind read once, mind and p written once: at
//   n = 2^20, d = 64, 0.28 GB, 0.08 ms.
//   Design: x streams from memory once a step (it does not fit the L2), so
//   its reads are coalesced and carry the evict-first hint (__ldcs): the 16
//   lanes of a half-warp share a row (16 x float4 = 64 floats), each half
//   keeps 4 rows in flight, and the dot product and |x|^2 are reduced by
//   __shfl_xor_sync; 8 lanes of a warp then write 8 consecutive rows.  |c|^2
//   is computed once a block.  (ab_kernels.py km3_staged times the other
//   design: 128-row tiles staged in shared memory by cp.async, one thread a
//   row summing in dimension order.)

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
// dimensions per shared-memory tile of centers (a multiple of 4)
constexpr int kDT = 64;

__device__ __forceinline__ float clamp_dist(float v) {
  // max(v, 0) that lets NaN through, as jnp.maximum does
  return v < 0.f ? 0.f : v;
}

// ------------------------------------------------------------ KM1 and KM2

constexpr int kTP = 128;           // points a tile
constexpr int kPerSM = 2;          // blocks of a KM1 or KM2 launch an SM holds
constexpr int kXS = kDT + 4;       // floats a staged row chunk (16 bytes of padding)
constexpr int kWarps = kBlock / 32;
constexpr int kRegSlots = 8;       // centers a warp sums in registers
constexpr int kGroup = 16;         // blocks whose partials one block sums first

// What a dist_kernel launch does with a tile's nearest centers.
enum Sums { kAssign, kRegisterSums, kSharedSums };

// The register micro-tile of a center tile of KT with PP points a thread:
// CC centers a thread, GC threads sharing a point (adjacent lanes), kThreads
// threads covering a tile of kTP points.
template <int KT, int PP>
struct Micro {
  static constexpr int CC = KT == 64 ? 8 : 4;
  static constexpr int GC = KT / CC;
  static constexpr int kThreads = GC * kTP / PP;
};

// Points a thread takes (KM1 and KM2): 4 (1 at k <= 8), so 256 threads a
// block.  (8 x 8 in 128-thread blocks, which loads fewer floats an FMA, ran
// slower for KM1: ab_kernels.py km1_tile8x8.)
template <int KT>
constexpr int tile_points() { return KT == 8 ? 1 : 4; }

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// A distance's argmin key: max(v, 0)'s bits plus one, as an int.  The card's
// float arithmetic gives the canonical NaN (0x7fffffff), whose key wraps to
// the least int; a negative v (or -0) keys as +0; the others keep their
// order.  So the least key, the lower index on a tie, is argmin's choice
// over the clamped distances (the first NaN wins, as jnp.argmin's does).
__device__ __forceinline__ int dist_key(float v) {
  return static_cast<int>(static_cast<unsigned>(max(__float_as_int(v), 0)) + 1u);
}

// The clamped distance of a key.
__device__ __forceinline__ float key_dist(int key) {
  return __int_as_float(static_cast<int>(static_cast<unsigned>(key) - 1u));
}

// (key, i) comes before (b, bi): the least key, a tie going to the lower
// index.
__device__ __forceinline__ bool before(int key, int i, int b, int bi) {
  return key < b || (key == b && i < bi);
}

// Shared memory of a dist_kernel block: two x buffers of kTP x kXS floats,
// the center tile ([kDT][KT]) and its KT squared norms, the x tile's ids and
// weights, 4 flag ints, then `rows` x (d + 1) float64 sums (0 rows when
// the sums are in registers or not taken).
template <int KT>
size_t dist_smem(int d, int rows) {
  return sizeof(float) * (2 * kTP * kXS + kDT * KT + KT + 2 * kTP) + 16 +
         sizeof(double) * static_cast<size_t>(rows) * (d + 1);
}

__device__ __forceinline__ void lloyd_out(int e, double s, int d, int c_lo,
                                          float* __restrict__ wsum, float* __restrict__ xsum) {
  const int r = e / (d + 1), j = e - r * (d + 1);
  if (j == d) {
    wsum[c_lo + r] = static_cast<float>(s);
  } else {
    xsum[static_cast<long long>(c_lo + r) * d + j] = static_cast<float>(s);
  }
}

// For every cell e < cells, the sum over b < count of src[b * cells + e] in
// b order, passed to out(e, sum); a thread loads kSumCells cells of
// kSumBatch blocks before it adds any, so their loads are in flight together.
constexpr int kSumCells = 2;
constexpr int kSumBatch = 16;
template <typename Out>
__device__ __forceinline__ void sum_blocks(const double* __restrict__ src, int count, int cells,
                                           Out out) {
  for (int e0 = threadIdx.x; e0 < cells; e0 += blockDim.x * kSumCells) {
    double s[kSumCells];
#pragma unroll
    for (int u = 0; u < kSumCells; ++u) s[u] = 0.0;
    for (int b0 = 0; b0 < count; b0 += kSumBatch) {
      double v[kSumBatch][kSumCells];
#pragma unroll
      for (int b = 0; b < kSumBatch; ++b) {
        const double* row = src + static_cast<long long>(b0 + b) * cells;
#pragma unroll
        for (int u = 0; u < kSumCells; ++u) {
          const int e = e0 + u * blockDim.x;
          v[b][u] = b0 + b < count && e < cells ? __ldcg(row + e) : 0.0;
        }
      }
#pragma unroll
      for (int b = 0; b < kSumBatch; ++b) {
#pragma unroll
        for (int u = 0; u < kSumCells; ++u) {
          if (b0 + b < count) s[u] += v[b][u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSumCells; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < cells) out(e, s[u]);
    }
  }
}

// After every block has written its partial sums: the last block of each
// group of kGroup sums the group's partials in block order; the last group
// sums the groups' sums in group order into wsum and xsum.
__device__ void lloyd_finish(const double* __restrict__ partials, double* __restrict__ gsums,
                             unsigned* __restrict__ tickets, int rows, int d, int c_lo,
                             float* __restrict__ wsum, float* __restrict__ xsum, int* flag) {
  const int cells = rows * (d + 1);
  const int groups = (static_cast<int>(gridDim.x) + kGroup - 1) / kGroup;
  const int g = blockIdx.x / kGroup, b0 = g * kGroup;
  const int nb = min(kGroup, static_cast<int>(gridDim.x) - b0);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) flag[0] = atomicAdd(tickets + g, 1u) == static_cast<unsigned>(nb - 1);
  __syncthreads();
  if (!flag[0]) return;
  __threadfence();
  if (threadIdx.x == 0) tickets[g] = 0u;
  double* gsum = gsums + static_cast<long long>(g) * cells;
  sum_blocks(partials + static_cast<long long>(b0) * cells, nb, cells, [&](int e, double s) {
    if (groups == 1) {
      lloyd_out(e, s, d, c_lo, wsum, xsum);
    } else {
      gsum[e] = s;
    }
  });
  if (groups == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    flag[1] = atomicAdd(tickets + groups, 1u) == static_cast<unsigned>(groups - 1);
  }
  __syncthreads();
  if (!flag[1]) return;
  __threadfence();
  if (threadIdx.x == 0) tickets[groups] = 0u;
  sum_blocks(gsums, groups, cells,
             [&](int e, double s) { lloyd_out(e, s, d, c_lo, wsum, xsum); });
}

// A dist_kernel launch's arguments: x [n, d], c [k, d]; KM1 writes ids and
// mind; KM2 sums w and x * w of the centers [c_lo, c_lo + rows) through
// partials, gsums and tickets into wsum and xsum.
struct KmArgs {
  const float* x;
  const float* w;
  long long n;
  int d;
  const float* c;
  int k;
  long long* ids;
  float* mind;
  int c_lo, rows;
  double* partials;
  double* gsums;
  unsigned* tickets;
  float* wsum;
  float* xsum;
};

// KM1 (kSums == kAssign) or one Lloyd step's sums (KM2; see the file's
// note).  kVec: rows of x 16-byte aligned with d % 4 == 0; kRegisterSums:
// the float64 sums in registers (rows <= kWarps * kRegSlots, d <= kDT).
template <int KT, int PP, bool kVec, int kSums>
__global__ void __launch_bounds__(Micro<KT, PP>::kThreads, kPerSM) dist_kernel(const KmArgs a) {
  using M = Micro<KT, PP>;
  constexpr int CC = M::CC, GC = M::GC, kT = M::kThreads, GP = kT / GC;
  static_assert(GP * PP == kTP, "a tile is GP x PP points");
  static_assert(32 % GC == 0, "the threads of a point share a warp");
  static_assert(kSums == kAssign || kT == kBlock, "the sums take kBlock threads");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* cs = xs + 2 * kTP * kXS;
  float* c2s = cs + kDT * KT;
  int* tile_ids = reinterpret_cast<int*>(c2s + KT);
  float* tile_w = reinterpret_cast<float*>(tile_ids + kTP);
  int* flag = reinterpret_cast<int*>(tile_w + kTP);
  double* sums = reinterpret_cast<double*>(flag + 4);

  const float* __restrict__ x = a.x;
  const float* __restrict__ c = a.c;
  const long long n = a.n;
  const int d = a.d, k = a.k, c_lo = a.c_lo, rows = a.rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tc = tid % GC, tp = tid / GC;
  const int width = d + 1;
  const int nc = (d + kDT - 1) / kDT;  // 64-column chunks of a row
  const int nct = (k + KT - 1) / KT;   // center tiles
  const bool once = nc == 1 && nct == 1;

  // The centers of a (center tile, column chunk), transposed and padded with
  // 0; with the first chunk, the tile's |c|^2, an fmaf chain in dimension
  // order.
  auto stage_centers = [&](int kt, int dc) {
    const int k0 = kt * KT, d0 = dc * kDT;
    const int kc = min(KT, k - k0), dcw = min(kDT, d - d0);
    if (dc == 0) {
      for (int t = tid; t < KT; t += kT) {
        float s = 0.f;
        if (t < kc) {
          const float* r = c + static_cast<long long>(k0 + t) * d;
#pragma unroll 16
          for (int j = 0; j < d; ++j) s = fmaf(r[j], r[j], s);
        }
        c2s[t] = s;
      }
    }
    for (int i = tid; i < KT * kDT; i += kT) {
      const int j = i / KT, t = i - j * KT;
      cs[i] = (t < kc && j < dcw) ? c[static_cast<long long>(k0 + t) * d + d0 + j] : 0.f;
    }
  };

  // prologue: both x buffers zeroed (padding columns stay 0), the sums, and
  // the centers when one tile holds them all
  for (int i = tid; i < 2 * kTP * kXS; i += kT) xs[i] = 0.f;
  if constexpr (kSums == kSharedSums) {
    for (int i = tid; i < rows * width; i += kT) sums[i] = 0.0;
  }
  if (once) stage_centers(0, 0);
  __syncthreads();

  // x stages: one a tile when a row is one chunk, else one a (center tile,
  // chunk) of each tile
  const long long tiles = (n + kTP - 1) / kTP;
  const long long my_tiles = (tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const int spt = nc == 1 ? 1 : nct * nc;
  const long long stages = my_tiles * spt;
  auto issue = [&](long long s) {
    const long long p0 = (blockIdx.x + (s / spt) * gridDim.x) * kTP;
    const int dc = static_cast<int>(s % spt) % nc;
    const int np = static_cast<int>(min(static_cast<long long>(kTP), n - p0));
    const int d0 = dc * kDT, dcw = min(kDT, d - d0);
    float* buf = xs + (s & 1) * (kTP * kXS);
    const float* src = x + p0 * d + d0;
    if constexpr (kVec) {
      const int per = dcw >> 2;
      for (int i = tid; i < np * per; i += kT) {
        const int r = i / per, j = (i - r * per) << 2;
        cp_async16(buf + r * kXS + j, src + static_cast<long long>(r) * d + j);
      }
    } else {
      for (int i = tid; i < np * dcw; i += kT) {
        const int r = i / dcw, j = i - r * dcw;
        cp_async4(buf + r * kXS + j, src + static_cast<long long>(r) * d + j);
      }
      // an earlier, wider chunk may have left values in the padding
      const int pad = round4(dcw) - dcw;
      for (int i = tid; i < np * pad; i += kT) buf[(i / pad) * kXS + dcw + i % pad] = 0.f;
    }
    cp_async_commit();
  };

  // the float64 sums held in registers: slot s of warp v is center
  // v + kWarps * s; lane l holds its columns l and l + 32, lane s its weight
  constexpr int kSlots = kSums == kRegisterSums ? kRegSlots : 1;
  double rs[kSlots][2];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) rs[s][0] = rs[s][1] = 0.0;
  double rw = 0.0;

  // w and w * x of the tile's points into the sums of their centers: a warp
  // takes centers, its lanes take columns; for each of its centers a warp
  // finds the center's points by ballots and adds them in point order
  auto accumulate = [&](const float* buf, long long p0) {
    if constexpr (kSums == kRegisterSums) {
#pragma unroll
      for (int sl = 0; sl < kRegSlots; ++sl) {
        const int cr = warp + kWarps * sl;
        if (cr < rows) {
          for (int q0 = 0; q0 < kTP; q0 += 32) {
            unsigned bal = __ballot_sync(0xffffffffu, tile_ids[q0 + lane] == cr);
            while (bal) {
              const int q = q0 + __ffs(bal) - 1;
              bal &= bal - 1;
              const float wq = tile_w[q];
              const float* row = buf + q * kXS;
              // the float32 product x * w, rounded as the reference rounds
              // it (no FMA contraction into the float64 add)
              if (lane < d) rs[sl][0] += static_cast<double>(__fmul_rn(row[lane], wq));
              if (lane + 32 < d) rs[sl][1] += static_cast<double>(__fmul_rn(row[lane + 32], wq));
              if (lane == sl) rw += static_cast<double>(wq);
            }
          }
        }
      }
    } else if constexpr (kSums == kSharedSums) {
      for (int cr = warp; cr < rows; cr += kWarps) {
        double* cell = sums + cr * width;
        for (int q0 = 0; q0 < kTP; q0 += 32) {
          unsigned bal = __ballot_sync(0xffffffffu, tile_ids[q0 + lane] == cr);
          while (bal) {
            const int q = q0 + __ffs(bal) - 1;
            bal &= bal - 1;
            const float wq = tile_w[q];
            for (int j = lane; j < width; j += 32) {
              // a row wider than one chunk is read again, from the L2
              const float v =
                  j == d ? wq
                         : __fmul_rn(nc == 1 ? buf[q * kXS + j] : __ldg(x + (p0 + q) * d + j), wq);
              cell[j] += static_cast<double>(v);
            }
          }
        }
      }
    }
  };

  // point i of this thread is row tp + GP * i of the tile; bk, bi its
  // nearest center so far (dist_key, index)
  float acc[PP][CC], x2[PP];
  int bk[PP], bi[PP];
  if (stages > 0) issue(0);
  for (long long s = 0; s < stages; ++s) {
    cp_async_wait<0>();
    // stage s has landed, from every thread's copies; and every warp is done
    // with stage s - 1 (its buffer, the next stage's, and the tile's ids)
    __syncthreads();
    if (s + 1 < stages) issue(s + 1);
    const long long p0 = (blockIdx.x + (s / spt) * gridDim.x) * kTP;
    const int r = static_cast<int>(s % spt);
    const int dc = r % nc;
    const int kt0 = nc == 1 ? 0 : r / nc, kt1 = nc == 1 ? nct : r / nc + 1;
    const float* buf = xs + (s & 1) * (kTP * kXS);
    if (r == 0) {
#pragma unroll
      for (int i = 0; i < PP; ++i) {
        x2[i] = 0.f;
        bk[i] = 0x7fffffff;
        bi[i] = 0x7fffffff;
      }
    }
    for (int kt = kt0; kt < kt1; ++kt) {
      if (!once) {
        __syncthreads();  // the previous center tile is consumed
        stage_centers(kt, dc);
        __syncthreads();
      }
      if (dc == 0) {
#pragma unroll
        for (int i = 0; i < PP; ++i)
#pragma unroll
          for (int t = 0; t < CC; ++t) acc[i][t] = 0.f;
      }
      const int dc4 = round4(min(kDT, d - dc * kDT));
      for (int j = 0; j < dc4; j += 4) {
        float4 xv[PP];
#pragma unroll
        for (int i = 0; i < PP; ++i) {
          xv[i] = *reinterpret_cast<const float4*>(buf + (tp + GP * i) * kXS + j);
        }
        if (kt == 0) {
#pragma unroll
          for (int i = 0; i < PP; ++i) {
            x2[i] = fmaf(xv[i].x, xv[i].x, x2[i]);
            x2[i] = fmaf(xv[i].y, xv[i].y, x2[i]);
            x2[i] = fmaf(xv[i].z, xv[i].z, x2[i]);
            x2[i] = fmaf(xv[i].w, xv[i].w, x2[i]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float cv[CC];
#pragma unroll
          for (int g = 0; g < CC / 4; ++g) {
            const float4 v =
                *reinterpret_cast<const float4*>(cs + (j + e) * KT + g * GC * 4 + tc * 4);
            cv[g * 4 + 0] = v.x;
            cv[g * 4 + 1] = v.y;
            cv[g * 4 + 2] = v.z;
            cv[g * 4 + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < PP; ++i) {
            const float xe = e == 0 ? xv[i].x : e == 1 ? xv[i].y : e == 2 ? xv[i].z : xv[i].w;
#pragma unroll
            for (int t = 0; t < CC; ++t) acc[i][t] = fmaf(xe, cv[t], acc[i][t]);
          }
        }
      }
      if (dc == nc - 1) {
#pragma unroll
        // a thread meets its centers in index order: the strictly less
        // key keeps the lower index on a tie
        for (int t = 0; t < CC; ++t) {
          const int ct = (t / 4) * GC * 4 + tc * 4 + (t & 3), ci = kt * KT + ct;
          if (ci < k) {
            const float c2 = c2s[ct];
#pragma unroll
            for (int i = 0; i < PP; ++i) {
              const int key = dist_key((x2[i] - 2.f * acc[i][t]) + c2);
              if (key < bk[i]) {
                bk[i] = key;
                bi[i] = ci;
              }
            }
          }
        }
      }
    }
    if (r == spt - 1) {
      // the nearest over every center: combine the GC threads of a point
#pragma unroll
      for (int i = 0; i < PP; ++i) {
#pragma unroll
        for (int off = 1; off < GC; off <<= 1) {
          const int ok = __shfl_xor_sync(0xffffffffu, bk[i], off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
          if (before(ok, oi, bk[i], bi[i])) {
            bk[i] = ok;
            bi[i] = oi;
          }
        }
      }
      if constexpr (kSums == kAssign) {
        // every lane of a point group holds its points' nearest: lane tc
        // writes the points i with i % GC == tc
#pragma unroll
        for (int i = 0; i < PP; ++i) {
          const long long p = p0 + tp + GP * i;
          if (i % GC == tc && p < n) {
            a.ids[p] = bi[i];
            a.mind[p] = key_dist(bk[i]);
          }
        }
      } else {
        if (tc == 0) {
#pragma unroll
          for (int i = 0; i < PP; ++i) {
            const int q = tp + GP * i;
            const bool live = p0 + q < n;
            const int rel = bi[i] - c_lo;
            tile_ids[q] = live && rel >= 0 && rel < rows ? rel : -1;
            tile_w[q] = live ? a.w[p0 + q] : 0.f;
          }
        }
        __syncthreads();
        accumulate(buf, p0);
      }
    }
  }
  if constexpr (kSums != kAssign) {
    __syncthreads();  // the x buffers are free (the shared sums are complete)
    double* mine = a.partials + static_cast<long long>(blockIdx.x) * rows * width;
    if constexpr (kSums == kRegisterSums) {
#pragma unroll
      for (int sl = 0; sl < kRegSlots; ++sl) {
        const int cr = warp + kWarps * sl;
        if (cr < rows) {
          double* o = mine + cr * width;
          if (lane < d) o[lane] = rs[sl][0];
          if (lane + 32 < d) o[lane + 32] = rs[sl][1];
          if (lane == sl) o[d] = rw;
        }
      }
    } else {
      for (int i = tid; i < rows * width; i += kT) mine[i] = sums[i];
    }
    lloyd_finish(a.partials, a.gsums, a.tickets, rows, d, c_lo, a.wsum, a.xsum, flag);
  }
}

// ------------------------------------------------------------------ KM3

constexpr int kSeedRows = 4;  // rows a half-warp has in flight

__device__ __forceinline__ void seed_fold(long long i, float x2, float dot, float c2,
                                          const float* __restrict__ w, float* __restrict__ mind,
                                          float* __restrict__ p) {
  const float dd = clamp_dist((x2 - 2.f * dot) + c2);
  float m = mind[i];
  // jnp.min over the chosen centers: NaN propagates
  if (!isnan(m) && (isnan(dd) || dd < m)) m = dd;
  mind[i] = m;
  const float v = m * w[i];
  p[i] = isfinite(v) ? v : 0.f;
}

// kVec: x and c 16-byte aligned with d % 4 == 0 (a lane reads float4s).
template <bool kVec>
__global__ void __launch_bounds__(kBlock) seed_step_lanes(
    const float* __restrict__ x, const float* __restrict__ w, long long n, int d,
    const float* __restrict__ c, float* __restrict__ mind, float* __restrict__ p) {
  constexpr int U = kSeedRows;
  __shared__ float c2s;
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(__ldg(c + j), __ldg(c + j), s);
    c2s = s;
  }
  __syncthreads();
  const float c2 = c2s;
  const int lane = threadIdx.x & 31, h = lane >> 4, l16 = lane & 15;
  const long long warps = static_cast<long long>(gridDim.x) * (kBlock / 32);
  const long long warp0 = (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) >> 5;
  const int units = kVec ? d >> 2 : d;  // float4s (or floats) of a row
  const float4* c4 = reinterpret_cast<const float4*>(c);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 c_first = kVec && l16 < units ? __ldg(c4 + l16) : zero;
  for (long long base = warp0 * 2 * U; base < n; base += warps * 2 * U) {
    float dot[U], x2[U];
#pragma unroll
    for (int u = 0; u < U; ++u) dot[u] = x2[u] = 0.f;
    for (int jb = 0; jb < units; jb += 16) {
      const int j = jb + l16;
      const bool on = j < units;
      if constexpr (kVec) {
        float4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long row = base + 2 * u + h;
          v[u] = on && row < n ? __ldcs(reinterpret_cast<const float4*>(x + row * d) + j) : zero;
        }
        const float4 cv = jb == 0 ? c_first : (on ? __ldg(c4 + j) : zero);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          x2[u] = fmaf(v[u].x, v[u].x, x2[u]);
          x2[u] = fmaf(v[u].y, v[u].y, x2[u]);
          x2[u] = fmaf(v[u].z, v[u].z, x2[u]);
          x2[u] = fmaf(v[u].w, v[u].w, x2[u]);
          dot[u] = fmaf(v[u].x, cv.x, dot[u]);
          dot[u] = fmaf(v[u].y, cv.y, dot[u]);
          dot[u] = fmaf(v[u].z, cv.z, dot[u]);
          dot[u] = fmaf(v[u].w, cv.w, dot[u]);
        }
      } else {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long row = base + 2 * u + h;
          v[u] = on && row < n ? __ldcs(x + row * d + j) : 0.f;
        }
        const float cv = on ? __ldg(c + j) : 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          x2[u] = fmaf(v[u], v[u], x2[u]);
          dot[u] = fmaf(v[u], cv, dot[u]);
        }
      }
    }
    float my_dot = 0.f, my_x2 = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
        x2[u] += __shfl_xor_sync(0xffffffffu, x2[u], off);
      }
      if (l16 == u) {
        my_dot = dot[u];
        my_x2 = x2[u];
      }
    }
    // lanes 0..U-1 of each half: rows base + 2 l16 + h, 2U consecutive rows
    const long long row = base + 2 * l16 + h;
    if (l16 < U && row < n) seed_fold(row, my_x2, my_dot, c2, w, mind, p);
  }
}

bool rows_vectorizable(const float* x, int d) {
  return d % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

// Centers per shared-memory tile for k centers.
int tile_centers(int k) { return k <= 8 ? 8 : (k <= 32 ? 32 : 64); }

// Blocks of a KM1 or KM2 launch: a fixed function of n and the card, so the
// block order of KM2's sums, and with it the result, is the same every run.
long long dist_grid(long long n) {
  const long long tiles = (n + kTP - 1) / kTP;
  const long long cap = static_cast<long long>(kPerSM) * px_sm_count();
  const long long g = tiles < cap ? tiles : cap;
  return g < 1 ? 1 : g;
}

long long lloyd_groups(long long grid) { return (grid + kGroup - 1) / kGroup; }

// KM2 keeps its float64 sums in registers when every center fits the
// warps' slots and a row fits one chunk.
bool lloyd_in_registers(int k, int d) { return k <= kWarps * kRegSlots && d <= kDT; }

// Centers whose sums one launch holds: all k in registers, else as many as
// fit the shared memory left beside the fixed part (0: not even one).
template <int KT>
int lloyd_rows(int k, int d, bool reg) {
  const size_t fixed = dist_smem<KT>(d, 0);
  const size_t budget = static_cast<size_t>(px_smem_optin());
  if (budget < fixed) return 0;
  if (reg) return k;
  const long long rows = static_cast<long long>((budget - fixed) / (sizeof(double) * (d + 1)));
  return static_cast<int>(rows < k ? rows : k);
}

int lloyd_rows_for(int k, int d, bool reg) {
  switch (tile_centers(k)) {
    case 8: return lloyd_rows<8>(k, d, reg);
    case 32: return lloyd_rows<32>(k, d, reg);
    default: return lloyd_rows<64>(k, d, reg);
  }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on the current
// card (`opted`: the kernel's sizes set so far, a card each).
template <typename Kernel>
int opt_in(Kernel kernel, size_t smem, size_t* opted) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < PX_MAX_DEVICES && opted[dev] >= smem) return 0;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (err == 0 && dev < PX_MAX_DEVICES) opted[dev] = smem;
  return err;
}

template <int KT, bool kVec>
int launch_assign(const KmArgs& a, cudaStream_t stream) {
  constexpr int PP = tile_points<KT>();
  static size_t opted[PX_MAX_DEVICES] = {0};
  const size_t smem = dist_smem<KT>(a.d, 0);
  const int err = opt_in(dist_kernel<KT, PP, kVec, kAssign>, smem, opted);
  if (err != 0) return err;
  dist_kernel<KT, PP, kVec, kAssign>
      <<<static_cast<unsigned>(dist_grid(a.n)), Micro<KT, PP>::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KT, bool kVec, bool kReg>
int launch_lloyd(KmArgs a, double* scratch, cudaStream_t stream) {
  constexpr int PP = tile_points<KT>();
  constexpr int kSums = kReg ? kRegisterSums : kSharedSums;
  static size_t opted[PX_MAX_DEVICES] = {0};
  const int rows = a.rows, k = a.k;
  const size_t smem = dist_smem<KT>(a.d, kReg ? 0 : rows);
  const int err = opt_in(dist_kernel<KT, PP, kVec, kSums>, smem, opted);
  if (err != 0) return err;
  const long long grid = dist_grid(a.n);
  const long long cells = static_cast<long long>(rows) * (a.d + 1);
  a.partials = scratch;
  a.gsums = scratch + grid * cells;
  for (int c_lo = 0; c_lo < k; c_lo += rows) {
    a.c_lo = c_lo;
    a.rows = rows < k - c_lo ? rows : k - c_lo;
    dist_kernel<KT, PP, kVec, kSums>
        <<<static_cast<unsigned>(grid), Micro<KT, PP>::kThreads, smem, stream>>>(a);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

template <int KT>
int launch_lloyd_kt(const KmArgs& a, double* scratch, bool vec, bool reg, cudaStream_t stream) {
  if (vec) {
    return reg ? launch_lloyd<KT, true, true>(a, scratch, stream)
               : launch_lloyd<KT, true, false>(a, scratch, stream);
  }
  return reg ? launch_lloyd<KT, false, true>(a, scratch, stream)
             : launch_lloyd<KT, false, false>(a, scratch, stream);
}

template <int KT>
int launch_assign_kt(const KmArgs& a, bool vec, cudaStream_t stream) {
  return vec ? launch_assign<KT, true>(a, stream) : launch_assign<KT, false>(a, stream);
}

template <bool kVec>
int launch_seed_lanes(const float* x, const float* w, long long n, int d, const float* c,
                      float* mind, float* p, cudaStream_t stream) {
  const long long threads = (n + 2 * kSeedRows - 1) / (2 * kSeedRows) * 32;
  const long long grid = px_grid(seed_step_lanes<kVec>, threads, kBlock, 0);
  seed_step_lanes<kVec><<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(x, w, n, d, c,
                                                                           mind, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// KM1: one launch.
extern "C" int px_kmeans_assign(const float* x, long long n, int d, const float* c, int k,
                                long long* ids, float* mind, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (d <= 0 || k <= 0) return static_cast<int>(cudaErrorInvalidValue);
  KmArgs a{};
  a.x = x;
  a.n = n;
  a.d = d;
  a.c = c;
  a.k = k;
  a.ids = ids;
  a.mind = mind;
  const bool vec = rows_vectorizable(x, d);
  switch (tile_centers(k)) {
    case 8: return launch_assign_kt<8>(a, vec, stream);
    case 32: return launch_assign_kt<32>(a, vec, stream);
    default: return launch_assign_kt<64>(a, vec, stream);
  }
}

// KM2's plan for n points, d dimensions and k centers on card `device`:
// out[0] the float64 elements of the partial sums' scratch, out[1] the
// uint32 tickets (zeroed once by the caller; every launch leaves them 0),
// out[2] the grid, out[3] the centers a launch sums (out[0] = 0 when shared
// memory cannot hold even one center's sums), out[4] the points a tile.
extern "C" int px_kmeans_lloyd_scratch(long long n, int d, int k, int device, long long* out) {
  if (d <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  PxDeviceScope on(device);
  const bool reg = lloyd_in_registers(k, d);
  const int rows = lloyd_rows_for(k, d, reg);
  const long long grid = dist_grid(n), groups = lloyd_groups(grid);
  const long long cells = static_cast<long long>(rows) * (d + 1);
  out[0] = rows > 0 ? (grid + (groups > 1 ? groups : 0)) * cells : 0;
  out[1] = groups + 1;
  out[2] = grid;
  out[3] = rows;
  out[4] = kTP;
  return 0;
}

// KM2.  wsum [k] and xsum [k, d] are written (not added to); scratch and
// tickets are px_kmeans_lloyd_scratch's, used by one stream at a time.
extern "C" int px_kmeans_lloyd(const float* x, const float* w, long long n, int d,
                               const float* c, int k, float* wsum, float* xsum, double* scratch,
                               unsigned* tickets, int device, cudaStream_t stream) {
  if (d <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  PxDeviceScope on(device);
  const bool reg = lloyd_in_registers(k, d);
  const int rows = lloyd_rows_for(k, d, reg);
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  KmArgs a{};
  a.x = x;
  a.w = w;
  a.n = n;
  a.d = d;
  a.c = c;
  a.k = k;
  a.rows = rows;
  a.tickets = tickets;
  a.wsum = wsum;
  a.xsum = xsum;
  const bool vec = rows_vectorizable(x, d);
  switch (tile_centers(k)) {
    case 8: return launch_lloyd_kt<8>(a, scratch, vec, reg, stream);
    case 32: return launch_lloyd_kt<32>(a, scratch, vec, reg, stream);
    default: return launch_lloyd_kt<64>(a, scratch, vec, reg, stream);
  }
}

// KM3.  c: the center chosen last ([d]); mind [n] is folded in place.
extern "C" int px_kmeans_seed_step(const float* x, const float* w, long long n, int d,
                                   const float* c, float* mind, float* p,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = rows_vectorizable(x, d) && (reinterpret_cast<uintptr_t>(c) & 15) == 0;
  return vec ? launch_seed_lanes<true>(x, w, n, d, c, mind, p, stream)
             : launch_seed_lanes<false>(x, w, n, d, c, mind, p, stream);
}
