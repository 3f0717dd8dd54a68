// Parallel radix hash equijoin over int64 key codes — the host join
// (ops/join_device.py native_join; the executor's join on a CPU device).
// The port's copy of the reference's native/join.cc, unchanged in code.
//
// Reference: exec/equijoin_node.h builds one global hash table and probes
// row by row.  Reshaped for the hardware (Flare/Tailwind's lesson): both
// sides hash-partition into power-of-two buckets first (two sequential
// passes, multi-threaded over row chunks), then each bucket builds a small
// open-addressing table that lives in cache and probes emit (build, probe)
// row-index pairs — buckets are independent, so the match phase parallelizes
// over a thread pool with no locks.  Measured vs the XLA sort/searchsorted
// kernel at 16M x 16M uniform keys: ~10x.
//
// Protocol (ctypes, no pybind11):
//   h = px_join_run(bcodes, nb, pcodes, np, &total)   — partition + match
//   px_join_fetch(h, bidx, pidx)                      — copy pairs out
//   px_join_free(h)
// Pairs come back bucket-major (probe order within a bucket); the caller
// treats pair order as unspecified, same as the device kernel contract.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

int pool_threads() {
  unsigned hc = std::thread::hardware_concurrency();
  return (int)std::min(hc ? hc : 1u, 8u);
}

// One side, radix-partitioned by the top log2(B) bits of the mixed code.
struct Part {
  std::vector<int64_t> codes;
  std::vector<int64_t> idx;
  std::vector<int64_t> offs;  // B + 1 bucket boundaries
};

void partition(const int64_t* c, int64_t n, int B, int T, Part* out) {
  int lb = 0;
  while ((1 << lb) < B) lb++;
  // B==1 would need a 64-bit shift (UB); shift 63 + the B-1 mask gives 0
  int shift = lb ? 64 - lb : 63;
  uint64_t bmask = (uint64_t)(B - 1);
  out->codes.resize(n);
  out->idx.resize(n);
  out->offs.assign(B + 1, 0);
  std::vector<std::vector<int64_t>> hist(T, std::vector<int64_t>(B, 0));
  int64_t chunk = (n + T - 1) / T;
  std::vector<std::thread> th;
  for (int t = 0; t < T; t++)
    th.emplace_back([&, t] {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      auto& h = hist[t];
      for (int64_t i = lo; i < hi; i++) h[(mix64((uint64_t)c[i]) >> shift) & bmask]++;
    });
  for (auto& x : th) x.join();
  th.clear();
  std::vector<std::vector<int64_t>> base(T, std::vector<int64_t>(B));
  int64_t run = 0;
  for (int b = 0; b < B; b++) {
    out->offs[b] = run;
    for (int t = 0; t < T; t++) {
      base[t][b] = run;
      run += hist[t][b];
    }
  }
  out->offs[B] = run;
  for (int t = 0; t < T; t++)
    th.emplace_back([&, t] {
      int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
      auto& wb = base[t];
      for (int64_t i = lo; i < hi; i++) {
        int b = (int)((mix64((uint64_t)c[i]) >> shift) & bmask);
        int64_t w = wb[b]++;
        out->codes[w] = c[i];
        out->idx[w] = i;
      }
    });
  for (auto& x : th) x.join();
}

struct JoinHandle {
  std::vector<std::vector<int64_t>> outb, outp;  // per-bucket pair halves
  int64_t total = 0;
};

}  // namespace

extern "C" {

void* px_join_run(const int64_t* bcodes, int64_t nb, const int64_t* pcodes,
                  int64_t npr, int64_t* total_out) {
  int T = pool_threads();
  // ~128K rows per bucket keeps the per-bucket table in L2 while the
  // partition histograms stay trivial
  int B = 1;
  while ((int64_t)B * (128 << 10) < nb + npr && B < 4096) B <<= 1;
  Part pb, pp;
  {
    std::thread tb([&] { partition(bcodes, nb, B, std::max(1, T / 2), &pb); });
    partition(pcodes, npr, B, std::max(1, T - T / 2), &pp);
    tb.join();
  }
  auto* h = new JoinHandle;
  h->outb.resize(B);
  h->outp.resize(B);
  std::atomic<int> next{0};
  std::atomic<int64_t> total{0};
  std::vector<std::thread> th;
  for (int t = 0; t < T; t++)
    th.emplace_back([&] {
      std::vector<int32_t> head, nxt;
      for (;;) {
        int b = next.fetch_add(1);
        if (b >= B) break;
        int64_t bs = pb.offs[b], be = pb.offs[b + 1];
        int64_t ps = pp.offs[b], pe = pp.offs[b + 1];
        int64_t bn = be - bs, pn = pe - ps;
        if (!bn || !pn) continue;
        uint64_t cap = 1;
        while (cap < (uint64_t)bn * 2) cap <<= 1;
        uint64_t mask = cap - 1;
        head.assign(cap, -1);
        nxt.assign(bn, -1);
        // insert build rows; duplicate codes chain through nxt
        for (int64_t i = 0; i < bn; i++) {
          uint64_t slot = mix64((uint64_t)pb.codes[bs + i]) & mask;
          for (;;) {
            int32_t cur = head[slot];
            if (cur < 0) {
              head[slot] = (int32_t)i;
              break;
            }
            if (pb.codes[bs + cur] == pb.codes[bs + i]) {
              nxt[i] = cur;
              head[slot] = (int32_t)i;
              break;
            }
            slot = (slot + 1) & mask;
          }
        }
        auto& ob = h->outb[b];
        auto& op = h->outp[b];
        ob.reserve(pn);
        op.reserve(pn);
        for (int64_t j = 0; j < pn; j++) {
          int64_t code = pp.codes[ps + j];
          uint64_t slot = mix64((uint64_t)code) & mask;
          for (;;) {
            int32_t cur = head[slot];
            if (cur < 0) break;
            if (pb.codes[bs + cur] == code) {
              for (int32_t k = cur; k >= 0; k = nxt[k]) {
                ob.push_back(pb.idx[bs + k]);
                op.push_back(pp.idx[ps + j]);
              }
              break;
            }
            slot = (slot + 1) & mask;
          }
        }
        total += (int64_t)ob.size();
      }
    });
  for (auto& x : th) x.join();
  h->total = total.load();
  *total_out = h->total;
  return h;
}

void px_join_fetch(void* vh, int64_t* bidx, int64_t* pidx) {
  auto* h = (JoinHandle*)vh;
  // per-bucket output offsets, then copy in parallel
  size_t B = h->outb.size();
  std::vector<int64_t> offs(B + 1, 0);
  for (size_t b = 0; b < B; b++) offs[b + 1] = offs[b] + (int64_t)h->outb[b].size();
  int T = pool_threads();
  std::atomic<size_t> next{0};
  std::vector<std::thread> th;
  for (int t = 0; t < T; t++)
    th.emplace_back([&] {
      for (;;) {
        size_t b = next.fetch_add(1);
        if (b >= B) break;
        if (h->outb[b].empty()) continue;
        std::memcpy(bidx + offs[b], h->outb[b].data(),
                    h->outb[b].size() * sizeof(int64_t));
        std::memcpy(pidx + offs[b], h->outp[b].data(),
                    h->outp[b].size() * sizeof(int64_t));
      }
    });
  for (auto& x : th) x.join();
}

void px_join_free(void* vh) { delete (JoinHandle*)vh; }

}  // extern "C"
