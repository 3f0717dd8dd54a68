// The port's copy of the reference's native/sanitize/sanitize_main.cc: it drives the
// port's own native/*.cc (pixie_tpu_torch/native), unchanged in code.
// Sanitizer harness for the native hot loops (A2: the ASAN/TSAN analog of
// the reference's bazel --config asan/tsan CI runs, .bazelrc:102-136).
//
// Built BY THE TEST with -fsanitize=address,undefined into a standalone
// binary (sanitizers cannot ride along inside the ctypes .so loaded by a
// non-instrumented Python), then run: any heap overflow / UB / leak in
// dictionary.cc or stream_agg.cc aborts with a nonzero exit.  A thread
// section hammers the dictionary from multiple threads under its intended
// single-writer contract and re-validates the index afterwards.
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

// native API under test
extern "C" {
void* px_dict_new();
void px_dict_free(void* h);
int64_t px_dict_size(void* h);
int64_t px_dict_encode_ucs4(void* h, const uint32_t* data, int64_t n,
                            int64_t stride, int32_t* out_codes,
                            int64_t* new_first_idx);
int32_t px_dict_insert_ucs4(void* h, const uint32_t* data, int64_t len);
void px_hist_accumulate(int64_t n, const int64_t* gid, const int32_t* bins,
                        int64_t width, float* hist);
void px_bin_index(int64_t n, const double* vals, float inv_log_gamma,
                  float min_value, int32_t width, int32_t* bins);
void px_hist_update(int64_t n, const int64_t* gid, const double* vals,
                    float inv_log_gamma, float min_value, int64_t width,
                    float* hist);
void px_window_agg(int64_t n, const int64_t* time_ns, int64_t w, int64_t t0,
                   int64_t G, const double* vals, int64_t width,
                   float inv_log_gamma, float min_value, int64_t* counts,
                   double* sums, float* hist);
}

static int failures = 0;
#define CHECK(cond, msg)                                      \
  do {                                                        \
    if (!(cond)) {                                            \
      std::fprintf(stderr, "CHECK failed: %s\n", msg);        \
      ++failures;                                             \
    }                                                         \
  } while (0)

static void fill_row(uint32_t* grid, int64_t stride, int64_t i,
                     const std::string& s) {
  for (int64_t j = 0; j < stride; ++j)
    grid[i * stride + j] = j < (int64_t)s.size() ? (uint32_t)s[j] : 0u;
}

static void test_dictionary() {
  const int64_t n = 200000, stride = 12;
  std::vector<uint32_t> grid(n * stride);
  std::mt19937_64 rng(7);
  std::vector<std::string> pool;
  for (int i = 0; i < 300; ++i) pool.push_back("svc-" + std::to_string(i));
  for (int64_t i = 0; i < n; ++i)
    fill_row(grid.data(), stride, i, pool[rng() % pool.size()]);

  void* d = px_dict_new();
  std::vector<int32_t> codes(n);
  std::vector<int64_t> firsts(n);
  int64_t n_new =
      px_dict_encode_ucs4(d, grid.data(), n, stride, codes.data(),
                          firsts.data());
  CHECK(n_new <= 300, "at most |pool| new values");
  CHECK(px_dict_size(d) == n_new, "size == new count on empty dict");
  // codes are stable on re-encode and dense in [0, size)
  std::vector<int32_t> codes2(n);
  int64_t n_new2 = px_dict_encode_ucs4(d, grid.data(), n, stride,
                                       codes2.data(), firsts.data());
  CHECK(n_new2 == 0, "re-encode inserts nothing");
  CHECK(std::memcmp(codes.data(), codes2.data(), n * sizeof(int32_t)) == 0,
        "codes stable across re-encode");
  for (int64_t i = 0; i < n; ++i)
    CHECK(codes[i] >= 0 && codes[i] < px_dict_size(d), "dense code range");
  // single inserts agree with batch codes (NUL-trim path): re-insert the
  // FIRST ROW's value and expect its batch code back
  std::vector<uint32_t> one(grid.begin(), grid.begin() + stride);
  int32_t c = px_dict_insert_ucs4(d, one.data(), stride);
  CHECK(c == codes[0], "single insert agrees with the batch code");
  px_dict_free(d);
}

static void test_dict_threads() {
  // intended contract: one writer dict per table; concurrent READERS of
  // the produced codes.  Hammer N independent dicts from N threads (the
  // real concurrency shape) — ASAN catches any cross-thread aliasing into
  // shared globals.
  std::vector<std::thread> ts;
  for (int t = 0; t < 8; ++t) {
    ts.emplace_back([t] {
      const int64_t n = 50000, stride = 8;
      std::vector<uint32_t> grid(n * stride);
      for (int64_t i = 0; i < n; ++i)
        fill_row(grid.data(), stride, i,
                 "t" + std::to_string(t) + "-" + std::to_string(i % 97));
      void* d = px_dict_new();
      std::vector<int32_t> codes(n);
      std::vector<int64_t> firsts(n);
      px_dict_encode_ucs4(d, grid.data(), n, stride, codes.data(),
                          firsts.data());
      CHECK(px_dict_size(d) == 97, "per-thread dict sees its 97 values");
      px_dict_free(d);
    });
  }
  for (auto& th : ts) th.join();
}

static void test_stream_agg() {
  const int64_t n = 500000, G = 64, width = 514;
  std::mt19937_64 rng(3);
  std::vector<int64_t> tcol(n), gid(n);
  std::vector<double> vals(n);
  for (int64_t i = 0; i < n; ++i) {
    tcol[i] = i * 1000000;  // sorted (the incremental-bin fast case)
    gid[i] = (int64_t)(rng() % G);
    vals[i] = (double)(rng() % 100000) / 7.0;
  }
  std::vector<int64_t> counts(G, 0);
  std::vector<double> sums(G, 0.0);
  std::vector<float> hist(G * width, 0.0f);
  const float ilg = 1.0f / std::log(1.0404f);
  px_window_agg(n, tcol.data(), 10000000000LL, 0, G, vals.data(), width,
                ilg, 1e-9f, counts.data(), sums.data(), hist.data());
  int64_t total = 0;
  for (auto c : counts) total += c;
  CHECK(total == n, "window counts cover every row");
  // unsorted + boundary-heavy times (exercises the bin-range fallback)
  for (int64_t i = 0; i < n; ++i) tcol[i] = (int64_t)(rng() % 60) * 10000000000LL;
  px_window_agg(n, tcol.data(), 10000000000LL, 0, G, vals.data(), width,
                ilg, 1e-9f, counts.data(), nullptr, nullptr);
  // hist update + separate bin/accumulate agree
  std::vector<int32_t> bins(n);
  px_bin_index(n, vals.data(), ilg, 1e-9f, (int32_t)width, bins.data());
  std::vector<float> h1(G * width, 0.0f), h2(G * width, 0.0f);
  px_hist_update(n, gid.data(), vals.data(), ilg, 1e-9f, width, h1.data());
  px_hist_accumulate(n, gid.data(), bins.data(), width, h2.data());
  CHECK(std::memcmp(h1.data(), h2.data(), G * width * sizeof(float)) == 0,
        "fused and two-phase histograms identical");
  // negative gid rows are skipped, never written
  std::vector<int64_t> gneg(n, -1);
  std::vector<float> h3(G * width, 0.0f);
  px_hist_update(n, gneg.data(), vals.data(), ilg, 1e-9f, width, h3.data());
  for (auto v : h3) CHECK(v == 0.0f, "masked rows contribute nothing");
}

int main() {
  test_dictionary();
  test_dict_threads();
  test_stream_agg();
  if (failures) {
    std::fprintf(stderr, "%d checks failed\n", failures);
    return 1;
  }
  std::puts("native sanitize: all checks passed");
  return 0;
}
