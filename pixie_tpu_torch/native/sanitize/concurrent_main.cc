// The port's copy of the reference's native/sanitize/concurrent_main.cc: it drives the
// port's own native/*.cc (pixie_tpu_torch/native), unchanged in code.
// Concurrent sanitizer driver for the PTHREAD paths of the native runtime
// (the PX_NATIVE_SANITIZE=thread build mode — the TSAN analog of the
// reference's bazel --config tsan CI lane, .bazelrc:102-136).
//
// Built by tests/test_native_sanitize.py as a STANDALONE binary (address or
// thread sanitizer — TSan cannot ride inside the ctypes .so loaded by an
// uninstrumented Python) from dictionary.cc + join.cc + wholeplan.cc +
// stream_agg.cc, then executed.  Each section hammers a real concurrency
// shape of the engine:
//
//   * wholeplan: N host threads run px_wholeplan_run over DISJOINT row
//     ranges of SHARED read-only column buffers with per-thread state
//     arrays — exactly pixie_tpu_torch/native/codegen.py's batch-range pool —
//     and the deterministically merged states must equal a single-threaded
//     reference run.
//   * join: concurrent px_join_run/fetch/free handles (the radix join
//     spawns its own partition/match/fetch thread pools internally), each
//     validated against its expected pair count.
//   * dictionary: batches >= 1<<18 rows against a warm index trigger the
//     parallel read-only probe phase; codes must be identical to a cold
//     single-threaded encode.
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* px_dict_new();
void px_dict_free(void* h);
int64_t px_dict_size(void* h);
int64_t px_dict_encode_ucs4(void* h, const uint32_t* data, int64_t n,
                            int64_t stride, int32_t* out_codes,
                            int64_t* new_first_idx);
void* px_join_run(const int64_t* bcodes, int64_t nb, const int64_t* pcodes,
                  int64_t npr, int64_t* total_out);
void px_join_fetch(void* h, int64_t* bidx, int64_t* pidx);
void px_join_free(void* h);
int64_t px_wholeplan_run(
    int64_t n, int32_t n_cols, const void** col_data, const int32_t* col_dt,
    int32_t n_filters, const int32_t* f_col, const int32_t* f_op,
    const int32_t* f_isf, const int64_t* f_ival, const double* f_fval,
    int32_t time_col, int64_t t_lo, int64_t t_hi,
    int32_t n_keys, const int32_t* k_kind, const int32_t* k_col,
    const int64_t* k_card, const int64_t* k_width, const int64_t* k_t0,
    const int64_t* const* k_lut, const int64_t* k_lut_len,
    int64_t num_groups,
    int32_t n_aggs, const int32_t* a_kind, const int32_t* a_col,
    void* const* a_s0, void* const* a_s1, void* const* a_s2,
    int64_t hist_width, float inv_log_gamma, float min_value);
}

static std::atomic<int> failures{0};
static bool quick_mode = false;
#define CHECK(cond, msg)                               \
  do {                                                 \
    if (!(cond)) {                                     \
      std::fprintf(stderr, "CHECK failed: %s\n", msg); \
      failures.fetch_add(1);                           \
    }                                                  \
  } while (0)

// ------------------------------------------------------------- wholeplan

// One thread's run over rows [lo, hi): count + sum_i64 over one group.
static void wp_range(const int64_t* col, int64_t lo, int64_t hi,
                     int64_t* count_state, int64_t* sum_state) {
  const void* cols[1] = {col + lo};
  const int32_t dts[1] = {0 /*DT_I64*/};
  const int32_t a_kind[2] = {0 /*count*/, 1 /*sum_i64*/};
  const int32_t a_col[2] = {0, 0};
  void* s0[2] = {count_state, sum_state};
  void* s1[2] = {nullptr, nullptr};
  void* s2[2] = {nullptr, nullptr};
  int64_t passed = px_wholeplan_run(
      hi - lo, 1, cols, dts,
      /*filters*/ 0, nullptr, nullptr, nullptr, nullptr, nullptr,
      /*time_col*/ -1, 0, 0,
      /*keys*/ 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr,
      /*num_groups*/ 1,
      /*aggs*/ 2, a_kind, a_col, s0, s1, s2,
      /*hist*/ 0, 0.0f, 0.0f);
  CHECK(passed == hi - lo, "wholeplan: unfiltered rows all pass");
}

static void test_wholeplan_pool() {
  const int64_t n = quick_mode ? 1 << 17 : 1 << 20;
  const int T = 8;
  std::vector<int64_t> col(n);
  for (int64_t i = 0; i < n; ++i) col[i] = i % 1000;

  // single-threaded reference
  int64_t ref_cnt = 0, ref_sum = 0;
  wp_range(col.data(), 0, n, &ref_cnt, &ref_sum);

  // codegen's pool shape: threads share the column read-only, each owns
  // its state block; merge is deterministic range order
  std::vector<int64_t> cnts(T, 0), sums(T, 0);
  std::vector<std::thread> th;
  const int64_t per = n / T;
  for (int t = 0; t < T; ++t)
    th.emplace_back([&, t] {
      wp_range(col.data(), t * per, (t + 1) * per, &cnts[t], &sums[t]);
    });
  for (auto& x : th) x.join();
  int64_t cnt = 0, sum = 0;
  for (int t = 0; t < T; ++t) {
    cnt += cnts[t];
    sum += sums[t];
  }
  CHECK(cnt == ref_cnt, "wholeplan pool: merged count == reference");
  CHECK(sum == ref_sum, "wholeplan pool: merged sum == reference");
}

// ------------------------------------------------------------------ join

static void test_join_concurrent() {
  std::vector<std::thread> th;
  for (int t = 0; t < 4; ++t) {
    th.emplace_back([t] {
      const int64_t nb = quick_mode ? 40000 : 200000;
      const int64_t npr = quick_mode ? 30000 : 150000;
      const int64_t K = 997;
      std::mt19937_64 rng(100 + t);
      std::vector<int64_t> b(nb), p(npr);
      std::vector<int64_t> bc(K, 0), pc(K, 0);
      for (auto& v : b) {
        v = (int64_t)(rng() % K);
        bc[v]++;
      }
      for (auto& v : p) {
        v = (int64_t)(rng() % K);
        pc[v]++;
      }
      int64_t expect = 0;
      for (int64_t k = 0; k < K; ++k) expect += bc[k] * pc[k];
      int64_t total = 0;
      void* h = px_join_run(b.data(), nb, p.data(), npr, &total);
      CHECK(total == expect, "join: pair count matches histogram product");
      std::vector<int64_t> bi(total), pi(total);
      px_join_fetch(h, bi.data(), pi.data());
      for (int64_t i = 0; i < total; i += 1997)
        CHECK(b[bi[i]] == p[pi[i]], "join: fetched pairs key-match");
      px_join_free(h);
    });
  }
  for (auto& x : th) x.join();
}

// ------------------------------------------------------------ dictionary

static void fill_row(uint32_t* grid, int64_t stride, int64_t i,
                     const std::string& s) {
  for (int64_t j = 0; j < stride; ++j)
    grid[i * stride + j] = j < (int64_t)s.size() ? (uint32_t)s[j] : 0u;
}

static void test_dict_parallel_probe() {
  // >= MT_MIN_ROWS (1<<18) rows against a WARM index runs the internal
  // multi-threaded probe phase; codes must equal a cold sequential encode
  const int64_t n = (1 << 18) + 4096, stride = 10;
  std::vector<uint32_t> grid(n * stride);
  std::mt19937_64 rng(11);
  for (int64_t i = 0; i < n; ++i)
    fill_row(grid.data(), stride, i, "svc-" + std::to_string(rng() % 300));

  void* warm = px_dict_new();
  std::vector<int32_t> codes(n), codes2(n);
  std::vector<int64_t> firsts(n);
  // warm the index with a small prefix (sequential), then the full batch
  // probes in parallel
  px_dict_encode_ucs4(warm, grid.data(), 4096, stride, codes.data(),
                      firsts.data());
  px_dict_encode_ucs4(warm, grid.data(), n, stride, codes.data(),
                      firsts.data());
  void* cold = px_dict_new();
  px_dict_encode_ucs4(cold, grid.data(), n, stride, codes2.data(),
                      firsts.data());
  CHECK(px_dict_size(warm) == px_dict_size(cold),
        "dict: warm and cold sizes agree");
  CHECK(std::memcmp(codes.data(), codes2.data(), n * sizeof(int32_t)) == 0,
        "dict: parallel probe codes == sequential codes");
  px_dict_free(warm);
  px_dict_free(cold);
}

int main(int argc, char** argv) {
  // "quick" shrinks the wholeplan/join sections for the tier-1 smoke lane;
  // the slow TSan lane runs full sizes
  quick_mode = argc > 1 && std::string(argv[1]) == "quick";
  test_wholeplan_pool();
  test_join_concurrent();
  test_dict_parallel_probe();
  if (failures.load()) {
    std::fprintf(stderr, "%d checks failed\n", failures.load());
    return 1;
  }
  std::puts("native concurrent sanitize: all checks passed");
  return 0;
}
