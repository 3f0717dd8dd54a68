// Streaming partial-aggregation hot loops (ctypes, C ABI).
// The port's copy of the reference's native/stream_agg.cc, unchanged in
// code (engine/np_partial.py calls it).
//
// Reference bar: the reference's streaming pipeline is C++ end to end
// (Table::TransferRecordBatch src/table_store/table/table.h:152-166 feeding
// AggNode's hash update exec/agg_node.h:140).  Python-side numpy covers the
// bincount-shaped reductions at memory speed already; the one loop numpy
// cannot fuse is the grouped log-histogram scatter (group id x bin -> count),
// which otherwise costs an 8M-element flat bincount over a G*width index
// space per poll.  This kernel does the scatter in one pass.

#include <cmath>
#include <cstdint>

extern "C" {

// hist[g * width + bin] += 1 for each row; gid pre-masked (negative = skip).
void px_hist_accumulate(int64_t n, const int64_t* gid, const int32_t* bins,
                        int64_t width, float* hist) {
  for (int64_t i = 0; i < n; ++i) {
    const int64_t g = gid[i];
    if (g < 0) continue;
    hist[g * width + bins[i]] += 1.0f;
  }
}

// DDSketch bin index per value (ops/sketch.py bin_index, f32 semantics):
// idx = ceil(log(max(v, min_value)) / log(gamma)) + 1; v <= min_value -> 0;
// clipped to [0, width-1].
void px_bin_index(int64_t n, const double* vals, float inv_log_gamma,
                  float min_value, int32_t width, int32_t* bins) {
  const int32_t hi = width - 1;
  for (int64_t i = 0; i < n; ++i) {
    const float v = (float)vals[i];
    const float vm = v > min_value ? v : min_value;
    int32_t idx = (int32_t)std::ceil(std::log(vm) * inv_log_gamma) + 1;
    if (v <= min_value) idx = 0;
    if (idx < 0) idx = 0;
    if (idx > hi) idx = hi;
    bins[i] = idx;
  }
}

// Fused: bin + grouped histogram scatter in one pass (no 8M-element
// intermediate bins array when the caller doesn't need it).
void px_hist_update(int64_t n, const int64_t* gid, const double* vals,
                    float inv_log_gamma, float min_value, int64_t width,
                    float* hist) {
  const int32_t hi = (int32_t)width - 1;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t g = gid[i];
    if (g < 0) continue;
    const float v = (float)vals[i];
    const float vm = v > min_value ? v : min_value;
    int32_t idx = (int32_t)std::ceil(std::log(vm) * inv_log_gamma) + 1;
    if (v <= min_value) idx = 0;
    if (idx < 0) idx = 0;
    if (idx > hi) idx = hi;
    hist[g * width + idx] += 1.0f;
  }
}

// Fully fused single-pass windowed aggregate for the streaming fast path:
// gid = time/w - t0 (clamped to [0, G)); accumulates any subset of
// {count, sum, log-histogram} in ONE pass over the rows — no gid array, no
// bins array, no boolean masks.  This is the Stirling->table->windowed-LET
// hot loop at memory speed (reference: the reference's whole streaming
// pipeline is C++, table.h:152-166 -> agg_node.h:140).
void px_window_agg(int64_t n, const int64_t* time_ns, int64_t w, int64_t t0,
                   int64_t G, const double* vals, int64_t width,
                   float inv_log_gamma, float min_value, int64_t* counts,
                   double* sums, float* hist) {
  const int32_t hi = (int32_t)width - 1;
  // telemetry time is (near-)sorted: track the current window's [lo, hi)
  // bounds and divide only when a row leaves it — one 64-bit division per
  // window CHANGE instead of per row (the div was ~60 cycles/row, the
  // dominant cost of this loop at 8M rows/poll)
  int64_t cur_bin = 0, bin_lo = 1, bin_hi = 0;  // empty range forces init
  for (int64_t i = 0; i < n; ++i) {
    const int64_t t = time_ns[i];
    if (t < bin_lo || t >= bin_hi) {
      cur_bin = t / w;
      bin_lo = cur_bin * w;
      bin_hi = bin_lo + w;
    }
    int64_t g = cur_bin - t0;
    if (g < 0) g = 0;
    if (g >= G) g = G - 1;
    if (counts) counts[g] += 1;
    if (sums) sums[g] += vals[i];
    if (hist) {
      const float v = (float)vals[i];
      const float vm = v > min_value ? v : min_value;
      int32_t idx = (int32_t)std::ceil(std::log(vm) * inv_log_gamma) + 1;
      if (v <= min_value) idx = 0;
      if (idx < 0) idx = 0;
      if (idx > hi) idx = hi;
      hist[g * width + idx] += 1.0f;
    }
  }
}

}  // extern "C"
