// Whole-plan fused loop for the sub-crossover CPU path (ctypes, C ABI).
// The port's copy of the reference's native/wholeplan.cc, unchanged in
// code: the CPU route of both packages runs the same loop, bit for bit.
//
// Flare's lesson (PAPERS.md): below the accelerator crossover the winning
// design is ONE compiled loop over the whole scan->filter->map->partial-agg
// chain, not a pipeline of per-op kernels with intermediate arrays.  This
// kernel executes the lowered micro-program (filters, group-key encoders,
// aggregate accumulators — pixie_tpu_torch/native/codegen.py) in ONE
// cache-resident pass straight off the storage batches: no feed coalescing
// copies, no masks, no upload to the card.
//
// Loop structure: rows process in 4K blocks; every program step runs as its
// own tight loop over the block with ALL switches hoisted outside (the
// templated-loop shape — each (dtype, op) combination is a separate
// compiled inner loop the vectorizer can chew on), communicating through a
// block-local gid vector (-1 = filtered/dropped).  The Python side
// (codegen.run) additionally fans batches out over a thread pool with
// per-batch partial states merged in batch order — deterministic
// regardless of scheduling.
//
// Numeric contract (tests/test_torch_wholeplan.py): integer accumulators
// are exact (int64 sums wrap mod 2^64 — true two's-complement sums, as the
// card's K1 adds them; histogram cells are integer counts in f32) and
// the log-histogram binning is the exact f32 expression of
// ops/sketch.LogHistogram.bin_index (the code px_hist_update in
// stream_agg.cc runs).  Float sums accumulate row-order within a batch and
// merge in batch order — bit-stable run to run, equal to the interpreted
// path within last-ulp rounding.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// column dtype tags (codegen.py _DT_*)
constexpr int32_t DT_I64 = 0;
constexpr int32_t DT_F64 = 1;
constexpr int32_t DT_I32 = 2;
constexpr int32_t DT_U8 = 3;  // numpy bool_

constexpr int64_t BLK = 4096;

inline int64_t load_i(const void* p, int32_t dt, int64_t i) {
  switch (dt) {
    case DT_I64: return ((const int64_t*)p)[i];
    case DT_I32: return (int64_t)((const int32_t*)p)[i];
    default: return (int64_t)((const uint8_t*)p)[i];
  }
}

inline double load_f(const void* p, int32_t dt, int64_t i) {
  switch (dt) {
    case DT_F64: return ((const double*)p)[i];
    case DT_I64: return (double)((const int64_t*)p)[i];
    case DT_I32: return (double)((const int32_t*)p)[i];
    default: return (double)((const uint8_t*)p)[i];
  }
}

// floor division matching python/numpy `//` (C++ '/' truncates toward 0)
inline int64_t floordiv(int64_t a, int64_t b) {
  int64_t q = a / b;
  if ((a % b) != 0 && ((a < 0) != (b < 0))) --q;
  return q;
}

// ---- log-histogram binning -------------------------------------------
// The DDSketch bin (ops/sketch.LogHistogram.bin_index f32 semantics; the
// same expression px_hist_update in stream_agg.cc runs):
//   vm = v > min ? v : min; idx = ceil(logf(vm) * inv_log_gamma) + 1;
//   v <= min -> 0; clip [0, width-1]
// logf per row is the dominant cost of a quantile aggregate (~20 ns/row
// measured).  bin_slow below IS that expression; bin_lut resolves ~99.2%
// of rows from a 2^16-entry table over the f32 value's top 16 bits: the
// expression is monotone in the float's bit pattern within a cell, so a
// cell whose two endpoint values bin identically (checked with bin_slow
// itself at build time) is EXACT — only boundary-straddling cells (and
// non-finite payloads) take the slow path.  Bit-identical to the per-row
// logf loop by construction.

inline int32_t bin_slow(float v, float inv_log_gamma, float min_value,
                        int32_t hi) {
  const float vm = v > min_value ? v : min_value;
  int32_t idx = (int32_t)std::ceil(std::log(vm) * inv_log_gamma) + 1;
  if (v <= min_value) idx = 0;
  if (idx < 0) idx = 0;
  if (idx > hi) idx = hi;
  return idx;
}

struct HistLut {
  int16_t bin[1 << 16];  // -1 = ambiguous cell -> bin_slow
  float inv_log_gamma, min_value;
  int32_t hi;

  HistLut(float ilg, float mv, int32_t h)
      : inv_log_gamma(ilg), min_value(mv), hi(h) {
    for (uint32_t c = 0; c < (1u << 16); ++c) {
      uint32_t lo_bits = c << 16, hi_bits = (c << 16) | 0xFFFFu;
      float lo, hif;
      std::memcpy(&lo, &lo_bits, 4);
      std::memcpy(&hif, &hi_bits, 4);
      if (!std::isfinite(lo) || !std::isfinite(hif)) {
        bin[c] = -1;
        continue;
      }
      const int32_t a = bin_slow(lo, ilg, mv, h);
      const int32_t b = bin_slow(hif, ilg, mv, h);
      bin[c] = a == b ? (int16_t)a : (int16_t)-1;
    }
  }
};

inline int32_t hist_bin(float v, const HistLut* lut, float ilg, float mv,
                        int32_t hi) {
  if (lut != nullptr) {
    uint32_t bits;
    std::memcpy(&bits, &v, 4);
    const int16_t b = lut->bin[bits >> 16];
    if (b >= 0) return b;
  }
  return bin_slow(v, ilg, mv, hi);
}

// one process-wide LUT for the process-constant LogHistogram parameters
// (built lazily under C++11 magic-statics); different parameters keep the
// plain slow path
const HistLut* hist_lut_for(float ilg, float mv, int32_t hi) {
  // magic-static: built once by the first caller's parameters; the LUT
  // self-describes its parameters, so a caller with different ones gets
  // nullptr (plain slow path) instead of a mismatched table
  static const HistLut lut(ilg, mv, hi);
  return (lut.inv_log_gamma == ilg && lut.min_value == mv && lut.hi == hi)
             ? &lut
             : nullptr;
}

template <typename T, typename R>
inline void filter_block(const T* v, R rhs, int32_t op, int64_t m,
                         int32_t* gid) {
  switch (op) {
    case 0: for (int64_t i = 0; i < m; ++i) if (!((R)v[i] == rhs)) gid[i] = -1; break;
    case 1: for (int64_t i = 0; i < m; ++i) if (!((R)v[i] != rhs)) gid[i] = -1; break;
    case 2: for (int64_t i = 0; i < m; ++i) if (!((R)v[i] < rhs)) gid[i] = -1; break;
    case 3: for (int64_t i = 0; i < m; ++i) if (!((R)v[i] <= rhs)) gid[i] = -1; break;
    case 4: for (int64_t i = 0; i < m; ++i) if (!((R)v[i] > rhs)) gid[i] = -1; break;
    default: for (int64_t i = 0; i < m; ++i) if (!((R)v[i] >= rhs)) gid[i] = -1; break;
  }
}

template <typename R>
inline void filter_dispatch(const void* p, int32_t dt, R rhs, int32_t op,
                            int64_t m, int32_t* gid) {
  switch (dt) {
    case DT_I64: filter_block((const int64_t*)p, rhs, op, m, gid); break;
    case DT_F64: filter_block((const double*)p, rhs, op, m, gid); break;
    case DT_I32: filter_block((const int32_t*)p, rhs, op, m, gid); break;
    default: filter_block((const uint8_t*)p, rhs, op, m, gid); break;
  }
}

}  // namespace

extern "C" {

// filter ops (codegen.py): 0 eq, 1 ne, 2 lt, 3 le, 4 gt, 5 ge
// key kinds: 0 dict (i32 codes; negative = drop row), 1 intdevice
//   (searchsorted against sorted lut), 2 window (floor(t/width) - t0)
// agg kinds: 0 count, 1 sum_i64, 2 sum_f64, 3 mean, 4 min_i64, 5 max_i64,
//   6 min_f64, 7 max_f64, 8 log-histogram, 9 variance(sum,sumsq,count)
//
// Returns the number of rows that passed filters + key null-drops.
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
    int64_t hist_width, float inv_log_gamma, float min_value) {
  (void)n_cols;
  (void)num_groups;
  const int32_t hist_hi = (int32_t)hist_width - 1;
  int64_t passed = 0;
  int32_t gid[BLK];
  for (int64_t base = 0; base < n; base += BLK) {
    const int64_t m = std::min(BLK, n - base);
    for (int64_t i = 0; i < m; ++i) gid[i] = 0;
    // ---- time bounds + filters: each predicate is one tight typed loop
    if (time_col >= 0) {  // time is always i64 storage
      const int64_t* t = (const int64_t*)col_data[time_col] + base;
      for (int64_t i = 0; i < m; ++i)
        if (t[i] < t_lo || t[i] >= t_hi) gid[i] = -1;
    }
    for (int32_t f = 0; f < n_filters; ++f) {
      const int32_t c = f_col[f];
      const int32_t dt = col_dt[c];
      const int64_t esz = dt == DT_I32 ? 4 : dt == DT_U8 ? 1 : 8;
      const void* p = (const char*)col_data[c] + base * esz;
      if (f_isf[f])
        filter_dispatch(p, dt, f_fval[f], f_op[f], m, gid);
      else
        filter_dispatch(p, dt, f_ival[f], f_op[f], m, gid);
    }
    // ---- group id (mixed radix; per-key clamp matches combine_codes)
    for (int32_t k = 0; k < n_keys; ++k) {
      const int32_t c = k_col[k];
      const int32_t dt = col_dt[c];
      const int64_t esz = dt == DT_I32 ? 4 : dt == DT_U8 ? 1 : 8;
      const void* p = (const char*)col_data[c] + base * esz;
      const int32_t card = (int32_t)k_card[k];
      if (k_kind[k] == 0) {  // dict codes: null (-1) drops the row
        const int32_t* codes = (const int32_t*)p;
        for (int64_t i = 0; i < m; ++i) {
          if (gid[i] < 0) continue;
          int32_t code = codes[i];
          if (code < 0) { gid[i] = -1; continue; }
          if (code >= card) code = card - 1;
          gid[i] = gid[i] * card + code;
        }
      } else if (k_kind[k] == 1) {  // searchsorted(lut, v, "left")
        const int64_t* lut = k_lut[k];
        const int64_t len = k_lut_len[k];
        if (len <= 16 && dt == DT_I64) {
          // tiny key sets (the common interactive shape): branchless
          // count-of-smaller equals lower_bound on a sorted array
          const int64_t* v = (const int64_t*)p;
          for (int64_t i = 0; i < m; ++i) {
            if (gid[i] < 0) continue;
            int64_t code = 0;
            for (int64_t j = 0; j < len; ++j) code += lut[j] < v[i];
            if (code >= card) code = card - 1;
            gid[i] = gid[i] * card + (int32_t)code;
          }
        } else {
          const int64_t* end = lut + len;
          for (int64_t i = 0; i < m; ++i) {
            if (gid[i] < 0) continue;
            const int64_t v = load_i(p, dt, i);
            int64_t code = std::lower_bound(lut, end, v) - lut;
            if (code >= card) code = card - 1;
            gid[i] = gid[i] * card + (int32_t)code;
          }
        }
      } else {  // window: floor(t/width) - t0, clamped
        const int64_t* t = (const int64_t*)p;
        const int64_t w = k_width[k], t0 = k_t0[k];
        for (int64_t i = 0; i < m; ++i) {
          if (gid[i] < 0) continue;
          int64_t code = floordiv(t[i], w) - t0;
          if (code < 0) code = 0;
          if (code >= card) code = card - 1;
          gid[i] = gid[i] * card + (int32_t)code;
        }
      }
    }
    for (int64_t i = 0; i < m; ++i) passed += gid[i] >= 0;
    // ---- aggregates: one switch per (agg, block), tight loops inside
    for (int32_t a = 0; a < n_aggs; ++a) {
      const void* p = nullptr;
      int32_t dt = DT_I64;
      if (a_kind[a] != 0) {  // count reads no value column — a count-only
        const int32_t c = a_col[a];  // program may carry ZERO columns, so
        dt = col_dt[c];              // col_data[0] must not be touched
        const int64_t esz = dt == DT_I32 ? 4 : dt == DT_U8 ? 1 : 8;
        p = (const char*)col_data[c] + base * esz;
      }
      switch (a_kind[a]) {
        case 0: {
          int64_t* s = (int64_t*)a_s0[a];
          for (int64_t i = 0; i < m; ++i)
            if (gid[i] >= 0) s[gid[i]] += 1;
          break;
        }
        case 1: {
          int64_t* s = (int64_t*)a_s0[a];
          for (int64_t i = 0; i < m; ++i)
            if (gid[i] >= 0)
              s[gid[i]] = (int64_t)((uint64_t)s[gid[i]] +
                                    (uint64_t)load_i(p, dt, i));
          break;
        }
        case 2: {
          double* s = (double*)a_s0[a];
          for (int64_t i = 0; i < m; ++i)
            if (gid[i] >= 0) s[gid[i]] += load_f(p, dt, i);
          break;
        }
        case 3: {
          double* s = (double*)a_s0[a];
          int64_t* cs = (int64_t*)a_s1[a];
          if (dt == DT_F64) {
            const double* v = (const double*)p;
            for (int64_t i = 0; i < m; ++i)
              if (gid[i] >= 0) { s[gid[i]] += v[i]; cs[gid[i]] += 1; }
          } else {
            for (int64_t i = 0; i < m; ++i)
              if (gid[i] >= 0) { s[gid[i]] += load_f(p, dt, i);
                                 cs[gid[i]] += 1; }
          }
          break;
        }
        case 4: {
          int64_t* s = (int64_t*)a_s0[a];
          for (int64_t i = 0; i < m; ++i)
            if (gid[i] >= 0) {
              const int64_t v = load_i(p, dt, i);
              if (v < s[gid[i]]) s[gid[i]] = v;
            }
          break;
        }
        case 5: {
          int64_t* s = (int64_t*)a_s0[a];
          for (int64_t i = 0; i < m; ++i)
            if (gid[i] >= 0) {
              const int64_t v = load_i(p, dt, i);
              if (v > s[gid[i]]) s[gid[i]] = v;
            }
          break;
        }
        case 6: {
          double* s = (double*)a_s0[a];
          for (int64_t i = 0; i < m; ++i)
            if (gid[i] >= 0) {
              const double v = load_f(p, dt, i);
              if (v < s[gid[i]]) s[gid[i]] = v;
            }
          break;
        }
        case 7: {
          double* s = (double*)a_s0[a];
          for (int64_t i = 0; i < m; ++i)
            if (gid[i] >= 0) {
              const double v = load_f(p, dt, i);
              if (v > s[gid[i]]) s[gid[i]] = v;
            }
          break;
        }
        case 8: {
          float* s = (float*)a_s0[a];
          const double* v64 = (const double*)p;  // value cols are f64 here
          const HistLut* lut =
              hist_lut_for(inv_log_gamma, min_value, hist_hi);
          for (int64_t i = 0; i < m; ++i) {
            if (gid[i] < 0) continue;
            const float v = dt == DT_F64 ? (float)v64[i]
                                         : (float)load_f(p, dt, i);
            const int32_t idx =
                hist_bin(v, lut, inv_log_gamma, min_value, hist_hi);
            s[(int64_t)gid[i] * hist_width + idx] += 1.0f;
          }
          break;
        }
        default: {
          double* s = (double*)a_s0[a];
          double* sq = (double*)a_s1[a];
          int64_t* cs = (int64_t*)a_s2[a];
          for (int64_t i = 0; i < m; ++i)
            if (gid[i] >= 0) {
              const double v = load_f(p, dt, i);
              s[gid[i]] += v;
              sq[gid[i]] += v * v;
              cs[gid[i]] += 1;
            }
          break;
        }
      }
    }
  }
  return passed;
}

}  // extern "C"
