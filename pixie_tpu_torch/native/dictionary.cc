// Native dictionary encoder — the ingest hot loop.
// The port's copy of the reference's native/dictionary.cc, unchanged in code.
//
// Reference analog: the C++ string handling inside ColumnWrapper/DataTable
// (src/shared/types/column_wrapper.h, src/stirling/core/data_table.h) — the
// reference's ingest is C++ end to end.  Here the Python Dictionary keeps the
// value list (decode stays pure-python) while THIS index does the O(rows)
// value→code hashing over numpy's fixed-width UCS4 string grids, called via
// ctypes with zero copies.
//
// The index is a flat open-addressing table (pow2 slots, linear probing).
// Key bytes live in ONE contiguous arena (offset/length vectors per code):
// std::string storage put every 24-byte UCS4 key on the heap (past SSO), so
// the hit-path memcmp paid an extra dependent cache miss per row; the arena
// keeps key bytes append-only and densely packed, and the per-key hash is
// memoized so growth rehashes without touching key bytes at all.
//
// Large batches (>= MT_MIN_ROWS) run a PARALLEL read-only probe phase:
// worker threads resolve rows whose value already has a code (the steady
// state of telemetry ingest — service/pod/status cardinality is tiny), and
// only the rows that missed take the serial insert pass, in row order so
// code assignment stays first-occurrence deterministic (identical to the
// Python fallback's assignment; either path yields byte-identical tables).
//
// Build: see pixie_tpu_torch/native/build.py (g++ -O3 -shared -fPIC -pthread).
//
// Layout contract (matches numpy 'U' arrays): n rows, `stride` uint32 code
// points per row, rows padded with NUL.  Codes are dense int32, assigned in
// first-occurrence order.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <thread>
#include <vector>

namespace {

inline uint64_t hash_bytes(const char* p, size_t len) {
  // 8-bytes-at-a-time multiply/xor mix (murmur-finalizer flavored).  UCS4
  // rows are 4-byte-aligned multiples of 4 bytes, so the 8-wide loop covers
  // nearly everything; the tail handles an odd trailing code point.
  uint64_t h = 0x9e3779b97f4a7c15ull ^ (uint64_t)len;
  while (len >= 8) {
    uint64_t k;
    std::memcpy(&k, p, 8);
    h = (h ^ k) * 0xff51afd7ed558ccdull;
    h ^= h >> 29;
    p += 8;
    len -= 8;
  }
  if (len) {
    uint64_t k = 0;
    std::memcpy(&k, p, len);
    h = (h ^ k) * 0xc4ceb9fe1a85ec53ull;
  }
  h ^= h >> 32;
  return h;
}

//: below this row count the thread spawn costs more than it saves
constexpr int64_t MT_MIN_ROWS = 1 << 18;
constexpr int MT_MAX_THREADS = 8;

struct Dict {
  // Arena key storage: key c occupies arena[key_off[c], key_off[c]+key_len[c]).
  // Append-only, so offsets stay valid across arena growth (the vector may
  // relocate, but only between calls — probes re-read arena.data()).
  std::vector<char> arena;
  std::vector<uint64_t> key_off;
  std::vector<uint32_t> key_len;
  std::vector<uint64_t> key_hash;
  std::vector<int32_t> slots;  // open addressing, -1 = empty
  uint64_t mask;

  Dict() : slots(64, -1), mask(63) {}

  size_t size() const { return key_len.size(); }

  void grow() {
    const size_t ns = slots.size() * 2;
    std::vector<int32_t> fresh(ns, -1);
    const uint64_t m = ns - 1;
    for (size_t c = 0; c < key_len.size(); ++c) {
      uint64_t i = key_hash[c] & m;
      while (fresh[i] != -1) i = (i + 1) & m;
      fresh[i] = (int32_t)c;
    }
    slots.swap(fresh);
    mask = m;
  }

  // Read-only probe: code of `raw` or -1 when absent.  Safe to run from
  // worker threads concurrently with other lookups (no mutation).
  inline int32_t lookup(std::string_view raw, uint64_t h) const {
    const char* base = arena.data();
    uint64_t i = h & mask;
    for (;;) {
      const int32_t c = slots[i];
      if (c == -1) return -1;
      if (key_hash[c] == h && key_len[c] == raw.size() &&
          std::memcmp(base + key_off[c], raw.data(), raw.size()) == 0)
        return c;
      i = (i + 1) & mask;
    }
  }

  int32_t insert(std::string_view raw) {
    const uint64_t h = hash_bytes(raw.data(), raw.size());
    uint64_t i = h & mask;
    const char* base = arena.data();
    for (;;) {
      const int32_t c = slots[i];
      if (c == -1) break;
      if (key_hash[c] == h && key_len[c] == raw.size() &&
          std::memcmp(base + key_off[c], raw.data(), raw.size()) == 0)
        return c;
      i = (i + 1) & mask;
    }
    const int32_t code = (int32_t)key_len.size();
    key_off.push_back(arena.size());
    key_len.push_back((uint32_t)raw.size());
    key_hash.push_back(h);
    arena.insert(arena.end(), raw.data(), raw.data() + raw.size());
    slots[i] = code;
    // grow at 3/4 load so probe chains stay short
    if ((uint64_t)key_len.size() * 4 >= slots.size() * 3) grow();
    return code;
  }
};

inline std::string_view row_view(const uint32_t* data, int64_t stride, int64_t i) {
  const uint32_t* row = data + i * stride;
  int64_t len = stride;
  while (len > 0 && row[len - 1] == 0) --len;  // numpy pads rows with NUL
  return {reinterpret_cast<const char*>(row),
          static_cast<size_t>(len) * sizeof(uint32_t)};
}

}  // namespace

extern "C" {

void* px_dict_new() { return new Dict(); }

void px_dict_free(void* h) { delete static_cast<Dict*>(h); }

int64_t px_dict_size(void* h) {
  return static_cast<int64_t>(static_cast<Dict*>(h)->size());
}

// Batch encode n rows of a UCS4 grid.  out_codes[n] receives the codes;
// new_first_idx receives, for each NEWLY-inserted value (in insertion order),
// the batch row index of its first occurrence, so the caller can mirror the
// Python-side value list.  Returns the number of new values.
int64_t px_dict_encode_ucs4(void* h, const uint32_t* data, int64_t n,
                            int64_t stride, int32_t* out_codes,
                            int64_t* new_first_idx) {
  Dict* d = static_cast<Dict*>(h);
  const int64_t size_before = static_cast<int64_t>(d->size());
  int64_t n_new = 0;

  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = (int)(hw ? hw : 1);
  if (nthreads > MT_MAX_THREADS) nthreads = MT_MAX_THREADS;
  if (n >= MT_MIN_ROWS && nthreads > 1 && d->size() > 0) {
    // Phase 1: parallel READ-ONLY probes.  Rows whose value is already
    // indexed (virtually all of them in steady-state ingest) get their code
    // with no synchronization; misses are marked -1 for the serial pass.
    // Nothing mutates the Dict during this phase, so worker reads are safe.
    std::vector<std::thread> workers;
    workers.reserve(nthreads);
    const int64_t per = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
      const int64_t lo = t * per, hi = std::min(n, lo + per);
      if (lo >= hi) break;
      workers.emplace_back([d, data, stride, out_codes, lo, hi]() {
        for (int64_t i = lo; i < hi; ++i) {
          std::string_view raw = row_view(data, stride, i);
          out_codes[i] = d->lookup(raw, hash_bytes(raw.data(), raw.size()));
        }
      });
    }
    for (auto& w : workers) w.join();
    // Phase 2 (serial, row order → first-occurrence code determinism):
    // resolve only the missed rows.  A value that appeared in several
    // threads' ranges inserts once, at its LOWEST row index.
    for (int64_t i = 0; i < n; ++i) {
      if (out_codes[i] != -1) continue;
      int32_t code = d->insert(row_view(data, stride, i));
      if (code >= size_before + n_new) new_first_idx[n_new++] = i;
      out_codes[i] = code;
    }
    return n_new;
  }

  for (int64_t i = 0; i < n; ++i) {
    int32_t code = d->insert(row_view(data, stride, i));
    if (code >= size_before + n_new) {
      new_first_idx[n_new++] = i;
    }
    out_codes[i] = code;
  }
  return n_new;
}

// Single insert used to keep the native index in sync when the Python side
// adds a value directly (literal lookups).  Returns the value's code.
int32_t px_dict_insert_ucs4(void* h, const uint32_t* data, int64_t len) {
  Dict* d = static_cast<Dict*>(h);
  std::string_view raw(reinterpret_cast<const char*>(data),
                       static_cast<size_t>(len) * sizeof(uint32_t));
  // trim trailing NULs for consistency with row_view
  while (raw.size() >= sizeof(uint32_t)) {
    uint32_t last;
    std::memcpy(&last, raw.data() + raw.size() - sizeof(uint32_t), sizeof(uint32_t));
    if (last != 0) break;
    raw.remove_suffix(sizeof(uint32_t));
  }
  return d->insert(raw);
}

}  // extern "C"
