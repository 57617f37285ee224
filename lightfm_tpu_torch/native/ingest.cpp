// Native data-ingest engine: the host-side runtime of lightfm_tpu_torch.
//
// A copy of lightfm_tpu/native/ingest.cpp.  The model's compute runs on the
// GPU; this library serves the host where it burns cycles on dataset
// ingestion -- id mapping, interaction assembly, and text parsing.  The
// Python `Dataset` (lightfm_tpu_torch/data.py, mirroring reference
// `lightfm/data.py:136-449`) calls these functions for numpy-typed inputs and
// falls back to pure Python for arbitrary hashables.
//
// INT64_MIN is the hash map's empty-slot marker, so it cannot be a key: the
// loader (native/__init__.py) refuses it and `Dataset` routes an array that
// holds it through its pure-Python path.
//
// Exposed via a C ABI (ctypes); no pybind11 dependency.  Built with g++ at
// first use by native/__init__.py.

#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

// Open-addressing hash map int64 -> int32, linear probing, power-of-2 size.
struct I64Map {
  int64_t* keys;
  int32_t* vals;
  uint64_t mask;      // capacity - 1
  uint64_t size;
  static const int64_t EMPTY = INT64_MIN;

  // Start small and grow: the table stays cache-resident while the number
  // of distinct ids is small, which is the common case (uniques << rows).
  explicit I64Map(uint64_t expected_uniques) {
    uint64_t cap = 1 << 10;
    while (cap < expected_uniques * 2) cap <<= 1;
    alloc(cap);
  }
  ~I64Map() {
    free(keys);
    free(vals);
  }
  void alloc(uint64_t cap) {
    mask = cap - 1;
    size = 0;
    keys = static_cast<int64_t*>(malloc(cap * sizeof(int64_t)));
    vals = static_cast<int32_t*>(malloc(cap * sizeof(int32_t)));
    for (uint64_t i = 0; i < cap; ++i) keys[i] = EMPTY;
  }
  void grow() {
    uint64_t old_cap = mask + 1;
    int64_t* ok = keys;
    int32_t* ov = vals;
    alloc(old_cap * 2);
    for (uint64_t i = 0; i < old_cap; ++i) {
      if (ok[i] != EMPTY) insert_nogrow(ok[i], ov[i]);
    }
    free(ok);
    free(ov);
  }
  static uint64_t hash(int64_t k) {
    uint64_t h = static_cast<uint64_t>(k);
    h ^= h >> 33;
    h *= 0xff51afd7ed558ccdULL;
    h ^= h >> 33;
    return h;
  }
  void insert_nogrow(int64_t k, int32_t v) {
    uint64_t i = hash(k) & mask;
    while (keys[i] != EMPTY) i = (i + 1) & mask;
    keys[i] = k;
    vals[i] = v;
    ++size;
  }
  // Insert if absent; returns the value (existing or new).
  int32_t get_or_insert(int64_t k, int32_t next_val, bool* inserted) {
    if (size * 10 >= (mask + 1) * 7) grow();  // load factor 0.7
    uint64_t i = hash(k) & mask;
    while (keys[i] != EMPTY) {
      if (keys[i] == k) {
        *inserted = false;
        return vals[i];
      }
      i = (i + 1) & mask;
    }
    keys[i] = k;
    vals[i] = next_val;
    ++size;
    *inserted = true;
    return next_val;
  }
  // Lookup; -1 if absent.
  int32_t find(int64_t k) const {
    uint64_t i = hash(k) & mask;
    while (keys[i] != EMPTY) {
      if (keys[i] == k) return vals[i];
      i = (i + 1) & mask;
    }
    return -1;
  }
};

}  // namespace

extern "C" {

// Deduplicate `ids` preserving first-seen order, continuing an existing
// mapping of `n_existing` ids (passed in first-seen order).  Writes the NEW
// unique ids (in first-seen order) to `uniq_out` (capacity `n`).  Returns
// the number of new unique ids.
int64_t lf_map_ids(const int64_t* existing, int64_t n_existing,
                   const int64_t* ids, int64_t n, int64_t* uniq_out) {
  I64Map map(static_cast<uint64_t>(n_existing + n));
  for (int64_t i = 0; i < n_existing; ++i) {
    bool ins;
    map.get_or_insert(existing[i], static_cast<int32_t>(i), &ins);
  }
  int64_t n_new = 0;
  int32_t next = static_cast<int32_t>(n_existing);
  for (int64_t i = 0; i < n; ++i) {
    bool ins;
    map.get_or_insert(ids[i], next, &ins);
    if (ins) {
      uniq_out[n_new++] = ids[i];
      ++next;
    }
  }
  return n_new;
}

// Map `keys` through the mapping defined by `ids` (first-seen order = dense
// index).  Writes int32 indices (-1 for missing) to `out`.  Returns the
// count of missing keys.
int64_t lf_lookup_ids(const int64_t* ids, int64_t n_ids, const int64_t* keys,
                      int64_t n_keys, int32_t* out) {
  I64Map map(static_cast<uint64_t>(n_ids));
  for (int64_t i = 0; i < n_ids; ++i) {
    bool ins;
    map.get_or_insert(ids[i], static_cast<int32_t>(i), &ins);
  }
  int64_t missing = 0;
  for (int64_t i = 0; i < n_keys; ++i) {
    int32_t v = map.find(keys[i]);
    out[i] = v;
    missing += (v < 0);
  }
  return missing;
}

// Parse delimiter-separated interaction lines: "uid<d>iid[<d>value[...]]\n".
// Non-numeric / short lines are skipped.  Returns rows parsed; fills
// uids/iids (int64) and vals (float, 1.0 when absent).
int64_t lf_parse_interactions(const char* buf, int64_t len, char delim,
                              int64_t* uids, int64_t* iids, float* vals) {
  int64_t n = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* line_end = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!line_end) line_end = end;

    // field 1: uid
    char* q;
    long long uid = strtoll(p, &q, 10);
    if (q == p || q >= line_end || *q != delim) {
      p = line_end + 1;
      continue;
    }
    const char* f2 = q + 1;
    long long iid = strtoll(f2, &q, 10);
    if (q == f2) {
      p = line_end + 1;
      continue;
    }
    float v = 1.0f;
    if (q < line_end && *q == delim) {
      const char* f3 = q + 1;
      // strtof skips leading whitespace *including '\n'*, so an empty value
      // field ("1\t2\t\n") would otherwise consume the next line's uid.
      if (f3 < line_end) {
        char* q2;
        float parsed = strtof(f3, &q2);
        if (q2 != f3 && q2 <= line_end) v = parsed;
      }
    }
    uids[n] = uid;
    iids[n] = iid;
    vals[n] = v;
    ++n;
    p = line_end + 1;
  }
  return n;
}

// Count newline-terminated lines (upper bound for parse buffers).
int64_t lf_count_lines(const char* buf, int64_t len) {
  int64_t n = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) {
      ++n;
      break;
    }
    ++n;
    p = nl + 1;
  }
  return n;
}

}  // extern "C"
