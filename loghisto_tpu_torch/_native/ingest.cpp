// Native ingest runtime: lock-striped sample staging + vectorized codec
// (the port's own copy of loghisto_tpu/_native/ingest.cpp; the C code is
// unchanged but for the LH_PACKED_COUNT_CAP_VALUE override below).
//
// This is the C++ analog of the reference's hot path machinery (the Go
// library's RWMutex + atomic lock-promotion ingest, metrics.go:251-295),
// rebuilt for the batch/device design: writers append (metric_id, value)
// pairs into per-shard ring buffers under a per-shard mutex with the GIL
// released, and the reaper drains whole shards for vectorized compression
// and device upload.  Also provides the log-bucket codec and a dense
// accumulate as portable C for host-side verification and CPU fallback.
//
// Plain C ABI on purpose: loaded via ctypes (no pybind11, no PyTorch
// headers), built by loghisto_tpu_torch/_native/__init__.py with g++.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

namespace {

constexpr int16_t kBucketLimit = 32767;

struct Shard {
  std::mutex mu;
  std::vector<int32_t> ids;
  std::vector<double> values;
  // lifetime counters of dropped samples (buffer full)
  std::atomic<uint64_t> dropped{0};
};

struct Buffer {
  std::vector<Shard> shards;
  int64_t capacity_per_shard;
  explicit Buffer(int num_shards, int64_t cap)
      : shards(num_shards), capacity_per_shard(cap) {
    for (auto& s : shards) {
      s.ids.reserve(static_cast<size_t>(std::min<int64_t>(cap, 1 << 20)));
      s.values.reserve(static_cast<size_t>(std::min<int64_t>(cap, 1 << 20)));
    }
  }
};

inline int16_t compress_one(double value, int precision) {
  double mag = std::floor(precision * std::log1p(std::fabs(value)) + 0.5);
  if (std::isnan(mag)) mag = 0.0;  // NaN -> bucket 0 (matches device tier)
  if (mag > kBucketLimit) mag = kBucketLimit;
  int16_t i = static_cast<int16_t>(mag);
  return value < 0 ? static_cast<int16_t>(-i) : i;
}

}  // namespace

extern "C" {

void* lh_create(int num_shards, int64_t capacity_per_shard) {
  if (num_shards < 1 || capacity_per_shard < 1) return nullptr;
  return new (std::nothrow) Buffer(num_shards, capacity_per_shard);
}

void lh_destroy(void* handle) { delete static_cast<Buffer*>(handle); }

int lh_num_shards(void* handle) {
  return static_cast<int>(static_cast<Buffer*>(handle)->shards.size());
}

// Append a batch into one shard. Returns the number of samples accepted
// (the rest were dropped: shed-don't-block, like the reference's
// slow-subscriber policy).
int64_t lh_record_batch(void* handle, int shard_idx, const int32_t* ids,
                        const double* values, int64_t n) {
  Buffer* buf = static_cast<Buffer*>(handle);
  Shard& shard = buf->shards[shard_idx % buf->shards.size()];
  std::lock_guard<std::mutex> lock(shard.mu);
  int64_t room = buf->capacity_per_shard -
                 static_cast<int64_t>(shard.ids.size());
  int64_t take = std::max<int64_t>(0, std::min(room, n));
  if (take > 0) {
    shard.ids.insert(shard.ids.end(), ids, ids + take);
    shard.values.insert(shard.values.end(), values, values + take);
  }
  if (take < n) shard.dropped.fetch_add(static_cast<uint64_t>(n - take));
  return take;
}

int64_t lh_record(void* handle, int shard_idx, int32_t id, double value) {
  return lh_record_batch(handle, shard_idx, &id, &value, 1);
}

// Swap one shard's buffers and copy them out. Returns the sample count
// (<= max_n; anything beyond max_n is discarded and counted as dropped).
int64_t lh_drain(void* handle, int shard_idx, int32_t* ids_out,
                 double* values_out, int64_t max_n) {
  Buffer* buf = static_cast<Buffer*>(handle);
  Shard& shard = buf->shards[shard_idx % buf->shards.size()];
  std::vector<int32_t> ids;
  std::vector<double> values;
  {
    std::lock_guard<std::mutex> lock(shard.mu);
    ids.swap(shard.ids);
    values.swap(shard.values);
    // keep the warm reserve: without this, every post-drain interval
    // re-grows through the realloc ladder while holding the shard mutex
    size_t warm = std::min<size_t>(
        ids.capacity(), static_cast<size_t>(buf->capacity_per_shard));
    shard.ids.reserve(warm);
    shard.values.reserve(warm);
  }
  int64_t n = static_cast<int64_t>(ids.size());
  int64_t take = std::min(n, max_n);
  if (take > 0) {
    std::memcpy(ids_out, ids.data(), take * sizeof(int32_t));
    std::memcpy(values_out, values.data(), take * sizeof(double));
  }
  if (take < n) shard.dropped.fetch_add(static_cast<uint64_t>(n - take));
  return take;
}

uint64_t lh_dropped(void* handle) {
  Buffer* buf = static_cast<Buffer*>(handle);
  uint64_t total = 0;
  for (auto& s : buf->shards) total += s.dropped.load();
  return total;
}

// Vectorized codec: values -> int16 buckets (reference metrics.go:316-322
// semantics, saturating instead of wrapping).
void lh_compress(const double* values, int64_t n, int precision,
                 int16_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = compress_one(values[i], precision);
}

void lh_decompress(const int16_t* buckets, int64_t n, int precision,
                   double* out) {
  for (int64_t i = 0; i < n; ++i) {
    double f = std::exp(std::fabs(static_cast<double>(buckets[i])) /
                        precision) - 1.0;
    out[i] = buckets[i] < 0 ? -f : f;
  }
}

}  // extern "C"

// Persistent host cell store: an open-addressing (id, codec_bucket) ->
// int64 count table that ACCUMULATES across flushes, so one device ship
// per interval carries the dedup of the whole interval, not one batch.
// This is the host-tier half of interval-granularity transport: sample
// rate is decoupled from wire bandwidth (wire cost = unique cells per
// interval), which is what lets a thin host->device link keep up with
// a firehose of samples.

namespace {

struct CellSlot {
  uint64_t key;  // (id << 16) | (bucket + 32768); 0 = empty
  int64_t count;
};

struct CellStore {
  std::vector<CellSlot> table;
  uint64_t mask;
  int64_t used = 0;

  explicit CellStore(uint64_t cap) : table(cap, CellSlot{0, 0}), mask(cap - 1) {}

  bool grow() {
    uint64_t new_cap = table.size() * 2;
    std::vector<CellSlot> fresh;
    try {
      fresh.assign(new_cap, CellSlot{0, 0});
    } catch (...) {
      return false;
    }
    uint64_t new_mask = new_cap - 1;
    for (const CellSlot& s : table) {
      if (s.key == 0) continue;
      uint64_t h = s.key * 0x9E3779B97F4A7C15ull;
      uint64_t j = (h ^ (h >> 32)) & new_mask;
      while (fresh[j].key != 0) j = (j + 1) & new_mask;
      fresh[j] = s;
    }
    table.swap(fresh);
    mask = new_mask;
    return true;
  }

  bool add_one(uint64_t key, int64_t weight) {
    uint64_t h = key * 0x9E3779B97F4A7C15ull;
    uint64_t j = (h ^ (h >> 32)) & mask;
    while (true) {
      if (table[j].key == key) {
        table[j].count += weight;
        return true;
      }
      if (table[j].key == 0) {
        // keep load factor under ~0.7 so probe chains stay short
        if ((used + 1) * 10 >= static_cast<int64_t>(table.size()) * 7) {
          if (!grow()) return false;
          return add_one(key, weight);
        }
        table[j].key = key;
        table[j].count = weight;
        ++used;
        return true;
      }
      j = (j + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

void* lh_cells_create(int64_t initial_capacity) {
  uint64_t cap = 1024;
  while (cap < static_cast<uint64_t>(initial_capacity)) cap <<= 1;
  try {
    // nothrow covers only the object shell; the constructor's vector
    // fill can itself throw, and an exception must never cross the C ABI
    return new (std::nothrow) CellStore(cap);
  } catch (...) {
    return nullptr;
  }
}

void lh_cells_destroy(void* store) { delete static_cast<CellStore*>(store); }

int64_t lh_cells_size(void* store) {
  return static_cast<CellStore*>(store)->used;
}

// Fold one batch into the store. Returns the number of samples CONSUMED
// from the input (including skipped negative ids): n on full success,
// or i < n if a table growth allocation failed before sample i — the
// prefix [0, i) is already folded, so the caller retries only ids[i:]
// (typically after draining).  This exactness contract is what lets the
// Python layer recover from allocation failure without double counting.
int64_t lh_cells_add(void* store, const int32_t* ids, const float* values,
                     int64_t n, int precision, int bucket_limit) {
  CellStore* cs = static_cast<CellStore*>(store);
  for (int64_t i = 0; i < n; ++i) {
    int32_t id = ids[i];
    if (id < 0) continue;
    int32_t b = compress_one(static_cast<double>(values[i]), precision);
    if (b < -bucket_limit) b = -bucket_limit;
    if (b > bucket_limit) b = bucket_limit;
    uint64_t key =
        (static_cast<uint64_t>(static_cast<uint32_t>(id)) << 16) |
        static_cast<uint16_t>(b + 32768);
    if (!cs->add_one(key, 1)) return i;
  }
  return n;
}

// Copy out every cell and clear the table (capacity retained). Output
// arrays must hold lh_cells_size entries. Returns the cell count.
int64_t lh_cells_drain(void* store, int32_t* ids_out, int32_t* buckets_out,
                       int64_t* counts_out) {
  CellStore* cs = static_cast<CellStore*>(store);
  int64_t m = 0;
  for (CellSlot& s : cs->table) {
    if (s.key == 0) continue;
    ids_out[m] = static_cast<int32_t>(s.key >> 16);
    buckets_out[m] = static_cast<int32_t>(s.key & 0xFFFF) - 32768;
    counts_out[m] = s.count;
    s.key = 0;
    s.count = 0;
    ++m;
  }
  cs->used = 0;
  return m;
}

// Copy out every cell as interleaved [id, codec_bucket, count] int32
// triples and clear the table (capacity retained).  int32 END TO END:
// the card's weighted scatter (csrc/sparse_ingest.cu) reads int32
// triples, and one packed array means ONE host->device transfer per
// merge instead of three.  out must hold 3 * lh_cells_size(store)
// entries.  A cell whose int64 count exceeds LH_PACKED_COUNT_CAP is
// emitted capped and LEFT IN THE TABLE with the remainder — the caller
// loops until lh_cells_size reaches 0 (one pass in any realistic run;
// the cap keeps every emitted row < 2^30, below the aggregator's int32
// accumulator spill threshold).  A build may lower the cap with
// -DLH_PACKED_COUNT_CAP_VALUE=n to exercise the split on small counts.
#ifndef LH_PACKED_COUNT_CAP_VALUE
#define LH_PACKED_COUNT_CAP_VALUE ((1 << 30) - 1)
#endif
static const int64_t LH_PACKED_COUNT_CAP = LH_PACKED_COUNT_CAP_VALUE;

int64_t lh_cells_drain_packed(void* store, int32_t* out) {
  CellStore* cs = static_cast<CellStore*>(store);
  int64_t m = 0;
  int64_t remaining = 0;
  for (CellSlot& s : cs->table) {
    if (s.key == 0) continue;
    int64_t c = s.count;
    int64_t emit = c > LH_PACKED_COUNT_CAP ? LH_PACKED_COUNT_CAP : c;
    out[3 * m] = static_cast<int32_t>(s.key >> 16);
    out[3 * m + 1] = static_cast<int32_t>(s.key & 0xFFFF) - 32768;
    out[3 * m + 2] = static_cast<int32_t>(emit);
    ++m;
    if (c > emit) {
      s.count = c - emit;
      ++remaining;
    } else {
      s.key = 0;
      s.count = 0;
    }
  }
  cs->used = remaining;
  return m;
}

}  // extern "C"

// -- the sparse transport's host fold ---------------------------------------
//
// The fold below is the host half of transport="sparse": one GIL-released
// call turns a raw (ids, values) batch into packed int32 [n, 3]
// (id, codec_bucket, count) triples — the packed wire format — using T
// thread-local CellStores over disjoint batch slices.  Thread-local
// tables need no locks; duplicate (id, bucket) cells across slices cost
// only wire rows (the device merge is additive), the same bounded-
// duplication trade the sharded record-time store already makes.

namespace {

// Rows needed to emit one table under the 2^30-1 per-row count cap
// (split rule shared with lh_cells_drain_packed).
int64_t packed_rows_needed(const CellStore& cs, int64_t cap) {
  int64_t rows = 0;
  for (const CellSlot& s : cs.table) {
    if (s.key == 0) continue;
    rows += (s.count + cap - 1) / cap;
  }
  return rows;
}

// Emit every cell as split [id, bucket, count<=cap] triples at out;
// clears the table (capacity retained).  Returns rows written.
int64_t emit_packed_split(CellStore& cs, int64_t cap, int32_t* out) {
  int64_t m = 0;
  for (CellSlot& s : cs.table) {
    if (s.key == 0) continue;
    int64_t c = s.count;
    while (c > 0) {
      int64_t emit = c > cap ? cap : c;
      out[3 * m] = static_cast<int32_t>(s.key >> 16);
      out[3 * m + 1] = static_cast<int32_t>(s.key & 0xFFFF) - 32768;
      out[3 * m + 2] = static_cast<int32_t>(emit);
      c -= emit;
      ++m;
    }
    s.key = 0;
    s.count = 0;
  }
  cs.used = 0;
  return m;
}

}  // namespace

extern "C" {

void lh_packed_free(int32_t* p) { delete[] p; }

// Fold a raw batch into packed triples with `num_threads` parallel
// thread-local tables.  *out receives a buffer allocated here (release
// with lh_packed_free).  Returns the row count, or -1 when an
// allocation failed (nothing is leaked; the caller falls back to the
// NumPy tier or raw transport).
int64_t lh_fold_packed(const int32_t* ids, const float* values, int64_t n,
                       int precision, int bucket_limit, int num_threads,
                       int32_t** out) {
  const int64_t cap = LH_PACKED_COUNT_CAP;
  if (num_threads < 1) num_threads = 1;
  // below ~64k samples/thread the spawn+merge overhead beats the win
  int64_t max_t = n / 65536 + 1;
  if (num_threads > max_t) num_threads = static_cast<int>(max_t);
  std::vector<std::unique_ptr<CellStore>> stores;
  std::atomic<bool> failed{false};
  try {
    for (int t = 0; t < num_threads; ++t)
      stores.emplace_back(new CellStore(1 << 14));
  } catch (...) {
    return -1;
  }
  auto fold_slice = [&](int t) {
    int64_t lo = n * t / num_threads;
    int64_t hi = n * (t + 1) / num_threads;
    CellStore& cs = *stores[t];
    for (int64_t i = lo; i < hi; ++i) {
      int32_t id = ids[i];
      if (id < 0) continue;
      int32_t b = compress_one(static_cast<double>(values[i]), precision);
      if (b < -bucket_limit) b = -bucket_limit;
      if (b > bucket_limit) b = bucket_limit;
      uint64_t key =
          (static_cast<uint64_t>(static_cast<uint32_t>(id)) << 16) |
          static_cast<uint16_t>(b + 32768);
      if (!cs.add_one(key, 1)) {
        failed.store(true);
        return;
      }
    }
  };
  if (num_threads == 1) {
    fold_slice(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t)
      threads.emplace_back(fold_slice, t);
    for (auto& th : threads) th.join();
  }
  if (failed.load()) return -1;
  int64_t total = 0;
  std::vector<int64_t> offsets(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    offsets[t] = total;
    total += packed_rows_needed(*stores[t], cap);
  }
  int32_t* buf = new (std::nothrow) int32_t[3 * std::max<int64_t>(total, 1)];
  if (!buf) return -1;
  if (num_threads == 1) {
    emit_packed_split(*stores[0], cap, buf);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t)
      threads.emplace_back([&, t] {
        emit_packed_split(*stores[t], cap, buf + 3 * offsets[t]);
      });
    for (auto& th : threads) th.join();
  }
  *out = buf;
  return total;
}

// Parallel drain of `num_stores` detached CellStore handles into one
// packed buffer (allocated here; release with lh_packed_free) — the
// ShardedCellStore's whole-store drain in one GIL-released call, shards
// scanned concurrently.  Returns total rows or -1 on allocation failure
// (the stores are left untouched in that case: sizing happens before
// any table is cleared).
int64_t lh_cells_drain_packed_multi(void** stores, int num_stores,
                                    int num_threads, int32_t** out) {
  const int64_t cap = LH_PACKED_COUNT_CAP;
  if (num_stores < 1) return 0;
  if (num_threads < 1) num_threads = 1;
  if (num_threads > num_stores) num_threads = num_stores;
  std::vector<int64_t> offsets(num_stores);
  int64_t total = 0;
  for (int i = 0; i < num_stores; ++i) {
    offsets[i] = total;
    total += packed_rows_needed(*static_cast<CellStore*>(stores[i]), cap);
  }
  int32_t* buf = new (std::nothrow) int32_t[3 * std::max<int64_t>(total, 1)];
  if (!buf) return -1;
  auto drain_range = [&](int t) {
    for (int i = t; i < num_stores; i += num_threads)
      emit_packed_split(*static_cast<CellStore*>(stores[i]), cap,
                        buf + 3 * offsets[i]);
  };
  if (num_threads == 1) {
    drain_range(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(num_threads);
    for (int t = 0; t < num_threads; ++t)
      threads.emplace_back(drain_range, t);
    for (auto& th : threads) th.join();
  }
  *out = buf;
  return total;
}

// Dense accumulate on host: the CPU fallback / verification twin of the
// device scatter-add kernel. acc is uint32[num_metrics][2*bucket_limit+1].
void lh_accumulate_dense(const int32_t* ids, const double* values, int64_t n,
                         int precision, int bucket_limit, uint32_t* acc,
                         int32_t num_metrics) {
  const int64_t row = 2 * static_cast<int64_t>(bucket_limit) + 1;
  for (int64_t i = 0; i < n; ++i) {
    int32_t id = ids[i];
    if (id < 0 || id >= num_metrics) continue;
    int32_t b = compress_one(values[i], precision);
    if (b < -bucket_limit) b = -bucket_limit;
    if (b > bucket_limit) b = bucket_limit;
    ++acc[id * row + b + bucket_limit];
  }
}

}  // extern "C"
