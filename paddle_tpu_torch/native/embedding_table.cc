// Native sparse-embedding table: the host-side hot loop of the parameter
// server (reference: paddle/fluid/distributed/table/common_sparse_table.cc
// — brpc-served shard with per-id rows + optimizer slots). The python
// EmbeddingTable walks a dict row-by-row per RPC; this arena-backed
// open-hash table does batched pull/push in C++ so a shard can hold
// hundreds of millions of ids without python-loop cost.
//
// C ABI only (ctypes-loaded; no pybind in this image).
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

// splitmix64: deterministic per-(key, column) init so a row's value does
// not depend on arrival order (python's shared-RNG rows do; determinism
// here is strictly better for shard rebuilds).
static inline uint64_t mix(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct Table {
  int dim = 0;
  int n_slots = 0;       // 0 sgd, 1 adagrad
  int opt = 0;           // 0 sgd, 1 adagrad
  int init_mode = 0;     // 0 uniform(-s, s), 1 zeros
  float lr = 0.01f;
  float init_scale = 0.01f;
  uint64_t seed = 0;
  std::mutex mu;
  std::unordered_map<int64_t, size_t> index;  // id -> arena offset
  std::vector<float> arena;                   // stride = dim * (1 + n_slots)

  size_t stride() const { return static_cast<size_t>(dim) * (1 + n_slots); }

  float* row(int64_t id, bool create) {
    auto it = index.find(id);
    if (it != index.end()) return arena.data() + it->second;
    if (!create) return nullptr;
    size_t off = arena.size();
    arena.resize(off + stride(), 0.0f);
    float* r = arena.data() + off;
    if (init_mode == 0) {
      for (int j = 0; j < dim; ++j) {
        uint64_t h = mix(static_cast<uint64_t>(id) * 0x100000001b3ULL + j +
                         seed * 0x9e3779b9ULL);
        // map to [-init_scale, init_scale)
        float u = static_cast<float>(h >> 11) * (1.0f / 9007199254740992.0f);
        r[j] = (2.0f * u - 1.0f) * init_scale;
      }
    }
    index.emplace(id, off);
    return r;
  }
};

}  // namespace

extern "C" {

void* emb_create(int dim, int opt, float lr, int init_mode, float init_scale,
                 uint64_t seed) {
  Table* t = new Table();
  t->dim = dim;
  t->opt = opt;
  t->n_slots = (opt == 1) ? 1 : 0;
  t->lr = lr;
  t->init_mode = init_mode;
  t->init_scale = init_scale;
  t->seed = seed;
  return t;
}

void emb_free(void* p) { delete static_cast<Table*>(p); }

int64_t emb_size(void* p) {
  Table* t = static_cast<Table*>(p);
  std::lock_guard<std::mutex> g(t->mu);
  return static_cast<int64_t>(t->index.size());
}

// pull with on-demand init (create=1) or zero-fill for misses (create=0)
void emb_pull(void* p, const int64_t* ids, int64_t n, float* out,
              int create) {
  Table* t = static_cast<Table*>(p);
  std::lock_guard<std::mutex> g(t->mu);
  for (int64_t i = 0; i < n; ++i) {
    float* r = t->row(ids[i], create != 0);
    if (r)
      std::memcpy(out + i * t->dim, r, sizeof(float) * t->dim);
    else
      std::memset(out + i * t->dim, 0, sizeof(float) * t->dim);
  }
}

// batched optimizer push; ignores ids never pulled (reference semantics:
// push to a non-existent row is dropped)
void emb_push(void* p, const int64_t* ids, int64_t n, const float* grads,
              float eps) {
  Table* t = static_cast<Table*>(p);
  std::lock_guard<std::mutex> g(t->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto it = t->index.find(ids[i]);
    if (it == t->index.end()) continue;
    float* r = t->arena.data() + it->second;
    const float* gr = grads + i * t->dim;
    if (t->opt == 0) {  // sgd
      for (int j = 0; j < t->dim; ++j) r[j] -= t->lr * gr[j];
    } else {            // adagrad
      float* acc = r + t->dim;
      for (int j = 0; j < t->dim; ++j) {
        acc[j] += gr[j] * gr[j];
        r[j] -= t->lr * gr[j] / (std::sqrt(acc[j]) + eps);
      }
    }
  }
}

void emb_push_delta(void* p, const int64_t* ids, int64_t n,
                    const float* deltas) {
  Table* t = static_cast<Table*>(p);
  std::lock_guard<std::mutex> g(t->mu);
  for (int64_t i = 0; i < n; ++i) {
    auto it = t->index.find(ids[i]);
    if (it == t->index.end()) continue;
    float* r = t->arena.data() + it->second;
    const float* d = deltas + i * t->dim;
    for (int j = 0; j < t->dim; ++j) r[j] += d[j];
  }
}

// export for save. Writes at most `cap` entries and returns the table's
// TOTAL size under the same lock — the caller grows its buffers and
// retries when total > cap (a concurrent pull may have created rows
// between the caller's sizing call and this one).
int64_t emb_export(void* p, int64_t* keys, float* rows, float* slots,
                   int64_t cap) {
  Table* t = static_cast<Table*>(p);
  std::lock_guard<std::mutex> g(t->mu);
  int64_t i = 0;
  for (const auto& kv : t->index) {
    if (i >= cap) break;
    keys[i] = kv.first;
    const float* r = t->arena.data() + kv.second;
    std::memcpy(rows + i * t->dim, r, sizeof(float) * t->dim);
    if (t->n_slots)
      std::memcpy(slots + i * t->dim, r + t->dim, sizeof(float) * t->dim);
    ++i;
  }
  return static_cast<int64_t>(t->index.size());
}

void emb_clear(void* p) {
  Table* t = static_cast<Table*>(p);
  std::lock_guard<std::mutex> g(t->mu);
  t->index.clear();
  t->arena.clear();
}

// bulk import for load: overwrites/creates the given ids
void emb_import(void* p, const int64_t* keys, int64_t n, const float* rows,
                const float* slots) {
  Table* t = static_cast<Table*>(p);
  std::lock_guard<std::mutex> g(t->mu);
  for (int64_t i = 0; i < n; ++i) {
    float* r = t->row(keys[i], true);
    std::memcpy(r, rows + i * t->dim, sizeof(float) * t->dim);
    if (t->n_slots && slots)
      std::memcpy(r + t->dim, slots + i * t->dim, sizeof(float) * t->dim);
  }
}

}  // extern "C"
