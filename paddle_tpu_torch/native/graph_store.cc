// Sharded in-memory graph store with weighted neighbor sampling.
//
// TPU-native counterpart of the reference's distributed graph engine core:
//   paddle/fluid/distributed/table/common_graph_table.{h,cc}  (GraphShard,
//   load_edges/load_nodes, random_sample_neighboors)
//   paddle/fluid/distributed/table/graph/graph_weighted_sampler.cc (alias
//   method weighted sampling)
//
// C API (ctypes-bound from python/native/graph_store.py). Thread-safe per
// shard; alias tables built lazily per node and cached. The RPC layer
// (GraphPyService parity) lives in python — this library is the hot path:
// parsing, storage, sampling.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct AliasTable {
  // Walker alias method for O(1) weighted sampling.
  std::vector<float> prob;
  std::vector<int32_t> alias;
  void build(const std::vector<float>& w) {
    size_t n = w.size();
    prob.assign(n, 0.f);
    alias.assign(n, 0);
    double sum = 0;
    for (float x : w) sum += x;
    if (sum <= 0) {  // degenerate: uniform
      for (size_t i = 0; i < n; i++) { prob[i] = 1.f; alias[i] = (int32_t)i; }
      return;
    }
    std::vector<double> p(n);
    for (size_t i = 0; i < n; i++) p[i] = w[i] * n / sum;
    std::vector<int32_t> small, large;
    for (size_t i = 0; i < n; i++)
      (p[i] < 1.0 ? small : large).push_back((int32_t)i);
    while (!small.empty() && !large.empty()) {
      int32_t s = small.back(); small.pop_back();
      int32_t l = large.back(); large.pop_back();
      prob[s] = (float)p[s];
      alias[s] = l;
      p[l] = p[l] - (1.0 - p[s]);
      (p[l] < 1.0 ? small : large).push_back(l);
    }
    for (int32_t s : small) { prob[s] = 1.f; alias[s] = s; }
    for (int32_t l : large) { prob[l] = 1.f; alias[l] = l; }
  }
  inline int32_t draw(std::mt19937* rng) const {
    std::uniform_real_distribution<float> uf(0.f, 1.f);
    std::uniform_int_distribution<int32_t> ui(0, (int32_t)prob.size() - 1);
    int32_t i = ui(*rng);
    return uf(*rng) < prob[i] ? i : alias[i];
  }
};

struct Node {
  std::vector<int64_t> nbrs;
  std::vector<float> weights;   // empty => uniform
  std::vector<float> feat;      // optional dense feature
  AliasTable* alias = nullptr;  // lazily built, owned
  ~Node() { delete alias; }
};

struct Shard {
  std::unordered_map<int64_t, Node> nodes;
  std::mutex mu;
};

struct GraphStore {
  std::vector<Shard> shards;
  std::atomic<int64_t> edge_count{0};
  explicit GraphStore(int n) : shards(n) {}
  inline Shard& shard_of(int64_t id) {
    return shards[(uint64_t)id % shards.size()];
  }
};

thread_local std::mt19937 g_rng{std::random_device{}()};

// Append one edge keeping weights consistent when weighted and unweighted
// inserts are mixed for the same node: a missing weight means 1.0, and a
// late first weight backfills 1.0 for all earlier neighbors, so
// weights.size() is always 0 or nbrs.size() (the sampler relies on this).
inline void push_edge(Node& nd, int64_t dst, bool has_w, float w) {
  nd.nbrs.push_back(dst);
  if (has_w) {
    if (nd.weights.size() + 1 < nd.nbrs.size())
      nd.weights.resize(nd.nbrs.size() - 1, 1.f);
    nd.weights.push_back(w);
  } else if (!nd.weights.empty()) {
    nd.weights.push_back(1.f);
  }
  delete nd.alias;
  nd.alias = nullptr;
}

}  // namespace

extern "C" {

void* gs_create(int shard_num) {
  if (shard_num <= 0) shard_num = 16;
  return new GraphStore(shard_num);
}

void gs_free(void* h) { delete static_cast<GraphStore*>(h); }

void gs_seed(uint64_t seed) { g_rng.seed((unsigned)seed); }

int64_t gs_add_edges(void* h, const int64_t* src, const int64_t* dst,
                     const float* weight, int64_t n) {
  auto* gs = static_cast<GraphStore*>(h);
  for (int64_t i = 0; i < n; i++) {
    Shard& sh = gs->shard_of(src[i]);
    std::lock_guard<std::mutex> lk(sh.mu);
    Node& nd = sh.nodes[src[i]];
    push_edge(nd, dst[i], weight != nullptr, weight ? weight[i] : 1.f);
  }
  gs->edge_count += n;
  return n;
}

int64_t gs_add_nodes(void* h, const int64_t* ids, int64_t n) {
  auto* gs = static_cast<GraphStore*>(h);
  for (int64_t i = 0; i < n; i++) {
    Shard& sh = gs->shard_of(ids[i]);
    std::lock_guard<std::mutex> lk(sh.mu);
    sh.nodes[ids[i]];
  }
  return n;
}

// erase nodes and their outgoing edges (reference remove_graph_node)
int64_t gs_remove_nodes(void* h, const int64_t* ids, int64_t n) {
  auto* gs = static_cast<GraphStore*>(h);
  int64_t removed = 0;
  for (int64_t i = 0; i < n; i++) {
    Shard& sh = gs->shard_of(ids[i]);
    std::lock_guard<std::mutex> lk(sh.mu);
    auto it = sh.nodes.find(ids[i]);
    if (it != sh.nodes.end()) {
      gs->edge_count -= (int64_t)it->second.nbrs.size();
      sh.nodes.erase(it);
      removed++;
    }
  }
  return removed;
}

// text file: "src \t dst [\t weight]" per line (reference load_edges format)
int64_t gs_load_edge_file(void* h, const char* path, int reversed) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  auto* gs = static_cast<GraphStore*>(h);
  char line[4096];
  int64_t count = 0;
  while (fgets(line, sizeof(line), f)) {
    int64_t a, b;
    float w = 1.f;
    int got = sscanf(line, "%ld%ld%f", &a, &b, &w);
    if (got < 2) continue;
    int64_t s = reversed ? b : a, d = reversed ? a : b;
    Shard& sh = gs->shard_of(s);
    std::lock_guard<std::mutex> lk(sh.mu);
    Node& nd = sh.nodes[s];
    push_edge(nd, d, got >= 3, w);
    count++;
  }
  fclose(f);
  gs->edge_count += count;
  return count;
}

int64_t gs_node_count(void* h) {
  auto* gs = static_cast<GraphStore*>(h);
  int64_t n = 0;
  for (auto& sh : gs->shards) n += (int64_t)sh.nodes.size();
  return n;
}

int64_t gs_edge_count(void* h) {
  return static_cast<GraphStore*>(h)->edge_count.load();
}

int64_t gs_get_degree(void* h, const int64_t* ids, int64_t n, int64_t* out) {
  auto* gs = static_cast<GraphStore*>(h);
  for (int64_t i = 0; i < n; i++) {
    Shard& sh = gs->shard_of(ids[i]);
    std::lock_guard<std::mutex> lk(sh.mu);
    auto it = sh.nodes.find(ids[i]);
    out[i] = it == sh.nodes.end() ? 0 : (int64_t)it->second.nbrs.size();
  }
  return n;
}

// weighted (alias) or uniform sampling WITH replacement; pad = fill value
// for nodes with no neighbors. out is [n, k] row-major.
int64_t gs_sample_neighbors(void* h, const int64_t* ids, int64_t n, int k,
                            int64_t* out, int64_t pad) {
  auto* gs = static_cast<GraphStore*>(h);
  for (int64_t i = 0; i < n; i++) {
    Shard& sh = gs->shard_of(ids[i]);
    std::lock_guard<std::mutex> lk(sh.mu);
    auto it = sh.nodes.find(ids[i]);
    if (it == sh.nodes.end() || it->second.nbrs.empty()) {
      for (int j = 0; j < k; j++) out[i * k + j] = pad;
      continue;
    }
    Node& nd = it->second;
    if (!nd.weights.empty()) {
      if (!nd.alias) {
        nd.alias = new AliasTable();
        nd.alias->build(nd.weights);
      }
      for (int j = 0; j < k; j++)
        out[i * k + j] = nd.nbrs[nd.alias->draw(&g_rng)];
    } else {
      std::uniform_int_distribution<size_t> ui(0, nd.nbrs.size() - 1);
      for (int j = 0; j < k; j++) out[i * k + j] = nd.nbrs[ui(g_rng)];
    }
  }
  return n;
}

// sample `k` distinct node ids from the store (reference
// random_sample_nodes): reservoir over shards.
int64_t gs_random_sample_nodes(void* h, int64_t k, int64_t* out) {
  auto* gs = static_cast<GraphStore*>(h);
  int64_t seen = 0;
  for (auto& sh : gs->shards) {
    std::lock_guard<std::mutex> lk(sh.mu);
    for (auto& kv : sh.nodes) {
      if (seen < k) {
        out[seen] = kv.first;
      } else {
        std::uniform_int_distribution<int64_t> ui(0, seen);
        int64_t j = ui(g_rng);
        if (j < k) out[j] = kv.first;
      }
      seen++;
    }
  }
  return seen < k ? seen : k;
}

// batched node iteration (reference pull_graph_list): writes up to cap ids
// from a shard starting at cursor; returns count.
int64_t gs_pull_graph_list(void* h, int shard, int64_t cursor, int64_t cap,
                           int64_t* out) {
  auto* gs = static_cast<GraphStore*>(h);
  if (shard < 0 || shard >= (int)gs->shards.size()) return 0;
  Shard& sh = gs->shards[shard];
  std::lock_guard<std::mutex> lk(sh.mu);
  int64_t idx = 0, written = 0;
  for (auto& kv : sh.nodes) {
    if (idx++ < cursor) continue;
    if (written >= cap) break;
    out[written++] = kv.first;
  }
  return written;
}

int gs_set_node_feat(void* h, int64_t id, const float* feat, int dim) {
  auto* gs = static_cast<GraphStore*>(h);
  Shard& sh = gs->shard_of(id);
  std::lock_guard<std::mutex> lk(sh.mu);
  Node& nd = sh.nodes[id];
  nd.feat.assign(feat, feat + dim);
  return 0;
}

int gs_get_node_feat(void* h, const int64_t* ids, int64_t n, int dim,
                     float* out) {
  auto* gs = static_cast<GraphStore*>(h);
  for (int64_t i = 0; i < n; i++) {
    Shard& sh = gs->shard_of(ids[i]);
    std::lock_guard<std::mutex> lk(sh.mu);
    auto it = sh.nodes.find(ids[i]);
    if (it != sh.nodes.end() && (int)it->second.feat.size() == dim) {
      memcpy(out + i * dim, it->second.feat.data(), dim * sizeof(float));
    } else {
      memset(out + i * dim, 0, dim * sizeof(float));
    }
  }
  return 0;
}

}  // extern "C"
