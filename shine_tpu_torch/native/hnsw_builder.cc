// Native host-side HNSW graph builder of shine_tpu_torch: a copy of
// shine_tpu/native/hnsw_builder.cc, kept so that the PyTorch port builds its
// graphs without importing the JAX package. The code below this header stays
// equal to that file's but for one repair in insert() (ROADMAP C1): the new
// vertex connects itself into its neighbours' lists only once it has written
// its own list on every level. On one thread that order builds the same graph
// (a level's connects touch only that level's lists, which the searches of
// the levels below never read), so both packages build the same graph from
// the same inputs at threads=1 (tests/test_torch_graph.py holds them to it);
// on more threads the port's graph keeps every vertex reachable.
//
// A second repair for threaded builds (ROADMAP C1, repair_level0): vertices
// inserted at once do not see each other, so a vertex can enter the graph
// through a few far neighbours whose full lists later prune it (the
// shrink-if-full heuristic keeps a diverse subset), and once its last
// in-edge is gone no later insert finds it: a seeded loop of 3,000 builds of
// 200 rows on 8 threads left a level-0 vertex unreachable in 161. No memory
// is raced; the order is. After a threaded build every vertex that level 0
// does not reach from the entry point gets an in-edge from the nearest
// reachable vertex with room in its list (or, if none has room, in place of
// the nearest one's farthest neighbour that the entry point still reaches
// without that edge), in rounds until level 0 reaches every vertex. A build
// on one thread is left as it is, the JAX package's graph.
// The builder, its host k-NN search (graph/soa.py:host_search, the oracle
// the card's search is held to) and the reverse-edge merge of the scan-speed
// build (models/fastbuild.py) are copied.
//
// Clean-room C++20 implementation of the HNSW construction semantics of the
// reference engine (src/hnsw/hnsw.hh:40-251): geometric level draw with
// m_L = 1/ln(M), greedy upper-layer descent, ef_construction-bounded
// best-first search per layer, the diversity selection heuristic
// (hnsw.hh:482-522), and bidirectional connection with shrink-if-full
// (hnsw.hh:180-225). Where the reference synchronizes through one-sided RDMA
// CAS spinlocks across the network, this builder uses in-process per-vertex
// mutexes.
//
// Exposed as a plain C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

using std::int32_t;
using std::int64_t;
using std::uint64_t;

constexpr int kMetricL2 = 0;
constexpr int kMetricIP = 1;

struct PairDI {
  float dist;
  int32_t id;
};
struct NearerFirst {
  bool operator()(const PairDI& a, const PairDI& b) const {
    return a.dist > b.dist || (a.dist == b.dist && a.id > b.id);
  }
};
struct FartherFirst {
  bool operator()(const PairDI& a, const PairDI& b) const {
    return a.dist < b.dist || (a.dist == b.dist && a.id < b.id);
  }
};

using MinQ = std::priority_queue<PairDI, std::vector<PairDI>, NearerFirst>;
using MaxQ = std::priority_queue<PairDI, std::vector<PairDI>, FartherFirst>;

inline float l2sq(const float* a, const float* b, int d) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int i = 0;
  for (; i + 4 <= d; i += 4) {
    float d0 = a[i] - b[i];
    float d1 = a[i + 1] - b[i + 1];
    float d2 = a[i + 2] - b[i + 2];
    float d3 = a[i + 3] - b[i + 3];
    s0 += d0 * d0;
    s1 += d1 * d1;
    s2 += d2 * d2;
    s3 += d3 * d3;
  }
  for (; i < d; ++i) {
    float dd = a[i] - b[i];
    s0 += dd * dd;
  }
  return s0 + s1 + s2 + s3;
}

inline float ipdist(const float* a, const float* b, int d) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int i = 0;
  for (; i + 4 <= d; i += 4) {
    s0 += a[i] * b[i];
    s1 += a[i + 1] * b[i + 1];
    s2 += a[i + 2] * b[i + 2];
    s3 += a[i + 3] * b[i + 3];
  }
  for (; i < d; ++i) s0 += a[i] * b[i];
  return 1.f - (s0 + s1 + s2 + s3);
}

class Builder {
 public:
  Builder(const float* vecs, int64_t n, int d, int M, int efc, uint64_t seed,
          int metric, int32_t* levels, int32_t* neighbors0, int32_t* upper_row,
          int32_t* upper_neighbors, int64_t upper_cap, int level_cap)
      : vecs_(vecs),
        n_(n),
        d_(d),
        M_(M),
        Mmax_(M),
        Mmax0_(2 * M),
        efc_(efc),
        metric_(metric),
        levels_(levels),
        neighbors0_(neighbors0),
        upper_row_(upper_row),
        upper_neighbors_(upper_neighbors),
        upper_cap_(upper_cap),
        level_cap_(level_cap),
        locks_(static_cast<size_t>(n)),
        deg0_(static_cast<size_t>(n)),
        mult_(1.0 / std::log(static_cast<double>(M))) {
    std::fill(neighbors0_, neighbors0_ + n_ * Mmax0_, -1);
    std::fill(upper_row_, upper_row_ + n_, -1);
    std::fill(upper_neighbors_, upper_neighbors_ + upper_cap_ * level_cap_ * M_,
              -1);
    for (int64_t i = 0; i < n_; ++i) {
      levels_[i] = -1;  // not inserted yet
      deg0_[i].store(0, std::memory_order_relaxed);
    }
    // deterministic per-id level draw (independent of thread schedule)
    seed_ = seed;
  }

  int draw_level(int64_t id) const {
    std::mt19937_64 rng(seed_ ^ (0x9E3779B97F4A7C15ULL * (id + 1)));
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double r = u(rng);
    if (r <= 0.0) r = 1e-300;
    int lvl = static_cast<int>(-std::log(r) * mult_);
    return std::min(lvl, level_cap_);
  }

  inline float dist(const float* a, const float* b) const {
    return metric_ == kMetricIP ? ipdist(a, b, d_) : l2sq(a, b, d_);
  }
  inline const float* vec(int32_t id) const { return vecs_ + (int64_t)id * d_; }

  // --- adjacency accessors -------------------------------------------------
  // level 0 list: neighbors0_[id*Mmax0 .. ), degree in deg0_[id]
  // level l>=1 list: upper_neighbors_[(upper_row[id]*level_cap + (l-1))*M .. )
  int32_t* list0(int32_t id) { return neighbors0_ + (int64_t)id * Mmax0_; }
  int32_t* list_u(int32_t id, int l) {
    int64_t row = upper_row_[id];
    return upper_neighbors_ + ((row * level_cap_) + (l - 1)) * M_;
  }

  int degree(int32_t id, int l) {
    if (l == 0) return deg0_[id].load(std::memory_order_acquire);
    const int32_t* ls = list_u(id, l);
    int c = 0;
    while (c < M_ && ls[c] >= 0) ++c;
    return c;
  }

  // --- search --------------------------------------------------------------
  // Greedy 1-NN descent on one level (reference search_for_one,
  // hnsw.hh:331-393). Locking the scanned vertex during construction matches
  // the reference's with_lock behavior.
  PairDI search_for_one(const float* q, PairDI ep, int level, bool lock) {
    bool improved = true;
    while (improved) {
      improved = false;
      int32_t cur = ep.id;
      std::unique_lock<std::mutex> guard;
      if (lock) guard = std::unique_lock<std::mutex>(locks_[cur]);
      const int32_t* ls = level == 0 ? list0(cur) : list_u(cur, level);
      int cap = level == 0 ? Mmax0_ : M_;
      for (int j = 0; j < cap; ++j) {
        int32_t nb = ls[j];
        if (nb < 0) break;
        float dd = dist(q, vec(nb));
        if (dd < ep.dist || (dd == ep.dist && nb < ep.id)) {
          ep = {dd, nb};
          improved = true;
        }
      }
    }
    return ep;
  }

  // ef-bounded best-first search on one level (reference search_level,
  // hnsw.hh:406-476). Returns up to ef results, nearest first.
  std::vector<PairDI> search_level(const float* q, PairDI ep, int level,
                                   int ef, bool lock,
                                   std::vector<uint64_t>& visited,
                                   uint64_t stamp) {
    MinQ cand;
    MaxQ top;
    cand.push(ep);
    top.push(ep);
    visited[ep.id] = stamp;
    while (!cand.empty()) {
      PairDI c = cand.top();
      if (c.dist > top.top().dist && (int)top.size() >= ef) break;
      cand.pop();
      std::unique_lock<std::mutex> guard;
      if (lock) guard = std::unique_lock<std::mutex>(locks_[c.id]);
      const int32_t* ls = level == 0 ? list0(c.id) : list_u(c.id, level);
      int cap = level == 0 ? Mmax0_ : M_;
      for (int j = 0; j < cap; ++j) {
        int32_t nb = ls[j];
        if (nb < 0) break;
        if (visited[nb] == stamp) continue;
        visited[nb] = stamp;
        float dd = dist(q, vec(nb));
        if ((int)top.size() < ef || dd < top.top().dist ||
            (dd == top.top().dist && nb < top.top().id)) {
          cand.push({dd, nb});
          top.push({dd, nb});
          if ((int)top.size() > ef) top.pop();
        }
      }
    }
    std::vector<PairDI> out(top.size());
    for (int i = (int)top.size() - 1; i >= 0; --i) {
      out[i] = top.top();
      top.pop();
    }
    return out;
  }

  // Diversity heuristic (reference select_heuristic, hnsw.hh:482-522):
  // scan candidates nearest-first; keep c iff it is closer to q than to any
  // already-kept element.
  void select_heuristic(std::vector<PairDI>& cands, int M) const {
    if ((int)cands.size() <= M) return;
    std::sort(cands.begin(), cands.end(), [](const PairDI& a, const PairDI& b) {
      return a.dist < b.dist || (a.dist == b.dist && a.id < b.id);
    });
    std::vector<PairDI> kept;
    kept.reserve(M);
    for (const PairDI& c : cands) {
      if ((int)kept.size() >= M) break;
      bool good = true;
      for (const PairDI& k : kept) {
        float dck = dist(vec(c.id), vec(k.id));
        if (dck < c.dist) {
          good = false;
          break;
        }
      }
      if (good) kept.push_back(c);
    }
    cands = std::move(kept);
  }

  // --- insertion -----------------------------------------------------------
  void insert(int32_t id, std::vector<uint64_t>& visited, uint64_t& stamp) {
    int level = draw_level(id);
    const float* q = vec(id);

    // claim upper rows before publishing
    if (level > 0) {
      int64_t row = upper_next_.fetch_add(1, std::memory_order_relaxed);
      if (row >= upper_cap_) {
        overflow_.store(true, std::memory_order_relaxed);
        level = 0;
      } else {
        upper_row_[id] = (int32_t)row;
      }
    }

    // bootstrap / entry point read (reference hnsw.hh:56-96)
    int32_t ep_id;
    int ep_level;
    {
      std::unique_lock<std::mutex> g(global_lock_);
      if (entry_point_ < 0) {
        levels_[id] = level;
        entry_point_ = id;
        top_level_ = level;
        return;
      }
      ep_id = entry_point_;
      ep_level = top_level_;
    }
    bool new_top = level > ep_level;
    // when the insert raises the top level the reference holds the global
    // new-level lock for the whole insert (hnsw.hh:101-107); here the EP is
    // only re-checked and swapped at the end under that lock. Holding the
    // lock for the whole insert changes nothing measurable: on 8 threads
    // most builds of a 200-vector set stay inexact either way. What
    // loses vertices is another thread finding this one through a level above
    // while its lists below are still empty: that thread's search there sees
    // nothing but this vertex, and its connect() into the empty list is
    // overwritten when this vertex writes it. So the connects wait below
    // until every list of this vertex is written.

    levels_[id] = level;

    PairDI ep{dist(q, vec(ep_id)), ep_id};
    for (int l = ep_level; l > level; --l)
      ep = search_for_one(q, ep, l, /*lock=*/true);

    const int top = std::min(level, ep_level);
    std::vector<std::vector<PairDI>> chosen(top + 1);
    for (int l = top; l >= 0; --l) {
      ++stamp;
      std::vector<PairDI> cands =
          search_level(q, ep, l, efc_, /*lock=*/true, visited, stamp);
      ep = cands.front();
      select_heuristic(cands, M_);
      // write the new node's list for this level
      {
        std::lock_guard<std::mutex> g(locks_[id]);
        int32_t* ls = l == 0 ? list0(id) : list_u(id, l);
        int cap = l == 0 ? Mmax0_ : M_;
        int c = 0;
        for (const PairDI& p : cands) {
          if (c >= cap) break;
          ls[c++] = p.id;
        }
        if (l == 0) deg0_[id].store(c, std::memory_order_release);
      }
      chosen[l] = std::move(cands);
    }
    // bidirectional connect with shrink-if-full (hnsw.hh:180-225), top level
    // first, once no list of this vertex is left to write
    for (int l = top; l >= 0; --l)
      for (const PairDI& p : chosen[l]) connect(p.id, id, p.dist, l);

    if (new_top) {
      std::unique_lock<std::mutex> g(global_lock_);
      if (level > top_level_) {
        top_level_ = level;
        entry_point_ = id;
      }
    }
  }

  void connect(int32_t dst, int32_t src, float d_sd, int l) {
    std::lock_guard<std::mutex> g(locks_[dst]);
    int cap = l == 0 ? Mmax0_ : M_;
    int32_t* ls = l == 0 ? list0(dst) : list_u(dst, l);
    int deg = degree(dst, l);
    if (deg < cap) {
      ls[deg] = src;
      if (l == 0) deg0_[dst].store(deg + 1, std::memory_order_release);
      return;
    }
    // full: re-select among existing + new (reference hnsw.hh:204-223)
    std::vector<PairDI> cands;
    cands.reserve(deg + 1);
    cands.push_back({d_sd, src});
    const float* dv = vec(dst);
    for (int j = 0; j < deg; ++j) cands.push_back({dist(dv, vec(ls[j])), ls[j]});
    select_heuristic(cands, cap);
    int c = 0;
    for (const PairDI& p : cands) ls[c++] = p.id;
    for (int j = c; j < cap; ++j) ls[j] = -1;
    if (l == 0) deg0_[dst].store(c, std::memory_order_release);
  }

  void run(int threads) {
    if (threads < 1) threads = 1;
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
      std::vector<uint64_t> visited(n_, 0);
      uint64_t stamp = 0;
      for (;;) {
        int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n_) return;
        insert((int32_t)i, visited, stamp);
      }
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
  }

  // Give every level-0 vertex that the entry point does not reach an
  // in-edge from a reachable one (the header's second repair), in rounds:
  // each round marks what the entry point reaches afresh and links every
  // vertex it misses, until a round finds none (or can link none). A
  // replaced edge is one whose target the entry point still reaches without
  // it, so no repair cuts another vertex off. Returns the number of
  // vertices repaired.
  int64_t repair_level0() {
    if (entry_point_ < 0) return 0;
    std::vector<char> seen(n_, 0);
    std::vector<int32_t> stack;
    auto reach = [&](int32_t from) {  // mark everything level 0 reaches from it
      stack.assign(1, from);
      seen[from] = 1;
      while (!stack.empty()) {
        const int32_t* ls = list0(stack.back());
        stack.pop_back();
        for (int j = 0; j < Mmax0_ && ls[j] >= 0; ++j)
          if (!seen[ls[j]]) {
            seen[ls[j]] = 1;
            stack.push_back(ls[j]);
          }
      }
    };
    // whether level 0 reaches w from the entry point without u's slot j
    std::vector<uint64_t> mark(n_, 0);
    uint64_t mark_stamp = 0;
    auto reached_without = [&](int32_t u, int slot, int32_t w) {
      if (w == entry_point_) return true;
      ++mark_stamp;
      stack.assign(1, entry_point_);
      mark[entry_point_] = mark_stamp;
      while (!stack.empty()) {
        const int32_t x = stack.back();
        stack.pop_back();
        const int32_t* ls = list0(x);
        for (int j = 0; j < Mmax0_ && ls[j] >= 0; ++j) {
          const int32_t y = ls[j];
          if ((x == u && j == slot) || mark[y] == mark_stamp) continue;
          if (y == w) return true;
          mark[y] = mark_stamp;
          stack.push_back(y);
        }
      }
      return false;
    };
    // link v from a vertex of near (reachable, nearest first): the first
    // with room in its list, else in place of the farthest neighbour of the
    // nearest one that can spare it
    auto link = [&](int32_t v, const std::vector<PairDI>& near) {
      for (const PairDI& c : near)
        if (c.id != v && degree(c.id, 0) < Mmax0_) {
          const int deg = degree(c.id, 0);
          list0(c.id)[deg] = v;
          deg0_[c.id].store(deg + 1, std::memory_order_release);
          return true;
        }
      for (const PairDI& c : near) {
        if (c.id == v) continue;
        int32_t* ls = list0(c.id);
        std::vector<PairDI> slots;  // (distance to c, slot), farthest first
        for (int j = 0; j < Mmax0_; ++j) slots.push_back({dist(vec(c.id), vec(ls[j])), j});
        std::sort(slots.begin(), slots.end(), NearerFirst());  // descending
        for (const PairDI& sj : slots)
          if (reached_without(c.id, sj.id, ls[sj.id])) {
            ls[sj.id] = v;
            return true;
          }
      }
      return false;
    };
    std::vector<uint64_t> visited(n_, 0);
    uint64_t stamp = 0;
    int64_t repaired = 0;
    for (;;) {
      std::fill(seen.begin(), seen.end(), 0);
      reach(entry_point_);
      int64_t linked = 0;
      for (int32_t v = 0; v < n_; ++v) {
        if (seen[v] || levels_[v] < 0) continue;
        const float* q = vec(v);
        PairDI ep{dist(q, vec(entry_point_)), entry_point_};
        // the search walks level 0 from the entry point: all it returns is
        // reachable
        std::vector<PairDI> near =
            search_level(q, ep, 0, std::max(efc_, Mmax0_), /*lock=*/false, visited, ++stamp);
        if (!link(v, near)) continue;
        reach(v);
        ++linked;
      }
      repaired += linked;
      if (linked == 0) return repaired;
    }
  }

  // Take over a finished level-0 graph (levels, lists and entry point as
  // shine_hnsw_build writes them) so that repair_level0 can run on it.
  void adopt(const int32_t* levels, const int32_t* neighbors0, int32_t entry_point) {
    std::copy(levels, levels + n_, levels_);
    std::copy(neighbors0, neighbors0 + n_ * Mmax0_, neighbors0_);
    for (int64_t i = 0; i < n_; ++i) {
      int c = 0;
      while (c < Mmax0_ && neighbors0_[i * Mmax0_ + c] >= 0) ++c;
      deg0_[i].store(c, std::memory_order_relaxed);
    }
    entry_point_ = entry_point;
  }

  int32_t entry_point() const { return entry_point_; }
  int top_level() const { return top_level_; }
  int64_t upper_used() const {
    int64_t v = upper_next_.load();
    return v < upper_cap_ ? v : upper_cap_;
  }
  bool overflowed() const { return overflow_.load(); }

 private:
  const float* vecs_;
  int64_t n_;
  int d_, M_, Mmax_, Mmax0_, efc_, metric_;
  int32_t* levels_;
  int32_t* neighbors0_;
  int32_t* upper_row_;
  int32_t* upper_neighbors_;
  int64_t upper_cap_;
  int level_cap_;
  uint64_t seed_;
  std::vector<std::mutex> locks_;
  std::vector<std::atomic<int32_t>> deg0_;
  std::mutex global_lock_;
  int32_t entry_point_ = -1;
  int top_level_ = 0;
  std::atomic<int64_t> upper_next_{0};
  std::atomic<bool> overflow_{false};
  double mult_;
};

}  // namespace

extern "C" {

// Returns 0 on success, 1 if the upper-row capacity overflowed (affected
// nodes were demoted to level 0; the build is still valid).
// Outputs:
//   levels[n]                       node max level (0-based)
//   neighbors0[n * 2M]              level-0 adjacency, -1 padded
//   upper_row[n]                    row into upper_neighbors, -1 if level==0
//   upper_neighbors[upper_cap * level_cap * M]  levels 1..level_cap, -1 padded
//   meta[3] = {entry_point, top_level, upper_rows_used}
int shine_hnsw_build(const float* vecs, int64_t n, int d, int M, int efc,
                     uint64_t seed, int metric, int threads, int64_t upper_cap,
                     int level_cap, int32_t* levels, int32_t* neighbors0,
                     int32_t* upper_row, int32_t* upper_neighbors,
                     int64_t* meta) {
  Builder b(vecs, n, d, M, efc, seed, metric, levels, neighbors0, upper_row,
            upper_neighbors, upper_cap, level_cap);
  b.run(threads);
  if (threads > 1) b.repair_level0();
  meta[0] = b.entry_point();
  meta[1] = b.top_level();
  meta[2] = b.upper_used();
  return b.overflowed() ? 1 : 0;
}

// The threaded build's level-0 repair (repair_level0) run on a given graph
// of n vectors: levels[n] and neighbors0[n * 2M] are read and rewritten in
// place. Returns the number of vertices repaired. It lets the tests hand the
// repair graphs that no build is sure to produce.
int64_t shine_hnsw_repair_level0(const float* vecs, int64_t n, int d, int M, int efc,
                                 int metric, int32_t entry_point, int32_t* levels,
                                 int32_t* neighbors0) {
  const std::vector<int32_t> lv(levels, levels + n), nb(neighbors0, neighbors0 + n * 2 * M);
  std::vector<int32_t> upper_row(n);
  int32_t upper_neighbors = 0;
  Builder b(vecs, n, d, M, efc, 0, metric, levels, neighbors0, upper_row.data(),
            &upper_neighbors, 0, 0);
  b.adopt(lv.data(), nb.data(), entry_point);
  return b.repair_level0();
}

// Host-side reference k-NN search over the built graph (no locks), used as
// the semantic oracle for the batched search on the card (reference knn,
// hnsw.hh:253-307). results must hold nq*k int32; dists nq*k float.
void shine_hnsw_search(const float* vecs, int64_t n, int d, int M, int metric,
                       const int32_t* levels, const int32_t* neighbors0,
                       const int32_t* upper_row, const int32_t* upper_neighbors,
                       int level_cap, int32_t entry_point, int top_level,
                       const float* queries, int64_t nq, int k, int ef,
                       int threads, int32_t* results, float* dists) {
  auto vec = [&](int32_t id) { return vecs + (int64_t)id * d; };
  auto dist = [&](const float* a, const float* b) {
    return metric == kMetricIP ? ipdist(a, b, d) : l2sq(a, b, d);
  };
  const int Mmax0_cols = 2 * M;  // level-0 row stride
  auto list0 = [&](int32_t id) { return neighbors0 + (int64_t)id * Mmax0_cols; };
  auto list_u = [&](int32_t id, int l) {
    return upper_neighbors + (((int64_t)upper_row[id] * level_cap) + (l - 1)) * M;
  };
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<uint64_t> visited(n, 0);
    uint64_t stamp = 0;
    for (;;) {
      int64_t qi = next.fetch_add(1, std::memory_order_relaxed);
      if (qi >= nq) return;
      const float* q = queries + qi * d;
      PairDI ep{dist(q, vec(entry_point)), entry_point};
      for (int l = top_level; l >= 1; --l) {
        bool improved = true;
        while (improved) {
          improved = false;
          const int32_t* ls = list_u(ep.id, l);
          for (int j = 0; j < M; ++j) {
            int32_t nb = ls[j];
            if (nb < 0) break;
            float dd = dist(q, vec(nb));
            if (dd < ep.dist || (dd == ep.dist && nb < ep.id)) {
              ep = {dd, nb};
              improved = true;
            }
          }
        }
      }
      ++stamp;
      MinQ cand;
      MaxQ top;
      cand.push(ep);
      top.push(ep);
      visited[ep.id] = stamp;
      while (!cand.empty()) {
        PairDI c = cand.top();
        if (c.dist > top.top().dist && (int)top.size() >= ef) break;
        cand.pop();
        const int32_t* ls = list0(c.id);
        for (int j = 0; j < Mmax0_cols; ++j) {
          int32_t nb = ls[j];
          if (nb < 0) break;
          if (visited[nb] == stamp) continue;
          visited[nb] = stamp;
          float dd = dist(q, vec(nb));
          if ((int)top.size() < ef || dd < top.top().dist ||
              (dd == top.top().dist && nb < top.top().id)) {
            cand.push({dd, nb});
            top.push({dd, nb});
            if ((int)top.size() > ef) top.pop();
          }
        }
      }
      std::vector<PairDI> out(top.size());
      for (int i = (int)top.size() - 1; i >= 0; --i) {
        out[i] = top.top();
        top.pop();
      }
      for (int i = 0; i < k; ++i) {
        if (i < (int)out.size()) {
          results[qi * k + i] = out[i].id;
          dists[qi * k + i] = out[i].dist;
        } else {
          results[qi * k + i] = -1;
          dists[qi * k + i] = INFINITY;
        }
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 1; t < threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& th : pool) th.join();
}

// Host reverse-edge merge for the fastbuild pipeline — the C++ twin of
// models/fastbuild.py:_reverse_merge (semantics MUST stay bit-identical;
// tests/test_torch_fastbuild.py asserts exact equality on adversarial ties).
// Per vertex: candidates = forward edges ∪ incoming reverse edges, incoming
// ranked by (dist, src) with at most cap_c granted, the union sorted by
// (dist, id) ascending with -1 pads last, adjacent-duplicate ids dropped.
// numpy's three global lexsorts over the (n*M,) edge list are O(E log E)
// with big constants; here: one stable counting sort by destination row + per-row
// small sorts. Edges whose destination is not in `ids` are skipped (the
// callers never produce one: forward edges point within the level set).
int shine_reverse_merge(const int32_t* fwd_sel, const float* fwd_d,
                        const int32_t* ids, int64_t n, int M, int cap_c,
                        int32_t* cand_out, float* cd_out, int threads) {
  if (n <= 0 || M <= 0 || cap_c <= 0) return 1;
  if (threads <= 0)
    threads = std::max(1u, std::thread::hardware_concurrency());
  int32_t max_id = 0;
  for (int64_t i = 0; i < n; ++i) max_id = std::max(max_id, ids[i]);
  std::vector<int32_t> row_of((size_t)max_id + 1, -1);
  for (int64_t i = 0; i < n; ++i) row_of[(size_t)ids[i]] = (int32_t)i;

  const int64_t E = n * (int64_t)M;
  // pass 1: incoming degree per destination row
  std::vector<int64_t> off(n + 1, 0);
  for (int64_t e = 0; e < E; ++e) {
    int32_t v = fwd_sel[e];
    if (v < 0 || v > max_id) continue;
    int32_t r = row_of[(size_t)v];
    if (r >= 0) ++off[r + 1];
  }
  for (int64_t i = 0; i < n; ++i) off[i + 1] += off[i];
  struct Inc {
    float d;
    int32_t src;
  };
  std::vector<Inc> inc((size_t)off[n]);
  std::vector<int64_t> fill(off.begin(), off.end() - 1);
  // pass 2: bucket-fill in forward edge order (stable within a row)
  for (int64_t i = 0; i < n; ++i) {
    const int32_t u = ids[i];
    const int64_t base = i * (int64_t)M;
    for (int j = 0; j < M; ++j) {
      int32_t v = fwd_sel[base + j];
      if (v < 0 || v > max_id) continue;
      int32_t r = row_of[(size_t)v];
      if (r < 0) continue;
      inc[(size_t)fill[r]++] = {fwd_d[base + j], u};
    }
  }

  struct Ent {
    float d;
    int32_t key;  // id with -1 -> INT32_MAX (pads sort last)
    int32_t id;
  };
  // NOTE on stability: numpy's lexsorts are stable, but every tie the
  // comparator cannot split is a fully identical element (key encodes
  // id; an (d, src) tie in `inc` is a duplicate edge), so plain
  // std::sort (no per-call allocation, unlike stable_sort) produces
  // bit-identical output.
  const auto by_dist_key = [](const Ent& a, const Ent& b) {
    if (a.d != b.d) return a.d < b.d;
    return a.key < b.key;
  };
  const int W = cap_c + M;
  // per-row work is independent after the counting sort (each thread
  // sorts only its own rows' buckets) -> bit-identical at any thread
  // count
  const auto worker = [&](int64_t lo, int64_t hi) {
    std::vector<Ent> row((size_t)W);
    for (int64_t i = lo; i < hi; ++i) {
      // incoming, ranked by (dist, src) in place in its bucket — like
      // np.lexsort((src, dists, rows)) within one row group
      std::sort(inc.begin() + off[i], inc.begin() + off[i + 1],
                [](const Inc& a, const Inc& b) {
                  if (a.d != b.d) return a.d < b.d;
                  return a.src < b.src;
                });
      const int n_in = (int)std::min<int64_t>(off[i + 1] - off[i], cap_c);
      // assemble: forward first, then granted incoming, then pads
      const int64_t base = i * (int64_t)M;
      for (int j = 0; j < M; ++j) {
        int32_t c = fwd_sel[base + j];
        // fwd_d kept verbatim at -1 pads (numpy does not mask it; the
        // callers always pass inf there — select_heuristic's pad value)
        row[j] = {fwd_d[base + j], c < 0 ? INT32_MAX : c, c};
      }
      const Inc* in_s = inc.data() + off[i];
      for (int j = 0; j < n_in; ++j)
        row[M + j] = {in_s[j].d, in_s[j].src, in_s[j].src};
      for (int j = M + n_in; j < W; ++j)
        row[j] = {INFINITY, INT32_MAX, -1};
      std::sort(row.begin(), row.end(), by_dist_key);
      // adjacent-duplicate ids -> dropped; compacting the survivors
      // left and padding the tail IS the numpy "pad + re-lexsort": the
      // array is sorted, survivors keep relative order, and a pad
      // (inf, INT32_MAX) never sorts before one.
      int w = 0;
      const int64_t out = i * (int64_t)cap_c;
      for (int j = 0; j < W && w < cap_c; ++j) {
        if (j > 0 && row[j].id == row[j - 1].id) continue;
        cand_out[out + w] = row[j].id;
        cd_out[out + w] = row[j].d;
        ++w;
      }
      for (; w < cap_c; ++w) {
        cand_out[out + w] = -1;
        cd_out[out + w] = INFINITY;
      }
    }
  };
  if (threads == 1) {
    worker(0, n);
  } else {
    std::vector<std::thread> pool;
    const int64_t step = (n + threads - 1) / threads;
    for (int t = 0; t < threads; ++t) {
      const int64_t lo = t * step;
      if (lo >= n) break;
      pool.emplace_back(worker, lo, std::min(n, lo + step));
    }
    for (auto& th : pool) th.join();
  }
  return 0;
}

}  // extern "C"
