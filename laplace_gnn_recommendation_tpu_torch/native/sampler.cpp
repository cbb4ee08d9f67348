// Native host-side graph samplers (the PyTorch port's copy of the JAX
// package's native/sampler.cpp, kept identical below this header so both
// packages draw the same batches from one seed).
//
// The N-hop BFS (fetch_n_hop_neighbourhood of the reference's
// data/dataset.py:258-293), the whole-batch assembly of the ranking stack's
// subgraph sampler, the collaborative 2-hop matcher and the PinSAGE
// random-walk frontier, as C++ over CSR arrays, OpenMP-parallel across the
// seeds of a batch. Python binds via ctypes (native/__init__.py).
//
// Build: g++ -O3 -march=native -shared -fPIC -fopenmp sampler.cpp -o libsampler.so

#include <atomic>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

// Per-seed parallel map with one thread-local context per worker.
//
// Production builds use OpenMP. TSAN builds (-DSAMPLER_STD_THREADS, see
// native.run_sanitizer_check) swap in a std::thread pool with an atomic
// work counter: libgomp is not TSAN-instrumented, so its fork-join
// hand-off reads as a race on main's capture struct (a known false
// positive); std::thread creation/join and the atomic fetch_add are fully
// TSAN-visible, and the USER code under test — BFS, sampling, assembly
// over shared per-seed vectors — is byte-for-byte the same.
#ifdef SAMPLER_STD_THREADS
#include <thread>
template <typename MakeCtx, typename Fn>
static void parallel_seeds(int64_t n, MakeCtx&& make_ctx, Fn&& fn) {
  const unsigned hw = std::thread::hardware_concurrency();
  const int64_t nt = std::min<int64_t>(std::max(1u, hw), std::max<int64_t>(n, 1));
  std::atomic<int64_t> next(0);
  std::vector<std::thread> workers;
  workers.reserve(nt);
  for (int64_t t = 0; t < nt; ++t) {
    workers.emplace_back([&]() {
      auto ctx = make_ctx();
      for (int64_t s; (s = next.fetch_add(1, std::memory_order_relaxed)) < n;)
        fn(ctx, s);
    });
  }
  for (auto& w : workers) w.join();
}
#else
template <typename MakeCtx, typename Fn>
static void parallel_seeds(int64_t n, MakeCtx&& make_ctx, Fn&& fn) {
#ifdef _OPENMP
#pragma omp parallel
#endif
  {
    auto ctx = make_ctx();
#ifdef _OPENMP
#pragma omp for schedule(dynamic)
#endif
    for (int64_t s = 0; s < n; ++s) fn(ctx, s);
  }
}
#endif

namespace {

// splitmix64 — deterministic, seedable, fast.
struct Rng {
  uint64_t state;
  explicit Rng(uint64_t seed) : state(seed + 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) {
    if (n == 0) return 0;
    __uint128_t m = (__uint128_t)next() * (__uint128_t)n;
    return (uint64_t)(m >> 64);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

// sample min(n, k) distinct elements from arr[0..n) without replacement
// (partial Fisher-Yates on a scratch copy).
void sample_cut(const int32_t* arr, int64_t n, int64_t k, Rng& rng,
                std::vector<int32_t>& out) {
  out.clear();
  if (n <= k) {
    out.assign(arr, arr + n);
    return;
  }
  std::vector<int32_t> scratch(arr, arr + n);
  for (int64_t i = 0; i < k; ++i) {
    int64_t j = i + (int64_t)rng.bounded((uint64_t)(n - i));
    std::swap(scratch[i], scratch[j]);
    out.push_back(scratch[i]);
  }
}

// scratch buffers for one BFS worker thread; persisted thread_local across
// calls (OpenMP keeps its thread pool alive) so batches don't re-zero
// O(num_users) stamp arrays. Validity of a stamp entry is "== gen" where gen
// comes from a process-global atomic counter, unique per seed across ALL
// calls — stale entries from earlier batches can never collide.
struct BfsScratch {
  std::vector<int64_t> explored_stamp, seen_stamp;
  std::vector<int32_t> new_articles, articles_queue, cut_buf, queue, new_users;
  std::vector<int64_t> prefix;
  void ensure(int64_t num_users) {
    if ((int64_t)explored_stamp.size() < num_users) {
      explored_stamp.assign(num_users, 0);
      seen_stamp.assign(num_users, 0);
    }
  }
};

BfsScratch* tls_bfs_scratch(int64_t num_users) {
  thread_local BfsScratch sc;
  sc.ensure(num_users);
  return &sc;
}

std::atomic<int64_t> g_bfs_gen{1};

// Above this many neighbor occurrences in a hop frontier, the exact
// enumerate→dedup→sort→uniform-cut of the reference semantics
// (data/dataset.py:258-293) is replaced by rejection sampling over
// occurrences: draw a random (article, position) slot, reject already-seen
// users, until num_neighbors NEW users are found. This is occurrence-
// weighted (degree-biased) frontier selection — the standard GraphSAGE
// compromise — and only engages on graphs whose popular items have tens of
// thousands of users (H&M/at-scale shapes), where the exact path would scan
// and sort 100k+ users per seed per hop. All golden/parity-test graphs stay
// on the exact path bit-for-bit; ML-1M mostly does too, though a hot
// frontier (num_neighbors popular movies at ~3.4k degree) can exceed the
// cap and engage rejection for that hop.
constexpr int64_t kExactFrontierScanCap = 32768;

// one seed's N-hop BFS (fetch_n_hop_neighbourhood semantics,
// data/dataset.py:258-293); appends hop edges to (srcs, dsts)
void bfs_seed(
    const int64_t* user_row_ptr, const int32_t* user_cols,
    const int64_t* item_row_ptr, const int32_t* item_cols,
    int32_t seed, int32_t n_hops, int32_t num_neighbors,
    int64_t gen, Rng& rng, BfsScratch& sc,
    std::vector<int32_t>& srcs, std::vector<int32_t>& dsts) {
  sc.queue.assign(1, seed);
  sc.explored_stamp[seed] = gen;
  for (int32_t hop = 0; hop < n_hops; ++hop) {
    if (sc.queue.empty()) break;
    sc.new_articles.clear();
    for (int32_t u : sc.queue) {
      const int64_t lo = user_row_ptr[u], hi = user_row_ptr[u + 1];
      for (int64_t e = lo; e < hi; ++e) {
        const int32_t a = user_cols[e];
        sc.new_articles.push_back(a);
        if (hop != 0) {
          srcs.push_back(u);
          dsts.push_back(a);
        }
      }
    }
    sample_cut(sc.new_articles.data(), (int64_t)sc.new_articles.size(),
               num_neighbors, rng, sc.articles_queue);
    // frontier-user occurrence count decides exact vs rejection selection
    sc.prefix.clear();
    int64_t total = 0;
    for (int32_t a : sc.articles_queue) {
      sc.prefix.push_back(total);
      total += item_row_ptr[a + 1] - item_row_ptr[a];
    }
    if (total > kExactFrontierScanCap) {
      // rejection sampling over (article, position) occurrence slots —
      // degree-biased over distinct users; O(num_neighbors) instead of
      // O(total + distinct·log distinct).
      //
      // Documented semantic divergence from the exact path (beyond the
      // degree bias): the exact path stamps EVERY scanned user seen —
      // including scanned-but-unselected ones — so later hops never
      // revisit them; this path never enumerates the unselected users, so
      // it stamps only accepted ones and later hops may re-draw users the
      // exact path would have excluded. Acceptable at the scales that
      // engage this path (hop unions ≫ num_neighbors, so the revisit
      // probability is tiny).
      sc.cut_buf.clear();
      const int64_t cap = 24 * (int64_t)num_neighbors + 64;
      for (int64_t attempts = 0;
           (int64_t)sc.cut_buf.size() < num_neighbors && attempts < cap;
           ++attempts) {
        const int64_t o = (int64_t)rng.bounded((uint64_t)total);
        // articles_queue has ≤ num_neighbors entries: binary search the
        // prefix array for the owning article
        const size_t ai =
            (size_t)(std::upper_bound(sc.prefix.begin(), sc.prefix.end(), o) -
                     sc.prefix.begin()) - 1;
        const int32_t a = sc.articles_queue[ai];
        const int32_t u2 = item_cols[item_row_ptr[a] + (o - sc.prefix[ai])];
        if (sc.explored_stamp[u2] == gen || sc.seen_stamp[u2] == gen) continue;
        sc.seen_stamp[u2] = gen;
        sc.cut_buf.push_back(u2);
      }
      if ((int64_t)sc.cut_buf.size() < num_neighbors) {
        // the attempt cap under-filled the hop — unseen users are a small
        // fraction of a huge occurrence total (heavy revisit pressure).
        // Fall back to the exact scan for the REMAINING slots instead of
        // silently shrinking the frontier: enumerate unseen users once
        // and uniform-cut them (rejection-accepted users keep their
        // slots; the scan skips them via seen_stamp).
        sc.new_users.clear();
        for (int32_t a : sc.articles_queue) {
          const int64_t lo = item_row_ptr[a], hi = item_row_ptr[a + 1];
          for (int64_t e = lo; e < hi; ++e) {
            const int32_t u2 = item_cols[e];
            if (sc.explored_stamp[u2] != gen && sc.seen_stamp[u2] != gen) {
              sc.seen_stamp[u2] = gen;
              sc.new_users.push_back(u2);
            }
          }
        }
        std::sort(sc.new_users.begin(), sc.new_users.end());  // determinism
        // new_articles is free until the next hop refills it — reuse as
        // the remainder buffer (sample_cut clears its out vector)
        sample_cut(sc.new_users.data(), (int64_t)sc.new_users.size(),
                   num_neighbors - (int64_t)sc.cut_buf.size(), rng,
                   sc.new_articles);
        sc.cut_buf.insert(sc.cut_buf.end(), sc.new_articles.begin(),
                          sc.new_articles.end());
      }
    } else {
      sc.new_users.clear();
      for (int32_t a : sc.articles_queue) {
        const int64_t lo = item_row_ptr[a], hi = item_row_ptr[a + 1];
        for (int64_t e = lo; e < hi; ++e) {
          const int32_t u2 = item_cols[e];
          if (sc.explored_stamp[u2] != gen && sc.seen_stamp[u2] != gen) {
            sc.seen_stamp[u2] = gen;
            sc.new_users.push_back(u2);
          }
        }
      }
      std::sort(sc.new_users.begin(), sc.new_users.end());  // determinism
      sample_cut(sc.new_users.data(), (int64_t)sc.new_users.size(),
                 num_neighbors, rng, sc.cut_buf);
    }
    for (int32_t u2 : sc.cut_buf) sc.explored_stamp[u2] = gen;
    sc.queue = sc.cut_buf;
  }
}

}  // namespace

extern "C" {

// N-hop BFS neighborhoods for a batch of seed users.
//
// Per seed: hop edges (excluding the seed's own direct edges, which the
// caller adds as positive edges), frontier capped at num_neighbors articles
// and num_neighbors users per hop, users explored at most once — exactly the
// semantics of fetch_n_hop_neighbourhood (data/dataset.py:258-293).
//
// Outputs: flat (src, dst) arrays; out_offsets[i]..out_offsets[i+1] is seed
// i's slice. Returns 0 on success, -1 if max_edges was exceeded (callers
// should retry with a larger buffer; counts are still valid up to the
// failing seed).
int64_t nhop_sample(
    const int64_t* user_row_ptr, const int32_t* user_cols,
    const int64_t* item_row_ptr, const int32_t* item_cols,
    int64_t num_users, int64_t /*num_items*/,
    const int32_t* seeds, int64_t num_seeds,
    int32_t n_hops, int32_t num_neighbors,
    uint64_t rng_seed,
    int32_t* out_src, int32_t* out_dst, int64_t max_edges,
    int64_t* out_offsets) {
  std::vector<std::vector<int32_t>> srcs(num_seeds), dsts(num_seeds);

  // thread-local generation-stamped membership arrays: O(1) dedup with no
  // hashing (the per-hop user unions touch O(articles · item_degree) entries)
  parallel_seeds(
      num_seeds,
      [&]() { return tls_bfs_scratch(num_users); },
      [&](BfsScratch* sc, int64_t s) {
        Rng rng(rng_seed * 0x9e3779b97f4a7c15ULL +
                (uint64_t)s * 0xda942042e4dd58b5ULL);
        const int64_t gen = g_bfs_gen.fetch_add(1, std::memory_order_relaxed);
        bfs_seed(user_row_ptr, user_cols, item_row_ptr, item_cols,
                 seeds[s], n_hops, num_neighbors, gen, rng, *sc, srcs[s],
                 dsts[s]);
      });

  int64_t total = 0;
  out_offsets[0] = 0;
  for (int64_t s = 0; s < num_seeds; ++s) {
    const int64_t n = (int64_t)srcs[s].size();
    if (total + n > max_edges) return -1;
    std::memcpy(out_src + total, srcs[s].data(), n * sizeof(int32_t));
    std::memcpy(out_dst + total, dsts[s].data(), n * sizeof(int32_t));
    total += n;
    out_offsets[s + 1] = total;
  }
  return total;
}

// PinSAGE random-walk importance frontier.
//
// Per seed item: num_walks walks, each walk_length item→user→item
// traversals with restart probability; visit counts of reached items
// (excluding the seed) are ranked, top num_neighbors become the frontier
// with counts as weights — dgl.sampling.PinSAGESampler semantics.
//
// Outputs per seed i occupy slots [i*num_neighbors, (i+1)*num_neighbors);
// unused slots have weight 0.
void pinsage_frontier(
    const int64_t* user_row_ptr, const int32_t* user_cols,   // user→items
    const int64_t* item_row_ptr, const int32_t* item_cols,   // item→users
    const int32_t* seeds, int64_t num_seeds,
    int32_t walk_length, double restart_prob,
    int32_t num_walks, int32_t num_neighbors,
    uint64_t rng_seed,
    int32_t* out_src, float* out_w) {
  parallel_seeds(num_seeds, []() { return 0; }, [&](int, int64_t s) {
    Rng rng(rng_seed * 0xda942042e4dd58b5ULL + (uint64_t)s * 0x9e3779b97f4a7c15ULL);
    const int32_t seed_item = seeds[s];
    std::unordered_map<int32_t, int32_t> counts;
    for (int32_t w = 0; w < num_walks; ++w) {
      int32_t cur = seed_item;
      for (int32_t step = 0; step < walk_length; ++step) {
        // item → user
        const int64_t ulo = item_row_ptr[cur], uhi = item_row_ptr[cur + 1];
        if (uhi == ulo) break;
        const int32_t u = item_cols[ulo + (int64_t)rng.bounded((uint64_t)(uhi - ulo))];
        // user → item
        const int64_t ilo = user_row_ptr[u], ihi = user_row_ptr[u + 1];
        if (ihi == ilo) break;
        const int32_t it = user_cols[ilo + (int64_t)rng.bounded((uint64_t)(ihi - ilo))];
        counts[it] += 1;
        cur = (rng.uniform() < restart_prob) ? seed_item : it;
      }
    }
    counts.erase(seed_item);
    std::vector<std::pair<int32_t, int32_t>> top(counts.begin(), counts.end());
    std::sort(top.begin(), top.end(), [](const auto& a, const auto& b) {
      return a.second != b.second ? a.second > b.second : a.first < b.first;
    });
    const int64_t base = s * num_neighbors;
    for (int32_t j = 0; j < num_neighbors; ++j) {
      if ((size_t)j < top.size()) {
        out_src[base + j] = top[j].first;
        out_w[base + j] = (float)top[j].second;
      } else {
        out_src[base + j] = 0;
        out_w[base + j] = 0.0f;
      }
    }
  });
}

// One item→user→item metapath step for a batch of items (the tail draw of
// ItemToItemBatchSampler, pinsage/sampler.py:30-34). Dead ends → -1.
void walk_step(
    const int64_t* user_row_ptr, const int32_t* user_cols,
    const int64_t* item_row_ptr, const int32_t* item_cols,
    const int32_t* items, int64_t n, uint64_t rng_seed, int32_t* out) {
  Rng rng(rng_seed);
  for (int64_t i = 0; i < n; ++i) {
    out[i] = -1;
    const int32_t it = items[i];
    if (it < 0) continue;
    const int64_t ulo = item_row_ptr[it], uhi = item_row_ptr[it + 1];
    if (uhi == ulo) continue;
    const int32_t u = item_cols[ulo + (int64_t)rng.bounded((uint64_t)(uhi - ulo))];
    const int64_t ilo = user_row_ptr[u], ihi = user_row_ptr[u + 1];
    if (ihi == ilo) continue;
    out[i] = user_cols[ilo + (int64_t)rng.bounded((uint64_t)(ihi - ilo))];
  }
}

// Full padded TRAIN batch in one native call — BFS + positive/negative
// sampling + slot assignment + edge/label-grid fill (the whole
// SubgraphSampler.sample_batch fast path, data/sampler.py). Eval batches
// (Python matcher candidates) and the deterministic oracle mode stay in
// Python.
//
// Semantics mirror data/dataset.py through the Python sampler:
//   * positives: max(1, floor(deg·pos_ratio)) draws WITH replacement (:57-69)
//   * negatives: n_pos<=1 → k-1 draws; fast path uniform in [0, id_max)
//     when total_edges/num_neg > 100, else distinct draws excluding the
//     sampled positives (:190-230)
//   * node slots: ascending global id over the batch's touched nodes
//     (generation-stamped scratch + sort of the touched set only)
//   * per-user edge order: positive edges then hop edges
//
// Returns 0 on success; -1 when a node budget or the edge buffer would
// overflow (caller falls back to the Python truncating path).
int64_t assemble_train_batch(
    const int64_t* user_row_ptr, const int32_t* user_cols,
    const int64_t* item_row_ptr, const int32_t* item_cols,
    int64_t num_users, int64_t num_items,
    const int32_t* seeds, int64_t num_seeds,
    int32_t n_hops, int32_t num_neighbors,
    double pos_ratio, double neg_ratio, int32_t k,
    int32_t id_max, int64_t total_edges,
    uint64_t rng_seed,
    // EVAL mode: when cand_width > 0, negatives are the matcher candidates
    // XOR the user's positives (count-one semantics of data/dataset.py:
    // 93-106) instead of random draws. eval_cands is [num_seeds, cand_width]
    // with -1 pads; rows may contain duplicates (they are deduped here,
    // matching the Python path's np.unique over concatenated matchers).
    const int32_t* eval_cands, int64_t cand_width,
    int64_t num_user_slots, int64_t num_item_slots, int64_t num_edges,
    int64_t labels_per_user, int64_t gt_per_user,
    int32_t* user_ids, int32_t* item_ids,
    uint8_t* user_mask, uint8_t* item_mask,
    int32_t* edge_src, int32_t* edge_dst, uint8_t* edge_mask,
    int32_t* label_src, int32_t* label_dst, float* label,
    uint8_t* label_mask, int32_t* label_item_global,
    int32_t* gt_items, int32_t* gt_count,
    int32_t* seed_slots, int32_t* seeds_out,
    int32_t* uslot, int32_t* islot,        // persistent [num_users]/[num_items]
    int64_t* ustamp, int64_t* istamp,      // persistent generation stamps
    int64_t gen,                           // this call's generation (unique)
    int64_t* stats /* [label_truncations] */) {
  // --- per-seed sampling (parallel) -------------------------------------
  std::vector<std::vector<int32_t>> hsrcs(num_seeds), hdsts(num_seeds);
  std::vector<std::vector<int32_t>> pos_draws(num_seeds), negs(num_seeds);

  parallel_seeds(
      num_seeds,
      [&]() { return tls_bfs_scratch(num_users); },
      [&](BfsScratch* scp, int64_t s) {
      BfsScratch& sc = *scp;
      Rng rng(rng_seed * 0x9e3779b97f4a7c15ULL +
              (uint64_t)s * 0xda942042e4dd58b5ULL);
      const int64_t bfs_gen = g_bfs_gen.fetch_add(1, std::memory_order_relaxed);
      bfs_seed(user_row_ptr, user_cols, item_row_ptr, item_cols,
               seeds[s], n_hops, num_neighbors, bfs_gen, rng, sc,
               hsrcs[s], hdsts[s]);
      const int32_t u = seeds[s];
      const int64_t lo = user_row_ptr[u];
      const int64_t deg = user_row_ptr[u + 1] - lo;
      const int64_t cut =
          deg > 0 ? std::max<int64_t>(1, (int64_t)(deg * pos_ratio)) : 0;
      for (int64_t i = 0; i < cut; ++i)
        pos_draws[s].push_back((int32_t)rng.bounded((uint64_t)deg));
      if (cand_width > 0) {
        // eval: sorted unique candidates, then count-one vs positives
        std::vector<int32_t> cv;
        cv.reserve(cand_width);
        const int32_t* crow = eval_cands + s * cand_width;
        for (int64_t j = 0; j < cand_width; ++j)
          if (crow[j] >= 0) cv.push_back(crow[j]);
        std::sort(cv.begin(), cv.end());
        cv.erase(std::unique(cv.begin(), cv.end()), cv.end());
        std::vector<int32_t> merged(cv);
        for (int64_t e = 0; e < deg; ++e) merged.push_back(user_cols[lo + e]);
        std::sort(merged.begin(), merged.end());
        for (size_t j = 0; j < merged.size();) {
          size_t j2 = j;
          while (j2 < merged.size() && merged[j2] == merged[j]) ++j2;
          if (j2 - j == 1) negs[s].push_back(merged[j]);
          j = j2;
        }
        return;  // no random negatives in eval mode
      }
      const int64_t n_pos = cut;
      const int64_t num_neg =
          n_pos <= 1 ? (int64_t)(k - 1)
                     : (int64_t)(neg_ratio * (double)n_pos);
      if (num_neg > 0) {
        const int64_t bound = std::max<int64_t>(id_max, 1);
        // float division to match the Python selector exactly
        // (total_edges/num_neg in (100,101) must take the fast path too)
        if ((double)total_edges / (double)num_neg > 100.0) {
          for (int64_t i = 0; i < num_neg; ++i)
            negs[s].push_back((int32_t)rng.bounded((uint64_t)bound));
        } else {
          // distinct draws excluding the sampled positives (the Python
          // path's setdiff+shuffle, expressed as rejection draws)
          std::unordered_set<int32_t> excl;
          for (int32_t d : pos_draws[s]) excl.insert(user_cols[lo + d]);
          std::unordered_set<int32_t> chosen;
          const int64_t want =
              std::min<int64_t>(num_neg, (int64_t)(id_max + 1));
          int64_t attempts = 0, cap = 20 * want + 64;
          while ((int64_t)chosen.size() < want && attempts++ < cap) {
            int32_t c = (int32_t)rng.bounded((uint64_t)(id_max + 1));
            if (excl.count(c) || chosen.count(c)) continue;
            chosen.insert(c);
            negs[s].push_back(c);
          }
        }
      }
      });

  // --- slot assignment (serial): ascending-global-id slots ----------------
  // Generation-stamped persistent buffers (caller-owned): no per-call
  // O(num_users + num_items) allocation/zeroing/scan — cost is
  // O(touched · log touched), which is what the batch actually touches.
  std::vector<int32_t> u_touch, i_touch;
  u_touch.reserve(256);
  i_touch.reserve(1024);
  auto mark_u = [&](int32_t u) {
    if (ustamp[u] != gen) { ustamp[u] = gen; u_touch.push_back(u); }
  };
  auto mark_i = [&](int32_t a) {
    if (istamp[a] != gen) { istamp[a] = gen; i_touch.push_back(a); }
  };
  for (int64_t s = 0; s < num_seeds; ++s) {
    mark_u(seeds[s]);
    for (int32_t u : hsrcs[s]) mark_u(u);
    const int32_t u = seeds[s];
    for (int64_t e = user_row_ptr[u]; e < user_row_ptr[u + 1]; ++e)
      mark_i(user_cols[e]);
    for (int32_t a : negs[s]) mark_i(a);
    for (int32_t a : hdsts[s]) mark_i(a);
  }
  const int64_t nu = (int64_t)u_touch.size();
  const int64_t ni = (int64_t)i_touch.size();
  if (nu > num_user_slots || ni > num_item_slots) return -1;
  std::sort(u_touch.begin(), u_touch.end());
  std::sort(i_touch.begin(), i_touch.end());
  for (int64_t r = 0; r < nu; ++r) {
    uslot[u_touch[r]] = (int32_t)r;
    user_ids[r] = u_touch[r];
  }
  for (int64_t r = 0; r < ni; ++r) {
    islot[i_touch[r]] = (int32_t)r;
    item_ids[r] = i_touch[r];
  }
  for (int64_t i = nu; i < num_user_slots; ++i) user_ids[i] = 0;
  for (int64_t i = ni; i < num_item_slots; ++i) item_ids[i] = 0;
  for (int64_t i = 0; i < num_user_slots; ++i) user_mask[i] = i < nu;
  for (int64_t i = 0; i < num_item_slots; ++i) item_mask[i] = i < ni;

  // --- edges + label grid -------------------------------------------------
  std::memset(label, 0, sizeof(float) * num_seeds * labels_per_user);
  std::memset(label_mask, 0, num_seeds * labels_per_user);
  std::memset(label_src, 0, sizeof(int32_t) * num_seeds * labels_per_user);
  std::memset(label_dst, 0, sizeof(int32_t) * num_seeds * labels_per_user);
  std::memset(label_item_global, 0,
              sizeof(int32_t) * num_seeds * labels_per_user);
  int64_t label_trunc = 0;
  int64_t e_n = 0;
  for (int64_t s = 0; s < num_seeds; ++s) {
    const int32_t u = seeds[s];
    const int32_t us = uslot[u];
    seeds_out[s] = u;
    seed_slots[s] = us;
    const int64_t lo = user_row_ptr[u];
    const int64_t deg = user_row_ptr[u + 1] - lo;
    // positive edges, then hop edges (Python fast-path order)
    if (e_n + deg + (int64_t)hsrcs[s].size() > num_edges) return -1;
    for (int64_t e = 0; e < deg; ++e) {
      edge_src[e_n] = us;
      edge_dst[e_n] = islot[user_cols[lo + e]];
      ++e_n;
    }
    for (size_t j = 0; j < hsrcs[s].size(); ++j) {
      edge_src[e_n] = uslot[hsrcs[s][j]];
      edge_dst[e_n] = islot[hdsts[s][j]];
      ++e_n;
    }
    // label grid row
    const int64_t n_pos = (int64_t)pos_draws[s].size();
    const int64_t n_neg = (int64_t)negs[s].size();
    const int64_t total = n_pos + n_neg;
    const int64_t c = std::min<int64_t>(total, labels_per_user);
    if (total > labels_per_user) label_trunc += total - labels_per_user;
    float* lrow = label + s * labels_per_user;
    uint8_t* mrow = label_mask + s * labels_per_user;
    int32_t* srow = label_src + s * labels_per_user;
    int32_t* drow = label_dst + s * labels_per_user;
    int32_t* grow = label_item_global + s * labels_per_user;
    for (int64_t j = 0; j < c; ++j) {
      const int32_t item =
          j < n_pos ? user_cols[lo + pos_draws[s][j]] : negs[s][j - n_pos];
      lrow[j] = j < n_pos ? 1.0f : 0.0f;
      mrow[j] = 1;
      srow[j] = us;
      drow[j] = islot[item];
      grow[j] = item;
    }
    // ground truth = the user's positives (caps at gt_per_user)
    const int64_t g = std::min<int64_t>(deg, gt_per_user);
    for (int64_t j = 0; j < g; ++j) gt_items[s * gt_per_user + j] =
        user_cols[lo + j];
    for (int64_t j = g; j < gt_per_user; ++j)
      gt_items[s * gt_per_user + j] = -1;
    gt_count[s] = (int32_t)g;
  }
  for (int64_t e = 0; e < num_edges; ++e) edge_mask[e] = e < e_n;
  for (int64_t e = e_n; e < num_edges; ++e) {
    edge_src[e] = 0;
    edge_dst[e] = 0;
  }
  stats[0] = label_trunc;
  return 0;
}

// Batched UsersWithCommonItemsMatcher (reference data/matching/
// users_with_common_purchases.py:8-26): for each user, walk its articles in
// CSR order, each article's co-purchasers in CSR order, each co-purchaser's
// items in CSR order, collecting until k — the exact traversal order of the
// Python matcher (concat-then-[:k] semantics with early break). One OpenMP
// task per user; out is [num_seeds, k] padded with -1.
void common_items_matches(
    const int64_t* user_row_ptr, const int32_t* user_cols,
    const int64_t* item_row_ptr, const int32_t* item_cols,
    const int32_t* users, int64_t num_seeds, int32_t k,
    int32_t* out) {
  parallel_seeds(num_seeds, []() { return 0; }, [&](int, int64_t s) {
    int32_t* row = out + s * k;
    int32_t n = 0;
    const int32_t u = users[s];
    for (int64_t a = user_row_ptr[u]; a < user_row_ptr[u + 1] && n < k; ++a) {
      const int32_t art = user_cols[a];
      for (int64_t p = item_row_ptr[art];
           p < item_row_ptr[art + 1] && n < k; ++p) {
        const int32_t peer = item_cols[p];
        for (int64_t i = user_row_ptr[peer];
             i < user_row_ptr[peer + 1] && n < k; ++i) {
          row[n++] = user_cols[i];
        }
      }
    }
    for (; n < k; ++n) row[n] = -1;
  });
}

}  // extern "C"
