// Standalone sanitizer driver for the port's native sampler library (the
// port's copy of the JAX package's native/sanitize_check.cpp).
//
// Compiled together with sampler.cpp under -fsanitize=address,undefined or
// -fsanitize=thread (see native.run_sanitizer_check) and run as a
// subprocess from tests/test_torch_native_sanitize.py. A standalone binary
// — not an LD_PRELOADed Python extension — so the sanitizer runtimes
// initialize cleanly and the OpenMP fan-outs run under TSAN exactly as they
// do in production (shared generation-stamped scratch included).
//
// Exercises every exported entry point on a random bipartite graph:
//   nhop_sample (parallel BFS, buffer-overflow retry path included),
//   assemble_train_batch (parallel batch assembly, repeated calls so the
//     generation-stamp scratch reuse crosses calls),
//   pinsage_frontier (parallel random-walk importance sampling),
//   walk_step.
// Exit code 0 = clean; the sanitizer aborts with nonzero otherwise.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

extern "C" {
int64_t nhop_sample(
    const int64_t*, const int32_t*, const int64_t*, const int32_t*,
    int64_t, int64_t, const int32_t*, int64_t, int32_t, int32_t, uint64_t,
    int32_t*, int32_t*, int64_t, int64_t*);
int64_t assemble_train_batch(
    const int64_t*, const int32_t*, const int64_t*, const int32_t*,
    int64_t, int64_t, const int32_t*, int64_t, int32_t, int32_t,
    double, double, int32_t, int32_t, int64_t, uint64_t,
    const int32_t*, int64_t,
    int64_t, int64_t, int64_t, int64_t, int64_t,
    int32_t*, int32_t*, uint8_t*, uint8_t*,
    int32_t*, int32_t*, uint8_t*,
    int32_t*, int32_t*, float*, uint8_t*, int32_t*,
    int32_t*, int32_t*, int32_t*, int32_t*,
    int32_t*, int32_t*, int64_t*, int64_t*, int64_t, int64_t*);
void common_items_matches(
    const int64_t*, const int32_t*, const int64_t*, const int32_t*,
    const int32_t*, int64_t, int32_t, int32_t*);
void pinsage_frontier(
    const int64_t*, const int32_t*, const int64_t*, const int32_t*,
    const int32_t*, int64_t, int32_t, double, int32_t, int32_t, uint64_t,
    int32_t*, float*);
void walk_step(
    const int64_t*, const int32_t*, const int64_t*, const int32_t*,
    const int32_t*, int64_t, uint64_t, int32_t*);
}

struct Csr {
  std::vector<int64_t> row_ptr;
  std::vector<int32_t> cols;
};

static Csr build_csr(const std::vector<int32_t>& src,
                     const std::vector<int32_t>& dst, int64_t rows) {
  Csr c;
  c.row_ptr.assign(rows + 1, 0);
  for (int32_t s : src) c.row_ptr[s + 1]++;
  for (int64_t r = 0; r < rows; ++r) c.row_ptr[r + 1] += c.row_ptr[r];
  c.cols.resize(src.size());
  std::vector<int64_t> fill(c.row_ptr.begin(), c.row_ptr.end() - 1);
  for (size_t e = 0; e < src.size(); ++e) c.cols[fill[src[e]]++] = dst[e];
  return c;
}

int main() {
  const int64_t num_users = 600, num_items = 400;
  const int64_t avg_deg = 12;
  std::mt19937_64 rng(7);
  std::vector<int32_t> eu, ei;
  for (int64_t u = 0; u < num_users; ++u) {
    int64_t d = 1 + (int64_t)(rng() % (2 * avg_deg));
    for (int64_t j = 0; j < d; ++j) {
      eu.push_back((int32_t)u);
      ei.push_back((int32_t)(rng() % num_items));
    }
  }
  Csr ucsr = build_csr(eu, ei, num_users);
  Csr icsr = build_csr(ei, eu, num_items);
  const int64_t total_edges = (int64_t)eu.size();

  const int64_t b = 48;
  std::vector<int32_t> seeds(b);
  for (int64_t i = 0; i < b; ++i) seeds[i] = (int32_t)(rng() % num_users);

  // --- nhop_sample, including the too-small-buffer retry path ---
  for (int64_t cap : {64L, 1L << 18}) {
    std::vector<int32_t> src(cap), dst(cap);
    std::vector<int64_t> off(b + 1, 0);
    int64_t total = nhop_sample(
        ucsr.row_ptr.data(), ucsr.cols.data(), icsr.row_ptr.data(),
        icsr.cols.data(), num_users, num_items, seeds.data(), b, 3, 16,
        12345, src.data(), dst.data(), cap, off.data());
    if (cap > 64 && total < 0) { std::fprintf(stderr, "bfs overflow\n"); return 2; }
  }

  // --- assemble_train_batch, repeated (generation-stamp scratch reuse) ---
  const int64_t nus = 2048, nis = 2048, ne = 1 << 15, lpu = 64, gpu = 32;
  std::vector<int32_t> user_ids(nus), item_ids(nis), edge_src(ne), edge_dst(ne);
  std::vector<uint8_t> user_mask(nus), item_mask(nis), edge_mask(ne);
  std::vector<int32_t> label_src(b * lpu), label_dst(b * lpu),
      label_item(b * lpu), gt_items(b * gpu), gt_count(b), seed_slots(b),
      seeds_out(b);
  std::vector<float> label(b * lpu);
  std::vector<uint8_t> label_mask(b * lpu);
  std::vector<int32_t> uslot(num_users), islot(num_items);
  std::vector<int64_t> ustamp(num_users, 0), istamp(num_items, 0);
  int64_t stats[1];
  // eval-candidate matrix from the batched matcher (exercised below too)
  const int32_t ck = 16;
  std::vector<int32_t> cands(b * ck);
  common_items_matches(ucsr.row_ptr.data(), ucsr.cols.data(),
                       icsr.row_ptr.data(), icsr.cols.data(), seeds.data(),
                       b, ck, cands.data());
  for (int64_t gen = 1; gen <= 5; ++gen) {
    const bool eval_mode = (gen % 2) == 0;  // alternate train/eval paths
    int64_t rc = assemble_train_batch(
        ucsr.row_ptr.data(), ucsr.cols.data(), icsr.row_ptr.data(),
        icsr.cols.data(), num_users, num_items, seeds.data(), b, 3, 16,
        0.5, 3.0, 12, (int32_t)(num_items - 1), total_edges, 999 + gen,
        eval_mode ? cands.data() : nullptr, eval_mode ? ck : 0,
        nus, nis, ne, lpu, gpu,
        user_ids.data(), item_ids.data(), user_mask.data(), item_mask.data(),
        edge_src.data(), edge_dst.data(), edge_mask.data(),
        label_src.data(), label_dst.data(), label.data(), label_mask.data(),
        label_item.data(), gt_items.data(), gt_count.data(),
        seed_slots.data(), seeds_out.data(),
        uslot.data(), islot.data(), ustamp.data(), istamp.data(), gen, stats);
    if (rc != 0) { std::fprintf(stderr, "assemble rc=%lld\n", (long long)rc); return 3; }
  }

  // --- rejection-sampled frontier path (kExactFrontierScanCap crossing) ---
  // a hub item connected to every user pushes a hop's occurrence total far
  // past 32768, exercising the occurrence-rejection branch of bfs_seed
  {
    const int64_t nu2 = 60000, ni2 = 64;
    std::vector<int32_t> eu2, ei2;
    for (int64_t u = 0; u < nu2; ++u) {
      eu2.push_back((int32_t)u);
      ei2.push_back(0);  // the hub
      eu2.push_back((int32_t)u);
      ei2.push_back((int32_t)(1 + rng() % (ni2 - 1)));
    }
    Csr u2 = build_csr(eu2, ei2, nu2);
    Csr i2 = build_csr(ei2, eu2, ni2);
    std::vector<int32_t> seeds2(b);
    for (int64_t i = 0; i < b; ++i) seeds2[i] = (int32_t)(rng() % nu2);
    const int64_t cap2 = 1 << 18;
    std::vector<int32_t> src2(cap2), dst2(cap2);
    std::vector<int64_t> off2(b + 1, 0);
    int64_t total2 = nhop_sample(
        u2.row_ptr.data(), u2.cols.data(), i2.row_ptr.data(), i2.cols.data(),
        nu2, ni2, seeds2.data(), b, 3, 16, 2024,
        src2.data(), dst2.data(), cap2, off2.data());
    if (total2 < 0) { std::fprintf(stderr, "hub bfs overflow\n"); return 4; }
    std::vector<int32_t> uslot2(nu2), islot2(ni2);
    std::vector<int64_t> ustamp2(nu2, 0), istamp2(ni2, 0);
    std::vector<int32_t> user_ids2(4096), item_ids2(ni2);
    std::vector<uint8_t> user_mask2(4096), item_mask2(ni2);
    int64_t rc2 = assemble_train_batch(
        u2.row_ptr.data(), u2.cols.data(), i2.row_ptr.data(), i2.cols.data(),
        nu2, ni2, seeds2.data(), b, 2, 16,
        0.5, 3.0, 12, (int32_t)(ni2 - 1), (int64_t)eu2.size(), 4242,
        nullptr, 0,
        4096, ni2, ne, lpu, gpu,
        user_ids2.data(), item_ids2.data(), user_mask2.data(),
        item_mask2.data(),
        edge_src.data(), edge_dst.data(), edge_mask.data(),
        label_src.data(), label_dst.data(), label.data(), label_mask.data(),
        label_item.data(), gt_items.data(), gt_count.data(),
        seed_slots.data(), seeds_out.data(),
        uslot2.data(), islot2.data(), ustamp2.data(), istamp2.data(), 99,
        stats);
    if (rc2 != 0) { std::fprintf(stderr, "hub assemble rc=%lld\n", (long long)rc2); return 5; }
  }

  // --- pinsage_frontier + walk_step ---
  std::vector<int32_t> items(b);
  for (int64_t i = 0; i < b; ++i) items[i] = (int32_t)(rng() % num_items);
  const int32_t nn = 8;
  std::vector<int32_t> f_src(b * nn);
  std::vector<float> f_w(b * nn);
  pinsage_frontier(ucsr.row_ptr.data(), ucsr.cols.data(), icsr.row_ptr.data(),
                   icsr.cols.data(), items.data(), b, 2, 0.5, 10, nn, 77,
                   f_src.data(), f_w.data());
  std::vector<int32_t> stepped(b);
  walk_step(ucsr.row_ptr.data(), ucsr.cols.data(), icsr.row_ptr.data(),
            icsr.cols.data(), items.data(), b, 42, stepped.data());

  std::printf("sanitize_check ok\n");
  return 0;
}
