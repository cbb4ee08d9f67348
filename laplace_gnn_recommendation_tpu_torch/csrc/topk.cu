// Streaming maximum-inner-product top-k over an int8 catalog — kernel C.
//
// Kernel C replaces the Pallas kernels `_kernel_int8` and
// `_kernel_int8_masked` of laplace_gnn_recommendation_tpu/ops/topk_pallas.py
// (`streaming_mips_topk_int8`): one kernel with a nullable exclusion-mask
// pointer. The f32 kernel (B) has its own source, topk_f32.cu; the template
// below keeps the f32 branches of its first design unchanged, and only its
// int8 instantiation is built.
//
// Semantics kept from the Pallas fold (`_fold_topk`): the result is the k
// best items by (score descending, item id ascending); a slot that no item
// fills holds (NEG_INF = -FLT_MAX, id 0); an excluded item scores NEG_INF and
// so never displaces an unfilled slot. The int8 score is
// (float(qu·qi) * su) * si, the same two roundings as the plain version, so
// int8 scores and ids are bitwise equal to it.
//
// What bounds it on an H100: at serving shapes (B=256 users, ~105k items,
// D=32) the [B, I] scores are 2·B·I·D operations against I·D catalog bytes
// (plus B·I mask bytes) — the work is arithmetic, and the k-best fold (one
// compare per score, rare inserts) rides on the same cores. The [B, I]
// score matrix never reaches device memory.
//
// Design: blocks run in parallel in no order, so the catalog is cut into
// `num_splits` contiguous ranges (grid.y) and users into groups of 8
// (grid.x, one warp per user). A block stages an item tile in shared memory
// (rows padded by one word against bank conflicts), each warp scores 32
// items at a time (one per lane) against its user and offers the scores
// that beat its running k-th best to a sorted list kept in shared memory.
// A second kernel merges each user's per-split lists in split order.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -FLT_MAX;  // numpy's finfo(float32).min
constexpr int kTileBytes = 32 * 1024;

// Insert (v, id) into a warp's list sorted by value descending; entries of
// equal value stay ahead of it (they were offered first, with lower ids).
// The caller guarantees v > lv[k-1].
__device__ void list_insert(float* lv, int32_t* li, int k, float v, int32_t id, int lane) {
  int pos = 0;
  for (int base = 0; base < k; base += 32) {
    const int p = base + lane;
    pos += __popc(__ballot_sync(kFull, p < k && lv[p] >= v));
  }
  for (int top = k - 1; top > pos; top -= 32) {
    const int p = top - lane;
    const bool act = p > pos;
    float tv = 0.f;
    int32_t ti = 0;
    if (act) {
      tv = lv[p - 1];
      ti = li[p - 1];
    }
    __syncwarp();
    if (act) {
      lv[p] = tv;
      li[p] = ti;
    }
    __syncwarp();
  }
  if (lane == 0) {
    lv[pos] = v;
    li[pos] = id;
  }
  __syncwarp();
}

// Offer one score per lane (lanes in ascending id order); `thr` is the
// list's current k-th value, kept equal on every lane.
__device__ void offer(float* lv, int32_t* li, int k, float& thr, float s, int32_t id,
                      bool valid, int lane) {
  unsigned mask = __ballot_sync(kFull, valid && s > thr);
  while (mask) {
    const int src = __ffs(mask) - 1;
    const float v = __shfl_sync(kFull, s, src);
    const int32_t vid = __shfl_sync(kFull, id, src);
    list_insert(lv, li, k, v, vid, lane);
    thr = lv[k - 1];
    mask = __ballot_sync(kFull, valid && s > thr) & ~((2u << src) - 1u);
  }
}

__host__ __device__ int words_of(int d) { return (d + 3) / 4; }

// Rows of an item tile that fit kTileBytes (a multiple of 32, at least 32).
int tile_rows(int row_bytes) {
  int t = (kTileBytes / row_bytes) / 32 * 32;
  if (t < 32) t = 32;
  if (t > 1024) t = 1024;
  return t;
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads) topk_partial_kernel(
    const float* __restrict__ users_f, const int8_t* __restrict__ users_q,
    const float* __restrict__ su, const float* __restrict__ items_f,
    const int8_t* __restrict__ items_q, const float* __restrict__ si,
    const int8_t* __restrict__ mask, int64_t b_total, int64_t i_total, int d, int k,
    int64_t split_len, int tile, float* __restrict__ part_v, int32_t* __restrict__ part_i) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dw = words_of(d);
  const int ustride = kInt8 ? dw : d;         // words per staged user
  const int tstride = (kInt8 ? dw : d) + 1;   // words per staged item row
  float* lists_v = smem;
  int32_t* lists_i = reinterpret_cast<int32_t*>(lists_v + kWarps * k);
  float* ubuf = reinterpret_cast<float*>(lists_i + kWarps * k);
  float* tbuf = ubuf + kWarps * ustride;
  float* lv = lists_v + warp * k;
  int32_t* li = lists_i + warp * k;

  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kWarps;
  const int64_t b = b0 + warp;
  const int64_t split = blockIdx.y;
  const int64_t num_splits = gridDim.y;
  const int64_t lo = split * split_len;
  const int64_t hi = lo + split_len < i_total ? lo + split_len : i_total;

  for (int idx = threadIdx.x; idx < kWarps * k; idx += kThreads) {
    lists_v[idx] = kNegInf;
    lists_i[idx] = 0;
  }
  for (int idx = threadIdx.x; idx < kWarps * ustride; idx += kThreads) {
    const int w = idx / ustride, c = idx % ustride;
    const int64_t bu = b0 + w;
    if (kInt8) {
      uint32_t word = 0;
      for (int j = 0; j < 4; ++j) {
        const int col = c * 4 + j;
        const uint8_t byte = (bu < b_total && col < d)
            ? static_cast<uint8_t>(users_q[bu * d + col]) : 0;
        word |= static_cast<uint32_t>(byte) << (8 * j);
      }
      reinterpret_cast<uint32_t*>(ubuf)[idx] = word;
    } else {
      ubuf[idx] = bu < b_total ? users_f[bu * d + c] : 0.f;
    }
  }
  const float su_b = (kInt8 && b < b_total) ? su[b] : 0.f;
  float thr = kNegInf;
  __syncthreads();

  for (int64_t t0 = lo; t0 < hi; t0 += tile) {
    const int n = hi - t0 < tile ? static_cast<int>(hi - t0) : tile;
    __syncthreads();  // the previous tile is no longer read
    const int row_words = kInt8 ? dw : d;
    for (int idx = threadIdx.x; idx < n * row_words; idx += kThreads) {
      const int j = idx / row_words, c = idx % row_words;
      if (kInt8) {
        uint32_t word = 0;
        for (int q = 0; q < 4; ++q) {
          const int col = c * 4 + q;
          const uint8_t byte = col < d ? static_cast<uint8_t>(items_q[(t0 + j) * d + col]) : 0;
          word |= static_cast<uint32_t>(byte) << (8 * q);
        }
        reinterpret_cast<uint32_t*>(tbuf)[j * tstride + c] = word;
      } else {
        tbuf[j * tstride + c] = items_f[(t0 + j) * d + c];
      }
    }
    __syncthreads();
    if (b < b_total) {  // uniform across the warp
      for (int c0 = 0; c0 < n; c0 += 32) {
        const int j = c0 + lane;
        const bool valid = j < n;
        float s = kNegInf;
        if (valid) {
          if (kInt8) {
            const int* uq = reinterpret_cast<const int*>(ubuf) + warp * ustride;
            const int* iq = reinterpret_cast<const int*>(tbuf) + j * tstride;
            int raw = 0;
            for (int c = 0; c < dw; ++c) raw = __dp4a(uq[c], iq[c], raw);
            s = (static_cast<float>(raw) * su_b) * si[t0 + j];
          } else {
            const float* u = ubuf + warp * ustride;
            const float* it = tbuf + j * tstride;
            float acc = 0.f;
            for (int c = 0; c < d; ++c) acc = fmaf(u[c], it[c], acc);
            s = acc;
          }
          if (mask != nullptr && mask[b * i_total + t0 + j] != 0) s = kNegInf;
        }
        offer(lv, li, k, thr, s, static_cast<int32_t>(t0 + j), valid, lane);
      }
    }
  }
  if (b < b_total) {
    const int64_t base = (b * num_splits + split) * k;
    for (int p = lane; p < k; p += 32) {
      part_v[base + p] = lv[p];
      part_i[base + p] = li[p];
    }
  }
}

__global__ void __launch_bounds__(kThreads) topk_merge_kernel(
    const float* __restrict__ part_v, const int32_t* __restrict__ part_i,
    int64_t b_total, int64_t num_splits, int k, float* __restrict__ out_v,
    int32_t* __restrict__ out_i) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= b_total) return;  // no block-wide barrier below
  float* lv = smem + warp * k;
  int32_t* li = reinterpret_cast<int32_t*>(smem + kWarps * k) + warp * k;
  for (int p = lane; p < k; p += 32) {
    lv[p] = kNegInf;
    li[p] = 0;
  }
  __syncwarp();
  float thr = kNegInf;
  // splits in catalog order, each list in rank order: among equal scores
  // the candidates arrive in ascending id order, as the fold requires
  const int64_t total = num_splits * k;
  const float* pv = part_v + b * total;
  const int32_t* pi = part_i + b * total;
  for (int64_t c0 = 0; c0 < total; c0 += 32) {
    const int64_t idx = c0 + lane;
    const bool valid = idx < total;
    const float v = valid ? pv[idx] : kNegInf;
    const int32_t id = valid ? pi[idx] : 0;
    offer(lv, li, k, thr, v, id, valid, lane);
  }
  for (int p = lane; p < k; p += 32) {
    out_v[b * k + p] = lv[p];
    out_i[b * k + p] = li[p];
  }
}

template <bool kInt8>
int launch(const float* users_f, const int8_t* users_q, const float* su,
           const float* items_f, const int8_t* items_q, const float* si,
           const int8_t* mask, int64_t b_total, int64_t i_total, int64_t d, int64_t k,
           int64_t num_splits, int64_t split_len, float* part_v, int32_t* part_i,
           float* out_v, int32_t* out_i, cudaStream_t st) {
  if (b_total == 0) return 0;
  const int dd = static_cast<int>(d);
  const int ustride = kInt8 ? words_of(dd) : dd;
  const int tstride = ustride + 1;
  const int tile = tile_rows(tstride * 4);
  const size_t smem = sizeof(float) * (2 * kWarps * k + kWarps * ustride) +
                      sizeof(float) * static_cast<size_t>(tile) * tstride;
  auto kern = topk_partial_kernel<kInt8>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((b_total + kWarps - 1) / kWarps),
                  static_cast<unsigned>(num_splits));
  kern<<<grid, kThreads, smem, st>>>(users_f, users_q, su, items_f, items_q, si, mask,
                                     b_total, i_total, dd, static_cast<int>(k),
                                     split_len, tile, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t msmem = sizeof(float) * 2 * kWarps * k;
  topk_merge_kernel<<<static_cast<unsigned>((b_total + kWarps - 1) / kWarps), kThreads,
                      msmem, st>>>(part_v, part_i, b_total, num_splits,
                                   static_cast<int>(k), out_v, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int topk_int8_launch(const void* qu, const void* su, const void* q_items,
                                const void* item_scales, const void* mask, int64_t b,
                                int64_t i, int64_t d, int64_t k, int64_t num_splits,
                                int64_t split_len, void* part_v, void* part_i, void* out_v,
                                void* out_i, void* stream) {
  return launch<true>(nullptr, static_cast<const int8_t*>(qu), static_cast<const float*>(su),
                      nullptr, static_cast<const int8_t*>(q_items),
                      static_cast<const float*>(item_scales), static_cast<const int8_t*>(mask),
                      b, i, d, k, num_splits, split_len, static_cast<float*>(part_v),
                      static_cast<int32_t*>(part_i), static_cast<float*>(out_v),
                      static_cast<int32_t*>(out_i), static_cast<cudaStream_t>(stream));
}

// Shared-memory bytes the partial kernel needs, so the wrapper can refuse a
// width the card cannot stage.
extern "C" int64_t topk_smem_bytes(int64_t d, int64_t k, int64_t is_int8) {
  const int dd = static_cast<int>(d);
  const int ustride = is_int8 ? words_of(dd) : dd;
  const int tstride = ustride + 1;
  return static_cast<int64_t>(sizeof(float)) *
         (2 * kWarps * k + kWarps * ustride + static_cast<int64_t>(tile_rows(tstride * 4)) * tstride);
}
