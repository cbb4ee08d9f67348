// Streaming maximum-inner-product top-k in f32 — kernel B of the port.
//
// Replaces the Pallas kernels `_kernel` and `_kernel_masked` of
// laplace_gnn_recommendation_tpu/ops/topk_pallas.py (`streaming_mips_topk`,
// `streaming_mips_topk_masked`): one kernel with a nullable int8 exclusion
// mask.
//
// Semantics kept from the Pallas fold (`_fold_topk`): the result is the k
// best items by the total order (score descending, item id ascending); a
// slot that no item fills holds (NEG_INF = -FLT_MAX, id 0); an excluded item
// is never a candidate, so it never displaces an unfilled slot. Every
// comparison below uses that total order, so the result does not depend on
// the order in which candidates arrive.
//
// What bounds it on an H100: the [B, I] scores are 2·B·I·D f32 operations
// against (B + I)·D·4 bytes of embeddings plus B·I mask bytes; at the main
// path's shape (B=512, I=270,336, D=32) the operations bound it. The score
// matrix never reaches device memory.
//
// Design:
// * Scoring: a block takes 64 users (kept in shared memory) and one
//   contiguous range of the catalog (a split; blocks run in parallel in no
//   order). Item tiles of 128 rows stream through shared memory with
//   cp.async, double-buffered, so the next tile loads while this one is
//   scored. Thread (ty, tx) of the 16×16 block scores users 4·ty..4·ty+3
//   against items tx + 16·j (j < 8): a 4×8 register micro-tile, built from
//   16-byte shared loads (4 dims of one row each), 128 FMAs for every 12
//   loads. Rows are padded by 4 floats, so the 8 rows a quarter-warp reads
//   fall in distinct banks. Where the mask rows are 16-byte aligned, the
//   mask tile streams in beside the item tile the same way; otherwise it is
//   read straight from device memory.
// * Fold: a half-warp holds all scores of 4 users, so a warp owns 8 users'
//   lists outright and folds without block barriers. A score that beats its
//   user's current k-th entry goes into that user's 64-entry candidate
//   buffer in shared memory; each lane offers its candidates one at a time
//   and takes its slot from a shared counter (an integer atomic), so a tile
//   with no candidate costs one vote per user row. A full buffer is merged
//   at once into the user's sorted list of K = max(32, 2^⌈log2 k⌉) entries,
//   all in registers: a 64-wide bitonic sort of the buffer, then the top K
//   of list ∪ buffer by one bitonic merge (C[i] = max(L[i], B[K-1-i])). The
//   merges are called, not inlined, so the unrolled fold stays small enough
//   for the instruction cache. The order in which candidates reach a buffer
//   varies from run to run; the result does not, as every comparison uses
//   the total order and no candidate that belongs in the top k is dropped.
// * A second kernel merges each user's per-split lists the same way.
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUsers = 64;    // users per block: 8 per warp, 4 per thread
constexpr int kTile = 128;    // items per staged tile: 8 per thread
constexpr int kBuf = 64;      // candidate buffer entries per user
constexpr int kMinSplit = 4 * kTile;
constexpr float kNegInf = -FLT_MAX;   // numpy's finfo(float32).min
constexpr int32_t kPadId = INT32_MAX; // pads the buffer; below every real entry and fill

__device__ __forceinline__ bool better(float av, int32_t ai, float bv, int32_t bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Merges the first `cnt` buffer entries (lv/li[K .. K + cnt)) into the sorted
// list lv/li[0 .. K), K = 32 · kPer; while it runs, entry e of the list (and
// of the buffer) is held by lane e % 32 in register e / 32. Warp-collective.
// Not inlined: the fold calls it from several unrolled sites, and inlined
// copies would crowd the instruction cache.
template <int kPer>
__device__ __noinline__ void merge_list(float* lv, int32_t* li, int cnt, int lane) {
  constexpr int K = 32 * kPer;
  __syncwarp();
  float bv[2];
  int32_t bi[2];
  float v[kPer];
  int32_t id[kPer];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int e = 32 * r + lane;
    bv[r] = e < cnt ? lv[K + e] : kNegInf;
    bi[r] = e < cnt ? li[K + e] : kPadId;
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    v[r] = lv[32 * r + lane];
    id[r] = li[32 * r + lane];
  }
  // bitonic sort of the 64 buffer entries, best first
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {   // size 64: registers 0 and 1 of one lane
        if (better(bv[1], bi[1], bv[0], bi[0])) {
          const float tv = bv[0];
          const int32_t ti = bi[0];
          bv[0] = bv[1];
          bi[0] = bi[1];
          bv[1] = tv;
          bi[1] = ti;
        }
        continue;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int e = 32 * r + lane;
        const float ov = __shfl_xor_sync(kFull, bv[r], stride);
        const int32_t oi = __shfl_xor_sync(kFull, bi[r], stride);
        const bool best_here = ((e & stride) == 0) == ((e & size) == 0);
        if (best_here ? better(ov, oi, bv[r], bi[r]) : better(bv[r], bi[r], ov, oi)) {
          bv[r] = ov;
          bi[r] = oi;
        }
      }
    }
  }
  // C[i] = max(L[i], B[K-1-i]) holds the top K of both and is bitonic (only
  // the buffer's best K take part)
#pragma unroll
  for (int rr = 0; rr < (kPer < 2 ? kPer : 2); ++rr) {
    const int r = kPer - 1 - rr;   // list register; its partner is buffer register rr
    const float rv = __shfl_sync(kFull, bv[rr], 31 - lane);
    const int32_t ri = __shfl_sync(kFull, bi[rr], 31 - lane);
    if (better(rv, ri, v[r], id[r])) {
      v[r] = rv;
      id[r] = ri;
    }
  }
  // bitonic merge, best first: strides of 32 and more pair registers of a
  // lane, smaller strides pair lanes
#pragma unroll
  for (int m = kPer / 2; m > 0; m >>= 1) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if ((r & m) == 0 && better(v[r + m], id[r + m], v[r], id[r])) {
        const float tv = v[r];
        const int32_t ti = id[r];
        v[r] = v[r + m];
        id[r] = id[r + m];
        v[r + m] = tv;
        id[r + m] = ti;
      }
    }
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const bool lower = (lane & stride) == 0;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const float ov = __shfl_xor_sync(kFull, v[r], stride);
      const int32_t oi = __shfl_xor_sync(kFull, id[r], stride);
      if (lower ? better(ov, oi, v[r], id[r]) : better(v[r], id[r], ov, oi)) {
        v[r] = ov;
        id[r] = oi;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    lv[32 * r + lane] = v[r];
    li[32 * r + lane] = id[r];
  }
  __syncwarp();
}

__device__ void merge_buffer(float* lv, int32_t* li, int K, int cnt, int lane) {
  switch (K) {
    case 32: merge_list<1>(lv, li, cnt, lane); break;
    case 64: merge_list<2>(lv, li, cnt, lane); break;
    case 128: merge_list<4>(lv, li, cnt, lane); break;
    default: merge_list<8>(lv, li, cnt, lane); break;
  }
}

// One of a thread's 8 scores, picked without indexing registers at run time.
__device__ __forceinline__ float pick(const float (&a)[8], int j) {
  float v = a[0];
#pragma unroll
  for (int q = 1; q < 8; ++q) v = j == q ? a[q] : v;
  return v;
}

__host__ __device__ int list_len(int k) {
  int K = 32;
  while (K < k) K <<= 1;
  return K;
}

size_t partial_smem_bytes(int d, int k) {
  const int stride = d + 4;
  return sizeof(float) * (static_cast<size_t>(kUsers + 2 * kTile) * stride) +
         (sizeof(float) + sizeof(int32_t)) * static_cast<size_t>(kUsers) * (list_len(k) + kBuf) +
         sizeof(int32_t) * kUsers + 2 * kUsers * kTile;   // buffer counts, mask tiles
}

__global__ void __launch_bounds__(kThreads, 2) topk_f32_partial_kernel(
    const float* __restrict__ users, const float* __restrict__ items,
    const int8_t* __restrict__ mask, int64_t b_total, int64_t i_total, int d, int k,
    int64_t split_len, float* __restrict__ part_v, int32_t* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  const int K = list_len(k);
  const int L = K + kBuf;
  const int stride = d + 4, d4 = d / 4;
  float* us = reinterpret_cast<float*>(smem4);
  float* ts = us + kUsers * stride;
  float* lv = ts + 2 * kTile * stride;
  int32_t* li = reinterpret_cast<int32_t*>(lv + kUsers * L);
  int* cnt = li + kUsers * L;                               // buffer entries per user
  int8_t* ms = reinterpret_cast<int8_t*>(cnt + kUsers);     // two mask tiles [kUsers][kTile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 15, half = lane >> 4, ty = 2 * warp + half;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kUsers;
  const int64_t split = blockIdx.y, num_splits = gridDim.y;
  const int64_t lo = split * split_len;
  const int64_t hi = lo + split_len < i_total ? lo + split_len : i_total;
  const int ntiles = hi > lo ? static_cast<int>((hi - lo + kTile - 1) / kTile) : 0;
  // mask rows 16-byte aligned: the mask tile streams in beside the item tile
  const bool mask_async = mask != nullptr && i_total % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(mask) % 16 == 0;

  auto stage = [&](int t) {
    const int64_t t0 = lo + static_cast<int64_t>(t) * kTile;
    float* dst = ts + (t & 1) * kTile * stride;
    for (int idx = threadIdx.x; idx < kTile * d4; idx += kThreads) {
      const int r = idx / d4, c = idx % d4;
      const bool ok = t0 + r < hi;
      cp_async16(dst + r * stride + 4 * c, ok ? items + (t0 + r) * d + 4 * c : items, ok ? 16 : 0);
    }
    if (mask_async) {
      int8_t* mdst = ms + (t & 1) * kUsers * kTile;
      for (int idx = threadIdx.x; idx < kUsers * kTile / 16; idx += kThreads) {
        const int u = idx / (kTile / 16), c = idx % (kTile / 16);
        const int64_t from = t0 + 16 * c;
        const int64_t left = b0 + u < b_total ? hi - from : 0;
        const int bytes = left < 0 ? 0 : left > 16 ? 16 : static_cast<int>(left);
        cp_async16(mdst + u * kTile + 16 * c, bytes ? mask + (b0 + u) * i_total + from : mask,
                   bytes);
      }
    }
    cp_async_commit();
  };
  if (ntiles > 0) stage(0);

  for (int idx = threadIdx.x; idx < kUsers * d4; idx += kThreads) {
    const int u = idx / d4, c = idx % d4;
    const float4 v = b0 + u < b_total
        ? *reinterpret_cast<const float4*>(users + (b0 + u) * d + 4 * c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(us + u * stride + 4 * c) = v;
  }
  for (int idx = threadIdx.x; idx < kUsers * L; idx += kThreads) {
    lv[idx] = kNegInf;
    li[idx] = 0;
  }
  if (threadIdx.x < kUsers) cnt[threadIdx.x] = 0;
  __syncthreads();
  float thr_v[4];
  int32_t thr_i[4];
  bool user_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    thr_v[i] = kNegInf;
    thr_i[i] = 0;
    user_ok[i] = b0 + 4 * ty + i < b_total;
  }
  const float* urow = us + 4 * ty * stride;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int64_t t0 = lo + static_cast<int64_t>(t) * kTile;
    const int n = hi - t0 < kTile ? static_cast<int>(hi - t0) : kTile;
    // eligibility bits (bit 8·i + j): a real item, a real user, not excluded
    uint32_t ok_bits = 0;
    const int8_t* mtile = ms + (t & 1) * kUsers * kTile + 4 * ty * kTile;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int8_t* mrow = mask_async ? mtile + i * kTile
          : mask != nullptr && user_ok[i] ? mask + (b0 + 4 * ty + i) * i_total + t0 : nullptr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int item = tx + 16 * j;
        const bool ok = user_ok[i] && item < n && (mrow == nullptr || mrow[item] == 0);
        ok_bits |= static_cast<uint32_t>(ok) << (8 * i + j);
      }
    }
    const float* tb = ts + (t & 1) * kTile * stride + tx * stride;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int c = 0; c < d4; ++c) {
      float4 x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = *reinterpret_cast<const float4*>(tb + 16 * j * stride + 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 u = *reinterpret_cast<const float4*>(urow + i * stride + 4 * c);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(u.x, x[j].x, acc[i][j]);
          acc[i][j] = fmaf(u.y, x[j].y, acc[i][j]);
          acc[i][j] = fmaf(u.z, x[j].z, acc[i][j]);
          acc[i][j] = fmaf(u.w, x[j].w, acc[i][j]);
        }
      }
    }
    // fold: each lane offers its candidates one at a time; a shared counter
    // gives each its slot in the user's buffer, and a buffer that fills is
    // merged at once, after which the lanes that found it full offer again
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ub = 4 * ty + i;
      uint32_t pend = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int32_t id = static_cast<int32_t>(t0 + tx + 16 * j);
        const bool c = ((ok_bits >> (8 * i + j)) & 1u) && better(acc[i][j], id, thr_v[i], thr_i[i]);
        pend |= static_cast<uint32_t>(c) << j;
      }
      while (__any_sync(kFull, pend != 0)) {
        bool over = false;
        if (pend != 0) {
          const int j = __ffs(pend) - 1;
          const int pos = atomicAdd(cnt + ub, 1);
          over = pos >= kBuf;
          if (!over) {
            lv[ub * L + K + pos] = pick(acc[i], j);
            li[ub * L + K + pos] = static_cast<int32_t>(t0 + tx + 16 * j);
            pend &= pend - 1;
          }
        }
        const unsigned full = __ballot_sync(kFull, over);
        if (full == 0) continue;  // uniform
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if ((full >> (16 * h)) & 0xffffu) {
            const int u = 4 * (2 * warp + h) + i;
            merge_buffer(lv + u * L, li + u * L, K, kBuf, lane);
            if (lane == 0) cnt[u] = 0;
          }
        }
        __syncwarp();
        thr_v[i] = lv[ub * L + k - 1];
        thr_i[i] = li[ub * L + k - 1];
      }
    }
    __syncthreads();  // this tile's buffers are staged again two tiles on
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = 4 * (2 * warp + h) + i;
      const int c = cnt[u];
      if (c > 0) merge_buffer(lv + u * L, li + u * L, K, c, lane);
    }
  __syncwarp();
  for (int u = 8 * warp; u < 8 * warp + 8; ++u) {
    if (b0 + u < b_total) {
      const int64_t out = ((b0 + u) * num_splits + split) * k;
      for (int p = lane; p < k; p += 32) {
        part_v[out + p] = lv[u * L + p];
        part_i[out + p] = li[u * L + p];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) topk_f32_merge_kernel(
    const float* __restrict__ part_v, const int32_t* __restrict__ part_i, int64_t b_total,
    int64_t num_splits, int k, float* __restrict__ out_v, int32_t* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  const int K = list_len(k);
  const int L = K + kBuf;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= b_total) return;  // no block-wide barrier below
  float* lv = reinterpret_cast<float*>(smem4) + warp * L;
  int32_t* li = reinterpret_cast<int32_t*>(reinterpret_cast<float*>(smem4) + kWarps * L) + warp * L;
  for (int p = lane; p < K; p += 32) {
    lv[p] = kNegInf;
    li[p] = 0;
  }
  __syncwarp();
  float thr_v = kNegInf;
  int32_t thr_i = 0;
  int cnt = 0;
  const int64_t total = num_splits * k;
  const float* pv = part_v + b * total;
  const int32_t* pi = part_i + b * total;
  for (int64_t c0 = 0; c0 < total; c0 += 32) {
    const int64_t idx = c0 + lane;
    const float v = idx < total ? pv[idx] : kNegInf;
    const int32_t id = idx < total ? pi[idx] : 0;
    const bool c = idx < total && better(v, id, thr_v, thr_i);
    const unsigned bal = __ballot_sync(kFull, c);
    if (bal == 0) continue;  // uniform
    const int add = __popc(bal);
    if (cnt + add > kBuf) {
      merge_buffer(lv, li, K, cnt, lane);
      cnt = 0;
      thr_v = lv[k - 1];
      thr_i = li[k - 1];
    }
    if (c) {
      const int pos = cnt + __popc(bal & ((1u << lane) - 1u));
      lv[K + pos] = v;
      li[K + pos] = id;
    }
    cnt += add;
    __syncwarp();
  }
  if (cnt > 0) merge_buffer(lv, li, K, cnt, lane);
  for (int p = lane; p < k; p += 32) {
    out_v[b * k + p] = lv[p];
    out_i[b * k + p] = li[p];
  }
}

}  // namespace

// Shared-memory bytes a block of the scoring kernel needs at (d, k).
extern "C" int64_t topk_f32_smem_bytes(int64_t d, int64_t k) {
  return static_cast<int64_t>(partial_smem_bytes(static_cast<int>(d), static_cast<int>(k)));
}

// The catalog split for (b, i, d, k): enough blocks to fill every SM at the
// occupancy the scoring kernel reaches, each split at least kMinSplit items.
// Writes {num_splits, split_len} to `plan`.
extern "C" int topk_f32_plan(int64_t b, int64_t i, int64_t d, int64_t k, void* plan) {
  const size_t smem = partial_smem_bytes(static_cast<int>(d), static_cast<int>(k));
  cudaError_t err = cudaFuncSetAttribute(
      topk_f32_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, topk_f32_partial_kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t groups = b > 0 ? (b + kUsers - 1) / kUsers : 1;
  int64_t s = (static_cast<int64_t>(per_sm) * sms + groups - 1) / groups;
  const int64_t most = (i + kMinSplit - 1) / kMinSplit;
  if (s > most) s = most;
  if (s > 65535) s = 65535;
  if (s < 1) s = 1;
  int64_t len = (i + s - 1) / s;
  len = (len + kTile - 1) / kTile * kTile;  // whole tiles, but the last
  int64_t* out = static_cast<int64_t*>(plan);
  out[0] = i > 0 ? (i + len - 1) / len : 1;
  out[1] = len > 0 ? len : kTile;
  return 0;
}

extern "C" int topk_f32_launch(const void* users, const void* items, const void* mask,
                               int64_t b, int64_t i, int64_t d, int64_t k, int64_t num_splits,
                               int64_t split_len, void* part_v, void* part_i, void* out_v,
                               void* out_i, void* stream) {
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 != 0 || reinterpret_cast<uintptr_t>(users) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(items) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = partial_smem_bytes(static_cast<int>(d), static_cast<int>(k));
  cudaError_t err = cudaFuncSetAttribute(
      topk_f32_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((b + kUsers - 1) / kUsers),
                  static_cast<unsigned>(num_splits));
  topk_f32_partial_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(users), static_cast<const float*>(items),
      static_cast<const int8_t*>(mask), b, i, static_cast<int>(d), static_cast<int>(k),
      split_len, static_cast<float*>(part_v), static_cast<int32_t*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t msmem = (sizeof(float) + sizeof(int32_t)) * kWarps *
                       static_cast<size_t>(list_len(static_cast<int>(k)) + kBuf);
  topk_f32_merge_kernel<<<static_cast<unsigned>((b + kWarps - 1) / kWarps), kThreads, msmem,
                          st>>>(static_cast<const float*>(part_v),
                                static_cast<const int32_t*>(part_i), b, num_splits,
                                static_cast<int>(k), static_cast<float*>(out_v),
                                static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
