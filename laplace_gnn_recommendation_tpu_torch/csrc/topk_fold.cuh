// The k-best fold shared by the streaming top-k kernels B (topk_f32.cu) and
// C (topk.cu): staging helpers, per-user candidate buffers merged into sorted
// lists by register bitonic merges, and the pass that merges each user's
// per-split lists.
//
// Order: every comparison uses the total order (value descending, item id
// ascending), so the result does not depend on the order in which
// candidates arrive. Unfilled slots hold (NEG_INF = -FLT_MAX, id 0).
//
// Layout a scoring kernel shares with this file: a block of kThreads
// threads holds kUsers users; warp w owns users 8·w .. 8·w+7, thread
// (ty = 2·w + half, tx = lane % 16) scores users 4·ty .. 4·ty+3 against items
// tx + 16·j (j < 8) of a 128-item run. User u's list lives in shared memory
// at lv/li[u·L .. u·L + K) with L = K + kBuf, its candidate buffer right
// after it, and cnt[u] counts the buffer's entries.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUsers = 64;    // users per block: 8 per warp, 4 per thread
constexpr int kBuf = 64;      // candidate buffer entries per user
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

// Every list of the block empty, every buffer count 0. The caller syncs.
__device__ __forceinline__ void init_lists(float* lv, int32_t* li, int* cnt, int L) {
  for (int idx = threadIdx.x; idx < kUsers * L; idx += kThreads) {
    lv[idx] = kNegInf;
    li[idx] = 0;
  }
  if (threadIdx.x < kUsers) cnt[threadIdx.x] = 0;
}

// User i of this thread (block user ub = 4·ty + i): offers its candidates,
// bit j of `pend` standing for score sc[j] of item t0 + tx + 16·j, one at a
// time; a shared counter gives each its slot in the user's buffer, and a
// buffer that fills is merged at once, after which the lanes that found it
// full offer again. (thr_v, thr_i) is the user's k-th entry, kept current.
// Warp-collective.
__device__ __forceinline__ void offer_user(float* lv, int32_t* li, int* cnt, int K, int L,
                                           int k, int i, int warp, int lane, int tx,
                                           int64_t t0, const float (&sc)[8], uint32_t pend,
                                           float& thr_v, int32_t& thr_i) {
  const int ub = 4 * (2 * warp + (lane >> 4)) + i;
  while (__any_sync(kFull, pend != 0)) {
    bool over = false;
    if (pend != 0) {
      const int j = __ffs(pend) - 1;
      const int pos = atomicAdd(cnt + ub, 1);
      over = pos >= kBuf;
      if (!over) {
        lv[ub * L + K + pos] = pick(sc, j);
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
    thr_v = lv[ub * L + k - 1];
    thr_i = li[ub * L + k - 1];
  }
}

// Merges what is left in this warp's 8 buffers and writes the warp's users'
// lists for this split to part_v/part_i [B, num_splits, k].
__device__ __forceinline__ void write_lists(float* lv, int32_t* li, const int* cnt, int K,
                                            int L, int k, int warp, int lane, int64_t b0,
                                            int64_t b_total, int64_t split, int64_t num_splits,
                                            float* __restrict__ part_v,
                                            int32_t* __restrict__ part_i) {
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

// Merges each user's num_splits lists of k entries into its k best; one
// warp a user.
__global__ void __launch_bounds__(kThreads) topk_merge_kernel(
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

cudaError_t launch_merge(const float* part_v, const int32_t* part_i, int64_t b,
                         int64_t num_splits, int64_t k, float* out_v, int32_t* out_i,
                         cudaStream_t st) {
  const size_t msmem = (sizeof(float) + sizeof(int32_t)) * kWarps *
                       static_cast<size_t>(list_len(static_cast<int>(k)) + kBuf);
  topk_merge_kernel<<<static_cast<unsigned>((b + kWarps - 1) / kWarps), kThreads, msmem, st>>>(
      part_v, part_i, b, num_splits, static_cast<int>(k), out_v, out_i);
  return cudaGetLastError();
}

// The catalog split for a scoring kernel that takes `smem` bytes a block:
// enough blocks to fill every SM at the occupancy it reaches, each split at
// least `min_split` items and a whole number of `tile`-item tiles (but the
// last). Writes {num_splits, split_len} to `out`.
template <typename Kernel>
int plan_splits(Kernel kern, size_t smem, int64_t b, int64_t i, int64_t tile,
                int64_t min_split, int64_t* out) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t groups = b > 0 ? (b + kUsers - 1) / kUsers : 1;
  int64_t s = (static_cast<int64_t>(per_sm) * sms + groups - 1) / groups;
  const int64_t most = (i + min_split - 1) / min_split;
  if (s > most) s = most;
  if (s > 65535) s = 65535;
  if (s < 1) s = 1;
  int64_t len = (i + s - 1) / s;
  len = (len + tile - 1) / tile * tile;  // whole tiles, but the last
  out[0] = i > 0 ? (i + len - 1) / len : 1;
  out[1] = len > 0 ? len : tile;
  return 0;
}

}  // namespace
