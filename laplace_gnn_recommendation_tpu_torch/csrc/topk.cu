// Streaming maximum-inner-product top-k over an int8 catalog — kernel C.
//
// Replaces the Pallas kernels `_kernel_int8` and `_kernel_int8_masked` of
// laplace_gnn_recommendation_tpu/ops/topk_pallas.py
// (`streaming_mips_topk_int8`): one kernel with a nullable int8 exclusion
// mask.
//
// Semantics kept from the Pallas fold (`_fold_topk`): the result is the k
// best items by (score descending, item id ascending); a slot that no item
// fills holds (NEG_INF = -FLT_MAX, id 0); an excluded item is never a
// candidate, so it never displaces an unfilled slot. The score is
// (float(qu·qi) * su) * si: the integer dot product is exact whatever
// instruction forms it, and the two f32 roundings are the plain version's,
// so values and ids are bitwise equal to it.
//
// What bounds it on an H100: bytes. The function reads I·D catalog bytes,
// I scales and, with a mask, B·I mask bytes; at the main path's shape
// (B=256, I=106,496, D=32) the mask is 27.3 MB of the 31.2 MB (~9 µs at
// 3.35 TB/s), while the 2·B·I·D integer operations would take under 2 µs at
// the int8 peak. The [B, I] score matrix never reaches device memory; the
// mask streams in once, beside the item tiles, and each score costs a few
// instructions unless it is a candidate.
//
// Design (kernel B's, topk_f32.cu, with an integer front end):
// * Scoring: a block takes 64 users, their int8 rows zero-padded to
//   D16 = ⌈D/16⌉·16 bytes in shared memory (zero bytes add nothing to an
//   integer dot), and one contiguous range of the catalog (a split). Item
//   tiles of kTile = 128 rows, as in kernel B, stream through shared memory
//   with cp.async, double-buffered, the tile's scales and mask tile beside
//   them.
//   A staged row is D16 bytes padded to an odd number of 16-byte units, so
//   the 8 rows a quarter-warp reads fall in distinct banks. Thread (ty, tx)
//   scores users 4·ty..4·ty+3 against items tx + 16·j (j < 8) of each
//   128-item run: for every 16 bytes of depth, 8 item and 4 user 16-byte
//   shared loads feed 128 __dp4a. Each thread keeps its 4 user scales in
//   registers. Where D % 16 != 0 or the catalog is not 16-byte aligned, rows
//   are staged by plain word (or byte) loads into the same layout; where the
//   mask rows are not 16-byte aligned (I % 16 != 0), the mask is read
//   straight from device memory.
// * Candidates: a score at or above its user's k-th value (one compare)
//   goes on to the exact test, the total order and then the mask byte, so
//   the mask bytes in shared memory are read for candidates alone; a warp
//   whose run holds none skips the rest. The fold, not the scoring, sets
//   the time: every split starts with empty lists, and its first runs offer
//   nearly every score. For k ≤ 16 a run whose candidates crowd a lane is
//   first cut to the k-th best of its 16 lane bests, which also becomes the
//   user's threshold (exact: k eligible items lie at or above it).
// * Fold and merge: kernel B's own (topk_fold.cuh): per-user 64-entry
//   candidate buffers with slots from a shared counter, merged into sorted
//   lists of K = max(32, 2^⌈log2 k⌉) entries by register bitonic merges; a
//   second kernel merges each user's per-split lists.
#include "topk_fold.cuh"

namespace {

constexpr int kRun = 128;             // items scored at once: 8 per thread
constexpr int kTile = 128;            // item rows per staged tile
constexpr int kMinSplit = 4 * kRun;

__host__ __device__ int depth16(int d) { return (d + 15) / 16 * 16; }

// Bytes per staged row: D16 rounded up to an odd number of 16-byte units.
__host__ __device__ int row_stride(int d) { return 16 * ((depth16(d) / 16) | 1); }

constexpr int kBoundK = 16;   // k up to which a run's bound is taken

// The run bound, for k ≤ kBoundK: drops the pending candidates (bit j of
// `pend`: score sc[j] of item t0 + tx + 16·j) that cannot reach the top k
// and returns the bound τ in (tv, ti). Among the 16 lane bests of the
// half-warp's candidates, the k-th best τ has at least k eligible items at
// or above it, so an item below τ, in this run or a later one, has k better
// items. Warp-collective; each half-warp bounds its own user.
__device__ __forceinline__ uint32_t run_bound(const float (&sc)[8], uint32_t pend, int64_t t0,
                                              int tx, int k, float& tv, int32_t& ti) {
  float v = kNegInf;
  int32_t vi = kPadId;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int32_t id = static_cast<int32_t>(t0 + tx + 16 * j);
    if (((pend >> j) & 1u) && better(sc[j], id, v, vi)) {
      v = sc[j];
      vi = id;
    }
  }
  // bitonic sort of the 16 lane bests, best first
#pragma unroll
  for (int size = 2; size <= 16; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, stride);
      const int32_t oi = __shfl_xor_sync(kFull, vi, stride);
      const bool best_here = ((tx & stride) == 0) == ((tx & size) == 0);
      if (best_here ? better(ov, oi, v, vi) : better(v, vi, ov, oi)) {
        v = ov;
        vi = oi;
      }
    }
  }
  tv = __shfl_sync(kFull, v, k - 1, 16);
  ti = __shfl_sync(kFull, vi, k - 1, 16);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (better(tv, ti, sc[j], static_cast<int32_t>(t0 + tx + 16 * j))) pend &= ~(1u << j);
  }
  return pend;
}

size_t partial_smem_bytes(int d, int k) {
  const size_t rs = row_stride(d);
  return rs * (kUsers + 2 * kTile) +                               // user rows, two item tiles
         sizeof(float) * 2 * kTile + 2 * kUsers * kTile +          // scales, masks
         (sizeof(float) + sizeof(int32_t)) * static_cast<size_t>(kUsers) * (list_len(k) + kBuf) +
         sizeof(int32_t) * kUsers;                                 // buffer counts
}

__global__ void __launch_bounds__(kThreads, 2) topk_int8_partial_kernel(
    const int8_t* __restrict__ qu, const float* __restrict__ su,
    const int8_t* __restrict__ items, const float* __restrict__ si,
    const int8_t* __restrict__ mask, int64_t b_total, int64_t i_total, int d, int k,
    int64_t split_len, float* __restrict__ part_v, int32_t* __restrict__ part_i) {
  extern __shared__ int4 smem16[];
  const int K = list_len(k);
  const int L = K + kBuf;
  const int rs = row_stride(d), c16 = depth16(d) / 16, w16 = 4 * c16;
  int8_t* us = reinterpret_cast<int8_t*>(smem16);
  int8_t* ts = us + kUsers * rs;                                   // two item tiles
  float* ss = reinterpret_cast<float*>(ts + 2 * kTile * rs);       // two scale tiles
  int8_t* ms = reinterpret_cast<int8_t*>(ss + 2 * kTile);          // two mask tiles [kUsers][kTile]
  float* lv = reinterpret_cast<float*>(ms + 2 * kUsers * kTile);
  int32_t* li = reinterpret_cast<int32_t*>(lv + kUsers * L);
  int* cnt = li + kUsers * L;                                      // buffer entries per user

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = lane & 15, ty = 2 * warp + (lane >> 4);
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kUsers;
  const int64_t split = blockIdx.y, num_splits = gridDim.y;
  const int64_t lo = split * split_len;
  const int64_t hi = lo + split_len < i_total ? lo + split_len : i_total;
  const int ntiles = hi > lo ? static_cast<int>((hi - lo + kTile - 1) / kTile) : 0;
  const bool items_async = d % 16 == 0 && reinterpret_cast<uintptr_t>(items) % 16 == 0;
  const bool item_words = d % 4 == 0 && reinterpret_cast<uintptr_t>(items) % 4 == 0;
  const bool scales_async = reinterpret_cast<uintptr_t>(si) % 16 == 0;
  const bool mask_async = mask != nullptr && i_total % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(mask) % 16 == 0;

  auto stage = [&](int t) {
    const int64_t t0 = lo + static_cast<int64_t>(t) * kTile;
    int8_t* dst = ts + (t & 1) * kTile * rs;
    if (items_async) {
      for (int idx = threadIdx.x; idx < kTile * c16; idx += kThreads) {
        const int r = idx / c16, c = idx % c16;
        const bool ok = t0 + r < hi;
        cp_async16(dst + r * rs + 16 * c, ok ? items + (t0 + r) * d + 16 * c : items, ok ? 16 : 0);
      }
    } else {   // plain loads into the same layout, zero past D and past the split
      for (int idx = threadIdx.x; idx < kTile * w16; idx += kThreads) {
        const int r = idx / w16, w = idx % w16;
        uint32_t word = 0;
        if (t0 + r < hi && 4 * w < d) {
          const int8_t* src = items + (t0 + r) * d + 4 * w;
          if (item_words) {
            word = *reinterpret_cast<const uint32_t*>(src);
          } else {
            for (int q = 0; q < 4 && 4 * w + q < d; ++q)
              word |= static_cast<uint32_t>(static_cast<uint8_t>(src[q])) << (8 * q);
          }
        }
        *reinterpret_cast<uint32_t*>(dst + r * rs + 4 * w) = word;
      }
    }
    float* sdst = ss + (t & 1) * kTile;
    if (scales_async) {
      for (int idx = threadIdx.x; idx < kTile / 4; idx += kThreads) {
        const int64_t from = t0 + 4 * idx;
        const int64_t left = hi - from;
        const int bytes = left <= 0 ? 0 : left >= 4 ? 16 : 4 * static_cast<int>(left);
        cp_async16(sdst + 4 * idx, bytes ? si + from : si, bytes);
      }
    } else {
      for (int idx = threadIdx.x; idx < kTile; idx += kThreads)
        sdst[idx] = t0 + idx < hi ? si[t0 + idx] : 0.f;
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

  for (int idx = threadIdx.x; idx < kUsers * w16; idx += kThreads) {
    const int u = idx / w16, w = idx % w16;
    uint32_t word = 0;
    if (b0 + u < b_total) {
      const int8_t* src = qu + (b0 + u) * d + 4 * w;
      for (int q = 0; q < 4 && 4 * w + q < d; ++q)
        word |= static_cast<uint32_t>(static_cast<uint8_t>(src[q])) << (8 * q);
    }
    *reinterpret_cast<uint32_t*>(us + u * rs + 4 * w) = word;
  }
  init_lists(lv, li, cnt, L);
  __syncthreads();
  float thr_v[4], su_r[4];
  int32_t thr_i[4];
  uint32_t user_bits = 0;   // bit 8·i + j: user i of this thread is real
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool real = b0 + 4 * ty + i < b_total;
    thr_v[i] = kNegInf;
    thr_i[i] = 0;
    su_r[i] = real ? su[b0 + 4 * ty + i] : 0.f;
    user_bits |= real ? 0xffu << (8 * i) : 0u;
  }
  const int8_t* urow = us + 4 * ty * rs;

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
    const int8_t* tile = ts + (t & 1) * kTile * rs;
    const float* stile = ss + (t & 1) * kTile;
    const int8_t* mtile = ms + (t & 1) * kUsers * kTile + 4 * ty * kTile;
#pragma unroll 1
    for (int r0 = 0; r0 < n; r0 += kRun) {   // n is the same for the whole block
      int acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0;
      const int8_t* tb = tile + (r0 + tx) * rs;
      for (int c = 0; c < c16; ++c) {
        int4 x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          x[j] = *reinterpret_cast<const int4*>(tb + 16 * j * rs + 16 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int4 u = *reinterpret_cast<const int4*>(urow + i * rs + 16 * c);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = __dp4a(u.x, x[j].x, acc[i][j]);
            acc[i][j] = __dp4a(u.y, x[j].y, acc[i][j]);
            acc[i][j] = __dp4a(u.z, x[j].z, acc[i][j]);
            acc[i][j] = __dp4a(u.w, x[j].w, acc[i][j]);
          }
        }
      }
      // dequantize; a score at or above its user's k-th value goes on to the
      // exact test (the total order, not excluded) and the fold
      // (topk_fold.cuh). Most runs have no such score.
      const int64_t t0r = t0 + r0;
      uint32_t ok = user_bits;
      if (r0 + kRun > n) {   // the split's last, short run
        uint32_t items_in = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) items_in |= static_cast<uint32_t>(r0 + tx + 16 * j < n) << j;
        ok &= items_in * 0x01010101u;
      }
      float sj[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) sj[j] = stile[r0 + tx + 16 * j];
      float sc[4][8];
      uint32_t pend = 0;   // bit 8·i + j
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[i][j] = (static_cast<float>(acc[i][j]) * su_r[i]) * sj[j];
          pend |= static_cast<uint32_t>(sc[i][j] >= thr_v[i]) << (8 * i + j);
        }
      pend &= ok;
      if (!__any_sync(kFull, pend != 0)) continue;   // uniform across the warp
      // the exact test: the total order against the k-th entry, then the
      // mask byte of each survivor
      uint32_t keep = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          keep |= static_cast<uint32_t>(better(sc[i][j], static_cast<int32_t>(t0r + tx + 16 * j),
                                               thr_v[i], thr_i[i])) << (8 * i + j);
      keep &= pend;
      if (mask != nullptr) {
        for (uint32_t rest = keep; rest != 0; rest &= rest - 1) {
          const int q = __ffs(rest) - 1, i = q >> 3, item = r0 + tx + 16 * (q & 7);
          const int8_t m = mask_async ? mtile[i * kTile + item]
                                      : mask[(b0 + 4 * ty + i) * i_total + t0 + item];
          if (m != 0) keep &= ~(1u << q);
        }
      }
      // per user with candidates: where a lane holds more than 2 of them (a
      // split's first runs) and k ≤ kBoundK, the run bound cuts them first;
      // then the fold
      uint32_t crowded = 0;   // bit i: this lane holds more than 2 of user i's
#pragma unroll
      for (int i = 0; i < 4; ++i)
        crowded |= static_cast<uint32_t>(__popc((keep >> (8 * i)) & 0xffu) > 2) << i;
      const uint32_t any = __reduce_or_sync(kFull, keep);
      const uint32_t many = __reduce_or_sync(kFull, crowded);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (((any >> (8 * i)) & 0xffu) == 0) continue;   // uniform across the warp
        uint32_t pu = (keep >> (8 * i)) & 0xffu;
        float tv = kNegInf;
        int32_t ti = kPadId;
        if (k <= kBoundK && ((many >> i) & 1u)) pu = run_bound(sc[i], pu, t0r, tx, k, tv, ti);
        offer_user(lv, li, cnt, K, L, k, i, warp, lane, tx, t0r, sc[i], pu, thr_v[i], thr_i[i]);
        if (better(tv, ti, thr_v[i], thr_i[i])) {   // the run bound, where tighter
          thr_v[i] = tv;
          thr_i[i] = ti;
        }
      }
    }
    __syncthreads();  // this tile's buffers are staged again two tiles on
  }
  write_lists(lv, li, cnt, K, L, k, warp, lane, b0, b_total, split, num_splits, part_v, part_i);
}

}  // namespace

// Shared-memory bytes a block of the scoring kernel needs at (d, k), so the
// wrapper can refuse what the card cannot stage.
extern "C" int64_t topk_smem_bytes(int64_t d, int64_t k) {
  return static_cast<int64_t>(partial_smem_bytes(static_cast<int>(d), static_cast<int>(k)));
}

// The catalog split for (b, i, d, k): enough blocks to fill every SM at the
// occupancy the scoring kernel reaches, each split at least kMinSplit items.
// Writes {num_splits, split_len} to `plan`.
extern "C" int topk_int8_plan(int64_t b, int64_t i, int64_t d, int64_t k, void* plan) {
  return plan_splits(topk_int8_partial_kernel,
                     partial_smem_bytes(static_cast<int>(d), static_cast<int>(k)), b, i, kTile,
                     kMinSplit, static_cast<int64_t*>(plan));
}

extern "C" int topk_int8_launch(const void* qu, const void* su, const void* q_items,
                                const void* item_scales, const void* mask, int64_t b,
                                int64_t i, int64_t d, int64_t k, int64_t num_splits,
                                int64_t split_len, void* part_v, void* part_i, void* out_v,
                                void* out_i, void* stream) {
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = partial_smem_bytes(static_cast<int>(d), static_cast<int>(k));
  cudaError_t err = cudaFuncSetAttribute(topk_int8_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((b + kUsers - 1) / kUsers),
                  static_cast<unsigned>(num_splits));
  topk_int8_partial_kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const int8_t*>(qu), static_cast<const float*>(su),
      static_cast<const int8_t*>(q_items), static_cast<const float*>(item_scales),
      static_cast<const int8_t*>(mask), b, i, static_cast<int>(d), static_cast<int>(k), split_len,
      static_cast<float*>(part_v), static_cast<int32_t*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge(static_cast<const float*>(part_v),
                                       static_cast<const int32_t*>(part_i), b, num_splits, k,
                                       static_cast<float*>(out_v), static_cast<int32_t*>(out_i),
                                       st));
}
