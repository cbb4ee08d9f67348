// Streaming maximum-inner-product top-k in f32 — kernel B of the port.
//
// Replaces the Pallas kernels `_kernel` and `_kernel_masked` of
// laplace_gnn_recommendation_tpu/ops/topk_pallas.py (`streaming_mips_topk`,
// `streaming_mips_topk_masked`): one kernel with a nullable int8 exclusion
// mask. A second instantiation takes exclusion lists instead of a mask
// (`topk_f32_lists_launch`; the port's single-device f32 retrieval server).
//
// Semantics kept from the Pallas fold (`_fold_topk`): the result is the k
// best items by the total order (score descending, item id ascending); a
// slot that no item fills holds (NEG_INF = -FLT_MAX, id 0); an item the mask
// excludes is never a candidate, so it never displaces an unfilled slot.
// An item the lists exclude is a candidate that scores `fill` (the
// materializing path's EXCLUDE_FILL), so an over-excluded row answers its
// excluded items at `fill`, lowest ids first, as that path ranks them. Every
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
//   read straight from device memory. Where two tiles of whole rows do not
//   fit the block's shared memory (wide rows: D > 124 at k = 12), a tile
//   is staged in column chunks of 64, 32, ... floats (`chunk_cols`), one
//   chunk a pipeline step, and the 4×8 sums carry over its chunks; the
//   users are always staged whole.
// * Exclusion lists (the list instantiation): user b's excluded ids are the
//   first count[b] entries of row b of an int32 [B, X] table, in ascending
//   order. A [B, I] mask would be B·I bytes read (and built) a batch; the
//   lists are B·X·4 bytes, each row read about once a split. Tiles are
//   walked in increasing order, so each thread keeps, for each of its 4
//   users, a cursor into the row and the next excluded id (found at the
//   start by binary search for the split's first item) in its own shared
//   slots (the mask tiles' space, which this instantiation does not use):
//   a tile costs one shared load and one comparison a user, and a tile that
//   holds excluded items walks them, each thread marking those in its 8
//   columns. No slot is shared, so no barrier is added.
// * Fold (topk_fold.cuh, shared with kernel C): a half-warp holds all
//   scores of 4 users, so a warp owns 8 users' lists outright and folds
//   without block barriers. A score that beats its
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
// * A second kernel (topk_fold.cuh) merges each user's per-split lists the
//   same way.
#include "topk_fold.cuh"

namespace {

constexpr int kTile = 128;    // items per staged tile: 8 per thread
constexpr int kMinSplit = 4 * kTile;
constexpr size_t kMaxSmem = 232448;   // shared memory a block may use on sm_90

// Bytes of a block at width d whose item tiles are staged dc columns at a
// time (the users are staged whole).
size_t smem_bytes(int d, int dc, int k) {
  return sizeof(float) * (static_cast<size_t>(kUsers) * (d + 4) +
                          static_cast<size_t>(2 * kTile) * (dc + 4)) +
         (sizeof(float) + sizeof(int32_t)) * static_cast<size_t>(kUsers) * (list_len(k) + kBuf) +
         sizeof(int32_t) * kUsers + 2 * kUsers * kTile;   // buffer counts, mask tiles
}

// Columns of an item tile staged at once: the whole row where the block
// fits, else the widest of 64, 32, ..., 4 that fits (wide rows).
int chunk_cols(int d, int k) {
  if (smem_bytes(d, d, k) <= kMaxSmem) return d;
  int dc = 64;
  while (dc > 4 && smem_bytes(d, dc, k) > kMaxSmem) dc /= 2;
  return dc < d ? dc : d;
}

size_t partial_smem_bytes(int d, int k) { return smem_bytes(d, chunk_cols(d, k), k); }

// Per-thread list state in shared memory: for each of a thread's 4 users,
// its cursor, the row's end and the next excluded id, each at
// slot(i) = (i·16 + ty)·16 + tx, so the two half-warps of a warp read 32
// distinct banks.
constexpr int kSlots = kUsers * 16;
static_assert(3 * kSlots * sizeof(int32_t) <= 2 * kUsers * kTile, "list state fits the mask tiles");

// kChunked: item tiles staged in column chunks of dc floats (wide rows);
// the whole-row instantiation folds every chunk index to a constant.
// kLists: exclusions from sorted lists (excl, excl_cnt; excluded items score
// excl_fill) instead of the mask, which this instantiation never reads.
template <bool kChunked, bool kLists>
__global__ void __launch_bounds__(kThreads, 2) topk_f32_partial_kernel(
    const float* __restrict__ users, const float* __restrict__ items,
    const int8_t* __restrict__ mask_in, const int32_t* __restrict__ excl,
    const int32_t* __restrict__ excl_cnt, int64_t excl_x, float excl_fill, int64_t b_total,
    int64_t i_total, int d, int dc, int k, int64_t split_len, float* __restrict__ part_v,
    int32_t* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  const int8_t* mask = kLists ? nullptr : mask_in;
  const int K = list_len(k);
  const int L = K + kBuf;
  const int stride = d + 4, d4 = d / 4;            // staged users: whole rows
  const int dcw = kChunked ? dc : d;               // staged items: dcw columns of a row
  const int tstride = dcw + 4;
  const int nchunks = kChunked ? (d + dcw - 1) / dcw : 1;
  float* us = reinterpret_cast<float*>(smem4);
  float* ts = us + kUsers * stride;
  float* lv = ts + 2 * kTile * tstride;
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

  // step st stages columns [dc·ch, dc·ch + cw) of tile t = st / nchunks,
  // ch = st % nchunks, into item buffer st & 1; the tile's mask rows go in
  // with its first chunk, into mask buffer t & 1
  auto stage = [&](int st) {
    const int t = kChunked ? st / nchunks : st, ch = kChunked ? st % nchunks : 0;
    const int col0 = dcw * ch, cw4 = kChunked ? (d - col0 < dcw ? d - col0 : dcw) / 4 : d4;
    const int64_t t0 = lo + static_cast<int64_t>(t) * kTile;
    float* dst = ts + (st & 1) * kTile * tstride;
    for (int idx = threadIdx.x; idx < kTile * cw4; idx += kThreads) {
      const int r = idx / cw4, c = idx % cw4;
      const bool ok = t0 + r < hi;
      cp_async16(dst + r * tstride + 4 * c, ok ? items + (t0 + r) * d + col0 + 4 * c : items,
                 ok ? 16 : 0);
    }
    if (mask_async && ch == 0) {
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
  init_lists(lv, li, cnt, L);
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
  int32_t* lstate = reinterpret_cast<int32_t*>(ms) + ty * 16 + tx;   // + i·256: user i's slot
  if constexpr (kLists) {
    // each user's first excluded id at or past lo, by binary search
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int cur = 0, end = 0;
      int32_t next = INT32_MAX;
      if (user_ok[i]) {
        const int32_t* row = excl + (b0 + 4 * ty + i) * excl_x;
        const int32_t n = excl_cnt[b0 + 4 * ty + i];
        end = n < 0 ? 0 : n > excl_x ? static_cast<int>(excl_x) : n;
        int hi_pos = end;
        while (cur < hi_pos) {
          const int mid = (cur + hi_pos) >> 1;
          if (row[mid] < lo) cur = mid + 1; else hi_pos = mid;
        }
        if (cur < end) next = row[cur];
      }
      lstate[i * 256] = cur;
      lstate[i * 256 + kSlots] = end;
      lstate[i * 256 + 2 * kSlots] = next;
    }
  }
  const float* urow = us + 4 * ty * stride;
  const int nsteps = ntiles * nchunks;
  uint32_t ok_bits = 0, ex_bits = 0;
  float acc[4][8];

  for (int st = 0; st < nsteps; ++st) {
    if (st + 1 < nsteps) {
      stage(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t = kChunked ? st / nchunks : st, ch = kChunked ? st % nchunks : 0;
    const int64_t t0 = lo + static_cast<int64_t>(t) * kTile;
    if (ch == 0) {
      const int n = hi - t0 < kTile ? static_cast<int>(hi - t0) : kTile;
      // eligibility bits (bit 8·i + j): a real item, a real user, not excluded
      ok_bits = 0;
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
      if constexpr (kLists) {
        // this tile's excluded items, user by user: bit 8·i + j as ok_bits
        ex_bits = 0;
        const int64_t t_end = t0 + n;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int32_t next = lstate[i * 256 + 2 * kSlots];
          if (next < t_end) {
            int cur = lstate[i * 256];
            const int end = lstate[i * 256 + kSlots];
            const int32_t* row = excl + (b0 + 4 * ty + i) * excl_x;
            do {   // next ≥ t0: earlier tiles consumed every smaller id
              const int off = static_cast<int>(next - t0);
              if ((off & 15) == tx) ex_bits |= 1u << (8 * i + (off >> 4));
              ++cur;
              next = cur < end ? row[cur] : INT32_MAX;
            } while (next < t_end);
            lstate[i * 256] = cur;
            lstate[i * 256 + 2 * kSlots] = next;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* tb = ts + (st & 1) * kTile * tstride + tx * tstride;
    const int c0 = dcw * ch / 4;
    const int cw4 = kChunked ? (d - dcw * ch < dcw ? d - dcw * ch : dcw) / 4 : d4;
    for (int c = 0; c < cw4; ++c) {
      float4 x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = *reinterpret_cast<const float4*>(tb + 16 * j * tstride + 4 * c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 u = *reinterpret_cast<const float4*>(urow + i * stride + 4 * (c0 + c));
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(u.x, x[j].x, acc[i][j]);
          acc[i][j] = fmaf(u.y, x[j].y, acc[i][j]);
          acc[i][j] = fmaf(u.z, x[j].z, acc[i][j]);
          acc[i][j] = fmaf(u.w, x[j].w, acc[i][j]);
        }
      }
    }
    if (ch == nchunks - 1) {
      // fold: each lane offers its candidates one at a time (topk_fold.cuh)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t pend = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if constexpr (kLists) {
            if ((ex_bits >> (8 * i + j)) & 1u) acc[i][j] = excl_fill;
          }
          const int32_t id = static_cast<int32_t>(t0 + tx + 16 * j);
          const bool c = ((ok_bits >> (8 * i + j)) & 1u) && better(acc[i][j], id, thr_v[i], thr_i[i]);
          pend |= static_cast<uint32_t>(c) << j;
        }
        offer_user(lv, li, cnt, K, L, k, i, warp, lane, tx, t0, acc[i], pend, thr_v[i], thr_i[i]);
      }
    }
    __syncthreads();  // this step's buffers are staged again two steps on
  }
  write_lists(lv, li, cnt, K, L, k, warp, lane, b0, b_total, split, num_splits, part_v, part_i);
}

}  // namespace

// Shared-memory bytes a block of the scoring kernel needs at (d, k).
extern "C" int64_t topk_f32_smem_bytes(int64_t d, int64_t k) {
  return static_cast<int64_t>(partial_smem_bytes(static_cast<int>(d), static_cast<int>(k)));
}

// The catalog split for (b, i, d, k): enough blocks to fill every SM at the
// occupancy the scoring kernel reaches, each split at least kMinSplit items.
// Writes {num_splits, split_len} to `plan`. Both instantiations take the
// same shared memory and are held to the same occupancy by their launch
// bounds, so one plan serves both.
extern "C" int topk_f32_plan(int64_t b, int64_t i, int64_t d, int64_t k, void* plan) {
  const int dc = chunk_cols(static_cast<int>(d), static_cast<int>(k));
  const size_t smem = smem_bytes(static_cast<int>(d), dc, static_cast<int>(k));
  return dc < d ? plan_splits(topk_f32_partial_kernel<true, false>, smem, b, i, kTile, kMinSplit,
                              static_cast<int64_t*>(plan))
                : plan_splits(topk_f32_partial_kernel<false, false>, smem, b, i, kTile, kMinSplit,
                              static_cast<int64_t*>(plan));
}

namespace {

template <bool kLists>
int launch(const void* users, const void* items, const void* mask, const void* excl,
           const void* excl_cnt, int64_t excl_x, float excl_fill, int64_t b, int64_t i,
           int64_t d, int64_t k, int64_t num_splits, int64_t split_len, void* part_v,
           void* part_i, void* out_v, void* out_i, void* stream) {
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d % 4 != 0 || reinterpret_cast<uintptr_t>(users) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(items) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dc = chunk_cols(static_cast<int>(d), static_cast<int>(k));
  const size_t smem = smem_bytes(static_cast<int>(d), dc, static_cast<int>(k));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  auto kern = dc < d ? topk_f32_partial_kernel<true, kLists>
                     : topk_f32_partial_kernel<false, kLists>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((b + kUsers - 1) / kUsers),
                  static_cast<unsigned>(num_splits));
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(users), static_cast<const float*>(items),
      static_cast<const int8_t*>(mask), static_cast<const int32_t*>(excl),
      static_cast<const int32_t*>(excl_cnt), excl_x, excl_fill, b, i, static_cast<int>(d), dc,
      static_cast<int>(k), split_len, static_cast<float*>(part_v),
      static_cast<int32_t*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_merge(static_cast<const float*>(part_v),
                                       static_cast<const int32_t*>(part_i), b, num_splits, k,
                                       static_cast<float*>(out_v), static_cast<int32_t*>(out_i),
                                       st));
}

}  // namespace

// Kernel B with a nullable int8 [b, i] mask (1 = excluded, never a candidate).
extern "C" int topk_f32_launch(const void* users, const void* items, const void* mask,
                               int64_t b, int64_t i, int64_t d, int64_t k, int64_t num_splits,
                               int64_t split_len, void* part_v, void* part_i, void* out_v,
                               void* out_i, void* stream) {
  return launch<false>(users, items, mask, nullptr, nullptr, 0, 0.f, b, i, d, k, num_splits,
                       split_len, part_v, part_i, out_v, out_i, stream);
}

// Kernel B with exclusion lists: row r of the int32 [b, x] table `excl`
// holds user r's excluded ids in ascending order in its first excl_cnt[r]
// slots (clamped to [0, x]; ids outside the catalog are never met); an
// excluded item scores `fill`.
extern "C" int topk_f32_lists_launch(const void* users, const void* items, const void* excl,
                                     const void* excl_cnt, int64_t x, float fill, int64_t b,
                                     int64_t i, int64_t d, int64_t k, int64_t num_splits,
                                     int64_t split_len, void* part_v, void* part_i, void* out_v,
                                     void* out_i, void* stream) {
  return launch<true>(users, items, nullptr, excl, excl_cnt, x, fill, b, i, d, k, num_splits,
                      split_len, part_v, part_i, out_v, out_i, stream);
}
