// Segment-sum SpMM over a destination-sorted CSR — kernel A of the port.
//
// Replaces the Pallas kernel `_segsum_kernel` of
// laplace_gnn_recommendation_tpu/ops/spmm_pallas.py (called through
// `pallas_segment_sum`):
//
//     out[r, :] = sum_{e in row r} w[e] * table[src[e], :]
//
// and the bf16-gather mode of the JAX blocked tier
// (laplace_gnn_recommendation_tpu/ops/spmm_blocked.py `blocked_segment_sum`
// with `gather_bf16`): the table arrives as bf16, each message is
// bf16(bf16(w[e]) * table[src[e]]) and the messages are summed in f32.
//
// What bounds it on an H100: memory. Each edge costs one gathered table row
// (4·D bytes, 2·D in bf16) plus 8 bytes of index and weight against 2·D
// flops, far below the card's flop-per-byte ridge. The TPU kernel had to
// receive the gathered rows pre-materialized in HBM as [E, D] messages; here
// the gather happens inside the kernel. The rows are gathered at random, so
// what matters is where they come from (a table that fits L2, as the 13 MB
// item table at D=32 does, or device memory, as for the 175 MB user table)
// and how many gathers are in flight.
//
// Design:
// * Source windows: the plan cuts the source table into windows of rows that
//   fit a share of L2 and orders the work window by window; one launch runs
//   the pieces of one window, so its gathers hit L2 after the first touch of
//   each row.
// * Pieces: the edges of one (row, window) are cut into pieces of at most
//   `chunk` consecutive edges (an empty row owns one empty piece, so every
//   row is written). A piece is a chain of dependent loads (its bounds, its
//   edge ids, its rows), so the kernel is held by how many gathers are in
//   flight. The plan picks the lanes a piece runs on: a warp for pieces that
//   are long on average, a group of 8 lanes (more for D > 32) for short ones
//   (a user row holds ~18 edges), so that a warp runs several side by side.
//   The kernel is held to 32 registers a thread, so every SM keeps its full
//   64 warps. A piece's lanes load its edge ids and weights one per lane
//   (the next batch while the current rows are gathered) and broadcast them
//   with shuffles.
// * Widths: D a multiple of 4, up to 128. A row is D/4 four-element vectors
//   (a float4, or 8 bytes of bf16); L lanes (L the power of two at or above
//   D/4, so L = 8 at D = 32) read one table row, lanes past D/4 idle; where
//   a piece runs on more than L lanes, its row slots each sum their own
//   edges and are combined by a fixed butterfly at the end. Other widths,
//   and tables not 16-byte aligned, are refused.
// * A row with one piece writes its output row directly. The pieces of any
//   other row (heavy rows, rows spread over several windows) each write a
//   partial row into a scratch slot, and a second kernel sums each row's
//   slots in a fixed order (slot s into row slot s mod 32/L, in (window,
//   piece) order, then the butterfly). No float atomics: the summation
//   order is fixed by the plan, so results are bitwise the same on every run.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One lane's four-element vector of a table row, as f32.
template <bool kBf16>
__device__ __forceinline__ float4 load_vec(const void* table, int64_t idx) {
  if constexpr (kBf16) {
    const uint2 raw = __ldg(static_cast<const uint2*>(table) + idx);
    return make_float4(__uint_as_float(raw.x << 16), __uint_as_float(raw.x & 0xffff0000u),
                       __uint_as_float(raw.y << 16), __uint_as_float(raw.y & 0xffff0000u));
  } else {
    return __ldg(static_cast<const float4*>(table) + idx);
  }
}

// acc += message; f32: w·x fused, bf16: the bf16-rounded product of the
// bf16-rounded weight and the bf16 value (exact in f32 before the rounding).
template <bool kBf16>
__device__ __forceinline__ void accumulate(float4& acc, float wt, const float4& x) {
  if constexpr (kBf16) {
    acc.x += bf16_round(wt * x.x);
    acc.y += bf16_round(wt * x.y);
    acc.z += bf16_round(wt * x.z);
    acc.w += bf16_round(wt * x.w);
  } else {
    acc.x = fmaf(wt, x.x, acc.x);
    acc.y = fmaf(wt, x.y, acc.y);
    acc.z = fmaf(wt, x.z, acc.z);
    acc.w = fmaf(wt, x.w, acc.w);
  }
}

// kLanes lanes (a power of two <= 32) cover one row of d4 <= kLanes vectors.
// A group of kGroup >= kLanes lanes runs one piece, so a warp runs
// 32 / kGroup pieces side by side and gathers kGroup / kLanes rows of each
// per instruction. Runs pieces [p0, p1). At most 32 registers a thread, so
// all 64 warps an SM can hold stay resident.
template <int kLanes, int kGroup, bool kBf16>
__global__ void __launch_bounds__(kThreads, 8) segsum_pieces_kernel(
    const int32_t* __restrict__ src, const float* __restrict__ w,
    const int32_t* __restrict__ piece_row, const int64_t* __restrict__ piece_lo,
    const int64_t* __restrict__ piece_hi, const int32_t* __restrict__ piece_slot,
    int64_t p0, int64_t p1, const void* __restrict__ table, int64_t d4,
    float4* __restrict__ partial, float4* __restrict__ out) {
  constexpr int kRows = kGroup / kLanes;   // rows of one piece per instruction
  const int lane = threadIdx.x & 31;
  const int64_t first =   // the warp's first piece
      p0 + ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5) * (32 / kGroup);
  if (first >= p1) return;  // uniform across the warp
  const int64_t piece = first + lane / kGroup;
  const int gl = lane % kGroup;   // lane within the group
  const int slot_in = gl / kLanes, sub = gl % kLanes;
  const bool live = sub < d4;
  const bool has = piece < p1;
  int64_t row = 0, lo = 0, hi = 0;
  int32_t slot = 0;
  if (has) {
    row = piece_row[piece];
    lo = piece_lo[piece];
    hi = piece_hi[piece];
    slot = piece_slot[piece];
  }
  // batches of kGroup edges; every group of the warp runs the warp's largest count
  int batches = static_cast<int>((hi - lo + kGroup - 1) / kGroup);
#pragma unroll
  for (int off = kGroup; off < 32; off <<= 1)
    batches = max(batches, __shfl_xor_sync(kFull, batches, off));

  int32_t s_lane = 0;
  float w_lane = 0.f;
  if (lo + gl < hi) {
    s_lane = src[lo + gl];
    w_lane = w[lo + gl];
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = 0; b < batches; ++b) {
    const int64_t e0 = lo + static_cast<int64_t>(b) * kGroup;
    const int n = hi - e0 < kGroup ? static_cast<int>(hi - e0) : kGroup;   // <= 0 when done
    // the next batch's edge ids and weights load while these rows are gathered
    const int64_t e_next = e0 + kGroup + gl;
    int32_t s_next = 0;
    float w_next = 0.f;
    if (e_next < hi) {
      s_next = src[e_next];
      w_next = w[e_next];
    }
    if (kBf16) w_lane = bf16_round(w_lane);
#pragma unroll
    for (int t0 = 0; t0 < kGroup; t0 += kRows) {
      const int t = t0 + slot_in;
      const int64_t s = __shfl_sync(kFull, s_lane, t, kGroup);
      const float wt = __shfl_sync(kFull, w_lane, t, kGroup);
      if (t < n && live) accumulate<kBf16>(acc, wt, load_vec<kBf16>(table, s * d4 + sub));
    }
    s_lane = s_next;
    w_lane = w_next;
  }
#pragma unroll
  for (int off = kLanes; off < kGroup; off <<= 1) {
    acc.x += __shfl_xor_sync(kFull, acc.x, off);
    acc.y += __shfl_xor_sync(kFull, acc.y, off);
    acc.z += __shfl_xor_sync(kFull, acc.z, off);
    acc.w += __shfl_xor_sync(kFull, acc.w, off);
  }
  float4* dst = slot < 0 ? out + row * d4 : partial + static_cast<int64_t>(slot) * d4;
  if (has && slot_in == 0 && live) dst[sub] = acc;
}

// Sums each heavy row's slots: row slot g of the warp (kLanes lanes) takes
// slots s0 + g, s0 + g + 32 / kLanes, ..., then the butterfly combines them.
template <int kLanes>
__global__ void __launch_bounds__(kThreads) segsum_combine_kernel(
    const int32_t* __restrict__ heavy_row, const int32_t* __restrict__ heavy_ptr,
    int64_t num_heavy, const float4* __restrict__ partial, int64_t d4,
    float4* __restrict__ out) {
  constexpr int kGroups = 32 / kLanes;
  const int64_t h = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (h >= num_heavy) return;  // uniform across the warp
  const int grp = lane / kLanes, sub = lane % kLanes;
  const bool live = sub < d4;
  const int64_t row = heavy_row[h];
  const int64_t s0 = heavy_ptr[h], s1 = heavy_ptr[h + 1];
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
#pragma unroll 4
    for (int64_t s = s0 + grp; s < s1; s += kGroups) {
      const float4 x = partial[s * d4 + sub];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
  }
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
    acc.x += __shfl_xor_sync(kFull, acc.x, off);
    acc.y += __shfl_xor_sync(kFull, acc.y, off);
    acc.z += __shfl_xor_sync(kFull, acc.z, off);
    acc.w += __shfl_xor_sync(kFull, acc.w, off);
  }
  if (grp == 0 && live) out[row * d4 + sub] = acc;
}

template <int kLanes, bool kBf16>
cudaError_t launch_group(int group, cudaStream_t st, const int32_t* src, const float* w,
                         const int32_t* piece_row, const int64_t* piece_lo,
                         const int64_t* piece_hi, const int32_t* piece_slot, int64_t p0,
                         int64_t p1, const void* table, int64_t d4, float4* partial,
                         float4* out) {
  constexpr int kNarrow = kLanes > 8 ? kLanes : 8;
  const bool wide = group > kNarrow;
  const int64_t per_block = (kThreads / 32) * (wide ? 1 : 32 / kNarrow);   // pieces a block runs
  const unsigned blocks = static_cast<unsigned>((p1 - p0 + per_block - 1) / per_block);
  if (wide) {
    segsum_pieces_kernel<kLanes, 32, kBf16><<<blocks, kThreads, 0, st>>>(
        src, w, piece_row, piece_lo, piece_hi, piece_slot, p0, p1, table, d4, partial, out);
  } else {
    segsum_pieces_kernel<kLanes, kNarrow, kBf16><<<blocks, kThreads, 0, st>>>(
        src, w, piece_row, piece_lo, piece_hi, piece_slot, p0, p1, table, d4, partial, out);
  }
  return cudaGetLastError();
}

// `group`: lanes a piece runs on — 32 (a warp) or fewer, max(lanes, 8).
template <bool kBf16>
cudaError_t launch_pieces(int lanes, int group, cudaStream_t st, const int32_t* src,
                          const float* w, const int32_t* piece_row, const int64_t* piece_lo,
                          const int64_t* piece_hi, const int32_t* piece_slot, int64_t p0,
                          int64_t p1, const void* table, int64_t d4, float4* partial,
                          float4* out) {
#define SEGSUM(L)                                                                           \
  return launch_group<L, kBf16>(group, st, src, w, piece_row, piece_lo, piece_hi, piece_slot, \
                                p0, p1, table, d4, partial, out)
  switch (lanes) {
    case 1: SEGSUM(1);
    case 2: SEGSUM(2);
    case 4: SEGSUM(4);
    case 8: SEGSUM(8);
    case 16: SEGSUM(16);
    default: SEGSUM(32);
  }
#undef SEGSUM
}

cudaError_t launch_combine(int lanes, cudaStream_t st, const int32_t* heavy_row,
                           const int32_t* heavy_ptr, int64_t num_heavy, const float4* partial,
                           int64_t d4, float4* out) {
  const unsigned blocks = static_cast<unsigned>((num_heavy + kThreads / 32 - 1) / (kThreads / 32));
#define COMBINE(L)                                                                     \
  segsum_combine_kernel<L><<<blocks, kThreads, 0, st>>>(heavy_row, heavy_ptr, num_heavy, \
                                                        partial, d4, out);               \
  break
  switch (lanes) {
    case 1: COMBINE(1);
    case 2: COMBINE(2);
    case 4: COMBINE(4);
    case 8: COMBINE(8);
    case 16: COMBINE(16);
    default: COMBINE(32);
  }
#undef COMBINE
  return cudaGetLastError();
}

}  // namespace

// `window_pieces` is a host array of num_windows + 1 piece offsets; the
// pieces of window k are [window_pieces[k], window_pieces[k + 1]).
extern "C" int segsum_launch(
    const void* src, const void* w, const void* piece_row, const void* piece_lo,
    const void* piece_hi, const void* piece_slot, int64_t num_windows,
    const void* window_pieces, const void* heavy_row, int64_t num_heavy,
    const void* heavy_ptr, int64_t d, int64_t bf16, int64_t group, const void* table,
    void* partial, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t d4 = d / 4;
  if (d % 4 != 0 || d4 < 1 || d4 > 32 || reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(partial) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int lanes = 1;
  while (lanes < d4) lanes <<= 1;
  const int64_t* wp = static_cast<const int64_t*>(window_pieces);
  auto launch = bf16 ? launch_pieces<true> : launch_pieces<false>;
  for (int64_t k = 0; k < num_windows; ++k) {
    if (wp[k + 1] <= wp[k]) continue;
    const cudaError_t err = launch(
        lanes, static_cast<int>(group), st, static_cast<const int32_t*>(src),
        static_cast<const float*>(w), static_cast<const int32_t*>(piece_row),
        static_cast<const int64_t*>(piece_lo), static_cast<const int64_t*>(piece_hi),
        static_cast<const int32_t*>(piece_slot), wp[k], wp[k + 1], table, d4,
        static_cast<float4*>(partial), static_cast<float4*>(out));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_heavy == 0) return 0;
  return static_cast<int>(launch_combine(
      lanes, st, static_cast<const int32_t*>(heavy_row), static_cast<const int32_t*>(heavy_ptr),
      num_heavy, static_cast<const float4*>(partial), d4, static_cast<float4*>(out)));
}
