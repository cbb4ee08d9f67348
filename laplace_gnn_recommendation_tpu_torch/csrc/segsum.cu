// Segment-sum SpMM over a destination-sorted CSR — kernel A of the port.
//
// Replaces the Pallas kernel `_segsum_kernel` of
// laplace_gnn_recommendation_tpu/ops/spmm_pallas.py (called through
// `pallas_segment_sum`):
//
//     out[r, :] = sum_{e in row_ptr[r] .. row_ptr[r+1]} w[e] * table[src[e], :]
//
// What bounds it on an H100: memory. Each edge costs one gathered table row
// (4·D bytes) plus 8 bytes of index and weight against 2·D flops, far below
// the card's flop-per-byte ridge. The TPU kernel had to receive the gathered
// rows pre-materialized in HBM as [E, D] messages; here the gather happens
// inside the kernel, so the only device-memory traffic is the table rows
// (many of which hit the 50 MB L2 — the item table is 13 MB at D=32), the
// edge stream and one write per output row.
//
// Design:
// * Work is cut into "pieces": every row owns ceil(deg / chunk) pieces of at
//   most `chunk` consecutive edges (an empty row owns one empty piece, so
//   every row is written). One warp runs one piece. Edge ids and weights
//   are loaded 32 at a time, one per lane, and broadcast with shuffles.
// * Widths: D a multiple of 4, up to 128. A row is D/4 float4s; L lanes
//   (L the power of two at or above D/4, so L = 8 at D = 32) read one table
//   row, lanes past D/4 idle, so a warp gathers 32 / L rows per instruction
//   and keeps that many loads in flight; each lane group sums its own edges,
//   and the groups are combined by a fixed butterfly at the end. Other
//   widths, and tables not 16-byte aligned, are refused.
// * A row with one piece writes its output row directly. The pieces of a
//   heavier row (item rows of a popularity-skewed graph hold up to hundreds
//   of thousands of edges) each write a partial row into a scratch slot, and
//   a second kernel sums each row's slots in piece order. No float atomics:
//   the summation order is fixed by the plan, so results are bitwise the
//   same on every run.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

// kLanes lanes (a power of two <= 32) cover one row of d4 <= kLanes float4s;
// 32 / kLanes edges are gathered per step.
template <int kLanes>
__global__ void segsum_pieces_kernel(
    const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ src,
    const float* __restrict__ w, const int32_t* __restrict__ piece_row,
    const int64_t* __restrict__ piece_lo, const int32_t* __restrict__ piece_slot,
    int64_t num_pieces, int64_t chunk, const float4* __restrict__ table, int64_t d4,
    float4* __restrict__ partial, float4* __restrict__ out) {
  constexpr int kGroups = 32 / kLanes;
  const int64_t piece = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (piece >= num_pieces) return;  // uniform across the warp
  const int grp = lane / kLanes, sub = lane % kLanes;
  const bool live = sub < d4;
  const int64_t row = piece_row[piece];
  const int64_t lo = piece_lo[piece];
  const int64_t row_end = row_ptr[row + 1];
  const int64_t hi = lo + chunk < row_end ? lo + chunk : row_end;
  const int32_t slot = piece_slot[piece];
  float4* dst = slot < 0 ? out + row * d4 : partial + static_cast<int64_t>(slot) * d4;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int64_t e0 = lo; e0 < hi; e0 += 32) {
    const int n = hi - e0 < 32 ? static_cast<int>(hi - e0) : 32;
    int32_t s_lane = 0;
    float w_lane = 0.f;
    if (lane < n) {
      s_lane = src[e0 + lane];
      w_lane = w[e0 + lane];
    }
#pragma unroll
    for (int t0 = 0; t0 < 32; t0 += kGroups) {
      const int t = t0 + grp;
      const int64_t s = __shfl_sync(kFull, s_lane, t);
      const float wt = __shfl_sync(kFull, w_lane, t);
      if (t < n && live) {
        const float4 x = __ldg(table + s * d4 + sub);
        acc.x = fmaf(wt, x.x, acc.x);
        acc.y = fmaf(wt, x.y, acc.y);
        acc.z = fmaf(wt, x.z, acc.z);
        acc.w = fmaf(wt, x.w, acc.w);
      }
    }
  }
#pragma unroll
  for (int off = kLanes; off < 32; off <<= 1) {
    acc.x += __shfl_xor_sync(kFull, acc.x, off);
    acc.y += __shfl_xor_sync(kFull, acc.y, off);
    acc.z += __shfl_xor_sync(kFull, acc.z, off);
    acc.w += __shfl_xor_sync(kFull, acc.w, off);
  }
  if (grp == 0 && live) dst[sub] = acc;
}

__global__ void segsum_combine_kernel(
    const int32_t* __restrict__ heavy_row, const int32_t* __restrict__ heavy_ptr,
    int64_t num_heavy, const float* __restrict__ partial, int64_t d,
    float* __restrict__ out) {
  const int64_t h = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (h >= num_heavy) return;
  const int64_t row = heavy_row[h];
  const int64_t s0 = heavy_ptr[h], s1 = heavy_ptr[h + 1];
  for (int64_t col = lane; col < d; col += 32) {
    float acc = 0.f;
    for (int64_t s = s0; s < s1; ++s) acc += partial[s * d + col];
    out[row * d + col] = acc;
  }
}

}  // namespace

extern "C" int segsum_launch(
    const void* row_ptr, const void* src, const void* w, const void* piece_row,
    const void* piece_lo, const void* piece_slot, int64_t num_pieces, int64_t chunk,
    const void* heavy_row, const void* heavy_ptr, int64_t num_heavy,
    const void* table, int64_t d, void* partial, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t warps_per_block = kThreads / 32;
  const int64_t d4 = d / 4;
  if (d % 4 != 0 || d4 < 1 || d4 > 32 || reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(partial) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int lanes = 1;
  while (lanes < d4) lanes <<= 1;
  if (num_pieces > 0) {
    const unsigned blocks =
        static_cast<unsigned>((num_pieces + warps_per_block - 1) / warps_per_block);
#define SEGSUM(L)                                                                            \
  segsum_pieces_kernel<L><<<blocks, kThreads, 0, st>>>(                                      \
      static_cast<const int64_t*>(row_ptr), static_cast<const int32_t*>(src),                \
      static_cast<const float*>(w), static_cast<const int32_t*>(piece_row),                  \
      static_cast<const int64_t*>(piece_lo), static_cast<const int32_t*>(piece_slot),        \
      num_pieces, chunk, static_cast<const float4*>(table), d4,                              \
      static_cast<float4*>(partial), static_cast<float4*>(out))
    switch (lanes) {
      case 1: SEGSUM(1); break;
      case 2: SEGSUM(2); break;
      case 4: SEGSUM(4); break;
      case 8: SEGSUM(8); break;
      case 16: SEGSUM(16); break;
      default: SEGSUM(32); break;
    }
#undef SEGSUM
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (num_heavy > 0) {
    const int64_t blocks = (num_heavy + warps_per_block - 1) / warps_per_block;
    segsum_combine_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const int32_t*>(heavy_row), static_cast<const int32_t*>(heavy_ptr),
        num_heavy, static_cast<const float*>(partial), d, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
