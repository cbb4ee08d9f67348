// Ordered sums of gathered rows: the sorted segment sum of ops/sorted_sum.py.
//
//     out[r, :] = sum over the plan's sorted entries k of row r of table[src_row[k], :]
//
// It replaces no TPU kernel: the JAX package sums these with plain
// `jax.ops.segment_sum`, outside any Pallas kernel. It serves every sum of
// `SumPlan` (src_row = the plan's order: the gradients of gathered rows) and
// the ranking model's edge aggregations fused with their gathers (src_row =
// the other end of each edge, in the plan's order), where the library's
// route built an [E, D] message tensor, zeroed its pad edges and gathered it
// again before two `segment_reduce` passes.
//
// Order. The sum is taken exactly in `SumPlan`'s order, so results equal the
// plain version bit for bit and a seed repeats: a row's entries, in sorted
// (stable) order, are cut into pieces of `PIECE_ROWS` (32); each piece is
// summed left to right from +0, then the row's pieces left to right from +0.
// No float atomics.
//
// What bounds it on an H100: bytes. Each entry costs one gathered table row
// (4·D bytes) and a 4-byte index against D adds, far below the card's
// flop-per-byte ridge; the compulsory traffic is the rows of the valid
// entries read once, the indices, and the [rows, D] result written once.
//
// Design:
// * Entries the plan masks (a batch's pad edges) are sorted past the last
//   row and never visited.
// * A piece is one work item. A group of kLanes lanes (the power of two at
//   or above the row's vector count, at most 32) runs it; each lane owns a
//   slice of the row (16-byte vectors where D % 4 == 0 and the table is
//   16-byte aligned, single floats otherwise; wider rows loop over column
//   slices) and walks the piece's entries in order, with kBatch rows in
//   flight: their indices and rows load together, the adds follow in order.
// * A row of one piece (an empty row owns one empty piece) writes its output
//   row directly. The pieces of a longer row (a popular item holds thousands
//   of entries in a batch) run side by side in different groups and write
//   scratch slots; a second kernel adds each such row's slots in order.
// * It launches on the caller's stream and allocates nothing: the wrapper
//   hands it the output and the scratch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;   // rows a lane has in flight

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// meta[p] = (row, first entry, end entry, scratch slot); row < 0: an unused
// item; slot < 0: the row has this one piece and its output row is written.
template <int kLanes, typename V>
__global__ void __launch_bounds__(kThreads) sorted_sum_pieces_kernel(
    const int4* __restrict__ meta, int64_t num_pieces, const int32_t* __restrict__ src_row,
    const V* __restrict__ table, int64_t dv, V* __restrict__ partial, V* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t piece = t / kLanes;
  if (piece >= num_pieces) return;
  const int sub = static_cast<int>(t % kLanes);
  const int4 m = __ldg(meta + piece);
  if (m.x < 0 || sub >= dv) return;
  V* dst = m.w < 0 ? out + static_cast<int64_t>(m.x) * dv : partial + static_cast<int64_t>(m.w) * dv;
  for (int64_t c = sub; c < dv; c += kLanes) {
    V acc = zero<V>();
    for (int k0 = m.y; k0 < m.z; k0 += kBatch) {
      V x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        x[j] = zero<V>();
        if (k0 + j < m.z) x[j] = __ldg(table + static_cast<int64_t>(__ldg(src_row + k0 + j)) * dv + c);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (k0 + j < m.z) acc = add(acc, x[j]);
    }
    dst[c] = acc;
  }
}

// Rows of more than one piece: row r's pieces are [row_end[r - 1], row_end[r])
// of the work list, and their sums are the scratch slots of the same numbers.
template <int kLanes, typename V>
__global__ void __launch_bounds__(kThreads) sorted_sum_combine_kernel(
    const int32_t* __restrict__ row_end, int64_t rows, const V* __restrict__ partial,
    int64_t dv, V* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t r = t / kLanes;
  if (r >= rows) return;
  const int sub = static_cast<int>(t % kLanes);
  const int p0 = r > 0 ? __ldg(row_end + r - 1) : 0;
  const int p1 = __ldg(row_end + r);
  if (p1 - p0 < 2 || sub >= dv) return;
  for (int64_t c = sub; c < dv; c += kLanes) {
    V acc = zero<V>();
    for (int q0 = p0; q0 < p1; q0 += kBatch) {
      V x[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        x[j] = zero<V>();
        if (q0 + j < p1) x[j] = partial[static_cast<int64_t>(q0 + j) * dv + c];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (q0 + j < p1) acc = add(acc, x[j]);
    }
    out[r * dv + c] = acc;
  }
}

unsigned blocks_for(int64_t items, int lanes) {
  return static_cast<unsigned>((items * lanes + kThreads - 1) / kThreads);
}

template <int kLanes, typename V>
cudaError_t launch_lanes(cudaStream_t st, const int4* meta, int64_t num_pieces,
                         const int32_t* row_end, int64_t rows, const int32_t* src_row,
                         const V* table, int64_t dv, V* partial, V* out) {
  sorted_sum_pieces_kernel<kLanes, V><<<blocks_for(num_pieces, kLanes), kThreads, 0, st>>>(
      meta, num_pieces, src_row, table, dv, partial, out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sorted_sum_combine_kernel<kLanes, V><<<blocks_for(rows, kLanes), kThreads, 0, st>>>(
      row_end, rows, partial, dv, out);
  return cudaGetLastError();
}

template <typename V>
cudaError_t launch(int lanes, cudaStream_t st, const int4* meta, int64_t num_pieces,
                   const int32_t* row_end, int64_t rows, const int32_t* src_row, const void* table,
                   int64_t dv, void* partial, void* out) {
#define SORTED_SUM(L)                                                                       \
  return launch_lanes<L, V>(st, meta, num_pieces, row_end, rows, src_row,                   \
                            static_cast<const V*>(table), dv, static_cast<V*>(partial),     \
                            static_cast<V*>(out))
  switch (lanes) {
    case 1: SORTED_SUM(1);
    case 2: SORTED_SUM(2);
    case 4: SORTED_SUM(4);
    case 8: SORTED_SUM(8);
    case 16: SORTED_SUM(16);
    default: SORTED_SUM(32);
  }
#undef SORTED_SUM
}

}  // namespace

// `meta`: int32 [num_pieces, 4] work list; `row_end`: int32 [rows], each
// row's end in it; `src_row`: int32, the table row each sorted entry reads;
// `table` f32 [*, d]; `partial` f32 [num_pieces, d] scratch; `out` f32
// [rows, d]. `vec`: read 16-byte vectors (d % 4 == 0, all three buffers
// 16-byte aligned). Returns a cudaError_t.
extern "C" int sorted_sum_launch(const void* meta, int64_t num_pieces, const void* row_end,
                                 int64_t rows, const void* src_row, const void* table, int64_t d,
                                 int64_t vec, void* partial, void* out, void* stream) {
  if (d < 1 || num_pieces < 0 || rows < 0 || num_pieces * 32 / kThreads >= (1ll << 31) ||
      rows * 32 / kThreads >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec && (d % 4 != 0 || reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(partial) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_pieces == 0 || rows == 0) return 0;
  const int64_t dv = vec ? d / 4 : d;
  int lanes = 1;
  while (lanes < dv && lanes < 32) lanes <<= 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* m = static_cast<const int4*>(meta);
  const int32_t* re = static_cast<const int32_t*>(row_end);
  const int32_t* sr = static_cast<const int32_t*>(src_row);
  return static_cast<int>(vec ? launch<float4>(lanes, st, m, num_pieces, re, rows, sr, table, dv,
                                               partial, out)
                              : launch<float>(lanes, st, m, num_pieces, re, rows, sr, table, dv,
                                              partial, out));
}
