// The fixed-order cross-tile sum of the sorted backward kernels, K2
// (composite_sorted_bwd.cu) and K3 (composite_sorted_bwd_window.cu): what
// takes the place of the TPU's in-order read-modify-write of the global
// grad array (eags_slam_tpu/ops/rasterizer_pallas_v2.py:16-21), so that
// one input gives one answer whatever the blocks' order, and whatever the
// order of tile_ids.
//
//  - A survivor's column is a gaussian of a centre tile (cx, cy); a tile
//    sees it through its bands only when the tile's column offset from cx
//    and its row offset from cy both lie in a range of `bands` consecutive
//    integers (ops/rasterizer.py `_center_sort`: rows ty - r_n ..
//    ty - r_n + bands - 1, columns tx - r_n .. tx + r_n, r_n = (bands - 1)
//    / 2). So the tiles that see one column differ in (tx mod bands,
//    ty mod bands), and table_slot gives each of them its own slot
//    k = (ty mod bands) bands + (tx mod bands) of the column: bands^2
//    slots, no centre tile needed.
//  - A kernel stores a tile's total of (column, channel) with a plain store
//    into slots[k][column][channel] (a column's 10 channels in 40
//    contiguous bytes, one or two sectors a store) and marks
//    flags[k][column]. table_clear zeroes the flags (bands^2 bytes a
//    column); the slot floats are left unwritten.
//  - A tile that tile_ids holds twice would store twice into one slot, so
//    fold_repeats runs first: the backward is linear in the cotangent, so
//    a tile's copies are replayed once, by the first copy, with the
//    copies' cotangent rows added in row order (`merged`); the later
//    copies are skipped (row_flag 0). Rows of a tile held once keep their
//    cotangent (row_flag 1; 2: read `merged`).
//  - table_reduce then sums each column's marked slots in the order
//    k = 0 .. bands^2 - 1 into the (16, Npad) grads (rows 10-15 zero), one
//    thread a column. The plain twin (composite_sorted_bwd_plain) sums in
//    the same order, so the CPU tests show the tile order does not matter.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_patch.cuh"

namespace eags {

constexpr int GRAD_ROWS = 16;  // the attrs' rows, each with its grad row

// The slot of tile tc in the tables of the columns it sees.
__device__ __forceinline__ int table_slot(int tc, int tiles_x, int bands) {
  return (tc / tiles_x % bands) * bands + tc % tiles_x % bands;
}

// Tile total v of channel c of column col into slot k.
__device__ __forceinline__ void table_store(float* __restrict__ slots,
                                            uint8_t* __restrict__ flags,
                                            int64_t npad, int k, int c,
                                            int col, float v) {
  slots[((int64_t)k * npad + col) * NG + c] = v;
  if (c == 0) flags[(int64_t)k * npad + col] = 1;
}

template <int UNUSED = 0>
__global__ void __launch_bounds__(256)
table_reduce_kernel(const float* __restrict__ slots,
                    const uint8_t* __restrict__ flags, int nslots,
                    int64_t npad, float* __restrict__ grads) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= npad) return;
  float acc[NG];
#pragma unroll
  for (int c = 0; c < NG; ++c) acc[c] = 0.0f;
  for (int k = 0; k < nslots; ++k) {
    if (flags[(int64_t)k * npad + col]) {
#pragma unroll
      for (int c = 0; c < NG; ++c)
        acc[c] += slots[((int64_t)k * npad + col) * NG + c];
    }
  }
#pragma unroll
  for (int c = 0; c < NG; ++c) grads[c * npad + col] = acc[c];
#pragma unroll
  for (int c = NG; c < GRAD_ROWS; ++c) grads[c * npad + col] = 0.0f;
}

// Zero the flags of `nslots` slots a column (before the kernel that
// stores into the table).
inline int table_clear(uint8_t* flags, int nslots, int64_t npad,
                       cudaStream_t st) {
  return (int)cudaMemsetAsync(flags, 0, (size_t)nslots * npad, st);
}

// The grads from the table, after the kernel that stored into it.
inline int table_reduce(const float* slots, const uint8_t* flags,
                        int nslots, int64_t npad, float* grads,
                        cudaStream_t st) {
  const int64_t blocks = (npad + 255) / 256;
  table_reduce_kernel<0><<<(unsigned)blocks, 256, 0, st>>>(
      slots, flags, nslots, npad, grads);
  return (int)cudaGetLastError();
}

// One block a row s of tile_ids: row_flag[s] = 0 when an earlier row
// holds the same tile, else 2 when a later one does (merged[s] = the rows'
// cotangents added in row order), else 1. rowlen = OUT_CH * TILE^2.
template <int UNUSED = 0>
__global__ void __launch_bounds__(256)
fold_repeats_kernel(const int* __restrict__ tile_ids, int n_sel,
                    int64_t rowlen, const float* __restrict__ dout,
                    float* __restrict__ merged, int* __restrict__ row_flag) {
  __shared__ int s_earlier, s_later;
  const int s = blockIdx.x;
  const int tc = tile_ids[s];
  if (threadIdx.x == 0) s_earlier = s_later = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < n_sel; r += blockDim.x)
    if (r != s && tile_ids[r] == tc) {
      if (r < s) s_earlier = 1;
      else s_later = 1;
    }
  __syncthreads();
  if (s_earlier || !s_later) {
    if (threadIdx.x == 0) row_flag[s] = s_earlier ? 0 : 1;
    return;
  }
  if (threadIdx.x == 0) row_flag[s] = 2;
  float* m = merged + s * rowlen;
  for (int64_t e = threadIdx.x; e < rowlen; e += blockDim.x) {
    float acc = dout[s * rowlen + e];
    for (int r = s + 1; r < n_sel; ++r)
      if (tile_ids[r] == tc) acc += dout[r * rowlen + e];
    m[e] = acc;
  }
}

// row_flag and merged for the n_sel rows of tile_ids (before K2 / K3).
inline int fold_repeats(const int* tile_ids, int n_sel, int64_t rowlen,
                        const float* dout, float* merged, int* row_flag,
                        cudaStream_t st) {
  if (n_sel <= 0) return 0;
  fold_repeats_kernel<0><<<n_sel, 256, 0, st>>>(tile_ids, n_sel, rowlen,
                                                 dout, merged, row_flag);
  return (int)cudaGetLastError();
}

}  // namespace eags
