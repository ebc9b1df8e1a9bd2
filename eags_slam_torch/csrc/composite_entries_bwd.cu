// K6: backward of the entry-binned compositing (the `pallas` backend), for
// Hopper.
//
// Replaces eags_slam_tpu/ops/rasterizer_pallas.py::_bwd_kernel (built by
// _make_bwd, called from _composite_bwd, which also zeroes the columns the
// forward did not composite). Same semantics as the plain twin
// composite_entries_bwd_plain in eags_slam_torch/ops/composite_entries.py.
//
// What bounds it on the card: the replay recomputes alpha and
// transmittance for every (pixel, entry) pair of the chunks K5 used (~40
// FP32 operations and two transcendentals per contributing pair), and sums
// each entry's 10 per-pixel gradient terms over the tile's pixels. It is
// bound by FP32 / SFU throughput; its bytes are the entries' 10 attr rows,
// the forward's log T and counts, dout rows 0-4 and the 10 grad rows of
// the replayed columns.
//
// Design, and how it answers the TPU version:
//  - One thread block per tile, 256 threads, PX / 256 pixels a thread in
//    registers: output cotangents, log T after the entry, and the running
//    "behind" sum b. The chunks K5 used (its channel 6) are replayed in
//    reverse and each chunk's entries back to front, so the TPU's
//    triangular suffix matmul becomes the running sum b; the per-(pixel,
//    entry) step is K2's (replay.cuh), which applies _chunk_alpha's rules:
//    no contribution where power > 0 or alpha < 1/255, alpha clipped at
//    0.99 with dop still taken through g = exp(power).
//  - Per entry, the 10 terms are summed with warp shuffles; lane 0 of each
//    warp writes its warp's sums to its own shared-memory slot (no shared
//    atomics) and the 8 slots are added in a fixed order.
//  - An entry column belongs to exactly one tile's segment, so the block
//    stores each column's 10 sums straight into (16, Epad): no global
//    atomics, and the result is the same from run to run. The wrapper
//    zero-fills the grads, which leaves every column K5 did not composite
//    (early-stopped chunks, alignment gaps, the padded tail) at zero, as
//    the TPU path's explicit mask did.
//  - Built with -fmad=false like K5.
#include <cuda_runtime.h>
#include <stdint.h>

#include "replay.cuh"

namespace {

using eags::CHUNK;
using eags::NTHREADS;
using eags::OUT_CH;
constexpr int NWARPS = NTHREADS / 32;
constexpr int NG = 10;

template <int PPT>
__global__ void __launch_bounds__(NTHREADS)
entries_bwd_kernel(const float* __restrict__ entries, int64_t epad,
                   const int* __restrict__ start, int tile, int tiles_x,
                   const float* __restrict__ out,
                   const float* __restrict__ dout,
                   float* __restrict__ grads) {
  __shared__ float s_attr[10][CHUNK];
  __shared__ float s_warp[NWARPS][NG][CHUNK];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int px = tile * tile;
  const int64_t st = start[t];
  const float tx0 = (float)((t % tiles_x) * tile);
  const float ty0 = (float)((t / tiles_x) * tile);
  const float* o = out + (int64_t)t * OUT_CH * px;
  const float* g = dout + (int64_t)t * OUT_CH * px;
  const int eff = (int)o[6 * px];
  const int cnt = (int)o[7 * px];

  float pu[PPT], pv[PPT], d4[PPT][4], dA[PPT], log_after[PPT], bsum[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = tid + q * NTHREADS;
    pu[q] = tx0 + (float)(p % tile);
    pv[q] = ty0 + (float)(p / tile);
    d4[q][0] = g[0 * px + p];
    d4[q][1] = g[1 * px + p];
    d4[q][2] = g[2 * px + p];
    d4[q][3] = g[3 * px + p];
    dA[q] = g[4 * px + p];
    log_after[q] = o[5 * px + p];
    bsum[q] = 0.0f;
  }

  for (int ci = eff - 1; ci >= 0; --ci) {
    const int base = ci * CHUNK;
    const int jmax = min(CHUNK, cnt - base);
    __syncthreads();
    for (int i = tid; i < NWARPS * NG * CHUNK; i += NTHREADS)
      (&s_warp[0][0][0])[i] = 0.0f;
    for (int i = tid; i < 10 * CHUNK; i += NTHREADS) {
      const int ch = i / CHUNK;
      const int j = i % CHUNK;
      s_attr[ch][j] = j < jmax ? entries[ch * epad + st + base + j] : 0.0f;
    }
    __syncthreads();

    for (int j = jmax - 1; j >= 0; --j) {
      const float mu = s_attr[0][j], mv = s_attr[1][j];
      const float ca = s_attr[2][j], cb = s_attr[3][j], cc = s_attr[4][j];
      const float op = s_attr[5][j];
      const float f0 = s_attr[6][j], f1 = s_attr[7][j];
      const float f2 = s_attr[8][j], f3 = s_attr[9][j];
      float r[NG];
#pragma unroll
      for (int c = 0; c < NG; ++c) r[c] = 0.0f;
      int any = 0;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        eags::ReplayTerms e;
        if (!eags::replay_step(pu[q], pv[q], mu, mv, ca, cb, cc, op, f0, f1,
                               f2, f3, d4[q], dA[q], log_after[q], bsum[q],
                               e))
          continue;
        const float du = e.du, dv = e.dv;
        const float dpower = e.d_alpha * e.alpha;
        r[0] += dpower * (ca * du + cb * dv);
        r[1] += dpower * (cc * dv + cb * du);
        r[2] += -0.5f * du * du * dpower;
        r[3] += -du * dv * dpower;
        r[4] += -0.5f * dv * dv * dpower;
        r[5] += e.d_alpha * e.gg;
        r[6] += d4[q][0] * e.w;
        r[7] += d4[q][1] * e.w;
        r[8] += d4[q][2] * e.w;
        r[9] += d4[q][3] * e.w;
        any = 1;
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int c = 0; c < NG; ++c) {
          float v = r[c];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
          r[c] = v;
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < NG; ++c) s_warp[warp][c][j] = r[c];
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < NG * CHUNK; i += NTHREADS) {
      const int c = i / CHUNK;
      const int j = i % CHUNK;
      if (j < jmax) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) v += s_warp[w][c][j];
        grads[c * epad + st + base + j] = v;
      }
    }
  }
}

}  // namespace

extern "C" int eags_composite_entries_bwd(
    const float* entries, int64_t epad, const int* start, int num_tiles,
    int tile, int tiles_x, const float* out, const float* dout,
    float* grads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(num_tiles), block(NTHREADS);
  switch (tile) {
    case 16:
      entries_bwd_kernel<1><<<grid, block, 0, st>>>(entries, epad, start,
                                                    tile, tiles_x, out, dout,
                                                    grads);
      break;
    case 32:
      entries_bwd_kernel<4><<<grid, block, 0, st>>>(entries, epad, start,
                                                    tile, tiles_x, out, dout,
                                                    grads);
      break;
    case 64:
      entries_bwd_kernel<16><<<grid, block, 0, st>>>(entries, epad, start,
                                                     tile, tiles_x, out, dout,
                                                     grads);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
