// K2: backward of the centre-tile-sorted compositing, for Hopper.
//
// Replaces eags_slam_tpu/ops/rasterizer_pallas_v2.py::_bwd_kernel with
// window=False (built by _make_bwd, called from _composite_sorted_bwd; the
// replay is _replay_chunks). Same semantics as the plain twin
// composite_sorted_bwd_plain in eags_slam_torch/ops/composite_sorted.py.
//
// What bounds it on the card: the replay recomputes alpha and
// transmittance for every (pixel, survivor) pair of the chunks the forward
// used (~40 FP32 operations and two transcendentals per pair), and every
// survivor's 10 per-pixel gradient terms must be summed over the tile's
// pixels. The cross-pixel reduction and the cross-tile accumulation are
// the extra costs that the TPU's sequential grid did not have.
//
// Design, and how it answers the TPU version:
//  - One thread block per selected tile, 256 threads, PX/256 pixels per
//    thread in registers (output cotangents, log T, the running "behind"
//    sum b). The chunks are replayed in reverse, and inside a chunk the
//    survivors are walked back to front, so the TPU's triangular suffix
//    matmul becomes a running per-pixel sum: for each survivor,
//      log T_before = log T_after - log(1 - alpha), T = exp(log T_before),
//      q = dout_rgbd . feat + dout_alpha,
//      d_alpha = T q - b / max(1 - alpha, 1e-6)   (alpha > 0 only),
//      b += alpha T q,
//    and dop uses g = exp(min(power, 0)) even where alpha was clipped at
//    0.99, as the TPU kernel does.
//  - Per survivor, the 10 per-pixel terms (mean u/v, conic a/b/c, opacity,
//    rgb, depth) are summed with warp shuffles (skipped when no pixel of the
//    warp sees the survivor) and then across the block with shared-memory
//    atomics.
//  - The race: neighbouring tiles' band windows overlap, so several blocks
//    add into the same gaussian's gradient. The TPU serialised this with its
//    sequential grid; here each block adds its per-survivor totals into the
//    (16, Npad) gradient with global atomicAdd. The summation order then
//    varies from run to run (last-bit differences, ~1e-6 relative).
//  - Built with -fmad=false so the recomputed alphas round like the forward.
//  - The per-(pixel, survivor) replay step is shared with K4 (replay.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "replay.cuh"

namespace {

using eags::CHUNK;
using eags::NTHREADS;
using eags::OUT_CH;
constexpr int NG = 10;

template <int PPT>
__global__ void __launch_bounds__(NTHREADS)
bwd_kernel(const float* __restrict__ attrs, int64_t npad,
           const int* __restrict__ tile_ids, int tile, int tiles_x, int capt,
           const float* __restrict__ out, const int* __restrict__ cols,
           const float* __restrict__ dout, float* __restrict__ grads) {
  __shared__ float s_attr[10][CHUNK];
  __shared__ float s_red[NG][CHUNK];
  __shared__ int s_col[CHUNK];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tc = tile_ids[s];
  const int px = tile * tile;
  const float tx0 = (float)((tc % tiles_x) * tile);
  const float ty0 = (float)((tc / tiles_x) * tile);
  const float* o = out + (int64_t)s * OUT_CH * px;
  const float* g = dout + (int64_t)s * OUT_CH * px;
  const int eff = (int)o[6 * px];
  const int n_surv = (int)o[7 * px];

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
    const int jmax = min(CHUNK, n_surv - base);
    __syncthreads();
    for (int i = tid; i < CHUNK; i += NTHREADS)
      s_col[i] = i < jmax ? cols[(int64_t)s * capt + base + i] : 0;
    for (int i = tid; i < NG * CHUNK; i += NTHREADS)
      s_red[i / CHUNK][i % CHUNK] = 0.0f;
    __syncthreads();
    for (int i = tid; i < 10 * CHUNK; i += NTHREADS) {
      const int ch = i / CHUNK;
      const int j = i % CHUNK;
      s_attr[ch][j] = j < jmax ? attrs[ch * npad + s_col[j]] : 0.0f;
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
          for (int c = 0; c < NG; ++c) atomicAdd(&s_red[c][j], r[c]);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < NG * CHUNK; i += NTHREADS) {
      const int c = i / CHUNK;
      const int j = i % CHUNK;
      if (j < jmax) {
        const float v = s_red[c][j];
        if (v != 0.0f) atomicAdd(&grads[c * npad + s_col[j]], v);
      }
    }
  }
}

}  // namespace

extern "C" int eags_composite_sorted_bwd(
    const float* attrs, int64_t npad, const int* tile_ids, int n_sel,
    int tile, int tiles_x, int capt, const float* out, const int* cols,
    const float* dout, float* grads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(n_sel), block(NTHREADS);
  switch (tile) {
    case 16:
      bwd_kernel<1><<<grid, block, 0, st>>>(attrs, npad, tile_ids, tile,
                                            tiles_x, capt, out, cols, dout,
                                            grads);
      break;
    case 32:
      bwd_kernel<4><<<grid, block, 0, st>>>(attrs, npad, tile_ids, tile,
                                            tiles_x, capt, out, cols, dout,
                                            grads);
      break;
    case 64:
      bwd_kernel<16><<<grid, block, 0, st>>>(attrs, npad, tile_ids, tile,
                                             tiles_x, capt, out, cols, dout,
                                             grads);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
