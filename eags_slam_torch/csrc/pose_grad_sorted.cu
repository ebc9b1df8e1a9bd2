// K4: pose-contraction backward of the centre-tile-sorted compositing, for
// Hopper.
//
// Replaces eags_slam_tpu/ops/rasterizer_pallas_v2.py::_pose_bwd_kernel
// (built by _make_pose_bwd, called from pose_grad_sorted). Same semantics as
// the plain twin pose_grad_sorted_plain in
// eags_slam_torch/ops/composite_sorted.py.
//
// What it computes: tracking needs dL/dpose (7 parameters: quat wxyz and
// trans xyz of the relative pose), not per-gaussian grads. For each
// selected tile the kernel replays K1's survivors back to front as K2 does,
// forms each survivor's grads of the 6 pose-dependent attr rows (mean u/v,
// conic a/b/c, depth) summed over the tile's pixels, and contracts them
// with the survivor's precomputed pose jacobian jac[p * 6 + ch, column]
// (48, Npad). Each block writes its tile's 7 sums to an (S, 8) partial
// that the wrapper sums; no (16, Npad) grad array is written, no global
// atomics are used, and the result is the same from run to run.
//
// What bounds it on the card: as K2, the replay (~40 FP32 operations and
// two transcendentals per (pixel, survivor) pair). The contraction adds 42
// jacobian reads and 42 multiply-adds per survivor and tile, a few per
// cent of the replay.
//
// Design, and how it answers the TPU version:
//  - One block per selected tile, 256 threads, PX / 256 pixels a thread in
//    registers (the replay state of replay.cuh).
//  - Per survivor, the 6 per-pixel terms are summed with warp shuffles;
//    lane 0 of each warp writes its warp's sum to its own shared-memory
//    slot (no shared atomics), and the 8 warp slots are added in a fixed
//    order. The TPU contracted a (16, capt) grad buffer with the jacobian
//    bands in VMEM and folded lanes into an (8, 128) block per program.
//  - The contraction: thread j of the block takes survivor j of the chunk
//    and adds its 6 totals times the 42 jacobian values into 7 running
//    sums; at the end the block reduces the 7 sums with shuffles and a
//    fixed-order pass over the warps.
//  - Built with -fmad=false like K5.
#include <cuda_runtime.h>
#include <stdint.h>

#include "replay.cuh"

namespace {

using eags::CHUNK;
using eags::NTHREADS;
using eags::OUT_CH;
constexpr int NWARPS = NTHREADS / 32;
constexpr int PJ = 6;      // pose-dependent rows per parameter
constexpr int NP = 7;      // pose parameters
constexpr int P_MAX = 8;   // partial row width (row 7 is zero)

template <int PPT>
__global__ void __launch_bounds__(NTHREADS)
pose_kernel(const float* __restrict__ attrs, const float* __restrict__ jac,
            int64_t npad, const int* __restrict__ tile_ids, int tile,
            int tiles_x, int capt, const float* __restrict__ out,
            const int* __restrict__ cols, const float* __restrict__ dout,
            float* __restrict__ part) {
  __shared__ float s_attr[10][CHUNK];
  __shared__ float s_warp[NWARPS][PJ][CHUNK];
  __shared__ int s_col[CHUNK];
  __shared__ float s_acc[NWARPS][NP];

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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
  float acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0.0f;

  for (int ci = eff - 1; ci >= 0; --ci) {
    const int base = ci * CHUNK;
    const int jmax = min(CHUNK, n_surv - base);
    __syncthreads();
    for (int i = tid; i < CHUNK; i += NTHREADS)
      s_col[i] = i < jmax ? cols[(int64_t)s * capt + base + i] : 0;
    for (int i = tid; i < NWARPS * PJ * CHUNK; i += NTHREADS)
      (&s_warp[0][0][0])[i] = 0.0f;
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
      float r[PJ];
#pragma unroll
      for (int c = 0; c < PJ; ++c) r[c] = 0.0f;
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
        r[5] += d4[q][3] * e.w;
        any = 1;
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int c = 0; c < PJ; ++c) {
          float v = r[c];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
          r[c] = v;
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < PJ; ++c) s_warp[warp][c][j] = r[c];
        }
      }
    }
    __syncthreads();
    // Contract: thread j takes survivor j of this chunk.
    for (int j = tid; j < jmax; j += NTHREADS) {
      float tot[PJ];
#pragma unroll
      for (int c = 0; c < PJ; ++c) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < NWARPS; ++w) v += s_warp[w][c][j];
        tot[c] = v;
      }
      const int col = s_col[j];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float v = 0.0f;
#pragma unroll
        for (int c = 0; c < PJ; ++c)
          v += tot[c] * jac[(int64_t)(p * PJ + c) * npad + col];
        acc[p] += v;
      }
    }
  }

  // Block reduction of the 7 sums in a fixed order.
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    float v = acc[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) s_acc[warp][p] = v;
  }
  __syncthreads();
  if (tid < P_MAX) {
    float v = 0.0f;
    if (tid < NP) {
      for (int w = 0; w < NWARPS; ++w) v += s_acc[w][tid];
    }
    part[(int64_t)s * P_MAX + tid] = v;
  }
}

}  // namespace

extern "C" int eags_pose_grad_sorted(
    const float* attrs, const float* jac, int64_t npad, const int* tile_ids,
    int n_sel, int tile, int tiles_x, int capt, const float* out,
    const int* cols, const float* dout, float* part, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(n_sel), block(NTHREADS);
  switch (tile) {
    case 16:
      pose_kernel<1><<<grid, block, 0, st>>>(attrs, jac, npad, tile_ids, tile,
                                             tiles_x, capt, out, cols, dout,
                                             part);
      break;
    case 32:
      pose_kernel<4><<<grid, block, 0, st>>>(attrs, jac, npad, tile_ids, tile,
                                             tiles_x, capt, out, cols, dout,
                                             part);
      break;
    case 64:
      pose_kernel<16><<<grid, block, 0, st>>>(attrs, jac, npad, tile_ids,
                                              tile, tiles_x, capt, out, cols,
                                              dout, part);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
