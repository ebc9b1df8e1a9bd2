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
// (48, Npad). Each block writes its 7 sums to a row of an (S * regions, 8)
// partial that the wrapper sums; no (16, Npad) grad array is written, no
// global atomics are used, and the result is the same from run to run.
//
// What bounds it on the card: as K2, the replay (~10 FP32 operations to
// test a pair inside its survivor's alpha box, ~47 more and an exp when it
// contributes). The contraction adds 42 jacobian reads and multiply-adds
// per survivor a block's warps contributed to, a few per cent of the
// replay.
//
// Design, and how it answers the TPU version: K2's replay
// (composite_sorted_bwd.cu) with a contraction in place of its atomics.
//  - K2's grid: nothing couples a tile's pixels in the backward, so at tile
//    32 a tile takes four blocks, one per 16 x 16 quadrant, of 128 threads
//    (two pixels a thread), or of 256 (one) when the grid has no more tiles
//    than the card has SMs: the 1/8 tracking subset's 104 tiles become 416
//    blocks of 8 warps. Tile 64 takes four 32 x 32 quadrants of 256
//    threads, tile 16 one block of 256.
//  - The replay is warp_patch.cuh's: compact warp patches, one alpha box
//    per survivor staged with the chunk and one ballot per 32 survivors,
//    linear T from K1's log T, alpha decisions rounded as the twin rounds
//    them (twin_alpha) with FMA elsewhere. patch_step keeps only the 6
//    pose terms (0-4 and 9, the JAX `gsel`), reduce6 sums them over the
//    warp, and the warp's totals go to its own shared slots [warp][6][128].
//  - After each chunk, thread j takes survivor j: it adds the survivor's
//    warp slots in a fixed warp order (slot_total), skipping a survivor no
//    warp emitted, so its jacobian is never read, and adds the 6 totals
//    times the 42 jacobian values into 7 running sums. At the end the block
//    reduces the 7 sums with shuffles and a fixed-order pass over the
//    warps. The TPU contracted a (16, capt) grad buffer with the jacobian
//    bands in VMEM and folded lanes into an (8, 128) block per program.
//  - The JAX options kernel_quadform and kernel_bf16 are the variants
//    <QUAD, BF16> (`opts` bits 0 and 1), as in K2: BF16 stages from the
//    bf16 attr layout; QUAD stages the quadform coefficients (4 KB of
//    dynamic shared memory), replays with quad_alpha and sums 7 terms a
//    pair (six basis moments and the depth term), contracted to the five
//    geometry grads per survivor after the warp reduction. Each variant
//    keeps the fixed summation order: two runs are equal bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_patch.cuh"

namespace {

using eags::CHUNK;
using eags::MASK_WORDS;
using eags::OUT_CH;
using eags::PJ;
using eags::region;
constexpr int NP = 7;      // pose parameters
constexpr int P_MAX = 8;   // partial row width (column 7 is zero)

template <int TILE, int PPT, bool QUAD, bool BF16>
__global__ void __launch_bounds__(region(TILE) * region(TILE) / PPT)
pose_kernel(const eags::AttrT<BF16>* __restrict__ attrs,
            const float* __restrict__ jac,
            int64_t npad, const int* __restrict__ tile_ids, int tiles_x,
            int capt, const float* __restrict__ out,
            const int* __restrict__ cols, const float* __restrict__ dout,
            float* __restrict__ part) {
  // Region RS x RS at (rx0, ry0) of the tile.
  constexpr int RS = region(TILE);
  constexpr int PARTS = TILE / RS;
  constexpr int NT = RS * RS / PPT;
  constexpr int NWARPS = NT / 32;
  constexpr int PATCH_H = 4 * PPT;
  constexpr int NWX = RS / 8;
  static_assert(NT % 32 == 0 && NT >= CHUNK && RS % PATCH_H == 0, "");
  __shared__ float s_attr[10][CHUNK];
  __shared__ float4 s_box[CHUNK];
  __shared__ float s_warp[NWARPS][PJ][CHUNK];
  __shared__ int s_col[CHUNK];
  __shared__ unsigned s_wmask[NWARPS][MASK_WORDS];
  __shared__ float s_acc[NWARPS][NP];
  // QUAD: [QROWS][CHUNK], the staged survivors' coefficients and means.
  extern __shared__ float s_dynq[];
  float (*s_q)[CHUNK] = reinterpret_cast<float (*)[CHUNK]>(s_dynq);

  const int s = blockIdx.y;
  const int rg = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tc = tile_ids[s];
  constexpr int px = TILE * TILE;
  const float tx0 = (float)((tc % tiles_x) * TILE);
  const float ty0 = (float)((tc / tiles_x) * TILE);
  const float* o = out + (int64_t)s * OUT_CH * px;
  const float* g = dout + (int64_t)s * OUT_CH * px;
  const int eff = (int)o[6 * px];
  const int n_surv = (int)o[7 * px];

  const int x0 = (rg % PARTS) * RS + (warp % NWX) * 8;
  const int y0 = (rg / PARTS) * RS + (warp / NWX) * PATCH_H;
  eags::Patch<PPT> P;
  eags::patch_init<TILE, PPT>(P, o, g, tx0, ty0, x0, y0, lane);
  eags::QuadBasis<PPT> B;
  if constexpr (QUAD) eags::quad_basis_init(B, x0, y0, lane);
  float acc[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) acc[p] = 0.0f;

  for (int ci = eff - 1; ci >= 0; --ci) {
    const int base = ci * CHUNK;
    const int jmax = min(CHUNK, n_surv - base);
    __syncthreads();  // the last chunk's contraction has read s_col
    if (tid < jmax) {
      const int col = cols[(int64_t)s * capt + base + tid];
      eags::stage<QUAD, BF16>(s_attr, s_box, tid, attrs, npad, col, s_q, tx0,
                              ty0, (float)TILE);
      s_col[tid] = col;
    }
    __syncthreads();

    unsigned wm[MASK_WORDS];
    eags::walk_chunk<PJ, QUAD>(
        P, s_attr, s_box, jmax, lane, wm,
        [&](int j, int ch, float v) { s_warp[warp][ch][j] = v; }, B, s_q);
    eags::store_mask(s_wmask[warp], lane, wm);
    __syncthreads();
    // Contract: thread j takes survivor j of this chunk (NT >= CHUNK).
    if (tid < jmax) {
      unsigned hit = 0;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) hit |= s_wmask[w][tid >> 5];
      if ((hit >> (tid & 31)) & 1u) {
        float tot[PJ];
#pragma unroll
        for (int c = 0; c < PJ; ++c)
          tot[c] = eags::slot_total<NWARPS, CHUNK, PJ>(
              &s_warp[0][0][0], &s_wmask[0][0], c, tid);
        const int64_t col = s_col[tid];
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
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) v += s_acc[w][tid];
    }
    part[((int64_t)s * PARTS * PARTS + rg) * P_MAX + tid] = v;
  }
}

template <int TILE, int PPT, bool QUAD, bool BF16>
int launch_variant(const void* attrs, const float* jac, int64_t npad,
                   const int* tile_ids, int n_sel, int tiles_x, int capt,
                   const float* out, const int* cols, const float* dout,
                   float* part, cudaStream_t st) {
  constexpr int RS = region(TILE);
  const dim3 grid((TILE / RS) * (TILE / RS), n_sel);
  const size_t dyn = QUAD ? eags::QROWS * CHUNK * sizeof(float) : 0;
  if (dyn) {
    const cudaError_t err = cudaFuncSetAttribute(
        pose_kernel<TILE, PPT, QUAD, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  pose_kernel<TILE, PPT, QUAD, BF16><<<grid, RS * RS / PPT, dyn, st>>>(
      static_cast<const eags::AttrT<BF16>*>(attrs), jac, npad, tile_ids,
      tiles_x, capt, out, cols, dout, part);
  return (int)cudaGetLastError();
}

// The variant `opts` names: bit 0 QUAD, bit 1 BF16.
template <int TILE, int PPT>
int launch(const void* attrs, const float* jac, int64_t npad,
           const int* tile_ids, int n_sel, int tiles_x, int capt,
           const float* out, const int* cols, const float* dout, float* part,
           int opts, cudaStream_t st) {
  switch (opts) {
    case 0:
      return launch_variant<TILE, PPT, false, false>(
          attrs, jac, npad, tile_ids, n_sel, tiles_x, capt, out, cols, dout,
          part, st);
    case 1:
      return launch_variant<TILE, PPT, true, false>(
          attrs, jac, npad, tile_ids, n_sel, tiles_x, capt, out, cols, dout,
          part, st);
    case 2:
      return launch_variant<TILE, PPT, false, true>(
          attrs, jac, npad, tile_ids, n_sel, tiles_x, capt, out, cols, dout,
          part, st);
    case 3:
      return launch_variant<TILE, PPT, true, true>(
          attrs, jac, npad, tile_ids, n_sel, tiles_x, capt, out, cols, dout,
          part, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K2's grid: at tile 32, quadrants of two pixels a thread (128 threads)
// when the grid has more tiles than the card has SMs, of one (256 threads)
// when it has no more, as the tracker's 1/8 subset. `part` has n_sel *
// (tile / region(tile))^2 rows of 8.
extern "C" int eags_pose_grad_sorted(
    const void* attrs, const float* jac, int64_t npad, const int* tile_ids,
    int n_sel, int tile, int tiles_x, int capt, const float* out,
    const int* cols, const float* dout, float* part, int opts,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 16:
      return launch<16, 1>(attrs, jac, npad, tile_ids, n_sel, tiles_x, capt,
                           out, cols, dout, part, opts, st);
    case 32:
      if (n_sel <= eags::sm_count())
        return launch<32, 1>(attrs, jac, npad, tile_ids, n_sel, tiles_x,
                             capt, out, cols, dout, part, opts, st);
      return launch<32, 2>(attrs, jac, npad, tile_ids, n_sel, tiles_x, capt,
                           out, cols, dout, part, opts, st);
    case 64:
      return launch<64, 4>(attrs, jac, npad, tile_ids, n_sel, tiles_x, capt,
                           out, cols, dout, part, opts, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
