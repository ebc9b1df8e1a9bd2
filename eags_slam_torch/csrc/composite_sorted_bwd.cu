// K2: backward of the centre-tile-sorted compositing, for Hopper.
//
// Replaces eags_slam_tpu/ops/rasterizer_pallas_v2.py::_bwd_kernel with
// window=False (built by _make_bwd, called from _composite_sorted_bwd; the
// replay is _replay_chunks). Same semantics as the plain twin
// composite_sorted_bwd_plain in eags_slam_torch/ops/composite_sorted.py.
//
// What bounds it on the card: the replay recomputes alpha and
// transmittance for every (pixel, survivor) pair of the chunks the forward
// used (~10 FP32 operations to test a pair, ~55 more and an exp when it
// contributes), and every survivor's 10 per-pixel gradient terms must be
// summed over the tile's pixels: FP32 / SFU instruction throughput, then
// the cross-pixel reduction, which the TPU did with matmuls.
//
// Design, and how it answers the TPU version:
//  - Nothing couples a tile's pixels in the backward (the chunk count comes
//    from K1's output), so a tile is split over several blocks: at tile 32,
//    four blocks, one per 16 x 16 quadrant, of 128 threads (two pixels a
//    thread), or of 256 (one) when the grid has no more tiles than the
//    card has SMs: the 1/8 tracking subset's 104 tiles become 416 blocks
//    of 8 warps and fill the card. Tile 64 takes four 32 x 32 quadrants of
//    256 threads (four pixels a thread), tile 16 one block of 256.
//  - Each warp owns a compact 8 x (4 * PPT) patch. When a chunk is staged,
//    one thread per survivor computes its conservative alpha box
//    (alpha_box.cuh); each warp tests the 128 boxes against its patch, one
//    per lane and ballot, and walks only the survivors whose box meets it,
//    back to front. The box never drops a pair with nonzero alpha.
//  - The replay walks the chunks in reverse and each chunk's survivors back
//    to front, so the TPU's triangular suffix matmul becomes a running
//    per-pixel sum b:
//      T_before = T_after / (1 - alpha),  q = dout_rgbd . feat + dout_alpha,
//      d_alpha = T q - b / (1 - alpha),   b += alpha T q,
//    (1 - alpha >= 0.01, so the twin's max(., 1e-6) never binds), with dop
//    through g = exp(power) where alpha was clipped at 0.99. T is linear,
//    started from K1's log T and rescaled by 2^64 as in K1 (weights below
//    2^-64 are zero in both): one reciprocal instead of a log1p and an exp.
//    The alpha decision is rounded as the twin rounds it (twin_alpha); the
//    rest is built with FMA.
//  - A warp reduces a survivor's 10 terms with a transposing shuffle
//    reduction (12 shuffles: 5 + 3 + 2 + 1 + 1, each step halving the
//    values a lane keeps), after which 10 of its lane pairs hold one
//    channel each and write the warp's shared slot [warp][channel][j] in
//    one store, without atomics (a warp's mask marks the slots it wrote).
//    The patch, the replay step and the reduction are warp_patch.cuh's,
//    shared with K3 and K6.
//    At the end of the chunk the block adds the warps' slots in a fixed
//    order and makes one global atomicAdd per (survivor, channel) that is
//    nonzero: neighbouring tiles and quadrants
//    share gaussians, so the cross-block order, and the last bits, vary
//    from run to run (~1e-6 relative).
//  - The JAX options kernel_quadform and kernel_bf16 are the variants
//    <QUAD, BF16> (`opts` bits 0 and 1) of the kernel, for every tile
//    shape (warp_patch.cuh): BF16 stages from the bf16 attr layout and
//    rebuilds float32 exactly; QUAD stages the quadform coefficients
//    beside the attrs in 4 KB of dynamic shared memory (the static arrays
//    fill 48 KB), replays with quad_alpha, and sums 11 terms a pair (the
//    six basis moments in place of the five du / dv terms), contracted to
//    the five geometry grads per survivor after the warp reduction.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_patch.cuh"

namespace {

using eags::CHUNK;
using eags::MASK_WORDS;
using eags::NG;
using eags::OUT_CH;
using eags::region;

template <int TILE, int PPT, bool QUAD, bool BF16>
__global__ void __launch_bounds__(region(TILE) * region(TILE) / PPT)
bwd_kernel(const eags::AttrT<BF16>* __restrict__ attrs, int64_t npad,
           const int* __restrict__ tile_ids, int tiles_x, int capt,
           const float* __restrict__ out, const int* __restrict__ cols,
           const float* __restrict__ dout, float* __restrict__ grads) {
  // Region RS x RS at (rx0, ry0) of the tile.
  constexpr int RS = region(TILE);
  constexpr int PARTS = TILE / RS;
  constexpr int NT = RS * RS / PPT;
  constexpr int NWARPS = NT / 32;
  constexpr int PATCH_H = 4 * PPT;
  constexpr int NWX = RS / 8;
  static_assert(NT % 32 == 0 && NT >= CHUNK && RS % PATCH_H == 0, "");
  static_assert(NWARPS <= 8, "the warp slots must fit 48 KB");
  __shared__ float s_attr[10][CHUNK];
  __shared__ float4 s_box[CHUNK];
  __shared__ float s_warp[NWARPS][NG][CHUNK];
  __shared__ int s_col[CHUNK];
  __shared__ unsigned s_wmask[NWARPS][MASK_WORDS];
  // QUAD: [QROWS][CHUNK], the staged survivors' coefficients and means.
  extern __shared__ float s_dynq[];
  float (*s_q)[CHUNK] = reinterpret_cast<float (*)[CHUNK]>(s_dynq);

  const int s = blockIdx.y;
  const int part = blockIdx.x;
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

  const int x0 = (part % PARTS) * RS + (warp % NWX) * 8;
  const int y0 = (part / PARTS) * RS + (warp / NWX) * PATCH_H;
  eags::Patch<PPT> P;
  eags::patch_init<TILE, PPT>(P, o, g, tx0, ty0, x0, y0, lane);
  eags::QuadBasis<PPT> B;
  if constexpr (QUAD) eags::quad_basis_init(B, x0, y0, lane);

  for (int ci = eff - 1; ci >= 0; --ci) {
    const int base = ci * CHUNK;
    const int jmax = min(CHUNK, n_surv - base);
    __syncthreads();
    if (tid < jmax) {
      const int col = cols[(int64_t)s * capt + base + tid];
      eags::stage<QUAD, BF16>(s_attr, s_box, tid, attrs, npad, col, s_q, tx0,
                              ty0, (float)TILE);
      s_col[tid] = col;
    }
    __syncthreads();

    unsigned wm[MASK_WORDS];
    eags::walk_chunk<NG, QUAD>(
        P, s_attr, s_box, jmax, lane, wm,
        [&](int j, int ch, float v) { s_warp[warp][ch][j] = v; }, B, s_q);
    eags::store_mask(s_wmask[warp], lane, wm);
    __syncthreads();
    for (int i = tid; i < NG * CHUNK; i += NT) {
      const int c = i / CHUNK;
      const int j = i % CHUNK;
      const float v = eags::slot_total<NWARPS>(&s_warp[0][0][0],
                                               &s_wmask[0][0], c, j);
      if (v != 0.0f) atomicAdd(&grads[c * npad + s_col[j]], v);
    }
  }
}

template <int TILE, int PPT, bool QUAD, bool BF16>
int launch_variant(const void* attrs, int64_t npad, const int* tile_ids,
                   int n_sel, int tiles_x, int capt, const float* out,
                   const int* cols, const float* dout, float* grads,
                   cudaStream_t st) {
  constexpr int RS = region(TILE);
  const dim3 grid((TILE / RS) * (TILE / RS), n_sel);
  const size_t dyn = QUAD ? eags::QROWS * CHUNK * sizeof(float) : 0;
  if (dyn) {
    const cudaError_t err = cudaFuncSetAttribute(
        bwd_kernel<TILE, PPT, QUAD, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  bwd_kernel<TILE, PPT, QUAD, BF16><<<grid, RS * RS / PPT, dyn, st>>>(
      static_cast<const eags::AttrT<BF16>*>(attrs), npad, tile_ids, tiles_x,
      capt, out, cols, dout, grads);
  return (int)cudaGetLastError();
}

// The variant `opts` names: bit 0 QUAD, bit 1 BF16.
template <int TILE, int PPT>
int launch(const void* attrs, int64_t npad, const int* tile_ids, int n_sel,
           int tiles_x, int capt, const float* out, const int* cols,
           const float* dout, float* grads, int opts, cudaStream_t st) {
  switch (opts) {
    case 0:
      return launch_variant<TILE, PPT, false, false>(
          attrs, npad, tile_ids, n_sel, tiles_x, capt, out, cols, dout, grads,
          st);
    case 1:
      return launch_variant<TILE, PPT, true, false>(
          attrs, npad, tile_ids, n_sel, tiles_x, capt, out, cols, dout, grads,
          st);
    case 2:
      return launch_variant<TILE, PPT, false, true>(
          attrs, npad, tile_ids, n_sel, tiles_x, capt, out, cols, dout, grads,
          st);
    case 3:
      return launch_variant<TILE, PPT, true, true>(
          attrs, npad, tile_ids, n_sel, tiles_x, capt, out, cols, dout, grads,
          st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// At tile 32, quadrants of two pixels a thread (128 threads) when the grid
// has more tiles than the card has SMs, of one (256 threads) when it has no
// more, as the tracker's 1/8 subset.
extern "C" int eags_composite_sorted_bwd(
    const void* attrs, int64_t npad, const int* tile_ids, int n_sel,
    int tile, int tiles_x, int capt, const float* out, const int* cols,
    const float* dout, float* grads, int opts, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 16:
      return launch<16, 1>(attrs, npad, tile_ids, n_sel, tiles_x, capt, out,
                           cols, dout, grads, opts, st);
    case 32:
      if (n_sel <= eags::sm_count())
        return launch<32, 1>(attrs, npad, tile_ids, n_sel, tiles_x, capt,
                             out, cols, dout, grads, opts, st);
      return launch<32, 2>(attrs, npad, tile_ids, n_sel, tiles_x, capt, out,
                           cols, dout, grads, opts, st);
    case 64:
      return launch<64, 4>(attrs, npad, tile_ids, n_sel, tiles_x, capt, out,
                           cols, dout, grads, opts, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
