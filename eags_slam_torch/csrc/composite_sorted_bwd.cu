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
//    At the end of the chunk the block adds the warps' slots in a fixed
//    order and makes one global atomicAdd per (survivor, channel) that is
//    nonzero: neighbouring tiles and quadrants
//    share gaussians, so the cross-block order, and the last bits, vary
//    from run to run (~1e-6 relative).
#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha_box.cuh"

namespace {

constexpr int CHUNK = 128;
constexpr int OUT_CH = 8;
constexpr int NG = 10;
constexpr float LN2_64_INV = 0.0225421100138f;   // 1 / (64 ln 2)
constexpr float LN2_64 = 44.3614195558365f;

// Transposing reduction of v[10] over the 32 lanes of a warp. Returns the
// warp's total of channel `ch` (set here; -1 when this lane holds none, and
// only the even lane of each holding pair reports a channel).
__device__ __forceinline__ float reduce10(const float (&v)[NG], int lane,
                                          int& ch) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  // xor 16: keep channels 5 * b4 + [0, 5).
  float a[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float send = b4 ? v[k] : v[5 + k];
    const float keep = b4 ? v[5 + k] : v[k];
    a[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  // xor 8: keep a[0..2] (b3 = 0) or a[3..4] (b3 = 1).
  float b[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = a[k];
    const float hi = k < 2 ? a[3 + k] : 0.0f;
    const float send = b3 ? lo : hi;
    const float keep = b3 ? hi : lo;
    b[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  // xor 4: keep b[0..1] (b2 = 0) or b[2] (b2 = 1).
  float c[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float lo = b[k];
    const float hi = k < 1 ? b[2] : 0.0f;
    const float send = b2 ? lo : hi;
    const float keep = b2 ? hi : lo;
    c[k] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  // xor 2: keep c[0] (b1 = 0) or c[1] (b1 = 1); xor 1: the lane pair.
  float d = (b1 ? c[1] : c[0]) +
            __shfl_xor_sync(0xffffffffu, b1 ? c[0] : c[1], 2);
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  const int local = (b3 ? 3 : 0) + (b2 ? 2 : 0) + (b1 ? 1 : 0);
  const bool valid = (lane & 1) == 0 && (b3 ? !b2 : local < 3);
  ch = valid ? (b4 ? 5 : 0) + local : -1;
  return d;
}

// The side of the square region of a tile one block takes: the whole tile
// at 16, a quadrant at 32 and 64.
__host__ __device__ constexpr int region(int tile) {
  return tile > 16 ? tile / 2 : tile;
}

template <int TILE, int PPT>
__global__ void __launch_bounds__(region(TILE) * region(TILE) / PPT)
bwd_kernel(const float* __restrict__ attrs, int64_t npad,
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
  __shared__ unsigned s_wmask[NWARPS][CHUNK / 32];

  const int s = blockIdx.y;
  const int part = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tc = tile_ids[s];
  constexpr int px = TILE * TILE;
  const int rx0 = (part % PARTS) * RS;
  const int ry0 = (part / PARTS) * RS;
  const float tx0 = (float)((tc % tiles_x) * TILE);
  const float ty0 = (float)((tc / tiles_x) * TILE);
  const float* o = out + (int64_t)s * OUT_CH * px;
  const float* g = dout + (int64_t)s * OUT_CH * px;
  const int eff = (int)o[6 * px];
  const int n_surv = (int)o[7 * px];

  // This warp's patch bounds, in pixel centres.
  const int x0 = rx0 + (warp % NWX) * 8;
  const int y0 = ry0 + (warp / NWX) * PATCH_H;
  const float bx0 = tx0 + (float)x0, bx1 = bx0 + 7.0f;
  const float by0 = ty0 + (float)y0, by1 = by0 + (float)(PATCH_H - 1);
  const float pu = tx0 + (float)(x0 + (lane & 7));

  float pv[PPT], d4[PPT][4], dA[PPT], tm[PPT], bsum[PPT];
  int ex[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int y = y0 + (lane >> 3) + 4 * q;
    const int p = y * TILE + x0 + (lane & 7);
    pv[q] = ty0 + (float)y;
    d4[q][0] = g[0 * px + p];
    d4[q][1] = g[1 * px + p];
    d4[q][2] = g[2 * px + p];
    d4[q][3] = g[3 * px + p];
    dA[q] = g[4 * px + p];
    // T at the end of the tile as (tm, ex): T = tm * 2^(-64 ex).
    const float log_t = o[5 * px + p];
    ex[q] = max(0, (int)floorf(-log_t * LN2_64_INV));
    tm[q] = expf(log_t + (float)ex[q] * LN2_64);
    bsum[q] = 0.0f;
  }

  for (int ci = eff - 1; ci >= 0; --ci) {
    const int base = ci * CHUNK;
    const int jmax = min(CHUNK, n_surv - base);
    __syncthreads();
    if (tid < jmax) {
      const int col = cols[(int64_t)s * capt + base + tid];
      float a[10];
#pragma unroll
      for (int ch = 0; ch < 10; ++ch) a[ch] = attrs[ch * npad + col];
#pragma unroll
      for (int ch = 0; ch < 10; ++ch) s_attr[ch][tid] = a[ch];
      s_box[tid] = eags::alpha_box(a[0], a[1], a[2], a[3], a[4], a[5]);
      s_col[tid] = col;
    }
    __syncthreads();

    // This warp's survivors: a 128-bit mask from one box test a lane per
    // 32 survivors, walked back to front. A survivor no lane contributed
    // to leaves the mask, so the mask says which slots were written.
    unsigned wm[CHUNK / 32];
#pragma unroll
    for (int k = 0; k < CHUNK / 32; ++k) {
      const int j = k * 32 + lane;
      wm[k] = __ballot_sync(0xffffffffu,
                            j < jmax &&
                                eags::box_meets(s_box[j], bx0, bx1, by0, by1));
    }
#pragma unroll
    for (int k = CHUNK / 32 - 1; k >= 0; --k) {
      for (unsigned m = wm[k]; m;) {
        const int bit = 31 - __clz(m);
        m &= ~(1u << bit);
        const int j = k * 32 + bit;
        float r[NG];
#pragma unroll
        for (int c = 0; c < NG; ++c) r[c] = 0.0f;
        int any = 0;
        const float mu = s_attr[0][j], mv = s_attr[1][j];
        const float ca = s_attr[2][j], cb = s_attr[3][j];
        const float cc = s_attr[4][j], op = s_attr[5][j];
        const float f0 = s_attr[6][j], f1 = s_attr[7][j];
        const float f2 = s_attr[8][j], f3 = s_attr[9][j];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          float du, dv, gg, alpha;
          if (!eags::twin_alpha(pu, pv[q], mu, mv, ca, cb, cc, op, du, dv,
                                gg, alpha))
            continue;
          const float rr = __frcp_rn(1.0f - alpha);
          tm[q] *= rr;
          if (ex[q] > 0 && tm[q] >= 1.0f) {
            tm[q] *= 0x1p-64f;
            --ex[q];
          }
          const float T = ex[q] > 0 ? 0.0f : tm[q];
          const float qv = d4[q][0] * f0 + d4[q][1] * f1 + d4[q][2] * f2 +
                           d4[q][3] * f3 + dA[q];
          const float d_alpha = T * qv - bsum[q] * rr;
          const float w = alpha * T;
          bsum[q] += w * qv;
          const float dpower = d_alpha * alpha;
          r[0] += dpower * (ca * du + cb * dv);
          r[1] += dpower * (cc * dv + cb * du);
          r[2] += -0.5f * du * du * dpower;
          r[3] += -du * dv * dpower;
          r[4] += -0.5f * dv * dv * dpower;
          r[5] += d_alpha * gg;
          r[6] += d4[q][0] * w;
          r[7] += d4[q][1] * w;
          r[8] += d4[q][2] * w;
          r[9] += d4[q][3] * w;
          any = 1;
        }
        if (__any_sync(0xffffffffu, any)) {
          int ch;
          const float val = reduce10(r, lane, ch);
          if (ch >= 0) s_warp[warp][ch][j] = val;
        } else {
          wm[k] &= ~(1u << bit);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < CHUNK / 32; ++k)
      if (lane == k) s_wmask[warp][k] = wm[k];
    __syncthreads();
    for (int i = tid; i < NG * CHUNK; i += NT) {
      const int c = i / CHUNK;
      const int j = i % CHUNK;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w)
        if ((s_wmask[w][j >> 5] >> (j & 31)) & 1u) v += s_warp[w][c][j];
      if (v != 0.0f) atomicAdd(&grads[c * npad + s_col[j]], v);
    }
  }
}

template <int TILE, int PPT>
int launch(const float* attrs, int64_t npad, const int* tile_ids, int n_sel,
           int tiles_x, int capt, const float* out, const int* cols,
           const float* dout, float* grads, cudaStream_t st) {
  constexpr int RS = region(TILE);
  const dim3 grid((TILE / RS) * (TILE / RS), n_sel);
  bwd_kernel<TILE, PPT><<<grid, RS * RS / PPT, 0, st>>>(
      attrs, npad, tile_ids, tiles_x, capt, out, cols, dout, grads);
  return (int)cudaGetLastError();
}

}  // namespace

// At tile 32, quadrants of two pixels a thread (128 threads) when the grid
// has more tiles than the card has SMs, of one (256 threads) when it has no
// more, as the tracker's 1/8 subset.
extern "C" int eags_composite_sorted_bwd(
    const float* attrs, int64_t npad, const int* tile_ids, int n_sel,
    int tile, int tiles_x, int capt, const float* out, const int* cols,
    const float* dout, float* grads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 16:
      return launch<16, 1>(attrs, npad, tile_ids, n_sel, tiles_x, capt, out,
                           cols, dout, grads, st);
    case 32:
      if (n_sel <= eags::sm_count())
        return launch<32, 1>(attrs, npad, tile_ids, n_sel, tiles_x, capt,
                             out, cols, dout, grads, st);
      return launch<32, 2>(attrs, npad, tile_ids, n_sel, tiles_x, capt, out,
                           cols, dout, grads, st);
    case 64:
      return launch<64, 4>(attrs, npad, tile_ids, n_sel, tiles_x, capt, out,
                           cols, dout, grads, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
