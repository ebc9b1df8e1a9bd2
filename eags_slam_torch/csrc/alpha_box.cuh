// What K1 (composite_sorted_fwd.cu) and the warp-patch backward kernels K2,
// K3 and K6 (warp_patch.cuh) share: the two per-pair pieces below, and the
// card's SM count, from which K1, K2 and K6 pick their block size.
//
//  - twin_alpha: the alpha of one (pixel, survivor) pair, rounded as the
//    plain twin (`_chunk_alpha` in ops/composite_sorted.py) rounds it:
//    separate float32 operations through the _rn intrinsics, which the
//    compiler never contracts into FMA, and the precise expf. Every decision
//    (power > 0, the 0.99 clip, the 1/255 test) therefore matches the twin
//    while the rest of each kernel is free to use FMA.
//  - alpha_box: a conservative pixel box per survivor outside of which
//    twin_alpha is zero. Mirrored constant for constant by `alpha_box` in
//    ops/composite_sorted.py, which the CPU tests hold against
//    `_chunk_alpha`.
//  - The quadform variant (RasterConfig.kernel_quadform): quad_coeffs
//    forms a survivor's six coefficients of the expanded quadratic form in
//    tile-local pixel coordinates, quad_alpha its alpha at one pixel, both
//    rounded op for op as the twin's `_quad_coeffs` / `_quad_power` (one
//    fixed order, every multiply and add through an _rn intrinsic), and
//    quad_box the alpha box widened for the expanded form (`quad_alpha_box`
//    in ops/composite_sorted.py).
//
// The box: alpha >= 1/255 needs op * exp(power) >= 1/255, i.e. the
// quadratic form Q = a du^2 + 2 b du dv + c dv^2 = -2 power must satisfy
// Q <= 2 t with t = ln(255 op). For a positive definite conic that ellipse
// has half-widths sqrt(2 t c / det) in u and sqrt(2 t a / det) in v. The
// float32 Q can be below the exact one by at most ~12 eps kappa Q, kappa =
// (a + c)^2 / det, so the bound is widened to 2 (t + 1e-4) / (1 - 64 eps
// kappa), the half-widths by 1e-4 relative, 1e-3 px and 4 ulp of the mean.
// op < 1/255 gives an empty box (alpha <= op); a conic that is not positive
// definite, or so ill-conditioned that 64 eps kappa >= 0.5, gives no cull.
#pragma once

#include <cuda_runtime.h>

namespace eags {

constexpr float BOX_ALPHA_MAX = 0.99f;
constexpr float BOX_ALPHA_MIN = 1.0f / 255.0f;
constexpr float BOX_KAPPA_EPS = 64.0f * 1.1920929e-7f;
constexpr float BOX_T_PAD = 1e-4f;
constexpr float BOX_REL = 1.0001f;
constexpr float BOX_ABS = 1e-3f;
constexpr float BOX_POS = 4.0f * 1.1920929e-7f;
constexpr float BOX_QUAD_EPS = 16.0f * 1.1920929e-7f;

// Returns false (the pair does not contribute) when power > 0 or alpha <
// 1/255; else alpha, g = exp(power) and the offsets du, dv.
__device__ __forceinline__ bool twin_alpha(float pu, float pv, float mu,
                                           float mv, float ca, float cb,
                                           float cc, float op, float& du,
                                           float& dv, float& gg,
                                           float& alpha) {
  du = __fsub_rn(pu, mu);
  dv = __fsub_rn(pv, mv);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, du), du),
                               __fmul_rn(__fmul_rn(cc, dv), dv));
  const float power =
      __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, du), dv));
  if (power > 0.0f) return false;
  gg = expf(power);
  alpha = fminf(__fmul_rn(op, gg), BOX_ALPHA_MAX);
  return !(alpha < BOX_ALPHA_MIN);
}

// The quadform alpha at the pixel whose tile-local basis is L = (lu^2,
// lv^2, lu lv, lu, lv), g the survivor's coefficients (quad_coeffs):
// power = ((((g0 L0 + g1 L1) + g2 L2) + g3 L3) + g4 L4) + g5, then
// twin_alpha's rules.
__device__ __forceinline__ bool quad_alpha(float l0, float l1, float l2,
                                           float l3, float l4,
                                           const float (&g)[6], float op,
                                           float& gg, float& alpha) {
  float power = __fadd_rn(__fmul_rn(g[0], l0), __fmul_rn(g[1], l1));
  power = __fadd_rn(power, __fmul_rn(g[2], l2));
  power = __fadd_rn(power, __fmul_rn(g[3], l3));
  power = __fadd_rn(power, __fmul_rn(g[4], l4));
  power = __fadd_rn(power, g[5]);
  if (power > 0.0f) return false;
  gg = expf(power);
  alpha = fminf(__fmul_rn(op, gg), BOX_ALPHA_MAX);
  return !(alpha < BOX_ALPHA_MIN);
}

// The coefficients g[0..5] of the survivor (mu, mv, conic a / b / c) for
// the tile with its corner at (tx0, ty0), and its tile-local mean (g[6],
// g[7]) = (u_, v_): [-a/2, -c/2, -b, a u_ + b v_, c v_ + b u_,
// -(a u_^2 + c v_^2) / 2 - b u_ v_].
__device__ __forceinline__ void quad_coeffs(float mu, float mv, float ca,
                                            float cb, float cc, float tx0,
                                            float ty0, float (&g)[8]) {
  const float u = __fsub_rn(mu, tx0);
  const float v = __fsub_rn(mv, ty0);
  g[0] = __fmul_rn(-0.5f, ca);
  g[1] = __fmul_rn(-0.5f, cc);
  g[2] = -cb;
  g[3] = __fadd_rn(__fmul_rn(ca, u), __fmul_rn(cb, v));
  g[4] = __fadd_rn(__fmul_rn(cc, v), __fmul_rn(cb, u));
  g[5] = __fsub_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(ca, u), u),
                                 __fmul_rn(__fmul_rn(cc, v), v))),
      __fmul_rn(__fmul_rn(cb, u), v));
  g[6] = u;
  g[7] = v;
}

// The box of alpha_box with t padded by t_pad.
__device__ __forceinline__ float4 box_core(float mu, float mv, float ca,
                                           float cb, float cc, float op,
                                           float t_pad) {
  const float inf = __int_as_float(0x7f800000);
  if (op < BOX_ALPHA_MIN) return make_float4(inf, -inf, inf, -inf);
  const float det = __fsub_rn(__fmul_rn(ca, cc), __fmul_rn(cb, cb));
  const float tr = __fadd_rn(ca, cc);
  const float slack = __fmul_rn(BOX_KAPPA_EPS, __fdiv_rn(__fmul_rn(tr, tr),
                                                         det));
  if (!(op >= BOX_ALPHA_MIN) || !(ca > 0.0f) || !(cc > 0.0f) ||
      !(det > 0.0f) || !(slack < 0.5f))
    return make_float4(-inf, inf, -inf, inf);
  const float t = fmaxf(logf(__fmul_rn(255.0f, op)), 0.0f);
  const float q = __fdiv_rn(__fmul_rn(2.0f, __fadd_rn(t, t_pad)),
                            __fsub_rn(1.0f, slack));
  const float hu = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsqrt_rn(__fdiv_rn(__fmul_rn(q, cc), det)),
                          BOX_REL), BOX_ABS),
      __fmul_rn(BOX_POS, fabsf(mu)));
  const float hv = __fadd_rn(
      __fadd_rn(__fmul_rn(__fsqrt_rn(__fdiv_rn(__fmul_rn(q, ca), det)),
                          BOX_REL), BOX_ABS),
      __fmul_rn(BOX_POS, fabsf(mv)));
  return make_float4(__fsub_rn(mu, hu), __fadd_rn(mu, hu), __fsub_rn(mv, hv),
                     __fadd_rn(mv, hv));
}

// (u_lo, u_hi, v_lo, v_hi) in pixel-centre coordinates.
__device__ __forceinline__ float4 alpha_box(float mu, float mv, float ca,
                                            float cb, float cc, float op) {
  return box_core(mu, mv, ca, cb, cc, op, BOX_T_PAD);
}

// alpha_box for quad_alpha on a TILE-wide tile, (u_, v_) the survivor's
// tile-local mean: the expanded form's float32 power is off the exact one
// by at most ~9 eps / 2 of S = (|a| U^2 + |c| V^2) / 2 + |b| U V, U = tile
// + |u_|, V = tile + |v_| (the sum of its terms' magnitudes over the
// tile's pixels), so t is padded by 16 eps S more.
__device__ __forceinline__ float4 quad_box(float mu, float mv, float ca,
                                           float cb, float cc, float op,
                                           float u, float v, float tile) {
  const float au = __fadd_rn(tile, fabsf(u));
  const float av = __fadd_rn(tile, fabsf(v));
  const float s = __fadd_rn(
      __fmul_rn(0.5f, __fadd_rn(__fmul_rn(__fmul_rn(fabsf(ca), au), au),
                                __fmul_rn(__fmul_rn(fabsf(cc), av), av))),
      __fmul_rn(__fmul_rn(fabsf(cb), au), av));
  return box_core(mu, mv, ca, cb, cc, op,
                  __fadd_rn(BOX_T_PAD, __fmul_rn(BOX_QUAD_EPS, s)));
}

// Streaming multiprocessors of the current device (read once).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// Whether box b meets the pixel-centre rectangle [x0, x1] x [y0, y1].
__device__ __forceinline__ bool box_meets(float4 b, float x0, float x1,
                                          float y0, float y1) {
  return b.x <= x1 && b.y >= x0 && b.z <= y1 && b.w >= y0;
}

}  // namespace eags
