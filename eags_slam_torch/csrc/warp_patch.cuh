// The warp-patch loops of the compositing kernels: the forward walk shared
// by K1 (composite_sorted_fwd.cu) and K5 (composite_entries_fwd.cu), and
// the backward replay shared by K2 (composite_sorted_bwd.cu), K3
// (composite_sorted_bwd_window.cu), K4 (pose_grad_sorted.cu) and K6
// (composite_entries_bwd.cu): what each does for a tile's pixels once a
// chunk of its survivors (K5, K6: entries) is staged in shared memory. The
// forward kernels differ only in how a chunk is staged, the backward ones
// in how the warps' totals leave the block.
//
//  - A warp owns a compact 8 x (4 PPT) patch of the tile: lane l holds
//    column l % 8 and rows l / 8 + 4 q, q < PPT. Its pixel state lives in
//    registers (FwdPatch, Patch), with the transmittance kept linear as
//    tm 2^(-64 ex) (weights below 2^-64 are zero in the kernels and in the
//    twins alike).
//  - patch_ballot tests the chunk's alpha boxes (alpha_box.cuh) against the
//    patch, one survivor a lane and one ballot per 32; a warp walks only
//    the survivors whose box meets its patch. The alpha decision is
//    twin_alpha's, rounded as the twin rounds it; the rest is built with
//    FMA.
//  - Forward (fwd_walk_chunk): front to back, T *= 1 - alpha, rescaled by
//    2^64 when it falls below 2^-64; log T is written once at the end
//    (fwd_store), and fwd_live is the tile-wide stop's per-lane test.
//  - Backward (walk_chunk, walk_words): back to front from the forward's
//    log T, over all of the chunk's mask words (K2, K4, K6) or a part of
//    them between two sums of the slots (K3). Per pair:
//      T_before = T_after / (1 - alpha),  q = dout_rgbd . feat + dout_alpha,
//      d_alpha = T q - b / (1 - alpha),   b += alpha T q,
//    (1 - alpha >= 0.01, so the twin's max(., 1e-6) never binds), with dop
//    through g = exp(power) where alpha was clipped at 0.99.
//  - reduce10 sums a survivor's 10 terms over the warp with a transposing
//    shuffle reduction (reduce6 the 6 pose-dependent ones of K4);
//    walk_words hands each warp total to the kernel's `emit` and leaves in
//    `wm` the survivors the warp contributed to.
//  - slot_total adds per-warp slots [warp][channel][survivor] in warp
//    order, skipping the slots a warp's mask says it did not write: the
//    same order every run.
//  - The variants of K1-K4 are template parameters of these loops,
//    <QUAD, BF16>, each branch under `if constexpr`, so <false, false> is
//    the default loop as it was. BF16: `stage` reads the bf16 attr layout
//    (ops/composite_sorted.py `to_bf16_layout`) and rebuilds float32
//    exactly (load_attrs). QUAD: `stage` also keeps each survivor's six
//    quadform coefficients and tile-local mean in s_q (quad_coeffs) and
//    its box is quad_box; each lane holds its pixels' tile-local basis
//    (QuadBasis); the alpha is quad_alpha's; the backward sums, per pair,
//    the six dpower-weighted basis moments in place of the five du / dv
//    terms, reduces them over the warp (reduce_terms, one term more than
//    the default) and contracts them to the five geometry grads per
//    survivor (quad_contract) before they leave the warp.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "alpha_box.cuh"

namespace eags {

constexpr int CHUNK = 128;
constexpr int OUT_CH = 8;
constexpr int NG = 10;
constexpr int PJ = 6;     // K4's pose-dependent terms: 0-4 and 9 of NG
constexpr int MASK_WORDS = CHUNK / 32;
constexpr float LN2_64_INV = 0.0225421100138f;   // 1 / (64 ln 2)
constexpr float LN2_64 = 44.3614195558365f;
constexpr float LOG_T_MIN = -11.5f;              // the tile-wide stop
constexpr int QROWS = 8;  // s_q rows under QUAD: 6 coefficients, u_, v_

// The attrs' element type: float, or the bf16 layout's.
template <bool BF16>
struct AttrType {
  using T = float;
};
template <>
struct AttrType<true> {
  using T = __nv_bfloat16;
};
template <bool BF16>
using AttrT = typename AttrType<BF16>::T;

// The 10 compositing rows of column col: read as they are, or rebuilt from
// the bf16 layout (rows 0 / 1 u hi / lo, 2 / 3 v, 4-10 conic, opacity,
// rgb, 11 / 12 depth) with hi + lo rounded as JAX's `_rebuild_f32`.
template <bool BF16>
__device__ __forceinline__ void load_attrs(
    float (&a)[10], const AttrT<BF16>* __restrict__ attrs, int64_t npad,
    int64_t col) {
  if constexpr (BF16) {
    const auto at = [&](int row) {
      return __bfloat162float(attrs[row * npad + col]);
    };
    a[0] = __fadd_rn(at(0), at(1));
    a[1] = __fadd_rn(at(2), at(3));
#pragma unroll
    for (int ch = 2; ch < 9; ++ch) a[ch] = at(ch + 2);
    a[9] = __fadd_rn(at(11), at(12));
  } else {
#pragma unroll
    for (int ch = 0; ch < 10; ++ch) a[ch] = attrs[ch * npad + col];
  }
}

// A lane's tile-local pixel basis under QUAD: its column lu and rows
// lv[q] (exact integers) and their squares and products.
template <int PPT>
struct QuadBasis {
  float lu, lu2;
  float lv[PPT], lv2[PPT], luv[PPT];
};

// The basis of the lane's pixels of the patch at tile-local (x0, y0).
template <int PPT>
__device__ __forceinline__ void quad_basis_init(QuadBasis<PPT>& B, int x0,
                                                int y0, int lane) {
  B.lu = (float)(x0 + (lane & 7));
  B.lu2 = B.lu * B.lu;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    B.lv[q] = (float)(y0 + (lane >> 3) + 4 * q);
    B.lv2[q] = B.lv[q] * B.lv[q];
    B.luv[q] = B.lu * B.lv[q];
  }
}

// The lane holding term t of NT after reduce_terms<NT> (-1: none).
__host__ __device__ constexpr int term_of_lane(int nt, int lane) {
  int idx = 0, n = nt, size = nt;
  for (int off = 16; off > 0; off >>= 1) {
    const int h = (size + 1) / 2;
    if (lane & off) {
      idx += h;
      n -= h;
    } else if (n > h) {
      n = h;
    }
    size = h;
  }
  return n >= 1 ? idx : -1;
}

__host__ __device__ constexpr int lane_of_term(int nt, int t) {
  for (int lane = 0; lane < 32; ++lane)
    if (term_of_lane(nt, lane) == t) return lane;
  return -1;
}

// The side of the square region of a tile that one K2 block takes: the
// whole tile at 16, a quadrant at 32 and 64.
__host__ __device__ constexpr int region(int tile) {
  return tile > 16 ? tile / 2 : tile;
}

// Transposing reduction of v[10] over the 32 lanes of a warp (12 shuffles:
// 5 + 3 + 2 + 1 + 1, each step halving the values a lane keeps). Returns
// the warp's total of channel `ch` (set here; -1 when this lane holds none,
// and only the even lane of each holding pair reports a channel).
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

// The same for the 6 values of K4 (8 shuffles: 3 + 2 + 1 + 1 + 1). The
// lanes whose low two bits are zero report; lanes 12 and 28 hold none.
__device__ __forceinline__ float reduce6(const float (&v)[PJ], int lane,
                                         int& ch) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  // xor 16: keep channels 3 * b4 + [0, 3).
  float a[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float send = b4 ? v[k] : v[3 + k];
    const float keep = b4 ? v[3 + k] : v[k];
    a[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
  // xor 8: keep a[0..1] (b3 = 0) or a[2] (b3 = 1).
  float b[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float lo = a[k];
    const float hi = k < 1 ? a[2] : 0.0f;
    const float send = b3 ? lo : hi;
    const float keep = b3 ? hi : lo;
    b[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  // xor 4: keep b[0] (b2 = 0) or b[1] (b2 = 1); xor 2, 1: the lane quad.
  float d = (b2 ? b[1] : b[0]) +
            __shfl_xor_sync(0xffffffffu, b2 ? b[0] : b[1], 4);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  const bool valid = (lane & 3) == 0 && !(b3 && b2);
  ch = valid ? (b4 ? 3 : 0) + (b3 ? 2 : (b2 ? 1 : 0)) : -1;
  return d;
}

// One lane's pixels of a forward warp patch: colour / depth sums and T.
template <int PPT>
struct FwdPatch {
  float bx0, bx1, by0, by1;   // the patch's pixel-centre bounds
  float pu;                   // the lane's column
  float pv[PPT];              // its rows
  float acc[PPT][4];          // rgb + depth sums
  float tm[PPT];              // T: tm * 2^(-64 ex)
  int ex[PPT];
};

// The patch whose top-left pixel is (x0, y0) of the tile with its corner
// at (tx0, ty0), before any survivor.
template <int PPT>
__device__ __forceinline__ void fwd_patch_init(FwdPatch<PPT>& P, float tx0,
                                               float ty0, int x0, int y0,
                                               int lane) {
  P.bx0 = tx0 + (float)x0;
  P.bx1 = P.bx0 + 7.0f;
  P.by0 = ty0 + (float)y0;
  P.by1 = P.by0 + (float)(4 * PPT - 1);
  P.pu = tx0 + (float)(x0 + (lane & 7));
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    P.pv[q] = ty0 + (float)(y0 + (lane >> 3) + 4 * q);
    P.tm[q] = 1.0f;
    P.ex[q] = 0;
    P.acc[q][0] = P.acc[q][1] = P.acc[q][2] = P.acc[q][3] = 0.0f;
  }
}

// One lane's pixels of a warp patch and their replay state.
template <int PPT>
struct Patch {
  float bx0, bx1, by0, by1;   // the patch's pixel-centre bounds
  float pu;                   // the lane's column
  float pv[PPT];              // its rows
  float d4[PPT][4], dA[PPT];  // output cotangents: rgb + depth, alpha
  float tm[PPT];              // T after the replayed survivors:
  int ex[PPT];                //   tm * 2^(-64 ex)
  float bsum[PPT];            // the running "behind" sum b
};

// The patch whose top-left pixel is (x0, y0) of a TILE x TILE tile with
// its corner at (tx0, ty0); o, g: the tile's (8, PX) forward output and
// cotangent.
template <int TILE, int PPT>
__device__ __forceinline__ void patch_init(Patch<PPT>& P, const float* o,
                                           const float* g, float tx0,
                                           float ty0, int x0, int y0,
                                           int lane) {
  constexpr int px = TILE * TILE;
  P.bx0 = tx0 + (float)x0;
  P.bx1 = P.bx0 + 7.0f;
  P.by0 = ty0 + (float)y0;
  P.by1 = P.by0 + (float)(4 * PPT - 1);
  P.pu = tx0 + (float)(x0 + (lane & 7));
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int y = y0 + (lane >> 3) + 4 * q;
    const int p = y * TILE + x0 + (lane & 7);
    P.pv[q] = ty0 + (float)y;
    P.d4[q][0] = g[0 * px + p];
    P.d4[q][1] = g[1 * px + p];
    P.d4[q][2] = g[2 * px + p];
    P.d4[q][3] = g[3 * px + p];
    P.dA[q] = g[4 * px + p];
    const float log_t = o[5 * px + p];
    P.ex[q] = max(0, (int)floorf(-log_t * LN2_64_INV));
    P.tm[q] = expf(log_t + (float)P.ex[q] * LN2_64);
    P.bsum[q] = 0.0f;
  }
}

// Stage entry j of a chunk from attribute column `col`: its 10 attr rows
// and its alpha box; under QUAD also its coefficients and tile-local mean
// into s_q (the tile's corner at (tx0, ty0)) and the widened box.
template <bool QUAD = false, bool BF16 = false>
__device__ __forceinline__ void stage(float (*s_attr)[CHUNK], float4* s_box,
                                      int j,
                                      const AttrT<BF16>* __restrict__ attrs,
                                      int64_t npad, int64_t col,
                                      float (*s_q)[CHUNK] = nullptr,
                                      float tx0 = 0.0f, float ty0 = 0.0f,
                                      float tile = 0.0f) {
  float a[10];
  load_attrs<BF16>(a, attrs, npad, col);
#pragma unroll
  for (int ch = 0; ch < 10; ++ch) s_attr[ch][j] = a[ch];
  if constexpr (QUAD) {
    float g[QROWS];
    quad_coeffs(a[0], a[1], a[2], a[3], a[4], tx0, ty0, g);
#pragma unroll
    for (int k = 0; k < QROWS; ++k) s_q[k][j] = g[k];
    s_box[j] = quad_box(a[0], a[1], a[2], a[3], a[4], a[5], g[6], g[7], tile);
  } else {
    s_box[j] = alpha_box(a[0], a[1], a[2], a[3], a[4], a[5]);
  }
}

// Replay survivor j of the staged chunk over the lane's pixels: move their
// state past it and add its gradient terms to r: all 10 (NG), or K4's
// six (PJ: terms 0-4 and 9, the JAX `gsel`); under QUAD the five geometry
// terms become the six basis moments (r has NC + 1 terms). Returns
// whether any of the lane's pixels took a contribution from it.
template <int NC, int PPT, bool QUAD = false>
__device__ __forceinline__ bool patch_step(
    Patch<PPT>& P, const float (*s_attr)[CHUNK], int j,
    float (&r)[NC + (QUAD ? 1 : 0)],
    const QuadBasis<PPT>& B = QuadBasis<PPT>{},
    const float (*s_q)[CHUNK] = nullptr) {
  static_assert(NC == NG || NC == PJ, "");
  const float mu = s_attr[0][j], mv = s_attr[1][j];
  const float ca = s_attr[2][j], cb = s_attr[3][j];
  const float cc = s_attr[4][j], op = s_attr[5][j];
  const float f0 = s_attr[6][j], f1 = s_attr[7][j];
  const float f2 = s_attr[8][j], f3 = s_attr[9][j];
  float g[6];
  if constexpr (QUAD) {
#pragma unroll
    for (int k = 0; k < 6; ++k) g[k] = s_q[k][j];
  }
  bool any = false;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    float du, dv, gg, alpha;
    if constexpr (QUAD) {
      if (!quad_alpha(B.lu2, B.lv2[q], B.luv[q], B.lu, B.lv[q], g, op, gg,
                      alpha))
        continue;
    } else {
      if (!twin_alpha(P.pu, P.pv[q], mu, mv, ca, cb, cc, op, du, dv, gg,
                      alpha))
        continue;
    }
    const float rr = __frcp_rn(1.0f - alpha);
    P.tm[q] *= rr;
    if (P.ex[q] > 0 && P.tm[q] >= 1.0f) {
      P.tm[q] *= 0x1p-64f;
      --P.ex[q];
    }
    const float T = P.ex[q] > 0 ? 0.0f : P.tm[q];
    const float qv = P.d4[q][0] * f0 + P.d4[q][1] * f1 + P.d4[q][2] * f2 +
                     P.d4[q][3] * f3 + P.dA[q];
    const float d_alpha = T * qv - P.bsum[q] * rr;
    const float w = alpha * T;
    P.bsum[q] += w * qv;
    const float dpower = d_alpha * alpha;
    if constexpr (QUAD) {
      r[0] += dpower * B.lu2;
      r[1] += dpower * B.lv2[q];
      r[2] += dpower * B.luv[q];
      r[3] += dpower * B.lu;
      r[4] += dpower * B.lv[q];
      r[5] += dpower;
      if constexpr (NC == NG) {
        r[6] += d_alpha * gg;
        r[7] += P.d4[q][0] * w;
        r[8] += P.d4[q][1] * w;
        r[9] += P.d4[q][2] * w;
        r[10] += P.d4[q][3] * w;
      } else {
        r[6] += P.d4[q][3] * w;
      }
    } else {
      r[0] += dpower * (ca * du + cb * dv);
      r[1] += dpower * (cc * dv + cb * du);
      r[2] += -0.5f * du * du * dpower;
      r[3] += -du * dv * dpower;
      r[4] += -0.5f * dv * dv * dpower;
      if constexpr (NC == NG) {
        r[5] += d_alpha * gg;
        r[6] += P.d4[q][0] * w;
        r[7] += P.d4[q][1] * w;
        r[8] += P.d4[q][2] * w;
        r[9] += P.d4[q][3] * w;
      } else {
        r[5] += P.d4[q][3] * w;
      }
    }
    any = true;
  }
  return any;
}

// One step of reduce_terms: keep the low or the high half of in[] (by
// whether this lane's bit `off` is set) plus the partner's same half.
template <int N, int H>
__device__ __forceinline__ void reduce_step(const float (&in)[N],
                                            float (&out)[H], bool hi,
                                            int off) {
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float lo = in[k];
    const float up = k + H < N ? in[k + H] : 0.0f;
    out[k] = (hi ? up : lo) +
             __shfl_xor_sync(0xffffffffu, hi ? lo : up, off);
  }
}

// Transposing reduction of v[NT] over the warp (the QUAD variants' 11 or
// 7 terms: 13 or 9 shuffles). Returns the warp's total of the term this
// lane holds (`term`, term_of_lane; -1 for none).
template <int NT>
__device__ __forceinline__ float reduce_terms(const float (&v)[NT],
                                              int lane, int& term) {
  constexpr int S1 = (NT + 1) / 2, S2 = (S1 + 1) / 2, S3 = (S2 + 1) / 2;
  constexpr int S4 = (S3 + 1) / 2, S5 = (S4 + 1) / 2;
  static_assert(NT <= 32 && S5 == 1, "");
  float a[S1], b[S2], c[S3], d[S4], e[S5];
  reduce_step(v, a, lane & 16, 16);
  reduce_step(a, b, lane & 8, 8);
  reduce_step(b, c, lane & 4, 4);
  reduce_step(c, d, lane & 2, 2);
  reduce_step(d, e, lane & 1, 1);
  term = term_of_lane(NT, lane);
  return e[0];
}

// Under QUAD: the warp totals of survivor j's NT terms (reduce_terms; the
// six moments S0-S5 first) to its emitted channels. The lanes holding
// S0-S4 emit the geometry grads of u, v, conic a / b / c, contracted as
// JAX's `_replay_chunks` under quadform; S5's lane emits nothing; the
// other terms move down one channel. All lanes take part (shuffles).
template <int NT>
__device__ __forceinline__ float quad_contract(float val, int term,
                                               const float (*s_attr)[CHUNK],
                                               const float (*s_q)[CHUNK],
                                               int j, int& ch) {
  float S[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    S[k] = __shfl_sync(0xffffffffu, val, lane_of_term(NT, k));
  ch = term > 5 ? term - 1 : (term == 5 ? -1 : term);
  if (term < 0 || term > 4) return val;
  const float u = s_q[6][j], v = s_q[7][j];
  const float a = s_attr[2][j], b = s_attr[3][j], c = s_attr[4][j];
  const float su = S[3] - u * S[5];
  const float sv = S[4] - v * S[5];
  switch (term) {
    case 0:
      return a * su + b * sv;
    case 1:
      return c * sv + b * su;
    case 2:
      return -0.5f * (S[0] - 2.0f * u * S[3] + u * u * S[5]);
    case 3:
      return -(S[2] - u * S[4] - v * S[3] + u * v * S[5]);
    default:
      return -0.5f * (S[1] - 2.0f * v * S[4] + v * v * S[5]);
  }
}

// The box ballots of the staged chunk (jmax survivors) for this warp's
// patch: bit j % 32 of word j / 32 is set when survivor j's box meets it.
template <class PatchT>
__device__ __forceinline__ void patch_ballot(const PatchT& P,
                                             const float4* s_box, int jmax,
                                             int lane,
                                             unsigned (&wm)[MASK_WORDS]) {
#pragma unroll
  for (int k = 0; k < MASK_WORDS; ++k) {
    const int j = k * 32 + lane;
    wm[k] = __ballot_sync(0xffffffffu,
                          j < jmax && box_meets(s_box[j], P.bx0, P.bx1,
                                                P.by0, P.by1));
  }
}

// Walk the survivors of mask words hi down to lo back to front. Each warp
// total of the NC terms goes to emit(j, channel, value) on the lane that
// holds it. A survivor no lane contributed to leaves wm, so wm says which
// survivors the warp emitted.
template <int NC = NG, bool QUAD = false, int PPT, class Emit>
__device__ __forceinline__ void walk_words(
    Patch<PPT>& P, const float (*s_attr)[CHUNK], int lane,
    unsigned (&wm)[MASK_WORDS], int hi, int lo, Emit&& emit,
    const QuadBasis<PPT>& B = QuadBasis<PPT>{},
    const float (*s_q)[CHUNK] = nullptr) {
  constexpr int NT = QUAD ? NC + 1 : NC;
#pragma unroll
  for (int k = MASK_WORDS - 1; k >= 0; --k) {
    if (k > hi || k < lo) continue;
    for (unsigned m = wm[k]; m;) {
      const int bit = 31 - __clz(m);
      m &= ~(1u << bit);
      const int j = k * 32 + bit;
      float r[NT];
#pragma unroll
      for (int c = 0; c < NT; ++c) r[c] = 0.0f;
      const bool any = patch_step<NC, PPT, QUAD>(P, s_attr, j, r, B, s_q);
      if (__any_sync(0xffffffffu, any)) {
        int ch;
        float val;
        if constexpr (QUAD) {
          int term;
          val = reduce_terms<NT>(r, lane, term);
          val = quad_contract<NT>(val, term, s_attr, s_q, j, ch);
        } else if constexpr (NC == NG) {
          val = reduce10(r, lane, ch);
        } else {
          val = reduce6(r, lane, ch);
        }
        if (ch >= 0) emit(j, ch, val);
      } else {
        wm[k] &= ~(1u << bit);
      }
    }
  }
}

// Walk the whole staged chunk for this warp's patch: ballots, then every
// mask word back to front.
template <int NC = NG, bool QUAD = false, int PPT, class Emit>
__device__ __forceinline__ void walk_chunk(
    Patch<PPT>& P, const float (*s_attr)[CHUNK], const float4* s_box,
    int jmax, int lane, unsigned (&wm)[MASK_WORDS], Emit&& emit,
    const QuadBasis<PPT>& B = QuadBasis<PPT>{},
    const float (*s_q)[CHUNK] = nullptr) {
  patch_ballot(P, s_box, jmax, lane, wm);
  walk_words<NC, QUAD>(P, s_attr, lane, wm, MASK_WORDS - 1, 0, emit, B,
                       s_q);
}

// Lanes 0-3 store the warp's mask words.
__device__ __forceinline__ void store_mask(unsigned* s_wmask_warp, int lane,
                                           const unsigned (&wm)[MASK_WORDS]) {
#pragma unroll
  for (int k = 0; k < MASK_WORDS; ++k)
    if (lane == k) s_wmask_warp[k] = wm[k];
}

// The fixed-order total of channel c of survivor j over the NW warps'
// slots s_warp[w][c][j % SLOTS] (NC channels a warp) that their masks
// s_wmask[w][.] mark as written (SLOTS survivors a slot row: the chunk, or
// the part of it walked since the slots were last summed).
template <int NW, int SLOTS = CHUNK, int NC = NG>
__device__ __forceinline__ float slot_total(const float* s_warp,
                                            const unsigned* s_wmask, int c,
                                            int j) {
  float v = 0.0f;
#pragma unroll
  for (int w = 0; w < NW; ++w)
    if ((s_wmask[w * MASK_WORDS + (j >> 5)] >> (j & 31)) & 1u)
      v += s_warp[(w * NC + c) * SLOTS + j % SLOTS];
  return v;
}

// Composite the staged chunk (jmax survivors) over the lane's pixels front
// to back, walking only the survivors whose box meets the warp's patch.
// Under QUAD the alphas are quad_alpha's, from the lane's basis B and the
// chunk's coefficients s_q.
template <int PPT, bool QUAD = false>
__device__ __forceinline__ void fwd_walk_chunk(
    FwdPatch<PPT>& P, const float (*s_attr)[CHUNK], const float4* s_box,
    int jmax, int lane, const QuadBasis<PPT>& B = QuadBasis<PPT>{},
    const float (*s_q)[CHUNK] = nullptr) {
  unsigned wm[MASK_WORDS];
  patch_ballot(P, s_box, jmax, lane, wm);
#pragma unroll
  for (int k = 0; k < MASK_WORDS; ++k) {
    for (unsigned m = wm[k]; m; m &= m - 1) {
      const int j = k * 32 + __ffs(m) - 1;
      const float mu = s_attr[0][j], mv = s_attr[1][j];
      const float ca = s_attr[2][j], cb = s_attr[3][j], cc = s_attr[4][j];
      const float op = s_attr[5][j];
      const float f0 = s_attr[6][j], f1 = s_attr[7][j];
      const float f2 = s_attr[8][j], f3 = s_attr[9][j];
      float g[6];
      if constexpr (QUAD) {
#pragma unroll
        for (int c = 0; c < 6; ++c) g[c] = s_q[c][j];
      }
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        float du, dv, gg, alpha;
        if constexpr (QUAD) {
          if (!quad_alpha(B.lu2, B.lv2[q], B.luv[q], B.lu, B.lv[q], g, op,
                          gg, alpha))
            continue;
        } else {
          if (!twin_alpha(P.pu, P.pv[q], mu, mv, ca, cb, cc, op, du, dv, gg,
                          alpha))
            continue;
        }
        if (P.ex[q] == 0) {
          const float w = alpha * P.tm[q];
          P.acc[q][0] += w * f0;
          P.acc[q][1] += w * f1;
          P.acc[q][2] += w * f2;
          P.acc[q][3] += w * f3;
        }
        P.tm[q] *= 1.0f - alpha;
        if (P.tm[q] < 0x1p-64f) {
          P.tm[q] *= 0x1p64f;
          ++P.ex[q];
        }
      }
    }
  }
}

// Whether a pixel of the lane still has T > t_stop = exp(LOG_T_MIN): the
// tile goes on to its next chunk while one of its pixels does.
template <int PPT>
__device__ __forceinline__ int fwd_live(const FwdPatch<PPT>& P,
                                        float t_stop) {
  int live = 0;
#pragma unroll
  for (int q = 0; q < PPT; ++q) live |= P.ex[q] == 0 && P.tm[q] > t_stop;
  return live;
}

// The lane's pixels of the tile's (8, PX) output block o: rgb, depth,
// alpha = 1 - T, log T, chunks used (eff) and the survivor / entry count.
template <int TILE, int PPT>
__device__ __forceinline__ void fwd_store(const FwdPatch<PPT>& P, float* o,
                                          int x0, int y0, int lane, int eff,
                                          int count) {
  constexpr int px = TILE * TILE;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = (y0 + (lane >> 3) + 4 * q) * TILE + x0 + (lane & 7);
    o[0 * px + p] = P.acc[q][0];
    o[1 * px + p] = P.acc[q][1];
    o[2 * px + p] = P.acc[q][2];
    o[3 * px + p] = P.acc[q][3];
    o[4 * px + p] = 1.0f - (P.ex[q] == 0 ? P.tm[q] : 0.0f);
    o[5 * px + p] = logf(P.tm[q]) - (float)P.ex[q] * LN2_64;
    o[6 * px + p] = (float)eff;
    o[7 * px + p] = (float)count;
  }
}

}  // namespace eags
