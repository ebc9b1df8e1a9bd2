// The reverse replay step of the pose-contraction backward K4
// (pose_grad_sorted.cu); K2, K3 and K6 replay on warp patches instead
// (warp_patch.cuh).
//
// K4 walks a tile's survivors back to front, each thread holding its
// pixels' state in registers: the transmittance after the survivor
// (log_after) and the running "behind" sum b of alpha T q over the
// survivors already replayed. For one (pixel, survivor) pair this step
// recomputes alpha exactly as the forward K1 did and, when the survivor
// contributed to the pixel, moves the state past it and returns the
// per-pixel terms the gradients are built from:
//   log T_before = log T_after - log(1 - alpha), T = exp(log T_before),
//   q = dout_rgbd . feat + dout_alpha,
//   d_alpha = T q - b / max(1 - alpha, 1e-6),   b += alpha T q.
// It mirrors eags_slam_tpu/ops/rasterizer_pallas_v2.py::_replay_chunks and
// the replay of rasterizer_pallas.py::_bwd_kernel, whose alphas both follow
// rasterizer_pallas.py::_chunk_alpha.
#pragma once

namespace eags {

constexpr int CHUNK = 128;
constexpr int NTHREADS = 256;
constexpr int OUT_CH = 8;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;

struct ReplayTerms {
  float du, dv;      // pixel centre minus the survivor's mean
  float gg;          // exp(power), also where alpha was clipped at 0.99
  float alpha;
  float w;           // alpha * T: the survivor's weight at the pixel
  float d_alpha;     // dL / d alpha
};

// Returns false (and leaves the state alone) when the survivor did not
// contribute to the pixel (power > 0 or alpha < 1/255).
__device__ __forceinline__ bool replay_step(
    float pu, float pv, float mu, float mv, float ca, float cb, float cc,
    float op, float f0, float f1, float f2, float f3, const float* d4,
    float dA, float& log_after, float& bsum, ReplayTerms& o) {
  const float du = pu - mu;
  const float dv = pv - mv;
  const float power = -0.5f * (ca * du * du + cc * dv * dv) - cb * du * dv;
  if (power > 0.0f) return false;
  const float gg = expf(power);
  const float alpha = fminf(op * gg, ALPHA_MAX);
  if (alpha < ALPHA_MIN) return false;
  const float log1m = log1pf(-alpha);
  const float log_before = log_after - log1m;
  const float T = expf(log_before);
  const float w = alpha * T;
  const float qv = d4[0] * f0 + d4[1] * f1 + d4[2] * f2 + d4[3] * f3 + dA;
  o.d_alpha = T * qv - bsum / fmaxf(1.0f - alpha, 1e-6f);
  bsum += w * qv;
  log_after = log_before;
  o.du = du;
  o.dv = dv;
  o.gg = gg;
  o.alpha = alpha;
  o.w = w;
  return true;
}

}  // namespace eags
