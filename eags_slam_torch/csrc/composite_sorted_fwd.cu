// K1: forward compositing of the centre-tile-sorted rasterizer, for Hopper.
//
// Replaces eags_slam_tpu/ops/rasterizer_pallas_v2.py::_fwd_kernel (built by
// _make_fwd, called from composite_sorted / _composite_sorted_fwd). Same
// semantics as the plain twin composite_sorted_fwd_plain in
// eags_slam_torch/ops/composite_sorted.py (see its module docstring).
//
// What bounds it on the card: per tile, the candidate test reads 4 floats of
// up to bands * seg_cap columns (<= 48 KB at seg_cap 1024), and compositing
// is ~25 FP32 operations plus one exp per (pixel, survivor) pair -- at
// 1200x680, tile 32 and ~1000 survivors per tile that is ~2e10 flops, so the
// kernel is bound by FP32/SFU instruction throughput, not by memory traffic.
//
// Design, and how it answers the TPU version:
//  - One thread block per selected tile, 256 threads, each thread owning
//    PX/256 pixels in registers (tile 16/32/64 -> 1/4/16 pixels), so the
//    per-pixel transmittance and colour sums never leave registers.
//  - The TPU ranked candidates with all-pairs compares and gathered chunks
//    with one-hot matmuls (the MXU was the only fast path). Here the covered
//    candidates are compacted into shared memory with a shared counter and
//    ordered by a block-wide bitonic sort of their unique 32-bit keys, which
//    gives the same order as the TPU rank pass.
//  - The sorted survivor columns are written out (S, capt) for the backward
//    replay instead of the TPU's per-lane rank array.
//  - Chunks of 128 survivors are staged in shared memory; every thread walks
//    the chunk front to back for its pixels. The tile-wide stop
//    (no pixel with log T > -11.5) is checked once per chunk with
//    __syncthreads_or, exactly like the TPU while_loop condition; it is not
//    3DGS's per-pixel early exit.
//  - Built with -fmad=false so that the exponent and alpha rounding follow
//    the plain twin operation for operation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;
constexpr int NTHREADS = 256;
constexpr int MAX_CAPT = 4096;
constexpr int OUT_CH = 8;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float LOG_T_MIN = -11.5f;
constexpr int KEY_PAD = 0x7fffffff;

template <int PPT>
__global__ void __launch_bounds__(NTHREADS)
fwd_kernel(const float* __restrict__ attrs, int64_t npad,
           const int* __restrict__ seg_start, const int* __restrict__ seg_cnt,
           const int* __restrict__ tile_ids, int tile, int tiles_x,
           int bands, int seg_cap, float* __restrict__ out,
           int* __restrict__ cols_out) {
  __shared__ int s_key[MAX_CAPT];
  __shared__ int s_col[MAX_CAPT];
  __shared__ float s_attr[10][CHUNK];
  __shared__ int s_count;

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int tc = tile_ids[s];
  const int capt = bands * seg_cap;
  const int px = tile * tile;
  const float tx0 = (float)((tc % tiles_x) * tile);
  const float ty0 = (float)((tc / tiles_x) * tile);
  const float tx1 = tx0 + (float)tile;
  const float ty1 = ty0 + (float)tile;

  if (tid == 0) s_count = 0;
  __syncthreads();

  // 1. Candidates: exact coverage test, compact the survivors with keys.
  for (int b = 0; b < bands; ++b) {
    const int start = seg_start[tc * bands + b];
    const int al = (start / CHUNK) * CHUNK;
    const int lead = start - al;
    const int cnt = min(seg_cnt[tc * bands + b], seg_cap - lead);
    for (int i = tid; i < cnt; i += NTHREADS) {
      const int col = start + i;
      const float u = attrs[col];
      const float v = attrs[npad + col];
      const float d = attrs[9 * npad + col];
      const float r = attrs[10 * npad + col];
      const bool cover = (r > 0.0f) && (u + r > tx0) && (u - r < tx1) &&
                         (v + r > ty0) && (v - r < ty1);
      if (cover) {
        const int lane = b * seg_cap + lead + i;
        const int dbits = __float_as_int(fmaxf(d, 1e-6f));
        const int pos = atomicAdd(&s_count, 1);
        s_key[pos] = (dbits & ~4095) | lane;
        s_col[pos] = col;
      }
    }
  }
  __syncthreads();
  const int n_surv = s_count;

  // 2. Block bitonic sort of (key, col) over the next power of two.
  int n_sort = 1;
  while (n_sort < n_surv) n_sort <<= 1;
  for (int i = n_surv + tid; i < n_sort; i += NTHREADS) {
    s_key[i] = KEY_PAD;
    s_col[i] = 0;
  }
  __syncthreads();
  for (int k = 2; k <= n_sort; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n_sort; i += NTHREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          const int ki = s_key[i];
          const int kj = s_key[ixj];
          if ((ki > kj) == up) {
            s_key[i] = kj;
            s_key[ixj] = ki;
            const int c = s_col[i];
            s_col[i] = s_col[ixj];
            s_col[ixj] = c;
          }
        }
      }
      __syncthreads();
    }
  }

  // 3. Persist the depth-ordered survivor columns for the backward replay.
  for (int i = tid; i < n_surv; i += NTHREADS)
    cols_out[(int64_t)s * capt + i] = s_col[i];

  // 4. Front-to-back compositing in chunks of 128 survivors.
  float pu[PPT], pv[PPT], log_t[PPT], acc[PPT][4];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = tid + q * NTHREADS;
    pu[q] = tx0 + (float)(p % tile);
    pv[q] = ty0 + (float)(p / tile);
    log_t[q] = 0.0f;
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
  }
  const int num_chunks = (n_surv + CHUNK - 1) / CHUNK;
  int eff = 0;
  bool go = num_chunks > 0;
  while (go) {
    const int base = eff * CHUNK;
    const int jmax = min(CHUNK, n_surv - base);
    __syncthreads();
    for (int i = tid; i < 10 * CHUNK; i += NTHREADS) {
      const int ch = i / CHUNK;
      const int j = i % CHUNK;
      s_attr[ch][j] = j < jmax ? attrs[ch * npad + s_col[base + j]] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < jmax; ++j) {
      const float mu = s_attr[0][j], mv = s_attr[1][j];
      const float ca = s_attr[2][j], cb = s_attr[3][j], cc = s_attr[4][j];
      const float op = s_attr[5][j];
      const float f0 = s_attr[6][j], f1 = s_attr[7][j];
      const float f2 = s_attr[8][j], f3 = s_attr[9][j];
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        const float du = pu[q] - mu;
        const float dv = pv[q] - mv;
        const float power = -0.5f * (ca * du * du + cc * dv * dv) - cb * du * dv;
        if (power > 0.0f) continue;
        const float alpha = fminf(op * expf(power), ALPHA_MAX);
        if (alpha < ALPHA_MIN) continue;
        const float w = alpha * expf(log_t[q]);
        acc[q][0] += w * f0;
        acc[q][1] += w * f1;
        acc[q][2] += w * f2;
        acc[q][3] += w * f3;
        log_t[q] += log1pf(-alpha);
      }
    }
    ++eff;
    int live = 0;
#pragma unroll
    for (int q = 0; q < PPT; ++q) live |= log_t[q] > LOG_T_MIN;
    const int any_live = __syncthreads_or(live);
    go = (eff < num_chunks) && any_live;
  }

  // 5. Output block (8, PX).
  float* o = out + (int64_t)s * OUT_CH * px;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = tid + q * NTHREADS;
    o[0 * px + p] = acc[q][0];
    o[1 * px + p] = acc[q][1];
    o[2 * px + p] = acc[q][2];
    o[3 * px + p] = acc[q][3];
    o[4 * px + p] = 1.0f - expf(log_t[q]);
    o[5 * px + p] = log_t[q];
    o[6 * px + p] = (float)eff;
    o[7 * px + p] = (float)n_surv;
  }
}

}  // namespace

extern "C" int eags_composite_sorted_fwd(
    const float* attrs, int64_t npad, const int* seg_start,
    const int* seg_cnt, const int* tile_ids, int n_sel, int tile,
    int tiles_x, int bands, int seg_cap, float* out, int* cols,
    void* stream) {
  if (bands * seg_cap > MAX_CAPT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(n_sel), block(NTHREADS);
  switch (tile) {
    case 16:
      fwd_kernel<1><<<grid, block, 0, st>>>(attrs, npad, seg_start, seg_cnt,
                                            tile_ids, tile, tiles_x, bands,
                                            seg_cap, out, cols);
      break;
    case 32:
      fwd_kernel<4><<<grid, block, 0, st>>>(attrs, npad, seg_start, seg_cnt,
                                            tile_ids, tile, tiles_x, bands,
                                            seg_cap, out, cols);
      break;
    case 64:
      fwd_kernel<16><<<grid, block, 0, st>>>(attrs, npad, seg_start, seg_cnt,
                                             tile_ids, tile, tiles_x, bands,
                                             seg_cap, out, cols);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
