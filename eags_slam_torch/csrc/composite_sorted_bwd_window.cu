// K3: backward of the centre-tile-sorted compositing with a per-band
// accumulation window (`rmw_window`), for Hopper.
//
// Replaces eags_slam_tpu/ops/rasterizer_pallas_v2.py::_bwd_kernel with
// window=True, whose accumulation is _bwd_rmw_window (built by _make_bwd,
// called from _composite_sorted_bwd). It computes K2's gradients
// (composite_sorted_bwd.cu) with another accumulation, so its plain version
// is K2's twin, composite_sorted_bwd_plain in
// eags_slam_torch/ops/composite_sorted.py.
//
// What bounds it on the card: the replay, as in K2 (~40 FP32 operations
// and two transcendentals per contributing (pixel, survivor) pair). What
// the window changes is the gradient traffic: K2 adds every survivor's 10
// totals into the (16, Npad) array with one global atomicAdd each, once
// per tile that sees it (up to bands x bands = 9 tiles); here a column is
// added once per block that holds it.
//
// Design, and how it answers the TPU version:
//  - One thread block takes a run of `group` consecutive entries of
//    tile_ids and replays them one after another with K2's replay
//    (replay.cuh): 256 threads, PX / 256 pixels a thread in registers,
//    survivors back to front, per-survivor sums by warp shuffles and
//    shared-memory atomics.
//  - Per band b the block keeps an accumulation window over the seg_cap
//    columns from the current tile's 128-aligned band start al_b, rows 0-9,
//    in dynamic shared memory (10 x bands x seg_cap floats: 120 KB at
//    3 x 1024, above the 48 KB static limit, hence
//    cudaFuncSetAttribute). Column c lives in ring slot c mod seg_cap, so
//    moving the window needs no shift (the TPU shifted its VMEM window and
//    kept a second, zero half for it: 2 x seg_cap lanes, which would not
//    fit here).
//  - Before each tile, a band whose aligned start advances by d
//    (0 < d <= seg_cap) retires the d columns that fall off the back: each
//    nonzero value goes to the global array with one atomicAdd and its
//    slot is zeroed, ready for the columns entering at the front. A
//    backward jump (unsorted tile_ids, as the tracker's score order gives)
//    or an advance past seg_cap retires the whole window. A repeated tile
//    (d = 0) keeps the window. After the run every window is flushed.
//  - Each survivor's tile totals are added into the window of the first
//    band whose current window holds its column (one always does: a
//    survivor of band b lies in [al_b, al_b + seg_cap)). Band windows that
//    overlap in sparse scenes are no hazard: windows only meet in the
//    global array, through atomics.
//  - So an interior column leaves the block once, not once per survivor
//    per tile as in K2. Neighbouring runs still overlap and add into the
//    same columns: atomicAdd, so the last bits vary from run to run.
//  - Built with -fmad=false like K1 / K2.
#include <cuda_runtime.h>
#include <stdint.h>

#include "replay.cuh"

namespace {

using eags::CHUNK;
using eags::NTHREADS;
using eags::OUT_CH;
constexpr int NG = 10;
constexpr int MAX_BANDS = 8;

// Move the nonzero sums of window columns [base, base + n) of band b to the
// global array and zero their slots. All threads take part.
__device__ __forceinline__ void retire(float* win, int b, int base, int n,
                                       int seg_cap, int64_t npad,
                                       float* __restrict__ grads) {
  for (int i = threadIdx.x; i < NG * n; i += NTHREADS) {
    const int c = i / n;
    const int col = base + i % n;
    float* slot = win + ((int64_t)b * NG + c) * seg_cap + col % seg_cap;
    const float v = *slot;
    if (v != 0.0f) {
      atomicAdd(&grads[c * npad + col], v);
      *slot = 0.0f;
    }
  }
}

template <int PPT>
__global__ void __launch_bounds__(NTHREADS)
bwd_window_kernel(const float* __restrict__ attrs, int64_t npad,
                  const int* __restrict__ seg_start, int bands, int seg_cap,
                  const int* __restrict__ tile_ids, int n_sel, int group,
                  int tile, int tiles_x, int capt,
                  const float* __restrict__ out, const int* __restrict__ cols,
                  const float* __restrict__ dout,
                  float* __restrict__ grads) {
  extern __shared__ float s_win[];  // [bands][NG][seg_cap], ring per band
  __shared__ float s_attr[10][CHUNK];
  __shared__ float s_red[NG][CHUNK];
  __shared__ int s_col[CHUNK];
  __shared__ int s_slot[CHUNK];
  __shared__ int s_base[MAX_BANDS];
  __shared__ int s_next[MAX_BANDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int px = tile * tile;
  const int s0 = blockIdx.x * group;
  const int s1 = min(s0 + group, n_sel);

  for (int i = tid; i < bands * NG * seg_cap; i += NTHREADS) s_win[i] = 0.0f;
  if (tid < bands) {
    const int tc0 = tile_ids[s0];
    s_base[tid] = (seg_start[tc0 * bands + tid] / CHUNK) * CHUNK;
  }
  __syncthreads();

  for (int s = s0; s < s1; ++s) {
    const int tc = tile_ids[s];
    // 1. Move each band's window to this tile's aligned band start.
    if (tid < bands)
      s_next[tid] = (seg_start[tc * bands + tid] / CHUNK) * CHUNK;
    __syncthreads();
    for (int b = 0; b < bands; ++b) {
      const int base = s_base[b];
      const int d = s_next[b] - base;
      if (d != 0)
        retire(s_win, b, base, (d < 0 || d > seg_cap) ? seg_cap : d, seg_cap,
               npad, grads);
    }
    __syncthreads();
    if (tid < bands) s_base[tid] = s_next[tid];

    // 2. K2's replay of this tile, its totals into the windows.
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
      const int cbase = ci * CHUNK;
      const int jmax = min(CHUNK, n_surv - cbase);
      __syncthreads();
      for (int i = tid; i < CHUNK; i += NTHREADS) {
        const int col = i < jmax ? cols[(int64_t)s * capt + cbase + i] : 0;
        int slot = -1;
        for (int b = 0; b < bands && slot < 0; ++b) {
          const int lo = s_base[b];
          if (col >= lo && col < lo + seg_cap)
            slot = b * NG * seg_cap + col % seg_cap;
        }
        s_col[i] = col;
        s_slot[i] = slot;
      }
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
          if (!eags::replay_step(pu[q], pv[q], mu, mv, ca, cb, cc, op, f0,
                                 f1, f2, f3, d4[q], dA[q], log_after[q],
                                 bsum[q], e))
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
      // Survivors of one tile have distinct columns, so no two (c, j) of
      // this pass share a window slot.
      for (int i = tid; i < NG * CHUNK; i += NTHREADS) {
        const int c = i / CHUNK;
        const int j = i % CHUNK;
        if (j < jmax) {
          const float v = s_red[c][j];
          if (v != 0.0f) {
            const int slot = s_slot[j];
            if (slot >= 0)
              s_win[slot + c * seg_cap] += v;
            else
              atomicAdd(&grads[c * npad + s_col[j]], v);
          }
        }
      }
    }
    __syncthreads();
  }

  // 3. Flush every window.
  for (int b = 0; b < bands; ++b)
    retire(s_win, b, s_base[b], seg_cap, seg_cap, npad, grads);
}

template <int PPT>
int launch(const float* attrs, int64_t npad, const int* seg_start, int bands,
           int seg_cap, const int* tile_ids, int n_sel, int group, int tile,
           int tiles_x, int capt, const float* out, const int* cols,
           const float* dout, float* grads, cudaStream_t st) {
  const size_t smem = (size_t)bands * NG * seg_cap * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_window_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_sel + group - 1) / group;
  bwd_window_kernel<PPT><<<blocks, NTHREADS, smem, st>>>(
      attrs, npad, seg_start, bands, seg_cap, tile_ids, n_sel, group, tile,
      tiles_x, capt, out, cols, dout, grads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int eags_composite_sorted_bwd_window(
    const float* attrs, int64_t npad, const int* seg_start, int bands,
    int seg_cap, const int* tile_ids, int n_sel, int group, int tile,
    int tiles_x, int capt, const float* out, const int* cols,
    const float* dout, float* grads, void* stream) {
  if (bands > MAX_BANDS || group < 1 || seg_cap % CHUNK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 16:
      return launch<1>(attrs, npad, seg_start, bands, seg_cap, tile_ids,
                       n_sel, group, tile, tiles_x, capt, out, cols, dout,
                       grads, st);
    case 32:
      return launch<4>(attrs, npad, seg_start, bands, seg_cap, tile_ids,
                       n_sel, group, tile, tiles_x, capt, out, cols, dout,
                       grads, st);
    case 64:
      return launch<16>(attrs, npad, seg_start, bands, seg_cap, tile_ids,
                        n_sel, group, tile, tiles_x, capt, out, cols, dout,
                        grads, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
