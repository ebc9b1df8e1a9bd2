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
// What bounds it on the card: the replay, as in K2 (FP32 / SFU throughput
// on the (pixel, survivor) pairs inside the survivors' alpha boxes), and
// how many warps an SM can hold beside the window: the band rings take
// 10 x bands x seg_cap floats (120 KB at 3 x 1024) of shared memory per
// run in flight. What the window changes is the gradient traffic: K2 adds
// every survivor's 10 totals into the (16, Npad) array with one global
// atomicAdd each, once per quadrant of every tile that sees it; here a
// column leaves the cluster once per run that holds it.
//
// Design, and how it answers the TPU version:
//  - A thread-block cluster takes a run of consecutive entries of tile_ids
//    and replays them one after another. Its NC CTAs of 128 threads split
//    each tile into regions (at tile 32: K2's four 16 x 16 quadrants, two
//    pixels a thread, when the grid has more tiles than the card has SMs;
//    eight 16 x 8 regions of one pixel a thread when it has no more, as the
//    tracker's subset) and run K2's inner loop on them (warp_patch.cuh):
//    compact warp patches, one alpha box per survivor when the chunk is
//    staged, one ballot per 32 survivors, twin_alpha decisions and FMA
//    elsewhere, T linear from K1's log T, reduce10 into per-warp slots.
//  - The band rings live in the cluster's distributed shared memory: per
//    band b a window over the seg_cap columns from the current tile's
//    128-aligned band start al_b, column c in ring slot c mod seg_cap,
//    held by CTA c mod NC (30 KB a CTA at 3 x 1024 in quadrants). A whole
//    ring in one block left room for one block of 16 warps an SM; split,
//    an SM holds five quadrant CTAs (20 warps). The TPU shifted its VMEM
//    window and kept a second, zero half for it; the ring needs no shift.
//  - The warp slots hold a quarter chunk (32 survivors, 5 KB a CTA): each
//    quarter is walked, summed over the CTA's warps in a fixed order and
//    added to the owner CTA's ring slot through distributed shared memory
//    (atomicAdd: the cluster's CTAs add to the same slots).
//  - Before each tile, behind a cluster barrier, a band whose aligned start
//    advances by d (0 < d <= seg_cap) retires the d columns that fall off
//    the back: each CTA moves the nonzero values of the columns it holds
//    to the global array with one atomicAdd each and zeroes their slots; a
//    second barrier orders that before the tile's adds. A backward jump
//    (unsorted tile_ids, as the tracker's score order gives) or an advance
//    past seg_cap retires the whole window; a repeated tile (d = 0) keeps
//    it. After the run every window is flushed.
//  - A survivor's totals go into the window of the first band whose current
//    window holds its column (one always does: a survivor of band b lies in
//    [al_b, al_b + seg_cap)). Band windows that overlap in sparse scenes
//    are no hazard: windows only meet in the global array, through atomics.
//    Neighbouring runs add into the same columns: atomicAdd, so the last
//    bits vary from run to run.
//  - The run is at most `group` tiles; the wrapper (window_run) takes one
//    tile a cluster, since longer runs measured slower (PERF.md).
//  - The JAX options kernel_quadform and kernel_bf16 (which the TPU's
//    windowed backward takes as K2 does) are the variants <QUAD, BF16>
//    (`opts` bits 0 and 1): K2's staging and replay variants
//    (warp_patch.cuh), the quadform coefficients in 4 KB more of the
//    dynamic shared memory, after the rings.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_patch.cuh"

namespace cg = cooperative_groups;

namespace {

using eags::CHUNK;
using eags::MASK_WORDS;
using eags::NG;
using eags::OUT_CH;
constexpr int MAX_BANDS = 8;
constexpr int SLOTS = 32;  // survivors a slot row holds: a quarter chunk

// The region of a tile that one CTA of the cluster takes, and its pixels a
// thread: 128 threads a CTA. At tile 32, K2's quadrants of two pixels a
// thread when the grid has more tiles than the card has SMs, eighths of
// one when it has no more (the tracker's subset: twice the CTAs a tile).
template <int TILE, bool FEW>
struct Region;
template <bool FEW>
struct Region<16, FEW> {
  static constexpr int W = 16, H = 8, PPT = 1;
};
template <>
struct Region<32, false> {
  static constexpr int W = 16, H = 16, PPT = 2;
};
template <>
struct Region<32, true> {
  static constexpr int W = 16, H = 8, PPT = 1;
};
template <bool FEW>
struct Region<64, FEW> {
  static constexpr int W = 32, H = 16, PPT = 4;
};

// Move the nonzero sums of window columns [base, base + n) of band b that
// this CTA holds (column % NC == rank; base is 128-aligned, n a multiple of
// 128) to the global array and zero their slots. All threads take part.
template <int NT, int NC>
__device__ __forceinline__ void retire(float* win, int b, int base, int n,
                                       int seg_cap, int rank, int64_t npad,
                                       float* __restrict__ grads) {
  const int q = seg_cap / NC;
  const int nk = n / NC;
  for (int i = threadIdx.x; i < NG * nk; i += NT) {
    const int c = i / nk;
    const int col = base + rank + NC * (i % nk);
    float* slot = win + ((int64_t)b * NG + c) * q + (col % seg_cap) / NC;
    const float v = *slot;
    if (v != 0.0f) {
      atomicAdd(&grads[c * npad + col], v);
      *slot = 0.0f;
    }
  }
}

template <int TILE, bool FEW, bool QUAD, bool BF16>
__global__ void __launch_bounds__(Region<TILE, FEW>::W * Region<TILE, FEW>::H /
                                  Region<TILE, FEW>::PPT)
bwd_window_kernel(const eags::AttrT<BF16>* __restrict__ attrs, int64_t npad,
                  const int* __restrict__ seg_start, int bands, int seg_cap,
                  const int* __restrict__ tile_ids, int n_sel, int run,
                  int tiles_x, int capt, const float* __restrict__ out,
                  const int* __restrict__ cols,
                  const float* __restrict__ dout,
                  float* __restrict__ grads) {
  using R = Region<TILE, FEW>;
  constexpr int PPT = R::PPT;
  constexpr int NCX = TILE / R::W;
  constexpr int NC = NCX * (TILE / R::H);
  constexpr int NT = R::W * R::H / PPT;
  constexpr int NWARPS = NT / 32;
  constexpr int PATCH_H = 4 * PPT;
  constexpr int NWX = R::W / 8;
  constexpr int WORDS = SLOTS / 32;
  constexpr int px = TILE * TILE;
  static_assert(NWX * (R::H / PATCH_H) == NWARPS && NT >= CHUNK, "");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float s_dyn[];
  float* s_warp = s_dyn;                       // [NWARPS][NG][SLOTS]
  float* s_win = s_dyn + NWARPS * NG * SLOTS;  // [bands][NG][seg_cap / NC]
  __shared__ float s_attr[10][CHUNK];
  __shared__ float4 s_box[CHUNK];
  __shared__ int s_col[CHUNK];
  __shared__ int s_slot[CHUNK];
  __shared__ unsigned s_wmask[NWARPS][MASK_WORDS];
  __shared__ int s_base[MAX_BANDS];
  __shared__ int s_next[MAX_BANDS];

  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q = seg_cap / NC;
  const int s0 = blockIdx.y * run;
  const int s1 = min(s0 + run, n_sel);
  // QUAD: [QROWS][CHUNK] after the rings, the staged survivors'
  // coefficients and means.
  float (*s_q)[CHUNK] =
      reinterpret_cast<float (*)[CHUNK]>(s_win + bands * NG * q);

  for (int i = tid; i < bands * NG * q; i += NT) s_win[i] = 0.0f;
  if (tid < bands) {
    const int tc0 = tile_ids[s0];
    s_base[tid] = (seg_start[tc0 * bands + tid] / CHUNK) * CHUNK;
  }

  for (int s = s0; s < s1; ++s) {
    const int tc = tile_ids[s];
    // 1. Move each band's window to this tile's aligned band start, once
    // every CTA's adds of the last tile (and its zeroing) are in.
    if (tid < bands)
      s_next[tid] = (seg_start[tc * bands + tid] / CHUNK) * CHUNK;
    cluster.sync();
    for (int b = 0; b < bands; ++b) {
      const int base = s_base[b];
      const int d = s_next[b] - base;
      if (d != 0)
        retire<NT, NC>(s_win, b, base, (d < 0 || d > seg_cap) ? seg_cap : d,
                       seg_cap, rank, npad, grads);
    }
    __syncthreads();
    if (tid < bands) s_base[tid] = s_next[tid];
    cluster.sync();

    // 2. K2's replay of this CTA's region, the totals into the windows.
    const float tx0 = (float)((tc % tiles_x) * TILE);
    const float ty0 = (float)((tc / tiles_x) * TILE);
    const float* o = out + (int64_t)s * OUT_CH * px;
    const float* g = dout + (int64_t)s * OUT_CH * px;
    const int eff = (int)o[6 * px];
    const int n_surv = (int)o[7 * px];
    const int x0 = (rank % NCX) * R::W + (warp % NWX) * 8;
    const int y0 = (rank / NCX) * R::H + (warp / NWX) * PATCH_H;
    eags::Patch<PPT> P;
    eags::patch_init<TILE, PPT>(P, o, g, tx0, ty0, x0, y0, lane);
    eags::QuadBasis<PPT> B;
    if constexpr (QUAD) eags::quad_basis_init(B, x0, y0, lane);

    // Every pass ends at a barrier, so staging needs none before it.
    for (int ci = eff - 1; ci >= 0; --ci) {
      const int cbase = ci * CHUNK;
      const int jmax = min(CHUNK, n_surv - cbase);
      if (tid < jmax) {
        const int col = cols[(int64_t)s * capt + cbase + tid];
        eags::stage<QUAD, BF16>(s_attr, s_box, tid, attrs, npad, col, s_q,
                                tx0, ty0, (float)TILE);
        int slot = -1;
        for (int b = 0; b < bands && slot < 0; ++b) {
          const int lo = s_base[b];
          if (col >= lo && col < lo + seg_cap)
            slot = b * NG * q + (col % seg_cap) / NC;
        }
        s_col[tid] = col;
        s_slot[tid] = slot;
      }
      __syncthreads();

      unsigned wm[MASK_WORDS];
      eags::patch_ballot(P, s_box, jmax, lane, wm);
      for (int hi = MASK_WORDS - 1; hi >= 0; hi -= WORDS) {
        const int lo = hi - WORDS + 1;
        eags::walk_words<NG, QUAD>(
            P, s_attr, lane, wm, hi, lo,
            [&](int j, int ch, float v) {
              s_warp[(warp * NG + ch) * SLOTS + j % SLOTS] = v;
            },
            B, s_q);
        eags::store_mask(s_wmask[warp], lane, wm);
        __syncthreads();
        // Survivors of one tile have distinct columns, so no two (c, j) of
        // this pass share a window slot; the cluster's CTAs do share them.
        for (int i = tid; i < NG * SLOTS; i += NT) {
          const int c = i / SLOTS;
          const int j = lo * 32 + i % SLOTS;
          const float v =
              eags::slot_total<NWARPS, SLOTS>(s_warp, &s_wmask[0][0], c, j);
          if (v != 0.0f) {
            const int slot = s_slot[j];
            if (slot >= 0)
              atomicAdd(cluster.map_shared_rank(s_win, s_col[j] % NC) +
                            slot + c * q,
                        v);
            else
              atomicAdd(&grads[c * npad + s_col[j]], v);
          }
        }
        __syncthreads();
      }
    }
  }

  // 3. Flush every window once every add is in.
  cluster.sync();
  for (int b = 0; b < bands; ++b)
    retire<NT, NC>(s_win, b, s_base[b], seg_cap, seg_cap, rank, npad, grads);
}

template <int TILE, bool FEW, bool QUAD, bool BF16>
int launch_variant(const void* attrs_v, int64_t npad, const int* seg_start,
                   int bands, int seg_cap, const int* tile_ids, int n_sel,
                   int run, int tiles_x, int capt, const float* out,
                   const int* cols, const float* dout, float* grads,
                   cudaStream_t st) {
  using R = Region<TILE, FEW>;
  constexpr int NC = (TILE / R::W) * (TILE / R::H);
  constexpr int NT = R::W * R::H / R::PPT;
  const auto* attrs = static_cast<const eags::AttrT<BF16>*>(attrs_v);
  const size_t smem = ((size_t)(NT / 32) * NG * SLOTS +
                       (size_t)bands * NG * (seg_cap / NC) +
                       (QUAD ? (size_t)eags::QROWS * CHUNK : 0)) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_window_kernel<TILE, FEW, QUAD, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NC, (n_sel + run - 1) / run);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bwd_window_kernel<TILE, FEW, QUAD, BF16>,
                           attrs, npad, seg_start, bands, seg_cap, tile_ids,
                           n_sel, run, tiles_x, capt, out, cols, dout, grads);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The variant `opts` names: bit 0 QUAD, bit 1 BF16.
template <int TILE, bool FEW>
int launch(const void* attrs, int64_t npad, const int* seg_start, int bands,
           int seg_cap, const int* tile_ids, int n_sel, int run, int tiles_x,
           int capt, const float* out, const int* cols, const float* dout,
           float* grads, int opts, cudaStream_t st) {
  switch (opts) {
    case 0:
      return launch_variant<TILE, FEW, false, false>(
          attrs, npad, seg_start, bands, seg_cap, tile_ids, n_sel, run,
          tiles_x, capt, out, cols, dout, grads, st);
    case 1:
      return launch_variant<TILE, FEW, true, false>(
          attrs, npad, seg_start, bands, seg_cap, tile_ids, n_sel, run,
          tiles_x, capt, out, cols, dout, grads, st);
    case 2:
      return launch_variant<TILE, FEW, false, true>(
          attrs, npad, seg_start, bands, seg_cap, tile_ids, n_sel, run,
          tiles_x, capt, out, cols, dout, grads, st);
    case 3:
      return launch_variant<TILE, FEW, true, true>(
          attrs, npad, seg_start, bands, seg_cap, tile_ids, n_sel, run,
          tiles_x, capt, out, cols, dout, grads, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// `group` is the run: the tiles one cluster replays (the wrapper's
// window_run).
extern "C" int eags_composite_sorted_bwd_window(
    const void* attrs, int64_t npad, const int* seg_start, int bands,
    int seg_cap, const int* tile_ids, int n_sel, int group, int tile,
    int tiles_x, int capt, const float* out, const int* cols,
    const float* dout, float* grads, int opts, void* stream) {
  if (bands > MAX_BANDS || group < 1 || seg_cap % CHUNK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 16:
      return launch<16, true>(attrs, npad, seg_start, bands, seg_cap,
                              tile_ids, n_sel, group, tiles_x, capt, out,
                              cols, dout, grads, opts, st);
    case 32:
      if (n_sel <= eags::sm_count())
        return launch<32, true>(attrs, npad, seg_start, bands, seg_cap,
                                tile_ids, n_sel, group, tiles_x, capt, out,
                                cols, dout, grads, opts, st);
      return launch<32, false>(attrs, npad, seg_start, bands, seg_cap,
                               tile_ids, n_sel, group, tiles_x, capt, out,
                               cols, dout, grads, opts, st);
    case 64:
      return launch<64, true>(attrs, npad, seg_start, bands, seg_cap,
                              tile_ids, n_sel, group, tiles_x, capt, out,
                              cols, dout, grads, opts, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
