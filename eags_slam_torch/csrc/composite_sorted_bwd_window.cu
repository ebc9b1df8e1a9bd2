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
// run in flight. What the window changes is the gradient traffic: K2
// stores every survivor's 10 totals into its table once per tile that sees
// it; here a column leaves the cluster once per run that holds it.
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
//  - Every sum is in a fixed order, as the TPU grid's in-order
//    read-modify-write was. The warp slots hold a quarter chunk (32
//    survivors, 5 KB a CTA): each quarter is walked and summed over the
//    CTA's warps in a fixed order into the CTA's totals (two buffers, used
//    in turn); after a cluster barrier the CTA that holds a survivor's
//    column adds the NC CTAs' totals in rank order and adds that into its
//    own ring slot, the ring's only writer. A ring column also keeps the
//    table slot (slot_table.cuh) of the last tile that added to it.
//  - Before each tile, behind a cluster barrier, a band whose aligned start
//    advances by d (0 < d <= seg_cap) retires the d columns that fall off
//    the back: each CTA stores the columns it holds that a tile added to
//    into K2's table, at the slot of that last tile, and zeroes them; a
//    second barrier orders that before the tile's adds. The tiles a
//    retirement sums are the run's that saw the column since it entered
//    the window, so no two retirements of one column, in this cluster or
//    another, share a last tile and a slot (a tile that tile_ids repeats
//    is replayed once, its copies' cotangents folded into the first copy:
//    slot_table.cuh fold_repeats). A backward jump (unsorted tile_ids, as
//    the tracker's score order gives) or an advance past seg_cap retires
//    the whole window.
//    After the run every window is flushed. K2's table_reduce then adds
//    each column's slots in slot order: with the wrapper's one tile a run
//    the grads do not depend on the order of tile_ids, and with any run
//    they are the same bits on every call.
//  - A survivor's totals go into the window of the first band whose current
//    window holds its column (one always does: a survivor of band b lies in
//    [al_b, al_b + seg_cap)); one that none held would be stored into the
//    table at its tile's slot. Band windows that overlap in sparse scenes
//    are no hazard: a column's windows retire into distinct slots.
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

#include "slot_table.cuh"
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

constexpr uint8_t NO_TILE = 0xff;  // a ring column no tile added to

// Store the window columns [base, base + n) of band b that this CTA holds
// (column % NC == rank; base is 128-aligned, n a multiple of 128) and that
// a tile added to into the table at that tile's slot (s_last), and zero
// them. All threads take part.
template <int NT, int NC>
__device__ __forceinline__ void retire(float* win, uint8_t* s_last, int b,
                                       int base, int n, int seg_cap,
                                       int rank, int64_t npad,
                                       float* __restrict__ slots,
                                       uint8_t* __restrict__ flags) {
  const int q = seg_cap / NC;
  for (int i = threadIdx.x; i < n / NC; i += NT) {
    const int col = base + rank + NC * i;
    const int r = (col % seg_cap) / NC;
    const int k = s_last[b * q + r];
    if (k == NO_TILE) continue;
    for (int c = 0; c < NG; ++c) {
      float* slot = win + ((int64_t)b * NG + c) * q + r;
      eags::table_store(slots, flags, npad, k, c, col, *slot);
      *slot = 0.0f;
    }
    s_last[b * q + r] = NO_TILE;
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
                  const float* __restrict__ merged,
                  const int* __restrict__ row_flag,
                  float* __restrict__ slots, uint8_t* __restrict__ flags) {
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
  __shared__ float s_tot[2][NG][SLOTS];        // the CTA's totals, in turn
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
  // [bands][seg_cap / NC]: the table slot of the last tile that added to
  // each ring column, after the rings (and QUAD's rows).
  uint8_t* s_last = reinterpret_cast<uint8_t*>(
      s_win + bands * NG * q + (QUAD ? eags::QROWS * CHUNK : 0));
  int pass = 0;

  for (int i = tid; i < bands * NG * q; i += NT) s_win[i] = 0.0f;
  for (int i = tid; i < bands * q; i += NT) s_last[i] = NO_TILE;
  if (tid < bands) {
    const int tc0 = tile_ids[s0];
    s_base[tid] = (seg_start[tc0 * bands + tid] / CHUNK) * CHUNK;
  }

  for (int s = s0; s < s1; ++s) {
    // A later copy of a tile: its cotangent is in the first copy's merged
    // row (the same for every CTA of the cluster).
    const int fold = row_flag[s];
    if (fold == 0) continue;
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
        retire<NT, NC>(s_win, s_last, b, base,
                       (d < 0 || d > seg_cap) ? seg_cap : d, seg_cap, rank,
                       npad, slots, flags);
    }
    __syncthreads();
    if (tid < bands) s_base[tid] = s_next[tid];
    cluster.sync();

    // 2. K2's replay of this CTA's region, the totals into the windows.
    const float tx0 = (float)((tc % tiles_x) * TILE);
    const float ty0 = (float)((tc / tiles_x) * TILE);
    const float* o = out + (int64_t)s * OUT_CH * px;
    const float* g = (fold == 2 ? merged : dout) + (int64_t)s * OUT_CH * px;
    const int eff = (int)o[6 * px];
    const int n_surv = (int)o[7 * px];
    const int k = eags::table_slot(tc, tiles_x, bands);
    const int x0 = (rank % NCX) * R::W + (warp % NWX) * 8;
    const int y0 = (rank / NCX) * R::H + (warp / NWX) * PATCH_H;
    eags::Patch<PPT> P;
    eags::patch_init<TILE, PPT>(P, o, g, tx0, ty0, x0, y0, lane);
    eags::QuadBasis<PPT> B;
    if constexpr (QUAD) eags::quad_basis_init(B, x0, y0, lane);

    for (int ci = eff - 1; ci >= 0; --ci) {
      const int cbase = ci * CHUNK;
      const int jmax = min(CHUNK, n_surv - cbase);
      __syncthreads();  // the last pass's reads of s_col / s_slot are done
      if (tid < jmax) {
        const int col = cols[(int64_t)s * capt + cbase + tid];
        eags::stage<QUAD, BF16>(s_attr, s_box, tid, attrs, npad, col, s_q,
                                tx0, ty0, (float)TILE);
        int slot = -1;  // b * q + ring slot of the first band holding col
        for (int b = 0; b < bands && slot < 0; ++b) {
          const int lo = s_base[b];
          if (col >= lo && col < lo + seg_cap)
            slot = b * q + (col % seg_cap) / NC;
        }
        s_col[tid] = col;
        s_slot[tid] = slot;
      }
      __syncthreads();

      unsigned wm[MASK_WORDS];
      eags::patch_ballot(P, s_box, jmax, lane, wm);
      for (int hi = MASK_WORDS - 1; hi >= 0; hi -= WORDS, ++pass) {
        const int lo = hi - WORDS + 1;
        eags::walk_words<NG, QUAD>(
            P, s_attr, lane, wm, hi, lo,
            [&](int j, int ch, float v) {
              s_warp[(warp * NG + ch) * SLOTS + j % SLOTS] = v;
            },
            B, s_q);
        eags::store_mask(s_wmask[warp], lane, wm);
        __syncthreads();
        float(*tot)[SLOTS] = s_tot[pass & 1];
        for (int i = tid; i < NG * SLOTS; i += NT)
          tot[i / SLOTS][i % SLOTS] = eags::slot_total<NWARPS, SLOTS>(
              s_warp, &s_wmask[0][0], i / SLOTS, lo * 32 + i % SLOTS);
        // The other buffer's last readers finished before this barrier.
        cluster.sync();
        // The CTA holding a survivor's column adds the cluster's totals in
        // rank order into its ring slot. Survivors of one tile have
        // distinct columns, so each (slot, c) has one writer.
        for (int i = tid; i < NG * SLOTS; i += NT) {
          const int c = i / SLOTS;
          const int jj = i % SLOTS;
          const int j = lo * 32 + jj;
          if (j >= jmax || s_col[j] % NC != rank) continue;
          float v = 0.0f;
#pragma unroll
          for (int r = 0; r < NC; ++r)
            v += cluster.map_shared_rank(&tot[0][0], r)[c * SLOTS + jj];
          const int slot = s_slot[j];
          if (slot >= 0) {
            s_win[((slot / q) * NG + c) * q + slot % q] += v;
            if (c == 0) s_last[slot] = (uint8_t)k;
          } else {
            eags::table_store(slots, flags, npad, k, c, s_col[j], v);
          }
        }
      }
    }
  }

  // 3. Flush every window once every add is in (the barrier also keeps
  // every CTA until the others have read its totals).
  cluster.sync();
  for (int b = 0; b < bands; ++b)
    retire<NT, NC>(s_win, s_last, b, s_base[b], seg_cap, seg_cap, rank, npad,
                   slots, flags);
}

template <int TILE, bool FEW, bool QUAD, bool BF16>
int launch_variant(const void* attrs_v, int64_t npad, const int* seg_start,
                   int bands, int seg_cap, const int* tile_ids, int n_sel,
                   int run, int tiles_x, int capt, const float* out,
                   const int* cols, const float* dout, const float* merged,
                   const int* row_flag, float* slots, uint8_t* flags,
                   cudaStream_t st) {
  using R = Region<TILE, FEW>;
  constexpr int NC = (TILE / R::W) * (TILE / R::H);
  constexpr int NT = R::W * R::H / R::PPT;
  const auto* attrs = static_cast<const eags::AttrT<BF16>*>(attrs_v);
  const size_t smem = ((size_t)(NT / 32) * NG * SLOTS +
                       (size_t)bands * NG * (seg_cap / NC) +
                       (QUAD ? (size_t)eags::QROWS * CHUNK : 0)) *
                          sizeof(float) +
                      (size_t)bands * (seg_cap / NC);
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
                           n_sel, run, tiles_x, capt, out, cols, dout, merged,
                           row_flag, slots, flags);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The variant `opts` names: bit 0 QUAD, bit 1 BF16.
template <int TILE, bool FEW>
int launch(const void* attrs, int64_t npad, const int* seg_start, int bands,
           int seg_cap, const int* tile_ids, int n_sel, int run, int tiles_x,
           int capt, const float* out, const int* cols, const float* dout,
           const float* merged, const int* row_flag, float* slots,
           uint8_t* flags, int opts, cudaStream_t st) {
  switch (opts) {
    case 0:
      return launch_variant<TILE, FEW, false, false>(
          attrs, npad, seg_start, bands, seg_cap, tile_ids, n_sel, run,
          tiles_x, capt, out, cols, dout, merged, row_flag, slots, flags,
          st);
    case 1:
      return launch_variant<TILE, FEW, true, false>(
          attrs, npad, seg_start, bands, seg_cap, tile_ids, n_sel, run,
          tiles_x, capt, out, cols, dout, merged, row_flag, slots, flags,
          st);
    case 2:
      return launch_variant<TILE, FEW, false, true>(
          attrs, npad, seg_start, bands, seg_cap, tile_ids, n_sel, run,
          tiles_x, capt, out, cols, dout, merged, row_flag, slots, flags,
          st);
    case 3:
      return launch_variant<TILE, FEW, true, true>(
          attrs, npad, seg_start, bands, seg_cap, tile_ids, n_sel, run,
          tiles_x, capt, out, cols, dout, merged, row_flag, slots, flags,
          st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch_tile(const void* attrs, int64_t npad, const int* seg_start,
                int bands, int seg_cap, const int* tile_ids, int n_sel,
                int run, int tile, int tiles_x, int capt, const float* out,
                const int* cols, const float* dout, const float* merged,
                const int* row_flag, float* slots, uint8_t* flags, int opts,
                cudaStream_t st) {
  switch (tile) {
    case 16:
      return launch<16, true>(attrs, npad, seg_start, bands, seg_cap,
                              tile_ids, n_sel, run, tiles_x, capt, out, cols,
                              dout, merged, row_flag, slots, flags, opts, st);
    case 32:
      if (n_sel <= eags::sm_count())
        return launch<32, true>(attrs, npad, seg_start, bands, seg_cap,
                                tile_ids, n_sel, run, tiles_x, capt, out,
                                cols, dout, merged, row_flag, slots, flags,
                                opts, st);
      return launch<32, false>(attrs, npad, seg_start, bands, seg_cap,
                               tile_ids, n_sel, run, tiles_x, capt, out, cols,
                               dout, merged, row_flag, slots, flags, opts, st);
    case 64:
      return launch<64, true>(attrs, npad, seg_start, bands, seg_cap,
                              tile_ids, n_sel, run, tiles_x, capt, out, cols,
                              dout, merged, row_flag, slots, flags, opts, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// `group` is the run: the tiles one cluster replays (the wrapper's
// window_run). `merged`, `row_flag`, `slots`, `flags` and `grads` as K2's
// (eags_composite_sorted_bwd): the flags are cleared, repeated tiles
// folded, the kernel stores into the table and table_reduce sums it, all
// on `stream`.
extern "C" int eags_composite_sorted_bwd_window(
    const void* attrs, int64_t npad, const int* seg_start, int bands,
    int seg_cap, const int* tile_ids, int n_sel, int group, int tile,
    int tiles_x, int capt, const float* out, const int* cols,
    const float* dout, float* merged, int* row_flag, float* slots,
    uint8_t* flags, float* grads, int opts, void* stream) {
  if (bands > MAX_BANDS || group < 1 || seg_cap % CHUNK != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nslots = bands * bands;
  int err = eags::table_clear(flags, nslots, npad, st);
  if (err) return err;
  if (n_sel > 0) {
    err = eags::fold_repeats(tile_ids, n_sel, (int64_t)OUT_CH * tile * tile,
                             dout, merged, row_flag, st);
    if (err) return err;
    err = launch_tile(attrs, npad, seg_start, bands, seg_cap, tile_ids,
                      n_sel, group, tile, tiles_x, capt, out, cols, dout,
                      merged, row_flag, slots, flags, opts, st);
    if (err) return err;
  }
  return eags::table_reduce(slots, flags, nslots, npad, grads, st);
}
