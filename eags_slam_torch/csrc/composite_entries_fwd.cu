// K5: forward compositing of the entry-binned rasterizer (the `pallas`
// backend), for Hopper.
//
// Replaces eags_slam_tpu/ops/rasterizer_pallas.py::_fwd_kernel (built by
// _make_fwd, called from composite_entries). Same semantics as the plain
// twin composite_entries_fwd_plain in
// eags_slam_torch/ops/composite_entries.py (see its module docstring).
//
// What bounds it on the card: the entries arrive binned and depth-sorted,
// so the kernel only composites: one alpha box per entry of a processed
// chunk (~40 FP32 operations), ~10 to test each (pixel, entry) pair inside
// the box, and ~16 more with one exp when the alpha passes the 1/255 test.
// Its bytes are the 10 attr rows of the entries it reads (40 B an entry)
// and the (T, 8, PX) output. At the main path's shape the pairs dominate:
// it is bound by FP32 / SFU throughput.
//
// Design, and how it answers the TPU version: K1's compositing
// (composite_sorted_fwd.cu) on contiguous columns.
//  - One block per tile: the tile-wide stop (no pixel with log T > -11.5,
//    tested once per chunk with __syncthreads_or, as the TPU while_loop
//    condition) couples all of a tile's pixels. At tile 32 the block has
//    512 threads (two pixels a thread) when the grid has more tiles than
//    the card has SMs, else 1024 (one), as K1 and K6 choose.
//  - Tile t owns the entry columns [start[t], start[t] + count[t]) with
//    start[t] a multiple of 128, so chunk ci's entry j is column start[t] +
//    128 ci + j: one thread an entry stages the chunk's 10 attr rows with
//    coalesced loads, and its alpha box (alpha_box.cuh). Binning already
//    put each entry in the tiles its radius box covers, in depth order:
//    there is no coverage test and no ordering pass. The TPU double-
//    buffered the chunks into VMEM by DMA and took the transmittance prefix
//    as a triangular matmul.
//  - The chunk walk is warp_patch.cuh's, shared with K1: compact 8 x (4 *
//    PPT) warp patches, one ballot of the boxes per 32 entries, each warp
//    walks only the entries whose box meets its patch (the box never drops
//    a pair with nonzero alpha), alpha decisions rounded as the twin rounds
//    them (twin_alpha) with FMA elsewhere, linear T with the 2^64 rescale,
//    and log T written once at the end. K6 replays from that log T and the
//    chunks used (channels 5 and 6).
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_patch.cuh"

namespace {

using eags::CHUNK;
using eags::OUT_CH;

// Three 512-thread blocks (two pixels a thread) share an SM: registers are
// held to 40 a thread for them (left free, the compiler took 53 and fit
// two: 10% slower, PERF.md).
template <int TILE, int PPT>
__global__ void __launch_bounds__(TILE * TILE / PPT, PPT == 2 ? 3 : 1)
entries_fwd_kernel(const float* __restrict__ entries, int64_t epad,
                   const int* __restrict__ start,
                   const int* __restrict__ count, int tiles_x,
                   float* __restrict__ out) {
  constexpr int NT = TILE * TILE / PPT;
  constexpr int PATCH_H = 4 * PPT;
  constexpr int NWX = TILE / 8;
  static_assert(NT % 32 == 0 && NT >= CHUNK && TILE % PATCH_H == 0, "");
  __shared__ float s_attr[10][CHUNK];
  __shared__ float4 s_box[CHUNK];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t st = start[t];
  const int cnt = count[t];
  const float tx0 = (float)((t % tiles_x) * TILE);
  const float ty0 = (float)((t / tiles_x) * TILE);
  const int x0 = (warp % NWX) * 8;
  const int y0 = (warp / NWX) * PATCH_H;
  eags::FwdPatch<PPT> P;
  eags::fwd_patch_init(P, tx0, ty0, x0, y0, lane);
  const float t_stop = expf(eags::LOG_T_MIN);
  const int num_chunks = (cnt + CHUNK - 1) / CHUNK;
  int eff = 0;
  bool go = num_chunks > 0;
  while (go) {
    const int base = eff * CHUNK;
    const int jmax = min(CHUNK, cnt - base);
    __syncthreads();
    if (tid < jmax)
      eags::stage(s_attr, s_box, tid, entries, epad, st + base + tid);
    __syncthreads();
    eags::fwd_walk_chunk(P, s_attr, s_box, jmax, lane);
    ++eff;
    const int any_live = __syncthreads_or(eags::fwd_live(P, t_stop));
    go = (eff < num_chunks) && any_live;
  }
  eags::fwd_store<TILE, PPT>(P, out + (int64_t)t * OUT_CH * TILE * TILE, x0,
                             y0, lane, eff, cnt);
}

template <int TILE, int PPT>
int launch(const float* entries, int64_t epad, const int* start,
           const int* count, int num_tiles, int tiles_x, float* out,
           cudaStream_t st) {
  entries_fwd_kernel<TILE, PPT><<<num_tiles, TILE * TILE / PPT, 0, st>>>(
      entries, epad, start, count, tiles_x, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int eags_composite_entries_fwd(
    const float* entries, int64_t epad, const int* start, const int* count,
    int num_tiles, int tile, int tiles_x, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 16:
      return launch<16, 1>(entries, epad, start, count, num_tiles, tiles_x,
                           out, st);
    case 32:
      if (num_tiles <= eags::sm_count())
        return launch<32, 1>(entries, epad, start, count, num_tiles,
                             tiles_x, out, st);
      return launch<32, 2>(entries, epad, start, count, num_tiles, tiles_x,
                           out, st);
    case 64:
      return launch<64, 8>(entries, epad, start, count, num_tiles, tiles_x,
                           out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
