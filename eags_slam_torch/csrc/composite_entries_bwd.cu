// K6: backward of the entry-binned compositing (the `pallas` backend), for
// Hopper.
//
// Replaces eags_slam_tpu/ops/rasterizer_pallas.py::_bwd_kernel (built by
// _make_bwd, called from _composite_bwd, which also zeroes the columns the
// forward did not composite). Same semantics as the plain twin
// composite_entries_bwd_plain in eags_slam_torch/ops/composite_entries.py.
//
// What bounds it on the card: the replay recomputes alpha and
// transmittance for the (pixel, entry) pairs of the chunks K5 used that lie
// inside the entries' alpha boxes, and sums each entry's 10 per-pixel
// gradient terms over the tile's pixels: FP32 / SFU throughput. Its bytes
// are the entries' 10 attr rows, the forward's log T and counts, dout rows
// 0-4 and the 10 grad rows of the replayed columns.
//
// Design, and how it answers the TPU version:
//  - K2's inner loop (warp_patch.cuh) on contiguous columns: tile t owns
//    the entry columns [start[t], start[t] + count[t]), so chunk ci's entry
//    j is column start[t] + 128 ci + j. Compact warp patches, one alpha box
//    per entry when the chunk is staged, one ballot per 32 entries, the
//    alpha decision rounded as the twin rounds it (twin_alpha: K5 computes
//    that alpha operation for operation), FMA elsewhere, T linear from K5's
//    log T, reduce10 into per-warp slots. The chunks K5 used (its channel
//    6) are replayed in reverse and each chunk's entries back to front, so
//    the TPU's triangular suffix matmul becomes the running sum b.
//  - One block a tile with the slots in dynamic shared memory: at tile 32,
//    512 threads (16 warps of 8 x 8 pixels, 80 KB of slots, at most 64
//    registers a thread so that two blocks, 32 warps, share an SM) when the
//    grid has more tiles than the card has SMs, 1024 (32 warps of 8 x 4,
//    160 KB) when it has no more, as K1 chooses. Fewer, larger blocks cost
//    more at their barriers: one 512-thread block an SM took 2.0 ms on the
//    main-path entry layout, two 1.5 ms (PERF.md).
//  - The block adds the warps' slots of each (entry, channel) in a fixed
//    warp order and stores the total straight into (16, Epad): an entry
//    column belongs to exactly one tile's segment, so each column is
//    written once, there are no atomics, and two runs are equal bit for
//    bit. The wrapper zero-fills the grads, which leaves every column K5
//    did not composite (early-stopped chunks, alignment gaps, the padded
//    tail) at zero, as the TPU path's explicit mask did.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_patch.cuh"

namespace {

using eags::CHUNK;
using eags::MASK_WORDS;
using eags::NG;
using eags::OUT_CH;

// Two 512-thread blocks (two pixels a thread) share an SM: registers are
// held to 64 a thread for them.
template <int TILE, int PPT>
__global__ void __launch_bounds__(TILE * TILE / PPT, PPT == 2 ? 2 : 1)
entries_bwd_kernel(const float* __restrict__ entries, int64_t epad,
                   const int* __restrict__ start, int tiles_x,
                   const float* __restrict__ out,
                   const float* __restrict__ dout,
                   float* __restrict__ grads) {
  constexpr int NT = TILE * TILE / PPT;
  constexpr int NWARPS = NT / 32;
  constexpr int PATCH_H = 4 * PPT;
  constexpr int NWX = TILE / 8;
  constexpr int px = TILE * TILE;
  static_assert(NWX * (TILE / PATCH_H) == NWARPS && NT >= CHUNK, "");
  extern __shared__ float s_warp[];  // [NWARPS][NG][CHUNK]
  __shared__ float s_attr[10][CHUNK];
  __shared__ float4 s_box[CHUNK];
  __shared__ unsigned s_wmask[NWARPS][MASK_WORDS];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t st = start[t];
  const float tx0 = (float)((t % tiles_x) * TILE);
  const float ty0 = (float)((t / tiles_x) * TILE);
  const float* o = out + (int64_t)t * OUT_CH * px;
  const float* g = dout + (int64_t)t * OUT_CH * px;
  const int eff = (int)o[6 * px];
  const int cnt = (int)o[7 * px];

  eags::Patch<PPT> P;
  eags::patch_init<TILE, PPT>(P, o, g, tx0, ty0, (warp % NWX) * 8,
                              (warp / NWX) * PATCH_H, lane);

  // Two barriers a chunk: staging writes nothing the last chunk's sums
  // read, and the barrier before those sums came after every warp's walk.
  for (int ci = eff - 1; ci >= 0; --ci) {
    const int base = ci * CHUNK;
    const int jmax = min(CHUNK, cnt - base);
    if (tid < jmax)
      eags::stage(s_attr, s_box, tid, entries, epad, st + base + tid);
    __syncthreads();

    unsigned wm[MASK_WORDS];
    eags::walk_chunk(P, s_attr, s_box, jmax, lane, wm,
                     [&](int j, int ch, float v) {
                       s_warp[(warp * NG + ch) * CHUNK + j] = v;
                     });
    eags::store_mask(s_wmask[warp], lane, wm);
    __syncthreads();
    for (int i = tid; i < NG * CHUNK; i += NT) {
      const int c = i / CHUNK;
      const int j = i % CHUNK;
      if (j < jmax)
        grads[c * epad + st + base + j] =
            eags::slot_total<NWARPS>(s_warp, &s_wmask[0][0], c, j);
    }
  }
}

template <int TILE, int PPT>
int launch(const float* entries, int64_t epad, const int* start,
           int num_tiles, int tiles_x, const float* out, const float* dout,
           float* grads, cudaStream_t st) {
  constexpr int NT = TILE * TILE / PPT;
  constexpr size_t smem = (size_t)(NT / 32) * NG * CHUNK * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      entries_bwd_kernel<TILE, PPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  entries_bwd_kernel<TILE, PPT><<<num_tiles, NT, smem, st>>>(
      entries, epad, start, tiles_x, out, dout, grads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int eags_composite_entries_bwd(
    const float* entries, int64_t epad, const int* start, int num_tiles,
    int tile, int tiles_x, const float* out, const float* dout,
    float* grads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 16:
      return launch<16, 1>(entries, epad, start, num_tiles, tiles_x, out,
                           dout, grads, st);
    case 32:
      if (num_tiles <= eags::sm_count())
        return launch<32, 1>(entries, epad, start, num_tiles, tiles_x, out,
                             dout, grads, st);
      return launch<32, 2>(entries, epad, start, num_tiles, tiles_x, out,
                           dout, grads, st);
    case 64:
      return launch<64, 8>(entries, epad, start, num_tiles, tiles_x, out,
                           dout, grads, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
