// K5: forward compositing of the entry-binned rasterizer (the `pallas`
// backend), for Hopper.
//
// Replaces eags_slam_tpu/ops/rasterizer_pallas.py::_fwd_kernel (built by
// _make_fwd, called from composite_entries). Same semantics as the plain
// twin composite_entries_fwd_plain in
// eags_slam_torch/ops/composite_entries.py (see its module docstring).
//
// What bounds it on the card: the entries arrive binned and depth-sorted,
// so the kernel only composites: ~10 FP32 operations per (pixel, entry)
// pair for the Gaussian test, and ~16 more with one exp and one log1p when
// the alpha passes the 1/255 test. Its bytes are the 10 attr rows of the
// entries it reads (40 B an entry) and the (T, 8, PX) output. At the main
// path's shape the pairs dominate: it is bound by FP32 / SFU throughput.
//
// Design, and how it answers the TPU version:
//  - One thread block per tile, 256 threads, each thread owning PX / 256
//    pixels in registers (tile 16 / 32 / 64 -> 1 / 4 / 16 pixels): the
//    per-pixel log T and colour sums never leave registers.
//  - The TPU double-buffered 128-entry chunks of the tile's segment into
//    VMEM by DMA and took the transmittance prefix as a triangular matmul.
//    Here each chunk's 10 attr rows are staged in shared memory and every
//    thread walks the chunk front to back for its pixels, carrying a
//    running log T: no prefix matrix, the same sums.
//  - Unlike K1 there is no coverage test and no ordering pass: binning
//    already put each entry in the tiles its radius box covers, in depth
//    order.
//  - The tile-wide stop (no pixel with log T > -11.5) is checked once per
//    chunk with __syncthreads_or, as the TPU while_loop condition did.
//  - Built with -fmad=false so that the exponent and alpha rounding follow
//    the plain twin operation for operation.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;
constexpr int NTHREADS = 256;
constexpr int OUT_CH = 8;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float LOG_T_MIN = -11.5f;

template <int PPT>
__global__ void __launch_bounds__(NTHREADS)
entries_fwd_kernel(const float* __restrict__ entries, int64_t epad,
                   const int* __restrict__ start,
                   const int* __restrict__ count, int tile, int tiles_x,
                   float* __restrict__ out) {
  __shared__ float s_attr[10][CHUNK];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int px = tile * tile;
  const int64_t st = start[t];
  const int cnt = count[t];
  const float tx0 = (float)((t % tiles_x) * tile);
  const float ty0 = (float)((t / tiles_x) * tile);

  float pu[PPT], pv[PPT], log_t[PPT], acc[PPT][4];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = tid + q * NTHREADS;
    pu[q] = tx0 + (float)(p % tile);
    pv[q] = ty0 + (float)(p / tile);
    log_t[q] = 0.0f;
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
  }
  const int num_chunks = (cnt + CHUNK - 1) / CHUNK;
  int eff = 0;
  bool go = num_chunks > 0;
  while (go) {
    const int base = eff * CHUNK;
    const int jmax = min(CHUNK, cnt - base);
    __syncthreads();
    for (int i = tid; i < 10 * CHUNK; i += NTHREADS) {
      const int ch = i / CHUNK;
      const int j = i % CHUNK;
      s_attr[ch][j] = j < jmax ? entries[ch * epad + st + base + j] : 0.0f;
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

  float* o = out + (int64_t)t * OUT_CH * px;
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
    o[7 * px + p] = (float)cnt;
  }
}

}  // namespace

extern "C" int eags_composite_entries_fwd(
    const float* entries, int64_t epad, const int* start, const int* count,
    int num_tiles, int tile, int tiles_x, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(num_tiles), block(NTHREADS);
  switch (tile) {
    case 16:
      entries_fwd_kernel<1><<<grid, block, 0, st>>>(entries, epad, start,
                                                    count, tile, tiles_x, out);
      break;
    case 32:
      entries_fwd_kernel<4><<<grid, block, 0, st>>>(entries, epad, start,
                                                    count, tile, tiles_x, out);
      break;
    case 64:
      entries_fwd_kernel<16><<<grid, block, 0, st>>>(entries, epad, start,
                                                     count, tile, tiles_x,
                                                     out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
