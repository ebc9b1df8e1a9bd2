// K1: forward compositing of the centre-tile-sorted rasterizer, for Hopper.
//
// Replaces eags_slam_tpu/ops/rasterizer_pallas_v2.py::_fwd_kernel (built by
// _make_fwd, called from composite_sorted / _composite_sorted_fwd). Same
// semantics as the plain twin composite_sorted_fwd_plain in
// eags_slam_torch/ops/composite_sorted.py (see its module docstring).
//
// What bounds it on the card: per tile, the candidate test reads 4 floats of
// up to bands * seg_cap columns (<= 48 KB at seg_cap 1024); compositing is
// ~10 FP32 operations to test a (pixel, survivor) pair and ~16 more plus an
// exp when it contributes. At 1200x680, tile 32 the kernels map has 629 M
// pairs in the processed chunks, 18% of them contributing: FP32 / SFU
// instruction throughput bounds it, not memory traffic.
//
// Design, and how it answers the TPU version:
//  - One block per selected tile: the tile-wide stop (no pixel with log T
//    > -11.5, tested once per chunk with __syncthreads_or, exactly like the
//    TPU while_loop condition) couples all of a tile's pixels. At tile 32
//    the block has 512 threads (two pixels a thread), or 1024 (one) when
//    the grid has no more tiles than the card has SMs, as the 1/8 tracking
//    subset (104 tiles): 32 warps then on each busy SM.
//  - Each warp owns a compact 8 x (4 * PPT) patch of the tile (lane: 8
//    wide x 4 tall, its PPT pixels 4 rows apart), so most survivors miss
//    most patches.
//  - When a chunk of 128 survivors is staged in shared memory, one thread
//    per survivor also computes its conservative alpha box (alpha_box.cuh).
//    Each warp then tests the 128 boxes against its patch, one per lane
//    and ballot, and walks only the survivors whose box meets it. The box
//    never drops a pair with nonzero alpha, so the skip is exact.
//  - The alpha decision is rounded as the twin rounds it (twin_alpha); the
//    library is otherwise built with FMA. Transmittance is kept linear (T
//    *= 1 - alpha, rescaled by 2^64 when it falls below 2^-64, where the
//    weights it gives are zero), and log T is written once at the end:
//    one multiply per contributing pair instead of an exp and a log1p.
//    The patch, the chunk walk and the output are warp_patch.cuh's,
//    shared with K5, which differs only in how a chunk is staged.
//  - The TPU ranked candidates with all-pairs compares and gathered chunks
//    with one-hot matmuls. Here the covered candidates are compacted into
//    shared memory with a shared counter and ordered by a block-wide
//    bitonic sort of their unique 32-bit keys (the TPU rank order); the
//    sorted columns are written out (S, capt) for the backward replay.
//  - The JAX options kernel_quadform and kernel_bf16 are the variants
//    <QUAD, BF16> of the kernel (`opts` bits 0 and 1), instantiated for
//    every tile shape: BF16 reads the bf16 attr layout (14 of the 16 bytes
//    the coverage test reads, 26 of the 40 a staged survivor needs) and
//    rebuilds float32 exactly; QUAD stages each survivor's quadform
//    coefficients beside its attrs, in dynamic shared memory (4 KB; the
//    default variant launches without it), and composites with
//    quad_alpha (warp_patch.cuh). A simple variant: the TPU's reason for
//    the quadform (one MXU matmul in place of ~15 VPU operations a pair)
//    has no counterpart in a kernel that culls pairs by box; here a boxed
//    pair costs quad_alpha's 5 multiplies and 5 adds, where twin_alpha
//    takes 2 subtractions, 7 multiplies and 2 adds.
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_patch.cuh"

namespace {

using eags::CHUNK;
using eags::OUT_CH;
constexpr int MAX_CAPT = 4096;
constexpr int KEY_PAD = 0x7fffffff;

// Three 512-thread blocks (two pixels a thread) share an SM: registers are
// held to 40 a thread for them (left free, the compiler took 53 and fit
// two: 10% slower, PERF.md).
template <int TILE, int PPT, bool QUAD, bool BF16>
__global__ void __launch_bounds__(TILE * TILE / PPT, PPT == 2 ? 3 : 1)
fwd_kernel(const eags::AttrT<BF16>* __restrict__ attrs, int64_t npad,
           const int* __restrict__ seg_start, const int* __restrict__ seg_cnt,
           const int* __restrict__ tile_ids, int tiles_x, int bands,
           int seg_cap, float* __restrict__ out, int* __restrict__ cols_out) {
  constexpr int NT = TILE * TILE / PPT;
  constexpr int PATCH_H = 4 * PPT;
  constexpr int NWX = TILE / 8;
  static_assert(NT % 32 == 0 && NT >= CHUNK && TILE % PATCH_H == 0, "");
  __shared__ int s_key[MAX_CAPT];
  __shared__ int s_col[MAX_CAPT];
  __shared__ float s_attr[10][CHUNK];
  __shared__ float4 s_box[CHUNK];
  __shared__ int s_count;
  // QUAD: [QROWS][CHUNK], the staged survivors' coefficients and means.
  extern __shared__ float s_dynq[];
  float (*s_q)[CHUNK] = reinterpret_cast<float (*)[CHUNK]>(s_dynq);

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int tc = tile_ids[s];
  const int capt = bands * seg_cap;
  constexpr int px = TILE * TILE;
  const float tx0 = (float)((tc % tiles_x) * TILE);
  const float ty0 = (float)((tc / tiles_x) * TILE);
  const float tx1 = tx0 + (float)TILE;
  const float ty1 = ty0 + (float)TILE;

  if (tid == 0) s_count = 0;
  __syncthreads();

  // 1. Candidates: exact coverage test, compact the survivors with keys.
  for (int b = 0; b < bands; ++b) {
    const int start = seg_start[tc * bands + b];
    const int al = (start / CHUNK) * CHUNK;
    const int lead = start - al;
    const int cnt = min(seg_cnt[tc * bands + b], seg_cap - lead);
    for (int i = tid; i < cnt; i += NT) {
      const int col = start + i;
      float u, v, d, r;
      if constexpr (BF16) {
        const auto at = [&](int row) {
          return __bfloat162float(attrs[row * npad + col]);
        };
        u = __fadd_rn(at(0), at(1));
        v = __fadd_rn(at(2), at(3));
        d = __fadd_rn(at(11), at(12));
        r = at(13);
      } else {
        u = attrs[col];
        v = attrs[npad + col];
        d = attrs[9 * npad + col];
        r = attrs[10 * npad + col];
      }
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
  for (int i = n_surv + tid; i < n_sort; i += NT) {
    s_key[i] = KEY_PAD;
    s_col[i] = 0;
  }
  __syncthreads();
  for (int k = 2; k <= n_sort; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n_sort; i += NT) {
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
  for (int i = tid; i < n_surv; i += NT)
    cols_out[(int64_t)s * capt + i] = s_col[i];

  // 4. Front-to-back compositing in chunks of 128 survivors; this warp's
  //    patch is [x0, x0 + 7] x [y0, y0 + PATCH_H - 1] of the tile.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int x0 = (warp % NWX) * 8;
  const int y0 = (warp / NWX) * PATCH_H;
  eags::FwdPatch<PPT> P;
  eags::fwd_patch_init(P, tx0, ty0, x0, y0, lane);
  eags::QuadBasis<PPT> B;
  if constexpr (QUAD) eags::quad_basis_init(B, x0, y0, lane);
  const float t_stop = expf(eags::LOG_T_MIN);
  const int num_chunks = (n_surv + CHUNK - 1) / CHUNK;
  int eff = 0;
  bool go = num_chunks > 0;
  while (go) {
    const int base = eff * CHUNK;
    const int jmax = min(CHUNK, n_surv - base);
    __syncthreads();
    if (tid < CHUNK) {
      float a[10];
      if (tid < jmax) {
        const int col = s_col[base + tid];
        eags::load_attrs<BF16>(a, attrs, npad, col);
      } else {
#pragma unroll
        for (int ch = 0; ch < 10; ++ch) a[ch] = 0.0f;
      }
#pragma unroll
      for (int ch = 0; ch < 10; ++ch) s_attr[ch][tid] = a[ch];
      if constexpr (QUAD) {
        float g[eags::QROWS];
        eags::quad_coeffs(a[0], a[1], a[2], a[3], a[4], tx0, ty0, g);
#pragma unroll
        for (int k = 0; k < eags::QROWS; ++k) s_q[k][tid] = g[k];
        s_box[tid] = eags::quad_box(a[0], a[1], a[2], a[3], a[4], a[5], g[6],
                                    g[7], (float)TILE);
      } else {
        s_box[tid] = eags::alpha_box(a[0], a[1], a[2], a[3], a[4], a[5]);
      }
    }
    __syncthreads();
    eags::fwd_walk_chunk<PPT, QUAD>(P, s_attr, s_box, jmax, lane, B, s_q);
    ++eff;
    const int any_live = __syncthreads_or(eags::fwd_live(P, t_stop));
    go = (eff < num_chunks) && any_live;
  }

  // 5. Output block (8, PX).
  eags::fwd_store<TILE, PPT>(P, out + (int64_t)s * OUT_CH * px, x0, y0, lane,
                             eff, n_surv);
}

template <int TILE, int PPT, bool QUAD, bool BF16>
int launch_variant(const void* attrs, int64_t npad, const int* seg_start,
                   const int* seg_cnt, const int* tile_ids, int n_sel,
                   int tiles_x, int bands, int seg_cap, float* out,
                   int* cols, cudaStream_t st) {
  const size_t dyn = QUAD ? eags::QROWS * CHUNK * sizeof(float) : 0;
  if (dyn) {
    const cudaError_t err = cudaFuncSetAttribute(
        fwd_kernel<TILE, PPT, QUAD, BF16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (err != cudaSuccess) return (int)err;
  }
  fwd_kernel<TILE, PPT, QUAD, BF16><<<n_sel, TILE * TILE / PPT, dyn, st>>>(
      static_cast<const eags::AttrT<BF16>*>(attrs), npad, seg_start, seg_cnt,
      tile_ids, tiles_x, bands, seg_cap, out, cols);
  return (int)cudaGetLastError();
}

// The variant `opts` names: bit 0 QUAD, bit 1 BF16.
template <int TILE, int PPT>
int launch(const void* attrs, int64_t npad, const int* seg_start,
           const int* seg_cnt, const int* tile_ids, int n_sel, int tiles_x,
           int bands, int seg_cap, float* out, int* cols, int opts,
           cudaStream_t st) {
  switch (opts) {
    case 0:
      return launch_variant<TILE, PPT, false, false>(
          attrs, npad, seg_start, seg_cnt, tile_ids, n_sel, tiles_x, bands,
          seg_cap, out, cols, st);
    case 1:
      return launch_variant<TILE, PPT, true, false>(
          attrs, npad, seg_start, seg_cnt, tile_ids, n_sel, tiles_x, bands,
          seg_cap, out, cols, st);
    case 2:
      return launch_variant<TILE, PPT, false, true>(
          attrs, npad, seg_start, seg_cnt, tile_ids, n_sel, tiles_x, bands,
          seg_cap, out, cols, st);
    case 3:
      return launch_variant<TILE, PPT, true, true>(
          attrs, npad, seg_start, seg_cnt, tile_ids, n_sel, tiles_x, bands,
          seg_cap, out, cols, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// At tile 32, two pixels a thread (512 threads a tile) when the grid has
// more tiles than the card has SMs, one (1024 threads) when it has no more,
// as the tracker's 1/8 subset (104 tiles on 132 SMs): one block an SM then,
// and the larger block puts 32 warps on it.
extern "C" int eags_composite_sorted_fwd(
    const void* attrs, int64_t npad, const int* seg_start,
    const int* seg_cnt, const int* tile_ids, int n_sel, int tile,
    int tiles_x, int bands, int seg_cap, float* out, int* cols, int opts,
    void* stream) {
  if (bands * seg_cap > MAX_CAPT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 16:
      return launch<16, 1>(attrs, npad, seg_start, seg_cnt, tile_ids, n_sel,
                           tiles_x, bands, seg_cap, out, cols, opts, st);
    case 32:
      if (n_sel <= eags::sm_count())
        return launch<32, 1>(attrs, npad, seg_start, seg_cnt, tile_ids,
                             n_sel, tiles_x, bands, seg_cap, out, cols, opts,
                             st);
      return launch<32, 2>(attrs, npad, seg_start, seg_cnt, tile_ids, n_sel,
                           tiles_x, bands, seg_cap, out, cols, opts, st);
    case 64:
      return launch<64, 8>(attrs, npad, seg_start, seg_cnt, tile_ids, n_sel,
                           tiles_x, bands, seg_cap, out, cols, opts, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
