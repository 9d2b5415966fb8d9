// splat_fwd_cuda — GES tile splat forward: per active 16x16 tile and its
// L-deep gaussian list, out[k, p] = sum_l w[l, p] * ce[l, k] over C colour
// channels + one weight-sum channel.
//
// Replaces the TPU kernel gps_slam_tpu/gs/splat_pallas.py `_fwd_kernel`
// (:83; entry `splat_fwd`, called from rasterize._splat_fwd_impl).
//
// What bounds it on the H100: arithmetic on the CUDA cores.  Each live
// (slot, pixel) pair costs ~35 f32 operations including one exp, against
// 64 bytes of attribute row per slot that all 256 pixels of the tile
// reuse, so the kernel sits far above the memory roofline.  One thread
// per pixel that walks all L slots spends its instructions on two things
// that are not that arithmetic: slots whose row cannot contribute (the
// NULL row that pads a list, and any row with opacity below 1/255), and a
// shared-memory read of the row's ~10 attributes for every pixel.  So,
// one CTA of 64 threads per active tile:
//
//   1. the tile's live slots are found and compacted in list order: a slot
//      whose opacity is below 1/255 has alpha < 1/255 at every pixel, so it
//      adds exactly 0 and is dropped (the plain version sums it, as +0).
//      A tile with none (most of the window megastep's fixed-shape lists
//      are such padded rows: sentinel ids, the NULL row) writes zeros and
//      exits without reading its pixels;
//   2. the live slots' 64-byte packed rows are copied into shared memory
//      with TMA bulk copies completing on an mbarrier, while each thread
//      loads its pixels' coordinates and reference depths;
//   3. each thread covers 4 pixels (p, p + 64, p + 128, p + 192, so loads
//      and stores stay coalesced): each row's attributes are read from
//      shared memory once and feed 4 pixels, whose C+1 channel sums live in
//      f32 registers and are written once as [A, C+1, 256].
//
// Live slots are summed in list order, the order the plain PyTorch version
// uses, with every expression in its order (built with -fmad=false), so
// the kernel gives the plain version's bits.  Measured on the main path's
// last splat (H100 SXM at 700 W, chip_smoke.py's [kernel] rows, each pair
// of builds in one run): 0.0317 ms, against 0.0376 with 2 pixels a
// thread over 128 threads, and 0.0361 with a branch past the pairs whose
// sigma rules them out before the exp (the warps diverge).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int NPIX = 256;
constexpr int NT = 64;           // threads per tile
constexpr int PPT = NPIX / NT;   // pixels per thread
constexpr int MAX_L = 256;
constexpr int MAX_COLS = 16;
constexpr int MAX_CH = 8;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(NT)
splat_fwd_kernel(const float* __restrict__ packed, const int* __restrict__ gids,
                 const float* __restrict__ px, const float* __restrict__ py,
                 const float* __restrict__ ref, float* __restrict__ out,
                 int L, int C, int cols, float delta_depth) {
  __shared__ __align__(16) float s_rows[MAX_L * MAX_COLS];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_src[MAX_L];       // gaussian row of each live slot
  __shared__ int s_count[NT / 32];   // live slots per warp in a chunk
  const int a = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float gmin = 1.0f / 255.0f;
  const uint32_t bar = tma::smem_addr(&s_bar);
  if (t == 0) tma::mbar_init(bar);

  // ---- 1. the live slots, compacted in list order ----
  int n_live = 0;
  for (int base = 0; base < L; base += NT) {
    const int l = base + t;
    int g = 0;
    bool live = false;
    if (l < L) {
      g = gids[(size_t)a * L + l];
      live = __ldg(packed + (size_t)g * cols + 6 + C) >= gmin;
    }
    const unsigned m = __ballot_sync(FULL, live);
    if (lane == 0) s_count[warp] = __popc(m);
    __syncthreads();
    int before = __popc(m & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      before += w < warp ? s_count[w] : 0;
      total += s_count[w];
    }
    if (live) s_src[n_live + before] = g;
    n_live += total;
    __syncthreads();  // s_count is reused; s_src is complete
  }

  // a tile with no live slot (a padded row of the fixed-shape lists, or
  // every slot below 1/255) sums nothing: zeros, and nothing else read
  if (n_live == 0) {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      float* o = out + (size_t)a * (C + 1) * NPIX + t + j * NT;
      for (int k = 0; k <= C; ++k) o[k * NPIX] = 0.0f;
    }
    return;
  }

  // ---- 2. stage the live rows (TMA bulk copies) ----
  if (t == 0) tma::mbar_expect_tx(bar, n_live * cols * 4);
  __syncthreads();
  for (int i = t; i < n_live; i += NT)
    tma::bulk_copy(s_rows + i * cols, packed + (size_t)s_src[i] * cols, cols * 4, bar);
  float x[PPT], y[PPT], lim[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const size_t pix = (size_t)a * NPIX + t + j * NT;
    x[j] = px[pix];
    y[j] = py[pix];
    lim[j] = ref[pix] + delta_depth;
  }
  float acc[PPT][MAX_CH];
#pragma unroll
  for (int j = 0; j < PPT; ++j)
#pragma unroll
    for (int k = 0; k < MAX_CH; ++k) acc[j][k] = 0.0f;
  tma::mbar_wait(bar, 0);

  // ---- 3. 4 pixels per thread, one read of each row ----
  for (int i = 0; i < n_live; ++i) {
    const float* g = s_rows + i * cols;
    const float gx = g[0], gy = g[1], ca = g[2], cb = g[3], cc = g[4];
    const float dep = g[5 + C], op = g[6 + C];
    float col[MAX_CH - 1];
#pragma unroll
    for (int k = 0; k < MAX_CH - 1; ++k) col[k] = k < C ? g[5 + k] : 0.0f;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float dx = gx - x[j];
      const float dy = gy - y[j];
      const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
      const float alpha = fminf(op * expf(-sigma), 0.999f);
      const bool keep = sigma >= 0.0f && alpha >= gmin && dep <= lim[j];
      const float w = keep ? alpha : 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_CH - 1; ++k)
        if (k < C) acc[j][k] = acc[j][k] + w * col[k];
      acc[j][MAX_CH - 1] = acc[j][MAX_CH - 1] + w;
    }
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    float* o = out + (size_t)a * (C + 1) * NPIX + t + j * NT;
#pragma unroll
    for (int k = 0; k < MAX_CH - 1; ++k)
      if (k < C) o[k * NPIX] = acc[j][k];
    o[C * NPIX] = acc[j][MAX_CH - 1];
  }
}

}  // namespace

extern "C" int splat_fwd(const float* packed, const int* gids, const float* px,
                         const float* py, const float* ref, float* out, int A,
                         int L, int C, int cols, float delta_depth,
                         cudaStream_t stream) {
  if (L > MAX_L || cols > MAX_COLS || cols % 4 || C + 1 > MAX_CH || L < 1)
    return (int)cudaErrorInvalidValue;
  if (A > 0) {
    splat_fwd_kernel<<<A, NT, 0, stream>>>(packed, gids, px, py, ref, out, L,
                                           C, cols, delta_depth);
  }
  return (int)cudaGetLastError();
}
