// splat_bwd_cuda — GES tile splat backward: per active 16x16 tile a and
// list slot l, the gradient components of the pair (a, l) reduced over the
// tile's 256 pixels, out[a, l, :] = v_x, v_y, v_cA, v_cB, v_cC,
// v_ce[0..C-1], v_op, for the cotangent v_out [A, C+1, 256] of
// splat_fwd_cuda.  Per pixel p, with the forward's pair terms:
//   v_w     = sum_k ce[l, k] v_out[k, p]   (C colours, then the weight row)
//   d_alpha = v_w if kept and raw_alpha < 0.999 else 0
//   v_sigma = -d_alpha * raw_alpha
// and the sums over p of v_sigma (cA dx + cB dy), v_sigma (cC dy + cB dx),
// v_sigma dx^2 / 2, v_sigma dx dy, v_sigma dy^2 / 2, w v_out[k], d_alpha e.
//
// Replaces the TPU kernel gps_slam_tpu/gs/splat_pallas.py `_bwd_kernel`
// (entry `splat_bwd`, called from rasterize._ges_splat_bwd).  The TPU
// kernel factors the pixel sums through six moment matmuls on the MXU;
// here each pixel's term is summed directly in f32, which computes the same
// function without the moment form's cancellation (x^2 S0 - 2x Sx + Sxx)
// for Gaussians whose centre lies tiles away.
//
// What bounds it on the H100 depends on how many of a tile's L slots are
// live.  Each tile moves ~11 KB whatever its lists hold (3 pixel planes,
// C+1 cotangent rows, the L ids and the [L, 6+C] output, C = 4), plus one
// 64-byte attribute row per distinct live Gaussian; each live (slot,
// pixel) pair costs ~71 f32 operations including one exp.  At the card's
// 20 f32 operations per HBM byte, arithmetic bounds a tile above ~12 live
// slots and bytes below.  The smoke run's Adam steps fill ~10 of 64
// slots per tile, so there the bytes bound it.  The design serves both:
// one thread block per active tile, so each byte is read once; the
// tile's L attribute rows, pixel planes and cotangent rows are staged
// once in shared memory (~27 KB); each of the 8 warps
// takes one slot at a time, each lane walks 8 pixels strided by 32
// (conflict-free shared reads) keeping the 6+C partial sums in registers,
// and a fixed warp-shuffle tree reduces them, so the result is the same
// bit for bit from run to run; no atomics.  Slots that point at the
// all-zero NULL row (opacity 0: every pair is dropped, the row is exactly
// zero) are written without the pixel loop.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NPIX = 256;
constexpr int NWARP = NPIX / 32;
constexpr int MAX_L = 256;
constexpr int MAX_COLS = 16;
constexpr int MAX_CH = 8;   // C colours + the weight channel

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(NPIX)
splat_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ gids,
                 const float* __restrict__ px, const float* __restrict__ py,
                 const float* __restrict__ ref, const float* __restrict__ v_out,
                 float* __restrict__ out, int L, int C, int cols,
                 float delta_depth) {
  __shared__ float s_rows[MAX_L * MAX_COLS];
  __shared__ float s_px[NPIX], s_py[NPIX], s_lim[NPIX];
  __shared__ float s_vo[MAX_CH * NPIX];
  const int a = blockIdx.x;
  const int t = threadIdx.x;
  const int nload = L * cols;
  for (int i = t; i < nload; i += NPIX) {
    const int l = i / cols, c = i % cols;
    const int g = gids[(size_t)a * L + l];
    s_rows[l * MAX_COLS + c] = packed[(size_t)g * cols + c];
  }
  const size_t pix = (size_t)a * NPIX + t;
  s_px[t] = px[pix];
  s_py[t] = py[pix];
  s_lim[t] = ref[pix] + delta_depth;
  for (int k = 0; k <= C; ++k)
    s_vo[k * NPIX + t] = v_out[((size_t)a * (C + 1) + k) * NPIX + t];
  __syncthreads();

  const int warp = t >> 5, lane = t & 31;
  const int K = 6 + C;
  const float gmin = 1.0f / 255.0f;
  for (int l = warp; l < L; l += NWARP) {
    const float* g = s_rows + l * MAX_COLS;
    float* o = out + ((size_t)a * L + l) * K;
    const float op = g[6 + C];
    if (op == 0.0f) {
      if (lane < K) o[lane] = 0.0f;
      continue;
    }
    const float gx = g[0], gy = g[1], cA = g[2], cB = g[3], cC = g[4];
    const float gd = g[5 + C];
    float s_x = 0.0f, s_y = 0.0f, s_a = 0.0f, s_b = 0.0f, s_c = 0.0f, s_op = 0.0f;
    float s_ce[MAX_CH - 1];
#pragma unroll
    for (int k = 0; k < MAX_CH - 1; ++k) s_ce[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < NPIX / 32; ++i) {
      const int p = lane + 32 * i;
      const float dx = gx - s_px[p];
      const float dy = gy - s_py[p];
      const float sigma = 0.5f * (cA * dx * dx + cC * dy * dy) + cB * dx * dy;
      const float e = expf(-sigma);
      const float raw = op * e;
      const float alpha = fminf(raw, 0.999f);
      const bool keep = sigma >= 0.0f && alpha >= gmin && gd <= s_lim[p];
      const float w = keep ? alpha : 0.0f;
      float v_w = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_CH - 1; ++k)
        if (k < C) v_w = v_w + g[5 + k] * s_vo[k * NPIX + p];
      v_w = v_w + s_vo[C * NPIX + p];
      const float dal = (keep && raw < 0.999f) ? v_w : 0.0f;
      const float vs = -dal * raw;
      s_x = s_x + vs * (cA * dx + cB * dy);
      s_y = s_y + vs * (cC * dy + cB * dx);
      s_a = s_a + vs * 0.5f * dx * dx;
      s_b = s_b + vs * dx * dy;
      s_c = s_c + vs * 0.5f * dy * dy;
#pragma unroll
      for (int k = 0; k < MAX_CH - 1; ++k)
        if (k < C) s_ce[k] = s_ce[k] + w * s_vo[k * NPIX + p];
      s_op = s_op + dal * e;
    }
    s_x = warp_sum(s_x);
    s_y = warp_sum(s_y);
    s_a = warp_sum(s_a);
    s_b = warp_sum(s_b);
    s_c = warp_sum(s_c);
    s_op = warp_sum(s_op);
#pragma unroll
    for (int k = 0; k < MAX_CH - 1; ++k)
      if (k < C) s_ce[k] = warp_sum(s_ce[k]);
    if (lane == 0) {
      o[0] = s_x;
      o[1] = s_y;
      o[2] = s_a;
      o[3] = s_b;
      o[4] = s_c;
#pragma unroll
      for (int k = 0; k < MAX_CH - 1; ++k)
        if (k < C) o[5 + k] = s_ce[k];
      o[5 + C] = s_op;
    }
  }
}

}  // namespace

extern "C" int splat_bwd(const float* packed, const int* gids, const float* px,
                         const float* py, const float* ref, const float* v_out,
                         float* out, int A, int L, int C, int cols,
                         float delta_depth, cudaStream_t stream) {
  if (L > MAX_L || cols > MAX_COLS || C + 1 > MAX_CH || L < 1 || C < 1)
    return (int)cudaErrorInvalidValue;
  if (A > 0) {
    splat_bwd_kernel<<<A, NPIX, 0, stream>>>(packed, gids, px, py, ref, v_out,
                                             out, L, C, cols, delta_depth);
  }
  return (int)cudaGetLastError();
}
