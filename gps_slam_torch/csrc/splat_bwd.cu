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
// (:99; entry `splat_bwd`, called from rasterize._ges_splat_bwd).  The TPU
// kernel factors the pixel sums through six moment matmuls on the MXU;
// here each pixel's term is summed directly in f32, which computes the same
// function without the moment form's cancellation (x^2 S0 - 2x Sx + Sxx)
// for Gaussians whose centre lies tiles away.
//
// What bounds it on the H100.  Each tile with a live slot moves ~11 KB
// whatever its list holds (3 pixel planes, C+1 cotangent rows, the L ids
// and the [L, 6+C] output, C = 4) plus one 64-byte row per live Gaussian,
// a tile without one its ids and zero output, and each live
// (slot, pixel) pair costs ~71 f32 operations including one exp: bytes
// bound a tile below ~12 live slots, arithmetic above.  The main path's
// last Adam step fills 9.5 of 64 slots on average (45 at most) over 845
// tiles, so the launch is one wave of small CTAs whose time is latency:
// the chain of dependent loads before the arithmetic, then the SMs'
// instruction streams.  So, one CTA of 128 threads per active tile:
//
//   1. the live slots are compacted in list order: a slot whose opacity
//      is below 1/255 (the NULL row's is 0) has alpha < 1/255 at every
//      pixel, so no pixel keeps the pair and its output row is exactly
//      zero; it is never computed (the rule of splat_fwd.cu).  Thread 0
//      starts TMA bulk copies of the tile's px, py, ref rows and [C+1,
//      256] cotangent block (contiguous, 8 KB at C = 4) on one mbarrier as
//      soon as it sees slot 0 live, so they land while the other slots
//      are found (else once the count is known);
//   2. a tile with no live slot writes its zero rows and exits: it reads
//      only its L ids and their opacities.  The window megastep's
//      fixed-shape lists hold act_cap tiles, most of them such padded
//      rows (sentinel ids, the NULL row);
//   3. the live rows are copied by TMA onto a second mbarrier;
//   4. the live work is cut into (live slot, pixel chunk) items, chunk c
//      of n taking pixels c, c + n, ...; n is chosen per tile (each warp
//      tries 1..32 at once, one per lane) for the fewest pixel steps of the
//      busiest thread, so no warp idles on a dead slot and a tile's work
//      spreads evenly over its threads.  A thread keeps its item's sums in
//      registers; lanes on one chunk read the same pixel (a broadcast),
//      lanes on neighbouring chunks neighbouring words (no bank
//      conflicts).  The conic multiplies the pixel sums once per item
//      (sum v_sigma (cA dx + cB dy) = cA sum v_sigma dx + cB sum v_sigma
//      dy: each pixel's own dx, dy, not the TPU's moment form);
//   5. the item sums meet in shared memory and each output value adds its
//      slot's chunk sums in chunk order: fixed, so a second launch gives
//      the same bits, with no atomics; each thread builds 4 consecutive
//      floats of the tile's [L, 6+C] region in registers (zeros for dead
//      slots) and stores them as one coalesced 16-byte vector (scalar
//      stores when L (6+C) is not a multiple of 4).
//
// One instance per colour count C (1..7), so every per-colour loop and
// array has its size at compile time.  The pixel sums run in another order
// than splat_bwd_plain, so the kernel is held to each column's largest
// value (1e-4), not to its bits; it is the one kernel built with
// multiply-add contraction (kernels.py), which moves each pair term by an
// f32 rounding, far inside that tolerance.
//
// Measured on the main path's last Adam step (NVIDIA H100 80GB HBM3,
// 700 W, chip_smoke.py's [kernel] rows, every build in one call): 0.0227
// ms against 0.0310 for the design it replaced (one warp per list slot
// over all L slots, staged by scalar loads); 0.0242 with contraction off;
// 0.0241 with 256 threads a tile.  On a window megastep step's padded
// lists (2,048 tiles, 1,203 of them without a live slot; same card and
// script, both builds in one run): 0.0221 ms with the early exit of step
// 2, 0.0232 without it, 0.0217 on the live tiles alone.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int NPIX = 256;
constexpr int NT = 128;          // threads per tile
constexpr int MAX_L = 256;
constexpr int MAX_COLS = 16;
constexpr int MAX_C = 7;         // colours; + the weight channel <= 8
constexpr int MAX_CHUNK = 32;    // pixel chunks per live slot
constexpr unsigned FULL = 0xffffffffu;

// the items' sums in shared memory: at most max(2 NT, L) items
__host__ __device__ inline int item_cap(int L) { return L > 2 * NT ? L : 2 * NT; }

// dynamic shared memory, in 4-byte words; every float array starts on a
// 16-byte boundary (cols % 4 == 0), as the bulk copies need
struct Layout {
  int rows, px, py, lim, vo, part, src, idx, words;
};

__host__ __device__ inline Layout layout(int L, int C, int cols) {
  Layout s;
  int o = 0;
  s.rows = o; o += L * cols;                  // the live rows, compacted
  s.px = o; o += NPIX;
  s.py = o; o += NPIX;
  s.lim = o; o += NPIX;                       // ref, then ref + delta_depth
  s.vo = o; o += (C + 1) * NPIX;              // the cotangent block
  s.part = o; o += (6 + C) * item_cap(L);     // [6+C][item] sums
  s.src = o; o += L;                          // gaussian row of each live slot
  s.idx = o; o += L;                          // live index of each slot, -1 dead
  s.words = o;
  return s;
}

// pixel chunks per live slot: the fewest pixel steps for the busiest
// thread (rounds of NT items times the longest chunk), the fewest chunks
// on a tie, within the item cap.  Every warp finds it at once: lane j
// tries j + 1 chunks and a min over the lanes picks.
__device__ inline int chunks_for(int n_live, int cap, int lane) {
  const int n = lane + 1;  // <= MAX_CHUNK
  int key = 0x7fffffff;
  if (n * n_live <= cap) {
    const int cost = ((n * n_live + NT - 1) / NT) * ((NPIX + n - 1) / n);
    key = (cost << 6) | n;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(FULL, key, o));
  return key & 63;
}

template <int C>
__global__ void __launch_bounds__(NT, 8)
splat_bwd_kernel(const float* __restrict__ packed, const int* __restrict__ gids,
                 const float* __restrict__ px, const float* __restrict__ py,
                 const float* __restrict__ ref, const float* __restrict__ v_out,
                 float* __restrict__ out, int L, int cols, float delta_depth) {
  constexpr int K = 6 + C;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ int s_count[NT / 32];
  const Layout S = layout(L, C, cols);
  float* s_rows = smem + S.rows;
  float* s_px = smem + S.px;
  float* s_py = smem + S.py;
  float* s_lim = smem + S.lim;
  float* s_vo = smem + S.vo;
  float* s_part = smem + S.part;
  int* s_src = reinterpret_cast<int*>(smem + S.src);
  int* s_idx = reinterpret_cast<int*>(smem + S.idx);
  const int a = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float gmin = 1.0f / 255.0f;
  const uint32_t bar_pix = tma::smem_addr(&s_bar[0]);
  const uint32_t bar_rows = tma::smem_addr(&s_bar[1]);

  float* o = out + (size_t)a * L * K;
  const int n_out = L * K;
  // thread 0: the tile's pixel planes and [C+1, 256] cotangent block, 8 KB
  // at C = 4, as TMA bulk copies onto bar_pix
  auto fetch_planes = [&]() {
    const uint32_t plane = NPIX * 4;
    tma::mbar_expect_tx(bar_pix, (3 + C + 1) * plane);
    tma::bulk_copy(s_px, px + (size_t)a * NPIX, plane, bar_pix);
    tma::bulk_copy(s_py, py + (size_t)a * NPIX, plane, bar_pix);
    tma::bulk_copy(s_lim, ref + (size_t)a * NPIX, plane, bar_pix);
    tma::bulk_copy(s_vo, v_out + (size_t)a * (C + 1) * NPIX, (C + 1) * plane,
                   bar_pix);
  };
  if (t == 0) {
    tma::mbar_init(bar_pix);
    tma::mbar_init(bar_rows);
  }

  // ---- 1. the live slots, compacted in list order; the planes are in
  //         flight as soon as slot 0 is seen live ----
  bool fetched = false;  // thread 0's
  int n_live = 0;
  for (int base = 0; base < L; base += NT) {
    const int l = base + t;
    int g = 0;
    bool live = false;
    if (l < L) {
      g = gids[(size_t)a * L + l];
      live = __ldg(packed + (size_t)g * cols + 6 + C) >= gmin;
    }
    if (l == 0 && live) {
      fetch_planes();
      fetched = true;
    }
    const unsigned m = __ballot_sync(FULL, live);
    if (lane == 0) s_count[warp] = __popc(m);
    __syncthreads();  // also publishes thread 0's mbarrier init
    int before = __popc(m & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
      before += w < warp ? s_count[w] : 0;
      total += s_count[w];
    }
    if (l < L) s_idx[l] = live ? n_live + before : -1;
    if (live) s_src[n_live + before] = g;
    n_live += total;
    __syncthreads();  // s_count is reused; s_src and s_idx are complete
  }

  // ---- 2. a tile with no live slot (a padded row of the fixed-shape
  //         lists, or every slot below 1/255): its rows are exactly zero,
  //         and nothing else of it is read ----
  if (n_live == 0) {
    if ((n_out & 3) == 0) {
      for (int e = 4 * t; e < n_out; e += 4 * NT)
        *reinterpret_cast<float4*>(o + e) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      for (int e = t; e < n_out; e += NT) o[e] = 0.0f;
    }
    return;
  }
  if (t == 0 && !fetched) fetch_planes();

  // ---- 3. the live rows (TMA bulk copies) ----
  if (warp == 0) {
    if (lane == 0) tma::mbar_expect_tx(bar_rows, n_live * cols * 4);
    __syncwarp();
    for (int i = lane; i < n_live; i += 32)
      tma::bulk_copy(s_rows + i * cols, packed + (size_t)s_src[i] * cols,
                     cols * 4, bar_rows);
  }
  const int icap = item_cap(L);
  const int nchunk = chunks_for(n_live, icap, lane);
  const int items = n_live * nchunk;
  tma::mbar_wait(bar_pix, 0);
  for (int p = t; p < NPIX; p += NT) s_lim[p] = s_lim[p] + delta_depth;
  tma::mbar_wait(bar_rows, 0);
  __syncthreads();

  // ---- 4. (live slot, pixel chunk) items over the threads ----
  for (int it = t; it < items; it += NT) {
    const int i = it % n_live, c = it / n_live;
    const float* g = s_rows + i * cols;
    const float gx = g[0], gy = g[1], cA = g[2], cB = g[3], cC = g[4];
    const float gd = g[5 + C], op = g[6 + C];
    float ce[C], s_ce[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      ce[k] = g[5 + k];
      s_ce[k] = 0.0f;
    }
    // the conic is constant over the pixels, so it multiplies the pixel
    // sums once: sum v_sigma (cA dx + cB dy) = cA sum v_sigma dx + cB sum
    // v_sigma dy, and so on (each pixel's own dx, dy: no moment form)
    float s_dx = 0.0f, s_dy = 0.0f, s_xx = 0.0f, s_xy = 0.0f, s_yy = 0.0f, s_op = 0.0f;
#pragma unroll 4
    for (int p = c; p < NPIX; p += nchunk) {
      float vo[C];
#pragma unroll
      for (int k = 0; k < C; ++k) vo[k] = s_vo[k * NPIX + p];
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
      for (int k = 0; k < C; ++k) v_w = v_w + ce[k] * vo[k];
      v_w = v_w + s_vo[C * NPIX + p];
      const float dal = (keep && raw < 0.999f) ? v_w : 0.0f;
      const float vs = -dal * raw;
      const float vx = vs * dx, vy = vs * dy;
      s_dx = s_dx + vx;
      s_dy = s_dy + vy;
      s_xx = s_xx + vx * dx;
      s_xy = s_xy + vx * dy;
      s_yy = s_yy + vy * dy;
#pragma unroll
      for (int k = 0; k < C; ++k) s_ce[k] = s_ce[k] + w * vo[k];
      s_op = s_op + dal * e;
    }
    float* pt = s_part + it;
    pt[0 * icap] = cA * s_dx + cB * s_dy;
    pt[1 * icap] = cC * s_dy + cB * s_dx;
    pt[2 * icap] = 0.5f * s_xx;
    pt[3 * icap] = s_xy;
    pt[4 * icap] = 0.5f * s_yy;
#pragma unroll
    for (int k = 0; k < C; ++k) pt[(5 + k) * icap] = s_ce[k];
    pt[(5 + C) * icap] = s_op;
  }
  __syncthreads();

  // ---- 5. the tile's [L, 6+C] region: chunk sums in chunk order ----
  auto value = [&](int e) -> float {
    const int l = e / K, k = e - l * K;
    const int i = s_idx[l];
    if (i < 0) return 0.0f;
    const float* pk = s_part + k * icap + i;
    float v = pk[0];
    for (int c = 1; c < nchunk; ++c) v = v + pk[c * n_live];
    return v;
  };
  if ((n_out & 3) == 0) {
    for (int e = 4 * t; e < n_out; e += 4 * NT)
      *reinterpret_cast<float4*>(o + e) =
          make_float4(value(e), value(e + 1), value(e + 2), value(e + 3));
  } else {
    for (int e = t; e < n_out; e += NT) o[e] = value(e);
  }
}

template <int C>
void launch(const float* packed, const int* gids, const float* px,
            const float* py, const float* ref, const float* v_out, float* out,
            int A, int L, int cols, float delta_depth, cudaStream_t stream) {
  const size_t bytes = (size_t)layout(L, C, cols).words * 4;
  if (bytes > 48 * 1024)
    cudaFuncSetAttribute(splat_bwd_kernel<C>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  splat_bwd_kernel<C><<<A, NT, bytes, stream>>>(packed, gids, px, py, ref,
                                                v_out, out, L, cols, delta_depth);
}

}  // namespace

extern "C" int splat_bwd(const float* packed, const int* gids, const float* px,
                         const float* py, const float* ref, const float* v_out,
                         float* out, int A, int L, int C, int cols,
                         float delta_depth, cudaStream_t stream) {
  if (L > MAX_L || cols > MAX_COLS || cols % 4 || C > MAX_C || L < 1 ||
      C < 1 || cols < 7 + C)
    return (int)cudaErrorInvalidValue;
  if (A > 0) {
    // one instance per colour count, so that every per-colour array and
    // loop has its size at compile time
    switch (C) {
      case 1: launch<1>(packed, gids, px, py, ref, v_out, out, A, L, cols, delta_depth, stream); break;
      case 2: launch<2>(packed, gids, px, py, ref, v_out, out, A, L, cols, delta_depth, stream); break;
      case 3: launch<3>(packed, gids, px, py, ref, v_out, out, A, L, cols, delta_depth, stream); break;
      case 4: launch<4>(packed, gids, px, py, ref, v_out, out, A, L, cols, delta_depth, stream); break;
      case 5: launch<5>(packed, gids, px, py, ref, v_out, out, A, L, cols, delta_depth, stream); break;
      case 6: launch<6>(packed, gids, px, py, ref, v_out, out, A, L, cols, delta_depth, stream); break;
      default: launch<7>(packed, gids, px, py, ref, v_out, out, A, L, cols, delta_depth, stream); break;
    }
  }
  return (int)cudaGetLastError();
}
