// raycast_cuda — per-tile TSDF march over each 16x16 tile's candidate blocks.
//
// Replaces the TPU kernel gps_slam_tpu/tsdf/raycast_pallas.py `_kernel`
// (:51; entries `raycast`, `raycast_batch`).  The candidate lists (gids
// [T, LB], -1 = empty slot) come from the torch binning
// `raycast_tiles._tile_bins`, as the TPU version's came from XLA.  The TPU
// kernel needed its operands dense, so its caller staged [T, LB, 512] sdf
// and [T, LB, 1536] colour copies; here each CTA reads the tile's block ids
// and fetches rows from the pool by id.  Nothing is staged in device memory.
//
// What bounds it on the H100: arithmetic and latency, not bytes.  A tile
// needs its LB mip rows (256 B each), the state rows of the blocks it
// refines (2 KiB each) and its 6 x 256 outputs, a few tens of MB per
// camera; the work is 64 x LB quad slab tests with s_coarse trilinear mip
// samples each, then k_blocks x s_refine trilinear sdf samples and one
// colour read per pixel, ~1.3 G f32 ops per camera at 1200x680, all built
// with -fmad=false (two instructions per multiply-add) so that they round
// like the plain PyTorch version.  So the design runs no operation twice
// and serves every sample's reads from shared memory.  One CTA per tile,
// 256 threads:
//
//   0. the tile's LB block ids, origins, max weights and 4^3 mip rows go to
//      shared memory; 64 threads compute the 2x2-quad ray directions (the
//      mean of the quad's four pixel directions, in that order), and the
//      coarse and refine sample fractions (f64 divisions) are computed
//      once for the CTA;
//   1. coarse pass over the 64 x LB (quad, block) pairs, spread over the
//      CTA's threads: each pair's slab test and s_coarse mip samples run
//      once (a thread per pixel ran its quad's pass four times over), and
//      only for the slots that hold a block (an empty slot never hits);
//      each pair leaves its key, first negative sample and NEAR flag in
//      shared memory as [LB][64] arrays;
//   2. one thread per quad picks its k_blocks slots (smallest key, first
//      slot on a tie) and ORs them into the tile's mask of picked blocks;
//   3. one thread copies the picked blocks' 2 KiB state rows into shared
//      memory with TMA bulk copies that complete on an mbarrier, while the
//      other threads compute their pixel directions;
//   4. the staged rows' packed sdf words are decoded to f32 once, in
//      place, and each thread refines its pixel from them (virtual entry
//      crossing, s_refine samples, secant step), then reads the winner's
//      colour with one load per corner word and unpacks all three channels
//      from it.
//
// Colour rows are not staged: a pixel reads only its winner's 8 corner
// words, once, after the refine.  Staging them as well (2 KiB more per
// picked block, 77 KiB per CTA at LB 16, so 2 CTAs per SM instead of 4)
// was measured slower on an H100 SXM at 700 W: 0.216 against 0.170 ms on
// the 1200x680 eval raycast and 0.475 against 0.369 ms at 1920x1080
// (chip_smoke.py's [kernel] rows, both builds in one run, before the sdf
// decode and the sample fractions left the samples, which then took the
// eval raycast from 0.170 to 0.151 ms and from 0.369 to 0.320 ms).
//
// The tracking mode (`track`, the tracking-prepare raycast of both tracked
// routes) takes the JAX XLA march's semantics (gps_slam_tpu/tsdf/
// raycast_tiles.py `raycast`), under which the JAX package meets its own
// tracking gates: steps 1-2 run per pixel, not per quad (each thread's own
// coarse pass over the non-empty blocks, in slot order, keeping its k_blocks
// <= MAX_TRACK_K smallest keys in registers, so that its hit needs no flag of
// its own: a finite key dipped below NEAR; the picked blocks are ORed into
// the tile's mask a warp at a time), and step 4
// brackets in two stages (the mip bracket widened by 1.25 / 0.25 coarse
// spacings, then the sample pair the first stage found).  It is the simple
// form of that mode: the per-pixel pass runs 4x the quad pass's work.
//
// Every f32 expression keeps the order of the plain version
// (`raycast_tiles._march_chunk`): trilinear reads sum the two non-zero hat
// taps per axis, x first, then y, then z.  Dynamic shared memory is LB x
// (2 KiB of staged row + 768 B of mip, keys and flags) plus the sample
// fractions: 45 KiB at LB 16, so 4 CTAs fit on an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int NQ = NPIX / 4;  // 2x2 pixel quads per tile
constexpr int MAX_LB = 32;
constexpr int MAX_TRACK_K = 4;  // picks a pixel holds in the tracking mode
constexpr int ROW = 512;      // voxels of a block row
constexpr float NEAR = 0.9f;
// dynamic shared memory per candidate slot: one staged state row, its mip
// row, its per-quad keys and its per-quad flags
constexpr int SLOT_BYTES = ROW * 4 + 64 * 4 + NQ * 4 * 2;

struct Cam {
  float fx, fy, cx, cy;
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;
  float ox, oy, oz;
  float inv_vox, ext, fmin, fmax;
};

struct Intr {
  float fx, fy, cx, cy, inv_vox, ext, fmin, fmax;
};

__device__ __forceinline__ void pixel_dir(const Cam& c, float tx0, float ty0,
                                          int p, float& dx, float& dy,
                                          float& dz) {
  const float px = tx0 + (float)(p % TILE) + 0.5f;
  const float py = ty0 + (float)(p / TILE) + 0.5f;
  const float dirx = (px - c.cx) / c.fx;
  const float diry = (py - c.cy) / c.fy;
  dx = dirx * c.r00 + diry * c.r01 + c.r02;
  dy = dirx * c.r10 + diry * c.r11 + c.r12;
  dz = dirx * c.r20 + diry * c.r21 + c.r22;
}

// the two non-zero taps of max(0, 1 - |l - i|), i = 0..n-1, l in [0, n-1]
__device__ __forceinline__ void hat2(float l, int n, int& i0, int& i1,
                                     float& w0, float& w1) {
  const float i0f = floorf(l);
  w0 = fmaxf(1.0f - fabsf(l - i0f), 0.0f);
  w1 = fmaxf(1.0f - fabsf(l - (i0f + 1.0f)), 0.0f);
  i0 = (int)i0f;
  if (i0 + 1 <= n - 1) {
    i1 = i0 + 1;
  } else {
    i1 = i0;
    w1 = 0.0f;
  }
}

__device__ __forceinline__ void slab(float bx, float by, float bz, float dx,
                                     float dy, float dz, float ext, float fmin,
                                     float fmax, float& t0, float& t1) {
  const float b[3] = {bx, by, bz};
  const float d[3] = {dx, dy, dz};
  t0 = fmin;
  t1 = fmax;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ds = fabsf(d[a]) < 1e-9f ? 1e-9f : d[a];
    const float ta = b[a] / ds;
    const float tb = (b[a] + ext) / ds;
    t0 = fmaxf(t0, fminf(ta, tb));
    t1 = fminf(t1, fmaxf(ta, tb));
  }
}

// trilinear of the 4^3 mip held in shared memory (cell x + 4y + 16z)
__device__ __forceinline__ float tri_mip(const float* m, float lx, float ly,
                                         float lz) {
  int x0, x1, y0, y1, z0, z1;
  float wx0, wx1, wy0, wy1, wz0, wz1;
  hat2(lx, 4, x0, x1, wx0, wx1);
  hat2(ly, 4, y0, y1, wy0, wy1);
  hat2(lz, 4, z0, z1, wz0, wz1);
  const int zs[2] = {z0 * 16, z1 * 16};
  const float wz[2] = {wz0, wz1};
  float acc_z = 0.0f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float ra = (m[zs[k] + y0 * 4 + x0] * wx0 + m[zs[k] + y0 * 4 + x1] * wx1) * wy0;
    const float rb = (m[zs[k] + y1 * 4 + x0] * wx0 + m[zs[k] + y1 * 4 + x1] * wx1) * wy1;
    const float term = (ra + rb) * wz[k];
    acc_z = k == 0 ? term : acc_z + term;
  }
  return acc_z;
}

__device__ __forceinline__ float sdf_of(int word) {
  int su = word & 0xFFFF;
  su = su >= 32768 ? su - 65536 : su;
  return (float)su * (1.0f / 32767.0f);
}

// trilinear weights and corner indices in an 8^3 voxel row (x + 8y + 64z)
struct Taps {
  float wx0, wx1, wy0, wy1, wz[2];
  int idx[2][2][2];  // [z][y][x]
};

__device__ __forceinline__ Taps row_taps(float lx, float ly, float lz) {
  Taps t;
  int x0, x1, y0, y1, z0, z1;
  hat2(lx, 8, x0, x1, t.wx0, t.wx1);
  hat2(ly, 8, y0, y1, t.wy0, t.wy1);
  hat2(lz, 8, z0, z1, t.wz[0], t.wz[1]);
  const int zs[2] = {z0 * 64, z1 * 64};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    t.idx[k][0][0] = zs[k] + y0 * 8 + x0;
    t.idx[k][0][1] = zs[k] + y0 * 8 + x1;
    t.idx[k][1][0] = zs[k] + y1 * 8 + x0;
    t.idx[k][1][1] = zs[k] + y1 * 8 + x1;
  }
  return t;
}

// the trilinear sum of corner values c[z][y][x] with the weights of `t`
__device__ __forceinline__ float tri_sum(const Taps& t, const float c[2][2][2]) {
  float acc_z = 0.0f;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float ra = (c[k][0][0] * t.wx0 + c[k][0][1] * t.wx1) * t.wy0;
    const float rb = (c[k][1][0] * t.wx0 + c[k][1][1] * t.wx1) * t.wy1;
    const float term = (ra + rb) * t.wz[k];
    acc_z = k == 0 ? term : acc_z + term;
  }
  return acc_z;
}

// one bracket stage against a staged, decoded row: samples at the fractions
// s_fr of [lo, hi], after a virtual entry sample (lo, 1e-3) if `entry` (a
// block entered with sdf already below 0 hides a crossing in the seam before
// it); returns whether a crossing was found, with t and sdf on its two sides
__device__ __forceinline__ bool bracket(const int* row, float bx, float by,
                                        float bz, float dx, float dy, float dz,
                                        float inv_vox, float lo, float hi,
                                        const float* s_fr, int s_refine,
                                        bool entry, float& tlo, float& thi,
                                        float& vlo, float& vhi) {
  float t_prev = lo, v_prev = 1e-3f;
  bool fk = false;
  tlo = thi = vlo = vhi = 0.0f;
  for (int qq = 0; qq < s_refine; ++qq) {
    const float tq = lo + (hi - lo) * s_fr[qq];
    const float lx = fminf(fmaxf((dx * tq - bx) * inv_vox, 0.0f), 7.0f);
    const float ly = fminf(fmaxf((dy * tq - by) * inv_vox, 0.0f), 7.0f);
    const float lz = fminf(fmaxf((dz * tq - bz) * inv_vox, 0.0f), 7.0f);
    const Taps t = row_taps(lx, ly, lz);
    float cv[2][2][2];
#pragma unroll
    for (int z = 0; z < 2; ++z)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int x = 0; x < 2; ++x) cv[z][y][x] = __int_as_float(row[t.idx[z][y][x]]);
    const float v = tri_sum(t, cv);
    if (!fk && (entry || qq > 0) && v_prev >= 0.0f && v_prev < 1e9f && v < 0.0f) {
      tlo = t_prev;
      thi = tq;
      vlo = v_prev;
      vhi = v;
      fk = true;
    }
    t_prev = tq;
    v_prev = v;
  }
  return fk;
}

// element k of a pick array held in registers (selects, no local memory)
static_assert(MAX_TRACK_K == 4, "pick_at selects among 4 picks");
__device__ __forceinline__ int pick_at(const int (&a)[MAX_TRACK_K], int k) {
  return k == 0 ? a[0] : k == 1 ? a[1] : k == 2 ? a[2] : a[3];
}

__global__ void __launch_bounds__(NPIX)
march_kernel(const int* __restrict__ gids, const int* __restrict__ state,
             const int* __restrict__ color, const float* __restrict__ summary,
             const int* __restrict__ block_coords, float* __restrict__ out,
             const float* __restrict__ pose, int LB, int tw, int s_coarse,
             int s_refine, int k_blocks, int need_color, int track, Intr in) {
  // c2w rows [R | t], 3 x 4, read from the device (no host read-back)
  const Cam c{in.fx, in.fy, in.cx, in.cy, pose[0], pose[1], pose[2],
              pose[4], pose[5], pose[6], pose[8], pose[9], pose[10],
              pose[3], pose[7], pose[11], in.inv_vox, in.ext, in.fmin,
              in.fmax};
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_gid[MAX_LB];
  __shared__ int s_row[MAX_LB];  // staged row of each picked slot
  __shared__ float s_borg[3][MAX_LB];
  __shared__ float s_maxw[MAX_LB];
  __shared__ float s_dq[3][NQ];
  __shared__ unsigned char s_pick[MAX_LB][NQ];
  __shared__ unsigned char s_qcand[NQ];
  __shared__ int s_live[MAX_LB];  // the non-empty slots, in slot order
  __shared__ int s_nlive;
  __shared__ unsigned s_mask;
  extern __shared__ __align__(128) int s_dyn[];
  int* s_rows = s_dyn;                                          // [LB][512]
  float* s_mip = reinterpret_cast<float*>(s_dyn + LB * ROW);    // [LB][64]
  float* s_key = s_mip + LB * 64;                               // [LB][NQ]
  int* s_info = reinterpret_cast<int*>(s_key + LB * NQ);        // [LB][NQ]
  float* s_cs = reinterpret_cast<float*>(s_info + LB * NQ);     // [s_coarse]
  float* s_fr = s_cs + s_coarse;                                // [s_refine]

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const float tx0 = (float)(tile % tw) * TILE;
  const float ty0 = (float)(tile / tw) * TILE;
  const uint32_t bar = tma::smem_addr(&s_bar);

  // ---- 0. the tile's candidates and the quad directions ----
  if (p == 0) {
    tma::mbar_init(bar);
    s_mask = 0u;
  }
  if (p < 32) {  // warp 0: list the non-empty slots (LB <= 32)
    const bool live = p < LB && gids[(size_t)tile * LB + p] >= 0;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (live) s_live[__popc(m & ((1u << p) - 1u))] = p;
    if (p == 0) s_nlive = __popc(m);
  }
  if (p < LB) {
    const int g = gids[(size_t)tile * LB + p];
    s_gid[p] = g;
    if (g >= 0) {
      const int key = block_coords[g];
      s_borg[0][p] = (float)((key & 1023) - 512) * c.ext - c.ox;
      s_borg[1][p] = (float)(((key >> 10) & 1023) - 512) * c.ext - c.oy;
      s_borg[2][p] = (float)(((key >> 20) & 1023) - 512) * c.ext - c.oz;
      s_maxw[p] = summary[(size_t)g * 128 + 65];
    } else {
      s_borg[0][p] = s_borg[1][p] = s_borg[2][p] = 1e9f;
      s_maxw[p] = 0.0f;
    }
  }
  for (int i = p; i < LB * 64; i += NPIX) {
    const int g = gids[(size_t)tile * LB + i / 64];
    s_mip[i] = g >= 0 ? summary[(size_t)g * 128 + (i % 64)] : 0.0f;
  }
  // the coarse and refine sample fractions, once per CTA (f64 divisions)
  for (int s = p; s < s_coarse; s += NPIX)
    s_cs[s] = (float)(((double)s + 0.5) / (double)s_coarse);
  for (int s = p; s < s_refine; s += NPIX)
    s_fr[s] = (float)((double)s / (double)(s_refine - 1));
  if (!track && p < NQ) {  // the tracking mode ranks per pixel
    const int p0 = (p / 8) * 2 * TILE + (p % 8) * 2;
    float qd[4][3];
    pixel_dir(c, tx0, ty0, p0, qd[0][0], qd[0][1], qd[0][2]);
    pixel_dir(c, tx0, ty0, p0 + 1, qd[1][0], qd[1][1], qd[1][2]);
    pixel_dir(c, tx0, ty0, p0 + TILE, qd[2][0], qd[2][1], qd[2][2]);
    pixel_dir(c, tx0, ty0, p0 + TILE + 1, qd[3][0], qd[3][1], qd[3][2]);
#pragma unroll
    for (int a = 0; a < 3; ++a)
      s_dq[a][p] = (((qd[0][a] + qd[1][a]) + qd[2][a]) + qd[3][a]) * 0.25f;
  }
  __syncthreads();

  const int kb = k_blocks < LB ? k_blocks : LB;  // later picks find none
  const float half = c.inv_vox * 0.5f;
  float dx, dy, dz;
  // the tracking mode's picks of this pixel: slot (LB: none) and (first
  // negative sample << 2 | has a negative sample << 1)
  int ps[MAX_TRACK_K], pi[MAX_TRACK_K];
  if (track) {
    // ---- 1-2 (tracking mode). each pixel's own coarse pass over the
    // non-empty blocks, in slot order, keeping its kb smallest keys (the
    // first slot on a tie) ----
    pixel_dir(c, tx0, ty0, p, dx, dy, dz);
    float pk[MAX_TRACK_K];
#pragma unroll
    for (int k = 0; k < MAX_TRACK_K; ++k) {
      pk[k] = INFINITY;
      ps[k] = LB;
      pi[k] = 0;
    }
    const float dp[3] = {dx, dy, dz};
    for (int j = 0; j < s_nlive; ++j) {
      const int l = s_live[j];
      const float bo[3] = {s_borg[0][l], s_borg[1][l], s_borg[2][l]};
      float t0, t1;
      slab(bo[0], bo[1], bo[2], dx, dy, dz, c.ext, c.fmin, c.fmax, t0, t1);
      const bool hit = t1 > t0;
      float minval = INFINITY;
      int sf = 0;
      bool neg_any = false;
      for (int s = 0; s < s_coarse; ++s) {
        const float ts = t0 + (t1 - t0) * s_cs[s];
        float lq[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          lq[a] = fminf(fmaxf((dp[a] * ts - bo[a]) * half - 0.5f, 0.0f), 3.0f);
        const float v = tri_mip(s_mip + l * 64, lq[0], lq[1], lq[2]);
        const bool neg = (v < 0.0f) && hit;
        if (neg && !neg_any) sf = s;
        if (hit) minval = fminf(minval, v);
        neg_any = neg_any || neg;
      }
      float key = neg_any ? t0 - 1e4f : (minval < NEAR ? minval : INFINITY);
      int slot = l, info = (sf << 2) | ((int)neg_any << 1);
#pragma unroll
      for (int k = 0; k < MAX_TRACK_K; ++k) {  // sorted insert; a tie stays
        if (k < kb && key < pk[k]) {
          const float fk = pk[k];
          const int sk = ps[k], ik = pi[k];
          pk[k] = key;
          ps[k] = slot;
          pi[k] = info;
          key = fk;
          slot = sk;
          info = ik;
        }
      }
    }
    unsigned picked = 0u;
#pragma unroll
    for (int k = 0; k < MAX_TRACK_K; ++k)
      if (k < kb && ps[k] < LB) picked |= 1u << ps[k];
    picked = __reduce_or_sync(0xffffffffu, picked);
    if ((p & 31) == 0 && picked) atomicOr(&s_mask, picked);
    __syncthreads();
  } else {
    // ---- 1. coarse pass, once per (quad, non-empty block) pair ----
    // an empty slot never hits (its origin is 1e9): key INF, no flags
    for (int i = p; i < LB * NQ; i += NPIX) {
      if (s_gid[i / NQ] < 0) {
        s_key[i] = INFINITY;
        s_info[i] = 0;
      }
    }
    for (int j = p; j < s_nlive * NQ; j += NPIX) {
      const int l = s_live[j / NQ], q = j % NQ, i = l * NQ + q;
      const float dq[3] = {s_dq[0][q], s_dq[1][q], s_dq[2][q]};
      const float bo[3] = {s_borg[0][l], s_borg[1][l], s_borg[2][l]};
      float t0, t1;
      slab(bo[0], bo[1], bo[2], dq[0], dq[1], dq[2], c.ext, c.fmin, c.fmax, t0, t1);
      const bool hit = t1 > t0;
      float minval = INFINITY;
      int sf = 0;
      bool neg_any = false, cand = false;
      for (int s = 0; s < s_coarse; ++s) {
        const float ts = t0 + (t1 - t0) * s_cs[s];
        float lq[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          lq[a] = fminf(fmaxf((dq[a] * ts - bo[a]) * half - 0.5f, 0.0f), 3.0f);
        const float v = tri_mip(s_mip + l * 64, lq[0], lq[1], lq[2]);
        const bool neg = (v < 0.0f) && hit;
        if (neg && !neg_any) sf = s;
        if (hit) minval = fminf(minval, v);
        neg_any = neg_any || neg;
        cand = cand || ((v < NEAR) && hit);
      }
      s_key[i] = neg_any ? t0 - 1e4f : (minval < NEAR ? minval : INFINITY);
      s_info[i] = (sf << 2) | ((int)neg_any << 1) | (int)cand;
    }
    __syncthreads();

    // ---- 2. each quad picks its k_blocks slots ----
    if (p < NQ) {
      bool qcand = false;
      for (int l = 0; l < LB; ++l) qcand = qcand || (s_info[l * NQ + p] & 1);
      s_qcand[p] = qcand;
      unsigned picked = 0u;
      for (int k = 0; k < kb; ++k) {
        float kmin = INFINITY;
        for (int l = 0; l < LB; ++l) kmin = fminf(kmin, s_key[l * NQ + p]);
        int slot = LB;
        if (kmin < INFINITY) {
          for (int l = 0; l < LB; ++l) {
            if (s_key[l * NQ + p] <= kmin) {
              slot = l;
              break;
            }
          }
          s_key[slot * NQ + p] = INFINITY;
          picked |= 1u << slot;
        }
        s_pick[k][p] = (unsigned char)slot;
      }
      if (picked) atomicOr(&s_mask, picked);
    }
    __syncthreads();
  }

  // ---- 3. stage the picked blocks' state rows (TMA bulk copies) ----
  if (p == 0) {
    unsigned m = s_mask;
    tma::mbar_expect_tx(bar, __popc(m) * ROW * 4);
    for (int r = 0; m; ++r, m &= m - 1) {
      const int l = __ffs(m) - 1;
      s_row[l] = r;
      tma::bulk_copy(s_rows + r * ROW, state + (size_t)s_gid[l] * ROW, ROW * 4, bar);
    }
  }
  if (!track) pixel_dir(c, tx0, ty0, p, dx, dy, dz);
  const int q = ((p / TILE) / 2) * 8 + (p % TILE) / 2;
  __syncthreads();  // s_row
  tma::mbar_wait(bar, 0);
  // decode the staged rows' sdf once, in place (as f32 bits), for every
  // sample to read
  for (int i = p; i < __popc(s_mask) * ROW; i += NPIX)
    s_rows[i] = __float_as_int(sdf_of(s_rows[i]));
  __syncthreads();

  // ---- 4. refine the picked candidates at pixel resolution ----
  bool found = false;
  float t_star = 0.0f;
  int win = -1;
  for (int k = 0; k < kb; ++k) {
    const int slot = track ? pick_at(ps, k) : s_pick[k][q];
    if (slot >= LB) continue;
    const float bx = s_borg[0][slot], by = s_borg[1][slot], bz = s_borg[2][slot];
    float t0s, t1s;
    slab(bx, by, bz, dx, dy, dz, c.ext, c.fmin, c.fmax, t0s, t1s);
    t1s = fmaxf(t1s, t0s);
    const int info = track ? pick_at(pi, k) : s_info[slot * NQ + q];
    const bool an = (info >> 1) & 1;
    const float dt = (t1s - t0s) / (float)s_coarse;
    const float ts_neg = t0s + ((float)(info >> 2) + 0.5f) * dt;
    const int* row = s_rows + s_row[slot] * ROW;
    float lo, hi, tlo, thi, vlo, vhi;
    if (track) {
      // the XLA march's two stages: the mip bracket widened by 1.25 / 0.25
      // coarse spacings (no negative sample: the whole segment), then the
      // sample pair it found (none: the whole segment again)
      lo = an ? fmaxf(ts_neg - 1.25f * dt, t0s) : t0s;
      hi = an ? ts_neg + 0.25f * dt : t1s;
      const bool f1 = bracket(row, bx, by, bz, dx, dy, dz, c.inv_vox, lo, hi,
                              s_fr, s_refine, false, tlo, thi, vlo, vhi);
      lo = f1 ? tlo : t0s;
      hi = f1 ? thi : t1s;
    } else {
      lo = an ? fmaxf(ts_neg - 1.5f * dt, t0s) : t0s;
      hi = an ? fminf(ts_neg + 0.5f * dt, t1s) : t1s;
    }
    // virtual entry (lo, 1e-3) then s_refine samples over [lo, hi]
    const bool fk = bracket(row, bx, by, bz, dx, dy, dz, c.inv_vox, lo, hi,
                            s_fr, s_refine, true, tlo, thi, vlo, vhi);
    const float denom = vlo - vhi;
    const float alpha =
        fminf(fmaxf(vlo / (fabsf(denom) < 1e-9f ? 1e-9f : denom), 0.0f), 1.0f);
    const float tk = tlo + alpha * (thi - tlo);
    if (fk && (!found || tk < t_star)) {
      t_star = tk;
      win = slot;
    }
    found = found || fk;
  }

  // the quad's candidate flag: any of its blocks dipped below NEAR (in the
  // tracking mode a pixel picks only blocks whose key is finite, which
  // dipped below NEAR along its own ray: its own flag is always set)
  found = found && (track || s_qcand[q]);
  const float fm = found ? 1.0f : 0.0f;
  const float conf = win >= 0 ? s_maxw[win] : 0.0f;
  float* o = out + (size_t)tile * 6 * NPIX + p;
  o[0 * NPIX] = t_star * fm;
  o[1 * NPIX] = (conf + 1.0f) * fm;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (need_color && win >= 0) {
    const float bx = s_borg[0][win], by = s_borg[1][win], bz = s_borg[2][win];
    const float lx = fminf(fmaxf((dx * t_star - bx) * c.inv_vox, 0.0f), 7.0f);
    const float ly = fminf(fmaxf((dy * t_star - by) * c.inv_vox, 0.0f), 7.0f);
    const float lz = fminf(fmaxf((dz * t_star - bz) * c.inv_vox, 0.0f), 7.0f);
    const int* crow = color + (size_t)s_gid[win] * ROW;
    const Taps t = row_taps(lx, ly, lz);
    int w[2][2][2];  // the 8 corner words, each loaded once
#pragma unroll
    for (int z = 0; z < 2; ++z)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int x = 0; x < 2; ++x) w[z][y][x] = __ldg(crow + t.idx[z][y][x]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float cv[2][2][2];
#pragma unroll
      for (int z = 0; z < 2; ++z)
#pragma unroll
        for (int y = 0; y < 2; ++y)
#pragma unroll
          for (int x = 0; x < 2; ++x)
            cv[z][y][x] = (float)((w[z][y][x] >> (8 * ch)) & 0xFF);
      rgb[ch] = tri_sum(t, cv) * (1.0f / 255.0f) * fm;
    }
  }
  o[2 * NPIX] = rgb[0];
  o[3 * NPIX] = rgb[1];
  o[4 * NPIX] = rgb[2];
  o[5 * NPIX] = fm;
}

}  // namespace

extern "C" int raycast_march(
    const int* gids, const int* state, const int* color, const float* summary,
    const int* block_coords, const float* pose, float* out, int T, int LB,
    int tw, int s_coarse, int s_refine, int k_blocks, int need_color, int track,
    float fx, float fy, float cx, float cy, float inv_vox, float ext,
    float fmin, float fmax, cudaStream_t stream) {
  if (LB > MAX_LB || LB < 1 || (track && k_blocks > MAX_TRACK_K))
    return (int)cudaErrorInvalidValue;
  const int smem = LB * SLOT_BYTES + (s_coarse + s_refine) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Intr in{fx, fy, cx, cy, inv_vox, ext, fmin, fmax};
  if (T > 0) {
    march_kernel<<<T, NPIX, smem, stream>>>(
        gids, state, color, summary, block_coords, out, pose, LB, tw,
        s_coarse, s_refine, k_blocks, need_color, track, in);
  }
  return (int)cudaGetLastError();
}
