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
// routes) is a kernel of its own, `track_kernel`.  It takes the JAX XLA
// march's semantics (gps_slam_tpu/tsdf/raycast_tiles.py `raycast`), under
// which the JAX package meets its own tracking gates: blocks are ranked and
// picked per pixel (each pixel keeps its k_blocks <= MAX_TRACK_K smallest
// keys, the first slot on a tie; a pick dipped below NEAR along the pixel's
// own ray, so its hit needs no flag of its own), and the refine brackets in
// two stages (the mip bracket widened by 1.25 / 0.25 coarse spacings, then
// the sample pair the first stage found).  A pixel's ray hits about one in
// four of its tile's blocks on the 1200x680 tracked path (one in seven on
// tests/test_tracking.py's fixture), so most of the work its plain version
// describes is never read.  What bounds the kernel is instruction
// throughput: dozens of instructions a trilinear sample and six f32
// divisions a slab test, with -fmad=false, and lanes left idle where the
// rays of a warp part ways.  So it computes only what its picks read, with
// full warps where it can:
//
//   1. each pixel tests its ray against the non-empty blocks in slot order
//      with `slab_misses` (products with the reciprocals of its direction,
//      no division), which rules out every pair but the hits and a few
//      near misses; a ballot per warp and block lists the lanes that may
//      hit;
//   2. those pairs, numbered block-major from the ballots, are spread over
//      the CTA's threads (a warp's lanes mostly read one block's mip): each
//      runs the exact slab test and, where it hits, its mip samples up to
//      its first negative one (the key is then t0 - 1e4 and nothing reads a
//      later sample); it leaves its key and info in shared memory;
//   3. each pixel walks its pairs in slot order, keeping its smallest keys
//      in registers, in (key, slot) order (sorted insert: a new pair never
//      displaces an equal key, whose slot comes before it, but a pair that
//      an insert pushed down does displace an equal key of a later slot;
//      a miss's key is inf and never enters), the plain version's picks:
//      the smallest key k times, the first slot on a tie; the picked blocks
//      are ORed into the tile's mask a warp at a time;
//   4. the picked rows are staged by TMA as in the quad mode, over the
//      shared memory that held the pairs' results;
//   5. each pixel refines its picks; a bracket stage stops at its first
//      crossing (later samples change nothing it returns); stage 2 after a
//      crossing starts from stage 1's sample at the crossing's near side
//      (its first sample, at tlo + (thi - tlo) * 0 = tlo); with no negative
//      sample and no crossing in stage 1, which took stage 2's samples,
//      only stage 2's virtual entry pair is left to test; a pick whose slab
//      entry t0s is at or beyond the pixel's t* is skipped once a pick has
//      hit: every t a refine returns is lo + (hi - lo) * f with f in [0, 1]
//      and hi >= lo >= t0s, or its secant point between two such ts, so it
//      lies at or beyond t0s in f32 too.
//
// Left out: staging every live row at step 0, so that the copies overlap
// steps 1-3, took 0.300 against 0.225 ms on the 1200x680 tracked path's
// last prepare call (tools/k3_track_split.py, an H100 SXM at 700 W; LB x 2
// KiB more shared memory: 2 CTAs an SM, not 4); leaving out a pair that
// could only lose (t0 - 1e4 at or above the pixel's k-th key, that key with
// a negative sample) needs the walk of step 3 before step 2 and would spare
// 3% of the hit pairs on tests/test_tracking.py's fixture
// (tests/test_torch_raycast_track_skips.py counts them).  The pairs'
// results sit over the staged rows' shared memory, so the mode needs the
// quad mode's bytes: LB x (2 KiB of rows or results + 256 B of mip + 512 B
// of pair list).
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
constexpr int NWARP = NPIX / 32;
constexpr int MAX_LB = 32;
constexpr int MAX_TRACK_K = 4;  // picks a pixel holds in the tracking mode
constexpr int ROW = 512;      // voxels of a block row
constexpr float NEAR = 0.9f;
// dynamic shared memory per candidate slot: one staged state row, its mip
// row, its per-quad keys and its per-quad flags (the tracking mode: its
// (pixel, block) pairs over the row, its mip row, its pair list)
constexpr int SLOT_BYTES = ROW * 4 + 64 * 4 + NQ * 4 * 2;
static_assert(NQ * 4 * 2 == NPIX * 2, "a slot's pair list fills its quad arrays");

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

// whether `slab` surely finds no hit, from products with the direction's
// reciprocals (r = 1 / ds, correctly rounded) in place of its quotients:
// each product lies within 2e-7 of its size of the quotient `slab` rounds
// once, and a min or max of such values within 2e-7 of its own size of
// theirs, so where this entry lies beyond this exit by 4e-6 of their sizes,
// `slab`'s entry lies at or beyond its exit (a miss, as its t1 > t0 says)
__device__ __forceinline__ bool slab_misses(float bx, float by, float bz, float rx,
                                            float ry, float rz, float ext, float fmin,
                                            float fmax) {
  const float b[3] = {bx, by, bz};
  const float r[3] = {rx, ry, rz};
  float t0 = fmin, t1 = fmax;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ta = b[a] * r[a];
    const float tb = (b[a] + ext) * r[a];
    t0 = fmaxf(t0, fminf(ta, tb));
    t1 = fminf(t1, fmaxf(ta, tb));
  }
  return t0 >= t1 + 4e-6f * (fabsf(t0) + fabsf(t1));
}

// the reciprocal of a direction component as `slab` clamps it
__device__ __forceinline__ float slab_rcp(float d) {
  return 1.0f / (fabsf(d) < 1e-9f ? 1e-9f : d);
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

// the trilinear sdf of a staged, decoded row at t along the ray
__device__ __forceinline__ float sample_row(const int* row, float bx, float by,
                                            float bz, float dx, float dy, float dz,
                                            float inv_vox, float t) {
  const float lx = fminf(fmaxf((dx * t - bx) * inv_vox, 0.0f), 7.0f);
  const float ly = fminf(fmaxf((dy * t - by) * inv_vox, 0.0f), 7.0f);
  const float lz = fminf(fmaxf((dz * t - bz) * inv_vox, 0.0f), 7.0f);
  const Taps tp = row_taps(lx, ly, lz);
  float cv[2][2][2];
#pragma unroll
  for (int z = 0; z < 2; ++z)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int x = 0; x < 2; ++x) cv[z][y][x] = __int_as_float(row[tp.idx[z][y][x]]);
  return tri_sum(tp, cv);
}

// one bracket stage against a staged, decoded row: samples q0.. of the
// fractions s_fr of [lo, hi], each after the one before it, the first after
// (t_prev, v_prev): the virtual entry sample (lo, 1e-3) (a block entered
// with sdf already below 0 hides a crossing in the seam before it), a
// sample already taken, or v_prev = inf for none; returns whether a
// crossing was found, with t and sdf on its two sides (with kStop it stops
// there: no later sample changes what it returns)
template <bool kStop>
__device__ __forceinline__ bool bracket(const int* row, float bx, float by,
                                        float bz, float dx, float dy, float dz,
                                        float inv_vox, float lo, float hi,
                                        const float* s_fr, int q0, int s_refine,
                                        float t_prev, float v_prev, float& tlo,
                                        float& thi, float& vlo, float& vhi) {
  bool fk = false;
  tlo = thi = vlo = vhi = 0.0f;
  for (int qq = q0; qq < s_refine; ++qq) {
    const float tq = lo + (hi - lo) * s_fr[qq];
    const float v = sample_row(row, bx, by, bz, dx, dy, dz, inv_vox, tq);
    if (!fk && v_prev >= 0.0f && v_prev < 1e9f && v < 0.0f) {
      tlo = t_prev;
      thi = tq;
      vlo = v_prev;
      vhi = v;
      fk = true;
      if (kStop) break;
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

// the tile's candidates to shared memory (both modes' step 0): the
// non-empty slots in slot order, each slot's block id, origin relative to
// the camera (1e9 for an empty slot), max weight and 4^3 mip row, and the
// coarse and refine sample fractions (f64 divisions)
__device__ __forceinline__ void load_candidates(
    const Cam& c, const int* __restrict__ gids, const float* __restrict__ summary,
    const int* __restrict__ block_coords, int tile, int p, int LB, int s_coarse,
    int s_refine, int* s_gid, float (*s_borg)[MAX_LB], float* s_maxw, int* s_live,
    int* s_nlive, float* s_mip, float* s_cs, float* s_fr) {
  if (p < 32) {  // warp 0: list the non-empty slots (LB <= 32)
    const bool live = p < LB && gids[(size_t)tile * LB + p] >= 0;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    if (live) s_live[__popc(m & ((1u << p) - 1u))] = p;
    if (p == 0) *s_nlive = __popc(m);
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
  for (int s = p; s < s_coarse; s += NPIX)
    s_cs[s] = (float)(((double)s + 0.5) / (double)s_coarse);
  for (int s = p; s < s_refine; s += NPIX)
    s_fr[s] = (float)((double)s / (double)(s_refine - 1));
}

// thread 0 stages the state rows of the blocks in `mask` (TMA bulk copies,
// row r of the staged rows for the r-th picked slot); then every thread
// waits for them and decodes their packed sdf words to f32, once, in place
__device__ __forceinline__ void stage_rows(const int* __restrict__ state, int p,
                                           unsigned mask, uint32_t bar,
                                           const int* s_gid, int* s_row, int* s_rows) {
  if (p == 0) {
    unsigned m = mask;
    tma::mbar_expect_tx(bar, __popc(m) * ROW * 4);
    for (int r = 0; m; ++r, m &= m - 1) {
      const int l = __ffs(m) - 1;
      s_row[l] = r;
      tma::bulk_copy(s_rows + r * ROW, state + (size_t)s_gid[l] * ROW, ROW * 4, bar);
    }
  }
  __syncthreads();  // s_row
  tma::mbar_wait(bar, 0);
  for (int i = p; i < __popc(mask) * ROW; i += NPIX)
    s_rows[i] = __float_as_int(sdf_of(s_rows[i]));
  __syncthreads();
}

// pixel p's outputs: t*, confidence (the winner's max weight + 1), colour
// (the winner's 8 corner words, each loaded once, all three channels
// unpacked from them) and the hit flag, each masked by the hit
__device__ __forceinline__ void write_out(
    const Cam& c, const int* __restrict__ color, float* __restrict__ out, int tile,
    int p, bool found, float t_star, int win, int need_color, float dx, float dy,
    float dz, const float (*s_borg)[MAX_LB], const float* s_maxw, const int* s_gid) {
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
    int w[2][2][2];
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

__device__ __forceinline__ Cam make_cam(const Intr& in, const float* __restrict__ pose) {
  // c2w rows [R | t], 3 x 4, read from the device (no host read-back)
  return Cam{in.fx, in.fy, in.cx, in.cy, pose[0], pose[1], pose[2],
             pose[4], pose[5], pose[6], pose[8], pose[9], pose[10],
             pose[3], pose[7], pose[11], in.inv_vox, in.ext, in.fmin, in.fmax};
}

__global__ void __launch_bounds__(NPIX)
march_kernel(const int* __restrict__ gids, const int* __restrict__ state,
             const int* __restrict__ color, const float* __restrict__ summary,
             const int* __restrict__ block_coords, float* __restrict__ out,
             const float* __restrict__ pose, int LB, int tw, int s_coarse,
             int s_refine, int k_blocks, int need_color, Intr in) {
  const Cam c = make_cam(in, pose);
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
  load_candidates(c, gids, summary, block_coords, tile, p, LB, s_coarse, s_refine,
                  s_gid, s_borg, s_maxw, s_live, &s_nlive, s_mip, s_cs, s_fr);
  if (p < NQ) {
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

  // ---- 3. stage the picked blocks' state rows (TMA bulk copies) ----
  float dx, dy, dz;
  pixel_dir(c, tx0, ty0, p, dx, dy, dz);
  const int q = ((p / TILE) / 2) * 8 + (p % TILE) / 2;
  stage_rows(state, p, s_mask, bar, s_gid, s_row, s_rows);

  // ---- 4. refine the picked candidates at pixel resolution ----
  bool found = false;
  float t_star = 0.0f;
  int win = -1;
  for (int k = 0; k < kb; ++k) {
    const int slot = s_pick[k][q];
    if (slot >= LB) continue;
    const float bx = s_borg[0][slot], by = s_borg[1][slot], bz = s_borg[2][slot];
    float t0s, t1s;
    slab(bx, by, bz, dx, dy, dz, c.ext, c.fmin, c.fmax, t0s, t1s);
    t1s = fmaxf(t1s, t0s);
    const int info = s_info[slot * NQ + q];
    const bool an = (info >> 1) & 1;
    const float dt = (t1s - t0s) / (float)s_coarse;
    const float ts_neg = t0s + ((float)(info >> 2) + 0.5f) * dt;
    const int* row = s_rows + s_row[slot] * ROW;
    const float lo = an ? fmaxf(ts_neg - 1.5f * dt, t0s) : t0s;
    const float hi = an ? fminf(ts_neg + 0.5f * dt, t1s) : t1s;
    // virtual entry (lo, 1e-3) then s_refine samples over [lo, hi]
    float tlo, thi, vlo, vhi;
    const bool fk = bracket<false>(row, bx, by, bz, dx, dy, dz, c.inv_vox, lo, hi,
                                   s_fr, 0, s_refine, lo, 1e-3f, tlo, thi, vlo, vhi);
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
  // the quad's candidate flag: any of its blocks dipped below NEAR
  write_out(c, color, out, tile, p, found && s_qcand[q], t_star, win, need_color,
            dx, dy, dz, s_borg, s_maxw, s_gid);
}

__global__ void __launch_bounds__(NPIX)
track_kernel(const int* __restrict__ gids, const int* __restrict__ state,
             const int* __restrict__ color, const float* __restrict__ summary,
             const int* __restrict__ block_coords, float* __restrict__ out,
             const float* __restrict__ pose, int LB, int tw, int s_coarse,
             int s_refine, int k_blocks, int need_color, Intr in) {
  const Cam c = make_cam(in, pose);
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_gid[MAX_LB];
  __shared__ int s_row[MAX_LB];  // staged row of each picked slot
  __shared__ float s_borg[3][MAX_LB];
  __shared__ float s_maxw[MAX_LB];
  __shared__ int s_live[MAX_LB];  // the non-empty slots, in slot order
  __shared__ int s_nlive;
  __shared__ unsigned s_mask;
  __shared__ float s_dir[3][NPIX];            // each pixel's ray direction
  __shared__ unsigned s_ball[NWARP][MAX_LB];  // per warp and live slot: lanes that may hit
  __shared__ int s_off[MAX_LB * NWARP];       // first pair of (live slot, warp)
  __shared__ int s_npairs;
  extern __shared__ __align__(128) int s_dyn[];
  int* s_rows = s_dyn;                                          // [LB][512]
  // steps 2-3: per (live slot, pixel) pair its key and info, over the
  // staged rows
  float2* s_pair = reinterpret_cast<float2*>(s_dyn);            // [LB][NPIX]
  float* s_mip = reinterpret_cast<float*>(s_dyn + LB * ROW);    // [LB][64]
  // the pairs that may hit, live slot << 8 | pixel, block-major
  unsigned short* s_list = reinterpret_cast<unsigned short*>(s_mip + LB * 64);
  float* s_cs = reinterpret_cast<float*>(s_list + LB * NPIX);   // [s_coarse]
  float* s_fr = s_cs + s_coarse;                                // [s_refine]

  const int tile = blockIdx.x;
  const int p = threadIdx.x, lane = p & 31, warp = p >> 5;
  const float tx0 = (float)(tile % tw) * TILE;
  const float ty0 = (float)(tile / tw) * TILE;
  const uint32_t bar = tma::smem_addr(&s_bar);

  // ---- 0. the tile's candidates and the pixel directions ----
  if (p == 0) {
    tma::mbar_init(bar);
    s_mask = 0u;
  }
  load_candidates(c, gids, summary, block_coords, tile, p, LB, s_coarse, s_refine,
                  s_gid, s_borg, s_maxw, s_live, &s_nlive, s_mip, s_cs, s_fr);
  float dx, dy, dz;
  pixel_dir(c, tx0, ty0, p, dx, dy, dz);
  s_dir[0][p] = dx;
  s_dir[1][p] = dy;
  s_dir[2][p] = dz;
  __syncthreads();
  const int kb = k_blocks < LB ? k_blocks : LB;  // a pixel's picks
  const int nlive = s_nlive;

  // ---- 1. each pixel's blocks that its ray may hit, in slot order ----
  const float rx = slab_rcp(dx), ry = slab_rcp(dy), rz = slab_rcp(dz);
  unsigned may_hit = 0u;  // bit j: the ray may hit live slot j
  for (int j = 0; j < nlive; ++j) {
    const int l = s_live[j];
    const bool may = !slab_misses(s_borg[0][l], s_borg[1][l], s_borg[2][l], rx, ry, rz,
                                  c.ext, c.fmin, c.fmax);
    if (may) may_hit |= 1u << j;
    const unsigned b = __ballot_sync(0xffffffffu, may);
    if (lane == 0) s_ball[warp][j] = b;
  }
  __syncthreads();
  // number those pairs block-major, warp-minor: warp 0 scans the counts
  if (warp == 0) {
    const int n = nlive * NWARP;
    int carry = 0;
    for (int base = 0; base < n; base += 32) {
      const int e = base + lane;
      const int cnt = e < n ? __popc(s_ball[e % NWARP][e / NWARP]) : 0;
      int incl = cnt;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (e < n) s_off[e] = carry + incl - cnt;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) s_npairs = carry;
  }
  __syncthreads();
  const unsigned lanes_below = (1u << lane) - 1u;
  for (unsigned m = may_hit; m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    s_list[s_off[j * NWARP + warp] + __popc(s_ball[warp][j] & lanes_below)] =
        (unsigned short)((j << 8) | p);
  }
  __syncthreads();

  // ---- 2. their slab tests and mip samples, spread over the CTA's threads ----
  const float half = c.inv_vox * 0.5f;
  const int npairs = s_npairs;
  for (int i = p; i < npairs; i += NPIX) {
    const int e = s_list[i];
    const int j = e >> 8, q = e & 0xFF, l = s_live[j];
    const float dq[3] = {s_dir[0][q], s_dir[1][q], s_dir[2][q]};
    const float bo[3] = {s_borg[0][l], s_borg[1][l], s_borg[2][l]};
    float t0, t1;
    slab(bo[0], bo[1], bo[2], dq[0], dq[1], dq[2], c.ext, c.fmin, c.fmax, t0, t1);
    float minval = INFINITY;
    int info = 0;  // first negative sample << 2 | has one << 1
    // a miss takes no sample: its key stays inf
    for (int s = 0; s < (t1 > t0 ? s_coarse : 0); ++s) {
      const float ts = t0 + (t1 - t0) * s_cs[s];
      float lq[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        lq[a] = fminf(fmaxf((dq[a] * ts - bo[a]) * half - 0.5f, 0.0f), 3.0f);
      const float v = tri_mip(s_mip + l * 64, lq[0], lq[1], lq[2]);
      if (v < 0.0f) {
        info = (s << 2) | 2;
        break;
      }
      minval = fminf(minval, v);
    }
    const float key = info ? t0 - 1e4f : (minval < NEAR ? minval : INFINITY);
    s_pair[j * NPIX + q] = make_float2(key, __int_as_float(info));
  }
  __syncthreads();

  // ---- 3. each pixel keeps its kb smallest keys (the first slot on a tie) ----
  float pk[MAX_TRACK_K];
  int ps[MAX_TRACK_K], pi[MAX_TRACK_K];  // slot (LB: none), info
#pragma unroll
  for (int k = 0; k < MAX_TRACK_K; ++k) {
    pk[k] = INFINITY;
    ps[k] = LB;
    pi[k] = 0;
  }
  for (unsigned m = may_hit; m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    const float2 r = s_pair[j * NPIX + p];
    float key = r.x;
    int slot = s_live[j], info = __float_as_int(r.y);
#pragma unroll
    for (int k = 0; k < MAX_TRACK_K; ++k) {  // sorted insert, by (key, slot)
      if (k < kb && (key < pk[k] || (key == pk[k] && slot < ps[k] && key < INFINITY))) {
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
  tma::fence_proxy_async();  // the rows land where the pairs were
  __syncthreads();

  // ---- 4. stage the picked blocks' state rows (TMA bulk copies) ----
  stage_rows(state, p, s_mask, bar, s_gid, s_row, s_rows);

  // ---- 5. refine: two bracket stages per pick, each to its first crossing ----
  bool found = false;
  float t_star = 0.0f;
  int win = -1;
  for (int k = 0; k < kb; ++k) {
    const int slot = pick_at(ps, k);
    if (slot >= LB) break;  // the picks fill from the first
    const float bx = s_borg[0][slot], by = s_borg[1][slot], bz = s_borg[2][slot];
    float t0s, t1s;
    slab(bx, by, bz, dx, dy, dz, c.ext, c.fmin, c.fmax, t0s, t1s);
    // a refined t lies at or beyond t0s: this pick cannot beat the hit
    if (found && t0s >= t_star) continue;
    t1s = fmaxf(t1s, t0s);
    const int info = pick_at(pi, k);
    const bool an = (info >> 1) & 1;
    const float dt = (t1s - t0s) / (float)s_coarse;
    const float ts_neg = t0s + ((float)(info >> 2) + 0.5f) * dt;
    const int* row = s_rows + s_row[slot] * ROW;
    // the mip bracket widened by 1.25 / 0.25 coarse spacings (no negative
    // sample: the whole segment), then the sample pair it found (none: the
    // whole segment again)
    const float lo = an ? fmaxf(ts_neg - 1.25f * dt, t0s) : t0s;
    const float hi = an ? ts_neg + 0.25f * dt : t1s;
    const float tq0 = lo + (hi - lo) * s_fr[0];
    const float v0 = sample_row(row, bx, by, bz, dx, dy, dz, c.inv_vox, tq0);
    float tlo, thi, vlo, vhi;
    const bool f1 = bracket<true>(row, bx, by, bz, dx, dy, dz, c.inv_vox, lo, hi,
                                  s_fr, 1, s_refine, tq0, v0, tlo, thi, vlo, vhi);
    bool fk;
    if (f1) {
      // stage 2 over [tlo, thi] after its virtual entry: its first sample
      // (at tlo + (thi - tlo) * 0 = tlo) is stage 1's there, vlo >= 0, so
      // it starts from that sample
      const float l2 = tlo, h2 = thi, v2 = vlo;
      fk = bracket<true>(row, bx, by, bz, dx, dy, dz, c.inv_vox, l2, h2, s_fr, 1,
                         s_refine, l2, v2, tlo, thi, vlo, vhi);
    } else if (!an) {
      // stage 1 took stage 2's samples (both over [t0s, t1s]) and found no
      // crossing between them: only the virtual entry's pair can cross
      fk = v0 < 0.0f;
      tlo = fk ? t0s : 0.0f;
      thi = fk ? tq0 : 0.0f;
      vlo = fk ? 1e-3f : 0.0f;
      vhi = fk ? v0 : 0.0f;
    } else {
      // virtual entry (t0s, 1e-3) then s_refine samples over [t0s, t1s]
      fk = bracket<true>(row, bx, by, bz, dx, dy, dz, c.inv_vox, t0s, t1s, s_fr, 0,
                         s_refine, t0s, 1e-3f, tlo, thi, vlo, vhi);
    }
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
  write_out(c, color, out, tile, p, found, t_star, win, need_color, dx, dy, dz,
            s_borg, s_maxw, s_gid);
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
  auto* kernel = track ? track_kernel : march_kernel;
  const int smem = LB * SLOT_BYTES + (s_coarse + s_refine) * 4;
  // above 48 KiB of shared memory a kernel must opt in; the tracking
  // kernel's static arrays (~6 KiB) take it there from LB 15
  if (track || smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Intr in{fx, fy, cx, cy, inv_vox, ext, fmin, fmax};
  if (T > 0) {
    kernel<<<T, NPIX, smem, stream>>>(gids, state, color, summary, block_coords,
                                      out, pose, LB, tw, s_coarse, s_refine,
                                      k_blocks, need_color, in);
  }
  return (int)cudaGetLastError();
}
