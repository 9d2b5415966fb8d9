// integrate_cuda — per-block TSDF + colour update for one RGB-D frame.
//
// Replaces the TPU kernel gps_slam_tpu/tsdf/integrate_pallas.py
// `_kernel_resident_packed` (entry `integrate_blocks_packed`), including
// the caller's scatter-back (`integrate._finish_fuse_packed`): the state,
// colour and summary rows are written in place into the pool through the
// per-block pool rows `ptrs`, so nothing is staged in a [V, 512] buffer.
//
// What bounds it on the H100: bytes.  Per block it reads and writes 512
// state words and 512 colour words (4 KiB) and does ~100 flops per voxel,
// far below the card's 20 flop/byte float32 balance point.  The design
// keeps each pool row in one pass: one thread block per integration block,
// one thread per voxel, so the 512 voxels of a row are 512 consecutive
// 4-byte words read and written fully coalesced.  The image taps are
// nearest-pixel reads from the f32 depth and packed rgb888 images, which
// stay in L2 (2 x 3.3 MB at 1200x680); the TPU's bf16 hi/lo tile planes
// and one-hot matrix-unit select exist only for its VMEM and are dropped.
// The 2x2x2 sdf mip, min sdf and max weight of the summary row are a
// block-level reduction in shared memory, in f32.
//
// Semantics (computeUpdatedVoxelDepthInfo / ColorInfo): a voxel updates
// when it projects inside the image (1 px rim excluded) and inside its
// block's 64x64 window anchored at the 32-px tile of the block's 8-corner
// min projection, the depth tap is > 0 and eta = d - z >= -mu.  sdf is
// quantized as round(clip(f, -1, 1) * 32767), colour as
// trunc(clip(c + 0.5, 0, 255)), weights clamp at max_w.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 8;
constexpr int VOL = 512;
constexpr int PT = 32;
constexpr int WIN = 64;

__global__ void __launch_bounds__(VOL)
integrate_kernel(const float* __restrict__ depth, const int* __restrict__ rgb,
                 const int* __restrict__ keys, const int* __restrict__ ptrs,
                 int* __restrict__ state, int* __restrict__ color,
                 float* __restrict__ summary, const float* __restrict__ pose,
                 int W, int H, float fx, float fy, float cx, float cy,
                 float vs, float mu, int max_w) {
  __shared__ float s_f[VOL];
  __shared__ float s_red[2][VOL / 32];
  __shared__ float s_uv[2][8];

  const int blk = blockIdx.x;
  const int row = ptrs[blk];
  if (row < 0) return;  // dropped candidate: nothing to update
  const int key = keys[blk];
  const int lin = threadIdx.x;
  // w2c rows [R | t], 3 x 4, read from the device (no host read-back)
  const float r00 = pose[0], r01 = pose[1], r02 = pose[2], t0 = pose[3];
  const float r10 = pose[4], r11 = pose[5], r12 = pose[6], t1 = pose[7];
  const float r20 = pose[8], r21 = pose[9], r22 = pose[10], t2 = pose[11];
  const float bxw = (float)((key & 1023) - 512) * BLOCK;
  const float byw = (float)(((key >> 10) & 1023) - 512) * BLOCK;
  const float bzw = (float)(((key >> 20) & 1023) - 512) * BLOCK;

  // window anchor: min projection of the 8 block corners
  if (lin < 8) {
    const float ext = vs * BLOCK;
    const float px = bxw * vs + ((lin >> 2) & 1 ? ext : 0.0f);
    const float py = byw * vs + ((lin >> 1) & 1 ? ext : 0.0f);
    const float pz = bzw * vs + (lin & 1 ? ext : 0.0f);
    float zc = r20 * px + r21 * py + r22 * pz + t2;
    zc = fmaxf(zc, 1e-6f);
    s_uv[0][lin] = fx * (r00 * px + r01 * py + r02 * pz + t0) / zc + cx;
    s_uv[1][lin] = fy * (r10 * px + r11 * py + r12 * pz + t1) / zc + cy;
  }
  __syncthreads();
  float umin = s_uv[0][0], vmin = s_uv[1][0];
#pragma unroll
  for (int c = 1; c < 8; ++c) {
    umin = fminf(umin, s_uv[0][c]);
    vmin = fminf(vmin, s_uv[1][c]);
  }
  const int tw = (W + PT - 1) / PT, th = (H + PT - 1) / PT;
  const int ax = (int)fminf(fmaxf(floorf(umin / PT), 0.0f), (float)(tw - 2));
  const int ay = (int)fminf(fmaxf(floorf(vmin / PT), 0.0f), (float)(th - 2));

  // project this voxel
  const float px = (bxw + (float)(lin % BLOCK)) * vs;
  const float py = (byw + (float)((lin / BLOCK) % BLOCK)) * vs;
  const float pz = (bzw + (float)(lin / (BLOCK * BLOCK))) * vs;
  const float zc = r20 * px + r21 * py + r22 * pz + t2;
  const float xc = r00 * px + r01 * py + r02 * pz + t0;
  const float yc = r10 * px + r11 * py + r12 * pz + t1;
  const float zs = fabsf(zc) < 1e-9f ? 1e-9f : zc;
  const float u = fx * xc / zs + cx;
  const float v = fy * yc / zs + cy;
  const bool in_img = (zc > 0.0f) && (u >= 1.0f) && (u <= (float)(W - 2)) &&
                      (v >= 1.0f) && (v <= (float)(H - 2));
  const float ruf = rintf(fminf(fmaxf(u, -1e7f), 1e7f));
  const float rvf = rintf(fminf(fmaxf(v, -1e7f), 1e7f));
  const int ru = (int)ruf, rv = (int)rvf;
  const int iu = ru - ax * PT, iv = rv - ay * PT;
  const bool in_win = iu >= 0 && iu < WIN && iv >= 0 && iv < WIN;
  float d_meas = 0.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f;
  if (in_win && ru >= 0 && ru < W && rv >= 0 && rv < H) {
    const size_t pix = (size_t)rv * W + ru;
    d_meas = depth[pix];
    const int p = rgb[pix];
    cr = (float)(p & 0xFF);
    cg = (float)((p >> 8) & 0xFF);
    cb = (float)((p >> 16) & 0xFF);
  }

  // running-average update
  const size_t off = (size_t)row * VOL + lin;
  const int po = state[off];
  int su = po & 0xFFFF;
  su = su >= 32768 ? su - 65536 : su;
  const float old_f = (float)su * (1.0f / 32767.0f);
  const float old_w = (float)((po >> 16) & 0xFF);
  const float old_wc = (float)((po >> 24) & 0xFF);
  const float eta = d_meas - zc;
  const bool update = in_img && in_win && d_meas > 0.0f && eta >= -mu;
  const float new_obs = fminf(1.0f, eta / mu);
  const float den = old_w + 1.0f;
  const float new_f = update ? (old_w * old_f + new_obs) / den : old_f;
  const float new_w = update ? fminf(den, (float)max_w) : old_w;
  const bool cu = update && eta <= mu && fabsf(eta / mu) < 0.25f;
  const int co = color[off];
  const float wc_den = old_wc + 1.0f;
  const float cm[3] = {cr, cg, cb};
  int new_cp = 0;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float oc = (float)((co >> (8 * ch)) & 0xFF);
    const float nc = cu ? (oc * old_wc + cm[ch]) / wc_den : oc;
    const int q = (int)fminf(fmaxf(nc + 0.5f, 0.0f), 255.0f);
    new_cp |= q << (8 * ch);
  }
  const float new_wc = cu ? fminf(wc_den, (float)max_w) : old_wc;
  const int sdf_q = (int)rintf(fminf(fmaxf(new_f, -1.0f), 1.0f) * 32767.0f);
  state[off] = (sdf_q & 0xFFFF) | ((int)new_w << 16) | ((int)new_wc << 24);
  color[off] = new_cp;

  // summary row: 2x2x2 mip (f32), min integrated sdf, max weight
  s_f[lin] = new_f;
  float mn = new_w > 0.0f ? new_f : 1.0f;
  float mx = new_w;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if ((lin & 31) == 0) {
    s_red[0][lin >> 5] = mn;
    s_red[1][lin >> 5] = mx;
  }
  __syncthreads();
  float* srow = summary + (size_t)row * 128;
  if (lin < 64) {
    const int mxi = lin & 3, myi = (lin >> 2) & 3, mzi = lin >> 4;
    float acc = 0.0f;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx)
          acc += s_f[(2 * mxi + dx) + 8 * (2 * myi + dy) + 64 * (2 * mzi + dz)];
    srow[lin] = acc * 0.125f;
  } else if (lin == 64) {
    float m = s_red[0][0];
    for (int i = 1; i < VOL / 32; ++i) m = fminf(m, s_red[0][i]);
    srow[64] = m;
  } else if (lin == 65) {
    float m = s_red[1][0];
    for (int i = 1; i < VOL / 32; ++i) m = fmaxf(m, s_red[1][i]);
    srow[65] = m;
  } else if (lin < 128) {
    srow[lin] = 0.0f;
  }
}

}  // namespace

extern "C" int integrate_packed(
    const float* depth, const int* rgb, const int* keys, const int* ptrs,
    int* state, int* color, float* summary, const float* pose, int V, int W,
    int H, float fx, float fy, float cx, float cy, float voxel_size,
    float mu, int max_w, cudaStream_t stream) {
  if (V > 0) {
    integrate_kernel<<<V, VOL, 0, stream>>>(
        depth, rgb, keys, ptrs, state, color, summary, pose, W, H, fx, fy,
        cx, cy, voxel_size, mu, max_w);
  }
  return (int)cudaGetLastError();
}
