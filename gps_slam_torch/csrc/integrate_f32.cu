// integrate_f32_cuda — the f32-I/O per-block TSDF + colour update for one
// RGB-D frame (frames above the packed kernel's size budget).
//
// Replaces BOTH TPU kernels behind gps_slam_tpu/tsdf/integrate_pallas.py
// `integrate_blocks`: `_kernel_resident` (K2a) and `_kernel_pregather`
// (K2b).  The two compute the same function and return identical outputs;
// they differ only in how the TPU stages each block's 64x64 pixel window
// into VMEM (K2a slices it out of the whole tiled image held in VMEM, K2b
// reads windows gathered into HBM beforehand, for frames whose tile planes
// exceed the VMEM budget).  On the H100 the f32 depth and packed rgb888
// images stay in device memory and L2 for both (2 x 8.3 MB at 1920x1080,
// of the 50 MB L2) and each voxel reads its one nearest tap directly, so
// one kernel serves both routes.  The TPU's one-hot matrix-unit select
// (f32 HIGHEST for depth, bf16 for colour bytes) picks exactly one pixel
// and is dropped.
//
// What bounds it on the H100: bytes.  Per block it reads four [512] planes
// (f32 sdf, weight and colour weight, packed colour: 8 KiB) and writes six
// f32 planes (sdf, weight, r, g, b, colour weight: 12 KiB) for ~110 flops
// per voxel, ~2.8 flop/byte, far below the card's ~20 flop/byte f32
// balance point.  The design keeps every plane in one coalesced pass: one
// thread block per visible block, one thread per voxel, so a row's 512
// voxels are 512 consecutive words (the [V, 512, 3] colour output is 1536
// consecutive floats).  Rows whose `valid` flag is 0 return at once and
// write nothing.
//
// Semantics (`_voxel_update`, computeUpdatedVoxelDepthInfo / ColorInfo):
// as integrate.cu — window anchored at the 32-px tile of the block's
// 8-corner min projection, update when the voxel projects inside the image
// (1 px rim excluded) and inside the window, the depth tap is > 0 and
// eta = d - z >= -mu; a tap past the image edge reads 0 (the TPU's
// zero-padded tiles).  Colour is in 0..1 units: the old colour is its byte
// divided by 255, a new tap its byte times f32(1/255), as the TPU kernels
// compute them.  Built with -fmad=false so every expression rounds like the
// plain PyTorch version (`integrate.integrate_blocks_plain`).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 8;
constexpr int VOL = 512;
constexpr int PT = 32;
constexpr int WIN = 64;
// f32 of the double 1/255, as the JAX package's `* (1.0 / 255.0)` rounds it
constexpr float INV255 = (float)(1.0 / 255.0);

__global__ void __launch_bounds__(VOL)
integrate_f32_kernel(const float* __restrict__ depth, const int* __restrict__ rgb,
                     const int* __restrict__ keys,
                     const unsigned char* __restrict__ valid,
                     const float* __restrict__ old_sdf,
                     const float* __restrict__ old_w,
                     const int* __restrict__ old_color,
                     const float* __restrict__ old_wc,
                     float* __restrict__ new_f, float* __restrict__ new_w,
                     float* __restrict__ new_c, float* __restrict__ new_wc,
                     const float* __restrict__ pose, int W, int H, float fx,
                     float fy, float cx, float cy, float vs, float mu,
                     int max_w) {
  __shared__ float s_uv[2][8];

  const int blk = blockIdx.x;
  if (!valid[blk]) return;  // padding row: nothing to compute or write
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

  // project this voxel and take its nearest tap inside the window
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
  const int ru = (int)rintf(fminf(fmaxf(u, -1e7f), 1e7f));
  const int rv = (int)rintf(fminf(fmaxf(v, -1e7f), 1e7f));
  const int iu = ru - ax * PT, iv = rv - ay * PT;
  const bool in_win = iu >= 0 && iu < WIN && iv >= 0 && iv < WIN;
  float d_meas = 0.0f, cm[3] = {0.0f, 0.0f, 0.0f};
  if (in_win && ru >= 0 && ru < W && rv >= 0 && rv < H) {
    const size_t pix = (size_t)rv * W + ru;
    d_meas = depth[pix];
    const int p = rgb[pix];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) cm[ch] = (float)((p >> (8 * ch)) & 0xFF) * INV255;
  }

  // running-average update on the f32 planes
  const size_t off = (size_t)blk * VOL + lin;
  const float of = old_sdf[off];
  const float ow = old_w[off];
  const float owc = old_wc[off];
  const float eta = d_meas - zc;
  const bool update = in_img && in_win && d_meas > 0.0f && eta >= -mu;
  const float eta_mu = eta / mu;
  const float den = ow + 1.0f;
  new_f[off] = update ? (ow * of + fminf(eta_mu, 1.0f)) / den : of;
  new_w[off] = update ? fminf(den, (float)max_w) : ow;
  const bool cu = update && eta <= mu && fabsf(eta_mu) < 0.25f;
  const int co = old_color[off];
  const float wc_den = owc + 1.0f;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float oc = (float)((co >> (8 * ch)) & 0xFF) / 255.0f;
    new_c[off * 3 + ch] = cu ? (oc * owc + cm[ch]) / wc_den : oc;
  }
  new_wc[off] = cu ? fminf(wc_den, (float)max_w) : owc;
}

}  // namespace

extern "C" int integrate_f32(
    const float* depth, const int* rgb, const int* keys,
    const unsigned char* valid, const float* old_sdf, const float* old_w,
    const int* old_color, const float* old_wc, float* new_f, float* new_w,
    float* new_c, float* new_wc, const float* pose, int V, int W, int H,
    float fx, float fy, float cx, float cy, float voxel_size, float mu,
    int max_w, cudaStream_t stream) {
  if (V > 0) {
    integrate_f32_kernel<<<V, VOL, 0, stream>>>(
        depth, rgb, keys, valid, old_sdf, old_w, old_color, old_wc, new_f,
        new_w, new_c, new_wc, pose, W, H, fx, fy, cx, cy, voxel_size, mu,
        max_w);
  }
  return (int)cudaGetLastError();
}
