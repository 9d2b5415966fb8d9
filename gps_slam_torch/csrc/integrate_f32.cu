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
// balance point.  A frame's 2,400-3,200 valid rows are few for 132 SMs, so
// what the design fights is each row's chain of dependent round trips to
// device memory, with as many warps in flight as the registers allow.  One
// CTA of 256 threads per row, thread t on the 2 consecutive x-voxels
// 2t, 2t + 1 (x = 2 (t & 3) + 0..1, y = (t >> 2) & 7, z = t >> 5):
//
//   1. `valid` is read first: a padding row returns before any other load
//      and writes nothing;
//   2. the key, and at once the four old planes as one 8-byte word each
//      (sdf, weight and colour weight as float2, colour as int2: 256
//      contiguous bytes per warp and plane), so they arrive while the
//      window anchor and the taps are computed;
//   3. the window anchor needs no shared memory and no barrier: lane j of
//      every warp projects corner j & 7 and three xor shuffles take each
//      coordinate's minimum;
//   4. the 2 voxels' depth and rgb taps are independent loads;
//   5. the outputs go out as streaming (evict-first) 8-byte stores: one
//      float2 each for sdf, weight and colour weight, and the thread's 6
//      consecutive colour floats as three.
//
// At 43 registers, 5 CTAs (40 warps) fit an SM.  Measured on the
// 1920x1080 path's last call (NVIDIA H100 80GB HBM3, 700 W, every build in
// one call): 0.0401 ms against 0.0475 for one thread per voxel and 512
// threads a row with a barrier; 128 threads x 4 voxels (61 registers,
// 16-byte words) 0.0447, with streaming stores 0.0437; 256 x 2 with plain
// stores 0.0410; 512 x 1 0.0418, with streaming stores 0.0408; persistent
// CTAs that load the next row's planes before updating the current one
// 0.0428-0.0478; register caps that spill 0.0420-0.0503.
//
// Every voxel keeps the f32 expressions and their order of the
// one-thread-per-voxel design it replaced (built with -fmad=false); the
// anchor is a min, which no order changes; so the outputs are the same
// bits.
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
constexpr int THREADS = 256;  // 2 voxels a thread
constexpr unsigned FULL = 0xffffffffu;
// f32 of the double 1/255, as the JAX package's `* (1.0 / 255.0)` rounds it
constexpr float INV255 = (float)(1.0 / 255.0);

__device__ __forceinline__ void st2(float* p, float a0, float a1) {
  __stcs(reinterpret_cast<float2*>(p), make_float2(a0, a1));
}

// one CTA per row
__global__ void __launch_bounds__(THREADS)
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
  const int r = blockIdx.x;
  if (!__ldg(valid + r)) return;  // padding row: nothing to compute or write
  const int t = threadIdx.x, lane = t & 31;

  // the key and this thread's voxels lin = 2t, 2t + 1 of the four old
  // planes, one 8-byte word each, before anything waits on them
  const size_t off = (size_t)r * VOL + 2 * t;
  const int key = __ldg(keys + r);
  const float2 of = __ldg(reinterpret_cast<const float2*>(old_sdf + off));
  const float2 ow = __ldg(reinterpret_cast<const float2*>(old_w + off));
  const float2 owc = __ldg(reinterpret_cast<const float2*>(old_wc + off));
  const int2 co = __ldg(reinterpret_cast<const int2*>(old_color + off));

  // w2c rows [R | t], 3 x 4, read from the device (no host read-back)
  float ps[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) ps[i] = __ldg(pose + i);
  const float r00 = ps[0], r01 = ps[1], r02 = ps[2], t0 = ps[3];
  const float r10 = ps[4], r11 = ps[5], r12 = ps[6], t1 = ps[7];
  const float r20 = ps[8], r21 = ps[9], r22 = ps[10], t2 = ps[11];
  const float bxw = (float)((key & 1023) - 512) * BLOCK;
  const float byw = (float)(((key >> 10) & 1023) - 512) * BLOCK;
  const float bzw = (float)(((key >> 20) & 1023) - 512) * BLOCK;

  // window anchor: min projection of the 8 block corners, corner lane & 7
  float umin, vmin;
  {
    const int c = lane & 7;
    const float ext = vs * BLOCK;
    const float px = bxw * vs + ((c >> 2) & 1 ? ext : 0.0f);
    const float py = byw * vs + ((c >> 1) & 1 ? ext : 0.0f);
    const float pz = bzw * vs + (c & 1 ? ext : 0.0f);
    float zc = r20 * px + r21 * py + r22 * pz + t2;
    zc = fmaxf(zc, 1e-6f);
    umin = fx * (r00 * px + r01 * py + r02 * pz + t0) / zc + cx;
    vmin = fy * (r10 * px + r11 * py + r12 * pz + t1) / zc + cy;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      umin = fminf(umin, __shfl_xor_sync(FULL, umin, o));
      vmin = fminf(vmin, __shfl_xor_sync(FULL, vmin, o));
    }
  }
  const int tw = (W + PT - 1) / PT, th = (H + PT - 1) / PT;
  const int ax = (int)fminf(fmaxf(floorf(umin / PT), 0.0f), (float)(tw - 2));
  const int ay = (int)fminf(fmaxf(floorf(vmin / PT), 0.0f), (float)(th - 2));

  // project the 2 voxels and take each one's nearest tap inside the window
  const int lin0 = 2 * t;
  const int x0 = lin0 % BLOCK, vy = (lin0 / BLOCK) % BLOCK, vz = lin0 / (BLOCK * BLOCK);
  float zc[2], d_meas[2], cm[2][3];
  bool seen[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float px = (bxw + (float)(x0 + j)) * vs;
    const float py = (byw + (float)vy) * vs;
    const float pz = (bzw + (float)vz) * vs;
    zc[j] = r20 * px + r21 * py + r22 * pz + t2;
    const float xc = r00 * px + r01 * py + r02 * pz + t0;
    const float yc = r10 * px + r11 * py + r12 * pz + t1;
    const float zs = fabsf(zc[j]) < 1e-9f ? 1e-9f : zc[j];
    const float u = fx * xc / zs + cx;
    const float v = fy * yc / zs + cy;
    const bool in_img = (zc[j] > 0.0f) && (u >= 1.0f) && (u <= (float)(W - 2)) &&
                        (v >= 1.0f) && (v <= (float)(H - 2));
    const int ru = (int)rintf(fminf(fmaxf(u, -1e7f), 1e7f));
    const int rv = (int)rintf(fminf(fmaxf(v, -1e7f), 1e7f));
    const int iu = ru - ax * PT, iv = rv - ay * PT;
    const bool in_win = iu >= 0 && iu < WIN && iv >= 0 && iv < WIN;
    seen[j] = in_img && in_win;
    d_meas[j] = 0.0f;
    cm[j][0] = cm[j][1] = cm[j][2] = 0.0f;
    if (in_win && ru >= 0 && ru < W && rv >= 0 && rv < H) {
      const size_t pix = (size_t)rv * W + ru;
      d_meas[j] = __ldg(depth + pix);
      const int p = __ldg(rgb + pix);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) cm[j][ch] = (float)((p >> (8 * ch)) & 0xFF) * INV255;
    }
  }

  // running-average update on the f32 planes
  const float ofs[2] = {of.x, of.y}, ows[2] = {ow.x, ow.y}, owcs[2] = {owc.x, owc.y};
  const int cws[2] = {co.x, co.y};
  float nf[2], nw[2], nwc[2], nc[6];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float eta = d_meas[j] - zc[j];
    const bool update = seen[j] && d_meas[j] > 0.0f && eta >= -mu;
    const float eta_mu = eta / mu;
    const float den = ows[j] + 1.0f;
    nf[j] = update ? (ows[j] * ofs[j] + fminf(eta_mu, 1.0f)) / den : ofs[j];
    nw[j] = update ? fminf(den, (float)max_w) : ows[j];
    const bool cu = update && eta <= mu && fabsf(eta_mu) < 0.25f;
    const float wc_den = owcs[j] + 1.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float oc = (float)((cws[j] >> (8 * ch)) & 0xFF) / 255.0f;
      nc[3 * j + ch] = cu ? (oc * owcs[j] + cm[j][ch]) / wc_den : oc;
    }
    nwc[j] = cu ? fminf(wc_den, (float)max_w) : owcs[j];
  }
  st2(new_f + off, nf[0], nf[1]);
  st2(new_w + off, nw[0], nw[1]);
  st2(new_wc + off, nwc[0], nwc[1]);
  // the thread's 6 consecutive colour floats, as three 8-byte words
  float* cp = new_c + off * 3;
  st2(cp, nc[0], nc[1]);
  st2(cp + 2, nc[2], nc[3]);
  st2(cp + 4, nc[4], nc[5]);
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
    integrate_f32_kernel<<<V, THREADS, 0, stream>>>(
        depth, rgb, keys, valid, old_sdf, old_w, old_color, old_wc, new_f,
        new_w, new_c, new_wc, pose, W, H, fx, fy, cx, cy, voxel_size, mu,
        max_w);
  }
  return (int)cudaGetLastError();
}
