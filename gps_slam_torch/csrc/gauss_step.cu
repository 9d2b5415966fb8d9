// project_sh_fwd_cuda, project_sh_bwd_cuda — the per-Gaussian head of an
// Adam step: the projection of each Gaussian and its SH colour, and their
// analytic backward.
//
// Replaces no TPU kernel: the counterpart of the XLA fusions that the JAX
// package makes of `_project_and_colors` (gps_slam_tpu/gs/model.py:58-79:
// projection.project, gps_slam_tpu/gs/projection.py:72, and sh.eval_sh,
// gps_slam_tpu/gs/sh.py:44) and of their `jax.grad` inside the window's
// `lax.scan` (model.py:357-404).  Their plain versions are
// gps_slam_torch/gs/projection.py (`project_fwd_plain`,
// `project_bwd_plain`) and gps_slam_torch/gs/sh.py (`eval_sh`,
// `eval_sh_bwd_plain`), composed in gps_slam_torch/gs/gauss_step.py; every
// f32 expression here is theirs, in their order, built with -fmad=false,
// true divisions and square roots, rsqrtf and expf as torch's CUDA ops
// take them, so the two give the same bits on the card.
//
//   project_sh_fwd  a CTA of 64 threads a tile of FWD_ROWS = 64 rows: (1)
//                   the tile's means, quaternions and log-scales staged in
//                   shared memory; (2) one lane a row: the camera point,
//                   the camera covariance, the clamped Jacobian, the
//                   blurred 2D covariance, its conic, the 3-sigma radius
//                   and the cull; (3) the visible rows (radius > 0)
//                   listed, then one lane a (row, channel): the SH colour
//                   of the view direction (+0.5, clamped at 0; 0.5 where
//                   the radius is 0, its SH not read), the lane's 16
//                   coefficients read at once; (4) means2d, conics,
//                   depths, radii (at most max_radii) and colours stored
//                   from shared memory.
//   project_sh_bwd  a CTA of 2 warps a tile of BWD_ROWS = 32 rows: (1) the
//                   tile's inputs, radii and cotangents (a null pointer is
//                   a zero cotangent) staged; (2) warp 0, one lane a row:
//                   the projection's intermediates again, then their
//                   chain back to the quaternions, the log-scales and the
//                   projection's part of the means' grad; beside it warp
//                   1, one lane a row: the SH of its three channels, the
//                   colour grads, both SH coefficient grads and the view
//                   direction's part of the means' grad; (3) every grad
//                   stored from shared memory, the means' as the sum of
//                   its two parts.
//
// Bound: bytes.  At SH degree 3 a row is 58 f32 (means 3, quats 4,
// log-scales 3, SH 48) and the alive flag; only a visible row needs its
// 48 SH floats and its colours' cotangent.  The forward reads 41 B a row
// and 192 B more a visible row and writes 40 B; the backward reads 68 B a
// row and 204 B more a visible row and writes 232 B; against ~260 + ~210
// a visible row (forward) and ~560 + ~540 (backward) f32 operations.  The
// first design ran one thread a row: 128 CTAs of 256 threads on 132 SMs
// at the main path's 32,768 rows, each thread's loads and stores 4 bytes
// at its row's stride, so a warp's access to features_rest (180 B a row)
// touched 32 lines and the backward's 45 strided stores a row set its
// time.  Here every input and output of a tile is one contiguous slab per
// array, moved between device and shared memory by consecutive threads in
// 16-byte words (4-byte words for a ragged tail or a base that is not
// 16-byte aligned), so every load and store is coalesced, and the loads
// of the camera, the SH ramp and the alive flags are in flight with the
// slabs'.  At 32,768 rows every CTA of either kernel is resident at once
// (the backward's 1,024 CTAs of 96 registers a thread: 10 an SM), so a
// kernel's time is one tile's chain of latencies: its loads, the
// projection, (forward) the visible rows' SH loads, its stores.  Two lanes
// work on a backward row, the SH's beside the projection's; a lane a
// (row, channel), the channels' shares summed across lanes, timed slower
// (more instructions, and 64 registers to keep 4-warp CTAs resident).
// The forward's SH takes a lane a visible (row, channel), which timed
// faster than a lane a row; its projection stays one chain a lane:
// 32-row CTAs of 96 threads timed no faster.  The backward reads every
// row's SH, as its plain version does: a culled row's view-direction
// terms are zeros whose signs, or NaNs, come from its coefficients.  The
// kernels are instanced per SH degree (0-4), so the band loops unroll and
// the shared arrays take the degree's size; features_rest rows wider than
// the degree needs are read up to the degree and their grads written as
// zeros past it.  Nothing is read back to the host: the camera (view
// matrix and c2w) and the SH ramp's active degree are read on the device,
// so a CUDA graph captures both launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#define F(x) ((float)(x))   // a constant as torch takes a Python float: f64, then f32

constexpr int FWD_ROWS = 64;               // the forward's tile, a lane a row
constexpr int FWD_THREADS = FWD_ROWS;      // each lane also a SH item, (row, channel)
constexpr int BWD_ROWS = 32;               // the backward's tile: a warp's lanes
constexpr int BWD_THREADS = 2 * BWD_ROWS;  // warp 0 the projection, warp 1 the SH

struct Cam {
  float fx, fy, cx, cy, lim_x_neg, lim_x_pos, lim_y_neg, lim_y_pos, eps2d;
};

// torch.clamp (NaN passes through)
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return (a0 * b0 + a1 * b1) + a2 * b2;
}

// `projection._fma`: a b + c in f64, rounded to f32
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return (float)((double)a * (double)b + (double)c);
}

// ---- slabs: a tile's rows of one [N, w] array, between device and shared
// memory, by the CTA's `nt` threads (thread `t`), consecutive threads on
// consecutive words.  The shared side is 16-byte aligned; 16-byte words
// where the device side is too, else (and for the tail) 4-byte words.

template <class T>
__device__ __forceinline__ void load_slab(T* dst, const T* __restrict__ src, int n, int t,
                                          int nt) {
  int i = t;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    for (; i < n4; i += nt)
      reinterpret_cast<uint4*>(dst)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    i = (n4 << 2) + t;
  }
  for (; i < n; i += nt) dst[i] = __ldg(src + i);
}

// a cotangent's slab, zeros for a null pointer
__device__ __forceinline__ void load_cot(float* dst, const float* __restrict__ src, int n,
                                         int t, int nt) {
  if (src) {
    load_slab(dst, src, n, t, nt);
  } else {
    for (int i = t; i < n; i += nt) dst[i] = 0.f;
  }
}

// a + b of two [n] shared slabs, element by element
__device__ __forceinline__ void store_sum(float* __restrict__ dst, const float* a,
                                          const float* b, int n, int t, int nt) {
  int i = t;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = n >> 2;
    for (; i < n4; i += nt) {
      const float4 x = reinterpret_cast<const float4*>(a)[i];
      const float4 y = reinterpret_cast<const float4*>(b)[i];
      reinterpret_cast<float4*>(dst)[i] = make_float4(x.x + y.x, x.y + y.y, x.z + y.z,
                                                      x.w + y.w);
    }
    i = (n4 << 2) + t;
  }
  for (; i < n; i += nt) dst[i] = a[i] + b[i];
}

template <class T>
__device__ __forceinline__ void store_slab(T* __restrict__ dst, const T* src, int n, int t,
                                           int nt) {
  int i = t;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int n4 = n >> 2;
    for (; i < n4; i += nt)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    i = (n4 << 2) + t;
  }
  for (; i < n; i += nt) dst[i] = src[i];
}

// the first W floats of each of `rows` rows of width w (>= W) into a
// [rows, W] slab
template <int W>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int rows,
                                          int w, int t, int nt) {
  if (w == W) {
    load_slab(dst, src, rows * W, t, nt);
    return;
  }
  for (int e = t; e < rows * W; e += nt) {
    const int r = e / W;
    dst[e] = __ldg(src + (size_t)r * w + (e - r * W));
  }
}

// a [rows, W] slab into rows of width w (>= W), zeros past W
template <int W>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float* src, int rows,
                                           int w, int t, int nt) {
  if (w == W) {
    store_slab(dst, src, rows * W, t, nt);
    return;
  }
  for (int e = t; e < rows * w; e += nt) {
    const int r = e / w, j = e - r * w;
    dst[e] = j < W ? src[r * W + j] : 0.f;
  }
}

// ---- one row's projection

// the view matrix's rows [R | t]
struct View {
  float R[3][3], t[3];
};

__device__ __forceinline__ void load_view(const float* __restrict__ viewmat, View& v) {
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k) v.R[i][k] = __ldg(viewmat + 4 * i + k);
    v.t[i] = __ldg(viewmat + 4 * i + 3);
  }
}

// `projection._forward_terms` of one row
struct Terms {
  float R[3][3];
  float mc[3];
  float qn[4], qinv;
  float r[3][3], s[3], m[3][3];
  float c00, c01, c02, c11, c12, c22;
  float rz, rz2, ux, uy, tx, ty, j00, j02, j11, j12;
  float a00, a01, a11, det, D;
  bool det_ok;
};

// `mean` and `log_scale`: the row's 3 floats; `q`: its quaternion (w, x, y, z)
__device__ __forceinline__ void forward_terms(const float* mean, float4 q,
                                              const float* log_scale, const View& view,
                                              const Cam& cam, Terms& f) {
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) f.R[i][k] = view.R[i][k];
  const float px = mean[0], py = mean[1], pz = mean[2];
  // `projection.camera_point`: the CPU matmul's multiply-add chain, each
  // step rounded once to f32 through an exact f64 product
  for (int i = 0; i < 3; ++i)
    f.mc[i] = fma32(f.R[i][2], pz, fma32(f.R[i][1], py, f.R[i][0] * px)) + view.t[i];

  float w = q.x, x = q.y, y = q.z, z = q.w;
  const float inv = rsqrtf((((w * w + x * x) + y * y) + z * z) + F(1e-20));
  w = w * inv;
  x = x * inv;
  y = y * inv;
  z = z * inv;
  f.qn[0] = w; f.qn[1] = x; f.qn[2] = y; f.qn[3] = z;
  f.qinv = inv;
  f.r[0][0] = 1.f - 2.f * (y * y + z * z);
  f.r[0][1] = 2.f * (x * y - w * z);
  f.r[0][2] = 2.f * (x * z + w * y);
  f.r[1][0] = 2.f * (x * y + w * z);
  f.r[1][1] = 1.f - 2.f * (x * x + z * z);
  f.r[1][2] = 2.f * (y * z - w * x);
  f.r[2][0] = 2.f * (x * z - w * y);
  f.r[2][1] = 2.f * (y * z + w * x);
  f.r[2][2] = 1.f - 2.f * (x * x + y * y);
  for (int k = 0; k < 3; ++k) f.s[k] = expf(log_scale[k]);
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) f.m[i][k] = f.r[i][k] * f.s[k];
  // world covariance M M^T, symmetric
  float cw[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = i; j < 3; ++j) {
      cw[i][j] = dot3(f.m[i][0], f.m[i][1], f.m[i][2], f.m[j][0], f.m[j][1], f.m[j][2]);
      cw[j][i] = cw[i][j];
    }
  float a[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      a[i][j] = dot3(f.R[i][0], f.R[i][1], f.R[i][2], cw[0][j], cw[1][j], cw[2][j]);
  auto cc = [&](int i, int j) {
    return dot3(a[i][0], a[i][1], a[i][2], f.R[j][0], f.R[j][1], f.R[j][2]);
  };
  f.c00 = cc(0, 0); f.c01 = cc(0, 1); f.c02 = cc(0, 2);
  f.c11 = cc(1, 1); f.c12 = cc(1, 2); f.c22 = cc(2, 2);

  const float mx = f.mc[0], my = f.mc[1], mz = f.mc[2];
  const float zsafe = fabsf(mz) < F(1e-8) ? F(1e-8) : mz;
  f.rz = 1.f / zsafe;
  f.rz2 = f.rz * f.rz;
  f.ux = mx * f.rz;
  f.uy = my * f.rz;
  f.tx = mz * clampf(f.ux, -cam.lim_x_neg, cam.lim_x_pos);
  f.ty = mz * clampf(f.uy, -cam.lim_y_neg, cam.lim_y_pos);
  f.j00 = cam.fx * f.rz;
  f.j02 = (-cam.fx) * f.tx * f.rz2;
  f.j11 = cam.fy * f.rz;
  f.j12 = (-cam.fy) * f.ty * f.rz2;
  const float j00 = f.j00, j02 = f.j02, j11 = f.j11, j12 = f.j12;
  float a00 = (j00 * j00 * f.c00 + 2.f * j00 * j02 * f.c02) + j02 * j02 * f.c22;
  const float a01 = ((j00 * j11 * f.c01 + j00 * j12 * f.c02) + j02 * j11 * f.c12)
                    + j02 * j12 * f.c22;
  float a11 = (j11 * j11 * f.c11 + 2.f * j11 * j12 * f.c12) + j12 * j12 * f.c22;
  a00 = a00 + cam.eps2d;
  a11 = a11 + cam.eps2d;
  f.a00 = a00;
  f.a01 = a01;
  f.a11 = a11;
  f.det = a00 * a11 - a01 * a01;
  f.det_ok = f.det > 0.f;
  f.D = f.det_ok ? f.det : 1.f;
}

// ---- the SH

// `sh.eval_sh` of one channel: the band sums, each band scaled by f[b];
// c(k) is the channel's coefficient k
template <int DEG, class Coeff>
__device__ __forceinline__ float eval_sh(Coeff c, float x, float y, float z, const float* f) {
  float res = F(0.28209479177387814) * c(0);
  if (DEG >= 1)
    res = res + f[1] * (F(0.4886025119029199) * (((-y) * c(1) + z * c(2)) - x * c(3)));
  if (DEG >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z, xy = x * y, yz = y * z, xz = x * z;
    float b = F(1.0925484305920792) * xy * c(4);
    b = b + F(-1.0925484305920792) * yz * c(5);
    b = b + F(0.31539156525252005) * ((2.f * zz - xx) - yy) * c(6);
    b = b + F(-1.0925484305920792) * xz * c(7);
    b = b + F(0.5462742152960396) * (xx - yy) * c(8);
    res = res + f[2] * b;
    if (DEG >= 3) {
      b = F(-0.5900435899266435) * y * (3.f * xx - yy) * c(9);
      b = b + F(2.890611442640554) * xy * z * c(10);
      b = b + F(-0.4570457994644658) * y * ((4.f * zz - xx) - yy) * c(11);
      b = b + F(0.3731763325901154) * z * ((2.f * zz - 3.f * xx) - 3.f * yy) * c(12);
      b = b + F(-0.4570457994644658) * x * ((4.f * zz - xx) - yy) * c(13);
      b = b + F(1.445305721320277) * z * (xx - yy) * c(14);
      b = b + F(-0.5900435899266435) * x * (xx - 3.f * yy) * c(15);
      res = res + f[3] * b;
    }
    if (DEG >= 4) {
      b = F(2.5033429417967046) * xy * (xx - yy) * c(16);
      b = b + F(-1.7701307697799304) * yz * (3.f * xx - yy) * c(17);
      b = b + F(0.9461746957575601) * xy * (7.f * zz - 1.f) * c(18);
      b = b + F(-0.6690465435572892) * yz * (7.f * zz - 3.f) * c(19);
      b = b + F(0.10578554691520431) * (zz * (35.f * zz - 30.f) + 3.f) * c(20);
      b = b + F(-0.6690465435572892) * xz * (7.f * zz - 3.f) * c(21);
      b = b + F(0.47308734787878004) * (xx - yy) * (7.f * zz - 1.f) * c(22);
      b = b + F(-1.7701307697799304) * xz * (xx - 3.f * yy) * c(23);
      b = b + F(0.6258357354491761) * (xx * (xx - 3.f * yy) - yy * (3.f * xx - yy)) * c(24);
      res = res + f[4] * b;
    }
  }
  return res;
}

// `sh.eval_sh_bwd_plain`'s walk over the coefficients k = 1 .. (DEG+1)^2 - 1
// of the unit direction (x_, y_, z_): term(k, band, value, d0, d1, d2,
// first) with the basis value of k and its derivatives along x, y and z
// (null: zero); `first` marks band 1, where each derivative is the first
// of its sum
template <int DEG, class Term>
__device__ __forceinline__ void sh_terms(float x_, float y_, float z_, Term&& term) {
  if (DEG >= 1) {
    const float C1 = F(0.4886025119029199), mC1 = F(-0.4886025119029199);
    float t;
    t = mC1; term(1, 1, mC1 * y_, nullptr, &t, nullptr, true);
    t = C1;  term(2, 1, C1 * z_, nullptr, nullptr, &t, true);
    t = mC1; term(3, 1, mC1 * x_, &t, nullptr, nullptr, true);
  }
  if (DEG >= 2) {
    const float xx = x_ * x_, yy = y_ * y_, zz = z_ * z_;
    const float xy = x_ * y_, yz = y_ * z_, xz = x_ * z_;
    float a0, a1, a2;
    {
      const float c0_ = F(1.0925484305920792), c1_ = F(-1.0925484305920792),
                  c2_ = F(0.31539156525252005), c3_ = F(-1.0925484305920792),
                  c4_ = F(0.5462742152960396);
      a0 = c0_ * y_; a1 = c0_ * x_;
      term(4, 2, c0_ * xy, &a0, &a1, nullptr, false);
      a1 = c1_ * z_; a2 = c1_ * y_;
      term(5, 2, c1_ * yz, nullptr, &a1, &a2, false);
      a0 = c2_ * (-2.f * x_); a1 = c2_ * (-2.f * y_); a2 = c2_ * (4.f * z_);
      term(6, 2, c2_ * ((2.f * zz - xx) - yy), &a0, &a1, &a2, false);
      a0 = c3_ * z_; a2 = c3_ * x_;
      term(7, 2, c3_ * xz, &a0, nullptr, &a2, false);
      a0 = c4_ * (2.f * x_); a1 = c4_ * (-2.f * y_);
      term(8, 2, c4_ * (xx - yy), &a0, &a1, nullptr, false);
    }
    if (DEG >= 3) {
      const float c0_ = F(-0.5900435899266435), c1_ = F(2.890611442640554),
                  c2_ = F(-0.4570457994644658), c3_ = F(0.3731763325901154),
                  c4_ = F(-0.4570457994644658), c5_ = F(1.445305721320277),
                  c6_ = F(-0.5900435899266435);
      a0 = c0_ * (6.f * xy); a1 = c0_ * (3.f * xx - 3.f * yy);
      term(9, 3, c0_ * y_ * (3.f * xx - yy), &a0, &a1, nullptr, false);
      a0 = c1_ * yz; a1 = c1_ * xz; a2 = c1_ * xy;
      term(10, 3, c1_ * xy * z_, &a0, &a1, &a2, false);
      a0 = c2_ * (-2.f * xy); a1 = c2_ * ((4.f * zz - xx) - 3.f * yy); a2 = c2_ * (8.f * yz);
      term(11, 3, c2_ * y_ * ((4.f * zz - xx) - yy), &a0, &a1, &a2, false);
      a0 = c3_ * (-6.f * xz); a1 = c3_ * (-6.f * yz); a2 = c3_ * ((6.f * zz - 3.f * xx) - 3.f * yy);
      term(12, 3, c3_ * z_ * ((2.f * zz - 3.f * xx) - 3.f * yy), &a0, &a1, &a2, false);
      a0 = c4_ * ((4.f * zz - 3.f * xx) - yy); a1 = c4_ * (-2.f * xy); a2 = c4_ * (8.f * xz);
      term(13, 3, c4_ * x_ * ((4.f * zz - xx) - yy), &a0, &a1, &a2, false);
      a0 = c5_ * (2.f * xz); a1 = c5_ * (-2.f * yz); a2 = c5_ * (xx - yy);
      term(14, 3, c5_ * z_ * (xx - yy), &a0, &a1, &a2, false);
      a0 = c6_ * (3.f * xx - 3.f * yy); a1 = c6_ * (-6.f * xy);
      term(15, 3, c6_ * x_ * (xx - 3.f * yy), &a0, &a1, nullptr, false);
    }
    if (DEG >= 4) {
      const float c0_ = F(2.5033429417967046), c1_ = F(-1.7701307697799304),
                  c2_ = F(0.9461746957575601), c3_ = F(-0.6690465435572892),
                  c4_ = F(0.10578554691520431), c5_ = F(-0.6690465435572892),
                  c6_ = F(0.47308734787878004), c7_ = F(-1.7701307697799304),
                  c8_ = F(0.6258357354491761);
      a0 = c0_ * y_ * (3.f * xx - yy); a1 = c0_ * x_ * (xx - 3.f * yy);
      term(16, 4, c0_ * xy * (xx - yy), &a0, &a1, nullptr, false);
      a0 = c1_ * (6.f * xy) * z_; a1 = c1_ * z_ * (3.f * xx - 3.f * yy);
      a2 = c1_ * y_ * (3.f * xx - yy);
      term(17, 4, c1_ * yz * (3.f * xx - yy), &a0, &a1, &a2, false);
      a0 = c2_ * y_ * (7.f * zz - 1.f); a1 = c2_ * x_ * (7.f * zz - 1.f);
      a2 = c2_ * (14.f * xy) * z_;
      term(18, 4, c2_ * xy * (7.f * zz - 1.f), &a0, &a1, &a2, false);
      a1 = c3_ * z_ * (7.f * zz - 3.f); a2 = c3_ * y_ * (21.f * zz - 3.f);
      term(19, 4, c3_ * yz * (7.f * zz - 3.f), nullptr, &a1, &a2, false);
      a2 = c4_ * z_ * (140.f * zz - 60.f);
      term(20, 4, c4_ * (zz * (35.f * zz - 30.f) + 3.f), nullptr, nullptr, &a2, false);
      a0 = c5_ * z_ * (7.f * zz - 3.f); a2 = c5_ * x_ * (21.f * zz - 3.f);
      term(21, 4, c5_ * xz * (7.f * zz - 3.f), &a0, nullptr, &a2, false);
      a0 = c6_ * (2.f * x_) * (7.f * zz - 1.f); a1 = c6_ * (-2.f * y_) * (7.f * zz - 1.f);
      a2 = c6_ * (xx - yy) * (14.f * z_);
      term(22, 4, c6_ * (xx - yy) * (7.f * zz - 1.f), &a0, &a1, &a2, false);
      a0 = c7_ * z_ * (3.f * xx - 3.f * yy); a1 = c7_ * (-6.f * xy) * z_;
      a2 = c7_ * x_ * (xx - 3.f * yy);
      term(23, 4, c7_ * xz * (xx - 3.f * yy), &a0, &a1, &a2, false);
      a0 = c8_ * (4.f * x_) * (xx - 3.f * yy); a1 = c8_ * (4.f * y_) * (yy - 3.f * xx);
      term(24, 4, c8_ * (xx * (xx - 3.f * yy) - yy * (3.f * xx - yy)), &a0, &a1, nullptr,
           false);
    }
  }
}

// the band scales: 1, or (active >= b) where the SH ramp gives an active degree
__device__ __forceinline__ void band_scales(const int* __restrict__ active, float f[5]) {
  const int a = active ? __ldg(active) : 0;
  for (int b = 0; b < 5; ++b) f[b] = active ? (a >= b ? 1.f : 0.f) : 1.f;
}

// the camera's centre, c2w's last column
__device__ __forceinline__ void load_campos(const float* __restrict__ c2w, float campos[3]) {
  for (int j = 0; j < 3; ++j) campos[j] = __ldg(c2w + 4 * j + 3);
}

// the unit view direction of a row's mean and 1 / |mean - campos|
__device__ __forceinline__ void view_dir(const float* mean, const float* campos, float& x,
                                         float& y, float& z, float& inv) {
  float d[3];
  for (int j = 0; j < 3; ++j) d[j] = mean[j] - campos[j];
  inv = rsqrtf(((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]) + F(1e-20));
  x = d[0] * inv;
  y = d[1] * inv;
  z = d[2] * inv;
}

template <int DEG>
__global__ void __launch_bounds__(FWD_THREADS) project_sh_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ log_scales, const float* __restrict__ fdc,
    const float* __restrict__ frest, const bool* __restrict__ alive,
    const float* __restrict__ viewmat, const float* __restrict__ c2w,
    const int* __restrict__ active, float* __restrict__ means2d, float* __restrict__ conics,
    float* __restrict__ depths, int* __restrict__ radii, float* __restrict__ colors, int N,
    int n_coeffs, int width, int height, int max_radii, Cam cam, float near_plane,
    float far_plane, float radius_clip) {
  constexpr int R = FWD_ROWS, NT = FWD_THREADS;
  __shared__ __align__(16) float s_means[R * 3];
  __shared__ __align__(16) float s_quats[R * 4];
  __shared__ __align__(16) float s_ls[R * 3];
  __shared__ __align__(16) float s_m2d[R * 2];
  __shared__ __align__(16) float s_con[R * 3];
  __shared__ __align__(16) float s_dep[R];
  __shared__ __align__(16) int s_rad[R];
  __shared__ __align__(16) float s_col[R * 3];
  __shared__ int s_vis[R];
  __shared__ int s_nvis;
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * R;
  const int rows = min(R, N - n0);

  // ---- 1. stage the tile's rows; the camera, the SH ramp and a row's
  // alive flag into registers, their loads in flight with the slabs'
  if (t == 0) s_nvis = 0;
  load_slab(s_means, means + (size_t)n0 * 3, rows * 3, t, NT);
  load_slab(s_quats, quats + (size_t)n0 * 4, rows * 4, t, NT);
  load_slab(s_ls, log_scales + (size_t)n0 * 3, rows * 3, t, NT);
  View view;
  bool live = false;
  if (t < rows) {
    load_view(viewmat, view);
    live = alive[n0 + t];
  }
  float campos[3], fb[5];
  load_campos(c2w, campos);
  band_scales(active, fb);
  __syncthreads();

  // ---- 2. the projection, a lane a row
  if (t < rows) {
    Terms f;
    forward_terms(s_means + 3 * t, reinterpret_cast<const float4*>(s_quats)[t], s_ls + 3 * t,
                  view, cam, f);
    const float D = f.D;
    s_con[3 * t] = f.a11 / D;
    s_con[3 * t + 1] = (-f.a01) / D;
    s_con[3 * t + 2] = f.a00 / D;
    const float b = 0.5f * (f.a00 + f.a11);
    const float v1 = b + sqrtf(clamp_min(b * b - D, F(0.01)));
    const float radius = ceilf(3.f * sqrtf(v1));
    const float mx = f.mc[0], my = f.mc[1], mz = f.mc[2];
    const float u = cam.fx * mx * f.rz + cam.cx;
    const float v = cam.fy * my * f.rz + cam.cy;
    const bool cull = (mz < near_plane) | (mz > far_plane) | !f.det_ok
                      | (radius <= radius_clip) | (u + radius <= 0.f)
                      | (u - radius >= (float)width) | (v + radius <= 0.f)
                      | (v - radius >= (float)height) | !live;
    int rad = cull ? 0 : (int)clampf(radius, -1073741824.f, 1073741824.f);
    if (max_radii > 0) rad = min(rad, max_radii);
    s_m2d[2 * t] = u;
    s_m2d[2 * t + 1] = v;
    s_dep[t] = mz;
    s_rad[t] = rad;
    // a culled row's colour is clamp(0 + 0.5, 0) whatever its coefficients
    // hold: its SH is not read
    if (rad > 0) {
      s_vis[atomicAdd(&s_nvis, 1)] = t;
    } else {
      for (int ch = 0; ch < 3; ++ch) s_col[3 * t + ch] = 0.5f;
    }
  }
  __syncthreads();

  // ---- 3. the visible rows' SH, a lane a (row, channel): the lane's
  // coefficients read where they are used, all in flight at once
  const int nvis = s_nvis;
  const int w = (n_coeffs - 1) * 3;
  for (int i = t; i < 3 * nvis; i += NT) {
    const int k = i / 3, ch = i - 3 * k, r = s_vis[k];
    const size_t n = (size_t)n0 + r;
    float x, y, z, inv;
    view_dir(s_means + 3 * r, campos, x, y, z, inv);
    const float* rest = frest + n * w + ch;  // coefficient c >= 1 at rest[3 (c - 1)]
    const float res = eval_sh<DEG>(
        [&](int c) { return c == 0 ? __ldg(fdc + 3 * n + ch) : __ldg(rest + 3 * (c - 1)); },
        x, y, z, fb);
    s_col[3 * r + ch] = clamp_min(res + 0.5f, 0.f);
  }
  __syncthreads();

  // ---- 4. store the tile's outputs
  store_slab(means2d + (size_t)n0 * 2, s_m2d, rows * 2, t, NT);
  store_slab(conics + (size_t)n0 * 3, s_con, rows * 3, t, NT);
  store_slab(depths + n0, s_dep, rows, t, NT);
  store_slab(radii + n0, s_rad, rows, t, NT);
  store_slab(colors + (size_t)n0 * 3, s_col, rows * 3, t, NT);
}

// one row's projection backward: the cotangents gu, gv (means2d), g0-g2
// (conics) and gz (depth) to the quaternion's and the log-scales' grads
// and the projection's part of the mean's
__device__ __forceinline__ void project_bwd_row(const Terms& f, const Cam& cam,
                                                const float* v_m2d, const float* v_con,
                                                float gz, float* g_q, float* g_ls,
                                                float* v_means) {
  const float gu = v_m2d[0], gv = v_m2d[1];
  const float g0 = v_con[0], g1 = v_con[1], g2 = v_con[2];
  const float x = f.mc[0], y = f.mc[1], z = f.mc[2];
  const float rz = f.rz, rz2 = f.rz2, tx = f.tx, ty = f.ty;
  const float j00 = f.j00, j02 = f.j02, j11 = f.j11, j12 = f.j12;
  const float a00 = f.a00, a01 = f.a01, a11 = f.a11, D = f.D;

  // conic = (a11, -a01, a00) / D
  const float c0 = a11 / D, c1 = (-a01) / D, c2 = a00 / D;
  const float v_D = f.det_ok ? (-((g0 * c0 + g1 * c1) + g2 * c2)) / D : 0.f;
  const float v_a00 = g2 / D + v_D * a11;
  const float v_a11 = g0 / D + v_D * a00;
  const float v_a01 = (-g1) / D + v_D * (-2.f * a01);

  // cov2d = J C J^T
  float vc[3][3];
  vc[0][0] = v_a00 * (j00 * j00);
  vc[0][1] = v_a01 * (j00 * j11);
  vc[0][2] = v_a00 * (2.f * j00 * j02) + v_a01 * (j00 * j12);
  vc[1][1] = v_a11 * (j11 * j11);
  vc[1][2] = v_a01 * (j02 * j11) + v_a11 * (2.f * j11 * j12);
  vc[2][2] = (v_a00 * (j02 * j02) + v_a01 * (j02 * j12)) + v_a11 * (j12 * j12);
  const float v_j00 = v_a00 * (2.f * j00 * f.c00 + 2.f * j02 * f.c02)
                      + v_a01 * (j11 * f.c01 + j12 * f.c02);
  const float v_j02 = v_a00 * (2.f * j00 * f.c02 + 2.f * j02 * f.c22)
                      + v_a01 * (j11 * f.c12 + j12 * f.c22);
  const float v_j11 = v_a11 * (2.f * j11 * f.c11 + 2.f * j12 * f.c12)
                      + v_a01 * (j00 * f.c01 + j02 * f.c12);
  const float v_j12 = v_a11 * (2.f * j11 * f.c12 + 2.f * j12 * f.c22)
                      + v_a01 * (j00 * f.c02 + j02 * f.c22);

  // J and the projected mean
  const float fx = cam.fx, fy = cam.fy;
  const float v_tx = (-fx) * rz2 * v_j02;
  const float v_ty = (-fy) * rz2 * v_j12;
  const float v_rz2 = (-fx) * tx * v_j02 + (-fy) * ty * v_j12;
  float v_rz = (((fx * v_j00 + fy * v_j11) + fx * x * gu) + fy * y * gv) + 2.f * rz * v_rz2;
  float v_x = fx * rz * gu;
  float v_y = fy * rz * gv;
  // torch's clamp passes the gradient between its limits, ties included
  const bool pass_x = (f.ux >= -cam.lim_x_neg) & (f.ux <= cam.lim_x_pos);
  const bool pass_y = (f.uy >= -cam.lim_y_neg) & (f.uy <= cam.lim_y_pos);
  const float v_ux = pass_x ? z * v_tx : 0.f;
  const float v_uy = pass_y ? z * v_ty : 0.f;
  v_x = v_x + v_ux * rz;
  v_y = v_y + v_uy * rz;
  v_rz = (v_rz + v_ux * x) + v_uy * y;
  float v_z = (gz + clampf(f.ux, -cam.lim_x_neg, cam.lim_x_pos) * v_tx)
              + clampf(f.uy, -cam.lim_y_neg, cam.lim_y_pos) * v_ty;
  v_z = v_z + (fabsf(z) < F(1e-8) ? 0.f : (-(rz * rz)) * v_rz);
  for (int k = 0; k < 3; ++k)
    v_means[k] = dot3(f.R[0][k], f.R[1][k], f.R[2][k], v_x, v_y, v_z);

  // C = Rc Cw Rc^T (upper triangle) -> a = Rc Cw -> Cw
  float v_a[3][3];
  for (int k = 0; k < 3; ++k) {
    v_a[0][k] = (vc[0][0] * f.R[0][k] + vc[0][1] * f.R[1][k]) + vc[0][2] * f.R[2][k];
    v_a[1][k] = vc[1][1] * f.R[1][k] + vc[1][2] * f.R[2][k];
    v_a[2][k] = vc[2][2] * f.R[2][k];
  }
  float v_cw[3][3];
  for (int k = 0; k < 3; ++k)
    for (int j = 0; j < 3; ++j)
      v_cw[k][j] = dot3(f.R[0][k], f.R[1][k], f.R[2][k], v_a[0][j], v_a[1][j], v_a[2][j]);
  // Cw = M M^T
  float G[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) G[i][j] = v_cw[i][j] + v_cw[j][i];
  float v_m[3][3];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      v_m[i][k] = dot3(G[i][0], G[i][1], G[i][2], f.m[0][k], f.m[1][k], f.m[2][k]);
  // M = Rq diag(s)
  float v_s[3], v[3][3];
  for (int k = 0; k < 3; ++k)
    v_s[k] = dot3(v_m[0][k], v_m[1][k], v_m[2][k], f.r[0][k], f.r[1][k], f.r[2][k]);
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) v[i][k] = v_m[i][k] * f.s[k];
  const float w = f.qn[0], qx = f.qn[1], qy = f.qn[2], qz = f.qn[3];
  const float v_w = 2.f * (((((((-qz) * v[0][1] + qy * v[0][2]) + qz * v[1][0]) - qx * v[1][2])
                            - qy * v[2][0]) + qx * v[2][1]));
  const float v_qx = 2.f * (((((((qy * v[0][1] + qz * v[0][2]) + qy * v[1][0])
                                - 2.f * qx * v[1][1]) - w * v[1][2]) + qz * v[2][0])
                             + w * v[2][1]) - 2.f * qx * v[2][2]);
  const float v_qy = 2.f * ((((((((-2.f) * qy * v[0][0] + qx * v[0][1]) + w * v[0][2])
                                + qx * v[1][0]) + qz * v[1][2]) - w * v[2][0])
                             + qz * v[2][1]) - 2.f * qy * v[2][2]);
  const float v_qz = 2.f * ((((((((-2.f) * qz * v[0][0] - w * v[0][1]) + qx * v[0][2])
                                + w * v[1][0]) - 2.f * qz * v[1][1]) + qy * v[1][2])
                             + qx * v[2][0]) + qy * v[2][1]);
  const float inv = f.qinv;
  const float dot = ((v_w * w + v_qx * qx) + v_qy * qy) + v_qz * qz;
  g_q[0] = (v_w - dot * w) * inv;
  g_q[1] = (v_qx - dot * qx) * inv;
  g_q[2] = (v_qy - dot * qy) * inv;
  g_q[3] = (v_qz - dot * qz) * inv;
  for (int k = 0; k < 3; ++k) g_ls[k] = v_s[k] * f.s[k];
}

template <int DEG>
__global__ void __launch_bounds__(BWD_THREADS) project_sh_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ log_scales, const float* __restrict__ fdc,
    const float* __restrict__ frest, const int* __restrict__ radii,
    const float* __restrict__ viewmat, const float* __restrict__ c2w,
    const int* __restrict__ active, const float* __restrict__ v_means2d,
    const float* __restrict__ v_conics, const float* __restrict__ v_depths,
    const float* __restrict__ v_colors, float* __restrict__ g_means,
    float* __restrict__ g_quats, float* __restrict__ g_log_scales,
    float* __restrict__ g_fdc, float* __restrict__ g_frest, int N, int n_coeffs, Cam cam) {
  constexpr int R = BWD_ROWS, NT = BWD_THREADS;
  constexpr int FR = 3 * ((DEG + 1) * (DEG + 1) - 1);  // a row's staged features_rest
  constexpr int FRS = FR > 0 ? FR : 1;
  __shared__ __align__(16) float s_means[R * 3];
  __shared__ __align__(16) float s_quats[R * 4];
  __shared__ __align__(16) float s_ls[R * 3];
  __shared__ __align__(16) float s_fdc[R * 3];
  __shared__ __align__(16) float s_fr[R * FRS];
  __shared__ __align__(16) int s_rad[R];
  __shared__ __align__(16) float s_vm2d[R * 2];
  __shared__ __align__(16) float s_vcon[R * 3];
  __shared__ __align__(16) float s_vdep[R];
  __shared__ __align__(16) float s_vcol[R * 3];
  __shared__ __align__(16) float s_gq[R * 4];
  __shared__ __align__(16) float s_gls[R * 3];
  __shared__ __align__(16) float s_gmp[R * 3];  // the means' grad: the projection's
  __shared__ __align__(16) float s_gmd[R * 3];  // and the view direction's
  __shared__ __align__(16) float s_gfdc[R * 3];
  __shared__ __align__(16) float s_gfr[R * FRS];
  const int t = threadIdx.x, warp = t >> 5, r = t & 31;  // r: the lane's row
  const int n0 = blockIdx.x * R;
  const int rows = min(R, N - n0);
  const int w = (n_coeffs - 1) * 3;

  // ---- 1. stage the tile's rows
  load_slab(s_means, means + (size_t)n0 * 3, rows * 3, t, NT);
  load_slab(s_quats, quats + (size_t)n0 * 4, rows * 4, t, NT);
  load_slab(s_ls, log_scales + (size_t)n0 * 3, rows * 3, t, NT);
  load_slab(s_fdc, fdc + (size_t)n0 * 3, rows * 3, t, NT);
  if constexpr (FR > 0) load_rows<FR>(s_fr, frest + (size_t)n0 * w, rows, w, t, NT);
  load_slab(s_rad, radii + n0, rows, t, NT);
  load_cot(s_vm2d, v_means2d ? v_means2d + (size_t)n0 * 2 : nullptr, rows * 2, t, NT);
  load_cot(s_vcon, v_conics ? v_conics + (size_t)n0 * 3 : nullptr, rows * 3, t, NT);
  load_cot(s_vdep, v_depths ? v_depths + n0 : nullptr, rows, t, NT);
  load_cot(s_vcol, v_colors ? v_colors + (size_t)n0 * 3 : nullptr, rows * 3, t, NT);
  // the camera and the SH ramp into registers, their loads in flight with
  // the slabs'
  View view;
  float campos[3], fb[5];
  if (warp == 0) {
    load_view(viewmat, view);
  } else {
    load_campos(c2w, campos);
    band_scales(active, fb);
  }
  __syncthreads();

  // ---- 2. the projection's chain (warp 0) beside the SH's (warp 1)
  if (warp == 0) {
    if (r < rows) {
      Terms f;
      forward_terms(s_means + 3 * r, reinterpret_cast<const float4*>(s_quats)[r],
                    s_ls + 3 * r, view, cam, f);
      project_bwd_row(f, cam, s_vm2d + 2 * r, s_vcon + 3 * r, s_vdep[r], s_gq + 4 * r,
                      s_gls + 3 * r, s_gmp + 3 * r);
    }
  } else {
    // ---- `sh.eval_sh_bwd_plain` of clamp(eval_sh + 0.5, min=0), a lane
    // a row, its three channels; band b's weight w_c is channel c's
    // colour grad g_c scaled by fb[b]
    if (r < rows) {
      float x, y, z, dinv;
      view_dir(s_means + 3 * r, campos, x, y, z, dinv);
      const bool mask = s_rad[r] > 0;
      const float* fr = s_fr + r * FRS;  // coefficient k >= 1, channel c: fr[3 (k - 1) + c]
      float g[3];
      for (int ch = 0; ch < 3; ++ch) {
        float res = eval_sh<DEG>(
            [&](int k) { return k == 0 ? s_fdc[3 * r + ch] : fr[3 * (k - 1) + ch]; }, x, y, z,
            fb);
        res = mask ? res : 0.f;
        const float gc = res + 0.5f >= 0.f ? s_vcol[3 * r + ch] : 0.f;
        g[ch] = mask ? gc : 0.f;
      }
      for (int ch = 0; ch < 3; ++ch) s_gfdc[3 * r + ch] = F(0.28209479177387814) * g[ch];
      float* gfr = s_gfr + r * FRS;
      // coefficient k: its grads w_c value, and s = (w_0 c_0 + w_1 c_1) +
      // w_2 c_2 times its direction derivatives, summed in k's order
      float vd0 = 0.f, vd1 = 0.f, vd2 = 0.f;
      sh_terms<DEG>(x, y, z, [&](int k, int band, float value, const float* d0, const float* d1,
                                 const float* d2, bool first) {
        float wv[3];
        for (int ch = 0; ch < 3; ++ch) wv[ch] = fb[band] * g[ch];
        for (int ch = 0; ch < 3; ++ch) gfr[3 * (k - 1) + ch] = wv[ch] * value;
        const float* c = fr + 3 * (k - 1);
        const float s = (wv[0] * c[0] + wv[1] * c[1]) + wv[2] * c[2];
        if (d0) vd0 = first ? s * *d0 : vd0 + s * *d0;
        if (d1) vd1 = first ? s * *d1 : vd1 + s * *d1;
        if (d2) vd2 = first ? s * *d2 : vd2 + s * *d2;
      });
      // d = dirs / |dirs|: v_dirs = (v_d - (v_d . d) d) / |dirs|
      const float ddot = (vd0 * x + vd1 * y) + vd2 * z;
      s_gmd[3 * r] = (vd0 - ddot * x) * dinv;
      s_gmd[3 * r + 1] = (vd1 - ddot * y) * dinv;
      s_gmd[3 * r + 2] = (vd2 - ddot * z) * dinv;
    }
  }
  __syncthreads();

  // ---- 3. store the tile's grads; the means' is the projection's plus
  // the view direction's, in that order
  store_sum(g_means + (size_t)n0 * 3, s_gmp, s_gmd, rows * 3, t, NT);
  store_slab(g_quats + (size_t)n0 * 4, s_gq, rows * 4, t, NT);
  store_slab(g_log_scales + (size_t)n0 * 3, s_gls, rows * 3, t, NT);
  store_slab(g_fdc + (size_t)n0 * 3, s_gfdc, rows * 3, t, NT);
  if (w > 0) store_rows<FR>(g_frest + (size_t)n0 * w, s_gfr, rows, w, t, NT);
}

template <int DEG>
void launch_fwd(const float* means, const float* quats, const float* log_scales,
                const float* fdc, const float* frest, const bool* alive, const float* viewmat,
                const float* c2w, const int* active, float* means2d, float* conics,
                float* depths, int* radii, float* colors, int N, int n_coeffs, int width,
                int height, int max_radii, Cam cam, float near_plane, float far_plane,
                float radius_clip, cudaStream_t stream) {
  project_sh_fwd_kernel<DEG><<<(N + FWD_ROWS - 1) / FWD_ROWS, FWD_THREADS, 0, stream>>>(
      means, quats, log_scales, fdc, frest, alive, viewmat, c2w, active, means2d, conics,
      depths, radii, colors, N, n_coeffs, width, height, max_radii, cam, near_plane,
      far_plane, radius_clip);
}

template <int DEG>
void launch_bwd(const float* means, const float* quats, const float* log_scales,
                const float* fdc, const float* frest, const int* radii, const float* viewmat,
                const float* c2w, const int* active, const float* v_means2d,
                const float* v_conics, const float* v_depths, const float* v_colors,
                float* g_means, float* g_quats, float* g_log_scales, float* g_fdc,
                float* g_frest, int N, int n_coeffs, Cam cam, cudaStream_t stream) {
  project_sh_bwd_kernel<DEG><<<(N + BWD_ROWS - 1) / BWD_ROWS, BWD_THREADS, 0, stream>>>(
      means, quats, log_scales, fdc, frest, radii, viewmat, c2w, active, v_means2d,
      v_conics, v_depths, v_colors, g_means, g_quats, g_log_scales, g_fdc, g_frest, N,
      n_coeffs, cam);
}

}  // namespace

extern "C" int project_sh_fwd(const float* means, const float* quats, const float* log_scales,
                              const float* fdc, const float* frest, const bool* alive,
                              const float* viewmat, const float* c2w, const int* active,
                              float* means2d, float* conics, float* depths, int* radii,
                              float* colors, int N, int n_coeffs, int degree, int width,
                              int height, int max_radii, float fx, float fy, float cx, float cy,
                              float lim_x_neg, float lim_x_pos, float lim_y_neg,
                              float lim_y_pos, float eps2d, float near_plane, float far_plane,
                              float radius_clip, cudaStream_t stream) {
  if (N <= 0) return 0;
  const Cam cam = {fx, fy, cx, cy, lim_x_neg, lim_x_pos, lim_y_neg, lim_y_pos, eps2d};
#define FWD(D)                                                                            \
  launch_fwd<D>(means, quats, log_scales, fdc, frest, alive, viewmat, c2w, active, means2d, \
                conics, depths, radii, colors, N, n_coeffs, width, height, max_radii, cam,  \
                near_plane, far_plane, radius_clip, stream)
  switch (degree) {
    case 0: FWD(0); break;
    case 1: FWD(1); break;
    case 2: FWD(2); break;
    case 3: FWD(3); break;
    case 4: FWD(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FWD
  return (int)cudaGetLastError();
}

extern "C" int project_sh_bwd(const float* means, const float* quats, const float* log_scales,
                              const float* fdc, const float* frest, const int* radii,
                              const float* viewmat, const float* c2w, const int* active,
                              const float* v_means2d, const float* v_conics,
                              const float* v_depths, const float* v_colors, float* g_means,
                              float* g_quats, float* g_log_scales, float* g_fdc,
                              float* g_frest, int N, int n_coeffs, int degree, float fx,
                              float fy, float cx, float cy, float lim_x_neg, float lim_x_pos,
                              float lim_y_neg, float lim_y_pos, float eps2d,
                              cudaStream_t stream) {
  if (N <= 0) return 0;
  const Cam cam = {fx, fy, cx, cy, lim_x_neg, lim_x_pos, lim_y_neg, lim_y_pos, eps2d};
#define BWD(D)                                                                           \
  launch_bwd<D>(means, quats, log_scales, fdc, frest, radii, viewmat, c2w, active,        \
                v_means2d, v_conics, v_depths, v_colors, g_means, g_quats, g_log_scales,  \
                g_fdc, g_frest, N, n_coeffs, cam, stream)
  switch (degree) {
    case 0: BWD(0); break;
    case 1: BWD(1); break;
    case 2: BWD(2); break;
    case 3: BWD(3); break;
    case 4: BWD(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef BWD
  return (int)cudaGetLastError();
}
