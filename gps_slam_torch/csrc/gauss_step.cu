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
//   project_sh_fwd  one thread a row: the camera point, the camera
//                   covariance, the clamped Jacobian, the blurred 2D
//                   covariance, its conic, the 3-sigma radius and the cull,
//                   the SH colour of the view direction (+0.5, clamped at
//                   0; 0.5 where the radius is 0, its SH not read); writes
//                   means2d, conics, depths, radii (at most max_radii) and
//                   colours.
//   project_sh_bwd  one thread a row: the same intermediates again from
//                   the same inputs (and the forward's radii), then the
//                   cotangents of means2d, conics, depths and colours
//                   (a null pointer is a zero cotangent) back to the grads
//                   of the means (projection, then view direction), the
//                   quaternions, the log-scales and both SH coefficient
//                   arrays.
//
// Bound: bytes.  At SH degree 3 a row is 58 f32 (means 3, quats 4,
// log-scales 3, SH 48) and the alive flag; only a visible row (radius > 0)
// needs its 48 SH floats and its colours' cotangent.  The forward reads
// 41 B a row and 192 B more a visible row, and writes 40 B; the backward
// reads 44 B and 24 B of cotangents a row and 204 B more a visible row,
// and writes 232 B; against ~260 + ~210 a visible row (forward) and ~560
// + ~540 (backward) f32 operations.  The design is the simplest that is
// right: one thread a row, everything in registers, the SH coefficients
// read where they are used (the forward skips a culled row's; the
// backward reads every row's, as its plain version does: a culled row's
// view-direction terms are zeros whose signs, or NaNs, come from them);
// the kernels are instanced per SH degree (0-4), so the
// band loops unroll.  Nothing is read back to the host: the camera
// (view matrix and c2w) and the SH ramp's active degree are read on the
// device, so a CUDA graph captures both launches.

#include <cuda_runtime.h>
#include <math.h>

namespace {

#define F(x) ((float)(x))   // a constant as torch takes a Python float: f64, then f32

constexpr int NT = 256;

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

__device__ __forceinline__ void forward_terms(const float* __restrict__ means,
                                              const float* __restrict__ quats,
                                              const float* __restrict__ log_scales,
                                              const float* __restrict__ viewmat, int n,
                                              const Cam& cam, Terms& f) {
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) f.R[i][k] = __ldg(viewmat + 4 * i + k);
  const float px = __ldg(means + 3 * n), py = __ldg(means + 3 * n + 1),
              pz = __ldg(means + 3 * n + 2);
  // `projection.camera_point`: the CPU matmul's multiply-add chain, each
  // step rounded once to f32 through an exact f64 product
  for (int i = 0; i < 3; ++i)
    f.mc[i] = fma32(f.R[i][2], pz, fma32(f.R[i][1], py, f.R[i][0] * px))
              + __ldg(viewmat + 4 * i + 3);

  float w = __ldg(quats + 4 * n), x = __ldg(quats + 4 * n + 1), y = __ldg(quats + 4 * n + 2),
        z = __ldg(quats + 4 * n + 3);
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
  for (int k = 0; k < 3; ++k) f.s[k] = expf(__ldg(log_scales + 3 * n + k));
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

// SH coefficient k, channel ch of row n (k 0: features_dc, else features_rest)
__device__ __forceinline__ float coeff(const float* __restrict__ fdc,
                                       const float* __restrict__ frest, int n, int n_coeffs,
                                       int k, int ch) {
  return k == 0 ? __ldg(fdc + 3 * n + ch)
                : __ldg(frest + ((size_t)n * (n_coeffs - 1) + (k - 1)) * 3 + ch);
}

// `sh.eval_sh` of one channel: the band sums, each band scaled by f[b]
template <int DEG>
__device__ __forceinline__ float eval_sh(const float* __restrict__ fdc,
                                         const float* __restrict__ frest, int n, int nc,
                                         int ch, float x, float y, float z, const float* f) {
  auto c = [&](int k) { return coeff(fdc, frest, n, nc, k, ch); };
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

// the band scales: 1, or (active >= b) where the SH ramp gives an active degree
__device__ __forceinline__ void band_scales(const int* __restrict__ active, float f[5]) {
  const int a = active ? __ldg(active) : 0;
  for (int b = 0; b < 5; ++b) f[b] = active ? (a >= b ? 1.f : 0.f) : 1.f;
}

// the unit view direction and 1 / |means - campos|
__device__ __forceinline__ void view_dir(const float* __restrict__ means,
                                         const float* __restrict__ c2w, int n, float d[3],
                                         float& x, float& y, float& z, float& inv) {
  for (int j = 0; j < 3; ++j) d[j] = __ldg(means + 3 * n + j) - __ldg(c2w + 4 * j + 3);
  inv = rsqrtf(((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]) + F(1e-20));
  x = d[0] * inv;
  y = d[1] * inv;
  z = d[2] * inv;
}

template <int DEG>
__global__ void __launch_bounds__(NT) project_sh_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ log_scales, const float* __restrict__ fdc,
    const float* __restrict__ frest, const bool* __restrict__ alive,
    const float* __restrict__ viewmat, const float* __restrict__ c2w,
    const int* __restrict__ active, float* __restrict__ means2d, float* __restrict__ conics,
    float* __restrict__ depths, int* __restrict__ radii, float* __restrict__ colors, int N,
    int n_coeffs, int width, int height, int max_radii, Cam cam, float near_plane,
    float far_plane, float radius_clip) {
  const int n = blockIdx.x * NT + threadIdx.x;
  if (n >= N) return;
  Terms f;
  forward_terms(means, quats, log_scales, viewmat, n, cam, f);
  const float D = f.D;
  conics[3 * n] = f.a11 / D;
  conics[3 * n + 1] = (-f.a01) / D;
  conics[3 * n + 2] = f.a00 / D;
  const float b = 0.5f * (f.a00 + f.a11);
  const float v1 = b + sqrtf(clamp_min(b * b - D, F(0.01)));
  const float radius = ceilf(3.f * sqrtf(v1));
  const float mx = f.mc[0], my = f.mc[1], mz = f.mc[2];
  const float u = cam.fx * mx * f.rz + cam.cx;
  const float v = cam.fy * my * f.rz + cam.cy;
  const bool cull = (mz < near_plane) | (mz > far_plane) | !f.det_ok | (radius <= radius_clip)
                    | (u + radius <= 0.f) | (u - radius >= (float)width)
                    | (v + radius <= 0.f) | (v - radius >= (float)height) | !alive[n];
  int rad = cull ? 0 : (int)clampf(radius, -1073741824.f, 1073741824.f);
  if (max_radii > 0) rad = min(rad, max_radii);
  means2d[2 * n] = u;
  means2d[2 * n + 1] = v;
  depths[n] = mz;
  radii[n] = rad;

  // a culled row's colour is clamp(0 + 0.5, 0) whatever its coefficients
  // hold: its SH is not read
  if (!(rad > 0)) {
    for (int ch = 0; ch < 3; ++ch) colors[3 * n + ch] = 0.5f;
    return;
  }
  float fb[5], d[3], x, y, z, inv;
  band_scales(active, fb);
  view_dir(means, c2w, n, d, x, y, z, inv);
  for (int ch = 0; ch < 3; ++ch) {
    const float res = eval_sh<DEG>(fdc, frest, n, n_coeffs, ch, x, y, z, fb);
    colors[3 * n + ch] = clamp_min(res + 0.5f, 0.f);
  }
}

// the cotangent `p[i]` of a [N, w] array, or 0 for a null pointer
__device__ __forceinline__ float cot(const float* __restrict__ p, int i) {
  return p ? __ldg(p + i) : 0.f;
}

template <int DEG>
__global__ void __launch_bounds__(NT) project_sh_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ log_scales, const float* __restrict__ fdc,
    const float* __restrict__ frest, const int* __restrict__ radii,
    const float* __restrict__ viewmat, const float* __restrict__ c2w,
    const int* __restrict__ active, const float* __restrict__ v_means2d,
    const float* __restrict__ v_conics, const float* __restrict__ v_depths,
    const float* __restrict__ v_colors, float* __restrict__ g_means,
    float* __restrict__ g_quats, float* __restrict__ g_log_scales,
    float* __restrict__ g_fdc, float* __restrict__ g_frest, int N, int n_coeffs, Cam cam) {
  const int n = blockIdx.x * NT + threadIdx.x;
  if (n >= N) return;
  Terms f;
  forward_terms(means, quats, log_scales, viewmat, n, cam, f);
  const float gu = cot(v_means2d, 2 * n), gv = cot(v_means2d, 2 * n + 1);
  const float g0 = cot(v_conics, 3 * n), g1 = cot(v_conics, 3 * n + 1),
              g2 = cot(v_conics, 3 * n + 2);
  const float gz = cot(v_depths, n);
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
  float v_means[3];
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
  g_quats[4 * n] = (v_w - dot * w) * inv;
  g_quats[4 * n + 1] = (v_qx - dot * qx) * inv;
  g_quats[4 * n + 2] = (v_qy - dot * qy) * inv;
  g_quats[4 * n + 3] = (v_qz - dot * qz) * inv;
  for (int k = 0; k < 3; ++k) g_log_scales[3 * n + k] = v_s[k] * f.s[k];

  // ---- SH: `sh.eval_sh_bwd_plain` of clamp(eval_sh + 0.5, min=0)
  float fb[5], dd[3], dx, dy, dz, dinv;
  band_scales(active, fb);
  view_dir(means, c2w, n, dd, dx, dy, dz, dinv);
  const bool mask = __ldg(radii + n) > 0;
  float g[3];
  for (int ch = 0; ch < 3; ++ch) {
    float res = eval_sh<DEG>(fdc, frest, n, n_coeffs, ch, dx, dy, dz, fb);
    res = mask ? res : 0.f;
    const float gc = res + 0.5f >= 0.f ? cot(v_colors, 3 * n + ch) : 0.f;
    g[ch] = mask ? gc : 0.f;
  }
  const int nr = n_coeffs - 1;
  float* gr = g_frest + (size_t)n * nr * 3;
  for (int ch = 0; ch < 3; ++ch) g_fdc[3 * n + ch] = F(0.28209479177387814) * g[ch];
  // the grads of the unit direction
  float vd0 = 0.f, vd1 = 0.f, vd2 = 0.f;
  // coefficient k: its grad w * value, and s = w . c_k times its
  // direction derivatives (band b's w: g scaled by fb[b])
  auto term = [&](int k, int band, float value, float* d0, float* d1, float* d2, bool first) {
    float wv[3];
    for (int ch = 0; ch < 3; ++ch) wv[ch] = fb[band] * g[ch];
    for (int ch = 0; ch < 3; ++ch) gr[(k - 1) * 3 + ch] = wv[ch] * value;
    const float s = (wv[0] * coeff(fdc, frest, n, n_coeffs, k, 0)
                     + wv[1] * coeff(fdc, frest, n, n_coeffs, k, 1))
                    + wv[2] * coeff(fdc, frest, n, n_coeffs, k, 2);
    if (d0) vd0 = first ? s * *d0 : vd0 + s * *d0;
    if (d1) vd1 = first ? s * *d1 : vd1 + s * *d1;
    if (d2) vd2 = first ? s * *d2 : vd2 + s * *d2;
  };
  const float x_ = dx, y_ = dy, z_ = dz;
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
  // bands past DEG: zeros
  for (int k = (DEG + 1) * (DEG + 1); k < n_coeffs; ++k)
    for (int ch = 0; ch < 3; ++ch) gr[(k - 1) * 3 + ch] = 0.f;
  // d = dirs / |dirs|: v_dirs = (v_d - (v_d . d) d) / |dirs|; the means'
  // grad is the projection's plus the view direction's
  const float ddot = (vd0 * x_ + vd1 * y_) + vd2 * z_;
  g_means[3 * n] = v_means[0] + (vd0 - ddot * x_) * dinv;
  g_means[3 * n + 1] = v_means[1] + (vd1 - ddot * y_) * dinv;
  g_means[3 * n + 2] = v_means[2] + (vd2 - ddot * z_) * dinv;
}

template <int DEG>
void launch_fwd(const float* means, const float* quats, const float* log_scales,
                const float* fdc, const float* frest, const bool* alive, const float* viewmat,
                const float* c2w, const int* active, float* means2d, float* conics,
                float* depths, int* radii, float* colors, int N, int n_coeffs, int width,
                int height, int max_radii, Cam cam, float near_plane, float far_plane,
                float radius_clip, cudaStream_t stream) {
  project_sh_fwd_kernel<DEG><<<(N + NT - 1) / NT, NT, 0, stream>>>(
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
  project_sh_bwd_kernel<DEG><<<(N + NT - 1) / NT, NT, 0, stream>>>(
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
