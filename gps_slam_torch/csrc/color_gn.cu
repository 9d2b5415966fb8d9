// color_gn_cuda — one Gauss-Newton iteration of a colour-tracker pyramid
// level: the per-point photometric system, its f64 sums and the
// Levenberg-Marquardt step, on the level's carried state in place.
//
// Replaces no TPU kernel: the counterpart of the body `gn_iter` of the JAX
// colour tracker's per-level `lax.while_loop` (gps_slam_tpu/slam/
// tracker.py:322-380), which XLA compiles into a few fusions of one
// program.  Its plain version, with the semantics and the state layout, is
// gps_slam_torch/slam/color_gn.py; every f32 expression here is that
// version's, in its order, built with -fmad=false and true divisions, so
// the two give the same bits on the card.
//
// The points are the previous raycast's world points at a stride of 4 (N =
// 51,000 at 1200x680) at every pyramid level; only the image they are
// projected into shrinks.  Per point a pass reads the point, its model
// colour and its valid flag (25 bytes) and the 4 corners of three bilinear
// reads (the level's rgb and its Sobel x and y); its f32 work (~230
// operations, 5 true divisions) and f64 work (~250: the 36 + 6 entries of
// the system summed over 3 channels) take less than those bytes.  What the
// design fights is what the loop of ~514 small torch kernels a pass paid:
// launches and the trips of [N, 3, 6] intermediates through device memory.
// One kernel a pass, `gn_iter`, in `icp_gn_cuda`'s design (gn_common.cuh):
//
//   * a thread takes PIX = 2 points a round (N = 51,000: 100 CTAs of 256
//     threads, one round), and adds their 44 terms: H (36, each summed over
//     the channels in f64), g (6), the squared residual of an inlier and
//     the inlier count;
//   * a warp sums them by the xor transpose, then the 8 warps by halving,
//     one f64 row per CTA ([44, n_ctas]);
//   * the CTA that finishes last (a ticket after a fence) sums the rows the
//     same way and one warp takes the colour tracker's step: on a reject
//     the new system (not the accepted one) is damped and solved from the
//     accepted estimate; a 6x6 LU with partial pivoting (a zero pivot or a
//     non-finite solution gives a zero step), se3_exp and the new
//     estimate, the state, the iteration count and the loop's test.
//
// No sum depends on which CTA finishes last or on timing: two launches
// give the same bits.

#include "gn_common.cuh"

namespace {

using namespace gn;

constexpr int NTERMS = 44;       // H (36, row-major), g (6), sum |r|^2 ok, inliers
constexpr int STATE = 37;        // `color_gn.FIELDS`

// shared parameters of a pass: M's rows 0-2 (w2c), cam fx fy cx cy
constexpr int P_M = 0, P_CAM = 12, P_N = 16;

// `color_gn.terms` of one point: the Jacobian J [3][6] of its three colour
// residuals r [3], its squared residual (an inlier's, else 0) and ok
__device__ __forceinline__ void point_terms(
    const float* __restrict__ sp, const float* __restrict__ pts,
    const float* __restrict__ col, const bool* __restrict__ valid,
    const float* __restrict__ rgb, const float* __restrict__ gx,
    const float* __restrict__ gy, int p, int h, int w, bool rot, float J[3][6], float r[3],
    float& rr, float& okf) {
  const float x = __ldg(pts + 3 * p), y = __ldg(pts + 3 * p + 1), zz = __ldg(pts + 3 * p + 2);
  float pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = sp + P_M + 4 * i;
    pc[i] = ((m[0] * x + m[1] * y) + m[2] * zz) + m[3];
  }
  const float fx = sp[P_CAM], fy = sp[P_CAM + 1], cx = sp[P_CAM + 2], cy = sp[P_CAM + 3];
  const float z = clamp_minf(pc[2], 1e-6f);
  const float u = fx * pc[0] / z + cx;
  const float v = fy * pc[1] / z + cy;
  const bool in_img = (pc[2] > 0.0f) & (u >= 0.0f) & (u <= (float)(w - 1)) & (v >= 0.0f)
                      & (v <= (float)(h - 1));
  const float us = clampf(u, 0.0f, (float)w - 1.0f);
  const float vs = clampf(v, 0.0f, (float)h - 1.0f);
  const Corners q = corners(us, vs, w, h);
  float c[3], gxo[3], gyo[3], wz, wx, wy;
  bilinear(rgb, w, q.iu0, q.iv0, q.iu1, q.iv1, q.fu, q.fv, c, wz);
  bilinear(gx, w, q.iu0, q.iv0, q.iu1, q.iv1, q.fu, q.fv, gxo, wx);
  bilinear(gy, w, q.iu0, q.iv0, q.iu1, q.iv1, q.fu, q.fv, gyo, wy);
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = c[k] - __ldg(col + 3 * p + k);
  const bool ok = valid[p] & in_img & (wz > 0.5f);
  okf = ok ? 1.0f : 0.0f;
  // projection Jacobians d(u, v) / d p_c, then [d ; p_c x d] for a
  // left-multiplied twist on M
  const float inv_z = 1.0f / z;
  const float du[3] = {fx * inv_z, 0.0f, ((-fx * pc[0]) * inv_z) * inv_z};
  const float dv[3] = {0.0f, fy * inv_z, ((-fy * pc[1]) * inv_z) * inv_z};
  float ju[6], jv[6];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ju[i] = du[i];
    jv[i] = dv[i];
  }
  ju[3] = pc[1] * du[2] - pc[2] * du[1];
  ju[4] = pc[2] * du[0] - pc[0] * du[2];
  ju[5] = pc[0] * du[1] - pc[1] * du[0];
  jv[3] = pc[1] * dv[2] - pc[2] * dv[1];
  jv[4] = pc[2] * dv[0] - pc[0] * dv[2];
  jv[5] = pc[0] * dv[1] - pc[1] * dv[0];
  if (rot) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ju[i] = ju[i] * 0.0f;
      jv[i] = jv[i] * 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int i = 0; i < 6; ++i) J[k][i] = gxo[k] * ju[i] + gyo[k] * jv[i];
  }
  rr = ((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2]) * okf;
}

// one round of a thread: its PIX points p0 + m NT, m < PIX (+0 terms past
// the n points), summed term by term in m's order; an entry of H or g sums
// its three channels in f64, Jm = J ok rounded to f32 first
struct Points {
  float J[PIX][3][6], r[PIX][3], rr[PIX], okf[PIX];

  __device__ __forceinline__ double term(int m, int j) const {
    const float o = okf[m];
    if (j < 36) {
      const int i = j / 6, l = j % 6;
      return ((double)(J[m][0][i] * o) * (double)J[m][0][l]
              + (double)(J[m][1][i] * o) * (double)J[m][1][l])
             + (double)(J[m][2][i] * o) * (double)J[m][2][l];
    }
    if (j < 42) {
      const int i = j - 36;
      return ((double)(J[m][0][i] * o) * (double)r[m][0]
              + (double)(J[m][1][i] * o) * (double)r[m][1])
             + (double)(J[m][2][i] * o) * (double)r[m][2];
    }
    if (j == 42) return (double)rr[m];
    return (double)o;
  }
  __device__ __forceinline__ double operator()(int j) const {
    double v = term(0, j);
#pragma unroll
    for (int m = 1; m < PIX; ++m) v = v + term(m, j);
    return v;
  }
};

// the last CTA: the CTAs' rows summed as the points are (`sum_rows`), then
// `color_gn.lm_step` in one warp, each entry of a matrix in a lane of its
// own, with the plain version's operations in its order; what every lane
// needs, every lane computes alike
__device__ __forceinline__ void take_step(const double* partials, float* __restrict__ state,
                                          long long* __restrict__ n_run,
                                          bool* __restrict__ more, int n_ctas, int n_pts,
                                          int first, int n_iters, float step_exit,
                                          double (*acc)[NTERMS]) {
  __shared__ double tot[NTERMS];
  __shared__ float ss[STATE];
  // the step's matrices: the new system, the damped one, M_ref, E = se3_exp(delta)
  __shared__ float sH[36], sA[36], sM[16], sE[16], sb[6], sx[6];
  __shared__ int s_piv;
  const int t = threadIdx.x, lane = t & 31;
  if (t < STATE) ss[t] = state[t];
  sum_rows<NTERMS>(partials, n_ctas, acc, tot);
  if (t >= 32) return;

  const float n_ok = (float)tot[43];
  const double den = isnan(tot[43]) ? tot[43] : fmax(tot[43], 1.0);
  const float err = n_ok > 50.0f ? (float)(tot[42] / den) : INFINITY;
  const float inlier = n_ok / (float)n_pts;
  const float mean_r = sqrtf(clamp_minf(err, 0.0f));
  const float err_acc = ss[32], lam = ss[33];
  const bool better = first != 0 || err <= err_acc;
  const float err_ref = better ? err : err_acc;
  const float lam_new = clampf(better ? lam * 0.1f : lam * 10.0f, 1e-6f, 1e5f);
  for (int i = lane; i < 36; i += 32) sH[i] = (float)tot[i];
  if (lane < 6) sb[lane] = -(float)tot[36 + lane];
  if (lane < 16) sM[lane] = better ? ss[lane] : ss[16 + lane];
  __syncwarp();
  // lambda-scaled diagonal + an absolute floor scaled to the mean diagonal,
  // on the new system whichever estimate it starts from
  const float trace = ((((sH[0] + sH[7]) + sH[14]) + sH[21]) + sH[28]) + sH[35];
  const float mean_diag = trace / 6.0f + 1e-9f;
  const float c = 1e-2f * mean_diag;
  for (int e = lane; e < 36; e += 32) {
    const bool diag = e % 7 == 0;
    const float damp = lam_new * (diag ? sH[e] : 0.0f) + c * (diag ? 1.0f : 0.0f);
    sA[e] = sH[e] + damp;
  }
  __syncwarp();
  const bool nonzero = lu6_warp(sA, sb, sx, &s_piv, lane);
  bool ok = nonzero && isfinite(err_ref);
  float dl[6];
  for (int i = 0; i < 6; ++i) {
    ok = ok && isfinite(sx[i]);
    dl[i] = sx[i];
  }
  for (int i = 0; i < 6; ++i) dl[i] = ok ? dl[i] : 0.0f;
  se3_exp_warp(dl, sE, lane);
  __syncwarp();
  // the new state: lane (i, j) of M_new, then M_ref as the accepted one
  state[lane] = lane < 16 ? compose_entry(sE, sM, lane) : sM[lane - 16];
  if (lane == 0) {
    const float step = step_of(dl);
    state[32] = err_ref;
    state[33] = lam_new;
    state[34] = step;
    state[35] = inlier;
    state[36] = mean_r;
    const long long n = *n_run + 1;
    *n_run = n;
    *more = (n < n_iters) & (step > step_exit);
  }
}

__global__ void __launch_bounds__(NT)
gn_iter(const float* __restrict__ pts, const float* __restrict__ col,
        const bool* __restrict__ valid, const float* __restrict__ rgb,
        const float* __restrict__ gx, const float* __restrict__ gy,
        const float* __restrict__ cam, float* __restrict__ state,
        long long* __restrict__ n_run, bool* __restrict__ more, double* partials,
        unsigned* ticket, int n, int h, int w, int rot, int rounds, int n_ctas, int first,
        int n_iters, float step_exit) {
  __shared__ float sp[P_N];
  __shared__ double acc[NW][NTERMS];
  const int t = threadIdx.x, lane = t & 31;
  if (t < 12) sp[P_M + t] = state[t];            // M's rows 0-2
  else if (t < 16) sp[P_CAM + t - 12] = cam[t - 12];
  __syncthreads();
  const int base = blockIdx.x * NT * PIX * rounds;
  double a1 = 0.0, a2 = 0.0;
  for (int k = 0; k < rounds; ++k) {
    Points pt;
#pragma unroll
    for (int m = 0; m < PIX; ++m) {
      const int p = base + (k * PIX + m) * NT + t;
      if (p < n) {
        point_terms(sp, pts, col, valid, rgb, gx, gy, p, h, w, rot != 0, pt.J[m], pt.r[m],
                    pt.rr[m], pt.okf[m]);
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
#pragma unroll
          for (int i = 0; i < 6; ++i) pt.J[m][c][i] = 0.0f;
          pt.r[m][c] = 0.0f;
        }
        pt.rr[m] = pt.okf[m] = 0.0f;
      }
    }
    double s1, s2;
    warp_terms<NTERMS>(pt, lane, s1, s2);
    a1 = a1 + s1;
    a2 = a2 + s2;
  }
  // the CTA that finishes last takes the step
  if (!cta_done<NTERMS>(acc, partials, ticket, n_ctas, a1, a2)) return;
  take_step(partials, state, n_run, more, n_ctas, n, first, n_iters, step_exit, acc);
}

}  // namespace

extern "C" int color_gn(const float* pts, const float* col, const bool* valid,
                        const float* rgb, const float* gx, const float* gy, const float* cam,
                        float* state, long long* n_run, bool* more, double* partials, int n,
                        int h, int w, int rot, int rounds, int n_ctas, int first, int n_iters,
                        float step_exit, cudaStream_t stream) {
  // the ticket: the bits of the slot after the rows
  unsigned* ticket = reinterpret_cast<unsigned*>(partials + (size_t)NTERMS * n_ctas);
  gn_iter<<<n_ctas, NT, 0, stream>>>(pts, col, valid, rgb, gx, gy, cam, state, n_run, more,
                                     partials, ticket, n, h, w, rot, rounds, n_ctas, first,
                                     n_iters, step_exit);
  return (int)cudaGetLastError();
}
