// color_gn_cuda — the Gauss-Newton loop of a colour-tracker pyramid level
// in one cooperative launch: pass after pass, the per-point photometric
// system, its f64 sums and the Levenberg-Marquardt step, on the level's
// carried state in place, until the loop's test fails or `budget` passes
// have run.
//
// Replaces no TPU kernel: the counterpart of the JAX colour tracker's
// per-level `lax.while_loop` (gps_slam_tpu/slam/tracker.py:322-388), its
// body `gn_iter` and its exit test, which XLA compiles into one program.
// Its plain version, with the semantics and the state layout, is
// gps_slam_torch/slam/color_gn.py (`iterate_plain`, one pass, run in a
// loop by `run_plain`); every f32 expression here is that version's, in
// its order, built with -fmad=false and true divisions, so the two give
// the same bits on the card.
//
// The points are the previous raycast's world points at a stride of 4 (N =
// 51,000 at 1200x680) at every pyramid level; only the image they are
// projected into shrinks.  Per point a pass reads the point, its model
// colour and its valid flag (25 bytes) and the 4 corners of three bilinear
// reads (the level's rgb and its Sobel x and y); its f32 work (~230
// operations, 5 true divisions) and f64 work (~250: the 36 + 6 entries of
// the system summed over 3 channels) take less than those bytes.  At this
// size a pass is a chain of latencies, and the design is `icp_gn_cuda`'s
// (gn_common.cuh): the whole level one launch with every CTA resident
// (cudaLaunchKernelEx, cudaLaunchAttributeCooperative; the logical grid
// `icp_gn`'s, 100 CTAs of 256 threads at 51,000 points; one CTA an SM is
// resident, so the launch's grid is the logical one capped at the card's
// 132, each resident CTA taking the logical CTAs b, b + gridDim.x, ...:
// 254 of them at 1920x1080), and per pass:
//
//   * a thread takes PIX = 2 points a round (those of its CTA's first
//     logical CTA's first round, their coordinates, colours and flags, in
//     shared memory after the first pass) and adds their 44 terms: H
//     (36, each summed over the channels in f64), g (6), the squared
//     residual of an inlier and the inlier count; a warp sums them by the
//     xor transpose, then the 8 warps by halving, one f64 row per CTA
//     per logical CTA ([44, n_ctas], two halves used in turn by the
//     passes);
//   * a grid barrier; every CTA sums the rows the same way and one warp
//     takes the colour tracker's step on the level state it keeps in
//     shared memory: on a reject the new system (not the accepted one) is
//     damped and solved from the accepted estimate; a 6x6 LU with partial
//     pivoting a row a lane (a zero pivot or a non-finite solution gives
//     a zero step), se3_exp and the new estimate, the iteration count and
//     the loop's test;
//   * CTA 0 writes the state, the count and the test at the end; every
//     logical CTA's row of the last pass is left in the first half.
//
// No sum depends on timing or on the CTA: two launches give the same
// bits.

#include "gn_common.cuh"

namespace {

using namespace gn;

constexpr int NTERMS = 44;       // H (36, row-major), g (6), sum |r|^2 ok, inliers
constexpr int STATE = 37;        // `color_gn.FIELDS`

// shared parameters of a launch: cam fx fy cx cy
constexpr int P_CAM = 0, P_N = 4;

// `color_gn.terms` of one point (pt: its world point, model colour and
// valid flag): the Jacobian J [3][6] of its three colour residuals r [3],
// its squared residual (an inlier's, else 0) and ok
__device__ __forceinline__ void point_terms(
    const float* __restrict__ sM, const float* __restrict__ sp, const float pt[7],
    const float* __restrict__ rgb, const float* __restrict__ gx,
    const float* __restrict__ gy, int h, int w, bool rot, float J[3][6], float r[3],
    float& rr, float& okf) {
  const float x = pt[0], y = pt[1], zz = pt[2];
  float pc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = sM + 4 * i;
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
  for (int k = 0; k < 3; ++k) r[k] = c[k] - pt[3 + k];
  const bool ok = (pt[6] != 0.0f) & in_img & (wz > 0.5f);
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

// A pass's step: the CTAs' rows summed as the points are (`sum_rows`),
// then `color_gn.lm_step` in one warp, each entry of a matrix in a lane of
// its own, with the plain version's operations in its order, on the level
// state `ss` in shared memory (the new state written back there); what
// every lane needs, every lane computes alike
__device__ __forceinline__ void take_step(const double* rows, float* ss, long long* s_n,
                                          bool* s_more, int n_ctas, int n_pts, bool first,
                                          int n_iters, float step_exit,
                                          double (*acc)[NTERMS]) {
  __shared__ double tot[NTERMS];
  // the step's matrices: the new system, the damped one, M_ref, E = se3_exp(delta)
  __shared__ float sH[36], sA[36], sM[16], sE[16], sb[6];
  const int t = threadIdx.x, lane = t & 31;
  sum_rows<NTERMS>(rows, n_ctas, acc, tot);
  if (t >= 32) return;

  const float n_ok = (float)tot[43];
  const double den = isnan(tot[43]) ? tot[43] : fmax(tot[43], 1.0);
  const float err = n_ok > 50.0f ? (float)(tot[42] / den) : INFINITY;
  const float inlier = n_ok / (float)n_pts;
  const float mean_r = sqrtf(clamp_minf(err, 0.0f));
  const float err_acc = ss[32], lam = ss[33];
  const bool better = first || err <= err_acc;
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
  float dl[6];
  const bool nonzero = lu6_lanes(sA, sb, dl, lane);
  bool ok = nonzero && isfinite(err_ref);
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(dl[i]);
  for (int i = 0; i < 6; ++i) dl[i] = ok ? dl[i] : 0.0f;
  se3_exp_warp(dl, sE, lane);
  __syncwarp();
  // the new state: lane (i, j) of M_new, then M_ref as the accepted one
  // (ss is not read past the first __syncwarp)
  ss[lane] = lane < 16 ? compose_entry(sE, sM, lane) : sM[lane - 16];
  if (lane == 0) {
    const float step = step_of(dl);
    ss[32] = err_ref;
    ss[33] = lam_new;
    ss[34] = step;
    ss[35] = inlier;
    ss[36] = mean_r;
    const long long n = *s_n + 1;
    *s_n = n;
    *s_more = (n < n_iters) & (step > step_exit);
  }
}

// the level's passes: the first always, then while the loop's test holds
// and fewer than `budget` have run in this launch.  The launch's grid
// holds gridDim.x <= n_ctas CTAs; CTA b takes the logical CTAs b, b +
// gridDim.x, ... of the n_ctas whose rows fix the sums' order.
__global__ void __launch_bounds__(NT, 1)
gn_level(const float* __restrict__ pts, const float* __restrict__ col,
         const bool* __restrict__ valid, const float* __restrict__ rgb,
         const float* __restrict__ gx, const float* __restrict__ gy,
         const float* __restrict__ cam, float* state, long long* n_run, bool* more,
         double* partials, unsigned long long* bar, int n, int h, int w, int rot, int rounds,
         int n_ctas, int first, int n_iters, float step_exit, int budget) {
  __shared__ float ss[STATE];    // the level's state, the same bits in every CTA
  __shared__ float sp[P_N];
  __shared__ double acc[NW][NTERMS];
  __shared__ float spt[PIX][7][NT];   // the first logical CTA's round 0, after pass 0
  __shared__ long long s_n;
  __shared__ bool s_more;
  const int t = threadIdx.x, lane = t & 31, G = gridDim.x;
  if (t < STATE) ss[t] = state[t];
  if (t < 4) sp[P_CAM + t] = cam[t];
  __shared__ unsigned long long s_bar;   // the barrier count's base
  if (t == 0) {
    s_n = *n_run;
    s_more = *more;
    s_bar = grid_base(bar, G);
  }
  __syncthreads();
  int k = 0;
  for (;;) {
    double* rows = partials + (size_t)(k & 1) * NTERMS * n_ctas;
    for (int lb = blockIdx.x; lb < n_ctas; lb += G) {
      const int base = lb * NT * PIX * rounds;
      double a1 = 0.0, a2 = 0.0;
      for (int r = 0; r < rounds; ++r) {
        // round 0 of the first logical CTA (every round where the card
        // holds the grid) stays in shared memory after pass 0; a thread
        // reads back only its own
        const bool kept = r == 0 && lb == (int)blockIdx.x;
        Points pt;
#pragma unroll
        for (int m = 0; m < PIX; ++m) {
          const int p = base + (r * PIX + m) * NT + t;
          if (p < n) {
            float q[7];
            if (k > 0 && kept) {
#pragma unroll
              for (int i = 0; i < 7; ++i) q[i] = spt[m][i][t];
            } else {
#pragma unroll
              for (int i = 0; i < 3; ++i) {
                q[i] = __ldg(pts + 3 * p + i);
                q[3 + i] = __ldg(col + 3 * p + i);
              }
              q[6] = valid[p] ? 1.0f : 0.0f;
              if (kept) {
#pragma unroll
                for (int i = 0; i < 7; ++i) spt[m][i][t] = q[i];
              }
            }
            point_terms(ss, sp, q, rgb, gx, gy, h, w, rot != 0, pt.J[m], pt.r[m],
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
      const double row = cta_sum<NTERMS>(acc, a1, a2);
      if (t < NTERMS) rows[(size_t)t * n_ctas + lb] = row;
      if (lb + G < n_ctas) __syncthreads();   // acc read before the next sums
    }
    grid_sync(bar, s_bar + (unsigned long long)(k + 1) * G);
    take_step(rows, ss, &s_n, &s_more, n_ctas, n, first != 0 && k == 0, n_iters, step_exit,
              acc);
    __syncthreads();
    ++k;
    if (!(s_more && k < budget)) break;
  }
  if (blockIdx.x == 0) {
    if (t < STATE) state[t] = ss[t];
    if (t == 0) {
      *n_run = s_n;
      *more = s_more;
    }
  }
  // the last pass's rows into the first half, each copied by the thread
  // that wrote it (that half's last readers, the steps of the pass before,
  // arrived at the last pass's barrier first)
  if (((k - 1) & 1) && t < NTERMS) {
    for (int lb = blockIdx.x; lb < n_ctas; lb += G)
      partials[(size_t)t * n_ctas + lb] = partials[(size_t)(NTERMS + t) * n_ctas + lb];
  }
}

}  // namespace

// the CTAs the card holds resident at once (occupancy x SMs; 0 where it
// cannot launch a cooperative kernel); loads the kernel onto the current
// device, which a first launch inside a graph capture would otherwise do
extern "C" int color_gn_capacity(int* ctas) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_level, NT, 0);
  *ctas = coop ? per_sm * sms : 0;
  return (int)e;
}

extern "C" int color_gn(const float* pts, const float* col, const bool* valid,
                        const float* rgb, const float* gx, const float* gy, const float* cam,
                        float* state, long long* n_run, bool* more, double* partials, int n,
                        int h, int w, int rot, int rounds, int n_ctas, int grid, int first,
                        int n_iters, float step_exit, int budget, cudaStream_t stream) {
  // `grid` <= n_ctas CTAs, all resident (the CUDA runtime refuses the launch
  // otherwise); the barrier's words: the bits of the slot after the two
  // halves of rows
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(partials + (size_t)2 * NTERMS * n_ctas);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(NT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, gn_level, pts, col, valid, rgb, gx, gy, cam, state,
                                     n_run, more, partials, bar, n, h, w, rot, rounds, n_ctas,
                                     first, n_iters, step_exit, budget);
  cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
