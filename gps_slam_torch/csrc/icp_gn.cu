// icp_gn_cuda — the Gauss-Newton loop of an ICP pyramid level in one
// cooperative launch: pass after pass, the per-pixel point-to-plane
// system, its f64 sums and the Levenberg-Marquardt step, on the level's
// carried state in place, until the loop's test fails or `budget` passes
// have run.
//
// Replaces no TPU kernel: the counterpart of the JAX tracker's per-level
// `lax.while_loop` (gps_slam_tpu/slam/tracker.py:150-233), its body
// `gn_iter` and its exit test, which XLA compiles into one program.  Its
// plain version, with the semantics and the state layout, is
// gps_slam_torch/slam/icp_gn.py (`iterate_plain`, one pass, run in a loop
// by `run_plain`); every f32 expression here is that version's, in its
// order, built with -fmad=false and true divisions, so the two give the
// same bits on the card.
//
// What bounds it on the H100: at the finest level, bytes.  At 1200x680 a
// pass reads the depth (3.3 MB) and, around each pixel's projection, the
// reference vertex and normal maps (2 x 9.8 MB, which fit in the 50 MB L2
// and are read again each pass); its f32 work (~270 operations a pixel,
// 14 of them true divisions) and f64 work (42 products and ~45 adds a
// pixel; the H100's FP64 rate is half its FP32) take less.  At the coarse
// levels (51,000 and 12,750 pixels) a pass is a chain of latencies, and
// the design shortens it:
//
//   * the whole level is one launch with every CTA resident
//     (cudaLaunchKernelEx, cudaLaunchAttributeCooperative), so a pass costs
//     no launch, no host read and no graph node.  The logical grid, which
//     fixes the sums' order, stays within 264 CTAs of 256 threads, two an
//     SM at <= 128 registers a thread; the launch's grid is the logical
//     one capped at the CTAs the card holds resident, each resident CTA
//     taking the logical CTAs b, b + gridDim.x, ...;
//   * a thread takes PIX = 2 pixels a round, `rounds` rounds, and adds
//     their terms (keeping the depths in shared memory across passes
//     gained nothing: tools/icp_gn_split.py); a warp sums each round's 45 terms over its 32 lanes by
//     an xor transpose (`warp_terms`), then the 8 warps' sums by halving,
//     one f64 row per logical CTA ([45, n_ctas], two such halves used in turn by
//     the passes, so that a pass's rows never overwrite the rows another
//     CTA is still summing);
//   * a grid barrier on a counter (`grid_sync`: one atomic add a CTA)
//     where the launch boundary was; then every CTA sums the rows in the
//     same order (a thread loads its row's terms at once) and one warp
//     takes the step from the level state it keeps in shared memory: the
//     accept/reject, the damping, a 6x6 LU with partial pivoting a row a
//     lane in registers (a zero pivot or a non-finite solution gives a
//     zero step), se3_exp and the new estimate, the iteration count and
//     the loop's test.  Every CTA taking the step costs one barrier a
//     pass; CTA 0 taking it and publishing the state behind a second
//     barrier was slower at every level (tools/icp_gn_split.py);
//   * CTA 0 writes the state, the count and the test once, at the end;
//     every logical CTA's row of the last pass is left in the first half.
//
// No sum depends on timing or on the CTA: every CTA's step is the same
// bits, and two launches give the same bits.

#include "gn_common.cuh"

namespace {

using namespace gn;

constexpr int NTERMS = 45;       // H (36, row-major), g (6), sum |r| w, sum w, inliers
constexpr int STATE = 79;        // `icp_gn.FIELDS`

// shared parameters of a launch: the raycast camera's w2c rows 0-2, cam
// [8], space_thresh^2, tukey_c
constexpr int P_R = 0, P_CAM = 12, P_ST2 = 20, P_TC = 21, P_N = 22;

// `icp_gn.terms` of one pixel: Jw = Jt w and Jt (f32), r, |r| w, w, ok
__device__ __forceinline__ void pixel_terms(
    const float* __restrict__ sT, const float* __restrict__ sp,
    const float* __restrict__ depth, const float* __restrict__ refv,
    const float* __restrict__ refn, int p, int w, int Hf, int Wf, bool rot, float jw[6],
    float jt[6], float& r, float& rw, float& wgt, float& okf) {
  const int row = p / w, col = p - row * w;
  const float d = __ldg(depth + p);
  const float x = ((float)col - sp[P_CAM + 2]) / sp[P_CAM + 0];
  const float y = ((float)row - sp[P_CAM + 3]) / sp[P_CAM + 1];
  const float px = x * d, py = y * d, pz = 1.0f * d;
  float pw[3], pr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = sT + 4 * i;
    pw[i] = ((m[0] * px + m[1] * py) + m[2] * pz) + m[3];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = sp + P_R + 4 * i;
    pr[i] = ((m[0] * pw[0] + m[1] * pw[1]) + m[2] * pw[2]) + m[3];
  }
  const float z = pr[2];
  const float zs = clamp_minf(z, 1e-6f);
  const float u = sp[P_CAM + 4] * pr[0] / zs + sp[P_CAM + 6];
  const float v = sp[P_CAM + 5] * pr[1] / zs + sp[P_CAM + 7];
  const bool in_img = (z > 0.0f) & (u >= 0.0f) & (u <= (float)(Wf - 1)) & (v >= 0.0f)
                      & (v <= (float)(Hf - 1));
  const float us = clampf(u, 0.0f, (float)Wf - 1.0f);
  const float vs = clampf(v, 0.0f, (float)Hf - 1.0f);
  const Corners q = corners(us, vs, Wf, Hf);
  float vt[3], nt[3], wv, wn;
  bilinear(refv, Wf, q.iu0, q.iv0, q.iu1, q.iv1, q.fu, q.fv, vt, wv);
  bilinear(refn, Wf, q.iu0, q.iv0, q.iu1, q.iv1, q.fu, q.fv, nt, wn);
  const float nlen = sqrtf((nt[0] * nt[0] + nt[1] * nt[1]) + nt[2] * nt[2]);
  const float nl = clamp_minf(nlen, 1e-6f);
  const float n0 = nt[0] / nl, n1 = nt[1] / nl, n2 = nt[2] / nl;
  const bool has_ref = (wv > 0.5f) & (wn > 0.5f) & (nlen > 0.3f);
  const float d0 = pw[0] - vt[0], d1 = pw[1] - vt[1], d2 = pw[2] - vt[2];
  const float dist2 = (d0 * d0 + d1 * d1) + d2 * d2;
  r = (n0 * d0 + n1 * d1) + n2 * d2;
  const bool ok = (d > 0.0f) & in_img & has_ref & (dist2 < sp[P_ST2]);
  // Tukey biweight on the point-to-plane residual
  const float t = clampf(r / sp[P_TC], -1.0f, 1.0f);
  const float s = 1.0f - t * t;
  okf = ok ? 1.0f : 0.0f;
  wgt = okf * (s * s);
  // d r / d xi = [n ; p_w x n] for a left-multiplied twist on T
  jt[0] = n0;
  jt[1] = n1;
  jt[2] = n2;
  jt[3] = pw[1] * n2 - pw[2] * n1;
  jt[4] = pw[2] * n0 - pw[0] * n2;
  jt[5] = pw[0] * n1 - pw[1] * n0;
  if (rot) {
    jt[0] = jt[0] * 0.0f;
    jt[1] = jt[1] * 0.0f;
    jt[2] = jt[2] * 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) jw[i] = jt[i] * wgt;
  rw = fabsf(r) * wgt;
}

// one round of a thread: its PIX pixels p0 + m NT, m < PIX (+0 terms past
// the level's n pixels), summed term by term in m's order
struct Pixels {
  float jw[PIX][6], jt[PIX][6], r[PIX], rw[PIX], wgt[PIX], okf[PIX];

  __device__ __forceinline__ double term(int m, int j) const {
    if (j < 36) return (double)jw[m][j / 6] * (double)jt[m][j % 6];
    if (j < 42) return (double)jw[m][j - 36] * (double)r[m];
    if (j == 42) return (double)rw[m];
    if (j == 43) return (double)wgt[m];
    return (double)okf[m];
  }
  __device__ __forceinline__ double operator()(int j) const {
    double v = term(0, j);
#pragma unroll
    for (int m = 1; m < PIX; ++m) v = v + term(m, j);
    return v;
  }
};

// A pass's step: the CTAs' rows summed as the pixels are (`sum_rows`),
// then `icp_gn.lm_step` in one warp, each entry of a matrix in a lane of
// its own, with the plain version's operations in its order, on the level
// state `ss` in shared memory (the new state written back there); what
// every lane needs, every lane computes alike
__device__ __forceinline__ void take_step(const double* rows, float* ss, long long* s_n,
                                          bool* s_more, int n_ctas, int n_pix, bool first,
                                          int n_iters, float step_exit,
                                          double (*acc)[NTERMS]) {
  __shared__ double tot[NTERMS];
  // the step's matrices: H_ref, the damped system, T_ref, E = se3_exp(delta)
  __shared__ float sH[36], sA[36], sT[16], sE[16], sg[6], sb[6];
  const int t = threadIdx.x, lane = t & 31;
  sum_rows<NTERMS>(rows, n_ctas, acc, tot);
  if (t >= 32) return;

  const float n_ok = (float)tot[44];
  const double den = isnan(tot[43]) ? tot[43] : fmax(tot[43], 1.0);
  const float mean_r = (float)(tot[42] / den);
  const float inlier = n_ok / (float)n_pix;
  const float err = n_ok > 50.0f ? mean_r : INFINITY;
  const float err_acc = ss[74], lam = ss[75];
  const bool better = first || err <= err_acc;
  const float err_ref = better ? err : err_acc;
  const float lam_new = clampf(better ? lam * 0.1f : lam * 10.0f, 1e-6f, 1e5f);
  for (int i = lane; i < 36; i += 32) sH[i] = better ? (float)tot[i] : ss[32 + i];
  if (lane < 6) sg[lane] = better ? (float)tot[36 + lane] : ss[68 + lane];
  if (lane < 16) sT[lane] = better ? ss[lane] : ss[16 + lane];
  __syncwarp();
  // lambda-scaled diagonal + an absolute floor scaled to the mean diagonal
  const float trace = ((((sH[0] + sH[7]) + sH[14]) + sH[21]) + sH[28]) + sH[35];
  const float mean_diag = trace / 6.0f + 1e-6f;
  const float c = 1e-2f * mean_diag;
  for (int e = lane; e < 36; e += 32) {
    const bool diag = e % 7 == 0;
    const float damp = lam_new * (diag ? sH[e] : 0.0f) + c * (diag ? 1.0f : 0.0f);
    sA[e] = sH[e] + damp;
  }
  if (lane < 6) sb[lane] = -sg[lane];
  __syncwarp();
  float dl[6];
  const bool nonzero = lu6_lanes(sA, sb, dl, lane);
  bool ok = nonzero && isfinite(err_ref);
  for (int i = 0; i < 6; ++i) ok = ok && isfinite(dl[i]);
  for (int i = 0; i < 6; ++i) dl[i] = ok ? dl[i] : 0.0f;
  se3_exp_warp(dl, sE, lane);
  __syncwarp();
  // the new state: lane (i, j) of T_new, the rest copied over (ss is not
  // read past the first __syncwarp)
  ss[lane] = lane < 16 ? compose_entry(sE, sT, lane) : sT[lane - 16];
  for (int i = lane; i < 36; i += 32) ss[32 + i] = sH[i];
  if (lane < 6) ss[68 + lane] = sg[lane];
  if (lane == 0) {
    const float step = step_of(dl);
    ss[74] = err_ref;
    ss[75] = lam_new;
    ss[76] = step;
    ss[77] = inlier;
    ss[78] = mean_r;
    const long long n = *s_n + 1;
    *s_n = n;
    *s_more = (n < n_iters) & (step > step_exit);
  }
}

// the level's passes: the first always, then while the loop's test holds
// and fewer than `budget` have run in this launch.  The launch's grid
// holds gridDim.x <= n_ctas CTAs; CTA b takes the logical CTAs b, b +
// gridDim.x, ... of the n_ctas whose rows fix the sums' order.
__global__ void __launch_bounds__(NT, 2)
gn_level(const float* __restrict__ depth, const float* __restrict__ refv,
         const float* __restrict__ refn, const float* __restrict__ cam,
         const float* __restrict__ rpi, const float* __restrict__ st,
         const float* __restrict__ tc, float* state, long long* n_run, bool* more,
         double* partials, unsigned long long* bar, int h, int w, int Hf, int Wf, int rot, int rounds,
         int n_ctas, int first, int n_iters, float step_exit, int budget) {
  __shared__ float ss[STATE];    // the level's state, the same bits in every CTA
  __shared__ float sp[P_N];
  __shared__ double acc[NW][NTERMS];
  __shared__ long long s_n;
  __shared__ bool s_more;
  const int t = threadIdx.x, lane = t & 31, G = gridDim.x;
  if (t < STATE) ss[t] = state[t];
  if (t < 12) sp[P_R + t] = rpi[t];
  else if (t < 20) sp[P_CAM + t - 12] = cam[t - 12];
  else if (t == 20) sp[P_ST2] = st[0] * st[0];
  else if (t == 21) sp[P_TC] = tc[0];
  __shared__ unsigned long long s_bar;   // the barrier count's base
  if (t == 0) {
    s_n = *n_run;
    s_more = *more;
    s_bar = grid_base(bar, G);
  }
  __syncthreads();
  const int n = h * w;
  int k = 0;
  for (;;) {
    double* rows = partials + (size_t)(k & 1) * NTERMS * n_ctas;
    for (int lb = blockIdx.x; lb < n_ctas; lb += G) {
      const int base = lb * NT * PIX * rounds;
      double a1 = 0.0, a2 = 0.0;
      for (int r = 0; r < rounds; ++r) {
        Pixels px;
#pragma unroll
        for (int m = 0; m < PIX; ++m) {
          const int p = base + (r * PIX + m) * NT + t;
          if (p < n) {
            pixel_terms(ss, sp, depth, refv, refn, p, w, Hf, Wf, rot != 0, px.jw[m],
                        px.jt[m], px.r[m], px.rw[m], px.wgt[m], px.okf[m]);
          } else {
#pragma unroll
            for (int i = 0; i < 6; ++i) px.jw[m][i] = px.jt[m][i] = 0.0f;
            px.r[m] = px.rw[m] = px.wgt[m] = px.okf[m] = 0.0f;
          }
        }
        double s1, s2;
        warp_terms<NTERMS>(px, lane, s1, s2);
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
extern "C" int icp_gn_capacity(int* ctas) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_level, NT, 0);
  *ctas = coop ? per_sm * sms : 0;
  return (int)e;
}

extern "C" int icp_gn(const float* depth, const float* refv, const float* refn,
                      const float* cam, const float* rpi, const float* st, const float* tc,
                      float* state, long long* n_run, bool* more, double* partials, int h,
                      int w, int Hf, int Wf, int rot, int rounds, int n_ctas, int grid,
                      int first, int n_iters, float step_exit, int budget,
                      cudaStream_t stream) {
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
  cudaError_t e = cudaLaunchKernelEx(&cfg, gn_level, depth, refv, refn, cam, rpi, st, tc, state,
                                     n_run, more, partials, bar, h, w, Hf, Wf, rot, rounds,
                                     n_ctas, first, n_iters, step_exit, budget);
  cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
