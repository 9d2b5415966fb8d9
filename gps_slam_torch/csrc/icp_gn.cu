// icp_gn_cuda — one Gauss-Newton iteration of an ICP pyramid level: the
// per-pixel point-to-plane system, its f64 sums and the
// Levenberg-Marquardt step, on the level's carried state in place.
//
// Replaces no TPU kernel: the counterpart of the body `gn_iter` of the JAX
// tracker's per-level `lax.while_loop` (gps_slam_tpu/slam/tracker.py:
// 150-224), which XLA compiles into a few fusions of one program.  Its
// plain version, with the semantics and the state layout, is
// gps_slam_torch/slam/icp_gn.py; every f32 expression here is that
// version's, in its order, built with -fmad=false and true divisions, so
// the two give the same bits on the card.
//
// What bounds it on the H100: bytes.  At 1200x680 a pass reads the depth
// (3.3 MB) and, around each pixel's projection, the reference vertex and
// normal maps (2 x 9.8 MB, which fit in the 50 MB L2 and are read again
// each iteration); its f32 work (~270 operations a pixel, 14 of them true
// divisions) and f64 work (42 products and ~45 adds a pixel; the H100's
// FP64 rate is half its FP32) take less.  The design fights what a loop of
// small torch kernels paid for, launches (~300 a pass) and the trips of
// [N, 6] intermediates through device memory, and then what a warp spends
// on its 45 sums.  One kernel a pass, `gn_iter` (its warp sums, ticket,
// row sums, LU and se3_exp are gn_common.cuh's, shared with color_gn.cu):
//
//   * a thread takes PIX = 2 pixels a round, `rounds` rounds (the grid
//     stays within 264 CTAs of 256 threads, one wave at 100 registers a
//     thread), and adds their terms;
//   * a warp sums each round's 45 terms over its 32 lanes by an xor
//     transpose (`warp_terms`: 47 f64 shuffles, where a shuffle-down sum of
//     each term takes 225), each lane keeping the running sum of one term
//     round after round from +0; then the 8 warps' sums by halving, one f64
//     row per CTA ([45, n_ctas]);
//   * the CTA that finishes last (a ticket counted with one atomic add per
//     CTA after a fence) sums the rows the same way, a row a thread, and
//     one warp takes the step, each entry of a matrix in a lane: the
//     accept/reject, the damping, a 6x6 LU with partial pivoting (a zero
//     pivot or a non-finite solution gives a zero step), se3_exp and the
//     new estimate, the state, the iteration count and the loop's test.
//
// No sum depends on which CTA finishes last or on timing: two launches
// give the same bits.  The first design (a pixel a thread a round, a
// shuffle-down sum of each term, a second kernel for the step in one
// thread) took 0.108 ms on the finest level's pass (NVIDIA H100 80GB HBM3,
// chip_smoke.py's [kernel] row).
//
// With `active` (the unrolled route's mask) false, the kernel changes no
// state and writes the loop's test anew.

#include "gn_common.cuh"

namespace {

using namespace gn;

constexpr int NTERMS = 45;       // H (36, row-major), g (6), sum |r| w, sum w, inliers

// shared parameters of a pass: T's rows 0-2, the raycast camera's w2c rows
// 0-2, cam [8], space_thresh^2, tukey_c
constexpr int P_T = 0, P_R = 12, P_CAM = 24, P_ST2 = 32, P_TC = 33, P_N = 34;

// `icp_gn.terms` of one pixel: Jw = Jt w and Jt (f32), r, |r| w, w, ok
__device__ __forceinline__ void pixel_terms(
    const float* __restrict__ sp, const float* __restrict__ depth,
    const float* __restrict__ refv, const float* __restrict__ refn, int p, int w, int Hf,
    int Wf, bool rot, float jw[6], float jt[6], float& r, float& rw, float& wgt,
    float& okf) {
  const int row = p / w, col = p - row * w;
  const float d = __ldg(depth + p);
  const float x = ((float)col - sp[P_CAM + 2]) / sp[P_CAM + 0];
  const float y = ((float)row - sp[P_CAM + 3]) / sp[P_CAM + 1];
  const float px = x * d, py = y * d, pz = 1.0f * d;
  float pw[3], pr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* m = sp + P_T + 4 * i;
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

// the state's loop test, unchanged state
__device__ __forceinline__ void test_only(const float* state, const long long* n_run,
                                          bool* more, int n_iters, float step_exit) {
  *more = (*n_run < n_iters) & (state[76] > step_exit);
}

// the last CTA: the CTAs' rows summed as the pixels are (`sum_rows`), then
// `icp_gn.lm_step` in one warp, each entry of a matrix in a lane of its
// own, with the plain version's operations in its order; what every lane
// needs, every lane computes alike
__device__ __forceinline__ void take_step(const double* partials, float* __restrict__ state,
                                          long long* __restrict__ n_run,
                                          bool* __restrict__ more, int n_ctas, int n_pix,
                                          int first, int n_iters, float step_exit,
                                          double (*acc)[NTERMS]) {
  __shared__ double tot[NTERMS];
  __shared__ float ss[79];
  // the step's matrices: H_ref, the damped system, T_ref, E = se3_exp(delta)
  __shared__ float sH[36], sA[36], sT[16], sE[16], sg[6], sb[6], sx[6];
  __shared__ int s_piv;
  const int t = threadIdx.x, lane = t & 31;
  if (t < 79) ss[t] = state[t];
  sum_rows<NTERMS>(partials, n_ctas, acc, tot);
  if (t >= 32) return;

  const float n_ok = (float)tot[44];
  const double den = isnan(tot[43]) ? tot[43] : fmax(tot[43], 1.0);
  const float mean_r = (float)(tot[42] / den);
  const float inlier = n_ok / (float)n_pix;
  const float err = n_ok > 50.0f ? mean_r : INFINITY;
  const float err_acc = ss[74], lam = ss[75];
  const bool better = first != 0 || err <= err_acc;
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
  // the new state: lane (i, j) of T_new, the rest copied over
  state[lane] = lane < 16 ? compose_entry(sE, sT, lane) : sT[lane - 16];
  for (int i = lane; i < 36; i += 32) state[32 + i] = sH[i];
  if (lane < 6) state[68 + lane] = sg[lane];
  if (lane == 0) {
    const float step = step_of(dl);
    state[74] = err_ref;
    state[75] = lam_new;
    state[76] = step;
    state[77] = inlier;
    state[78] = mean_r;
    const long long n = *n_run + 1;
    *n_run = n;
    *more = (n < n_iters) & (step > step_exit);
  }
}

__global__ void __launch_bounds__(NT)
gn_iter(const float* __restrict__ depth, const float* __restrict__ refv,
        const float* __restrict__ refn, const float* __restrict__ cam,
        const float* __restrict__ rpi, const float* __restrict__ st,
        const float* __restrict__ tc, float* __restrict__ state,
        long long* __restrict__ n_run, bool* __restrict__ more,
        const bool* __restrict__ active, double* partials, unsigned* ticket, int h, int w,
        int Hf, int Wf, int rot, int rounds, int n_ctas, int first, int n_iters,
        float step_exit) {
  if (active != nullptr && !*active) {
    if (blockIdx.x == 0 && threadIdx.x == 0) test_only(state, n_run, more, n_iters, step_exit);
    return;
  }
  __shared__ float sp[P_N];
  __shared__ double acc[NW][NTERMS];
  const int t = threadIdx.x, lane = t & 31;
  if (t < 12) sp[P_T + t] = state[t];            // T's rows 0-2
  else if (t < 24) sp[P_R + t - 12] = rpi[t - 12];
  else if (t < 32) sp[P_CAM + t - 24] = cam[t - 24];
  else if (t == 32) sp[P_ST2] = st[0] * st[0];
  else if (t == 33) sp[P_TC] = tc[0];
  __syncthreads();
  const int n = h * w;
  const int base = blockIdx.x * NT * PIX * rounds;
  double a1 = 0.0, a2 = 0.0;
  for (int k = 0; k < rounds; ++k) {
    Pixels px;
#pragma unroll
    for (int m = 0; m < PIX; ++m) {
      const int p = base + (k * PIX + m) * NT + t;
      if (p < n) {
        pixel_terms(sp, depth, refv, refn, p, w, Hf, Wf, rot != 0, px.jw[m], px.jt[m],
                    px.r[m], px.rw[m], px.wgt[m], px.okf[m]);
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
  // the CTA that finishes last takes the step
  if (!cta_done<NTERMS>(acc, partials, ticket, n_ctas, a1, a2)) return;
  take_step(partials, state, n_run, more, n_ctas, n, first, n_iters, step_exit, acc);
}

}  // namespace

extern "C" int icp_gn(const float* depth, const float* refv, const float* refn,
                      const float* cam, const float* rpi, const float* st, const float* tc,
                      float* state, long long* n_run, bool* more, const bool* active,
                      double* partials, int h, int w, int Hf, int Wf, int rot, int rounds,
                      int n_ctas, int first, int n_iters, float step_exit,
                      cudaStream_t stream) {
  // the ticket: the bits of the slot after the rows
  unsigned* ticket = reinterpret_cast<unsigned*>(partials + (size_t)NTERMS * n_ctas);
  gn_iter<<<n_ctas, NT, 0, stream>>>(depth, refv, refn, cam, rpi, st, tc, state, n_run, more,
                                     active, partials, ticket, h, w, Hf, Wf, rot, rounds,
                                     n_ctas, first, n_iters, step_exit);
  return (int)cudaGetLastError();
}

// loads the kernel onto the current device: a first launch inside a graph
// capture would load it there
extern "C" int icp_gn_load() {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, gn_iter);
}
