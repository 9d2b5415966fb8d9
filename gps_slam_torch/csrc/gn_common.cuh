// gn_common.cuh — what the two Gauss-Newton level kernels share:
// icp_gn.cu (the ICP tracker's level) and color_gn.cu (the colour
// tracker's).
//
// Both run a whole pyramid level in one cooperative launch (every CTA
// resident at once), pass after pass: a thread takes PIX points a round,
// each warp sums its lanes' NTERMS f64 terms by an xor transpose, each
// logical CTA of the grid writes one f64 row of sums (`cta_sum`; a
// resident CTA takes the logical CTAs b, b + gridDim.x, ... where the
// grid outgrows the card); a grid barrier (`grid_sync`);
// then every CTA sums the rows in one fixed order (`sum_rows`) and one of
// its warps takes the Levenberg-Marquardt step, the same bits in each: a 6x6 LU with partial pivoting, a
// row a lane in registers (`lu6_lanes`), and se3_exp, each entry of a
// matrix in a lane.  The sums' order is `icp_gn.cta_sums`
// (gps_slam_torch/slam/icp_gn.py), which both plain versions use; every
// f32 expression is the plain versions', built with -fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gn {

constexpr int NT = 256;          // threads of a CTA
constexpr int NW = NT / 32;
constexpr int PIX = 2;           // points a thread sums before its warp's transpose
constexpr unsigned FULL = 0xffffffffu;

// torch.clamp on the card: NaN passes through
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_minf(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// one step of the transpose: a lane keeps values [0, N) or [N, 2N) by its
// lane bit B, sends the other half across that bit and adds what comes back
template <int N, int B>
__device__ __forceinline__ void xor_step(double* v, int lane) {
  const bool up = lane & B;
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = (up ? v[i + N] : v[i]) + __shfl_xor_sync(FULL, up ? v[i] : v[i + N], B);
}

// One warp's sums of the NTERMS (33 to 48) terms of its 32 lanes, `term(j)`
// being lane's term j, by an xor transpose: at each lane bit from 4 down to
// 0 a lane keeps half of its values, sends the other half to the lane
// across that bit and adds what it gets back.  Lane l ends with the warp's
// sum of term l (s1) and of term 32 + (l >> 1) (s2, for 32 + (l >> 1) <
// NTERMS).  Each sum is the tree that pairs lanes l and l ^ 16, then those
// pairs at lane distance 8, ..., 1: the halving tree of `icp_gn.cta_sums`
// (a shuffle down by 16, 8, 4, 2, 1), bit for bit, since IEEE addition
// commutes; 47 f64 shuffles a warp where a shuffle-down sum of each of 45
// terms takes 225.
template <int NTERMS, class Term>
__device__ __forceinline__ void warp_terms(const Term& term, int lane, double& s1,
                                           double& s2) {
  static_assert(NTERMS > 32 && NTERMS <= 48, "terms 32.. fill 16 values");
  double v[16];
  bool up = lane & 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const double lo = term(i), hi = term(i + 16);
    v[i] = (up ? hi : lo) + __shfl_xor_sync(FULL, up ? lo : hi, 16);
  }
  xor_step<8, 8>(v, lane);
  xor_step<4, 4>(v, lane);
  xor_step<2, 2>(v, lane);
  xor_step<1, 1>(v, lane);
  s1 = v[0];
  // terms 32 .. NTERMS - 1 as values 0 .. NTERMS - 33 of 16, the rest +0
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const double lo = 32 + i < NTERMS ? term(32 + i) : 0.0;
    const double hi = 40 + i < NTERMS ? term(40 + i) : 0.0;
    v[i] = (up ? hi : lo) + __shfl_xor_sync(FULL, up ? lo : hi, 16);
  }
  xor_step<4, 8>(v, lane);
  xor_step<2, 4>(v, lane);
  xor_step<1, 2>(v, lane);
  s2 = v[0] + __shfl_xor_sync(FULL, v[0], 1);
}

// a warp's running sums (s1, s2 of `warp_terms`, added round after round
// from +0) into acc[warp][term]
template <int NTERMS>
__device__ __forceinline__ void store_warp_sums(double (*acc)[NTERMS], int warp, int lane,
                                                double a1, double a2) {
  acc[warp][lane] = a1;
  if (!(lane & 1) && 32 + (lane >> 1) < NTERMS) acc[warp][32 + (lane >> 1)] = a2;
}

// the NW warps' running sums acc [NW][NTERMS] by halving; thread j <
// NTERMS returns term j's
template <int NTERMS>
__device__ __forceinline__ double warps_sum(const double (*acc)[NTERMS], int j) {
  double a[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) a[i] = acc[i][j];
#pragma unroll
  for (int h = NW / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int i = 0; i < h; ++i) a[i] = a[i] + a[i + h];
  }
  return a[0];
}

// The end of a CTA's sums: its warps' running sums (a1, a2 of each lane)
// halved into one row; thread j < NTERMS returns the row's term j (0 in
// the others).  `acc` is read after the call: a CTA that sums again syncs
// first.
template <int NTERMS>
__device__ __forceinline__ double cta_sum(double (*acc)[NTERMS], double a1, double a2) {
  const int t = threadIdx.x;
  store_warp_sums<NTERMS>(acc, t >> 5, t & 31, a1, a2);
  __syncthreads();
  return t < NTERMS ? warps_sum<NTERMS>(acc, t) : 0.0;
}

// A barrier of the whole grid, sound only because the launch is
// cooperative (every CTA resident at once), on a 64-bit count of arrivals
// that only grows: it starts at 0 with its buffer and stands at a
// multiple of the grid's n resident CTAs whenever no barrier is under way
// (every launch on one buffer has the same grid: its wrapper's for the
// level's size on the card).
// `grid_base` reads that multiple at the launch's start (no CTA passes
// the launch's first barrier before every CTA has arrived, so at most
// n - 1 arrivals can precede the read); the launch's barrier i then
// waits for base + i n.  A CTA arrives with one add of release semantics
// at the device scope (after __syncthreads, so its threads' row writes go
// before it) and waits with loads of acquire semantics, the pattern of
// CUTLASS's grid barrier: no full fence either side.  A wait that lasts
// past ~2^33 cycles (seconds) traps: a fault, not a hung card.
__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long grid_base(const unsigned long long* bar,
                                                        unsigned n) {
  return ld_acquire(bar) / n * n;
}

__device__ __forceinline__ void grid_sync(unsigned long long* bar,
                                          unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" : : "l"(bar) : "memory");
    const long long t0 = clock64();
    while (ld_acquire(bar) < target) {
      if (clock64() - t0 > (1ll << 33)) __trap();
    }
  }
  __syncthreads();
}

// A pass's totals: the CTAs' rows summed as the points are (a row a
// thread a round, one point a thread), into tot [NTERMS] in shared memory.
// A thread loads its row's NTERMS terms at once (one trip to L2), then
// the warps transpose them.
template <int NTERMS>
__device__ __forceinline__ void sum_rows(const double* partials, int n_ctas,
                                         double (*acc)[NTERMS], double* tot) {
  const int t = threadIdx.x, lane = t & 31;
  const int rounds = (n_ctas + NT - 1) / NT;
  double a1 = 0.0, a2 = 0.0;
  for (int k = 0; k < rounds; ++k) {
    const int row = k * NT + t;
    // rows other CTAs wrote: read from L2
    double x[NTERMS];
#pragma unroll
    for (int j = 0; j < NTERMS; ++j)
      x[j] = row < n_ctas ? __ldcg(partials + (size_t)j * n_ctas + row) : 0.0;
    auto term = [&](int j) -> double { return x[j]; };
    double s1, s2;
    warp_terms<NTERMS>(term, lane, s1, s2);
    a1 = a1 + s1;
    a2 = a2 + s2;
  }
  store_warp_sums<NTERMS>(acc, t >> 5, lane, a1, a2);
  __syncthreads();
  if (t < NTERMS) tot[t] = warps_sum<NTERMS>(acc, t);
  __syncthreads();
}

// the bilinear read of `icp_gn.bilinear` at (us, vs): three channels and
// the weight sum, a corner whose three values are all zero left out
__device__ __forceinline__ void bilinear(const float* __restrict__ img, int Wf, int iu0,
                                         int iv0, int iu1, int iv1, float fu, float fv,
                                         float out[3], float& wacc) {
  const int iu[4] = {iu0, iu1, iu0, iu1};
  const int iv[4] = {iv0, iv0, iv1, iv1};
  const float ww[4] = {(1.0f - fu) * (1.0f - fv), fu * (1.0f - fv), (1.0f - fu) * fv,
                       fu * fv};
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  wacc = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float* px = img + ((size_t)iv[c] * Wf + iu[c]) * 3;
    const float c0 = __ldg(px), c1 = __ldg(px + 1), c2 = __ldg(px + 2);
    const float ok = ((fabsf(c0) + fabsf(c1)) + fabsf(c2)) > 1e-6f ? 1.0f : 0.0f;
    a0 = a0 + (c0 * ww[c]) * ok;
    a1 = a1 + (c1 * ww[c]) * ok;
    a2 = a2 + (c2 * ww[c]) * ok;
    wacc = wacc + ww[c] * ok;
  }
  const float den = clamp_minf(wacc, 1e-6f);
  out[0] = a0 / den;
  out[1] = a1 / den;
  out[2] = a2 / den;
}

// the corners and fractions of a bilinear read at (u, v) clamped into a
// Wf x Hf image: `icp_gn.bilinear`'s indices
struct Corners {
  int iu0, iv0, iu1, iv1;
  float fu, fv;
};

__device__ __forceinline__ Corners corners(float us, float vs, int Wf, int Hf) {
  Corners c;
  const float u0 = floorf(us), v0 = floorf(vs);
  c.fu = us - u0;
  c.fv = vs - v0;
  c.iu0 = min(max((int)u0, 0), Wf - 1);
  c.iv0 = min(max((int)v0, 0), Hf - 1);
  c.iu1 = min(c.iu0 + 1, Wf - 1);
  c.iv1 = min(c.iv0 + 1, Hf - 1);
  return c;
}

// x with sA x = sb (6 x 6 in shared memory, row-major) by LU with partial
// pivoting (`icp_gn.solve6`), in registers: lane r < 6 holds row r of A
// and b.  Column k: the pivot row by one warp max of a key that orders
// |a_ik| by its bits, a NaN above every number, and a ballot for the
// first row that holds the max (the serial search's first largest, first
// NaN); the two rows swapped by shuffles (the columns from k on: the
// others are never read again), the pivot row broadcast, and each row
// below it eliminated by its own lane; then back substitution from the
// last unknown up, each x_j broadcast from lane j.  Every f32
// expression is the plain version's.  Returns x in every lane and "no
// zero pivot".
__device__ __forceinline__ bool lu6_lanes(const float* sA, const float* sb, float x[6],
                                          int lane) {
  float a[6], bb;
  const bool row = lane < 6;
#pragma unroll
  for (int j = 0; j < 6; ++j) a[j] = row ? sA[lane * 6 + j] : 0.0f;
  bb = row ? sb[lane] : 0.0f;
  bool nonzero = true;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float m = fabsf(a[k]);
    const bool below = lane >= k && row;
    const unsigned key = below ? (isnan(m) ? 0x7fffffffu : __float_as_uint(m)) : 0u;
    const unsigned top = __reduce_max_sync(FULL, key);
    const int p = __ffs(__ballot_sync(FULL, below && key == top)) - 1;
    const int src = lane == k ? p : (lane == p ? k : lane);
#pragma unroll
    for (int j = k; j < 6; ++j) a[j] = __shfl_sync(FULL, a[j], src);
    bb = __shfl_sync(FULL, bb, src);
    const float piv = __shfl_sync(FULL, a[k], k);
    nonzero = nonzero && piv != 0.0f;
    float rk[6];
#pragma unroll
    for (int j = k + 1; j < 6; ++j) rk[j] = __shfl_sync(FULL, a[j], k);
    const float bk = __shfl_sync(FULL, bb, k);
    if (lane > k && row) {
      const float f = a[k] / piv;
#pragma unroll
      for (int j = k + 1; j < 6; ++j) a[j] = a[j] - f * rk[j];
      bb = bb - f * bk;
    }
  }
#pragma unroll
  for (int j = 5; j >= 0; --j) {
    const float xj = __shfl_sync(FULL, bb / a[j], j);
    x[j] = xj;
    if (lane < j) bb = bb - a[j] * xj;
  }
  return nonzero;
}

// E = se3_exp(dl) (`icp_gn._se3_exp`, each sum term by term) into sE [16],
// row-major: lane i < 3 builds row i, lanes 3-6 the bottom row
__device__ __forceinline__ void se3_exp_warp(const float dl[6], float* sE, int lane) {
  const float theta = clamp_minf(sqrtf((dl[3] * dl[3] + dl[4] * dl[4]) + dl[5] * dl[5]),
                                 1e-12f);
  if (lane < 3) {
    const int i = lane;
    const float ax = dl[3] / theta, ay = dl[4] / theta, az = dl[5] / theta;
    const float K[9] = {0.0f, -az, ay, az, 0.0f, -ax, -ay, ax, 0.0f};
    const float sin_t = sinf(theta), cos_t = cosf(theta);
    const bool small = theta < 1e-8f;
    const float omc = 1.0f - cos_t;
    const float c1 = omc / theta, c2 = (theta - sin_t) / theta;
    float V[3];
    for (int j = 0; j < 3; ++j) {
      const float kk = (K[i * 3] * K[j] + K[i * 3 + 1] * K[3 + j]) + K[i * 3 + 2] * K[6 + j];
      const float e = i == j ? 1.0f : 0.0f;
      sE[i * 4 + j] = small ? e : (e + sin_t * K[i * 3 + j]) + omc * kk;
      V[j] = small ? e : (e + c1 * K[i * 3 + j]) + c2 * kk;
    }
    sE[i * 4 + 3] = (V[0] * dl[0] + V[1] * dl[1]) + V[2] * dl[2];
  } else if (lane < 7) {
    sE[12 + lane - 3] = lane == 6 ? 1.0f : 0.0f;
  }
}

// entry (i, j) = lane of E @ T for 4 x 4 row-major matrices, each sum term
// by term (`icp_gn._compose`)
__device__ __forceinline__ float compose_entry(const float* sE, const float* sT, int e) {
  const int i = e >> 2, j = e & 3;
  return ((sE[i * 4] * sT[j] + sE[i * 4 + 1] * sT[4 + j]) + sE[i * 4 + 2] * sT[8 + j])
         + sE[i * 4 + 3] * sT[12 + j];
}

// the sum of the squared step, term by term
__device__ __forceinline__ float step_of(const float dl[6]) {
  return ((((dl[0] * dl[0] + dl[1] * dl[1]) + dl[2] * dl[2]) + dl[3] * dl[3])
          + dl[4] * dl[4]) + dl[5] * dl[5];
}

}  // namespace gn
