// window_adam_cuda — one Adam update of every attribute of the Gaussian
// pool (means, scales, quats, SH, opacities, exposure) in one launch.
//
// Replaces no TPU kernel: the counterpart of the optax update that the JAX
// package's window scan applies after each gradient (gps_slam_tpu/gs/
// model.py:398, gps_slam_tpu/gs/optim.py:24-53), which XLA fuses into a
// few elementwise fusions.  Its plain version is `WindowAdam._step_plain`
// (gps_slam_torch/gs/optim.py): per element
//
//     mu  = (1 - b1) g + b1 mu
//     nu  = (1 - b2) (g g) + b2 nu
//     p  += ((mu / bc1) / (sqrt(nu / bc2) + eps)) (-lr)
//
// with bc1 = 1 - b1^t, bc2 = 1 - b2^t from the window's schedule table on
// the device (`optim.window_schedule`) and lr the attribute's, the means'
// from the same table row.  Every expression is the plain version's, in
// its order, built with -fmad=false, true divisions and square roots, so
// the two give the same bits on the card.
//
// Bound: bytes.  Per element it reads p, g, mu and nu and writes p, mu
// and nu (28 B) for ~12 f32 operations.  The attributes' pointers, sizes
// and learning rates are kernel arguments (`Args`, by value): a CUDA graph
// captures them with the launch, and nothing is copied from the host.  A
// null gradient is a zero one (an attribute the loss did not reach).  One
// thread an element over the attributes laid end to end; a thread finds
// its attribute by the running offsets.

#include <cuda_runtime.h>

namespace {

#define F(x) ((float)(x))   // a constant as torch takes a Python float: f64, then f32

constexpr int NT = 256;
constexpr int MAXG = 8;

struct Group {
  float* p;
  const float* g;   // null: a zero gradient
  float* mu;
  float* nu;
  long long n;
  float neg_lr;     // -lr (unused where table_lr)
  int table_lr;     // 1: the lr is -(the table row's third entry)
};

struct Args {
  Group g[MAXG];
  long long offset[MAXG + 1];   // running sums of n; offset[n_groups..] = total
};

__global__ void __launch_bounds__(NT) window_adam_kernel(Args a, const float* __restrict__ table,
                                                         int row) {
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= a.offset[MAXG]) return;
  int k = 0;
  while (i >= a.offset[k + 1]) ++k;
  const Group& G = a.g[k];
  const long long j = i - a.offset[k];
  const float g = G.g ? __ldg(G.g + j) : 0.f;
  const float bc1 = __ldg(table + 3 * row), bc2 = __ldg(table + 3 * row + 1);
  const float neg_lr = G.table_lr ? -__ldg(table + 3 * row + 2) : G.neg_lr;
  const float mu = F(1.0 - 0.9) * g + F(0.9) * G.mu[j];
  const float nu = F(1.0 - 0.999) * (g * g) + F(0.999) * G.nu[j];
  G.mu[j] = mu;
  G.nu[j] = nu;
  const float upd = (mu / bc1) / (sqrtf(nu / bc2) + F(1e-8));
  G.p[j] = G.p[j] + upd * neg_lr;
}

}  // namespace

// `args`: an `Args` (a void pointer: a type of this file's unnamed
// namespace would take the entry's external name away)
extern "C" int window_adam(const void* args_, const float* table, int row,
                           cudaStream_t stream) {
  const Args* args = static_cast<const Args*>(args_);
  const long long total = args->offset[MAXG];
  if (total <= 0) return 0;
  const long long blocks = (total + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  window_adam_kernel<<<(unsigned)blocks, NT, 0, stream>>>(*args, table, row);
  return (int)cudaGetLastError();
}
