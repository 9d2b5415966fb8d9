// tma.cuh — 1-D TMA bulk copies from global into shared memory that
// complete on an mbarrier (sm_90), shared by the kernels that stage rows:
// raycast.cu (the picked state rows) and splat_fwd.cu (the live Gaussian
// rows).  kernels.py hashes this header with each source that includes it.
//
// Use: one thread calls mbar_init, then __syncthreads; one thread arms the
// barrier with the total byte count (mbar_expect_tx; 0 bytes completes the
// phase at once); threads issue bulk_copy for 16-byte aligned spans whose
// sizes are multiples of 16; every thread waits on mbar_wait(bar, 0).
// Copies into shared memory that the CTA has used before wait for
// fence_proxy_async.

#pragma once

#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a barrier that completes its phase on one arrival and the expected bytes
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of bulk copies on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// order the calling thread's earlier accesses to shared memory before
// later bulk copies into it (every thread that touched the destination
// calls it before the barrier that precedes the copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// copy `bytes` from global `src` to shared `dst`, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
      "r"(bytes), "r"(bar)
      : "memory");
}

}  // namespace tma
