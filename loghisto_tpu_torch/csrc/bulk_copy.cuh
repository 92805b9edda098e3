// 1-D bulk copies (cp.async.bulk, the TMA's linear form) into shared
// memory, completing on an mbarrier: the streaming helpers shared by K5
// (window_merge.cu) and K7 (divergence.cu).
//
// A bulk copy moves a 16-byte multiple between 16-byte aligned global and
// shared addresses.  One thread arms the stage's mbarrier with the bytes
// it expects (lh_mbar_expect), issues the copies (lh_bulk_copy), and every
// thread waits on the stage's phase (lh_mbar_wait).  lh_bulk_load arms and
// copies in one step, for a stage fed by a single copy.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned lh_smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void lh_mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(lh_smem(bar)), "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the copy engine
__device__ __forceinline__ void lh_mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void lh_mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(lh_smem(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// arrive on `bar` (initialised with count 1) and arm it for `bytes`
__device__ __forceinline__ void lh_mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(lh_smem(bar)),
               "r"(bytes)
               : "memory");
}

// one bulk copy of `bytes` from global `src` into shared `dst`, whose
// completion counts against `bar`'s armed bytes
__device__ __forceinline__ void lh_bulk_copy(void* dst, const void* src, unsigned bytes,
                                             unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(lh_smem(dst)),
      "l"(src), "r"(bytes), "r"(lh_smem(bar))
      : "memory");
}

// arm `bar` for one copy and issue it
__device__ __forceinline__ void lh_bulk_load(void* dst, const void* src, unsigned bytes,
                                             unsigned long long* bar) {
  lh_mbar_expect(bar, bytes);
  lh_bulk_copy(dst, src, bytes, bar);
}
