// 1-D bulk copies (cp.async.bulk) from global into shared memory that
// complete on an mbarrier: B1's and B4's Kinv (qp_common.cuh) and B2's
// stored laps (cuda_sysid.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one thread, before any copy on bar; a __syncthreads must pass before use
static __device__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// waits for the phase of bar with this parity (0 for its first use, then
// alternating); a copy that never lands traps (a launch error) rather than
// hanging the card
static __device__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (unsigned spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// the one arrival of a phase: it completes once `bytes` have landed (0:
// at once)
static __device__ void mbar_arrive(uint64_t* bar, uint32_t bytes) {
  if (bytes > 0)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

// starts copies of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from src to dst, 32 KB each, completing on bar
static __device__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar) {
  for (uint32_t off = 0; off < bytes; off += 32768u) {
    const uint32_t chunk = min(32768u, bytes - off);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst) + off),
        "l"(static_cast<const char*>(src) + off), "r"(chunk),
        "r"(smem_u32(bar))
        : "memory");
  }
}
