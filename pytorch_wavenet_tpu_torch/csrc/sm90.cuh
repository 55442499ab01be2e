// Hopper's asynchronous path in PTX (sm_90a), for the wide-chain kernel KW
// (gen_kernel_wide.cu): mbarriers, bulk copies from global to shared memory
// (plain, or boxes of a tensor map multicast to the CTAs of a cluster),
// cluster addressing, setmaxnreg, and the warpgroup MMA m64n32k8 in TF32
// with A from registers.
//
// wgmma's operand layouts (one warpgroup, warp w = 0..3 of it, g = lane / 4,
// t = lane % 4):
//   A (64 x 8), from registers: a0 A[16w + g][t], a1 A[16w + g + 8][t],
//     a2 A[16w + g][t + 4], a3 A[16w + g + 8][t + 4]
//   B (8 x 32), K-major in shared memory without swizzle: core matrices of
//     8 rows (of N) x 4 k, 128 contiguous bytes; the descriptor's leading
//     byte offset steps k by 4, its stride byte offset steps N by 8
//   D (64 x 32): d[4j] D[16w + g][8j + 2t], d[4j + 1] D[16w + g][8j + 2t + 1],
//     d[4j + 2] D[16w + g + 8][8j + 2t], d[4j + 3] D[16w + g + 8][8j + 2t + 1]
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// the barriers' initialisation, visible to the cluster's copies and arrivals
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` more of copies
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one arrival on the barrier at the same offset in cluster CTA `cta`, if
// `pred` (predicated, not branched: wgmma may be in flight across it)
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   unsigned cta, bool pred) {
  asm volatile(
      "{\n.reg .b32 ra;\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [ra];\n}" ::"r"(
          smem_u32(bar)),
      "r"(cta), "r"((unsigned)pred)
      : "memory");
}

// until the barrier's phase of parity `parity` has completed (the loop
// inside the asm, so the compiler sees no divergent path: wgmma may be in
// flight across it)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into this CTA's shared memory; completes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the box of a 3-D tensor map (`map` in kernel parameter space) at
// coordinates (x, y, z), innermost first, into the same offset of every
// cluster CTA in `mask`, each completing on its own barrier at `bar`'s
// offset; coordinates out of the tensor read zeros
__device__ __forceinline__ void tma_load_3d_multicast(void* dst,
                                                      const void* map, int x,
                                                      int y, int z,
                                                      uint64_t* bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3, %4}], [%5], %6;" ::"r"(
          smem_u32(dst)),
      "l"(map), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// this thread's generic-proxy writes to shared memory, ordered before later
// copies and wgmma reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the same for global memory: generic-proxy writes (the epilogues' stores)
// ordered with the copies that read them
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster arrives before any leaves
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// a shared-memory descriptor of B, K-major without swizzle (sm90.cuh's
// header): start address, leading byte offset `lbo`, stride byte offset
// `sbo`
__device__ __forceinline__ uint64_t gmma_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// a warpgroup's registers a thread, lowered or raised to N (all its warps)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

// keeps the compiler from moving accesses of `r` across a wgmma's issue or
// wait
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ void reg_fence(unsigned& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// d += A B: one warpgroup, m64n32k8, TF32 operands (A in registers, B by
// descriptor), f32 accumulators
__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const unsigned (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
