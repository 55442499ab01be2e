// Device helpers shared by the generation kernels K1 and K4.
//
// counter_gumbel: counter-hash Gumbel noise, the int32 mixing of the JAX package's HBM kernel
// (pytorch_wavenet_tpu/ops/pallas/gen_kernel_hbm.py, hash_gumbel): a
// murmur3-style finalizer over (idx, tloc, seed) in wrapping 32-bit
// arithmetic. K1 keys it by (class * streams + stream, absolute step, one
// seed); K4 by that too, or by (class, request-local step, per-lane seed)
// under lane_seed. The PyTorch versions repeat it in
// ops/cuda/gen_kernel.py::counter_uniform.
#pragma once

#include <math.h>

// a mod p in [0, p) for p > 0 (C's % keeps the sign of a)
__device__ __forceinline__ int pmod(int a, int p) {
  int r = a % p;
  return r < 0 ? r + p : r;
}

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float counter_gumbel(unsigned idx, unsigned tloc,
                                                unsigned seed) {
  unsigned x = idx * 0x9E3779B9u;
  x ^= tloc * 0x85EBCA6Bu;
  x ^= seed;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  float u = __fmul_rn((float)(x >> 8), 1.0f / 16777216.0f);
  u = fminf(fmaxf(u, 1e-7f), (float)(1.0 - 1e-7));
  return -logf(-logf(u));
}
