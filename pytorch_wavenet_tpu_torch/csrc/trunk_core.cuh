// The tile core of the training-trunk kernels K2 (trunk_fwd.cu) and K3
// (trunk_bwd.cu) for Hopper (sm_90a).
//
// A block of NWARP warps owns a tile of TM positions of one item (TM = 16,
// 32 or 64, a multiple of the 16 rows of an m-tile). Every product of the
// trunk is skinny: positions (or, for a weight gradient, weight rows) by a
// few dozen columns, with a depth of a few dozen. Each runs on the tensor
// cores as mma.sync m16n8k8 in 3xTF32 (tf32.cuh) with f32 accumulators: a
// warp takes one m-tile of 16 rows and up to 4 n-tiles of 8 columns (an
// item; a product's items are dealt to the warps in turn), and walks the
// depth in k-steps of 8. Operands are read from shared memory
// (or, where a layer's weights do not fit, from device memory through L2)
// through a strided view, so one routine serves every product, transposed
// or not.
//
// Widths are padded to multiples of 16 by the wrapper's packing
// (ops/cuda/trunk_kernel.py::pack_weights), so every m-tile, n-tile and
// k-step is whole; the padding is zero and stays zero through every
// product. Local conditioning (cond rows of Mp columns, w_cond's Mp rows
// packed below w_in) extends the tap product's depth from k*Rp to k*Rp +
// Mp; the kernels compile it apart (a COND template flag), so the
// unconditioned kernels keep their code. The gate's two halves are interleaved by 8-column tiles (packed
// column 16c + i is the filter half of channel 8c + i, 16c + 8 + i its gate
// half), so one warp's accumulators hold both halves of the same channels
// and the gate runs in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tf32.cuh"

#define NWARP 8
#define NTHREADS (NWARP * 32)

namespace trunk {

// A strided view: element (i, j) at p[i * rs + j * cs].
struct Op {
  const float* p;
  int rs, cs;
  __device__ __forceinline__ float operator()(int i, int j) const {
    return p[i * rs + j * cs];
  }
};

__device__ __forceinline__ Op op(const float* p, int rs, int cs) {
  Op o;
  o.p = p;
  o.rs = rs;
  o.cs = cs;
  return o;
}

// acc[b] += A[m0 : m0 + 16, 0 : K] @ B[0 : K, n0 + 8b : n0 + 8b + 8] for
// b < nb, in 3xTF32, k-steps in order. AEX: every A value is exactly a
// TF32 value (a bf16 save or stream), so its lo part is 0 and a_lo b_hi is
// dropped; BEX: the same for B (weights rounded to bf16 under a bf16
// stream), which drops a_hi b_lo. Both: one product, exact in f32.
template <int NB, bool AEX, bool BEX = false>
__device__ __forceinline__ void mma3(float (&acc)[NB][4], Op A, int m0, Op B,
                                     int n0, int nb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8) {
    const float a[4] = {A(m0 + g, k0 + t), A(m0 + g + 8, k0 + t),
                        A(m0 + g, k0 + t + 4), A(m0 + g + 8, k0 + t + 4)};
    unsigned ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) tf32_split(a[i], ah[i], al[i]);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nb) {
        const int n = n0 + 8 * b + g;
        unsigned bh0, bl0 = 0, bh1, bl1 = 0;
        if (BEX) {
          bh0 = __float_as_uint(B(k0 + t, n));
          bh1 = __float_as_uint(B(k0 + t + 4, n));
        } else {
          tf32_split(B(k0 + t, n), bh0, bl0);
          tf32_split(B(k0 + t + 4, n), bh1, bl1);
        }
        if (!AEX) mma_tf32(acc[b], al, bh0, bh1);
        if (!BEX) mma_tf32(acc[b], ah, bl0, bl1);
        mma_tf32(acc[b], ah, bh0, bh1);
      }
    }
  }
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][4]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[b][e] = 0.f;
}

// The accumulator element e of a lane: row g + 8 (e / 2), column 2t + e % 2
// of its m-tile and n-tile.
__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int e) {
  return 2 * (threadIdx.x & 3) + (e & 1);
}

// The gate's tanh and sigmoid from the fast exponential (a few ulp; the
// trunk's tolerances are 1e-5 of max(1, |u|)). tanh(x) = 1 - 2 / (1 +
// e^{2x}); __fdividef returns 0 for an infinite divisor, so both saturate.
__device__ __forceinline__ float gate_tanh(float x) {
  return 1.f - __fdividef(2.f, 1.f + __expf(2.f * x));
}
__device__ __forceinline__ float gate_sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}

// cp.async of 16 or 4 bytes; an invalid source (src_bytes 0) fills zeros
// and reads nothing, but must still be a valid address.
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Loops that deal rows to warps and columns to lanes (no division).
#define FOR_ROWS(i, rows) \
  for (int i = threadIdx.x >> 5; i < (rows); i += NWARP)
#define FOR_COLS(c, cols, step) \
  for (int c = (step) * (threadIdx.x & 31); c < (cols); c += 32 * (step))

// rows x cols floats (cols a multiple of 4, src rows contiguous) into
// shared memory with row stride ld, 16 bytes a copy.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int rows, int cols) {
  FOR_ROWS(i, rows) {
    FOR_COLS(c, cols, 4) cp16(dst + i * ld + c, src + (size_t)i * cols + c,
                              true);
  }
}

// The tile's tap rows v[i][j * Rp + r] = h(t0 + i - (k-1-j) d)[r] from an
// f32 stream (N, T, R) at item base `h`, zero before the stream's start,
// at or past T, and in the padding r >= R. 16-byte copies when R % 4 == 0.
__device__ __forceinline__ void stage_taps_f32(float* v, int ld, const float* h,
                                               int t0, int TM, int T, int k,
                                               int R, int Rp, int d) {
  const int KR = k * Rp;
  FOR_ROWS(i, TM) {
    const int t = t0 + i;
    if (R % 4 == 0) {
      FOR_COLS(c, KR, 4) {
        const int j = c / Rp, r = c - j * Rp, src = t - (k - 1 - j) * d;
        const bool ok = t < T && src >= 0 && r < R;
        cp16(v + i * ld + c, ok ? h + (size_t)src * R + r : h, ok);
      }
    } else {
      FOR_COLS(c, KR, 1) {
        const int j = c / Rp, r = c - j * Rp, src = t - (k - 1 - j) * d;
        const bool ok = t < T && src >= 0 && r < R;
        cp4(v + i * ld + c, ok ? h + (size_t)src * R + r : h, ok);
      }
    }
  }
}

// The tile's cond rows c[i][m] = cond(t0 + i)[m] (the columns after the tap
// rows) from an f32 (N, T, M) at item base `c`, zero at or past T and in
// the padding m >= M (Mp columns). 16-byte copies when M % 4 == 0.
__device__ __forceinline__ void stage_cond_f32(float* v, int ld, const float* c,
                                               int t0, int TM, int T, int M,
                                               int Mp) {
  FOR_ROWS(i, TM) {
    const int t = t0 + i;
    if (M % 4 == 0) {
      FOR_COLS(m, Mp, 4) {
        const bool ok = t < T && m < M;
        cp16(v + i * ld + m, ok ? c + (size_t)t * M + m : c, ok);
      }
    } else {
      FOR_COLS(m, Mp, 1) {
        const bool ok = t < T && m < M;
        cp4(v + i * ld + m, ok ? c + (size_t)t * M + m : c, ok);
      }
    }
  }
}

// The same from a bf16 save or stream (N, T, R) when R % 8 == 0: the raw
// rows go to `raw` ([TM][k*Rp] bf16) with cp.async; widen_taps then writes
// them to v.
__device__ __forceinline__ void stage_taps_bf16_raw(
    __nv_bfloat16* raw, const __nv_bfloat16* h, int t0, int TM, int T, int k,
    int R, int Rp, int d) {
  const int KR = k * Rp;
  FOR_ROWS(i, TM) {
    const int t = t0 + i;
    FOR_COLS(c, KR, 8) {
      const int j = c / Rp, r = c - j * Rp, src = t - (k - 1 - j) * d;
      const bool ok = t < T && src >= 0 && r < R;
      cp16(reinterpret_cast<float*>(raw + i * KR + c),
           reinterpret_cast<const float*>(ok ? h + (size_t)src * R + r : h),
           ok);
    }
  }
}

__device__ __forceinline__ void widen_taps(float* v, int ld,
                                           const __nv_bfloat16* raw, int TM,
                                           int KR) {
  FOR_ROWS(i, TM) {
    FOR_COLS(c, KR, 2) {
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(raw + i * KR + c));
      *reinterpret_cast<float2*>(v + i * ld + c) = x;
    }
  }
}

// The same from a bf16 save or stream of any width: plain loads, widened
// to f32.
__device__ __forceinline__ void stage_taps_bf16(float* v, int ld,
                                                const __nv_bfloat16* h, int t0,
                                                int TM, int T, int k, int R,
                                                int Rp, int d) {
  const int KR = k * Rp;
  FOR_ROWS(i, TM) {
    const int t = t0 + i;
    FOR_COLS(c, KR, 1) {
      const int j = c / Rp, r = c - j * Rp, src = t - (k - 1 - j) * d;
      v[i * ld + c] = t < T && src >= 0 && r < R
          ? __bfloat162float(h[(size_t)src * R + r]) : 0.f;
    }
  }
}

// Shared-memory row strides. A row-major operand read as A (rows g, column
// t) wants a stride of 4 mod 8 words, one read as B (rows t, column g) 8 or
// 24 mod 32: then a warp's 32 fragment reads fall in 32 banks.
__host__ __device__ __forceinline__ int lda(int cols) { return cols + 4; }
__host__ __device__ __forceinline__ int ldb(int cols) { return cols + 8; }
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

}  // namespace trunk
