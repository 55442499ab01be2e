// 3xTF32 products on the tensor cores, shared by the generation core
// (gen_cluster.cuh: the head of K1 and K4) and the training-trunk core
// (trunk_core.cuh: K2 and K3).
//
// An f32 operand x is split into a TF32 part hi (x rounded to 10 mantissa
// bits, ties away from zero) and the exact rest lo = x - hi (|lo| <= 2^-11
// |x|, of which the tensor cores read the top 11 significant bits), and a
// product accumulates a_lo b_hi, a_hi b_lo and a_hi b_hi, which holds it
// near f32 accuracy (a product's error is at most about 2^-21 of it: the
// a_lo b_lo term and lo's low bits). The split is two integer operations
// and one subtraction: cvt.rna.tf32.f32 would run at a quarter of their
// rate.
#pragma once

__device__ __forceinline__ void tf32_split(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// d += a b: mma.sync m16n8k8, TF32 operands, f32 accumulators. Fragments
// (thread g = lane / 4, t = lane % 4): a0 A[g][t], a1 A[g + 8][t], a2
// A[g][t + 4], a3 A[g + 8][t + 4]; b0 B[t][g], b1 B[t + 4][g]; d0 D[g][2t],
// d1 D[g][2t + 1], d2 D[g + 8][2t], d3 D[g + 8][2t + 1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
