// Training trunk forward for Hopper (sm_90a): kernel K2.
//
// Replaces the JAX package's Pallas TPU kernel
// pytorch_wavenet_tpu/ops/pallas/trunk_kernel.py::fused_trunk (the forward
// _trunk_fwd_call, _make_fwd_kernel :150, pallas_call :621).
//
// What it computes, for the embedded window h0 (N, T, R) f32, channels last,
// and optionally local conditioning cond (N, T, M) f32, per layer l
// (dilation d, tap j looking back m_j = (k-1-j)d, zero history before
// t = 0), on the layer's window t in [s_l, T):
//   z[t] = sum_j h(t - m_j) @ w_in[l, j] + b_in[l]          (2D columns)
//          (+ cond[t] @ w_cond[l])
//   u[t] = tanh(z[t][:D]) * sigmoid(z[t][D:])
//   h'[t] = h[t] + u[t] @ w_res[l] + b_res[l]   (not for the last layer,
//                                                whose stream is discarded)
// u on the output window [T - out, T) goes to u_out (N, out, L*D), columns
// l*D..l*D+D; layer l's input stream on [sp_l, T) is saved for the backward
// (f32 or bf16). With a bf16 stream (the BS instantiation; the JAX
// kernel's cfg.stream_dtype) the stream is stored in bf16 between layers:
// h'[t] = round_bf16((h[t] + u[t] @ w_res[l]) + b_res[l]), summed in f32,
// with w_in, w_res, w_cond and cond rounded to bf16 by the wrapper, so the
// tap product's operands are all exact TF32 values (one TF32 product in
// place of three) and the residual product's weights are (two).
//
// What bounds it on this card: the arithmetic. At chaconne_wide, batch 16,
// out 1024 the layers' windows hold 1,375,872 positions, each 2*(64*64 +
// 32*32) = 10,240 operations: 14.09 GFLOP, done as three TF32 products
// each, 0.0854 ms at the tensor cores' 495 TFLOP/s, against 0.048 ms for
// its bytes (chip_smoke.py::trunk_bounds). The vocoder's cond product adds
// 2*80*128 operations a position.
//
// Design. The TPU kernel keeps one item's whole stream in VMEM while all L
// layers walk over it. Here one item's stream (524 KB at chaconne_wide) is
// more than the 227 KB of shared memory a block can have, so the walk is
// one launch per layer: the launch boundary orders the layers, and the
// stream lives in device memory (at batch 16 the two 8.4 MB ping-pong
// copies stay in the 50 MB L2). A dilated tap reads up to (k-1)*512
// positions back, into another block's tile, so a layer never updates its
// input in place: it reads one buffer and writes the other. With f32 saves,
// and with a bf16 stream, the saves are the stream: layer l reads saves[l]
// and writes saves[l+1] (a bf16 stream moves half the bytes).
// A block owns a tile of TM positions of one item: it stages the layer's
// packed weights and the tile's k tap rows with cp.async, forms the tap
// product on the tensor cores (trunk_core.cuh, 3xTF32), runs the gate in
// registers (with the fast exponential), puts u in shared memory (for the
// residual product and a coalesced write of u_out), and forms the residual
// product on the tensor cores. With cond (the COND instantiation) the
// tile's cond rows are staged beside its tap rows and w_cond's rows below
// w_in's, so the tap product runs k*Rp + Mp deep: the cond product costs
// no pass of its own.

#include "trunk_core.cuh"

using namespace trunk;

namespace {

struct Layer {
  const void* hin;      // (N, T, R): this layer's input stream (f32; BS bf16)
  void* hout;           // (N, T, R): its output stream, or null (last layer)
  __nv_bfloat16* save;  // (N, T, R) bf16 save of hin, or null
  const float* w;       // the layer's packed weights (pack_weights)
  float* u_out;         // (N, out, L*D)
  int T, out, LD, k, R, D, Rp, Dp, d, s, sp, col, wsm;
  const float* cond;    // (N, T, M) f32 (COND; last, as in trunk_bwd.cu)
  int M, Mp;
};

// Shared memory in floats: biases, tap (and cond) rows, u (first, with a
// bf16 stream, the staged bf16 tap rows), then (wsm) the weights (w_in and
// w_cond).
int smem_floats(int TM, int k, int Rp, int Dp, int Mp, int wsm, int bs) {
  const int KC = k * Rp + Mp, D2 = 2 * Dp;
  return D2 + Rp + TM * lda(KC) + TM * imax(lda(Dp), bs ? k * Rp / 2 : 0) +
         (wsm ? KC * ldb(D2) + Dp * ldb(Rp) : 0);
}

template <int TM, bool COND, bool BS>
__global__ void __launch_bounds__(NTHREADS) trunk_fwd_layer(Layer a) {
  extern __shared__ __align__(16) float sm[];
  const int k = a.k, Rp = a.Rp, Dp = a.Dp, KR = k * Rp, D2 = 2 * Dp;
  const int KC = KR + (COND ? a.Mp : 0);  // the product's depth
  const int LW = ldb(D2), LR = ldb(Rp), LV = lda(KC), LU = lda(Dp);
  float* bi = sm;               // D2, packed (gate halves interleaved)
  float* br = bi + D2;          // Rp
  float* v = br + Rp;           // TM x KC: tap rows, then cond rows
  float* us = v + TM * LV;      // TM x Dp: u (BS: first the raw tap rows)
  float* wi = us + TM * imax(LU, BS ? KR / 2 : 0);  // KC x D2 (wsm)
  float* wr = wi + KC * LW;     // Dp x Rp (wsm)
  const float* wg = a.w;
  const float* wrg = wg + KC * D2;
  const float* big = wrg + Dp * Rp;
  const float* brg = big + D2;
  const int n = blockIdx.y, t0 = a.sp + blockIdx.x * TM;
  const int warp = threadIdx.x >> 5;
  const size_t base = (size_t)n * a.T * a.R;
  const bool raw_taps = BS && a.R % 8 == 0;
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(us);  // [TM][KR]

  stage(bi, D2, big, 1, D2);
  stage(br, Rp, brg, 1, Rp);
  if (a.wsm) {
    stage(wi, LW, wg, KC, D2);
    stage(wr, LR, wrg, Dp, Rp);
  }
  if (!BS)
    stage_taps_f32(v, LV, static_cast<const float*>(a.hin) + base, t0, TM,
                   a.T, k, a.R, Rp, a.d);
  else if (raw_taps)
    stage_taps_bf16_raw(raw, static_cast<const __nv_bfloat16*>(a.hin) + base,
                        t0, TM, a.T, k, a.R, Rp, a.d);
  else
    stage_taps_bf16(v, LV, static_cast<const __nv_bfloat16*>(a.hin) + base,
                    t0, TM, a.T, k, a.R, Rp, a.d);
  if (COND)
    stage_cond_f32(v + KR, LV, a.cond + (size_t)n * a.T * a.M, t0, TM, a.T,
                   a.M, a.Mp);
  cp_commit();
  cp_wait();
  __syncthreads();
  if (raw_taps) {
    widen_taps(v, LV, raw, TM, KR);
    __syncthreads();
  }

  if (a.save != nullptr) {  // the layer's input on the tile: tap k-1
    FOR_ROWS(i, TM) {
      const int t = t0 + i;
      if (t >= a.T) continue;
      FOR_COLS(r, a.R, 1)
        a.save[base + (size_t)t * a.R + r] =
            __float2bfloat16(v[i * LV + (k - 1) * Rp + r]);
    }
  }

  // z = taps @ w_in (+ cond @ w_cond) on the tensor cores, the gate in
  // registers: an item is an m-tile of 16 positions and 2 channel tiles (4
  // n-tiles: f, g, f, g). With a bf16 stream both operands are exact TF32.
  const Op V = op(v, LV, 1);
  const Op W = a.wsm ? op(wi, LW, 1) : op(wg, D2, 1);
  const int MT = TM / 16, G = Dp / 16;
  for (int it = warp; it < MT * G; it += NWARP) {
    const int mt = it % MT, grp = it / MT;
    float acc[4][4];
    zero(acc);
    mma3<4, BS, BS>(acc, V, 16 * mt, W, 32 * grp, 4, KC);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + frag_row(e), t = t0 + row;
        const int pf = 32 * grp + 16 * c + frag_col(e);
        float u = 0.f;
        if (t >= a.s && t < a.T)
          u = gate_tanh(acc[2 * c][e] + bi[pf]) *
              gate_sigmoid(acc[2 * c + 1][e] + bi[pf + 8]);
        us[row * LU + 16 * grp + 8 * c + frag_col(e)] = u;
      }
    }
  }
  __syncthreads();

  const int o0 = a.T - a.out;
  FOR_ROWS(i, TM) {
    const int t = t0 + i;
    if (t < o0 || t >= a.T) continue;
    float* dst = a.u_out + ((size_t)n * a.out + (t - o0)) * a.LD + a.col;
    FOR_COLS(c, a.D, 1) dst[c] = us[i * LU + c];
  }
  if (a.hout == nullptr) return;

  // h' = h + (u @ w_res + b_res) on the layer's window; with a bf16 stream
  // round((h + u @ w_res) + b_res), the JAX kernel's order
  const Op U = op(us, LU, 1);
  const Op Wr = a.wsm ? op(wr, LR, 1) : op(wrg, Rp, 1);
  const int GR = (Rp + 31) / 32;
  for (int it = warp; it < MT * GR; it += NWARP) {
    const int mt = it % MT, grp = it / MT, nb = min(4, Rp / 8 - 4 * grp);
    float acc[4][4];
    zero(acc);
    mma3<4, false, BS>(acc, U, 16 * mt, Wr, 32 * grp, nb, Dp);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (b >= nb) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + frag_row(e), t = t0 + row;
        const int r = 32 * grp + 8 * b + frag_col(e);
        if (t >= a.s && t < a.T && r < a.R) {
          const float h = v[row * LV + (k - 1) * Rp + r];
          const size_t o = base + (size_t)t * a.R + r;
          if (BS)
            static_cast<__nv_bfloat16*>(a.hout)[o] = __float2bfloat16_rn(
                __fadd_rn(__fadd_rn(h, acc[b][e]), br[r]));
          else
            static_cast<float*>(a.hout)[o] = h + (acc[b][e] + br[r]);
        }
      }
    }
  }
}

template <int TM, bool COND, bool BS>
cudaError_t launch(const Layer& a, int N, cudaStream_t st) {
  const int smem = 4 * smem_floats(TM, a.k, a.Rp, a.Dp, a.Mp, a.wsm, BS);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_layer<TM, COND, BS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T - a.sp + TM - 1) / TM, N);
  trunk_fwd_layer<TM, COND, BS><<<grid, NTHREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool COND, bool BS>
cudaError_t launch_tm(int TM, const Layer& a, int N, cudaStream_t st) {
  switch (TM) {
    case 64: return launch<64, COND, BS>(a, N, st);
    case 32: return launch<32, COND, BS>(a, N, st);
    case 16: return launch<16, COND, BS>(a, N, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory per block, in bytes, for the tile of TM positions (Mp
// padded cond channels, 0 without cond; bs: a bf16 stream).
extern "C" int wavenet_trunk_fwd_smem(int TM, int k, int Rp, int Dp, int Mp,
                                      int wsm, int bs) {
  return 4 * smem_floats(TM, k, Rp, Dp, Mp, wsm, bs);
}

// Runs the layer walk on `stream`: one launch per layer. `w` holds the
// packed weights, (L, P) with P = (k*Rp + Mp)*2Dp + Dp*Rp + 2Dp + Rp
// (ops/cuda/trunk_kernel.py::pack_weights). `cond` (N, T, M) f32, or null
// (then M and Mp are 0): every layer's gate adds cond @ w_cond[l]. `mode`:
// 0, f32 saves: `saves` is (L, N, T, R) f32 and is the stream itself (h0
// is copied into saves[0]; buf0/buf1 are not read); 1, bf16 saves of an
// f32 stream: h0 is layer 0's input, buf0/buf1 (N, T, R) f32 ping-pong,
// `saves` (L, N, T, R) bf16; 2, a bf16 stream: `saves` (L, N, T, R) bf16 is
// the stream, saves[0] holds h0 rounded (the wrapper writes it), buf0/buf1
// are not read. TM (16, 32 or 64) and wsm (weights in shared memory) come
// from the wrapper's plan. Returns the first cudaError_t that is not
// cudaSuccess, 0 when every launch went out.
extern "C" int wavenet_trunk_fwd(
    const float* h0, const float* w, float* buf0, float* buf1, void* saves,
    float* u_out, const float* cond, int N, int T, int out, int L, int k,
    int R, int D, int Rp, int Dp, int M, int Mp, const int* dil, const int* s,
    const int* sp, int mode, int TM, int wsm, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cond == nullptr) M = Mp = 0;
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const size_t NTR = (size_t)N * T * R;
  const size_t P = (size_t)(k * Rp + Mp) * 2 * Dp + Dp * Rp + 2 * Dp + Rp;
  float* sf = static_cast<float*>(saves);
  __nv_bfloat16* sb = static_cast<__nv_bfloat16*>(saves);
  cudaError_t err;
  if (mode == 0) {
    err = cudaMemcpyAsync(sf, h0, NTR * sizeof(float),
                          cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  float* bufs[2] = {buf0, buf1};
  for (int l = 0; l < L; ++l) {
    Layer a;
    if (mode == 1) {
      a.hin = l == 0 ? h0 : bufs[(l - 1) % 2];
      a.hout = l + 1 < L ? bufs[l % 2] : nullptr;
      a.save = sb + l * NTR;
    } else if (mode == 2) {
      a.hin = sb + l * NTR;
      a.hout = l + 1 < L ? sb + (l + 1) * NTR : nullptr;
      a.save = nullptr;
    } else {
      a.hin = sf + l * NTR;
      a.hout = l + 1 < L ? sf + (l + 1) * NTR : nullptr;
      a.save = nullptr;
    }
    a.w = w + l * P;
    a.u_out = u_out;
    a.cond = cond;
    a.T = T; a.out = out; a.LD = L * D; a.k = k; a.R = R; a.D = D;
    a.Rp = Rp; a.Dp = Dp; a.M = M; a.Mp = Mp; a.d = dil[l]; a.s = s[l];
    a.sp = sp[l]; a.col = l * D; a.wsm = wsm;
    if (mode == 2)
      err = cond != nullptr ? launch_tm<true, true>(TM, a, N, st)
                            : launch_tm<false, true>(TM, a, N, st);
    else
      err = cond != nullptr ? launch_tm<true, false>(TM, a, N, st)
                            : launch_tm<false, false>(TM, a, N, st);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
