// Training trunk backward for Hopper (sm_90a): kernel K3.
//
// Replaces the JAX package's Pallas TPU kernel
// pytorch_wavenet_tpu/ops/pallas/trunk_kernel.py::_trunk_bwd (the custom VJP
// of fused_trunk, _make_bwd_kernel :267, pallas_call :729).
//
// What it computes: the reverse layer walk over the forward's saves (layer
// l's input stream on [sp_l, T), f32 or bf16; with a bf16 stream, the
// stream itself) and du (N, out, L*D), the
// cotangent of the gated units on the output window. Per layer l, from the
// top, with dh_next the gradient of the layer's output stream (0 for the last
// layer), on the layer's window t in [s_l, T):
//   recompute z[t] from the save, a = tanh(z[:D]), g = sigmoid(z[D:])
//   du[t] = dh_next[t] @ w_res[l]^T  (+ du_out on the output window)
//   dz[t] = [du a' g, du a g(1-g)] with a' = 1 - a^2
//   dw_in[l] = sum_{n,t} v[t]^T dz[t]   (v[t] the tap rows h(t - m_j))
//   dw_res[l] = sum u[t]^T dh_next[t], db_in[l] = sum dz, db_res[l] = sum dh_next
//   dv[t] = dz[t] @ w_in[l]^T   (k*R columns, one group of R per tap)
//   dh[t] = dh_next[t] + dv[t, (k-1)R:] + sum_{j<k-1} dv[t + m_j, jR:(j+1)R]
// dh goes back to [sp_l, T) (the whole window for layer 0: dh0, f32).
// With local conditioning cond (N, T, M) f32, z also takes cond[t] @
// w_cond[l], and
//   dw_cond[l] = sum_{n,t} cond[t]^T dz[t]
//   dcond[t] += dz[t] @ w_cond[l]^T   (on [s_l, T), from the top layer down)
//
// What bounds it on this card: the arithmetic. The tap product is computed
// three times (recompute, weight and stream gradients) and the residual
// product twice: 39.45 GFLOP at chaconne_wide, batch 16, out 1024, done as
// three TF32 products each, 0.2391 ms at the tensor cores' 495 TFLOP/s
// (chip_smoke.py::trunk_bounds). The vocoder's cond product adds three
// products of 2*80*128 operations a position.
//
// Design. The TPU kernel walks all layers per item pair with the item's
// stream in VMEM and sums the weight gradients across its sequential grid in
// constant-index VMEM blocks. Neither carries over: an item's stream (524 KB
// at chaconne_wide) is more than a block's 227 KB of shared memory, and
// Hopper's blocks run in parallel in no order. So the walk is one fused
// launch per layer, then two light launches:
//   layer l: a fixed number S of blocks (partial slots, set by the shapes
//     alone: ops/cuda/trunk_kernel.py::bwd_geometry) each walks a fixed,
//     contiguous run of tiles of TM positions in order. Per tile it stages
//     the tap rows from the save with cp.async and gathers dh_next from the
//     layer above's dv (the stream gradient's gather-add, in the prologue),
//     forms z and du_out . w_res^T on the tensor cores (trunk_core.cuh,
//     3xTF32), dz in registers, dv = dz @ w_in^T on the tensor cores while
//     dz is on chip, and adds the tile's weight and bias gradients (v^T dz
//     and u^T dh_next, on the tensor cores) to the block's partial sums. dv
//     goes to device memory with dh_next already added to its own tap's
//     columns; the layer below gathers it. A tap's gradient lands m_j
//     positions earlier, in another tile, so the scatter form would race;
//     the gather reads dv, which no block of that launch writes;
//   dh0: layer 0's dv gathered over the whole window;
//   reduce: every layer's S slots summed per gradient element in a fixed
//     tree (four contiguous runs of slots, then the four in order), spread
//     over the whole card.
// No atomics anywhere, so two calls on the same inputs give bitwise-equal
// gradients and a resumed run can be held to an uninterrupted one.
// A bf16 stream (MODE 2; the JAX kernel's cfg.stream_dtype, its "direct"
// loads) reads its bf16 saves as the bf16 saves of an f32 stream do (MODE
// 1), but the wrapper has rounded w_in, w_res, w_cond and cond to bf16, as
// the forward used them, so every product with a weight operand drops the
// weight's lo part (the recompute, both operands exact, runs one TF32
// product; du_out . w_res^T and dz . w_in^T two), and the cond rows of
// dW_cond are exact like the tap rows.
// Conditioning (the COND instantiation) extends the three tap products'
// depth or width by the cond rows: the tile's cond rows are staged beside
// its tap rows and w_cond's rows below w_in's, so the recompute's depth is
// k*Rp + Mp, the weight gradient v^T dz gains dw_cond's Mp rows (the
// partial slots grow by Mp*2Dp floats and the same reduction sums them),
// and dv = dz @ w_in^T gains Mp columns, dz @ w_cond^T, which the tile adds
// to dcond (N, T, M) in place: a position belongs to one tile of a layer
// launch and the launches run in order, so the sum's order is the layers'
// from the top, with no atomics.

#include "trunk_core.cuh"

using namespace trunk;

namespace {

struct Layer {
  const float* sf;          // f32 save of the layer's input (N, T, R), or null
  const __nv_bfloat16* sb;  // bf16 save, or null
  const float* du;          // (N, out, L*D)
  const float* dvn;         // (N, T, k*Rp): dv of layer l + 1, or null
  float* dv;                // (N, T, k*Rp): this layer's
  const float* w;           // the layer's packed weights
  float* slots;             // (S, P): this layer's partial slots
  int T, out, LD, k, R, D, Rp, Dp, d, s, col;
  int dn, sn;               // layer l + 1's dilation and window start
  int tpi, ntiles, per, wsm, asm_;
  // local conditioning (COND), last, so that the unconditioned kernels
  // read their parameters where they always did
  const float* cond;        // (N, T, M) f32
  float* dcond;             // (N, T, M) f32, accumulated, or null
  int M, Mp;
};

// Shared memory in floats: biases, tap (and cond) rows, dh_next, dz (first
// the staged rows of the layer above's dv), u (first the staged bf16 tap
// rows), then (wsm) the weights and (asm_) the partial sums.
int smem_floats(int TM, int k, int Rp, int Dp, int Mp, int wsm, int asm_) {
  const int KR = k * Rp, KC = KR + Mp, D2 = 2 * Dp;
  return D2 + TM * (lda(KC) + lda(Rp) + imax(lda(D2), KR) +
                    imax(lda(Dp), KR / 2)) +
         (wsm ? KC * ldb(D2) + Dp * lda(Rp) : 0) +
         (asm_ ? KC * ldb(D2) + Dp * ldb(Rp) + D2 + Rp : 0);
}

// dh[t][r] of the layer whose dv (N, T, k*Rp) at item base `dv` is given,
// with dilation d and window start s: its own tap's columns (which carry
// dh_next) where t is in the window, plus every other tap's landing at t.
__device__ __forceinline__ float gather_dh(const float* dv, int t, int r,
                                           int T, int k, int Rp, int d,
                                           int s) {
  const int KR = k * Rp;
  float x = t >= s ? dv[(size_t)t * KR + (k - 1) * Rp + r] : 0.f;
  for (int j = 0; j < k - 1; ++j) {
    const int tau = t + (k - 1 - j) * d;
    if (tau >= s && tau < T) x += dv[(size_t)tau * KR + j * Rp + r];
  }
  return x;
}

template <int NB>
__device__ __forceinline__ void c_load(float (&acc)[NB][4], const float* C,
                                       int ld, int m0, int n0, int nb) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[b][e] = C[(m0 + frag_row(e)) * ld + n0 + 8 * b + frag_col(e)];
}

template <int NB>
__device__ __forceinline__ void c_store(const float (&acc)[NB][4], float* C,
                                        int ld, int m0, int n0, int nb) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b < nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        C[(m0 + frag_row(e)) * ld + n0 + 8 * b + frag_col(e)] = acc[b][e];
}

// MODE 0: f32 saves; 1: bf16 saves of an f32 stream; 2: a bf16 stream.
template <int TM, int MODE, bool COND>
__global__ void __launch_bounds__(NTHREADS) trunk_bwd_layer(Layer a) {
  constexpr bool BF16 = MODE >= 1, SX = MODE == 2;
  extern __shared__ __align__(16) float sm[];
  const int k = a.k, Rp = a.Rp, Dp = a.Dp, KR = k * Rp, D2 = 2 * Dp;
  const int Mp = COND ? a.Mp : 0, KC = KR + Mp;
  const int LV = lda(KC), LH = lda(Rp), LZ = lda(D2), LU = lda(Dp);
  const int LW = ldb(D2), LR = lda(Rp);
  const int P = KC * D2 + Dp * Rp + D2 + Rp;
  float* bi = sm;                          // D2, packed
  float* v = bi + D2;                      // TM x KC: tap rows, cond rows
  float* dh = v + TM * LV;                 // TM x Rp: dh_next
  float* dz = dh + TM * LH;                // TM x D2, packed
  float* us = dz + TM * imax(LZ, KR);      // TM x Dp: u
  float* wi = us + TM * imax(LU, KR / 2);  // KC x D2 (wsm): w_in, w_cond
  float* wr = wi + (a.wsm ? KC * LW : 0);    // Dp x Rp (wsm)
  float* acc0 = wr + (a.wsm ? Dp * LR : 0);  // partial sums (asm_)
  float* pc = dz;  // staged rows of dv above: [TM][KR], before dz
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(us);  // [TM][KR]
  const float* wg = a.w;
  const float* wrg = wg + KC * D2;
  const float* big = wrg + Dp * Rp;
  float* slot = a.slots + (size_t)blockIdx.x * P;
  // the block's partial sums: in shared memory, or in its own slot
  // (dw_in's KR rows, then dw_cond's Mp)
  float* gw = a.asm_ ? acc0 : slot;
  const int lgw = a.asm_ ? ldb(D2) : D2;
  float* gr = gw + KC * lgw;
  const int lgr = a.asm_ ? ldb(Rp) : Rp;
  float* gbi = gr + Dp * lgr;
  float* gbr = gbi + D2;
  const int warp = threadIdx.x >> 5;
  const bool raw_taps = BF16 && a.R % 8 == 0;

  stage(bi, D2, big, 1, D2);
  if (a.wsm) {
    stage(wi, LW, wg, KC, D2);
    stage(wr, LR, wrg, Dp, Rp);
  }
  const int nacc = KC * lgw + Dp * lgr + D2 + Rp;
  for (int e = threadIdx.x; e < nacc; e += NTHREADS) gw[e] = 0.f;

  const Op V = op(v, LV, 1), VT = op(v, 1, LV);
  const Op DH = op(dh, LH, 1), DZ = op(dz, LZ, 1);
  const Op UT = op(us, 1, LU);
  const Op W = a.wsm ? op(wi, LW, 1) : op(wg, D2, 1);
  const Op WT = a.wsm ? op(wi, 1, LW) : op(wg, 1, D2);
  const Op WrT = a.wsm ? op(wr, 1, LR) : op(wrg, 1, Rp);
  // the cond part of the recompute: cond rows by w_cond, both f32
  const Op VC = op(v + KR, LV, 1);
  const Op WC = a.wsm ? op(wi + KR * LW, LW, 1) : op(wg + KR * D2, D2, 1);
  // dv's columns: k*Rp, and Mp more (dz @ w_cond^T) when dcond is wanted
  const int NV = KR + (COND && a.dcond != nullptr ? Mp : 0);
  const int MT = TM / 16, G = Dp / 16, GV = (NV + 31) / 32;
  const int n1 = KC / 16 * (D2 / 32), n2 = Dp / 16 * ((Rp + 31) / 32);
  const int o0 = a.T - a.out;
  const int first = blockIdx.x * a.per;
  const int last = min(a.ntiles, first + a.per);

  for (int tile = first; tile < last; ++tile) {
    const int n = tile / a.tpi, t0 = a.s + (tile % a.tpi) * TM;
    const size_t base = (size_t)n * a.T * a.R;
    if (!BF16)
      stage_taps_f32(v, LV, a.sf + base, t0, TM, a.T, k, a.R, Rp, a.d);
    else if (raw_taps)
      stage_taps_bf16_raw(raw, a.sb + base, t0, TM, a.T, k, a.R, Rp, a.d);
    else
      stage_taps_bf16(v, LV, a.sb + base, t0, TM, a.T, k, a.R, Rp, a.d);
    if (COND)
      stage_cond_f32(v + KR, LV, a.cond + (size_t)n * a.T * a.M, t0, TM, a.T,
                     a.M, Mp);
    // the layer above's dv at t (its own tap, which carries its dh_next)
    // and at t + m_j (tap j), where they lie in its window
    const float* dvn = a.dvn + (size_t)n * a.T * KR;
    if (a.dvn != nullptr) {
      FOR_ROWS(i, TM) {
        const int t = t0 + i;
        FOR_COLS(c, KR, 4) {
          const int j = c / Rp;
          const int tau = t + (k - 1 - j) * a.dn;
          const bool ok = t < a.T && tau >= a.sn && tau < a.T;
          cp16(pc + i * KR + c, ok ? dvn + (size_t)tau * KR + c : dvn, ok);
        }
      }
    }
    cp_commit();
    cp_wait();
    __syncthreads();
    if (raw_taps) widen_taps(v, LV, raw, TM, KR);
    // dh_next: the gather-add of the stream gradient
    FOR_ROWS(i, TM) {
      FOR_COLS(r, Rp, 1) {
        float x = 0.f;
        if (a.dvn != nullptr) {
          const float* row = pc + i * KR;
          x = row[(k - 1) * Rp + r];
          for (int j = 0; j < k - 1; ++j) x += row[j * Rp + r];
        }
        dh[i * LH + r] = x;
      }
    }
    __syncthreads();

    // z = taps @ w_in and g = dh_next @ w_res^T on the tensor cores; the
    // gate's gradient in registers. An item: an m-tile of 16 positions and
    // 2 channel tiles.
    for (int it = warp; it < MT * G; it += NWARP) {
      const int mt = it % MT, grp = it / MT;
      float az[4][4], ag[2][4];
      zero(az);
      zero(ag);
      mma3<4, BF16, SX>(az, V, 16 * mt, W, 32 * grp, 4, KR);
      if (COND) mma3<4, SX, SX>(az, VC, 16 * mt, WC, 32 * grp, 4, Mp);
      mma3<2, false, SX>(ag, DH, 16 * mt, WrT, 16 * grp, 2, Rp);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mt + frag_row(e), t = t0 + row;
          const int ch = 16 * grp + 8 * c + frag_col(e);
          const int pf = 32 * grp + 16 * c + frag_col(e);
          float df = 0.f, dg = 0.f, u = 0.f;
          if (t < a.T) {
            const float th = gate_tanh(az[2 * c][e] + bi[pf]);
            const float sg = gate_sigmoid(az[2 * c + 1][e] + bi[pf + 8]);
            float gv = ag[c][e];
            if (t >= o0 && ch < a.D)
              gv += a.du[((size_t)n * a.out + (t - o0)) * a.LD + a.col + ch];
            df = gv * sg * (1.f - th * th);
            dg = gv * th * (sg * (1.f - sg));
            u = th * sg;
          }
          dz[row * LZ + pf] = df;
          dz[row * LZ + pf + 8] = dg;
          us[row * LU + ch] = u;
        }
      }
    }
    __syncthreads();

    // dv = dz @ w_in^T, dh_next added to the own tap's columns; with
    // dcond its columns past k*Rp are dz @ w_cond^T, added to dcond
    float* dvo = a.dv + (size_t)n * a.T * KR;
    for (int it = warp; it < MT * GV; it += NWARP) {
      const int mt = it % MT, grp = it / MT, nb = min(4, NV / 8 - 4 * grp);
      float acc[4][4];
      zero(acc);
      mma3<4, false, SX>(acc, DZ, 16 * mt, WT, 32 * grp, nb, D2);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (b >= nb) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * mt + frag_row(2 * h), t = t0 + row;
          const int q = 32 * grp + 8 * b + frag_col(2 * h);
          if (t >= a.T) continue;
          if (COND && q >= KR) {  // a pair never straddles KR (16 | KR)
            float* dc = a.dcond + ((size_t)n * a.T + t) * a.M + (q - KR);
            if (q - KR < a.M) dc[0] += acc[b][2 * h];
            if (q + 1 - KR < a.M) dc[1] += acc[b][2 * h + 1];
            continue;
          }
          float2 x = make_float2(acc[b][2 * h], acc[b][2 * h + 1]);
          if (q >= (k - 1) * Rp) {
            x.x += dh[row * LH + q - (k - 1) * Rp];
            x.y += dh[row * LH + q + 1 - (k - 1) * Rp];
          }
          *reinterpret_cast<float2*>(dvo + (size_t)t * KR + q) = x;
        }
      }
    }

    // the tile's weight gradients added to the block's partial sums:
    // dw_in (and dw_cond) += v^T dz, dw_res += u^T dh_next
    for (int it = warp; it < n1 + n2; it += NWARP) {
      float acc[4][4];
      if (it < n1) {
        const int mt = it % (KC / 16), grp = it / (KC / 16);
        c_load(acc, gw, lgw, 16 * mt, 32 * grp, 4);
        if (!COND || 16 * mt < KR)  // tap rows (exact TF32 from bf16 saves)
          mma3<4, BF16>(acc, VT, 16 * mt, DZ, 32 * grp, 4, TM);
        else  // cond rows: f32, exact under a bf16 stream
          mma3<4, SX>(acc, VT, 16 * mt, DZ, 32 * grp, 4, TM);
        c_store(acc, gw, lgw, 16 * mt, 32 * grp, 4);
      } else {
        const int j = it - n1, mt = j % (Dp / 16), grp = j / (Dp / 16);
        const int nb = min(4, Rp / 8 - 4 * grp);
        c_load(acc, gr, lgr, 16 * mt, 32 * grp, nb);
        mma3<4, false>(acc, UT, 16 * mt, DH, 32 * grp, nb, TM);
        c_store(acc, gr, lgr, 16 * mt, 32 * grp, nb);
      }
    }
    for (int c = threadIdx.x; c < D2 + Rp; c += NTHREADS) {
      float x = 0.f;
      if (c < D2) {
        for (int i = 0; i < TM; ++i) x += dz[i * LZ + c];
        gbi[c] += x;
      } else {
        for (int i = 0; i < TM; ++i) x += dh[i * LH + c - D2];
        gbr[c - D2] += x;
      }
    }
    __syncthreads();
  }

  if (!a.asm_) return;
  // the partial sums to the block's slot: [dw_in | dw_cond | dw_res | db_in
  // | db_res]
  __syncthreads();
  for (int e = threadIdx.x; e < P; e += NTHREADS) {
    float x;
    if (e < KC * D2) x = gw[(e / D2) * lgw + e % D2];
    else if (e < KC * D2 + Dp * Rp) {
      const int f = e - KC * D2;
      x = gr[(f / Rp) * lgr + f % Rp];
    } else x = gbi[e - KC * D2 - Dp * Rp];  // db_in, then db_res
    slot[e] = x;
  }
}

// dh0 (N, T, R): layer 0's dv gathered over the whole window.
__global__ void __launch_bounds__(256) trunk_bwd_dh0(
    const float* dv, float* dh0, int N, int T, int k, int R, int Rp, int d,
    int s) {
  const size_t e = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (e >= (size_t)N * T * R) return;
  const int r = (int)(e % R), t = (int)((e / R) % T), n = (int)(e / R / T);
  dh0[e] = gather_dh(dv + (size_t)n * T * k * Rp, t, r, T, k, Rp, d, s);
}

// Every layer's S partial slots summed per element: four contiguous runs
// of slots (one warp each, 32 elements), then the four runs in order.
__global__ void __launch_bounds__(128) trunk_bwd_reduce(
    const float* slots, int S, int P, float* out) {
  __shared__ float ps[4][32];
  const int l = blockIdx.y, lane = threadIdx.x & 31, part = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane, run = (S + 3) / 4;
  float x = 0.f;
  if (e < P) {
    const float* p = slots + (size_t)l * S * P + e;
    for (int b = part * run; b < min(S, (part + 1) * run); ++b)
      x += p[(size_t)b * P];
  }
  ps[part][lane] = x;
  __syncthreads();
  if (part == 0 && e < P)
    out[(size_t)l * P + e] = ((ps[0][lane] + ps[1][lane]) + ps[2][lane]) +
                             ps[3][lane];
}

template <int TM, int MODE, bool COND>
cudaError_t launch(const Layer& a, int S, cudaStream_t st) {
  const int smem = 4 * smem_floats(TM, a.k, a.Rp, a.Dp, a.Mp, a.wsm, a.asm_);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_layer<TM, MODE, COND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  trunk_bwd_layer<TM, MODE, COND><<<S, NTHREADS, smem, st>>>(a);
  return cudaGetLastError();
}

template <int MODE, bool COND>
cudaError_t launch_tm(int TM, const Layer& a, int S, cudaStream_t st) {
  switch (TM) {
    case 64: return launch<64, MODE, COND>(a, S, st);
    case 32: return launch<32, MODE, COND>(a, S, st);
    case 16: return launch<16, MODE, COND>(a, S, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool COND>
cudaError_t launch_mode(int mode, int TM, const Layer& a, int S,
                        cudaStream_t st) {
  switch (mode) {
    case 0: return launch_tm<0, COND>(TM, a, S, st);
    case 1: return launch_tm<1, COND>(TM, a, S, st);
    case 2: return launch_tm<2, COND>(TM, a, S, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory per block of the layer launch, in bytes (Mp padded cond
// channels, 0 without cond).
extern "C" int wavenet_trunk_bwd_smem(int TM, int k, int Rp, int Dp, int Mp,
                                      int wsm, int asm_) {
  return 4 * smem_floats(TM, k, Rp, Dp, Mp, wsm, asm_);
}

// Runs the reverse walk on `stream`: L layer launches, the dh0 gather and
// the reduction. `saves` is (L, N, T, R), f32 (mode 0) or bf16 (mode 1:
// the saves of an f32 stream; 2: a bf16 stream, whose weights and cond
// the wrapper rounded to bf16); `w` the packed weights (L, P)
// (pack_weights); dv0/dv1 (N, T, k*Rp) and `slots`
// (L, S, P) are scratch. `cond` (N, T, M) f32, or null (then M and Mp are
// 0); `dcond` (N, T, M) f32, zero on entry, receives d cond (null: not
// wanted). Layer l walks ntiles[l] tiles of TM positions
// (tpi[l] per item, from s[l]) in S blocks of per[l] tiles each
// (bwd_geometry). Writes dh0 (N, T, R) and the gradients `grads` (L, P) in
// the packed layout. Returns the first cudaError_t that is not
// cudaSuccess, 0 when every launch went out.
extern "C" int wavenet_trunk_bwd(
    const void* saves, const float* du, const float* w, float* dv0,
    float* dv1, float* slots, float* grads, float* dh0, const float* cond,
    float* dcond, int N, int T, int out, int L, int k, int R, int D, int Rp,
    int Dp, int M, int Mp, const int* dil, const int* s, const int* tpi,
    const int* ntiles, const int* per, int S, int TM, int wsm, int asm_,
    int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cond == nullptr) {
    M = Mp = 0;
    dcond = nullptr;
  }
  if (mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const bool save_bf16 = mode >= 1;
  const size_t NTR = (size_t)N * T * R;
  const size_t P = (size_t)(k * Rp + Mp) * 2 * Dp + Dp * Rp + 2 * Dp + Rp;
  float* dvs[2] = {dv0, dv1};
  cudaError_t err;
  for (int l = L - 1; l >= 0; --l) {
    Layer a;
    a.sf = save_bf16 ? nullptr : static_cast<const float*>(saves) + l * NTR;
    a.sb = save_bf16 ? static_cast<const __nv_bfloat16*>(saves) + l * NTR
                     : nullptr;
    a.du = du;
    a.dvn = l + 1 < L ? dvs[(l + 1) % 2] : nullptr;
    a.dv = dvs[l % 2];
    a.w = w + l * P;
    a.slots = slots + (size_t)l * S * P;
    a.cond = cond;
    a.dcond = dcond;
    a.T = T; a.out = out; a.LD = L * D; a.k = k; a.R = R; a.D = D;
    a.Rp = Rp; a.Dp = Dp; a.M = M; a.Mp = Mp; a.d = dil[l]; a.s = s[l];
    a.col = l * D;
    a.dn = l + 1 < L ? dil[l + 1] : 1;
    a.sn = l + 1 < L ? s[l + 1] : T;
    a.tpi = tpi[l]; a.ntiles = ntiles[l]; a.per = per[l];
    a.wsm = wsm; a.asm_ = asm_;
    err = cond != nullptr ? launch_mode<true>(mode, TM, a, S, st)
                          : launch_mode<false>(mode, TM, a, S, st);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t nel = NTR;
  trunk_bwd_dh0<<<(unsigned)((nel + 255) / 256), 256, 0, st>>>(
      dvs[0], dh0, N, T, k, R, Rp, dil[0], s[0]);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  trunk_bwd_reduce<<<dim3((unsigned)((P + 31) / 32), L), 128, 0, st>>>(
      slots, S, (int)P, grads);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return 0;
}
