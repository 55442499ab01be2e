// Training trunk backward for Hopper (sm_90a): kernel K3.
//
// Replaces the JAX package's Pallas TPU kernel
// pytorch_wavenet_tpu/ops/pallas/trunk_kernel.py::_trunk_bwd (the custom VJP
// of fused_trunk, _make_bwd_kernel :267, pallas_call :729).
//
// What it computes: the reverse layer walk over the forward's saves (layer
// l's input stream on [sp_l, T), f32 or bf16) and du (N, out, L*D), the
// cotangent of the gated units on the output window. Per layer l, from the
// top, with dh_next the gradient of the layer's output stream (0 for the last
// layer), on the layer's window t in [s_l, T):
//   recompute z[t] from the save, a = tanh(z[:D]), g = sigmoid(z[D:])
//   du[t] = dh_next[t] @ w_res[l]^T  (+ du_out on the output window)
//   dz[t] = [du a' g, du a g(1-g)] with a' = 1 - a^2
//   dw_in[l] = sum_{n,t} v[t]^T dz[t]   (v[t] the tap rows h(t - m_j))
//   dw_res[l] = sum u[t]^T dh_next[t], db_in[l] = sum dz, db_res[l] = sum dh_next
//   dh[t] = dh_next[t] + dz[t] @ w_in[l, k-1]^T
//           + sum_{j<k-1} dz[t + m_j] @ w_in[l, j]^T
// dh goes back to [sp_l, T) (the whole window for layer 0: dh0, f32).
//
// What bounds it on this card: the arithmetic. The tap product is computed
// three times (recompute, weight and stream gradients) and the residual
// product twice: 0.5888 ms at chaconne_wide, batch 16, out 1024, at the
// card's 67 TFLOP/s outside the tensor cores (chip_smoke.py::trunk_bounds).
//
// Design. The TPU kernel walks all layers per item pair with the item's
// stream in VMEM and sums the weight gradients across its sequential grid in
// constant-index VMEM blocks. Neither carries over: an item's stream (524 KB
// at chaconne_wide) is more than a block's 227 KB of shared memory, and
// Hopper's blocks run in parallel in no order. So each layer is three
// launches, ordered by the stream:
//   1. gates: a block per (item, tile of TT positions) recomputes z, writes
//      dz (N, T, 2D) to device memory and this tile's partial weight and
//      bias gradients to its own slot of a scratch buffer (each partial a
//      sum over the tile's positions in order);
//   2. reduce: one thread per gradient element sums the slots in block
//      order. No atomics anywhere, so two calls on the same inputs give
//      bitwise-equal gradients and a resumed run can be held to an
//      uninterrupted one;
//   3. stream: a block per tile gathers dh[t] from dz at t and at t + m_j.
//      A tap's gradient lands m_j positions earlier, in another tile, so
//      the scatter form would race; the gather form reads dz, which no block
//      of this launch writes, and writes the other dh buffer of a ping-pong
//      pair (never the dh_next it reads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define NT 256  // threads per block
#define TT 64   // positions per block

namespace {

struct Layer {
  const float* sf;          // f32 save of the layer's input (N, T, R), or null
  const __nv_bfloat16* sb;  // bf16 save, or null
  const float* du;          // (N, out, L*D)
  const float* dhn;         // (N, T, R) gradient of the output stream, or null
  float* dh;                // (N, T, R) gradient of the input stream
  float* dz;                // (N, T, 2D)
  float* partial;           // (blocks, P)
  const float* w;           // (k*R, 2D)
  const float* wr;          // (D, R)
  const float* bi;          // (2D)
  int T, out, LD, k, R, D, d, s, lo, col;
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float load_save(const Layer& a, size_t at) {
  return a.sf != nullptr ? a.sf[at] : __bfloat162float(a.sb[at]);
}

// 1. gates: dz and this tile's partial gradients
__global__ void __launch_bounds__(NT) trunk_bwd_gates(Layer a) {
  extern __shared__ float sm[];
  const int k = a.k, R = a.R, D = a.D, KR = k * R, D2 = 2 * D;
  float* w = sm;              // KR * D2
  float* wrt = w + KR * D2;   // R * D: w_res transposed
  float* bi = wrt + D * R;    // D2
  float* v = bi + D2;         // TT * KR
  float* dhn = v + TT * KR;   // TT * R
  float* dzs = dhn + TT * R;  // TT * D2
  float* us = dzs + TT * D2;  // TT * D
  const int n = blockIdx.y;
  const int t0 = a.s + blockIdx.x * TT;
  const int tid = threadIdx.x;
  const size_t base = (size_t)n * a.T * R;

  for (int e = tid; e < KR * D2; e += NT) w[e] = a.w[e];
  for (int e = tid; e < D * R; e += NT) {
    const int c = e / R, r = e % R;
    wrt[r * D + c] = a.wr[e];
  }
  for (int e = tid; e < D2; e += NT) bi[e] = a.bi[e];
  for (int e = tid; e < TT * KR; e += NT) {
    const int i = e / KR, jr = e % KR, j = jr / R, r = jr % R;
    const int t = t0 + i, src = t - (k - 1 - j) * a.d;
    v[e] = (t < a.T && src >= 0) ? load_save(a, base + (size_t)src * R + r)
                                 : 0.f;
  }
  for (int e = tid; e < TT * R; e += NT) {
    const int t = t0 + e / R;
    dhn[e] = (a.dhn != nullptr && t < a.T)
                 ? a.dhn[base + (size_t)t * R + e % R] : 0.f;
  }
  __syncthreads();

  for (int p = tid; p < TT * D; p += NT) {
    const int i = p / D, c = p % D, t = t0 + i;
    float df = 0.f, dg = 0.f, u = 0.f;
    if (t < a.T) {
      float zf = 0.f, zg = 0.f;
      const float* vi = v + i * KR;
      for (int q = 0; q < KR; ++q) {
        const float x = vi[q];
        zf = fmaf(x, w[q * D2 + c], zf);
        zg = fmaf(x, w[q * D2 + D + c], zg);
      }
      const float th = tanhf(zf + bi[c]);
      const float sg = sigmoidf_(zg + bi[D + c]);
      float g = 0.f;
      const float* hi = dhn + i * R;
      for (int r = 0; r < R; ++r) g = fmaf(hi[r], wrt[r * D + c], g);
      const int o = t - (a.T - a.out);
      if (o >= 0) g += a.du[((size_t)n * a.out + o) * a.LD + a.col + c];
      df = g * sg * (1.f - th * th);
      dg = g * th * (sg * (1.f - sg));
      u = th * sg;
      float* dzt = a.dz + ((size_t)n * a.T + t) * D2;
      dzt[c] = df;
      dzt[D + c] = dg;
    }
    dzs[i * D2 + c] = df;
    dzs[i * D2 + D + c] = dg;
    us[i * D + c] = u;
  }
  __syncthreads();

  // partials, each a sum over the tile's positions in order; layout
  // [dw_in (KR*D2) | dw_res (D*R) | db_in (D2) | db_res (R)]
  const int P = KR * D2 + D * R + D2 + R;
  float* out = a.partial + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * P;
  for (int e = tid; e < P; e += NT) {
    float acc = 0.f;
    if (e < KR * D2) {
      const int q = e / D2, c = e % D2;
      for (int i = 0; i < TT; ++i) acc = fmaf(v[i * KR + q], dzs[i * D2 + c], acc);
    } else if (e < KR * D2 + D * R) {
      const int f = e - KR * D2, c = f / R, r = f % R;
      for (int i = 0; i < TT; ++i) acc = fmaf(us[i * D + c], dhn[i * R + r], acc);
    } else if (e < KR * D2 + D * R + D2) {
      const int c = e - KR * D2 - D * R;
      for (int i = 0; i < TT; ++i) acc += dzs[i * D2 + c];
    } else {
      const int r = e - KR * D2 - D * R - D2;
      for (int i = 0; i < TT; ++i) acc += dhn[i * R + r];
    }
    out[e] = acc;
  }
}

// 2. reduce: the partials of `blocks` tiles, summed in block order
__global__ void __launch_bounds__(NT) trunk_bwd_reduce(
    const float* partial, int blocks, int P, int nw, int nr, int nb,
    float* dw_in, float* dw_res, float* db_in, float* db_res) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= P) return;
  float acc = 0.f;
  for (int b = 0; b < blocks; ++b) acc += partial[(size_t)b * P + e];
  if (e < nw) dw_in[e] = acc;
  else if (e < nw + nr) dw_res[e - nw] = acc;
  else if (e < nw + nr + nb) db_in[e - nw - nr] = acc;
  else db_res[e - nw - nr - nb] = acc;
}

// 3. stream: dh on [lo, T) gathered from dz
__global__ void __launch_bounds__(NT) trunk_bwd_stream(Layer a) {
  extern __shared__ float sm[];
  const int k = a.k, R = a.R, D2 = 2 * a.D, KR = k * R;
  float* wt = sm;              // D2 * KR: w_in transposed
  float* dzs = wt + D2 * KR;   // k * TT * D2: dz at t + m_j
  const int n = blockIdx.y;
  const int t0 = a.lo + blockIdx.x * TT;
  const int tid = threadIdx.x;

  for (int e = tid; e < KR * D2; e += NT) {
    const int q = e / D2, c = e % D2;
    wt[c * KR + q] = a.w[e];
  }
  for (int e = tid; e < k * TT * D2; e += NT) {
    const int j = e / (TT * D2), i = (e / D2) % TT, c = e % D2;
    const int tau = t0 + i + (k - 1 - j) * a.d;
    dzs[e] = (tau >= a.s && tau < a.T)
                 ? a.dz[((size_t)n * a.T + tau) * D2 + c] : 0.f;
  }
  __syncthreads();

  for (int p = tid; p < TT * R; p += NT) {
    const int i = p / R, r = p % R, t = t0 + i;
    if (t >= a.T) continue;
    const size_t at = ((size_t)n * a.T + t) * R + r;
    float acc = (t >= a.s && a.dhn != nullptr) ? a.dhn[at] : 0.f;
    for (int j = 0; j < k; ++j) {
      const float* dzi = dzs + (j * TT + i) * D2;
      const float* wj = wt + j * R + r;
      for (int c = 0; c < D2; ++c) acc = fmaf(dzi[c], wj[c * KR], acc);
    }
    a.dh[at] = acc;
  }
}

int tiles(int T, int from) { return (T - from + TT - 1) / TT; }

int gates_smem(int k, int R, int D) {
  return 4 * (k * R * 2 * D + D * R + 2 * D + TT * k * R + TT * R +
              TT * 2 * D + TT * D);
}

int stream_smem(int k, int R, int D) {
  return 4 * (2 * D * k * R + k * TT * 2 * D);
}

}  // namespace

// Floats of scratch the partial gradients need: one slot per block of the
// widest layer.
extern "C" long long wavenet_trunk_bwd_scratch(int N, int T, int k, int R,
                                               int D) {
  const long long P = (long long)k * R * 2 * D + D * R + 2 * D + R;
  return (long long)N * tiles(T, 0) * P;
}

// Runs the reverse walk on `stream`: three launches per layer. `saves` is
// (L, N, T, R), f32 or bf16 (save_bf16); dz (N, T, 2D), dh0/dh1 (N, T, R)
// and `partial` are scratch; dh0 holds the input stream's gradient at the
// end. Gradients are written in the params' layout: dw_in (L, k, R, 2D),
// dw_res (L, D, R), db_in (L, 2D), db_res (L, R). Returns the first
// cudaError_t that is not cudaSuccess, 0 when every launch went out.
extern "C" int wavenet_trunk_bwd(
    const void* saves, const float* du, const float* w_in, const float* w_res,
    const float* b_in, float* dz, float* dh0, float* dh1, float* partial,
    float* dw_in, float* dw_res, float* db_in, float* db_res, int N, int T,
    int out, int L, int k, int R, int D, const int* dil, const int* s,
    const int* sp, int save_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sm_g = gates_smem(k, R, D), sm_s = stream_smem(k, R, D);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_bwd_gates, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_g);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      trunk_bwd_stream, cudaFuncAttributeMaxDynamicSharedMemorySize, sm_s);
  if (err != cudaSuccess) return (int)err;
  const size_t NTR = (size_t)N * T * R;
  const int nw = k * R * 2 * D, nr = D * R, nb = 2 * D;
  const int P = nw + nr + nb + R;
  float* dhs[2] = {dh0, dh1};
  for (int l = L - 1; l >= 0; --l) {
    Layer a;
    a.sf = save_bf16 ? nullptr : static_cast<const float*>(saves) + l * NTR;
    a.sb = save_bf16 ? static_cast<const __nv_bfloat16*>(saves) + l * NTR
                     : nullptr;
    a.du = du;
    a.dhn = l + 1 < L ? dhs[(l + 1) % 2] : nullptr;
    a.dh = dhs[l % 2];
    a.dz = dz;
    a.partial = partial;
    a.w = w_in + (size_t)l * nw;
    a.wr = w_res + (size_t)l * nr;
    a.bi = b_in + (size_t)l * nb;
    a.T = T; a.out = out; a.LD = L * D; a.k = k; a.R = R; a.D = D;
    a.d = dil[l]; a.s = s[l]; a.lo = l == 0 ? 0 : sp[l]; a.col = l * D;
    const dim3 g1(tiles(T, s[l]), N);
    trunk_bwd_gates<<<g1, NT, sm_g, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    trunk_bwd_reduce<<<(P + NT - 1) / NT, NT, 0, st>>>(
        partial, (int)(g1.x * g1.y), P, nw, nr, nb, dw_in + (size_t)l * nw,
        dw_res + (size_t)l * nr, db_in + (size_t)l * nb,
        db_res + (size_t)l * R);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const dim3 g3(tiles(T, a.lo), N);
    trunk_bwd_stream<<<g3, NT, sm_s, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
