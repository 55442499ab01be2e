// Training trunk forward for Hopper (sm_90a): kernel K2.
//
// Replaces the JAX package's Pallas TPU kernel
// pytorch_wavenet_tpu/ops/pallas/trunk_kernel.py::fused_trunk (the forward
// _trunk_fwd_call, _make_fwd_kernel :150, pallas_call :621).
//
// What it computes, for the embedded window h0 (N, T, R) f32, channels last,
// per layer l (dilation d, tap j looking back m_j = (k-1-j)d, zero history
// before t = 0), on the layer's window t in [s_l, T):
//   z[t] = sum_j h(t - m_j) @ w_in[l, j] + b_in[l]          (2D columns)
//   u[t] = tanh(z[t][:D]) * sigmoid(z[t][D:])
//   h'[t] = h[t] + u[t] @ w_res[l] + b_res[l]   (not for the last layer,
//                                                whose stream is discarded)
// u on the output window [T - out, T) goes to u_out (N, out, L*D), columns
// l*D..l*D+D; layer l's input stream on [sp_l, T) is saved for the backward
// (f32 or bf16).
//
// What bounds it on this card: the arithmetic. At chaconne_wide, batch 16,
// out 1024 the layers' windows hold 1,375,872 positions, each 2*(64*64 +
// 32*32) = 10,240 f32 operations: 14.09 GFLOP, 0.2103 ms at the card's
// 67 TFLOP/s outside the tensor cores, against 0.048 ms for its bytes
// (chip_smoke.py::trunk_bounds).
//
// Design, and why the layer walk is split: the TPU kernel keeps one item's
// whole stream in VMEM while all L layers walk over it. Here one item's
// stream (32 x 4093 x 4 B = 524 KB at chaconne_wide) is more than the
// 227 KB of shared memory a block can have, so the walk is one launch per
// layer from the C entry point below: the launch boundary orders the layers,
// and the stream lives in device memory (at batch 16 the two 8.4 MB
// ping-pong copies stay in the 50 MB L2). A dilated tap reads up to
// (k-1)*512 positions back, into another block's tile, so a layer never
// updates its input in place: it reads one buffer and writes the other.
// With f32 saves the saves are the stream: layer l reads saves[l] and
// writes saves[l+1]. A block owns a tile of TT positions of one item; it
// stages the layer's weights (20 KB at chaconne) and the tile's current and
// tap rows in shared memory, computes z with plain f32 FMAs (each thread one
// (position, channel) pair of u at a time), and then the residual update
// from the tile's u in shared memory. Tensor cores are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#define NT 256  // threads per block
#define TT 64   // positions per block

namespace {

struct Layer {
  const float* hin;   // (N, T, R): this layer's input stream
  float* hout;        // (N, T, R): its output stream, or null (last layer)
  __nv_bfloat16* save;  // (N, T, R) bf16 save of hin, or null
  const float* w;     // (k*R, 2D)
  const float* wr;    // (D, R)
  const float* bi;    // (2D)
  const float* br;    // (R)
  float* u_out;       // (N, out, L*D)
  int T, out, LD, k, R, D, d, s, sp, col;
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(NT) trunk_fwd_layer(Layer a) {
  extern __shared__ float sm[];
  const int k = a.k, R = a.R, D = a.D, KR = k * R, D2 = 2 * D;
  float* w = sm;               // KR * D2
  float* wr = w + KR * D2;     // D * R
  float* bi = wr + D * R;      // D2
  float* br = bi + D2;         // R
  float* v = br + R;           // TT * KR
  float* us = v + TT * KR;     // TT * D
  const int n = blockIdx.y;
  const int t0 = a.sp + blockIdx.x * TT;
  const int tid = threadIdx.x;
  const size_t base = (size_t)n * a.T * R;

  for (int e = tid; e < KR * D2; e += NT) w[e] = a.w[e];
  for (int e = tid; e < D * R; e += NT) wr[e] = a.wr[e];
  for (int e = tid; e < D2; e += NT) bi[e] = a.bi[e];
  for (int e = tid; e < R; e += NT) br[e] = a.br[e];
  // tap rows: v[i][j*R + r] = h(t - m_j)[r], 0.0 before the window
  for (int e = tid; e < TT * KR; e += NT) {
    const int i = e / KR, jr = e % KR, j = jr / R, r = jr % R;
    const int t = t0 + i, src = t - (k - 1 - j) * a.d;
    float x = 0.f;
    if (t < a.T && src >= 0) x = a.hin[base + (size_t)src * R + r];
    v[e] = x;
    if (a.save != nullptr && j == k - 1 && t < a.T)
      a.save[base + (size_t)t * R + r] = __float2bfloat16(x);
  }
  __syncthreads();

  for (int p = tid; p < TT * D; p += NT) {
    const int i = p / D, c = p % D, t = t0 + i;
    float u = 0.f;
    if (t >= a.s && t < a.T) {
      float zf = 0.f, zg = 0.f;
      const float* vi = v + i * KR;
      for (int q = 0; q < KR; ++q) {
        const float x = vi[q];
        zf = fmaf(x, w[q * D2 + c], zf);
        zg = fmaf(x, w[q * D2 + D + c], zg);
      }
      u = tanhf(zf + bi[c]) * sigmoidf_(zg + bi[D + c]);
      const int o = t - (a.T - a.out);
      if (o >= 0) a.u_out[((size_t)n * a.out + o) * a.LD + a.col + c] = u;
    }
    us[p] = u;
  }
  if (a.hout == nullptr) return;
  __syncthreads();

  for (int p = tid; p < TT * R; p += NT) {
    const int i = p / R, r = p % R, t = t0 + i;
    if (t < a.s || t >= a.T) continue;
    float acc = 0.f;
    const float* ui = us + i * D;
    for (int c = 0; c < D; ++c) acc = fmaf(ui[c], wr[c * R + r], acc);
    const size_t at = base + (size_t)t * R + r;
    a.hout[at] = a.hin[at] + (acc + br[r]);
  }
}

int smem_bytes(int k, int R, int D) {
  return 4 * (k * R * 2 * D + D * R + 2 * D + R + TT * k * R + TT * D);
}

}  // namespace

// Runs the layer walk on `stream`: one launch per layer. f32 saves (save_bf16
// = 0): `saves` is (L, N, T, R) f32 and is the stream itself (h0 is copied
// into saves[0]; buf0/buf1 are not read). bf16 saves: h0 is layer 0's input,
// buf0/buf1 (N, T, R) f32 ping-pong, `saves` (L, N, T, R) bf16. Returns the
// first cudaError_t that is not cudaSuccess, 0 when every launch went out.
extern "C" int wavenet_trunk_fwd(
    const float* h0, const float* w_in, const float* w_res, const float* b_in,
    const float* b_res, float* buf0, float* buf1, void* saves, float* u_out,
    int N, int T, int out, int L, int k, int R, int D, const int* dil,
    const int* s, const int* sp, int save_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = smem_bytes(k, R, D);
  cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_layer, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const size_t NTR = (size_t)N * T * R;
  float* sf = static_cast<float*>(saves);
  __nv_bfloat16* sb = static_cast<__nv_bfloat16*>(saves);
  if (!save_bf16) {
    err = cudaMemcpyAsync(sf, h0, NTR * sizeof(float),
                          cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return (int)err;
  }
  float* bufs[2] = {buf0, buf1};
  for (int l = 0; l < L; ++l) {
    Layer a;
    if (save_bf16) {
      a.hin = l == 0 ? h0 : bufs[(l - 1) % 2];
      a.hout = l + 1 < L ? bufs[l % 2] : nullptr;
      a.save = sb + l * NTR;
    } else {
      a.hin = sf + l * NTR;
      a.hout = l + 1 < L ? sf + (l + 1) * NTR : nullptr;
      a.save = nullptr;
    }
    a.w = w_in + (size_t)l * k * R * 2 * D;
    a.wr = w_res + (size_t)l * D * R;
    a.bi = b_in + (size_t)l * 2 * D;
    a.br = b_res + (size_t)l * R;
    a.u_out = u_out;
    a.T = T; a.out = out; a.LD = L * D; a.k = k; a.R = R; a.D = D;
    a.d = dil[l]; a.s = s[l]; a.sp = sp[l]; a.col = l * D;
    const dim3 grid((T - sp[l] + TT - 1) / TT, N);
    trunk_fwd_layer<<<grid, NT, smem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
