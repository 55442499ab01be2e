// Fused WaveNet generation loop for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// pytorch_wavenet_tpu/ops/pallas/gen_kernel.py::generate_fast_fused
// (_make_kernel, one pallas_call for the whole autoregressive loop).
//
// What it computes, per stream and per step t (absolute time ta = t0 + t):
//   h = w_start[cls] + b_start
//   per layer l (dilation d, ring period P = (k-1)d + 1):
//     z = [tap_0 .. tap_{k-2}, h] @ w_tap[l] + b_in[l], tap_j = ring_l[(ta - (k-1-j)d) mod P]
//     u = tanh(z[:D]) * sigmoid(z[D:])
//     [skip | res] = u @ w_out[l] + b_out[l];  skip_acc += skip;  ring_l[ta mod P] = h;  h += res
//   logits = relu(relu(skip_acc) @ w_end1 + b_end1) @ w_end2 + b_end2 - reg
//   next = argmax(logits / T + gumbel) (argmax of logits at T = 0), fed back unless priming.
// The fuse_res variant (FUSE) walks the chain with pre-multiplied
// wf[l] = w_res[l] @ w_cur[l+1]:  z[l+1] = (h @ w_cur[l+1] + bf[l] + taps) + u[l] @ wf[l].
//
// Design: one thread block per stream (streams never interact), looping over
// every step inside ONE launch; __syncthreads() separates the phases of a
// layer and a block-level argmax ends each step. Rings live in device memory
// (rows slot*streams + s, the FusedGenState layout); the block's write of a
// slot is visible to its own reads at the next step after the barrier.
//
// What bounds it on this card: the weights (~7.2 MB f32 at chaconne widths)
// do not fit in one SM's 227 KB of shared memory, so every step re-reads
// them from L2 through ONE SM's L2 port, and the per-layer chain pays an L2
// round trip per phase. The arithmetic (~3.6 MFLOP per step at chaconne) is
// far below either limit of the whole card: the kernel is bound by one SM's
// L2 bandwidth and latency, not by the card's memory rate or FLOP rate. What
// the design does about it: coalesced column-per-thread weight reads, row
// groups for the narrow products so that more loads are in flight, the
// fuse_res variant (two barriers per layer instead of three). Spreading the
// weights over many SMs' shared memory (thread block clusters) is left for
// later work.

#include <cuda_runtime.h>
#include <math.h>

#include "gen_common.cuh"

#define NT 512  // threads per block

namespace {

struct Args {
  const float* w_start;  // (C, R)
  const float* b_start;  // (R)
  const float* w_tap;    // (L, k, R, 2D)
  const float* b_in;     // (L, 2D)
  const float* w_out;    // (L, D, S+R)
  const float* b_out;    // (L, S+R)
  const float* w_end1;   // (S, E)
  const float* b_end1;   // (E)
  const float* w_end2;   // (E, C)
  const float* b_end2;   // (C)
  const float* wf;       // (L-1, D, 2D), FUSE only
  const float* bf;       // (L-1, 2D), FUSE only
  const int* prime;      // (streams, num_given)
  const int* meta;       // (L, 3): dilation, period, ring offset in floats
  float* rings;          // all layers' rings, updated in place
  int* out_cls;          // (streams, total)
  int streams, num_given, total, t0;
  int L, k, R, D, S, E, C;
  int gz, ge1, ge2;      // row groups of the z, end1 and end2 products
  float temperature, regularize;
  unsigned seed;
};

// Partial sums of x (n_in, in shared memory; relu'd when RELU) times the
// columns of the row-major W (n_in, n_out), split into G row groups:
// part[g*n_out + o]. With G == 1 the caller reads part as the full sum.
template <bool RELU>
__device__ __forceinline__ void matvec_part(const float* __restrict__ W,
                                            const float* x, int n_in,
                                            int n_out, int G, float* part) {
  const int rows = (n_in + G - 1) / G;
  for (int task = threadIdx.x; task < G * n_out; task += NT) {
    const int o = task % n_out, g = task / n_out;
    const int i1 = min(n_in, (g + 1) * rows);
    float acc = 0.f;
#pragma unroll 8
    for (int i = g * rows; i < i1; ++i) {
      const float xv = RELU ? fmaxf(x[i], 0.f) : x[i];
      acc = fmaf(xv, W[(size_t)i * n_out + o], acc);
    }
    part[task] = acc;
  }
}

// Partial sums of the gate input of layer l: x = [taps of layer l, h],
// (k*R) rows of w_tap[l], 2D columns, G row groups -> part[g*2D + o].
__device__ __forceinline__ void z_part(const Args& a, int l, int ta, int s,
                                       const float* h, float* part) {
  const int twoD = 2 * a.D, nrow = a.k * a.R, G = a.gz;
  const int d = a.meta[3 * l], P = a.meta[3 * l + 1];
  const float* ring = a.rings + a.meta[3 * l + 2];
  const float* W = a.w_tap + (size_t)l * nrow * twoD;
  const int rows = (nrow + G - 1) / G;
  for (int task = threadIdx.x; task < G * twoD; task += NT) {
    const int o = task % twoD, g = task / twoD;
    const int i1 = min(nrow, (g + 1) * rows);
    float acc = 0.f;
    for (int i = g * rows; i < i1; ++i) {
      const int j = i / a.R, r = i - j * a.R;
      float xv;
      if (j == a.k - 1) {
        xv = h[r];
      } else {
        const int slot = pmod(ta - (a.k - 1 - j) * d, P);
        xv = ring[((size_t)slot * a.streams + s) * a.R + r];
      }
      acc = fmaf(xv, W[(size_t)i * twoD + o], acc);
    }
    part[task] = acc;
  }
}

// Ring write of the layer input h at slot ta mod P. No tap of this step
// reads that slot: a tap looks back m in (0, P) steps.
__device__ __forceinline__ void ring_write(const Args& a, int l, int ta,
                                           int s, const float* h) {
  const int P = a.meta[3 * l + 1];
  float* ring = a.rings + a.meta[3 * l + 2];
  const int slot = pmod(ta, P);
  for (int r = threadIdx.x; r < a.R; r += NT)
    ring[((size_t)slot * a.streams + s) * a.R + r] = h[r];
}

// [skip | res] = u @ w_out[l] + b_out[l]: skip accumulates, hn = h + res.
// Task ids start at `first` so that a phase can share threads with other
// work; tasks [first, first + S + R).
__device__ __forceinline__ void out_proj(const Args& a, int l, const float* u,
                                         const float* h, float* hn,
                                         float* skip, int first, int ntask) {
  const int SR = a.S + a.R;
  const float* W = a.w_out + (size_t)l * a.D * SR;
  for (int task = threadIdx.x; task < ntask; task += NT) {
    const int o = task - first;
    if (o < 0) continue;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < a.D; ++i) acc = fmaf(u[i], W[(size_t)i * SR + o], acc);
    acc = acc + a.b_out[l * SR + o];
    if (o < a.S)
      skip[o] = skip[o] + acc;
    else
      hn[o - a.S] = h[o - a.S] + acc;
  }
}

template <bool FUSE>
__global__ void __launch_bounds__(NT) gen_fused_kernel(Args a) {
  extern __shared__ float sm[];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int R = a.R, D = a.D, S = a.S, E = a.E, C = a.C, twoD = 2 * a.D;
  float* h = sm;
  float* hn = h + R;
  float* skip = hn + R;
  float* u = skip + S;
  float* z = u + D;
  float* part = z + twoD;
  const int npart = max(NT, max(a.gz * twoD, max(a.ge1 * E, a.ge2 * C)));
  float* y1 = part + npart;
  float* lg = y1 + E;
  float* red_v = lg + C;
  int* red_i = reinterpret_cast<int*>(red_v + NT / 32);
  int* cur = red_i + NT / 32;

  if (tid == 0) cur[0] = a.prime[s * a.num_given];
  __syncthreads();

  for (int t = 0; t < a.total; ++t) {
    const int ta = a.t0 + t;
    const int c_in = cur[0];
    for (int r = tid; r < R; r += NT)
      h[r] = a.w_start[(size_t)c_in * R + r] + a.b_start[r];
    for (int o = tid; o < S; o += NT) skip[o] = 0.f;
    __syncthreads();

    if (!FUSE) {
      for (int l = 0; l < a.L; ++l) {
        z_part(a, l, ta, s, h, part);
        ring_write(a, l, ta, s, h);
        __syncthreads();
        for (int o = tid; o < D; o += NT) {
          float zf = a.b_in[l * twoD + o], zg = a.b_in[l * twoD + D + o];
          for (int g = 0; g < a.gz; ++g) {
            zf += part[g * twoD + o];
            zg += part[g * twoD + D + o];
          }
          u[o] = tanhf(zf) * sigmoidf_(zg);
        }
        __syncthreads();
        out_proj(a, l, u, h, hn, skip, 0, S + R);
        __syncthreads();
        float* tmp = h; h = hn; hn = tmp;
      }
    } else {
      // z of layer 0
      z_part(a, 0, ta, s, h, part);
      __syncthreads();
      for (int o = tid; o < twoD; o += NT) {
        float acc = a.b_in[o];
        for (int g = 0; g < a.gz; ++g) acc += part[g * twoD + o];
        z[o] = acc;
      }
      __syncthreads();
      for (int l = 0; l < a.L; ++l) {
        const bool next = l + 1 < a.L;
        // phase A: u from z; partial sums of h @ w_tap[l+1] (+ taps of l+1)
        ring_write(a, l, ta, s, h);
        for (int o = tid; o < D; o += NT) u[o] = tanhf(z[o]) * sigmoidf_(z[D + o]);
        if (next) z_part(a, l + 1, ta, s, h, part);
        __syncthreads();
        // phase B: z of layer l+1 = pre + u @ wf[l]; the output projection
        const int nz = next ? twoD : 0;
        for (int o = tid; o < nz; o += NT) {
          float pre = a.bf[l * twoD + o];
          for (int g = 0; g < a.gz; ++g) pre += part[g * twoD + o];
          const float* W = a.wf + (size_t)l * D * twoD;
          float acc = 0.f;
          for (int i = 0; i < D; ++i) acc = fmaf(u[i], W[i * twoD + o], acc);
          z[o] = pre + acc;
        }
        out_proj(a, l, u, h, hn, skip, nz, nz + S + R);
        __syncthreads();
        float* tmp = h; h = hn; hn = tmp;
      }
    }

    // head: y1 = relu(relu(skip) @ w_end1 + b_end1)
    matvec_part<true>(a.w_end1, skip, S, E, a.ge1, part);
    __syncthreads();
    for (int o = tid; o < E; o += NT) {
      float acc = a.b_end1[o];
      for (int g = 0; g < a.ge1; ++g) acc += part[g * E + o];
      y1[o] = fmaxf(acc, 0.f);
    }
    __syncthreads();
    // logits = y1 @ w_end2 + b_end2 - reg; the sampling score
    matvec_part<false>(a.w_end2, y1, E, C, a.ge2, part);
    __syncthreads();
    for (int c = tid; c < C; c += NT) {
      float v = a.b_end2[c];
      for (int g = 0; g < a.ge2; ++g) v += part[g * C + c];
      if (a.regularize != 0.f) {
        const float dc = (float)c - 0.5f * (float)C;
        v = __fsub_rn(v, __fmul_rn(__fmul_rn(dc, dc), a.regularize));
      }
      if (a.temperature > 0.f)
        v = __fadd_rn(__fdiv_rn(v, a.temperature),
                      counter_gumbel(c * a.streams + s, ta, a.seed));
      lg[c] = v;
    }
    __syncthreads();
    // block argmax, first index on ties
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int c = tid; c < C; c += NT) {
      const float v = lg[c];
      if (v > bv) { bv = v; bi = c; }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    if ((tid & 31) == 0) { red_v[tid >> 5] = bv; red_i[tid >> 5] = bi; }
    __syncthreads();
    if (tid < 32) {
      bv = tid < NT / 32 ? red_v[tid] : -INFINITY;
      bi = tid < NT / 32 ? red_i[tid] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      if (tid == 0) {
        if (bi >= C) bi = 0;  // all scores NaN: keep the embed gather in bounds
        a.out_cls[(size_t)s * a.total + t] = bi;
        cur[0] = t + 1 < a.num_given ? a.prime[s * a.num_given + t + 1] : bi;
      }
    }
    __syncthreads();
  }
}

// Row groups of a narrow product (n_in rows, n_out columns): as many as
// fit NT column tasks, so that more loads are in flight.
int row_groups(int n_out, int n_in) {
  const int g = NT / n_out;
  return g < 1 ? 1 : (g < n_in ? g : n_in);
}

// Dynamic shared memory of one block: the layout at the top of
// gen_fused_kernel.
int shared_bytes(int R, int D, int S, int E, int C, int gz, int ge1, int ge2) {
  int npart = NT;
  if (gz * 2 * D > npart) npart = gz * 2 * D;
  if (ge1 * E > npart) npart = ge1 * E;
  if (ge2 * C > npart) npart = ge2 * C;
  const int floats = 2 * R + S + D + 2 * D + npart + E + C + NT / 32;
  return (floats + NT / 32 + 1) * 4;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int wavenet_gen_fused(
    const float* w_start, const float* b_start, const float* w_tap,
    const float* b_in, const float* w_out, const float* b_out,
    const float* w_end1, const float* b_end1, const float* w_end2,
    const float* b_end2, const float* wf, const float* bf, const int* prime,
    const int* meta, float* rings, int* out_cls, int streams, int num_given,
    int total, int t0, int L, int k, int R, int D, int S, int E, int C,
    float temperature, float regularize,
    int seed, int fuse_res, void* stream) {
  Args a;
  a.w_start = w_start; a.b_start = b_start; a.w_tap = w_tap; a.b_in = b_in;
  a.w_out = w_out; a.b_out = b_out; a.w_end1 = w_end1; a.b_end1 = b_end1;
  a.w_end2 = w_end2; a.b_end2 = b_end2; a.wf = wf; a.bf = bf;
  a.prime = prime; a.meta = meta; a.rings = rings; a.out_cls = out_cls;
  a.streams = streams; a.num_given = num_given; a.total = total; a.t0 = t0;
  a.L = L; a.k = k; a.R = R; a.D = D; a.S = S; a.E = E; a.C = C;
  a.gz = row_groups(2 * D, k * R);
  a.ge1 = row_groups(E, S);
  a.ge2 = row_groups(C, E);
  a.temperature = temperature; a.regularize = regularize;
  a.seed = (unsigned)seed;
  const int smem = shared_bytes(R, D, S, E, C, a.gz, a.ge1, a.ge2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fuse_res) {
    err = cudaFuncSetAttribute(gen_fused_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gen_fused_kernel<true><<<streams, NT, smem, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(gen_fused_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    gen_fused_kernel<false><<<streams, NT, smem, st>>>(a);
  }
  return (int)cudaGetLastError();
}
