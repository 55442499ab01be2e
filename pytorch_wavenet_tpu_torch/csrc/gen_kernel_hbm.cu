// Batched many-stream WaveNet generation for Hopper (sm_90a): kernel K4.
//
// Replaces the JAX package's Pallas TPU kernel
// pytorch_wavenet_tpu/ops/pallas/gen_kernel_hbm.py::generate_fast_batched
// (_make_kernel, one pallas_call for the whole loop of many streams, ring
// state in device memory).
//
// What it computes, per stream ("lane") and per step t (absolute time
// ta = t0 + t), with the ring in the JAX layout (sum_l P_l * R, streams):
//   h = w_start[cls] + b_start
//   per layer l (dilation d, period P = (k-1)d + 1):
//     ring_l[ta mod P] = h
//     z = [taps with ta >= lookback, h] @ w_tap[l] + b_in[l]
//         (tap j looks back m = (k-1-j)d: slot (ta - m) mod P; a tap with
//          ta < m is 0.0 through a select, never read, so unwritten slots
//          never matter)
//     u = tanh(z[:D]) * sigmoid(z[D:])
//     exact: [skip | res] = u @ w_out[l] + b_out[l]; skip_acc += skip; h += res
//     skip_slab: slab[l] = u; h += u @ w_res[l] + b_res[l]
//   row = skip_acc, or slab @ w_skip + sum_l b_skip[l] under skip_slab
//   logits = relu(relu(row) @ w_end1 + b_end1) @ w_end2 + b_end2 - reg
//   T > 0: argmax(logits / max(T, 1e-6) + gumbel), else argmax(logits)
//   (first index on ties), fed back unless the prime still runs.
// fuse_res walks the chain with wf[l] = w_res[l] @ w_cur[l+1]:
//   z[l+1] = (taps[l+1] + h[l] @ w_cur[l+1] + bf[l]) + u[l] @ wf[l].
// The Gumbel noise is the counter hash of gen_common.cuh, keyed by
// (class * streams + lane, ta, seed), or under lane_seed by (class,
// ta + toff[lane], seed[lane]): a request's draws do not depend on its lane
// or on the pool around it.
//
// Design: lanes never interact, so one thread block owns a tile of TL
// lanes for every step of the call (no grid-wide synchronisation, no
// prefetch across steps). Activations live in shared memory as
// [channel][lane]; each thread computes one output channel for all TL lanes
// of the tile in registers, so a weight read from L2 serves TL lanes, and
// the lane values come from shared memory as broadcast vector loads. Taps
// and ring writes go to device memory: a tile's lanes are contiguous, so
// they move as TL-float segments. __syncthreads() separates the phases of a
// layer (4 per layer exact, 3 under fuse_res); a block's ring writes are
// visible to its own reads after the barrier, and no other block touches
// its lanes.
//
// What bounds it on this card: the f32 arithmetic of the whole call is
// 3.58 MFLOP per lane-step at chaconne widths (most of it the skip
// projection, 30 x 32 x 1024 MACs, and the head), 1.88 TFLOP per 2048-step
// chunk of 256 lanes: 28 ms at the card's 67 TFLOP/s outside the tensor
// cores, far above the bytes' bound. The kernel is further from it: every
// block re-reads all weights (7.2 MB at chaconne) from L2 every step, and
// each SM computes with plain FMAs, so the tile size trades L2 traffic
// (small tiles, many blocks) against the number of busy SMs (large tiles,
// few blocks). Tensor cores for the skip and head products and weights
// shared across a cluster are left for later work.

#include <cuda_runtime.h>
#include <math.h>

#include "gen_common.cuh"

#define NT 256  // threads per block

namespace {

struct Args {
  const float* w_start;  // (C, R)
  const float* b_start;  // (R)
  const float* w_tap;    // (L, k*R, 2D)
  const float* b_in;     // (L, 2D)
  const float* w_out;    // exact: (L, D, S+R)
  const float* b_out;    // exact: (L, S+R)
  const float* w_res;    // skip_slab: (L, D, R)
  const float* b_res;    // skip_slab: (L, R)
  const float* w_skip;   // skip_slab: (L*D, S)
  const float* b_skip;   // skip_slab: (S), the layers' skip biases summed
  const float* w_end1;   // (S, E)
  const float* b_end1;   // (E)
  const float* w_end2;   // (E, C)
  const float* b_end2;   // (C)
  const float* wf;       // fuse_res: (L-1, D, 2D)
  const float* bf;       // fuse_res: (L-1, 2D)
  const float* temps;    // (streams)
  const int* seeds;      // lane_seed: (streams)
  const int* toffs;      // lane_seed: (streams)
  const int* prime;      // (streams, num_given)
  const int* meta;       // (L, 3): dilation, period, first ring slot
  float* ring;           // (sum P * R, streams), updated in place
  int* out_cls;          // (streams, total)
  int streams, num_given, total, t0;
  int L, k, R, D, S, E, C;
  int gz;                // row groups of the z product
  float regularize;
  unsigned seed;
  int fuse_res, skip_slab, lane_seed;
};

// The TL lane values of one channel row of a [channel][lane] buffer.
template <int TL>
__device__ __forceinline__ void load_lanes(const float* p, float (&v)[TL]) {
  if constexpr (TL % 4 == 0) {
#pragma unroll
    for (int j = 0; j < TL; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + j);
      v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
    }
  } else if constexpr (TL % 2 == 0) {
#pragma unroll
    for (int j = 0; j < TL; j += 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + j);
      v[j] = q.x; v[j + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < TL; ++j) v[j] = p[j];
  }
}

// acc[lane] += sum_{i in [i0, i1)} f(x[i][lane]) * W[i][o], W row-major with
// leading dimension ld; f = relu when RELU.
template <int TL, bool RELU>
__device__ __forceinline__ void dot_lanes(const float* __restrict__ W, int ld,
                                          int o, const float* x, int i0,
                                          int i1, float (&acc)[TL]) {
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
    const float w = __ldg(W + (size_t)i * ld + o);
    float xv[TL];
    load_lanes<TL>(x + i * TL, xv);
#pragma unroll
    for (int j = 0; j < TL; ++j)
      acc[j] = fmaf(RELU ? fmaxf(xv[j], 0.f) : xv[j], w, acc[j]);
  }
}

// y[o][lane] = b[o] + sum_i f(x[i][lane]) W[i][o] for o < n_out (relu'd
// when RELU_OUT): one output channel per thread, all lanes in registers.
template <int TL, bool RELU_IN, bool RELU_OUT>
__device__ __forceinline__ void dense(const float* __restrict__ W,
                                      const float* __restrict__ b, int n_in,
                                      int n_out, const float* x, float* y) {
  for (int o = threadIdx.x; o < n_out; o += NT) {
    float acc[TL];
#pragma unroll
    for (int j = 0; j < TL; ++j) acc[j] = 0.f;
    dot_lanes<TL, RELU_IN>(W, n_out, o, x, 0, n_in, acc);
    const float bo = b[o];
#pragma unroll
    for (int j = 0; j < TL; ++j) {
      const float v = acc[j] + bo;
      y[o * TL + j] = RELU_OUT ? fmaxf(v, 0.f) : v;
    }
  }
}

// Stage layer l's gate input: x = [taps, h] as [row][lane], rows j*R + r.
// A tap whose lookback m reaches before time 0 (ta < m) is staged as 0.0
// through a select, never read: an unwritten slot never reaches the result,
// and the product sums the same k*R rows in the same groups at every ta, as
// a pooled lane does over zeroed history.
template <int TL>
__device__ __forceinline__ void stage_taps(const Args& a, int l, int ta,
                                           int lane0, const float* h,
                                           float* x) {
  const int d = a.meta[3 * l], P = a.meta[3 * l + 1];
  const int first = a.meta[3 * l + 2];
  const int nt = a.k - 1;
  for (int idx = threadIdx.x; idx < nt * a.R * TL; idx += NT) {
    const int row = idx / TL, lane = idx % TL;
    const int j = row / a.R, r = row - j * a.R;
    const int m = (nt - j) * d;
    const int s = lane0 + lane;
    x[idx] = s < a.streams && ta >= m
                 ? a.ring[((size_t)(first + pmod(ta - m, P)) * a.R + r) *
                              a.streams + s]
                 : 0.f;
  }
  for (int idx = threadIdx.x; idx < a.R * TL; idx += NT)
    x[(nt * a.R) * TL + idx] = h[idx];
}

// Ring write of the layer input h at slot ta mod P. No tap of this step
// reads that slot: a tap looks back m in (0, P) steps.
template <int TL>
__device__ __forceinline__ void ring_write(const Args& a, int l, int ta,
                                           int lane0, const float* h) {
  const int P = a.meta[3 * l + 1], first = a.meta[3 * l + 2];
  const int slot = pmod(ta, P);
  for (int idx = threadIdx.x; idx < a.R * TL; idx += NT) {
    const int r = idx / TL, lane = idx % TL, s = lane0 + lane;
    if (s < a.streams)
      a.ring[((size_t)(first + slot) * a.R + r) * a.streams + s] = h[idx];
  }
}

// Row-group partial sums of a gate input: the k*R rows of x against
// w_tap[l], then (fuse_res) the D rows of u against wf[lf]:
// part[(g * 2D + o) * TL + lane]. Task ids start at 0.
template <int TL>
__device__ __forceinline__ void z_part(const Args& a, int l, const float* x,
                                       int lf, const float* u, float* part) {
  const int twoD = 2 * a.D, kR = a.k * a.R, G = a.gz;
  const float* Wt = a.w_tap + (size_t)l * kR * twoD;
  const int n_tap = kR, n = n_tap + (lf >= 0 ? a.D : 0);
  const int rows = (n + G - 1) / G;
  for (int task = threadIdx.x; task < G * twoD; task += NT) {
    const int o = task % twoD, g = task / twoD;
    const int i0 = g * rows, i1 = min(n, i0 + rows);
    float acc[TL];
#pragma unroll
    for (int j = 0; j < TL; ++j) acc[j] = 0.f;
    // tap and h rows
    const int t1 = min(i1, n_tap);
    if (i0 < t1) dot_lanes<TL, false>(Wt, twoD, o, x, i0, t1, acc);
    // u rows against the chain weights
    if (lf >= 0 && i1 > n_tap) {
      const int u0 = max(i0, n_tap) - n_tap, u1 = i1 - n_tap;
      dot_lanes<TL, false>(a.wf + (size_t)lf * a.D * twoD, twoD, o, u, u0, u1,
                           acc);
    }
#pragma unroll
    for (int j = 0; j < TL; ++j) part[task * TL + j] = acc[j];
  }
}

// Output projection of u, tasks [first, first + n_out) of this phase:
// exact: [skip | res] = u @ w_out[l] + b_out[l] (skip += the first S,
// h += the rest); skip_slab: h += u @ w_res[l] + b_res[l].
template <int TL>
__device__ __forceinline__ void out_proj(const Args& a, int l, const float* u,
                                         float* h, float* skip, int first) {
  const int S = a.skip_slab ? 0 : a.S;
  const int n_out = S + a.R;
  const float* W = a.skip_slab ? a.w_res + (size_t)l * a.D * a.R
                               : a.w_out + (size_t)l * a.D * n_out;
  const float* b = a.skip_slab ? a.b_res + l * a.R : a.b_out + l * n_out;
  for (int task = threadIdx.x; task < first + n_out; task += NT) {
    const int o = task - first;
    if (o < 0) continue;
    float acc[TL];
#pragma unroll
    for (int j = 0; j < TL; ++j) acc[j] = 0.f;
    dot_lanes<TL, false>(W, n_out, o, u, 0, a.D, acc);
    const float bo = b[o];
    float* dst = o < S ? skip + o * TL : h + (o - S) * TL;
#pragma unroll
    for (int j = 0; j < TL; ++j) dst[j] = dst[j] + (acc[j] + bo);
  }
}

// Shared memory of one block, in floats; the layout at the top of
// gen_batched_kernel.
struct Layout {
  int h, x, u, z, part, row, tail, cur, total;
};

__host__ __device__ inline Layout layout(int TL, int L, int k, int R, int D,
                                         int S, int E, int C, int gz,
                                         int skip_slab) {
  Layout s;
  s.h = 0;
  s.x = s.h + R * TL;                 // staged gate input, k*R rows
  s.u = s.x + k * R * TL;
  s.z = s.u + D * TL;
  s.part = s.z + 2 * D * TL;          // z partials, gz * 2D rows
  s.row = s.part + gz * 2 * D * TL;   // skip accumulator / skip row, S rows
  s.tail = s.row + S * TL;            // slab (L*D rows), then y1 and logits
  const int head = (E + C) * TL;
  const int slab = skip_slab ? L * D * TL : 0;
  s.cur = s.tail + (slab > head ? slab : head);
  s.total = s.cur + TL;               // + TL ints: the next input classes
  return s;
}

template <int TL>
__global__ void __launch_bounds__(NT) gen_batched_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane0 = blockIdx.x * TL;
  const int R = a.R, D = a.D, S = a.S, E = a.E, C = a.C, twoD = 2 * a.D;
  const Layout lay = layout(TL, a.L, a.k, R, D, S, E, C, a.gz, a.skip_slab);
  float* h = sm + lay.h;
  float* x = sm + lay.x;
  float* u = sm + lay.u;
  float* z = sm + lay.z;
  float* part = sm + lay.part;
  float* row = sm + lay.row;
  float* slab = sm + lay.tail;
  float* y1 = sm + lay.tail;  // the slab is consumed before y1 is written
  float* lg = y1 + E * TL;
  int* cur = reinterpret_cast<int*>(sm + lay.cur);

  for (int lane = tid; lane < TL; lane += NT) {
    const int s = lane0 + lane;
    cur[lane] = s < a.streams ? a.prime[(size_t)s * a.num_given] : 0;
  }
  __syncthreads();

  for (int t = 0; t < a.total; ++t) {
    const int ta = a.t0 + t;
    for (int idx = tid; idx < R * TL; idx += NT) {
      const int r = idx / TL, lane = idx % TL;
      h[idx] = a.w_start[(size_t)cur[lane] * R + r] + a.b_start[r];
    }
    if (!a.skip_slab)
      for (int idx = tid; idx < S * TL; idx += NT) row[idx] = 0.f;
    __syncthreads();

    if (!a.fuse_res) {
      for (int l = 0; l < a.L; ++l) {
        ring_write<TL>(a, l, ta, lane0, h);
        stage_taps<TL>(a, l, ta, lane0, h, x);
        __syncthreads();
        z_part<TL>(a, l, x, -1, u, part);
        __syncthreads();
        for (int idx = tid; idx < D * TL; idx += NT) {
          const int o = idx / TL, lane = idx % TL;
          float zf = a.b_in[l * twoD + o], zg = a.b_in[l * twoD + D + o];
          for (int g = 0; g < a.gz; ++g) {
            zf += part[(g * twoD + o) * TL + lane];
            zg += part[(g * twoD + D + o) * TL + lane];
          }
          const float uv = tanhf(zf) * sigmoidf_(zg);
          u[idx] = uv;
          if (a.skip_slab) slab[(l * D) * TL + idx] = uv;
        }
        __syncthreads();
        out_proj<TL>(a, l, u, h, row, 0);
        __syncthreads();
      }
    } else {
      // z of layer 0
      {
        stage_taps<TL>(a, 0, ta, lane0, h, x);
        __syncthreads();
        z_part<TL>(a, 0, x, -1, u, part);
        __syncthreads();
        for (int idx = tid; idx < twoD * TL; idx += NT) {
          const int o = idx / TL, lane = idx % TL;
          float acc = a.b_in[o];
          for (int g = 0; g < a.gz; ++g) acc += part[(g * twoD + o) * TL + lane];
          z[idx] = acc;
        }
        __syncthreads();
      }
      for (int l = 0; l < a.L; ++l) {
        const bool next = l + 1 < a.L;
        // phase A: ring write of h; u from z; stage layer l+1's input
        ring_write<TL>(a, l, ta, lane0, h);
        for (int idx = tid; idx < D * TL; idx += NT) {
          const float uv = tanhf(z[idx]) * sigmoidf_(z[D * TL + idx]);
          u[idx] = uv;
          if (a.skip_slab) slab[(l * D) * TL + idx] = uv;
        }
        if (next) stage_taps<TL>(a, l + 1, ta, lane0, h, x);
        __syncthreads();
        // phase B: partials of z[l+1] = taps + h @ w_cur[l+1] + u @ wf[l];
        // the output projection of u updates skip and h
        const int nz = next ? a.gz * twoD : 0;
        if (next) z_part<TL>(a, l + 1, x, l, u, part);
        out_proj<TL>(a, l, u, h, row, nz);
        __syncthreads();
        // phase C: z of layer l+1
        if (next) {
          for (int idx = tid; idx < twoD * TL; idx += NT) {
            const int o = idx / TL, lane = idx % TL;
            float acc = a.bf[l * twoD + o];
            for (int g = 0; g < a.gz; ++g)
              acc += part[(g * twoD + o) * TL + lane];
            z[idx] = acc;
          }
          __syncthreads();
        }
      }
    }

    // head: the skip row, y1 = relu(relu(row) @ w_end1 + b_end1), logits
    if (a.skip_slab) {
      dense<TL, false, false>(a.w_skip, a.b_skip, a.L * D, S, slab, row);
      __syncthreads();
    }
    dense<TL, true, true>(a.w_end1, a.b_end1, S, E, row, y1);
    __syncthreads();
    dense<TL, false, false>(a.w_end2, a.b_end2, E, C, y1, lg);
    __syncthreads();

    // sampling: one warp per lane, argmax with the first index on ties
    const int warp = tid >> 5, wl = tid & 31;
    for (int lane = warp; lane < TL; lane += NT / 32) {
      const int s = lane0 + lane;
      const float temp = s < a.streams ? a.temps[s] : 0.f;
      const float tdiv = fmaxf(temp, 1e-6f);
      unsigned tloc = (unsigned)ta, seed = a.seed;
      if (a.lane_seed && s < a.streams) {
        tloc = (unsigned)ta + (unsigned)a.toffs[s];
        seed = (unsigned)a.seeds[s];
      }
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      for (int c = wl; c < C; c += 32) {
        float v = lg[c * TL + lane];
        if (a.regularize != 0.f) {
          const float dc = (float)c - 0.5f * (float)C;
          v = __fsub_rn(v, __fmul_rn(__fmul_rn(dc, dc), a.regularize));
        }
        if (temp > 0.f) {
          const unsigned idx = a.lane_seed ? (unsigned)c
                                           : (unsigned)c * a.streams + s;
          v = __fadd_rn(__fdiv_rn(v, tdiv), counter_gumbel(idx, tloc, seed));
        }
        if (v > bv) { bv = v; bi = c; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      if (wl == 0) {
        if (bi >= C) bi = 0;  // all scores NaN: keep the embed gather in bounds
        if (s < a.streams) {
          a.out_cls[(size_t)s * a.total + t] = bi;
          cur[lane] = t + 1 < a.num_given
                          ? a.prime[(size_t)s * a.num_given + t + 1]
                          : bi;
        }
      }
    }
    __syncthreads();
  }
}

// Row groups of the z product (2D columns, up to k*R + D rows): as many as
// fit NT column tasks, so that more loads are in flight.
int row_groups(int n_out, int n_in) {
  const int g = NT / n_out;
  return g < 1 ? 1 : (g < n_in ? g : n_in);
}

template <int TL>
int launch(const Args& a, int grid, cudaStream_t st) {
  const Layout lay = layout(TL, a.L, a.k, a.R, a.D, a.S, a.E, a.C, a.gz,
                            a.skip_slab);
  const int smem = lay.total * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gen_batched_kernel<TL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  gen_batched_kernel<TL><<<grid, NT, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory (bytes) of one block at tile width `tile`.
extern "C" int wavenet_gen_batched_smem(int tile, int L, int k, int R, int D,
                                        int S, int E, int C, int skip_slab) {
  const int gz = row_groups(2 * D, k * R + D);
  return layout(tile, L, k, R, D, S, E, C, gz, skip_slab).total * 4;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success),
// or -1 for a tile width without a compiled kernel.
extern "C" int wavenet_gen_batched(
    const float* w_start, const float* b_start, const float* w_tap,
    const float* b_in, const float* w_out, const float* b_out,
    const float* w_res, const float* b_res, const float* w_skip,
    const float* b_skip, const float* w_end1, const float* b_end1,
    const float* w_end2, const float* b_end2, const float* wf,
    const float* bf, const float* temps, const int* seeds, const int* toffs,
    const int* prime, const int* meta, float* ring, int* out_cls,
    int streams, int num_given, int total, int t0, int L, int k, int R, int D,
    int S, int E, int C, float regularize, int seed, int fuse_res,
    int skip_slab, int lane_seed, int tile, void* stream) {
  Args a;
  a.w_start = w_start; a.b_start = b_start; a.w_tap = w_tap; a.b_in = b_in;
  a.w_out = w_out; a.b_out = b_out; a.w_res = w_res; a.b_res = b_res;
  a.w_skip = w_skip; a.b_skip = b_skip; a.w_end1 = w_end1;
  a.b_end1 = b_end1; a.w_end2 = w_end2; a.b_end2 = b_end2; a.wf = wf;
  a.bf = bf; a.temps = temps; a.seeds = seeds; a.toffs = toffs;
  a.prime = prime; a.meta = meta; a.ring = ring; a.out_cls = out_cls;
  a.streams = streams; a.num_given = num_given; a.total = total; a.t0 = t0;
  a.L = L; a.k = k; a.R = R; a.D = D; a.S = S; a.E = E; a.C = C;
  a.gz = row_groups(2 * D, k * R + D);
  a.regularize = regularize;
  a.seed = (unsigned)seed;
  a.fuse_res = fuse_res; a.skip_slab = skip_slab; a.lane_seed = lane_seed;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (streams + tile - 1) / tile;
  switch (tile) {
    case 2: return launch<2>(a, grid, st);
    case 4: return launch<4>(a, grid, st);
    default: return -1;
  }
}
