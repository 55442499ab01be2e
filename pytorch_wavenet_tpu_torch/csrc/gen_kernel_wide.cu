// Kernel KW: batched many-stream WaveNet generation for a wide chain, on
// Hopper (sm_90a). It replaces no TPU kernel: the JAX package's HBM
// kernel (ops/pallas/gen_kernel_hbm.py::generate_fast_batched) keeps a
// tile's chain weights on chip, which no block of this card can do at the
// published vocoder widths (R = D = 512, 30 layers: 178 MB of weights, more
// than L2 and more than every SM's shared memory together). K4's cluster
// core (gen_cluster.cuh) has no tile that fits there, so the wrapper
// (ops/cuda/gen_kernel_wide.py) launches this kernel instead; it computes
// the function of K4's plain version (gen_kernel_hbm.py::batched_plain):
// the same ring layout (sum_l P_l * R (+1), streams), the same taps,
// sampling and counter-hash noise, and the kernel-2 input
// (h0 = w_prev[x[t-1]] + w[x[t]] + b, the previous class carried in the
// ring's last row as class + 1, 0 for none).
//
// What bounds it on this card: a step is 30 layers of two dependent
// products whose batch is the pool's lanes, [tap | h | c_t] (2R + M) x 2D
// and u D x (R + S), then the head: 88.5 MFLOP a lane-step at wnv512,
// 22.7 GFLOP a step at 256 lanes (45.8 us at the TF32 peak), with all
// 178 MB of weights read each step (53 us at 3.35 TB/s). What the design
// does about it: ONE persistent cooperative launch a call, one block an
// SM, walks the steps and layers; each product is split into 32-row x
// 64-lane tiles over the blocks, the lanes as the tensor cores' N, so all
// lanes share one read of each layer's weights a step (from HBM, then L2
// for the other lane tiles). The tiles stream K in 64-deep stages through
// a 5-stage cp.async pipeline (16-byte copies of the lanes' rows: the
// wrapper pads the lanes to a multiple of 4) and multiply on the tensor cores in
// 3xTF32 (tf32.cuh), which holds f32 accuracy; each warp holds 16 lanes
// of 32 rows over half of every stage's depth, with the hi x hi products
// and the cross terms in separate sums, so eight mma chains run apart.
// The gate rows are packed so a tile holds the tanh and sigmoid rows of
// the same 16 channels: u is made in registers. A grid barrier (one
// counter, release/acquire) separates the phases: after the gate
// products, after the residual and skip products (h of layer l+1 is
// written straight into its ring slot), after end1, end2 and the
// sampling, 2L + 3 a step (2L for a teacher-forced step, which skips the
// skip rows and the head). Measured (PERF.md): 1.06 ms a 256-lane step,
// each tile's stages bound by their loads of the lanes' rows and their
// mma.sync work, which add rather than overlap.
//
// Every sum's order is fixed by the configuration alone: a product sums
// each half of every 64-deep stage in 8-deep mma steps in order, the
// stages in order, then the two halves, so a lane's classes and ring are
// the same bits at any lane count, tile or grid size.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gen_common.cuh"
#include "tf32.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BM = 32;      // rows of a tile: two m16 tiles
constexpr int BN = 64;      // lanes of a tile: two n8 tiles a warp pair
constexpr int KC = 64;      // depth of a pipeline stage
constexpr int STAGES = 5;
constexpr int AST = KC + 4;  // padded rows: conflict-free fragment loads
constexpr int BST = BN + 8;
constexpr int A_TILE = BM * AST;
constexpr int B_TILE = KC * BST;
constexpr int SMEM_BYTES = STAGES * (A_TILE + B_TILE) * 4;

// the phases of a step that `timers` accumulates (ns, block 0's view)
enum { PH_GATE, PH_OUT, PH_BAR, PH_INPUT, PH_END1, PH_END2, PH_SAMPLE,
       NPHASE };

struct Args {
  const float *A0, *A1, *a;    // input taps (C, R) (A0 may be null), bias (R)
  const float *W1, *b1;        // (L, M1p, K1p), (L, M1p): gate products
  const float *W2, *b2;        // (L, Rp + Sp, K2p), (L, Rp + Sp)
  const float *E1, *be1;       // (Ep, K3p), (Ep)
  const float *E2, *be2;       // (Cp, K4p), (Cp)
  const float* cond;           // (total, M, streams) or null
  const float* temps;
  const int *seeds, *toffs, *prime, *meta;
  float* ring;
  int* out;
  float *U, *skip, *Y;  // (D|S|E, streams) scratch
  float* logits;        // (streams, C) scratch
  int* cur;             // (streams,) this step's input class
  unsigned long long* bar;
  unsigned long long* timers;
  int streams, num_given, total, t0, L, R, D, S, E, C, M;
  int M1p, K1p, Rp, Sp, K2p, Ep, K3p, Cp, K4p;
  int extra_row;  // the ring's previous-class row, or -1
  int seed, lane_seed, head_from;
  float regularize;
};

// rows [0, n0) of a product's B operand from p0, the next n1 from p1, the
// next n2 from p2 (a null part, and every row past them, reads 0)
struct Src {
  const float* p[3];
  int n[3];
};

__device__ __forceinline__ const float* src_row(const Src& s, int k,
                                                int streams) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (k < s.n[i]) return s.p[i] ? s.p[i] + (size_t)k * streams : nullptr;
    k -= s.n[i];
  }
  return nullptr;
}

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// Every block of the grid arrives before any leaves; the block's writes
// before it are visible to every block after it.
__device__ __forceinline__ void grid_barrier(unsigned long long* bar,
                                             unsigned long long& target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += gridDim.x;
    __threadfence();
    atomicAdd(bar, 1ull);
    unsigned long long v;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(v)
                   : "l"(bar)
                   : "memory");
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void cp16z(float* dst, const float* src,
                                      bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// One BM x BN tile of A (Mp, Kp) row-major times B (Kp, streams). Warp w
// takes lanes n0 + 16 (w % 4) .. + 15 (two n8 tiles) and half w / 4 of
// each stage's depth; the 3xTF32 terms sum into two accumulators (the
// hi x hi products, and the two cross terms), then the halves meet in
// shared memory in a fixed order. On return the warps of half 0 hold the
// tile in acc[q][j]: rows m0 + 16q + (g, g + 8), lanes n0 + 16 (w % 4) +
// 8j + (2t, 2t + 1), in mma.sync's accumulator order; the function
// returns whether the calling warp holds it. RELU_B: B is read through
// max(0, .). The streams are a multiple of 4, so B's rows copy in 16-byte
// pieces.
template <bool RELU_B>
__device__ bool tile_mma(const float* __restrict__ A, int Kp, int m0,
                         const Src& src, int n0, int streams, float* smem,
                         float (&acc)[2][2][4]) {
  float* As = smem;
  float* Bs = smem + STAGES * A_TILE;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp & 3, wk = warp >> 2;
  float cm[2][2][4], cc[2][2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) cm[q][j][i] = cc[q][j][i] = 0.f;
  const int nk = Kp / KC;
  const bool active = n0 + wn * 16 < streams;

  auto load = [&](int stage, int kc) {
#pragma unroll
    for (int i = 0; i < BM * KC / (4 * THREADS); ++i) {
      const int e = tid + i * THREADS, m = e / (KC / 4);
      const int c4 = (e % (KC / 4)) * 4;
      cp16(As + stage * A_TILE + m * AST + c4,
           A + (size_t)(m0 + m) * Kp + kc * KC + c4);
    }
    float* bs = Bs + stage * B_TILE;
#pragma unroll
    for (int i = 0; i < KC * BN / (4 * THREADS); ++i) {
      const int e = tid + i * THREADS, kr = e / (BN / 4);
      const int nc = (e % (BN / 4)) * 4, n = n0 + nc;
      const float* row = src_row(src, kc * KC + kr, streams);
      const bool valid = row != nullptr && n < streams;
      cp16z(bs + kr * BST + nc, valid ? row + n : A, valid);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    wait_groups<STAGES - 2>();
    __syncthreads();
    const int nxt = kc + STAGES - 1;
    if (nxt < nk) load(nxt % STAGES, nxt);
    commit();
    if (!active) continue;
    const float* as = As + (kc % STAGES) * A_TILE;
    const float* bs = Bs + (kc % STAGES) * B_TILE + wn * 16 + g;
#pragma unroll
    for (int kk = wk * (KC / 2); kk < (wk + 1) * (KC / 2); kk += 8) {
      unsigned bh[2][2], bl[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float b0 = bs[(kk + t) * BST + 8 * j];
        float b1 = bs[(kk + t + 4) * BST + 8 * j];
        if (RELU_B) {
          b0 = fmaxf(b0, 0.f);
          b1 = fmaxf(b1, 0.f);
        }
        tf32_split(b0, bh[j][0], bl[j][0]);
        tf32_split(b1, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* ar = as + (q * 16 + g) * AST + kk + t;
        unsigned ah[4], al[4];
        tf32_split(ar[0], ah[0], al[0]);
        tf32_split(ar[8 * AST], ah[1], al[1]);
        tf32_split(ar[4], ah[2], al[2]);
        tf32_split(ar[8 * AST + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_tf32(cc[q][j], al, bh[j][0], bh[j][1]);
          mma_tf32(cc[q][j], ah, bl[j][0], bl[j][1]);
          mma_tf32(cm[q][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
  }
  wait_groups<0>();
  __syncthreads();
  // the two halves of the depth: half 1 hands its sums to half 0
  float* red = smem + (wn * 32 + lane) * 16;
  if (wk == 1 && active) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[q * 8 + j * 4 + i] = cc[q][j][i] + cm[q][j][i];
  }
  __syncthreads();
  if (wk == 0 && active) {
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[q][j][i] = (cc[q][j][i] + cm[q][j][i]) + red[q * 8 + j * 4 + i];
  }
  __syncthreads();
  return wk == 0 && active;
}

// Calls f(row, lane, value) for each element of a tile that the calling
// warp holds (tile_mma's layout).
template <class F>
__device__ __forceinline__ void each(const float (&acc)[2][2][4], int m0,
                                     int n0, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        f(m0 + q * 16 + g + 8 * (i >> 1),
          n0 + (warp & 3) * 16 + j * 8 + 2 * t + (i & 1), acc[q][j][i]);
}

// the ring row of layer-0 slot `slot`, channel 0, of every lane
__device__ __forceinline__ float* layer0_row(const Args& a, int ta) {
  const int P0 = a.meta[1], f0 = a.meta[2];
  return a.ring + (size_t)(f0 + ta % P0) * a.R * a.streams;
}

// Lane n's input rows at the call's first step (one warp).
__device__ void input_lane(const Args& a, int n, int lane) {
  const int c = a.prime[(size_t)n * a.num_given];
  int p = -1;
  if (a.A0 != nullptr && a.t0 >= 1) {
    const float pv = a.ring[(size_t)a.extra_row * a.streams + n];
    if (pv > 0.5f) p = min(max((int)pv - 1, 0), a.C - 1);
  }
  float* dst = layer0_row(a, a.t0) + n;
  for (int r = lane; r < a.R; r += 32) {
    float v = a.A1[(size_t)c * a.R + r];
    if (p >= 0) v = a.A0[(size_t)p * a.R + r] + v;
    dst[(size_t)r * a.streams] = v + a.a[r];
  }
  if (lane == 0) a.cur[n] = c;
}

// Lane n after step t (one warp): its output class, its next input class
// and, unless t is the call's last step, step t + 1's input rows; the
// ring's previous-class row takes this step's input.
__device__ void advance_lane(const Args& a, int n, int lane, int t, int ta,
                             int sampled) {
  const int c_in = a.cur[n];
  int out, next;
  if (t < a.head_from) {
    next = out = a.prime[(size_t)n * a.num_given + t + 1];
  } else {
    out = sampled;
    next = t + 1 < a.num_given ? a.prime[(size_t)n * a.num_given + t + 1]
                               : sampled;
  }
  if (t + 1 < a.total) {
    float* dst = layer0_row(a, ta + 1) + n;
    for (int r = lane; r < a.R; r += 32) {
      float v = a.A1[(size_t)next * a.R + r];
      if (a.A0 != nullptr) v = a.A0[(size_t)c_in * a.R + r] + v;
      dst[(size_t)r * a.streams] = v + a.a[r];
    }
  }
  __syncwarp();
  if (lane == 0) {
    a.out[(size_t)n * a.total + t] = out;
    if (a.extra_row >= 0)
      a.ring[(size_t)a.extra_row * a.streams + n] = (float)(c_in + 1);
    a.cur[n] = next;
  }
}

// Lane n's draw at step t from its logits row (one warp): argmax of the
// scores, the first class on ties.
__device__ int sample_lane(const Args& a, int n, int lane, int ta) {
  const float T = a.temps[n];
  const bool hot = T > 0.f;
  const float tdiv = fmaxf(T, 1e-6f);
  float best = -INFINITY;
  int bi = 0x7fffffff;
  for (int c = lane; c < a.C; c += 32) {
    float s = a.logits[(size_t)n * a.C + c];
    if (a.regularize != 0.f) {
      const float dc = (float)c - a.C / 2.0f;
      s = s - __fmul_rn(__fmul_rn(dc, dc), a.regularize);
    }
    if (hot) {
      unsigned idx, tl, sd;
      if (a.lane_seed) {
        idx = (unsigned)c;
        tl = (unsigned)(ta + a.toffs[n]);
        sd = (unsigned)a.seeds[n];
      } else {
        idx = (unsigned)(c * a.streams + n);
        tl = (unsigned)ta;
        sd = (unsigned)a.seed;
      }
      s = __fdiv_rn(s, tdiv) + counter_gumbel(idx, tl, sd);
    }
    if (s > best) {
      best = s;
      bi = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ob > best || (ob == best && oi < bi)) {
      best = ob;
      bi = oi;
    }
  }
  return bi == 0x7fffffff ? 0 : bi;
}

__global__ void __launch_bounds__(THREADS, 1) wide_step_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = gridDim.x, bid = blockIdx.x;
  const int ns = a.streams;
  const int ntn = (ns + BN - 1) / BN;
  const int wid = bid * WARPS + warp, nwarps = nb * WARPS;
  unsigned long long target = 0;
  const bool timed = a.timers != nullptr && bid == 0 && threadIdx.x == 0;
  unsigned long long tacc[NPHASE];
#pragma unroll
  for (int i = 0; i < NPHASE; ++i) tacc[i] = 0;
  unsigned long long tmark = timed ? now_ns() : 0;
  auto mark = [&](int ph) {
    if (timed) {
      const unsigned long long x = now_ns();
      tacc[ph] += x - tmark;
      tmark = x;
    }
  };
  auto sync = [&]() {
    grid_barrier(a.bar, target);
    mark(PH_BAR);
  };

  for (int n = wid; n < ns; n += nwarps) input_lane(a, n, lane);
  mark(PH_INPUT);
  sync();

  for (int t = 0; t < a.total; ++t) {
    const int ta = a.t0 + t;
    const bool head = t >= a.head_from;
    for (int l = 0; l < a.L; ++l) {
      const int d = a.meta[3 * l], P = a.meta[3 * l + 1],
                f = a.meta[3 * l + 2];
      const float* cur = a.ring + (size_t)(f + ta % P) * a.R * ns;
      const float* tap =
          ta >= d ? a.ring + (size_t)(f + (ta - d) % P) * a.R * ns : nullptr;
      const int M2 = a.Rp + a.Sp;
      // the gate products: z = [tap | h | c_t] @ W1[l] + b1[l]; a tile's
      // rows 0-15 are the tanh rows and 16-31 the sigmoid rows of the
      // same 16 channels
      {
        const Src src{{tap, cur,
                       a.cond ? a.cond + (size_t)t * a.M * ns : nullptr},
                      {a.R, a.R, a.M}};
        const float* W1 = a.W1 + (size_t)l * a.M1p * a.K1p;
        const float* b1 = a.b1 + (size_t)l * a.M1p;
        const int tiles = (a.M1p / BM) * ntn;
        for (int i = bid; i < tiles; i += nb) {
          const int mt = i / ntn, n0 = (i % ntn) * BN;
          float acc[2][2][4];
          if (!tile_mma<false>(W1, a.K1p, mt * BM, src, n0, ns, smem, acc))
            continue;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i2 = 0; i2 < 4; ++i2) {
              const int r = (lane >> 2) + 8 * (i2 >> 1), ch = mt * 16 + r;
              const int n =
                  n0 + (warp & 3) * 16 + j * 8 + 2 * (lane & 3) + (i2 & 1);
              if (ch < a.D && n < ns) {
                const float zt = acc[0][j][i2] + b1[mt * BM + r];
                const float zs = acc[1][j][i2] + b1[mt * BM + 16 + r];
                a.U[(size_t)ch * ns + n] = tanhf(zt) * sigmoidf_(zs);
              }
            }
        }
      }
      mark(PH_GATE);
      sync();
      // the residual rows (h of layer l + 1, into its ring slot) and, on a
      // step with the head, the skip rows
      {
        const bool last = l + 1 == a.L;
        const int lo = last ? a.Rp / BM : 0;
        const int hi = head ? (a.Rp + a.Sp) / BM : (last ? lo : a.Rp / BM);
        float* nxt = last ? nullptr
                          : a.ring + (size_t)(a.meta[3 * l + 5] +
                                              ta % a.meta[3 * l + 4]) *
                                         a.R * ns;
        const Src src{{a.U, nullptr, nullptr}, {a.D, 0, 0}};
        const float* W2 = a.W2 + (size_t)l * M2 * a.K2p;
        const float* b2 = a.b2 + (size_t)l * M2;
        const int tiles = (hi - lo) * ntn;
        for (int i = bid; i < tiles; i += nb) {
          const int mt = lo + i / ntn, n0 = (i % ntn) * BN;
          float acc[2][2][4];
          if (!tile_mma<false>(W2, a.K2p, mt * BM, src, n0, ns, smem, acc))
            continue;
          each(acc, mt * BM, n0, [&](int row, int n, float x) {
            if (n >= ns) return;
            const float v = x + b2[row];
            if (row < a.Rp) {
              if (row < a.R)
                nxt[(size_t)row * ns + n] = cur[(size_t)row * ns + n] + v;
            } else if (row - a.Rp < a.S) {
              float* p = a.skip + (size_t)(row - a.Rp) * ns + n;
              *p = (l == 0 ? 0.f : *p) + v;
            }
          });
        }
        mark(PH_OUT);
        if (last && !head) {
          for (int n = wid; n < ns; n += nwarps)
            advance_lane(a, n, lane, t, ta, 0);
          mark(PH_INPUT);
        }
      }
      sync();
    }
    if (!head) continue;
    // end1: y = relu(relu(skip) @ E1 + be1)
    {
      const Src src{{a.skip, nullptr, nullptr}, {a.S, 0, 0}};
      const int tiles = (a.Ep / BM) * ntn;
      for (int i = bid; i < tiles; i += nb) {
        const int mt = i / ntn, n0 = (i % ntn) * BN;
        float acc[2][2][4];
        if (!tile_mma<true>(a.E1, a.K3p, mt * BM, src, n0, ns, smem, acc))
          continue;
        each(acc, mt * BM, n0, [&](int e, int n, float x) {
          if (e < a.E && n < ns)
            a.Y[(size_t)e * ns + n] = fmaxf(x + a.be1[e], 0.f);
        });
      }
    }
    mark(PH_END1);
    sync();
    // end2: the logits, lane-major for the sampling's reads
    {
      const Src src{{a.Y, nullptr, nullptr}, {a.E, 0, 0}};
      const int tiles = (a.Cp / BM) * ntn;
      for (int i = bid; i < tiles; i += nb) {
        const int mt = i / ntn, n0 = (i % ntn) * BN;
        float acc[2][2][4];
        if (!tile_mma<false>(a.E2, a.K4p, mt * BM, src, n0, ns, smem, acc))
          continue;
        each(acc, mt * BM, n0, [&](int k, int n, float x) {
          if (k < a.C && n < ns) a.logits[(size_t)n * a.C + k] = x + a.be2[k];
        });
      }
    }
    mark(PH_END2);
    sync();
    for (int n = wid; n < ns; n += nwarps)
      advance_lane(a, n, lane, t, ta, sample_lane(a, n, lane, ta));
    mark(PH_SAMPLE);
    sync();
  }
  if (timed)
    for (int i = 0; i < NPHASE; ++i) a.timers[i] += tacc[i];
}

}  // namespace

extern "C" {

// ptrs: A0, A1, a, W1, b1, W2, b2, E1, be1, E2, be2, cond, temps, seeds,
// toffs, prime, meta, ring, out, U, skip, Y, logits, cur, bar, timers.
// ints: streams, num_given, total, t0, L, R, D, S, E, C, M, M1p, K1p, Rp,
// Sp, K2p, Ep, K3p, Cp, K4p, extra_row, seed, lane_seed, head_from; streams
// a multiple of 4. One block an SM. Returns a CUDA error code (0 on
// success).
int wavenet_gen_wide(void* const* ptrs, const int* ints, float regularize,
                     cudaStream_t stream) {
  Args a;
  a.A0 = (const float*)ptrs[0];
  a.A1 = (const float*)ptrs[1];
  a.a = (const float*)ptrs[2];
  a.W1 = (const float*)ptrs[3];
  a.b1 = (const float*)ptrs[4];
  a.W2 = (const float*)ptrs[5];
  a.b2 = (const float*)ptrs[6];
  a.E1 = (const float*)ptrs[7];
  a.be1 = (const float*)ptrs[8];
  a.E2 = (const float*)ptrs[9];
  a.be2 = (const float*)ptrs[10];
  a.cond = (const float*)ptrs[11];
  a.temps = (const float*)ptrs[12];
  a.seeds = (const int*)ptrs[13];
  a.toffs = (const int*)ptrs[14];
  a.prime = (const int*)ptrs[15];
  a.meta = (const int*)ptrs[16];
  a.ring = (float*)ptrs[17];
  a.out = (int*)ptrs[18];
  a.U = (float*)ptrs[19];
  a.skip = (float*)ptrs[20];
  a.Y = (float*)ptrs[21];
  a.logits = (float*)ptrs[22];
  a.cur = (int*)ptrs[23];
  a.bar = (unsigned long long*)ptrs[24];
  a.timers = (unsigned long long*)ptrs[25];
  int i = 0;
  a.streams = ints[i++];
  a.num_given = ints[i++];
  a.total = ints[i++];
  a.t0 = ints[i++];
  a.L = ints[i++];
  a.R = ints[i++];
  a.D = ints[i++];
  a.S = ints[i++];
  a.E = ints[i++];
  a.C = ints[i++];
  a.M = ints[i++];
  a.M1p = ints[i++];
  a.K1p = ints[i++];
  a.Rp = ints[i++];
  a.Sp = ints[i++];
  a.K2p = ints[i++];
  a.Ep = ints[i++];
  a.K3p = ints[i++];
  a.Cp = ints[i++];
  a.K4p = ints[i++];
  a.extra_row = ints[i++];
  a.seed = ints[i++];
  a.lane_seed = ints[i++];
  a.head_from = ints[i++];
  a.regularize = regularize;

  if (a.streams % 4 != 0) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)wide_step_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, SMEM_BYTES)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if ((err = cudaMemsetAsync(a.bar, 0, sizeof(unsigned long long),
                             stream)) != cudaSuccess)
    return (int)err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3(sms), dim3(THREADS), params,
                                    SMEM_BYTES, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
