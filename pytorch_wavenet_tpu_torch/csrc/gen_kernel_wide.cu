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
// products whose batch is the pool's lanes, [tap | c_t | h] (2R + M) x 2D
// and u D x (R + S), then the head: 88.5 MFLOP a lane-step at wnv512,
// 22.7 GFLOP a step at 256 lanes, 45.8 us at the TF32 peak and three
// times that (138 us) as the 3xTF32 products that hold f32 accuracy; the
// weights read each step with their pre-split low parts (356 MB, 106 us at
// 3.35 TB/s); and 2L + 3 phases a step, each depending on the one before
// across the whole grid, so that each pays a grid barrier and a pipeline
// fill that the design has to hide. On an H100 the 256-lane step takes
// about 745 us (PERF.md): the gate products 446 of it, about 0.9 us a
// 64-deep stage against 0.2 us of tensor-core work, for with one step's
// products in flight each step waits on the next step's loads and split;
// the 2L + 3 barriers take 48.
//
// What the design does about it: ONE persistent cooperative launch a call,
// one CTA an SM (two consumer warpgroups and a producer warpgroup, which
// hands registers to the consumers: setmaxnreg 88 / 208), in clusters
// of 2 along the weight rows; the phases (the gate products; the residual
// and skip products, h of layer l+1 written straight into its ring slot;
// end1; end2; the sampling; 2L for a teacher-forced step, which skips the
// skip rows and the head) meet at grid barriers on one counter. Each
// product splits into tiles of 64 lanes x 32 weight rows (lanes on wgmma's
// M, rows on its N):
//  - one producer thread fills a 6-stage ring of 64-deep stages with bulk
//    copies completing on an mbarrier a stage: the tile's 32 rows of
//    weights, pre-split into TF32 hi and lo by the wrapper's `pack` and
//    laid out as wgmma's K-major B image of each stage (4 KB a copy), and
//    the lanes' rows, two 32-lane boxes of a tensor map (128-byte
//    swizzled), which the cluster's two CTAs (the same lanes, other weight
//    rows) load once between them, each multicasting one box to both;
//  - the two consumer warpgroups each take half of every stage's depth:
//    for each 8-deep step a warpgroup reads its lanes' values into
//    registers, splits them into TF32 hi and lo there (tf32.cuh), and
//    issues wgmma m64n32k8 three times, a_lo b_hi, a_hi b_lo and a_hi
//    b_hi, each into its own sum (three independent chains); a step's
//    products run while the next step's values load (wgmma.wait_group 1),
//    and a stage goes back to the producers of both CTAs (an mbarrier
//    arrival in each) once its last step is done. No __syncthreads sits in
//    the loop; its waits and arrivals are asm without branches, so that
//    ptxas keeps the wgmma asynchronous;
//  - the grid barriers are split: the consumers only arrive (their writes
//    fenced for the async proxy) and go on; a producer waits for the count
//    before it copies what the phase before wrote. The gate's K runs tap,
//    conditioning rows, h: the taps (written steps before) and the
//    conditioning rows wait for no barrier, so 9 of a gate tile's 17
//    stages load and multiply while the grid still finishes the residual
//    products; a stage's weights are copied up to 5 stages ahead, into the
//    phase before. The consumers wait at a barrier only where they read
//    what other blocks wrote with plain loads: before the sampling (the
//    logits) and after each write of input rows (layer 0's residual
//    product reads them back); and a block that took part in no tile of a
//    phase waits for the barrier before it arrives at the next, so that
//    the count holds one barrier's arrivals at a time. A row tile falls to
//    the same CTA in every phase, so an epilogue reads back (the residual,
//    the skip sums) only what its own thread wrote.
// The gate rows are packed so a tile holds the tanh and sigmoid rows of
// the same 8 channels: u is made in registers.
//
// Tile plan by lane count: the lanes split into tiles of 64, the last one
// ragged (a 32-lane box wholly past the lanes is not copied; lanes past
// them read zeros), the streams padded to a multiple of 4 for 16-byte
// copies; the cluster size, 2 or 1, is the larger that runs the gate's
// tiles in the fewest rounds over the clusters the card holds at once. At
// 256 lanes and wnv512: 32 row tiles x 4 lane tiles, 64 cluster tiles on
// 66 clusters of 2 (132 SMs); residual + skip 48, the head 16. Few lanes
// leave most CTAs without tiles: one lane streams the weights through 32.
//
// Every sum's order is fixed by the configuration alone: a product sums
// its 8-deep wgmma steps in order over the padded depth, each of the three
// terms apart, then (a_lo b_hi + a_hi b_lo) + a_hi b_hi, the first
// warpgroup's half of the depth before the second's, so a lane's classes
// and ring are the same bits at any lane count, tile, cluster or grid
// size.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gen_common.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace {

constexpr int CONSUMERS = 256;  // two warpgroups; then the producer's
constexpr int THREADS = CONSUMERS + 128;
constexpr int WARPS = CONSUMERS / 32;  // the warps of the lane-wise phases
constexpr int BL = 64;      // lanes of a tile: wgmma's M
constexpr int BR = 32;      // weight rows of a tile: wgmma's N
constexpr int KC = 64;      // depth of a stage: 4 wgmma steps a warpgroup
constexpr int BOX = 32;     // lanes of a box: one 128-byte swizzle row
constexpr int STAGES = 6;
constexpr int A_TILE = KC * BL;   // floats: 2 boxes of 64 rows x 32 lanes
constexpr int W_TILE = BR * KC;   // floats, one of hi / lo
constexpr int GROUP = 8 * KC;     // floats: 8 rows of a stage
constexpr int XCH = 16 * 128;     // floats: a warpgroup's sums of a tile
constexpr int SMEM_BYTES =
    (STAGES * (A_TILE + 2 * W_TILE) + XCH) * 4 + 2 * STAGES * 8 + 1024;
constexpr int MAX_CLUSTER = 2;
// registers a thread: the producer warpgroup's, the consumers' (128 x 88
// + 256 x 208 = 64,512 of the SM's 65,536; ptxas then spills in neither)
constexpr int PRODUCER_REGS = 88, CONSUMER_REGS = 208;

// the phases of a step that `timers` accumulates (ns, block 0's view)
enum { PH_GATE, PH_OUT, PH_BAR, PH_INPUT, PH_END1, PH_END2, PH_SAMPLE,
       NPHASE };

// the lanes' operands as the copies read them: (streams, rows, slots)
// boxes of 32 lanes x 64 rows, 128-byte swizzled
enum { MAP_RING, MAP_COND, MAP_U, MAP_SKIP, MAP_Y, NMAP };

struct Args {
  CUtensorMap maps[NMAP];
  const float *A0, *A1, *a;    // input taps (C, R) (A0 may be null), bias (R)
  const float *W1, *b1;        // (L, 2, K1p/KC, M1p/8, KC/4, 8, 4), (L, M1p)
  const float *W2, *b2;        // (L, 2, K2p/KC, (Rp+Sp)/8, ...), (L, Rp + Sp)
  const float *E1, *be1;       // (2, K3p/KC, Ep/8, ...), (Ep)
  const float *E2, *be2;       // (2, K4p/KC, Cp/8, ...), (Cp)
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
  int seed, lane_seed, head_from, slots;
  float regularize;
};

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// the thread's warp, known to the compiler to be the same across the warp
__device__ __forceinline__ int warp_id() {
  return __shfl_sync(0xffffffffu, (int)(threadIdx.x >> 5), 0);
}

// A part of a product's lanes' operand: `rows` rows of slot `slot` of a
// map (slot -1 reads zeros); each part takes its rows rounded up to KC
// of the product's depth, the rows past it read zeros too.
struct Part {
  const CUtensorMap* map;
  int rows, slot;
  bool dep;  // written by the phase before: its copies wait for the grid
};

// One product's phase: rows [rt0, rt0 + nrt) tiles of BR of the packed
// weights W (hi, then lo) of Mp rows and depth Kp, times the lanes'
// operand made of parts.
struct Prod {
  const float* W;
  int Mp, Kp, rt0, nrt;
  Part part[3];
};

// Where this CTA stands: its shared memory, barriers and the stage counter
// that its producer and consumers each advance in the same order.
struct Pipe {
  float* As;       // STAGES x A_TILE, 1024-byte aligned
  float* Ws;       // STAGES x 2 W_TILE
  uint64_t* full;  // STAGES: the producer's arrival and the copies' bytes
  uint64_t* empty; // STAGES: every consumer warp of the cluster
  float* X;        // XCH: the second warpgroup's sums, for the first
  unsigned it;     // stages walked so far
  int cs, rank, cluster, clusters;
  int g0, g1;      // the boxes of a stage's lanes' rows this CTA copies
};


__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// The consumers' arrival at a grid barrier: this block's writes before it
// made visible to every block, to their copies (the async proxy) too,
// then one arrival on the grid's count. The consumers go on to the next
// phase at once: what in it depends on other blocks' writes arrives by
// copies, which the producers issue after the count (wait_grid).
__device__ __forceinline__ void grid_arrive(unsigned long long* bar) {
  fence_proxy_async_global();
  consumers_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1ull);
  }
}

// until every block has arrived `target` times in all; reads after it see
// their writes before it
__device__ __forceinline__ void poll_grid(unsigned long long* bar,
                                          unsigned long long target) {
  unsigned long long v;
  do {
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                 : "=l"(v)
                 : "l"(bar)
                 : "memory");
  } while (v < target);
}

// The producer's wait for the grid before a copy of what the phase before
// wrote.
__device__ __forceinline__ void wait_grid(unsigned long long* bar,
                                          unsigned long long target) {
  poll_grid(bar, target);
  fence_proxy_async_global();
}

// The consumers' wait for the grid (the sampling's reads of the logits).
__device__ __forceinline__ void grid_wait(unsigned long long* bar,
                                          unsigned long long target) {
  if (threadIdx.x == 0) {
    poll_grid(bar, target);
    __threadfence();
  }
  consumers_sync();
}

// The cluster tiles of a product, numbered over all its rows so that a
// row tile falls to the same CTA in every phase of the product (an
// epilogue reads back what the same thread wrote there before): lane
// tiles fastest, then groups of `cs` row tiles, one a CTA of the cluster;
// cluster tile ct is cluster ct % clusters'. A phase takes the row tiles
// [rt0, rt0 + nrt): its cluster tiles [ct0, ct1); a CTA whose row tile
// lies outside them takes part with no rows.
struct Span {
  int ct0, ct1, nlt;
};

__device__ __forceinline__ Span span_of(const Pipe& p, int rt0, int nrt,
                                        int streams) {
  const int nlt = (streams + BL - 1) / BL;
  return Span{rt0 / p.cs * nlt, (rt0 + nrt + p.cs - 1) / p.cs * nlt, nlt};
}

// this cluster's first cluster tile at or after ct0
__device__ __forceinline__ int first_tile(const Pipe& p, int ct0) {
  return ct0 + ((p.cluster - ct0) % p.clusters + p.clusters) % p.clusters;
}

// this CTA's row tile of cluster tile ct, or -1
__device__ __forceinline__ int row_tile(const Pipe& p, int ct, int nlt,
                                        int rt0, int nrt) {
  const int rt = ct / nlt * p.cs + p.rank;
  return rt >= rt0 && rt < rt0 + nrt ? rt : -1;
}

// Calls f(row tile or -1, first lane) for each tile this CTA takes part
// in, in the same order on every CTA of the cluster.
template <class F>
__device__ __forceinline__ void each_tile(const Pipe& p, int rt0, int nrt,
                                          int streams, F f) {
  const Span sp = span_of(p, rt0, nrt, streams);
  for (int ct = first_tile(p, sp.ct0); ct < sp.ct1; ct += p.clusters)
    f(row_tile(p, ct, sp.nlt, rt0, nrt), ct % sp.nlt * BL);
}

// A stage of a phase as the producer walks it: its tile and depth, and
// the part of the lanes' operand it reads. Advanced in order, without
// divisions.
struct Cursor {
  int ct, kc, rt, n0, pi, pk;  // cluster tile, stage, row tile, lane, part
};

// The producer's side of a phase (one thread): for each stage of each
// tile, wait until every consumer warp of the cluster has released the
// buffer, copy this tile's weights and this CTA's boxes of the lanes' rows
// to every CTA of the cluster (boxes [g0, g1) of a stage's 2). The weights
// run up to STAGES stages ahead of the rows, into the phase before's last
// stages; the rows of a part that the phase before wrote wait for the
// grid (`target`, the consumers' count), those of any other part (the
// gate's taps and conditioning rows) do not.
__device__ void produce(const Prod& q, Pipe& p, int streams,
                        unsigned long long* bar, unsigned long long target) {
  const int nk = q.Kp / KC;
  const Span sp = span_of(p, q.rt0, q.nrt, streams);
  const int nlt = sp.nlt;
  if (first_tile(p, sp.ct0) >= sp.ct1) return;
  const uint16_t mask = (uint16_t)((1u << p.cs) - 1);
  const size_t wstride = (size_t)q.Mp * q.Kp;  // hi to lo
  const size_t kstride = (size_t)(q.Mp / 8) * GROUP;  // a stage's weights
  auto at = [&](Cursor& c) {  // a new tile
    c.kc = c.pi = c.pk = 0;
    c.rt = row_tile(p, c.ct, nlt, q.rt0, q.nrt);
    c.n0 = c.ct % nlt * BL;
  };
  auto next = [&](Cursor& c) {
    c.pk += KC;
    while (c.pi < 3 && c.pk >= q.part[c.pi].rows) {  // parts may be empty
      c.pk = 0;
      ++c.pi;
    }
    if (++c.kc == nk) {
      c.ct += p.clusters;
      if (c.ct < sp.ct1) at(c);
    }
  };
  auto boxes = [&](const Cursor& c) {
    return min(BL / BOX, (streams - c.n0 + BOX - 1) / BOX);
  };
  // a stage: its buffer free, its bytes expected, its weights copied
  auto weights = [&](const Cursor& c, unsigned it) {
    const int b = it % STAGES;
    mbar_wait(&p.empty[b], ((it / STAGES) & 1) ^ 1);
    mbar_arrive_tx(&p.full[b], (unsigned)boxes(c) * KC * BOX * 4 +
                                   (c.rt >= 0 ? 2 * W_TILE * 4 : 0));
    if (c.rt >= 0) {
      float* ws = p.Ws + b * 2 * W_TILE;
      const float* w =
          q.W + (size_t)c.kc * kstride + (size_t)c.rt * (BR / 8) * GROUP;
      bulk_load(ws, w, W_TILE * 4, &p.full[b]);
      bulk_load(ws + W_TILE, w + wstride, W_TILE * 4, &p.full[b]);
    }
  };
  // a stage: this CTA's boxes of the lanes' rows
  auto rows = [&](const Cursor& c, unsigned it) {
    const int b = it % STAGES, nbox = boxes(c);
    const Part& pt = q.part[c.pi];
    float* as = p.As + b * A_TILE;
    for (int g = p.g0; g < p.g1 && g < nbox; ++g)
      tma_load_3d_multicast(as + g * KC * BOX, pt.map, c.n0 + g * BOX, c.pk,
                            pt.slot, &p.full[b], mask);
  };
  Cursor c{first_tile(p, sp.ct0), 0, 0, 0, 0, 0};
  at(c);
  Cursor r = c;
  unsigned it = p.it, rit = p.it;
  bool waited = false;
  while (r.ct < sp.ct1) {
    // (a stage's buffer comes free once the consumers have the next
    // stage's data: the weights run at most STAGES - 1 ahead)
    for (; c.ct < sp.ct1 && it - rit < STAGES - 1; next(c)) weights(c, it++);
    if (!waited && q.part[r.pi].dep) {
      wait_grid(bar, target);
      waited = true;
    }
    rows(r, rit++);
    next(r);
  }
  p.it = it;
}

// Where a thread's A values of an 8-deep step lie in a stage's boxes of
// the lanes' rows, for its 4 values (a0-a3): wgmma's logical k = t reads
// the stage's row 8s + 2t and k = t + 4 row 8s + 2t + 1 (`pack` orders
// the weights' K so), which keeps the 128-byte swizzled reads free of bank
// conflicts; the offsets do not depend on the step s (+ 8 s rows).
__device__ __forceinline__ void a_offsets(int l0, int (&off)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int l = l0 + g;                      // a0, a2; a1, a3: l + 8
  const int c = (l & 31) >> 2, e = l & 3;    // 16-byte chunk, its word
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = 2 * t + (i >> 1);
    const int cc = c + 2 * (i & 1);
    off[i] = (l >> 5) * KC * BOX + k * BOX + (((cc ^ k) << 2) | e);
  }
}

// step s's A values, split into TF32 hi and lo
template <bool RELU>
__device__ __forceinline__ void load_a(const float* as, const int (&off)[4],
                                       int s, unsigned (&h)[4],
                                       unsigned (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x = as[8 * s * BOX + off[i]];
    if (RELU) x = fmaxf(x, 0.f);
    tf32_split(x, h[i], lo[i]);
    reg_fence(h[i]);
    reg_fence(lo[i]);
  }
}

// A warpgroup's sums of a tile: a_lo b_hi, a_hi b_lo and a_hi b_hi, each
// its own chain of wgmma.
constexpr int NACC = 3;

// Issues a warpgroup's products of one 8-deep step s as one group, each
// term into its own sum (three independent chains of wgmma).
__device__ __forceinline__ void issue_step(float (&acc)[NACC][16],
                                           const float* ws, int s,
                                           const unsigned (&h)[4],
                                           const unsigned (&lo)[4]) {
  const uint64_t dh = gmma_desc(ws + s * 64, 128, 2048);
  const uint64_t dl = gmma_desc(ws + W_TILE + s * 64, 128, 2048);
  wgmma_fence();
  wgmma_tf32_n32(acc[0], lo, dh);
  wgmma_tf32_n32(acc[1], h, dl);
  wgmma_tf32_n32(acc[2], h, dh);
  wgmma_commit();
}


// a warpgroup's sum of a tile: the cross terms, then the main term
__device__ __forceinline__ float acc_sum(const float (&acc)[NACC][16],
                                         int e) {
  return (acc[0][e] + acc[1][e]) + acc[2][e];
}


// where element e of a thread's tile fragment lies: rows 8 apart in
// groups of 4 (e % 8 < 4 and the next 4 are rows r and r + 8), lanes 8
// apart
__device__ __forceinline__ int row_of(int e) {
  return 8 * (e >> 2) + (e & 1);
}

__device__ __forceinline__ int lane_of(int e) { return 8 * ((e >> 1) & 1); }

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(CONSUMERS) : "memory");
}

// The consumers' side of a phase: for each tile, 64 lanes x 32 rows, each
// warpgroup summing its half of every stage's depth (the first warpgroup
// steps 0-3, the second 4-7); a step's products run while the next step's
// A values load (two register sets). The second warpgroup hands
// its sums to the first, which adds them after its own and calls post(r0,
// n, x) with the 16 elements it holds: x[e] is row r0 + row_of(e) (in the
// product's packed rows) of lane n + lane_of(e); pre(r0, n) runs at the
// tile's start, for the epilogue's reads. A tile with no lanes or rows
// only passes the stages on. Returns whether this CTA took part in a tile.
template <bool RELU, class Pre, class Post>
__device__ __forceinline__ bool consume(const Prod& q, Pipe& p, int streams,
                                        Pre pre, Post post) {
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_id();
  const int g = lane >> 2, t = lane & 3;
  const int v = warp >> 2, w4 = warp & 3;
  const int nk = q.Kp / KC, s0 = 4 * v;
  const int l0 = 16 * w4;  // the warp's first lane in the tile
  int off[4];
  a_offsets(l0, off);
  float* xch = p.X + w4 * 32 + lane;  // element i at xch[128 i]
  auto full = [&]() {
    const int b = p.it % STAGES;
    mbar_wait(&p.full[b], (p.it / STAGES) & 1);
    ++p.it;
    return b;
  };
  auto release = [&](int b) {
    __syncwarp();
    mbar_arrive_remote(&p.empty[b], lane, lane < p.cs);
  };
  each_tile(p, q.rt0, q.nrt, streams, [&](int rt, int n0) {
    if (rt < 0 || n0 >= streams) {
      for (int kc = 0; kc < nk; ++kc) release(full());
      return;
    }
    const int r0 = rt * BR + 2 * t, n = n0 + l0 + g;
    if (v == 0) pre(r0, n);
    float acc[NACC][16];
#pragma unroll
    for (int c = 0; c < NACC; ++c)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[c][i] = 0.f;
    // a step: its lanes' values into registers and split, its products
    // issued; then the step before it done (wgmma.wait_group 1), which
    // frees the other register set: a step's products run while the next
    // step's values load
    unsigned h0[4], lo0[4], h1[4], lo1[4];
    auto step = [&](int b, int s, unsigned (&h)[4], unsigned (&lo)[4]) {
      load_a<RELU>(p.As + b * A_TILE, off, s, h, lo);
      issue_step(acc, p.Ws + b * 2 * W_TILE, s, h, lo);
      wgmma_wait<1>();
    };
    int b0 = full();
    step(b0, s0, h0, lo0);
    step(b0, s0 + 1, h1, lo1);
    step(b0, s0 + 2, h0, lo0);
    step(b0, s0 + 3, h1, lo1);
    for (int kc = 1; kc < nk; ++kc) {
      const int b1 = full();
      step(b1, s0, h0, lo0);
      release(b0);  // its last step done
      step(b1, s0 + 1, h1, lo1);
      step(b1, s0 + 2, h0, lo0);
      step(b1, s0 + 3, h1, lo1);
      b0 = b1;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NACC; ++c)
#pragma unroll
      for (int i = 0; i < 16; ++i) reg_fence(acc[c][i]);
    release(b0);
    if (v == 1) {
#pragma unroll
      for (int e = 0; e < 16; ++e) xch[128 * e] = acc_sum(acc, e);
    }
    named_sync(2);
    if (v == 0) {
      float x[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) x[e] = acc_sum(acc, e) + xch[128 * e];
      post(r0, n, x);
    }
    named_sync(3);
  });
  const Span sp = span_of(p, q.rt0, q.nrt, streams);
  return first_tile(p, sp.ct0) < sp.ct1;
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

// The products of a step, for the producer and the consumers alike.
// Gate products of layer l at step t: z = [tap | c_t | h] @ W1[l] + b1[l];
// each 16 rows of a tile are the tanh rows and then the sigmoid rows of
// the same 8 channels, so a thread holds both of each of its channels.
__device__ __forceinline__ Prod gate_prod(const Args& a, int t, int l) {
  const int ta = a.t0 + t;
  const int d = a.meta[3 * l], P = a.meta[3 * l + 1], f = a.meta[3 * l + 2];
  const CUtensorMap* ring = &a.maps[MAP_RING];
  return Prod{a.W1 + (size_t)l * 2 * a.M1p * a.K1p, a.M1p, a.K1p, 0,
              a.M1p / BR,
              {{ring, a.R, ta >= d ? f + (ta - d) % P : -1, false},
               {a.cond ? &a.maps[MAP_COND] : ring, a.M, a.cond ? t : -1,
                false},
               {ring, a.R, f + ta % P, true}}};
}

// The residual rows (h of layer l + 1) and, on a step with the head, the
// skip rows.
__device__ __forceinline__ Prod out_prod(const Args& a, int l, bool head) {
  const bool last = l + 1 == a.L;
  const int lo = last ? a.Rp / BR : 0;
  const int hi = head ? (a.Rp + a.Sp) / BR : (last ? lo : a.Rp / BR);
  const int M2 = a.Rp + a.Sp;
  return Prod{a.W2 + (size_t)l * 2 * M2 * a.K2p, M2, a.K2p, lo, hi - lo,
              {{&a.maps[MAP_U], a.D, 0, true}}};
}

// end1: y = relu(relu(skip) @ E1 + be1); end2: the logits
__device__ __forceinline__ Prod end1_prod(const Args& a) {
  return Prod{a.E1, a.Ep, a.K3p, 0, a.Ep / BR,
              {{&a.maps[MAP_SKIP], a.S, 0, true}}};
}

__device__ __forceinline__ Prod end2_prod(const Args& a) {
  return Prod{a.E2, a.Cp, a.K4p, 0, a.Cp / BR,
              {{&a.maps[MAP_Y], a.E, 0, true}}};
}

// The producer thread's walk through the call: every phase's copies, the
// lanes' rows of each after the consumers' grid barrier before it.
__device__ void producer_loop(const Args& a, Pipe& p) {
  const unsigned long long nb = gridDim.x;
  unsigned long long target = nb;  // after the first input rows
  for (int t = 0; t < a.total; ++t) {
    const bool head = t >= a.head_from;
    for (int l = 0; l < a.L; ++l) {
      produce(gate_prod(a, t, l), p, a.streams, a.bar, target);
      target += nb;
      produce(out_prod(a, l, head), p, a.streams, a.bar, target);
      target += nb;
    }
    if (!head) continue;
    produce(end1_prod(a), p, a.streams, a.bar, target);
    target += nb;
    produce(end2_prod(a), p, a.streams, a.bar, target);
    target += 2 * nb;  // and the sampling's
  }
}

// The consumers' walk through the call (two warpgroups): the lane-wise
// phases, each product's tiles and their epilogues, and the grid barriers.
__device__ __forceinline__ void consumer_loop(const Args& a, Pipe& p) {
  const int warp = warp_id(), lane = threadIdx.x & 31;
  const int nb = gridDim.x, bid = blockIdx.x;
  const int ns = a.streams;
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
  // a grid barrier, the consumers' side: arrive; and wait too where they
  // read what other blocks wrote: the logits, before the sampling, and the
  // input rows, which layer 0's residual product reads back
  // A block that took part in no tile of the phase first waits for the
  // barrier before (every other block's copies did): the count has to
  // hold one barrier's arrivals at a time.
  auto sync = [&](bool wait = false, bool idle = false) {
    if (idle) grid_wait(a.bar, target);
    grid_arrive(a.bar);
    target += nb;
    if (wait) grid_wait(a.bar, target);
    mark(PH_BAR);
  };

  bool busy = true;  // this block took part in the phase's tiles
  for (int n = wid; n < ns; n += nwarps) input_lane(a, n, lane);
  mark(PH_INPUT);
  sync(true);  // the residual product of layer 0 reads the input rows back

  for (int t = 0; t < a.total; ++t) {
    const int ta = a.t0 + t;
    const bool head = t >= a.head_from;
    for (int l = 0; l < a.L; ++l) {
      const int P = a.meta[3 * l + 1], f = a.meta[3 * l + 2];
      const float* cur = a.ring + (size_t)(f + ta % P) * a.R * ns;
      {
        const float* b1 = a.b1 + (size_t)l * a.M1p;
        float bias[16];
        busy = consume<false>(
            gate_prod(a, t, l), p, ns,
            [&](int r0, int n) {
#pragma unroll
              for (int e = 0; e < 16; ++e) bias[e] = b1[r0 + row_of(e)];
            },
            [&](int r0, int n, const float (&x)[16]) {
              // e % 8 < 4: tanh rows; e + 4 the sigmoid rows of the same
              // channels, each 16 rows a group of 8 channels
#pragma unroll
              for (int e = 0; e < 16; ++e) {
                if (e % 8 >= 4) continue;
                const int row = r0 + row_of(e);
                const int ch = (row >> 4) * 8 + (row & 7), m = n + lane_of(e);
                if (ch < a.D && m < ns)
                  a.U[(size_t)ch * ns + m] = tanhf(x[e] + bias[e]) *
                                             sigmoidf_(x[e + 4] + bias[e + 4]);
              }
            });
      }
      mark(PH_GATE);
      sync(false, !busy);
      {
        const bool last = l + 1 == a.L;
        float* nxt = last ? nullptr
                          : a.ring + (size_t)(a.meta[3 * l + 5] +
                                              ta % a.meta[3 * l + 4]) *
                                         a.R * ns;
        const int M2 = a.Rp + a.Sp;
        const float* b2 = a.b2 + (size_t)l * M2;
        // h of layer l + 1 (row < R) and the skip sums (Rp <= row < Rp +
        // S), their earlier values read at the tile's start
        float bias[16], old[16];
        busy = consume<false>(
            out_prod(a, l, head), p, ns,
            [&](int r0, int n) {
#pragma unroll
              for (int e = 0; e < 16; ++e) {
                const int row = r0 + row_of(e), m = n + lane_of(e);
                bias[e] = b2[row];
                old[e] = 0.f;
                if (m >= ns) continue;
                if (row < a.R)
                  old[e] = cur[(size_t)row * ns + m];
                else if (row >= a.Rp && row - a.Rp < a.S && l > 0)
                  old[e] = a.skip[(size_t)(row - a.Rp) * ns + m];
              }
            },
            [&](int r0, int n, const float (&x)[16]) {
#pragma unroll
              for (int e = 0; e < 16; ++e) {
                const int row = r0 + row_of(e), m = n + lane_of(e);
                if (m >= ns) continue;
                if (row < a.R)
                  nxt[(size_t)row * ns + m] = old[e] + (x[e] + bias[e]);
                else if (row >= a.Rp && row - a.Rp < a.S)
                  a.skip[(size_t)(row - a.Rp) * ns + m] =
                      old[e] + (x[e] + bias[e]);
              }
            });
        mark(PH_OUT);
        if (last && !head) {
          for (int n = wid; n < ns; n += nwarps)
            advance_lane(a, n, lane, t, ta, 0);
          mark(PH_INPUT);
        }
      }
      sync(l + 1 == a.L && !head, !busy);  // and after writing input rows
    }
    if (!head) continue;
    {
      float bias[16];
      busy = consume<true>(
          end1_prod(a), p, ns,
          [&](int r0, int) {
#pragma unroll
            for (int e = 0; e < 16; ++e) bias[e] = a.be1[r0 + row_of(e)];
          },
          [&](int r0, int n, const float (&x)[16]) {
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              const int row = r0 + row_of(e), m = n + lane_of(e);
              if (row < a.E && m < ns)
                a.Y[(size_t)row * ns + m] = fmaxf(x[e] + bias[e], 0.f);
            }
          });
    }
    mark(PH_END1);
    sync(false, !busy);
    // the logits, lane-major for the sampling's reads
    {
      float bias[16];
      busy = consume<false>(
          end2_prod(a), p, ns,
          [&](int r0, int) {
#pragma unroll
            for (int e = 0; e < 16; ++e) bias[e] = a.be2[r0 + row_of(e)];
          },
          [&](int r0, int n, const float (&x)[16]) {
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              const int row = r0 + row_of(e), m = n + lane_of(e);
              if (row < a.C && m < ns)
                a.logits[(size_t)m * a.C + row] = x[e] + bias[e];
            }
          });
    }
    mark(PH_END2);
    sync(true, !busy);  // the sampling reads every block's logits
    for (int n = wid; n < ns; n += nwarps)
      advance_lane(a, n, lane, t, ta, sample_lane(a, n, lane, ta));
    mark(PH_SAMPLE);
    sync(true);
  }
  if (timed)
    for (int i = 0; i < NPHASE; ++i) a.timers[i] += tacc[i];
  cluster_sync();
}

__global__ void __launch_bounds__(THREADS, 1)
    wide_step_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(1024) float smem_raw[];
  // the swizzled boxes want 1024-byte aligned buffers
  float* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023) / 4;
  const int warp = warp_id(), lane = threadIdx.x & 31;
  const int nb = gridDim.x, bid = blockIdx.x;
  Pipe p;
  p.As = smem;
  p.Ws = smem + STAGES * A_TILE;
  p.X = p.Ws + STAGES * 2 * W_TILE;
  p.full = (uint64_t*)(p.X + XCH);
  p.empty = p.full + STAGES;
  p.it = 0;
  {
    unsigned cs;
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(cs));
    p.cs = (int)cs;
  }
  p.rank = (int)cluster_rank();
  p.cluster = bid / p.cs;
  p.clusters = nb / p.cs;
  p.g0 = p.rank * (BL / BOX) / p.cs;
  p.g1 = (p.rank + 1) * (BL / BOX) / p.cs;
  // stale lanes' values must be finite: a tile's unused lanes multiply too
  for (int i = threadIdx.x; i < STAGES * (A_TILE + 2 * W_TILE); i += THREADS)
    smem[i] = 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&p.full[s], 1);
      mbar_init(&p.empty[s], (unsigned)(p.cs * WARPS));
    }
    mbar_init_fence();
  }
  fence_proxy_async();
  __syncthreads();
  cluster_sync();

  // one big branch (setmaxnreg wants paths that do not meet again): the
  // producer warpgroup gives up registers for the consumers' sums
  if (warp >= WARPS) {  // the producer warpgroup: one thread copies
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == WARPS && lane == 0) producer_loop(a, p);
    __syncwarp();
    // no CTA leaves while a peer may still arrive on its barriers
    cluster_sync();
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consumer_loop(a, p);
  }
}

// the largest clusters of each size (index) the card holds at once, found
// at first use
int max_clusters[MAX_CLUSTER + 1];

cudaError_t cluster_counts() {
  if (max_clusters[1] > 0) return cudaSuccess;
  const void* kernel = (const void*)wide_step_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  for (int cs = 1; cs <= MAX_CLUSTER; cs *= 2) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM_BYTES;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = cs;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    int n = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)) !=
        cudaSuccess)
      return err;
    max_clusters[cs] = n;
  }
  return max_clusters[1] > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The map of a (slots, rows, streams) f32 array for boxes of 32 lanes x KC
// rows of one slot, 128-byte swizzled (out-of-range reads give zeros).
int encode_map(CUtensorMap* m, const float* base, int streams, int rows,
               int slots) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (fn == nullptr || q != cudaDriverEntryPointSuccess)
      return (int)cudaErrorSymbolNotFound;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)streams,
                              (cuuint64_t)(rows > 0 ? rows : 1),
                              (cuuint64_t)(slots > 0 ? slots : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)streams * 4,
                                 (cuuint64_t)streams * 4 * dims[1]};
  const cuuint32_t box[3] = {BOX, KC, 1}, elem[3] = {1, 1, 1};
  const CUresult r =
      encode(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, (void*)base, dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {


// The cluster size and the grid the kernel takes for `streams` lanes and
// `gate_tiles` row tiles of the gate product: the larger cluster (2 or 1)
// that runs the gate's tiles in the fewest rounds. Returns a CUDA error
// code.
int wavenet_wide_plan(int streams, int gate_tiles, int* cs_out,
                      int* grid_out) {
  cudaError_t err = cluster_counts();
  if (err != cudaSuccess) return (int)err;
  const int nlt = (streams + BL - 1) / BL;
  int best = 0, best_rounds = 0;
  for (int cs = MAX_CLUSTER; cs >= 1; cs /= 2) {
    const int n = max_clusters[cs];
    if (n < 1) continue;
    const int tiles = (gate_tiles + cs - 1) / cs * nlt;
    const int rounds = (tiles + n - 1) / n;
    if (best == 0 || rounds < best_rounds) {
      best = cs;
      best_rounds = rounds;
    }
  }
  *cs_out = best;
  *grid_out = best * max_clusters[best];
  return 0;
}

// ptrs: A0, A1, a, W1, b1, W2, b2, E1, be1, E2, be2, cond, temps, seeds,
// toffs, prime, meta, ring, out, U, skip, Y, logits, cur, bar, timers.
// ints: streams, num_given, total, t0, L, R, D, S, E, C, M, M1p, K1p, Rp,
// Sp, K2p, Ep, K3p, Cp, K4p, extra_row, seed, lane_seed, head_from, slots
// (the ring's layer slots of R rows); streams a multiple of 4. One block
// an SM, in clusters along the weight rows.
// Returns a CUDA error code (0 on success).
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
  a.slots = ints[i++];
  a.regularize = regularize;

  if (a.streams % 4 != 0) return (int)cudaErrorInvalidValue;
  int e;
  if ((e = encode_map(&a.maps[MAP_RING], a.ring, a.streams, a.R, a.slots)) ||
      (e = encode_map(&a.maps[MAP_U], a.U, a.streams, a.D, 1)) ||
      (e = encode_map(&a.maps[MAP_SKIP], a.skip, a.streams, a.S, 1)) ||
      (e = encode_map(&a.maps[MAP_Y], a.Y, a.streams, a.E, 1)) ||
      (a.cond != nullptr && (e = encode_map(&a.maps[MAP_COND], a.cond,
                                            a.streams, a.M, a.total))))
    return e;
  int cs = 0, grid = 0;
  if ((e = wavenet_wide_plan(a.streams, a.M1p / BR, &cs, &grid)) != 0)
    return e;
  cudaError_t err;
  if ((err = cudaMemsetAsync(a.bar, 0, sizeof(unsigned long long),
                             stream)) != cudaSuccess)
    return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, wide_step_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
