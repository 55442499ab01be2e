// The generation core shared by kernels K1 (csrc/gen_kernel.cu) and K4
// (csrc/gen_kernel_hbm.cu), for Hopper (sm_90a): one thread block cluster
// of CS blocks (8 or 16 SMs) runs a tile of TL lanes ("streams") for every
// step of a call.
//
// What it computes, per lane and step t (absolute time ta = t0 + t):
//   h = w_start[cls] + b_start
//   per layer l (dilation d, period P = (k-1)d + 1):
//     ring_l[ta mod P] = h
//     z = [taps with ta >= lookback, h] @ w_tap[l] + b_in[l]
//     u = tanh(z[:D]) * sigmoid(z[D:]);  h += u @ w_res[l] + b_res[l]
//   row = sum_l (u_l @ w_skip[l] + b_skip[l])  (exact), or
//         [u_0 .. u_{L-1}] @ w_skip + sum_l b_skip[l]  (skip_slab)
//   logits = relu(relu(row) @ w_end1 + b_end1) @ w_end2 + b_end2 - reg
//   the sampled class: argmax(logits / T + gumbel) at T > 0, else
//   argmax(logits), first index on ties; fed back unless the prime runs.
// A teacher-forced step before `head_from` (the first step whose class the
// caller reads) runs without the head, in a kernel launched before the
// rest (launch): the chain and the ring writes only, no skip row, logits
// or sampling; its input for the next step is the prime's, and its
// out_cls entry holds that prime class. head_from = 0 runs the head on
// every step.
// fuse_res walks the chain with wf[l] = w_res[l] @ w_cur[l+1]:
//   z[l+1] = taps[l+1] + h[l] @ w_cur[l+1] + bf[l] + u[l] @ wf[l].
// Conditioning adds to z[l] beside the taps: local conditioning, in K1 a
// row cond[t][l][s] (2D) projected by the wrapper, in K4 the product
// cond_t[s] @ w_cond[l] (M x 2D) computed here; global conditioning a
// per-(layer, lane) row projected by the wrapper (gcond).
//
// The design, against what bounds a step on this card (a serial chain of
// L small products, then ~6.5 MB of skip and head weights at chaconne):
//  * The chain's weights are resident in the cluster's shared memory:
//    rank q owns gate channels c = q + j*CS (columns c and D + c of z) and
//    residual channels r = q + j*CS, and holds w_cur, the biases, w_res and
//    wf for those columns only (packed per rank by the Python wrapper). A
//    rank computes u and h for its channels and stores them into every
//    rank's shared memory (distributed shared memory); one cluster barrier
//    per layer under fuse_res (two on the exact path) makes them visible.
//    Each of those products is split over 8 threads by rows and reduced
//    with shuffles, so a layer's serial part is ~10 FMAs deep. A config
//    whose chain weights do not fit reads the same packed slices from L2.
//  * All taps of a step at once: a tap of step t looks back m >= 1 steps,
//    so as soon as step t-1's ring writes are done, rank q issues cp.async
//    copies of every tap row of the layers l = q (mod CS) for step t (0.0
//    through the zero-fill form where ta < m or the lane is empty, never
//    read), during the head of step t-1 (on a headless step nothing hides
//    the copies: they are issued right after the ring writes, which are
//    made as soon as the chain ends). At step t it waits once, computes
//    those layers' tap products for all 2D columns (weights from L2: off
//    the chain), and stores each into its owner's shared memory. The ring
//    writes of layer l are made by the same rank, so one block barrier
//    orders them before the next prefetch (a d = 1 layer reads at t+1 the
//    slot it wrote at t).
//  * Conditioning rides with the taps, off the chain: the step's rows are
//    copied with cp.async beside the tap rows (K1: the projected rows of
//    the rank's layers, nlt x 2D x TL; K4: the step's M x TL cond slab,
//    the same in every rank), into a slab of their own that is idle from
//    the tap products until the next prefetch, so one buffer suffices. The
//    tap products then add them: K1 the projected rows, K4 the product
//    with w_cond[l] (from L2) as M more rows after the taps, summed lane
//    by lane in row order; then the global rows (from L2).
//  * The skip row and the head are off the chain and split by output
//    columns across the cluster (blocks of 16 columns per rank); each
//    product's input row is gathered in every rank through distributed
//    shared memory, so a rank reads its 1/CS of the head's weights from L2
//    once per step. The head's products run on the tensor cores in
//    3xTF32 (mma.sync m16n8k8: 16 output columns as M, the tile's lanes as
//    N, three TF32 products per f32 product to hold f32 accuracy), each
//    m-tile's rows split over the block's idle warps, each warp keeping
//    8 k-steps of weight loads in flight. wgmma is not used: its TF32
//    form reads B only K-major from shared memory, and the slab of u is
//    stored lane-major for the chain. The argmax combines each rank's best
//    in rank order (first index on ties).
//  * Ring dtypes (K4; the RT template argument, compiled apart): f32
//    (RT 0), bf16 (1) or int8 (2, symmetric per layer). A tap row of a
//    narrow ring is TL elements of 2 or 1 bytes at any offset in the ring
//    (any stream count), so it is copied with 4-byte cp.async from the
//    word below its first byte on (the bytes past the ring's end
//    zero-filled) into the top of its layer's tap rows, which are idle
//    from the ring writes to the next step, and widened in place into the
//    f32 tap rows at the step's start: bf16 values, or int8 counts whose
//    dequant the host folded into the tap weights. The layout is the f32
//    ring's, so no width loses its resident chain. The ring write rounds h to bf16, or
//    stores clip(rint(h * qscale[l]), -127, 127). In-register and
//    shared-memory h stay f32 within the step, as on the TPU. Under
//    skip_slab the skip row's operands are rounded to bf16 (u as the head
//    reads the slab; w_skip by the host), so its product is one TF32
//    product, exact, in place of three.
// What still bounds a step (chip_smoke.py prints the split from the
// kernel's own timers, `timers`): the chain's latency, a cluster barrier
// and a few dependent shared-memory, shuffle and transcendental rounds per
// layer, about half of a step at 30 layers (nearly all of a headless
// one); then the head, where the 3xTF32 splits of both operands (the input
// rows once per m-tile) cost about what the tensor cores save over f32
// FMAs at 8-24 lanes, and its L2 reads.
// Summation order: every output of a chain product is the sum of KG = 8
// row groups (group g: rows g, g + 8, ..., in order; interleaved so the
// groups' shared-memory reads fall in different banks), combined by a
// fixed shuffle tree; a head product sums 8-row k-steps in order in a
// fixed number of contiguous groups of its rows, added in group order
// (head_cols). It depends on the config and the cluster size alone, never
// on TL, a lane's slot, the pool or t0: a lane's classes and ring are
// bitwise the same at any tile width (each kernel launches one cluster
// size: K4 8, K1 16).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "gen_common.cuh"
#include "tf32.cuh"

namespace gen_cluster {

namespace cg = cooperative_groups;

constexpr int NT = 512;             // threads per block
constexpr int KG = 8;               // row groups of every product
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory a block may use
constexpr int NPHASE = 7;           // timed phases of a step
constexpr int PART_ROWS = (NT / 32 - 1) * 16;  // head_cols' partial sums

struct Args {
  const float* w_start;  // (C, R)
  const float* b_start;  // (R)
  const float* chain;    // (CS, F): each rank's packed chain weights
  const float* w_skip;   // exact: w_out (L, D, S+R); skip_slab: (L*D, S)
  const float* b_skip;   // exact: b_out (L, S+R); skip_slab: (S)
  const float* w_end1;   // (S, E)
  const float* b_end1;   // (E)
  const float* w_end2;   // (E, C)
  const float* b_end2;   // (C)
  // conditioning, each null when absent: K1 cond (total, L, streams, 2D)
  // projected rows; K4 cond (total, M, streams) rows and w_cond (L, M,
  // 2D); gcond K1 (L, streams, 2D), K4 (L, 2D, streams)
  const float* cond;
  const float* w_cond;
  const float* gcond;
  const float* temps;    // (streams), or null: `temperature` for every lane
  const int* seeds;      // lane_seed: (streams)
  const int* toffs;      // lane_seed: (streams)
  const int* prime;      // (streams, num_given)
  const int* meta;       // (L, 3): dilation, period, ring offset
  void* ring;            // updated in place: f32, or (K4) bf16 or int8
  const float* qscale;   // int8 rings: (L) store scales 127 / scale_l
  int* out_cls;          // (streams, total)
  unsigned long long* timers;  // null, or (NPHASE,): ns per phase
  int streams, num_given, total, t0;
  int head_from;         // steps t < head_from skip the head (<= num_given-1)
  int L, k, R, D, S, E, C;
  int M, cond_rows;      // cond channels (K4); rows of the cond slab
  int CS, F, resident;
  float temperature, regularize;
  unsigned seed;
  int fuse_res, skip_slab, lane_seed;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Output columns per rank in the head: blocks of 16.
__host__ __device__ inline int col_block(int n, int CS) {
  return cdiv(cdiv(n, CS), 16) * 16;
}

// Packed chain weights of one rank (floats), the layout of the Python
// wrapper's pack_chain: nlt tap blocks ((k-1)R x 2D, the layers q + m*CS),
// then per layer: wc (R x 2ndm), bz (2ndm), wr (D x nrm), br (nrm) and,
// under fuse_res, wf (D x 2ndm). Column slot j < ndm is filter channel
// q + j*CS, slot ndm + j its gate channel; residual slot j is channel
// q + j*CS; slots past the width hold zeros. The per-layer part, from
// `base` on, is what sits in shared memory; offsets below are relative
// to it. TS rows per owned layer hold its KT tap rows in shared memory
// and, after they are consumed, its R rows of h until the ring write
// (TS = R at kernel_size 1, which has no taps).
struct Chain {
  int ndm, nrm, nlt, KT, TS, PL, base;
  __host__ __device__ Chain(int L, int k, int R, int D, int CS, int fuse) {
    ndm = cdiv(D, CS);
    nrm = cdiv(R, CS);
    nlt = cdiv(L, CS);
    KT = (k - 1) * R;
    TS = KT > R ? KT : R;
    PL = R * 2 * ndm + 2 * ndm + D * nrm + nrm + (fuse ? D * 2 * ndm : 0);
    base = nlt * KT * 2 * D;
  }
  __host__ __device__ int layers(int L) const { return L * PL; }
  __host__ __device__ int wt(int m, int D) const { return m * KT * 2 * D; }
  __host__ __device__ int wc(int l) const { return l * PL; }
  __host__ __device__ int bz(int l, int R) const {
    return wc(l) + R * 2 * ndm;
  }
  __host__ __device__ int wr(int l, int R) const { return bz(l, R) + 2 * ndm; }
  __host__ __device__ int br(int l, int R, int D) const {
    return wr(l, R) + D * nrm;
  }
  __host__ __device__ int wf(int l, int R, int D) const {
    return br(l, R, D) + nrm;
  }
};

// Shared memory of one block, in floats. The head's partial sums (part,
// PART_ROWS rows) share the tz rows when they are large enough (tz is idle
// during the head). `cond_rows` rows of TL lanes hold the step's
// conditioning (0 without it).
struct Layout {
  int taps, cs, tz, hbuf, H, scratch, part, tab_v, tab_i, cur, blob, nonblob;
};

__host__ __device__ inline Layout layout(int TL, int CS, int L, int k, int R,
                                         int D, int S, int E, int C,
                                         int fuse, int cond_rows) {
  const Chain ch(L, k, R, D, CS, fuse);
  Layout s;
  s.taps = 0;
  s.cs = s.taps + ch.nlt * ch.TS * TL;
  s.tz = s.cs + cond_rows * TL;
  s.hbuf = s.tz + L * 2 * ch.ndm * TL;
  s.H = s.hbuf + 2 * R * TL;
  int hrows = L * D;
  if (S > hrows) hrows = S;
  if (E > hrows) hrows = E;
  int next = s.H + hrows * TL;
  int srows = col_block(S, CS);
  if (col_block(E, CS) > srows) srows = col_block(E, CS);
  if (col_block(C, CS) > srows) srows = col_block(C, CS);
  s.scratch = next;
  next += srows * TL;
  if (PART_ROWS <= L * 2 * ch.ndm) {
    s.part = s.tz;
  } else {
    s.part = next;
    next += PART_ROWS * TL;
  }
  s.tab_v = next;
  s.tab_i = s.tab_v + CS * TL;
  s.cur = s.tab_i + CS * TL;
  s.blob = s.cur + TL + ((4 - TL % 4) % 4);
  s.nonblob = s.blob;
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Where slot `slot`, channel r, lane s of layer l's ring lives.
template <bool K1RING>
__device__ __forceinline__ size_t ring_index(const Args& a, int off, int slot,
                                             int r, int s) {
  if constexpr (K1RING)  // FusedGenState: off (floats) + (slot*streams+s)*R+r
    return (size_t)off + ((size_t)slot * a.streams + s) * a.R + r;
  else  // HbmGenState: ((first + slot)*R + r)*streams + s
    return ((size_t)(off + slot) * a.R + r) * a.streams + s;
}

// Start the copies of every tap row of this rank's layers for step ta.
template <int TL, bool K1RING>
__device__ void prefetch_taps(const Args& a, const Chain& ch, int q, int ta,
                              int lane0, float* taps) {
  const int n = ch.KT * TL;
  for (int m = 0; m < ch.nlt; ++m) {
    const int l = q + m * a.CS;
    if (l >= a.L) break;
    const int d = a.meta[3 * l], P = a.meta[3 * l + 1], off = a.meta[3 * l + 2];
    for (int idx = threadIdx.x; idx < n; idx += NT) {
      const int row = idx / TL, lane = idx - row * TL;
      const int j = row / a.R, r = row - j * a.R;
      const int look = (a.k - 1 - j) * d;
      const int s = lane0 + lane;
      const bool valid = s < a.streams && ta >= look;
      const float* ring = static_cast<const float*>(a.ring);
      const float* src =
          valid ? ring + ring_index<K1RING>(a, off, pmod(ta - look, P), r, s)
                : ring;
      cp_async4(taps + (size_t)m * ch.TS * TL + idx, src, valid);
    }
  }
  cp_async_commit();
}

// A narrow ring (K4's layout, rb = 2 or 1 bytes per element): the byte at
// which tap row `row` of owned layer `l` starts for the tile's first lane
// at step ta.
__device__ __forceinline__ size_t raw_byte(const Args& a, int l, int row,
                                           int ta, int lane0, int rb) {
  const int d = a.meta[3 * l], P = a.meta[3 * l + 1], off = a.meta[3 * l + 2];
  const int j = row / a.R, r = row - j * a.R;
  const int look = (a.k - 1 - j) * d;
  return ring_index<false>(a, off, pmod(ta - look, P), r, 0) * rb +
         (size_t)lane0 * rb;
}

// A narrow ring's staged tap rows (RW words each: a row's TL elements from
// the 4-byte word below its first byte on) sit at the top of their owned
// layer's TS x TL tap rows, idle from the ring writes to the next step.
template <int TL, int RB>
__device__ __forceinline__ unsigned* raw_rows(const Chain& ch, float* taps,
                                              int m) {
  constexpr int RW = TL * RB / 4 + 1;
  return reinterpret_cast<unsigned*>(taps + (size_t)(m + 1) * ch.TS * TL) -
         ch.KT * RW;
}

// Start the copies of every tap row of this rank's layers for step ta from
// a narrow ring: per row, the 4-byte words from the one holding its first
// byte to the one holding its last lane's (clipped to the ring's
// `ring_bytes`; a word partly past it is zero-filled), into its raw row
// (raw_rows). Rows whose tap is not yet valid (ta < lookback) are not
// copied; widen_taps writes 0.0 for them.
template <int TL, int RB>
__device__ void prefetch_raw(const Args& a, const Chain& ch, int q, int ta,
                             int lane0, float* taps, size_t ring_bytes) {
  constexpr int RW = TL * RB / 4 + 1;
  const int nl = min(TL, a.streams - lane0);
  const char* base = static_cast<const char*>(a.ring);
  for (int m = 0; m < ch.nlt; ++m) {
    const int l = q + m * a.CS;
    if (l >= a.L) break;
    const int d = a.meta[3 * l];
    for (int idx = threadIdx.x; idx < ch.KT * RW; idx += NT) {
      const int row = idx / RW, w = idx - row * RW;
      const int look = (a.k - 1 - row / a.R) * d;
      const size_t b0 = raw_byte(a, l, row, ta, lane0, RB);
      const size_t g = (b0 & ~(size_t)3) + 4 * (size_t)w;
      const size_t end = min(b0 + (size_t)nl * RB, ring_bytes);
      const int n = ta >= look && g < end ? (int)min((size_t)4, ring_bytes - g)
                                          : 0;
      const unsigned dst = (unsigned)__cvta_generic_to_shared(
          raw_rows<TL, RB>(ch, taps, m) + row * RW + w);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                   "l"(n ? base + g : base), "r"(n)
                   : "memory");
    }
  }
  cp_async_commit();
}

// The staged raw rows of step ta into the f32 tap rows, in place: bf16
// values, or int8 counts; 0.0 where the tap is not yet valid or the lane
// is empty. A thread takes LPT lanes of one row (the row's offsets
// computed once), reads them into registers and, after a barrier, writes
// them; a pass takes whole rows in order, and f32 rows 0..r end at or
// below raw row r + 1 (RW <= TL, TS >= KT), so a pass never overwrites a
// raw row a later pass reads. Every thread of the block calls it (it
// holds block barriers).
template <int TL, int RB>
__device__ void widen_taps(const Args& a, const Chain& ch, int q, int ta,
                           int lane0, float* taps) {
  constexpr int RW = TL * RB / 4 + 1, LPT = 8, TPR = TL / LPT;
  constexpr int RP = NT / TPR;  // rows per pass
  static_assert(TL % LPT == 0, "lanes per cluster: a multiple of 8");
  const int rows = min(ch.nlt, cdiv(a.L - q, a.CS)) * ch.KT;
  const int sub = (int)threadIdx.x % TPR, lo = sub * LPT;
  for (int r0 = 0; r0 < rows; r0 += RP) {
    const int g = r0 + (int)threadIdx.x / TPR;
    const bool live = (int)threadIdx.x / TPR < RP && g < rows;
    const int m = live ? g / ch.KT : 0, row = live ? g - m * ch.KT : 0;
    float x[LPT];
#pragma unroll
    for (int j = 0; j < LPT; ++j) x[j] = 0.f;
    if (live) {
      const int l = q + m * a.CS;
      const int look = (a.k - 1 - row / a.R) * a.meta[3 * l];
      if (ta >= look) {
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(
                raw_rows<TL, RB>(ch, taps, m) + row * RW) +
            (raw_byte(a, l, row, ta, lane0, RB) & 3) + lo * RB;
        const int nl = min(LPT, a.streams - lane0 - lo);
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          if (j >= nl) continue;
          if constexpr (RB == 2)
            x[j] = __uint_as_float((unsigned)src[2 * j] << 16 |
                                   (unsigned)src[2 * j + 1] << 24);
          else
            x[j] = (float)static_cast<signed char>(src[j]);
        }
      }
    }
    __syncthreads();
    if (live) {
      float* dst = taps + ((size_t)m * ch.TS + row) * TL + lo;
      reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();
  }
}

// Issue the copies of step t's conditioning rows (t counts from the
// call's start): K1 the projected rows of this rank's layers into
// cs[(m * 2D + c) * TL + lane], K4 the M x TL slab into cs[m * TL + lane];
// 0.0 for lanes past the streams. Committed with the taps.
template <int TL, bool K1RING>
__device__ void prefetch_cond(const Args& a, const Chain& ch, int q, int t,
                              int lane0, float* cs) {
  if constexpr (K1RING) {
    const int n2 = 2 * a.D, n = n2 * TL;
    for (int m = 0; m < ch.nlt; ++m) {
      const int l = q + m * a.CS;
      if (l >= a.L) break;
      for (int idx = threadIdx.x; idx < n; idx += NT) {
        const int lane = idx / n2, c = idx - lane * n2;
        const int s = lane0 + lane;
        const bool valid = s < a.streams;
        const float* src =
            valid ? a.cond + (((size_t)t * a.L + l) * a.streams + s) * n2 + c
                  : a.cond;
        cp_async4(cs + ((size_t)m * n2 + c) * TL + lane, src, valid);
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < a.M * TL; idx += NT) {
      const int m = idx / TL, lane = idx - m * TL;
      const int s = lane0 + lane;
      const bool valid = s < a.streams;
      const float* src =
          valid ? a.cond + ((size_t)t * a.M + m) * a.streams + s : a.cond;
      cp_async4(cs + idx, src, valid);
    }
  }
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Sum over the KG = 8 row groups held by 8 consecutive threads (the low
// three bits of the lane): a fixed tree, the same value in each of them.
// The sum over the 8 row groups of lane g mod NL, in thread g: for 8
// lanes the tree reduce-scattered (each level adds the same two partial
// sums as the full tree, so the values are the same, with 7 shuffles in
// place of 24); for 4 lanes the full tree, then a select.
template <int NL>
__device__ __forceinline__ float group_scatter(const float (&v)[NL], int g) {
  if constexpr (NL == 4) {
    float mine = 0.f;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      float t = v[j];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      t += __shfl_xor_sync(0xffffffffu, t, 4);
      if (j == (g & 3)) mine = t;
    }
    return mine;
  } else {
    static_assert(NL == 8, "4 or 8 lanes per thread");
    const int b0 = g & 1, b1 = (g >> 1) & 1, b2 = (g >> 2) & 1;
    float s1[4], s2[2];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float keep = b0 ? v[2 * k + 1] : v[2 * k];
      const float give = b0 ? v[2 * k] : v[2 * k + 1];
      s1[k] = keep + __shfl_xor_sync(0xffffffffu, give, 1);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float keep = b1 ? s1[2 * k + 1] : s1[2 * k];
      const float give = b1 ? s1[2 * k] : s1[2 * k + 1];
      s2[k] = keep + __shfl_xor_sync(0xffffffffu, give, 2);
    }
    const float keep = b2 ? s2[1] : s2[0];
    const float give = b2 ? s2[0] : s2[1];
    return keep + __shfl_xor_sync(0xffffffffu, give, 4);
  }
}

// The head's products run on the tensor cores in 3xTF32 (tf32.cuh).

constexpr int HEAD_DEPTH = 8;  // k-steps of weights in flight per warp

// One m-tile's A fragment for the k-step at k: rows k + t and k + t + 4,
// columns c and c + 1 (m = g and g + 8: adjacent columns, one 8-byte load
// under VEC; columns past c_last read in bounds and are never written);
// rows at or past k1 read as 0 and are not loaded.
template <bool VEC>
__device__ __forceinline__ void tc_load(const float* __restrict__ W, int ld,
                                        int c, int c_last, int k, int k1,
                                        int t, float (&a)[4]) {
  const int ra = k + t, rb = ra + 4;
  const bool va = ra < k1, vb = rb < k1;
  if constexpr (VEC) {  // past the last pair: read the last pair
    const int cv = min(c, c_last - 1);
    const float2 p = va ? __ldg(reinterpret_cast<const float2*>(
                              W + (size_t)ra * ld + cv))
                        : make_float2(0.f, 0.f);
    const float2 r = vb ? __ldg(reinterpret_cast<const float2*>(
                              W + (size_t)rb * ld + cv))
                        : make_float2(0.f, 0.f);
    a[0] = p.x; a[1] = p.y; a[2] = r.x; a[3] = r.y;
  } else {
    const int ca = min(c, c_last), cb = min(c + 1, c_last);
    a[0] = va ? __ldg(W + (size_t)ra * ld + ca) : 0.f;
    a[1] = va ? __ldg(W + (size_t)ra * ld + cb) : 0.f;
    a[2] = vb ? __ldg(W + (size_t)rb * ld + ca) : 0.f;
    a[3] = vb ? __ldg(W + (size_t)rb * ld + cb) : 0.f;
  }
}

// Rows [k0, k1) of a head product for one m-tile, 8-row k-steps in order:
// M = 16 output columns, N = the tile's lanes in TL / 8 tiles of 8, A[m][i]
// = W[k + i][column of m] (a0 m g row t, a1 m g + 8 row t, a2 m g row t +
// 4, a3 m g + 8 row t + 4, thread g = lane / 4, t = lane % 4), B[i][n] =
// f(x[k + i][8n + g]) (b0 row t, b1 row t + 4; f = relu when RELU). The
// weights of the next HEAD_DEPTH k-steps are loaded while one computes.
// BF16: x is rounded to bf16 as it is read and W holds bf16 values (the
// skip row of a narrow ring), so both are exact TF32 and one product
// replaces three.
template <int TL, bool RELU, bool VEC, bool BF16 = false>
__device__ __forceinline__ void tc_rows(const float* __restrict__ W, int ld,
                                        int c, int c_last, const float* x,
                                        int k0, int k1, int g, int t,
                                        float (&acc)[TL / 8][4]) {
  float av[HEAD_DEPTH][4];
#pragma unroll
  for (int p = 0; p < HEAD_DEPTH; ++p)
    tc_load<VEC>(W, ld, c, c_last, k0 + 8 * p, k1, t, av[p]);
  for (int k = k0; k < k1; k += 8 * HEAD_DEPTH) {
#pragma unroll
    for (int p = 0; p < HEAD_DEPTH; ++p) {
      const int kk = k + 8 * p;
      float a[4] = {av[p][0], av[p][1], av[p][2], av[p][3]};
      tc_load<VEC>(W, ld, c, c_last, kk + 8 * HEAD_DEPTH, k1, t, av[p]);
      if (kk >= k1) continue;
      unsigned ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (BF16) ah[i] = __float_as_uint(a[i]);
        else tf32_split(a[i], ah[i], al[i]);
      }
      const int ra = kk + t, rb = ra + 4;
#pragma unroll
      for (int n = 0; n < TL / 8; ++n) {
        float b0 = ra < k1 ? x[ra * TL + n * 8 + g] : 0.f;
        float b1 = rb < k1 ? x[rb * TL + n * 8 + g] : 0.f;
        if (RELU) {
          b0 = fmaxf(b0, 0.f);
          b1 = fmaxf(b1, 0.f);
        }
        if (BF16) {
          mma_tf32(acc[n], ah,
                   __float_as_uint(__bfloat162float(__float2bfloat16_rn(b0))),
                   __float_as_uint(__bfloat162float(__float2bfloat16_rn(b1))));
          continue;
        }
        unsigned bh0, bl0, bh1, bl1;
        tf32_split(b0, bh0, bl0);
        tf32_split(b1, bh1, bl1);
        mma_tf32(acc[n], al, bh0, bh1);
        mma_tf32(acc[n], ah, bl0, bl1);
        mma_tf32(acc[n], ah, bh0, bh1);
      }
    }
  }
}

// Output columns [c0, c1) of a head product into out[(c - c0)][lane]:
// bias[c] + sum_i f(x[i][lane]) W[i][c] (f = relu when RELU_IN; relu'd
// when RELU_OUT), W row-major with leading dimension ld and n_in rows.
// Columns go in m-tiles of 16 (thread g of a warp holds columns c0 + 16mt
// + 2g and + 1). The block's warps split each m-tile's k-steps into ks
// contiguous groups, ks the largest power of two with ks * (m-tiles) <=
// warps and ks <= k-steps: groups 1 .. ks-1 store their sums in `part`
// (PART_ROWS x TL) and, after a block barrier, group 0 adds them in group
// order, then the bias. The order depends on n_in and the rank's columns
// (the config and the cluster size) alone. Under EXACT_SKIP, W is the
// [skip|res] output weights (L, D, ld) read as (L*D, ld) rows and the bias
// the layers' skip biases b_out (L, ld), summed in layer order: the skip
// row the exact path accumulates layer by layer, summed in the slab
// form's order. BF16: the operands rounded to bf16 (tc_rows). Every thread
// of the block calls it (it holds block barriers).
template <int TL, bool RELU_IN, bool RELU_OUT, bool EXACT_SKIP,
          bool BF16 = false>
__device__ void head_cols(const float* __restrict__ W,
                          const float* __restrict__ bias, int ld, int n_in,
                          int L, const float* x, int c0, int c1, float* out,
                          float* part) {
  constexpr int NN = TL / 8, NW = NT / 32;
  static_assert(TL % 8 == 0, "lanes per cluster: a multiple of 8");
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int g = wl >> 2, t = wl & 3;
  const int nmt = cdiv(c1 - c0, 16), nk = cdiv(n_in, 8);
  int ks = 1;
  while (2 * ks * nmt <= NW && 2 * ks <= nk) ks *= 2;
  const int per = NW / ks;  // m-tiles per round
  const int slot = warp / ks, grp = warp % ks;
  const bool vec = (ld & 1) == 0 && ((c1 - c0) & 1) == 0 &&
                   (reinterpret_cast<size_t>(W) & 7) == 0;
  for (int base = 0; base < nmt; base += per) {
    const int mt = base + slot;
    const bool live = mt < nmt;
    const int c = c0 + mt * 16 + 2 * g;
    float acc[NN][4];
#pragma unroll
    for (int n = 0; n < NN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
    if (live) {
      const int k0 = 8 * (grp * nk / ks);
      const int k1 = min(n_in, 8 * ((grp + 1) * nk / ks));
      if (vec)
        tc_rows<TL, RELU_IN, true, BF16>(W, ld, c, c1 - 1, x, k0, k1, g, t,
                                         acc);
      else
        tc_rows<TL, RELU_IN, false, BF16>(W, ld, c, c1 - 1, x, k0, k1, g, t,
                                          acc);
    }
    // acc[n]: 0, 1 column c, lanes 8n + 2t and + 1; 2, 3 column c + 1
    float* mine = part + ((slot * (ks - 1) + grp - 1) * 16 + 2 * g) * TL;
    if (live && grp > 0)
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          *reinterpret_cast<float2*>(mine + cc * TL + n * 8 + 2 * t) =
              make_float2(acc[n][2 * cc], acc[n][2 * cc + 1]);
    __syncthreads();
    if (live && grp == 0) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        if (c + cc >= c1) continue;
        float b = 0.f;
        if constexpr (EXACT_SKIP)  // the layers' skip biases, in order
          for (int l = 0; l < L; ++l) b = b + bias[l * ld + c + cc];
        else
          b = bias[c + cc];
#pragma unroll
        for (int n = 0; n < NN; ++n) {
          float v0 = acc[n][2 * cc], v1 = acc[n][2 * cc + 1];
          for (int j = 1; j < ks; ++j) {
            const float2 p = *reinterpret_cast<const float2*>(
                part + ((slot * (ks - 1) + j - 1) * 16 + 2 * g + cc) * TL +
                n * 8 + 2 * t);
            v0 += p.x;
            v1 += p.y;
          }
          v0 += b;
          v1 += b;
          if (RELU_OUT) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<float2*>(out + (c + cc - c0) * TL + n * 8 +
                                     2 * t) = make_float2(v0, v1);
        }
      }
    }
    if (base + per < nmt) __syncthreads();  // part is reused by the next round
  }
}

// Store rows [0, n) of a local [row][lane] buffer into rows [r0, r0 + n)
// of the buffer at `dst` in every rank of the cluster.
template <int TL>
__device__ __forceinline__ void all_gather(cg::cluster_group& cl, int CS,
                                           const float* src, float* dst,
                                           int r0, int n) {
  const int total = n * TL / 4;
  for (int idx = threadIdx.x; idx < total * CS; idx += NT) {
    const int rank = idx / total, i = idx - rank * total;
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    float* base = cl.map_shared_rank(dst, (unsigned)rank);
    reinterpret_cast<float4*>(base + r0 * TL)[i] = v;
  }
}

// Rows i0, i0 + KG, ... below i1 of x ([row][lane]) against column cs of
// W (n2 columns), NL lanes from j0, accumulated in row order.
template <int TL, int NL>
__device__ __forceinline__ void chain_rows(const float* W, int n2, int cs,
                                           const float* x, int j0, int i0,
                                           int i1, float (&acc)[NL]) {
#pragma unroll 4
  for (int i = i0; i < i1; i += KG) {
    const float w = W[i * n2 + cs];
#pragma unroll
    for (int j = 0; j < NL; j += 4) {
      const float4 v = ld4(x + i * TL + j0 + j);
      acc[j] = fmaf(v.x, w, acc[j]);
      acc[j + 1] = fmaf(v.y, w, acc[j + 1]);
      acc[j + 2] = fmaf(v.z, w, acc[j + 2]);
      acc[j + 3] = fmaf(v.w, w, acc[j + 3]);
    }
  }
}

// The tag of the kernel that runs a call's headless steps.
struct Headless {};

// The steps of one call on this block: HEAD, steps [head_from, total) with
// the head; else the teacher-forced steps [0, head_from) without it. Each
// is a kernel of its own (launch), so the headless steps cost the headed
// kernel no registers (a branch on the step in one loop spilled more at
// every width, at 24 lanes twice the bytes loaded, and slowed the 24-lane
// step by 3.5 % on an H100).
// COND: the call has conditioning inputs (cond or
// gcond). The kernel without them is compiled apart, so their code costs
// the unconditioned paths no registers. RT: the ring's dtype, 0 f32, 1
// bf16, 2 int8 (K4).
template <int TL, bool K1RING, bool COND, int RT, bool HEAD>
__device__ __forceinline__ void gen_steps(const Args& a) {
  static_assert(RT == 0 || !K1RING, "K1's rings are f32");
  constexpr int RB = RT == 0 ? 4 : RT == 1 ? 2 : 1;  // bytes per element
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int CS = a.CS, q = (int)cl.block_rank();
  const int tid = threadIdx.x;
  const int lane0 = (blockIdx.x / CS) * TL;
  const int L = a.L, R = a.R, D = a.D, S = a.S, E = a.E, C = a.C;
  const Chain ch(L, a.k, R, D, CS, a.fuse_res);
  const int ndm = ch.ndm, nrm = ch.nrm, n2 = 2 * ndm;
  constexpr int LQ = TL >= 16 ? 8 : 4;  // lanes per thread in the chain
  constexpr int NQ = TL / LQ;
  const Layout lay = layout(TL, CS, L, a.k, R, D, S, E, C, a.fuse_res,
                            a.cond_rows);
  float* taps = sm + lay.taps;
  float* cs = sm + lay.cs;
  float* tz = sm + lay.tz;
  float* hbuf = sm + lay.hbuf;
  float* H = sm + lay.H;  // the slab of u, then the skip row, then y1
  float* scratch = sm + lay.scratch;
  float* part = sm + lay.part;
  float* tab_v = sm + lay.tab_v;
  int* tab_i = reinterpret_cast<int*>(sm + lay.tab_i);
  int* cur = reinterpret_cast<int*>(sm + lay.cur);
  // a narrow ring's size in bytes (its last layer's slots end it)
  const size_t ring_bytes =
      RT == 0 ? 0
              : (size_t)(a.meta[3 * (L - 1) + 2] + a.meta[3 * (L - 1) + 1]) *
                    R * a.streams * RB;
  const float* wtaps = a.chain + (size_t)q * a.F;  // tap blocks: from L2
  const float* blob = wtaps + ch.base;
  if (a.resident) {
    float* b = sm + lay.blob;
    for (int i = tid; i < ch.layers(L); i += NT) b[i] = blob[i];
    blob = b;
  }
  const int t_begin = HEAD ? a.head_from : 0;
  const int t_end = HEAD ? a.total : a.head_from;
  for (int lane = tid; lane < TL; lane += NT) {
    const int s = lane0 + lane;
    cur[lane] =
        s < a.streams ? a.prime[(size_t)s * a.num_given + t_begin] : 0;
  }
  // the first step's taps (and conditioning), issued before the loop (a
  // resumed call reads its history from the first step on)
  if (COND && a.cond != nullptr)
    prefetch_cond<TL, K1RING>(a, ch, q, t_begin, lane0, cs);
  if constexpr (RT == 0)
    prefetch_taps<TL, K1RING>(a, ch, q, a.t0 + t_begin, lane0, taps);
  else
    prefetch_raw<TL, RB>(a, ch, q, a.t0 + t_begin, lane0, taps, ring_bytes);
  cl.sync();

  const int bsS = col_block(S, CS), bsE = col_block(E, CS);
  const int bsC = col_block(C, CS);
  const int s0 = min(S, q * bsS), s1 = min(S, s0 + bsS);
  const int e0 = min(E, q * bsE), e1 = min(E, e0 + bsE);
  const int c0 = min(C, q * bsC), c1 = min(C, c0 + bsC);
  const int n_own = cdiv(L - q, CS);  // layers whose taps this rank holds
  // task counts in whole warps (the shuffles need every lane of a warp)
  const int ngate = cdiv(ndm * NQ * 2 * KG, 32) * 32;
  const int nres = cdiv(nrm * NQ * KG, 32) * 32;

  // phase times of the first block (thread 0): 0 tap products and embed,
  // 1 the chain's work, 2 its barriers, 3 the skip row, 4 ring writes,
  // the skip row's gather and end1, 5 y1's gather and end2, 6 sampling
  const bool timed = a.timers != nullptr && blockIdx.x == 0 && tid == 0;
  unsigned long long t_mark = timed ? now_ns() : 0, t_acc[NPHASE] = {};
  auto mark = [&](int phase) {
    if (timed) {
      const unsigned long long n = now_ns();
      t_acc[phase] += n - t_mark;
      t_mark = n;
    }
  };
  for (int t = t_begin; t < t_end; ++t) {
    const int ta = a.t0 + t;
    cp_async_wait_all();
    __syncthreads();
    if constexpr (RT != 0) widen_taps<TL, RB>(a, ch, q, ta, lane0, taps);
    // tap products of this rank's layers, all 2D columns, into the
    // owners' tz rows
    for (int idx = tid; idx < n_own * 2 * D * NQ; idx += NT) {
      const int quad = idx % NQ, rest = idx / NQ;
      const int col = rest % (2 * D), m = rest / (2 * D);
      const int l = q + m * CS;
      const float* wt = wtaps + ch.wt(m, D);
      const float* x = taps + (size_t)m * ch.TS * TL;
      float acc[LQ];
#pragma unroll
      for (int jj = 0; jj < LQ; ++jj) acc[jj] = 0.f;
#pragma unroll 16
      for (int i = 0; i < ch.KT; ++i) {
        const float w = __ldg(wt + i * 2 * D + col);
#pragma unroll
        for (int jj = 0; jj < LQ; jj += 4) {
          const float4 v = ld4(x + i * TL + quad * LQ + jj);
          acc[jj] = fmaf(v.x, w, acc[jj]);
          acc[jj + 1] = fmaf(v.y, w, acc[jj + 1]);
          acc[jj + 2] = fmaf(v.z, w, acc[jj + 2]);
          acc[jj + 3] = fmaf(v.w, w, acc[jj + 3]);
        }
      }
      if (COND && a.cond != nullptr) {
        if constexpr (K1RING) {  // the projected rows
          const float4* cv = reinterpret_cast<const float4*>(
              cs + ((size_t)m * 2 * D + col) * TL + quad * LQ);
#pragma unroll
          for (int jj = 0; jj < LQ; jj += 4) {
            const float4 v = cv[jj / 4];
            acc[jj] += v.x;
            acc[jj + 1] += v.y;
            acc[jj + 2] += v.z;
            acc[jj + 3] += v.w;
          }
        } else {  // cond_t @ w_cond[l]: M more rows, in order
          const float* wc = a.w_cond + (size_t)l * a.M * 2 * D;
#pragma unroll 8
          for (int i = 0; i < a.M; ++i) {
            const float w = __ldg(wc + i * 2 * D + col);
#pragma unroll
            for (int jj = 0; jj < LQ; jj += 4) {
              const float4 v = ld4(cs + i * TL + quad * LQ + jj);
              acc[jj] = fmaf(v.x, w, acc[jj]);
              acc[jj + 1] = fmaf(v.y, w, acc[jj + 1]);
              acc[jj + 2] = fmaf(v.z, w, acc[jj + 2]);
              acc[jj + 3] = fmaf(v.w, w, acc[jj + 3]);
            }
          }
        }
      }
      if (COND && a.gcond != nullptr) {
#pragma unroll
        for (int jj = 0; jj < LQ; ++jj) {
          const int s = lane0 + quad * LQ + jj;
          if (s < a.streams)
            acc[jj] += K1RING
                ? __ldg(a.gcond + ((size_t)l * a.streams + s) * 2 * D + col)
                : __ldg(a.gcond + ((size_t)l * 2 * D + col) * a.streams + s);
        }
      }
      const int c = col < D ? col : col - D;
      const int cs = (col < D ? 0 : ndm) + c / CS;
      float* dst = cl.map_shared_rank(tz, (unsigned)(c % CS)) +
                   (l * n2 + cs) * TL + quad * LQ;
#pragma unroll
      for (int jj = 0; jj < LQ; jj += 4)
        st4(dst + jj, make_float4(acc[jj], acc[jj + 1], acc[jj + 2],
                                  acc[jj + 3]));
    }
    // the layer-0 input, in every rank
    for (int idx = tid; idx < R * TL; idx += NT) {
      const int r = idx / TL, lane = idx - r * TL;
      hbuf[idx] = a.w_start[(size_t)cur[lane] * R + r] + a.b_start[r];
    }
    cl.sync();
    mark(0);

    // One round of chain work: the gate of layer lg (lg >= 0; from h and,
    // under fuse_res, u = u[lg-1] with wf[lg-1]) and the residual update
    // of layer lr (lr >= 0; h[lr+1] from h = h[lr] and u = u[lr]). Both
    // store their channels into every rank.
    auto chain_tasks = [&](int lg, int lr, const float* h, const float* u,
                           float* hn) {
      const int ng = lg >= 0 ? ngate : 0, nr = lr >= 0 ? nres : 0;
      for (int base = 0; base < ng + nr; base += NT) {
        const int tsk = base + tid;
        if (tsk < ng) {
          const int g = tsk % KG, o0 = tsk / KG;
          const bool live = o0 < ndm * NQ * 2;
          const int o = live ? o0 : ndm * NQ * 2 - 2 + (o0 & 1);
          const int fg = o & 1, rest = o >> 1;
          const int quad = rest % NQ, j = rest / NQ;
          const int cs = fg ? ndm + j : j, j0 = quad * LQ;
          const float* wc = blob + ch.wc(lg);
          const bool fu = u != nullptr;
          // row group g: rows g, g + KG, ... of [h; u]
          const int iu = g + KG * cdiv(max(R - g, 0), KG) - R;
          float acc[LQ];
#pragma unroll
          for (int jj = 0; jj < LQ; ++jj) acc[jj] = 0.f;
          chain_rows<TL, LQ>(wc, n2, cs, h, j0, g, R, acc);
          if (fu)
            chain_rows<TL, LQ>(blob + ch.wf(lg - 1, R, D), n2, cs, u, j0, iu,
                               D, acc);
          const float bz = blob[ch.bz(lg, R) + cs];
          const float* tzp = tz + (lg * n2 + cs) * TL + j0;
          // thread g of the 8 row groups takes lane g mod LQ: tanh of the
          // filter (fg 0) beside the sigmoid of the gate (fg 1), so the
          // lanes' transcendentals run in parallel
          const float z = (tzp[g % LQ] + group_scatter<LQ>(acc, g)) + bz;
          const float act = fg ? sigmoidf_(z) : tanhf(z);
          const float u1 = act * __shfl_xor_sync(0xffffffffu, act, KG);
          const int lead = (tid & 31) & ~(2 * KG - 1);
          float uv[LQ];
#pragma unroll
          for (int jj = 0; jj < LQ; ++jj)
            uv[jj] = __shfl_sync(0xffffffffu, u1, lead + jj);
          const int c = q + j * CS, p = fg * KG + g;
          if (live && c < D && p < CS) {
            float* dst = cl.map_shared_rank(H, (unsigned)p) + (lg * D + c) * TL + j0;
#pragma unroll
            for (int jj = 0; jj < LQ; jj += 4)
              st4(dst + jj, make_float4(uv[jj], uv[jj + 1], uv[jj + 2],
                                        uv[jj + 3]));
          }
        } else if (tsk < ng + nr) {
          const int t2 = tsk - ng;
          const int g = t2 % KG, o = t2 / KG;
          const bool live = o < nrm * NQ;
          const int oc = live ? o : nrm * NQ - 1;
          const int quad = oc % NQ, jr = oc / NQ, j0 = quad * LQ;
          const int r = q + jr * CS, rr = min(r, R - 1);
          float acc[LQ];
#pragma unroll
          for (int jj = 0; jj < LQ; ++jj) acc[jj] = 0.f;
          chain_rows<TL, LQ>(blob + ch.wr(lr, R), nrm, jr, u, j0, g, D, acc);
          const float br = blob[ch.br(lr, R, D) + jr];
          const float* hp = h + rr * TL + j0;
          const float v1 = hp[g % LQ] + (group_scatter<LQ>(acc, g) + br);
          const int lead = (tid & 31) & ~(KG - 1);
          float v[LQ];
#pragma unroll
          for (int jj = 0; jj < LQ; ++jj)
            v[jj] = __shfl_sync(0xffffffffu, v1, lead + jj);
          if (live && r < R)
            for (int p = g; p < CS; p += KG) {
              float* dst = cl.map_shared_rank(hn, (unsigned)p) + r * TL + j0;
#pragma unroll
              for (int jj = 0; jj < LQ; jj += 4)
                st4(dst + jj, make_float4(v[jj], v[jj + 1], v[jj + 2],
                                          v[jj + 3]));
            }
        }
      }
    };
    // layer l's input, kept by the rank that prefetches its taps (in the
    // tap rows it consumed at the step's start) for the ring write after
    // the chain: a global store before a cluster barrier would hold the
    // barrier until it reached L2
    auto ring_keep = [&](int l, const float* h) {
      if (l % CS != q) return;
      float* dst = taps + (size_t)(l / CS) * ch.TS * TL;
      for (int idx = tid; idx < R * TL; idx += NT) dst[idx] = h[idx];
    };

    if (a.fuse_res) {
      chain_tasks(0, -1, hbuf, nullptr, nullptr);
      for (int l = 0; l < L; ++l) {
        mark(1);
        cl.sync();  // u[l] and h[l] complete in every rank
        mark(2);
        const float* h = hbuf + (l & 1) * R * TL;
        const float* u = H + l * D * TL;
        ring_keep(l, h);
        if (l + 1 < L)
          chain_tasks(l + 1, l, h, u, hbuf + ((l + 1) & 1) * R * TL);
      }
    } else {
      for (int l = 0; l < L; ++l) {
        const float* h = hbuf + (l & 1) * R * TL;
        chain_tasks(l, -1, h, nullptr, nullptr);
        mark(1);
        cl.sync();  // u[l] complete in every rank
        mark(2);
        ring_keep(l, h);
        if (l + 1 < L) {
          chain_tasks(-1, l, h, H + l * D * TL, hbuf + ((l + 1) & 1) * R * TL);
          mark(1);
          cl.sync();  // h[l+1] complete in every rank
          mark(2);
        }
      }
    }

    mark(1);
    // a headless step: no rank reads the slab of u, tz or hbuf after the
    // chain's last cluster barrier, and the next step's stores into other
    // ranks' tz, slab and hbuf come after its tap barrier, so no barrier
    // takes the skip row's place
    if constexpr (HEAD) {
      // skip row: this rank's columns from the slab of u
      if (a.skip_slab)
        head_cols<TL, false, false, false, RT != 0>(a.w_skip, a.b_skip, S,
                                                    L * D, L, H, s0, s1,
                                                    scratch, part);
      else
        head_cols<TL, false, false, true>(a.w_skip, a.b_skip, S + R, L * D,
                                          L, H, s0, s1, scratch, part);
      cl.sync();  // every rank is done with its slab
      mark(3);
    }
    // the ring writes of this rank's layers, then the next step's taps
    for (int m = 0; m < n_own; ++m) {
      const int l = q + m * CS;
      const int P = a.meta[3 * l + 1], off = a.meta[3 * l + 2];
      const int slot = pmod(ta, P);
      const float* h = taps + (size_t)m * ch.TS * TL;
      for (int idx = tid; idx < R * TL; idx += NT) {
        const int r = idx / TL, lane = idx - r * TL, s = lane0 + lane;
        if (s >= a.streams) continue;
        const size_t e = ring_index<K1RING>(a, off, slot, r, s);
        if constexpr (RT == 0) {
          static_cast<float*>(a.ring)[e] = h[idx];
        } else if constexpr (RT == 1) {
          static_cast<__nv_bfloat16*>(a.ring)[e] = __float2bfloat16_rn(h[idx]);
        } else {  // jnp.round: half to even, as rintf
          const float v = rintf(__fmul_rn(h[idx], a.qscale[l]));
          static_cast<signed char*>(a.ring)[e] =
              (signed char)(int)fminf(fmaxf(v, -127.f), 127.f);
        }
      }
    }
    __syncthreads();  // a d = 1 layer's taps read the slot just written
    if (t + 1 < t_end) {
      if (COND && a.cond != nullptr)
        prefetch_cond<TL, K1RING>(a, ch, q, t + 1, lane0, cs);
      if constexpr (RT == 0)
        prefetch_taps<TL, K1RING>(a, ch, q, ta + 1, lane0, taps);
      else
        prefetch_raw<TL, RB>(a, ch, q, ta + 1, lane0, taps, ring_bytes);
    }
    if constexpr (!HEAD) {  // the next input is the prime's (t < num_given-1)
      mark(4);
      for (int lane = tid; lane < TL; lane += NT) {
        const int s = lane0 + lane;
        if (s >= a.streams) continue;
        const int next = a.prime[(size_t)s * a.num_given + t + 1];
        if (q == 0) a.out_cls[(size_t)s * a.total + t] = next;
        cur[lane] = next;
      }
      mark(6);
      continue;
    }
    all_gather<TL>(cl, CS, scratch, H, s0, s1 - s0);
    cl.sync();
    head_cols<TL, true, true, false>(a.w_end1, a.b_end1, E, S, L, H, e0, e1,
                                     scratch, part);
    cl.sync();  // every rank is done with the skip row
    mark(4);
    all_gather<TL>(cl, CS, scratch, H, e0, e1 - e0);
    cl.sync();
    head_cols<TL, false, false, false>(a.w_end2, a.b_end2, C, E, L, H, c0,
                                       c1, scratch, part);
    __syncthreads();
    mark(5);

    // sampling: this rank's classes, one warp per lane, then the best of
    // each rank in rank order
    const int warp = tid >> 5, wl = tid & 31;
    for (int lane = warp; lane < TL; lane += NT / 32) {
      const int s = lane0 + lane;
      const bool live = s < a.streams;
      const float temp =
          !live ? 0.f : (a.temps != nullptr ? a.temps[s] : a.temperature);
      const float tdiv = a.temps != nullptr ? fmaxf(temp, 1e-6f) : temp;
      unsigned tloc = (unsigned)ta, seed = a.seed;
      if (a.lane_seed && live) {
        tloc = (unsigned)ta + (unsigned)a.toffs[s];
        seed = (unsigned)a.seeds[s];
      }
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      for (int c = c0 + wl; c < c1; c += 32) {
        float v = scratch[(c - c0) * TL + lane];
        if (a.regularize != 0.f) {
          const float dc = (float)c - 0.5f * (float)C;
          v = __fsub_rn(v, __fmul_rn(__fmul_rn(dc, dc), a.regularize));
        }
        if (temp > 0.f) {
          const unsigned idx =
              a.lane_seed ? (unsigned)c : (unsigned)c * a.streams + s;
          v = __fadd_rn(__fdiv_rn(v, tdiv), counter_gumbel(idx, tloc, seed));
        }
        if (v > bv) { bv = v; bi = c; }
      }
      for (int o = 16; o > 0; o >>= 1) {  // butterfly: every lane gets it
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
      }
      if (wl < CS) {
        cl.map_shared_rank(tab_v, (unsigned)wl)[q * TL + lane] = bv;
        cl.map_shared_rank(tab_i, (unsigned)wl)[q * TL + lane] = bi;
      }
    }
    cl.sync();
    for (int lane = tid; lane < TL; lane += NT) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
      for (int rank = 0; rank < CS; ++rank) {
        const float v = tab_v[rank * TL + lane];
        const int i = tab_i[rank * TL + lane];
        if (v > bv || (v == bv && i < bi)) { bv = v; bi = i; }
      }
      if (bi >= C) bi = 0;  // all scores NaN: keep the embed gather in bounds
      const int s = lane0 + lane;
      if (s < a.streams) {
        if (q == 0) a.out_cls[(size_t)s * a.total + t] = bi;
        cur[lane] = t + 1 < a.num_given
                        ? a.prime[(size_t)s * a.num_given + t + 1]
                        : bi;
      }
    }
    mark(6);
  }
  if (timed)
    for (int i = 0; i < NPHASE; ++i) a.timers[i] += t_acc[i];
  cl.sync();  // no rank leaves while another may still store into it
}

template <int TL, bool K1RING, bool COND, int RT = 0>
__global__ void __launch_bounds__(NT, 1) gen_cluster_kernel(Args a) {
  gen_steps<TL, K1RING, COND, RT, true>(a);
}

// The headless steps, launched before the kernel above when head_from > 0
// (the same name, so a trace counts both as the one kernel's).
template <int TL, bool K1RING, bool COND, int RT = 0>
__global__ void __launch_bounds__(NT, 1) gen_cluster_kernel(Args a,
                                                            Headless) {
  gen_steps<TL, K1RING, COND, RT, false>(a);
}

// A kernel's launch attributes: `smem` bytes of dynamic shared memory, and
// clusters of CS > 8 blocks allowed.
template <typename K>
cudaError_t set_attributes(K kern, int smem, int CS) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && CS > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// Bytes of dynamic shared memory at tile width TL and cluster size CS,
// with the chain weights resident when they fit (*resident says so).
inline int shared_bytes(int TL, int CS, int L, int k, int R, int D, int S,
                        int E, int C, int fuse, int cond_rows,
                        int* resident) {
  const Chain ch(L, k, R, D, CS, fuse);
  const Layout s = layout(TL, CS, L, k, R, D, S, E, C, fuse, cond_rows);
  *resident = (s.nonblob + ch.layers(L)) * 4 <= SMEM_LIMIT;
  return (s.nonblob + (*resident ? ch.layers(L) : 0)) * 4;
}

// Launch on `st`: the headless kernel over steps [0, head_from) when
// head_from > 0, then the kernel over the rest; returns a cudaError_t (0 =
// success), or -2 when even the layout without the chain exceeds a block's
// shared memory.
template <int TL, bool K1RING, int RT = 0>
int launch(Args a, int tiles, cudaStream_t st, int* max_clusters) {
  int resident = 0;
  const int smem = shared_bytes(TL, a.CS, a.L, a.k, a.R, a.D, a.S, a.E, a.C,
                                a.fuse_res, a.cond_rows, &resident);
  if (smem > SMEM_LIMIT) return -2;
  a.resident = resident;
  const bool cond = a.cond != nullptr || a.gcond != nullptr;
  void (*kern)(Args) = gen_cluster_kernel<TL, K1RING, false, RT>;
  if (cond) kern = gen_cluster_kernel<TL, K1RING, true, RT>;
  cudaError_t err = set_attributes(kern, smem, a.CS);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.CS, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr) {
    err = cudaOccupancyMaxActiveClusters(max_clusters, kern, &cfg);
    return (int)err;
  }
  if (RT == 2 && a.qscale == nullptr) return -1;  // int8 without scales
  if (a.head_from > 0) {
    void (*headless)(Args, Headless) =
        gen_cluster_kernel<TL, K1RING, false, RT>;
    if (cond) headless = gen_cluster_kernel<TL, K1RING, true, RT>;
    err = set_attributes(headless, smem, a.CS);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernelEx(&cfg, headless, a, Headless{});
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace gen_cluster
