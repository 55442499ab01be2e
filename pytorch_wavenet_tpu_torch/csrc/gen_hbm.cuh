// Batched many-stream WaveNet generation for Hopper (sm_90a): kernel K4,
// the entry points of one ring dtype. Each of gen_kernel_hbm.cu (f32
// rings), gen_kernel_hbm_bf16.cu and gen_kernel_hbm_int8.cu defines
// GEN_HBM_RING (0, 1, 2: the cluster core's RT) and includes this file, so
// the three build in parallel into libraries of their own.
//
// Replaces the JAX package's Pallas TPU kernel
// pytorch_wavenet_tpu/ops/pallas/gen_kernel_hbm.py::generate_fast_batched
// (_make_kernel, one pallas_call for the whole loop of many streams, ring
// state in device memory).
//
// The ring is the JAX layout (sum_l P_l * R, streams): layer l, slot p,
// channel r, lane s at ((first_l + p) * R + r) * streams + s. Per-lane
// temperatures (max(T, 1e-6) divides the logits of a hot lane); the Gumbel
// noise is the counter hash of gen_common.cuh keyed by (class * streams +
// lane, ta, seed), or under lane_seed by (class, ta + toff[lane],
// seed[lane]): a request's draws do not depend on its lane or the pool.
//
// What bounds it on this card: a step is a serial chain of L small
// products (at chaconne, 30 layers of (2R) x 2D and D x R per lane), then
// the skip row and head, 3.58 MFLOP per lane-step with ~6.5 MB of weights
// that every tile reads once per step. The arithmetic of a 2048-step chunk
// at 256 lanes is 28 ms at the card's 67 TFLOP/s f32 rate, far below what
// bounds the kernel: the chain's latency (each layer waits on the one
// before, about 2 us a layer) and the head's L2 reads. What the design
// does about it: the core in gen_cluster.cuh. One cluster of 8 SMs per
// tile of `tile` lanes (8, 16 or 24; default_tile picks the narrowest whose
// clusters all run at once) keeps the chain's weights in its shared
// memory, passes each layer's u and h between its SMs through distributed
// shared memory with one cluster barrier per layer (fuse_res), prefetches
// a step's taps at once with cp.async, and splits the skip row and head
// over its SMs by columns, on the tensor cores in 3xTF32, so each SM reads
// 1/8 of the head weights per step. Local conditioning is a product in
// the kernel, as in the TPU kernel (projecting outside would write
// total*L*lanes*2D floats, 8 GB per 2048-step chunk at 256 lanes of the
// vocoder): each cluster copies the step's M x tile cond rows with the
// taps, a step ahead, and each rank adds cond_t @ w_cond[l] (w_cond from
// L2) to its layers' tap products, M*2D*L FMAs per lane and step off
// the chain, summed in an order fixed by M alone. bf16 and int8 rings (the
// TPU kernel's ring_dtype) halve and quarter the ring's bytes: their tap
// rows are staged raw and widened on chip, the ring writes round or
// quantize, and the chain stays f32 (gen_cluster.cuh).
#pragma once

#include "gen_cluster.cuh"

#ifndef GEN_HBM_RING
#error "define GEN_HBM_RING (0 f32, 1 bf16, 2 int8) before including"
#endif

using gen_cluster::Args;

namespace {

int launch_tile(const Args& a, int tile, int tiles, cudaStream_t st,
                int* max_clusters) {
  switch (tile) {
    case 8:
      return gen_cluster::launch<8, false, GEN_HBM_RING>(a, tiles, st,
                                                         max_clusters);
    case 16:
      return gen_cluster::launch<16, false, GEN_HBM_RING>(a, tiles, st,
                                                          max_clusters);
    case 24:
      return gen_cluster::launch<24, false, GEN_HBM_RING>(a, tiles, st,
                                                          max_clusters);
    default: return -1;
  }
}

}  // namespace

// Dynamic shared memory (bytes) of one block at `tile` lanes per cluster
// of `cluster` blocks with a cond slab of `cond_rows` rows (M, or 0
// without local conditioning); *resident says whether the chain weights
// are in it.
extern "C" int wavenet_gen_batched_smem(int tile, int cluster, int L, int k,
                                        int R, int D, int S, int E, int C,
                                        int fuse_res, int cond_rows,
                                        int* resident) {
  return gen_cluster::shared_bytes(tile, cluster, L, k, R, D, S, E, C,
                                   fuse_res, cond_rows, resident);
}

// Launch on `stream`; `cond` (total, M, streams) rows with `w_cond` (L, M,
// 2D), and `gcond` (L, 2D, streams) projected rows, each null when absent;
// `ring` of this library's dtype, and for int8 rings `qscale` (L) f32, the
// per-layer store scales (null otherwise). Steps t < `head_from` (at most
// num_given - 1) are teacher-forced and run without the head: their
// out_cls entry is the prime's next class (gen_cluster.cuh).
// Returns the cudaError_t of the launch (0 = success), -1 for a tile width
// without a compiled kernel, a cluster size other than 8, a head_from
// outside [0, num_given) or an int8 ring without its scales, -2 for a
// config whose buffers exceed a block's shared memory. With `max_clusters`
// non-null it launches nothing and stores cudaOccupancyMaxActiveClusters
// there. With `timers` non-null (NPHASE int64, zeroed by the caller) the
// first block adds the ns it spent per phase of a step (gen_cluster.cuh).
extern "C" int wavenet_gen_batched(
    const float* w_start, const float* b_start, const float* chain,
    const float* w_skip, const float* b_skip, const float* w_end1,
    const float* b_end1, const float* w_end2, const float* b_end2,
    const float* cond, const float* w_cond, const float* gcond, int M,
    const float* qscale, const float* temps, const int* seeds,
    const int* toffs, const int* prime, const int* meta, void* ring,
    int* out_cls, int streams, int num_given,
    int total, int t0, int L, int k, int R, int D, int S, int E, int C,
    int chain_floats, float regularize, int seed, int fuse_res,
    int skip_slab, int lane_seed, int head_from, int tile, int cluster,
    void* stream, int* max_clusters, unsigned long long* timers) {
  Args a = {};
  a.w_start = w_start; a.b_start = b_start; a.chain = chain;
  a.w_skip = w_skip; a.b_skip = b_skip; a.w_end1 = w_end1;
  a.b_end1 = b_end1; a.w_end2 = w_end2; a.b_end2 = b_end2;
  a.cond = cond; a.w_cond = w_cond; a.gcond = gcond;
  a.M = M; a.cond_rows = M;  // 0 without cond
  a.qscale = qscale;
  a.temps = temps; a.seeds = seeds; a.toffs = toffs; a.prime = prime;
  a.meta = meta; a.ring = ring; a.out_cls = out_cls; a.timers = timers;
  a.streams = streams; a.num_given = num_given; a.total = total; a.t0 = t0;
  a.L = L; a.k = k; a.R = R; a.D = D; a.S = S; a.E = E; a.C = C;
  a.CS = cluster; a.F = chain_floats;
  a.temperature = 0.f; a.regularize = regularize;
  a.seed = (unsigned)seed;
  a.fuse_res = fuse_res; a.skip_slab = skip_slab; a.lane_seed = lane_seed;
  a.head_from = head_from;
  if (cluster != 8 || head_from < 0 || head_from >= num_given) return -1;
  const int tiles = (streams + tile - 1) / tile;
  return launch_tile(a, tile, tiles, static_cast<cudaStream_t>(stream),
                     max_clusters);
}
