// Fused WaveNet generation loop for Hopper (sm_90a): kernel K1.
//
// Replaces the JAX package's Pallas TPU kernel
// pytorch_wavenet_tpu/ops/pallas/gen_kernel.py::generate_fast_fused
// (_make_kernel, one pallas_call for the whole autoregressive loop).
//
// Up to 8 streams in ONE launch per call: priming, generation, sampling,
// feedback and the ring state. The rings are the FusedGenState layout
// (layer after layer, row slot * streams + s, R channels each); one scalar
// temperature T for every stream (logits / T + gumbel at T > 0); the
// Gumbel noise is the counter hash of gen_common.cuh keyed by (class *
// streams + stream, ta, seed), as K4 keys it without lane_seed. The skip
// row, sum_l (u_l @ w_skip[l] + b_skip[l]), is summed as one product over
// all layers' units; fuse_res walks the chain with wf[l] = w_res[l] @
// w_cur[l+1].
//
// What bounds it on this card: one stream's step is a serial chain of L
// small products and a head over ~6.5 MB of weights at chaconne widths
// (~3.6 MFLOP): far below the card's memory and f32 rates, so latency
// bounds it. A single SM would re-read every weight from L2 through its
// one port each step and pay an L2 round trip per phase of every layer.
// What the design does about it: the core in gen_cluster.cuh with one
// cluster of 16 SMs holding all streams as the lanes of one 8-lane tile:
// the chain's weights stay in the cluster's shared memory, a layer costs
// one cluster barrier (fuse_res) and about 2 us, a step's taps arrive with
// one wait, and the head's weights are read by 16 SMs, each its own
// columns, on the tensor cores in 3xTF32. Local conditioning arrives as
// rows projected outside the kernel (as the TPU kernel takes it: one
// product over every step of the call), copied with the taps, a step
// ahead, and added to the tap products; it moves L*2D*4 bytes per stream
// and step and adds nothing to the chain.

#include "gen_cluster.cuh"

using gen_cluster::Args;

// Dynamic shared memory (bytes) of one block of the cluster with a cond
// slab of `cond_rows` rows (0 without local conditioning); *resident says
// whether the chain weights are in it.
extern "C" int wavenet_gen_fused_smem(int cluster, int L, int k, int R, int D,
                                      int S, int E, int C, int fuse_res,
                                      int cond_rows, int* resident) {
  return gen_cluster::shared_bytes(8, cluster, L, k, R, D, S, E, C, fuse_res,
                                   cond_rows, resident);
}

// Launch on `stream`; `cond` (total, L, streams, 2D) and `gcond` (L,
// streams, 2D) are the projected conditioning rows, each null when absent
// (`cond_rows`, the slab's rows, 0 then). Steps t < `head_from` (at most
// num_given - 1) are teacher-forced and run without the head: their
// out_cls entry is the prime's next class (gen_cluster.cuh). Returns the
// cudaError_t of the launch (0 = success), -1 for a cluster size other
// than 16, more than 8 streams or a head_from outside [0, num_given), -2
// for a config whose buffers exceed a block's shared memory. With
// `max_clusters` non-null it launches nothing and stores
// cudaOccupancyMaxActiveClusters there.
extern "C" int wavenet_gen_fused(
    const float* w_start, const float* b_start, const float* chain,
    const float* w_out, const float* b_out, const float* w_end1,
    const float* b_end1, const float* w_end2, const float* b_end2,
    const float* cond, const float* gcond, int cond_rows,
    const int* prime, const int* meta, float* rings, int* out_cls,
    int streams, int num_given, int total, int t0, int L, int k, int R, int D,
    int S, int E, int C, int chain_floats, float temperature,
    float regularize, int seed, int fuse_res, int head_from, int cluster,
    void* stream, int* max_clusters) {
  Args a = {};
  a.w_start = w_start; a.b_start = b_start; a.chain = chain;
  a.w_skip = w_out; a.b_skip = b_out; a.w_end1 = w_end1; a.b_end1 = b_end1;
  a.w_end2 = w_end2; a.b_end2 = b_end2;
  a.cond = cond; a.w_cond = nullptr; a.gcond = gcond;
  a.M = 0; a.cond_rows = cond_rows;  // 0 without cond
  a.temps = nullptr; a.seeds = nullptr; a.toffs = nullptr;
  a.prime = prime; a.meta = meta; a.ring = rings; a.out_cls = out_cls;
  a.streams = streams; a.num_given = num_given; a.total = total; a.t0 = t0;
  a.L = L; a.k = k; a.R = R; a.D = D; a.S = S; a.E = E; a.C = C;
  a.CS = cluster; a.F = chain_floats;
  a.temperature = temperature; a.regularize = regularize;
  a.seed = (unsigned)seed;
  a.fuse_res = fuse_res; a.skip_slab = 0; a.lane_seed = 0;
  a.head_from = head_from;
  if (cluster != 16 || streams < 1 || streams > 8 || head_from < 0 ||
      head_from >= num_given)
    return -1;
  return gen_cluster::launch<8, true>(a, 1, static_cast<cudaStream_t>(stream),
                                      max_clusters);
}
