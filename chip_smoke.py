#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the port's sources; without a card, or outside a
checkout, it exits nonzero and prints no result.

Phases (any failure stops the run with a nonzero exit):
  1. the card: ``nvidia-smi`` name and power limit, torch, device name;
  2. build: every ``csrc/*.cu`` with ``nvcc`` (``-Xptxas -v`` printed:
     registers, spills); the generation core's shared memory per block and
     ``cudaOccupancyMaxActiveClusters`` at every compiled width;
  3. kernel K1 (the fused generation loop) against its plain PyTorch
     version at full width, chaconne and saber, exact and ``fuse_res``:
     teacher-forced classes (and again with ``head_from = total - 1``:
     its headless kernel's ring and class read bitwise the headed
     kernel's, both launches counted; so every teacher-forced check of K1
     and K4 below), free-running rollouts at temperature 0 and 1,
     a resumed chunk (t0 = rf, temperature 0.9, the serving call), a
     3-chunk resumed rollout equal to one shot bitwise, and chunks resumed
     at t0 = 0, 1, 2 and 513 equal to one shot bitwise;
  4. serving (the main path): chaconne with random weights from a seed,
     written as a checkpoint, served by ``serving.server.main`` on a free
     port; three /synthesize requests; the kernel's launch count read
     around exactly this phase;
  5. times with CUDA events: K1 at the serving chunk and for chaconne
     (a full-rf prime, temperature 1; the bench shape, saber, is phase
     36's); the plain version; the bound from the shapes;
  6. kernel K4 (batched many-stream generation) against its plain version
     at chaconne width, 256 lanes and 200 (a tail tile), exact and
     ``fuse_res + skip_slab``: a teacher-forced prime, rollouts at
     temperature 0 and hot with per-lane seeds, temperatures and clocks,
     a resumed chunk at the pool's clock, three resumed chunks equal to
     one shot bitwise, NaN-filled fresh rings giving the classes of
     zeroed ones, a fresh call equal bitwise (classes and ring) to the
     same rollout at the pool's clock over zeroed history, chunks resumed
     at t0 = 0, 1, 2 and 513 equal to one shot bitwise, the same lanes
     bitwise equal at every width of lanes per cluster, and kernel sizes 1
     and 3 (K1 and K4) against the plain versions;
  7. the ContinuousBatcher on the card (chaconne, 256 lanes): staggered
     greedy requests and bursts of seeded hot ones, each equal to its solo
     call bitwise;
  8. batched serving (the main path of this slice): chaconne served by
     ``serving.server.main --batcher --lanes 256 --batch-chunk 2048``; 64
     concurrent 16000-sample requests, all complete, two byte-equal to
     their solo rollouts, /stats counting them; K4's launch count read
     around exactly this phase, and the plain version barred from it;
     aggregate samples/s and time to first audio;
  9. times with CUDA events: K4 on a resumed 2048-step chunk at 128, 256
     and 1024 lanes, per width of lanes per cluster at 256 and 1024 lanes,
     a step's split into phases (the kernel's own timers) and the depth
     sweep; the plain version; the bound from the shapes;
 10. kernels K2 and K3 (the training trunk's forward and backward) against
     their plain versions at chaconne_wide, batch 16, output_length 1024,
     and at batch 3 with kernel_size 3 on a short window, with f32 and bf16
     saves; two K3 calls bitwise equal;
 11. one train step's gradients through K2/K3 against autograd of the
     plain model (chaconne_wide, batch 16), f32 and bf16 saves;
 12. training (the main path of this slice): chaconne_wide, batch 16, 20
     steps through ``training.train.main`` on the example audio, snapshot
     at step 10; K2/K3 launch counts read around exactly this run, the
     plain trunk barred from it; the loss falls; a run resumed from the
     step-10 snapshot ends at the uninterrupted run's params;
 13. times with CUDA events: the train step (and with the plain trunk),
     K2 and K3 at bf16 and f32 saves beside their bounds (3xTF32, and the
     f32 bound of the FMA kernels they replaced), their device time split
     by CUDA kernel (``torch.profiler``: K3's layer, dh0 and reduction
     launches, K2's per layer), the plain trunk, and the step's split into
     embed, trunk, skip and head, loss and optimizer;
 14. kernel K1 at the vocoder preset (R = D = 64: the chain read from L2,
     80 mel channels, plus 16 global ones) against its plain version,
     without and with projected cond and gcond rows, exact and fuse_res:
     teacher-forced, a resumed chunk; a chunked conditioned rollout equal
     to one shot bitwise;
 15. kernel K4 at the vocoder, 256 and 200 lanes, exact and fuse_res +
     skip_slab, without and with cond rows (the product with w_cond in the
     kernel) and gcond: teacher-forced, a resumed chunk at the pool's
     clock (t0 = 513); the same 200 lanes at every width that fits bitwise
     equal, chunks resumed at t0 = 513 and a fresh call over zeroed
     history equal to one shot bitwise;
 16. /vocode (the main path of this slice): the vocoder preset served by
     ``serving.server.main`` on ``examples/generated_t1.0.wav``: two
     single-stream requests (K1 through ``synthesize``), each byte-equal to
     ``synthesize`` on the same mel, then ``--batcher --lanes 256
     --batch-chunk 2048 --cond-hop 256`` with 16 concurrent requests (K4,
     mel frames expanded on the card), each byte-equal to its solo
     rollout of the same frames; launches counted around each, the plain
     versions barred;
 17. times with CUDA events at the vocoder: K1 (one stream) and K4 (256
     lanes) on a resumed VOCODER_CHUNK-step chunk without conditioning,
     with cond rows and with cond and gcond, the cost of each, bounds, a
     K4 step's phase split, and the plain versions on the conditioned
     chunk;
 18. kernels K2 and K3 with local conditioning (80 mel channels) against
     their plain versions at the vocoder, batch 4, out 1024, f32 and bf16
     saves: u, every gradient, dW_cond and dcond; two conditioned K3 calls
     bitwise equal;
 19. vocoder training (the main path of this slice): ``training.train.main
     --config vocoder --cond-upsample 16,16 --batch-size 16`` on the
     example audio, 10 steps with a snapshot at step 5 (mel frames on the
     host, the learnable upsampler on the card, K2/K3 with cond); K2/K3
     launch counts read around exactly this run, the plain trunk barred;
     the loss on the first batch falls; a run resumed from the step-5
     snapshot ends at the uninterrupted run's params;
 20. times with CUDA events at the vocoder, batch 16, out 1024: K2 and K3
     without and with cond beside their bounds, their plain versions, K3's
     device time by CUDA kernel (its reduction apart), the conditioned
     train step, its split (upsampler, trunk, skip and head, optimizer)
     and training targets per second;
 21. kernels K2 and K3 at a bf16 stream (``cfg.stream_dtype``) against
     their plain versions at chaconne_wide, batch 16, out 1024, and at the
     vocoder with cond, batch 4: layer by layer from the kernel's own
     stream (u within U_TOL, the stream's bf16 flips counted and each
     within one ulp), K3 on the kernel's saves, two K3 calls bitwise equal,
     f32 and bf16 saves giving bitwise the same gradients;
 22. ``--bf16`` training (the main path of this slice): ``training.train.
     main --config chaconne_wide --bf16 --batch-size 16``, 20 steps with a
     snapshot at 10 and a resumed run, K2/K3 launches counted and the plain
     trunk barred (as phase 12); then its times and step split (as phase
     13), and the f32 and ``--bf16`` steps with their optimizer and loss
     parts timed in alternation;
 23. kernel K4 with bf16 and int8 rings against its plain version at
     chaconne, 256 lanes, fuse_res + skip_slab, int8 scales from
     ``calibrate_ring_scales``: teacher-forced, then the pool's resumed
     chunk (RING_LOCKSTEP steps) step by step from the kernel's state
     (classes off near-ties, ring writes within one bf16 ulp or int8
     count; the teacher-forced steps also in one launch, with the head
     and with ``head_from``, bitwise the lockstep's), the one-step launches and three resumed chunks equal to one
     launch bitwise, timed on that chunk; the vocoder with cond + gcond at
     bf16 rings (256 steps in lockstep); times and the
     phase split (the vocoder on phase 17's chunk, f32 and bf16 rings in
     alternation); then ``generate_fast_batched(ring_dtype=int8)`` in two
     chunks with its launches counted;
 24. batched serving with ``--bf16-rings`` (the main path of this slice):
     phase 8's burst with the pool's ring in bf16, two responses equal to
     their bf16-ring solo rollouts;
 25. the training remainder (the main path of this slice):
     ``training.train.main --config chaconne_wide --batch-size 16`` for 20
     micro-steps with a cosine schedule after a 4-step warmup,
     ``--accum-steps 2``, ``--ema-decay 0.999``, a TensorBoard log and the
     audio hook at step 20 (``generate_audio``: 16000 samples at
     temperatures 0.5 and 1.0 in one K4 rollout, on the logger's thread,
     joined); snapshots every 5 micro-steps, so steps 5 and 15 fall in the
     middle of an accumulation; K2/K3 launches (20 each) and the hook's K4
     launch counted around exactly this run with the plain trunk and K4's
     plain version barred; the loss on the first batch falls; a run
     resumed from the async step-5 snapshot ends bitwise at the
     uninterrupted run's params, EMA and optimizer state; the event file
     parses back with every CRC checked (loss scalars, every parameter's
     and gradient's histogram, two 16000-sample clips); 5 steps of
     ``--optimizer sgd_normalized --momentum 0.9`` give a finite loss; the
     native codec loads, and its gather and quantizer are timed against
     numpy's on the host; then K4 at the hook's shape against its plain
     version, timed;
 26. ``serve --ema`` (the main path of this slice): phase 25's step-20
     snapshot served by ``serving.server.main --ema``, one request single
     stream (K1) and one through ``--batcher`` (K4), each byte-equal to a
     solo rollout of the EMA params that ``find_ema_state_dict`` takes from
     the same file, launches counted around each, the plain versions
     barred; then the train step's times under Adam, Adam with an EMA,
     ``sgd_normalized`` and phase 25's stack per micro-step, each with its
     optimizer part alone, and the training thread's stall in an async
     snapshot against a synchronous ``save_checkpoint``.
 27. speculation at full width: the chaconne teacher from seed 1234;
     ``gen_step_window`` over windows of 1, 8 and 20 against as many
     chained ``gen_step`` calls (logits within 1e-5 x max(1, |y|); after
     ``commit_window`` each ring slot holds its last pending input
     bitwise, the steps' rings within 1e-5 x max(1, |h|) with the values
     that differ counted, and the draft's recorded steps committed equal
     the steps bitwise); ``speculative_generate`` for 2048 samples after a
     512-class prime at k = 4 and 8 with the teacher as its own draft
     (accept rate exactly k) and a one-block draft (chaconne, blocks=1:
     the teacher's first block under its embedding and head),
     every class the teacher's argmax on its history off near-ties and
     the rollouts equal to the plain ``generate_fast(T=0)`` and to K1 at
     T = 0 up to a first difference at a near-tie (counted); samples/s,
     accept rate and host syncs a sample beside K1's samples/s;
 28. distillation (the main path of this slice): K2 against its plain
     version at N 4, out 931 (chaconne, and the vocoder with cond), timed
     beside its bound; the distillation loss with the teacher through K2
     against the plain trunk within 1e-5 relative; ``distill_cli.main``
     for 10 steps on phase 25's chaconne_wide step-20 snapshot with
     ``--data-dir`` (the example audio), the default student, batch 4,
     length 4000, K2/K3 launches counted around exactly this run (10 and
     0) with the plain trunk barred; a run resumed from the step-5
     snapshot ends at the step-10 params bitwise; 3 steps on a vocoder
     teacher from seed 1234 (K2's COND instantiation, 3 launches); each
     step's split (the student's draw, the teacher, the loss and its
     backward, the optimizer);
 29. the student served: ``serving.server.main --student-snapshot`` on
     phase 28's students, ``/synthesize`` of 16000 samples byte-equal to
     ``student_generate`` with the request's seed, ``/vocode`` of
     ``examples/generated_t1.0.wav`` on the conditioned student byte-equal
     to ``student_synthesize``; request times;
 30. ``generate_long`` at chaconne: K1 (1 stream) and K4 (256 lanes),
     16384 samples in chunks of 4096, each bitwise equal to one call at
     T = 0 and 0.9 with the same seed, a progress call after every chunk;
     ``streaming=False`` on K1 against the plain ``generate_long`` at T = 0
     on a 6-layer cut (classes off near-ties); temperatures (0, 0.9, 0,
     1.0) in one plain ``generate_fast`` rollout on the card, the 0
     streams bitwise the scalar T = 0 rollout; ``progress_callback``
     leaving the plain rollout bitwise unchanged;
 31. reference snapshots: a chaconne-shaped whole-module pickle made here
     (stub ``wavenet_model`` module, random weights) loaded on the card by
     ``load_reference_snapshot``, round-tripping bitwise through
     ``to_reference_state_dict``, served with ``--torch-snapshot``: a T = 0
     response byte-equal to K1 on the converted params;
 32. ``/reload`` (the main path of this slice): ``--batcher --lanes 256
     --batch-chunk 2048 --reload-interval 1`` on snapshot A; /reload to B
     while a 64000-sample request streams (it completes, /stats failed 0);
     the next request byte-equal to K4 on B; snapshot C written into the
     directory rolled in by the follower (a request equal to K4 on C);
     another config 400; then /reload on the single-stream server (K1);
 33. ``/profile``: a 2 s capture during 16 pooled requests, a second
     capture 409, the Chrome trace naming K4's kernel with its device time
     (launches and ms printed), the responses byte-equal to solo K4;
 34. ``--backend plain`` on the card (``cuda-plain``): 512 samples at
     T = 0 byte-equal to ``generate_fast``, K1's classes off near-ties, no
     kernel launched;
 35. the generate CLI in subprocesses started together: ``--snapshot`` at
     1 stream (K1) and 16 (K4), ``--torch-snapshot``, ``--vocode-wav`` at
     the vocoder, ``--ema`` on phase 25's snapshot, each wav byte-equal to
     the library call it printed; ``--draft-snapshot`` without
     ``--force-speculate`` refused. Each phase's seconds are printed;
 36. the single-card tools (phases 36-41), each run in this process through
     its ``main`` with its output logged under its name and its launches
     per kernel counted from zero around it: the port's one-line metric
     ``pytorch_wavenet_tpu_torch.bench`` (K1 at saber, 65536 samples, 3
     launches);
 37. ``scripts.serving_bench`` at chaconne, 256 lanes, chunk 2048, 256
     requests in flight until 512 of 16000 samples complete (f32 rings),
     then with ``--device-profile`` (bf16 rings): K4's device time inside
     the traced window at most the window;
 38. ``serving_bench`` at the vocoder with mel frames (``--cond --cond-hop
     256``), 256 requests;
 39. ``scripts.serving_soak`` at chaconne, 256 lanes, for SOAK_SECONDS with
     ``update_params`` every SOAK_RELOAD s, then for SOAK_CHECK_SECONDS
     without reloads, greedy requests held bitwise against their solo K4
     rollouts: the script's invariants, no request failed, every reload
     installed, some requests checked;
 40. ``scripts.benchmark`` at chaconne (BENCHMARK_ARGS: the train step on
     K2/K3, K1 exact and fuse_res, K4's sweep up to 512 streams), the
     launches of each part exact;
 41. ``scripts.distill_demo`` in both modes at its default widths with
     DEMO_STEPS (K2/K3 in the teacher's training, K2 in distillation, the
     rollouts on K1), metrics finite, the student snapshot read back;
 42. the multi-rank layer (phases 42-45; every rank a process, all of them
     sharing the one card through gloo, the backend printed; the ranks of
     42, 44 and 45 spawned together, 2 and 4 of them):
     ``parallel_train_step`` at chaconne_wide, global batch 16, meshes
     2x1 and 1x2 for 3 steps and 2x2 for 1, against the one-rank
     ``train_step`` on the global batch (losses within S13_LOSS_RTOL, the
     first step's gradients within GRAD_TOL x max(1, scale), params
     within 2 lr a step), K2/K3 launched once a step on every rank;
 43. the train CLI under ``torch.distributed.run`` on 2 ranks (1x2) at
     chaconne_wide, 10 steps with sharded snapshots at 5 and 10 (each
     rank's K2/K3 launches from the line rank 0 prints); a 2-rank run
     resumed from the step-5 snapshot ends bitwise at the step-10 one, and
     a 1-rank ``--resume`` loads the sharded snapshot and trains on;
 44. ``sharded_pool_step`` at chaconne, 256 lanes over 2 ranks, a resumed
     2048-step chunk through K4 (one launch a rank), classes and ring
     bitwise equal to one unsharded K4 call;
 45. ``time_sharded_loss`` at chaconne (T 4096 in 2 blocks) against the
     unsharded loss and gradients, ``generate_pipelined`` over 2 stages
     bitwise ``generate_fast`` on each group (plain PyTorch on the card),
     and ``scripts.scaling_bench`` at 1 and 2 ranks (its K2/K3 launches
     per rank checked);
 46. the lane pool on a mesh (its 2 ranks spawned with phase 44's, sharing
     the card through gloo): ``ContinuousBatcher(mesh=)`` on rank 0 and
     ``follow_pool`` on rank 1 at chaconne, 256 lanes (128 a rank), chunk
     2048, fuse_res + skip_slab: 64 requests of 16000 samples with
     full-rf primes at T 0, 0.9 and 1.0 (seeded), half admitted once the
     first chunk is out, each bitwise one K4 call of the 64 as lanes; the
     same load on a one-rank pool (bitwise, timed beside it and beside
     phases 8 and 24); ``update_params`` while a request streams, then 130
     requests on lanes of both ranks bitwise K4 on the new weights; the
     vocoder's frames mode (8 requests of 4096 samples at hop 256 on 8
     lanes) bitwise; each rank's K4 launches (a prewarm step, its pool
     steps, its prime calls; the plain version barred) and the cross-rank
     bytes a pool step and an admission; then ``serving.server --batcher
     --mesh-data 2`` under ``torch.distributed.run``: 4 seeded requests
     byte-equal to the one-process server's, SIGINT to rank 0, both ranks
     exit 0 with their K4 launches printed;
 47. the wide-chain kernel KW (``gen_kernel_wide.py``) through
     ``scripts/torch_wide_check.py``'s checks: against its plain version
     at ``tiny_wnv`` (1, 5, 64 and 70 lanes, and 64 resumed at step
     5000) and ``wnv512`` (3 and 256 lanes, and 256 resumed at step
     5000), a lane's classes and ring bitwise at 1, 40 and 256 lanes, a
     256-lane ``wnv512`` call of 128 steps timed with its timers' split,
     the lane pool in frames mode at ``wnv512`` (10 requests, each
     bitwise its solo ``generate_fast_batched``; the wide kernel
     launched, K4 not; the launch counters set to 0 just before it, so
     the kernels line gives the pool run's own launches), one stream
     through ``generate_fast_fused`` and chaconne still on K4.

``python3 chip_smoke.py --remainder-only`` runs phases 1, 2, 25 and 26 only,
``--distill-only`` phases 1, 2, 25 (the teacher) and 27-29,
``--slice11-only`` phases 1, 2, 25 (the ``--ema`` snapshot) and 30-35,
``--slice12-only`` phases 1, 2 and 36-41, ``--slice13-only`` phases 1,
2 and 42-45, ``--slice14-only`` phases 1, 2 and 46, and ``--wide-only``
phases 1, 2 and 47; each exits 1 without a result (short calls while
working on them).

The line before the last is one JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.

Tolerances: the kernel and the plain version sum in different orders, so
a class may differ only where the plain version's top-2 score gap is below
NEAR_TIE; ring states agree within RING_TOL (f32 rounding of O(1) values
over a few hundred layer updates). K2's units agree within U_TOL x max(1,
|u|); K3's gradients within GRAD_TOL x max(1, scale) of the plain version
on the same saves and of the exact gradients with f32 saves, and within
GRAD_TOL_BF16 with bf16 saves (the rule of tests/test_trunk_kernel.py).
"""

import functools
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

NEAR_TIE = 1e-4
RING_TOL = 1e-4
SEED = 1234
F32_PEAK_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
TF32_PEAK_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores (dense)
BF16_PEAK_FLOPS = 989e12  # H100 SXM, bf16 on the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*args):
    print(*args, flush=True)


# ------------------------------------------------------------------ phases


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    # the plain version is the reference: full f32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("reference matmuls in full f32 (allow_tf32 = False)")
    return card


def phase_build():
    from pytorch_wavenet_tpu_torch.ops.cuda import build

    t = time.time()
    logs = build.build(verbose=True)
    for name, out in logs.items():
        for line in out.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "entry function" in line):
                log(f"[nvcc {name}] {line.strip()}")
    log(f"build: {sorted(logs)} in {time.time() - t:.1f} s")


def phase_clusters(torch, pt, gk, ghbm, card):
    """cudaOccupancyMaxActiveClusters and the shared memory of the
    generation core at chaconne, for every compiled width."""
    cfg = pt.get_config("chaconne")
    log(f"[clusters] K1 chaconne fuse_res, cluster {gk.CLUSTER}: "
        f"{gk.shared_bytes(cfg, True)} B shared per block, max "
        f"active clusters {gk.max_active_clusters(cfg, True)} [{card}]")
    for tile in ghbm.TILES:
        n = ghbm.max_active_clusters(cfg, tile, True, True)
        nbytes, resident = gk.shared_bytes_for(cfg, tile, ghbm.CLUSTER, True)
        log(f"[clusters] K4 chaconne fuse_res, {tile} lanes per cluster "
            f"of {ghbm.CLUSTER}: {nbytes} B shared per block (chain weights "
            f"{'resident' if resident else 'read from L2'}), max active "
            f"clusters {n} [{card}]")


def _flip_gap(miss, gaps):
    """The largest top-2 gap of the plain version's scores at a class
    mismatch: the kernel's score error there is at least half of it."""
    return float(gaps[miss].max()) if bool(miss.any()) else 0.0


def _first_mismatch(a, b):
    diff = (a != b).nonzero()
    return int(diff[0, -1]) if diff.numel() else -1


def _headless_check(torch, mod, launch, prime, ck, rk, cp, gaps, rp, tag):
    """A teacher-forced case again, on fresh rings, with ``head_from =
    total - 1`` (``launch(ring, head_from)`` returns the classes): its
    teacher-forced steps run in the headless kernel, launched once besides
    the kernel (``mod``'s counters). The ring and the one class read are
    bitwise those of the same kernel with the head on every step (``ck``,
    ``rk``), so within RING_TOL of the plain ring ``rp`` and equal to the
    plain class ``cp`` off a near-tie (``gaps``); each headless position
    holds the prime's next class. Returns the ring error against ``rp``."""
    total = ck.shape[1]
    before = (mod.launches, mod.headless_launches)
    ring = torch.zeros_like(rk)
    ch = launch(ring, total - 1)
    torch.cuda.synchronize()
    counted = (mod.launches - before[0], mod.headless_launches - before[1])
    err = float((ring.float() - rp.float()).abs().max())
    tie = gaps[:, -1] < NEAR_TIE
    last = int(((ch[:, -1] != cp[:, -1]) & ~tie).sum())
    same = torch.equal(ring, rk) and torch.equal(ch[:, -1], ck[:, -1])
    fed = torch.equal(ch[:, :-1], prime[:, 1:total])
    log(f"[{tag}] head_from {total - 1}: launches (kernel, headless) "
        f"{counted}; ring and class read bitwise those of head_from 0: "
        f"{same}; headless positions the prime's next class: {fed}; ring "
        f"max abs err against plain {err:.3g}, {last} read classes off "
        f"plain's away from a near-tie")
    check(counted == (1, 1), f"{tag} head_from: launches {counted}")
    check(same and fed, f"{tag}: head_from {total - 1} differs from "
          f"head_from 0")
    check(err <= RING_TOL and last == 0,
          f"{tag} head_from: ring error {err}, {last} classes off plain")
    return err


def phase_kernel_vs_plain(torch, pt, gk, dev):
    """Returns the largest ring error and the class mismatch and near-tie
    counts over every comparison."""
    worst, mismatches, near_ties = 0.0, 0, 0
    for name in ("chaconne", "saber"):
        cfg = pt.get_config(name)
        params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
        rf, C = cfg.receptive_field, cfg.classes
        ring_size = sum(gk.periods(cfg)) * cfg.residual_channels
        for fuse in (False, True):
            w = gk.prepare_weights(params, cfg, fuse)
            tag = f"{name} {'fuse_res' if fuse else 'exact'}"

            # teacher-forced: prime of rf + 512 classes, one sample after
            prime = torch.randint(0, C, (1, rf + 512),
                                  generator=torch.Generator().manual_seed(7))
            prime = prime.to(dev, torch.int32)
            total = prime.shape[1]
            rk, rp = (torch.zeros(ring_size, device=dev) for _ in range(2))
            ck = gk.fused_cuda(w, cfg, prime, rk, 0, total, 0.0, 0.0, 0, fuse)
            torch.cuda.synchronize()
            cp, gaps = gk.fused_plain(w, cfg, prime, rp, 0, total, 0.0, 0.0, 0,
                                      fuse, return_gaps=True)
            forced = slice(0, total - 1)
            miss = ck[:, forced] != cp[:, forced]
            ties = gaps[:, forced] < NEAR_TIE
            bad = int((miss & ~ties).sum())
            err = float((rk - rp).abs().max())
            log(f"[K1 {tag}] teacher-forced {total - 1} steps: "
                f"{int(miss.sum())} class mismatches ({bad} not at a near-tie, "
                f"largest gap at one {_flip_gap(miss, gaps[:, forced]):.3g}), "
                f"{int(ties.sum())} near-ties (gap < {NEAR_TIE}), "
                f"ring max abs err {err:.3g}")
            check(bad == 0, f"{tag}: kernel disagrees with plain off a near-tie")
            check(err <= RING_TOL, f"{tag}: ring error {err} > {RING_TOL}")
            err = max(err, _headless_check(
                torch, gk, lambda r, h: gk.fused_cuda(
                    w, cfg, prime, r, 0, total, 0.0, 0.0, 0, fuse,
                    head_from=h), prime, ck, rk, cp, gaps, rp, f"K1 {tag}"))
            worst = max(worst, err)
            mismatches += int(miss.sum())
            near_ties += int(ties.sum())

            def rollout(what, prime, rk, t0, total, temp, seed):
                """Kernel and plain version from the same rings; they agree
                up to the first near-tie. Returns 1 if they part there."""
                rp = rk.clone()
                ck = gk.fused_cuda(w, cfg, prime, rk, t0, total, temp, 0.0,
                                   seed, fuse)
                torch.cuda.synchronize()
                cp, gaps = gk.fused_plain(w, cfg, prime, rp, t0, total, temp,
                                          0.0, seed, fuse, return_gaps=True)
                first = _first_mismatch(ck, cp)
                if first >= 0:
                    gap = float(gaps[0, first])
                    check(gap < NEAR_TIE, f"{tag} {what}: rollouts part at "
                          f"step {first} where the plain gap is {gap}")
                    log(f"[K1 {tag}] {what}: identical up to step {first}, "
                        f"a near-tie (gap {gap:.2g})")
                    return 1
                err = float((rk - rp).abs().max())
                check(err <= RING_TOL, f"{tag} {what}: ring error {err}")
                log(f"[K1 {tag}] {what}: identical over {total} steps, ring "
                    f"max abs err {err:.3g}")
                return 0

            # free-running rollouts, temperature 0 and 1 (shared noise)
            short = prime[:, :64].contiguous()
            for temp in (0.0, 1.0):
                n = rollout(f"free-running T={temp}", short,
                            torch.zeros(ring_size, device=dev), 0,
                            short.shape[1] - 1 + 384, temp, 99)
                mismatches += n
                near_ties += n

            # a resumed chunk, the main path's call: rings filled by an
            # rf-step call, then 300 steps from t0 = rf at T = 0.9
            rk = torch.zeros(ring_size, device=dev)
            head = gk.fused_cuda(w, cfg, prime[:, :rf].contiguous(), rk, 0, rf,
                                 0.0, 0.0, 0, fuse)
            n = rollout("resumed chunk t0=rf T=0.9",
                        head[:, -1:].contiguous(), rk, rf, 300, 0.9, 21)
            mismatches += n
            near_ties += n

            # 3-chunk resume equals one shot, bitwise, at temperature 1
            one = short[:, :8].clone()
            _, c_all, s_all = pt.generate_fast_fused(
                params, cfg, 5, 3000, one, temperature=1.0, return_state=True,
                fuse_res=fuse, device=dev)
            _, c1, st = pt.generate_fast_fused(
                params, cfg, 5, 1000, one, temperature=1.0, return_state=True,
                fuse_res=fuse, device=dev)
            _, c2, st = pt.generate_fast_fused(
                params, cfg, 5, 1200, None, state=st, temperature=1.0,
                return_state=True, fuse_res=fuse, device=dev)
            _, c3, st = pt.generate_fast_fused(
                params, cfg, 5, 800, None, state=st, temperature=1.0,
                return_state=True, fuse_res=fuse, device=dev)
            same = torch.equal(torch.cat([c1, c2, c3], dim=1), c_all) and all(
                torch.equal(a, b) for a, b in zip(st.rings, s_all.rings))
            check(same, f"{tag}: chunked rollout differs from one shot")
            log(f"[K1 {tag}] 3-chunk resume (1000+1200+800) equals one shot "
                f"bitwise (classes and rings)")

            # a resumed chunk at clock offsets 0, 1, 2 and 513 (the taps of
            # a call's first step are issued before its loop)
            _, c_one, s_one = pt.generate_fast_fused(
                params, cfg, 5, 700, one[:, :1], temperature=1.0,
                return_state=True, fuse_res=fuse, device=dev)
            for off in (0, 1, 2, 513):
                if off:
                    _, ca, st = pt.generate_fast_fused(
                        params, cfg, 5, off, one[:, :1], temperature=1.0,
                        return_state=True, fuse_res=fuse, device=dev)
                else:
                    ca = c_one[:, :0]
                    st = pt.FusedGenState(
                        rings=tuple(torch.zeros_like(r) for r in s_one.rings),
                        t=0, cls=one[:, 0].clone())
                _, cb, st = pt.generate_fast_fused(
                    params, cfg, 5, 700 - off, None, state=st,
                    temperature=1.0, return_state=True, fuse_res=fuse,
                    device=dev)
                same = torch.equal(torch.cat([ca, cb], dim=1), c_one) and all(
                    torch.equal(a, b) for a, b in zip(st.rings, s_one.rings))
                check(same, f"{tag}: chunk resumed at t0={off} differs from "
                      f"one shot")
            log(f"[K1 {tag}] chunks resumed at t0 = 0, 1, 2 and 513 equal "
                f"one shot bitwise (700 samples, classes and rings)")
    return worst, mismatches, near_ties


def _read_wav(blob, n_expected):
    check(blob[:4] == b"RIFF" and blob[8:12] == b"WAVE", "not a RIFF/WAVE body")
    n = struct.unpack("<I", blob[40:44])[0] // 2
    check(n == n_expected, f"wav header says {n} samples, asked {n_expected}")
    check(len(blob) == 44 + 2 * n, f"wav body of {len(blob)} bytes")
    return blob[44:]


def phase_serving(torch, np, pt, gk, dev):
    """The main path. Returns the launches counted around it."""
    from pytorch_wavenet_tpu_torch.serving import server as srv

    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    requests = [(16000, 2048, 0.9, 11), (16000, 2048, 1.0, 12),
                (16000, 2048, 0.0, 13)]
    with tempfile.TemporaryDirectory() as d:
        path = pt.save_checkpoint(d, "chaconne", 0, params, cfg=cfg)
        box, ready = {}, threading.Event()

        def on_ready(server):
            box["server"] = server
            ready.set()

        gk.launches = 0
        th = threading.Thread(target=srv.main, kwargs=dict(
            argv=["--snapshot", path, "--port", "0"], on_ready=on_ready),
            daemon=True)
        t0 = time.time()
        th.start()
        check(ready.wait(600), "server did not come up")
        server = box["server"]
        base = f"http://127.0.0.1:{server.server_address[1]}"
        log(f"[serve] up in {time.time() - t0:.1f} s at {base}")
        bodies = []
        try:
            with urllib.request.urlopen(base + "/health", timeout=60) as r:
                health = json.loads(r.read())
            check(health["status"] == "ok" and health["backend"] == "cuda-fused",
                  f"health: {health}")
            for n, chunk, temp, seed in requests:
                t = time.time()
                url = (f"{base}/synthesize?num_samples={n}&chunk={chunk}"
                       f"&temperature={temp}&seed={seed}")
                with urllib.request.urlopen(url, timeout=600) as r:
                    check(r.headers["Content-Type"] == "audio/wav",
                          "response is not audio/wav")
                    blob = r.read()
                dt = time.time() - t
                bodies.append(_read_wav(blob, n))
                log(f"[serve] {n} samples, chunk {chunk}, T={temp}, seed "
                    f"{seed}: {dt:.2f} s, {n / dt:.0f} samples/s")
        finally:
            server.shutdown()
            th.join(30)
        launched = gk.launches
    check(not th.is_alive(), "server thread did not stop")
    expect = 1 + sum(math.ceil(n / c) for n, c, _, _ in requests)
    log(f"[serve] K1 launches during serving: {launched} (expected {expect}: "
        f"1 warm-up + one per chunk)")
    check(launched == expect, f"{launched} launches, expected {expect}")

    # what came out: finite PCM; the T=0 response equals a one-shot call
    # and agrees with the plain version up to a near-tie
    n, _, _, seed = requests[2]
    pcm = np.frombuffer(bodies[2], "<i2")
    kseed = int(torch.randint(0, 2**31 - 1, (1,),
                              generator=torch.Generator().manual_seed(seed)))
    wav, cls = pt.generate_fast_fused(params, cfg, kseed, n, None,
                                      temperature=0.0, fuse_res=True,
                                      device=dev)
    direct = np.clip(wav[0].cpu().numpy() * 32767.0, -32768, 32767)
    check(np.isfinite(wav.cpu().numpy()).all(), "non-finite waveform")
    check(np.array_equal(pcm, direct.astype("<i2")),
          "T=0 response differs from a one-shot kernel call")
    w = gk.prepare_weights(params, cfg, True)
    prime = torch.full((1, 1), cfg.classes // 2, dtype=torch.int32, device=dev)
    ring = torch.zeros(sum(gk.periods(cfg)) * cfg.residual_channels,
                       device=dev)
    cp, gaps = gk.fused_plain(w, cfg, prime, ring, 0, 300, 0.0, 0.0, 0, True,
                              return_gaps=True)
    first = _first_mismatch(cls[:, :300].to(torch.int32), cp)
    check(first < 0 or float(gaps[0, first]) < NEAR_TIE,
          f"served T=0 audio leaves the plain version at step {first}")
    log(f"[serve] T=0 response equals a one-shot call bitwise; "
        f"{'agrees with' if first < 0 else f'matches up to a near-tie at step {first} of'} "
        f"the plain version over its first 300 samples")
    return launched


def _flops_per_step(cfg):
    """The f32 operations of one step of the function, for either variant,
    as (chain, head): fuse_res reassociates the chain (its wf products
    replace nothing the function needs), so the exact path's products are
    what is counted; the head is the skip row, end1 and end2."""
    k, R, D = cfg.kernel_size, cfg.residual_channels, cfg.dilation_channels
    S, E, C, L = (cfg.skip_channels, cfg.end_channels, cfg.classes,
                  cfg.num_layers)
    return 2 * L * (k * R * 2 * D + D * R), 2 * (L * D * S + S * E + E * C)


def bound_ms(pt, gk, params, cfg, streams, num_given, total, lane_rows=0,
             extra_bytes=0, extra_flops=0, ring_bytes=4, skip_bf16=False):
    """Least time for the call: the larger of its bytes (the model's
    parameters, the prime, the rings (``ring_bytes`` an element: 4, or 2
    and 1 for bf16 and int8 rings) and ``lane_rows`` per-lane f32/int32
    rows read once, classes and rings written once; no fuse_res products,
    no stand-in zero biases; plus ``extra_bytes``, the conditioning rows)
    over the memory rate and its operations at the peak of their type: the
    chain's f32 products (plus ``extra_flops``, K4's cond product) at the
    f32 rate, the head's as the three TF32 products of 3xTF32 each at the
    TF32 rate, except the skip row's under ``skip_bf16`` (skip_slab with a
    bf16 or int8 ring: both operands bf16), one product at the bf16
    rate."""
    ring = sum(gk.periods(cfg)) * streams * cfg.residual_channels * ring_bytes
    nbytes = (4 * pt.parameter_count(params) + 2 * ring
              + 4 * streams * (num_given + total + lane_rows) + extra_bytes)
    chain, head = _flops_per_step(cfg)
    L, D, S = cfg.num_layers, cfg.dilation_channels, cfg.skip_channels
    skip = 2 * L * D * S
    t_skip = (skip / BF16_PEAK_FLOPS if skip_bf16
              else 3 * skip / TF32_PEAK_FLOPS)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (streams * total * (chain / F32_PEAK_FLOPS
                                + 3 * (head - skip) / TF32_PEAK_FLOPS
                                + t_skip)
             + extra_flops / F32_PEAK_FLOPS)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def trunk_bounds(cfg, batch, out_len, save_bytes=2, tf32x3=True,
                 cond_channels=0, stream_bf16=False):
    """Bounds of the training trunk kernels K2 (forward) and K3 (backward)
    from their shapes: ``{name: (ms, bound_by)}``.
    Layer l's gated unit is needed on the output window widened by every
    later layer's lookback (W_l positions per item; the JAX kernel's
    ``_windows`` without its 128-lane rounding). Forward operations per
    position: the fused tap product 2*(k*R)*(2D) and the residual product
    2*D*R; bytes: the embedded input stream (f32) read once, the gated
    units (batch, out, L*D) f32 written once, each layer's input window
    saved once in bf16, and the trunk weights. Backward: the tap product
    recomputed and two of its size for the weight and input gradients, two
    of the residual product's size; bytes: the saves and the units'
    gradient read once, the input stream's gradient and the weight
    gradients written once. The kernels form every product in 3xTF32, so
    an operation counts as three TF32 operations on the tensor cores
    (``tf32x3``); ``tf32x3=False`` gives the f32 bound of the FMA kernels
    they replaced (67 TFLOP/s outside the tensor cores). With
    ``cond_channels`` M the cond product adds 2*M*2D operations a position
    forward and three times that backward (recompute, dW_cond, dcond), and
    its bytes: w_cond, the cond rows (f32, read once by each kernel) and
    dcond (written once by K3). With a bf16 stream (``stream_bf16``) the
    input stream and the cond rows count 2 bytes an element, and each
    product counts at the peak of its operands' type: one whose two
    operands are bf16 values (the tap and cond products forward and their
    recompute) at the bf16 rate; one with an f32 operand as the TF32
    products the kernels run, two with a bf16 operand (the residual product
    forward, du and dv through the bf16 weights, dW_in and dW_cond against
    the bf16 rows) and three with none (dW_res)."""
    k, R, D, L = (cfg.kernel_size, cfg.residual_channels,
                  cfg.dilation_channels, cfg.num_layers)
    M = cond_channels
    T = cfg.receptive_field + out_len - 1
    W, reach = [], 0
    for d in reversed(cfg.dilations):
        W.append(min(T, out_len + reach))
        reach += (k - 1) * d
    pos = batch * sum(W)
    tap, res, cnd = 2 * k * R * 2 * D, 2 * D * R, 2 * M * 2 * D
    w_bytes = 4 * L * (k * R * 2 * D + 2 * D + D * R + R + M * 2 * D)
    cond = 4 * batch * T * M
    saves = save_bytes * R * pos
    units = 4 * batch * out_len * L * D
    stream = 4 * batch * T * R
    rate = TF32_PEAK_FLOPS / 3 if tf32x3 else F32_PEAK_FLOPS
    t_fwd = pos * (tap + res + cnd) / rate
    t_bwd = pos * (3 * tap + 2 * res + 3 * cnd) / rate
    stream_in, cond_in = stream, cond
    if stream_bf16:  # bf16 x bf16 at the bf16 rate, TF32 products apart
        t_fwd = pos * ((tap + cnd) / BF16_PEAK_FLOPS
                       + 2 * res / TF32_PEAK_FLOPS)
        t_bwd = pos * ((tap + cnd) / BF16_PEAK_FLOPS
                       + ((2 + 2) * (tap + cnd) + (2 + 3) * res)
                       / TF32_PEAK_FLOPS)
        stream_in, cond_in = stream // 2, cond // 2
    out = {}  # saves in bf16 (save_bytes 2) unless said
    for name, t_o, nbytes in (
            ("K2", t_fwd, stream_in + units + saves + w_bytes + cond_in),
            ("K3", t_bwd, saves + units + stream + 2 * w_bytes + cond_in
             + cond)):
        t_b = nbytes / HBM_BYTES_PER_S
        out[name] = (1e3 * max(t_b, t_o),
                     "bytes" if t_b > t_o else "operations")
    return out


def kernel_split(torch, fn, reps=3):
    """Device time by CUDA kernel name over ``reps`` calls of ``fn`` (after
    a warm call), from ``torch.profiler``: ``{name: (ms per call, launches
    per call)}``, empty when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and not e.key.startswith("cuda"):
            out[e.key] = (us / 1e3 / reps, e.count / reps)
    return out


def short_kernel_name(name):
    """``trunk_bwd_gates`` from ``void (anonymous
    namespace)::trunk_bwd_gates(Layer)``."""
    s = name.split("namespace)::", 1)[-1]
    s = s[5:] if s.startswith("void ") else s
    return s.split("(")[0].split("<")[0].strip() or name


def _time(torch, fn, reps, warm=True):
    """A warm call (unless ``warm`` is False), then ``reps`` timed calls
    with CUDA events; ms each."""
    if warm:
        fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def phase_times(torch, pt, gk, dev, card):
    """Returns the measurements of the serving chunk for the kernels line."""
    def timed(cfg, n_prime, n, temp, reps, resume=False):
        params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
        w = gk.prepare_weights(params, cfg, True)
        prime = torch.randint(0, cfg.classes, (1, n_prime),
                              generator=torch.Generator().manual_seed(3))
        prime = prime.to(dev, torch.int32)
        total = n_prime - 1 + n
        ring = torch.zeros(sum(gk.periods(cfg)) * cfg.residual_channels,
                           device=dev)
        t0 = cfg.receptive_field if resume else 0
        ms = _time(torch, lambda: gk.fused_cuda(
            w, cfg, prime, ring, t0, total, temp, 0.0, 1, True), reps)
        b_ms, b_by = bound_ms(pt, gk, params, cfg, 1, n_prime, total)
        best = min(ms)
        name = f"{cfg.layers}x{cfg.blocks} skip {cfg.skip_channels}"
        log(f"[time] K1 {name} fuse_res, prime {n_prime}, {n} samples, "
            f"T={temp}: " + ", ".join(f"{m:.2f}" for m in ms)
            + f" ms; {1e3 * best / total:.2f} us/step, "
            f"{n / best * 1e3:.0f} samples/s; bound {b_ms:.4f} ms "
            f"({b_by}) [{card}]")
        return cfg, w, prime, ring, t0, total, temp, best, b_ms, b_by

    # the serving chunk: a resumed 2048-step call, the main path's shape
    chaconne, saber = pt.get_config("chaconne"), pt.get_config("saber")
    cfg, w, prime, ring, t0, total, temp, k_ms, b_ms, b_by = timed(
        chaconne, 1, 2048, 0.9, 3, resume=True)
    plain = _time(torch, lambda: gk.fused_plain(
        w, cfg, prime, ring, t0, total, temp, 0.0, 1, True), 1, warm=False)[0]
    log(f"[time] plain version, same chaconne chunk: {plain:.1f} ms, "
        f"{1e3 * plain / total:.1f} us/step [{card}]")
    log("[time] library call: none (no single PyTorch call computes the loop)")
    timed(chaconne, chaconne.receptive_field, 16384, 1.0, 1)
    # where a step's time goes: chaconne widths at 1, 2 and 3 blocks; the
    # slope is the cost of one layer, the intercept that of the embed, the
    # head and the sampling
    us = []
    for blocks in (1, 2, 3):
        c = pt.get_config("chaconne", blocks=blocks)
        us.append(1e3 * timed(c, 1, 2048, 0.9, 1)[7] / 2048)
    per_layer = (us[2] - us[0]) / 20
    log(f"[time] K1 chaconne widths, 10/20/30 layers: "
        + ", ".join(f"{u:.2f}" for u in us) + f" us/step; {per_layer:.2f} "
        f"us per layer, {us[0] - 10 * per_layer:.2f} us per step outside "
        f"the layers [{card}]")
    scfg = saber
    sp = pt.init_wavenet(scfg, torch.Generator().manual_seed(SEED), dev)
    sw = gk.prepare_weights(sp, scfg, True)
    sprime = torch.full((1, 1), scfg.classes // 2, dtype=torch.int32,
                        device=dev)
    sring = torch.zeros(sum(gk.periods(scfg)) * scfg.residual_channels,
                        device=dev)
    sp_ms = _time(torch, lambda: gk.fused_plain(
        sw, scfg, sprime, sring, 0, 256, 1.0, 0.0, 1, True), 1,
        warm=False)[0]
    log(f"[time] plain version, saber fuse_res, 256 steps: {sp_ms:.1f} ms, "
        f"{1e3 * sp_ms / 256:.1f} us/step [{card}]")
    return dict(ms=k_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)



# ---------------------------------------------------------------------- K4

K4_VARIANTS = (("exact", False, False), ("fuse_res + skip_slab", True, True))


def _lane_rows(torch, dev, lanes, temps_cycle=(0.0, 0.9, 1.0)):
    """Per-lane temperatures cycling through ``temps_cycle``, distinct
    seeds, and non-zero noise clocks."""
    i = torch.arange(lanes, dtype=torch.int32)
    temps = torch.tensor([temps_cycle[j % len(temps_cycle)]
                          for j in range(lanes)], dtype=torch.float32)
    return (temps.to(dev), (i * 7919 - 1000).to(dev),
            ((i * 37) % 1000 - 300).to(dev))


def _rollout_check(torch, ck, cp, gaps, rk, rp, tag, what):
    """Kernel and plain version from the same state: every lane's classes
    agree up to its first mismatch, which must be at a near-tie of the
    plain version's scores; rings agree on the lanes that never parted.
    Returns (lanes that parted, ring error)."""
    diff = ck != cp
    parted = diff.any(dim=1)
    n = int(parted.sum())
    if n:
        lanes = parted.nonzero()[:, 0]
        first = diff.int().argmax(dim=1)[lanes]
        gap = float(gaps[lanes, first].max())
        check(gap < NEAR_TIE, f"{tag} {what}: {n} lanes part, widest plain "
              f"gap at a parting {gap}")
    keep = ~parted
    err = (float((rk[:, keep] - rp[:, keep]).abs().max())
           if bool(keep.any()) else 0.0)
    check(err <= RING_TOL, f"{tag} {what}: ring error {err}")
    log(f"[{tag}] {what}: {ck.shape[0] - n} of {ck.shape[0]} lanes identical "
        f"over {ck.shape[1]} steps, {n} part at a near-tie (gap < "
        f"{NEAR_TIE}); ring max abs err {err:.3g} on the identical lanes")
    return n, err


def _roll_ring(torch, ghbm, cfg, ring, delta):
    """The ring as a call started ``delta`` steps later would hold it: each
    layer's slot s moves to (s + delta) mod P."""
    R, out = cfg.residual_channels, torch.empty_like(ring)
    for first, P in zip(ghbm.ring_offsets(cfg), ghbm.periods(cfg)):
        blk = ring[first * R:(first + P) * R].view(P, R, -1)
        out[first * R:(first + P) * R] = torch.roll(
            blk, delta % P, dims=0).reshape(P * R, -1)
    return out


def gk_fits(ghbm, cfg, tile, fuse, cond_rows=0):
    """Whether K4 takes this width of lanes per cluster at cfg (with a cond
    slab of ``cond_rows`` rows)."""
    try:
        ghbm.k1.cluster_fits(cfg, tile, ghbm.CLUSTER, fuse, cond_rows)
        return True
    except ValueError:
        return False


def default_tile(ghbm, cfg, lanes):
    """The width batched_cuda picks for ``lanes`` (fuse_res+skip_slab)."""
    return ghbm.default_tile(lanes, cfg, True, lambda t: (
        ghbm.max_active_clusters(cfg, t, True, True)))


def phase_k4_vs_plain(torch, pt, ghbm, dev):
    """K4 against its plain version at chaconne width. Returns the largest
    ring error and the class mismatch and near-tie counts."""
    worst, mismatches, near_ties = 0.0, 0, 0
    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    C, rows = cfg.classes, ghbm.ring_rows(cfg)
    clock = max(ghbm.periods(cfg))  # the pool's clock at bootstrap
    for lanes in (256, 200):
        zeros = torch.zeros(lanes, dtype=torch.int32, device=dev)
        greedy = torch.zeros(lanes, device=dev)
        temps, seeds, toffs = _lane_rows(torch, dev, lanes)
        prime = torch.randint(0, C, (lanes, 600),
                              generator=torch.Generator().manual_seed(7))
        prime = prime.to(dev, torch.int32)
        short = prime[:, :16].contiguous()
        for name, fuse, slab in K4_VARIANTS:
            w = ghbm.prepare_weights(params, cfg, fuse, slab)
            tag = f"K4 chaconne {lanes} lanes {name}"

            def both(prime, ring, t0, total, temps, seeds, toffs):
                rp = ring.clone()
                ck = ghbm.batched_cuda(w, cfg, prime, ring, t0, total, temps,
                                       seeds, toffs, 0, 0.0, fuse, slab, True)
                torch.cuda.synchronize()
                cp, gaps = ghbm.batched_plain(w, cfg, prime, rp, t0, total,
                                              temps, seeds, toffs, 0, 0.0,
                                              fuse, slab, True,
                                              return_gaps=True)
                return ck, cp, gaps, ring, rp

            # teacher-forced: a prime of 300 classes, one sample after
            forced = prime[:, :300].contiguous()
            ck, cp, gaps, rk, rp = both(forced, torch.zeros(rows, lanes,
                                                            device=dev),
                                        0, 300, greedy, zeros, zeros)
            miss = ck[:, :299] != cp[:, :299]
            ties = gaps[:, :299] < NEAR_TIE
            bad = int((miss & ~ties).sum())
            err = float((rk - rp).abs().max())
            log(f"[{tag}] teacher-forced 299 steps: {int(miss.sum())} class "
                f"mismatches ({bad} not at a near-tie, largest gap at one "
                f"{_flip_gap(miss, gaps[:, :299]):.3g}), {int(ties.sum())} "
                f"near-ties (gap < {NEAR_TIE}), ring max abs err {err:.3g}")
            check(bad == 0, f"{tag}: kernel disagrees with plain off a "
                  f"near-tie")
            check(err <= RING_TOL, f"{tag}: ring error {err} > {RING_TOL}")
            err = max(err, _headless_check(
                torch, ghbm, lambda r, h: ghbm.batched_cuda(
                    w, cfg, forced, r, 0, 300, greedy, zeros, zeros, 0, 0.0,
                    fuse, slab, True, head_from=h),
                forced, ck, rk, cp, gaps, rp, tag))
            worst = max(worst, err)
            mismatches += int(miss.sum())
            near_ties += int(ties.sum())

            # free-running from fresh rings: greedy, then hot with per-lane
            # seeds, temperatures {0, 0.9, 1.0} and non-zero clocks
            for what, rows_ in (("rollout T=0", (greedy, zeros, zeros)),
                                ("hot rollout lane_seed/lane_clock",
                                 (temps, seeds, toffs))):
                n, e = _rollout_check(
                    torch, *both(short, torch.zeros(rows, lanes, device=dev),
                                 0, 215, *rows_), tag, what)
                mismatches += n
                near_ties += n
                worst = max(worst, e)

            # a resumed chunk at the pool's clock or later, T = 0.9: rings
            # written by a 600-step kernel call, then 200 steps from there
            ring = torch.zeros(rows, lanes, device=dev)
            head = ghbm.batched_cuda(w, cfg, prime, ring, 0, 600, greedy,
                                     zeros, zeros, 0, 0.0, fuse, slab, True)
            check(600 >= clock, "the resumed chunk starts before the clock")
            hot = torch.full((lanes,), 0.9, device=dev)
            n, e = _rollout_check(
                torch, *both(head[:, -1:].contiguous(), ring, 600, 200, hot,
                             seeds, toffs), tag, "resumed chunk t0=600 T=0.9")
            mismatches += n
            near_ties += n
            worst = max(worst, e)

            # three resumed chunks equal one shot, bitwise
            r1 = torch.zeros(rows, lanes, device=dev)
            c_all = ghbm.batched_cuda(w, cfg, short, r1, 0, 615, temps,
                                      seeds, toffs, 0, 0.0, fuse, slab, True)
            r3 = torch.zeros(rows, lanes, device=dev)
            parts, t0, p = [], 0, short
            for total in (215, 200, 200):
                c = ghbm.batched_cuda(w, cfg, p, r3, t0, total, temps, seeds,
                                      toffs, 0, 0.0, fuse, slab, True)
                parts.append(c[:, p.shape[1] - 1:])
                t0 += total
                p = c[:, -1:].contiguous()
            same = (torch.equal(torch.cat(parts, dim=1), c_all[:, 15:])
                    and torch.equal(r1, r3))
            check(same, f"{tag}: chunked rollout differs from one shot")
            log(f"[{tag}] 3-chunk resume (215+200+200 steps) equals one shot "
                f"bitwise (classes and ring)")

            # predication: a NaN-filled fresh ring gives the classes of a
            # zeroed one
            cls = [ghbm.batched_cuda(w, cfg, short,
                                     torch.full((rows, lanes), fill,
                                                device=dev),
                                     0, 215, temps, seeds, toffs, 0, 0.0,
                                     fuse, slab, True)
                   for fill in (float("nan"), 0.0)]
            torch.cuda.synchronize()
            check(torch.equal(cls[0], cls[1]),
                  f"{tag}: a NaN-filled fresh ring changes the classes")
            log(f"[{tag}] NaN-filled fresh ring: same classes as a zeroed "
                f"ring over 215 steps")

            # what the pool relies on: a fresh call from one class equals,
            # bitwise, the same rollout at the pool's clock over zeroed
            # history (same request-local noise clock), ring rolled by it
            one = short[:, :1].contiguous()
            r_fresh = torch.full((rows, lanes), float("nan"), device=dev)
            c_fresh = ghbm.batched_cuda(w, cfg, one, r_fresh, 0, 600, temps,
                                        seeds, toffs, 0, 0.0, fuse, slab,
                                        True)
            r_pool = torch.zeros(rows, lanes, device=dev)
            c_pool = ghbm.batched_cuda(w, cfg, one, r_pool, clock, 600, temps,
                                       seeds, toffs - clock, 0, 0.0, fuse,
                                       slab, True)
            same = (torch.equal(c_fresh, c_pool) and torch.equal(
                _roll_ring(torch, ghbm, cfg, r_fresh, clock), r_pool))
            check(same, f"{tag}: a fresh call differs from its rollout over "
                  f"zeroed history")
            log(f"[{tag}] fresh call equals its rollout at t0={clock} over "
                f"zeroed history bitwise (classes and ring, 600 steps)")

            # a resumed chunk at clock offsets 0, 1, 2 and 513 equals one
            # shot (the taps of a call's first step are issued before its
            # loop); at 0 the "first chunk" is empty and the call runs over
            # a zeroed ring instead of a NaN-filled one
            r_all = torch.full((rows, lanes), float("nan"), device=dev)
            c_all = ghbm.batched_cuda(w, cfg, one, r_all, 0, 700, temps,
                                      seeds, toffs, 0, 0.0, fuse, slab, True)
            for off in (0, 1, 2, 513):
                ring = torch.zeros(rows, lanes, device=dev)
                p, parts = one, []
                if off:
                    parts.append(ghbm.batched_cuda(w, cfg, one, ring, 0, off,
                                                   temps, seeds, toffs, 0,
                                                   0.0, fuse, slab, True))
                    p = parts[-1][:, -1:].contiguous()
                parts.append(ghbm.batched_cuda(w, cfg, p, ring, off,
                                               700 - off, temps, seeds, toffs,
                                               0, 0.0, fuse, slab, True))
                same = (torch.equal(torch.cat(parts, dim=1), c_all)
                        and torch.equal(ring, r_all))
                check(same, f"{tag}: chunk resumed at t0={off} differs from "
                      f"one shot")
            log(f"[{tag}] chunks resumed at t0 = 0, 1, 2 and 513 equal one "
                f"shot bitwise (700 steps, classes and ring)")

            # position independence: the same lanes at other tile widths
            # give bitwise the same classes and ring
            widths = [t for t in ghbm.TILES if gk_fits(ghbm, cfg, t, fuse)]
            ref = None
            for tile in widths:
                ring = torch.zeros(rows, lanes, device=dev)
                c = ghbm.batched_cuda(w, cfg, short, ring, 0, 215, temps,
                                      seeds, toffs, 0, 0.0, fuse, slab, True,
                                      tile=tile)
                if ref is None:
                    ref = (c, ring)
                check(torch.equal(c, ref[0]) and torch.equal(ring, ref[1]),
                      f"{tag}: tile {tile} differs from tile {widths[0]}")
            log(f"[{tag}] the same lanes at {len(widths)} widths of lanes "
                f"per cluster {widths}: bitwise equal classes and ring over "
                f"215 steps")
    return worst, mismatches, near_ties


def phase_kernel_sizes(torch, pt, gk, ghbm, dev):
    """K1 and K4 at chaconne widths with kernel_size 1 (no taps) and 3
    (two tap rows a layer) against their plain versions, teacher-forced.
    Returns, for K1 and then K4, the largest ring error and the class
    mismatch and near-tie counts."""
    stats = {"K1": [0.0, 0, 0], "K4": [0.0, 0, 0]}

    def note(kernel, err, miss, ties):
        st = stats[kernel]
        st[0], st[1], st[2] = (max(st[0], err), st[1] + int(miss.sum()),
                               st[2] + int(ties.sum()))

    for k in (1, 3):
        cfg = pt.get_config("chaconne", kernel_size=k)
        params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED),
                                 dev)
        prime = torch.randint(0, cfg.classes, (40, 200),
                              generator=torch.Generator().manual_seed(9))
        prime = prime.to(dev, torch.int32)
        zeros = torch.zeros(40, dtype=torch.int32, device=dev)
        greedy = torch.zeros(40, device=dev)
        for name, fuse, slab in K4_VARIANTS:
            w = ghbm.prepare_weights(params, cfg, fuse, slab)
            runs = []
            for tile in (8, 24):
                rk = torch.zeros(ghbm.ring_rows(cfg), 40, device=dev)
                runs.append((ghbm.batched_cuda(
                    w, cfg, prime, rk, 0, 200, greedy, zeros, zeros, 0, 0.0,
                    fuse, slab, True, tile=tile), rk))
            torch.cuda.synchronize()
            rp = torch.zeros(ghbm.ring_rows(cfg), 40, device=dev)
            cp, gaps = ghbm.batched_plain(w, cfg, prime, rp, 0, 200, greedy,
                                          zeros, zeros, 0, 0.0, fuse, slab,
                                          True, return_gaps=True)
            ck, rk = runs[0]
            tag = f"K4 chaconne kernel_size {k} 40 lanes {name}"
            miss = ck[:, :199] != cp[:, :199]
            ties = gaps[:, :199] < NEAR_TIE
            bad = int((miss & ~ties).sum())
            err = float((rk - rp).abs().max())
            log(f"[{tag}] teacher-forced 199 steps: {int(miss.sum())} class "
                f"mismatches ({bad} not at a near-tie, largest gap at one "
                f"{_flip_gap(miss, gaps[:, :199]):.3g}), ring max abs err "
                f"{err:.3g}; tiles 8 and 24 bitwise equal: "
                f"{torch.equal(ck, runs[1][0]) and torch.equal(rk, runs[1][1])}")
            check(bad == 0 and err <= RING_TOL,
                  f"{tag}: kernel disagrees with plain")
            check(torch.equal(ck, runs[1][0]) and torch.equal(rk, runs[1][1]),
                  f"{tag}: tiles 8 and 24 differ")
            err = max(err, _headless_check(
                torch, ghbm, lambda r, h: ghbm.batched_cuda(
                    w, cfg, prime, r, 0, 200, greedy, zeros, zeros, 0, 0.0,
                    fuse, slab, True, tile=8, head_from=h),
                prime, ck, rk, cp, gaps, rp, tag + " tile 8"))
            note("K4", err, miss, ties)
        for fuse in (False, True):
            w = gk.prepare_weights(params, cfg, fuse)
            p3 = prime[:3].contiguous()
            size = sum(gk.periods(cfg)) * 3 * cfg.residual_channels
            rk = torch.zeros(size, device=dev)
            rp = torch.zeros(size, device=dev)
            ck = gk.fused_cuda(w, cfg, p3, rk, 0, 200, 0.0, 0.0, 0, fuse)
            torch.cuda.synchronize()
            cp, gaps = gk.fused_plain(w, cfg, p3, rp, 0, 200, 0.0, 0.0, 0,
                                      fuse, return_gaps=True)
            tag = (f"K1 chaconne kernel_size {k} 3 streams "
                   f"{'fuse_res' if fuse else 'exact'}")
            miss = ck[:, :199] != cp[:, :199]
            ties = gaps[:, :199] < NEAR_TIE
            bad = int((miss & ~ties).sum())
            err = float((rk - rp).abs().max())
            log(f"[{tag}] teacher-forced 199 steps: {int(miss.sum())} class "
                f"mismatches ({bad} not at a near-tie, largest gap at one "
                f"{_flip_gap(miss, gaps[:, :199]):.3g}), ring max abs err "
                f"{err:.3g}")
            check(bad == 0 and err <= RING_TOL,
                  f"{tag}: kernel disagrees with plain")
            err = max(err, _headless_check(
                torch, gk, lambda r, h: gk.fused_cuda(
                    w, cfg, p3, r, 0, 200, 0.0, 0.0, 0, fuse, head_from=h),
                p3, ck, rk, cp, gaps, rp, tag))
            note("K1", err, miss, ties)
    return stats["K1"], stats["K4"]


def _solo_cls(pt, params, cfg, prime, n, temperature, seed, dev, **kw):
    _, cls = pt.generate_fast_batched(
        params, cfg, 0, n, prime, temperature=temperature,
        lane_seed=seed, fuse_res=True, skip_slab=True, device=dev, **kw)
    return cls.cpu().numpy()


def phase_k4_batcher(torch, np, pt, dev):
    """The ContinuousBatcher on the card: pooled responses equal their solo
    calls bitwise."""
    from pytorch_wavenet_tpu_torch.serving import ContinuousBatcher

    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    rng = np.random.default_rng(5)
    b = ContinuousBatcher(params, cfg, lanes=256, chunk=512, fuse_res=True,
                          skip_slab=True, device=dev)
    reqs = []
    t = time.time()
    try:
        b.prewarm()
        # staggered greedy requests, then bursts of seeded hot ones, all
        # admitted while the pool runs
        for i in range(6):
            prime = rng.integers(0, cfg.classes, (1, 64, 700)[i % 3])
            reqs.append((b.submit(prime, 1500, temperature=0.0, seed=100 + i),
                         prime, 1500, 0.0, 100 + i))
            time.sleep(0.25)
        for burst in range(4):
            for j in range(10):
                prime = rng.integers(0, cfg.classes, (1, 64)[j % 2])
                temp, seed = (0.9, 1.0)[j % 2], 1000 + 10 * burst + j
                reqs.append((b.submit(prime, 1200, temperature=temp,
                                      seed=seed), prime, 1200, temp, seed))
            time.sleep(0.3)
        got = [h.result(timeout=600)[1] for h, *_ in reqs]
        stats = b.stats()
    finally:
        b.close()
    dt = time.time() - t
    check(stats["completed"] == len(reqs) and stats["failed"] == 0,
          f"batcher stats: {stats}")
    # solo references, one call per (prime length, length, temperature):
    # under lane_seed a lane's rollout does not depend on the lanes beside
    # it, so each lane of such a call is that request's solo rollout; the
    # first two requests also get literal one-lane calls
    groups = {}
    for i, (_, prime, n, temp, seed) in enumerate(reqs):
        groups.setdefault((prime.size, n, temp), []).append(i)
    for idx in groups.values():
        _, _, n, temp, _ = reqs[idx[0]]
        ref = _solo_cls(pt, params, cfg,
                        np.stack([reqs[i][1] for i in idx]), n, temp,
                        [reqs[i][4] for i in idx], dev)
        for row, i in enumerate(idx):
            check(np.array_equal(got[i], ref[row]),
                  f"pooled request {i} differs from its solo rollout")
    for i in (0, 6):
        _, prime, n, temp, seed = reqs[i]
        ref = _solo_cls(pt, params, cfg, prime[None], n, temp, [seed], dev)
        check(np.array_equal(got[i], ref[0]),
              f"pooled request {i} differs from its one-lane solo call")
    log(f"[batcher] chaconne, 256 lanes, chunk 512: {len(reqs)} requests "
        f"(6 staggered greedy, 40 hot in 4 bursts) all equal their solo "
        f"rollouts bitwise; {stats['pool_steps']} pool steps, "
        f"{stats['prime_calls']} prime calls, {dt:.1f} s")


def phase_k4_serving(torch, np, pt, gk, ghbm, dev, bf16_rings=False):
    """Phase 8 (and, with ``bf16_rings``, phase 24: ``--bf16-rings``, the
    pool's ring in bf16, the solo rollouts too). Returns the K4 launches
    counted around it and the served figures."""
    from pytorch_wavenet_tpu_torch.ops.mulaw import dequantize_to_f32
    from pytorch_wavenet_tpu_torch.serving import server as srv

    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    n, n_req = 16000, 64
    temps = [(0.9, 1.0, 0.0, 0.9)[i % 4] for i in range(n_req)]
    plain_calls = []
    real_plain = ghbm.batched_plain

    def barred(*args, **kwargs):
        plain_calls.append(1)
        raise RuntimeError("the plain version ran on the card path")

    with tempfile.TemporaryDirectory() as d:
        path = pt.save_checkpoint(d, "chaconne", 0, params, cfg=cfg)
        box, ready = {}, threading.Event()

        def on_ready(server):
            box["server"] = server
            ready.set()

        ghbm.batched_plain = barred
        gk.launches = 0
        ghbm.launches = 0
        th = threading.Thread(target=srv.main, kwargs=dict(
            argv=["--snapshot", path, "--port", "0", "--batcher", "--lanes",
                  "256", "--batch-chunk", "2048"]
            + (["--bf16-rings"] if bf16_rings else []), on_ready=on_ready),
            daemon=True)
        t0 = time.time()
        th.start()
        try:
            while not ready.wait(1):
                check(th.is_alive() and time.time() - t0 < 600,
                      "batcher server did not come up")
            server = box["server"]
            base = f"http://127.0.0.1:{server.server_address[1]}"
            log(f"[serve-batcher] up in {time.time() - t0:.1f} s at {base}")
            try:
                with urllib.request.urlopen(base + "/health", timeout=60) as r:
                    health = json.loads(r.read())
                check(health["backend"] == "cuda-batcher", f"health: {health}")
                with urllib.request.urlopen(base + "/stats", timeout=60) as r:
                    before = json.loads(r.read())
                out = [None] * n_req

                def fetch(i):
                    url = (f"{base}/synthesize?num_samples={n}"
                           f"&temperature={temps[i]}&seed={500 + i}")
                    t = time.time()
                    with urllib.request.urlopen(url, timeout=900) as r:
                        head = r.read(46)  # header + the first sample
                        t_first = time.time() - t
                        blob = head + r.read()
                    out[i] = (blob, t_first, time.time() - t)

                threads = [threading.Thread(target=fetch, args=(i,))
                           for i in range(n_req)]
                t = time.time()
                for th_ in threads:
                    th_.start()
                for th_ in threads:
                    th_.join(900)
                wall = time.time() - t
                with urllib.request.urlopen(base + "/stats", timeout=60) as r:
                    stats = json.loads(r.read())
            finally:
                server.shutdown()
                th.join(120)
        finally:
            ghbm.batched_plain = real_plain
        launched, k1 = ghbm.launches, gk.launches
    check(not th.is_alive(), "batcher server thread did not stop")
    check(all(o is not None for o in out), "a request did not finish")
    pcms = [np.frombuffer(_read_wav(blob, n), "<i2") for blob, _, _ in out]
    done = stats["completed"] - before["completed"]
    check(done == n_req and stats["failed"] == 0,
          f"/stats counts {done} completed of {n_req}: {stats}")
    check(not plain_calls and k1 == 0,
          f"plain calls {len(plain_calls)}, K1 launches {k1} on the K4 path")
    expect = stats["pool_steps"] + stats["prime_calls"] + 1  # + prewarm step
    log(f"[serve-batcher] K4 launches during serving: {launched} (expected "
        f"{expect}: {stats['pool_steps']} pool steps + "
        f"{stats['prime_calls']} prime calls + 1 prewarm step); K1 launches "
        f"{k1}; plain-version calls {len(plain_calls)}")
    check(launched == expect and stats["pool_steps"] >= n // 2048,
          f"{launched} K4 launches, expected {expect}")

    # what came out: two responses equal their solo rollouts byte for byte
    for i in (0, 2):
        cls = _solo_cls(pt, params, cfg, [[cfg.classes // 2]], n, temps[i],
                        [500 + i], dev, **({"ring_dtype": torch.bfloat16}
                                           if bf16_rings else {}))[0]
        wav = dequantize_to_f32(cls, cfg.classes)
        check(np.isfinite(wav).all(), "non-finite waveform")
        solo = np.clip(wav * 32767.0, -32768, 32767).astype("<i2")
        check(np.array_equal(pcms[i], solo),
              f"served request {i} (T={temps[i]}) differs from its solo "
              f"rollout")
    ttfa = sorted(o[1] for o in out)
    served = n_req * n / wall
    log(f"[serve-batcher{' --bf16-rings' if bf16_rings else ''}] {n_req} "
        f"concurrent {n}-sample requests in "
        f"{wall:.2f} s: {served:.0f} samples/s served; time to first audio "
        f"median {1e3 * ttfa[n_req // 2]:.0f} ms, max {1e3 * ttfa[-1]:.0f} "
        f"ms; requests 0 and 2 equal their solo rollouts byte for byte; "
        f"{stats['pool_steps']} pool steps of 2048")
    return launched, dict(samples_per_s=served, wall_s=wall,
                          ttfa_median_ms=1e3 * ttfa[n_req // 2],
                          ttfa_max_ms=1e3 * ttfa[-1])


def phase_wide(dev):
    """Phase 47: the wide-chain kernel's checks and time
    (``scripts/torch_wide_check.py``, whose failures fail the run).
    Returns its kernels-line entry."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_wide_check", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "scripts", "torch_wide_check.py"))
    wc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(wc)
    t, pool = wc.run_checks(dev, 128)
    check(not wc.failures, f"phase 47: {wc.failures}")
    return {"name": "gen_wide (KW, wnv512, 256 lanes, a 128-step call; "
                    "launches: the frames-mode lane pool's)",
            "route": "cuda",
            "source": "pytorch_wavenet_tpu_torch/csrc/gen_kernel_wide.cu",
            "replaces": None, "launches": pool["launches"],
            "pool_wide_launches": pool["stats"]["wide_launches"],
            "pool_steps": pool["stats"]["pool_steps"],
            "pool_prime_calls": pool["stats"]["prime_calls"],
            "ms": t["ms"], "us_per_step": t["us_per_step"],
            "split_us_per_step": t["split"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None}


def phase_k4_times(torch, pt, ghbm, dev, card):
    """K4 on a resumed 2048-step chunk (the pool's call). Returns the
    256-lane measurements for the kernels line."""
    def setup(cfg, lanes):
        params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED),
                                 dev)
        prime = torch.randint(0, cfg.classes, (lanes, 1),
                              generator=torch.Generator().manual_seed(3))
        temps = torch.full((lanes,), 0.9, device=dev)
        _, seeds, toffs = _lane_rows(torch, dev, lanes)
        return (params, ghbm.prepare_weights(params, cfg, True, True), cfg,
                prime.to(dev, torch.int32),
                torch.zeros(ghbm.ring_rows(cfg), lanes, device=dev),
                temps, seeds, toffs)

    def call(run, ops, steps, **kw):
        _, w, cfg, prime, ring, temps, seeds, toffs = ops
        clock = max(ghbm.periods(cfg))  # the pool's bootstrap clock
        return lambda: run(w, cfg, prime, ring, clock, steps, temps, seeds,
                           toffs, 0, 0.0, True, True, True, **kw)

    cfg = pt.get_config("chaconne")

    out = {}
    for lanes in (128, 256, 1024):
        ops = setup(cfg, lanes)
        params = ops[0]
        ms = _time(torch, call(ghbm.batched_cuda, ops, 2048), 1)
        best = min(ms)
        b_ms, b_by = bound_ms(pt, ghbm, params, cfg, lanes, 1, 2048,
                              lane_rows=3)
        log(f"[time] K4 chaconne fuse_res+skip_slab, {lanes} lanes (tile "
            f"{default_tile(ghbm, cfg, lanes)}, cluster "
            f"{ghbm.CLUSTER}), resumed 2048-step chunk, T=0.9 "
            f"lane_seed: " + ", ".join(f"{m:.2f}" for m in ms)
            + f" ms; {1e3 * best / 2048:.2f} us/step, "
            f"{lanes * 2048 / best * 1e3:.0f} samples/s; bound {b_ms:.4f} "
            f"ms ({b_by}), {100 * b_ms / best:.2f} % of it [{card}]")
        out[lanes] = dict(ms=best, bound_ms=b_ms, bound_by=b_by)
    # the sweep behind default_tile: lanes per cluster at both pool sizes
    # (a 512-step chunk each)
    for lanes in (256, 1024):
        ops = setup(cfg, lanes)
        for tile in ghbm.TILES:
            best = min(_time(torch, call(ghbm.batched_cuda, ops, 512,
                                         tile=tile), 1))
            log(f"[time] K4 {lanes} lanes, {tile} lanes per cluster of "
                f"{ghbm.CLUSTER} ({-(-lanes // tile)} clusters, "
                f"{ghbm.shared_bytes(cfg, tile, True)} B shared): "
                f"{1e3 * best / 512:.2f} us/step [{card}]")
    # where a step's time goes at 256 lanes (the first block's clock)
    ops = setup(cfg, 256)
    tm = torch.zeros(len(ghbm.PHASES), dtype=torch.int64, device=dev)
    call(ghbm.batched_cuda, ops, 2048, timers=tm)()
    torch.cuda.synchronize()
    log("[time] K4 256 lanes, a 2048-step chunk, per step: "
        + ", ".join(f"{n} {v / 2048e3:.2f} us"
                    for n, v in zip(ghbm.PHASES, tm.tolist()))
        + f" [{card}]")
    ops = setup(cfg, 256)
    cut = _time(torch, call(ghbm.batched_plain, ops, 256), 1,
                warm=False)[0]
    log(f"[time] plain version, 256 lanes, the same chunk cut to 256 steps: "
        f"{cut:.1f} ms, {1e3 * cut / 256:.1f} us/step [{card}]")
    plain = _time(torch, call(ghbm.batched_plain, ops, 2048), 1,
                  warm=False)[0]
    log(f"[time] plain version, 256 lanes, the whole 2048-step chunk: "
        f"{plain:.1f} ms, {1e3 * plain / 2048:.1f} us/step [{card}]")
    log("[time] library call: none (no single PyTorch call computes the loop)")
    # where a step's time goes: chaconne widths at 1, 2 and 3 blocks, 256
    # lanes; the slope is the cost of one layer, the intercept that of the
    # embed, the skip-row and head products and the sampling
    us = []
    for blocks in (1, 2, 3):
        ops = setup(pt.get_config("chaconne", blocks=blocks), 256)
        us.append(1e3 * min(_time(torch, call(ghbm.batched_cuda, ops, 2048),
                                  1)) / 2048)
    per_layer = (us[2] - us[0]) / 20
    log(f"[time] K4 chaconne widths, 256 lanes, 10/20/30 layers: "
        + ", ".join(f"{u:.2f}" for u in us) + f" us/step; {per_layer:.2f} "
        f"us per layer, {us[0] - 10 * per_layer:.2f} us per step outside "
        f"the layers [{card}]")
    return dict(out[256], plain_ms=plain)


# ------------------------------------------------------------------ K2/K3

GRAD_TOL = 1e-5       # f32 saves: gradients within GRAD_TOL * max(1, scale)
GRAD_TOL_BF16 = 2e-2  # bf16 saves against the exact gradients
U_TOL = 1e-5          # units within U_TOL * max(1, |u|)


def _trunk_case(torch, pt, dev, name, batch, out_len, **kw):
    """Random params, an embedded window and a units' cotangent of the size
    the loss gives (its mean over batch * out targets)."""
    cfg = pt.get_config(name, **kw)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    T = cfg.receptive_field + out_len - 1
    g = torch.Generator().manual_seed(2)
    h0 = (torch.rand((batch, T, cfg.residual_channels), generator=g) * 2
          - 1).to(dev)
    du = ((torch.rand((batch, out_len, cfg.num_layers
                       * cfg.dilation_channels), generator=g) * 2 - 1)
          / (batch * out_len)).to(dev)
    return cfg, params, h0, du


def _grad_err(got, ref):
    """Largest error of each gradient over max(1, its scale)."""
    return max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
               for a, b in zip(got, ref))


def _k23_check(torch, tk, tag, cfg, params, h0, du, out_len, cond=None):
    """K2 and K3 (with cond, when given) against their plain versions at
    f32 and bf16 saves: units within U_TOL x max(1, |u|), gradients within
    GRAD_TOL x max(1, scale) of the plain version on the same saves and of
    the exact (f32-save) gradients (GRAD_TOL_BF16 with bf16 saves), two K3
    calls bitwise equal. Returns the largest unit error and the largest
    f32-save gradient error (absolute)."""
    u_err = g_err = 0.0
    _, exact_saves = tk.trunk_fwd_plain(params, cfg, h0, out_len,
                                        torch.float32, cond)
    exact = tk.trunk_bwd_plain(params, cfg, exact_saves, du, out_len, cond)
    for sd, name_sd in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        uk, sk = tk.trunk_fwd_cuda(params, cfg, h0, out_len, sd, cond)
        torch.cuda.synchronize()
        up, _ = tk.trunk_fwd_plain(params, cfg, h0, out_len, sd, cond)
        eu = float(((uk - up).abs() / up.abs().clamp(min=1.0)).max())
        check(eu <= U_TOL, f"{tag} {name_sd} saves: u error {eu}")
        u_err = max(u_err, float((uk - up).abs().max()))
        gk = tk.trunk_bwd_cuda(params, cfg, sk, du, out_len, cond)
        again = tk.trunk_bwd_cuda(params, cfg, sk, du, out_len, cond)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(gk, again))
        check(same, f"{tag} {name_sd} saves: two K3 calls differ")
        gp = tk.trunk_bwd_plain(params, cfg, sk, du, out_len, cond)
        check(len(gk) == len(gp), f"{tag}: K3 gave {len(gk)} gradients")
        e_plain = _grad_err(gk, gp)
        e_exact = _grad_err(gk, exact)
        tol = GRAD_TOL if sd == torch.float32 else GRAD_TOL_BF16
        check(e_plain <= GRAD_TOL,
              f"{tag} {name_sd} saves: K3 vs plain {e_plain}")
        check(e_exact <= tol,
              f"{tag} {name_sd} saves: K3 vs exact gradients {e_exact}")
        if sd == torch.float32:
            g_err = max(g_err, max(float((a - b).abs().max())
                                   for a, b in zip(gk, gp)))
        of_cond = ("" if cond is None else
                   f" (dW_cond and dcond {_grad_err(gk[5:], gp[5:]):.3g})")
        log(f"[{tag}] {name_sd} saves: u within {eu:.3g} x max(1, |u|) "
            f"(tol {U_TOL}); K3 gradients within {e_plain:.3g} x max(1, "
            f"scale) of the plain version on the same saves{of_cond} (tol "
            f"{GRAD_TOL}), {e_exact:.3g} of the exact (f32-save) "
            f"gradients (tol {tol}); two K3 calls bitwise equal")
    return u_err, g_err


def phase_k23_vs_plain(torch, pt, tk, dev):
    """K2 and K3 against their plain versions: chaconne_wide at batch 16
    and output_length 1024 (the main path's shapes), and batch 3 with
    kernel_size 3 at a short window. Returns the largest unit error and
    the largest f32-save gradient error (absolute)."""
    u_err, g_err = 0.0, 0.0
    for name, batch, out_len, kw in (("chaconne_wide", 16, 1024, {}),
                                     ("chaconne_wide", 3, 64,
                                      {"kernel_size": 3})):
        cfg, params, h0, du = _trunk_case(torch, pt, dev, name, batch,
                                          out_len, **kw)
        tag = f"K2/K3 {name} batch {batch} out {out_len} k {cfg.kernel_size}"
        eu, eg = _k23_check(torch, tk, tag, cfg, params, h0, du, out_len)
        u_err, g_err = max(u_err, eu), max(g_err, eg)
    return u_err, g_err


def phase_k23_train_step(torch, pt, tk, dev):
    """One whole train step's gradients (chaconne_wide, batch 16) through
    K2/K3 against autograd of the plain model, with f32 and bf16 saves."""
    import dataclasses
    import functools

    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

    cfg = pt.get_config("chaconne_wide")
    g = torch.Generator().manual_seed(3)
    x = torch.randint(0, cfg.classes, (16, cfg.item_length), generator=g)
    y = torch.randint(0, cfg.classes, (16, cfg.output_length), generator=g)
    x, y = x.to(dev), y.to(dev)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    leaves = [p.requires_grad_(True) for _, p in _leaves(params)]

    def grads(c):
        loss = pt.cross_entropy_loss(params, c, x, y)
        return float(loss), torch.autograd.grad(loss, leaves)

    l_ref, g_ref = grads(dataclasses.replace(cfg, trunk_kernel=False))
    orig = tk.fused_trunk
    for sd, tol, name in ((torch.float32, GRAD_TOL, "f32"),
                          (torch.bfloat16, GRAD_TOL_BF16, "bf16")):
        before = (tk.fwd_launches, tk.bwd_launches)
        tk.fused_trunk = functools.partial(orig, save_dtype=sd)
        try:
            l_k, g_k = grads(dataclasses.replace(cfg, trunk_kernel=True))
        finally:
            tk.fused_trunk = orig
        check((tk.fwd_launches - before[0], tk.bwd_launches - before[1])
              == (1, 1), "the train step did not go through K2 and K3")
        err = _grad_err(g_k, g_ref)
        check(err <= tol and abs(l_k - l_ref) <= 1e-5 * max(1.0, abs(l_ref)),
              f"train step, {name} saves: gradients {err}, loss {l_k} vs "
              f"{l_ref}")
        log(f"[K2/K3 train step] chaconne_wide batch 16, {name} saves: loss "
            f"{l_k:.7f} vs autograd of the plain model {l_ref:.7f}; every "
            f"gradient within {err:.3g} x max(1, scale) (tol {tol})")


def phase_training(torch, np, pt, tk, dev, config="chaconne_wide", steps=20,
                   extra=()):
    """A main path: ``config`` trained for ``steps`` steps at batch 16
    through ``training.train.main`` on the example audio (``extra`` more
    flags), with a snapshot halfway; then a run resumed from that snapshot
    to the end. Phase 12 trains chaconne_wide for 20 steps; phase 19 the
    vocoder for 10 with ``--cond-upsample 16,16`` (mel frames on the host,
    the learnable upsampler on the card, K2/K3 with cond). K2/K3 launches
    are counted around exactly these runs, the plain trunk is barred, the
    loss on the first batch must fall and the resumed run must end at the
    uninterrupted run's params. Returns the launches counted around the
    first run."""
    import glob
    import shutil

    from pytorch_wavenet_tpu_torch.training import train
    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves
    from pytorch_wavenet_tpu_torch.utils.checkpoints import checkpoint_path

    here = os.path.dirname(os.path.abspath(__file__))
    wavs = sorted(glob.glob(os.path.join(here, "examples", "*.wav")))
    check(len(wavs) >= 4, f"example audio missing: {wavs}")
    real = (tk.trunk_fwd_plain, tk.trunk_bwd_plain)
    plain_calls = []
    half = steps // 2

    def barred(*args, **kwargs):
        plain_calls.append(1)
        raise RuntimeError("the plain trunk ran on the card path")

    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "audio")
        os.makedirs(data)
        for w in wavs:
            shutil.copy(w, data)
        base = ["--data-dir", data, "--config", config, *extra,
                "--batch-size", "16", "--epochs", "10", "--max-steps",
                str(steps), "--seed", str(SEED), "--lr", "1e-3",
                "--log-interval", str(half), "--validation-interval", "1000",
                "--device", str(dev)]
        tk.trunk_fwd_plain = tk.trunk_bwd_plain = barred
        try:
            tk.fwd_launches = tk.bwd_launches = 0
            t = time.time()
            a = train.main(base + ["--snapshot-path", os.path.join(d, "a"),
                                   "--snapshot-interval", str(half)])
            torch.cuda.synchronize()
            wall = time.time() - t
            launched = (tk.fwd_launches, tk.bwd_launches)
            snap = checkpoint_path(os.path.join(d, "a"), f"{config}_model",
                                   half)
            os.makedirs(os.path.join(d, "b"))
            shutil.copy(snap, os.path.join(d, "b"))
            tk.fwd_launches = tk.bwd_launches = 0
            b = train.main(base + ["--snapshot-path", os.path.join(d, "b"),
                                   "--snapshot-interval", "1000", "--resume"])
            torch.cuda.synchronize()
            resumed = (tk.fwd_launches, tk.bwd_launches)
        finally:
            tk.trunk_fwd_plain, tk.trunk_bwd_plain = real
        blob = pt.load_checkpoint(snap, device="cpu")
        opt = blob["opt_state"]
        check(opt is not None and int(opt["0"]["count"]) == half,
              f"the step-{half} snapshot has no optimizer state at count "
              f"{half}")
        # what came out: the loss on the first training batch (with its mel
        # frames, for a conditioned config) falls from the seed's init to
        # the trained params
        batch = [torch.from_numpy(v).to(dev)
                 for v in a.dataset.get_batch(np.arange(16))]
        cond = (batch[2], a._cond_hop) if len(batch) > 2 else ()
        init = pt.init_wavenet(a.cfg, torch.Generator().manual_seed(SEED),
                               dev)
        with torch.no_grad():
            l0 = float(pt.cross_entropy_loss(init, a.cfg, *batch[:2], *cond))
            l1 = float(pt.cross_entropy_loss(a.params, a.cfg, *batch[:2],
                                             *cond))
        n_items = len(a.dataset)
    what = ""
    if cond:
        want = (16, 1 + a.cfg.item_length // a._cond_hop,
                a.cfg.cond_channels)
        check(tuple(cond[0].shape) == want,
              f"mel frames {tuple(cond[0].shape)}, expected {want}")
        check(sorted(blob["params"].get("cond_up", {})) == ["s0", "s1"],
              "the snapshot has no learnable upsampler")
        what = (f", mel frames {want} a batch through the learnable "
                f"upsampler {a.cfg.cond_upsample}, K2/K3 with cond")
    check(not plain_calls, f"the plain trunk ran {len(plain_calls)} times")
    check(launched == (steps, steps), f"K2/K3 launches {launched}, expected "
          f"{steps} each (one per step)")
    check(resumed == (steps - half,) * 2, f"resumed run: K2/K3 launches "
          f"{resumed}, expected {steps - half} each")
    check(a.step == steps and b.step == steps, f"steps {a.step}, {b.step}")
    check(math.isfinite(l0) and math.isfinite(l1) and l1 < l0,
          f"loss did not fall: {l0} -> {l1}")
    with torch.no_grad():
        diffs = [float((p - q).abs().max()) for (_, p), (_, q)
                 in zip(_leaves(a.params), _leaves(b.params))]
    bitwise = all(torch.equal(p, q) for (_, p), (_, q)
                  in zip(_leaves(a.params), _leaves(b.params)))
    check(max(diffs) <= 1e-6, f"resumed run differs by {max(diffs)}")
    log(f"[train] {config} batch 16 on {len(wavs)} example files "
        f"({n_items} windows{what}): {steps} steps in {wall:.1f} s (dataset "
        f"and snapshots included; avg step {1e3 * a.avg_step_time:.2f} ms "
        f"host clock); K2/K3 launches {launched[0]}/{launched[1]} ({steps} "
        f"steps x 1 wrapper call each, {a.cfg.num_layers} and "
        f"{a.cfg.num_layers + 2} CUDA kernels per call), plain trunk calls "
        f"{len(plain_calls)}; loss on the first batch {l0:.4f} at init -> "
        f"{l1:.4f} at step {steps}; step-{half} snapshot holds opt_state "
        f"(count {half})")
    log(f"[train] {config} resumed from the step-{half} snapshot to step "
        f"{steps} (K2/K3 launches {resumed[0]}/{resumed[1]}): params "
        f"{'bitwise equal to' if bitwise else 'within %.3g of' % max(diffs)} "
        f"the uninterrupted run's")
    return launched


def _time_median(torch, fn, reps):
    ms = _time(torch, fn, reps)
    return sorted(ms)[len(ms) // 2], ms


def _loss_part(torch, logits, y):
    """The train step's loss forward and backward on given logits (phase
    13's split: logsumexp minus the one-hot hit, in f32)."""
    l32 = logits.to(torch.float32)
    hit = torch.sum(l32 * torch.nn.functional.one_hot(
        y.long(), logits.shape[-1]).to(torch.float32), dim=-1)
    torch.autograd.grad(torch.mean(torch.logsumexp(l32, dim=-1) - hit),
                        [logits])


def phase_train_times(torch, pt, tk, dev, card, config="chaconne_wide",
                      cond_upsample=None, hop=256, bf16=False):
    """Times with CUDA events at ``config``, batch 16: the train step and
    the step with the plain trunk, K2 and K3 beside their bounds, the plain
    trunk, K2's and K3's device time by CUDA kernel (``torch.profiler``)
    and the step's split. Phase 13 times chaconne_wide with K2/K3 at bf16
    and f32 saves; phase 20 the vocoder with ``cond_upsample`` (mel-like
    frames of ``hop`` samples through the learnable upsampler) and K2/K3 at
    bf16 saves without and with its cond rows; phase 22 chaconne_wide with
    ``bf16`` (``--bf16``: compute and stream dtypes bf16, K2/K3 at a bf16
    stream). Returns the figures for the kernels line, ``k[(kernel,
    variant)] = (ms, bound ms, bound by)``."""
    import dataclasses

    from pytorch_wavenet_tpu_torch.models.wavenet import skip_head
    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves
    from pytorch_wavenet_tpu_torch.training.trainer import _expand_cond

    kw = {"cond_upsample": tuple(cond_upsample)} if cond_upsample else {}
    dtypes = (dict(compute_dtype=torch.bfloat16, stream_dtype=torch.bfloat16)
              if bf16 else {})
    cfg = pt.get_config(config, trunk_kernel=True, **kw, **dtypes)
    what = config + (" --cond-upsample " + ",".join(map(str, cond_upsample))
                     if cond_upsample else "") + (" --bf16" if bf16 else "")
    B, out = 16, cfg.output_length
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, cfg.classes, (B, cfg.item_length), generator=g)
    y = torch.randint(0, cfg.classes, (B, out), generator=g)
    x, y = x.to(dev, torch.int32), y.to(dev, torch.int32)
    frames = (_normal(torch, (B, 1 + cfg.item_length // hop,
                              cfg.cond_channels), 6, dev, 2.0)
              if cond_upsample else None)
    cargs = (frames, hop) if cond_upsample else ()
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    for _, p in _leaves(params):
        p.requires_grad_(True)
    tx = pt.reference_adam(1e-4)
    state = tx.init(params)
    step_ms, all_ms = _time_median(torch, lambda: pt.train_step(
        params, state, cfg, tx, x, y, *cargs), 10)
    log(f"[time] train step, {what} batch 16, trunk K2/K3"
        f"{' with cond' if cond_upsample else ''} "
        f"({'a bf16 stream' if bf16 else 'bf16 saves'}): median "
        f"{step_ms:.3f} ms of 10 warm steps ("
        + ", ".join(f"{m:.3f}" for m in all_ms) + f"); "
        f"{B * out / step_ms * 1e3:.0f} targets/s [{card}]")
    plain_cfg = dataclasses.replace(cfg, trunk_kernel=False)
    plain_step, _ = _time_median(torch, lambda: pt.train_step(
        params, state, plain_cfg, tx, x, y, *cargs), 3)
    log(f"[time] {what} train step with the plain trunk "
        f"(--no-trunk-kernel): median {plain_step:.3f} ms of 3 [{card}]")

    # the kernels alone, at the main path's shapes
    cfg_t, p_t, h0, du = _trunk_case(torch, pt, dev, config, B, out,
                                     **dtypes)
    if bf16:
        variants = (("bf16 stream", " bf16 stream", torch.bfloat16, None),)
    elif cond_upsample:
        variants = (("without cond", " without cond", torch.bfloat16, None),
                    ("cond", " with cond", torch.bfloat16,
                     _cond_rows(torch, cfg_t, B, out, dev)))
    else:
        variants = (("bf16", "", torch.bfloat16, None),
                    ("f32", "", torch.float32, None))
    out_k, reduce_ms = {}, 0.0
    for name, label, sd, c in variants:
        _, saves = tk.trunk_fwd_cuda(p_t, cfg_t, h0, out, sd, c)
        fns = (("K2", lambda: tk.trunk_fwd_cuda(p_t, cfg_t, h0, out, sd, c)),
               ("K3", lambda: tk.trunk_bwd_cuda(p_t, cfg_t, saves, du, out,
                                                c)))
        sb, M = (2 if sd == torch.bfloat16 else 4,
                 0 if c is None else cfg_t.cond_channels)
        bounds = trunk_bounds(cfg_t, B, out, sb, cond_channels=M,
                              stream_bf16=bf16)
        old = trunk_bounds(cfg_t, B, out, sb, tf32x3=False, cond_channels=M)
        for kname, fn in fns:
            ms = min(_time(torch, fn, 5))
            b_ms, b_by = bounds[kname]
            log(f"[time] {kname} {config}{label}, batch 16 out {out}, "
                f"{'bf16' if sb == 2 else 'f32'} saves: {ms:.3f} ms (min of "
                f"5); bound {b_ms:.4f} ms ({b_by}, "
                + ("bf16 x bf16 products at the bf16 rate, the rest in TF32"
                   if bf16 else "3xTF32 on the tensor cores")
                + f"), {100 * b_ms / ms:.2f} % of it; the f32 bound of the "
                f"FMA kernels {old[kname][0]:.4f} ms, "
                f"{100 * old[kname][0] / ms:.2f} % [{card}]")
            out_k[(kname, name)] = (ms, b_ms, b_by)
        # the split by CUDA kernel (torch.profiler): K3's launch kinds with
        # its reduction of the partial slots, K2's time per layer
        for kname, fn in fns:
            split = kernel_split(torch, fn)
            check(split, f"{kname} {name}: the profiler saw no device time")
            if kname == "K3":
                reduce_ms = sum(ms_ for k_, (ms_, _) in split.items()
                                if "reduce" in short_kernel_name(k_))
            log(f"[time] {kname} {config}{label}, "
                f"{'bf16' if sb == 2 else 'f32'} saves, split (device time "
                f"per call, torch.profiler, mean of 3): " + "; ".join(
                    f"{short_kernel_name(k_)} {ms_:.3f} ms in {n_:g} "
                    f"launches ({1e3 * ms_ / n_:.1f} us each)"
                    for k_, (ms_, n_) in sorted(split.items(),
                                                key=lambda x: -x[1][0]))
                + f" [{card}]")
    if cond_upsample:
        for kname in ("K2", "K3"):
            extra = out_k[(kname, "cond")][0] - out_k[(kname,
                                                      "without cond")][0]
            log(f"[time] {kname} {config}: cond costs {extra:.3f} ms a call "
                f"[{card}]")
    c = variants[-1][3]
    _, saves = tk.trunk_fwd_plain(p_t, cfg_t, h0, out, torch.bfloat16, c)
    pf = min(_time(torch, lambda: tk.trunk_fwd_plain(
        p_t, cfg_t, h0, out, torch.bfloat16, c), 2))
    pb = min(_time(torch, lambda: tk.trunk_bwd_plain(
        p_t, cfg_t, saves, du, out, c), 2))
    log(f"[time] plain trunk{'' if c is None else ' with cond'}, same "
        f"shapes, bf16 saves: forward {pf:.3f} ms, backward {pb:.3f} ms "
        f"[{card}]")
    log("[time] library call: none (no single PyTorch call computes the "
        "dilated trunk)")

    # the step's split: each part timed alone on the step's shapes
    L, D = cfg.num_layers, cfg.dilation_channels
    lp = params["layers"]
    h0e = pt.embed_inputs(params, cfg, x).detach()
    ce = (_expand_cond(params, cfg, frames, hop, x.shape[1]).detach()
          .requires_grad_(True) if cond_upsample else None)
    u = torch.rand((B, out, L * D), generator=g).to(dev).requires_grad_(True)
    logits = torch.randn((B, out, cfg.classes), generator=g).to(
        dev).requires_grad_(True)

    def embed():
        h = pt.embed_inputs(params, cfg, x)
        torch.autograd.grad(h, [params["start"]["w"]], torch.ones_like(h))

    def upsample():
        c = _expand_cond(params, cfg, frames, hop, x.shape[1])
        torch.autograd.grad(c, list(params["cond_up"].values()),
                            torch.ones_like(c))

    def trunk():
        uu = tk.fused_trunk(params, cfg, h0e, out, cond=ce)
        wrt = [lp["w_in"]] + ([] if ce is None else [lp["w_cond"], ce])
        torch.autograd.grad(uu, wrt, torch.ones_like(uu))

    def head():
        yy = skip_head(params, cfg, u)
        torch.autograd.grad(yy, [u, lp["w_skip"]], torch.ones_like(yy))

    gtree = pt.train_step(params, state, cfg, tx, x, y, *cargs)[1]

    def opt():
        tx.step(params, gtree, state)

    parts = {}
    for name, fn in (("embed fwd+bwd", embed),
                     *((("upsampler fwd+bwd", upsample),)
                       if cond_upsample else ()),
                     ("trunk K2+K3" + (" with cond" if cond_upsample else ""),
                      trunk),
                     ("skip+head fwd+bwd", head),
                     ("loss fwd+bwd", functools.partial(
                         _loss_part, torch, logits, y)),
                     ("optimizer", opt)):
        parts[name] = _time_median(torch, fn, 5)[0]
    total = sum(parts.values())
    log(f"[time] {config} step split (each part alone, median of 5): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        + f"; of the trunk, K3's reduction of the partial slots "
          f"{reduce_ms:.3f} ms (profiler); sum {total:.3f} ms against the "
          f"step's {step_ms:.3f} ms [{card}]")
    return dict(step_ms=step_ms, plain_step_ms=plain_step,
                targets_per_s=B * out / step_ms * 1e3, parts=parts,
                k=out_k, plain_fwd_ms=pf, plain_bwd_ms=pb,
                reduce_ms=reduce_ms)


def phase_step_alternation(torch, pt, dev, card, rounds=4):
    """The chaconne_wide train step at batch 16, f32 and ``--bf16``, in
    alternation (f32 then bf16, then bf16 then f32, ``rounds`` rounds):
    each round times the step and its optimizer and loss parts (as phase
    13's split; the loss on logits in the config's compute dtype), the
    median of 5 warm calls each. Whether ``--bf16`` costs more a step, and
    how far the parts that run the same code spread between rounds."""
    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

    B, runs = 16, {}
    for name, dtypes in (("f32", {}), ("bf16", dict(
            compute_dtype=torch.bfloat16, stream_dtype=torch.bfloat16))):
        cfg = pt.get_config("chaconne_wide", trunk_kernel=True, **dtypes)
        g = torch.Generator().manual_seed(4)
        x = torch.randint(0, cfg.classes, (B, cfg.item_length), generator=g)
        y = torch.randint(0, cfg.classes, (B, cfg.output_length),
                          generator=g)
        x, y = x.to(dev, torch.int32), y.to(dev, torch.int32)
        logits = torch.randn((B, cfg.output_length, cfg.classes),
                             generator=g).to(dev, cfg.compute_dtype)
        params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED),
                                 dev)
        for _, p in _leaves(params):
            p.requires_grad_(True)
        tx = pt.reference_adam(1e-4)
        state = tx.init(params)
        grads = pt.train_step(params, state, cfg, tx, x, y)[1]
        runs[name] = {
            "step": functools.partial(pt.train_step, params, state, cfg, tx,
                                      x, y),
            "optimizer": functools.partial(tx.step, params, grads, state),
            "loss": functools.partial(_loss_part, torch,
                                      logits.requires_grad_(True), y)}
    ms = {n: {part: [] for part in runs[n]} for n in runs}
    for r in range(rounds):
        for name in (("f32", "bf16") if r % 2 == 0 else ("bf16", "f32")):
            for part, fn in runs[name].items():
                ms[name][part].append(_time_median(torch, fn, 5)[0])
    for part in ("step", "optimizer", "loss"):
        log(f"[time] chaconne_wide batch 16, {part}, f32 and --bf16 in "
            f"alternation ({rounds} rounds, median of 5 warm calls each): "
            + "; ".join(f"{n} " + ", ".join(f"{m:.3f}" for m in v[part])
                        + f" ms (spread {max(v[part]) - min(v[part]):.3f})"
                        for n, v in ms.items()) + f" [{card}]")
    return ms


# ------------------------------------------------------------- the vocoder

VOCODER_WAV = "examples/generated_t1.0.wav"
# steps of the vocoder chunks that phases 17 and 23 time, the plain
# versions included (2048 until the multi-rank phases needed the time)
VOCODER_CHUNK = 1024
GCOND = 16  # global channels given the vocoder preset for the kernel checks


def _vocoder(torch, pt, dev, gcond=0):
    """The vocoder preset (10x3, R = D = 64, skip 1024, end 512, 80 mel
    channels), with ``gcond`` global channels when asked, random weights
    from SEED."""
    cfg = pt.get_config("vocoder", **({"gcond_channels": gcond}
                                      if gcond else {}))
    return cfg, pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)


def _normal(torch, shape, seed, dev, scale=0.5):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(dev)


def _forced_check(torch, ck, cp, gaps, rk, rp, steps, tag, what):
    """Teacher-forced classes off near-ties, rings within RING_TOL.
    Returns (ring error, mismatches, near-ties)."""
    miss = ck[:, :steps] != cp[:, :steps]
    ties = gaps[:, :steps] < NEAR_TIE
    bad = int((miss & ~ties).sum())
    err = float((rk - rp).abs().max())
    log(f"[{tag}] {what + ' ' if what else ''}teacher-forced {steps} "
        f"steps: {int(miss.sum())} "
        f"class mismatches ({bad} not at a near-tie, largest gap at one "
        f"{_flip_gap(miss, gaps[:, :steps]):.3g}), {int(ties.sum())} "
        f"near-ties (gap < {NEAR_TIE}), ring max abs err {err:.3g}")
    check(bad == 0, f"{tag} {what}: kernel disagrees with plain off a "
          f"near-tie")
    check(err <= RING_TOL, f"{tag} {what}: ring error {err} > {RING_TOL}")
    return err, int(miss.sum()), int(ties.sum())


def phase_cond_k1_vs_plain(torch, pt, gk, dev):
    """K1 at the vocoder's widths (the chain read from L2) against its plain
    version, without and with cond and gcond, exact and fuse_res:
    teacher-forced, then a resumed chunk; a chunked conditioned rollout
    equals one shot. Returns the largest ring error and the mismatch and
    near-tie counts of the conditioned checks."""
    cfg, params = _vocoder(torch, pt, dev, GCOND)
    C, M = cfg.classes, cfg.cond_channels
    ring_size = sum(gk.periods(cfg)) * cfg.residual_channels
    worst, mismatches, near_ties = 0.0, 0, 0
    prime = torch.randint(0, C, (1, 160),
                          generator=torch.Generator().manual_seed(7))
    prime = prime.to(dev, torch.int32)
    g = _normal(torch, (1, GCOND), 8, dev, 1.0)
    for fuse in (False, True):
        w = gk.prepare_weights(params, cfg, fuse)
        for conditioned in (False, True):
            tag = (f"K1 vocoder {'fuse_res' if fuse else 'exact'} "
                   f"{'cond + gcond' if conditioned else 'unconditioned'}")
            kw = {}
            if conditioned:
                kw = dict(zip(("cond", "gcond"), gk.project_cond(
                    params, cfg, _normal(torch, (1, 160, M), 9, dev), g, 1,
                    160)))
            rk = torch.zeros(ring_size, device=dev)
            rp = rk.clone()
            ck = gk.fused_cuda(w, cfg, prime, rk, 0, 160, 0.0, 0.0, 0, fuse,
                               **kw)
            torch.cuda.synchronize()
            cp, gaps = gk.fused_plain(w, cfg, prime, rp, 0, 160, 0.0, 0.0, 0,
                                      fuse, return_gaps=True, **kw)
            err, mm, nt = _forced_check(torch, ck, cp, gaps, rk, rp, 159,
                                        tag, "")
            err = max(err, _headless_check(
                torch, gk, lambda r, h: gk.fused_cuda(
                    w, cfg, prime, r, 0, 160, 0.0, 0.0, 0, fuse,
                    head_from=h, **kw), prime, ck, rk, cp, gaps, rp, tag))
            if not conditioned:
                continue
            worst, mismatches, near_ties = (max(worst, err), mismatches + mm,
                                            near_ties + nt)
            # a resumed chunk (the serving call): 128 steps from the
            # kernel's rings at t0 = 160, T = 0.9, its own cond rows
            kw = dict(zip(("cond", "gcond"), gk.project_cond(
                params, cfg, _normal(torch, (1, 128, M), 10, dev), g, 1,
                128)))
            rp = rk.clone()
            p = ck[:, -1:].contiguous()
            ck = gk.fused_cuda(w, cfg, p, rk, 160, 128, 0.9, 0.0, 21, fuse,
                               **kw)
            torch.cuda.synchronize()
            cp, gaps = gk.fused_plain(w, cfg, p, rp, 160, 128, 0.9, 0.0, 21,
                                      fuse, return_gaps=True, **kw)
            first = _first_mismatch(ck, cp)
            if first >= 0:
                gap = float(gaps[0, first])
                check(gap < NEAR_TIE, f"{tag} resumed chunk: rollouts part "
                      f"at step {first} where the plain gap is {gap}")
                log(f"[{tag}] resumed chunk t0=160 T=0.9: identical up to "
                    f"step {first}, a near-tie (gap {gap:.2g})")
                mismatches, near_ties = mismatches + 1, near_ties + 1
            else:
                err = float((rk - rp).abs().max())
                check(err <= RING_TOL, f"{tag} resumed chunk: ring error "
                      f"{err}")
                worst = max(worst, err)
                log(f"[{tag}] resumed chunk t0=160 T=0.9: identical over 128 "
                    f"steps, ring max abs err {err:.3g}")
    # a chunked conditioned rollout equals one shot, bitwise
    cond = _normal(torch, (1, 1000, M), 11, dev)
    kw = dict(temperature=1.0, fuse_res=True, return_state=True, device=dev,
              global_cond=g)
    one = prime[:, :1]
    _, c_all, s_all = pt.generate_fast_fused(params, cfg, 5, 1000, one,
                                             cond=cond, **kw)
    parts, st, pos = [], None, 0
    for m in (300, 400, 300):
        _, c, st = pt.generate_fast_fused(
            params, cfg, 5, m, one if st is None else None, state=st,
            cond=cond[:, pos:pos + m], **kw)
        pos += m
        parts.append(c)
    same = torch.equal(torch.cat(parts, dim=1), c_all) and all(
        torch.equal(a, b) for a, b in zip(st.rings, s_all.rings))
    check(same, "K1 vocoder: chunked conditioned rollout differs from one "
          "shot")
    log("[K1 vocoder fuse_res cond + gcond] 3-chunk resume (300+400+300, "
        "each with its own rows) equals one shot bitwise (classes and rings)")
    return worst, mismatches, near_ties


def phase_cond_k4_vs_plain(torch, pt, ghbm, dev):
    """K4 at the vocoder's widths against its plain version, 256 and 200
    lanes, exact and fuse_res + skip_slab, without and with cond rows and
    gcond: teacher-forced, then a resumed chunk at the pool's clock (t0 =
    513); the same 200 lanes at 8 and 16 lanes per cluster bitwise equal;
    a fresh call equal to its rollout over zeroed history; chunks resumed
    at t0 = 513 equal to one shot. Returns the largest ring error and the
    mismatch and near-tie counts of the conditioned checks."""
    cfg, params = _vocoder(torch, pt, dev, GCOND)
    C, M, rows = cfg.classes, cfg.cond_channels, ghbm.ring_rows(cfg)
    clock = max(ghbm.periods(cfg))
    worst, mismatches, near_ties = 0.0, 0, 0
    for lanes in (256, 200):
        zeros = torch.zeros(lanes, dtype=torch.int32, device=dev)
        greedy = torch.zeros(lanes, device=dev)
        temps, seeds, toffs = _lane_rows(torch, dev, lanes)
        prime = torch.randint(0, C, (lanes, 64),
                              generator=torch.Generator().manual_seed(7))
        prime = prime.to(dev, torch.int32)
        cond = _normal(torch, (700, M, lanes), 12, dev)
        for name, fuse, slab in K4_VARIANTS:
            w = ghbm.prepare_weights(params, cfg, fuse, slab)
            gcond = ghbm.project_gcond(
                w, cfg, _normal(torch, (lanes, GCOND), 13, dev, 1.0), lanes)

            def both(p, ring, t0, total, lane_rows, **kw):
                rp = ring.clone()
                ck = ghbm.batched_cuda(w, cfg, p, ring, t0, total,
                                       *lane_rows, 0, 0.0, fuse, slab, True,
                                       **kw)
                torch.cuda.synchronize()
                cp, gaps = ghbm.batched_plain(w, cfg, p, rp, t0, total,
                                              *lane_rows, 0, 0.0, fuse, slab,
                                              True, return_gaps=True, **kw)
                return ck, cp, gaps, ring, rp

            for conditioned in (False, True):
                tag = (f"K4 vocoder {lanes} lanes {name} "
                       f"{'cond + gcond' if conditioned else 'unconditioned'}")
                kw = (dict(cond=cond[:64].contiguous(), gcond=gcond)
                      if conditioned else {})
                ck, cp, gaps, rk, rp = both(
                    prime, torch.zeros(rows, lanes, device=dev), 0, 64,
                    (greedy, zeros, zeros), **kw)
                err, mm, nt = _forced_check(torch, ck, cp, gaps, rk, rp, 63,
                                            tag, "")
                err = max(err, _headless_check(
                    torch, ghbm, lambda r, h: ghbm.batched_cuda(
                        w, cfg, prime, r, 0, 64, greedy, zeros, zeros, 0,
                        0.0, fuse, slab, True, head_from=h, **kw),
                    prime, ck, rk, cp, gaps, rp, tag))
                if not conditioned:
                    continue
                worst, mismatches, near_ties = (
                    max(worst, err), mismatches + mm, near_ties + nt)
                # the pool's call: a chunk resumed at t0 = 513, hot lanes
                # with per-lane seeds and clocks, the chunk's own rows
                n, e = _rollout_check(
                    torch, *both(ck[:, -1:].contiguous(), rk, clock, 128,
                                 (temps, seeds, toffs),
                                 cond=cond[64:192].contiguous(),
                                 gcond=gcond),
                    tag, f"resumed chunk t0={clock} hot lane_seed")
                mismatches, near_ties = mismatches + n, near_ties + n
                worst = max(worst, e)
            if lanes != 200:
                continue
            tag = f"K4 vocoder 200 lanes {name} cond + gcond"
            one = prime[:, :1].contiguous()
            kw = dict(cond=cond[:600].contiguous(), gcond=gcond)
            widths = [t for t in ghbm.TILES
                      if gk_fits(ghbm, cfg, t, fuse, M)]
            ref = None
            for tile in widths:
                ring = torch.zeros(rows, lanes, device=dev)
                c = ghbm.batched_cuda(w, cfg, one, ring, clock, 600, temps,
                                      seeds, toffs, 0, 0.0, fuse, slab, True,
                                      tile=tile, **kw)
                if ref is None:
                    ref = (c, ring)
                check(torch.equal(c, ref[0]) and torch.equal(ring, ref[1]),
                      f"{tag}: tile {tile} differs from tile {widths[0]}")
            log(f"[{tag}] the same lanes at widths {widths} of lanes per "
                f"cluster: bitwise equal classes and ring over 600 steps at "
                f"t0={clock}")
            check(len(widths) >= 2, f"{tag}: fewer than two widths fit")
            # chunks resumed at the pool's clock equal one shot
            ring = torch.zeros(rows, lanes, device=dev)
            parts, p, t0 = [], one, clock
            for m in (1, 250, 349):
                at = t0 - clock
                parts.append(ghbm.batched_cuda(
                    w, cfg, p, ring, t0, m, temps, seeds, toffs, 0, 0.0, fuse,
                    slab, True, cond=cond[at:at + m].contiguous(),
                    gcond=gcond))
                p = parts[-1][:, -1:].contiguous()
                t0 += m
            check(torch.equal(torch.cat(parts, dim=1), ref[0])
                  and torch.equal(ring, ref[1]),
                  f"{tag}: chunks resumed at t0={clock} differ from one shot")
            log(f"[{tag}] chunks resumed at t0 = {clock} (1+250+349, each "
                f"with its own rows) equal one shot bitwise")
            # the pool's admission: a fresh call equals its rollout at the
            # pool's clock over zeroed history
            r_fresh = torch.full((rows, lanes), float("nan"), device=dev)
            c_fresh = ghbm.batched_cuda(w, cfg, one, r_fresh, 0, 600, temps,
                                        seeds, toffs + clock, 0, 0.0, fuse,
                                        slab, True, **kw)
            same = (torch.equal(c_fresh, ref[0]) and torch.equal(
                _roll_ring(torch, ghbm, cfg, r_fresh, clock), ref[1]))
            check(same, f"{tag}: a fresh call differs from its rollout over "
                  f"zeroed history")
            log(f"[{tag}] fresh call equals its rollout at t0={clock} over "
                f"zeroed history bitwise (classes and ring, 600 steps)")
    return worst, mismatches, near_ties


def _vocoder_mel(pt, blob, cfg, hop=256, n_fft=1024):
    """The log-mel frames the server computes for an uploaded wav."""
    from pytorch_wavenet_tpu_torch.ops.mel import log_mel_spectrogram

    with tempfile.NamedTemporaryFile(suffix=".wav") as f:
        f.write(blob)
        f.flush()
        wav, sr = pt.load_audio(f.name)
    return log_mel_spectrogram(wav, num_mels=cfg.cond_channels, n_fft=n_fft,
                               hop_length=hop, sampling_rate=sr)


def _serve_vocoder(path, extra, timeout=600):
    """Start ``serving.server.main`` on the checkpoint; returns (server,
    thread, base url)."""
    from pytorch_wavenet_tpu_torch.serving import server as srv

    box, ready = {}, threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    th = threading.Thread(target=srv.main, kwargs=dict(
        argv=["--snapshot", path, "--port", "0"] + extra, on_ready=on_ready),
        daemon=True)
    t0 = time.time()
    th.start()
    while not ready.wait(1):
        check(th.is_alive() and time.time() - t0 < timeout,
              "vocoder server did not come up")
    server = box["server"]
    base = f"http://127.0.0.1:{server.server_address[1]}"
    log(f"[vocode] {' '.join(extra) or 'single stream'}: up in "
        f"{time.time() - t0:.1f} s at {base}")
    return server, th, base


def _post_vocode(base, blob, query):
    req = urllib.request.Request(f"{base}/vocode?{query}", data=blob,
                                 method="POST")
    t = time.time()
    with urllib.request.urlopen(req, timeout=900) as r:
        check(r.headers["Content-Type"] == "audio/wav", "not audio/wav")
        out = r.read()
    return out, time.time() - t


def phase_vocode_serving(torch, np, pt, gk, ghbm, dev):
    """The main path of this slice: POST /vocode at the vocoder preset,
    single stream (K1 through ``synthesize``) and pooled (``--batcher
    --lanes 256 --batch-chunk 2048 --cond-hop 256``: K4 in frames mode),
    each response byte-equal to its solo rollout of the same mel, the
    launches counted around each and the plain versions barred. Returns
    (K1 launches, K4 launches, the served figures)."""
    from pytorch_wavenet_tpu_torch.ops.mel import (expand_frames_window,
                                                   frames_window_len)
    from pytorch_wavenet_tpu_torch.ops.mulaw import dequantize_to_f32
    from pytorch_wavenet_tpu_torch.serving import server as srv

    cfg, params = _vocoder(torch, pt, dev)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, VOCODER_WAV), "rb") as f:
        blob = f.read()
    mel = _vocoder_mel(pt, blob, cfg)
    n = mel.shape[0] * 256
    log(f"[vocode] {VOCODER_WAV}: {len(blob)} bytes, {mel.shape[0]} mel "
        f"frames of {mel.shape[1]} -> {n} samples a response")
    barred_calls = []

    def barred(*args, **kwargs):
        barred_calls.append(1)
        raise RuntimeError("the plain version ran on the card path")

    real = (gk.fused_plain, ghbm.batched_plain)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        path = pt.save_checkpoint(d, "vocoder", 0, params, cfg=cfg)
        # single stream: two requests through K1
        single = [(0.9, 11), (1.0, 12)]
        gk.fused_plain, ghbm.batched_plain = barred, barred
        gk.launches = ghbm.launches = 0
        try:
            server, th, base = _serve_vocoder(path, [])
            try:
                got = [_post_vocode(base, blob, f"temperature={t}&seed={s}")
                       for t, s in single]
            finally:
                server.shutdown()
                th.join(120)
        finally:
            gk.fused_plain, ghbm.batched_plain = real
        k1_launched, k4_single = gk.launches, ghbm.launches
        check(not th.is_alive(), "vocoder server thread did not stop")
        check(not barred_calls and k4_single == 0,
              f"plain calls {len(barred_calls)}, K4 launches {k4_single} on "
              f"the single-stream path")
        check(k1_launched == 1 + len(single),
              f"{k1_launched} K1 launches, expected {1 + len(single)} (1 "
              f"warm-up + one per request)")
        for (temp, seed), (body, dt) in zip(single, got):
            pcm = np.frombuffer(_read_wav(body, n), "<i2")
            wav, _ = pt.synthesize(params, cfg, srv.Synthesizer.kernel_seed(
                seed), mel, 256, temperature=temp,
                backend=pt.generate_fast_fused, fuse_res=True, device=dev)
            wav = wav[0].cpu().numpy()
            check(np.isfinite(wav).all(), "non-finite waveform")
            solo = np.clip(wav * 32767.0, -32768, 32767).astype("<i2")
            check(np.array_equal(pcm, solo), f"single-stream /vocode T={temp} "
                  f"differs from synthesize on the same mel")
            log(f"[vocode] single stream T={temp} seed {seed}: {dt:.2f} s, "
                f"{n / dt:.0f} samples/s; equals synthesize on the same mel "
                f"byte for byte")
        out["single_s"] = [dt for _, dt in got]
        log(f"[vocode] K1 launches during single-stream serving: "
            f"{k1_launched} (1 warm-up + {len(single)} requests); plain "
            f"calls 0")

        # pooled: 16 concurrent requests through the batcher's frames mode
        n_req = 16
        temps = [(0.9, 1.0, 0.0, 0.9)[i % 4] for i in range(n_req)]
        gk.fused_plain, ghbm.batched_plain = barred, barred
        gk.launches = ghbm.launches = 0
        try:
            server, th, base = _serve_vocoder(path, [
                "--batcher", "--lanes", "256", "--batch-chunk", "2048",
                "--cond-hop", "256"])
            try:
                res = [None] * n_req

                def fetch(i):
                    res[i] = _post_vocode(
                        base, blob, f"temperature={temps[i]}&seed={600 + i}")

                threads = [threading.Thread(target=fetch, args=(i,))
                           for i in range(n_req)]
                t = time.time()
                for th_ in threads:
                    th_.start()
                for th_ in threads:
                    th_.join(900)
                wall = time.time() - t
                with urllib.request.urlopen(base + "/stats", timeout=60) as r:
                    stats = json.loads(r.read())
            finally:
                server.shutdown()
                th.join(120)
        finally:
            gk.fused_plain, ghbm.batched_plain = real
        k4_launched, k1_pool = ghbm.launches, gk.launches
    check(not th.is_alive(), "vocoder batcher thread did not stop")
    check(all(r is not None for r in res), "a /vocode request did not finish")
    check(not barred_calls and k1_pool == 0,
          f"plain calls {len(barred_calls)}, K1 launches {k1_pool} on the "
          f"pooled path")
    expect = stats["pool_steps"] + stats["prime_calls"] + 2  # 2 prewarm steps
    log(f"[vocode] K4 launches during pooled serving: {k4_launched} "
        f"(expected {expect}: {stats['pool_steps']} pool steps + "
        f"{stats['prime_calls']} prime calls + 2 prewarm steps, with and "
        f"without cond); K1 launches {k1_pool}; plain calls 0; bytes up "
        f"{stats['bytes_up']}, down {stats['bytes_down']}")
    check(k4_launched == expect, f"{k4_launched} K4 launches, expected "
          f"{expect}")
    check(stats["completed"] >= n_req and stats["failed"] == 0,
          f"/stats: {stats}")
    # the solo rollouts: the whole timeline's rows expanded in one shot (the
    # last frame replicated past the end), one call with every request's
    # seed and temperature as its own lane
    need = frames_window_len(n, 256)
    idx = np.minimum(np.arange(max(mel.shape[0], need)), mel.shape[0] - 1)
    rows = expand_frames_window(
        None, torch.from_numpy(mel[idx])[None].to(dev), 256,
        torch.zeros(1, dtype=torch.long, device=dev), n)
    _, cls = pt.generate_fast_batched(
        params, cfg, 0, n, [[cfg.classes // 2]] * n_req,
        temperature=np.asarray(temps, np.float32),
        lane_seed=[600 + i for i in range(n_req)],
        cond=rows.expand(n_req, -1, -1), fuse_res=True, skip_slab=True,
        device=dev)
    cls = cls.cpu().numpy()
    for i, (body, _) in enumerate(res):
        pcm = np.frombuffer(_read_wav(body, n), "<i2")
        wav = dequantize_to_f32(cls[i], cfg.classes)
        solo = np.clip(wav * 32767.0, -32768, 32767).astype("<i2")
        check(np.array_equal(pcm, solo), f"pooled /vocode request {i} "
              f"(T={temps[i]}) differs from its solo rollout")
    lat = sorted(dt for _, dt in res)
    served = n_req * n / wall
    log(f"[vocode] {n_req} concurrent /vocode requests of {n} samples in "
        f"{wall:.2f} s: {served:.0f} samples/s served, request time median "
        f"{lat[n_req // 2]:.2f} s, max {lat[-1]:.2f} s; all equal their solo "
        f"rollouts of the same frames byte for byte; {stats['pool_steps']} "
        f"pool steps of 2048")
    out.update(pooled_samples_per_s=served, pooled_wall_s=wall,
               pooled_median_s=lat[n_req // 2])
    return k1_launched, k4_launched, out


def _vocoder_chunk(torch, ghbm, cfg, params, dev, lanes, steps,
                   ring_dtype=None):
    """Phase 17's K4 chunk at the vocoder, from fixed seeds: the packed
    weights (fuse_res + skip_slab), prime, ring (zeros, f32 or
    ``ring_dtype``), per-lane rows (T = 0.9, lane_seed), cond rows and the
    gcond table. Phase 23 times the same chunk at bf16 rings."""
    rdt = torch.float32 if ring_dtype is None else ring_dtype
    w = ghbm.prepare_weights(params, cfg, True, True, rdt)
    prime = torch.randint(0, cfg.classes, (lanes, 1),
                          generator=torch.Generator().manual_seed(3))
    ring = torch.zeros(ghbm.ring_rows(cfg), lanes, dtype=rdt, device=dev)
    _, seeds, toffs = _lane_rows(torch, dev, lanes)
    cond = _normal(torch, (steps, cfg.cond_channels, lanes), 16, dev)
    gcond = ghbm.project_gcond(
        w, cfg, _normal(torch, (lanes, GCOND), 17, dev, 1.0), lanes)
    return (w, prime.to(dev, torch.int32), ring,
            torch.full((lanes,), 0.9, device=dev), seeds, toffs, cond, gcond)


def phase_vocoder_times(torch, pt, gk, ghbm, dev, card):
    """K1 (one stream) and K4 (256 lanes) on a resumed VOCODER_CHUNK-step
    chunk at the vocoder, without conditioning, with cond rows, and with cond and
    gcond; the plain versions on the conditioned chunk; bounds. Returns
    the conditioned measurements for the kernels line."""
    cfg, params = _vocoder(torch, pt, dev, GCOND)
    M, L, D = cfg.cond_channels, cfg.num_layers, cfg.dilation_channels
    steps, clock = VOCODER_CHUNK, max(gk.periods(cfg))
    out = {}
    # K1: one stream, fuse_res (the serving call), resumed at t0 = clock
    w = gk.prepare_weights(params, cfg, True)
    prime = torch.full((1, 1), cfg.classes // 2, dtype=torch.int32,
                       device=dev)
    ring = torch.zeros(sum(gk.periods(cfg)) * cfg.residual_channels,
                       device=dev)
    cond, gcond = gk.project_cond(
        params, cfg, _normal(torch, (1, steps, M), 14, dev),
        _normal(torch, (1, GCOND), 15, dev, 1.0), 1, steps)
    us = {}
    for what, kw in (("no cond", {}), ("cond", dict(cond=cond)),
                     ("cond + gcond", dict(cond=cond, gcond=gcond))):
        ms = _time(torch, lambda: gk.fused_cuda(
            w, cfg, prime, ring, clock, steps, 0.9, 0.0, 1, True, **kw), 3)
        us[what] = 1e3 * min(ms) / steps
        extra_b = 4 * steps * L * 2 * D * (("cond" in kw) + ("gcond" in kw))
        b_ms, b_by = bound_ms(pt, gk, params, cfg, 1, 1, steps,
                              extra_bytes=extra_b)
        log(f"[time] K1 vocoder fuse_res, one stream, resumed {steps}-step "
            f"chunk, {what}: " + ", ".join(f"{m:.2f}" for m in ms)
            + f" ms; {us[what]:.2f} us/step; bound {b_ms:.4f} ms ({b_by}) "
            f"[{card}]")
        if what == "cond + gcond":
            out["K1"] = dict(ms=min(ms), bound_ms=b_ms, bound_by=b_by)
    log(f"[time] K1 vocoder: cond costs {us['cond'] - us['no cond']:.2f} "
        f"us/step, cond + gcond {us['cond + gcond'] - us['no cond']:.2f} "
        f"[{card}]")
    out["K1"]["us"] = us
    plain = _time(torch, lambda: gk.fused_plain(
        w, cfg, prime, ring, clock, steps, 0.9, 0.0, 1, True, cond=cond,
        gcond=gcond), 1, warm=False)[0]
    out["K1"]["plain_ms"] = plain
    log(f"[time] plain version, the same K1 chunk with cond + gcond: "
        f"{plain:.1f} ms, {1e3 * plain / steps:.1f} us/step [{card}]")
    # K4: 256 lanes, fuse_res + skip_slab, resumed at the pool's clock
    lanes = 256
    w, prime, ring, temps, seeds, toffs, cond, gcond = _vocoder_chunk(
        torch, ghbm, cfg, params, dev, lanes, steps)
    tile = ghbm.default_tile(lanes, cfg, True, lambda t: (
        ghbm.max_active_clusters(cfg, t, True, True, M)), M)
    act = {t: ghbm.max_active_clusters(cfg, t, True, True, M)
           for t in ghbm.TILES if gk_fits(ghbm, cfg, t, True, M)}
    log(f"[time] K4 vocoder, 256 lanes with cond: default tile {tile} lanes "
        f"per cluster of {ghbm.CLUSTER} ({-(-lanes // tile)} clusters); max "
        f"active clusters by width {act}; shared bytes by width "
        + str({t: ghbm.shared_bytes(cfg, t, True, cond=True) for t in act})
        + f" [{card}]")
    us = {}
    for what, kw in (("no cond", {}), ("cond", dict(cond=cond)),
                     ("cond + gcond", dict(cond=cond, gcond=gcond))):
        ms = _time(torch, lambda: ghbm.batched_cuda(
            w, cfg, prime, ring, clock, steps, temps, seeds, toffs, 0, 0.0,
            True, True, True, **kw), 1)
        us[what] = 1e3 * min(ms) / steps
        has_c, has_g = "cond" in kw, "gcond" in kw
        b_ms, b_by = bound_ms(
            pt, ghbm, params, cfg, lanes, 1, steps, lane_rows=3,
            extra_bytes=4 * (steps * M * lanes * has_c
                             + L * 2 * D * lanes * has_g),
            extra_flops=lanes * steps * 2 * M * 2 * D * L * has_c)
        log(f"[time] K4 vocoder fuse_res+skip_slab, 256 lanes, resumed "
            f"{steps}-step chunk, T=0.9 lane_seed, {what}: "
            + ", ".join(f"{m:.2f}" for m in ms)
            + f" ms; {us[what]:.2f} us/step, "
            f"{lanes * steps / min(ms) * 1e3:.0f} samples/s; bound "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / min(ms):.2f} % of it "
            f"[{card}]")
        if what == "cond + gcond":
            out["K4"] = dict(ms=min(ms), bound_ms=b_ms, bound_by=b_by)
    log(f"[time] K4 vocoder: cond costs {us['cond'] - us['no cond']:.2f} "
        f"us/step, cond + gcond {us['cond + gcond'] - us['no cond']:.2f} "
        f"[{card}]")
    out["K4"]["us"] = us
    tm = torch.zeros(len(ghbm.PHASES), dtype=torch.int64, device=dev)
    ghbm.batched_cuda(w, cfg, prime, ring, clock, steps, temps, seeds, toffs,
                      0, 0.0, True, True, True, timers=tm, cond=cond,
                      gcond=gcond)
    torch.cuda.synchronize()
    log("[time] K4 vocoder 256 lanes cond + gcond, per step: "
        + ", ".join(f"{n} {v / (steps * 1e3):.2f} us"
                    for n, v in zip(ghbm.PHASES, tm.tolist()))
        + f" [{card}]")
    plain = _time(torch, lambda: ghbm.batched_plain(
        w, cfg, prime, ring, clock, steps, temps, seeds, toffs, 0, 0.0, True,
        True, True, cond=cond, gcond=gcond), 1, warm=False)[0]
    out["K4"]["plain_ms"] = plain
    log(f"[time] plain version, the same K4 chunk with cond + gcond: "
        f"{plain:.1f} ms, {1e3 * plain / steps:.1f} us/step [{card}]")
    log("[time] library call: none (no single PyTorch call computes either "
        "loop)")
    return out


# --------------------------------------------- conditioned training (K2/K3)

VOCODER_UPSAMPLE = (16, 16)  # the learnable upsampler's factors (hop 256)


def _cond_rows(torch, cfg, batch, out_len, dev, seed=5):
    """Random cond rows (batch, T, M), about the spread of log-mel
    features."""
    T = cfg.receptive_field + out_len - 1
    return _normal(torch, (batch, T, cfg.cond_channels), seed, dev, 2.0)


def phase_cond_k23_vs_plain(torch, pt, tk, dev):
    """K2 and K3 with cond against their plain versions at the vocoder (R =
    D = 64, 80 mel channels), out 1024, f32 and bf16 saves: u, every
    gradient, dW_cond and dcond; two conditioned K3 calls bitwise equal.
    Batch 16 is the main path's (phase 19; K3's slot geometry depends on
    the batch), batch 4 a second geometry. Returns the largest unit error
    and the largest f32-save gradient error (absolute) at batch 16."""
    errs = []
    for batch in (16, 4):
        cfg, params, h0, du = _trunk_case(torch, pt, dev, "vocoder", batch,
                                          1024)
        cond = _cond_rows(torch, cfg, batch, 1024, dev)
        errs.append(_k23_check(torch, tk, f"K2/K3 vocoder cond batch {batch} "
                               "out 1024", cfg, params, h0, du, 1024, cond))
    return errs[0]


# -------------------------------------------------------------------- main



# ------------------------------------- reduced-precision inputs (phases 21-24)

def bf16_flips(torch, a, b):
    """Where two bf16 tensors differ: ``(count, all within one bf16 ulp of
    the larger, max |a - b|)``. One ulp of |x| is 2^(floor(log2 |x|) - 7);
    a value within U_TOL of 0 may also differ by that much (the two sides'
    f32 sums, which differ by about that, decide its rounding and
    sign)."""
    fa, fb = a.to(torch.float32), b.to(torch.float32)
    d = (fa - fb).abs()
    m = torch.maximum(fa.abs(), fb.abs())
    ulp = torch.exp2(torch.floor(torch.log2(m.clamp(min=1e-30))) - 7)
    ok = d <= ulp + U_TOL
    return int((d > 0).sum()), bool(ok.all()), float(d.max())


def ring_flips(torch, a, b):
    """The same for rings: bf16 as :func:`bf16_flips`; int8 rings within
    one count, ``(count, within, max counts)``."""
    if a.dtype == torch.int8:
        d = (a.to(torch.int32) - b.to(torch.int32)).abs()
        return int((d > 0).sum()), bool((d <= 1).all()), float(d.max())
    return bf16_flips(torch, a, b)


def phase_bf16_k23_vs_plain(torch, pt, tk, dev):
    """K2 and K3 at a bf16 stream against their plain versions: the main
    path's shapes (chaconne_wide, batch 16, out 1024) and the vocoder with
    cond at batch 4, out 1024. Layer by layer from the kernel's own input
    stream: u within U_TOL x max(1, |u|) of the plain layer's, and the
    stream the kernel writes against the plain layer's, its flips counted
    and each within one bf16 ulp (:func:`bf16_flips`); end to end the units
    and the last stream against the plain walk's (reported: a flip moves
    the later layers). K3 on the kernel's saves within GRAD_TOL x max(1,
    scale) of the plain version, two calls bitwise equal, and f32 saves
    (K2's, holding the same values) giving bitwise the gradients of bf16
    ones. Returns the largest unit error, the largest gradient error
    (absolute) and the stream flips."""
    u_err = g_err = 0.0
    flips_all = 0
    for name, batch, cond_on in (("chaconne_wide", 16, False),
                                 ("vocoder", 4, True)):
        out = 1024
        cfg, params, h0, du = _trunk_case(torch, pt, dev, name, batch, out,
                                          stream_dtype=torch.bfloat16)
        cond = _cond_rows(torch, cfg, batch, out, dev) if cond_on else None
        tag = f"K2/K3 {name} batch {batch} out {out} bf16 stream" + (
            " cond" if cond_on else "")
        uk, sk = tk.trunk_fwd_cuda(params, cfg, h0, out, torch.bfloat16,
                                   cond)
        uk32, sk32 = tk.trunk_fwd_cuda(params, cfg, h0, out, torch.float32,
                                       cond)
        torch.cuda.synchronize()
        s, sp = tk.windows(cfg, out)
        T, D, L = h0.shape[1], cfg.dilation_channels, cfg.num_layers
        check(sk.dtype == torch.bfloat16 and sk32.dtype == torch.float32
              and torch.equal(uk, uk32) and all(
                  torch.equal(sk32[l, :, sp[l]:], sk[l, :, sp[l]:].float())
                  for l in range(L)),
              f"{tag}: f32 and bf16 saves of a bf16 stream differ")
        check(torch.equal(sk[0], h0.to(torch.bfloat16)),
              f"{tag}: the stream did not enter rounded")
        cr = None if cond is None else tk.round_bf16(cond)
        eu, flips, within, worst = 0.0, 0, True, 0.0
        for l in range(L):
            u, hn = tk.layer_fwd_plain(params, cfg, l, sk[l].float(), cr)
            ref = u[:, T - out:]
            got = uk[:, :, l * D:(l + 1) * D]
            eu = max(eu, float(((got - ref).abs()
                                / ref.abs().clamp(min=1.0)).max()))
            u_err = max(u_err, float((got - ref).abs().max()))
            if l + 1 < L:
                n, ok, d = bf16_flips(torch, hn[:, s[l]:].to(torch.bfloat16),
                                      sk[l + 1, :, s[l]:])
                flips, within, worst = flips + n, within and ok, max(worst, d)
        check(eu <= U_TOL, f"{tag}: u error {eu} x max(1, |u|)")
        check(within, f"{tag}: a stream flip beyond one bf16 ulp ({worst})")
        flips_all += flips
        n_stream = sum(batch * (T - s[l]) * cfg.residual_channels
                       for l in range(L - 1))
        up, sp_ = tk.trunk_fwd_plain(params, cfg, h0, out, torch.bfloat16,
                                     cond)
        e2e = float((uk - up).abs().max())
        n_e, _, d_e = bf16_flips(torch, sp_[-1, :, s[-2]:], sk[-1, :, s[-2]:])
        log(f"[{tag}] layer by layer from the kernel's stream: u within "
            f"{eu:.3g} x max(1, |u|) (tol {U_TOL}); the stream it writes: "
            f"{flips} of {n_stream} values one bf16 ulp off the plain "
            f"layer's (largest difference {worst:.3g}), none beyond; end to "
            f"end: u within {e2e:.3g} of the plain walk's, the last layer's "
            f"stream {n_e} values apart (largest {d_e:.3g}): the flips "
            f"carry forward")
        gk = tk.trunk_bwd_cuda(params, cfg, sk, du, out, cond)
        again = tk.trunk_bwd_cuda(params, cfg, sk, du, out, cond)
        g32 = tk.trunk_bwd_cuda(params, cfg, sk32, du, out, cond)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(gk, again)),
              f"{tag}: two K3 calls differ")
        check(all(torch.equal(a, b) for a, b in zip(gk, g32)),
              f"{tag}: f32 saves give other gradients than bf16 saves")
        gp = tk.trunk_bwd_plain(params, cfg, sk, du, out, cond)
        eg = _grad_err(gk, gp)
        check(eg <= GRAD_TOL, f"{tag}: K3 vs plain {eg}")
        g_err = max(g_err, max(float((a - b).abs().max())
                               for a, b in zip(gk, gp)))
        log(f"[{tag}] K3 on the kernel's saves: every gradient"
            f"{', dW_cond and dcond' if cond_on else ''} within {eg:.3g} x "
            f"max(1, scale) of the plain version (tol {GRAD_TOL}); two K3 "
            f"calls bitwise equal; f32 saves give bitwise the same "
            f"gradients")
    return u_err, g_err, flips_all


RING_DTYPES = ("bf16", "int8")
# steps of phase 23's chaconne chunk, checked one step at a time against
# the plain version (2048 until the multi-rank phases needed the time;
# from t0 = 513 it still wraps the longest ring, 513 slots, once over)
RING_LOCKSTEP = 768


def _lockstep(torch, ghbm, cfg, w, prime, ring, t0, steps, lane_rows, tag,
              kw=None):
    """Kernel and plain version step by step from the kernel's own state
    (``ring``, advanced in place): at each step the plain version starts
    from a copy of the kernel's ring and the same input class (``prime``'s
    column t while it lasts, then the kernel's last class), so every step
    compares the two on equal inputs. Classes agree off near-ties of the
    plain scores; the ring slots each step writes agree within one bf16
    ulp or one int8 count (:func:`ring_flips`). Returns the kernel's
    classes (streams, steps), the plain version's time in ms, and
    ``(mismatches, near-ties, ring values off, largest)``."""
    from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel as gk

    kw = kw or {}
    cond = kw.get("cond")
    rp = torch.empty_like(ring)
    cls, mm, nt, off, worst, within, plain_s = [], 0, 0, 0, 0.0, True, 0.0
    p = prime[:, :1].contiguous()
    for t in range(steps):
        if t < prime.shape[1]:
            p = prime[:, t:t + 1].contiguous()
        extra = dict(kw)
        if cond is not None:
            extra["cond"] = cond[t:t + 1].contiguous()
        rp.copy_(ring)
        ck = ghbm.batched_cuda(w, cfg, p, ring, t0 + t, 1, *lane_rows, 0,
                               0.0, True, True, True, **extra)
        torch.cuda.synchronize()
        a = time.perf_counter()
        with gk.full_f32():
            cp, gaps = ghbm.batched_plain(w, cfg, p, rp, t0 + t, 1,
                                          *lane_rows, 0, 0.0, True, True,
                                          True, return_gaps=True, **extra)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - a
        miss = ck != cp
        ties = gaps < NEAR_TIE
        check(not bool((miss & ~ties).any()),
              f"{tag}: step {t}: a class differs off a near-tie")
        mm, nt = mm + int(miss.sum()), nt + int(ties.sum())
        n, ok, d = ring_flips(torch, ring, rp)
        off, within, worst = off + n, within and ok, max(worst, d)
        cls.append(ck)
        p = ck
    check(within, f"{tag}: a ring value beyond one unit ({worst})")
    return torch.cat(cls, dim=1), 1e3 * plain_s, (mm, nt, off, worst)


def phase_ring_k4_vs_plain(torch, pt, ghbm, dev, card):
    """K4 with bf16 and int8 rings against its plain version: chaconne,
    256 lanes, fuse_res + skip_slab (the pool's flags), int8 scales from
    ``calibrate_ring_scales`` on a greedy receptive-field prime. A
    teacher-forced 64-step prime at t0 = 449, then the pool's call, a
    resumed RING_LOCKSTEP-step chunk at t0 = 513, T in {0, 0.9, 1} with
    lane_seed, run in one launch and again in lockstep with the plain
    version (:func:`_lockstep`): the one-step launches equal the one
    launch bitwise (classes and ring), and every step agrees with the plain
    version; three resumed chunks equal one shot bitwise. Then the vocoder
    with cond + gcond at bf16 rings (256 lanes, 256 steps in lockstep).
    Times (CUDA events, min of 2) and the kernel's phase split at 256
    lanes; the vocoder on phase 17's chunk, f32 and bf16 rings
    in alternation, and its phase split at bf16 rings. Returns ``{ring: figures}`` for the kernels line and
    the scales."""
    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    lanes, rows, clock = 256, ghbm.ring_rows(cfg), max(ghbm.periods(cfg))
    g = torch.Generator().manual_seed(21)
    cal = torch.randint(0, cfg.classes, (16, cfg.receptive_field),
                        generator=g)
    scales = ghbm.calibrate_ring_scales(params, cfg, cal, num_samples=256,
                                        device=dev)
    check(bool((scales > 0).all()) and scales.shape == (cfg.num_layers,),
          f"ring scales {scales}")
    log(f"[K4 rings] int8 scales from calibrate_ring_scales (16 streams, a "
        f"receptive-field prime + 256 greedy steps at bf16 rings, margin "
        f"1.05): " + ", ".join(f"{x:.4f}" for x in scales.tolist()))
    prime = torch.randint(0, cfg.classes, (lanes, 64), generator=g).to(
        dev, torch.int32)
    zeros = torch.zeros(lanes, dtype=torch.int32, device=dev)
    greedy = torch.zeros(lanes, device=dev)
    hot = _lane_rows(torch, dev, lanes)
    out = {}
    for rname in RING_DTYPES:
        rdt = getattr(torch, {"bf16": "bfloat16", "int8": "int8"}[rname])
        tag = f"K4 chaconne {lanes} lanes {rname} rings"
        w = ghbm.prepare_weights(params, cfg, True, True, rdt,
                                 scales if rname == "int8" else None)
        ring = torch.zeros(rows, lanes, dtype=rdt, device=dev)
        start, _, mmf = _lockstep(torch, ghbm, cfg, w, prime, ring,
                                  clock - 64, 64, (greedy, zeros, zeros),
                                  tag + " teacher-forced")
        state = ring.clone()
        # the same 64 steps in one launch, with the head on every step and
        # with head_from 63: both bitwise the lockstep's ring and last class
        one_shot = []
        for head_from in (0, 63):
            before = (ghbm.launches, ghbm.headless_launches)
            r = torch.zeros_like(ring)
            c = ghbm.batched_cuda(w, cfg, prime, r, clock - 64, 64, greedy,
                                  zeros, zeros, 0, 0.0, True, True, True,
                                  head_from=head_from)
            torch.cuda.synchronize()
            one_shot.append((torch.equal(r, state)
                             and torch.equal(c[:, -1], start[:, -1]),
                             (ghbm.launches - before[0],
                              ghbm.headless_launches - before[1])))
        fed = torch.equal(c[:, :-1], prime[:, 1:])
        log(f"[{tag}] the teacher-forced 64 steps in one launch, head_from "
            f"0 and 63: ring and last class bitwise the lockstep's "
            f"{[ok for ok, _ in one_shot]}, launches (kernel, headless) "
            f"{[n for _, n in one_shot]}; headless positions the prime's "
            f"next class: {fed}")
        check(one_shot == [(True, (1, 0)), (True, (1, 1))] and fed,
              f"{tag}: one-launch teacher-forced steps {one_shot}, fed "
              f"{fed}")
        first = start[:, -1:].contiguous()
        one_ring = state.clone()
        n = RING_LOCKSTEP
        one = ghbm.batched_cuda(w, cfg, first, one_ring, clock, n, *hot,
                                0, 0.0, True, True, True)
        lock_ring = state.clone()
        cls, plain_ms, (mm, nt, off, worst) = _lockstep(
            torch, ghbm, cfg, w, first, lock_ring, clock, n, hot, tag)
        check(torch.equal(cls, one) and torch.equal(lock_ring, one_ring),
              f"{tag}: {n} one-step launches differ from one launch")
        parts, r3, p, t0 = [], state.clone(), first, clock
        for m in (1, n // 2, n - 1 - n // 2):
            parts.append(ghbm.batched_cuda(w, cfg, p, r3, t0, m, *hot, 0,
                                           0.0, True, True, True))
            p, t0 = parts[-1][:, -1:].contiguous(), t0 + m
        check(torch.equal(torch.cat(parts, dim=1), one)
              and torch.equal(r3, one_ring),
              f"{tag}: three resumed chunks differ from one shot")
        unit = "bf16 ulp" if rname == "bf16" else "int8 count"
        log(f"[{tag}] teacher-forced 64 steps at t0={clock - 64}: "
            f"{mmf[0]} class mismatches, {mmf[2]} ring values one {unit} "
            f"off; the pool's resumed {n}-step chunk at t0={clock} (T in "
            f"0/0.9/1, lane_seed), step by step from the kernel's state: "
            f"{mm} class mismatches, all at near-ties ({nt} near-ties, gap "
            f"< {NEAR_TIE}), {off} ring values written one {unit} off the "
            f"plain version's (largest difference {worst:.3g}), none beyond; "
            f"{n} one-step launches equal the one launch bitwise, and so do "
            f"three resumed chunks (1 + {n // 2} + {n - 1 - n // 2})")
        # times: the same chunk, min of 2, and the phase split
        b_ms, b_by = bound_ms(pt, ghbm, params, cfg, lanes, 1, n,
                              lane_rows=3, ring_bytes=rdt.itemsize,
                              skip_bf16=True)
        r = state.clone()
        ms = min(_time(torch, lambda: ghbm.batched_cuda(
            w, cfg, first, r, clock, n, *hot, 0, 0.0, True, True, True),
            2))
        tm = torch.zeros(len(ghbm.PHASES), dtype=torch.int64, device=dev)
        r = state.clone()
        ghbm.batched_cuda(w, cfg, first, r, clock, n, *hot, 0, 0.0, True,
                          True, True, timers=tm)
        torch.cuda.synchronize()
        log(f"[time] K4 chaconne {rname} rings, fuse_res+skip_slab, "
            f"{lanes} lanes, resumed {n}-step chunk: {ms:.2f} ms, "
            f"{1e3 * ms / n:.2f} us/step, {lanes * n / ms * 1e3:.0f} "
            f"samples/s; bound {b_ms:.4f} ms ({b_by}; the ring's "
            f"{rdt.itemsize} bytes an element, the skip row's bf16 "
            f"operands at the bf16 rate), {100 * b_ms / ms:.2f} % of it; the plain version "
            f"{plain_ms:.1f} ms (the lockstep's {n} steps) [{card}]")
        log(f"[time] K4 {rname} rings, 256 lanes, per step: "
            + ", ".join(f"{ph} {v / (n * 1e3):.2f} us"
                        for ph, v in zip(ghbm.PHASES, tm.tolist()))
            + f" [{card}]")
        out[rname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, err=worst, mismatches=mm,
                          near_ties=nt, flips=off)
    # the vocoder with cond + gcond at bf16 rings
    vcfg, vparams = _vocoder(torch, pt, dev, GCOND)
    rdt, steps = torch.bfloat16, 256
    w = ghbm.prepare_weights(vparams, vcfg, True, True, rdt)
    vrows, vclock = ghbm.ring_rows(vcfg), max(ghbm.periods(vcfg))
    cond = _normal(torch, (64 + steps, vcfg.cond_channels, lanes), 12, dev)
    gcond = ghbm.project_gcond(
        w, vcfg, _normal(torch, (lanes, GCOND), 13, dev, 1.0), lanes)
    tag = f"K4 vocoder {lanes} lanes bf16 rings cond + gcond"
    ring = torch.zeros(vrows, lanes, dtype=rdt, device=dev)
    vprime = torch.randint(0, vcfg.classes, (lanes, 64), generator=g).to(
        dev, torch.int32)
    start, _, mmf = _lockstep(torch, ghbm, vcfg, w, vprime, ring,
                              vclock - 64, 64, (greedy, zeros, zeros),
                              tag + " teacher-forced",
                              dict(cond=cond[:64], gcond=gcond))
    state, first = ring.clone(), start[:, -1:].contiguous()
    kw = dict(cond=cond[64:].contiguous(), gcond=gcond)
    one_ring = state.clone()
    one = ghbm.batched_cuda(w, vcfg, first, one_ring, vclock, steps, *hot, 0,
                            0.0, True, True, True, **kw)
    cls, plain_ms, (mm, nt, off, worst) = _lockstep(
        torch, ghbm, vcfg, w, first, state, vclock, steps, hot, tag,
        dict(cond=cond[64:], gcond=gcond))
    check(torch.equal(cls, one) and torch.equal(state, one_ring),
          f"{tag}: one-step launches differ from one launch")
    log(f"[{tag}] teacher-forced 64 steps: {mmf[0]} class mismatches, "
        f"{mmf[2]} ring values one bf16 ulp off; a resumed {steps}-step "
        f"chunk at t0={vclock}, step by step: {mm} class mismatches, all at "
        f"near-ties ({nt} near-ties), {off} ring values one bf16 ulp off "
        f"(largest {worst:.3g}), none beyond; the one-step launches equal "
        f"the one launch bitwise")
    # times: phase 17's chunk, f32 and bf16 rings in alternation
    us = {"f32": [], "bf16": []}
    vn = VOCODER_CHUNK
    for rname in ("f32", "bf16", "bf16", "f32"):
        vw, vp, vr, vt, vs, vo, vc, vg = _vocoder_chunk(
            torch, ghbm, vcfg, vparams, dev, lanes, vn,
            None if rname == "f32" else torch.bfloat16)
        us[rname] += [1e3 * m / vn for m in _time(
            torch, lambda: ghbm.batched_cuda(
                vw, vcfg, vp, vr, vclock, vn, vt, vs, vo, 0, 0.0, True,
                True, True, cond=vc, gcond=vg), 2)]
    log(f"[time] K4 vocoder fuse_res+skip_slab, 256 lanes, phase 17's "
        f"resumed {vn}-step chunk with cond + gcond, f32 and bf16 rings in "
        f"alternation (f32, bf16, bf16, f32; 2 calls each): f32 rings "
        + ", ".join(f"{u:.2f}" for u in us["f32"]) + " us/step, bf16 rings "
        + ", ".join(f"{u:.2f}" for u in us["bf16"]) + f" [{card}]")
    vw, vp, vr, vt, vs, vo, vc, vg = _vocoder_chunk(
        torch, ghbm, vcfg, vparams, dev, lanes, vn, torch.bfloat16)
    tm = torch.zeros(len(ghbm.PHASES), dtype=torch.int64, device=dev)
    ghbm.batched_cuda(vw, vcfg, vp, vr, vclock, vn, vt, vs, vo, 0, 0.0,
                      True, True, True, timers=tm, cond=vc, gcond=vg)
    torch.cuda.synchronize()
    log("[time] K4 vocoder 256 lanes cond + gcond, bf16 rings, per step: "
        + ", ".join(f"{n} {v / (vn * 1e3):.2f} us"
                    for n, v in zip(ghbm.PHASES, tm.tolist()))
        + f" [{card}]")
    out["bf16"]["vocoder_us_per_step"] = min(us["bf16"])
    out["bf16"]["vocoder_f32_us_per_step"] = min(us["f32"])
    return out, scales


def phase_int8_generation(torch, pt, ghbm, dev, scales):
    """The int8 rings' main path: ``generate_fast_batched(ring_dtype=int8,
    ring_scales=calibrate_ring_scales(...))`` in two chunks at 256 lanes
    of chaconne (fuse_res + skip_slab), K4's launches counted around
    exactly these calls and the plain version barred; the two chunks equal
    one call bitwise, the state stays int8, and the waveform is finite.
    Returns the launches."""
    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    lanes = 256
    prime = torch.randint(0, cfg.classes, (lanes, 600),
                          generator=torch.Generator().manual_seed(22))
    kw = dict(temperature=0.9, lane_seed=list(range(lanes)), fuse_res=True,
              skip_slab=True, device=dev, ring_dtype=torch.int8,
              ring_scales=scales, return_state=True)
    real, calls = ghbm.batched_plain, []

    def barred(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("the plain version ran on the card path")

    ghbm.batched_plain = barred
    try:
        ghbm.launches = 0
        _, c1, st = pt.generate_fast_batched(params, cfg, 0, 1024, prime,
                                             **kw)
        wav, c2, st = pt.generate_fast_batched(params, cfg, 0, 1024,
                                               state=st, **kw)
        torch.cuda.synchronize()
        launched = ghbm.launches
        _, one, s1 = pt.generate_fast_batched(params, cfg, 0, 2048, prime,
                                              **kw)
    finally:
        ghbm.batched_plain = real
    check(not calls and launched == 2,
          f"int8 generation: {launched} K4 launches, {len(calls)} plain")
    check(st.ring.dtype == torch.int8 and torch.equal(st.ring, s1.ring)
          and torch.equal(torch.cat([c1, c2], dim=1), one),
          "int8 generation: two chunks differ from one call")
    check(bool(torch.isfinite(wav).all()), "int8 generation: non-finite")
    log(f"[int8 generation] generate_fast_batched(ring_dtype=int8, "
        f"ring_scales=calibrate_ring_scales(...)), 256 lanes, two 1024-sample "
        f"chunks after a 600-sample prime: K4 launches {launched}, plain "
        f"calls 0; equal to one 2048-sample call bitwise; the state's ring "
        f"is {st.ring.dtype}")
    return launched


# ------------------------------------------- phases 25-26: the remainder

REMAINDER_FLAGS = ("--lr-schedule", "cosine", "--warmup-steps", "4",
                   "--decay-steps", "20", "--min-lr-ratio", "0.1",
                   "--accum-steps", "2", "--ema-decay", "0.999")
HOOK_TEMPS = (0.5, 1.0)  # the audio hook's lanes


def _state_leaves(tr):
    """Params and the optimizer state in optax's layout, as numpy leaves
    in sorted order: what a bitwise resume compares."""
    from pytorch_wavenet_tpu_torch.models.convert import to_numpy_params
    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

    return list(_leaves({"params": to_numpy_params(tr.params),
                         "opt": tr.tx.state_dict(tr.opt_state)}))


def _native_times(np, pt, native, ds, batch=16, reps=50):
    """Host times of the data layer on this machine's CPU: a batch's window
    gather and the mu-law quantizer over the example audio, native against
    numpy (min of ``reps`` and of 5)."""
    from pytorch_wavenet_tpu_torch.ops.mulaw import quantize_data

    rng = np.random.default_rng(0)
    starts = np.asarray([ds.sample_index(int(i)) for i in
                         rng.integers(0, len(ds), batch)], np.int64)
    stream, il, tl = ds.flat_stream, ds._item_length, ds.target_length

    def best(fn, n):
        out = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            out.append(1e3 * (time.perf_counter() - t))
        return min(out)

    a = native.gather_windows(stream, starts, il, tl)
    b = native.gather_windows_numpy(stream, starts, il, tl)
    check(all(np.array_equal(x, y) for x, y in zip(a, b)),
          "native and numpy window gathers differ")
    here = os.path.dirname(os.path.abspath(__file__))
    wav = np.concatenate([pt.load_audio(os.path.join(here, "examples", f))[0]
                          for f in sorted(os.listdir(os.path.join(
                              here, "examples"))) if f.endswith(".wav")])
    q_n = native.mu_law_quantize(wav, 256)
    q_p = quantize_data(wav, 256).astype(np.uint8)
    off = int((q_n != q_p).sum())
    check(int(np.abs(q_n.astype(int) - q_p).max()) <= 1 and off <= 5e-3 *
          wav.size, f"native quantizer off numpy by more than one class or "
          f"at {off} samples")
    return dict(
        gather_native_ms=best(lambda: native.gather_windows(
            stream, starts, il, tl), reps),
        gather_numpy_ms=best(lambda: native.gather_windows_numpy(
            stream, starts, il, tl), reps),
        quantize_native_ms=best(lambda: native.mu_law_quantize(wav, 256), 5),
        quantize_numpy_ms=best(lambda: quantize_data(wav, 256), 5),
        samples=int(wav.size), window=il + 1, quantize_off=off)


def phase_training_remainder(torch, np, pt, tk, ghbm, dev, keep_dir,
                             steps=20, gen_len=16000):
    """Phase 25, the main path of the training remainder: chaconne_wide at
    batch 16 through ``training.train.main`` for ``steps`` micro-steps with
    a cosine schedule after a warmup, ``--accum-steps 2``, an EMA, a
    TensorBoard log and the audio hook at the last step (16000 samples at
    temperatures 0.5 and 1.0 in one K4 rollout); snapshots every 5
    micro-steps, so the step-5 and step-15 snapshots fall in the middle of
    an accumulation. K2/K3 launches and the hook's K4 launches are counted
    around exactly this run, the plain trunk and K4's plain version barred
    (the hook's thread is joined before they are restored). The loss on
    the first batch falls; a run resumed from the async step-5 snapshot
    (mini_step 1, a half-filled acc_grads) ends bitwise at the
    uninterrupted run's params, EMA and optimizer state; the event file
    parses back with every CRC checked; 5 steps of ``--optimizer
    sgd_normalized --momentum 0.9`` give a finite loss. The step-20
    snapshot is copied to ``keep_dir`` for phase 26."""
    import glob
    import shutil

    from pytorch_wavenet_tpu_torch.data import native
    from pytorch_wavenet_tpu_torch.training import train
    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves
    from pytorch_wavenet_tpu_torch.utils import tensorboard as tb
    from pytorch_wavenet_tpu_torch.utils.checkpoints import checkpoint_path

    check(native.available(), "the native audio codec did not build (g++)")
    here = os.path.dirname(os.path.abspath(__file__))
    wavs = sorted(glob.glob(os.path.join(here, "examples", "*.wav")))
    real = (tk.trunk_fwd_plain, tk.trunk_bwd_plain, ghbm.batched_plain)
    plain_calls = []

    def barred(*args, **kwargs):
        plain_calls.append(1)
        raise RuntimeError("a plain version ran on the card path")

    name = "chaconne_wide_model"
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "audio")
        os.makedirs(data)
        for w in wavs:
            shutil.copy(w, data)
        common = ["--data-dir", data, "--config", "chaconne_wide",
                  "--batch-size", "16", "--epochs", "10", "--seed", str(SEED),
                  "--lr", "1e-3", "--validation-interval", "1000",
                  "--device", str(dev)]
        base = common + list(REMAINDER_FLAGS) + ["--log-interval", "10"]
        logs = os.path.join(d, "logs")
        tk.trunk_fwd_plain = tk.trunk_bwd_plain = barred
        ghbm.batched_plain = barred
        try:
            tk.fwd_launches = tk.bwd_launches = ghbm.launches = 0
            t = time.time()
            a = train.main(base + [
                "--max-steps", str(steps), "--snapshot-path",
                os.path.join(d, "a"), "--snapshot-interval", "5",
                "--log-dir", logs, "--generate-interval", str(steps),
                "--generate-length", str(gen_len)])
            train_wall = time.time() - t
            hook = a.logger.generate_thread
            check(hook is not None, "the audio hook did not start")
            hook.join(600)
            check(not hook.is_alive(), "the audio hook did not finish")
            torch.cuda.synchronize()
            wall = time.time() - t
            launched = (tk.fwd_launches, tk.bwd_launches, ghbm.launches)
            a.logger.flush()
            snap5 = checkpoint_path(os.path.join(d, "a"), name, 5)
            os.makedirs(os.path.join(d, "b"))
            shutil.copy(snap5, os.path.join(d, "b"))
            tk.fwd_launches = tk.bwd_launches = 0
            b = train.main(base + [
                "--max-steps", str(steps), "--snapshot-path",
                os.path.join(d, "b"), "--snapshot-interval", "1000",
                "--resume", "--generate-interval", "1000"])
            torch.cuda.synchronize()
            resumed = (tk.fwd_launches, tk.bwd_launches)
            sgd = train.main(common + [
                "--optimizer", "sgd_normalized", "--momentum", "0.9",
                "--max-steps", "5", "--snapshot-path", os.path.join(d, "s"),
                "--snapshot-interval", "1000", "--generate-interval", "1000",
                "--log-interval", "5"])
        finally:
            tk.trunk_fwd_plain, tk.trunk_bwd_plain, ghbm.batched_plain = real
        snap20 = checkpoint_path(os.path.join(d, "a"), name, steps)
        kept = shutil.copy(snap20, keep_dir)
        blob5 = pt.load_checkpoint(snap5, device="cpu")
        events = tb.read_events(a.logger.writer.path)
        batch = [torch.from_numpy(v).to(dev)
                 for v in a.dataset.get_batch(np.arange(16))]
        init = pt.init_wavenet(a.cfg, torch.Generator().manual_seed(SEED),
                               dev)
        with torch.no_grad():
            l0 = float(pt.cross_entropy_loss(init, a.cfg, *batch))
            l1 = float(pt.cross_entropy_loss(a.params, a.cfg, *batch))
            ls = float(pt.cross_entropy_loss(sgd.params, sgd.cfg, *batch))
        nt = _native_times(np, pt, native, a.dataset)

    check(not plain_calls, f"a plain version ran {len(plain_calls)} times")
    check(launched == (steps, steps, 1), f"K2/K3/K4 launches {launched}, "
          f"expected {steps}, {steps} (one per micro-step) and 1 (the hook)")
    check(resumed == (steps - 5,) * 2, f"resumed run: K2/K3 launches "
          f"{resumed}, expected {steps - 5} each")
    check(a.step == b.step == steps and sgd.step == 5,
          f"steps {a.step}, {b.step}, {sgd.step}")
    check(math.isfinite(l0) and math.isfinite(l1) and l1 < l0,
          f"loss did not fall: {l0} -> {l1}")
    check(math.isfinite(ls), f"sgd_normalized: loss {ls}")
    opt5 = blob5["opt_state"]
    check(int(opt5["mini_step"]) == 1 and int(opt5["gradient_step"]) == 2,
          "the step-5 snapshot is not in the middle of an accumulation")
    check(any(float(np.abs(g).max()) > 0 for _, g in
              _leaves(opt5["acc_grads"])),
          "the step-5 snapshot's acc_grads are empty")
    sa, sb = _state_leaves(a), _state_leaves(b)
    check([p for p, _ in sa] == [p for p, _ in sb], "state layouts differ")
    off = [p for (p, x), (_, y) in zip(sa, sb) if not np.array_equal(x, y)]
    check(not off, f"the resumed run differs from the uninterrupted one at "
          f"{off[:4]}")
    # the event file: loss scalars, every param's and gradient's
    # histogram at the log cadence, two clips of 16000 samples
    vals = [(e["step"], tag, kind, v) for e in events
            for tag, kind, v in e["values"]]
    names = [n for n, _ in a.named_parameters()]
    losses = [s for s, tag, k, _ in vals if tag == "loss" and k == "scalar"]
    hists = {tag for _, tag, k, _ in vals if k == "histogram"}
    clips = {tag: tb.parse_fields(v)[3][0] for _, tag, k, v in vals
             if k == "audio"}
    check(events[0]["file_version"] == "brain.Event:2", "no file version")
    check(losses == [10, 20], f"loss scalars at steps {losses}")
    check(hists == set(names) | {n + "/grad" for n in names},
          f"histograms {sorted(hists)[:6]}... of {len(hists)}, expected "
          f"{2 * len(names)}")
    check(clips == {f"temperature_{t}/0": gen_len for t in HOOK_TEMPS},
          f"audio clips {clips}")
    log(f"[train+] chaconne_wide batch 16, {' '.join(REMAINDER_FLAGS)}: "
        f"{steps} micro-steps in {train_wall:.1f} s ({wall:.1f} s with the "
        f"hook; dataset and 4 async snapshots included); K2/K3 launches "
        f"{launched[0]}/{launched[1]}, the hook's K4 launches {launched[2]} "
        f"(one rollout, {len(HOOK_TEMPS)} lanes x {gen_len} steps), plain calls "
        f"{len(plain_calls)}; loss on the first batch {l0:.4f} at init -> "
        f"{l1:.4f} at step {steps}; sgd_normalized momentum 0.9, 5 steps: "
        f"{ls:.4f}")
    log(f"[train+] resumed from the async step-5 snapshot (mini_step 1, "
        f"gradient_step 2, acc_grads half filled) to step {steps} (K2/K3 "
        f"launches {resumed[0]}/{resumed[1]}): params, EMA and optimizer "
        f"state ({len(sa)} leaves) bitwise equal to the uninterrupted run's")
    log(f"[train+] event file {os.path.basename(a.logger.writer.path)}: "
        f"{len(events)} records, every CRC checked; loss at steps {losses}, "
        f"{len(hists)} histograms ({len(names)} params and their "
        f"gradients), clips {sorted(clips)} of {gen_len} samples")
    log(f"[data] host times on this machine's CPU: batch-16 window gather "
        f"({nt['window']} bytes a window) native {nt['gather_native_ms']:.3f} "
        f"ms, numpy {nt['gather_numpy_ms']:.3f} ms; mu-law quantizer over "
        f"{nt['samples']} samples native {nt['quantize_native_ms']:.2f} ms, "
        f"numpy {nt['quantize_numpy_ms']:.2f} ms ({nt['quantize_off']} "
        f"samples one class apart); min of 50 and of 5")
    return dict(launches=launched, snapshot=kept, native=nt, wall_s=wall)


def phase_hook_k4(torch, pt, ghbm, dev, card, steps=1024, full=16000):
    """K4 at the audio hook's shape (chaconne_wide, one lane per hook
    temperature, exact products, the noise keyed by one seed) against its
    plain version: ``steps`` steps from a fresh ring, classes up to a
    near-tie and the ring; times of both on that call with CUDA events,
    the bound, and the kernel on the hook's whole ``full``-step call."""
    cfg = pt.get_config("chaconne_wide")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    w = ghbm.prepare_weights(params, cfg, False, False)
    lanes = len(HOOK_TEMPS)
    prime = torch.full((lanes, 1), cfg.classes // 2, dtype=torch.int32,
                       device=dev)
    temps = torch.tensor(HOOK_TEMPS, dtype=torch.float32, device=dev)
    z = torch.zeros(lanes, dtype=torch.int32, device=dev)
    rows = ghbm.ring_rows(cfg)

    def args(ring, total):
        return (w, cfg, prime, ring, 0, total, temps, z, z, 7, 0.0, False,
                False, False)

    rk = torch.zeros(rows, lanes, device=dev)
    rp = torch.zeros(rows, lanes, device=dev)
    ck = ghbm.batched_cuda(*args(rk, steps))
    cp, gaps = ghbm.batched_plain(*args(rp, steps), return_gaps=True)
    torch.cuda.synchronize()
    parted, err = _rollout_check(torch, ck, cp, gaps, rk, rp, "hook K4",
                                 f"{lanes} lanes at T={HOOK_TEMPS}")
    ring = torch.zeros(rows, lanes, device=dev)
    ms = min(_time(torch, lambda: ghbm.batched_cuda(*args(ring, steps)), 5))
    plain = min(_time(torch, lambda: ghbm.batched_plain(*args(ring, steps)),
                      1))
    full_ms = min(_time(torch, lambda: ghbm.batched_cuda(*args(ring, full)),
                        1, warm=False))
    b_ms, b_by = bound_ms(pt, ghbm, params, cfg, lanes, 1, steps)
    log(f"[time] K4 at the hook's shape (chaconne_wide, {lanes} lanes, "
        f"exact, {steps} steps): {ms:.3f} ms (min of 5), "
        f"{1e3 * ms / steps:.2f} us a step; plain {plain:.1f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.2f} % of it; the hook's "
        f"{full}-step call {full_ms:.1f} ms [{card}]")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                err=err, parted=parted, full_ms=full_ms)


def phase_serve_ema(torch, np, pt, gk, ghbm, dev, snap, n=16000):
    """Phase 26: phase 25's step-20 snapshot served with ``serving.server.
    main --ema``: one single-stream request (K1) and then, with
    ``--batcher``, one pooled request (K4), each byte-equal to a solo
    rollout of the EMA params that ``find_ema_state_dict`` takes from the
    same file (which must differ from the live params). Launches are
    counted around each request, the plain versions barred."""
    from pytorch_wavenet_tpu_torch.ops.mulaw import dequantize_to_f32
    from pytorch_wavenet_tpu_torch.serving import server as srv
    from pytorch_wavenet_tpu_torch.training.optimizers import (
        _leaves, find_ema_state_dict)

    blob = pt.load_checkpoint(snap, device=dev)
    cfg = blob["config"]
    ema = pt.from_jax_params(find_ema_state_dict(blob["opt_state"]), dev)
    check(any(not torch.equal(a, b) for (_, a), (_, b) in
              zip(_leaves(ema), _leaves(blob["params"]))),
          "the EMA equals the live params")
    real = (gk.fused_plain, ghbm.batched_plain)
    plain_calls = []

    def barred(*args, **kwargs):
        plain_calls.append(1)
        raise RuntimeError("a plain version ran on the card path")

    def serve(extra, seed, temp):
        box, ready = {}, threading.Event()

        def on_ready(server):
            box["server"] = server
            ready.set()

        th = threading.Thread(target=srv.main, kwargs=dict(
            argv=["--snapshot", snap, "--port", "0", "--ema", *extra],
            on_ready=on_ready), daemon=True)
        th.start()
        t0 = time.time()
        while not ready.wait(1):
            check(th.is_alive() and time.time() - t0 < 600,
                  "the --ema server did not come up")
        server = box["server"]
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            gk.launches = ghbm.launches = 0
            url = (f"{base}/synthesize?num_samples={n}&temperature={temp}"
                   f"&seed={seed}")
            t = time.time()
            with urllib.request.urlopen(url, timeout=600) as r:
                body = r.read()
            dt = time.time() - t
            counts = (gk.launches, ghbm.launches)
        finally:
            server.shutdown()
            th.join(120)
        check(not th.is_alive(), "the --ema server thread did not stop")
        return np.frombuffer(_read_wav(body, n), "<i2"), counts, dt

    gk.fused_plain = ghbm.batched_plain = barred
    try:
        single, c1, dt1 = serve([], 21, 1.0)
        pooled, c4, dt4 = serve(["--batcher", "--lanes", "256",
                                 "--batch-chunk", "2048"], 22, 0.9)
    finally:
        gk.fused_plain, ghbm.batched_plain = real
    check(not plain_calls, f"a plain version ran {len(plain_calls)} times")
    chunks = math.ceil(n / 2048)
    check(c1 == (chunks, 0), f"single stream: K1/K4 launches {c1}, expected "
          f"{chunks} K1 (one per 2048-sample chunk)")
    check(c4[0] == 0 and c4[1] >= chunks, f"--batcher: K1/K4 launches {c4}")
    kseed = srv.Synthesizer.kernel_seed(21)

    def pcm(wav):
        w = np.asarray(wav)
        check(np.isfinite(w).all(), "non-finite waveform")
        return np.clip(w * 32767.0, -32768, 32767).astype("<i2")

    wav, _ = pt.generate_fast_fused(ema, cfg, kseed, n, None, temperature=1.0,
                                    fuse_res=True, device=dev)
    check(np.array_equal(single, pcm(wav[0].cpu().numpy())),
          "--ema single stream differs from a solo K1 rollout of the EMA")
    wav_live, _ = pt.generate_fast_fused(blob["params"], cfg, kseed, n, None,
                                         temperature=1.0, fuse_res=True,
                                         device=dev)
    check(not np.array_equal(single, pcm(wav_live[0].cpu().numpy())),
          "--ema served the live params")
    cls = _solo_cls(pt, ema, cfg, [[cfg.classes // 2]], n, 0.9, [22],
                    dev)[0]
    check(np.array_equal(pooled, pcm(dequantize_to_f32(cls, cfg.classes))),
          "--ema --batcher differs from a solo K4 rollout of the EMA")
    log(f"[serve --ema] phase 25's step-20 snapshot, EMA weights from "
        f"find_ema_state_dict: one {n}-sample request single-stream (K1 "
        f"launches {c1[0]}, K4 {c1[1]}; {dt1:.2f} s) and one through "
        f"--batcher --lanes 256 --batch-chunk 2048 (K1 {c4[0]}, K4 {c4[1]}; "
        f"{dt4:.2f} s), each byte-equal to its solo rollout of the EMA "
        f"params and not to the live params'; plain calls 0")
    return c1[0], c4[1]


def phase_remainder_times(torch, pt, dev, card, reps=10):
    """Times at chaconne_wide, batch 16, with CUDA events: the train step
    under plain Adam, Adam with an EMA, ``sgd_normalized``, and phase 25's
    stack per micro-step (``--accum-steps 2``: a mean over an even number
    of steps, half of them accumulating only), each with its optimizer
    part alone; then the training thread's stall in an async snapshot of
    phase 25's state against a synchronous ``save_checkpoint`` (host
    clock), and the worker's time to the file."""
    from pytorch_wavenet_tpu_torch.training import optimizers as topt
    from pytorch_wavenet_tpu_torch.utils.checkpoints import (
        AsyncCheckpointer, save_checkpoint)

    cfg = pt.get_config("chaconne_wide", trunk_kernel=True)
    B = 16
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, cfg.classes, (B, cfg.item_length), generator=g)
    y = torch.randint(0, cfg.classes, (B, cfg.output_length), generator=g)
    x, y = x.to(dev, torch.int32), y.to(dev, torch.int32)
    stacks = {
        "adam": lambda: topt.reference_adam(1e-4),
        "adam + EMA": lambda: topt.with_ema(topt.reference_adam(1e-4), 0.999),
        "sgd_normalized momentum 0.9": lambda: topt.sgd_normalized(
            1e-4, momentum=0.9),
        "accum 2 (EMA, cosine Adam), per micro-step": lambda: topt.
        build_optimizer("adam", 1e-3, schedule="cosine", warmup_steps=4,
                        decay_steps=20, min_lr_ratio=0.1, ema_decay=0.999,
                        accum_steps=2),
    }
    out = {}
    for name, make in stacks.items():
        params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED),
                                 dev)
        for _, p in topt._leaves(params):
            p.requires_grad_(True)
        tx = make()
        state = tx.init(params)
        step = _time(torch, lambda: pt.train_step(params, state, cfg, tx, x,
                                                  y), reps)
        gtree = pt.train_step(params, state, cfg, tx, x, y)[1]
        opt = _time(torch, lambda: tx.step(params, gtree, state), reps)
        out[name] = dict(step_ms=sum(step) / reps, opt_ms=sum(opt) / reps,
                         step_median_ms=sorted(step)[reps // 2])
        log(f"[time] chaconne_wide batch 16 train step, {name}: mean "
            f"{out[name]['step_ms']:.3f} ms of {reps} (median "
            f"{out[name]['step_median_ms']:.3f}); its optimizer part alone "
            f"mean {out[name]['opt_ms']:.3f} ms [{card}]")
    # the snapshot stall: phase 25's stack after a few steps
    stall, sync, worker = [], [], []
    with tempfile.TemporaryDirectory() as d:
        ck = AsyncCheckpointer()
        for i in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ck.save(d, "a", i, params, opt_state=state, cfg=cfg,
                    state_dict=tx.state_dict)
            stall.append(1e3 * (time.perf_counter() - t))
            ck.wait()
            worker.append(1e3 * (time.perf_counter() - t))
            torch.cuda.synchronize()
            t = time.perf_counter()
            save_checkpoint(d, "s", i, params, cfg=cfg,
                            opt_state=tx.state_dict(state))
            sync.append(1e3 * (time.perf_counter() - t))
        ck.close()
        nbytes = os.path.getsize(os.path.join(d, sorted(os.listdir(d))[0]))
    out["snapshot"] = dict(async_stall_ms=min(stall), sync_ms=min(sync),
                           async_total_ms=min(worker), bytes=nbytes)
    log(f"[time] snapshot of chaconne_wide with phase 25's optimizer state "
        f"({nbytes} bytes): the training thread stalls {min(stall):.2f} ms "
        f"in an async snapshot (device clones + event; min of 3: "
        + ", ".join(f"{v:.2f}" for v in stall) + f"), the file lands "
        f"{min(worker):.1f} ms after the call; a synchronous save_checkpoint "
        f"takes {min(sync):.1f} ms (" + ", ".join(f"{v:.1f}" for v in sync)
        + f"), host clock [{card}]")
    return out


# ------------------------------------------ speculation and distillation

SPEC_N = 128            # phase 27's rollout length
SPEC_PRIME = 512        # its prime (random classes, window-primed)
DISTILL_LENGTH = 4000   # the distillation CLI's draw length and batch
DISTILL_BATCH = 4
STUDENT_BUCKET = 8192   # the server's student clip bucket


def _clone_state(pt, state):
    return pt.GenState(tuple(b.clone() for b in state.buffers), state.t)


def _spec_gaps(torch, pt, params, cfg, prime, cls):
    """The teacher's top-2 logit gaps and argmax at every emitted position,
    teacher-forced on the emitted history (one plain trunk pass)."""
    full = torch.cat([prime, cls[:, :-1]], dim=1)
    with torch.no_grad():
        logits = pt.wavenet_logits(params, cfg, full, out_len=cls.shape[1])
    top = torch.topk(logits[0], 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu(), logits[0].argmax(-1).cpu()


def _held_off_near_ties(got, want, gaps, tag):
    """Classes equal up to the first difference, which must sit at a
    near-tie of the teacher (the rollouts part there); 1 if they parted."""
    off = (got[0].cpu() != want[0].cpu()).nonzero()
    if off.numel() == 0:
        return 0
    i = int(off[0])
    check(float(gaps[i]) < NEAR_TIE, f"{tag}: class {i} differs at a top-2 "
          f"gap of {float(gaps[i]):.3g} (not a near-tie)")
    return 1


def phase_window(torch, np, pt, dev, cfg, params):
    """Phase 27a: ``gen_step_window`` over windows of 1, 8 and 20 against
    as many chained ``gen_step`` calls on the card from a state with 300
    steps of history: logits within 1e-5 x max(1, |y|); the rings after
    ``commit_window`` hold each slot's last pending input bitwise (a
    dilation-1 ring takes ten of a window of 20), and the steps' rings
    within 1e-5 x max(1, |h|) (the window's ``(k, R)`` products round
    unlike a step's ``(1, R)`` ones; the elements that differ are
    counted); the draft's bookkeeping (each step's layer inputs recorded,
    then committed) equals the chained steps bitwise."""
    from pytorch_wavenet_tpu_torch.models.generate import PendingWindow

    rng = np.random.default_rng(SEED + 27)
    state = pt.init_gen_state(cfg, 1, dev)
    with torch.no_grad():
        for c in rng.integers(0, cfg.classes, 300):
            _, state = pt.gen_step(params, cfg, state,
                                   torch.tensor([int(c)], device=dev))
        out = {}
        for win in (1, 8, 20):
            window = torch.from_numpy(rng.integers(0, cfg.classes,
                                                   (1, win))).to(dev)
            logits, pend = pt.gen_step_window(params, cfg, state, window)
            seq, steps, recs = [], _clone_state(pt, state), []
            for i in range(win):
                rec = []
                lg, steps = pt.gen_step(params, cfg, steps, window[:, i],
                                        record=rec)
                seq.append(lg)
                recs.append(rec)
            seq = torch.stack(seq, dim=1)
            err = float(((logits - seq).abs() / seq.abs().clamp(min=1.0))
                        .max())
            check(err <= 1e-5, f"window {win}: logits {err:.3g} x max(1, |y|)")
            got = pt.commit_window(_clone_state(pt, state), pend, win)
            want = _clone_state(pt, state)
            for buf, h in zip(want.buffers, pend.h_wins):
                for i in range(win):  # ascending writes: the last one wins
                    buf[:, (state.t + i) % buf.shape[1]] = h[:, i]
            check(got.t == steps.t == state.t + win, "window cursor")
            check(all(torch.equal(a, b) for a, b in
                      zip(got.buffers, want.buffers)),
                  f"window {win}: commit_window is not the last write")
            ring_err, ring_off = 0.0, 0
            for a, b in zip(got.buffers, steps.buffers):
                d = (a - b).abs() / b.abs().clamp(min=1.0)
                ring_err = max(ring_err, float(d.max()))
                ring_off += int((a != b).sum())
            check(ring_err <= 1e-5, f"window {win}: rings {ring_err:.3g}")
            h = tuple(torch.stack([r[l] for r in recs], dim=1)
                      for l in range(cfg.num_layers))
            drafted = pt.commit_window(_clone_state(pt, state),
                                       PendingWindow(h, state.t), win)
            check(all(torch.equal(a, b) for a, b in
                      zip(drafted.buffers, steps.buffers)),
                  f"window {win}: recorded steps committed differ")
            out[win] = dict(logit_err=err, ring_err=ring_err,
                            ring_values_off=ring_off,
                            ring_values=sum(b.numel() for b in got.buffers))
            log(f"[window] chaconne, window {win} on the card against {win} "
                f"chained gen_step calls: logits within {err:.3g} x max(1, "
                f"|y|); commit_window leaves each slot's last pending input "
                f"(bitwise); rings within {ring_err:.3g} x max(1, |h|) of "
                f"the steps' ({ring_off} of {out[win]['ring_values']} "
                f"values differ: the window's products); recorded steps "
                f"committed equal the steps' rings bitwise")
    return out


def phase_speculation(torch, np, pt, gk, dev, card, n=SPEC_N):
    """Phase 27, speculation at full width: the chaconne teacher from seed
    1234 (``phase_window`` first), then ``speculative_generate`` for ``n``
    samples after a 512-class prime at k = 4 and 8 with two drafts (the
    teacher itself, whose accept rate must be exactly k, and chaconne with
    ``blocks=1``, rf 1024: the teacher's first block of layers under its
    embedding and head, a truncated teacher), held against the plain
    ``generate_fast(temperature=0)`` on the card and K1 at T = 0 (exact
    products): every class the teacher's argmax on the emitted history off
    near-ties, and the rollouts equal up to a first difference at a
    near-tie (the flips are counted). Times on the host clock after a
    synchronize: samples/s, accept rate, host syncs per sample; K1's
    samples/s on the same teacher beside them."""
    from pytorch_wavenet_tpu_torch.models import speculative as spec

    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    win = phase_window(torch, np, pt, dev, cfg, params)
    dcfg = pt.get_config("chaconne", blocks=1)
    draft = dict(params, layers={k: v[:dcfg.num_layers]
                                 for k, v in params["layers"].items()})
    prime = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.classes, (1, SPEC_PRIME))).to(dev)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (_, plain), plain_s = timed(lambda: pt.generate_fast(
        params, cfg, None, n, prime, temperature=0.0, device=dev))
    gk.launches = 0
    (_, k1), k1_s = timed(lambda: pt.generate_fast_fused(
        params, cfg, 0, n, prime.to(torch.int32), temperature=0.0,
        device=dev))
    check(gk.launches == 1, f"K1 launches {gk.launches}")
    (_, k1), k1_s = timed(lambda: pt.generate_fast_fused(
        params, cfg, 0, n, prime.to(torch.int32), temperature=0.0,
        device=dev))  # warm
    gaps, _ = _spec_gaps(torch, pt, params, cfg, prime, plain)
    flips = {"K1 vs plain": _held_off_near_ties(k1.long(), plain, gaps,
                                                "K1 vs plain")}
    runs = {}
    for dname, dp, dc in (("teacher", params, cfg),
                          ("one block", draft, dcfg)):
        for k in (4, 8):
            spec.host_syncs = 0
            (_, cls, rate), s = timed(lambda: pt.speculative_generate(
                params, cfg, dp, dc, None, n, prime, k=k, device=dev))
            syncs = spec.host_syncs
            check(cls.shape == (1, n), f"speculation shape {cls.shape}")
            tag = f"draft {dname}, k {k}"
            g, am = _spec_gaps(torch, pt, params, cfg, prime, cls)
            bad = ((cls[0].cpu() != am) & (g >= NEAR_TIE)).nonzero()
            check(bad.numel() == 0, f"{tag}: class {bad[:4].tolist()} is not "
                  "the teacher's argmax on its history")
            off_argmax = int((cls[0].cpu() != am).sum())
            f_plain = _held_off_near_ties(cls, plain, g, f"{tag} vs plain")
            f_k1 = _held_off_near_ties(cls, k1.long(), g, f"{tag} vs K1")
            if dname == "teacher":
                check(rate == k, f"{tag}: accept rate {rate}, expected {k}")
            runs[tag] = dict(s=s, samples_per_s=n / s, accept_rate=rate,
                             host_syncs=syncs, syncs_per_sample=syncs / n,
                             flips_vs_plain=f_plain, flips_vs_k1=f_k1,
                             off_argmax_at_near_ties=off_argmax)
            flips[tag] = f_plain + f_k1
            log(f"[speculation] chaconne teacher, {tag}: {n} samples in "
                f"{s:.2f} s ({n / s:,.1f} samples/s), accept rate "
                f"{rate:.3f}, {syncs} host syncs ({syncs / n:.4f} a sample); "
                f"classes against the plain rollout and K1 at T = 0: parted "
                f"at a near-tie {f_plain} and {f_k1} times, "
                f"{off_argmax} classes off the teacher-forced argmax, all at "
                f"near-ties [{card}]")
    log(f"[speculation] baselines on the same teacher and prime: plain "
        f"generate_fast(T=0) {n / plain_s:,.1f} samples/s ({plain_s:.2f} s); "
        f"K1 at T = 0 (exact) {n / k1_s:,.1f} samples/s ({1e3 * k1_s:.1f} "
        f"ms); K1 against the plain rollout: parted at a near-tie "
        f"{flips['K1 vs plain']} times [{card}]")
    return dict(window=win, runs=runs, plain_samples_per_s=n / plain_s,
                k1_samples_per_s=n / k1_s, flips=flips)


def _k2_at(torch, pt, tk, dev, name, cond, card, reps=5):
    """K2 at the distillation shape (N 4, out 931) against its plain
    version: units within U_TOL x max(1, |u|); times (CUDA events, min of
    ``reps`` warm calls; the plain version once) and the bound."""
    cfg = pt.get_config(name)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    out_len = DISTILL_LENGTH - cfg.receptive_field + 1
    T = cfg.receptive_field + out_len - 1
    g = torch.Generator().manual_seed(28)
    h0 = (torch.rand((DISTILL_BATCH, T, cfg.residual_channels), generator=g)
          * 2 - 1).to(dev)
    c = ((torch.rand((DISTILL_BATCH, T, cfg.cond_channels), generator=g) * 2
          - 1).to(dev) if cond else None)
    uk, _ = tk.trunk_fwd_cuda(params, cfg, h0, out_len, cond=c)
    torch.cuda.synchronize()
    up, _ = tk.trunk_fwd_plain(params, cfg, h0, out_len, cond=c)
    eu = float(((uk - up).abs() / up.abs().clamp(min=1.0)).max())
    err = float((uk - up).abs().max())
    tag = f"K2 {name}{' with cond' if cond else ''}, N {DISTILL_BATCH}, out {out_len}"
    check(eu <= U_TOL, f"{tag}: u error {eu}")
    ms = min(_time(torch, lambda: tk.trunk_fwd_cuda(params, cfg, h0, out_len,
                                                    cond=c), reps))
    plain = min(_time(torch, lambda: tk.trunk_fwd_plain(params, cfg, h0,
                                                        out_len, cond=c), 1))
    b_ms, b_by = trunk_bounds(cfg, DISTILL_BATCH, out_len,
                              cond_channels=cfg.cond_channels if cond else 0
                              )["K2"]
    log(f"[distill] {tag}: u within {eu:.3g} x max(1, |u|) (max |diff| "
        f"{err:.3g}); {ms:.3f} ms (min of {reps}), plain {plain:.3f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.2f} % of it "
        f"[{card}]")
    return dict(err=err, rel_err=eu, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, out_len=out_len)


def _example_audio(d):
    import glob
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    wavs = sorted(glob.glob(os.path.join(here, "examples", "*.wav")))
    check(len(wavs) >= 4, f"example audio missing: {wavs}")
    os.makedirs(d)
    for w in wavs:
        shutil.copy(w, d)
    return d


def _distill_split(torch, pt, tk, dev, card, teacher, tcfg, reps=5):
    """One distillation step of the default student (4 flows x 10 layers,
    width 64) on ``teacher`` at batch 4, length 4000, the CLI's loss (rms
    against a reference batch, teacher smoothing), split on the host clock
    after a synchronize into the student's draw, the teacher (K2 under
    no_grad), the loss with its backward, and the optimizer; median of
    ``reps`` after a warm step; K2's launches per step."""
    from pytorch_wavenet_tpu_torch.models import iaf
    from pytorch_wavenet_tpu_torch.training import distill
    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves, _map

    scfg = pt.IAFConfig(cond_channels=tcfg.cond_channels)
    sp = pt.init_student(scfg, torch.Generator().manual_seed(SEED), 0.1, dev)
    view = iaf.student_state_dict(sp)
    leaves = [p.requires_grad_(True) for _, p in _leaves(view)]
    tx = pt.reference_adam(3e-4, gradient_clipping=1.0)
    opt = tx.init(view)
    B, T = DISTILL_BATCH, DISTILL_LENGTH
    g = torch.Generator().manual_seed(29)
    ref = (0.2 * torch.randn((B, T - 1), generator=g)).to(dev)
    cond = ((torch.rand((B, T, tcfg.cond_channels), generator=g) - 0.5)
            .to(dev) if tcfg.cond_channels else None)
    parts = {"draw": [], "teacher": [], "loss+backward": [], "optimizer": []}
    step = []
    for r in range(reps + 1):
        u = iaf.base_uniforms(torch.Generator().manual_seed(100 + r), (B, T))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tk.fwd_launches = 0
        draw = iaf.student_sample(sp, scfg, None, (B, T), cond=cond, u=u)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logp = distill.teacher_logprobs(teacher, tcfg,
                                        torch.clamp(draw.x, -1.0, 1.0), cond,
                                        teacher_smooth=1e-3)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        launches = tk.fwd_launches
        rf = tcfg.receptive_field
        q = distill.student_bin_logprobs(draw.m[:, rf:], draw.log_s[:, rf:],
                                         tcfg.classes)
        kl = torch.mean(torch.sum(q * (torch.log(torch.clamp(q, min=1e-12))
                                       - logp), dim=-1))
        rms = torch.sqrt(torch.mean(draw.x * draw.x))
        loss = kl + (torch.log(rms + 1e-6) - torch.log(
            torch.sqrt(torch.mean(ref ** 2)) + 1e-6)) ** 2
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        it = iter(grads)
        tx.step(view, _map(lambda _: next(it), view), opt)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        if r:
            for name, a, b in (("draw", t0, t1), ("teacher", t1, t2),
                               ("loss+backward", t2, t3),
                               ("optimizer", t3, t4)):
                parts[name].append(1e3 * (b - a))
            step.append(1e3 * (t4 - t0))
    check(launches == 1, f"K2 launches a step {launches}, expected 1")
    med = {k: sorted(v)[reps // 2] for k, v in parts.items()}
    out = dict(step_ms=sorted(step)[reps // 2], split_ms=med,
               k2_launches_per_step=launches,
               student_params=iaf.student_parameter_count(sp))
    log(f"[distill] step of the default student ({out['student_params']:,} "
        f"params) on the {'vocoder' if tcfg.cond_channels else 'chaconne_wide'}"
        f" teacher (K2), batch {B}, length {T}: {out['step_ms']:.2f} ms "
        f"(median of {reps}; host clock after synchronize): "
        + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
        + f"; K2 launches a step {launches} [{card}]")
    return out


def phase_distillation(torch, np, pt, tk, dev, card, keep, teacher_snap):
    """Phase 28, distillation (the main path of this slice): K2 against
    its plain version at N 4, out 931 (chaconne, and the vocoder with
    cond); the distillation loss with the teacher through K2 against the
    plain trunk on the card (within 1e-5 relative); ``distill_cli.main``
    for 10 steps on phase 25's chaconne_wide step-20 snapshot with
    ``--data-dir`` (the example audio), the default student, batch 4,
    length 4000, snapshots every 5, K2/K3 launches counted around exactly
    this run with the plain trunk barred (10 and 0); a run resumed from the
    step-5 snapshot ends at the step-10 params bitwise; 3 steps of vocoder
    distillation on a ``vocoder`` teacher from seed 1234 written with
    ``save_checkpoint`` (cond through K2's COND instantiation, 3
    launches); then each step's split. The students are kept in ``keep``
    for phase 29."""
    import dataclasses
    import shutil

    from pytorch_wavenet_tpu_torch.models import iaf
    from pytorch_wavenet_tpu_torch.training import distill, distill_cli
    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

    k2 = {"chaconne": _k2_at(torch, pt, tk, dev, "chaconne", False, card),
          "vocoder": _k2_at(torch, pt, tk, dev, "vocoder", True, card)}
    blob = pt.load_checkpoint(teacher_snap, device=dev)
    tcfg = dataclasses.replace(blob["config"], trunk_kernel=True)
    teacher = blob["params"]
    scfg = pt.IAFConfig()
    sp = pt.init_student(scfg, torch.Generator().manual_seed(SEED), 0.1, dev)
    u = iaf.base_uniforms(torch.Generator().manual_seed(30),
                          (DISTILL_BATCH, DISTILL_LENGTH))
    with torch.no_grad():
        lk, ak = distill.distill_loss(sp, teacher, scfg, tcfg, u,
                                      DISTILL_BATCH, DISTILL_LENGTH,
                                      teacher_smooth=1e-3)
        lp, ap = distill.distill_loss(
            sp, teacher, scfg, dataclasses.replace(tcfg, trunk_kernel=False),
            u, DISTILL_BATCH, DISTILL_LENGTH, teacher_smooth=1e-3)
    loss_err = abs(float(lk) - float(lp)) / max(1.0, abs(float(lp)))
    check(loss_err <= 1e-5, f"distillation loss through K2 {float(lk)} "
          f"against the plain trunk {float(lp)}")
    log(f"[distill] loss of a fresh default student on phase 25's "
        f"chaconne_wide step-20 teacher, batch {DISTILL_BATCH}, length "
        f"{DISTILL_LENGTH}: teacher through K2 {float(lk):.6f} (KL "
        f"{float(ak['kl']):.6f}), plain trunk {float(lp):.6f}: within "
        f"{loss_err:.3g} relative")

    real = tk.trunk_fwd_plain, tk.trunk_bwd_plain
    plain_calls = []

    def barred(*args, **kwargs):
        plain_calls.append(1)
        raise RuntimeError("a plain version ran on the card path")

    with tempfile.TemporaryDirectory() as d:
        audio = _example_audio(os.path.join(d, "audio"))
        common = ["--data-dir", audio, "--seed", str(SEED), "--batch-size",
                  str(DISTILL_BATCH), "--length", str(DISTILL_LENGTH),
                  "--log-interval", "5", "--device", str(dev)]
        vteacher_cfg = pt.get_config("vocoder")
        vsnap = pt.save_checkpoint(
            os.path.join(d, "vteacher"), "vocoder", 0,
            pt.init_wavenet(vteacher_cfg, torch.Generator().manual_seed(SEED),
                            dev), cfg=vteacher_cfg)
        tk.trunk_fwd_plain = tk.trunk_bwd_plain = barred
        try:
            tk.fwd_launches = tk.bwd_launches = 0
            t = time.time()
            a = distill_cli.main(["--teacher-snapshot", teacher_snap,
                                  "--steps", "10", "--save-interval", "5",
                                  "--out-dir", os.path.join(d, "a")]
                                 + common)
            torch.cuda.synchronize()
            wall = time.time() - t
            launched = (tk.fwd_launches, tk.bwd_launches)
            snap5 = os.path.join(d, "a", "student_0000000005.ckpt")
            tk.fwd_launches = tk.bwd_launches = 0
            b = distill_cli.main(["--teacher-snapshot", teacher_snap,
                                  "--steps", "5", "--student-snapshot",
                                  snap5, "--out-dir", os.path.join(d, "b")]
                                 + common)
            torch.cuda.synchronize()
            resumed = (tk.fwd_launches, tk.bwd_launches)
            tk.fwd_launches = tk.bwd_launches = 0
            t = time.time()
            v = distill_cli.main(["--teacher-snapshot", vsnap, "--steps", "3",
                                  "--out-dir", os.path.join(d, "v")]
                                 + common)
            torch.cuda.synchronize()
            v_wall = time.time() - t
            v_launched = (tk.fwd_launches, tk.bwd_launches)
        finally:
            tk.trunk_fwd_plain, tk.trunk_bwd_plain = real
        students = {"chaconne": shutil.copy(a["path"], keep),
                    "vocoder": shutil.copy(v["path"], keep)}
    check(not plain_calls, f"a plain version ran {len(plain_calls)} times")
    check(launched == (10, 0), f"distillation: K2/K3 launches {launched}, "
          "expected 10 and 0 (the teacher is frozen)")
    check(resumed == (5, 0), f"resumed: K2/K3 launches {resumed}")
    check(v_launched == (3, 0), f"vocoder distillation: K2/K3 launches "
          f"{v_launched}")
    check(a["step"] == b["step"] == 10 and v["step"] == 3,
          f"steps {a['step']}, {b['step']}, {v['step']}")
    la = list(_leaves(iaf.student_state_dict(a["params"])))
    lb = list(_leaves(iaf.student_state_dict(b["params"])))
    off = [p for (p, x), (_, y) in zip(la, lb) if not torch.equal(x, y)]
    check([p for p, _ in la] == [p for p, _ in lb] and not off,
          f"the resumed run differs from the uninterrupted one at {off[:4]}")
    check(v["scfg"].cond_channels == vteacher_cfg.cond_channels,
          "the vocoder student is unconditioned")
    log(f"[distill] distill_cli.main on phase 25's chaconne_wide step-20 "
        f"snapshot, --data-dir (examples), default student, batch "
        f"{DISTILL_BATCH}, length {DISTILL_LENGTH}: 10 steps in {wall:.1f} s "
        f"(dataset, init and 2 snapshots included), K2/K3 launches "
        f"{launched[0]}/{launched[1]}, plain calls {len(plain_calls)}; "
        f"resumed from the step-5 snapshot (K2 {resumed[0]}): the step-10 "
        f"params ({len(la)} leaves) bitwise equal; the vocoder teacher, 3 "
        f"steps with cond in {v_wall:.1f} s, K2 (COND) launches "
        f"{v_launched[0]}")
    split = {"chaconne": _distill_split(torch, pt, tk, dev, card, teacher,
                                        tcfg)}
    vblob = pt.init_wavenet(vteacher_cfg, torch.Generator().manual_seed(SEED),
                            dev)
    split["vocoder"] = _distill_split(
        torch, pt, tk, dev, card, vblob,
        dataclasses.replace(vteacher_cfg, trunk_kernel=True))
    return dict(k2=k2, launches=launched[0], v_launches=v_launched[0],
                loss_err=loss_err, split=split, students=students,
                wall_s=wall)


def phase_student_serving(torch, np, pt, dev, card, students, n=16000):
    """Phase 29, the student served: ``serving.server.main
    --student-snapshot`` on phase 28's students. ``/synthesize`` of ``n``
    samples byte-equal to ``student_generate`` with the request's seed at
    the clip's 8192-sample bucket, cut; ``/vocode`` of
    ``examples/generated_t1.0.wav`` on the conditioned student byte-equal
    to ``student_synthesize`` of the server's mel frames. Request times on
    the host clock."""
    from pytorch_wavenet_tpu_torch.models import iaf
    from pytorch_wavenet_tpu_torch.serving import server as srv

    def serve(path):
        box, ready = {}, threading.Event()

        def on_ready(server):
            box["server"] = server
            ready.set()

        th = threading.Thread(target=srv.main, kwargs=dict(
            argv=["--student-snapshot", path, "--port", "0"],
            on_ready=on_ready), daemon=True)
        th.start()
        t0 = time.time()
        while not ready.wait(1):
            check(th.is_alive() and time.time() - t0 < 300,
                  "the student server did not come up")
        server = box["server"]
        return server, th, f"http://127.0.0.1:{server.server_address[1]}"

    def pcm(wav):
        w = np.asarray(wav)
        check(np.isfinite(w).all(), "non-finite waveform")
        return np.clip(w * 32767.0, -32768, 32767).astype("<i2")

    def bucket(m):
        return -(-m // STUDENT_BUCKET) * STUDENT_BUCKET

    out = {}
    server, th, base = serve(students["chaconne"])
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.loads(r.read())
        check(health["backend"] == "iaf-student", f"backend {health}")
        times, bodies = [], []
        for _ in range(2):  # the second request warm
            t = time.time()
            with urllib.request.urlopen(
                    f"{base}/synthesize?num_samples={n}&seed=31",
                    timeout=600) as r:
                bodies.append(r.read())
            times.append(time.time() - t)
        out["synthesize_s"] = min(times)
    finally:
        server.shutdown()
        th.join(60)
    check(not th.is_alive(), "the student server thread did not stop")
    params, scfg, _ = iaf.load_student_snapshot(students["chaconne"],
                                                device=dev)
    want = pcm(iaf.student_generate(
        params, scfg, torch.Generator().manual_seed(31), bucket(n),
        device=dev)[0, :n].cpu().numpy())
    for body in bodies:
        check(np.array_equal(np.frombuffer(_read_wav(body, n), "<i2"), want),
              "/synthesize differs from student_generate with its seed")
    check(health["parameter_count"] == iaf.student_parameter_count(params),
          f"/health parameter_count {health['parameter_count']}")

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, VOCODER_WAV), "rb") as f:
        blob = f.read()
    server, th, base = serve(students["vocoder"])
    try:
        vt = []
        for _ in range(2):
            req = urllib.request.Request(f"{base}/vocode?seed=33", data=blob,
                                         method="POST")
            t = time.time()
            with urllib.request.urlopen(req, timeout=600) as r:
                vbody = r.read()
            vt.append(time.time() - t)
    finally:
        server.shutdown()
        th.join(60)
    check(not th.is_alive(), "the student vocoder server thread did not stop")
    vparams, vscfg, _ = iaf.load_student_snapshot(students["vocoder"],
                                                  device=dev)
    mel = _vocoder_mel(pt, blob, pt.get_config("vocoder"))
    m = mel.shape[0] * 256
    vgot = np.frombuffer(_read_wav(vbody, m), "<i2")
    vwant = iaf.student_synthesize(vparams, vscfg,
                                   torch.Generator().manual_seed(33), mel,
                                   256, num_samples=bucket(m), device=dev)
    check(np.array_equal(vgot, pcm(vwant[0, :m].cpu().numpy())),
          "/vocode differs from student_synthesize")
    # the library call alone on the card, for the served rate beside it
    torch.cuda.synchronize()
    t = time.perf_counter()
    iaf.student_generate(params, scfg, torch.Generator().manual_seed(31),
                         bucket(n), device=dev)
    torch.cuda.synchronize()
    lib_s = time.perf_counter() - t
    out.update(synthesize_samples_per_s=n / out["synthesize_s"],
               vocode_s=min(vt), vocode_samples=m,
               vocode_samples_per_s=m / min(vt), library_s=lib_s,
               student_params=health["parameter_count"])
    log(f"[serve student] chaconne student ({health['parameter_count']:,} "
        f"params): /synthesize {n} samples in {out['synthesize_s']:.3f} s "
        f"({out['synthesize_samples_per_s']:,.0f} samples/s; the "
        f"{bucket(n)}-sample draw alone {1e3 * lib_s:.1f} ms), byte-equal to "
        f"student_generate with its seed; the vocoder student: /vocode of "
        f"{VOCODER_WAV} ({m} samples) in {min(vt):.3f} s "
        f"({out['vocode_samples_per_s']:,.0f} samples/s), byte-equal to "
        f"student_synthesize; host clock [{card}]")
    return out


# ------------------------------------------- slice 11: generation, serving

LONG_N = 16384         # phase 30's rollout length, in chunks of LONG_CHUNK
LONG_CHUNK = 4096
LONG_LANES = 256       # K4's lanes there (the pool's width)
RELOAD_STREAM = 64000  # phase 32's request that streams across a reload
REQ_N = 4096           # the other requests of phases 31-33
PROFILE_N = 16000      # phase 33's 16 requests
POOL_CHUNK = 2048       # the pool's chunk in phases 32-33
POOL = ["--batcher", "--lanes", "256", "--batch-chunk", str(POOL_CHUNK)]
CLI_N = 4096           # phase 35's samples a stream


def _wav_pcm(np, wav):
    w = np.asarray(wav)
    check(np.isfinite(w).all(), "non-finite waveform")
    return np.clip(w * 32767.0, -32768, 32767).astype("<i2")


def _server(srv, argv, tag, timeout=600):
    """``serving.server.main(argv)`` on a free port in a thread; returns
    (base url, stop) where ``stop()`` shuts it down and joins it."""
    box, ready = {}, threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    th = threading.Thread(target=srv.main, kwargs=dict(
        argv=argv + ["--port", "0"], on_ready=on_ready), daemon=True)
    t0 = time.time()
    th.start()
    while not ready.wait(1):
        check(th.is_alive() and time.time() - t0 < timeout,
              f"[{tag}] the server did not come up")
    server = box["server"]

    def stop():
        server.shutdown()
        th.join(120)
        check(not th.is_alive(), f"[{tag}] the server thread did not stop")

    return f"http://127.0.0.1:{server.server_address[1]}", stop


def _get(np, base, n, seed, temperature, chunk=2048):
    url = (f"{base}/synthesize?num_samples={n}&seed={seed}"
           f"&temperature={temperature}&chunk={chunk}")
    with urllib.request.urlopen(url, timeout=900) as r:
        return np.frombuffer(_read_wav(r.read(), n), "<i2")


def _post_json(base, route, body=None):
    """(status, JSON reply) of a POST."""
    data = b"" if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + route, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _json_get(base, route):
    with urllib.request.urlopen(base + route, timeout=60) as r:
        return json.loads(r.read())


def _k1_pcm(np, pt, params, cfg, n, seed, temperature, dev):
    """A single-stream request's library call: K1 with the server's seed."""
    from pytorch_wavenet_tpu_torch.serving.server import Synthesizer

    wav, _ = pt.generate_fast_fused(params, cfg, Synthesizer.kernel_seed(seed),
                                    n, None, temperature=temperature,
                                    fuse_res=True, device=dev)
    return _wav_pcm(np, wav[0].cpu().numpy())


def _k4_pcm(np, pt, params, cfg, n, seed, temperature, dev):
    """A pooled request's library call: its solo K4 rollout."""
    from pytorch_wavenet_tpu_torch.ops.mulaw import dequantize_to_f32

    cls = _solo_cls(pt, params, cfg, [[cfg.classes // 2]], n, temperature,
                    [seed], dev)[0]
    return _wav_pcm(np, dequantize_to_f32(cls, cfg.classes))


def phase_generate_long(torch, np, pt, gk, ghbm, dev, cfg, params):
    """Phase 30: ``generate_long`` through K1 (1 stream) and K4 (256
    lanes), LONG_N samples in chunks of LONG_CHUNK, each bitwise equal to
    one call at T = 0 and 0.9 with the same seed, progress calls at every
    chunk; ``streaming=False`` on K1 against the plain ``generate_long`` at
    T = 0 on a 6-layer cut of chaconne (classes off near-ties); per-stream
    temperature and ``progress_callback`` on the plain ``generate_fast``.
    Returns the K1 and K4 launches of the ``generate_long`` calls."""
    rng = np.random.default_rng(SEED)
    want = [(c, LONG_N) for c in range(LONG_CHUNK, LONG_N + 1, LONG_CHUNK)]
    launched = {"K1": 0, "K4": 0}
    for tag, fn, prime, kw in (
            ("K1", pt.generate_fast_fused, None, dict(fuse_res=True)),
            ("K4", pt.generate_fast_batched,
             rng.integers(0, cfg.classes, (LONG_LANES, 64)),
             dict(fuse_res=True, skip_slab=True))):
        for temp in (0.0, 0.9):
            t = time.time()
            _, one = fn(params, cfg, SEED, LONG_N, prime, temperature=temp,
                        device=dev, **kw)
            calls = []
            gk.launches = ghbm.launches = 0
            _, chunked = pt.generate_long(
                params, cfg, SEED, LONG_N, prime, temperature=temp,
                chunk_size=LONG_CHUNK, backend=fn, device=dev,
                progress_callback=lambda d, n: calls.append((d, n)), **kw)
            torch.cuda.synchronize()
            counts = {"K1": gk.launches, "K4": ghbm.launches}
            check(counts[tag] == LONG_N // LONG_CHUNK
                  and sum(counts.values()) == counts[tag],
                  f"generate_long {tag}: launches {counts}")
            launched[tag] += counts[tag]
            check(torch.equal(chunked, one),
                  f"generate_long {tag} T={temp} differs from one call")
            check(calls == want, f"progress calls {calls}")
            log(f"[generate_long] {tag}, streams {one.shape[0]}, T={temp}: "
                f"{LONG_N} samples in {LONG_N // LONG_CHUNK} chunks equal one "
                f"call bitwise; progress {calls[0]} .. {calls[-1]}; "
                f"{time.time() - t:.2f} s for both")

    # streaming=False: K1 re-primed per chunk against the plain rollout
    scfg = pt.get_config("chaconne", layers=6, blocks=1)  # rf 64
    sp = pt.init_wavenet(scfg, torch.Generator().manual_seed(SEED), dev)
    prime = torch.from_numpy(rng.integers(0, scfg.classes, (1, 64))).to(dev)
    gk.launches = 0
    _, ck = pt.generate_long(sp, scfg, 0, 300, prime, temperature=0.0,
                             chunk_size=100, backend=pt.generate_fast_fused,
                             streaming=False, device=dev, fuse_res=True)
    check(gk.launches == 3, f"streaming=False: {gk.launches} K1 launches")
    launched["K1"] += gk.launches
    _, cp = pt.generate_long(sp, scfg, None, 300, prime, temperature=0.0,
                             chunk_size=100, streaming=False, device=dev)
    gaps, _ = _spec_gaps(torch, pt, sp, scfg, prime, cp)
    parted = _held_off_near_ties(ck.long(), cp, gaps, "streaming=False")
    log(f"[generate_long] streaming=False, 6-layer chaconne (rf 64), 300 "
        f"samples in chunks of 100 re-primed: K1 equals the plain version"
        f"{' up to a near-tie' if parted else ''}")

    # per-stream temperature and progress on the plain rollout
    first = np.full((4, 1), cfg.classes // 2)
    temps = torch.tensor([0.0, 0.9, 0.0, 1.0])
    _, mixed = pt.generate_fast(params, cfg, torch.Generator().manual_seed(1),
                                64, first, temperature=temps, device=dev)
    _, cold = pt.generate_fast(params, cfg, None, 64, first, temperature=0.0,
                               device=dev)
    check(torch.equal(mixed[[0, 2]], cold[[0, 2]]),
          "per-stream temperature: a 0-temperature stream differs from the "
          "scalar T = 0 rollout")
    calls = []
    _, cb = pt.generate_fast(params, cfg, torch.Generator().manual_seed(2),
                             64, first, temperature=1.0, device=dev,
                             progress_callback=lambda d, n: calls.append(d),
                             progress_interval=16)
    _, nocb = pt.generate_fast(params, cfg, torch.Generator().manual_seed(2),
                               64, first, temperature=1.0, device=dev)
    check(torch.equal(cb, nocb) and calls == [16, 32, 48, 64],
          f"progress_callback changed the rollout (calls {calls})")
    log("[generate_long] plain generate_fast on the card: temperatures "
        "(0, 0.9, 0, 1.0) in one rollout, the 0 streams bitwise the scalar "
        "T = 0 rollout; progress_callback every 16 of 64 samples leaves it "
        "bitwise unchanged")
    return launched


def _reference_module(torch, cfg, path):
    """Pickle a module shaped like a reference pytorch-wavenet snapshot
    (``wavenet_model.WaveNetModel``, the reference's attribute names, its
    convs with random weights from SEED), with stub modules put into
    ``sys.modules`` for the save and taken out again."""
    import types

    nn = torch.nn
    stubs = {n: types.ModuleType(n) for n in ("wavenet_model",
                                              "wavenet_modules")}

    class WaveNetModel(nn.Module):
        pass

    class DilatedQueue:
        pass

    for cls, mod in ((WaveNetModel, "wavenet_model"),
                     (DilatedQueue, "wavenet_modules")):
        cls.__module__, cls.__qualname__ = mod, cls.__name__
        setattr(stubs[mod], cls.__name__, cls)
    torch.manual_seed(SEED)
    m = WaveNetModel()
    m.layers, m.blocks, m.kernel_size = cfg.layers, cfg.blocks, cfg.kernel_size
    m.classes, m.output_length = cfg.classes, cfg.output_length
    m.receptive_field = cfg.receptive_field
    m.dilations, m.dilated_queues, init = [], [], 1
    for d in cfg.dilations:
        m.dilations.append((d, init))
        q = DilatedQueue()
        q.max_length, q.dilation = (cfg.kernel_size - 1) * d + 1, d
        q.data = torch.zeros(cfg.residual_channels, q.max_length)
        m.dilated_queues.append(q)
        init = d
    R, D, S, E, C = (cfg.residual_channels, cfg.dilation_channels,
                     cfg.skip_channels, cfg.end_channels, cfg.classes)
    m.start_conv = nn.Conv1d(C, R, 1, bias=cfg.bias)
    for name, a, b, k in (("filter_convs", R, D, cfg.kernel_size),
                          ("gate_convs", R, D, cfg.kernel_size),
                          ("residual_convs", D, R, 1),
                          ("skip_convs", D, S, 1)):
        setattr(m, name, nn.ModuleList(nn.Conv1d(a, b, k, bias=cfg.bias)
                                       for _ in range(cfg.num_layers)))
    m.end_conv_1 = nn.Conv1d(S, E, 1, bias=True)
    m.end_conv_2 = nn.Conv1d(E, C, 1, bias=True)
    sys.modules.update(stubs)
    try:
        torch.save(m, path)
    finally:
        for n in stubs:
            del sys.modules[n]
    return {k: v.detach().numpy() for k, v in m.state_dict().items()}


def phase_reference_snapshot(torch, np, pt, gk, dev, d):
    """Phase 31: a chaconne-shaped whole-module reference pickle made here
    loads on the card with ``load_reference_snapshot`` (the chaconne widths
    and rf 3070 read off the module), round-trips bitwise through
    ``to_reference_state_dict``, and ``serving.server --torch-snapshot``
    serves it: /synthesize at T = 0 byte-equal to a K1 call on the converted
    params. Returns (pickle path, K1 launches while serving)."""
    from pytorch_wavenet_tpu_torch.models.convert import (
        to_reference_state_dict)
    from pytorch_wavenet_tpu_torch.serving import server as srv

    chaconne = pt.get_config("chaconne")
    path = os.path.join(d, "chaconne_reference.pt")
    sd = _reference_module(torch, chaconne, path)
    params, cfg = pt.load_reference_snapshot(path, device=dev)
    check(cfg.receptive_field == chaconne.receptive_field and all(
        getattr(cfg, f) == getattr(chaconne, f) for f in (
            "layers", "blocks", "residual_channels", "dilation_channels",
            "skip_channels", "end_channels", "classes", "bias")),
        f"converted config {cfg}")
    check(next(iter(params["layers"].values())).device.type == dev.type,
          "converted params are not on the card")
    back = to_reference_state_dict(params, cfg)
    check(sorted(back) == sorted(sd) and all(
        np.array_equal(back[k], sd[k]) for k in sd),
        "to_reference_state_dict does not give the pickle's weights back")
    n = REQ_N
    gk.launches = 0
    base, stop = _server(srv, ["--torch-snapshot", path], "torch-snapshot")
    try:
        got = _get(np, base, n, 31, 0.0)
    finally:
        stop()
    launched = gk.launches
    check(launched == 1 + math.ceil(n / 2048), f"--torch-snapshot: "
          f"{launched} K1 launches, expected 1 + one per chunk")
    check(np.array_equal(got, _k1_pcm(np, pt, params, cfg, n, 31, 0.0, dev)),
          "--torch-snapshot response differs from K1 on the converted params")
    log(f"[torch-snapshot] chaconne-shaped reference pickle: rf "
        f"{cfg.receptive_field}, {len(sd)} tensors round-trip bitwise; "
        f"served {n} samples at T=0 byte-equal to K1 on the converted "
        f"params; K1 launches {launched}")
    return path, launched


def phase_reload(torch, np, pt, gk, ghbm, dev, cfg, params, d):
    """Phase 32: ``--batcher --lanes 256 --batch-chunk 2048`` on snapshot A
    with ``--snapshot-path`` and ``--reload-interval 1``: POST /reload to B
    while a RELOAD_STREAM-sample request streams (it completes, /stats
    failed 0), a later request byte-equal to K4 on B; snapshot C written
    into the directory rolls in within a few polls (a request equal to K4
    on C); a snapshot of another config gets 400; the plain version barred;
    K4's launches in the server's run exactly those its requests need (the
    library calls it is held to run outside that count). Then /reload once
    on the single-stream server (K1). Returns the K1 and K4 launches."""
    from pytorch_wavenet_tpu_torch.serving import server as srv

    run, apart = os.path.join(d, "run"), os.path.join(d, "apart")
    pb = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED + 1), dev)
    pc = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED + 2), dev)
    a = pt.save_checkpoint(run, "chaconne", 1, params, cfg=cfg)
    b = pt.save_checkpoint(apart, "chaconne", 2, pb, cfg=cfg)
    ocfg = pt.get_config("chaconne", residual_channels=16)
    other = pt.save_checkpoint(apart, "narrow", 3, pt.init_wavenet(
        ocfg, torch.Generator().manual_seed(3), dev), cfg=ocfg)
    # the library calls the served clips are held to, before the count
    want_b = _k4_pcm(np, pt, pb, cfg, REQ_N, 41, 0.9, dev)
    want_c = _k4_pcm(np, pt, pc, cfg, REQ_N, 42, 0.0, dev)
    real = ghbm.batched_plain
    plain_calls = []

    def barred(*args, **kwargs):
        plain_calls.append(1)
        raise RuntimeError("the plain version ran on the card path")

    ghbm.batched_plain = barred
    gk.launches = ghbm.launches = 0
    try:
        base, stop = _server(srv, [
            "--snapshot", a, "--snapshot-path", run, *POOL,
            "--reload-interval", "1"], "reload --batcher")
        try:
            box = {}
            th = threading.Thread(target=lambda: box.update(
                pcm=_get(np, base, RELOAD_STREAM, 40, 0.9)))
            t = time.time()
            th.start()
            time.sleep(1.0)
            code, reply = _post_json(base, "/reload", {"snapshot": b})
            check(code == 200 and reply == {"reloaded": True, "step": 2},
                  f"/reload: {code} {reply}")
            after = _get(np, base, REQ_N, 41, 0.9)
            check(th.is_alive(), "the long request ended before /reload "
                  "and the request after it were served")
            code, reply = _post_json(base, "/reload", {"snapshot": other})
            check(code == 400 and "config" in reply["error"],
                  f"/reload of another config: {code} {reply}")
            th.join(900)
            check(not th.is_alive() and box["pcm"].size == RELOAD_STREAM,
                  "the request streaming across the reload did not finish")
            streamed_s = time.time() - t
            # the follower: snapshot C written into the served directory
            pt.save_checkpoint(run, "chaconne", 5, pc, cfg=cfg)
            t = time.time()
            polls = 0
            while True:
                polls += 1
                if np.array_equal(_get(np, base, REQ_N, 42, 0.0), want_c):
                    break
                check(time.time() - t < 30, "the follower did not roll in "
                      "snapshot C within 30 s")
                time.sleep(0.5)
            rolled_s = time.time() - t
            stats = _json_get(base, "/stats")
        finally:
            stop()
    finally:
        ghbm.batched_plain = real
    k4, k1 = ghbm.launches, gk.launches

    def lone(n):
        """K4 launches of a lone pooled request of n samples: its prime
        (sample 0), ceil((n - 1) / chunk) chunks, and the chunk launched
        before its last one is handed out."""
        return 2 + math.ceil((n - 1) / POOL_CHUNK)

    # the pool's prewarm step and the server's one-sample warm-up, the long
    # request, `after` (a prime; its chunks ride the long request's) and
    # the follower's polls
    want_k4 = 2 + lone(RELOAD_STREAM) + 1 + polls * lone(REQ_N)
    check(not plain_calls and k1 == 0 and k4 == want_k4
          and k4 == 1 + stats["prime_calls"] + stats["pool_steps"],
          f"reload --batcher: K4 {k4} (want {want_k4}; /stats prime calls "
          f"{stats['prime_calls']}, pool steps {stats['pool_steps']}), K1 "
          f"{k1}, plain {len(plain_calls)}")
    check(stats["failed"] == 0, f"/stats after the reloads: {stats}")
    check(np.array_equal(after, want_b),
          "a request after /reload differs from K4 on snapshot B")
    log(f"[reload] --batcher --lanes 256: a {RELOAD_STREAM}-sample request "
        f"streamed across /reload in {streamed_s:.1f} s (failed 0); the next "
        f"request byte-equal to K4 on B; another config 400; snapshot C "
        f"rolled in by the follower after {rolled_s:.1f} s ({polls} polls), "
        f"equal to K4 on C; K4 launches {k4}, K1 {k1}, plain calls 0")

    gk.launches = ghbm.launches = 0
    base, stop = _server(srv, ["--snapshot", a], "reload single-stream")
    try:
        code, reply = _post_json(base, "/reload", {"snapshot": b})
        got = _get(np, base, REQ_N, 43, 0.9)
    finally:
        stop()
    k1 = gk.launches
    check(code == 200 and reply["step"] == 2, f"/reload: {code} {reply}")
    check(k1 == 1 + math.ceil(REQ_N / 2048) and ghbm.launches == 0,
          f"single-stream: K1 {k1}")
    check(np.array_equal(got, _k1_pcm(np, pt, pb, cfg, REQ_N, 43, 0.9, dev)),
          "single-stream request after /reload differs from K1 on B")
    log(f"[reload] single stream: the request after /reload byte-equal to "
        f"K1 on B; K1 launches {k1}")
    return k1, k4


def phase_profile(torch, np, pt, gk, ghbm, dev, cfg, params, d):
    """Phase 33: ``--batcher --lanes 256 --batch-chunk 2048 --profile-dir``:
    a first short capture, then POST /profile?seconds=2 while 16 requests
    run on the pool; a second capture during it gets 409, the trace is a
    Chrome trace JSON naming K4's kernel with device time, and the 16
    responses are byte-equal to their solo K4 rollouts. The pool's busy
    share is K4's device time inside the capture's window over the
    window. Returns (K4 launches, the trace's K4 launches that overlap the
    window, their device ms inside it, their whole device ms, the window
    in ms)."""
    from pytorch_wavenet_tpu_torch.ops.mulaw import dequantize_to_f32
    from pytorch_wavenet_tpu_torch.serving import server as srv
    from pytorch_wavenet_tpu_torch.utils.profiling import (
        CAPTURE_SPAN, capture_window, clipped_ms, k4_events)

    prof = os.path.join(d, "profiles")
    snap = pt.save_checkpoint(os.path.join(d, "profile"), "chaconne", 1,
                              params, cfg=cfg)
    n, reqs = PROFILE_N, 16
    temps = [(0.9, 0.0)[i % 2] for i in range(reqs)]
    gk.launches = ghbm.launches = 0
    base, stop = _server(srv, ["--snapshot", snap, *POOL, "--profile-dir",
                               prof], "profile")
    try:
        # the process's first capture starts the device tracer (seconds on
        # the card), so a short one goes before the measured capture
        t = time.time()
        first = _post_json(base, "/profile?seconds=0.1")
        first_s = time.time() - t
        check(first[0] == 200, f"the first /profile: {first}")
        out = [None] * reqs

        def fetch(i):
            out[i] = _get(np, base, n, 700 + i, temps[i])

        threads = [threading.Thread(target=fetch, args=(i,))
                   for i in range(reqs)]
        for th in threads:
            th.start()
        time.sleep(0.5)
        box = {}
        cap = threading.Thread(target=lambda: box.update(
            r=_post_json(base, "/profile?seconds=2")))
        cap.start()
        time.sleep(0.3)
        second = _post_json(base, "/profile?seconds=1")
        cap.join(120)
        for th in threads:
            th.join(900)
        stats = _json_get(base, "/stats")
    finally:
        stop()
    k4 = ghbm.launches
    check(second[0] == 409, f"a second capture got {second}")
    code, reply = box["r"]
    check(code == 200 and reply["seconds"] == 2.0, f"/profile: {code} {reply}")
    check(all(o is not None for o in out) and stats["failed"] == 0,
          f"requests during the capture: {stats}")
    with open(reply["trace"]) as f:
        events = json.load(f)["traceEvents"]
    lo, hi = capture_window(events, CAPTURE_SPAN)
    ev = [e for e in k4_events(events)
          if float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    dev_ms = clipped_ms(ev, lo, hi)
    whole_ms = sum(float(e["dur"]) for e in ev) / 1e3
    window_ms = (hi - lo) / 1e3
    check(ev and 0 < dev_ms <= window_ms,
          f"K4 in the capture: {len(ev)} launches, {dev_ms} ms inside a "
          f"{window_ms} ms window")
    for temp in (0.9, 0.0):
        idx = [i for i in range(reqs) if temps[i] == temp]
        cls = _solo_cls(pt, params, cfg, [[cfg.classes // 2]] * len(idx), n,
                        temp, [700 + i for i in idx], dev)
        for row, i in enumerate(idx):
            check(np.array_equal(out[i], _wav_pcm(np, dequantize_to_f32(
                cls[row], cfg.classes))),
                f"request {i} during the capture differs from its solo K4")
    log(f"[profile] a first 0.1 s capture took {first_s:.2f} s; a 2 s "
        f"capture during 16 pooled {n}-sample requests: a {window_ms:.3f} "
        f"ms window, {len(ev)} K4 launches overlap it, {dev_ms:.3f} ms of "
        f"their device time inside it (busy share "
        f"{100 * dev_ms / window_ms:.1f} %; {whole_ms:.3f} ms whole) "
        f"({os.path.basename(reply['trace'])}, {len(events)} events); a "
        f"second capture got 409; the 16 responses byte-equal to their "
        f"solo K4 rollouts; K4 launches {k4}, K1 {gk.launches}")
    return k4, len(ev), dev_ms, whole_ms, window_ms


def phase_backend_plain(torch, np, pt, gk, ghbm, dev, cfg, params, d):
    """Phase 34: ``serving.server --backend plain`` on the card
    (``cuda-plain``: ``generate_fast``, no kernel): a 512-sample request at
    T = 0 byte-equal to the plain library call, whose classes equal K1's
    off near-ties."""
    from pytorch_wavenet_tpu_torch.serving import server as srv

    snap = pt.save_checkpoint(os.path.join(d, "plain"), "chaconne", 1,
                              params, cfg=cfg)
    n = 512
    gk.launches = ghbm.launches = 0
    base, stop = _server(srv, ["--snapshot", snap, "--backend", "plain"],
                         "backend plain")
    try:
        backend = _json_get(base, "/health")["backend"]
        t = time.time()
        got = _get(np, base, n, 5, 0.0, chunk=n)
        dt = time.time() - t
    finally:
        stop()
    check(backend == f"{dev.type}-plain", f"/health backend {backend}")
    check(gk.launches == 0 and ghbm.launches == 0,
          f"--backend plain launched K1 {gk.launches}, K4 {ghbm.launches}")
    wav, cp = pt.generate_fast(params, cfg, torch.Generator().manual_seed(5),
                               n, temperature=0.0, device=dev)
    check(np.array_equal(got, _wav_pcm(np, wav[0].cpu().numpy())),
          "--backend plain differs from the plain library call")
    _, ck = pt.generate_fast_fused(params, cfg, 0, n, None, temperature=0.0,
                                   fuse_res=True, device=dev)
    prime = torch.full((1, 1), cfg.classes // 2, device=dev)
    gaps, _ = _spec_gaps(torch, pt, params, cfg, prime, cp)
    parted = _held_off_near_ties(ck.long(), cp, gaps, "--backend plain")
    log(f"[backend plain] {backend}: {n} samples at T=0 in {dt:.2f} s "
        f"({n / dt:.1f} samples/s), byte-equal to generate_fast, K1's "
        f"classes{' up to a near-tie' if parted else ''}; no kernel launched")


def _cli(args, out):
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_wavenet_tpu_torch.generate_cli",
         *args, "--out", out], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def phase_generate_cli(torch, np, pt, dev, cfg, params, d, ref_pickle,
                       ema_snap):
    """Phase 35: ``python -m pytorch_wavenet_tpu_torch.generate_cli`` in
    subprocesses, all started together: ``--snapshot`` at 1 stream (K1) and
    16 streams (K4), ``--torch-snapshot``, ``--vocode-wav`` at the vocoder
    (K1 through ``synthesize``), ``--ema`` on phase 25's snapshot, each
    wav byte-equal to the library call the CLI printed it took (its
    launches printed); ``--draft-snapshot`` without ``--force-speculate``
    exits non-zero with the refusal. Returns the launches the CLIs
    printed."""
    from pytorch_wavenet_tpu_torch.models.generate import synthesize
    from pytorch_wavenet_tpu_torch.training.optimizers import (
        find_ema_state_dict)

    snap = pt.save_checkpoint(os.path.join(d, "cli"), "chaconne", 1, params,
                              cfg=cfg)
    vcfg, vparams = _vocoder(torch, pt, dev)
    vsnap = pt.save_checkpoint(os.path.join(d, "cli"), "vocoder", 1, vparams,
                               cfg=vcfg)

    def mid(streams):
        return np.full((streams, 1), cfg.classes // 2, np.int64)

    n = ["--num-samples", str(CLI_N)]
    runs = {
        "k1": (["--snapshot", snap, *n, "--seed", "3", "--temperature",
                "0.9"], "K1", 1),
        "k4": (["--snapshot", snap, *n, "--seed", "4", "--temperature", "0.9",
                "--num-streams", "16"], "K4", 16),
        "torch": (["--torch-snapshot", ref_pickle, *n, "--seed", "5",
                   "--temperature", "0"], "K1", 1),
        "vocode": (["--snapshot", vsnap, "--vocode-wav", VOCODER_WAV,
                    "--seed", "6", "--temperature", "0.9"], "K1", 1),
        "ema": (["--snapshot", ema_snap, "--ema", *n, "--seed", "7",
                 "--temperature", "1.0"], "K1", 1),
    }
    t = time.time()
    procs = {k: _cli(a, os.path.join(d, f"cli_{k}.wav"))
             for k, (a, _, _) in runs.items()}
    procs["draft"] = _cli(["--snapshot", snap, "--draft-snapshot", snap],
                          os.path.join(d, "cli_draft.wav"))
    try:
        done = {k: p.communicate(timeout=600) + (p.returncode,)
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    cli_s = time.time() - t
    out, err, rc = done["draft"]
    check(rc != 0 and "64-213x" in err and "--force-speculate" in err,
          f"--draft-snapshot without --force-speculate: rc {rc}: {err[-400:]}")

    # the library calls the CLIs said they took
    rparams, rcfg = pt.load_reference_snapshot(ref_pickle, device=dev)
    blob = pt.load_checkpoint(ema_snap, device=dev)
    ema = pt.from_jax_params(find_ema_state_dict(blob["opt_state"]), dev)
    with open(VOCODER_WAV, "rb") as f:
        mel = _vocoder_mel(pt, f.read(), vcfg)
    lib = {
        "k1": pt.generate_fast_fused(params, cfg, 3, CLI_N, mid(1),
                                     temperature=0.9, fuse_res=True,
                                     device=dev)[0],
        "k4": pt.generate_fast_batched(params, cfg, 4, CLI_N, mid(16),
                                       temperature=0.9, fuse_res=True,
                                       skip_slab=True, device=dev)[0],
        "torch": pt.generate_fast_fused(rparams, rcfg, 5, CLI_N, mid(1),
                                        temperature=0.0, fuse_res=True,
                                        device=dev)[0],
        "vocode": synthesize(vparams, vcfg, 6, mel, 256, mid(1),
                             temperature=0.9,
                             backend=pt.generate_fast_fused, fuse_res=True,
                             device=dev)[0],
        "ema": pt.generate_fast_fused(ema, blob["config"], 7, CLI_N, mid(1),
                                      temperature=1.0, fuse_res=True,
                                      device=dev)[0],
    }
    launches = {}
    for k, (_, kernel, streams) in runs.items():
        out, err, rc = done[k]
        check(rc == 0, f"generate_cli {k}: rc {rc}: {err[-600:]}")
        check(f"generation path: {kernel} " in out,
              f"generate_cli {k} did not take {kernel}: {out[-400:]}")
        launches[k] = int(out.split("kernel launches: ")[1].split()[0])
        check(launches[k] >= 1, f"generate_cli {k}: no kernel launch")
        wav = lib[k].cpu().numpy()
        stem = os.path.join(d, f"cli_{k}")
        files = ([stem + ".wav"] if streams == 1
                 else [f"{stem}_{i}.wav" for i in range(streams)])
        for i, path in enumerate(files):
            ref = os.path.join(d, f"lib_{k}_{i}.wav")
            pt.write_wav(ref, wav[i], 16000)
            with open(path, "rb") as f, open(ref, "rb") as g:
                check(f.read() == g.read(),
                      f"generate_cli {k}: {path} differs from the library "
                      f"call")
    log(f"[generate_cli] 6 subprocesses in {cli_s:.1f} s: --snapshot 1 "
        f"stream (K1) and 16 (K4), --torch-snapshot, --vocode-wav "
        f"(vocoder), --ema, each wav byte-equal to its library call "
        f"(launches {launches}); --draft-snapshot refused (rc "
        f"{done['draft'][2]})")
    return launches


# ------------------------------------------------------------- slice 12

SB_ARGS = ["--lanes", "256", "--chunk", "2048", "--concurrency", "256",
           "--num-samples", "16000", "--skip-slab",
           "--json"]      # phases 37-38's closed-loop load
SB_REQUESTS = 512          # phase 37's requests at chaconne
SB_VOCODER_REQUESTS = 256  # phase 38's requests at the vocoder
SOAK_SECONDS = 10          # phase 39's soak, reloads every SOAK_RELOAD s
SOAK_RELOAD = 5
SOAK_CHECK_SECONDS = 8     # then without reloads, greedy requests checked
SOAK_CHECK_RATE = "0.25"   # against their solo K4 rollouts at this rate
BENCHMARK_ARGS = ["--config", "chaconne", "--gen-samples", "256",
                  "--max-streams", "512", "--hbm-kernel-only"]
DEMO_STEPS = ("200", "60")  # phase 41's teacher and distillation steps
DEMO_EVAL = "16000"         # its evaluation rollouts' samples a stream
# the tools' runs on K4 with bf16 rings (the tools' default), the others
# f32
BF16_RING_TOOLS = ("serving_bench chaconne, profiled",
                   "serving_bench vocoder", "serving_soak reloads",
                   "serving_soak checked")


def _tool(gk, ghbm, tk, main, argv, tag):
    """One tool's ``main(argv)`` in this process, its standard output
    logged line by line under ``tag`` (so no line of it can pass for the
    run's result), its launches per kernel counted from zero around it; a
    ``SystemExit`` (a broken invariant, a refused argument) fails the
    run. Returns (main's result, launches per kernel, seconds)."""
    import contextlib
    import io

    gk.launches = ghbm.launches = tk.fwd_launches = tk.bwd_launches = 0
    buf = io.StringIO()
    t = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            out = main(argv)
    except SystemExit as e:
        raise SmokeFailure(f"{tag}: exited: {e}") from e
    finally:
        for line in buf.getvalue().splitlines():
            log(f"[{tag}] {line}")
    secs = time.time() - t
    n = {"K1": gk.launches, "K4": ghbm.launches, "K2": tk.fwd_launches,
         "K3": tk.bwd_launches}
    log(f"[{tag}] launches " + ", ".join(f"{k} {v}" for k, v in n.items())
        + f"; {secs:.1f} s")
    return out, n, secs


def phase_bench(torch, gk, ghbm, tk, card):
    """Phase 36: the port's one-line metric (``pytorch_wavenet_tpu_torch.
    bench``): K1 at saber, 65536 samples, a warm call and two timed; one
    JSON line with bench.py's keys."""
    from pytorch_wavenet_tpu_torch import bench

    r, n, _ = _tool(gk, ghbm, tk, bench.main, [], "bench")
    check(n == {"K1": 3, "K4": 0, "K2": 0, "K3": 0} and r["launches"] == 3,
          f"bench launches {n}")
    check(r["samples_per_s"] > 0, f"bench: {r}")
    log(f"[bench] {r['samples_per_s']:.1f} samples/s, {r['us_per_step']:.2f} "
        f"us/step (host clock, best of 2) [{card}]")
    return dict(r, launches=n)


def phase_serving_bench(torch, gk, ghbm, tk, card):
    """Phases 37-38: ``scripts.serving_bench`` at chaconne, 256 lanes,
    chunk 2048, 256 requests in flight until 512 complete (f32 rings), then
    again with ``--device-profile`` (bf16 rings, its default): K4's device
    time inside the traced window, no more than the window; then the
    vocoder with mel frames on the wire (``--cond --cond-hop 256``). Every
    request completes and none fails."""
    from pytorch_wavenet_tpu_torch.scripts import serving_bench as sb

    out = {}
    for tag, requests, extra in (
            ("chaconne", SB_REQUESTS, ["--config", "chaconne",
                                       "--ring-dtype", "f32"]),
            ("chaconne, profiled", SB_REQUESTS, [
                "--config", "chaconne", "--ring-dtype", "bf16",
                "--device-profile"]),
            ("vocoder", SB_VOCODER_REQUESTS, [
                "--config", "vocoder", "--cond", "--cond-hop", "256",
                "--ring-dtype", "bf16"])):
        argv = [*SB_ARGS, "--requests", str(requests), *extra]
        s, n, secs = _tool(gk, ghbm, tk, sb.main, argv,
                           f"serving_bench {tag}")
        check(s["completed"] == requests and s["failed"] == 0,
              f"serving_bench {tag}: {s}")
        check(n["K4"] > 0 and n["K1"] == n["K2"] == 0,
              f"serving_bench {tag} launches {n}")
        if "profiled" in tag:
            check("device_busy_s" in s, "the profile holds no K4 launch")
            check(s["device_busy_s"] <= s["wall_s"] * 1.05
                  and s["device_bound_samples_per_s"]
                  >= s["agg_samples_per_s"] * 0.95,
                  f"device busy {s['device_busy_s']} s in {s['wall_s']} s")
        log(f"[serving_bench {tag}] {s['agg_samples_per_s']:,} samples/s "
            f"aggregate, TTFA p50/p95 {s['ttfa_p50_ms']}/{s['ttfa_p95_ms']} "
            f"ms, wire {s['wire_bytes_per_sample']} B/sample"
            + (f", K4 busy {s['device_busy_s']} s of {s['wall_s']} s, "
               f"device-bound {s['device_bound_samples_per_s']:,} samples/s"
               if "device_busy_s" in s else "") + f" [{card}]")
        out[tag] = dict(summary=s, launches=n, seconds=secs)
    return out


def phase_soak(torch, gk, ghbm, tk, card):
    """Phase 39: ``scripts.serving_soak`` at chaconne, 256 lanes, chunk
    2048, bf16 rings, 16 workers of mixed lengths, temperatures and cancels:
    for SOAK_SECONDS with ``update_params`` every SOAK_RELOAD s, then for
    SOAK_CHECK_SECONDS without reloads, a SOAK_CHECK_RATE share of the
    greedy requests held bitwise against their solo K4 rollouts at the
    pool's settings (the script skips that check under reloads). In both:
    nothing hangs, fails or errs, the counters agree, the pool drains with
    every lane free; each reload installed; some requests checked and none
    mismatched (the script raises on its own invariants)."""
    from pytorch_wavenet_tpu_torch.scripts import serving_soak

    common = ["--config", "chaconne", "--lanes", "256", "--chunk", "2048",
              "--ring-dtype", "bf16", "--skip-slab", "--json"]
    out = {}
    for tag, extra in (
            ("reloads", ["--seconds", str(SOAK_SECONDS),
                         "--reload-every", str(SOAK_RELOAD)]),
            ("checked", ["--seconds", str(SOAK_CHECK_SECONDS),
                         "--check-rate", SOAK_CHECK_RATE])):
        r, n, secs = _tool(gk, ghbm, tk, serving_soak.main, common + extra,
                           f"serving_soak {tag}")
        check(r["hung"] == r["mismatched"] == r["worker_errors"] == 0
              and r["failed"] == r["pool_failed"] == 0
              and r["pool_outstanding"] == 0 and r["pool_free"] == 256
              and r["completed"] > 0, f"serving_soak {tag}: {r}")
        if tag == "reloads":
            check(r["reloads"] >= 1
                  and r["reloads_installed"] == r["reloads"],
                  f"serving_soak reloads: {r}")
        else:
            check(r["checked"] > 0 and r["reloads"] == 0,
                  f"serving_soak checked: {r}")
        check(n["K4"] > 0 and n["K1"] == n["K2"] == 0,
              f"soak {tag} launches {n}")
        log(f"[serving_soak {tag}] {r['completed']} completed, "
            f"{r['cancelled']} cancelled, {r['failed']} failed, "
            f"{r['checked']} checked bitwise ({r['mismatched']} mismatched), "
            f"{r['reloads_installed']} reloads installed, {r['pool_steps']} "
            f"pool steps, RSS growth {r['rss_growth_mb']} MB over "
            f"{r['wall_s']} s [{card}]")
        out[tag] = dict(report=r, launches=n, seconds=secs)
    return out


def phase_benchmark(torch, pt, gk, ghbm, tk, card):
    """Phase 40: ``scripts.benchmark`` at chaconne with BENCHMARK_ARGS: the
    train step at batch 16 (K2/K3, 21 steps), the plain lines, K1 exact and
    fuse_res (3 calls each), K4's sweep up to 512 streams (a short warm
    call and 4 timed each), the student and the gather. The default sweep
    (to 16384 bf16 lanes, 16384 samples) takes about 17 minutes alone."""
    from pytorch_wavenet_tpu_torch.scripts import benchmark

    lines, n, secs = _tool(gk, ghbm, tk, benchmark.main, BENCHMARK_ARGS,
                           "benchmark")
    args = benchmark.parse_args(BENCHMARK_ARGS)
    rows = benchmark.sweep_rows(pt.get_config(args.config), args.max_streams)
    check(n == {"K1": 6, "K4": 5 * len(rows), "K2": 21, "K3": 21},
          f"benchmark launches {n} ({len(rows)} sweep rows)")
    check(sum(line.startswith("gen fused-HBM") for line in lines)
          == len(rows) and any("(fuse_res)" in line for line in lines),
          "benchmark lines")
    return dict(lines=lines, launches=n, seconds=secs)


def phase_distill_demo(torch, gk, ghbm, tk, dev, card, d):
    """Phase 41: ``scripts.distill_demo`` in both modes at its default
    widths (the teacher 9x2 layers, width 32, skip 512, output 1024; the
    student 4 flows x 10 layers, width 64) with DEMO_STEPS and DEMO_EVAL
    samples a stream in the evaluation: the teacher
    trained through K2/K3 (a launch each a step), distilled with the
    teacher scored through K2 (a launch a step), its rollouts on K1; the
    metrics finite and the student snapshot read back."""
    from pytorch_wavenet_tpu_torch.models import iaf
    from pytorch_wavenet_tpu_torch.scripts import distill_demo

    teacher, distill = (int(s) for s in DEMO_STEPS)
    out = {}
    for mode in ("uncond", "vocoder"):
        m, n, secs = _tool(gk, ghbm, tk, distill_demo.main, [
            "--mode", mode, "--teacher-steps", DEMO_STEPS[0],
            "--distill-steps", DEMO_STEPS[1], "--eval-steps", "10",
            "--eval-samples", DEMO_EVAL, "--json",
            "--out-dir", d], f"distill_demo {mode}")
        check(all(math.isfinite(v) for k, v in m.items() if k != "mode"),
              f"distill_demo {mode}: {m}")
        check(n["K2"] == teacher + distill and n["K3"] == teacher
              and n["K1"] + n["K4"] >= 1,
              f"distill_demo {mode} launches {n}")
        _, scfg, step = iaf.load_student_snapshot(os.path.join(
            d, f"demo_student_{mode}_{distill:010d}.ckpt"), device=dev)
        check(step == distill and scfg.flows == 4, f"student {scfg}")
        log(f"[distill_demo {mode}] KL {m['kl_start']} -> {m['kl_end']}, "
            f"rms ratio {m['rms_ratio']}, log-mel L2 student "
            f"{m['logmel_l2_student']} (init {m['logmel_l2_init']}, teacher "
            f"{m['logmel_l2_teacher']}), {secs:.1f} s [{card}]")
        out[mode] = dict(metrics=m, launches=n, seconds=secs)
    return out


def slice12_entries(kernels, s12):
    """This slice's main paths, phases 36-41, on the kernels line: each
    tool's launches per kernel, counted from zero around its own run, on
    the entry of each kernel it drove (K4's by the ring dtype of the run:
    BF16_RING_TOOLS on the bf16-ring entry), and the tools' own figures."""
    k4_bf16 = next(e for e in kernels
                   if e["name"].startswith("gen_batched (K4, bf16 rings"))
    for entry, key, tools in (
            (kernels[0], "K1", None), (kernels[2], "K2", None),
            (kernels[3], "K3", None),
            (kernels[1], "K4", lambda t: t not in BF16_RING_TOOLS),
            (k4_bf16, "K4", lambda t: t in BF16_RING_TOOLS)):
        entry["slice12_launches"] = {
            tool: n[key] for tool, n in s12["launches"].items()
            if n[key] and (tools is None or tools(tool))}
    kernels[0]["bench"] = s12["bench"]
    kernels[1].update(serving_bench=s12["serving_bench"],
                      serving_soak=s12["soak"],
                      slice12_phase_seconds=s12["seconds"])
    kernels[2].update(distill_demo=s12["distill_demo"])


def slice12(torch, np, pt, gk, ghbm, tk, dev, card, t_start):
    """Phases 36-41, the single-card tools at full width. Returns their
    figures."""
    secs, out = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for name, fn in (
                ("36 bench", lambda: phase_bench(torch, gk, ghbm, tk, card)),
                ("37-38 serving_bench", lambda: phase_serving_bench(
                    torch, gk, ghbm, tk, card)),
                ("39 serving_soak", lambda: phase_soak(
                    torch, gk, ghbm, tk, card)),
                ("40 benchmark", lambda: phase_benchmark(
                    torch, pt, gk, ghbm, tk, card)),
                ("41 distill_demo", lambda: phase_distill_demo(
                    torch, gk, ghbm, tk, dev, card, d))):
            t = time.time()
            out[name] = fn()
            secs[name] = time.time() - t
            log(f"phase {name} took {secs[name]:.1f} s, done at "
                f"{time.time() - t_start:.0f} s")
    bench_, sbench, soak, bmark, demo = (out[k] for k in secs)
    launches = {
        "bench": bench_["launches"],
        **{f"serving_bench {k}": v["launches"] for k, v in sbench.items()},
        **{f"serving_soak {k}": v["launches"] for k, v in soak.items()},
        "benchmark": bmark["launches"],
        **{f"distill_demo {k}": v["launches"] for k, v in demo.items()},
    }
    return dict(
        launches=launches,
        bench={k: bench_[k] for k in ("samples_per_s", "us_per_step")},
        serving_bench={k: v["summary"] for k, v in sbench.items()},
        soak={k: v["report"] for k, v in soak.items()},
        benchmark_lines=bmark["lines"],
        distill_demo={k: v["metrics"] for k, v in demo.items()},
        seconds=secs)


def slice11(torch, np, pt, gk, ghbm, dev, t_start, ema_snap):
    """Phases 30-35 at chaconne's full width (the vocoder for the mel
    mode), random weights from SEED. Returns their figures."""
    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    secs, out = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for name, fn in (
                ("30 generate_long", lambda: phase_generate_long(
                    torch, np, pt, gk, ghbm, dev, cfg, params)),
                ("31 reference snapshot", lambda: phase_reference_snapshot(
                    torch, np, pt, gk, dev, d)),
                ("32 reload", lambda: phase_reload(
                    torch, np, pt, gk, ghbm, dev, cfg, params, d)),
                ("33 profile", lambda: phase_profile(
                    torch, np, pt, gk, ghbm, dev, cfg, params, d)),
                ("34 backend plain", lambda: phase_backend_plain(
                    torch, np, pt, gk, ghbm, dev, cfg, params, d)),
                ("35 generate CLI", lambda: phase_generate_cli(
                    torch, np, pt, dev, cfg, params, d,
                    out["31 reference snapshot"][0], ema_snap))):
            t = time.time()
            out[name] = fn()
            secs[name] = time.time() - t
            log(f"phase {name} took {secs[name]:.1f} s, done at "
                f"{time.time() - t_start:.0f} s")
    gl, (_, t_k1), (r_k1, r_k4), prof, _, cli = (out[k] for k in secs)
    p_k4, tr_n, tr_ms, tr_whole, tr_window = prof
    return dict(
        k1={"generate_long": gl["K1"], "torch_snapshot": t_k1,
            "reload": r_k1,
            "generate_cli": {k: v for k, v in cli.items() if k != "k4"}},
        k4={"generate_long": gl["K4"], "reload": r_k4, "profile": p_k4,
            "generate_cli": {"k4": cli["k4"]}},
        profile={"window_ms": tr_window, "k4_launches": tr_n,
                 "k4_device_ms_in_window": tr_ms,
                 "k4_device_ms_whole": tr_whole,
                 "busy_share": tr_ms / tr_window},
        seconds=secs)


def slice10(torch, np, pt, gk, tk, dev, card, t_start, keep, teacher_snap):
    """Phases 27-29."""
    sp = phase_speculation(torch, np, pt, gk, dev, card)
    log(f"phase speculation done at {time.time() - t_start:.0f} s")
    ds = phase_distillation(torch, np, pt, tk, dev, card, keep, teacher_snap)
    log(f"phase distillation done at {time.time() - t_start:.0f} s")
    ss = phase_student_serving(torch, np, pt, dev, card, ds["students"])
    log(f"phase student serving done at {time.time() - t_start:.0f} s")
    return sp, ds, ss


def remainder(torch, np, pt, gk, ghbm, tk, dev, card, t_start, keep):
    """Phases 25 and 26 and their times; phase 25's step-20 snapshot is
    kept in ``keep`` (phase 28's teacher)."""
    rem = phase_training_remainder(torch, np, pt, tk, ghbm, dev, keep)
    log(f"phase training remainder done at {time.time() - t_start:.0f} s")
    hk = phase_hook_k4(torch, pt, ghbm, dev, card)
    log(f"phase hook K4 done at {time.time() - t_start:.0f} s")
    served = phase_serve_ema(torch, np, pt, gk, ghbm, dev, rem["snapshot"])
    log(f"phase serve --ema done at {time.time() - t_start:.0f} s")
    rt = phase_remainder_times(torch, pt, dev, card)
    log(f"phase remainder times done at {time.time() - t_start:.0f} s")
    return rem, hk, served, rt


# ------------------------------------------------------------- slice 13

S13_CONFIG = "chaconne_wide"  # phase 42's config: the training main path's
S13_BATCH = 16                # its global batch
S13_LR = 1e-4
S13_MESHES = (((2, 1), 3), ((1, 2), 3), ((2, 2), 1))  # (data, model), steps
POOL13_LANES, POOL13_CHUNK, POOL13_T0 = 256, 2048, 513  # phase 44's pool
TIME13_T = 4096   # phase 45: chaconne's halo 512 and rf 3070 in 2 blocks
PIPE13_PRIME, PIPE13_N = 8, 64  # phase 45's pipelined rollout
S13_CLI_STEPS = 10            # phase 43: a sharded snapshot at half of them
S13_TIMEOUT = 300             # seconds a group of ranks may take
# the one-rank reference and the mesh sum gradients in other orders, and
# Adam moves an entry whose near-zero gradient flips sign by at most 2 lr a
# step: params within 2 * S13_LR * steps, entries beyond 1e-5 counted
S13_LOSS_RTOL = 1e-5


def _s13_batch(np, cfg):
    rng = np.random.default_rng(SEED)
    return (rng.integers(0, cfg.classes, (S13_BATCH, cfg.item_length),
                         dtype=np.int32),
            rng.integers(0, cfg.classes, (S13_BATCH, cfg.output_length),
                         dtype=np.int32))


def _s13_init(torch, pt, cfg, dev):
    return pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)


def _s13_train(torch, np, pt, dev, shape, steps):
    """Phase 42 on one rank: ``steps`` steps of the data- and
    model-parallel train step on the global batch (the first through
    ``train_step`` with the mesh, the work of ``parallel_train_step`` with
    its gradients kept), K2/K3 launches counted around them."""
    from pytorch_wavenet_tpu_torch.ops.cuda import trunk_kernel as tk
    from pytorch_wavenet_tpu_torch.parallel import sharding, training
    from pytorch_wavenet_tpu_torch.parallel.mesh import make_mesh
    from pytorch_wavenet_tpu_torch.training.optimizers import reference_adam

    cfg = pt.get_config(S13_CONFIG, trunk_kernel=True)
    mesh = make_mesh(*shape)
    x, y = _s13_batch(np, cfg)
    tx = reference_adam(S13_LR)
    p, o = training.make_sharded_train_state(
        cfg, _s13_init(torch, pt, cfg, dev), tx, mesh)
    tk.fwd_launches = tk.bwd_launches = 0
    xb, yb = training.put_batch(mesh, x, y, dev)
    loss, g = pt.train_step(p, o, cfg, tx, xb, yb, mesh=mesh)
    losses = [loss]
    for _ in range(steps - 1):
        losses.append(training.parallel_train_step(
            p, o, cfg, tx, x, y, mesh=mesh, device=dev)[2])
    torch.cuda.synchronize()
    launches = [tk.fwd_launches, tk.bwd_launches]
    cpu = lambda t: {k: {kk: v.cpu() for kk, v in d.items()}
                     for k, d in t.items()}
    return {"losses": [float(v) for v in losses], "launches": launches,
            "grads": cpu(sharding.gather_params(g, cfg, mesh)),
            "params": cpu(sharding.gather_params(p, cfg, mesh))}


def _s13_pool_inputs(torch, np, cfg):
    rng = np.random.default_rng(SEED)
    prime = rng.integers(0, cfg.classes, (POOL13_LANES, POOL13_T0),
                         dtype=np.int32)
    temps, seeds, clocks = _lane_rows(torch, "cpu", POOL13_LANES)
    return prime, temps, seeds, clocks


def _s13_pool_state(torch, np, pt, dev, cfg, params):
    """The whole pool after a prime of POOL13_T0 classes a lane (t =
    POOL13_T0), and its lane rows."""
    prime, temps, seeds, clocks = _s13_pool_inputs(torch, np, cfg)
    _, _, st = pt.generate_fast_batched(
        params, cfg, 0, 1, prime, temperature=temps, lane_seed=seeds,
        lane_clock=clocks, return_state=True, fuse_res=True, skip_slab=True,
        device=dev)
    return st, temps, seeds, clocks


def _s13_pool(torch, np, pt, dev):
    """Phase 44 on one rank: ``sharded_pool_step`` on this rank's 128
    lanes, one resumed POOL13_CHUNK-step K4 launch counted; the classes
    and the ring gathered."""
    from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as ghbm
    from pytorch_wavenet_tpu_torch.parallel import training
    from pytorch_wavenet_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                         all_gather,
                                                         make_mesh)

    cfg = pt.get_config("chaconne")
    params = _s13_init(torch, pt, cfg, dev)
    mesh = make_mesh(2, 1)
    st, temps, seeds, clocks = _s13_pool_state(torch, np, pt, dev, cfg,
                                               params)
    local = training.shard_pool_state(st, mesh)
    del st
    ghbm.launches = 0
    t = time.time()
    cls, st = training.sharded_pool_step(
        params, cfg, mesh, 0, POOL13_CHUNK, local, temperature=temps,
        lane_seed=seeds, lane_clock=clocks, fuse_res=True, skip_slab=True,
        device=dev)
    torch.cuda.synchronize()
    secs = time.time() - t
    launches = ghbm.launches
    return {"cls": cls.cpu(), "launches": launches, "seconds": secs,
            "ring": all_gather(st.ring, mesh, DATA_AXIS, dim=1).cpu(),
            "next": all_gather(st.cls, mesh, DATA_AXIS).cpu(), "t": st.t}


def _s13_time_inputs(np, cfg):
    rng = np.random.default_rng(SEED)
    return (rng.integers(0, cfg.classes, (1, TIME13_T), dtype=np.int32),
            rng.integers(0, cfg.classes, (1, TIME13_T), dtype=np.int32))


def _s13_time(torch, np, pt, dev):
    """Phase 45 on one rank: ``time_sharded_loss`` at chaconne over 2 time
    blocks (the halo through gloo), the loss and its gradients."""
    from pytorch_wavenet_tpu_torch.parallel.mesh import make_mesh
    from pytorch_wavenet_tpu_torch.parallel.time_sharding import (
        time_sharded_loss)
    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

    cfg = pt.get_config("chaconne")
    params = _s13_init(torch, pt, cfg, dev)
    leaves = [v.requires_grad_(True) for _, v in _leaves(params)]
    x, tgt = _s13_time_inputs(np, cfg)
    t = time.time()
    loss = time_sharded_loss(params, cfg, x, tgt, make_mesh(2, 1))
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return {"loss": float(loss.detach()), "seconds": time.time() - t,
            "grads": [v.cpu() for v in grads]}


def _s13_pipe(torch, np, pt, dev):
    """Phase 45 on one rank: ``generate_pipelined`` at chaconne over 2
    stages (15 layers each), 4 streams at T = 0."""
    from pytorch_wavenet_tpu_torch.parallel.pipeline import (
        generate_pipelined, make_pipeline_mesh)

    cfg = pt.get_config("chaconne")
    params = _s13_init(torch, pt, cfg, dev)
    prime = np.random.default_rng(SEED).integers(0, cfg.classes,
                                                 (4, PIPE13_PRIME))
    t = time.time()
    _, cls = generate_pipelined(params, cfg, make_pipeline_mesh(2), SEED,
                                PIPE13_N, prime, temperature=0.0, device=dev)
    return {"cls": cls.cpu(), "prime": prime, "seconds": time.time() - t}


def _s13_rank(rank, world, store, out_dir, jobs):
    """One rank of phases 42, 44 and 45 (a spawned process; the ranks share
    the card through gloo): each job's result saved to
    ``{out_dir}/{job}_r{rank}.pt``. Any exception exits nonzero."""
    import numpy as np
    import torch

    import pytorch_wavenet_tpu_torch as pt
    from pytorch_wavenet_tpu_torch.parallel.mesh import init_distributed

    dev = init_distributed("cuda", init_method=f"file://{store}", rank=rank,
                           world_size=world, local_rank=rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for job in jobs:
        if job.startswith("train"):
            shape, steps = dict((f"train{d}x{m}", ((d, m), s))
                                for (d, m), s in S13_MESHES)[job]
            out = _s13_train(torch, np, pt, dev, shape, steps)
        elif job == "pool46":
            out = _s14_pool(torch, np, pt, dev, rank)
        else:
            out = {"pool": _s13_pool, "time": _s13_time,
                   "pipe": _s13_pipe}[job](torch, np, pt, dev)
        torch.save(out, os.path.join(out_dir, f"{job}_r{rank}.pt"))
    torch.distributed.destroy_process_group()


def _s13_spawn(groups, out_dir):
    """Start every group of ranks (``[(world, jobs), ...]``) at once, each
    on its own ``file://`` store; fail unless every rank exits 0 within
    S13_TIMEOUT (ranks still running then are killed)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = []
    for g, (world, jobs) in enumerate(groups):
        store = os.path.join(out_dir, f"store{g}")
        procs += [(f"{world} ranks {jobs} rank {r}", ctx.Process(
            target=_s13_rank, args=(r, world, store, out_dir, jobs)))
            for r in range(world)]
    for _, p in procs:
        p.start()
    deadline = time.time() + S13_TIMEOUT
    for _, p in procs:
        p.join(timeout=max(deadline - time.time(), 1))
    for _, p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    bad = [(name, p.exitcode) for name, p in procs if p.exitcode != 0]
    check(not bad, f"ranks failed or timed out: {bad}")


def _s13_load(torch, out_dir, job, rank=0):
    return torch.load(os.path.join(out_dir, f"{job}_r{rank}.pt"),
                      weights_only=False)


def phase_parallel_train(torch, np, pt, dev, card, out_dir):
    """Phase 42: the ranks' results against the one-rank ``train_step`` on
    the global batch (the same params from SEED, the same batch): losses
    within S13_LOSS_RTOL, the first step's gradients within GRAD_TOL x
    max(1, scale), params within 2 lr a step; K2/K3 launched once a step
    on every rank."""
    from pytorch_wavenet_tpu_torch.training.optimizers import (_leaves, _map,
                                                               reference_adam)

    cfg = pt.get_config(S13_CONFIG, trunk_kernel=True)
    x, y = _s13_batch(np, cfg)
    p = _map(lambda v: v.requires_grad_(True), _s13_init(torch, pt, cfg,
                                                         dev))
    tx = reference_adam(S13_LR)
    o = tx.init(p)
    ref_losses, ref_params = [], {}
    for i in range(max(s for _, s in S13_MESHES)):
        loss, g = pt.train_step(p, o, cfg, tx, torch.from_numpy(x).to(dev),
                                torch.from_numpy(y).to(dev))
        if i == 0:
            ref_grads = [v.to("cpu", copy=True) for _, v in _leaves(g)]
        ref_losses.append(float(loss))
        ref_params[i + 1] = [v.detach().to("cpu", copy=True)
                             for _, v in _leaves(p)]
    out = {}
    for (d, m), steps in S13_MESHES:
        job = f"train{d}x{m}"
        ranks = [_s13_load(torch, out_dir, job, r) for r in range(d * m)]
        got = ranks[0]
        launches = [r["launches"] for r in ranks]
        check(all(n == [steps, steps] for n in launches),
              f"{job}: K2/K3 launches per rank {launches}, expected "
              f"{steps} each")
        rel = max(abs(a - b) / abs(b) for a, b in
                  zip(got["losses"], ref_losses))
        check(rel <= S13_LOSS_RTOL, f"{job}: losses {got['losses']} against "
              f"one rank's {ref_losses[:steps]} (rel {rel:.3g})")
        g_err = _grad_err([v for _, v in _leaves(got["grads"])], ref_grads)
        check(g_err <= GRAD_TOL, f"{job}: gradients off by {g_err:.3g} of "
              f"their scale")
        diffs = [(a - b).abs() for (_, a), b in
                 zip(_leaves(got["params"]), ref_params[steps])]
        p_err = max(float(v.max()) for v in diffs)
        beyond = sum(int((v > 1e-5).sum()) for v in diffs)
        total = sum(v.numel() for v in diffs)
        bound = 2 * S13_LR * steps * (1 + 1e-3)  # f32 rounding of 2 lr
        check(p_err <= bound, f"{job}: params off by {p_err:.3g} (bound "
              f"{bound:.3g})")
        log(f"[parallel] parallel_train_step {d}x{m} at {S13_CONFIG}, global "
            f"batch {S13_BATCH}, {steps} step(s), {d * m} ranks sharing "
            f"the card through gloo [{card}]: K2/K3 launches per rank "
            f"{launches}; losses rel {rel:.3g} of one rank's, first step's "
            f"gradients {g_err:.3g} of scale, params within {p_err:.3g} "
            f"({beyond} of {total} entries beyond 1e-5)")
        out[f"{d}x{m}"] = dict(launches=launches, loss_rel_err=rel,
                               grad_err=g_err, param_err=p_err,
                               param_entries_beyond_1e5=beyond)
    return out


def phase_pool_step_sharded(torch, np, pt, dev, card, out_dir):
    """Phase 44: the 2 ranks' ``sharded_pool_step`` (128 lanes each)
    against one unsharded K4 call on all 256 lanes from the same state:
    classes, ring, next classes and clock bitwise."""
    cfg = pt.get_config("chaconne")
    params = _s13_init(torch, pt, cfg, dev)
    st, temps, seeds, clocks = _s13_pool_state(torch, np, pt, dev, cfg,
                                               params)
    _, cls, ref = pt.generate_fast_batched(
        params, cfg, 0, POOL13_CHUNK, None, temperature=temps, state=st,
        lane_seed=seeds, lane_clock=clocks, return_state=True,
        fuse_res=True, skip_slab=True, device=dev)
    ranks = [_s13_load(torch, out_dir, "pool", r) for r in range(2)]
    got = ranks[0]
    launches = [r["launches"] for r in ranks]
    check(launches == [1, 1], f"sharded_pool_step: K4 launches per rank "
          f"{launches}, expected 1 each")
    check(torch.equal(got["cls"], cls.cpu()), "sharded pool classes differ "
          "from the unsharded call")
    check(torch.equal(got["ring"], ref.ring.cpu()), "sharded pool ring "
          "differs from the unsharded call")
    check(torch.equal(got["next"], ref.cls.cpu()) and got["t"] == ref.t,
          "sharded pool state differs from the unsharded call")
    log(f"[parallel] sharded_pool_step at chaconne, {POOL13_LANES} lanes over "
        f"2 ranks sharing the card through gloo, a resumed {POOL13_CHUNK}-step "
        f"chunk at t0 = {POOL13_T0} (fuse_res + skip_slab, hot lanes seeded): "
        f"K4 launches per rank {launches}; classes, ring and next classes "
        f"bitwise equal to one K4 call on all {POOL13_LANES} lanes; "
        f"{max(r['seconds'] for r in ranks):.2f} s per rank with the gather "
        f"[{card}]")
    return dict(launches=launches, seconds=[r["seconds"] for r in ranks])


def phase_time_pipe(torch, np, pt, dev, card, out_dir):
    """Phase 45a: the time-sharded loss and gradients against the
    unsharded ones, and the pipelined rollout against ``generate_fast``
    on each group, bitwise (all plain PyTorch on the card)."""
    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

    cfg = pt.get_config("chaconne")
    params = _s13_init(torch, pt, cfg, dev)
    leaves = [v.requires_grad_(True) for _, v in _leaves(params)]
    x, tgt = (torch.from_numpy(a).to(dev) for a in _s13_time_inputs(np, cfg))
    rf = cfg.receptive_field
    logits = pt.wavenet_logits(params, cfg, x, out_len=TIME13_T)
    nll = -torch.gather(torch.log_softmax(logits, -1), -1,
                        tgt[..., None].long())[..., 0]
    loss = nll[:, rf - 1:].sum() / (TIME13_T - rf + 1)
    grads = torch.autograd.grad(loss, leaves)
    got = _s13_load(torch, out_dir, "time")
    loss = float(loss.detach())
    rel = abs(got["loss"] - loss) / abs(loss)
    g_err = _grad_err(got["grads"], [v.cpu() for v in grads])
    check(rel <= S13_LOSS_RTOL and g_err <= GRAD_TOL,
          f"time_sharded_loss: loss rel {rel:.3g}, gradients {g_err:.3g}")
    pipe = _s13_load(torch, out_dir, "pipe")
    want = torch.cat([pt.generate_fast(
        params, cfg, None, PIPE13_N, pipe["prime"][2 * g:2 * g + 2],
        temperature=0.0, device=dev)[1].cpu() for g in range(2)])
    check(torch.equal(pipe["cls"], want), "generate_pipelined differs from "
          "generate_fast on its groups")
    log(f"[parallel] time_sharded_loss at chaconne, T {TIME13_T} in 2 blocks "
        f"(halo 512 through gloo): loss rel {rel:.3g}, gradients "
        f"{g_err:.3g} of scale against the unsharded trunk, "
        f"{got['seconds']:.2f} s; generate_pipelined at chaconne over 2 "
        f"stages, 4 streams, {PIPE13_N} samples after {PIPE13_PRIME}: "
        f"bitwise generate_fast on each group, {pipe['seconds']:.2f} s "
        f"[{card}]")
    return dict(time_loss_rel=rel, time_grad_err=g_err,
                time_seconds=got["seconds"], pipe_seconds=pipe["seconds"])


def _torchrun(args, tag):
    """The train CLI on 2 ranks of this card under ``torch.distributed.run``
    (its output logged under ``tag``); returns rank 0's launches line."""
    import re

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m",
           "pytorch_wavenet_tpu_torch.training.train"] + args
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                       text=True, timeout=S13_TIMEOUT)
    for line in (r.stdout + r.stderr).splitlines():
        log(f"[{tag}] {line}")
    check(r.returncode == 0, f"{tag}: torchrun exited {r.returncode}")
    m = re.search(r"kernel launches per rank: K2 \[(.*?)\], K3 \[(.*?)\], "
                  r"K4 \[(.*?)\]", r.stdout)
    check(m is not None, f"{tag}: no launches line")
    return [[int(v) for v in g.split(",")] for g in m.groups()]


def phase_train_cli_mesh(torch, np, pt, tk, card):
    """Phase 43: the train CLI at chaconne_wide on 2 ranks (1 x 2: the head
    split) for S13_CLI_STEPS steps with a sharded snapshot halfway; a
    2-rank run resumed from it ends bitwise at the uninterrupted run's
    final snapshot; a 1-rank ``--resume`` loads the sharded snapshot."""
    import glob
    import shutil

    from pytorch_wavenet_tpu_torch.training import train
    from pytorch_wavenet_tpu_torch.utils.checkpoints import (
        load_checkpoint, sharded_checkpoint_path)

    here = os.path.dirname(os.path.abspath(__file__))
    wavs = sorted(glob.glob(os.path.join(here, "examples", "*.wav")))
    half = S13_CLI_STEPS // 2
    name = f"{S13_CONFIG}_model"
    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "audio")
        os.makedirs(data)
        for w in wavs:
            shutil.copy(w, data)
        base = ["--data-dir", data, "--config", S13_CONFIG, "--batch-size",
                str(S13_BATCH), "--seed", str(SEED), "--lr", "1e-3",
                "--log-interval", str(half), "--validation-interval",
                "1000", "--snapshot-interval", str(half)]
        mesh = ["--mesh-data", "1", "--mesh-model", "2"]
        t = time.time()
        a = _torchrun(base + mesh + ["--snapshot-path", os.path.join(d, "a"),
                                     "--max-steps", str(S13_CLI_STEPS)],
                      "train CLI 2 ranks")
        secs = time.time() - t
        for r in ("b", "c"):
            shutil.copytree(sharded_checkpoint_path(os.path.join(d, "a"),
                                                    name, half),
                            sharded_checkpoint_path(os.path.join(d, r), name,
                                                    half))
        b = _torchrun(base + mesh + ["--snapshot-path", os.path.join(d, "b"),
                                     "--max-steps", str(S13_CLI_STEPS),
                                     "--resume"], "train CLI 2 ranks resumed")
        ends = [load_checkpoint(sharded_checkpoint_path(
            os.path.join(d, r), name, S13_CLI_STEPS), device="cpu")
            for r in ("a", "b")]
        tk.fwd_launches = tk.bwd_launches = 0
        one = train.main(base + ["--snapshot-path", os.path.join(d, "c"),
                                 "--max-steps", str(half + 2), "--resume"])
        torch.cuda.synchronize()
        c = [tk.fwd_launches, tk.bwd_launches]
    check(a[:2] == [[S13_CLI_STEPS] * 2] * 2, f"train CLI 2 ranks: K2/K3 "
          f"launches per rank {a[:2]}, expected {S13_CLI_STEPS} each")
    check(b[:2] == [[half] * 2] * 2, f"resumed: K2/K3 launches per rank "
          f"{b[:2]}, expected {half} each")
    check(c == [2, 2] and one.step == half + 2 and one.mesh is None,
          f"1-rank --resume from the sharded snapshot: step {one.step}, "
          f"K2/K3 launches {c}")
    pa, pb = (pt.to_numpy_params(e["params"]) for e in ends)
    same = all(np.array_equal(pa[k][kk], pb[k][kk]) for k in pa
               for kk in pa[k])
    check(same and ends[0]["step"] == ends[1]["step"] == S13_CLI_STEPS,
          "the resumed 2-rank run does not end bitwise at the uninterrupted "
          "run")
    log(f"[parallel] train CLI at {S13_CONFIG} under torchrun, 2 ranks (1 x "
        f"2) sharing the card through gloo, batch {S13_BATCH}: "
        f"{S13_CLI_STEPS} steps in {secs:.1f} s (process start, dataset, "
        f"sharded snapshots at {half} and {S13_CLI_STEPS}), K2/K3 launches per "
        f"rank {a[0]}/{a[1]}; resumed from the step-{half} sharded snapshot: "
        f"launches {b[0]}/{b[1]}, the step-{S13_CLI_STEPS} snapshot bitwise the "
        f"uninterrupted run's; 1-rank --resume from it to step {half + 2}: "
        f"K2/K3 launches {c} [{card}]")
    return dict(two_ranks=a[:2], resumed=b[:2], one_rank=c, seconds=secs)


def phase_scaling_bench():
    """Phase 45b: ``scripts.scaling_bench`` at chaconne on 1 and 2 ranks
    (its ranks' K2/K3 launches from their own counts)."""
    from pytorch_wavenet_tpu_torch.scripts import scaling_bench

    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lines = scaling_bench.main(["--config", "chaconne", "--max-ranks",
                                    "2", "--steps", "5"])
    for line in buf.getvalue().splitlines():
        log(f"[scaling_bench] {line}")
    check([r["data"] for r in lines] == [1, 2], f"scaling_bench sizes "
          f"{[r['data'] for r in lines]}")
    for r in lines:
        want = [6] * r["data"]  # a warm step and 5 timed, on every rank
        check(r["k2_launches"] == want and r["k3_launches"] == want,
              f"scaling_bench {r['data']} ranks: K2/K3 launches "
              f"{r['k2_launches']}/{r['k3_launches']}, expected {want}")
    return lines


def slice13(torch, np, pt, tk, dev, card, t_start, d, extra=()):
    """Phases 42-45: the multi-rank layer with its ranks sharing the card
    through gloo, their results under ``d``; ``extra`` jobs join the
    2-rank group (phase 46's). Returns their figures."""
    secs, out = {}, {}
    t = time.time()
    jobs2 = [f"train{a}x{b}" for (a, b), _ in S13_MESHES if a * b == 2]
    _s13_spawn([(2, jobs2 + ["pool", "time", "pipe"] + list(extra)),
                (4, ["train2x2"])], d)
    secs["ranks"] = time.time() - t
    log(f"phases 42, 44, 45{', 46' if extra else ''}: 6 ranks in two "
        f"groups took {secs['ranks']:.1f} s, done at "
        f"{time.time() - t_start:.0f} s")
    for name, fn in (
            ("42 parallel_train_step", lambda: phase_parallel_train(
                torch, np, pt, dev, card, d)),
            ("44 sharded_pool_step", lambda: phase_pool_step_sharded(
                torch, np, pt, dev, card, d)),
            ("45 time sharding, pipeline", lambda: phase_time_pipe(
                torch, np, pt, dev, card, d)),
            ("43 train CLI", lambda: phase_train_cli_mesh(
                torch, np, pt, tk, card)),
            ("45 scaling_bench", phase_scaling_bench)):
        t = time.time()
        out[name] = fn()
        secs[name] = time.time() - t
        log(f"phase {name} took {secs[name]:.1f} s, done at "
            f"{time.time() - t_start:.0f} s")
    return dict(train=out["42 parallel_train_step"],
                pool=out["44 sharded_pool_step"],
                time_pipe=out["45 time sharding, pipeline"],
                cli=out["43 train CLI"],
                scaling=out["45 scaling_bench"], seconds=secs)


def slice13_entries(kernels, s13):
    """This slice's main paths on the kernels line: K2's and K3's launches
    on every rank in phases 42, 43 and 45, K4's in phase 44, and the
    phases' figures."""
    cli = s13["cli"]
    for entry, i, key in ((kernels[2], 0, "k2_launches"),
                          (kernels[3], 1, "k3_launches")):
        per_rank = {f"parallel_train_step {k}": [n[i] for n in v["launches"]]
                    for k, v in s13["train"].items()}
        per_rank["train CLI 1x2"] = cli["two_ranks"][i]
        per_rank["train CLI 1x2 resumed"] = cli["resumed"][i]
        per_rank["train CLI 1 rank --resume"] = [cli["one_rank"][i]]
        for r in s13["scaling"]:
            per_rank[f"scaling_bench {r['data']} ranks"] = r[key]
        entry["slice13_launches_per_rank"] = per_rank
    kernels[1]["slice13_launches_per_rank"] = {
        "sharded_pool_step 2 ranks": s13["pool"]["launches"]}
    kernels[2]["slice13"] = {
        "parallel_train_step": {k: {m: v[m] for m in (
            "loss_rel_err", "grad_err", "param_err")}
            for k, v in s13["train"].items()},
        "scaling_bench": [{k: r[k] for k in ("data", "batch", "ms",
                                             "audio_s", "scaling_pct")}
                          for r in s13["scaling"]],
        "time_pipe": s13["time_pipe"], "phase_seconds": s13["seconds"]}


# ------------------------------------------------------------- slice 14

S14_LANES, S14_CHUNK = 256, 2048  # phase 46's pool: 128 lanes a rank
S14_REQS, S14_N = 64, 16000       # its load, half admitted mid-flight
S14_TEMPS = (0.0, 0.9, 1.0)
S14_BURST, S14_BURST_N = 130, 2049  # after update_params: both ranks' lanes
S14_VOC_LANES, S14_VOC_REQS, S14_VOC_N = 8, 8, 4096  # frames mode, hop 256
S14_SERVE_N = 4096                # the torchrun server's 4 requests


def _s14_inputs(np, cfg):
    """The 64 requests: full-receptive-field primes, temperatures cycling
    through S14_TEMPS, distinct seeds."""
    rng = np.random.default_rng(SEED + 46)
    primes = rng.integers(0, cfg.classes, (S14_REQS, cfg.receptive_field),
                          dtype=np.int32)
    temps = np.asarray([S14_TEMPS[i % 3] for i in range(S14_REQS)],
                       np.float32)
    return primes, temps, np.arange(S14_REQS, dtype=np.int32) + 4600


def _s14_voc_inputs(np, cfg):
    """The vocoder case's frames (one timeline a request), temperatures
    and seeds."""
    rng = np.random.default_rng(SEED + 47)
    frames = (0.5 * rng.standard_normal(
        (S14_VOC_REQS, S14_VOC_N // 256 + 1, cfg.cond_channels))
    ).astype(np.float32)
    temps = np.asarray([S14_TEMPS[i % 3] for i in range(S14_VOC_REQS)],
                       np.float32)
    return frames, temps, np.arange(S14_VOC_REQS, dtype=np.int32) + 4700


def _s14_params_b(torch, pt, cfg, dev):
    """The weights phase 46's update_params installs."""
    return pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED + 1), dev)


def _s14_drive(np, b, primes, temps, seeds):
    """Phase 46's load on a pool: the first half of the requests at once,
    the second half once the pool's first chunk has been handed out (so
    they join mid-flight). Returns (classes, times to first audio, wall
    seconds)."""
    first = [None] * len(primes)
    handles = []

    def submit(i):
        t = time.perf_counter()

        def on_chunk(_c, i=i, t=t):
            if first[i] is None:
                first[i] = time.perf_counter() - t

        handles.append(b.submit(primes[i], S14_N, temperature=float(temps[i]),
                                seed=int(seeds[i]), on_chunk=on_chunk))

    t0 = time.perf_counter()
    half = len(primes) // 2
    for i in range(half):
        submit(i)
    while (sum(p.size for p in handles[0]._parts) < 1 + S14_CHUNK
           and not handles[0].done()):
        time.sleep(0.005)
    for i in range(half, len(primes)):
        submit(i)
    cls = [h.result(timeout=900)[1] for h in handles]
    return cls, first, time.perf_counter() - t0


def _s14_barred(ghbm):
    """Bar K4's plain version in this process (the card path launches the
    kernel); returns the list its calls land in."""
    calls = []

    def barred(*a, **k):
        calls.append(1)
        raise RuntimeError("the plain version ran on the card path")

    ghbm.batched_plain = barred
    return calls


def _s14_pool(torch, np, pt, dev, rank):
    """Phase 46 on one rank: the pool on a 2-rank mesh at chaconne (rank 0
    schedules, rank 1 follows), then the vocoder's frames-mode pool; each
    rank's K4 launches counted from zero around each pool."""
    from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as ghbm
    from pytorch_wavenet_tpu_torch.parallel.mesh import make_mesh
    from pytorch_wavenet_tpu_torch.serving import (ContinuousBatcher,
                                                   follow_pool)

    mesh = make_mesh(2, 1)
    cfg = pt.get_config("chaconne")
    params = _s13_init(torch, pt, cfg, dev)
    vcfg, vparams = _vocoder(torch, pt, dev)
    opts = dict(lanes=S14_LANES, chunk=S14_CHUNK, fuse_res=True,
                skip_slab=True, device=dev, mesh=mesh)
    vopts = dict(opts, lanes=S14_VOC_LANES, cond_hop=256)
    plain = _s14_barred(ghbm)
    out = {}
    t = time.time()
    if rank > 0:
        for name, c, p, o in (("chaconne", cfg, params, opts),
                              ("vocoder", vcfg, vparams, vopts)):
            ghbm.launches = 0
            counts = follow_pool(p, c, **o)
            torch.cuda.synchronize()
            out[name] = dict(counts, launches=ghbm.launches)
        out.update(plain_calls=len(plain), seconds=time.time() - t)
        return out
    primes, temps, seeds = _s14_inputs(np, cfg)
    ghbm.launches = 0
    b = ContinuousBatcher(params, cfg, **opts)
    try:
        b.prewarm()
        cls, first, wall = _s14_drive(np, b, primes, temps, seeds)
        stats = b.stats()
        # update_params while a request streams; the burst after the event
        # covers the lanes of both ranks (the JAX lane choice fills rank
        # 1's block first)
        x = b.submit([cfg.classes // 2], 3 * S14_CHUNK, temperature=0.0,
                     seed=1)
        while sum(p.size for p in x._parts) < 1 + S14_CHUNK and not x.done():
            time.sleep(0.005)
        installed = b.update_params(_s14_params_b(torch, pt, cfg,
                                                  dev)).wait(300)
        hs = [b.submit([cfg.classes // 2], S14_BURST_N,
                       temperature=S14_TEMPS[i % 3], seed=9000 + i)
              for i in range(S14_BURST)]
        burst = [h.result(timeout=900)[1] for h in hs]
        x.result(timeout=900)
        after = b.stats()
    finally:
        b.close()
    torch.cuda.synchronize()
    out["chaconne"] = dict(cls=np.stack(cls), first=first, wall=wall,
                           stats=stats, after=after, installed=installed,
                           burst=np.stack(burst), launches=ghbm.launches)
    frames, vtemps, vseeds = _s14_voc_inputs(np, vcfg)
    ghbm.launches = 0
    vb = ContinuousBatcher(vparams, vcfg, **vopts)
    try:
        vb.prewarm()
        t0 = time.perf_counter()
        hs = [vb.submit([vcfg.classes // 2], S14_VOC_N,
                        temperature=float(vtemps[i]), seed=int(vseeds[i]),
                        cond_frames=frames[i]) for i in range(S14_VOC_REQS)]
        vcls = [h.result(timeout=900)[1] for h in hs]
        vwall = time.perf_counter() - t0
        vstats = vb.stats()
    finally:
        vb.close()
    torch.cuda.synchronize()
    out["vocoder"] = dict(cls=np.stack(vcls), wall=vwall, stats=vstats,
                          launches=ghbm.launches)
    out.update(plain_calls=len(plain), seconds=time.time() - t)
    return out


def _s14_served(first, wall, n_req, n):
    ttfa = sorted(first)
    return dict(samples_per_s=n_req * n / wall, wall_s=wall,
                ttfa_median_ms=1e3 * ttfa[n_req // 2],
                ttfa_max_ms=1e3 * ttfa[-1])


def phase_pool_mesh(torch, np, pt, ghbm, dev, card, out_dir, one_rank):
    """Phase 46a: the 2 ranks' pools against one K4 call of the same
    requests (bitwise), the same load on a one-rank pool in this process
    (bitwise, timed), the update and the vocoder's frames mode (bitwise),
    each rank's K4 launches against its pool steps and prime calls, and
    the cross-rank bytes. ``one_rank``: phases 8 and 24's served figures
    (None when they did not run)."""
    from pytorch_wavenet_tpu_torch.ops.mel import (expand_frames_window,
                                                   frames_window_len)
    from pytorch_wavenet_tpu_torch.serving import ContinuousBatcher

    ranks = [_s13_load(torch, out_dir, "pool46", r) for r in range(2)]
    r0, r1 = ranks
    check(r0["plain_calls"] == r1["plain_calls"] == 0,
          "the plain version ran on a rank's pool")
    cfg = pt.get_config("chaconne")
    params = _s13_init(torch, pt, cfg, dev)
    primes, temps, seeds = _s14_inputs(np, cfg)
    c = r0["chaconne"]
    # the reference: one K4 call with the 64 requests as its lanes
    _, ref = pt.generate_fast_batched(
        params, cfg, 0, S14_N, primes, temperature=temps, lane_seed=seeds,
        fuse_res=True, skip_slab=True, device=dev)
    ref = ref.cpu().numpy()
    diff = [i for i in range(S14_REQS) if not np.array_equal(c["cls"][i],
                                                             ref[i])]
    check(not diff, f"mesh pool requests {diff} differ from one K4 call")
    # the same load on one rank, in this process
    b = ContinuousBatcher(params, cfg, lanes=S14_LANES, chunk=S14_CHUNK,
                          fuse_res=True, skip_slab=True, device=dev)
    try:
        b.prewarm()
        cls1, first1, wall1 = _s14_drive(np, b, primes, temps, seeds)
    finally:
        b.close()
    diff = [i for i in range(S14_REQS) if not np.array_equal(cls1[i],
                                                             ref[i])]
    check(not diff, f"one-rank pool requests {diff} differ from one K4 call")
    mesh_served = _s14_served(c["first"], c["wall"], S14_REQS, S14_N)
    one_served = _s14_served(first1, wall1, S14_REQS, S14_N)
    # update_params: the burst after the event, on the new weights
    check(c["installed"], "update_params: the event was not set")
    _, bref = pt.generate_fast_batched(
        _s14_params_b(torch, pt, cfg, dev), cfg, 0, S14_BURST_N,
        [[cfg.classes // 2]] * S14_BURST,
        temperature=np.asarray([S14_TEMPS[i % 3] for i in range(S14_BURST)],
                               np.float32),
        lane_seed=[9000 + i for i in range(S14_BURST)], fuse_res=True,
        skip_slab=True, device=dev)
    check(np.array_equal(c["burst"], bref.cpu().numpy()),
          "requests after update_params differ from K4 on the new weights")
    # the vocoder, frames mode: rows expanded over each whole timeline
    vcfg, vparams = _vocoder(torch, pt, dev)
    frames, vtemps, vseeds = _s14_voc_inputs(np, vcfg)
    need = frames_window_len(S14_VOC_N, 256)
    idx = np.minimum(np.arange(max(frames.shape[1], need)),
                     frames.shape[1] - 1)
    rows = expand_frames_window(
        None, torch.from_numpy(frames[:, idx]).to(dev), 256,
        torch.zeros(S14_VOC_REQS, dtype=torch.long, device=dev), S14_VOC_N)
    _, vref = pt.generate_fast_batched(
        vparams, vcfg, 0, S14_VOC_N, [[vcfg.classes // 2]] * S14_VOC_REQS,
        temperature=vtemps, lane_seed=vseeds, cond=rows, fuse_res=True,
        skip_slab=True, device=dev)
    v = r0["vocoder"]
    check(np.array_equal(v["cls"], vref.cpu().numpy()),
          "vocoder frames-mode requests on the mesh differ from one K4 call")
    # each rank's K4 launches: a prewarm step (two with cond), one a pool
    # step, one a prime call of its own
    launches = {}
    for name, st, warm in (("chaconne", c["after"], 1),
                           ("vocoder", v["stats"], 2)):
        f = r1[name]
        got = [r0[name]["launches"], f["launches"]]
        want = [warm + st["pool_steps"] + st["prime_calls"],
                warm + f["pool_steps"] + f["prime_calls"]]
        check(got == want and f["pool_steps"] == st["pool_steps"]
              and min(got) > 0, f"{name}: K4 launches per rank {got}, "
              f"expected {want} (pool steps {st['pool_steps']}, "
              f"{f['pool_steps']})")
        launches[name] = got
    st = c["stats"]
    per_step = st["mesh_step_bytes"] / st["pool_steps"]
    per_admit = st["mesh_admit_bytes"] / st["admitted"]
    log(f"[mesh pool] chaconne, {S14_LANES} lanes over 2 ranks sharing the "
        f"card through gloo, chunk {S14_CHUNK}, fuse_res + skip_slab: "
        f"{S14_REQS} requests of {S14_N} (full-rf primes, T 0/0.9/1.0 "
        f"seeded, half admitted mid-flight) bitwise equal to one K4 call of "
        f"the {S14_REQS} as lanes, and to the one-rank pool's; "
        f"{S14_BURST} requests after update_params (lanes of both ranks) "
        f"bitwise K4 on the new weights; the vocoder's frames mode, "
        f"{S14_VOC_REQS} requests of {S14_VOC_N} over {S14_VOC_LANES} "
        f"lanes, bitwise [{card}]")
    log(f"[mesh pool] K4 launches per rank: chaconne {launches['chaconne']}, "
        f"vocoder {launches['vocoder']} (a prewarm step, the pool steps, "
        f"the rank's prime calls); plain calls 0")
    log(f"[mesh pool] cross-rank bytes: {per_step:.0f} a pool step (header, "
        f"lane rows when changed, rank 1's {S14_LANES // 2} x chunk classes "
        f"as uint8), {per_admit:.0f} an admission (prime classes), weights "
        f"{c['after']['mesh_params_bytes']} B at install and update; "
        f"rank 0 waited {st['t_gather']:.3f} s for rank 1 over "
        f"{st['pool_steps']} steps")
    for tag, s in (("2 ranks", mesh_served), ("1 rank, same load",
                                              one_served)):
        log(f"[mesh pool] {tag}: {s['samples_per_s']:.0f} samples/s served, "
            f"time to first audio median {s['ttfa_median_ms']:.0f} ms, max "
            f"{s['ttfa_max_ms']:.0f} ms, {s['wall_s']:.2f} s [{card}]")
    for tag, s in (one_rank or {}).items():
        log(f"[mesh pool] beside it, {tag} (one rank through HTTP, 64 "
            f"unprimed requests at once): {s['samples_per_s']:.0f} samples/s, "
            f"time to first audio median {s['ttfa_median_ms']:.0f} ms, max "
            f"{s['ttfa_max_ms']:.0f} ms")
    return dict(launches=launches, bytes_per_step=per_step,
                bytes_per_admission=per_admit,
                params_bytes=c["after"]["mesh_params_bytes"],
                gather_wait_s=st["t_gather"], pool_steps=st["pool_steps"],
                mesh=mesh_served, one_rank=one_served,
                rank_seconds=[r["seconds"] for r in ranks])


def _s14_reader(proc, lines, found):
    """Collect a torchrun child's output lines; set ``found`` once rank
    0's pid and URL are known."""
    for line in proc.stdout:
        lines.append(line)
        if "(pid " in line:
            found["pid"] = int(line.split("(pid ")[1].split(")")[0])
        if "serving " in line and "http://" in line:
            found["url"] = "http://" + line.split("http://")[1].split()[0]
        if "pid" in found and "url" in found:
            found["ready"].set()


def _s14_fetch(base, bodies):
    out = [None] * len(bodies)

    def fetch(i):
        req = urllib.request.Request(
            base + "/synthesize", data=json.dumps(bodies[i]).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=900) as r:
            out[i] = r.read()

    threads = [threading.Thread(target=fetch, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    check(all(o is not None for o in out), "a request did not finish")
    return out


def phase_serve_mesh(torch, np, pt, dev, card):
    """Phase 46b: ``serving.server --batcher --mesh-data 2`` under
    ``torch.distributed.run`` at chaconne: 4 seeded /synthesize requests
    byte-equal to the one-process server's, then SIGINT to rank 0 and a
    clean exit of both ranks with their K4 launches."""
    import signal

    from pytorch_wavenet_tpu_torch.serving import server as srv

    cfg = pt.get_config("chaconne")
    params = _s13_init(torch, pt, cfg, dev)
    prime = np.random.default_rng(SEED + 48).integers(0, cfg.classes, 512)
    bodies = [{"num_samples": S14_SERVE_N, "temperature": t, "seed": 700 + i}
              for i, t in enumerate((0.0, 0.9, 1.0, 0.9))]
    bodies[1]["prime"] = bodies[3]["prime"] = prime.tolist()
    pool = ["--batcher", "--lanes", str(S14_LANES), "--batch-chunk",
            str(S14_CHUNK)]
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        path = pt.save_checkpoint(d, "chaconne", 0, params, cfg=cfg)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m",
               "pytorch_wavenet_tpu_torch.serving.server", "--snapshot", path,
               "--port", "0", "--mesh-data", "2"] + pool
        env = dict(os.environ, PYTHONPATH=here + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t = time.time()
        proc = subprocess.Popen(cmd, cwd=here, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        lines, found = [], {"ready": threading.Event()}
        reader = threading.Thread(target=_s14_reader,
                                  args=(proc, lines, found), daemon=True)
        reader.start()
        try:
            base, stop = _server(srv, ["--snapshot", path] + pool,
                                 "serve one rank")
            try:
                want = _s14_fetch(base, bodies)
            finally:
                stop()
            while not found["ready"].wait(1):
                check(proc.poll() is None and time.time() - t < S13_TIMEOUT,
                      "the 2-rank server did not come up")
            up = time.time() - t
            t1 = time.time()
            got = _s14_fetch(found["url"], bodies)
            wall = time.time() - t1
            stats = _json_get(found["url"], "/stats")
        finally:
            if "pid" in found:
                os.kill(found["pid"], signal.SIGINT)
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            reader.join(10)
    for line in lines:
        log(f"[serve mesh] {line.rstrip()}")
    check(proc.returncode == 0, f"the 2-rank server exited {proc.returncode}")
    for i, (a, b) in enumerate(zip(got, want)):
        _read_wav(a, S14_SERVE_N)
        check(a == b, f"2-rank server response {i} differs from the "
              f"one-process server's")
    text = "".join(lines)
    m = [ln for ln in lines if "kernel launches per rank: K4" in ln]
    check(len(m) == 1, "no launches line from the 2-rank server")
    k4 = json.loads(m[0].split("K4 ")[1])
    m = [ln.split("pool steps per rank: ")[1] for ln in lines
         if "pool steps per rank: " in ln]
    check(len(m) == 1, "no pool steps line from the 2-rank server")
    steps, primes = (json.loads(x) for x in
                     m[0].strip().split("; prime calls per rank: "))
    # each rank: the prewarm's step, one a pool step, one a prime call of
    # its own (the 4 requests take the last lanes, rank 1's)
    want = [1 + s + p for s, p in zip(steps, primes)]
    check(k4 == want and steps[0] == steps[1] > 0 and sum(primes) > 0,
          f"K4 launches per rank {k4}, expected {want} (pool steps "
          f"{steps}, prime calls {primes})")
    check(stats["mesh_ranks"] == 2 and stats["failed"] == 0,
          f"/stats: {stats}")
    log(f"[serve mesh] chaconne under torchrun, --mesh-data 2, {S14_LANES} "
        f"lanes: up in {up:.1f} s, 4 seeded requests of {S14_SERVE_N} in "
        f"{wall:.2f} s byte-equal to the one-process server's; K4 launches "
        f"per rank {k4} (pool steps {steps}, prime calls {primes}, a "
        f"prewarm step); both ranks exited 0 [{card}]")
    check("Traceback" not in text, "a rank printed a traceback")
    return dict(k4=k4, up_s=up, wall_s=wall)


def slice14(torch, np, pt, ghbm, dev, card, t_start, out_dir, one_rank):
    """Phase 46 after its ranks ran (in phase 44's spawn wave): the pool on
    a 2-rank mesh and the server under torchrun. Returns their figures."""
    t = time.time()
    pool = phase_pool_mesh(torch, np, pt, ghbm, dev, card, out_dir, one_rank)
    checks = time.time() - t
    t = time.time()
    served = phase_serve_mesh(torch, np, pt, dev, card)
    serve_s = time.time() - t
    secs = {"ranks": max(pool["rank_seconds"]), "checks": checks,
            "server": serve_s}
    log(f"phase 46 took {sum(secs.values()):.1f} s (ranks "
        f"{secs['ranks']:.1f}, checks and the one-rank pool {checks:.1f}, "
        f"torchrun server {serve_s:.1f}), done at "
        f"{time.time() - t_start:.0f} s")
    return dict(pool=pool, server=served, seconds=secs)


def slice14_entries(kernels, s14):
    """Phase 46 on K4's entry: each rank's launches in the mesh pool, the
    vocoder's and the torchrun server's, and the pool's figures."""
    p = s14["pool"]
    kernels[1]["slice14_launches_per_rank"] = {
        "mesh pool chaconne 2 ranks": p["launches"]["chaconne"],
        "mesh pool vocoder frames 2 ranks": p["launches"]["vocoder"],
        "serve --mesh-data 2": s14["server"]["k4"]}
    kernels[1]["slice14"] = {
        "served_samples_per_s_2_ranks": p["mesh"]["samples_per_s"],
        "served_samples_per_s_1_rank": p["one_rank"]["samples_per_s"],
        "ttfa_ms_2_ranks": [p["mesh"]["ttfa_median_ms"],
                            p["mesh"]["ttfa_max_ms"]],
        "ttfa_ms_1_rank": [p["one_rank"]["ttfa_median_ms"],
                           p["one_rank"]["ttfa_max_ms"]],
        "cross_rank_bytes_per_step": p["bytes_per_step"],
        "cross_rank_bytes_per_admission": p["bytes_per_admission"],
        "gather_wait_s": p["gather_wait_s"],
        "phase_seconds": s14["seconds"]}


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import pytorch_wavenet_tpu_torch as pt
    from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel as gk
    from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as ghbm
    from pytorch_wavenet_tpu_torch.ops.cuda import trunk_kernel as tk

    t_start = time.time()
    dev = torch.device("cuda")
    card = phase_card(torch)
    phase_build()
    if sys.argv[1:] == ["--remainder-only"]:
        # a short call for work on phases 25-26 alone: no kernels line
        with tempfile.TemporaryDirectory() as keep:
            remainder(torch, np, pt, gk, ghbm, tk, dev, card, t_start, keep)
        return 1
    if sys.argv[1:] == ["--slice11-only"]:
        # a short call for work on phases 30-35 alone (phase 25 first for
        # the --ema snapshot): no kernels line
        with tempfile.TemporaryDirectory() as keep:
            rem = phase_training_remainder(torch, np, pt, tk, ghbm, dev, keep)
            slice11(torch, np, pt, gk, ghbm, dev, t_start, rem["snapshot"])
        return 1
    if sys.argv[1:] == ["--slice12-only"]:
        # a short call for work on phases 36-41 alone: no kernels line
        slice12(torch, np, pt, gk, ghbm, tk, dev, card, t_start)
        return 1
    if sys.argv[1:] == ["--slice13-only"]:
        # a short call for work on phases 42-45 alone: no kernels line
        with tempfile.TemporaryDirectory() as d:
            slice13(torch, np, pt, tk, dev, card, t_start, d)
        return 1
    if sys.argv[1:] == ["--slice14-only"]:
        # a short call for work on phase 46 alone: no kernels line
        with tempfile.TemporaryDirectory() as d:
            t = time.time()
            _s13_spawn([(2, ["pool46"])], d)
            log(f"phase 46's 2 ranks took {time.time() - t:.1f} s")
            slice14(torch, np, pt, ghbm, dev, card, t_start, d, None)
        return 1
    if sys.argv[1:] == ["--wide-only"]:
        # a short call for work on phase 47 alone: no kernels line
        log(json.dumps(phase_wide(dev)))
        return 1
    if sys.argv[1:] == ["--distill-only"]:
        # a short call for work on phases 27-29 alone (phase 25 first for
        # the teacher): no kernels line
        with tempfile.TemporaryDirectory() as keep:
            rem = phase_training_remainder(torch, np, pt, tk, ghbm, dev, keep)
            slice10(torch, np, pt, gk, tk, dev, card, t_start, keep,
                    rem["snapshot"])
        return 1
    phase_clusters(torch, pt, gk, ghbm, card)
    err, mismatches, near_ties = phase_kernel_vs_plain(torch, pt, gk, dev)
    log(f"phase kernel-vs-plain done at {time.time() - t_start:.0f} s")
    launched = phase_serving(torch, np, pt, gk, dev)
    log(f"phase serving done at {time.time() - t_start:.0f} s")
    times = phase_times(torch, pt, gk, dev, card)
    log(f"phase times done at {time.time() - t_start:.0f} s")
    k4_err, k4_mm, k4_nt = phase_k4_vs_plain(torch, pt, ghbm, dev)
    log(f"phase K4 kernel-vs-plain done at {time.time() - t_start:.0f} s")
    ks1, ks4 = phase_kernel_sizes(torch, pt, gk, ghbm, dev)
    err, mismatches, near_ties = (max(err, ks1[0]), mismatches + ks1[1],
                                  near_ties + ks1[2])
    k4_err, k4_mm, k4_nt = (max(k4_err, ks4[0]), k4_mm + ks4[1],
                            k4_nt + ks4[2])
    log(f"phase kernel sizes 1 and 3 done at {time.time() - t_start:.0f} s")
    phase_k4_batcher(torch, np, pt, dev)
    log(f"phase K4 batcher done at {time.time() - t_start:.0f} s")
    k4_launched, served = phase_k4_serving(torch, np, pt, gk, ghbm, dev)
    log(f"phase K4 serving done at {time.time() - t_start:.0f} s")
    k4_times = phase_k4_times(torch, pt, ghbm, dev, card)
    log(f"phase K4 times done at {time.time() - t_start:.0f} s")
    u_err, g_err = phase_k23_vs_plain(torch, pt, tk, dev)
    log(f"phase K2/K3 kernel-vs-plain done at {time.time() - t_start:.0f} s")
    phase_k23_train_step(torch, pt, tk, dev)
    log(f"phase K2/K3 train step done at {time.time() - t_start:.0f} s")
    k2_launched, k3_launched = phase_training(torch, np, pt, tk, dev)
    log(f"phase training done at {time.time() - t_start:.0f} s")
    tt = phase_train_times(torch, pt, tk, dev, card)
    log(f"phase training times done at {time.time() - t_start:.0f} s")
    c1 = phase_cond_k1_vs_plain(torch, pt, gk, dev)
    log(f"phase K1 vocoder cond-vs-plain done at {time.time() - t_start:.0f} s")
    c4 = phase_cond_k4_vs_plain(torch, pt, ghbm, dev)
    log(f"phase K4 vocoder cond-vs-plain done at {time.time() - t_start:.0f} s")
    v1_launched, v4_launched, vocoded = phase_vocode_serving(
        torch, np, pt, gk, ghbm, dev)
    log(f"phase /vocode serving done at {time.time() - t_start:.0f} s")
    vt = phase_vocoder_times(torch, pt, gk, ghbm, dev, card)
    log(f"phase vocoder times done at {time.time() - t_start:.0f} s")
    cu_err, cg_err = phase_cond_k23_vs_plain(torch, pt, tk, dev)
    log(f"phase K2/K3 vocoder cond-vs-plain done at "
        f"{time.time() - t_start:.0f} s")
    vk2_launched, vk3_launched = phase_training(
        torch, np, pt, tk, dev, "vocoder", 10,
        ("--cond-upsample", ",".join(map(str, VOCODER_UPSAMPLE)),
         "--hop-length", "256",
         "--n-fft", "1024"))
    log(f"phase vocoder training done at {time.time() - t_start:.0f} s")
    vtt = phase_train_times(torch, pt, tk, dev, card, "vocoder",
                            VOCODER_UPSAMPLE)
    log(f"phase vocoder training times done at "
        f"{time.time() - t_start:.0f} s")
    bu_err, bg_err, b_flips = phase_bf16_k23_vs_plain(torch, pt, tk, dev)
    log(f"phase K2/K3 bf16 stream vs plain done at "
        f"{time.time() - t_start:.0f} s")
    bk2_launched, bk3_launched = phase_training(
        torch, np, pt, tk, dev, "chaconne_wide", 20, ("--bf16",))
    log(f"phase --bf16 training done at {time.time() - t_start:.0f} s")
    btt = phase_train_times(torch, pt, tk, dev, card, bf16=True)
    alt = phase_step_alternation(torch, pt, dev, card)
    log(f"phase --bf16 training times done at "
        f"{time.time() - t_start:.0f} s")
    rings, scales = phase_ring_k4_vs_plain(torch, pt, ghbm, dev, card)
    log(f"phase K4 bf16 and int8 rings vs plain done at "
        f"{time.time() - t_start:.0f} s")
    i8_launched = phase_int8_generation(torch, pt, ghbm, dev, scales)
    log(f"phase int8 generation done at {time.time() - t_start:.0f} s")
    r_launched, r_served = phase_k4_serving(torch, np, pt, gk, ghbm, dev,
                                            bf16_rings=True)
    log(f"phase --bf16-rings serving done at {time.time() - t_start:.0f} s")
    with tempfile.TemporaryDirectory() as keep:
        rem, hk, (e1_launched, e4_launched), rt = remainder(
            torch, np, pt, gk, ghbm, tk, dev, card, t_start, keep)
        sp, ds, ss = slice10(torch, np, pt, gk, tk, dev, card, t_start, keep,
                             rem["snapshot"])
        s11 = slice11(torch, np, pt, gk, ghbm, dev, t_start, rem["snapshot"])
    s12 = slice12(torch, np, pt, gk, ghbm, tk, dev, card, t_start)
    with tempfile.TemporaryDirectory() as d:
        s13 = slice13(torch, np, pt, tk, dev, card, t_start, d, ["pool46"])
        s14 = slice14(torch, np, pt, ghbm, dev, card, t_start, d, {
            "phase 8 (f32 rings)": served,
            "phase 24 (bf16 rings)": r_served})
    wide = phase_wide(dev)
    log(f"phase 47 (the wide-chain kernel) done at "
        f"{time.time() - t_start:.0f} s")

    kernels = [{
        "name": "gen_fused (K1, fuse_res)",
        "route": "cuda",
        "source": "pytorch_wavenet_tpu_torch/csrc/gen_kernel.cu",
        "replaces": "pytorch_wavenet_tpu/ops/pallas/gen_kernel.py:558",
        "launches": launched,
        "max_abs_err": err,
        "ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": None,
        "class_mismatches": mismatches,
        "near_ties": near_ties,
    }, {
        "name": "gen_batched (K4, fuse_res + skip_slab, 256 lanes, "
                "2048-step chunk)",
        "route": "cuda",
        "source": "pytorch_wavenet_tpu_torch/csrc/gen_kernel_hbm.cu",
        "replaces": "pytorch_wavenet_tpu/ops/pallas/gen_kernel_hbm.py:1037",
        "launches": k4_launched,
        "max_abs_err": k4_err,
        "ms": k4_times["ms"],
        "plain_ms": k4_times["plain_ms"],
        "bound_ms": k4_times["bound_ms"],
        "bound_by": k4_times["bound_by"],
        "library_ms": None,
        "class_mismatches": k4_mm,
        "near_ties": k4_nt,
        "served_samples_per_s": served["samples_per_s"],
        "ttfa_median_ms": served["ttfa_median_ms"],
    }]
    for name, src, line, launched, err, plain in (
            ("trunk_fwd (K2, chaconne_wide, batch 16, out 1024, bf16 saves)",
             "trunk_fwd.cu", 621, k2_launched, u_err, tt["plain_fwd_ms"]),
            ("trunk_bwd (K3, chaconne_wide, batch 16, out 1024, bf16 saves)",
             "trunk_bwd.cu", 729, k3_launched, g_err, tt["plain_bwd_ms"])):
        key = name[name.index("(") + 1:name.index("(") + 3]
        ms, b_ms, b_by = tt["k"][(key, "bf16")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"pytorch_wavenet_tpu_torch/csrc/{src}",
            "replaces": f"pytorch_wavenet_tpu/ops/pallas/trunk_kernel.py:{line}",
            "launches": launched,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "ms_f32_saves": tt["k"][(key, "f32")][0],
            "train_step_ms": tt["step_ms"],
            "train_targets_per_s": tt["targets_per_s"],
        })
    for name, src, line, launched, (err, mm, nt), t in (
            (f"gen_fused (K1, vocoder, cond + gcond, {VOCODER_CHUNK}-step "
             "chunk)", "gen_kernel.cu", "gen_kernel.py:558", v1_launched, c1,
             vt["K1"]),
            (f"gen_batched (K4, vocoder, cond + gcond, 256 lanes, "
             f"{VOCODER_CHUNK}-step chunk)", "gen_kernel_hbm.cu",
             "gen_kernel_hbm.py:1037", v4_launched, c4, vt["K4"])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"pytorch_wavenet_tpu_torch/csrc/{src}",
            "replaces": f"pytorch_wavenet_tpu/ops/pallas/{line}",
            "launches": launched,
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "class_mismatches": mm,
            "near_ties": nt,
            "us_per_step": t["us"],
        })
    kernels[-2]["vocode_single_s"] = vocoded["single_s"]
    kernels[-1]["vocode_served_samples_per_s"] = vocoded[
        "pooled_samples_per_s"]
    for name, src, line, launched, err, plain in (
            ("trunk_fwd (K2, vocoder, cond, batch 16, out 1024, bf16 saves)",
             "trunk_fwd.cu", 621, vk2_launched, cu_err, vtt["plain_fwd_ms"]),
            ("trunk_bwd (K3, vocoder, cond, batch 16, out 1024, bf16 saves)",
             "trunk_bwd.cu", 729, vk3_launched, cg_err,
             vtt["plain_bwd_ms"])):
        key = name[name.index("(") + 1:name.index("(") + 3]
        ms, b_ms, b_by = vtt["k"][(key, "cond")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"pytorch_wavenet_tpu_torch/csrc/{src}",
            "replaces": f"pytorch_wavenet_tpu/ops/pallas/trunk_kernel.py:{line}",
            "launches": launched,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "ms_without_cond": vtt["k"][(key, "without cond")][0],
            "bound_ms_without_cond": vtt["k"][(key, "without cond")][1],
            "train_step_ms": vtt["step_ms"],
            "train_targets_per_s": vtt["targets_per_s"],
        })
    kernels[-1]["k3_reduce_ms"] = vtt["reduce_ms"]
    for name, src, line, launched, err, plain in (
            ("trunk_fwd (K2, chaconne_wide, bf16 stream (--bf16), batch 16, "
             "out 1024)", "trunk_fwd.cu", 621, bk2_launched, bu_err,
             btt["plain_fwd_ms"]),
            ("trunk_bwd (K3, chaconne_wide, bf16 stream (--bf16), batch 16, "
             "out 1024)", "trunk_bwd.cu", 729, bk3_launched, bg_err,
             btt["plain_bwd_ms"])):
        key = name[name.index("(") + 1:name.index("(") + 3]
        ms, b_ms, b_by = btt["k"][(key, "bf16 stream")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"pytorch_wavenet_tpu_torch/csrc/{src}",
            "replaces": f"pytorch_wavenet_tpu/ops/pallas/trunk_kernel.py:{line}",
            "launches": launched,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "stream_flips": b_flips,
            "train_step_ms": btt["step_ms"],
            "train_targets_per_s": btt["targets_per_s"],
            "train_step_ms_alternating": {n: alt[n]["step"] for n in alt},
        })
    for rname, launched in (("bf16", r_launched), ("int8", i8_launched)):
        r = rings[rname]
        kernels.append({
            "name": f"gen_batched (K4, {rname} rings, fuse_res + skip_slab, "
                    f"256 lanes, {RING_LOCKSTEP}-step chunk)",
            "route": "cuda",
            "source": f"pytorch_wavenet_tpu_torch/csrc/gen_kernel_hbm_"
                      f"{rname}.cu",
            "replaces": "pytorch_wavenet_tpu/ops/pallas/gen_kernel_hbm.py:"
                        "1037",
            "launches": launched,
            "max_abs_err": r["err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
            "class_mismatches": r["mismatches"],
            "near_ties": r["near_ties"],
            "ring_values_off": r["flips"],
        })
    kernels[-2].update(served_samples_per_s=r_served["samples_per_s"],
                       ttfa_median_ms=r_served["ttfa_median_ms"],
                       vocoder_us_per_step=rings["bf16"][
                           "vocoder_us_per_step"],
                       vocoder_f32_us_per_step=rings["bf16"][
                           "vocoder_f32_us_per_step"])
    # this slice's main paths: the scheduled, accumulated, EMA-tracking
    # run (phase 25: K2/K3 each micro-step, K4 in the audio hook) and
    # serve --ema (phase 26: K1, then K4 through the batcher)
    for name, src, line, launched, err, plain in (
            ("trunk_fwd (K2, chaconne_wide, batch 16, out 1024, bf16 saves: "
             "phase 25's scheduled --accum-steps 2 --ema-decay run)",
             "trunk_fwd.cu", 621, rem["launches"][0], u_err,
             tt["plain_fwd_ms"]),
            ("trunk_bwd (K3, chaconne_wide, batch 16, out 1024, bf16 saves: "
             "phase 25's scheduled --accum-steps 2 --ema-decay run)",
             "trunk_bwd.cu", 729, rem["launches"][1], g_err,
             tt["plain_bwd_ms"])):
        key = name[name.index("(") + 1:name.index("(") + 3]
        ms, b_ms, b_by = tt["k"][(key, "bf16")]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"pytorch_wavenet_tpu_torch/csrc/{src}",
            "replaces": f"pytorch_wavenet_tpu/ops/pallas/trunk_kernel.py:{line}",
            "launches": launched,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "train_step_ms": {k: v["step_ms"] for k, v in rt.items()
                              if "step_ms" in v},
            "optimizer_ms": {k: v["opt_ms"] for k, v in rt.items()
                             if "opt_ms" in v},
        })
    kernels[-1]["snapshot"] = rt["snapshot"]
    kernels[-1]["data_layer_host_ms"] = rem["native"]
    kernels.append({
        "name": "gen_batched (K4, the audio hook: chaconne_wide, 2 lanes at "
                "T 0.5 and 1.0, exact, 1024-step call)",
        "route": "cuda",
        "source": "pytorch_wavenet_tpu_torch/csrc/gen_kernel_hbm.cu",
        "replaces": "pytorch_wavenet_tpu/ops/pallas/gen_kernel_hbm.py:1037",
        "launches": rem["launches"][2],
        "max_abs_err": hk["err"],
        "ms": hk["ms"],
        "plain_ms": hk["plain_ms"],
        "bound_ms": hk["bound_ms"],
        "bound_by": hk["bound_by"],
        "library_ms": None,
        "lanes_parted_at_near_ties": hk["parted"],
        "hook_call_16000_steps_ms": hk["full_ms"],
    })
    for name, src, line, launched, err, t in (
            ("gen_fused (K1, serve --ema, chaconne_wide, fuse_res)",
             "gen_kernel.cu", "gen_kernel.py:558", e1_launched, kernels[0][
                 "max_abs_err"], kernels[0]),
            ("gen_batched (K4, serve --ema --batcher, 256 lanes, 2048-step "
             "chunk)", "gen_kernel_hbm.cu", "gen_kernel_hbm.py:1037",
             e4_launched, kernels[1]["max_abs_err"], kernels[1])):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"pytorch_wavenet_tpu_torch/csrc/{src}",
            "replaces": f"pytorch_wavenet_tpu/ops/pallas/{line}",
            "launches": launched,
            "max_abs_err": err,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
        })
    # this slice's main path: distillation, the teacher scored through K2
    # at N 4, out 931 (phase 28: distill_cli's 10 steps on phase 25's
    # chaconne_wide snapshot, and 3 on the vocoder teacher with cond)
    for name, key, launched in (
            ("trunk_fwd (K2, the distillation teacher: chaconne_wide, N 4, "
             "out 931, no_grad: distill_cli's 10 steps)", "chaconne",
             ds["launches"]),
            ("trunk_fwd (K2, the vocoder distillation teacher, cond, N 4, "
             "out 931: distill_cli's 3 steps)", "vocoder",
             ds["v_launches"])):
        t = ds["k2"][key]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pytorch_wavenet_tpu_torch/csrc/trunk_fwd.cu",
            "replaces": "pytorch_wavenet_tpu/ops/pallas/trunk_kernel.py:621",
            "launches": launched,
            "max_abs_err": t["err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "distill_step_ms": ds["split"][key]["step_ms"],
            "distill_step_split_ms": ds["split"][key]["split_ms"],
            "k2_launches_per_step": ds["split"][key]["k2_launches_per_step"],
        })
    kernels[-2].update(
        distill_loss_rel_err_vs_plain_trunk=ds["loss_err"],
        speculation={k: {m: v[m] for m in ("samples_per_s", "accept_rate",
                                           "syncs_per_sample")}
                     for k, v in sp["runs"].items()},
        speculation_plain_samples_per_s=sp["plain_samples_per_s"],
        speculation_k1_samples_per_s=sp["k1_samples_per_s"],
        student_synthesize_samples_per_s=ss["synthesize_samples_per_s"],
        student_vocode_samples_per_s=ss["vocode_samples_per_s"])
    # this slice's main paths, phases 30-35, on the K1 and K4 entries: the
    # launches of each path, counted around its own run (the CLIs' as the
    # processes printed them), and the /profile capture's K4 figures
    kernels[0]["slice11_launches"] = s11["k1"]
    kernels[1].update(slice11_launches=s11["k4"],
                      profile_capture=s11["profile"],
                      slice11_phase_seconds=s11["seconds"])
    slice12_entries(kernels, s12)
    slice13_entries(kernels, s13)
    slice14_entries(kernels, s14)
    kernels.append(wide)
    log(f"the run took {time.time() - t_start:.0f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
