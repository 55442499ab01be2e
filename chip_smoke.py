#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and the port's sources; without a card, or outside a
checkout, it exits nonzero and prints no result.

Phases (any failure stops the run with a nonzero exit):
  1. the card: ``nvidia-smi`` name and power limit, torch, device name;
  2. build: every ``csrc/*.cu`` with ``nvcc`` (``-Xptxas -v`` printed);
  3. kernel K1 (the fused generation loop) against its plain PyTorch
     version at full width, chaconne and saber, exact and ``fuse_res``:
     teacher-forced classes, free-running rollouts at temperature 0 and 1,
     a resumed chunk (t0 = rf, temperature 0.9, the serving call), a
     3-chunk resumed rollout equal to one shot bitwise;
  4. serving (the main path): chaconne with random weights from a seed,
     written as a checkpoint, served by ``serving.server.main`` on a free
     port; three /synthesize requests; the kernel's launch count read
     around exactly this phase;
  5. times with CUDA events: K1 at the serving chunk, at the bench shape
     (saber, full-rf prime, 65536 samples, temperature 1) and for
     chaconne; the plain version; the bound from the shapes;
  6. kernel K4 (batched many-stream generation) against its plain version
     at chaconne width, 256 lanes and 200 (a tail tile), exact and
     ``fuse_res + skip_slab``: a teacher-forced prime, rollouts at
     temperature 0 and hot with per-lane seeds, temperatures and clocks,
     a resumed chunk at the pool's clock, three resumed chunks equal to
     one shot bitwise, NaN-filled fresh rings giving the classes of
     zeroed ones, and a fresh call equal bitwise (classes and ring) to the
     same rollout at the pool's clock over zeroed history;
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
     and 1024 lanes, per tile width at 256 and 1024 lanes; the plain
     version; the bound from the shapes;
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
     K2 and K3 at bf16 and f32 saves beside their bounds, the plain trunk,
     and the step's split into embed, trunk, skip and head, loss and
     optimizer.

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

import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

NEAR_TIE = 1e-4
RING_TOL = 1e-4
SEED = 1234
F32_PEAK_FLOPS = 67e12   # H100 SXM, f32 outside the tensor cores
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
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[nvcc {name}] {line.strip()}")
    log(f"build: {sorted(logs)} in {time.time() - t:.1f} s")


def _first_mismatch(a, b):
    diff = (a != b).nonzero()
    return int(diff[0, -1]) if diff.numel() else -1


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
                f"{int(miss.sum())} class mismatches ({bad} not at a near-tie), "
                f"{int(ties.sum())} near-ties (gap < {NEAR_TIE}), "
                f"ring max abs err {err:.3g}")
            check(bad == 0, f"{tag}: kernel disagrees with plain off a near-tie")
            check(err <= RING_TOL, f"{tag}: ring error {err} > {RING_TOL}")
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
    """The f32 operations of one step of the function, for either variant:
    fuse_res reassociates the chain (its wf products replace nothing the
    function needs), so the exact path's products are what is counted."""
    k, R, D = cfg.kernel_size, cfg.residual_channels, cfg.dilation_channels
    S, E, C, L = (cfg.skip_channels, cfg.end_channels, cfg.classes,
                  cfg.num_layers)
    return 2 * (L * (k * R * 2 * D + D * (S + R)) + S * E + E * C)


def bound_ms(pt, gk, params, cfg, streams, num_given, total, lane_rows=0):
    """Least time for the call: the larger of its bytes (the model's
    parameters, the prime, the rings and ``lane_rows`` per-lane f32/int32
    rows read once, classes and rings written once; no fuse_res products,
    no stand-in zero biases) over the memory rate and its f32 operations
    over the f32 peak."""
    ring = sum(gk.periods(cfg)) * streams * cfg.residual_channels * 4
    nbytes = (4 * pt.parameter_count(params) + 2 * ring
              + 4 * streams * (num_given + total + lane_rows))
    flops = _flops_per_step(cfg) * streams * total
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_PEAK_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def trunk_bounds(cfg, batch, out_len, save_bytes=2):
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
    gradients written once."""
    k, R, D, L = (cfg.kernel_size, cfg.residual_channels,
                  cfg.dilation_channels, cfg.num_layers)
    T = cfg.receptive_field + out_len - 1
    W, reach = [], 0
    for d in reversed(cfg.dilations):
        W.append(min(T, out_len + reach))
        reach += (k - 1) * d
    pos = batch * sum(W)
    tap, res = 2 * k * R * 2 * D, 2 * D * R
    w_bytes = 4 * L * (k * R * 2 * D + 2 * D + D * R + R)
    saves = save_bytes * R * pos
    units = 4 * batch * out_len * L * D
    stream = 4 * batch * T * R
    out = {}  # saves in bf16 (save_bytes 2) unless said
    for name, flops, nbytes in (
            ("K2", pos * (tap + res), stream + units + saves + w_bytes),
            ("K3", pos * (3 * tap + 2 * res),
             saves + units + stream + 2 * w_bytes)):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / F32_PEAK_FLOPS
        out[name] = (1e3 * max(t_b, t_o),
                     "bytes" if t_b > t_o else "operations")
    return out


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
    timed(saber, saber.receptive_field, 65536, 1.0, 2)
    timed(chaconne, chaconne.receptive_field, 16384, 1.0, 2)
    # where a step's time goes: chaconne widths at 1, 2 and 3 blocks; the
    # slope is the cost of one layer, the intercept that of the embed, the
    # head and the sampling
    us = []
    for blocks in (1, 2, 3):
        c = pt.get_config("chaconne", blocks=blocks)
        us.append(1e3 * timed(c, 1, 2048, 0.9, 2)[7] / 2048)
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
                f"mismatches ({bad} not at a near-tie), {int(ties.sum())} "
                f"near-ties (gap < {NEAR_TIE}), ring max abs err {err:.3g}")
            check(bad == 0, f"{tag}: kernel disagrees with plain off a "
                  f"near-tie")
            check(err <= RING_TOL, f"{tag}: ring error {err} > {RING_TOL}")
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
    return worst, mismatches, near_ties


def _solo_cls(pt, params, cfg, prime, n, temperature, seed, dev):
    _, cls = pt.generate_fast_batched(
        params, cfg, 0, n, prime, temperature=temperature,
        lane_seed=seed, fuse_res=True, skip_slab=True, device=dev)
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


def phase_k4_serving(torch, np, pt, gk, ghbm, dev):
    """The main path of this slice. Returns the K4 launches counted around
    it and the served figures."""
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
                  "256", "--batch-chunk", "2048"], on_ready=on_ready),
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
                        [500 + i], dev)[0]
        wav = dequantize_to_f32(cls, cfg.classes)
        check(np.isfinite(wav).all(), "non-finite waveform")
        solo = np.clip(wav * 32767.0, -32768, 32767).astype("<i2")
        check(np.array_equal(pcms[i], solo),
              f"served request {i} (T={temps[i]}) differs from its solo "
              f"rollout")
    ttfa = sorted(o[1] for o in out)
    served = n_req * n / wall
    log(f"[serve-batcher] {n_req} concurrent {n}-sample requests in "
        f"{wall:.2f} s: {served:.0f} samples/s served; time to first audio "
        f"median {1e3 * ttfa[n_req // 2]:.0f} ms, max {1e3 * ttfa[-1]:.0f} "
        f"ms; requests 0 and 2 equal their solo rollouts byte for byte; "
        f"{stats['pool_steps']} pool steps of 2048")
    return launched, dict(samples_per_s=served, wall_s=wall,
                          ttfa_median_ms=1e3 * ttfa[n_req // 2],
                          ttfa_max_ms=1e3 * ttfa[-1])


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
        ms = _time(torch, call(ghbm.batched_cuda, ops, 2048), 2)
        best = min(ms)
        b_ms, b_by = bound_ms(pt, ghbm, params, cfg, lanes, 1, 2048,
                              lane_rows=3)
        log(f"[time] K4 chaconne fuse_res+skip_slab, {lanes} lanes (tile "
            f"{ghbm.default_tile(lanes)}), resumed 2048-step chunk, T=0.9 "
            f"lane_seed: " + ", ".join(f"{m:.2f}" for m in ms)
            + f" ms; {1e3 * best / 2048:.2f} us/step, "
            f"{lanes * 2048 / best * 1e3:.0f} samples/s; bound {b_ms:.4f} "
            f"ms ({b_by}), {100 * b_ms / best:.2f} % of it [{card}]")
        out[lanes] = dict(ms=best, bound_ms=b_ms, bound_by=b_by)
    # the tile sweep behind default_tile: each width at both pool sizes
    for lanes in (256, 1024):
        ops = setup(cfg, lanes)
        for tile in ghbm.TILES:
            best = min(_time(torch, call(ghbm.batched_cuda, ops, 2048,
                                         tile=tile), 1))
            log(f"[time] K4 {lanes} lanes, tile {tile} ({-(-lanes // tile)} "
                f"blocks, {ghbm.shared_bytes(cfg, tile, True)} B shared): "
                f"{best:.2f} ms per 2048-step chunk, "
                f"{1e3 * best / 2048:.2f} us/step [{card}]")
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
        _, exact_saves = tk.trunk_fwd_plain(params, cfg, h0, out_len,
                                            torch.float32)
        exact = tk.trunk_bwd_plain(params, cfg, exact_saves, du, out_len)
        for sd, name_sd in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            uk, sk = tk.trunk_fwd_cuda(params, cfg, h0, out_len, sd)
            torch.cuda.synchronize()
            up, _ = tk.trunk_fwd_plain(params, cfg, h0, out_len, sd)
            eu = float(((uk - up).abs() / up.abs().clamp(min=1.0)).max())
            check(eu <= U_TOL, f"{tag} {name_sd} saves: u error {eu}")
            u_err = max(u_err, float((uk - up).abs().max()))
            gk = tk.trunk_bwd_cuda(params, cfg, sk, du, out_len)
            again = tk.trunk_bwd_cuda(params, cfg, sk, du, out_len)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(gk, again))
            check(same, f"{tag} {name_sd} saves: two K3 calls differ")
            gp = tk.trunk_bwd_plain(params, cfg, sk, du, out_len)
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
            log(f"[{tag}] {name_sd} saves: u within {eu:.3g} x max(1, |u|) "
                f"(tol {U_TOL}); K3 gradients within {e_plain:.3g} x max(1, "
                f"scale) of the plain version on the same saves (tol "
                f"{GRAD_TOL}), {e_exact:.3g} of the exact (f32-save) "
                f"gradients (tol {tol}); two K3 calls bitwise equal")
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


def phase_training(torch, np, pt, tk, dev):
    """The main path of this slice: chaconne_wide trained for 20 steps at
    batch 16 through ``training.train.main`` on the example audio, with a
    snapshot at step 10; then a run resumed from that snapshot to step 20.
    Returns the K2/K3 launches counted around the first run."""
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

    def barred(*args, **kwargs):
        plain_calls.append(1)
        raise RuntimeError("the plain trunk ran on the card path")

    with tempfile.TemporaryDirectory() as d:
        data = os.path.join(d, "audio")
        os.makedirs(data)
        for w in wavs:
            shutil.copy(w, data)
        base = ["--data-dir", data, "--config", "chaconne_wide",
                "--batch-size", "16", "--epochs", "10", "--max-steps", "20",
                "--seed", str(SEED), "--lr", "1e-3", "--log-interval", "10",
                "--validation-interval", "1000", "--device", str(dev)]
        tk.trunk_fwd_plain = tk.trunk_bwd_plain = barred
        try:
            tk.fwd_launches = tk.bwd_launches = 0
            t = time.time()
            a = train.main(base + ["--snapshot-path", os.path.join(d, "a"),
                                   "--snapshot-interval", "10"])
            torch.cuda.synchronize()
            wall = time.time() - t
            launched = (tk.fwd_launches, tk.bwd_launches)
            snap10 = checkpoint_path(os.path.join(d, "a"),
                                     "chaconne_wide_model", 10)
            os.makedirs(os.path.join(d, "b"))
            shutil.copy(snap10, os.path.join(d, "b"))
            tk.fwd_launches = tk.bwd_launches = 0
            b = train.main(base + ["--snapshot-path", os.path.join(d, "b"),
                                   "--snapshot-interval", "1000", "--resume"])
            torch.cuda.synchronize()
            resumed = (tk.fwd_launches, tk.bwd_launches)
        finally:
            tk.trunk_fwd_plain, tk.trunk_bwd_plain = real
        blob = pt.load_checkpoint(snap10, device="cpu")
        opt = blob["opt_state"]
        check(opt is not None and int(opt["0"]["count"]) == 10,
              "the step-10 snapshot has no optimizer state at count 10")
        # what came out: the loss on the first training batch falls from
        # the seed's init to the trained params
        x, y = a.dataset.get_batch(np.arange(16))
        x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        init = pt.init_wavenet(a.cfg, torch.Generator().manual_seed(SEED),
                               dev)
        with torch.no_grad():
            l0 = float(pt.cross_entropy_loss(init, a.cfg, x, y))
            l1 = float(pt.cross_entropy_loss(a.params, a.cfg, x, y))
        n_items = len(a.dataset)
    check(not plain_calls, f"the plain trunk ran {len(plain_calls)} times")
    check(launched == (20, 20), f"K2/K3 launches {launched}, expected 20 each "
          f"(one per step)")
    check(resumed == (10, 10), f"resumed run: K2/K3 launches {resumed}, "
          f"expected 10 each")
    check(a.step == 20 and b.step == 20, f"steps {a.step}, {b.step}")
    check(math.isfinite(l0) and math.isfinite(l1) and l1 < l0,
          f"loss did not fall: {l0} -> {l1}")
    diffs = [float((p - q).abs().max()) for (_, p), (_, q)
             in zip(_leaves(a.params), _leaves(b.params))]
    bitwise = all(torch.equal(p, q) for (_, p), (_, q)
                  in zip(_leaves(a.params), _leaves(b.params)))
    check(max(diffs) <= 1e-6, f"resumed run differs by {max(diffs)}")
    log(f"[train] chaconne_wide batch 16 on {len(wavs)} example files "
        f"({n_items} windows): 20 steps in {wall:.1f} s (dataset and "
        f"snapshots included; avg step {1e3 * a.avg_step_time:.2f} ms host "
        f"clock); K2/K3 launches {launched[0]}/{launched[1]} (20 steps x 1 "
        f"wrapper call each, {a.cfg.num_layers} and {3 * a.cfg.num_layers} "
        f"CUDA kernels per call), plain trunk calls {len(plain_calls)}; "
        f"loss on the first batch {l0:.4f} at init -> {l1:.4f} at step 20; "
        f"step-10 snapshot holds opt_state (count 10)")
    log(f"[train] resumed from the step-10 snapshot to step 20 (K2/K3 "
        f"launches {resumed[0]}/{resumed[1]}): params "
        f"{'bitwise equal to' if bitwise else 'within %.3g of' % max(diffs)} "
        f"the uninterrupted run's")
    return launched


def _time_median(torch, fn, reps):
    ms = _time(torch, fn, reps)
    return sorted(ms)[len(ms) // 2], ms


def phase_train_times(torch, pt, tk, dev, card):
    """Times with CUDA events at chaconne_wide, batch 16: the train step,
    K2 and K3 at both save types beside their bounds, the plain trunk, and
    the step's split. Returns the figures for the kernels line."""
    import dataclasses

    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

    cfg = pt.get_config("chaconne_wide", trunk_kernel=True)
    B, out = 16, cfg.output_length
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, cfg.classes, (B, cfg.item_length), generator=g)
    y = torch.randint(0, cfg.classes, (B, out), generator=g)
    x, y = x.to(dev, torch.int32), y.to(dev, torch.int32)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(SEED), dev)
    for _, p in _leaves(params):
        p.requires_grad_(True)
    tx = pt.reference_adam(1e-4)
    state = tx.init(params)
    step_ms, all_ms = _time_median(torch, lambda: pt.train_step(
        params, state, cfg, tx, x, y), 10)
    log(f"[time] train step, chaconne_wide batch 16, trunk K2/K3 (bf16 "
        f"saves): median {step_ms:.3f} ms of 10 warm steps ("
        + ", ".join(f"{m:.3f}" for m in all_ms) + f"); "
        f"{B * out / step_ms * 1e3:.0f} targets/s [{card}]")
    plain_cfg = dataclasses.replace(cfg, trunk_kernel=False)
    plain_step, _ = _time_median(torch, lambda: pt.train_step(
        params, state, plain_cfg, tx, x, y), 3)
    log(f"[time] train step with the plain trunk (--no-trunk-kernel): "
        f"median {plain_step:.3f} ms of 3 [{card}]")

    # the kernels alone, at the main path's shapes
    cfg_t, p_t, h0, du = _trunk_case(torch, pt, dev, "chaconne_wide", B, out)
    out_k = {}
    for sd, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        _, saves = tk.trunk_fwd_cuda(p_t, cfg_t, h0, out, sd)
        k2 = min(_time(torch, lambda: tk.trunk_fwd_cuda(p_t, cfg_t, h0, out,
                                                        sd), 5))
        k3 = min(_time(torch, lambda: tk.trunk_bwd_cuda(p_t, cfg_t, saves,
                                                        du, out), 5))
        bounds = trunk_bounds(cfg_t, B, out, 2 if name == "bf16" else 4)
        for kname, ms in (("K2", k2), ("K3", k3)):
            b_ms, b_by = bounds[kname]
            log(f"[time] {kname} chaconne_wide batch 16 out {out}, {name} "
                f"saves: {ms:.3f} ms (min of 5); bound {b_ms:.4f} ms "
                f"({b_by}), {100 * b_ms / ms:.2f} % of it [{card}]")
            out_k[(kname, name)] = (ms, b_ms, b_by)
    _, saves = tk.trunk_fwd_plain(p_t, cfg_t, h0, out, torch.bfloat16)
    pf = min(_time(torch, lambda: tk.trunk_fwd_plain(
        p_t, cfg_t, h0, out, torch.bfloat16), 2))
    pb = min(_time(torch, lambda: tk.trunk_bwd_plain(
        p_t, cfg_t, saves, du, out), 2))
    log(f"[time] plain trunk, same shapes, bf16 saves: forward {pf:.3f} ms, "
        f"backward {pb:.3f} ms [{card}]")
    log("[time] library call: none (no single PyTorch call computes the "
        "dilated trunk)")

    # the step's split: each part timed alone on the step's shapes
    L, D = cfg.num_layers, cfg.dilation_channels
    lp = params["layers"]
    h0e = pt.embed_inputs(params, cfg, x).detach()
    u = torch.rand((B, out, L * D), generator=g).to(dev).requires_grad_(True)
    logits = torch.randn((B, out, cfg.classes), generator=g).to(
        dev).requires_grad_(True)
    from pytorch_wavenet_tpu_torch.models import wavenet as wm

    def embed():
        h = pt.embed_inputs(params, cfg, x)
        torch.autograd.grad(h, [params["start"]["w"]], torch.ones_like(h))

    def trunk():
        uu = tk.fused_trunk(params, cfg, h0e, out)
        torch.autograd.grad(uu, [lp["w_in"]], torch.ones_like(uu))

    def skip_head():
        skip = wm._mm(u, lp["w_skip"].reshape(L * D, -1), cfg.compute_dtype)
        skip = skip + lp["b_skip"].sum(dim=0)
        yy = torch.relu(skip)
        yy = torch.relu(wm._mm(yy, params["end1"]["w"], cfg.compute_dtype)
                        + params["end1"]["b"])
        yy = (wm._mm(yy, params["end2"]["w"], cfg.compute_dtype)
              + params["end2"]["b"])
        torch.autograd.grad(yy, [u, lp["w_skip"]], torch.ones_like(yy))

    def loss():
        lz = torch.logsumexp(logits, dim=-1)
        hit = torch.sum(logits * torch.nn.functional.one_hot(
            y.long(), cfg.classes).to(torch.float32), dim=-1)
        torch.autograd.grad(torch.mean(lz - hit), [logits])

    gtree = pt.train_step(params, state, cfg, tx, x, y)[1]

    def opt():
        tx.step(params, gtree, state)

    parts = {}
    for name, fn in (("embed fwd+bwd", embed), ("trunk K2+K3", trunk),
                     ("skip+head fwd+bwd", skip_head),
                     ("loss fwd+bwd", loss), ("optimizer", opt)):
        parts[name] = _time_median(torch, fn, 5)[0]
    total = sum(parts.values())
    log(f"[time] step split (each part alone, median of 5): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
        + f"; sum {total:.3f} ms against the step's {step_ms:.3f} ms "
        f"[{card}]")
    return dict(step_ms=step_ms, plain_step_ms=plain_step,
                targets_per_s=B * out / step_ms * 1e3, parts=parts,
                k=out_k, plain_fwd_ms=pf, plain_bwd_ms=pb)


# -------------------------------------------------------------------- main


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
    err, mismatches, near_ties = phase_kernel_vs_plain(torch, pt, gk, dev)
    log(f"phase kernel-vs-plain done at {time.time() - t_start:.0f} s")
    launched = phase_serving(torch, np, pt, gk, dev)
    log(f"phase serving done at {time.time() - t_start:.0f} s")
    times = phase_times(torch, pt, gk, dev, card)
    log(f"phase times done at {time.time() - t_start:.0f} s")
    k4_err, k4_mm, k4_nt = phase_k4_vs_plain(torch, pt, ghbm, dev)
    log(f"phase K4 kernel-vs-plain done at {time.time() - t_start:.0f} s")
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
