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
     chaconne; the plain version; the bound from the shapes.

The line before the last is one JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.

Tolerances: the kernel and the plain version sum in different orders, so
a class may differ only where the plain version's top-2 score gap is below
NEAR_TIE; ring states agree within RING_TOL (f32 rounding of O(1) values
over a few hundred layer updates).
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


def bound_ms(pt, gk, params, cfg, streams, num_given, total):
    """Least time for the call: the larger of its bytes (the model's
    parameters, the prime and the rings read once, classes and rings
    written once; no fuse_res products, no stand-in zero biases) over the
    memory rate and its f32 operations over the f32 peak."""
    ring = sum(gk.periods(cfg)) * streams * cfg.residual_channels * 4
    nbytes = (4 * pt.parameter_count(params) + 2 * ring
              + 4 * streams * (num_given + total))
    flops = _flops_per_step(cfg) * streams * total
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_PEAK_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


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
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
