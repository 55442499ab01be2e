#!/usr/bin/env python3
"""Quick check of the port's generation kernels K1 and K4 (the cluster
core, ``csrc/gen_cluster.cuh``) on one CUDA card: build them with
``-Xptxas -v`` (registers, shared memory, spills), print
``cudaOccupancyMaxActiveClusters``, hold each against its plain PyTorch
version at a few shapes (classes off near-ties of 1e-4, rings within
1e-4) at kernel sizes 1, 2 and 3, check that the same lanes give bitwise
the same classes and ring at every tile width, and time one chaconne
chunk of each with the split of a step from the kernel's own timers. ``chip_smoke.py`` runs the full checks; this takes about a minute.
``--vocoder`` runs the conditioned cases alone: K1 and K4 with cond and
gcond rows against their plain versions at the ``tiny_vocoder`` and
``vocoder`` widths, the same lanes at 8 and 16 lanes per cluster, and a
2048-step vocoder chunk of each without and with conditioning, with the
split of a K4 step. ``--prime`` times a chaconne prime of a receptive
field (3070 classes) with the head on every step and without it on the
3069 teacher-forced ones (``head_from``): K4 at the 8-lane tile, as the
lane pool's prime call runs it, with the split of a step from the
kernel's timers, and K1 at one stream, as the stream's first chunk runs
it, both checked bitwise against each other.

  python3 scripts/torch_gen_check.py [--vocoder | --prime]
"""

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import pytorch_wavenet_tpu_torch as pt  # noqa: E402
from pytorch_wavenet_tpu_torch.ops.cuda import build  # noqa: E402
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel as gk  # noqa: E402
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as ghbm  # noqa: E402

NEAR_TIE, RING_TOL = 1e-4, 1e-4
failures = []


def expect(cond, msg):
    print(("ok   " if cond else "FAIL ") + msg, flush=True)
    if not cond:
        failures.append(msg)


def cond_rows(dev, shape, seed, scale=0.5):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(dev)


def k4_case(dev, name, lanes, fuse, slab, n_prime, steps, tiles, cond=False,
            **kw):
    cfg = pt.get_config(name, **kw)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), dev)
    w = ghbm.prepare_weights(params, cfg, fuse, slab)
    ckw = {}
    if cond:  # cond rows (total, M, lanes) and the projected gcond table
        ckw = dict(cond=cond_rows(dev, (n_prime - 1 + steps,
                                        cfg.cond_channels, lanes), 5),
                   gcond=ghbm.project_gcond(w, cfg, cond_rows(
                       dev, (lanes, cfg.gcond_channels), 6, 1.0), lanes))
    rng = np.random.default_rng(1)
    prime = torch.from_numpy(rng.integers(0, cfg.classes, (lanes, n_prime))
                             ).to(dev, torch.int32)
    temps = torch.full((lanes,), 0.9, device=dev)
    temps[::3] = 0.0
    seeds = torch.arange(lanes, dtype=torch.int32, device=dev) * 7 - 3
    toffs = torch.arange(lanes, dtype=torch.int32, device=dev) % 5
    total = n_prime - 1 + steps
    rows = ghbm.ring_rows(cfg)
    rp = torch.zeros(rows, lanes, device=dev)
    cp, gaps = ghbm.batched_plain(w, cfg, prime, rp, 0, total, temps, seeds,
                                  toffs, 4, 0.05, fuse, slab, True,
                                  return_gaps=True, **ckw)
    ref = None
    for tile in tiles:
        rk = torch.zeros(rows, lanes, device=dev)
        try:
            ck = ghbm.batched_cuda(w, cfg, prime, rk, 0, total, temps,
                                   seeds, toffs, 4, 0.05, fuse, slab,
                                   True, tile=tile, **ckw)
            torch.cuda.synchronize()
        except Exception as e:  # report and go on to the next case
            expect(False, f"K4 {name} {kw} tile {tile}: {e}")
            continue
        forced = slice(0, n_prime - 1)
        bad = int(((ck[:, forced] != cp[:, forced])
                   & (gaps[:, forced] >= NEAR_TIE)).sum())
        err = float((rk - rp).abs().max())
        tag = (f"K4 {name} {kw} {lanes} lanes {'fuse' if fuse else 'exact'}"
               f"{'+slab' if slab else ''}{' cond+gcond' if cond else ''} "
               f"tile {tile}")
        expect(bad == 0 and err <= RING_TOL,
               f"{tag}: {bad} mismatches off a near-tie, ring err {err:.3g}")
        if ref is None:
            ref = (ck, rk)
        else:
            expect(torch.equal(ck, ref[0]) and torch.equal(rk, ref[1]),
                   f"{tag}: bitwise equal to the first width")


def k1_case(dev, name, streams, fuse, n_prime, steps, temp, cond=False,
            **kw):
    cfg = pt.get_config(name, **kw)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), dev)
    w = gk.prepare_weights(params, cfg, fuse)
    rng = np.random.default_rng(2)
    prime = torch.from_numpy(rng.integers(0, cfg.classes, (streams, n_prime))
                             ).to(dev, torch.int32)
    total = n_prime - 1 + steps
    ckw = {}
    if cond:  # the projected cond and gcond rows
        ckw = dict(zip(("cond", "gcond"), gk.project_cond(
            params, cfg, cond_rows(dev, (streams, total, cfg.cond_channels),
                                   7),
            cond_rows(dev, (streams, cfg.gcond_channels), 8, 1.0), streams,
            total)))
    size = sum(gk.periods(cfg)) * streams * cfg.residual_channels
    rk, rp = torch.zeros(size, device=dev), torch.zeros(size, device=dev)
    try:
        ck = gk.fused_cuda(w, cfg, prime, rk, 0, total, temp, 0.05, 4, fuse,
                           **ckw)
        torch.cuda.synchronize()
    except Exception as e:
        expect(False, f"K1 {name} {kw}: {e}")
        return
    cp, gaps = gk.fused_plain(w, cfg, prime, rp, 0, total, temp, 0.05, 4,
                              fuse, return_gaps=True, **ckw)
    forced = slice(0, n_prime - 1)
    bad = int(((ck[:, forced] != cp[:, forced])
               & (gaps[:, forced] >= NEAR_TIE)).sum())
    err = float((rk - rp).abs().max())
    expect(bad == 0 and err <= RING_TOL,
           f"K1 {name} {kw} {streams} streams {'fuse' if fuse else 'exact'}"
           f"{' cond+gcond' if cond else ''} T={temp}: {bad} mismatches off "
           f"a near-tie, ring err {err:.3g}")


def timed(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def vocoder(dev):
    """The conditioned cases: checks, then a 2048-step chunk of each kernel
    at the vocoder without and with conditioning."""
    g3 = dict(gcond_channels=3)
    for fuse in (False, True):
        k1_case(dev, "tiny_vocoder", 3, fuse, 30, 8, 0.9, cond=True, **g3)
        k1_case(dev, "vocoder", 1, fuse, 120, 8, 0.9, cond=True, **g3)
        k1_case(dev, "vocoder", 1, fuse, 120, 8, 0.9)
        k4_case(dev, "tiny_vocoder", 19, fuse, fuse, 40, 8, (8, 16),
                cond=True, **g3)
        k4_case(dev, "vocoder", 40, fuse, fuse, 60, 8, (8, 16), cond=True,
                **g3)
        k4_case(dev, "vocoder", 40, fuse, fuse, 60, 8, (8, 16))
    cfg = pt.get_config("vocoder", **g3)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), dev)
    M, steps = cfg.cond_channels, 2048
    w = gk.prepare_weights(params, cfg, True)
    prime = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    rings = torch.zeros(sum(gk.periods(cfg)) * cfg.residual_channels,
                        device=dev)
    cond, gcond = gk.project_cond(
        params, cfg, cond_rows(dev, (1, steps, M), 9),
        cond_rows(dev, (1, 3), 10, 1.0), 1, steps)
    for what, kw in (("no cond", {}), ("cond", dict(cond=cond)),
                     ("cond+gcond", dict(cond=cond, gcond=gcond))):
        ms = timed(lambda: gk.fused_cuda(w, cfg, prime, rings, 513, steps,
                                         0.9, 0.0, 1, True, **kw), 2)
        print(f"K1 vocoder {what}: {1e3 * ms / steps:.2f} us/step",
              flush=True)
    w = ghbm.prepare_weights(params, cfg, True, True)
    for lanes in (256,):
        prime = torch.zeros((lanes, 1), dtype=torch.int32, device=dev)
        ring = torch.zeros(ghbm.ring_rows(cfg), lanes, device=dev)
        temps = torch.full((lanes,), 0.9, device=dev)
        ids = torch.arange(lanes, dtype=torch.int32, device=dev)
        cond = cond_rows(dev, (steps, M, lanes), 11)
        gcond = ghbm.project_gcond(w, cfg, cond_rows(dev, (lanes, 3), 12),
                                   lanes)
        for what, kw in (("no cond", {}), ("cond", dict(cond=cond)),
                         ("cond+gcond", dict(cond=cond, gcond=gcond))):
            tm = torch.zeros(len(ghbm.PHASES), dtype=torch.int64, device=dev)
            ms = timed(lambda: ghbm.batched_cuda(
                w, cfg, prime, ring, 513, steps, temps, ids, ids, 0, 0.0,
                True, True, True, **kw), 2)
            ghbm.batched_cuda(w, cfg, prime, ring, 513, steps, temps, ids,
                              ids, 0, 0.0, True, True, True, timers=tm, **kw)
            torch.cuda.synchronize()
            split = ", ".join(f"{n} {v / (steps * 1e3):.2f}"
                              for n, v in zip(ghbm.PHASES, tm.tolist()))
            print(f"K4 vocoder {lanes} lanes {what}: "
                  f"{1e3 * ms / steps:.2f} us/step ({split} us)", flush=True)


def prime_calls(dev, reps=3):
    """A receptive-field prime at chaconne with and without the head on its
    teacher-forced steps, bitwise the same where read: K4 (fuse_res +
    skip_slab, the pool's flags; ``total = num_given``, the pool's prime
    call) at the 8-lane tile with each step's split, and K1 (fuse_res) at
    one stream, the prime alone and the stream's first 2048-sample chunk
    after it."""
    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), dev)
    ng = cfg.receptive_field
    w = ghbm.prepare_weights(params, cfg, True, True)
    for lanes in (1, 8, 16):
        prime = torch.from_numpy(np.random.default_rng(lanes).integers(
            0, cfg.classes, (lanes, ng))).to(dev, torch.int32)
        temps = torch.full((lanes,), 0.9, device=dev)
        ids = torch.arange(lanes, dtype=torch.int32, device=dev)
        zero = torch.zeros(lanes, dtype=torch.int32, device=dev)
        out = {}
        for head_from in (0, ng - 1):
            ring = torch.zeros(ghbm.ring_rows(cfg), lanes, device=dev)

            def call(tm=None):
                return ghbm.batched_cuda(
                    w, cfg, prime, ring, 0, ng, temps, ids, zero, 0, 0.0,
                    True, True, True, tile=8, timers=tm, head_from=head_from)
            ms = timed(call, reps)
            tm = torch.zeros(len(ghbm.PHASES), dtype=torch.int64, device=dev)
            ring.zero_()
            out[head_from] = (call(tm), ring.clone())
            torch.cuda.synchronize()
            split = ", ".join(f"{n} {v / (ng * 1e3):.2f}"
                              for n, v in zip(ghbm.PHASES, tm.tolist()))
            print(f"K4 prime {lanes} lanes tile 8 head_from {head_from}: "
                  f"{ms:.2f} ms, {1e3 * ms / ng:.2f} us/step ({split} us)",
                  flush=True)
        (c0, r0), (c1, r1) = out[0], out[ng - 1]
        expect(torch.equal(r0, r1) and torch.equal(c0[:, -1], c1[:, -1])
               and torch.equal(c1[:, :-1], prime[:, 1:]),
               f"K4 prime {lanes} lanes: headless ring and first sample "
               f"bitwise")
    w = gk.prepare_weights(params, cfg, True)
    prime = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.classes, (1, ng))).to(dev, torch.int32)
    for what, total in (("prime", ng), ("prime + 2048", ng - 1 + 2048)):
        out = {}
        for head_from in (0, ng - 1):
            rings = torch.zeros(sum(gk.periods(cfg))
                                * cfg.residual_channels, device=dev)
            ms = timed(lambda: gk.fused_cuda(
                w, cfg, prime, rings, 0, total, 0.9, 0.0, 1, True,
                head_from=head_from), reps)
            rings.zero_()
            out[head_from] = (gk.fused_cuda(
                w, cfg, prime, rings, 0, total, 0.9, 0.0, 1, True,
                head_from=head_from), rings.clone())
            torch.cuda.synchronize()
            print(f"K1 {what} 1 stream head_from {head_from}: {ms:.2f} ms, "
                  f"{1e3 * ms / total:.2f} us/step", flush=True)
        (c0, r0), (c1, r1) = out[0], out[ng - 1]
        expect(torch.equal(r0, r1)
               and torch.equal(c0[:, ng - 1:], c1[:, ng - 1:]),
               f"K1 {what}: headless rings and classes read bitwise")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--vocoder", action="store_true",
                      help="the conditioned cases alone")
    mode.add_argument("--prime", action="store_true",
                      help="time a chaconne prime with and without the head")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.time()
    for n, out in build.build(["gen_kernel", "gen_kernel_hbm"],
                              verbose=True).items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(n, line.strip())
    print(f"build {time.time() - t:.1f} s", flush=True)
    dev = torch.device("cuda")
    if args.vocoder or args.prime:
        (vocoder if args.vocoder else prime_calls)(dev)
        print(f"{len(failures)} failures")
        return 1 if failures else 0
    chaconne = pt.get_config("chaconne")
    for tile in ghbm.TILES:
        try:
            n = ghbm.max_active_clusters(chaconne, tile, True, True)
            print(f"K4 chaconne tile {tile}: "
                  f"{ghbm.shared_bytes(chaconne, tile, True)} B "
                  f"shared, max active clusters {n}")
        except ValueError as e:
            print(f"K4 chaconne tile {tile}: {e}")
    print(f"K1 chaconne: max active clusters "
          f"{gk.max_active_clusters(chaconne, True)}", flush=True)
    k4_case(dev, "tiny", 3, False, False, 40, 8, (8,))
    k4_case(dev, "tiny", 3, True, True, 40, 8, (8,))
    for k in (1, 3):
        k4_case(dev, "tiny", 19, False, False, 40, 8, (8, 16), kernel_size=k)
        k4_case(dev, "tiny", 19, True, True, 40, 8, (8, 24), kernel_size=k)
        k1_case(dev, "tiny", 3, False, 30, 8, 0.0, kernel_size=k)
        k1_case(dev, "tiny", 3, True, 30, 8, 1.0, kernel_size=k)
    k4_case(dev, "test_small", 130, True, True, 200, 8, ghbm.TILES)
    k4_case(dev, "test_small", 37, False, False, 200, 8, (8, 16))
    k1_case(dev, "tiny", 1, False, 30, 8, 0.0)
    k1_case(dev, "test_small", 3, True, 200, 8, 1.0)
    k1_case(dev, "chaconne", 8, True, 300, 8, 0.9)
    k1_case(dev, "saber", 2, False, 300, 8, 0.0)
    k4_case(dev, "chaconne", 200, True, True, 300, 8, ghbm.TILES)
    k4_case(dev, "chaconne", 256, False, False, 300, 8, (16,))
    k4_case(dev, "chaconne", 40, True, True, 200, 8, (8, 24), kernel_size=3)
    k4_case(dev, "chaconne", 20, True, True, 100, 8, (8,),
            residual_channels=64, dilation_channels=64)
    # one chaconne chunk of each kernel, and where a step's time goes
    params = pt.init_wavenet(chaconne, torch.Generator().manual_seed(0), dev)
    for lanes, sweep in ((256, ghbm.TILES), (1024, (16, 24)), (1, (8,))):
        w = ghbm.prepare_weights(params, chaconne, True, True)
        prime = torch.zeros((lanes, 1), dtype=torch.int32, device=dev)
        ring = torch.zeros(ghbm.ring_rows(chaconne), lanes, device=dev)
        temps = torch.full((lanes,), 0.9, device=dev)
        ids = torch.arange(lanes, dtype=torch.int32, device=dev)
        for tile in sweep:
            try:
                ms = timed(lambda: ghbm.batched_cuda(
                    w, chaconne, prime, ring, 513, 512, temps, ids, ids,
                    0, 0.0, True, True, True, tile=tile), 2)
            except ValueError as e:
                print(f"K4 {lanes} lanes tile {tile}: {e}")
                continue
            tm = torch.zeros(len(ghbm.PHASES), dtype=torch.int64, device=dev)
            ghbm.batched_cuda(w, chaconne, prime, ring, 513, 512, temps, ids,
                              ids, 0, 0.0, True, True, True, tile=tile,
                              timers=tm)
            torch.cuda.synchronize()
            split = ", ".join(f"{n} {v / 512e3:.2f}"
                              for n, v in zip(ghbm.PHASES, tm.tolist()))
            print(f"K4 chaconne {lanes} lanes tile {tile}: "
                  f"{1e3 * ms / 512:.2f} us/step ({split} us)", flush=True)
    w = gk.prepare_weights(params, chaconne, True)
    prime = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    rings = torch.zeros(sum(gk.periods(chaconne))
                        * chaconne.residual_channels, device=dev)
    ms = timed(lambda: gk.fused_cuda(w, chaconne, prime, rings, 3070,
                                     1024, 0.9, 0.0, 1, True), 2)
    print(f"K1 chaconne: {1e3 * ms / 1024:.2f} us/step", flush=True)
    print(f"{len(failures)} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
