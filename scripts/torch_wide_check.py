#!/usr/bin/env python3
"""The on-card checks of the port's wide-chain generation kernel KW
(``csrc/gen_kernel_wide.cu``), the one copy that ``chip_smoke.py``'s phase
47 and ``tests/test_torch_gpu_wnv.py`` run. Run alone, it builds the kernel
with ``-Xptxas -v`` (registers, shared memory, spills), then
:func:`run_checks`: KW against its plain version
(``gen_kernel_hbm.batched_plain``) at ``tiny_wnv`` and ``wnv512`` (classes
off near-ties of 1e-4, rings within 1e-4, the previous-class row exactly),
from a fresh ring and resumed past every period, at lane counts on and off
a multiple of 4 up to the pool's 256; a lane's classes and ring the same
bits at 1, 40 and 256 lanes; ``wnv512`` steps at 256 lanes timed with the
split of a step from the kernel's timers; ``wnv512`` served through the
lane pool in frames mode (each request bitwise its solo
``generate_fast_batched`` call, the wide kernel launched and K4 not) and
through ``generate_fast_fused`` (one lane on the wide kernel); and
``chaconne`` still on K4. About two minutes with the build. ``--digest
--root DIR`` prints instead a digest of chaconne's K4 and K1 classes and
rings from the package under DIR (a checkout of another commit unpacked
with ``git archive``), so two commits compare in one call.

  python3 scripts/torch_wide_check.py [--steps N]
  python3 scripts/torch_wide_check.py --digest [--root DIR]
"""

import argparse
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if "--root" in sys.argv:
    ROOT = sys.argv[sys.argv.index("--root") + 1]
sys.path.insert(0, ROOT)

import hashlib  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import pytorch_wavenet_tpu_torch as pt  # noqa: E402
from pytorch_wavenet_tpu_torch.ops.cuda import build  # noqa: E402
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel as gk  # noqa: E402
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as ghbm  # noqa: E402

try:
    from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_wide as kw
except ImportError:  # an older checkout under --root: --digest only
    kw = None

NEAR_TIE, RING_TOL = 1e-4, 1e-4
failures = []


def expect(cond, msg):
    print(("ok   " if cond else "FAIL ") + msg, flush=True)
    if not cond:
        failures.append(msg)


def model(name, dev, seed=0):
    cfg = pt.get_config(name)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(seed), dev)
    g = torch.Generator().manual_seed(seed + 1)
    params["cond_up"] = {"w": (torch.rand(cfg.cond_hop, generator=g)
                               + 0.5).to(dev),
                         "b": (torch.rand(1, generator=g) - 0.5).to(dev)}
    return cfg, params, ghbm.prepare_weights(params, cfg, False, False)


def lane_inputs(cfg, lanes, n_prime, total, seed, dev):
    """Per-lane prime, temperature, seed, clock and cond rows, each lane's
    drawn from its own index so a lane's inputs do not depend on the
    lane count."""
    prime, cond = [], []
    for s in range(lanes):
        rng = np.random.default_rng([seed, s])
        prime.append(rng.integers(0, cfg.classes, n_prime))
        cond.append(0.5 * rng.standard_normal((total, cfg.cond_channels)))
    prime = torch.tensor(np.stack(prime), dtype=torch.int32, device=dev)
    cond = torch.tensor(np.stack(cond), dtype=torch.float32, device=dev)
    temps = torch.tensor([[1.0, 0.0, 0.7][s % 3] for s in range(lanes)],
                         device=dev)
    seeds = torch.arange(lanes, dtype=torch.int32, device=dev) * 7 + 3
    toffs = torch.arange(lanes, dtype=torch.int32, device=dev) % 5
    return prime, temps, seeds, toffs, cond.permute(1, 2, 0).contiguous()


def against_plain(dev, name, lanes, n_prime, steps, t0=0):
    """KW against its plain version. At ``t0`` > 0 both resume from one
    seeded ring (every layer's slots and the previous-class row) past every
    period, as the pool's chunks do."""
    cfg, params, w = model(name, dev)
    total = n_prime - 1 + steps
    prime, temps, seeds, toffs, cond = lane_inputs(cfg, lanes, n_prime,
                                                   total, 1, dev)
    rk = torch.zeros((ghbm.ring_rows(cfg), lanes), device=dev)
    if t0:
        g = torch.Generator().manual_seed(t0)
        rk.copy_(0.5 * torch.randn(rk.shape, generator=g))
        rk[-1] = torch.randint(1, cfg.classes + 1, (lanes,), generator=g)
    rp = rk.clone()
    got = kw.wide_cuda(w, cfg, prime, rk, t0, total, temps, seeds, toffs, 11,
                       0.0, True, cond=cond, head_from=n_prime - 1)
    with torch.no_grad():
        want, gaps = ghbm.batched_plain(
            w, cfg, prime, rp, t0, total, temps, seeds, toffs, 11, 0.0, False,
            False, True, return_gaps=True, cond=cond, head_from=n_prime - 1)
    torch.cuda.synchronize()
    sure = gaps > NEAR_TIE
    diff = (got != want) & sure
    ring_err = float((rk[:-1] - rp[:-1]).abs().max())
    expect(not bool(diff.any()) and ring_err < RING_TOL
           and torch.equal(rk[-1], rp[-1]),
           f"{name} {lanes} lanes, prime {n_prime}, {steps} steps from "
           f"t0 {t0}: {int(diff.sum())} classes off near-ties, ring err "
           f"{ring_err:.2e}, previous-class row equal "
           f"{torch.equal(rk[-1], rp[-1])} ({int((~sure).sum())} near-ties)")


def lane_bits(dev, name, n_prime, steps):
    """Lane 0..39's classes and ring at 1, 40 and 256 lanes: the same
    bits."""
    cfg, params, w = model(name, dev)
    total = n_prime - 1 + steps
    big = lane_inputs(cfg, 256, n_prime, total, 2, dev)
    res = {}
    for lanes in (1, 40, 256):
        prime, temps, seeds, toffs = (x[:lanes].contiguous()
                                      for x in big[:4])
        cond = big[4][:, :, :lanes].contiguous()
        ring = torch.zeros((ghbm.ring_rows(cfg), lanes), device=dev)
        cls = kw.wide_cuda(w, cfg, prime, ring, 0, total, temps, seeds,
                           toffs, 5, 0.0, True, cond=cond,
                           head_from=n_prime - 1)
        res[lanes] = (cls, ring)
    torch.cuda.synchronize()
    base_cls, base_ring = res[40]
    for lanes, (cls, ring) in res.items():
        n = min(40, lanes)
        expect(torch.equal(cls[:n], base_cls[:n])
               and torch.equal(ring[:, :n], base_ring[:, :n]),
               f"{name}: {lanes} lanes give lane 0..{n - 1}'s classes and "
               f"ring bitwise")


def timing(dev, steps, lanes=256, reps=3):
    cfg, params, w = model("wnv512", dev)
    prime, temps, seeds, toffs, cond = lane_inputs(cfg, lanes, 1, steps, 3,
                                                   dev)
    ring = torch.zeros((ghbm.ring_rows(cfg), lanes), device=dev)
    timers = torch.zeros(len(kw.PHASES), dtype=torch.int64, device=dev)
    kw.wide_cuda(w, cfg, prime, ring, 0, 8, temps, seeds, toffs, 5, 0.0,
                 True, cond=cond[:8].contiguous())
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        kw.wide_cuda(w, cfg, prime, ring, 64, steps, temps, seeds, toffs, 5,
                     0.0, True, cond=cond, timers=timers)
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    per = min(ms) / steps * 1e3
    split = timers.cpu().numpy() / (reps * steps) / 1e3
    print(f"wnv512 {lanes} lanes, {steps} steps: {min(ms):.2f} ms "
          f"(runs {[round(x, 2) for x in ms]}), {per:.1f} us/step, "
          f"{lanes / per:.3f} M lane-steps/s; split (us/step, block 0): "
          + ", ".join(f"{n} {v:.1f}" for n, v in zip(kw.PHASES, split)),
          flush=True)
    flops = 88_489_984 * lanes
    least = max(flops / 495e12, (4 * cfg.parameter_count() + lanes
                                 * cfg.num_layers * 2 * cfg.residual_channels
                                 * 4) / 3.35e12)
    print(f"  operations {flops / per / 1e6:.1f} TFLOP/s; least step "
          f"{least * 1e6:.1f} us", flush=True)
    named = dict(zip(kw.PHASES, split))
    expect(all(named[p] > 0 for p in kw.PHASES if p != "input rows"),
           "the kernel's timers split every step into its phases")
    return {"ms": min(ms), "us_per_step": per, "bound_ms": least * steps * 1e3,
            "split": dict(zip(kw.PHASES, split.round(2).tolist()))}


def pool_vs_solo(dev, lanes=8, chunk=256):
    """wnv512 through ContinuousBatcher in frames mode (cond_hop 80): each
    request bitwise its solo generate_fast_batched call on the frames
    expanded over its whole timeline; the wide kernel launched, K4 not.
    Returns the pool run's own KW launches (the modules' counters are set
    to 0 just before it) and its ``stats()``."""
    from pytorch_wavenet_tpu_torch.ops import mel
    from pytorch_wavenet_tpu_torch.serving import ContinuousBatcher

    cfg, params, _ = model("wnv512", dev)
    rng = np.random.default_rng(7)
    reqs = []
    for i, (plen, n) in enumerate([(1, 700), (1, 300), (5, 520), (1, 610),
                                   (1, 260), (3, 430), (1, 390), (1, 800),
                                   (1, 350), (1, 480)]):
        prime = (np.full(1, cfg.classes // 2) if plen == 1 else
                 rng.integers(0, cfg.classes, plen)).astype(np.int32)
        total = plen - 1 + n
        frames = rng.standard_normal((-(-total // 80), cfg.cond_channels)
                                     ).astype(np.float32)
        reqs.append((prime, n, [1.0, 1.0, 0.0][i % 3], 90 + i, frames))
    ghbm.launches = kw.launches = 0
    b = ContinuousBatcher(params, cfg, lanes=lanes, chunk=chunk, cond_hop=80,
                          device=dev)
    try:
        hs = [b.submit(p, n, temperature=t, seed=sd, cond_frames=f)
              for p, n, t, sd, f in reqs]
        got = [np.asarray(h.result(timeout=600)[1]) for h in hs]
        st = b.stats()
    finally:
        b.close()
    pooled_k4, pooled = ghbm.launches, kw.launches
    same = 0
    for (p, n, t, sd, f), cls in zip(reqs, got):
        rows = mel.upsample_frames_phase(
            params["cond_up"], torch.from_numpy(f).to(dev), 80, len(p) - 1 + n)
        _, want = pt.generate_fast_batched(
            params, cfg, 0, n, p[None], temperature=t, lane_seed=[sd],
            cond=rows[None], device=dev)
        same += int(np.array_equal(cls, want[0].cpu().numpy()))
    expect(same == len(reqs) and st["wide_launches"] > 0 and pooled_k4 == 0,
           f"wnv512 pool in frames mode, {lanes} lanes, chunk {chunk}: "
           f"{same}/{len(reqs)} requests bitwise their solo rollouts; "
           f"wide_launches {st['wide_launches']}, K4 launches {pooled_k4}, "
           f"pool_steps {st['pool_steps']}, prime_calls {st['prime_calls']}, "
           f"t_chunk_device {st['t_chunk_device']} s, t_prime_device "
           f"{st['t_prime_device']} s")
    return {"launches": pooled, "stats": st}


def one_stream(dev):
    """generate_fast_fused at wnv512: one lane on the wide kernel, chunks
    resumed bitwise."""
    cfg, params, _ = model("wnv512", dev)
    prime = np.array([[128, 131, 127]], np.int32)
    rows = torch.randn(1, 2 + 300, cfg.cond_channels,
                       generator=torch.Generator().manual_seed(3)).to(dev)
    wide = kw.launches
    _, whole = gk.generate_fast_fused(params, cfg, 5, 300, prime,
                                      device=dev, cond=rows)
    _, a, st = gk.generate_fast_fused(params, cfg, 5, 100, prime, device=dev,
                                      cond=rows[:, :102], return_state=True)
    _, b = gk.generate_fast_fused(params, cfg, 5, 200, None, device=dev,
                                  cond=rows[:, 102:], state=st)
    expect(torch.equal(torch.cat([a, b], 1), whole) and kw.launches - wide == 3,
           f"wnv512 one stream through generate_fast_fused: chunks resume "
           f"bitwise, {kw.launches - wide} wide launches")


def chaconne_k4(dev):
    """chaconne still runs on K4's cluster core, not the wide kernel."""
    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), dev)
    k4, wide = ghbm.launches, kw.launches
    pt.generate_fast_batched(params, cfg, 0, 64, np.full((256, 1), 128),
                             device=dev, lane_seed=np.arange(256))
    w = ghbm.prepare_weights(params, cfg, False, False)
    expect(ghbm.launches - k4 == 1 and kw.launches == wide
           and ghbm.ring_rows(cfg) == sum(gk.periods(cfg)) * 32
           and not ghbm.is_wide(w) and "chain" in w,
           "chaconne at 256 lanes launches K4 (not the wide kernel), its "
           "ring without a previous-class row, its weights K4's")


PLAIN_CASES = (  # name, lanes, prime, steps, t0
    ("tiny_wnv", 1, 1, 20, 0), ("tiny_wnv", 5, 6, 24, 0),
    ("tiny_wnv", 64, 3, 16, 0), ("tiny_wnv", 70, 3, 16, 0),
    ("tiny_wnv", 64, 1, 16, 5000), ("wnv512", 3, 4, 6, 0),
    ("wnv512", 256, 1, 8, 0), ("wnv512", 256, 1, 8, 5000))
LANE_BITS_CASES = (("tiny_wnv", 4, 12), ("wnv512", 2, 4))


def run_checks(dev, steps):
    """Every check above; returns the timing's and the pool run's
    figures."""
    for case in PLAIN_CASES:
        against_plain(dev, *case)
    for case in LANE_BITS_CASES:
        lane_bits(dev, *case)
    t = timing(dev, steps)
    pool = pool_vs_solo(dev)
    one_stream(dev)
    chaconne_k4(dev)
    return t, pool


def digest(dev):
    """A digest of chaconne's K4 (256 lanes, fuse_res + skip_slab, 2048
    steps at T 1 and 0) and K1 (3070-class prime, 2048 steps) classes and
    rings, from the package on the path."""
    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), dev)
    h = hashlib.sha256()
    temps = np.tile([1.0, 1.0, 1.0, 0.0], 64)
    _, cls, st = pt.generate_fast_batched(
        params, cfg, 0, 2048, np.full((256, 1), 128), temperature=temps,
        lane_seed=np.arange(256) * 3 + 1, return_state=True, fuse_res=True,
        skip_slab=True, device=dev)
    h.update(cls.cpu().numpy().tobytes())
    h.update(st.ring.cpu().numpy().tobytes())
    prime = np.random.default_rng(1).integers(0, 256, (1, 3070))
    _, cls, st = gk.generate_fast_fused(params, cfg, 9, 2048, prime,
                                        return_state=True, fuse_res=True,
                                        device=dev)
    h.update(cls.cpu().numpy().tobytes())
    for r in st.rings:
        h.update(r.cpu().numpy().tobytes())
    print(f"chaconne K4 + K1 digest from {os.path.abspath(ROOT)}: "
          f"{h.hexdigest()}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--digest", action="store_true")
    ap.add_argument("--root", default=ROOT)
    a = ap.parse_args()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if a.digest:
        digest(dev)
        return 0
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda,
          flush=True)
    t = time.time()
    logs = build.build(["gen_kernel_wide"], verbose=True)
    print(f"build {time.time() - t:.1f} s", flush=True)
    for line in logs["gen_kernel_wide"].splitlines():
        if any(k in line for k in ("registers", "spill", "Compiling",
                                   "warning", "error")):
            print("  " + line.strip(), flush=True)
    run_checks(dev, a.steps)
    print(f"{len(failures)} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
