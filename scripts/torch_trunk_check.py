#!/usr/bin/env python3
"""Quick check of the port's training-trunk kernels K2 and K3 on one CUDA
card: build them with ``-Xptxas -v`` (registers, spills, shared memory),
hold each against its plain PyTorch version at a few shapes with f32 and
bf16 saves, without and with local conditioning (units, saves on each
layer's window, gradients, dW_cond and dcond, two K3 calls bitwise equal),
then time K2 and K3 at chaconne_wide and at the vocoder (without and with
its 80 mel channels), batch 16, out 1024 with bf16 saves (CUDA events) and
split their device time by CUDA kernel (``torch.profiler``).
``chip_smoke.py`` runs the full checks.

  python3 scripts/torch_trunk_check.py               # checks, times, split
  python3 scripts/torch_trunk_check.py --times-only  # times and split
  python3 scripts/torch_trunk_check.py --times-only --root _checkout/parent
  python3 scripts/torch_trunk_check.py --times-only --reps 20

``--root`` takes the package from another checkout (for example an older
commit unpacked with ``git archive`` under the ignored ``_checkout/``), so
two versions are timed with the same script in one call on one card.
"""

import argparse
import importlib.util
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _smoke():
    """This checkout's ``chip_smoke.py`` (its bounds and profiler split),
    loaded by path so that ``--root`` cannot shadow it."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def case(torch, pt, tk, dev, name, N, out, **kw):
    """K2/K3 against their plain versions; with ``cond_channels`` in ``kw``
    the kernels take random cond rows and K3 gives dW_cond and dcond."""
    cfg = pt.get_config(name, **kw)
    p = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), dev)
    T = cfg.receptive_field + out - 1
    g = torch.Generator().manual_seed(1)
    h0 = (torch.rand((N, T, cfg.residual_channels), generator=g) * 2
          - 1).to(dev)
    du = (torch.rand((N, out, cfg.num_layers * cfg.dilation_channels),
                     generator=g) * 2e-3 - 1e-3).to(dev)
    cond = (torch.randn((N, T, cfg.cond_channels), generator=g).to(dev)
            if cfg.cond_channels else None)
    c = {"cond": cond} if cond is not None else {}
    _, sp = tk.windows(cfg, out)
    for sd in (torch.float32, torch.bfloat16):
        uk, sk = tk.trunk_fwd_cuda(p, cfg, h0, out, sd, **c)
        torch.cuda.synchronize()
        up, spl = tk.trunk_fwd_plain(p, cfg, h0, out, sd, **c)
        eu = float(((uk - up).abs() / up.abs().clamp(min=1)).max())
        es = max(float((sk[l][:, sp[l]:].float()
                        - spl[l][:, sp[l]:].float()).abs().max())
                 for l in range(cfg.num_layers))
        gk = tk.trunk_bwd_cuda(p, cfg, sk, du, out, **c)
        gk2 = tk.trunk_bwd_cuda(p, cfg, sk, du, out, **c)
        torch.cuda.synchronize()
        gp = tk.trunk_bwd_plain(p, cfg, sk, du, out, **c)
        rep = all(torch.equal(a, b) for a, b in zip(gk, gk2))
        eg = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                 for a, b in zip(gk, gp))
        print(f"{name} N={N} out={out} {kw} {sd}: u err {eu:.3g}, save err "
              f"{es:.3g}, grad err {eg:.3g}, K3 repeats bitwise: {rep}",
              flush=True)
        if not (eu <= 1e-5 and eg <= 1e-5 and rep):
            raise SystemExit("K2/K3 disagree with their plain versions")


def times(torch, pt, tk, smoke, dev, card, tag, name="chaconne_wide",
          cond=False, reps=5):
    """K2 and K3 at ``name``, batch 16, out 1024, bf16 saves (with the
    preset's cond channels under ``cond``): CUDA events (min of ``reps``
    warm calls) and the profiler's split by kernel."""
    cfg, p, h0, du = smoke._trunk_case(torch, pt, dev, name, 16, 1024)
    out = cfg.output_length
    c = {}
    if cond:
        g = torch.Generator().manual_seed(3)
        c["cond"] = torch.randn(h0.shape[:2] + (cfg.cond_channels,),
                                generator=g).to(dev)
    _, saves = tk.trunk_fwd_cuda(p, cfg, h0, out, torch.bfloat16, **c)
    bounds = smoke.trunk_bounds(cfg, 16, out,
                                cond_channels=cfg.cond_channels if cond
                                else 0)
    fns = {"K2": lambda: tk.trunk_fwd_cuda(p, cfg, h0, out, torch.bfloat16,
                                           **c),
           "K3": lambda: tk.trunk_bwd_cuda(p, cfg, saves, du, out, **c)}
    what = f"{name}{' cond' if cond else ''}"
    for lab, fn in fns.items():
        ms = min(smoke._time(torch, fn, reps))
        b_ms, b_by = bounds[lab]
        print(f"[{tag}] {lab} {what} batch 16 out 1024 bf16 saves: "
              f"{ms:.3f} ms (min of {reps}); bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / ms:.2f} % of it [{card}]", flush=True)
        split = smoke.kernel_split(torch, fn)
        if not split:
            print(f"[{tag}] {lab} split: the profiler saw no device time",
                  flush=True)
        for kname, (k_ms, n) in sorted(split.items(),
                                       key=lambda x: -x[1][0]):
            print(f"[{tag}] {lab} {what} split: "
                  f"{smoke.short_kernel_name(kname)} "
                  f"{k_ms:.3f} ms in {n:g} launches per call "
                  f"({k_ms / n * 1e3:.1f} us each) [{card}]", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO,
                    help="checkout whose pytorch_wavenet_tpu_torch to test")
    ap.add_argument("--times-only", action="store_true",
                    help="skip the checks against the plain versions")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed calls per kernel (the minimum is printed)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smoke = _smoke()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import pytorch_wavenet_tpu_torch as pt
    from pytorch_wavenet_tpu_torch.ops.cuda import build
    from pytorch_wavenet_tpu_torch.ops.cuda import trunk_kernel as tk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    tag = os.path.relpath(root, REPO)
    tag = "this tree" if tag == "." else tag
    print(f"package from {tag}: {os.path.dirname(pt.__file__)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.time()
    for n, out in build.build(["trunk_fwd", "trunk_bwd"],
                              verbose=True).items():
        for line in out.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "entry function" in line):
                print(n, line.strip())
    print(f"build {time.time() - t:.1f} s", flush=True)
    has_cond = hasattr(tk, "cond_width")  # an older --root has no cond
    if hasattr(tk, "bwd_plan"):  # the kernels' shared memory, both sides
        fl, bl = tk._bind("trunk_fwd"), tk._bind("trunk_bwd")
        rows = [("chaconne_wide", {}, 0),
                ("chaconne_wide", {"residual_channels": 64,
                                   "dilation_channels": 64}, 0)]
        if has_cond:
            rows += [("vocoder", {}, 80), ("tiny_vocoder", {}, 8),
                     ("test_small", {"residual_channels": 128,
                                     "dilation_channels": 128}, 20)]
        # a checkout with bf16 streams: both streams' layouts of K2
        streams = ((0, 1) if hasattr(tk, "bf16_stream") else (None,))
        for (name, kw, M), bs in ((r, s) for r in rows for s in streams):
            c = pt.get_config(name, **kw, **(
                {"stream_dtype": torch.bfloat16} if bs else {}))
            Rp, Dp, k = *tk.padded_widths(c), c.kernel_size
            mp = (tk.cond_width(M),) if has_cond else ()
            fb = () if bs is None else (bool(bs),)
            f, b = tk.fwd_plan(c, *mp), tk.bwd_plan(c, *mp)
            pf = tk.fwd_smem(f[0], k, Rp, Dp, f[1], *mp, *fb)
            pb = tk.bwd_smem(b[0], k, Rp, Dp, *b[1:], *mp)
            cf = fl.wavenet_trunk_fwd_smem(f[0], k, Rp, Dp, *mp, int(f[1]),
                                           *(() if bs is None else (bs,)))
            cb = bl.wavenet_trunk_bwd_smem(b[0], k, Rp, Dp, *mp,
                                           *map(int, b[1:]))
            print(f"{name} {kw} Mp {mp[0] if mp else 0}"
                  f"{' bf16 stream' if bs else ''}: K2 plan {f} {cf} B of "
                  f"shared memory, K3 plan {b} {cb} B", flush=True)
            if (pf, pb) != (cf, cb):
                raise SystemExit(f"shared memory: Python {pf}, {pb}, "
                                 f"the kernels {cf}, {cb}")
    dev = torch.device("cuda")
    if not args.times_only:
        for name, N, out, kw in (
                ("tiny", 3, 20, {}),
                ("tiny", 2, 20, {"kernel_size": 3, "bias": False}),
                ("test_small", 3, 128, {}),
                ("test_small", 2, 64, {"residual_channels": 12,
                                       "dilation_channels": 20}),
                ("chaconne_wide", 2, 64, {"residual_channels": 64,
                                          "dilation_channels": 64}),
                ("chaconne_wide", 3, 64, {"kernel_size": 3}),
                ("chaconne_wide", 16, 1024, {})):
            case(torch, pt, tk, dev, name, N, out, **kw)
        if has_cond:
            for name, N, out, kw in (
                    ("tiny_vocoder", 3, 20, {}),
                    ("tiny_vocoder", 2, 20, {"kernel_size": 3,
                                             "cond_channels": 20}),
                    ("test_small", 2, 64, {"residual_channels": 12,
                                           "dilation_channels": 20,
                                           "cond_channels": 3}),
                    ("test_small", 2, 64, {"residual_channels": 128,
                                           "dilation_channels": 128,
                                           "cond_channels": 80}),
                    ("vocoder", 4, 1024, {})):
                case(torch, pt, tk, dev, name, N, out, **kw)
    times(torch, pt, tk, smoke, dev, card, tag, reps=args.reps)
    if has_cond:  # an older --root refuses the vocoder's cond channels
        times(torch, pt, tk, smoke, dev, card, tag, "vocoder", reps=args.reps)
        times(torch, pt, tk, smoke, dev, card, tag, "vocoder", cond=True,
              reps=args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
