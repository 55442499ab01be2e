#!/usr/bin/env python3
"""Quick check of the port's training-trunk kernels K2 and K3 on one CUDA
card: build them with ``-Xptxas -v`` (registers, spills), hold each
against its plain PyTorch version at a few shapes with f32 and bf16 saves
(units, saves on each layer's window, gradients, two K3 calls bitwise
equal), and time 5 back-to-back calls at chaconne_wide, batch 16.
``chip_smoke.py`` runs the full checks; this takes about 20 s.

  python3 scripts/torch_trunk_check.py
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

import pytorch_wavenet_tpu_torch as pt  # noqa: E402
from pytorch_wavenet_tpu_torch.ops.cuda import build  # noqa: E402
from pytorch_wavenet_tpu_torch.ops.cuda import trunk_kernel as tk  # noqa: E402


def case(dev, name, N, out, **kw):
    cfg = pt.get_config(name, **kw)
    p = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), dev)
    T = cfg.receptive_field + out - 1
    g = torch.Generator().manual_seed(1)
    h0 = (torch.rand((N, T, cfg.residual_channels), generator=g) * 2
          - 1).to(dev)
    du = (torch.rand((N, out, cfg.num_layers * cfg.dilation_channels),
                     generator=g) * 2e-3 - 1e-3).to(dev)
    _, sp = tk.windows(cfg, out)
    for sd in (torch.float32, torch.bfloat16):
        uk, sk = tk.trunk_fwd_cuda(p, cfg, h0, out, sd)
        torch.cuda.synchronize()
        up, spl = tk.trunk_fwd_plain(p, cfg, h0, out, sd)
        eu = float(((uk - up).abs() / up.abs().clamp(min=1)).max())
        es = max(float((sk[l][:, sp[l]:].float()
                        - spl[l][:, sp[l]:].float()).abs().max())
                 for l in range(cfg.num_layers))
        gk = tk.trunk_bwd_cuda(p, cfg, sk, du, out)
        gk2 = tk.trunk_bwd_cuda(p, cfg, sk, du, out)
        torch.cuda.synchronize()
        gp = tk.trunk_bwd_plain(p, cfg, sk, du, out)
        rep = all(torch.equal(a, b) for a, b in zip(gk, gk2))
        eg = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                 for a, b in zip(gk, gp))
        print(f"{name} N={N} out={out} {kw} {sd}: u err {eu:.3g}, save err "
              f"{es:.3g}, grad err {eg:.3g}, K3 repeats bitwise: {rep}",
              flush=True)
        if not (eu <= 1e-5 and eg <= 1e-5 and rep):
            raise SystemExit("K2/K3 disagree with their plain versions")
        if N == 16:
            for fn, lab in ((lambda: tk.trunk_fwd_cuda(p, cfg, h0, out, sd),
                             "K2"),
                            (lambda: tk.trunk_bwd_cuda(p, cfg, sk, du, out),
                             "K3")):
                fn()
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(5):
                    fn()
                b.record()
                torch.cuda.synchronize()
                print(f"{lab} {sd}: {a.elapsed_time(b) / 5:.3f} ms per call",
                      flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.time()
    for n, out in build.build(["trunk_fwd", "trunk_bwd"],
                              verbose=True).items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                print(n, line.strip())
    print(f"build {time.time() - t:.1f} s")
    dev = torch.device("cuda")
    case(dev, "tiny", 3, 20)
    case(dev, "tiny", 2, 20, kernel_size=3, bias=False)
    case(dev, "test_small", 3, 128)
    case(dev, "chaconne_wide", 3, 64, kernel_size=3)
    case(dev, "chaconne_wide", 16, 1024)
    return 0


if __name__ == "__main__":
    sys.exit(main())
