"""The port's one-line metric: single-stream generation throughput on one
card (the JAX package's ``bench.py``).

Reference baseline: Fast-WaveNet generation on the 10x4 config runs at
about 81 samples/s (12.3 ms/step, the reference's profiling.ipynb cell 5;
timing print at reference wavenet_model.py:304-306). Same model config
here (``saber``), one stream, a full receptive field of prime, 65536
samples at temperature 1 through the fused generation kernel K1
(``ops/cuda/gen_kernel.py``, ``fuse_res``): best of 2 timed calls after a
warm one, each ending in the samples' copy to the host.

Prints ONE JSON line ``{"metric", "value", "unit", "vs_baseline"}`` and
then, on standard error, a ``#`` line with µs per step, the card's name
and its power limit. Without a card it raises and prints no metric; a
kernel that fails to build or launch raises too. There is no fallback to
the CPU or to the plain version.

  python -m pytorch_wavenet_tpu_torch.bench
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

BASELINE_SAMPLES_PER_SEC = 81.0  # the reference on a CPU, profiling.ipynb
METRIC = "fast_generation_throughput_1stream_10x4"


def measure(num_samples: int = 65536, reps: int = 2, seed: int = 0) -> dict:
    """Time K1 on ``saber`` (random weights from ``seed``, a random prime
    of one receptive field): ``{"samples_per_s", "best_s", "us_per_step",
    "launches"}``, the launches those of the timed and warm calls."""
    from . import get_config, init_wavenet
    from .device import resolve_device
    from .ops.cuda import gen_kernel as gk

    dev = resolve_device("cuda")
    cfg = get_config("saber")
    params = init_wavenet(cfg, torch.Generator().manual_seed(seed), dev)
    prime = torch.randint(0, cfg.classes, (1, cfg.receptive_field),
                          generator=torch.Generator().manual_seed(seed + 2))

    def run(key):
        wav, _ = gk.generate_fast_fused(params, cfg, key, num_samples, prime,
                                        temperature=1.0, fuse_res=True,
                                        device=dev)
        return wav.cpu()  # the samples on the host end the call

    before = gk.launches
    run(seed)  # builds and loads the kernel
    best = float("inf")
    for rep in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(100 + rep)
        best = min(best, time.perf_counter() - t0)
    total_steps = cfg.receptive_field - 1 + num_samples
    return {"samples_per_s": num_samples / best, "best_s": best,
            "us_per_step": best * 1e6 / total_steps,
            "launches": gk.launches - before}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--num-samples", type=int, default=65536)
    args = p.parse_args(argv)
    from .device import card_description

    r = measure(args.num_samples)
    print(json.dumps({
        "metric": METRIC,
        "value": round(r["samples_per_s"], 1),
        "unit": "samples/s",
        "vs_baseline": round(r["samples_per_s"] / BASELINE_SAMPLES_PER_SEC, 2),
    }), flush=True)
    print(f"# {r['us_per_step']:.2f} us/step, {args.num_samples} samples in "
          f"{r['best_s']:.3f} s, kernel=K1 gen_kernel.cu (fuse_res), "
          f"launches={r['launches']}, realtime_x16kHz="
          f"{r['samples_per_s'] / 16000:.2f}, card: {card_description()}",
          file=sys.stderr, flush=True)
    return r


if __name__ == "__main__":
    main()
