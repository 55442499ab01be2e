"""The inputs of a run, made from ``--seed``: the weights, a synthetic
signal that primes are cut from, and the seeds of the streams that need
one. The program and the reference get the same tensors.

The weights are the stacked layout that ``pytorch_wavenet_tpu_torch``
takes (``models/wavenet.py``): Conv1d's default init, U(-s, s) with s =
1/sqrt(fan_in), drawn on the device by a ``torch.Generator`` in one call.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK63 = (1 << 63) - 1

# stream numbers of the sub-seeds derived from --seed
WEIGHTS, SIGNAL, TRAFFIC, CHECK = 1, 2, 3, 4


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one use of ``seed`` (any whole number)."""
    ss = np.random.SeedSequence([int(seed) & ((1 << 64) - 1), stream])
    return int(ss.generate_state(2, np.uint64)[0]) & MASK63


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, stream))


def leaf_specs(model: dict) -> list:
    """``(path, shape, fan_in)`` of every leaf, the port's layout."""
    L = model["layers"] * model["blocks"]
    k = model.get("kernel_size", 2)
    R, D = model["residual_channels"], model["dilation_channels"]
    S, E = model["skip_channels"], model["end_channels"]
    C = model.get("classes", 256)
    specs = [
        (("start", "w"), (C, R), C),
        (("layers", "w_in"), (L, k, R, 2 * D), R * k),
        (("layers", "w_res"), (L, D, R), D),
        (("layers", "w_skip"), (L, D, S), D),
        (("end1", "w"), (S, E), S),
        (("end1", "b"), (E,), S),
        (("end2", "w"), (E, C), E),
        (("end2", "b"), (C,), E),
    ]
    if model.get("bias", False):
        specs += [
            (("start", "b"), (R,), C),
            (("layers", "b_in"), (L, 2 * D), R * k),
            (("layers", "b_res"), (L, R), D),
            (("layers", "b_skip"), (L, S), D),
        ]
    return specs


def make_weights(model: dict, seed: int, device) -> dict:
    """The params tree, drawn on ``device`` from ``seed`` (f32)."""
    specs = leaf_specs(model)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    flat = torch.rand(sum(sizes), generator=g, device=device,
                      dtype=torch.float32)
    tree: dict = {}
    for (path, shape, fan_in), part in zip(specs, flat.split(sizes)):
        s = 1.0 / math.sqrt(fan_in)
        tree.setdefault(path[0], {})[path[1]] = (
            part.view(shape) * (2 * s) - s).contiguous()
    return tree


def make_signal(seed: int, length: int, classes: int, device) -> torch.Tensor:
    """A synthetic clip of ``length`` samples, mu-law coded into
    ``classes`` classes (int64, on ``device``): a few sinusoids whose
    frequencies and levels drift, plus noise, as speech or music would."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, SIGNAL))
    n_tones = 6
    draws = torch.rand(4 * n_tones + 1, generator=g, device=device)
    f0 = 60.0 + 900.0 * draws[:n_tones]                 # Hz at 16 kHz
    amp = 0.1 + 0.3 * draws[n_tones:2 * n_tones]
    phase = 2 * math.pi * draws[2 * n_tones:3 * n_tones]
    wobble = 0.2 + 2.0 * draws[3 * n_tones:4 * n_tones]  # Hz
    t = torch.arange(length, device=device, dtype=torch.float32) / 16000.0
    env = 0.55 + 0.45 * torch.sin(2 * math.pi * wobble[:, None] * t[None, :])
    x = (amp[:, None] * env * torch.sin(2 * math.pi * f0[:, None] * t[None, :]
                                        + phase[:, None])).sum(0)
    x = x + 0.05 * torch.randn(length, generator=g, device=device)
    x = x / x.abs().max()
    mu = classes - 1
    y = torch.sign(x) * torch.log1p(mu * x.abs()) / math.log1p(mu)
    return torch.clamp(((y + 1) / 2 * mu + 0.5).long(), 0, classes - 1)
