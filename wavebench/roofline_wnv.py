"""Operations and bytes of the WaveNet vocoder's work (``configs/wnv512.json``:
the kernel-2 input, local conditioning, the phase-scale upsampler), counted
from the configuration as ``roofline.py`` counts a plain WaveNet's: every
product once (2 * M * K * N) at the configuration's peak, never as 3xTF32
triples; the input's two rows and the upsampler are gathers and scales,
no products. Bytes: the whole weight set once a step (the wide-chain
kernel holds no weights across steps), and each useful lane-step's tap
row read and ring row written in every layer.
"""

from __future__ import annotations

import math

from .roofline import HBM_BYTES_PER_S, peak  # noqa: F401  (peak: re-export)


def _dims(m: dict):
    return (m["layers"] * m["blocks"], m.get("kernel_size", 2),
            m["residual_channels"], m["dilation_channels"],
            m["skip_channels"], m["end_channels"], m.get("classes", 256),
            m["cond_channels"])


def param_count(m: dict) -> int:
    """44,562,001 at wnv512: the input's two taps and bias, each layer's
    dilated, conditioning, residual and skip products and biases, the head
    and the upsampler's scales and bias."""
    L, k, R, D, S, E, C, M = _dims(m)
    n = 2 * C * R + R
    n += L * (k * R * 2 * D + M * 2 * D + D * R + D * S + 2 * D + R + S)
    n += S * E + E + E * C + C
    return n + math.prod(m["cond_upsample"]) + 1


def step_flops(m: dict) -> int:
    """One lane-step: each layer's taps, conditioning, residual and skip
    products, and the head (88,489,984 at wnv512)."""
    L, k, R, D, S, E, C, M = _dims(m)
    return 2 * L * (k * R * 2 * D + M * 2 * D + D * R + D * S) + 2 * (
        S * E + E * C)


def lane_step_bytes(m: dict) -> int:
    """A lane-step's state: a tap row read and a ring row written a layer."""
    L, _, R, *_ = _dims(m)
    return 4 * L * 2 * R


def bound_s(m: dict, lane_steps: int, steps: int) -> tuple:
    """Least time of ``lane_steps`` useful lane-steps over ``steps`` kernel
    steps (each reads the weights once): ``(seconds, "operations" |
    "bytes")``."""
    t_ops = lane_steps * step_flops(m) / peak(m)
    t_bytes = (steps * 4 * param_count(m)
               + lane_steps * lane_step_bytes(m)) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")
