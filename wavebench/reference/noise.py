"""The sampling rule the served requests follow: a greedy request takes
the argmax of the logits (the first on ties); a request at temperature T >
0 takes ``argmax(logits / T + g)`` with Gumbel noise ``g = -log(-log(u))``
and u the counter hash of (class, request-local step, seed): the 32-bit
mixing the port documents for K1 and K4 (``csrc/gen_common.cuh``),
written here again from that description.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _mul(x: torch.Tensor, m: int) -> torch.Tensor:
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def uniform(cls: torch.Tensor, step: torch.Tensor, seed: int) -> torch.Tensor:
    """f32 uniforms in [1e-7, 1 - 1e-7], broadcast over ``cls`` and
    ``step`` (int64 tensors)."""
    x = _mul(cls & M32, 0x9E3779B9)
    x = x ^ _mul(step & M32, 0x85EBCA6B)
    x = x ^ (int(seed) & M32)
    x = x ^ (x >> 16)
    x = _mul(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp(u, 1e-7, 1.0 - 1e-7)


def scores(logits: torch.Tensor, first_step: int, temperature: float,
           seed: int) -> torch.Tensor:
    """The sampling scores of ``logits`` ``(n, classes)`` at request-local
    steps ``first_step ..``."""
    if temperature <= 0:
        return logits
    n, C = logits.shape
    dev = logits.device
    step = torch.arange(first_step, first_step + n, device=dev)[:, None]
    cls = torch.arange(C, device=dev)[None, :]
    u = uniform(cls, step, seed)
    return logits / max(temperature, 1e-6) - torch.log(-torch.log(u))
