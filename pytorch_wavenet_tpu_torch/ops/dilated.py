"""Dilation utilities: the reference's L0 API (the JAX package's
``ops/dilated.py``).

The port's trunk does not fold the dilation into the batch (each layer
reads its taps as shifted slices, ``models/wavenet.py``), but the
reference's ``dilate`` and ``constant_pad_1d`` are public API
(reference: wavenet_modules.py:10-39,80-127), so plain tensor versions
live here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def constant_pad_1d(
    x: torch.Tensor,
    target_size: int,
    dimension: int = 0,
    value: float = 0,
    pad_start: bool = False,
) -> torch.Tensor:
    """Pad ``dimension`` up to ``target_size`` with ``value``, at the start
    or the end (reference: wavenet_modules.py:80-127). Differentiable: the
    gradient crops back, as autograd through ``F.pad`` does (the reference
    needed a hand-written backward for this, wavenet_modules.py:108-119)."""
    num_pad = target_size - x.shape[dimension]
    if num_pad < 0:
        raise ValueError("target size has to be greater than input size")
    if num_pad == 0:
        return x
    # F.pad lists (before, after) pairs from the last dimension backwards
    widths = [0, 0] * (x.dim() - dimension % x.dim())
    widths[-2:] = (num_pad, 0) if pad_start else (0, num_pad)
    return F.pad(x, widths, value=value)


def dilate(
    x: torch.Tensor, dilation: int, init_dilation: int = 1,
    pad_start: bool = True,
) -> torch.Tensor:
    """Reshape ``(N, C, L)`` so the batch dim carries the dilation factor
    (reference: wavenet_modules.py:10-39): the output is ``(dilation, C,
    L * N / dilation)``, zero-padded at the start if L is not divisible."""
    n, c, l = x.shape
    dilation_factor = dilation / init_dilation
    if dilation_factor == 1:
        return x

    new_l = int(math.ceil(l / dilation_factor) * dilation_factor)
    if new_l != l:
        l = new_l
        x = constant_pad_1d(x, new_l, dimension=2, pad_start=pad_start)

    l = math.ceil(l * init_dilation / dilation)
    n = math.ceil(n * dilation / init_dilation)

    # (n, c, l) -> (c, l, n) -> view (c, l', n') -> (n', c, l')
    x = x.permute(1, 2, 0).reshape(c, l, n)
    return x.permute(2, 0, 1)
