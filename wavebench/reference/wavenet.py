"""WaveNet's teacher-forced forward in plain PyTorch, written from the
architecture (vincentherrmann/pytorch-wavenet ``wavenet_model.py``) in the
stacked params layout the harness makes (``inputs.leaf_specs``).

Layer l (dilation d_l, kernel size k) reads its input h at the current
position and at the k-1 earlier taps d_l apart (zero before the start),
``z = sum_j tap_j @ w_in[l, j] + b_in[l]``; ``u = tanh(z[:D]) *
sigmoid(z[D:])``; the skip sum gathers ``u @ w_skip[l] + b_skip[l]``, and
``h <- h + u @ w_res[l] + b_res[l]``. The head is ``relu -> end1 -> relu
-> end2``. Every product is f32 with TF32 off (``prec="f32"``), or has
both operands rounded to TF32 (10 mantissa bits) with f32 sums
(``prec="tf32"``, the control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def set_f32():
    """Keep every float32 product in float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (nearest, ties away)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _MmTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        ga = g @ tf32_round(b).transpose(-1, -2)
        a2 = tf32_round(a).reshape(-1, a.shape[-1])
        gb = a2.transpose(0, 1) @ g.reshape(-1, g.shape[-1])
        return ga, gb


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "tf32":
        return _MmTF32.apply(a, b)
    return a @ b


def dilations(model: dict) -> list:
    return [2 ** (i % model["layers"])
            for i in range(model["layers"] * model["blocks"])]


def receptive_field(model: dict) -> int:
    k = model.get("kernel_size", 2)
    return 1 + model["blocks"] * (k - 1) * (2 ** model["layers"] - 1)


def logits(p: dict, model: dict, x: torch.Tensor, out_len: int,
           prec: str = "f32") -> torch.Tensor:
    """Logits ``(N, out_len, classes)`` at the last ``out_len`` positions
    of the int classes ``x`` ``(N, T)``; position t predicts x[t + 1]."""
    k = model.get("kernel_size", 2)
    D = model["dilation_channels"]
    lp = p["layers"]
    h = p["start"]["w"][x]
    if "b" in p["start"]:
        h = h + p["start"]["b"]
    T = x.shape[1]
    skip = 0.0
    for l, d in enumerate(dilations(model)):
        z = mm(h, lp["w_in"][l, k - 1], prec)
        for j in range(k - 1):
            s = (k - 1 - j) * d
            tap = F.pad(h, (0, 0, s, 0))[:, :T]
            z = z + mm(tap, lp["w_in"][l, j], prec)
        if "b_in" in lp:
            z = z + lp["b_in"][l]
        u = torch.tanh(z[..., :D]) * torch.sigmoid(z[..., D:])
        s_l = mm(u[:, T - out_len:], lp["w_skip"][l], prec)
        if "b_skip" in lp:
            s_l = s_l + lp["b_skip"][l]
        skip = skip + s_l
        r = mm(u, lp["w_res"][l], prec)
        if "b_res" in lp:
            r = r + lp["b_res"][l]
        h = h + r
    y = torch.relu(mm(torch.relu(skip), p["end1"]["w"], prec) + p["end1"]["b"])
    return mm(y, p["end2"]["w"], prec) + p["end2"]["b"]
