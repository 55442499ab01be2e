"""WaveNet trunk in plain PyTorch.

The counterpart of the JAX package's ``models/wavenet.py`` for
unconditioned models. Params keep its stacked layout, as torch tensors, so
weights map across 1:1:

- ``start.w (classes, R)``, optional ``start.b (R,)``
- ``layers.w_in (L, k, R, 2*D)``  fused filter+gate dilated-conv taps
- ``layers.w_res (L, D, R)``, ``layers.w_skip (L, D, S)``
- optional ``layers.b_in (L, 2*D)``, ``layers.b_res (L, R)``,
  ``layers.b_skip (L, S)``
- ``end1.w (S, E)``, ``end1.b (E,)``, ``end2.w (E, classes)``,
  ``end2.b (classes,)``

Activations are channels-last ``(N, T, C)``, so every 1x1 conv is a plain
``(..., C_in) @ (C_in, C_out)`` matmul. Tap j of a layer with dilation d
looks back ``(k-1-j)*d`` steps; history before the window is zero.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..config import WaveNetConfig
from ..device import resolve_device

Params = Dict[str, Any]


def _conv_init(gen: torch.Generator, shape, fan_in: int, device) -> torch.Tensor:
    """Conv1d default init: U(-s, s) with s = 1/sqrt(fan_in)."""
    stdv = 1.0 / (fan_in**0.5)
    x = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (x * (2 * stdv) - stdv).to(device)


def init_wavenet(cfg: WaveNetConfig, generator: torch.Generator,
                 device: str | torch.device = "cuda") -> Params:
    """Random params in the stacked layout (unconditioned models).

    ``generator`` is a CPU ``torch.Generator``: draws happen on the host
    and the result moves to ``device``, so one seed gives the same weights
    on every device."""
    if cfg.cond_channels or cfg.gcond_channels:
        raise NotImplementedError("conditioned models are not ported yet")
    dev = resolve_device(device)
    L, k = cfg.num_layers, cfg.kernel_size
    R, D, S, E, C = (
        cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels,
        cfg.end_channels, cfg.classes,
    )
    g = generator
    params: Params = {
        "start": {"w": _conv_init(g, (C, R), C, dev)},
        "layers": {
            "w_in": _conv_init(g, (L, k, R, 2 * D), R * k, dev),
            "w_res": _conv_init(g, (L, D, R), D, dev),
            "w_skip": _conv_init(g, (L, D, S), D, dev),
        },
        "end1": {"w": _conv_init(g, (S, E), S, dev),
                 "b": _conv_init(g, (E,), S, dev)},
        "end2": {"w": _conv_init(g, (E, C), E, dev),
                 "b": _conv_init(g, (C,), E, dev)},
    }
    if cfg.bias:
        params["start"]["b"] = _conv_init(g, (R,), C, dev)
        params["layers"]["b_in"] = _conv_init(g, (L, 2 * D), R * k, dev)
        params["layers"]["b_res"] = _conv_init(g, (L, R), D, dev)
        params["layers"]["b_skip"] = _conv_init(g, (L, S), D, dev)
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def parameter_count(params: Params) -> int:
    return sum(int(x.numel()) for x in _leaves(params))


def params_to(params: Params, device: torch.device) -> Params:
    """The same tree with every leaf on ``device`` (leaves already there
    are not copied)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)


def embed_inputs(params: Params, cfg: WaveNetConfig, x: torch.Tensor) -> torch.Tensor:
    """Start conv: integer classes ``(N, T)`` are an exact row gather of
    ``start.w``; float one-hot ``(N, T, C)`` inputs go through a matmul."""
    w = params["start"]["w"]
    if x.dtype.is_floating_point:
        h = x.to(cfg.compute_dtype) @ w.to(cfg.compute_dtype)
    else:
        h = w[x.long()]
    if "b" in params["start"]:
        h = h + params["start"]["b"]
    return h.to(torch.float32)


def _mm(a: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    return (a.to(dtype) @ w.to(dtype)).to(torch.float32)


def wavenet_logits(params: Params, cfg: WaveNetConfig, x: torch.Tensor,
                   out_len: int | None = None) -> torch.Tensor:
    """Teacher-forced trunk; logits ``(N, out_len, classes)``.

    ``x``: int ``(N, T)`` classes or float one-hot ``(N, T, classes)`` with
    ``T >= receptive_field + out_len - 1``. The skip projections run per
    layer below ``out_len`` 128 and as one ``K = L*D`` matmul after the
    layer walk at 128 and above (``cfg.fuse_skip`` overrides)."""
    if out_len is None:
        out_len = cfg.output_length
    if x.shape[1] < out_len:
        raise ValueError(
            f"input length {x.shape[1]} < out_len {out_len}; training "
            f"windows need item_length = receptive_field + output_length - 1 "
            f"= {cfg.item_length}"
        )
    k = cfg.kernel_size
    cdt = cfg.compute_dtype
    h = embed_inputs(params, cfg, x).to(cfg.stream_dtype)
    N, T, _ = h.shape
    lp = params["layers"]
    fuse = cfg.fuse_skip if cfg.fuse_skip is not None else (out_len >= 128)
    skip = None if fuse else torch.zeros(
        (N, out_len, cfg.skip_channels), dtype=torch.float32, device=h.device)
    gated_units = []

    for l, d in enumerate(cfg.dilations):
        z = _mm(h, lp["w_in"][l, k - 1], cdt)
        for j in range(k - 1):
            shift = (k - 1 - j) * d
            tap = F.pad(h, (0, 0, shift, 0))[:, :T, :]
            z = z + _mm(tap, lp["w_in"][l, j], cdt)
        if "b_in" in lp:
            z = z + lp["b_in"][l]
        f, g = z.chunk(2, dim=-1)
        u = torch.tanh(f) * torch.sigmoid(g)
        if fuse:
            gated_units.append(u[:, T - out_len:, :])
        else:
            s = _mm(u[:, T - out_len:, :], lp["w_skip"][l], cdt)
            if "b_skip" in lp:
                s = s + lp["b_skip"][l]
            skip = skip + s
        r = _mm(u, lp["w_res"][l], cdt)
        if "b_res" in lp:
            r = r + lp["b_res"][l]
        h = (r + h).to(cfg.stream_dtype)

    if fuse:
        L, D = cfg.num_layers, cfg.dilation_channels
        ucat = torch.cat(gated_units, dim=-1)
        skip = _mm(ucat, lp["w_skip"].reshape(L * D, -1), cdt)
        if "b_skip" in lp:
            skip = skip + lp["b_skip"].sum(dim=0)

    y = torch.relu(skip)
    y = torch.relu(_mm(y, params["end1"]["w"], cdt) + params["end1"]["b"])
    return _mm(y, params["end2"]["w"], cdt) + params["end2"]["b"]


def forward(params: Params, cfg: WaveNetConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits flattened to ``(N*output_length, classes)``."""
    y = wavenet_logits(params, cfg, x, cfg.output_length)
    N, L, C = y.shape
    return y.reshape(N * L, C)
