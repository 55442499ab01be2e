"""A plain reference of the WaveNet vocoder of kan-bayashi/PytorchWaveNetVocoder
(``src/nets/wavenet.py``, class ``WaveNet``), written from its layer
equations in plain ``torch``: float32, TF32 off, no kernel of the port and
no JAX. It takes a state dict in the source's own layout (module names as
the source's: ``causal.conv``, ``upsampling.conv``, ``dil_sigmoid.{l}.conv``,
``dil_tanh.{l}.conv``, ``aux_1x1_sigmoid.{l}``, ``aux_1x1_tanh.{l}``,
``skip_1x1.{l}``, ``res_1x1.{l}``, ``conv_post_1``, ``conv_post_2``).

With x the mu-law classes (one-hot over C) and f the frames (F, M):

* input: a causal conv of kernel 2 over the one-hot, ``h0[t] = A0 x[t-1]
  + A1 x[t] + a`` (zero before the start);
* upsampler: ``ConvTranspose2d(1, 1, (1, hop), stride (1, hop))``,
  ``c[t, m] = w[t mod hop] f[t div hop, m] + b``;
* layer l (dilation ``2 ** (l mod layers)``): ``g = sigmoid(dil_sigmoid(h)
  + aux_sigmoid(c)) * tanh(dil_tanh(h) + aux_tanh(c))``, ``skip +=
  skip_1x1(g)``, ``h = res_1x1(g) + h``;
* head: ``relu -> conv_post_1 -> relu -> conv_post_2``.

Departures: the recipe's noise shaping (an MLSA filter on the waveform,
outside the network) is left out; ``forward`` takes frames whose upsampled
length covers the positions it is asked for, and cuts the rest."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def set_f32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dilations(layers: int, blocks: int) -> list:
    return [2 ** (i % layers) for i in range(layers * blocks)]


def init_source(dims: dict, gen: torch.Generator) -> dict:
    """A state dict in the source's layout with Conv1d's default init
    (U(-s, s), s = 1/sqrt(fan_in)), every bias random too. ``dims``: C, R
    (the source's n_resch), S (n_skipch), M (n_aux), hop, layers, blocks."""
    C, R, S, M = dims["C"], dims["R"], dims["S"], dims["M"]
    sd = {}

    def u(name, shape, fan_in):
        s = 1.0 / math.sqrt(fan_in)
        sd[name] = torch.rand(shape, generator=gen) * (2 * s) - s

    u("causal.conv.weight", (R, C, 2), C * 2)
    u("causal.conv.bias", (R,), C * 2)
    u("upsampling.conv.weight", (1, 1, 1, dims["hop"]), 1)
    u("upsampling.conv.bias", (1,), 1)
    for l in range(dims["layers"] * dims["blocks"]):
        for g in ("sigmoid", "tanh"):
            u(f"dil_{g}.{l}.conv.weight", (R, R, 2), R * 2)
            u(f"dil_{g}.{l}.conv.bias", (R,), R * 2)
            u(f"aux_1x1_{g}.{l}.weight", (R, M, 1), M)
            u(f"aux_1x1_{g}.{l}.bias", (R,), M)
        u(f"skip_1x1.{l}.weight", (S, R, 1), R)
        u(f"skip_1x1.{l}.bias", (S,), R)
        u(f"res_1x1.{l}.weight", (R, R, 1), R)
        u(f"res_1x1.{l}.bias", (R,), R)
    u("conv_post_1.weight", (S, S, 1), S)
    u("conv_post_1.bias", (S,), S)
    u("conv_post_2.weight", (C, S, 1), S)
    u("conv_post_2.bias", (C,), S)
    return sd


def to_source(params: dict, layers: int, blocks: int) -> dict:
    """The port's stacked params (``models/wavenet.py``, with
    ``start.w_prev`` and the phase upsampler) in the source's layout; the
    port's gate bias goes to the dilated convs, the aux convs' biases are
    zero."""
    p = {k: {n: v.detach().cpu() for n, v in t.items()}
         for k, t in params.items()}
    lp, D = p["layers"], p["layers"]["w_res"].shape[1]
    sd = {"causal.conv.weight": torch.stack(
              [p["start"]["w_prev"].T, p["start"]["w"].T], dim=2),
          "causal.conv.bias": p["start"]["b"],
          "upsampling.conv.weight": p["cond_up"]["w"].reshape(1, 1, 1, -1),
          "upsampling.conv.bias": p["cond_up"]["b"].reshape(1)}
    for l in range(layers * blocks):
        for g, half in (("tanh", slice(0, D)), ("sigmoid", slice(D, 2 * D))):
            sd[f"dil_{g}.{l}.conv.weight"] = lp["w_in"][l][:, :, half] \
                .permute(2, 1, 0).contiguous()
            sd[f"dil_{g}.{l}.conv.bias"] = lp["b_in"][l][half]
            sd[f"aux_1x1_{g}.{l}.weight"] = lp["w_cond"][l][:, half] \
                .T[:, :, None].contiguous()
            sd[f"aux_1x1_{g}.{l}.bias"] = torch.zeros(D)
        sd[f"skip_1x1.{l}.weight"] = lp["w_skip"][l].T[:, :, None]
        sd[f"skip_1x1.{l}.bias"] = lp["b_skip"][l]
        sd[f"res_1x1.{l}.weight"] = lp["w_res"][l].T[:, :, None]
        sd[f"res_1x1.{l}.bias"] = lp["b_res"][l]
    sd["conv_post_1.weight"] = p["end1"]["w"].T[:, :, None]
    sd["conv_post_1.bias"] = p["end1"]["b"]
    sd["conv_post_2.weight"] = p["end2"]["w"].T[:, :, None]
    sd["conv_post_2.bias"] = p["end2"]["b"]
    return sd


def upsample(sd: dict, frames: torch.Tensor) -> torch.Tensor:
    """Frames ``(N, F, M)`` -> ``(N, M, F * hop)``, the source's
    ``UpSampling``."""
    y = F.conv_transpose2d(frames.transpose(1, 2)[:, None],
                           sd["upsampling.conv.weight"],
                           sd["upsampling.conv.bias"],
                           stride=(1, sd["upsampling.conv.weight"].shape[-1]))
    return y[:, 0]


def forward(sd: dict, x: torch.Tensor, frames: torch.Tensor, layers: int,
            blocks: int) -> torch.Tensor:
    """Logits ``(N, T, C)`` of classes ``x`` ``(N, T)`` under ``frames``
    ``(N, F, M)`` (``F * hop >= T``); position t predicts x[t + 1]."""
    set_f32()
    C = sd["conv_post_2.weight"].shape[0]
    T = x.shape[1]
    onehot = F.one_hot(x.long(), C).to(torch.float32).transpose(1, 2)
    h = F.conv1d(F.pad(onehot, (1, 0)), sd["causal.conv.weight"],
                 sd["causal.conv.bias"])
    c = upsample(sd, frames)
    if c.shape[-1] < T:
        raise ValueError(f"{c.shape[-1]} upsampled rows < {T} positions")
    c = c[:, :, :T]
    skip = 0.0
    for l, d in enumerate(dilations(layers, blocks)):
        hp = F.pad(h, (d, 0))

        def gate(g):
            return (F.conv1d(hp, sd[f"dil_{g}.{l}.conv.weight"],
                             sd[f"dil_{g}.{l}.conv.bias"], dilation=d)
                    + F.conv1d(c, sd[f"aux_1x1_{g}.{l}.weight"],
                               sd[f"aux_1x1_{g}.{l}.bias"]))

        g = torch.sigmoid(gate("sigmoid")) * torch.tanh(gate("tanh"))
        skip = skip + F.conv1d(g, sd[f"skip_1x1.{l}.weight"],
                               sd[f"skip_1x1.{l}.bias"])
        h = F.conv1d(g, sd[f"res_1x1.{l}.weight"], sd[f"res_1x1.{l}.bias"]) + h
    y = F.relu(F.conv1d(F.relu(skip), sd["conv_post_1.weight"],
                        sd["conv_post_1.bias"]))
    y = F.conv1d(y, sd["conv_post_2.weight"], sd["conv_post_2.bias"])
    return y.transpose(1, 2)
