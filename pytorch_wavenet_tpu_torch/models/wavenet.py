"""WaveNet trunk in plain PyTorch.

The counterpart of the JAX package's ``models/wavenet.py``. Params keep
its stacked layout, as torch tensors, so weights map across 1:1:

- ``start.w (classes, R)``, optional ``start.b (R,)``; with
  ``cfg.input_kernel`` 2 also ``start.w_prev (classes, R)``, the input
  conv's tap on the previous class (``h[t] = w_prev[x[t-1]] + w[x[t]] +
  b``, zero before the start)
- ``layers.w_in (L, k, R, 2*D)``  fused filter+gate dilated-conv taps
- ``layers.w_res (L, D, R)``, ``layers.w_skip (L, D, S)``
- optional ``layers.b_in (L, 2*D)``, ``layers.b_res (L, R)``,
  ``layers.b_skip (L, S)``
- ``end1.w (S, E)``, ``end1.b (E,)``, ``end2.w (E, classes)``,
  ``end2.b (classes,)``
- conditioned models: ``layers.w_cond (L, M, 2*D)`` (local conditioning,
  ``M = cond_channels``), ``layers.w_gcond (L, G, 2*D)`` (global), and
  ``cond_up.s{i} (2, r_i, M, M)``, the learnable upsampler of
  ``cond_upsample``, or under ``cond_upsampler="phase"`` ``cond_up.w
  (hop,)`` and ``cond_up.b (1,)``

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
from ..parallel.sharding import copy_to_model, reduce_from_model

Params = Dict[str, Any]


def _conv_init(gen: torch.Generator, shape, fan_in: int, device) -> torch.Tensor:
    """Conv1d default init: U(-s, s) with s = 1/sqrt(fan_in)."""
    stdv = 1.0 / (fan_in**0.5)
    x = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (x * (2 * stdv) - stdv).to(device)


def init_wavenet(cfg: WaveNetConfig, generator: torch.Generator,
                 device: str | torch.device = "cuda") -> Params:
    """Random params in the stacked layout.

    ``generator`` is a CPU ``torch.Generator``: draws happen on the host
    and the result moves to ``device``, so one seed gives the same weights
    on every device. The learnable upsampler starts as linear
    interpolation (``ops.mel.linear_init_upsampler``); the phase-scale
    upsampler as the nearest frame (scales 1, bias 0)."""
    dev = resolve_device(device)
    L, k, ki = cfg.num_layers, cfg.kernel_size, cfg.input_kernel
    R, D, S, E, C = (
        cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels,
        cfg.end_channels, cfg.classes,
    )
    g = generator
    params: Params = {
        "start": {"w": _conv_init(g, (C, R), C * ki, dev)},
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
        params["start"]["b"] = _conv_init(g, (R,), C * ki, dev)
        params["layers"]["b_in"] = _conv_init(g, (L, 2 * D), R * k, dev)
        params["layers"]["b_res"] = _conv_init(g, (L, R), D, dev)
        params["layers"]["b_skip"] = _conv_init(g, (L, S), D, dev)
    M, G = cfg.cond_channels, cfg.gcond_channels
    if M:
        params["layers"]["w_cond"] = _conv_init(g, (L, M, 2 * D), M, dev)
    if G:
        params["layers"]["w_gcond"] = _conv_init(g, (L, G, 2 * D), G, dev)
    if M and cfg.cond_upsample and cfg.cond_upsampler == "phase":
        params["cond_up"] = {
            "w": torch.ones((cfg.cond_hop,), dtype=torch.float32, device=dev),
            "b": torch.zeros((1,), dtype=torch.float32, device=dev)}
    elif M and cfg.cond_upsample:
        from ..ops.mel import linear_init_upsampler

        params["cond_up"] = {
            k: torch.from_numpy(v).to(dev)
            for k, v in linear_init_upsampler(cfg.cond_upsample, M).items()}
    if ki == 2:
        params["start"]["w_prev"] = _conv_init(g, (C, R), C * ki, dev)
    elif ki != 1:
        raise ValueError(f"input_kernel {ki}: the input conv takes 1 or 2 "
                         f"taps")
    return params


def upsample_cond(params: Params, cfg: WaveNetConfig, frames: torch.Tensor,
                  hop_length: int, length: int) -> torch.Tensor:
    """Frame-rate conditioning ``(..., F, M)`` -> sample-rate ``(...,
    length, M)``: through the learnable upsampler when the config has one
    (its factors must multiply to ``hop_length``, so frame i lands on
    sample ``i * hop``), or the phase-scale one (frame i covers samples
    ``[i * hop, (i + 1) * hop)``), else by linear interpolation."""
    from ..ops import mel

    if cfg.cond_upsample and "cond_up" in params:
        if cfg.cond_hop != hop_length:
            raise ValueError(
                f"cond_upsample factors {cfg.cond_upsample} multiply to "
                f"{cfg.cond_hop} but the conditioning hop is {hop_length}")
        if cfg.cond_upsampler == "phase":
            return mel.upsample_frames_phase(params["cond_up"], frames,
                                             hop_length, length)
        return mel.upsample_frames_conv(params["cond_up"], frames,
                                        cfg.cond_upsample, length)
    return mel.upsample_frames(frames, hop_length, length)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def parameter_count(params: Params) -> int:
    return sum(int(x.numel()) for x in _leaves(params))


def params_to(params: Params, device: torch.device) -> Params:
    """The same tree (dicts, and tuples such as the student's flows) with
    every leaf on ``device`` (leaves already there are not copied)."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, tuple):
        return tuple(params_to(v, device) for v in params)
    return params.to(device)


class _EmbedRows(torch.autograd.Function):
    """Row gather ``w[x]`` whose backward is ``one_hot(x)^T @ dh``, as in
    the JAX package. Autograd's own backward of an index is a scatter with
    atomics on CUDA, whose sums change order from run to run; this one is
    a matmul, so a resumed training run can equal an uninterrupted one
    bitwise."""

    @staticmethod
    def forward(ctx, w, x):
        ctx.save_for_backward(x)
        ctx.classes = w.shape[0]
        return w[x]

    @staticmethod
    def backward(ctx, dh):
        (x,) = ctx.saved_tensors
        onehot = F.one_hot(x.reshape(-1), ctx.classes).to(dh.dtype)
        return onehot.T @ dh.reshape(-1, dh.shape[-1]), None


def embed_inputs(params: Params, cfg: WaveNetConfig, x: torch.Tensor) -> torch.Tensor:
    """Start conv: integer classes ``(N, T)`` are an exact row gather of
    ``start.w`` (a matmul backward, :class:`_EmbedRows`); float one-hot
    ``(N, T, C)`` inputs go through a matmul. With ``cfg.input_kernel`` 2
    the previous position's row of ``start.w_prev`` (zero at position 0)
    is added first: ``(w_prev[x[t-1]] + w[x[t]]) + b``, as the generation
    kernels sum it."""
    w = params["start"]["w"]
    if x.dtype.is_floating_point:
        h = _mm(x, w, cfg.compute_dtype)
    else:
        h = _EmbedRows.apply(w, x.long())
    if cfg.input_kernel == 2:
        wp = params["start"]["w_prev"]
        if x.dtype.is_floating_point:
            prev = _mm(x[:, :-1], wp, cfg.compute_dtype)
        else:
            prev = _EmbedRows.apply(wp, x[:, :-1].long())
        h = F.pad(prev, (0, 0, 1, 0)) + h
    if "b" in params["start"]:
        h = h + params["start"]["b"]
    return h.to(torch.float32)


def _mm(a: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """``a @ w`` with both inputs rounded to ``dtype`` and the product kept
    in f32, as the JAX package's ``preferred_element_type=float32``
    (products of bf16 values are exact in f32)."""
    f32 = torch.float32
    return a.to(dtype).to(f32) @ w.to(dtype).to(f32)


def check_cond(cfg: WaveNetConfig, lead: tuple, cond, global_cond) -> None:
    """Raise unless ``cond`` is ``(*lead, cond_channels)`` and
    ``global_cond`` ``(lead[0], gcond_channels)`` (either may be None)."""
    if cond is not None:
        if cfg.cond_channels == 0:
            raise ValueError("cond given but cfg.cond_channels == 0")
        want = tuple(lead) + (cfg.cond_channels,)
        if tuple(cond.shape) != want:
            raise ValueError(f"cond shape {tuple(cond.shape)} must be "
                             f"{want} (..., cond_channels)")
    if global_cond is not None:
        if cfg.gcond_channels == 0:
            raise ValueError("global_cond given but cfg.gcond_channels == 0")
        want = (lead[0], cfg.gcond_channels)
        if tuple(global_cond.shape) != want:
            raise ValueError(f"global_cond shape {tuple(global_cond.shape)} "
                             f"must be {want} (streams, gcond_channels)")


def wavenet_logits(params: Params, cfg: WaveNetConfig, x: torch.Tensor,
                   out_len: int | None = None, cond: torch.Tensor | None = None,
                   global_cond: torch.Tensor | None = None, mesh=None
                   ) -> torch.Tensor:
    """Teacher-forced trunk; logits ``(N, out_len, classes)``.

    ``x``: int ``(N, T)`` classes or float one-hot ``(N, T, classes)`` with
    ``T >= receptive_field + out_len - 1``. ``cond``: local conditioning
    ``(N, T, cond_channels)`` aligned with ``x``; ``global_cond``: ``(N,
    gcond_channels)``, the same for every position. Each enters every
    layer's gate input through its own product (``w_cond``, ``w_gcond``).
    The skip projections run per layer below ``out_len`` 128 and as one
    ``K = L*D`` matmul after the layer walk at 128 and above
    (``cfg.fuse_skip`` overrides). With ``cfg.trunk_kernel`` the trunk is
    the fused one (:func:`_logits_fused`, local conditioning in its
    kernels, an f32 or bf16 ``cfg.stream_dtype``); it takes ``kernel_size
    >= 2``, and raises on the rest and on a passed ``global_cond`` (the JAX
    package falls back to its plain trunk there).

    ``mesh`` (``parallel.mesh.make_mesh``): ``x`` is this rank's block of
    the batch and the trunk runs on it whatever the mesh (K2/K3 on the
    card), the counterpart of the JAX package's per-data-shard
    ``shard_map``; ``params`` are this rank's blocks
    (``parallel.sharding.shard_params``). With ``model > 1`` the skip
    projection is column-parallel (its input through
    :func:`~pytorch_wavenet_tpu_torch.parallel.sharding.copy_to_model`)
    and ``end1`` row-parallel (its partial products through
    :func:`~pytorch_wavenet_tpu_torch.parallel.sharding.reduce_from_model`,
    ``end1.b`` added after the sum)."""
    if out_len is None:
        out_len = cfg.output_length
    if x.shape[1] < out_len:
        raise ValueError(
            f"input length {x.shape[1]} < out_len {out_len}; training "
            f"windows need item_length = receptive_field + output_length - 1 "
            f"= {cfg.item_length}"
        )
    check_cond(cfg, tuple(x.shape[:2]), cond, global_cond)
    k = cfg.kernel_size
    cdt = cfg.compute_dtype
    if cfg.trunk_kernel:
        if global_cond is not None:
            raise ValueError(
                "cfg.trunk_kernel takes no global conditioning (the trunk "
                "kernels K2/K3 have no w_gcond product); use "
                "cfg.trunk_kernel=False for a global_cond")
        return _logits_fused(params, cfg, x, out_len, cond, mesh)
    h = embed_inputs(params, cfg, x).to(cfg.stream_dtype)
    N, T, _ = h.shape
    lp = params["layers"]
    fuse = cfg.fuse_skip if cfg.fuse_skip is not None else (out_len >= 128)
    skip = None if fuse else torch.zeros(  # this rank's skip block
        (N, out_len, lp["w_skip"].shape[-1]), dtype=torch.float32,
        device=h.device)
    gated_units = []

    for l, d in enumerate(cfg.dilations):
        z = _mm(h, lp["w_in"][l, k - 1], cdt)
        for j in range(k - 1):
            shift = (k - 1 - j) * d
            tap = F.pad(h, (0, 0, shift, 0))[:, :T, :]
            z = z + _mm(tap, lp["w_in"][l, j], cdt)
        if cond is not None:
            z = z + _mm(cond, lp["w_cond"][l], cdt)
        if global_cond is not None:
            z = z + _mm(global_cond, lp["w_gcond"][l], cdt)[:, None, :]
        if "b_in" in lp:
            z = z + lp["b_in"][l]
        f, g = z.chunk(2, dim=-1)
        u = torch.tanh(f) * torch.sigmoid(g)
        if fuse:
            gated_units.append(u[:, T - out_len:, :])
        else:
            s = _mm(copy_to_model(u[:, T - out_len:, :], mesh),
                    lp["w_skip"][l], cdt)
            if "b_skip" in lp:
                s = s + lp["b_skip"][l]
            skip = skip + s
        r = _mm(u, lp["w_res"][l], cdt)
        if "b_res" in lp:
            r = r + lp["b_res"][l]
        h = (r + h).to(cfg.stream_dtype)

    if fuse:
        return skip_head(params, cfg, torch.cat(gated_units, dim=-1), mesh)
    return _head(params, cfg, skip, mesh)


def _head(params: Params, cfg: WaveNetConfig, skip: torch.Tensor,
          mesh=None) -> torch.Tensor:
    """relu -> end1 -> relu -> end2 on the summed skip ``(N, out, S)``
    (this rank's block of S under a model-parallel mesh)."""
    cdt = cfg.compute_dtype
    y = torch.relu(skip)
    y = reduce_from_model(_mm(y, params["end1"]["w"], cdt), mesh)
    y = torch.relu(y + params["end1"]["b"])
    return _mm(y, params["end2"]["w"], cdt) + params["end2"]["b"]


def skip_head(params: Params, cfg: WaveNetConfig, units: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """Logits from every layer's gated units ``(N, out, L*D)`` over the
    output window: the skip projection as one ``K = L*D`` product, then
    the head (column- and row-parallel under a model-parallel ``mesh``)."""
    lp = params["layers"]
    L, D = cfg.num_layers, cfg.dilation_channels
    skip = _mm(copy_to_model(units, mesh), lp["w_skip"].reshape(L * D, -1),
               cfg.compute_dtype)
    if "b_skip" in lp:
        skip = skip + lp["b_skip"].sum(dim=0)
    return _head(params, cfg, skip, mesh)


def _logits_fused(params: Params, cfg: WaveNetConfig, x: torch.Tensor,
                  out_len: int, cond: torch.Tensor | None = None,
                  mesh=None) -> torch.Tensor:
    """The ``cfg.trunk_kernel`` path: the embedded window (and its cond
    rows) through
    :func:`~pytorch_wavenet_tpu_torch.ops.cuda.trunk_kernel.fused_trunk`
    (the kernels K2/K3 on the card, their plain versions on the CPU), then
    the skip projection as one ``K = L*D`` product and the head. A longer
    input is cut to its trailing window, as the plain trunk reads it."""
    from ..ops.cuda.trunk_kernel import fused_trunk

    h0 = embed_inputs(params, cfg, x)
    win = cfg.receptive_field + out_len - 1
    if h0.shape[1] > win:
        h0 = h0[:, h0.shape[1] - win:]
        if cond is not None:
            cond = cond[:, cond.shape[1] - win:]
    u = fused_trunk(params, cfg, h0, out_len, cond=cond)  # (N, out, L*D)
    return skip_head(params, cfg, u, mesh)


def forward(params: Params, cfg: WaveNetConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits flattened to ``(N*output_length, classes)``."""
    y = wavenet_logits(params, cfg, x, cfg.output_length)
    N, L, C = y.shape
    return y.reshape(N * L, C)
