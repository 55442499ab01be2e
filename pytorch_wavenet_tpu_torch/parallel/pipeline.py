"""Layer-pipelined generation across ranks: the JAX package's
``parallel/pipeline.py``.

The stacked layers split into ``P`` contiguous stages, stage ``s`` (rank
``s`` of a ``("pipe",)`` mesh) holding layers ``[s*L/P, (s+1)*L/P)`` and
exact rings for them (``(k-1)*d + 1`` slots a layer, as
:class:`~pytorch_wavenet_tpu_torch.models.generate.GenState`). The ``S``
streams split into ``G = P`` groups; at tick ``T`` stage ``s`` works on
group ``(T - s) mod G`` at that group's step ``(T - s) div G``, sends the
residual and skip packet to stage ``s+1``, and the last stage samples and
sends the class to stage 0, which embeds it ``G`` ticks later. In steady
state every stage is busy and each tick yields one sample of ``S/G``
streams.

Ranks are separate programs, so none of the JAX package's SPMD
workarounds is copied (traced dilations, rings padded to one length, the
head computed and masked on every stage): each rank runs its own control
flow, only its stage's layers and rings, and only the last stage runs the
head. A send is waited on two ticks later (its receiver posts the receive
one tick after it), so no rank waits on one that waits on it.

Each group's rollout is :func:`~pytorch_wavenet_tpu_torch.models.generate.
generate_fast` on that group's streams, bitwise: the same steps in the
same order (:func:`~pytorch_wavenet_tpu_torch.models.generate.
advance_layers`, :func:`~pytorch_wavenet_tpu_torch.models.generate.
step_head`). At temperature > 0 group ``g`` draws its uniforms from
:func:`group_generator` ``(seed, g)``, the port's counterpart of the JAX
package's ``fold_in(key, g)`` (whose PRNG the port cannot match).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import WaveNetConfig
from ..device import resolve_device
from ..models.generate import (_prime_2d, _sample, advance_layers,
                               buffer_length, classes_to_waveform, step_head)
from ..models.wavenet import Params, params_to
from .mesh import (TrivialMesh, axis_index, axis_ranks, axis_size, broadcast,
                   fold_seed, recv, send)

PIPE_AXIS = "pipe"

_PACKET, _CLASS = 0, 1  # message tags


def make_pipeline_mesh(n_stages: int, devices=None):
    """A 1-axis ``("pipe",)`` mesh of ``n_stages`` ranks: the whole
    process group (one rank a stage), or the trivial mesh for one stage
    without a group. ``devices`` as in :func:`~.mesh.make_mesh`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_stages != world:
        raise ValueError(f"need {n_stages} ranks, have {world}")
    if n_stages == 1:
        return TrivialMesh((PIPE_AXIS,))
    from torch.distributed.device_mesh import DeviceMesh

    dtype = devices or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return DeviceMesh(dtype, torch.arange(n_stages),
                      mesh_dim_names=(PIPE_AXIS,))


def group_generator(seed: int, group: int) -> torch.Generator:
    """The CPU generator whose uniforms stream group ``group`` draws at
    temperature > 0 (``torch.rand((total, S/G))``, as ``generate_fast``
    draws them)."""
    return torch.Generator().manual_seed(fold_seed(seed, group))


@torch.no_grad()
def generate_pipelined(params: Params, cfg: WaveNetConfig, mesh,
                       seed: int = 0, num_samples: int = 1,
                       first_samples=None, temperature: float = 1.0,
                       regularize: float = 0.0, global_cond=None,
                       device: str | torch.device = "cuda"):
    """Layer-pipelined generation over the ``("pipe",)`` mesh; call it on
    every rank with the same arguments (``params`` the full params).

    ``first_samples``: int ``(S, num_given)`` (or ``(num_given,)``),
    default one mid-class sample for each of ``P`` streams; ``S`` must
    divide into ``P`` groups and ``cfg.num_layers`` into ``P`` stages.
    Group ``g`` (streams ``[g*S/G, (g+1)*S/G)``) reproduces
    ``generate_fast(params, cfg, group_generator(seed, g), num_samples,
    prime_g, ...)`` bitwise. ``global_cond`` ``(S, gcond_channels)``.

    Returns ``(waveform (S, num_samples) f32, classes (S, num_samples)
    int64)`` on every rank."""
    n_stages = axis_size(mesh, PIPE_AXIS)
    if cfg.num_layers % n_stages != 0:
        raise ValueError(
            f"{cfg.num_layers} layers not divisible into {n_stages} stages")
    dev = resolve_device(device)
    if first_samples is None:
        first_samples = torch.full((n_stages, 1), cfg.classes // 2)
    prime = _prime_2d(cfg, first_samples, dev)
    S, num_given = prime.shape
    if S % n_stages != 0:
        raise ValueError(f"{S} streams not divisible into {n_stages} groups")
    if global_cond is not None and cfg.gcond_channels == 0:
        raise ValueError("global_cond given but cfg.gcond_channels == 0")
    params = params_to(params, dev)
    G = n_stages
    Sg = S // G
    s = axis_index(mesh, PIPE_AXIS)
    ranks = axis_ranks(mesh, PIPE_AXIS)
    last = G - 1
    Lp = cfg.num_layers // n_stages
    layers = range(s * Lp, (s + 1) * Lp)
    R, SK, C = cfg.residual_channels, cfg.skip_channels, cfg.classes
    total = num_given - 1 + num_samples
    rings = [[torch.zeros((Sg, buffer_length(cfg, l), R), device=dev)
              for l in layers] for _ in range(G)]
    gcond = (None if global_cond is None else torch.as_tensor(
        global_cond).to(dev, torch.float32).reshape(G, Sg, -1))
    if s == last:
        uniforms = [torch.rand((total, Sg), generator=group_generator(
            seed, g)).to(dev) for g in range(G)]
        out = torch.zeros((G, total, Sg), dtype=torch.long, device=dev)
    fed_back = {}  # one stage: the classes the head hands to the embedding
    sends = []     # (tick, pending send)
    for T in range(total * G + G - 1):
        while sends and sends[0][0] <= T - 2:
            sends.pop(0)[1].wait()
        g, n = (T - s) % G, (T - s) // G
        if T < s or n >= total:
            continue
        if s == 0:
            if n < num_given:
                cls = prime[g * Sg:(g + 1) * Sg, n]
            elif G == 1:
                cls = fed_back.pop(g)
            else:
                cls = recv((Sg,), torch.long, dev, ranks[last], _CLASS)
            h = params["start"]["w"][cls]
            if "b" in params["start"]:
                h = h + params["start"]["b"]
            h = h.to(torch.float32)
            skip = torch.zeros((Sg, SK), dtype=torch.float32, device=dev)
        else:
            packet = recv((Sg, R + SK), torch.float32, dev, ranks[s - 1],
                          _PACKET)
            h, skip = packet[:, :R], packet[:, R:]
        h, skip = advance_layers(params, cfg, rings[g], n, h, skip, layers,
                                 None, None if gcond is None else gcond[g])
        if s < last:
            sends.append((T, send(torch.cat([h, skip], dim=1),
                                  ranks[s + 1], _PACKET)))
            continue
        sampled = _sample(step_head(params, cfg, skip), uniforms[g][n], C,
                          temperature, regularize)
        out[g, n] = sampled
        if num_given <= n + 1 < total:
            if G == 1:
                fed_back[g] = sampled
            else:
                sends.append((T, send(sampled.long(), ranks[0], _CLASS)))
    for _, pending in sends:
        pending.wait()
    if s != last:
        out = torch.empty((G, total, Sg), dtype=torch.long, device=dev)
    if G > 1:
        broadcast(out, ranks[last])
    cls = out[:, num_given - 1:, :].permute(0, 2, 1).reshape(S, num_samples)
    return classes_to_waveform(cls, C), cls
