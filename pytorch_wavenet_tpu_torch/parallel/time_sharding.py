"""Time-axis (context) parallelism: the trunk with T split across ranks,
the JAX package's ``parallel/time_sharding.py``.

Each rank holds a contiguous block of the time axis; a layer with
dilation ``d`` needs the ``(kernel_size-1)*d`` trailing columns of the left
neighbour's residual stream (the halo) before it can compute its first
positions. The halo is one send/recv pair per layer (:class:`_Halo`, an
autograd Function whose backward sends the halo's gradient back to the
left neighbour); the leftmost rank uses zeros, the zero history of the
unsharded trunk. The per-block math is plain PyTorch, as the JAX
package's is plain JAX; the weights are replicated and enter through
:func:`~pytorch_wavenet_tpu_torch.parallel.sharding.copy_to_model` over the
time axis, so their gradients come out summed over the blocks, as the
JAX package's ``shard_map`` of replicated weights gives them.

Constraint: the block length ``T/n`` must be at least the largest halo
``(k-1)*max_dilation``, so one neighbour hop suffices.
"""

from __future__ import annotations

import torch

from ..config import WaveNetConfig
from ..models.wavenet import Params, _mm, embed_inputs
from .mesh import DATA_AXIS, axis_index, axis_ranks, axis_size, recv, send
from .sharding import copy_to_model, reduce_from_model


def max_halo(cfg: WaveNetConfig) -> int:
    """Largest per-layer halo: (kernel_size-1) * max_dilation."""
    return (cfg.kernel_size - 1) * cfg.max_dilation


def _exchange(x: torch.Tensor, to: int | None, frm: int | None, tag: int
              ) -> torch.Tensor | None:
    """Send ``x`` to global rank ``to`` and receive a tensor of ``x``'s
    shape from ``frm`` (either may be None); returns what arrived."""
    pending = send(x, to, tag) if to is not None else None
    got = (recv(x.shape, x.dtype, x.device, frm, tag)
           if frm is not None else None)
    if pending is not None:
        pending.wait()
    return got


class _Halo(torch.autograd.Function):
    """The last ``need`` columns of the left neighbour's ``h`` (zeros on
    the leftmost rank); backward sends the halo's gradient to the left
    neighbour and adds the right neighbour's to this block's tail."""

    @staticmethod
    def forward(ctx, h, need, left, right, tag):
        ctx.need, ctx.left, ctx.right, ctx.tag = need, left, right, tag
        ctx.shape = h.shape
        tail = h[:, h.shape[1] - need:, :].contiguous()
        got = _exchange(tail, right, left, tag)
        return torch.zeros_like(tail) if got is None else got

    @staticmethod
    def backward(ctx, g):
        back = _exchange(g.contiguous(), ctx.left, ctx.right, ctx.tag)
        gh = g.new_zeros(ctx.shape)
        if back is not None:
            gh[:, ctx.shape[1] - ctx.need:, :] = back
        return gh, None, None, None, None


def _left_halo(h: torch.Tensor, need: int, mesh, axis: str, tag: int
               ) -> torch.Tensor:
    ranks = axis_ranks(mesh, axis)
    i = axis_index(mesh, axis)
    left = ranks[i - 1] if i > 0 else None
    right = ranks[i + 1] if i + 1 < len(ranks) else None
    if left is None and right is None:
        return torch.zeros_like(h[:, h.shape[1] - need:, :])
    return _Halo.apply(h, need, left, right, tag)


def _check(cfg: WaveNetConfig, T: int, n: int) -> None:
    if T % n:
        raise ValueError(f"T={T} not divisible by {n} time shards")
    if T // n < max_halo(cfg):
        raise ValueError(
            f"shard length {T // n} < max halo {max_halo(cfg)}; use fewer "
            "shards or longer sequences (one-hop halo exchange)")


def time_sharded_logits(params: Params, cfg: WaveNetConfig, x, mesh,
                        axis_name: str = DATA_AXIS) -> torch.Tensor:
    """Trunk forward with the time axis split over ``axis_name``.

    ``x``: int ``(N, T)``, the whole input on every rank, with ``T``
    divisible by the axis size and ``T/n >= max_halo(cfg)``. Returns this
    rank's block of the logits, ``(N, T/n, classes)`` for positions ``[i *
    T/n, (i+1) * T/n)``: position t sees x[<=t] with zero history before
    t = 0, the semantics of ``wavenet_logits(..., out_len=T)``. ``params``
    are the full (replicated) params, differentiable: their gradients come
    out summed over the blocks."""
    n = axis_size(mesh, axis_name)
    N, T = x.shape
    _check(cfg, T, n)
    i = axis_index(mesh, axis_name)
    Tl = T // n
    x = torch.as_tensor(x).to(params["start"]["w"].device)[
        :, i * Tl:(i + 1) * Tl]
    p = {k: {kk: copy_to_model(v, mesh, axis_name) for kk, v in d.items()}
         for k, d in params.items()}
    k = cfg.kernel_size
    cdt = cfg.compute_dtype
    h = embed_inputs(p, cfg, x)  # (N, Tl, R)
    lp = p["layers"]
    skip = torch.zeros((N, Tl, cfg.skip_channels), dtype=torch.float32,
                       device=h.device)
    for l, d in enumerate(cfg.dilations):
        need = (k - 1) * d
        hx = torch.cat([_left_halo(h, need, mesh, axis_name, l), h], dim=1)
        z = _mm(h, lp["w_in"][l, k - 1], cdt)
        for j in range(k - 1):
            back = (k - 1 - j) * d
            z = z + _mm(hx[:, need - back:need - back + Tl], lp["w_in"][l, j],
                        cdt)
        if "b_in" in lp:
            z = z + lp["b_in"][l]
        f, g = z.chunk(2, dim=-1)
        u = torch.tanh(f) * torch.sigmoid(g)
        s = _mm(u, lp["w_skip"][l], cdt)
        if "b_skip" in lp:
            s = s + lp["b_skip"][l]
        skip = skip + s
        r = _mm(u, lp["w_res"][l], cdt)
        if "b_res" in lp:
            r = r + lp["b_res"][l]
        h = r + h
    y = torch.relu(skip)
    y = torch.relu(_mm(y, p["end1"]["w"], cdt) + p["end1"]["b"])
    return _mm(y, p["end2"]["w"], cdt) + p["end2"]["b"]


def time_sharded_loss(params: Params, cfg: WaveNetConfig, x, target, mesh,
                      axis_name: str = DATA_AXIS) -> torch.Tensor:
    """Teacher-forced cross-entropy over the valid suffix with T split:
    ``target[:, t]`` labels position t; only positions with a full
    receptive field (t >= rf - 1) count, masked on each block. The value
    (the same on every rank) and the params' gradients equal the
    unsharded loss's."""
    T = x.shape[1]
    rf = cfg.receptive_field
    if T < rf:
        raise ValueError(
            f"T={T} < receptive field {rf}: no position has a full "
            "receptive field, the masked loss would be 0/0")
    logits = time_sharded_logits(params, cfg, x, mesh, axis_name)
    Tl = logits.shape[1]
    i = axis_index(mesh, axis_name)
    pos = torch.arange(i * Tl, (i + 1) * Tl, device=logits.device)[None, :]
    valid = (pos >= rf - 1).to(torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    tgt = torch.as_tensor(target)[:, i * Tl:(i + 1) * Tl].long().to(
        logits.device)
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    total = reduce_from_model(torch.sum(nll * valid), mesh, axis_name)
    return total / ((T - rf + 1) * x.shape[0])
