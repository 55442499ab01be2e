"""Partition specs of the WaveNet params, their local blocks, and the
autograd Functions of the Megatron head: the JAX package's
``parallel/sharding.py`` on ``torch.distributed``.

Channel parallelism of the wide head, as in the JAX package:

* ``w_skip (L, D, S)`` is column-parallel on the skip axis (``b_skip``
  with it): each rank of the ``model`` axis produces its block of the skip
  activations ``(N, T, S/model)``;
* ``end1.w (S, E)`` is row-parallel: each rank contracts its block of S
  and the partial products are summed over ``model``; ``end1.b`` is added
  after the sum;
* everything else (the start conv, the per-layer convs, the conditioning
  weights, the learnable upsampler) is replicated.

A spec is a plain tuple (``(None, None, "model")``, ``()`` replicated), so
specs compare leaf by leaf with the JAX package's ``PartitionSpec``s. A
rank keeps only its local block of a sharded leaf (:func:`shard_params`);
:func:`gather_params` puts the full tensors back together.

GSPMD's implicit collectives become two autograd Functions:
:func:`copy_to_model` (identity forward, sum over ``model`` backward)
before the column-parallel product, and :func:`reduce_from_model` (sum
over ``model`` forward, identity backward) after the row-parallel one.
``torch.distributed.nn.functional.all_reduce`` is not used for the second:
its backward sums the gradient again, which gives ``model`` times the
gradient when everything downstream is replicated.

Not ported, by design: ``activation_constraint`` (a GSPMD layout hint;
eager ranks hold their blocks as they are).
"""

from __future__ import annotations

import torch

from .mesh import (DATA_AXIS, MODEL_AXIS, all_gather, all_reduce, axis_index,
                   axis_size, broadcast)

# the JAX package's table (parallel/sharding.py:32-49); () is replicated
_TABLE = {
    "start": {"w": (), "b": ()},
    "layers": {
        "w_in": (), "b_in": (), "w_res": (), "b_res": (),
        "w_cond": (), "w_gcond": (),
        "w_skip": (None, None, MODEL_AXIS),
        "b_skip": (None, MODEL_AXIS),
    },
    "end1": {"w": (MODEL_AXIS, None), "b": ()},
    "end2": {"w": (), "b": ()},
}


def leaf_spec(path: tuple) -> tuple:
    """The spec of the param at ``path`` (``("layers", "w_skip")``); the
    learnable upsampler's stages replicate."""
    if path and path[0] == "cond_up":
        return ()
    node = _TABLE
    for key in path:
        node = node[key]
    return node


def param_pspecs(cfg, params) -> dict:
    """The spec tree matching the params' structure."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return leaf_spec(path)

    return walk(params, ())


def _model_dim(spec: tuple) -> int | None:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` (a copy)."""
    dim, m = _model_dim(spec), axis_size(mesh, MODEL_AXIS)
    if dim is None or m == 1:
        return x.detach().clone()
    n = x.shape[dim]
    if n % m:
        raise ValueError(f"dimension {dim} of size {n} does not divide over "
                         f"the model axis {m}")
    b = n // m
    i = axis_index(mesh, MODEL_AXIS)
    return x.detach().narrow(dim, i * b, b).clone()


def shard_params(params, cfg, mesh) -> dict:
    """This rank's blocks of the full params (copies, detached)."""
    specs = param_pspecs(cfg, params)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return _block(p, s, mesh)

    return walk(params, specs)


def gather_params(params, cfg, mesh) -> dict:
    """The full params from this rank's blocks: an all-gather over
    ``model`` for each sharded leaf (every rank of the group must call
    it); replicated leaves are copied."""
    specs = param_pspecs(cfg, params)

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        dim = _model_dim(s)
        if dim is None or axis_size(mesh, MODEL_AXIS) == 1:
            return p.detach().clone()
        return all_gather(p, mesh, MODEL_AXIS, dim)

    return walk(params, specs)


def _structure(tree):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def state_specs(state, params) -> object:
    """Specs for an optimizer state (live, or in optax's state-dict
    layout): a subtree with the params' structure (Adam's moments, an EMA,
    accumulated gradients, momentum) takes the params' specs, every other
    leaf (counters) is replicated."""
    want = _structure(params)
    specs = param_pspecs(None, params)

    def walk(node):
        if isinstance(node, dict):
            if node and _structure(node) == want:
                return specs
            return {k: walk(v) for k, v in node.items()}
        return ()

    return walk(state)


def shard_opt_state(opt_state, sharded_params, mesh):
    """The optimizer state with each subtree that mirrors the params cut to
    the params' blocks (a leaf already at its block's shape is copied as
    it is) and every other leaf (counters) kept, replicated. Works on the
    port's live states: Adam, ``sgd_normalized``, ``WithEma``,
    ``MultiSteps``."""
    want = _structure(sharded_params)
    specs = param_pspecs(None, sharded_params)

    def mirror(node, like, spec):
        if isinstance(node, dict):
            return {k: mirror(node[k], like[k], spec[k]) for k in node}
        if tuple(node.shape) == tuple(like.shape):
            return node.detach().clone()
        return _block(node, spec, mesh).to(like.device)

    def walk(node):
        if isinstance(node, dict):
            if node and _structure(node) == want:
                return mirror(node, sharded_params, specs)
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(opt_state)


def batch_sharding(mesh, global_batch: int) -> slice:
    """The rows of a global batch of ``global_batch`` items that this rank
    takes: its data index's block. Raises when the batch does not divide
    over the data axis."""
    n = axis_size(mesh, DATA_AXIS)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by the "
                         f"data axis size {n}")
    b = global_batch // n
    i = axis_index(mesh, DATA_AXIS)
    return slice(i * b, (i + 1) * b)


def replicate(x: torch.Tensor, mesh) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (a broadcast, in place)."""
    if mesh is None or axis_size(mesh, DATA_AXIS) * axis_size(
            mesh, MODEL_AXIS) == 1:
        return x
    return broadcast(x, 0)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x: torch.Tensor, mesh, axis: str = MODEL_AXIS
                  ) -> torch.Tensor:
    """Identity forward; the gradient summed over ``axis`` backward (the
    input of a column-parallel product, replicated over ``axis``)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis)


def reduce_from_model(x: torch.Tensor, mesh, axis: str = MODEL_AXIS
                      ) -> torch.Tensor:
    """The sum over ``axis`` forward; the gradient as it is backward (the
    partial products of a row-parallel product)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def model_sharded(path: tuple) -> bool:
    """Whether the param at ``path`` is split over the ``model`` axis."""
    return _model_dim(leaf_spec(path)) is not None
