"""Multi-rank training and generation entry points: the JAX package's
``parallel/training.py`` on ``torch.distributed``.

One step function serves every mesh shape: the params are this rank's
blocks (:func:`~.sharding.shard_params`), the batch is this rank's block of
the global batch (:func:`put_batch`), and
:func:`~pytorch_wavenet_tpu_torch.training.trainer.train_step` with the
mesh runs the trunk on it (K2/K3 on the card), the column- and
row-parallel head over ``model``, and one all-reduce of the gradients over
``data``. Generation shards streams over ``data``: the plain step
(:func:`sharded_generate_fast`) or K4 (:func:`sharded_generate_fast_batched`,
:func:`sharded_pool_step`), each rank on its own streams.

The JAX package's ``stage_layers`` and ``head_tiles`` (TPU VMEM
workarounds) are dropped, as everywhere in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import WaveNetConfig
from ..device import resolve_device
from ..models.generate import _rollout, _prime_2d
from ..models.wavenet import params_to
from ..ops.cuda.gen_kernel_hbm import HbmGenState, generate_fast_batched
from ..training.optimizers import _map
from ..training.trainer import train_step
from .mesh import DATA_AXIS, all_gather, axis_index, axis_size, fold_seed
from .sharding import batch_sharding, shard_params


def make_sharded_train_state(cfg: WaveNetConfig, params, tx, mesh):
    """This rank's blocks of ``params`` (leaves requiring grad) and the
    optimizer state of those blocks (``tx.init``: the moments take the
    blocks' shapes, counters are plain ints on every rank)."""
    local = _map(lambda p: p.requires_grad_(True),
                 shard_params(params, cfg, mesh))
    return local, tx.init(local)


def put_batch(mesh, x, target, device: str | torch.device = "cuda"):
    """This rank's block (its data index's rows) of the global batch ``x``,
    ``target`` (numpy or tensors, the same on every rank), on ``device``.
    Raises when the global batch does not divide over the data axis."""
    rows = batch_sharding(mesh, len(x))
    dev = resolve_device(device)

    def put(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return t[rows].to(dev)

    return put(x), put(target)


def parallel_train_step(params, opt_state, cfg: WaveNetConfig, tx, x, target,
                        cond=None, cond_hop=None, mesh=None,
                        device: str | torch.device = "cuda"):
    """One step on the global batch ``x``, ``target`` (and ``cond``), the
    same on every rank: this rank takes its block, and the step is the
    global batch's mean (``train_step`` with the mesh). ``params`` and
    ``opt_state`` (this rank's, :func:`make_sharded_train_state`) are
    updated in place. Returns ``(params, opt_state, loss)``, the loss the
    global mean. Raises when the global batch does not divide over the
    data axis."""
    xb, yb = put_batch(mesh, x, target, device)
    if cond is not None:
        cond, _ = put_batch(mesh, cond, cond, device)
    loss, _ = train_step(params, opt_state, cfg, tx, xb, yb, cond, cond_hop,
                         mesh)
    return params, opt_state, loss


def data_parallel_batch_iterator(it, mesh,
                                 device: str | torch.device = "cuda"):
    """Wrap an iterator of global batches ``(x, y)``, yielding this rank's
    block of each on ``device``."""
    for x, y in it:
        yield put_batch(mesh, x, y, device)


def _streams(mesh, first_samples, cfg) -> tuple[torch.Tensor, slice, int]:
    prime = _prime_2d(cfg, first_samples, "cpu")
    S = prime.shape[0]
    n = axis_size(mesh, DATA_AXIS)
    if S % n:
        raise ValueError(f"{S} streams not divisible by data axis {n}")
    b = S // n
    i = axis_index(mesh, DATA_AXIS)
    return prime, slice(i * b, (i + 1) * b), S


def sharded_generate_fast(params, cfg: WaveNetConfig, mesh, generator,
                          num_samples: int, first_samples,
                          temperature: float = 1.0, regularize: float = 0.0,
                          device: str | torch.device = "cuda"):
    """Many-stream generation with the streams split over the data axis:
    each rank runs the plain step (``generate_fast``'s) on its block of
    ``first_samples`` ``(S, num_given)``, S divisible by the data size,
    and the whole ``(S, num_samples)`` result is all-gathered to every
    rank. ``params`` are the full params. The uniforms are the global
    call's (``torch.rand((total, S), generator)``, this rank's columns), so
    the result equals ``generate_fast`` on all S streams at every
    temperature."""
    dev = resolve_device(device)
    prime, rows, S = _streams(mesh, first_samples, cfg)
    wav, cls = _rollout(params_to(params, dev), cfg, generator, num_samples,
                        prime[rows], temperature, regularize, None, False,
                        dev, None, None, uniform_cols=(rows, S))
    return (all_gather(wav, mesh, DATA_AXIS),
            all_gather(cls, mesh, DATA_AXIS))


def sharded_generate_fast_batched(params, cfg: WaveNetConfig, mesh, seed,
                                  num_samples: int, first_samples,
                                  temperature: float = 1.0,
                                  regularize: float = 0.0,
                                  ring_dtype=torch.float32,
                                  device: str | torch.device = "cuda"):
    """K4 on each rank's block of the streams (the plain version on the
    CPU), the ``(S, num_samples)`` result all-gathered to every rank. The
    counter-hash seed is folded with the data index (``fold_seed``), as
    the JAX package folds its key with the axis index, so results at
    temperature > 0 depend on the mesh size (argmax rollouts do not)."""
    prime, rows, _ = _streams(mesh, first_samples, cfg)
    i = axis_index(mesh, DATA_AXIS)
    wav, cls = generate_fast_batched(
        params, cfg, fold_seed(0 if seed is None else seed, i), num_samples,
        prime[rows], temperature=temperature, regularize=regularize,
        ring_dtype=ring_dtype, device=device)
    return (all_gather(wav, mesh, DATA_AXIS),
            all_gather(cls, mesh, DATA_AXIS))


def shard_pool_state(state: HbmGenState, mesh) -> HbmGenState:
    """This rank's lane block of a whole pool's :class:`HbmGenState` (its
    data index's lanes; a copy)."""
    rows = batch_sharding(mesh, state.cls.shape[0])
    return HbmGenState(ring=state.ring[:, rows].clone(), t=state.t,
                       cls=state.cls[rows].clone())


def sharded_pool_step(params, cfg: WaveNetConfig, mesh, key, chunk: int,
                      state: HbmGenState, *, temperature, lane_seed,
                      lane_clock, cond=None, ring_dtype=None,
                      fuse_res: bool = False, skip_slab: bool = False,
                      regularize: float = 0.0,
                      device: str | torch.device = "cuda"):
    """One continuous-batching pool step with the lanes split over the
    data axis: each rank advances its lane block ``state``
    (:func:`shard_pool_state`) by ``chunk`` samples in one K4 launch.
    ``temperature``, ``lane_seed`` and ``lane_clock`` (required) and
    ``cond`` ``(lanes, chunk, M)`` are the whole pool's (every rank takes
    its lanes'). The noise rides each lane's counters, so a lane's classes
    and ring are bitwise those of the unsharded step whatever the mesh;
    ``key`` does not enter. Returns ``(classes (lanes, chunk)``
    all-gathered, this rank's new lane block)."""
    n = axis_size(mesh, DATA_AXIS)
    lanes = len(lane_seed)
    if lanes % n:
        raise ValueError(f"{lanes} lanes not divisible by data axis {n}")
    if state.cls.shape[0] * n != lanes:
        raise ValueError(f"the state holds {state.cls.shape[0]} lanes; this "
                         f"rank's block of {lanes} over {n} ranks is "
                         f"{lanes // n}")
    rows = batch_sharding(mesh, lanes)

    def block(x):
        t = torch.as_tensor(x)
        return (t.expand(lanes) if t.dim() == 0 else t)[rows]

    _, out, st = generate_fast_batched(
        params, cfg, key, chunk, None, temperature=block(temperature),
        state=state, return_state=True, lane_seed=block(lane_seed),
        lane_clock=block(lane_clock),
        cond=None if cond is None else block(cond),
        ring_dtype=state.ring.dtype if ring_dtype is None else ring_dtype,
        fuse_res=fuse_res, skip_slab=skip_slab, regularize=regularize,
        device=device)
    return all_gather(out, mesh, DATA_AXIS), st
