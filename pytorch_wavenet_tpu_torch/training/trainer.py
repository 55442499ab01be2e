"""Training loop: the JAX package's ``training/trainer.py`` in PyTorch.

:func:`cross_entropy_loss` is its one-hot formulation (logsumexp minus the
one-hot hit); :func:`train_step` runs forward, loss, backward and the
optimizer update, in place on the params' tensors (JAX returns new ones);
:class:`WaveNetTrainer` keeps its cadence, snapshots with the optimizer
state, and exact resume: ``continue_training_at_step`` fast-forwards to the
epoch and batch an uninterrupted run would have reached, so a resumed run
sees the same data. With ``cfg.trunk_kernel`` the trunk runs through the
CUDA kernels K2/K3 on the card (their plain versions on the CPU).

A conditioned model (the vocoder) trains on 3-tuple batches ``(x, y,
cond)`` from :class:`~pytorch_wavenet_tpu_torch.data.mel_dataset.
MelWaveNetDataset`: mel frames, expanded to per-sample rows inside the
step (:func:`_expand_cond`) through the learnable upsampler when the
config has one, so its weights train with the rest.

The optimizer is any transform of ``training/optimizers.py`` (Adam with a
schedule, ``sgd_normalized``, an EMA, ``MultiSteps`` accumulation):
``step`` counts micro-steps, as the JAX trainer does. Snapshots go through
an :class:`~pytorch_wavenet_tpu_torch.utils.checkpoints.AsyncCheckpointer`
(cloned on the device, written by a worker thread); ``train`` waits for the
last one before it returns. The last step's gradients are kept for the
logger's histograms (:meth:`WaveNetTrainer.named_gradients`), and
:func:`generate_audio` is the audio hook's rollout (K4 on the card).

Batches travel to the card through pinned memory without blocking the
host; the loss stays on the card until the logger reads it.

Mesh mode (``mesh=``, ``parallel.mesh.make_mesh``; one rank a process):
the params and the optimizer state are this rank's blocks
(``parallel.sharding``), each step takes the rank's block of the global
batch (:class:`~pytorch_wavenet_tpu_torch.parallel.data_sharding.
ShardedBatchIterator`, ``drop_last``) and sums the gradients over the
``data`` axis (:func:`train_step`), validation computes each test item
once across the mesh, snapshots are sharded (each rank writes its own
blocks) and resume re-shards from either format. Only rank 0 prints; the
audio hook's params are gathered on every rank, on the training thread
(:meth:`WaveNetTrainer.full_params`).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..config import WaveNetConfig
from ..data.dataset import BatchIterator, PrefetchBatchIterator, WaveNetDataset
from ..device import resolve_device
from ..models.wavenet import upsample_cond, wavenet_logits
from ..ops.cuda.gen_kernel_hbm import generate_fast_batched
from ..parallel.data_sharding import ShardedBatchIterator
from ..parallel.mesh import DATA_AXIS, all_reduce, axis_size
from ..parallel.sharding import gather_params, shard_opt_state, shard_params
from ..utils import checkpoints
from ..utils.logging import Logger
from .optimizers import _leaves, _map, reference_adam

# steps between waits for the card: bounds how far the host runs ahead
_SYNC_EVERY = 25


def _expand_cond(params, cfg: WaveNetConfig, cond, cond_hop: int | None,
                 T: int):
    """Mel frames ``(N, F, M)`` -> per-sample rows ``(N, T, M)`` on the
    device (through the learnable upsampler when the config has one); rows
    already at ``(N, T, M)`` pass through."""
    if cond is None or cond.shape[1] == T:
        return cond
    if cond_hop is None:
        raise ValueError(
            f"cond has {cond.shape[1]} rows for {T} samples but no cond_hop "
            "was given to upsample it")
    return upsample_cond(params, cfg, cond, cond_hop, T)


def cross_entropy_loss(params, cfg: WaveNetConfig, x: torch.Tensor,
                       target: torch.Tensor, cond=None,
                       cond_hop: int | None = None, mesh=None
                       ) -> torch.Tensor:
    """Mean softmax cross-entropy over the ``(N * output_length)``
    predictions, as logsumexp minus the one-hot hit. ``cond``: per-sample
    rows ``(N, T, M)``, or frames ``(N, F, M)`` with ``cond_hop``.
    ``mesh``: the mean over this rank's block of the batch (see
    :func:`~pytorch_wavenet_tpu_torch.models.wavenet.wavenet_logits`)."""
    cond = _expand_cond(params, cfg, cond, cond_hop, x.shape[1])
    logits = wavenet_logits(params, cfg, x, cfg.output_length, cond=cond,
                            mesh=mesh)
    logits32 = logits.to(torch.float32)
    logz = torch.logsumexp(logits32, dim=-1)
    hit = torch.sum(logits32 * F.one_hot(target.long(), logits.shape[-1]).to(
        torch.float32), dim=-1)
    return torch.mean(logz - hit)


def train_step(params, opt_state: dict, cfg: WaveNetConfig,
               tx, x: torch.Tensor, target: torch.Tensor,
               cond=None, cond_hop: int | None = None, mesh=None):
    """One optimization step; updates ``params`` and ``opt_state`` in
    place and returns ``(loss, grads)``. ``params`` leaves require grad.

    ``mesh``: ``x``, ``target`` and ``cond`` are this rank's block of the
    global batch and ``params`` its blocks; the gradients (and the loss)
    are summed over the ``data`` axis in one all-reduce and divided by its
    size, so the step is the global batch's mean, and the optimizer takes
    the logical leaves' norms (``training.optimizers``)."""
    leaves = [p for _, p in _leaves(params)]
    loss = cross_entropy_loss(params, cfg, x, target, cond, cond_hop, mesh)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    loss = loss.detach()
    n = axis_size(mesh, DATA_AXIS)
    if n > 1:
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        flat = all_reduce(flat, mesh, DATA_AXIS) / n
        grads = [a.view_as(g) for a, g in zip(
            flat[:-1].split([g.numel() for g in grads]), grads)]
        loss = flat[-1]
    it = iter(grads)
    gtree = _map(lambda _: next(it), params)  # the leaves' order
    tx.step(params, gtree, opt_state, mesh)
    return loss, gtree


@torch.no_grad()
def eval_step(params, cfg: WaveNetConfig, x: torch.Tensor,
              target: torch.Tensor, cond=None, cond_hop: int | None = None,
              mesh=None):
    """Mean loss and the count of argmax hits; under ``mesh`` over the
    global batch (the ranks' blocks summed over ``data``)."""
    cond = _expand_cond(params, cfg, cond, cond_hop, x.shape[1])
    logits = wavenet_logits(params, cfg, x, cfg.output_length,
                            cond=cond, mesh=mesh).to(torch.float32)
    t = target.long()
    losses = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, t[..., None])[..., 0]
    correct = torch.sum(torch.argmax(logits, dim=-1) == t)
    loss = torch.mean(losses)
    n = axis_size(mesh, DATA_AXIS)
    if n > 1:
        both = all_reduce(torch.stack([loss, correct.to(loss.dtype)]), mesh,
                          DATA_AXIS)
        loss, correct = both[0] / n, torch.round(both[1]).long()
    return loss, correct


class WaveNetTrainer:
    """The reference-shaped trainer on ``device`` (default ``"cuda"``);
    with ``mesh`` one rank of a data- and model-parallel run (the module
    docstring), ``batch_size`` then the global batch."""

    def __init__(self, cfg: WaveNetConfig, params, dataset: WaveNetDataset,
                 optimizer=None, lr: float = 0.001,
                 weight_decay: float = 0.0,
                 gradient_clipping: float | None = None,
                 logger: Logger | None = None,
                 snapshot_path: str | None = None,
                 snapshot_name: str = "snapshot",
                 snapshot_interval: int = 1000, seed: int = 0,
                 num_workers: int = 4,
                 device: str | torch.device = "cuda", mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        # rank 0 prints (every rank of one process without a mesh)
        self.main_rank = torch.distributed.get_rank() == 0 if (
            mesh is not None and torch.distributed.is_initialized()) else True
        # own a copy: the steps update it in place
        self.params = self._own(params)
        self.dataset = dataset
        self.tx = optimizer if optimizer is not None else reference_adam(
            lr, weight_decay, gradient_clipping)
        self.opt_state = self.tx.init(self.params)
        self.logger = logger if logger is not None else Logger()
        self.logger.trainer = self  # validation runs at the log cadence
        self.snapshot_path = snapshot_path
        self.snapshot_name = snapshot_name
        self.snapshot_interval = snapshot_interval
        self.seed = seed
        self.num_workers = num_workers
        self.step = 0
        self.avg_step_time = None
        self._last_grads = None
        self._ckpt = checkpoints.AsyncCheckpointer(mesh)
        # frame-rate conditioning (MelWaveNetDataset.device_upsample): the
        # step expands it on the device with this hop
        self._cond_hop = (getattr(dataset, "hop_length", None)
                          if getattr(dataset, "device_upsample", False)
                          else None)

    def _own(self, params):
        """The full ``params`` as this trainer's leaves: f32 copies on its
        device (this rank's blocks under a mesh), requiring grad."""
        params = _map(lambda p: p.detach().to(
            device=self.device, dtype=torch.float32, copy=True), params)
        if self.mesh is not None:
            params = shard_params(params, self.cfg, self.mesh)
        return _map(lambda p: p.requires_grad_(True), params)

    def _batches(self, batch_size: int, **kw):
        """The batch iterator: this rank's blocks of the global batches
        under a mesh."""
        if self.mesh is not None:
            return ShardedBatchIterator(self.dataset, batch_size, self.mesh,
                                        num_workers=self.num_workers, **kw)
        if self.num_workers > 0:
            return PrefetchBatchIterator(self.dataset, batch_size,
                                         num_workers=self.num_workers, **kw)
        return BatchIterator(self.dataset, batch_size, **kw)

    def full_params(self):
        """The full params (detached copies): gathered over the ``model``
        axis under a mesh, so every rank of the mesh must call it together,
        on the training thread."""
        if self.mesh is None:
            return _map(lambda p: p.detach().clone(), self.params)
        return gather_params(self.params, self.cfg, self.mesh)

    def _put(self, x) -> torch.Tensor:
        """A host batch on the device: through pinned memory, without
        blocking, on the card."""
        t = torch.from_numpy(x)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def train(self, batch_size: int = 32, epochs: int = 10,
              continue_training_at_step: int = 0,
              max_steps: int | None = None):
        """Train from ``continue_training_at_step``, fast-forwarded to the
        epoch and batch an uninterrupted run would have reached."""
        self.step = continue_training_at_step
        step_t0 = None
        steps_per_epoch = len(BatchIterator(self.dataset, batch_size))
        if steps_per_epoch == 0:
            raise ValueError(f"dataset of {len(self.dataset)} items yields no "
                             f"batches of size {batch_size}")
        start_epoch = continue_training_at_step // steps_per_epoch
        for epoch in range(start_epoch, epochs):
            if self.main_rank:
                print("epoch", epoch)
            skip = (continue_training_at_step - start_epoch * steps_per_epoch
                    if epoch == start_epoch else 0)
            it = self._batches(batch_size, shuffle=True,
                               seed=self.seed + epoch, skip_batches=skip)
            for batch in it:
                cond = self._put(batch[2]) if len(batch) > 2 else None
                loss, self._last_grads = train_step(
                    self.params, self.opt_state, self.cfg, self.tx,
                    self._put(batch[0]), self._put(batch[1]), cond,
                    self._cond_hop, self.mesh)
                self.step += 1
                if (self.device.type == "cuda"
                        and self.step % _SYNC_EVERY == 0):
                    torch.cuda.synchronize(self.device)
                now = time.time()
                if step_t0 is not None:
                    dt = now - step_t0
                    self.avg_step_time = (dt if self.avg_step_time is None
                                          else 0.95 * self.avg_step_time
                                          + 0.05 * dt)
                step_t0 = now
                if (self.step == continue_training_at_step + 100
                        and self.main_rank):
                    print("one training step does take approximately "
                          f"{self.avg_step_time} seconds")
                if (self.snapshot_path is not None
                        and self.step % self.snapshot_interval == 0):
                    self.snapshot()
                self.logger.log(self.step, loss)
                if max_steps is not None and self.step >= max_steps:
                    self._ckpt.wait()
                    return
        self._ckpt.wait()

    def snapshot(self, wait: bool = False) -> str:
        """Checkpoint params, optimizer state (optax's layout) and step as
        they are now: cloned on the device here, copied to the host and
        written on the checkpointer's thread (under a mesh each rank writes
        its blocks into one sharded directory). ``wait``: block until this
        rank's file is on disk. Returns the path."""
        fut = self._ckpt.save(self.snapshot_path, self.snapshot_name,
                              self.step, self.params,
                              opt_state=self.opt_state, cfg=self.cfg,
                              state_dict=self.tx.state_dict)
        if wait:
            self._ckpt.wait()
        return fut.path

    def resume(self, location: str | None = None) -> int:
        """Load the newest snapshot (params, optimizer state, step) from
        ``location`` (default: the snapshot path), written by either
        package."""
        blob = checkpoints.load_latest_model_from(
            location or self.snapshot_path, device=self.device,
            verbose=self.main_rank)
        full = _map(lambda p: p.to(torch.float32), blob["params"])
        self.params = self._own(full)
        if blob["opt_state"] is None:
            self.opt_state = self.tx.init(self.params)
        else:
            state = self.tx.load_state_dict(blob["opt_state"], full)
            self.opt_state = (state if self.mesh is None else
                              shard_opt_state(state, self.params, self.mesh))
        self.step = blob["step"]
        return self.step

    def validate(self, batch_size: int = 16):
        """Average loss and argmax accuracy over the test split. Under a
        mesh each global batch is split over the data axis, so each test
        item is computed once across the mesh (the JAX trainer's rule: the
        ragged tail that cannot fill every rank is dropped)."""
        was_train = self.dataset.train
        self.dataset.train = False
        n_data = axis_size(self.mesh, DATA_AXIS)
        try:
            losses, correct, seen = [], [], 0
            for batch in self._batches(batch_size, shuffle=False,
                                       drop_last=self.mesh is not None):
                cond = self._put(batch[2]) if len(batch) > 2 else None
                loss, c = eval_step(self.params, self.cfg,
                                    self._put(batch[0]), self._put(batch[1]),
                                    cond, self._cond_hop, self.mesh)
                losses.append(loss)
                correct.append(c)
                seen += batch[1].size * n_data
            if not losses:
                return float("nan"), 0.0
            avg_loss = float(torch.mean(torch.stack(losses)))
            avg_accuracy = float(sum(correct)) / max(seen, 1)
        finally:
            self.dataset.train = was_train
        return avg_loss, avg_accuracy

    # ------------------------------------------------------- observability

    def named_parameters(self) -> list:
        """``("layers/w_in", tensor), ...`` in the JAX package's order."""
        return [("/".join(path), p) for path, p in _leaves(self.params)]

    def named_gradients(self) -> list:
        """The last step's gradients, named as :meth:`named_parameters`;
        empty before the first step."""
        if self._last_grads is None:
            return []
        return [("/".join(path), g) for path, g in _leaves(self._last_grads)]


def generate_audio(params, cfg: WaveNetConfig, length: int = 8000,
                   temperatures=(0.0, 1.0), seed: int = 0,
                   device: str | torch.device = "cuda") -> np.ndarray:
    """One clip per temperature, ``(len(temperatures), length)`` f32, the
    JAX package's ``generate_audio``: all temperatures share one batched
    rollout (one lane each, the first input ``classes // 2``, the noise
    keyed by ``seed``), K4 on the card and its plain version on the CPU.
    At temperature 0 the classes are the JAX function's (near-ties of the
    logits aside); above 0 the noise differs (the JAX function draws from
    ``jax.random``)."""
    temps = torch.tensor([float(t) for t in temperatures],
                         dtype=torch.float32)
    first = np.full((len(temps), 1), cfg.classes // 2, np.int32)
    wav, _ = generate_fast_batched(params, cfg, int(seed), length, first,
                                   temperature=temps, device=device)
    return wav.cpu().numpy()
