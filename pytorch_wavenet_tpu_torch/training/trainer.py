"""Training loop: the JAX package's ``training/trainer.py`` in PyTorch.

:func:`cross_entropy_loss` is its one-hot formulation (logsumexp minus the
one-hot hit); :func:`train_step` runs forward, loss, backward and the
optimizer update, in place on the params' tensors (JAX returns new ones);
:class:`WaveNetTrainer` keeps its cadence, snapshots with the optimizer
state, and exact resume: ``continue_training_at_step`` fast-forwards to the
epoch and batch an uninterrupted run would have reached, so a resumed run
sees the same data. With ``cfg.trunk_kernel`` the trunk runs through the
CUDA kernels K2/K3 on the card (their plain versions on the CPU).

Batches travel to the card through pinned memory without blocking the
host; the loss stays on the card until the logger reads it. The JAX
package's ``generate_audio``, mesh mode and conditioning are not ported.
"""

from __future__ import annotations

import time

import torch
import torch.nn.functional as F

from ..config import WaveNetConfig
from ..data.dataset import BatchIterator, PrefetchBatchIterator, WaveNetDataset
from ..device import resolve_device
from ..models.wavenet import wavenet_logits
from ..utils import checkpoints
from ..utils.logging import Logger
from .optimizers import ReferenceAdam, _leaves, _map, reference_adam

# steps between waits for the card: bounds how far the host runs ahead
_SYNC_EVERY = 25


def cross_entropy_loss(params, cfg: WaveNetConfig, x: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over the ``(N * output_length)``
    predictions, as logsumexp minus the one-hot hit."""
    logits = wavenet_logits(params, cfg, x, cfg.output_length)
    logits32 = logits.to(torch.float32)
    logz = torch.logsumexp(logits32, dim=-1)
    hit = torch.sum(logits32 * F.one_hot(target.long(), logits.shape[-1]).to(
        torch.float32), dim=-1)
    return torch.mean(logz - hit)


def train_step(params, opt_state: dict, cfg: WaveNetConfig,
               tx: ReferenceAdam, x: torch.Tensor, target: torch.Tensor):
    """One optimization step; updates ``params`` and ``opt_state`` in
    place and returns ``(loss, grads)``. ``params`` leaves require grad."""
    leaves = [p for _, p in _leaves(params)]
    loss = cross_entropy_loss(params, cfg, x, target)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)])
    gtree = _map(lambda _: next(it), params)  # the leaves' order
    tx.step(params, gtree, opt_state)
    return loss.detach(), gtree


@torch.no_grad()
def eval_step(params, cfg: WaveNetConfig, x: torch.Tensor,
              target: torch.Tensor):
    """Mean loss and the count of argmax hits."""
    logits = wavenet_logits(params, cfg, x, cfg.output_length).to(
        torch.float32)
    t = target.long()
    losses = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, t[..., None])[..., 0]
    correct = torch.sum(torch.argmax(logits, dim=-1) == t)
    return torch.mean(losses), correct


class WaveNetTrainer:
    """The reference-shaped trainer on ``device`` (default ``"cuda"``)."""

    def __init__(self, cfg: WaveNetConfig, params, dataset: WaveNetDataset,
                 optimizer: ReferenceAdam | None = None, lr: float = 0.001,
                 weight_decay: float = 0.0,
                 gradient_clipping: float | None = None,
                 logger: Logger | None = None,
                 snapshot_path: str | None = None,
                 snapshot_name: str = "snapshot",
                 snapshot_interval: int = 1000, seed: int = 0,
                 num_workers: int = 4,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # own a copy: the steps update it in place
        self.params = _map(lambda p: p.detach().to(
            device=self.device, dtype=torch.float32, copy=True
        ).requires_grad_(True), params)
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
            print("epoch", epoch)
            skip = (continue_training_at_step - start_epoch * steps_per_epoch
                    if epoch == start_epoch else 0)
            kw = dict(shuffle=True, seed=self.seed + epoch, skip_batches=skip)
            it = (PrefetchBatchIterator(self.dataset, batch_size,
                                        num_workers=self.num_workers, **kw)
                  if self.num_workers > 0
                  else BatchIterator(self.dataset, batch_size, **kw))
            for x, target in it:
                loss, _ = train_step(self.params, self.opt_state, self.cfg,
                                     self.tx, self._put(x), self._put(target))
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
                if self.step == continue_training_at_step + 100:
                    print("one training step does take approximately "
                          f"{self.avg_step_time} seconds")
                if (self.snapshot_path is not None
                        and self.step % self.snapshot_interval == 0):
                    self.snapshot()
                self.logger.log(self.step, loss)
                if max_steps is not None and self.step >= max_steps:
                    return

    def snapshot(self) -> str:
        """Write params, optimizer state (optax's layout) and step."""
        return checkpoints.save_checkpoint(
            self.snapshot_path, self.snapshot_name, self.step, self.params,
            cfg=self.cfg, opt_state=self.tx.state_dict(self.opt_state))

    def resume(self, location: str | None = None) -> int:
        """Load the newest snapshot (params, optimizer state, step) from
        ``location`` (default: the snapshot path), written by either
        package."""
        blob = checkpoints.load_latest_model_from(
            location or self.snapshot_path, device=self.device)
        self.params = _map(lambda p: p.to(torch.float32).requires_grad_(True),
                           blob["params"])
        self.opt_state = (self.tx.load_state_dict(blob["opt_state"],
                                                  self.params)
                          if blob["opt_state"] is not None
                          else self.tx.init(self.params))
        self.step = blob["step"]
        return self.step

    def validate(self, batch_size: int = 16):
        """Average loss and argmax accuracy over the test split."""
        was_train = self.dataset.train
        self.dataset.train = False
        try:
            losses, correct, seen = [], [], 0
            for x, target in BatchIterator(self.dataset, batch_size,
                                           shuffle=False, drop_last=False):
                loss, c = eval_step(self.params, self.cfg, self._put(x),
                                    self._put(target))
                losses.append(loss)
                correct.append(c)
                seen += target.size
            if not losses:
                return float("nan"), 0.0
            avg_loss = float(torch.mean(torch.stack(losses)))
            avg_accuracy = float(sum(correct)) / max(seen, 1)
        finally:
            self.dataset.train = was_train
        return avg_loss, avg_accuracy
