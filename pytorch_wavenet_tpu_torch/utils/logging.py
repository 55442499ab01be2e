"""Training observability: the JAX package's ``Logger`` (``utils/logging.py``).

Cadenced hooks off the training step: the windowed average loss every
``log_interval`` steps, validation every ``validation_interval`` (through
the ``trainer`` back-reference, which the trainer sets) and an audio
callback every ``generate_interval`` on a daemon thread, skipped while the
previous one still runs. The loss may be a device scalar: it is read on the
host only at the log cadence, so the loop does not wait for the card every
step.

:class:`TensorboardLogger` (the JAX package's) writes TensorBoard event
files through the port's dependency-free writer (``utils/tensorboard.py``):
the loss scalar and the parameter and gradient histograms at the log
cadence, the validation scalars at the validation cadence, and the audio
clips that the generate callback passes to :meth:`audio_summary`.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x)


class Logger:
    def __init__(self, log_interval: int = 50, validation_interval: int = 200,
                 generate_interval: int = 500, trainer=None,
                 generate_function: Callable | None = None):
        self.trainer = trainer
        self.log_interval = log_interval
        self.validation_interval = validation_interval
        self.generate_interval = generate_interval
        self.accumulated_loss = 0.0
        self.generate_function = generate_function
        self.generate_thread: threading.Thread | None = None

    def log(self, current_step: int, current_loss):
        self.accumulated_loss = self.accumulated_loss + current_loss
        if current_step % self.log_interval == 0:
            self.log_loss(current_step)
            self.accumulated_loss = 0.0
        if current_step % self.validation_interval == 0:
            self.validate(current_step)
        if current_step % self.generate_interval == 0:
            self.generate(current_step)

    def log_loss(self, current_step: int):
        avg_loss = float(self.accumulated_loss) / self.log_interval
        print(f"loss at step {current_step}: {avg_loss}")

    def validate(self, current_step: int):
        if self.trainer is None:
            return
        avg_loss, avg_accuracy = self.trainer.validate()
        print(f"validation loss: {avg_loss}")
        print(f"validation accuracy: {avg_accuracy * 100}%")

    def generate(self, current_step: int):
        if self.generate_function is None:
            return
        if self.generate_thread is not None and self.generate_thread.is_alive():
            print("Last generate is still running, skipping this one")
            return
        self.generate_thread = threading.Thread(
            target=self.generate_function, args=[current_step], daemon=True)
        self.generate_thread.start()


class TensorboardLogger(Logger):
    """Scalars, per-parameter and per-gradient histograms and audio clips
    in a TensorBoard event file under ``log_dir`` (reference:
    model_logging.py:62-163). Writes come from the training thread and from
    the generate callback's thread, so they take a lock."""

    def __init__(self, log_interval: int = 50, validation_interval: int = 200,
                 generate_interval: int = 500, trainer=None,
                 generate_function: Callable | None = None,
                 log_dir: str = "logs", log_histograms: bool = True):
        super().__init__(log_interval, validation_interval, generate_interval,
                         trainer, generate_function)
        from .tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir)
        self.log_histograms = log_histograms
        self._lock = threading.Lock()

    def log_loss(self, current_step: int):
        avg_loss = float(self.accumulated_loss) / self.log_interval
        self.scalar_summary("loss", avg_loss, current_step)
        if self.log_histograms and self.trainer is not None:
            # (reference: model_logging.py:79-83)
            for tag, value in self.trainer.named_parameters():
                self.histo_summary(tag.replace(".", "/"), _host(value),
                                   current_step)
            for tag, grad in self.trainer.named_gradients():
                self.histo_summary(tag.replace(".", "/") + "/grad",
                                   _host(grad), current_step)

    def validate(self, current_step: int):
        if self.trainer is None:
            return
        avg_loss, avg_accuracy = self.trainer.validate()
        self.scalar_summary("validation loss", avg_loss, current_step)
        self.scalar_summary("validation accuracy", avg_accuracy, current_step)

    def log_audio(self, step: int):
        """Run the generate callback here (not on a thread) and write what
        it returns as audio (reference: model_logging.py:90-93)."""
        if self.generate_function is None:
            return
        samples = self.generate_function(step)
        if samples is not None:
            self.audio_summary("audio sample", samples, step, sr=16000)

    def scalar_summary(self, tag, value, step):
        with self._lock:
            self.writer.add_scalar(tag, value, step)

    def histo_summary(self, tag, values, step, bins=200):
        with self._lock:
            self.writer.add_histogram(tag, values, step, bins=bins)

    def image_summary(self, tag, images, step):
        with self._lock:
            for i, img in enumerate(images):
                self.writer.add_image(f"{tag}/{i}", img, step)

    def audio_summary(self, tag, samples, step, sr=16000):
        samples = np.atleast_2d(_host(samples))
        with self._lock:
            for i, clip in enumerate(samples):
                self.writer.add_audio(f"{tag}/{i}", clip, step,
                                      sample_rate=sr)

    def flush(self):
        with self._lock:
            self.writer.flush()

    def close(self):
        with self._lock:
            self.writer.close()
