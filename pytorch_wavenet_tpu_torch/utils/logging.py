"""Training observability: the JAX package's ``Logger`` (``utils/logging.py``).

Cadenced hooks off the training step: the windowed average loss every
``log_interval`` steps, validation every ``validation_interval`` (through
the ``trainer`` back-reference, which the trainer sets) and an audio
callback every ``generate_interval`` on a daemon thread, skipped while the
previous one still runs. The loss may be a device scalar: it is read on the
host only at the log cadence, so the loop does not wait for the card every
step. ``TensorboardLogger`` is not ported.
"""

from __future__ import annotations

import threading
from typing import Callable


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
