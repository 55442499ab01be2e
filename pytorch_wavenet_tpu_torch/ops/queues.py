"""Functional dilated queue: the reference's L0 API (the JAX package's
``ops/queues.py``).

Fast generation keeps every layer's queue in one ring per layer, updated
by the kernels or ``models/generate.py``. This module provides the
reference's standalone ``DilatedQueue`` object (reference:
wavenet_modules.py:42-77) with the JAX package's value API: each method
returns a new queue and leaves the old one's tensor as it was, so one
scripted sequence of calls drives both packages."""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class DilatedQueue:
    """Ring buffer ``(num_channels, max_length)`` with enqueue/dequeue
    cursors. Methods return a new queue."""

    data: torch.Tensor
    in_pos: int = 0
    out_pos: int = 0
    dilation: int = 1
    num_deq: int = 1

    @classmethod
    def create(cls, max_length: int, num_channels: int = 1, dilation: int = 1,
               num_deq: int = 1, dtype=torch.float32) -> "DilatedQueue":
        return cls(
            data=torch.zeros((num_channels, max_length), dtype=dtype),
            dilation=dilation,
            num_deq=num_deq,
        )

    @property
    def max_length(self) -> int:
        return self.data.shape[1]

    @property
    def num_channels(self) -> int:
        return self.data.shape[0]

    def enqueue(self, value) -> "DilatedQueue":
        """Write one column at in_pos (reference: wavenet_modules.py:55-57)."""
        data = self.data.clone()
        data[:, self.in_pos] = torch.as_tensor(value, dtype=data.dtype,
                                               device=data.device)
        return replace(self, data=data,
                       in_pos=(self.in_pos + 1) % self.max_length)

    def dequeue(self, num_deq: int = 1, dilation: int = 1):
        """Gather ``num_deq`` taps spaced ``dilation`` apart ending at
        out_pos, with wrap-around (reference: wavenet_modules.py:59-72).
        Returns ``(taps (num_channels, num_deq), new_queue)``."""
        start = self.out_pos - (num_deq - 1) * dilation
        if start < 0:
            t1 = self.data[:, start::dilation]
            t2 = self.data[:, self.out_pos % dilation:
                           self.out_pos + 1:dilation]
            t = torch.cat((t1, t2), dim=1)
        else:
            t = self.data[:, start:self.out_pos + 1:dilation].clone()
        return t, replace(self, out_pos=(self.out_pos + 1) % self.max_length)

    def reset(self) -> "DilatedQueue":
        """Zero-fill and rewind (reference: wavenet_modules.py:74-77)."""
        return replace(self, data=torch.zeros_like(self.data), in_pos=0,
                       out_pos=0)
