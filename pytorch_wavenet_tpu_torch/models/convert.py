"""Carry params between the JAX package's numpy trees and the port.

Both packages use the same nested-dict layout (``models/wavenet.py``), so
conversion is a leaf-by-leaf copy; checkpoints and the tests go through
these two functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def from_jax_params(tree, device: str | torch.device = "cuda"):
    """Nested dict of array-likes (numpy, or anything ``np.asarray``
    takes) -> the same dict of torch tensors on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def to_numpy_params(params):
    """Port params -> the same dict of numpy arrays (host copies; numpy
    leaves pass through, and None stays None: optax's empty optional
    states, such as ``sgd_normalized`` without momentum)."""
    if params is None:
        return None
    if isinstance(params, dict):
        return {k: to_numpy_params(v) for k, v in params.items()}
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return np.asarray(params)
