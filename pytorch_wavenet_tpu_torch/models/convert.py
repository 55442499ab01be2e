"""Carry params between the JAX package's numpy trees and the port.

Both packages use the same nested layout (``models/wavenet.py``; the
student's flows are a tuple, ``models/iaf.py``), so conversion is a
leaf-by-leaf copy; checkpoints and the tests go through these two
functions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def from_jax_params(tree, device: str | torch.device = "cuda"):
    """Nested dicts, tuples and lists of array-likes (numpy, or anything
    ``np.asarray`` takes) -> the same tree of torch tensors on ``device``
    (lists become tuples, as JAX's pytrees hold the student's flows)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(v) for v in x)
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def to_numpy_params(params):
    """Port params -> the same dicts of numpy arrays (host copies; numpy
    leaves pass through, and None stays None: optax's empty optional
    states, such as ``sgd_normalized`` without momentum). Tuples and lists
    become dicts keyed ``"0"``, ``"1"``, ...: flax's state-dict layout, the
    one checkpoints store (the student's flows)."""
    if params is None:
        return None
    if isinstance(params, dict):
        return {k: to_numpy_params(v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return {str(i): to_numpy_params(v) for i, v in enumerate(params)}
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return np.asarray(params)
