"""mu-law companding codec.

The numpy codec is a copy of the JAX package's ``ops/mulaw.py`` (same
quirks: ``mu = classes``, digitize against ``classes`` bin edges then
subtract 1, decode to bin edges ``(q / classes) * 2 - 1``). The torch
functions are the counterparts of its ``*_jnp`` on-device codec.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------- numpy (host)


def mu_law_encoding(data: np.ndarray, mu: int) -> np.ndarray:
    """Compand waveform in [-1, 1] to mu-law space [-1, 1]."""
    data = np.asarray(data)
    return np.sign(data) * np.log1p(mu * np.abs(data)) / np.log1p(mu)


def mu_law_expansion(data: np.ndarray, mu: int) -> np.ndarray:
    """Inverse of :func:`mu_law_encoding`."""
    data = np.asarray(data)
    return np.sign(data) * (np.exp(np.abs(data) * np.log1p(mu)) - 1) / mu


def quantize_data(data: np.ndarray, classes: int) -> np.ndarray:
    """Waveform in [-1, 1] -> integer classes in [0, classes-1]."""
    mu_x = mu_law_encoding(data, classes)
    bins = np.linspace(-1, 1, classes)
    return np.digitize(mu_x, bins) - 1


def dequantize_data(quantized: np.ndarray, classes: int) -> np.ndarray:
    """Integer classes -> waveform, via the edge-based decode."""
    x = (np.asarray(quantized, dtype=np.float64) / classes) * 2.0 - 1.0
    return mu_law_expansion(x, classes)


def dequantize_to_f32(quantized: np.ndarray, classes: int) -> np.ndarray:
    """Host-side class -> float32 waveform decode that stays in float32
    end to end."""
    cls = np.asarray(quantized)
    return mu_law_expansion(
        (cls.astype(np.float32) / classes) * 2.0 - 1.0, classes
    ).astype(np.float32)


# ------------------------------------------------------------ torch (device)


def mu_law_encoding_torch(data: torch.Tensor, mu: int) -> torch.Tensor:
    return (torch.sign(data) * torch.log1p(mu * torch.abs(data))
            / float(np.log1p(np.float32(mu))))


def mu_law_expansion_torch(data: torch.Tensor, mu: int) -> torch.Tensor:
    return (torch.sign(data)
            * (torch.exp(torch.abs(data) * float(np.log1p(np.float32(mu))))
               - 1.0) / mu)


def quantize_data_torch(data: torch.Tensor, classes: int) -> torch.Tensor:
    mu_x = mu_law_encoding_torch(data, classes)
    bins = torch.linspace(-1.0, 1.0, classes, dtype=data.dtype,
                          device=data.device)
    # np.digitize(x, bins) - 1 == searchsorted(bins, x, right=True) - 1
    return torch.searchsorted(bins, mu_x.contiguous(), right=True) - 1


def dequantize_data_torch(quantized: torch.Tensor, classes: int) -> torch.Tensor:
    x = (quantized.to(torch.float32) / classes) * 2.0 - 1.0
    return mu_law_expansion_torch(x, classes)
