"""Checkpoints in the JAX package's ``pytorch_wavenet_tpu/1`` format.

A checkpoint is one msgpack blob (flax's encoding) holding the config
JSON, the params, the optimizer state and the step, written atomically
(tmp + rename) to ``{directory}/{name}_{step:010d}.ckpt``. Either package
reads what the other writes. The codec is the port's own
(``utils/msgpack_lite.py``): the machine with the card has no ``msgpack``.

``opt_state`` is the optimizer state in optax's state-dict layout
(``training/optimizers.py::ReferenceAdam.state_dict``), nil when there is
none; a loaded blob hands it back as nested numpy, which the JAX package
reads with ``load_checkpoint(path, opt_state_template=tx.init(params))``
and the port's optimizer with ``load_state_dict``. Sharded checkpoint
directories (``.ckpt.sharded``) are not read.
"""

from __future__ import annotations

import os
import time

import torch

from ..config import WaveNetConfig
from ..device import resolve_device
from ..models.convert import from_jax_params, to_numpy_params
from .msgpack_lite import packb, unpackb

CKPT_SUFFIX = ".ckpt"
FORMAT = "pytorch_wavenet_tpu/1"


def checkpoint_path(directory: str, name: str, step: int) -> str:
    return os.path.join(directory, f"{name}_{step:010d}{CKPT_SUFFIX}")


def save_checkpoint(directory: str, name: str, step: int, params,
                    cfg: WaveNetConfig | None = None,
                    extra: dict | None = None, opt_state=None) -> str:
    """Write the params (torch tensors or numpy arrays, nested dicts) with
    ``cfg``, ``step`` and ``opt_state`` (optax's state-dict layout, nested
    dicts of tensors or numpy, or None); returns the path."""
    path = checkpoint_path(directory, name, step)
    os.makedirs(directory, exist_ok=True)
    blob = {
        "format": FORMAT,
        "time": time.time(),
        "step": int(step),
        "config": cfg.to_json() if cfg is not None else None,
        "params": to_numpy_params(params),
        "opt_state": (to_numpy_params(opt_state) if opt_state is not None
                      else None),
        "extra": extra or {},
    }
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(packb(blob))
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, device: str | torch.device = "cuda") -> dict:
    """Read a checkpoint file: a dict with ``step``, ``config``
    (WaveNetConfig or None), ``params`` (torch tensors on ``device``),
    ``opt_state`` (nested numpy or None) and ``extra``."""
    dev = resolve_device(device)
    if os.path.isdir(path):
        raise ValueError(f"{path} is a sharded checkpoint directory; the "
                         "port reads single-file checkpoints only")
    with open(path, "rb") as f:
        blob = unpackb(f.read())
    return {
        "step": int(blob["step"]),
        "config": (WaveNetConfig.from_json(blob["config"])
                   if blob["config"] else None),
        "params": from_jax_params(blob["params"], dev),
        "opt_state": blob.get("opt_state"),
        "extra": blob.get("extra", {}),
    }


def latest_checkpoint(location: str) -> str | None:
    """Newest ``.ckpt`` file in ``location`` by (step, mtime); None when
    there is none."""
    if not os.path.isdir(location):
        return None
    files = []
    for f in os.listdir(location):
        p = os.path.join(location, f)
        if f.endswith(CKPT_SUFFIX) and os.path.isfile(p):
            files.append((p, f[: -len(CKPT_SUFFIX)]))
    if not files:
        return None

    def key(entry):
        p, stem = entry
        try:
            step = int(stem.rsplit("_", 1)[-1])
        except ValueError:
            step = -1
        return (step, os.path.getmtime(p))

    return max(files, key=key)[0]


def load_latest_model_from(location: str,
                           device: str | torch.device = "cuda") -> dict:
    """Load the newest checkpoint in ``location``."""
    path = latest_checkpoint(location)
    if path is None:
        raise FileNotFoundError(f"no checkpoints under {location}")
    print("load model " + path)
    return load_checkpoint(path, device)
