"""Device selection for the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``. A
CUDA device without a card raises: nothing falls back to the CPU on its
own. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def card_description() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (a card set below its
    maximum runs slower under load, so every time printed beside it), or
    the name alone with "power limit not read" where ``nvidia-smi`` is
    missing or fails."""
    import subprocess

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        smi = None
    if smi is not None and smi.returncode == 0 and smi.stdout.strip():
        return smi.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(0)}, power limit not read"
