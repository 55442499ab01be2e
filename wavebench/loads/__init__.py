"""The loads: one per kind of traffic (``pool``, ``stream``),
each a general load of the program's entry point, parameterised by the
traffic mix. A load builds the system under test from the inputs, warms
the cell's own shapes, measures the window, reads what the check needs,
frees the program's state and runs the reference.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Context:
    model: dict          # the configuration's model fields
    mix: dict            # the traffic mix
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    capture: object      # tracing.Capture
    t_process: float     # perf_counter at process start
    control: bool = False    # also read the control and the faults


@dataclass
class RunRecord:
    t_open: float = 0.0
    t_close: float = 0.0
    attempted: int = 0
    failed: int = 0
    e2e: dict = field(default_factory=dict)
    x: dict = field(default_factory=dict)       # what readers read
    compared: dict = field(default_factory=dict)  # numbers for `correct`
    control: dict = field(default_factory=dict)   # the control's numbers
    readings: dict = field(default_factory=dict)  # the faults' readings
    memory_peak_bytes: int = 0


def port_config(model: dict, **over):
    """The port's ``WaveNetConfig`` for the configuration's fields."""
    from pytorch_wavenet_tpu_torch.config import WaveNetConfig

    fields = {k: v for k, v in model.items() if k in (
        "layers", "blocks", "dilation_channels", "residual_channels",
        "skip_channels", "end_channels", "classes", "kernel_size", "bias")}
    fields.update(over)
    return WaveNetConfig(**fields)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device):
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def nearest_rank(values: list, q: float) -> float:
    """The q-quantile by nearest rank (a failure is +inf)."""
    v = sorted(values)
    if not v:
        return float("nan")
    i = max(0, min(len(v) - 1, math.ceil(q * len(v) - 1e-9) - 1))
    return v[i]


def now() -> float:
    return time.perf_counter()


def judge_served(ctx, rec: RunRecord, params: dict, checked: list):
    """The served check: the program's widest gap and, with
    ``ctx.control``, the control's and the altered class's, read at the
    same positions. ``checked``: ``(prime, served, temperature, seed)``."""
    from ..reference import judge

    if not checked:
        rec.compared = {"gap": float("inf")}
        rec.control = dict(rec.compared)
        return
    t_check = now()
    res = judge.judge_served(params, ctx.model, checked, ctx.device,
                             control=ctx.control)
    rec.x["check_s"] = now() - t_check
    rec.compared = {"gap": res["gap"]}
    rec.x["checked_positions"] = res["positions"]
    if ctx.control:
        rec.control = {"gap": res["control_gap"]}
        rec.readings["fault_gap"] = res["fault_gap"]
