"""Profiling and tracing (the JAX package's ``utils/profiling.py``).

:func:`trace` captures a ``torch.profiler`` trace (the host's ops and, on a
card, every CUDA kernel, the hand-written ones included) and writes it as
a Chrome trace into a directory; :class:`StepTimer` keeps wall-clock step
statistics with a warm-up discarded; :func:`trunk_flops` counts the
trunk's operations from a config.
"""

from __future__ import annotations

import contextlib
import os
import re
import time
from dataclasses import dataclass, field

import torch

from ..config import WaveNetConfig


CAPTURE_SPAN = "profiling.trace"
# K4's CUDA kernel in a trace: the cluster core with K1's ring flag false
# (demangled ``gen_cluster_kernel<16, false, ...>`` or mangled
# ``gen_cluster_kernelILi16ELb0...``)
_K4_KERNEL = re.compile(r"gen_cluster_kernel(<\d+, false|ILi\d+ELb0)")


@contextlib.contextmanager
def trace(log_dir: str = "profiles"):
    """Trace the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write it into ``log_dir`` as a
    Chrome trace JSON (open it in Perfetto or ``chrome://tracing``);
    yields the path the trace will have. The trace is written even when
    the block raises. The block is one span named :data:`CAPTURE_SPAN`
    (category ``user_annotation``) on the calling thread: device events
    that straddle its edges (the stop waits for them) can be clipped to
    it. Host ops and spans are recorded on every thread: a server's work
    runs on its handler threads and the pool's worker, not the caller's."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        # On an H100 the first profiler capture of a process recorded only
        # the kernels launched from its own thread, and every later one
        # those of all threads; a server's kernels come from other threads
        # (the pool's worker), so a short capture goes first.
        warm = profile(activities=activities)
        warm.start()
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        warm.stop()
    prof = profile(activities=activities, experimental_config=(
        _ExperimentalConfig(profile_all_threads=True)))
    prof.start()
    try:
        with torch.profiler.record_function(CAPTURE_SPAN):
            yield path
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)


def k4_events(events: list) -> list:
    """The K4 launches among a Chrome trace's ``traceEvents``."""
    return [e for e in events if e.get("cat") == "kernel"
            and _K4_KERNEL.search(e.get("name", ""))]


def capture_window(events: list, span: str = CAPTURE_SPAN):
    """(start, end) in µs of the capture's own span in a trace written by
    :func:`trace` (the block it wrapped)."""
    marks = [e for e in events if e.get("name") == span
             and e.get("cat") == "user_annotation"]
    if len(marks) != 1:
        raise ValueError(f"the trace holds {len(marks)} {span} spans")
    lo = float(marks[0]["ts"])
    return lo, lo + float(marks[0]["dur"])


def clipped_ms(events: list, lo: float, hi: float) -> float:
    """Device ms of ``events`` inside [lo, hi] (µs): a launch that
    straddles an edge counts only its part inside."""
    return sum(max(0.0, min(hi, float(e["ts"]) + float(e.get("dur", 0)))
                   - max(lo, float(e["ts"]))) for e in events) / 1e3


@dataclass
class StepTimer:
    """Wall-clock step statistics with warm-up discard: ``with timer:``
    around each step."""

    warmup: int = 3
    times: list = field(default_factory=list)
    _t0: float | None = None
    _seen: int = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup:
            self.times.append(dt)
        return False

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def best(self) -> float:
        return min(self.times) if self.times else float("nan")

    def summary(self) -> str:
        return (f"{self.mean*1e3:.3f} ms/step (best {self.best*1e3:.3f} ms, "
                f"n={len(self.times)})")


def trunk_flops(cfg: WaveNetConfig, batch: int, length: int | None = None,
                out_len: int | None = None) -> int:
    """Forward FLOPs of the trunk, each product counted as 2*M*K*N: the
    start embedding is a gather (0); per layer k tap products into 2D
    channels and the residual D->R over the full length, the skip D->S
    over ``out_len`` only; the head over ``out_len``."""
    if length is None:
        length = cfg.item_length
    if out_len is None:
        out_len = cfg.output_length
    R, D, S, E, C = (cfg.residual_channels, cfg.dilation_channels,
                     cfg.skip_channels, cfg.end_channels, cfg.classes)
    per_layer = (2 * length * R * (2 * D) * cfg.kernel_size  # gated taps
                 + 2 * length * D * R                         # residual
                 + 2 * out_len * D * S)                       # skip
    head = 2 * out_len * (S * E + E * C)
    return batch * (cfg.num_layers * per_layer + head)
