"""The traced run: a ``torch.profiler`` capture of the window, and the
readings taken from it.

Frozen here from the port's ``utils/profiling.py`` (``trace``,
``capture_window``, ``clipped_ms`` and K4's kernel-name pattern): the
capture's first session in a process records only its own thread's
kernels, so a short one runs first (in set-up); a device event that
straddles an edge of the window counts only its part inside. The window
is placed in the trace's clock by two marks recorded at known host times.
"""

from __future__ import annotations

import json
import os
import re
import time

import torch

# kernels by name, as the profiler writes them (demangled or mangled)
KERNELS = {
    "K1": re.compile(r"gen_cluster_kernel(<\d+, true|ILi\d+ELb1)"),
    "K4": re.compile(r"gen_cluster_kernel(<\d+, false|ILi\d+ELb0)"),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
MARK = "wavebench.mark"


def span(name: str):
    """A host span around a call into the program (shows in the trace)."""
    return torch.profiler.record_function(name)


class Capture:
    """A profiler session over the window; ``None``-safe when tracing is
    off (every method is then a no-op)."""

    def __init__(self, enabled: bool, out_dir: str):
        self.enabled = enabled
        self.out_dir = out_dir
        self.prof = None
        self.marks: list = []    # host perf_counter seconds of the marks
        self.events: list = []
        self.offset_us = 0.0     # trace clock minus host clock

    def _activities(self):
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return acts

    def warm(self):
        """A short first session (set-up): later sessions then see every
        thread's kernels."""
        if not self.enabled:
            return
        from torch.profiler import profile

        p = profile(activities=self._activities())
        p.start()
        if torch.cuda.is_available():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        p.stop()

    def _mark(self):
        with torch.profiler.record_function(MARK):
            self.marks.append(time.perf_counter())

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import profile

        self.prof = profile(activities=self._activities())
        self.prof.start()
        self._mark()

    def stop(self):
        if not self.enabled or self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._mark()
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            self.events = [e for e in json.load(f).get("traceEvents", [])
                           if e.get("ph") == "X"]
        os.remove(path)
        self.prof = None
        marks = sorted((float(e["ts"]) + 0.5 * float(e.get("dur", 0)))
                       for e in self.events if e.get("name") == MARK)
        if len(marks) != len(self.marks):
            raise RuntimeError(f"the trace holds {len(marks)} marks, the "
                               f"run made {len(self.marks)}")
        self.offset_us = sum(m - 1e6 * t for m, t in
                             zip(marks, self.marks)) / len(marks)

    def to_us(self, t: float) -> float:
        """A host perf_counter time in the trace's clock (µs)."""
        return 1e6 * t + self.offset_us


def device_events(events: list) -> list:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def clipped_s(events: list, lo: float, hi: float) -> float:
    """Device seconds of ``events`` inside [lo, hi] (µs)."""
    return sum(max(0.0, min(hi, float(e["ts"]) + float(e.get("dur", 0)))
                   - max(lo, float(e["ts"]))) for e in events) / 1e6


def kernel_events(events: list, kernel: str) -> list:
    pat = KERNELS[kernel]
    return [e for e in events if e.get("cat") == "kernel"
            and pat.search(e.get("name", ""))]


def busy_intervals(events: list, lo: float, hi: float) -> list:
    """The union of device events' intervals inside [lo, hi], sorted."""
    iv = sorted((max(lo, float(e["ts"])),
                 min(hi, float(e["ts"]) + float(e.get("dur", 0))))
                for e in device_events(events))
    out: list = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(events: list, lo: float, hi: float) -> float:
    return sum(b - a for a, b in busy_intervals(events, lo, hi)) / 1e6


def top_device_ops(events: list, lo: float, hi: float, n: int = 10) -> list:
    tot: dict = {}
    for e in device_events(events):
        t = clipped_s([e], lo, hi)
        if t > 0:
            tot[e.get("name", "?")] = tot.get(e.get("name", "?"), 0.0) + t
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events: list, lo: float, hi: float, n: int = 10) -> list:
    """The longest gaps with no device event in [lo, hi], each named by
    the innermost host event that spans its middle: ``(name, seconds,
    start in seconds after lo)``."""
    busy = busy_intervals(events, lo, hi)
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [e for e in events if e.get("cat") in HOST_CATS
            and e.get("name") != MARK]
    out = []
    for a, b in gaps[:n]:
        mid = 0.5 * (a + b)
        over = [e for e in host if float(e["ts"]) <= mid
                <= float(e["ts"]) + float(e.get("dur", 0))]
        name = (min(over, key=lambda e: float(e.get("dur", 0)))["name"]
                if over else "host outside any traced call")
        out.append((name, (b - a) / 1e6, (a - lo) / 1e6))
    return out
