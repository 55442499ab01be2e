"""One run of one cell: the load, the per-layer readers, the check and
the result line. ``run.py`` wraps this with the look for a card."""

from __future__ import annotations

import importlib
import importlib.util
import math
import sys

import torch

from . import loads, metrics, tracing
from .spec import BENCH_DIR, Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_wavenet_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's, or the JAX
    package's (``pytorch_wavenet_tpu_torch`` is another name)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def _reader(name: str):
    for stem in (name, name.split(".", 1)[0]):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.exists():
            mod = f"wavebench.metrics.{stem}"
            if mod in sys.modules:
                return sys.modules[mod].read
            spec = importlib.util.spec_from_file_location(mod, path)
            module = importlib.util.module_from_spec(spec)
            sys.modules[mod] = module
            spec.loader.exec_module(module)
            return module.read
    raise SystemExit(f"no reader for the per-layer metric {name!r} "
                     f"(metrics/{name}.py)")


def _num(x) -> float:
    return float(x) if math.isfinite(float(x)) else float("inf")


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_process: float, control: bool = False) -> dict:
    """Run the cell; returns the result line's object. With ``control``
    the numbers compared are the control's (the reference in TF32 in the
    program's place, read on the same inputs), judged against the same
    limits, so that ``correct`` must come out false; the program's own
    numbers and the faults' readings go under ``readings``."""
    out_dir = str(BENCH_DIR / ".runs")
    capture = tracing.Capture(trace, out_dir)
    ctx = loads.Context(cell.model_fields(), cell.traffic, int(seed),
                          float(seconds), bool(trace), device, capture,
                          t_process, control)
    kind = cell.traffic["kind"]
    load = importlib.import_module(f"wavebench.loads.{kind}")
    rec = load.run(ctx)
    rec.e2e["setup_s"] = rec.x["setup_end"] - t_process
    rec.x["window_s"] = rec.t_close - rec.t_open

    numbers = rec.compared
    if control:
        numbers = rec.control
        rec.readings.update({f"program_{k}": v
                             for k, v in rec.compared.items()})
    compared = {k: {"value": _num(v), "limit": float(cell.limits[k])}
                for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    if rec.failed:
        correct = False
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": rec.memory_peak_bytes}
    result = {"correct": correct, "attempted": rec.attempted,
              "failed": rec.failed, "metrics": {}, "device": dev}
    if trace:
        lo, hi = capture.to_us(rec.t_open), capture.to_us(rec.t_close)
        r = metrics.Reading(ctx.model, ctx.mix, rec.x, capture.events, lo,
                            hi)
        for m in cell.per_layer:
            v = _reader(m["name"])(r)
            if v is not None:
                result["metrics"][m["name"]] = {"value": float(v),
                                                "unit": m["unit"]}
        dev["busy_s"] = tracing.busy_s(capture.events, lo, hi)
        dev["window_s"] = (hi - lo) / 1e6
        gaps = tracing.idle_gaps(capture.events, lo, hi)
        for name, dur, at in gaps[:5]:
            print(f"idle {dur:.6f} s at +{at:.3f} s: {name}", file=sys.stderr)
        result["breakdown"] = {
            "device_ops": tracing.top_device_ops(capture.events, lo, hi),
            "idle_gaps": [[name, dur] for name, dur, _ in gaps]}
    else:
        result["metrics"] = {m["name"]: {"value": float(rec.e2e[m["name"]]),
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    if control:
        result["readings"] = rec.readings
    # the load's own numbers, for standard error (run.py)
    result["notes"] = {k: v for k, v in rec.x.items()
                       if isinstance(v, (int, float))}
    result["compared"] = compared
    return result
