"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU:
the trunk's operation count for every preset (equal integers), the step
timer, and a trace written as a Chrome trace JSON with the capture's
window marked."""

import json
import os

import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.utils import profiling as jprof
from pytorch_wavenet_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("name", sorted(wt.PRESETS))
def test_counts_match_jax(name):
    cj, ct = wt.get_config(name), pt.get_config(name)
    for args in ((1,), (4,), (3, 100, 20)):
        assert tprof.trunk_flops(ct, *args) == jprof.trunk_flops(cj, *args)


def test_step_timer_discards_the_warmup(monkeypatch):
    clock = iter([0.0, 1.0, 1.0, 3.0, 3.0, 3.5, 3.5, 4.0])
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: next(clock))
    t = tprof.StepTimer(warmup=1)
    assert t.mean != t.mean and t.best != t.best  # nan before any step
    for _ in range(4):
        with t:
            pass
    assert t.times == [2.0, 0.5, 0.5]
    assert t.mean == pytest.approx(1.0) and t.best == 0.5
    assert t.summary() == "1000.000 ms/step (best 500.000 ms, n=3)"
    jt = jprof.StepTimer(warmup=1)
    assert jt.warmup == t.warmup


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    with tprof.trace(d) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.dirname(path) == d and os.path.isfile(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_marks_the_capture_window(tmp_path):
    with tprof.trace(str(tmp_path)) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    span = [e for e in events if e.get("name") == tprof.CAPTURE_SPAN]
    assert len(span) == 1 and span[0]["cat"] == "user_annotation"
    lo, hi = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                      for e in mm)


def test_trace_is_written_when_the_block_raises(tmp_path):
    d = str(tmp_path / "prof")
    with pytest.raises(RuntimeError, match="boom"):
        with tprof.trace(d) as path:
            raise RuntimeError("boom")
    assert os.path.isfile(path)


def test_k4_events_clipped_to_the_capture_window():
    """K4's launches picked by kernel name (K1's cluster core and other
    kernels left out), the capture's span found, and device time clipped
    to it: a launch across an edge counts its part inside."""
    span = {"name": tprof.CAPTURE_SPAN, "cat": "user_annotation",
            "ts": 100.0, "dur": 1000.0}
    k4 = [{"cat": "kernel", "name": name, "ts": ts, "dur": dur}
          for name, ts, dur in (
              ("void gen_cluster_kernel<16, false, float>(Args)", 50, 100),
              ("_Z18gen_cluster_kernelILi8ELb0EfEv", 500, 200),
              ("void gen_cluster_kernel<8, false, bf16>(Args)", 1000, 300))]
    other = [{"cat": "kernel", "name": "gen_cluster_kernel<16, true>",
              "ts": 200, "dur": 50},
             {"cat": "kernel", "name": "_Z18gen_cluster_kernelILi16ELb1Ev",
              "ts": 300, "dur": 50},
             {"cat": "cpu_op", "name": "gen_cluster_kernel<8, false>",
              "ts": 300, "dur": 50}]
    events = [span, *other, *k4]
    assert tprof.k4_events(events) == k4
    assert tprof.capture_window(events) == (100.0, 1100.0)
    assert tprof.clipped_ms(k4, 100.0, 1100.0) == (50 + 200 + 100) / 1e3
    with pytest.raises(ValueError, match="2"):
        tprof.capture_window([span, span])
