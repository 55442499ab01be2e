"""The cell ``wnv512.pool_saturated`` (the lane pool in frames mode on the
WaveNet vocoder): a sound run at a tiny size is ``correct`` on the CPU, a
run whose timed path alters a class is not, a traced run reads the cell's
per-layer metrics, and (marked ``gpu``) the control at the cell's own size
is not ``correct``. The counts of ``roofline_wnv`` are the configuration's."""

import json
import time

import pytest
import torch

from wavebench import bench, roofline_wnv, spec
from wavebench.spec import ROOT

CELL = "wnv512.pool_saturated"
TINY = dict(layers=3, blocks=2, dilation_channels=8, residual_channels=8,
            skip_channels=16, end_channels=16, classes=32, kernel_size=2,
            bias=True, cond_channels=4, cond_upsample=[4],
            cond_upsampler="phase", input_kernel=2)


def tiny_cell() -> spec.Cell:
    cell = spec.load_cell(CELL)
    cell.config = dict(cell.config, model=dict(TINY))
    cell.traffic = dict(cell.traffic, lanes=4, chunk=16, clients=8,
                        length_min=20, length_max=60, deck=64, ramp_s=0.3,
                        check_requests=4, cond_hop=4, signal=4096,
                        max_requests=4096)
    return cell


def run_tiny(seed=2**31 + 7, trace=False, control=False):
    return bench.run_cell(tiny_cell(), seed, 1.0, trace, torch.device("cpu"),
                          time.perf_counter(), control=control)


def test_sound_run_is_correct():
    r = run_tiny()
    assert r["correct"], r["compared"]
    assert r["metrics"]["samples_per_s"]["value"] > 0
    assert list(r)[-1] == "compared"


def test_traced_run_reads_per_layer_metrics():
    r = run_tiny(trace=True)
    names = {m["name"] for m in spec.load_cell(CELL).per_layer}
    assert r["correct"] and set(r["metrics"]) <= names
    # no wide-chain kernel on the CPU: its roofline reads nothing
    assert "wnv_roofline.saturated" not in r["metrics"]
    assert {"wnv_mfu_pct.saturated",
            "lane_use_pct.wnv_saturated"} <= set(r["metrics"])


def test_token_altered_is_not_correct(monkeypatch):
    from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as g

    real = g.batched_plain

    def broken(*a, **k):
        out = real(*a, **k)
        cls = out[0] if isinstance(out, tuple) else out
        cls[..., cls.shape[-1] // 2] = (cls[..., cls.shape[-1] // 2] + 1) % 32
        return out

    monkeypatch.setattr(g, "batched_plain", broken)
    assert not run_tiny()["correct"]


def test_control_run_judges_the_control():
    r = run_tiny(control=True)
    assert set(r["compared"]) == {"gap"}
    assert r["readings"]["program_gap"] <= r["compared"]["gap"]["limit"]
    assert r["readings"]["fault_gap"] > r["compared"]["gap"]["limit"]


def test_roofline_counts_are_the_configurations():
    m = json.loads((ROOT / "wavebench/configs/wnv512.json").read_text())[
        "model"]
    assert roofline_wnv.param_count(m) == 44_562_001
    assert roofline_wnv.step_flops(m) == 88_489_984
    least, bound = roofline_wnv.bound_s(m, 256, 1)
    assert bound == "bytes" and 62e-6 < least < 63e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (an H100)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_control_is_not_correct(card):
    """The reference in TF32, put in the program's place at the cell's own
    size, comes out not correct through the run's own comparison."""
    r = bench.run_cell(spec.load_cell(CELL), 2**31 + 99, 30.0, False, card,
                       time.perf_counter(), control=True)
    assert r["correct"] is False, (r["compared"], r["readings"])
