"""The check sees a broken timed path. Each test drives a whole run at a
tiny size on the CPU (the look for a card skipped), with the program
broken underneath, and sees ``correct`` come out false; the unbroken run
comes out true. The control (the reference in TF32 in the program's place)
runs on the card at the cell's own size (marked ``gpu``)."""

import pytest
import torch

from wavebench.tests.helpers import run_tiny

CELLS = ["chaconne.stream", "chaconne.pool_saturated", "chaconne.pool_open"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run_tiny(cell)
    assert r["correct"], r["compared"]
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("cell", ["chaconne.pool_saturated", "chaconne.stream"])
def test_traced_run_reads_per_layer_metrics(cell):
    from wavebench import spec

    r = run_tiny(cell, trace=True)
    names = {m["name"] for m in spec.load_cell(cell).per_layer}
    assert r["correct"] and set(r["metrics"]) <= names
    assert any(n.startswith("mfu_pct.") for n in r["metrics"])
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", ["chaconne.pool_saturated",
                                  "chaconne.stream"])
def test_control_run_judges_the_control(cell, monkeypatch):
    """A control run compares the control's numbers against the cell's
    limits and keeps the program's own beside them; a control that picks
    other classes comes out not correct."""
    from wavebench.reference import wavenet

    r = run_tiny(cell, control=True)
    assert set(r["compared"]) == {"gap"}
    assert {"program_gap", "fault_gap"} <= set(r["readings"])
    assert r["readings"]["program_gap"] <= r["compared"]["gap"]["limit"]
    assert r["readings"]["fault_gap"] > r["compared"]["gap"]["limit"]
    # every product read as zero: the control's logits are the last bias
    monkeypatch.setattr(wavenet, "tf32_round", torch.zeros_like)
    r = run_tiny(cell, control=True)
    assert r["compared"]["gap"]["value"] > r["compared"]["gap"]["limit"]
    assert r["correct"] is False


def _alter(fn):
    """``fn`` with one class of its output altered where it is produced."""
    def broken(*a, **k):
        out = fn(*a, **k)
        cls = out[0] if isinstance(out, tuple) else out
        cls[..., cls.shape[-1] // 2] = (cls[..., cls.shape[-1] // 2] + 1) % 32
        return out
    return broken


@pytest.mark.parametrize("cell", ["chaconne.pool_saturated",
                                  "chaconne.pool_open"])
def test_pool_token_altered(cell, monkeypatch):
    from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as g

    monkeypatch.setattr(g, "batched_plain", _alter(g.batched_plain))
    assert not run_tiny(cell)["correct"]


def test_stream_token_altered(monkeypatch):
    from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel as g

    monkeypatch.setattr(g, "fused_plain", _alter(g.fused_plain))
    assert not run_tiny("chaconne.stream")["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (an H100)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    """The reference in TF32, put in the program's place at the cell's own
    size, comes out not correct through the run's own comparison."""
    import time

    from wavebench import bench, spec

    c = spec.load_cell(cell)
    r = bench.run_cell(c, 2**31 + 99, 30.0, False, card, time.perf_counter(),
                       control=True)
    assert r["correct"] is False, (r["compared"], r["readings"])
