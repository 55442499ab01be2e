"""The port's single-card tools on the CPU (``--device cpu``: the kernels'
wrappers run their plain versions), at ``tiny`` / ``tiny_vocoder`` /
``--smoke`` sizes, against the JAX package's scripts.

Bitwise: ``make_demo_data.synthesize`` and the wav files it writes,
``distill_demo.make_melody`` and ``mel_l2`` (numpy copies of the JAX
scripts' functions, run on the same seeds). The CLIs run in-process:
``benchmark``'s non-kernel lines, ``distill_demo`` in both modes with the
JAX metrics' keys and a student snapshot the JAX package's
``load_checkpoint`` reads (its leaves equal bitwise). The port's
``bench`` without a card exits nonzero and prints no metric. The serving
tools are in ``tests/test_torch_serving_tools.py``."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.utils import checkpoints as jck
from pytorch_wavenet_tpu_torch.models import iaf
from pytorch_wavenet_tpu_torch.scripts import (
    benchmark,
    distill_demo,
    make_demo_data,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX distill_demo's metrics (scripts/distill_demo.py:360-374)
JAX_DEMO_KEYS = {
    "mode", "teacher_steps", "teacher_final_loss", "distill_steps",
    "kl_start", "kl_end", "data_rms", "student_rms", "rms_ratio",
    "logmel_l2_student", "logmel_l2_init", "logmel_l2_teacher", "wall_s",
}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_make_demo_data_equals_jax(tmp_path, monkeypatch):
    jmd = _jax_script("make_demo_data")
    for seed in (0, 3):
        a = make_demo_data.synthesize(0.05, seed)
        b = jmd.synthesize(0.05, seed)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    argv = ["--minutes", "0.05", "--seed", "2", "--files", "3"]
    ours = make_demo_data.main(["--out", str(tmp_path / "t"), *argv])
    monkeypatch.setattr(sys, "argv", ["make_demo_data.py", "--out",
                                      str(tmp_path / "j"), *argv])
    jmd.main()
    assert [os.path.basename(p) for p in ours] == [
        f"demo_{i}.wav" for i in range(3)]
    for p in ours:
        assert _bytes(p) == _bytes(str(tmp_path / "j" / os.path.basename(p)))


def test_make_melody_and_mel_l2_equal_jax():
    jdd = _jax_script("distill_demo")
    for seconds, sr, seed in ((2.0, 16000, 0), (0.7, 8000, 5)):
        np.testing.assert_array_equal(
            distill_demo.make_melody(seconds, sr, seed),
            jdd.make_melody(seconds, sr, seed))
    rng = np.random.default_rng(1)
    a, b = rng.normal(size=(3, 17, 8)), rng.normal(size=(3, 15, 8))
    assert distill_demo.mel_l2(a, b) == jdd.mel_l2(a, b)
    assert distill_demo.mel_l2(a[0], a[0]) == 0.0


def test_benchmark_cli_prints_its_non_kernel_lines():
    lines = benchmark.main(["--config", "tiny", "--batch-size", "2",
                            "--gen-samples", "64", "--device", "cpu"])
    prefixes = ["device=cpu", "train step (B=2): ", "gen plain 1-stream: ",
                "gen plain 64-stream: ", "gen plain 256-stream: ",
                "student: 4 flows x 10 layers", "gen student 1-stream: ",
                "gen student 16-stream: ", "host window gather: "]
    assert len(lines) == len(prefixes)
    for line, prefix in zip(lines, prefixes):
        assert line.startswith(prefix), (line, prefix)
    assert not any("fused" in line for line in lines)  # no kernel on a CPU


def test_benchmark_sweep_rows():
    """The JAX sweep's rows without stage_layers/head_tiles, duplicates
    merged; --max-streams cuts the rows above it."""
    rows = benchmark.sweep_rows(pt.get_config("chaconne"))
    assert len(rows) == len(set(rows)) == 17
    assert rows[-1] == (16384, torch.bfloat16, False, False)
    assert benchmark.sweep_rows(pt.get_config("tiny")) == benchmark.SWEEP
    assert max(r[0] for r in benchmark.sweep_rows(
        pt.get_config("chaconne"), 1024)) == 1024


SMOKE = ["--smoke", "--teacher-steps", "4", "--distill-steps", "4",
         "--device", "cpu"]


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """Each mode's ``--smoke`` run with ``--out-dir``: (metrics, dir)."""
    out = {}
    for mode in ("uncond", "vocoder"):
        d = str(tmp_path_factory.mktemp(f"demo_{mode}"))
        out[mode] = distill_demo.main(["--mode", mode, *SMOKE, "--json",
                                       "--out-dir", d]), d
    return out


@pytest.mark.parametrize("mode", ["uncond", "vocoder"])
def test_distill_demo_smoke(mode, demo):
    metrics, out = demo[mode]
    assert set(metrics) == JAX_DEMO_KEYS and metrics["mode"] == mode
    assert all(np.isfinite(v) for k, v in metrics.items() if k != "mode")
    with open(os.path.join(out, f"metrics_{mode}.json")) as f:
        assert json.load(f) == metrics
    assert os.path.exists(os.path.join(out, f"student_{mode}.wav"))
    # the student snapshot in the JAX package's format
    path = os.path.join(out, f"demo_student_{mode}_0000000004.ckpt")
    blob = jck.load_checkpoint(path)
    ours, scfg, step = iaf.load_student_snapshot(path, device="cpu")
    assert step == 4 and blob["step"] == 4
    assert blob["extra"]["iaf_config"]["cond_channels"] == scfg.cond_channels
    assert scfg.flows == 2 and scfg.cond_channels == (16 if mode == "vocoder"
                                                      else 0)
    want = dict(jax.tree_util.tree_flatten_with_path(
        pt.to_numpy_params(iaf.student_state_dict(ours)))[0])
    got = dict(jax.tree_util.tree_flatten_with_path(blob["params"])[0])
    assert got.keys() == want.keys() and len(got) > 10
    for key, leaf in got.items():
        np.testing.assert_array_equal(np.asarray(leaf), want[key])
    teacher = jck.load_checkpoint(os.path.join(
        out, f"demo_teacher_{mode}_0000000004.ckpt"))
    assert teacher["config"].cond_channels == scfg.cond_channels


def test_distill_demo_reuses_a_saved_teacher(demo):
    metrics, out = demo["uncond"]
    path = os.path.join(out, "demo_teacher_uncond_0000000004.ckpt")
    again = distill_demo.main(["--mode", "uncond", *SMOKE,
                               "--teacher-ckpt", path])
    assert again["teacher_steps"] == 0
    # the same teacher and the same data windows: the same distillation
    assert again["kl_start"] == metrics["kl_start"]
    with pytest.raises(SystemExit, match="teacher-ckpt config"):
        distill_demo.main(["--mode", "vocoder", *SMOKE,
                           "--teacher-ckpt", path])


def test_bench_without_a_card_prints_no_metric():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "pytorch_wavenet_tpu_torch.bench",
         "--num-samples", "64"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert r.returncode != 0
    assert "metric" not in r.stdout and r.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in r.stderr
