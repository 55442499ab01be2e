"""The port's serving tools on the CPU (``--device cpu``: the batcher runs
K4's plain version) at ``tiny`` / ``tiny_vocoder``: ``serving_bench`` in
process with the JAX summary's keys (plain, ``--device-profile``,
``--cond`` with mel frames, ``--snapshot``), ``serving_soak`` for 3 s with
live reloads and with every greedy request checked bitwise against its
solo rollout, each with the pool's lifecycle invariants."""

import json

import pytest
import torch

import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch.scripts import serving_bench, serving_soak

# the JAX serving_bench's --json keys on a run with TTFA marks, without
# --device-profile (scripts/serving_bench.py:279-297,345-350,356-360)
JAX_BENCH_KEYS = {
    "config", "cond", "lanes", "chunk", "concurrency", "requests",
    "completed", "failed", "num_samples", "wall_s", "agg_samples_per_s",
    "realtime_x", "ttfa_p50_ms", "ttfa_p95_ms", "latency_p50_s",
    "latency_p95_s", "pool_steps", "prime_calls", "t_dispatch", "t_deliver",
    "t_admit", "t_idle", "t_prime_dispatch", "t_prime_sync", "t_splice",
    "ttfa_wait_p95_ms", "ttfa_first_sync_p95_ms", "bytes_down", "bytes_up",
    "wire_bytes_per_sample",
}
# the port's pool also reports K4's seconds on the card's clock (0.0 on the
# CPU) among its t_* phases
DEVICE_KEYS = {"t_prime_device", "t_chunk_device"}


@pytest.mark.parametrize("case", ["plain", "profile", "cond", "snapshot"])
def test_serving_bench_cli(case, tmp_path, capsys):
    argv = ["--config", "tiny", "--lanes", "3", "--chunk", "32",
            "--concurrency", "2", "--requests", "4", "--num-samples", "64",
            "--json", "--device", "cpu"]
    if case == "profile":
        argv += ["--device-profile"]
    elif case == "cond":
        argv = ["--config", "tiny_vocoder", *argv[2:], "--cond",
                "--cond-hop", "4", "--ring-dtype", "f32"]
    elif case == "snapshot":
        cfg = pt.get_config("tiny")
        params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
        path = pt.save_checkpoint(str(tmp_path), "tiny", 1, params, cfg=cfg)
        argv = ["--snapshot", path, *argv[2:]]
    summary = serving_bench.main(argv)
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == summary
    assert set(summary) == JAX_BENCH_KEYS | DEVICE_KEYS
    assert summary["completed"] == summary["requests"] == 4
    assert summary["failed"] == 0 and summary["agg_samples_per_s"] > 0
    assert 0 < summary["ttfa_p50_ms"] <= summary["ttfa_p95_ms"]
    assert summary["latency_p50_s"] <= summary["latency_p95_s"]
    assert summary["bytes_down"] > 0 and summary["wire_bytes_per_sample"] > 0
    assert summary["cond"] is (case == "cond")
    assert "TTFA decomposition (4 requests with marks)" in out
    if case == "profile":  # the trace holds no K4 launch on the CPU
        assert "holds no K4 launch" in out


def test_serving_bench_refuses_cond_without_channels():
    with pytest.raises(SystemExit, match="conditioned config"):
        serving_bench.main(["--config", "tiny", "--cond", "--device", "cpu",
                            "--lanes", "2", "--requests", "1"])


@pytest.mark.parametrize("case", ["reload", "check"])
def test_serving_soak_cli(case):
    argv = ["--config", "tiny", "--lanes", "3", "--chunk", "32",
            "--seconds", "3", "--max-samples", "96", "--workers", "3",
            "--json", "--device", "cpu"]
    argv += (["--reload-every", "0.5"] if case == "reload"
             else ["--check-rate", "1"])
    r = serving_soak.main(argv)
    assert r["hung"] == r["mismatched"] == r["worker_errors"] == 0
    assert r["failed"] == r["pool_failed"] == 0
    assert r["pool_outstanding"] == 0 and r["pool_free"] == 3
    assert 0 <= r["pool_admitted"] - r["pool_completed"] - r["pool_failed"] \
        <= r["pool_cancelled"]
    assert r["completed"] > 0 and r["rss_growth_mb"] >= 0
    if case == "reload":
        assert r["reloads"] >= 1 and r["reloads_installed"] >= 1
        assert r["checked"] == 0  # spot checks are off under reloads
    else:
        assert r["checked"] >= 1  # each bitwise against its solo rollout
