"""The port's generate CLI on the CPU (``--device cpu``: the kernels'
wrappers run their plain versions), at ``tiny`` and ``tiny_vocoder``.

Every wav the CLI writes is byte-equal to the wav of the library call it
prints it took: K1's wrapper up to 8 streams, K4's beyond, ``synthesize``
on K1 in the mel modes, a converted reference snapshot, a snapshot's EMA
weights, a dataset prime, and speculation with ``--force-speculate``.
"""

import os

import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch import generate_cli
from pytorch_wavenet_tpu_torch.models.speculative import speculative_generate
from test_convert import _random_state_dict, _save_reference_like_module


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _ref_wavs(tmp_path, wav, tag):
    """The wavs ``write_wav`` makes of the library call's waveforms."""
    out = []
    for i, w in enumerate(np.asarray(wav)):
        p = str(tmp_path / f"ref_{tag}_{i}.wav")
        pt.write_wav(p, w, 16000)
        out.append(_bytes(p))
    return out


def _run(tmp_path, argv, tag, streams=1):
    out = str(tmp_path / f"{tag}.wav")
    generate_cli.main(argv + ["--out", out, "--device", "cpu"])
    if streams == 1:
        return [_bytes(out)]
    return [_bytes(str(tmp_path / f"{tag}_{i}.wav")) for i in range(streams)]


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(1), "cpu")
    ema = pt.init_wavenet(cfg, torch.Generator().manual_seed(2), "cpu")
    d = tmp_path_factory.mktemp("snap")
    path = pt.save_checkpoint(
        str(d), "tiny", 7, params, cfg=cfg,
        opt_state={"inner": {"count": np.zeros((), np.int32)},
                   "ema": pt.to_numpy_params(ema)})
    return cfg, params, ema, path


def _mid(cfg, streams):
    return np.full((streams, 1), cfg.classes // 2, np.int64)


@pytest.mark.parametrize("streams", [1, 2, 9])
def test_snapshot(snap, tmp_path, capsys, streams):
    cfg, params, _, path = snap
    got = _run(tmp_path, ["--snapshot", path, "--num-samples", "40",
                          "--num-streams", str(streams), "--temperature",
                          "0.9", "--seed", "3"], "s", streams)
    printed = capsys.readouterr().out
    if streams <= 8:
        assert "generation path: K1 generate_fast_fused(fuse_res=True)" \
            in printed
        wav, _ = pt.generate_fast_fused(params, cfg, 3, 40, _mid(cfg, streams),
                                        temperature=0.9, fuse_res=True,
                                        device="cpu")
    else:
        assert ("generation path: K4 generate_fast_batched(fuse_res=True, "
                "skip_slab=False)") in printed
        wav, _ = pt.generate_fast_batched(params, cfg, 3, 40,
                                          _mid(cfg, streams), temperature=0.9,
                                          fuse_res=True, device="cpu")
    assert "kernel launches: 0" in printed  # plain versions on the CPU
    assert got == _ref_wavs(tmp_path, wav, "s")


def test_exact_chain_and_bf16_rings(snap, tmp_path, capsys):
    cfg, params, _, path = snap
    got = _run(tmp_path, ["--snapshot", path, "--num-samples", "30",
                          "--num-streams", "9", "--exact-chain",
                          "--bf16-rings", "--temperature", "0"], "x", 9)
    assert "ring_dtype=torch.bfloat16" in capsys.readouterr().out
    wav, _ = pt.generate_fast_batched(params, cfg, 0, 30, _mid(cfg, 9),
                                      temperature=0.0, fuse_res=False,
                                      ring_dtype=torch.bfloat16, device="cpu")
    assert got == _ref_wavs(tmp_path, wav, "x")


def test_ema(snap, tmp_path):
    cfg, _, ema, path = snap
    got = _run(tmp_path, ["--snapshot", path, "--num-samples", "40",
                          "--ema", "--seed", "4"], "e")
    wav, _ = pt.generate_fast_fused(ema, cfg, 4, 40, _mid(cfg, 1),
                                    temperature=1.0, fuse_res=True,
                                    device="cpu")
    assert got == _ref_wavs(tmp_path, wav, "e")
    bare = pt.save_checkpoint(str(tmp_path / "bare"), "m", 1, ema, cfg=cfg)
    with pytest.raises(SystemExit, match="no EMA"):
        generate_cli.main(["--snapshot", bare, "--ema", "--device", "cpu"])


def test_snapshot_path_and_data_dir(snap, tmp_path):
    cfg, params, _, path = snap
    data = tmp_path / "audio"
    data.mkdir()
    t = np.arange(4000) / 16000.0
    pt.write_wav(str(data / "sine.wav"), 0.5 * np.sin(2 * np.pi * 220 * t),
                 16000)
    got = _run(tmp_path, ["--snapshot-path", os.path.dirname(path),
                          "--data-dir", str(data), "--prime-index", "3",
                          "--num-samples", "30", "--temperature", "0"], "d")
    ds = pt.WaveNetDataset(str(data / "dataset.npz"), cfg.item_length,
                           cfg.output_length, classes=cfg.classes,
                           test_stride=20)
    x, _ = ds[3]
    prime = np.asarray(x[-cfg.receptive_field:], np.int64)[None]
    wav, _ = pt.generate_fast_fused(params, cfg, 0, 30, prime,
                                    temperature=0.0, fuse_res=True,
                                    device="cpu")
    assert got == _ref_wavs(tmp_path, wav, "d")


def test_torch_snapshot(tmp_path):
    cfg = pt.WaveNetConfig(layers=3, blocks=2, dilation_channels=8,
                           residual_channels=8, skip_channels=16,
                           end_channels=16, classes=32, bias=True)
    path = str(tmp_path / "ref.pt")
    _save_reference_like_module(cfg, _random_state_dict(cfg, seed=5), path)
    got = _run(tmp_path, ["--torch-snapshot", path, "--num-samples", "40",
                          "--seed", "2"], "t")
    params, rcfg = pt.load_reference_snapshot(path, device="cpu")
    wav, _ = pt.generate_fast_fused(params, rcfg, 2, 40, _mid(rcfg, 1),
                                    temperature=1.0, fuse_res=True,
                                    device="cpu")
    assert got == _ref_wavs(tmp_path, wav, "t")


def test_mel_file(tmp_path, capsys):
    cfg = pt.get_config("tiny_vocoder")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(3), "cpu")
    path = pt.save_checkpoint(str(tmp_path / "voc"), "v", 1, params, cfg=cfg)
    mel = np.random.default_rng(4).normal(
        0, 1, (6, cfg.cond_channels)).astype(np.float32)
    np.save(tmp_path / "mel.npy", mel)
    got = _run(tmp_path, ["--snapshot", path, "--mel-file",
                          str(tmp_path / "mel.npy"), "--hop-length", "4",
                          "--temperature", "0.8", "--seed", "5"], "m")
    assert "K1 generate_fast_fused" in capsys.readouterr().out
    wav, _ = pt.synthesize(params, cfg, 5, mel, 4, _mid(cfg, 1),
                           temperature=0.8, backend=pt.generate_fast_fused,
                           fuse_res=True, device="cpu")
    assert wav.shape == (1, 6 * 4)
    assert got == _ref_wavs(tmp_path, wav, "m")
    with pytest.raises(SystemExit, match="conditioned model"):
        generate_cli.main(["--snapshot", pt.save_checkpoint(
            str(tmp_path / "u"), "u", 1, pt.init_wavenet(
                pt.get_config("tiny"), torch.Generator(), "cpu"),
            cfg=pt.get_config("tiny")), "--mel-file",
            str(tmp_path / "mel.npy"), "--device", "cpu"])


def test_draft_snapshot_with_force_speculate(snap, tmp_path):
    cfg, params, _, path = snap
    got = _run(tmp_path, ["--snapshot", path, "--draft-snapshot", path,
                          "--force-speculate", "--speculate-k", "4",
                          "--num-samples", "30"], "sp")
    wav, _, rate = speculative_generate(params, cfg, params, cfg, None, 30,
                                        _mid(cfg, 1), k=4, device="cpu")
    assert float(rate) == 4.0
    assert got == _ref_wavs(tmp_path, wav, "sp")
    with pytest.raises(SystemExit, match="single-stream"):
        generate_cli.main(["--snapshot", path, "--draft-snapshot", path,
                           "--num-streams", "2", "--device", "cpu"])
