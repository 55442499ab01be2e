"""The port's training path (data layer, loss, reference Adam, train step,
trainer, checkpoints with optimizer state, the CLI) against the JAX
package's on the CPU, at the ``tiny`` preset.

Tolerances: losses and params within 1e-5 after 3 steps (both sides full
f32 on the CPU; the sums run in other orders), Adam moments within 1e-5
of scale in optax's state-dict layout, step counts equal; dataset windows
and batch order exactly equal.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.data.audio_io import load_audio as jax_load_audio
from pytorch_wavenet_tpu.ops.mulaw import quantize_data as jax_quantize
from pytorch_wavenet_tpu.training.optimizers import reference_adam as jax_adam
from pytorch_wavenet_tpu.training.trainer import (
    cross_entropy_loss as jax_loss,
)
from pytorch_wavenet_tpu.training.trainer import train_step as jax_step
from pytorch_wavenet_tpu_torch.training import train as train_cli
from pytorch_wavenet_tpu_torch.training.optimizers import _leaves


def _write_tone(directory, seconds=1.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    wav = (0.6 * np.sin(2 * np.pi * 110 * t) * np.sin(2 * np.pi * 0.5 * t)
           + 0.05 * rng.standard_normal(t.shape))
    os.makedirs(directory, exist_ok=True)
    pt.write_wav(os.path.join(directory, "tone.wav"), wav, 16000)


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    _write_tone(str(d))
    return str(d)


def _np_params(cfg_j, seed):
    return jax.tree.map(np.asarray, wt.init_wavenet(jax.random.PRNGKey(seed),
                                                    cfg_j))


def _batches(cfg, n, batch=3, seed=4):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.classes, (n, batch, cfg.item_length + 1))
    return [(s[:, :-1].astype(np.int32),
             s[:, -cfg.output_length:].astype(np.int32)) for s in seq]


def test_cross_entropy_matches_jax():
    cfg_j, cfg_t = wt.get_config("tiny"), pt.get_config("tiny")
    params = _np_params(cfg_j, 1)
    (x, y), = _batches(cfg_j, 1)
    ref = float(jax_loss(jax.tree.map(jnp.asarray, params), cfg_j,
                         jnp.asarray(x), jnp.asarray(y)))
    got = float(pt.cross_entropy_loss(pt.from_jax_params(params, "cpu"),
                                      cfg_t, torch.from_numpy(x),
                                      torch.from_numpy(y)))
    assert abs(got - ref) <= 1e-5 * max(1.0, abs(ref))


@pytest.mark.parametrize("trunk_kernel,weight_decay,clip", [
    (False, 0.0, None), (True, 0.0, None), (True, 0.01, 0.3),
    (False, 0.01, 0.3)], ids=["plain", "trunk-kernel", "trunk-kernel-decay-clip",
                              "plain-decay-clip"])
def test_three_train_steps_match_jax(trunk_kernel, weight_decay, clip):
    cfg_j = wt.get_config("tiny", trunk_kernel=trunk_kernel)
    cfg_t = pt.get_config("tiny", trunk_kernel=trunk_kernel)
    params_np = _np_params(cfg_j, 2)
    tx_j = jax_adam(3e-3, weight_decay, clip)
    pj = jax.tree.map(jnp.asarray, params_np)
    sj = tx_j.init(pj)
    tx_t = pt.reference_adam(3e-3, weight_decay, clip)
    p_t = {k: {n: v.requires_grad_(True) for n, v in sub.items()}
           for k, sub in pt.from_jax_params(params_np, "cpu").items()}
    s_t = tx_t.init(p_t)
    for x, y in _batches(cfg_j, 3):
        pj, sj, lj, _ = jax_step(pj, sj, cfg_j, tx_j, jnp.asarray(x),
                                 jnp.asarray(y))
        lt, _ = pt.train_step(p_t, s_t, cfg_t, tx_t, torch.from_numpy(x),
                              torch.from_numpy(y))
        assert abs(float(lt) - float(lj)) <= 1e-5
    for (path, a), (_, b) in zip(_leaves(jax.tree.map(np.asarray, pj)),
                                 _leaves(p_t)):
        np.testing.assert_allclose(b.detach().numpy(), a, atol=1e-5, rtol=0,
                                   err_msg=str(path))
    from flax import serialization

    ref = serialization.to_state_dict(jax.tree.map(np.asarray, sj))
    got = tx_t.state_dict(s_t)
    assert sorted(ref) == sorted(got)
    for key in ref:
        assert sorted(ref[key]) == sorted(got[key])
        if ref[key]:
            assert int(got[key]["count"]) == int(ref[key]["count"]) == 3
            for m in ("mu", "nu"):
                for (path, a), (_, b) in zip(_leaves(ref[key][m]),
                                             _leaves(got[key][m])):
                    scale = max(float(np.abs(a).max()), 1e-30)
                    assert float(np.abs(a - b).max()) <= 1e-5 * max(
                        scale, 1e-3), (m, path)


def test_dataset_matches_jax(audio_dir, tmp_path):
    """The port's featurization equals the JAX package's numpy
    quantize_data (the JAX dataset uses its native quantizer where built,
    which may differ by one class, rarely: tests/test_native.py); over the
    same npz both give the same length, windows and batch order."""
    cfg = pt.get_config("tiny")
    kw = dict(item_length=cfg.item_length, target_length=cfg.output_length,
              classes=cfg.classes, test_stride=20)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    for d in (jdir, tdir):
        shutil.copytree(audio_dir, d)
    ds_j = wt.WaveNetDataset(os.path.join(jdir, "dataset.npz"),
                             file_location=jdir, **kw)
    ds_t = pt.WaveNetDataset(os.path.join(tdir, "dataset.npz"),
                             file_location=tdir, **kw)
    wav, _ = jax_load_audio(os.path.join(audio_dir, "tone.wav"))
    np.testing.assert_array_equal(ds_t.data["arr_0"],
                                  jax_quantize(wav, cfg.classes).astype(
                                      np.uint8))
    assert len(ds_t) == len(ds_j) > 100
    same = pt.WaveNetDataset(os.path.join(jdir, "dataset.npz"), **kw)
    for i in (0, 1, 18, 19, len(same) - 1):
        for a, b in zip(same[i], ds_j[i]):
            np.testing.assert_array_equal(a, b)
    for seed, skip in ((0, 0), (7, 2)):
        it_j = wt.BatchIterator(ds_j, 8, seed=seed, skip_batches=skip)
        it_t = pt.PrefetchBatchIterator(same, 8, seed=seed,
                                        skip_batches=skip, num_workers=2)
        assert len(it_j) == len(it_t)
        for (xj, yj), (xt, yt) in zip(it_j, it_t):
            np.testing.assert_array_equal(xt, xj)
            np.testing.assert_array_equal(yt, yj)
    same.train = ds_j.train = False
    assert len(same) == len(ds_j) and len(same) > 0
    np.testing.assert_array_equal(same[len(same) - 1][0],
                                  ds_j[len(ds_j) - 1][0])


def _adam_blob_equal(a, b):
    for (pa, x), (pb, y) in zip(_leaves(a), _leaves(b)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("weight_decay,clip", [(0.0, None), (0.01, 0.5)])
def test_checkpoints_with_optimizer_state_cross_packages(tmp_path,
                                                         weight_decay, clip):
    """A port checkpoint loads in the JAX package with opt_state_template,
    and a JAX one hands its optimizer state back to the port's optimizer."""
    cfg_j, cfg_t = wt.get_config("tiny"), pt.get_config("tiny")
    params_np = _np_params(cfg_j, 3)
    tx_t = pt.reference_adam(1e-3, weight_decay, clip)
    p_t = {k: {n: v.requires_grad_(True) for n, v in sub.items()}
           for k, sub in pt.from_jax_params(params_np, "cpu").items()}
    s_t = tx_t.init(p_t)
    (x, y), = _batches(cfg_j, 1)
    pt.train_step(p_t, s_t, cfg_t, tx_t, torch.from_numpy(x),
                  torch.from_numpy(y))
    path = pt.save_checkpoint(str(tmp_path / "t"), "m", 1, p_t, cfg=cfg_t,
                              opt_state=tx_t.state_dict(s_t))
    tx_j = jax_adam(1e-3, weight_decay, clip)
    template = tx_j.init(jax.tree.map(jnp.asarray, params_np))
    blob = wt.load_checkpoint(path, opt_state_template=template)
    assert type(blob["opt_state"]) is type(template)
    from flax import serialization

    _adam_blob_equal(serialization.to_state_dict(blob["opt_state"]),
                     tx_t.state_dict(s_t))
    # and back: the JAX state, stepped once more there, into the port
    pj, sj, _, _ = jax_step(jax.tree.map(jnp.asarray, blob["params"]),
                            blob["opt_state"], cfg_j, tx_j, jnp.asarray(x),
                            jnp.asarray(y))
    jpath = wt.save_checkpoint(str(tmp_path / "j"), "m", 2, pj, opt_state=sj,
                               cfg=cfg_j)
    back = pt.load_checkpoint(jpath, device="cpu")
    s_back = tx_t.load_state_dict(back["opt_state"], back["params"])
    assert s_back["count"] == 2
    _adam_blob_equal(tx_t.state_dict(s_back),
                     serialization.to_state_dict(jax.tree.map(np.asarray, sj)))
    with pytest.raises(ValueError, match="chain"):
        pt.reference_adam(1e-3, 0.1 if weight_decay == 0 else 0.0,
                          clip).load_state_dict(back["opt_state"],
                                                back["params"])


class _Losses(pt.Logger):
    def __init__(self):
        super().__init__(log_interval=10**9, validation_interval=10**9,
                         generate_interval=10**9)
        self.losses = []

    def log(self, step, loss):
        self.losses.append(float(loss))


def test_resume_equals_uninterrupted_run(audio_dir, tmp_path):
    """Steps 5-8 after a snapshot/resume at step 4 see the same batches and
    params as an uninterrupted run (tests/test_training.py:227-281): the
    losses and the final params are equal bitwise on the CPU."""
    cfg = pt.get_config("tiny", trunk_kernel=True)
    ds = pt.WaveNetDataset(str(tmp_path / "d.npz"),
                           item_length=cfg.item_length,
                           target_length=cfg.output_length,
                           file_location=audio_dir, classes=cfg.classes,
                           test_stride=20)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(lr=1e-3, seed=3, device="cpu", gradient_clipping=0.5)
    rec_a = _Losses()
    a = pt.WaveNetTrainer(cfg, params, ds, logger=rec_a, **kw)
    a.train(batch_size=4, epochs=10, max_steps=8)
    snap = str(tmp_path / "snaps")
    rec_b = _Losses()
    b = pt.WaveNetTrainer(cfg, params, ds, logger=rec_b, snapshot_path=snap,
                          snapshot_name="r", snapshot_interval=4, **kw)
    b.train(batch_size=4, epochs=10, max_steps=4)
    rec_c = _Losses()
    c = pt.WaveNetTrainer(cfg, params, ds, logger=rec_c, snapshot_path=snap,
                          **kw)
    assert c.resume() == 4
    c.train(batch_size=4, epochs=10, continue_training_at_step=4, max_steps=8)
    assert rec_a.losses[:4] == rec_b.losses and rec_a.losses[4:] == rec_c.losses
    for (_, p), (_, q) in zip(_leaves(a.params), _leaves(c.params)):
        assert torch.equal(p, q)
    loss, acc = c.validate(batch_size=8)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0


def test_resume_fast_forwards_across_epochs(audio_dir, tmp_path):
    cfg = pt.get_config("tiny")
    ds = pt.WaveNetDataset(str(tmp_path / "d.npz"),
                           item_length=cfg.item_length,
                           target_length=cfg.output_length,
                           file_location=audio_dir, classes=cfg.classes)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(1), "cpu")
    bs = 128
    spe = len(pt.BatchIterator(ds, bs))
    assert spe >= 2
    rec_a, rec_b = _Losses(), _Losses()
    a = pt.WaveNetTrainer(cfg, params, ds, logger=rec_a, seed=5, device="cpu",
                          num_workers=0)
    a.train(batch_size=bs, epochs=10, max_steps=spe + 3)
    b = pt.WaveNetTrainer(cfg, params, ds, logger=rec_b, seed=5, device="cpu")
    b.train(batch_size=bs, epochs=10, max_steps=spe + 1)
    b.train(batch_size=bs, epochs=10, continue_training_at_step=spe + 1,
            max_steps=spe + 3)
    assert rec_a.losses == rec_b.losses


def test_training_cli_on_cpu(audio_dir, tmp_path):
    """``python -m pytorch_wavenet_tpu_torch.training.train``'s main: 3
    steps of tiny with a snapshot, then a resumed step."""
    data = str(tmp_path / "audio")
    shutil.copytree(audio_dir, data)
    snaps = str(tmp_path / "snaps")
    base = ["--data-dir", data, "--config", "tiny", "--batch-size", "4",
            "--device", "cpu", "--snapshot-path", snaps, "--test-stride", "20",
            "--log-interval", "1", "--validation-interval", "3"]
    tr = train_cli.main(base + ["--max-steps", "3", "--snapshot-interval",
                                "3", "--clip", "1.0"])
    assert tr.step == 3 and tr.cfg.trunk_kernel
    blob = pt.load_checkpoint(pt.latest_checkpoint(snaps), device="cpu")
    assert blob["step"] == 3 and blob["config"] == dataclasses.replace(
        pt.get_config("tiny"), trunk_kernel=True)
    assert int(blob["opt_state"]["1"]["count"]) == 3
    again = train_cli.main(base + ["--max-steps", "4", "--resume", "--clip",
                                   "1.0", "--no-trunk-kernel"])
    assert again.step == 4 and not again.cfg.trunk_kernel
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main(["--data-dir", data, "--config", "tiny"])
