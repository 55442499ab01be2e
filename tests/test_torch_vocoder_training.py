"""The vocoder's training path in the port (the mel dataset, the trunk with
local conditioning, the conditioned train step with the learnable
upsampler, snapshots and the CLI) against the JAX package's, on the CPU at
the ``tiny_vocoder`` preset.

Tolerances: the trunk's units and gradients (u, dh0, every dW, dW_cond and
dcond, f32 saves) at atol = rtol = 1e-5 against the JAX ``fused_trunk``
run as its own tests run it here (Pallas in interpret mode); losses and
params within 1e-5 after 3 steps (both sides full f32 on the CPU, the sums
in other orders). The mel dataset's x and y exactly, its cond within 1e-5
x max(1, |mel|): the JAX dataset decodes the window audio with its native
library's f32 ``expm1``, the port with numpy in f64, which moves the
waveform by about 2e-7 and a log-mel value by up to about 1e-5 of it (the
log of a quiet band amplifies the waveform's relative error).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.data.mel_dataset import (
    MelWaveNetDataset as JaxMelDataset,
)
from pytorch_wavenet_tpu.ops.pallas import trunk_kernel as jtk
from pytorch_wavenet_tpu.training.optimizers import reference_adam as jax_adam
from pytorch_wavenet_tpu.training.trainer import WaveNetTrainer as JaxTrainer
from pytorch_wavenet_tpu.training.trainer import train_step as jax_step
from pytorch_wavenet_tpu_torch.ops.cuda import trunk_kernel as tk
from pytorch_wavenet_tpu_torch.training import train as train_cli
from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

HOP = 4
UPSAMPLE = (2, 2)


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    rng = np.random.default_rng(0)
    t = np.arange(16000) / 16000.0
    wav = (0.6 * np.sin(2 * np.pi * 110 * t) * np.sin(2 * np.pi * 0.5 * t)
           + 0.05 * rng.standard_normal(t.shape))
    pt.write_wav(os.path.join(str(d), "tone.wav"), wav, 16000)
    return str(d)


def _np_params(cfg_j, seed):
    return jax.tree.map(np.asarray, wt.init_wavenet(jax.random.PRNGKey(seed),
                                                    cfg_j))


def _trainable(params_np):
    p = pt.from_jax_params(params_np, "cpu")
    for _, x in _leaves(p):
        x.requires_grad_(True)
    return p


def test_conditioned_trunk_matches_jax_fused_trunk():
    """The plain trunk with cond, and the autograd wrapper around it,
    against the JAX ``fused_trunk(cond=)`` (interpret mode) with f32 saves:
    u, dh0, every weight gradient, dW_cond and dcond."""
    cfg_j, cfg_t = wt.get_config("tiny_vocoder"), pt.get_config(
        "tiny_vocoder")
    N, out_len = 2, 8
    L, R, D = cfg_t.num_layers, cfg_t.residual_channels, \
        cfg_t.dilation_channels
    T = cfg_t.receptive_field + out_len - 1
    params_np = _np_params(cfg_j, 0)
    rng = np.random.default_rng(1)
    h0 = rng.uniform(-1, 1, (N, T, R)).astype(np.float32)
    cond = rng.standard_normal((N, T, cfg_t.cond_channels)).astype(np.float32)
    du = rng.uniform(-1, 1, (N, out_len, L * D)).astype(np.float32)

    def f(p, h, c):
        return jtk.fused_trunk(p, cfg_j, h, out_len, cond=c,
                               save_dtype=jnp.float32)

    u_j, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, params_np),
                       jnp.asarray(h0), jnp.asarray(cond))
    gp, gh, gc = vjp(jnp.asarray(du))
    ref = {"u": u_j, "h0": gh, "cond": gc,
           **{n: gp["layers"][n] for n in ("w_in", "w_res", "b_in", "b_res",
                                           "w_cond")}}

    p_t = pt.from_jax_params(params_np, "cpu")
    u, saves = tk.trunk_fwd_plain(p_t, cfg_t, torch.from_numpy(h0), out_len,
                                  torch.float32, torch.from_numpy(cond))
    out = tk.trunk_bwd_plain(p_t, cfg_t, saves, torch.from_numpy(du),
                             out_len, torch.from_numpy(cond))
    assert len(out) == 7
    got = dict(zip(("h0", "w_in", "w_res", "b_in", "b_res", "w_cond",
                    "cond"), out), u=u)
    for name, r in ref.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(r),
                                   atol=1e-5, rtol=1e-5, err_msg=name)

    # the same through fused_trunk's autograd Function
    p_t = _trainable(params_np)
    lp = p_t["layers"]
    h0_t = torch.from_numpy(h0).requires_grad_(True)
    c_t = torch.from_numpy(cond).requires_grad_(True)
    u = tk.fused_trunk(p_t, cfg_t, h0_t, out_len, cond=c_t,
                       save_dtype=torch.float32)
    names = ("w_in", "w_res", "b_in", "b_res", "w_cond")
    grads = torch.autograd.grad((u * torch.from_numpy(du)).sum(),
                                [h0_t, c_t] + [lp[n] for n in names])
    for name, g in zip(("h0", "cond") + names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref[name]),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def _frame_batches(cfg, n, batch=3, seed=4):
    """Random classes and mel-like frames at the dataset's frame count."""
    rng = np.random.default_rng(seed)
    frames = 1 + cfg.item_length // HOP
    out = []
    for _ in range(n):
        seq = rng.integers(0, cfg.classes, (batch, cfg.item_length + 1))
        out.append((seq[:, :-1].astype(np.int32),
                    seq[:, -cfg.output_length:].astype(np.int32),
                    rng.standard_normal((batch, frames, cfg.cond_channels))
                    .astype(np.float32)))
    return out


@pytest.mark.parametrize("trunk_kernel", [False, True],
                         ids=["plain", "trunk-kernel"])
def test_three_conditioned_train_steps_match_jax(trunk_kernel):
    """Three train steps on mel frames expanded by the learnable upsampler
    (hop 4, factors 2 x 2), through the plain trunk or the fused one (K2/K3's
    plain versions here, the Pallas kernel in interpret mode there): the
    losses, each step's gradients (within 1e-5 x max(1, scale)) and every
    leaf after, ``cond_up.s*`` and ``w_cond`` included, within 1e-5 of the
    JAX package's.

    One exception, for the params only: Adam's first update is lr * g /
    (|g| + 1e-8), so a gradient within a few eps of zero turns an f32 sum
    order difference of 1e-10 into 1e-2 of the step (3e-5 here, at one
    element of 1536 in w_in with these seeds). Elements whose gradient fell
    below 1e-7 (and was not 0 in both) at some step are held to their
    gradients alone: here a few of w_in and the rows of start.w of classes
    seen only at early positions; none of cond_up or w_cond."""
    kw = dict(cond_upsample=UPSAMPLE, trunk_kernel=trunk_kernel)
    cfg_j = wt.get_config("tiny_vocoder", **kw)
    cfg_t = pt.get_config("tiny_vocoder", **kw)
    params_np = _np_params(cfg_j, 2)
    assert sorted(params_np["cond_up"]) == ["s0", "s1"]
    tx_j, tx_t = jax_adam(3e-3), pt.reference_adam(3e-3)
    pj = jax.tree.map(jnp.asarray, params_np)
    sj = tx_j.init(pj)
    p_t = _trainable(params_np)
    s_t = tx_t.init(p_t)
    near_eps = {}
    for x, y, frames in _frame_batches(cfg_j, 3):
        pj, sj, lj, gj = jax_step(pj, sj, cfg_j, tx_j, jnp.asarray(x),
                                  jnp.asarray(y), jnp.asarray(frames), HOP)
        lt, gt = pt.train_step(p_t, s_t, cfg_t, tx_t, torch.from_numpy(x),
                               torch.from_numpy(y), torch.from_numpy(frames),
                               HOP)
        assert abs(float(lt) - float(lj)) <= 1e-5
        for (path, a), (_, b) in zip(_leaves(jax.tree.map(np.asarray, gj)),
                                     _leaves(gt)):
            err = float(np.abs(a - b.numpy()).max())
            assert err <= 1e-5 * max(1.0, float(np.abs(a).max())), path
            # (a gradient that is 0 in both moves neither param)
            near = (np.abs(a) < 1e-7) & ((a != 0) | (b.numpy() != 0))
            near_eps[path] = near_eps.get(path, False) | near
    ref, got = list(_leaves(jax.tree.map(np.asarray, pj))), list(_leaves(p_t))
    assert [p for p, _ in ref] == [p for p, _ in got]
    assert ("cond_up", "s1") in [p for p, _ in got]
    assert ("layers", "w_cond") in [p for p, _ in got]
    for (path, a), (_, b) in zip(ref, got):
        mask = near_eps[path]
        if path[0] == "cond_up" or path[1] == "w_cond":
            assert not mask.any(), path
        diff = np.where(mask, 0.0, np.abs(b.detach().numpy() - a))
        assert float(diff.max()) <= 1e-5, (path, float(diff.max()))
        assert not np.array_equal(a, params_np[path[0]][path[1]]), path


def test_mel_dataset_matches_jax(audio_dir, tmp_path):
    cfg = pt.get_config("vocoder")
    kw = dict(item_length=cfg.item_length, target_length=cfg.output_length,
              classes=cfg.classes, test_stride=5)
    npz = str(tmp_path / "d.npz")
    ds_t = pt.MelWaveNetDataset(npz, file_location=audio_dir, **kw)
    ds_j = JaxMelDataset(npz, **kw)
    assert len(ds_t) == len(ds_j) >= 8 and ds_t.device_upsample
    idxs = np.arange(len(ds_t))[::max(1, len(ds_t) // 6)]
    (xt, yt, ct), (xj, yj, cj) = ds_t.get_batch(idxs), ds_j.get_batch(idxs)
    assert ct.shape == (len(idxs), 1 + cfg.item_length // 256, 80)
    assert ct.dtype == np.float32
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_allclose(ct, cj, atol=1e-5, rtol=1e-5)
    for a, b in zip(ds_t[3], ds_j[3]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    ds_t.device_upsample = ds_j.device_upsample = False
    (_, _, rt), (_, _, rj) = ds_t.get_batch(idxs[:2]), ds_j.get_batch(
        idxs[:2])
    assert rt.shape == (2, cfg.item_length, 80)
    np.testing.assert_allclose(rt, rj, atol=1e-5, rtol=1e-5)


def _recorder(base):
    class Losses(base):
        def __init__(self):
            super().__init__(10**9, 10**9, 10**9)
            self.losses = []

        def log(self, step, loss):
            self.losses.append(float(loss))

    return Losses()


def _mel_data(cfg, npz, audio_dir):
    return pt.MelWaveNetDataset(
        npz, item_length=cfg.item_length, target_length=cfg.output_length,
        file_location=audio_dir, classes=cfg.classes, test_stride=20,
        num_mels=cfg.cond_channels, n_fft=16, hop_length=HOP)


def _same_state(params_a, opt_a, params_b, opt_b):
    """Params and optimizer state (optax's state-dict layout) bitwise
    equal."""
    for (pa, x), (pb, y) in zip(_leaves(params_a), _leaves(params_b)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert sorted(opt_a) == sorted(opt_b)
    for (pa, x), (pb, y) in zip(_leaves(opt_a), _leaves(opt_b)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_conditioned_snapshots_resume_across_packages(audio_dir, tmp_path):
    """A conditioned run (the learnable upsampler, the fused trunk) is
    snapshotted at step 2 by one package and resumed by the other, both
    ways: the resumed params and Adam state equal the writer's bitwise, and
    steps 3-4 give the losses of the port's uninterrupted run within 1e-5.
    The port resumed from its own snapshot equals the uninterrupted run
    bitwise (losses and params)."""
    from flax import serialization

    kw = dict(cond_upsample=UPSAMPLE, trunk_kernel=True)
    cfg_t = pt.get_config("tiny_vocoder", **kw)
    cfg_j = wt.get_config("tiny_vocoder", cond_upsample=UPSAMPLE)
    # one dataset object for both trainers, so both see the same cond
    # bytes (the packages' decoders differ by an ulp: the test above)
    ds = _mel_data(cfg_t, str(tmp_path / "d.npz"), audio_dir)
    params_np = _np_params(cfg_j, 5)
    train_kw = dict(batch_size=4, epochs=10)
    opt = dict(lr=3e-3, seed=3)

    def port(snap=None, interval=10**9):
        return pt.WaveNetTrainer(
            cfg_t, pt.from_jax_params(params_np, "cpu"), ds,
            logger=_recorder(pt.Logger), snapshot_path=snap,
            snapshot_name="v", snapshot_interval=interval, device="cpu",
            **opt)

    def jax_trainer(snap, interval=10**9):
        return JaxTrainer(cfg_j, jax.tree.map(jnp.asarray, params_np), ds,
                          logger=_recorder(wt.Logger), snapshot_path=snap,
                          snapshot_name="v", snapshot_interval=interval,
                          **opt)

    def jax_state(tr):
        return (jax.tree.map(np.asarray, tr.params),
                serialization.to_state_dict(jax.tree.map(np.asarray,
                                                         tr.opt_state)))

    def port_state(tr):
        return (pt.to_numpy_params(tr.params), tr.tx.state_dict(tr.opt_state))

    full = port()
    full.train(max_steps=4, **train_kw)
    tail = full.logger.losses[2:]
    # the port's snapshot, resumed by the port and by the JAX package
    snap_t = str(tmp_path / "t")
    writer = port(snap_t, 2)
    writer.train(max_steps=2, **train_kw)
    again = port(snap_t)
    assert again.resume() == 2
    again.train(continue_training_at_step=2, max_steps=4, **train_kw)
    assert again.logger.losses == tail
    for (_, a), (_, b) in zip(_leaves(full.params), _leaves(again.params)):
        assert torch.equal(a, b)
    j = jax_trainer(snap_t)
    assert j.resume() == 2
    _same_state(*port_state(writer), *jax_state(j))
    j.train(continue_training_at_step=2, max_steps=4, **train_kw)
    np.testing.assert_allclose(j.logger.losses, tail, atol=1e-5, rtol=0)
    # the JAX package's snapshot, resumed by the port
    snap_j = str(tmp_path / "j")
    jw = jax_trainer(snap_j, 2)
    jw.train(max_steps=2, **train_kw)
    np.testing.assert_allclose(jw.logger.losses, full.logger.losses[:2],
                               atol=1e-5, rtol=0)
    back = port(snap_j)
    assert back.resume() == 2
    _same_state(*jax_state(jw), *port_state(back))
    back.train(continue_training_at_step=2, max_steps=4, **train_kw)
    np.testing.assert_allclose(back.logger.losses, tail, atol=1e-5, rtol=0)
    assert ("cond_up", "s0") in [p for p, _ in _leaves(back.params)]
    loss, acc = back.validate(batch_size=8)
    assert np.isfinite(loss) and 0.0 <= acc <= 1.0


def test_conditioned_training_cli_on_cpu(audio_dir, tmp_path):
    """``python -m pytorch_wavenet_tpu_torch.training.train --config
    tiny_vocoder --cond-upsample 2,2 --hop-length 4``: the mel dataset, 3
    steps through the fused trunk with a snapshot, then a resumed step on
    the plain trunk; factors that do not multiply to the hop raise."""
    data = str(tmp_path / "audio")
    shutil.copytree(audio_dir, data)
    snaps = str(tmp_path / "snaps")
    base = ["--data-dir", data, "--config", "tiny_vocoder", "--cond-upsample",
            "2,2", "--hop-length", "4", "--n-fft", "16", "--batch-size", "4",
            "--device", "cpu", "--snapshot-path", snaps, "--test-stride", "20",
            "--log-interval", "1", "--validation-interval", "3"]
    tr = train_cli.main(base + ["--max-steps", "3", "--snapshot-interval",
                                "3"])
    assert isinstance(tr.dataset, pt.MelWaveNetDataset)
    assert tr.step == 3 and tr.cfg.trunk_kernel
    assert tr.cfg.cond_upsample == (2, 2) and tr._cond_hop == 4
    blob = pt.load_checkpoint(pt.latest_checkpoint(snaps), device="cpu")
    assert blob["step"] == 3 and blob["config"] == tr.cfg
    assert sorted(blob["params"]["cond_up"]) == ["s0", "s1"]
    assert int(blob["opt_state"]["0"]["count"]) == 3
    again = train_cli.main(base + ["--max-steps", "4", "--resume",
                                   "--no-trunk-kernel"])
    assert again.step == 4 and not again.cfg.trunk_kernel
    bad = [a if a != "2,2" else "2,3" for a in base]
    with pytest.raises(ValueError, match="multiply"):
        train_cli.main(bad + ["--max-steps", "1", "--snapshot-path",
                              str(tmp_path / "bad")])
