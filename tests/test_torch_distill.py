"""Probability density distillation in the port against the JAX package:
the mu-law bin edges and bin probabilities, ``power_spectrum``,
``distill_loss`` and its gradients against ``jax.value_and_grad`` (plain
and ``trunk_kernel`` teachers: K2's plain version here, the Pallas kernel
in interpret mode there; ``teacher_smooth``, power, rms, ``rms_per_item``;
a ``tiny_vocoder`` teacher with cond), three ``distill_step``s against
JAX's with ``optax.chain(clip_by_global_norm(1.0), adam(lr))``, and the
distillation CLI on a JAX-written teacher.

Tolerances: f32 at atol = rtol = 1e-5; gradients within 1e-5 x max(1,
scale) of the leaf's; after three Adam steps, the rule of
``tests/test_torch_vocoder_training.py`` (an element whose gradient fell
within 1e-7 of zero at some step is held to its gradients alone: Adam's
first update is lr * g / (|g| + 1e-8))."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.models import iaf as ji
from pytorch_wavenet_tpu.training import distill as jd
from pytorch_wavenet_tpu.training.optimizers import (
    reference_adam as jax_reference_adam)
from pytorch_wavenet_tpu.utils import checkpoints as jck
from pytorch_wavenet_tpu_torch.models import iaf as ti
from pytorch_wavenet_tpu_torch.training import distill as td
from pytorch_wavenet_tpu_torch.training import distill_cli
from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(flows=2, layers=3, residual_channels=8, dilation_channels=8,
             skip_channels=8, end_channels=8)


def _np_tree(tree_fn, seed, scale=0.3):
    shapes = jax.eval_shape(tree_fn)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.uniform(-scale, scale, s.shape).astype(np.float32),
        shapes)


def _teacher(name, seed, **kw):
    cfgj, cfgt = wt.get_config(name, **kw), pt.get_config(name, **kw)
    npp = _np_tree(lambda: wt.init_wavenet(jax.random.PRNGKey(0), cfgj), seed)
    return cfgj, jax.tree.map(jnp.asarray, npp), cfgt, pt.from_jax_params(
        npp, "cpu")


def _student(seed, **kw):
    sj, st = ji.IAFConfig(**SMALL, **kw), ti.IAFConfig(**SMALL, **kw)
    npp = _np_tree(lambda: ji.init_student(jax.random.PRNGKey(0), sj), seed,
                   0.2)
    return sj, jax.tree.map(jnp.asarray, npp), st, pt.from_jax_params(
        npp, "cpu")


def _uniforms(key, shape):
    return np.array(jax.random.uniform(key, shape, jnp.float32, 1e-5,
                                       1.0 - 1e-5))


def _sd_leaves(tree):
    return list(_leaves(serialization.to_state_dict(tree)))


def test_bin_edges_and_probabilities_match_jax():
    for classes in (32, 256):
        np.testing.assert_array_equal(td.mu_law_bin_edges(classes),
                                      jd.mu_law_bin_edges(classes))
    rng = np.random.default_rng(0)
    m = rng.uniform(-0.8, 0.8, (3, 17)).astype(np.float32)
    log_s = rng.uniform(-6.0, 0.5, (3, 17)).astype(np.float32)
    qj = jd.student_bin_logprobs(jnp.asarray(m), jnp.asarray(log_s), 256)
    qt = td.student_bin_logprobs(torch.from_numpy(m),
                                 torch.from_numpy(log_s), 256)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), **TOL)
    np.testing.assert_allclose(qt.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(qt.min()) >= 0.0
    # no 0 * inf in the gradient with respect to log_s, far in the tails
    ls = torch.full((4,), 6.9, requires_grad=True)
    q = td.student_bin_logprobs(torch.tensor([-5.0, 5.0, 0.0, 1.0]), ls, 32)
    (g,) = torch.autograd.grad(q[:, 0].sum() + q[:, -1].sum(), ls)
    assert torch.isfinite(g).all()


def test_power_spectrum_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 900)).astype(np.float32)
    np.testing.assert_allclose(
        td.power_spectrum(torch.from_numpy(x)).numpy(),
        np.asarray(jd.power_spectrum(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        td.power_spectrum(torch.from_numpy(x), frame=64, hop=16).numpy(),
        np.asarray(jd.power_spectrum(jnp.asarray(x), frame=64, hop=16)),
        **TOL)


def _assert_grads(gj, paths, grads):
    """JAX's gradient tree against the port's gradients of the leaves at
    ``paths`` (the student's state-dict leaves, in order)."""
    ref = _sd_leaves(gj)
    assert [p for p, _ in ref] == paths
    for (path, a), b in zip(ref, grads):
        a = np.asarray(a)
        err = float(np.abs(a - b.numpy()).max())
        assert err <= 1e-5 * max(1.0, float(np.abs(a).max())), (path, err)


CASES = {
    "plain": dict(teacher=("tiny", {}), student={}, kw={}),
    "trunk-kernel": dict(teacher=("tiny", {"trunk_kernel": True}),
                         student={}, kw={"teacher_smooth": 1e-3}),
    "power-rms": dict(teacher=("tiny", {}), student={},
                      kw={"teacher_smooth": 1e-3, "power_weight": 0.1,
                          "rms_weight": 1.0}),
    "vocoder-per-item": dict(
        teacher=("tiny_vocoder", {}), student={"cond_channels": 8},
        kw={"teacher_smooth": 1e-3, "power_weight": 0.05, "rms_weight": 1.0,
            "rms_per_item": True}, cond=True),
    "vocoder-trunk-kernel": dict(
        teacher=("tiny_vocoder", {"trunk_kernel": True}),
        student={"cond_channels": 8}, kw={"rms_weight": 1.0}, cond=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_distill_loss_and_gradients_match_jax(case):
    spec = CASES[case]
    cfgj, tpj, cfgt, tpt = _teacher(spec["teacher"][0], 1,
                                    **spec["teacher"][1])
    sj, spj, st, spt = _student(2, **spec["student"])
    B, T = 2, cfgj.receptive_field + 300
    key = jax.random.PRNGKey(3)
    rng = np.random.default_rng(4)
    ref = (0.3 * rng.standard_normal((B, T - 1))).astype(np.float32)
    cond = (0.5 * rng.standard_normal((B, T, 8))).astype(np.float32)
    extra_j = {k: v for k, v in spec["kw"].items()}
    extra_t = dict(extra_j)
    if spec.get("cond"):
        extra_j["cond"], extra_t["cond"] = (jnp.asarray(cond),
                                            torch.from_numpy(cond))
    extra_j["audio_ref"], extra_t["audio_ref"] = (jnp.asarray(ref),
                                                  torch.from_numpy(ref))
    (lj, auxj), gj = jax.value_and_grad(jd.distill_loss, has_aux=True)(
        spj, tpj, sj, cfgj, key, B, T, **extra_j)
    named = list(_leaves(ti.student_state_dict(spt)))
    leaves = [p.requires_grad_(True) for _, p in named]
    lt, auxt = td.distill_loss(spt, tpt, st, cfgt,
                               torch.from_numpy(_uniforms(key, (B, T))), B,
                               T, **extra_t)
    assert set(auxt) == set(auxj)
    for k in auxj:
        np.testing.assert_allclose(float(auxt[k].detach()), float(auxj[k]),
                                   **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(lt.detach()), float(lj), **TOL)
    grads = torch.autograd.grad(lt, leaves)
    _assert_grads(gj, [p for p, _ in named], grads)


def test_teacher_gets_no_gradient_and_refusals():
    cfgj, tpj, cfgt, tpt = _teacher("tiny", 5)
    sj, spj, st, spt = _student(6)
    tpt = {k: {n: v.clone().requires_grad_(True) for n, v in sub.items()}
           for k, sub in tpt.items()}
    leaves = [p.requires_grad_(True)
              for _, p in _leaves(ti.student_state_dict(spt))]
    T = cfgt.receptive_field + 40
    loss, _ = td.distill_loss(spt, tpt, st, cfgt, torch.Generator(), 2, T)
    loss.backward()
    assert all(v.grad is None for sub in tpt.values() for v in sub.values())
    assert all(p.grad is not None for p in leaves)
    with pytest.raises(ValueError, match="must exceed teacher rf"):
        td.distill_loss(spt, tpt, st, cfgt, torch.Generator(), 2,
                        cfgt.receptive_field)


def test_three_distill_steps_match_jax():
    """Three updates with the CLI's optimizer: ``reference_adam(lr,
    gradient_clipping=1.0)`` against ``optax.chain(clip_by_global_norm(1.0),
    adam(lr))``, fresh uniforms each step (JAX's ``fold_in(key, i)``)."""
    cfgj, tpj, cfgt, tpt = _teacher("tiny", 7)
    sj, spj, st, spt = _student(8)
    B, T = 2, cfgj.receptive_field + 300  # the power loss's frames fit
    rng = np.random.default_rng(9)
    ref = (0.3 * rng.standard_normal((B, T - 1))).astype(np.float32)
    kw = dict(power_weight=0.1, rms_weight=1.0, teacher_smooth=1e-3)
    lr = 1e-3
    tx_j = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))
    opt_j = tx_j.init(spj)
    tx_t = pt.reference_adam(lr, gradient_clipping=1.0)
    opt_t = tx_t.init(ti.student_state_dict(spt))
    key = jax.random.PRNGKey(10)
    start = [x.clone() for _, x in _leaves(ti.student_state_dict(spt))]
    near = None
    for i in range(3):
        k = jax.random.fold_in(key, i)
        (lj, _), gj = jax.value_and_grad(jd.distill_loss, has_aux=True)(
            spj, tpj, sj, cfgj, k, B, T, audio_ref=jnp.asarray(ref), **kw)
        spj, opt_j, lj2, _ = jd.distill_step(
            spj, opt_j, tpj, sj, cfgj, tx_j, k, B, T,
            audio_ref=jnp.asarray(ref), **kw)
        spt, opt_t, lt, aux = td.distill_step(
            spt, opt_t, tpt, st, cfgt, tx_t,
            torch.from_numpy(_uniforms(k, (B, T))), B, T,
            audio_ref=torch.from_numpy(ref), **kw)
        np.testing.assert_allclose(float(lt), float(lj2), **TOL)
        g = [np.asarray(a) for _, a in _sd_leaves(gj)]
        now = [np.abs(a) < 1e-7 for a in g]
        near = now if near is None else [a | b for a, b in zip(near, now)]
    assert int(opt_t["count"]) == 3
    ref_leaves = _sd_leaves(spj)
    got = list(_leaves(ti.student_state_dict(spt)))
    assert [p for p, _ in ref_leaves] == [p for p, _ in got]
    for (path, a), (_, b), mask, s in zip(ref_leaves, got, near, start):
        b = b.detach()
        diff = np.where(mask, 0.0, np.abs(b.numpy() - np.asarray(a)))
        assert float(diff.max()) <= 1e-5, (path, float(diff.max()))
        assert not torch.equal(b, s), path  # every leaf moved
    # the optimizer's state has the layout of the JAX package's
    # reference_adam(lr, gradient_clipping=1.0) (the same arithmetic as the
    # JAX script's nested chain), its moments leaf for leaf
    sd = tx_t.state_dict(opt_t)
    want = serialization.to_state_dict(
        jax_reference_adam(lr, gradient_clipping=1.0).init(spj))
    assert set(sd) == set(want) and set(sd["1"]) == set(want["1"])
    assert set(sd["1"]["mu"]["flows"]) == {"0", "1"}
    for (pa, a), (pb, b) in zip(_sd_leaves(opt_j[1][0].mu),
                                _leaves(sd["1"]["mu"])):
        assert pa == pb and np.abs(np.asarray(a) - b).max() <= 1e-5


# ------------------------------------------------------------------- CLI


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    """A JAX-written tiny teacher (with an EMA-less optimizer state), a
    tiny_vocoder one, and an audio directory."""
    d = tmp_path_factory.mktemp("distill")
    cfg = wt.get_config("tiny")
    params = jax.tree.map(np.asarray, wt.init_wavenet(jax.random.PRNGKey(1),
                                                      cfg))
    teacher = jck.save_checkpoint(str(d / "teacher"), "tiny", 3, params,
                                  cfg=cfg)
    vcfg = wt.get_config("tiny_vocoder")
    vparams = jax.tree.map(np.asarray, wt.init_wavenet(
        jax.random.PRNGKey(2), vcfg))
    vteacher = jck.save_checkpoint(str(d / "vteacher"), "voc", 1, vparams,
                                   cfg=vcfg)
    audio = d / "audio"
    audio.mkdir()
    t = np.arange(8000) / 16000.0
    wav = 0.5 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 2 * t)
    pt.write_wav(str(audio / "tone.wav"), wav, 16000)
    return d, teacher, vteacher, str(audio)


def _cli(teacher, out, *extra):
    return distill_cli.main([
        "--teacher-snapshot", teacher, "--flows", "2", "--layers", "3",
        "--width", "8", "--batch-size", "2", "--length", "64",
        "--out-dir", str(out), "--log-interval", "1", "--lr", "1e-3",
        "--device", "cpu", *extra])


def _same_params(a, b):
    la = list(_leaves(ti.student_state_dict(a)))
    lb = list(_leaves(ti.student_state_dict(b)))
    return [p for p, _ in la] == [p for p, _ in lb] and all(
        torch.equal(x.detach(), y.detach()) for (_, x), (_, y) in zip(la, lb))


def test_cli_trains_and_resumes_bitwise(cli_dirs, tmp_path):
    """4 steps with snapshots every 2 (the rms loss on reference batches by
    default); a run resumed from the step-2 snapshot ends at the
    uninterrupted run's step-4 params bitwise; the snapshots load in the
    JAX package."""
    _, teacher, _, audio = cli_dirs
    a = _cli(teacher, tmp_path / "a", "--steps", "4", "--save-interval",
             "2", "--data-dir", audio)
    assert a["step"] == 4 and a["path"].endswith("student_0000000004.ckpt")
    snap2 = os.path.join(tmp_path / "a", "student_0000000002.ckpt")
    b = _cli(teacher, tmp_path / "b", "--steps", "2", "--data-dir", audio,
             "--student-snapshot", snap2)
    assert b["step"] == 4 and _same_params(a["params"], b["params"])
    params, scfg, step = ji.load_student_snapshot(a["path"])
    assert step == 4 and scfg.flows == 2 and scfg.residual_channels == 8
    blob = pt.load_checkpoint(a["path"], "cpu")
    assert blob["extra"]["iaf_config"]["compute_dtype"] is None
    assert int(blob["opt_state"]["1"]["count"]) == 4


def test_cli_generate_and_teacher_kernel_flag(cli_dirs, tmp_path, capsys):
    _, teacher, _, _ = cli_dirs
    a = _cli(teacher, tmp_path / "a", "--steps", "1", "--init-scale", "0.2")
    assert "teacher trunk K2" in capsys.readouterr().out
    wav_out = str(tmp_path / "s.wav")
    g = _cli(teacher, tmp_path / "g", "--steps", "0", "--student-snapshot",
             a["path"], "--generate", "100", "--streams", "2", "--wav-out",
             wav_out, "--no-trunk-kernel")
    assert "teacher trunk plain" in capsys.readouterr().out
    want = ti.student_generate(a["params"], g["scfg"],
                               torch.Generator().manual_seed(0), 100,
                               num_streams=2, device="cpu").numpy()
    np.testing.assert_array_equal(g["wav"], want)
    got, _ = pt.load_audio(wav_out, sampling_rate=16000)
    assert got.shape == (100,)


def test_cli_conditioned_teacher(cli_dirs, tmp_path):
    """A tiny_vocoder teacher: both models see the mel rows of real windows;
    --generate is copy-synthesis of one window's rows."""
    _, _, vteacher, audio = cli_dirs
    out = _cli(vteacher, tmp_path / "v", "--steps", "2", "--data-dir",
               audio, "--n-fft", "32", "--hop-length", "8", "--generate",
               "50")
    assert out["scfg"].cond_channels == 8 and out["wav"].shape == (1, 50)
    assert np.isfinite(out["wav"]).all()


def test_cli_refusals(cli_dirs, tmp_path):
    _, teacher, vteacher, audio = cli_dirs
    with pytest.raises(SystemExit, match="pass --data-dir"):
        _cli(vteacher, tmp_path, "--steps", "1")
    with pytest.raises(SystemExit, match="must exceed teacher rf"):
        distill_cli.main(["--teacher-snapshot", teacher, "--length", "15",
                          "--device", "cpu"])
    with pytest.raises(SystemExit, match="need --data-dir"):
        _cli(teacher, tmp_path, "--steps", "1", "--power-weight", "0.1")
    with pytest.raises(SystemExit, match="no EMA"):
        _cli(teacher, tmp_path, "--steps", "1", "--teacher-ema")
    s = _cli(teacher, tmp_path / "s", "--steps", "1")
    with pytest.raises(SystemExit, match="cond_channels"):
        _cli(vteacher, tmp_path, "--steps", "1", "--data-dir", audio,
             "--student-snapshot", s["path"])
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no teacher checkpoint"):
        _cli(str(tmp_path / "empty"), tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            distill_cli.main(["--teacher-snapshot", teacher])


def test_cli_reads_the_teacher_ema(cli_dirs, tmp_path):
    """--teacher-ema distills against the EMA tree a snapshot trained with
    --ema-decay carries (a port-written one here)."""
    d, teacher, _, _ = cli_dirs
    blob = pt.load_checkpoint(teacher, "cpu")
    tx = pt.with_ema(pt.reference_adam(1e-3), 0.9)
    state = tx.init(blob["params"])
    path = pt.save_checkpoint(str(tmp_path / "ema"), "tiny", 5,
                              blob["params"], cfg=blob["config"],
                              opt_state=tx.state_dict(state))
    out = _cli(path, tmp_path / "o", "--steps", "1", "--teacher-ema")
    assert out["step"] == 1
