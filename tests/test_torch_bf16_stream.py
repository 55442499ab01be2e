"""The training trunk with a bf16 stream (``cfg.stream_dtype=bfloat16``,
the training CLI's ``--bf16``): the port's plain versions of K2/K3 against
the JAX package's ``fused_trunk`` run as its own tests run it here (Pallas
in interpret mode), the fused logits and a train step's gradients against
JAX's, saves of either dtype, the kernels' plans and the CLI.

Tolerances: atol = rtol = 1e-5, and gradients within 1e-5 x max(1, scale)
(the rule of tests/test_torch_trunk_kernel.py). Both sides round the same
f32 sums to bf16 at the same places (h0, each layer's stream update, the
bf16 matrices and cond); their sums run in other orders, which at these
sizes lands no stream value on the other side of a bf16 rounding boundary
(measured: units 1.2e-7, weight gradients 2e-6 at scales near 7). A wider
config can flip a stream value by one bf16 ulp, which moves the later
layers by about 2^-8 of that value, so these tests stay at ``tiny``.
Saves of a bf16 stream: f32 and bf16 saves hold the same values, so their
gradients are compared bitwise.
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
from pytorch_wavenet_tpu.models.wavenet import embed_inputs as jax_embed
from pytorch_wavenet_tpu.models.wavenet import wavenet_logits as jax_logits
from pytorch_wavenet_tpu.ops.pallas import trunk_kernel as jtk
from pytorch_wavenet_tpu_torch.ops.cuda import trunk_kernel as tk
from pytorch_wavenet_tpu_torch.training import train as train_cli

BF16_J = dict(stream_dtype=jnp.bfloat16)
BF16_T = dict(stream_dtype=torch.bfloat16)


def _close(name, got, ref, rel=1e-5):
    err = float(np.max(np.abs(np.asarray(ref) - np.asarray(got))))
    scale = float(np.max(np.abs(np.asarray(ref))))
    assert err <= rel * max(1.0, scale), f"{name}: {err:.3e} ({scale:.3e})"


def _trunk_inputs(name, N, out_len, seed=0):
    cfg_j = wt.get_config(name, **BF16_J)
    cfg_t = pt.get_config(name, **BF16_T)
    params_j = wt.init_wavenet(jax.random.PRNGKey(seed), cfg_j)
    params_np = jax.tree.map(np.asarray, params_j)
    T = cfg_j.receptive_field + out_len - 1
    x = np.random.default_rng(seed + 1).integers(0, cfg_j.classes, (N, T))
    h0 = np.array(jax_embed(params_j, cfg_j, jnp.asarray(x)))
    cond = (np.random.default_rng(seed + 2).standard_normal(
        (N, T, cfg_j.cond_channels)).astype(np.float32)
            if cfg_j.cond_channels else None)
    du = np.random.default_rng(seed + 3).standard_normal(
        (N, out_len, cfg_j.num_layers * cfg_j.dilation_channels)).astype(
            np.float32)
    return cfg_j, cfg_t, params_np, h0, cond, du


def test_plain_trunk_matches_jax_fused_trunk_with_cond():
    """u, dh0, dcond and every weight gradient of the plain K2/K3 at a bf16
    stream (tiny_vocoder: the COND path; the unconditioned one is held by
    the logits test below) against the JAX kernel's custom VJP with its
    default bf16 saves (the direct loads)."""
    out_len = 20
    cfg_j, cfg_t, params_np, h0, cond, du = _trunk_inputs(
        "tiny_vocoder", 2, out_len)

    def f(p, h, c):
        u = jtk.fused_trunk(p, cfg_j, h, out_len, cond=c)
        return jnp.sum(u * du), u

    (_, u_j), (g_p, g_h, g_c) = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(
            jax.tree.map(jnp.asarray, params_np), jnp.asarray(h0),
            jnp.asarray(cond))
    p_t = pt.from_jax_params(params_np, "cpu")
    ct = torch.from_numpy(cond)
    u_t, saves = tk.trunk_fwd_plain(p_t, cfg_t, torch.from_numpy(h0),
                                    out_len, torch.bfloat16, ct)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-5,
                               rtol=1e-5)
    dh0, dw_in, dw_res, db_in, db_res, dw_cond, dcond = tk.trunk_bwd_plain(
        p_t, cfg_t, saves, torch.from_numpy(du), out_len, ct)
    gl = g_p["layers"]
    for name, got, ref in (("dh0", dh0, g_h), ("dcond", dcond, g_c),
                           ("w_in", dw_in, gl["w_in"]),
                           ("w_res", dw_res, gl["w_res"]),
                           ("b_in", db_in, gl["b_in"]),
                           ("b_res", db_res, gl["b_res"]),
                           ("w_cond", dw_cond, gl["w_cond"])):
        _close(name, got.numpy(), ref)


@pytest.mark.parametrize("name", ["tiny", "tiny_vocoder"])
def test_f32_and_bf16_saves_give_bitwise_equal_gradients(name):
    """A bf16 stream's saves are the stream: held in f32 or bf16 they hold
    the same values, and give the same units and gradients bitwise."""
    out_len = 20
    _, cfg_t, params_np, h0, cond, du = _trunk_inputs(name, 2, out_len)
    p_t = pt.from_jax_params(params_np, "cpu")
    ct = None if cond is None else torch.from_numpy(cond)
    outs = []
    for sd in (torch.float32, torch.bfloat16):
        u, saves = tk.trunk_fwd_plain(p_t, cfg_t, torch.from_numpy(h0),
                                      out_len, sd, ct)
        assert saves.dtype == sd
        g = tk.trunk_bwd_plain(p_t, cfg_t, saves, torch.from_numpy(du),
                               out_len, ct)
        outs.append((u, saves.to(torch.float32), *g))
    for a, b in zip(*outs):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    # the stream is bf16: every save is a bf16 value
    s = outs[0][1]
    assert torch.equal(s, s.to(torch.bfloat16).to(torch.float32))


def test_fused_logits_and_train_step_gradients_match_jax():
    """``--bf16`` (compute and stream dtypes bf16) through the fused trunk:
    the logits and one train step's loss and gradients against the JAX
    package's. The JAX kernel emits u in the compute dtype, so its
    cotangent arrives as bf16; the port rounds u (and, through autograd of
    the cast, its cotangent) in the skip product: the same gradients."""
    cfg_j = wt.get_config("tiny", compute_dtype=jnp.bfloat16,
                          trunk_kernel=True, **BF16_J)
    cfg_t = pt.get_config("tiny", compute_dtype=torch.bfloat16,
                          trunk_kernel=True, **BF16_T)
    params_np = jax.tree.map(np.asarray,
                             wt.init_wavenet(jax.random.PRNGKey(2), cfg_j))
    rng = np.random.default_rng(4)
    x = rng.integers(0, cfg_j.classes, (3, cfg_j.item_length)).astype(
        np.int32)
    y = rng.integers(0, cfg_j.classes, (3, cfg_j.output_length)).astype(
        np.int32)

    def f(p):  # trainer.cross_entropy_loss, with the logits kept
        logits = jax_logits(p, cfg_j, jnp.asarray(x), cfg_j.output_length)
        l32 = logits.astype(jnp.float32)
        hit = jnp.sum(l32 * jax.nn.one_hot(jnp.asarray(y), cfg_j.classes),
                      axis=-1)
        return jnp.mean(jax.nn.logsumexp(l32, axis=-1) - hit), logits

    (loss_j, logits_j), g_j = jax.value_and_grad(f, has_aux=True)(
        jax.tree.map(jnp.asarray, params_np))
    p_t = {k: {n: v.requires_grad_(True) for n, v in sub.items()}
           for k, sub in pt.from_jax_params(params_np, "cpu").items()}
    with torch.no_grad():
        logits_t = pt.wavenet_logits(p_t, cfg_t, torch.from_numpy(x),
                                     cfg_t.output_length)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=1e-5, rtol=1e-5)
    tx = pt.reference_adam(1e-3)
    loss_t, g_t = pt.train_step(p_t, tx.init(p_t), cfg_t, tx,
                                torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5
    for k1 in g_t:
        for k2 in g_t[k1]:
            _close(f"{k1}.{k2}", g_t[k1][k2].numpy(), g_j[k1][k2])


def test_float16_streams_raise_and_bf16_passes():
    """The kernels take the stream dtypes the JAX kernel takes in training:
    f32 and bf16."""
    cfg = pt.get_config("tiny", **BF16_T)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    h0 = torch.zeros((1, cfg.receptive_field + 3, cfg.residual_channels))
    assert tk.fused_trunk(params, cfg, h0, 4).shape == (
        1, 4, cfg.num_layers * cfg.dilation_channels)
    with pytest.raises(ValueError, match="f32 and bf16 streams"):
        tk.fused_trunk(params, dataclasses.replace(
            cfg, stream_dtype=torch.float16), h0, 4)


@pytest.mark.parametrize("name,kw,M", [
    ("chaconne_wide", {}, 0), ("chaconne_wide", {"kernel_size": 3}, 0),
    ("vocoder", {}, 80), ("test_small", {"residual_channels": 12,
                                         "dilation_channels": 20}, 0)])
def test_bf16_stream_plans_fit_and_stage_the_raw_rows(name, kw, M):
    """K2's plan at a bf16 stream fits and makes room for the raw bf16 tap
    rows (k*Rp/2 words a position) in u's rows; K3's plans do not depend
    on the stream dtype (its bf16 saves already stage them there)."""
    f32 = pt.get_config(name, **kw)
    bf = pt.get_config(name, **kw, **BF16_T)
    Mp = tk.cond_width(M)
    Rp, Dp = tk.padded_widths(bf)
    k = bf.kernel_size
    tm, wsm = tk.fwd_plan(bf, Mp)
    assert tk.fwd_smem(tm, k, Rp, Dp, wsm, Mp, bs=True) <= tk.SMEM_LIMIT
    assert tk.fwd_smem(tm, k, Rp, Dp, wsm, Mp, bs=True) - tk.fwd_smem(
        tm, k, Rp, Dp, wsm, Mp) == 4 * tm * max(0, k * Rp // 2 - (Dp + 4))
    assert tk.bwd_plan(bf, Mp) == tk.bwd_plan(f32, Mp)


def _write_tone(directory, seconds=1.0):
    t = np.arange(int(16000 * seconds)) / 16000.0
    os.makedirs(directory, exist_ok=True)
    pt.write_wav(os.path.join(directory, "tone.wav"),
                 0.6 * np.sin(2 * np.pi * 110 * t), 16000)


def test_training_cli_bf16_snapshot_records_both_dtypes(tmp_path):
    """``train.main --bf16 --device cpu``: 2 steps through the fused trunk
    at a bf16 stream; the snapshot's config carries both dtypes, in the
    JAX package's JSON names, so the JAX package reads it as the same
    bf16 config."""
    data = str(tmp_path / "audio")
    _write_tone(data)
    snaps = str(tmp_path / "snaps")
    tr = train_cli.main(["--data-dir", data, "--config", "tiny",
                         "--batch-size", "2", "--device", "cpu", "--bf16",
                         "--snapshot-path", snaps, "--test-stride", "20",
                         "--max-steps", "2", "--snapshot-interval", "2"])
    assert tr.step == 2 and tr.cfg.trunk_kernel
    assert tr.cfg.compute_dtype == tr.cfg.stream_dtype == torch.bfloat16
    blob = pt.load_checkpoint(pt.latest_checkpoint(snaps), device="cpu")
    assert blob["step"] == 2 and blob["config"] == tr.cfg
    cfg_j = wt.WaveNetConfig.from_json(blob["config"].to_json())
    assert cfg_j.compute_dtype == cfg_j.stream_dtype == jnp.bfloat16
    assert cfg_j == wt.get_config("tiny", trunk_kernel=True,
                                  compute_dtype=jnp.bfloat16, **BF16_J)
    shutil.rmtree(snaps)
