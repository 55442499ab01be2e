"""The port's training trunk (``ops/cuda/trunk_kernel.py``, plain versions
on the CPU) against the JAX package's ``fused_trunk`` run as its own tests
run it here (Pallas in interpret mode), on the same params and inputs.

Tolerances: units and logits at atol 5e-6 / rtol 1e-5 (both sides are full
f32 on the CPU; tests/test_trunk_kernel.py holds the JAX kernel to its XLA
trunk at the same tolerance); gradients with f32 saves within 1e-5 x
max(1, scale), with bf16 saves within 2e-2 x max(1, scale) (the rule of
tests/test_trunk_kernel.py).
"""

import dataclasses
import functools

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


def _setup(out_len, N=2, seed=0, **kw):
    cfg_j = wt.get_config("tiny", **kw)
    cfg_t = pt.get_config("tiny", **kw)
    params_j = wt.init_wavenet(jax.random.PRNGKey(seed), cfg_j)
    params_np = jax.tree.map(np.asarray, params_j)
    rng = np.random.default_rng(seed + 1)
    x = rng.integers(0, cfg_j.classes, (N, cfg_j.receptive_field + out_len - 1))
    return cfg_j, cfg_t, params_np, x


CASES = [  # tests/test_trunk_kernel.py:46-56
    ({}, 2, 20), ({}, 3, 20), ({"kernel_size": 3}, 2, 20),
    ({"bias": False}, 2, 20), ({}, 2, 1), ({}, 4, 128),
    ({"kernel_size": 3}, 2, 256),
]


@pytest.mark.parametrize("kw,N,out_len", CASES)
def test_units_and_logits_match_jax_fused_trunk(kw, N, out_len):
    cfg_j, cfg_t, params_np, x = _setup(out_len, N=N, **kw)
    pj = jax.tree.map(jnp.asarray, params_np)
    h0 = jax_embed(pj, cfg_j, jnp.asarray(x))
    u_j = np.asarray(jtk.fused_trunk(pj, cfg_j, h0, out_len))
    p_t = pt.from_jax_params(params_np, "cpu")
    u_t = tk.fused_trunk(p_t, cfg_t, torch.from_numpy(np.array(h0)),
                         out_len)
    assert u_t.shape == (N, out_len, cfg_t.num_layers
                         * cfg_t.dilation_channels)
    np.testing.assert_allclose(u_t.numpy(), u_j, atol=5e-6, rtol=1e-5)
    ref = np.asarray(jax_logits(pj, dataclasses.replace(
        cfg_j, trunk_kernel=True), jnp.asarray(x), out_len))
    got = pt.wavenet_logits(p_t, dataclasses.replace(cfg_t, trunk_kernel=True),
                            torch.from_numpy(x), out_len)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6, rtol=1e-5)


def _grads_pair(kw, N, out_len, save_j, save_t):
    """Gradients of the same loss through the JAX fused trunk (its save
    dtype pinned, as tests/test_trunk_kernel.py:_grad_pair does) and the
    port's."""
    cfg_j, cfg_t, params_np, x = _setup(out_len, N=N, **kw)
    tgt = np.random.default_rng(9).integers(0, cfg_j.classes, (N, out_len))

    def loss_j(p):
        ls = jax.nn.log_softmax(jax_logits(
            p, dataclasses.replace(cfg_j, trunk_kernel=True), jnp.asarray(x),
            out_len))
        return -jnp.mean(jnp.take_along_axis(ls, jnp.asarray(tgt)[..., None],
                                             axis=-1))

    orig_j = jtk.fused_trunk
    try:
        jtk.fused_trunk = functools.partial(orig_j, save_dtype=save_j)
        g_j = jax.grad(loss_j)(jax.tree.map(jnp.asarray, params_np))
    finally:
        jtk.fused_trunk = orig_j
    p_t = pt.from_jax_params(params_np, "cpu")
    leaves = [(k1, k2) for k1 in sorted(p_t) for k2 in sorted(p_t[k1])]
    for k1, k2 in leaves:
        p_t[k1][k2].requires_grad_(True)
    logits = None
    orig_t = tk.fused_trunk
    try:
        tk.fused_trunk = functools.partial(orig_t, save_dtype=save_t)
        logits = pt.wavenet_logits(
            p_t, dataclasses.replace(cfg_t, trunk_kernel=True),
            torch.from_numpy(x), out_len)
    finally:
        tk.fused_trunk = orig_t
    loss = -torch.mean(torch.gather(torch.log_softmax(logits, -1), -1,
                                    torch.from_numpy(tgt)[..., None]))
    g_t = torch.autograd.grad(loss, [p_t[a][b] for a, b in leaves])
    return [(f"{a}.{b}", np.asarray(g_j[a][b]), g.numpy())
            for (a, b), g in zip(leaves, g_t)]


def _assert_close_scaled(pairs, rel):
    for name, ref, got in pairs:
        err = float(np.max(np.abs(ref - got)))
        scale = float(np.max(np.abs(ref)))
        assert err <= rel * max(1.0, scale), f"{name}: {err:.3e} ({scale:.3e})"


@pytest.mark.parametrize("kw,N,out_len", [
    ({}, 2, 20), ({}, 3, 20), ({"kernel_size": 3}, 2, 20),
    ({"bias": False}, 2, 20), ({}, 4, 128),
])
def test_grads_with_f32_saves_match_jax(kw, N, out_len):
    pairs = _grads_pair(kw, N, out_len, jnp.float32, torch.float32)
    assert len(pairs) == (12 if kw.get("bias", True) else 8)
    _assert_close_scaled(pairs, 1e-5)


def test_grads_with_bf16_saves_match_jax_at_bf16_scale():
    _assert_close_scaled(_grads_pair({}, 2, 20, jnp.bfloat16,
                                     torch.bfloat16), 2e-2)


@pytest.mark.parametrize("kw,N,out_len", [({}, 3, 20),
                                          ({"kernel_size": 3}, 2, 7),
                                          ({"bias": False}, 2, 1)])
@pytest.mark.parametrize("save_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_backward_equals_autograd_of_plain_forward(kw, N, out_len,
                                                         save_dtype):
    """trunk_bwd_plain (written out, recomputing from the saves) against
    autograd of trunk_fwd_plain: within 1e-5 x max(1, scale) with f32
    saves; with bf16 saves the recompute reads rounded streams, so 2e-2."""
    cfg = pt.get_config("tiny", **kw)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(1), "cpu")
    T = cfg.receptive_field + out_len - 1
    rng = np.random.default_rng(2)
    h0 = torch.from_numpy(rng.uniform(-1, 1, (N, T, cfg.residual_channels))
                          .astype(np.float32)).requires_grad_(True)
    du = torch.from_numpy(rng.uniform(-1, 1, (N, out_len, cfg.num_layers
                                              * cfg.dilation_channels))
                          .astype(np.float32))
    lp = params["layers"]
    names = [n for n in ("b_in", "b_res", "w_in", "w_res") if n in lp]
    for n in names:
        lp[n].requires_grad_(True)
    u, _ = tk.trunk_fwd_plain.__wrapped__(params, cfg, h0, out_len,
                                          torch.float32)
    ref = torch.autograd.grad((u * du).sum(), [h0] + [lp[n] for n in names])
    _, saves = tk.trunk_fwd_plain(params, cfg, h0.detach(), out_len,
                                  save_dtype)
    dh0, dw_in, dw_res, db_in, db_res = tk.trunk_bwd_plain(
        params, cfg, saves, du, out_len)
    got = {"w_in": dw_in, "w_res": dw_res, "b_in": db_in, "b_res": db_res}
    rel = 1e-5 if save_dtype == torch.float32 else 2e-2
    _assert_close_scaled(
        [("h0", ref[0].numpy(), dh0.numpy())]
        + [(n, r.numpy(), got[n].numpy()) for n, r in zip(names, ref[1:])],
        rel)


def test_rejects_what_the_trunk_does_not_take():
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    T = cfg.receptive_field + 19
    h0 = torch.zeros((2, T, cfg.residual_channels))
    with pytest.raises(ValueError, match="receptive_field"):
        tk.fused_trunk(params, cfg, h0[:, :-1], 20)
    with pytest.raises(ValueError, match="kernel_size"):
        tk.fused_trunk(params, pt.get_config("tiny", kernel_size=1), h0, 20)
    with pytest.raises(ValueError, match="f32 streams"):
        tk.fused_trunk(params, pt.get_config(
            "tiny", stream_dtype=torch.bfloat16), h0, 20)
    with pytest.raises(ValueError, match="conditioning"):
        tk.fused_trunk(params, cfg, h0, 20, cond=torch.zeros(2, T, 3))
    # a CPU tensor never reaches the CUDA launchers' kernels
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.trunk_fwd_cuda(params, cfg, h0, 20)
    u, saves = tk.trunk_fwd_plain(params, cfg, h0, 20)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.trunk_bwd_cuda(params, cfg, saves, torch.zeros_like(u), 20)
    assert tk.fwd_launches == 0 and tk.bwd_launches == 0


def test_raw_view_and_longer_window():
    """``raw=True`` views the units as (N, out, L, D); a longer input is cut
    to its trailing window, as the plain trunk reads it."""
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, cfg.classes,
                                      (2, cfg.receptive_field + 16)))
    ref = pt.wavenet_logits(params, cfg, x, 12)
    got = pt.wavenet_logits(params, dataclasses.replace(cfg, trunk_kernel=True),
                            x, 12)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-6, rtol=1e-5)
    h0 = pt.embed_inputs(params, cfg, x[:, 5:])
    raw = tk.fused_trunk(params, cfg, h0, 12, raw=True)
    assert raw.shape == (2, 12, cfg.num_layers, cfg.dilation_channels)
