"""The port's optimizers (learning-rate schedules, SGDNormalized, EMA,
MultiSteps accumulation and their stacks) against the JAX package's optax
transforms, on the CPU at the ``tiny`` preset.

Tolerances: each learning rate within 1 f32 ulp of optax's at counts 0-40;
after 6 train steps on the same params and batches, params, Adam moments,
EMA and accumulated gradients within atol = rtol = 1e-5 (both sides full
f32 on the CPU; the sums run in other orders); counts exactly equal. The
state-dict layouts equal ``flax.serialization.to_state_dict``'s key for
key, with the same shapes, int32 counts and None where optax has None.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.training import optimizers as jopt
from pytorch_wavenet_tpu.training.trainer import train_step as jax_step
from pytorch_wavenet_tpu_torch.training import optimizers as topt

SCHEDULES = [("constant", None, 0.0), ("cosine", 20, 0.1),
             ("cosine", 7, 0.0), ("exponential", 10, 0.5),
             ("exponential", 3, 0.1)]


@pytest.mark.parametrize("warmup", [0, 4])
@pytest.mark.parametrize("kind,decay,ratio", SCHEDULES,
                         ids=[f"{k}-{d}-{r}" for k, d, r in SCHEDULES])
def test_lr_schedule_matches_optax(kind, decay, ratio, warmup):
    j = jopt.lr_schedule(1e-3, kind, warmup, decay, ratio)
    t = topt.lr_schedule(1e-3, kind, warmup, decay, ratio)
    if isinstance(j, float):
        assert t == j
        return
    for count in range(41):
        ref = np.float32(j(jnp.asarray(count, jnp.int32)))
        got = t(count)
        assert got.dtype == np.float32
        ulps = abs(int(ref.view(np.int32)) - int(got.view(np.int32)))
        assert ulps <= 1, (count, ref, got)


def test_lr_schedule_refusals_match():
    for args in (("cosine", 0, None), ("exponential", 0, None),
                 ("exponential", 0, 5, 1.5), ("linear", 0, 5)):
        with pytest.raises(ValueError) as ej:
            jopt.lr_schedule(1e-3, *args)
        with pytest.raises(ValueError) as et:
            topt.lr_schedule(1e-3, *args)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="constant"):
        topt.sgd_normalized(lr=topt.lr_schedule(1e-3, "cosine", 0, 5))


def _cos(lr=3e-3):
    return dict(lr=lr, kind="cosine", warmup_steps=2, decay_steps=6,
                min_lr_ratio=0.1)


# name -> a function of a package's optimizer module (and its MultiSteps)
# that makes the same stack in either package
STACKS = {
    "adam-cosine-warmup-clip-decay": lambda m, ms: m.reference_adam(
        m.lr_schedule(**_cos()), 0.01, 0.5),
    "adam-exponential-warmup": lambda m, ms: m.reference_adam(
        m.lr_schedule(3e-3, "exponential", 2, 3, 0.5)),
    "adam-constant-warmup": lambda m, ms: m.reference_adam(
        m.lr_schedule(3e-3, "constant", 3)),
    "sgd": lambda m, ms: m.sgd_normalized(lr=1e-2),
    "sgd-momentum": lambda m, ms: m.sgd_normalized(lr=1e-2, momentum=0.9),
    "sgd-nesterov-decay": lambda m, ms: m.sgd_normalized(
        lr=1e-2, momentum=0.9, weight_decay=0.01, nesterov=True),
    "ema-adam": lambda m, ms: m.with_ema(m.reference_adam(3e-3), 0.9),
    "accum2-adam": lambda m, ms: ms(m.reference_adam(3e-3), 2),
    "accum3-adam-clip": lambda m, ms: ms(m.reference_adam(3e-3, 0.0, 0.5),
                                         3),
    "accum2-ema-adam-cosine": lambda m, ms: ms(m.with_ema(
        m.reference_adam(m.lr_schedule(**_cos())), 0.9), 2),
}


def build(name):
    """The stack ``name`` in both packages: (JAX, port)."""
    return (STACKS[name](jopt, lambda tx, k: optax.MultiSteps(
                tx, every_k_schedule=k)),
            STACKS[name](topt, topt.MultiSteps))


def _np_params(cfg, seed):
    return jax.tree.map(np.asarray,
                        wt.init_wavenet(jax.random.PRNGKey(seed), cfg))


def _trainable(params_np):
    return topt._map(lambda p: p.requires_grad_(True),
                     pt.from_jax_params(params_np, "cpu"))


def _batches(cfg, n, batch=3, seed=4):
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, cfg.classes, (n, batch, cfg.item_length + 1))
    return [(s[:, :-1].astype(np.int32),
             s[:, -cfg.output_length:].astype(np.int32)) for s in seq]


def _structure(tree):
    """Keys, shapes and dtypes of a state dict (None kept)."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if tree is None:
        return None
    a = np.asarray(tree)
    return (a.shape, str(a.dtype))


def assert_state_close(got, ref, path=()):
    """Two optax-layout state dicts: the same keys, counts equal, arrays
    within 1e-5."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(ref), path
        for k in ref:
            assert_state_close(got[k], ref[k], path + (k,))
        return
    if ref is None:
        assert got is None, path
        return
    ref, got = np.asarray(ref), np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype, path
    if ref.dtype.kind == "i":
        np.testing.assert_array_equal(got, ref, err_msg=str(path))
    else:
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", sorted(STACKS))
def test_state_dict_layout_matches_optax(name):
    cfg = wt.get_config("tiny")
    params_np = _np_params(cfg, 1)
    tx_j, tx_t = build(name)
    ref = serialization.to_state_dict(jax.tree.map(
        np.asarray, tx_j.init(jax.tree.map(jnp.asarray, params_np))))
    p_t = _trainable(params_np)
    got = tx_t.state_dict(tx_t.init(p_t))
    assert _structure(got) == _structure(ref)
    assert_state_close(got, ref)
    # and back: the JAX layout loads into the port's optimizer
    assert_state_close(tx_t.state_dict(tx_t.load_state_dict(ref, p_t)), ref)


@pytest.mark.parametrize("name", sorted(STACKS))
def test_six_train_steps_match_jax(name):
    """Params, every state leaf (Adam's moments, the EMA, the accumulated
    gradients, the counts) after each of 6 steps."""
    cfg_j, cfg_t = wt.get_config("tiny"), pt.get_config("tiny")
    params_np = _np_params(cfg_j, 2)
    tx_j, tx_t = build(name)
    pj = jax.tree.map(jnp.asarray, params_np)
    # a state of its own buffers (with_ema's init keeps the params'
    # arrays, and the step donates both)
    sj = tx_j.init(jax.tree.map(jnp.asarray, params_np))
    p_t = _trainable(params_np)
    s_t = tx_t.init(p_t)
    for step, (x, y) in enumerate(_batches(cfg_j, 6)):
        pj, sj, lj, _ = jax_step(pj, sj, cfg_j, tx_j, jnp.asarray(x),
                                 jnp.asarray(y))
        lt, _ = pt.train_step(p_t, s_t, cfg_t, tx_t, torch.from_numpy(x),
                              torch.from_numpy(y))
        assert abs(float(lt) - float(lj)) <= 1e-5, step
        assert_state_close(pt.to_numpy_params(p_t),
                           jax.tree.map(np.asarray, pj), ("params", step))
        assert_state_close(tx_t.state_dict(s_t), serialization.to_state_dict(
            jax.tree.map(np.asarray, sj)), ("opt_state", step))
    moved = [float(np.abs(np.asarray(a) - b).max()) for (_, a), (_, b) in
             zip(topt._leaves(pj), topt._leaves(params_np))]
    assert max(moved) > 0  # the stack did update the params


def test_multisteps_moves_params_once_per_k():
    cfg = pt.get_config("tiny")
    p = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    for _, v in topt._leaves(p):
        v.requires_grad_(True)
    tx = topt.MultiSteps(topt.with_ema(topt.reference_adam(1e-2), 0.5), 3)
    s = tx.init(p)
    before = topt._map(lambda t: t.detach().clone().numpy(), p)
    for i, (x, y) in enumerate(_batches(cfg, 3)):
        pt.train_step(p, s, cfg, tx, torch.from_numpy(x), torch.from_numpy(y))
        same = all(np.array_equal(a, b) for (_, a), (_, b) in zip(
            topt._leaves(before), topt._leaves(pt.to_numpy_params(p))))
        assert same == (i < 2)
    assert s["mini_step"] == 0 and s["gradient_step"] == 1
    assert s["inner_opt_state"]["inner"]["count"] == 1
    assert all(float(a.abs().max()) == 0
               for _, a in topt._leaves(s["acc_grads"]))
    ema = topt.ema_params(s)
    assert ema is s["inner_opt_state"]["ema"]
    for (_, e), (_, a), (_, b) in zip(topt._leaves(ema), topt._leaves(before),
                                      topt._leaves(pt.to_numpy_params(p))):
        np.testing.assert_allclose(e.numpy(), 0.5 * a + 0.5 * b, atol=1e-7)


def test_load_state_dict_refuses_another_stack():
    cfg = pt.get_config("tiny")
    p = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    sched = topt.reference_adam(topt.lr_schedule(**_cos()))
    blob = sched.state_dict(sched.init(p))
    with pytest.raises(ValueError, match="chain"):
        topt.reference_adam(1e-3).load_state_dict(blob, p)
    ms = topt.MultiSteps(topt.with_ema(sched, 0.9), 2)
    with pytest.raises(ValueError, match="chain"):
        topt.with_ema(sched, 0.9).load_state_dict(
            ms.state_dict(ms.init(p)), p)
    sgd = topt.sgd_normalized(momentum=0.9)
    with pytest.raises(ValueError, match="momentum"):
        topt.sgd_normalized().load_state_dict(sgd.state_dict(sgd.init(p)), p)
