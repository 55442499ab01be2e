"""The port's teacher-forced trunk against the JAX package's on the same
numpy weights and inputs (f32 on the CPU: atol = rtol = 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt

TOL = dict(atol=1e-5, rtol=1e-5)


def np_params(name, seed):
    """Seeded numpy weights in the stacked layout of ``name``'s config."""
    shapes = jax.eval_shape(
        lambda: wt.init_wavenet(jax.random.PRNGKey(0), wt.get_config(name)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name,out_len", [
    ("tiny", 4), ("tiny", 130), ("test_small", 8), ("test_small", 128),
])
def test_wavenet_logits_match_jax(name, out_len):
    cfgj, cfgt = wt.get_config(name), pt.get_config(name)
    npp = np_params(name, seed=1)
    rng = np.random.default_rng(2)
    x = rng.integers(0, cfgj.classes, (2, cfgj.receptive_field + out_len - 1))
    yj = np.asarray(wt.wavenet_logits(
        jax.tree.map(jnp.asarray, npp), cfgj, jnp.asarray(x, jnp.int32),
        out_len=out_len))
    yt = pt.wavenet_logits(pt.from_jax_params(npp, "cpu"), cfgt,
                           torch.from_numpy(x), out_len=out_len).numpy()
    assert yt.shape == (2, out_len, cfgj.classes)
    np.testing.assert_allclose(yt, yj, **TOL)


def test_one_hot_input_and_forward_match_jax():
    cfgj, cfgt = wt.get_config("tiny"), pt.get_config("tiny")
    npp = np_params("tiny", seed=3)
    rng = np.random.default_rng(4)
    x = rng.integers(0, cfgj.classes, (3, cfgj.item_length))
    onehot = np.eye(cfgj.classes, dtype=np.float32)[x]
    jp = jax.tree.map(jnp.asarray, npp)
    tp = pt.from_jax_params(npp, "cpu")
    np.testing.assert_allclose(
        pt.forward(tp, cfgt, torch.from_numpy(onehot)).numpy(),
        np.asarray(wt.forward(jp, cfgj, jnp.asarray(onehot))), **TOL)
    np.testing.assert_allclose(
        pt.forward(tp, cfgt, torch.from_numpy(x)).numpy(),
        np.asarray(wt.forward(jp, cfgj, jnp.asarray(x, jnp.int32))), **TOL)


def test_short_input_rejected():
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError):
        pt.wavenet_logits(params, cfg, torch.zeros((1, 3), dtype=torch.long),
                          out_len=4)


@pytest.mark.parametrize("name", ["tiny", "test_small"])
def test_init_layout_and_scale(name):
    """Same tree, shapes and Conv1d-default bounds as the JAX init."""
    cfg = pt.get_config(name)
    tp = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = wt.init_wavenet(jax.random.PRNGKey(0), wt.get_config(name))
    flat_t = {"/".join(k): v for k, v in _flatten(tp)}
    flat_j = {"/".join(k): np.asarray(v) for k, v in _flatten(jp)}
    assert flat_t.keys() == flat_j.keys()
    for key, v in flat_t.items():
        assert tuple(v.shape) == flat_j[key].shape, key
        bound = _init_bound(cfg, key)
        assert float(v.abs().max()) <= bound
        assert np.abs(flat_j[key]).max() <= bound
    assert pt.parameter_count(tp) == wt.parameter_count(jp)


def _init_bound(cfg, key):
    fan = {"start/w": cfg.classes, "start/b": cfg.classes,
           "end1/w": cfg.skip_channels, "end1/b": cfg.skip_channels,
           "end2/w": cfg.end_channels, "end2/b": cfg.end_channels,
           "layers/w_res": cfg.dilation_channels,
           "layers/w_skip": cfg.dilation_channels,
           "layers/b_res": cfg.dilation_channels,
           "layers/b_skip": cfg.dilation_channels}.get(
        key, cfg.residual_channels * cfg.kernel_size)
    return 1.0 / fan ** 0.5


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_cpu_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError):
        pt.init_wavenet(pt.get_config("tiny"), torch.Generator())
