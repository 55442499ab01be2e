"""The IAF student of the port against the JAX package: the init tree, the
identity at init and ``init_scale``, ``flow_transform``, ``student_sample``
and ``student_synthesize`` from the same base uniforms (with and without
cond and gcond), causality, and student snapshots across the packages.
f32 tolerances atol = rtol = 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.models import iaf as ji
from pytorch_wavenet_tpu.ops import mel as jmel
from pytorch_wavenet_tpu.utils import checkpoints as jck
from pytorch_wavenet_tpu_torch.models import iaf as ti
from pytorch_wavenet_tpu_torch.ops import mel as tmel
from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

TOL = dict(atol=1e-5, rtol=1e-5)
SMALL = dict(flows=2, layers=3, residual_channels=8, dilation_channels=8,
             skip_channels=8, end_channels=8)


def _cfgs(**kw):
    return ji.IAFConfig(**SMALL, **kw), ti.IAFConfig(**SMALL, **kw)


def _random_params(scfg_j, seed):
    """A JAX student with every leaf random (end2 too, so that no flow is
    the identity), and the same values in the port."""
    shapes = jax.eval_shape(lambda: ji.init_student(jax.random.PRNGKey(0),
                                                    scfg_j))
    rng = np.random.default_rng(seed)
    npp = jax.tree.map(
        lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32), shapes)
    return jax.tree.map(jnp.asarray, npp), pt.from_jax_params(npp, "cpu")


def _uniforms(key, shape):
    return np.array(jax.random.uniform(key, shape, jnp.float32, 1e-5,
                                         1.0 - 1e-5))


def _flat(sd):
    """``(path, leaf)`` pairs of a state dict (nested dicts), sorted."""
    return sorted(_leaves(sd), key=lambda e: e[0])


@pytest.mark.parametrize("kw", [{}, {"cond_channels": 5, "gcond_channels": 3},
                                {"bias": False, "blocks": 2}])
def test_init_tree_matches_jax_leaf_by_leaf(kw):
    sj, st = _cfgs(**kw)
    jp = ji.init_student(jax.random.PRNGKey(0), sj, init_scale=0.2)
    tp = ti.init_student(st, torch.Generator().manual_seed(0),
                         init_scale=0.2, device="cpu")
    assert isinstance(tp["flows"], tuple) and len(tp["flows"]) == 2
    a = _flat(serialization.to_state_dict(jp))
    b = _flat(ti.student_state_dict(tp))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert tuple(y.shape) == x.shape and y.dtype == torch.float32, path
        if path[2] in ("end2",) or path[2:] == ("end1", "b"):
            # zero heads, and the last flow's log-scale bias at init_scale
            np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL)
    assert ti.student_parameter_count(tp) == ji.student_parameter_count(jp)
    b_last = float(tp["flows"][-1]["end2"]["b"][1])
    assert 7.0 * np.tanh(b_last / 7.0) == pytest.approx(np.log(0.2), rel=1e-6)
    with pytest.raises(ValueError, match="soft bound"):
        ti.init_student(st, torch.Generator(), init_scale=1e-4, device="cpu")


@pytest.mark.parametrize("scale", [1.0, 0.1])
def test_identity_at_init_and_init_scale(scale):
    _, st = _cfgs()
    tp = ti.init_student(st, torch.Generator().manual_seed(1),
                         init_scale=scale, device="cpu")
    u = _uniforms(jax.random.PRNGKey(2), (2, 64))
    d = ti.student_sample(tp, st, None, (2, 64), u=torch.from_numpy(u))
    np.testing.assert_allclose(d.x.numpy(), scale * d.z0.numpy(), **TOL)
    np.testing.assert_allclose(d.m.numpy(), 0.0, atol=1e-7)
    np.testing.assert_allclose(d.log_s.numpy(), np.log(scale), **TOL)


@pytest.mark.parametrize("cond", [False, True])
def test_flow_transform_matches_jax(cond):
    kw = {"cond_channels": 5, "gcond_channels": 3} if cond else {}
    sj, st = _cfgs(**kw)
    jp, tp = _random_params(sj, 3)
    rng = np.random.default_rng(4)
    z = rng.logistic(size=(2, 50)).astype(np.float32)
    c = (0.5 * rng.standard_normal((2, 50, 5))).astype(np.float32)
    g = rng.standard_normal((2, 3)).astype(np.float32)
    args_j = (jnp.asarray(c), jnp.asarray(g)) if cond else (None, None)
    args_t = (torch.from_numpy(c), torch.from_numpy(g)) if cond else (None,
                                                                      None)
    mj, sj_ = ji.flow_transform(jp["flows"][0], sj, jnp.asarray(z), *args_j)
    mt, st_ = ti.flow_transform(tp["flows"][0], st, torch.from_numpy(z),
                                *args_t)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **TOL)
    np.testing.assert_allclose(st_.numpy(), np.asarray(sj_), **TOL)


@pytest.mark.parametrize("kw", [{}, {"cond_channels": 5},
                                {"cond_channels": 5, "gcond_channels": 3}])
def test_student_sample_matches_jax_from_the_same_uniforms(kw):
    sj, st = _cfgs(**kw)
    jp, tp = _random_params(sj, 5)
    B, T = 3, 120
    key = jax.random.PRNGKey(6)
    rng = np.random.default_rng(7)
    c = (0.5 * rng.standard_normal((B, T, 5))).astype(np.float32)
    g = rng.standard_normal((B, 3)).astype(np.float32)
    cj = jnp.asarray(c) if sj.cond_channels else None
    gj = jnp.asarray(g) if sj.gcond_channels else None
    dj = ji.student_sample(jp, sj, key, (B, T), cond=cj, global_cond=gj)
    dt = ti.student_sample(
        tp, st, None, (B, T),
        cond=None if cj is None else torch.from_numpy(c),
        global_cond=None if gj is None else torch.from_numpy(g),
        u=torch.from_numpy(_uniforms(key, (B, T))))
    for name in ("x", "m", "log_s", "z0", "log_q"):
        np.testing.assert_allclose(getattr(dt, name).detach().numpy(),
                                   np.asarray(getattr(dj, name)), **TOL,
                                   err_msg=name)
    gen = ti.student_generate(tp, st, None, T, num_streams=B,
                              cond=None if cj is None else c,
                              global_cond=None if gj is None else g,
                              device="cpu")
    assert gen.shape == (B, T) and float(gen.abs().max()) <= 1.0


def test_student_synthesize_matches_jax(monkeypatch):
    """Mel frames upsampled to rows (the port's ``upsample_frames``, JAX's
    jnp one), the same uniforms, one parallel pass."""
    sj, st = _cfgs(cond_channels=6)
    jp, tp = _random_params(sj, 8)
    mel = np.random.default_rng(9).standard_normal((2, 5, 6)).astype(
        np.float32)
    hop = 16
    key = jax.random.PRNGKey(10)
    want = ji.student_synthesize(jp, sj, key, jnp.asarray(mel), hop)
    u = _uniforms(key, (2, 5 * hop))
    monkeypatch.setattr(ti, "base_uniforms",
                        lambda gen, shape: torch.from_numpy(u))
    got = ti.student_synthesize(tp, st, None, mel, hop, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        tmel.upsample_frames(torch.from_numpy(mel), hop, 90).numpy(),
        np.asarray(jmel.upsample_frames(jnp.asarray(mel), hop, 90)), **TOL)
    with pytest.raises(ValueError, match="unconditional"):
        ti.student_synthesize(tp, ti.IAFConfig(**SMALL), None, mel, hop,
                              device="cpu")
    with pytest.raises(ValueError, match="channels"):
        ti.student_synthesize(tp, st, None, mel[..., :4], hop, device="cpu")


def test_the_draw_is_causal():
    """Moving the noise at step t moves no output before t: x_t depends on
    z0 up to t, (m, log_s) at t on z0 before t only."""
    sj, st = _cfgs()
    _, tp = _random_params(sj, 11)
    u = _uniforms(jax.random.PRNGKey(12), (1, 80))
    a = ti.student_sample(tp, st, None, (1, 80), u=torch.from_numpy(u))
    u2 = u.copy()
    u2[0, 40] = 0.9 if u[0, 40] < 0.5 else 0.1
    b = ti.student_sample(tp, st, None, (1, 80), u=torch.from_numpy(u2))
    assert torch.equal(a.x[:, :40], b.x[:, :40])
    assert torch.equal(a.m[:, :41], b.m[:, :41])
    assert torch.equal(a.log_s[:, :41], b.log_s[:, :41])
    assert not torch.equal(a.x[:, 40:], b.x[:, 40:])


def test_sample_refusals():
    _, st = _cfgs()
    tp = ti.init_student(st, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="cond_channels == 0"):
        ti.student_sample(tp, st, None, (1, 8), cond=torch.zeros(1, 8, 2))
    with pytest.raises(ValueError, match="gcond_channels == 0"):
        ti.student_sample(tp, st, None, (1, 8),
                          global_cond=torch.zeros(1, 2))
    with pytest.raises(ValueError, match="u shape"):
        ti.student_sample(tp, st, None, (1, 8), u=torch.full((1, 9), 0.5))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ti.student_generate(tp, st, None, 8)


def _extra(scfg):
    return {"iaf_config": dataclasses.asdict(
        dataclasses.replace(scfg, compute_dtype=None))}


def test_snapshots_load_across_the_packages(tmp_path):
    """A JAX-written student loads in the port (flax's ``{"flows": {"0":
    ...}}`` layout, the architecture from ``iaf_config``) and a port-written
    one in the JAX package, leaf for leaf."""
    sj = ji.IAFConfig(flows=3, layers=2, residual_channels=8,
                      dilation_channels=8, skip_channels=4, end_channels=6,
                      cond_channels=5)
    st = ti.IAFConfig(flows=3, layers=2, residual_channels=8,
                      dilation_channels=8, skip_channels=4, end_channels=6,
                      cond_channels=5)
    jp, tp = _random_params(sj, 13)
    jpath = jck.save_checkpoint(str(tmp_path / "j"), "student", 7, jp,
                                extra=_extra(sj))
    got, scfg, step = ti.load_student_snapshot(jpath, device="cpu")
    assert step == 7 and scfg == st and isinstance(got["flows"], tuple)
    for (pa, a), (pb, b) in zip(_flat(ti.student_state_dict(got)),
                                _flat(serialization.to_state_dict(jp))):
        assert pa == pb and np.array_equal(a.numpy(), np.asarray(b))
    tpath = pt.save_checkpoint(str(tmp_path / "t"), "student", 9, tp,
                               extra=_extra(st))
    back, scfg_j, step_j = ji.load_student_snapshot(tpath)
    assert step_j == 9 and scfg_j == sj
    for (pa, a), (pb, b) in zip(_flat(serialization.to_state_dict(back)),
                                _flat(ti.student_state_dict(tp))):
        assert pa == pb and np.array_equal(np.asarray(a), b.numpy())
    # both draw the same clip from the same uniforms after the round trip
    u = _uniforms(jax.random.PRNGKey(14), (1, 40))
    rows = np.random.default_rng(15).standard_normal((1, 40, 5)).astype(
        np.float32)
    dj = ji.student_sample(back, scfg_j, jax.random.PRNGKey(14), (1, 40),
                           cond=jnp.asarray(rows))
    dt = ti.student_sample(got, scfg, None, (1, 40),
                           cond=torch.from_numpy(rows),
                           u=torch.from_numpy(u))
    np.testing.assert_allclose(dt.x.numpy(), np.asarray(dj.x), **TOL)
    # a snapshot whose shapes do not fit its iaf_config is refused
    bad = pt.save_checkpoint(str(tmp_path / "b"), "student", 1, tp,
                             extra=_extra(dataclasses.replace(st, flows=2)))
    with pytest.raises(ValueError, match="flows"):
        ti.load_student_snapshot(bad, device="cpu")


def test_convert_takes_tuples_and_lists():
    sj, st = _cfgs()
    jp, tp = _random_params(sj, 16)
    back = pt.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    assert isinstance(back["flows"], tuple)
    sd = pt.to_numpy_params(tp)
    assert set(sd["flows"]) == {"0", "1"}
    want = serialization.to_state_dict(jax.tree.map(np.asarray, jp))
    for (pa, a), (pb, b) in zip(_flat(sd), _flat(want)):
        assert pa == pb and np.array_equal(a, b)
    lists = pt.from_jax_params({"a": [np.zeros(2), np.ones(3)]}, "cpu")
    assert isinstance(lists["a"], tuple) and lists["a"][1].shape == (3,)
