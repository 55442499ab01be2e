"""The port's time-sharded trunk and layer-pipelined generation on 2 and 4
gloo ranks, against the JAX package's ``time_sharded_*`` and
``generate_pipelined`` and against the port on one rank.

Time sharding (kernel_size 3, halo 8, T = 32): the gathered logits, the
loss and its gradients equal JAX's time-sharded ones and the unsharded
ones at atol = rtol = 1e-5, and the three refusals (T % n, T/n below the
halo, T below the receptive field) hold. The pipeline at 2 and 4 stages:
each group's classes equal the port's ``generate_fast`` on that group
bitwise at T = 0, with gcond, with the default and a short prime, and at
T = 1 given ``group_generator(seed, g)``; at T = 0 the classes equal JAX
``generate_pipelined``'s off near-ties (a top-2 gap below 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
import torch_parallel_cases as cases
from pytorch_wavenet_tpu.parallel.mesh import make_mesh as jax_mesh
from pytorch_wavenet_tpu.parallel.pipeline import (
    generate_pipelined as jax_pipelined, make_pipeline_mesh as jax_pipe_mesh)
from pytorch_wavenet_tpu.parallel.time_sharding import (time_sharded_logits,
                                                        time_sharded_loss)
from pytorch_wavenet_tpu_torch.parallel.pipeline import group_generator

TOL = dict(atol=1e-5, rtol=1e-5)
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("time_pipe"))
    cases.spawn("tp", 2, d)
    cases.spawn("tp", 4, d)
    return d


def _time_jax(n):
    cfg = wt.get_config("tiny", kernel_size=3)
    p = jax.tree.map(jnp.asarray, cases.params_of(
        cases.config("tiny", kernel_size=3), seed=4))
    x, t = (jnp.asarray(a) for a in cases.time_inputs(cfg))
    mesh = jax_mesh(n, 1, devices=jax.devices()[:n])
    rf, T = cfg.receptive_field, x.shape[1]

    def ref_loss(p):
        logits = wt.wavenet_logits(p, cfg, x, out_len=T)
        valid = (jnp.arange(T)[None, :] >= rf - 1).astype(jnp.float32)
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, t[..., None], axis=-1)[..., 0]
        return jnp.sum(nll * valid) / (jnp.sum(valid) * x.shape[0])

    # jitted: an eager shard_map runs op by op (about 20 s here)
    l_sh, g_sh = jax.jit(jax.value_and_grad(
        lambda p: time_sharded_loss(p, cfg, x, t, mesh)))(p)
    l_ref, g_ref = jax.jit(jax.value_and_grad(ref_loss))(p)
    logits = jax.jit(lambda p: time_sharded_logits(p, cfg, x, mesh))(p)
    return {
        "sharded": (np.asarray(logits),
                    np.asarray(l_sh), cases.flat(jax.tree.map(np.asarray,
                                                              g_sh))),
        "unsharded": (np.asarray(wt.wavenet_logits(p, cfg, x, out_len=T)),
                      np.asarray(l_ref), cases.flat(jax.tree.map(
                          np.asarray, g_ref))),
    }


@pytest.mark.parametrize("n", [2, 4])
def test_time_sharded_equals_jax(runs, n):
    got = cases.load(runs, f"time{n}")
    for which, (logits, loss, grads) in _time_jax(n).items():
        np.testing.assert_allclose(got["logits"], logits, **TOL,
                                   err_msg=which)
        np.testing.assert_allclose(got["loss"], loss, **TOL, err_msg=which)
        for k, g in grads.items():
            np.testing.assert_allclose(got["grads/" + k], g, **TOL,
                                       err_msg=f"{which} {k}")


@pytest.mark.parametrize("n", [2, 4])
def test_time_sharded_refusals(runs, n):
    got = cases.load(runs, f"time{n}", n - 1)
    assert "not divisible" in str(got["refused/divisible"])
    assert "halo" in str(got["refused/halo"])
    assert "receptive field" in str(got["refused/receptive"])


def _groups(params, cfg, n_stages, prime, n, seed=None, **kw):
    """Each group's ``generate_fast``, concatenated."""
    S = prime.shape[0]
    Sg = S // n_stages
    outs = []
    for g in range(n_stages):
        kw_g = dict(kw)
        if "global_cond" in kw:
            kw_g["global_cond"] = kw["global_cond"][g * Sg:(g + 1) * Sg]
        gen = None if seed is None else group_generator(seed, g)
        outs.append(pt.generate_fast(params, cfg, gen, n,
                                     prime[g * Sg:(g + 1) * Sg],
                                     device="cpu", **kw_g)[1].numpy())
    return np.concatenate(outs)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_equals_generate_fast_per_group(runs, n_stages):
    got = cases.load(runs, f"pipe{n_stages}", n_stages - 1)
    cfg = cases.pipe_configs()[n_stages]
    params = pt.from_jax_params(cases.params_of(cfg, scale=cases.PIPE_SCALE), "cpu")
    S = 2 * n_stages
    prime = cases.pipe_prime(cfg, S)
    np.testing.assert_array_equal(got["T0"], _groups(
        params, cfg, n_stages, prime, cases.PIPE_N, temperature=0.0))
    np.testing.assert_array_equal(got["T1"], _groups(
        params, cfg, n_stages, prime, 16, seed=10, temperature=1.0,
        regularize=0.01))
    mid = np.full((n_stages, 1), cfg.classes // 2)
    np.testing.assert_array_equal(got["default"], _groups(
        params, cfg, n_stages, mid, 8, temperature=0.0))
    np.testing.assert_array_equal(got["short"], _groups(
        params, cfg, n_stages, cases.pipe_prime(cfg, S, 15, 3), 8,
        temperature=0.0))
    gcfg = cases.config("tiny", gcond_channels=4, blocks=cfg.blocks)
    gp = pt.from_jax_params(cases.params_of(
        gcfg, seed=1, scale=cases.PIPE_SCALE), "cpu")
    gc = 5 * np.random.default_rng(12).normal(size=(S, 4)).astype(
        np.float32)
    want = _groups(gp, gcfg, n_stages, prime, 12, temperature=0.0,
                   global_cond=gc)
    np.testing.assert_array_equal(got["gcond"], want)
    assert not np.array_equal(want, _groups(gp, gcfg, n_stages, prime, 12,
                                            temperature=0.0))


def _held_off_near_ties(params, cfg, prime, got, want):
    """Each stream's classes equal up to its first difference, which must
    fall where the port's logits have a top-2 gap below NEAR_TIE."""
    for s in range(got.shape[0]):
        diff = np.nonzero(got[s] != want[s])[0]
        if not len(diff):
            continue
        t = diff[0]
        seq = np.concatenate([prime[s], got[s, :t]])
        with torch.no_grad():
            lg = pt.wavenet_logits(params, cfg, torch.from_numpy(seq[None]),
                                   out_len=1)[0, -1]
        top2 = torch.topk(lg, 2).values
        assert float(top2[0] - top2[1]) < NEAR_TIE, (s, t)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_equals_jax_off_near_ties(runs, n_stages):
    got = cases.load(runs, f"pipe{n_stages}")
    cfg = cases.pipe_configs()[n_stages]
    npp = cases.params_of(cfg, scale=cases.PIPE_SCALE)
    prime = cases.pipe_prime(cfg, 2 * n_stages)
    jcfg = wt.get_config("tiny", blocks=cfg.blocks)
    _, want = jax_pipelined(jax.tree.map(jnp.asarray, npp), jcfg,
                            jax_pipe_mesh(n_stages), jax.random.PRNGKey(8),
                            cases.PIPE_N, jnp.asarray(prime, jnp.int32),
                            temperature=0.0)
    _held_off_near_ties(pt.from_jax_params(npp, "cpu"), cfg, prime,
                        got["T0"], np.asarray(want))


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_refusals(runs, n_stages):
    got = cases.load(runs, f"pipe{n_stages}")
    assert "stages" in str(got["refused/stages"])
    assert "groups" in str(got["refused/groups"])
    assert "gcond_channels == 0" in str(got["refused/gcond"])
