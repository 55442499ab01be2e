"""``generate_long``, per-stream temperature and ``progress_callback`` in
the port, on the CPU at the ``tiny`` preset (``tiny_vocoder`` for cond).

Against the JAX package at temperature 0: ``generate_long`` in both
streaming modes (classes and progress calls equal), ``generate_fast`` with
a temperature array (its 0-temperature streams equal JAX's argmax
rollout), and ``progress_callback`` with cond. Within the port, bitwise: a
chunked rollout equals its single shot on every backend (the plain
``generate_fast`` and K1's and K4's plain versions, which run on the CPU)
at temperature 0 and 0.9, and a progress callback changes no output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt


def _np_params(cfg, seed):
    shapes = jax.eval_shape(lambda: wt.init_wavenet(jax.random.PRNGKey(0),
                                                    cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32), shapes)


def _pair(name, seed=0):
    cfgj, cfgt = wt.get_config(name), pt.get_config(name)
    npp = _np_params(cfgj, seed)
    return (cfgj, jax.tree.map(jnp.asarray, npp), cfgt,
            pt.from_jax_params(npp, "cpu"))


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny")


def _prime(cfg, streams, length, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.classes,
                                                (streams, length))


@pytest.mark.parametrize("streaming", [True, False])
def test_generate_long_matches_jax(tiny, streaming):
    cfgj, jp, cfgt, tp = tiny
    prime = _prime(cfgj, 2, 5)
    calls_j, calls_t = [], []
    _, cj = wt.generate_long(
        jp, cfgj, jax.random.PRNGKey(0), 50, jnp.asarray(prime, jnp.int32),
        temperature=0.0, chunk_size=cfgj.receptive_field + 3,
        progress_callback=lambda d, t: calls_j.append((d, t)),
        streaming=streaming)
    wav, ct = pt.generate_long(
        tp, cfgt, None, 50, prime, temperature=0.0,
        chunk_size=cfgt.receptive_field + 3,
        progress_callback=lambda d, t: calls_t.append((d, t)),
        streaming=streaming, device="cpu")
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert calls_t == calls_j == [(18, 50), (36, 50), (50, 50)]
    np.testing.assert_allclose(
        wav.numpy(), pt.ops.mulaw.mu_law_expansion(
            (ct.numpy() / cfgt.classes) * 2.0 - 1.0, cfgt.classes),
        atol=1e-6)


def _single_and_long(tp, cfg, backend, seed, n, prime, temperature, chunk,
                     **kw):
    noise = (torch.Generator().manual_seed(seed)
             if backend is pt.generate_fast else seed)
    _, one = backend(tp, cfg, noise, n, prime, temperature=temperature,
                     device="cpu", **kw)
    calls = []
    _, chunked = pt.generate_long(
        tp, cfg, seed, n, prime, temperature=temperature, chunk_size=chunk,
        backend=backend, progress_callback=lambda d, t: calls.append(d),
        device="cpu", **kw)
    return one, chunked, calls


@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("backend,kw", [
    ("plain", {}),
    ("k1", dict(fuse_res=True)),
    ("k4", dict(fuse_res=True, skip_slab=True)),
])
def test_streamed_equals_single_shot(tiny, backend, kw, temperature):
    _, _, cfg, tp = tiny
    fn = {"plain": pt.generate_fast, "k1": pt.generate_fast_fused,
          "k4": pt.generate_fast_batched}[backend]
    prime = _prime(cfg, 3, 4, seed=7)
    one, chunked, calls = _single_and_long(tp, cfg, fn, 5, 61, prime,
                                           temperature, 20)
    assert torch.equal(chunked, one)
    assert calls == [20, 40, 60, 61]


def test_generator_carries_across_chunks(tiny):
    _, _, cfg, tp = tiny
    one = pt.generate_fast(tp, cfg, torch.Generator().manual_seed(3), 40,
                           temperature=1.0, device="cpu")[1]
    long_ = pt.generate_long(tp, cfg, torch.Generator().manual_seed(3), 40,
                             temperature=1.0, chunk_size=16, device="cpu")[1]
    assert torch.equal(long_, one)
    # None is the single call's default stream
    assert torch.equal(
        pt.generate_long(tp, cfg, None, 40, temperature=1.0, chunk_size=16,
                         device="cpu")[1],
        pt.generate_fast(tp, cfg, None, 40, temperature=1.0,
                         device="cpu")[1])


def test_chunk_size_must_exceed_rf(tiny):
    cfgj, jp, cfgt, tp = tiny
    rf = cfgt.receptive_field
    with pytest.raises(ValueError, match="must exceed rf"):
        pt.generate_long(tp, cfgt, None, 40, chunk_size=rf, device="cpu")
    with pytest.raises(ValueError, match="must exceed rf"):
        wt.generate_long(jp, cfgj, jax.random.PRNGKey(0), 40, chunk_size=rf)
    pt.generate_long(tp, cfgt, None, 4, chunk_size=rf + 1, device="cpu")


def test_per_stream_temperature(tiny):
    cfgj, jp, cfgt, tp = tiny
    prime = _prime(cfgj, 4, 6, seed=9)
    temps = [0.0, 0.9, 0.0, 1.0]
    _, cj = wt.generate_fast(jp, cfgj, jax.random.PRNGKey(1), 40,
                             jnp.asarray(prime, jnp.int32),
                             temperature=jnp.asarray(temps, jnp.float32))
    _, cj0 = wt.generate_fast(jp, cfgj, jax.random.PRNGKey(1), 40,
                              jnp.asarray(prime, jnp.int32), temperature=0.0)
    _, ct = pt.generate_fast(tp, cfgt, torch.Generator().manual_seed(1), 40,
                             prime, temperature=torch.tensor(temps),
                             device="cpu")
    _, ct0 = pt.generate_fast(tp, cfgt, None, 40, prime, temperature=0.0,
                              device="cpu")
    cold = [0, 2]
    np.testing.assert_array_equal(np.asarray(cj)[cold], np.asarray(cj0)[cold])
    np.testing.assert_array_equal(ct.numpy()[cold], np.asarray(cj)[cold])
    assert torch.equal(ct[cold], ct0[cold])
    hot = ct[[1, 3]]
    assert ((hot >= 0) & (hot < cfgt.classes)).all()
    assert not torch.equal(hot, ct0[[1, 3]])
    # the hot streams draw what the scalar rollout at their temperature
    # draws from the same uniforms
    _, ct9 = pt.generate_fast(tp, cfgt, torch.Generator().manual_seed(1), 40,
                              prime, temperature=0.9, device="cpu")
    assert torch.equal(ct[1], ct9[1])
    with pytest.raises(ValueError, match="temperature"):
        pt.generate_fast(tp, cfgt, None, 4, prime,
                         temperature=torch.tensor([0.0, 1.0]), device="cpu")


@pytest.mark.parametrize("cond", [False, True])
def test_progress_callback_is_bitwise_free(cond):
    cfgj, jp, cfgt, tp = _pair("tiny_vocoder" if cond else "tiny", seed=4)
    prime = _prime(cfgt, 2, 3, seed=3)
    n = 45
    c = None
    if cond:
        c = np.random.default_rng(8).normal(
            0, 0.5, (2, prime.shape[1] - 1 + n, cfgt.cond_channels)
        ).astype(np.float32)

    def port(temperature, **kw):
        return pt.generate_fast(tp, cfgt, torch.Generator().manual_seed(6), n,
                                prime, temperature=temperature, cond=c,
                                device="cpu", **kw)

    for temperature in (0.0, 1.0):
        calls = []
        w_cb, c_cb = port(temperature, progress_interval=10,
                          progress_callback=lambda d, t: calls.append((d, t)))
        w, cls = port(temperature)
        assert torch.equal(c_cb, cls) and torch.equal(w_cb, w)
        assert calls == [(10, n), (20, n), (30, n), (40, n), (45, n)]
    # at temperature 0, against the JAX package's chunked rollout
    jcalls = []
    _, cj = wt.generate_fast(
        jp, cfgj, jax.random.PRNGKey(0), n, jnp.asarray(prime, jnp.int32),
        temperature=0.0, cond=None if c is None else jnp.asarray(c),
        progress_callback=lambda d, t: jcalls.append((d, t)),
        progress_interval=10)
    np.testing.assert_array_equal(port(0.0)[1].numpy(), np.asarray(cj))
    assert jcalls == calls
    # a state handed back by a chunked call continues the rollout
    _, c1, st = port(0.0, return_state=True, progress_interval=10,
                     progress_callback=lambda d, t: None)
    assert st.gen.t == prime.shape[1] - 1 + n
    assert torch.equal(c1, port(0.0)[1])
