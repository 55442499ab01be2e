"""Fast-WaveNet generation in the port: per-step logits against the JAX
``gen_step``, argmax rollouts against the JAX ``generate_fast``, and the
oracle chain naive == fast == teacher-forced inside the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.models import generate as jg
from pytorch_wavenet_tpu_torch.models import generate as tg

TOL = dict(atol=1e-5, rtol=1e-5)


def _np_params(cfg, seed):
    shapes = jax.eval_shape(lambda: wt.init_wavenet(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def tiny():
    cfgj, cfgt = wt.get_config("tiny"), pt.get_config("tiny")
    npp = _np_params(cfgj, 0)
    return (cfgj, jax.tree.map(jnp.asarray, npp), cfgt,
            pt.from_jax_params(npp, "cpu"))


def _prime(cfg, streams, seed, length=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.classes,
                        (streams, length or cfg.receptive_field))


def test_gen_step_logits_match_jax_with_wraparound(tiny):
    cfgj, jp, cfgt, tp = tiny
    n = 2 * tg.buffer_length(cfgt) + 5
    seq = np.random.default_rng(1).integers(0, cfgj.classes, (2, n))
    js = jg.init_gen_state(cfgj, 2)
    ts = tg.init_gen_state(cfgt, 2, device="cpu")
    for i in range(n):
        lj, js = jg.gen_step(jp, cfgj, js, jnp.asarray(seq[:, i], jnp.int32))
        lt, ts = tg.gen_step(tp, cfgt, ts, torch.from_numpy(seq[:, i]))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for bj, bt in zip(js.buffers, ts.buffers):
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), **TOL)
    assert ts.t == int(js.t) == n


@pytest.mark.parametrize("prime_len,regularize", [
    (None, 0.0), (3, 0.0), (None, 0.05), (0, 0.0),
])
def test_generate_fast_argmax_matches_jax(tiny, prime_len, regularize):
    cfgj, jp, cfgt, tp = tiny
    prime = None if prime_len == 0 else _prime(cfgj, 2, 2, prime_len)
    _, cj = wt.generate_fast(
        jp, cfgj, jax.random.PRNGKey(0), 40,
        None if prime is None else jnp.asarray(prime, jnp.int32),
        temperature=0.0, regularize=regularize)
    _, ct = pt.generate_fast(tp, cfgt, None, 40, prime, temperature=0.0,
                             regularize=regularize, device="cpu")
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_oracle_chain_naive_fast_teacher_forced(tiny):
    _, _, cfg, tp = tiny
    prime = torch.from_numpy(_prime(cfg, 2, 3))
    n = 32
    _, cf = pt.generate_fast(tp, cfg, None, n, prime, temperature=0.0,
                             device="cpu")
    _, cn = pt.generate(tp, cfg, None, n, prime, temperature=0.0,
                        device="cpu")
    assert torch.equal(cf, cn)
    full = torch.cat([prime, cf[:, :-1]], dim=1)
    tf = pt.wavenet_logits(tp, cfg, full, out_len=n).argmax(dim=-1)
    assert torch.equal(tf, cf)


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_chunked_stream_state_equals_one_shot(tiny, temperature):
    _, _, cfg, tp = tiny
    prime = _prime(cfg, 2, 4)

    def gen():
        return torch.Generator().manual_seed(11)

    w_all, c_all = pt.generate_fast(tp, cfg, gen(), 50, prime,
                                    temperature=temperature, device="cpu")
    g = gen()
    _, c1, st = pt.generate_fast(tp, cfg, g, 20, prime,
                                 temperature=temperature, return_state=True,
                                 device="cpu")
    _, c2, st2 = pt.generate_fast(tp, cfg, g, 18, None, state=st,
                                  temperature=temperature,
                                  return_state=True, device="cpu")
    w3, c3 = pt.generate_fast(tp, cfg, g, 12, None, state=st2,
                              temperature=temperature, device="cpu")
    assert torch.equal(torch.cat([c1, c2, c3], dim=1), c_all)
    assert torch.equal(w3, w_all[:, -12:])
    assert st2.gen.t == cfg.receptive_field - 1 + 38
    # passing a state back leaves it as it was
    _, again = pt.generate_fast(tp, cfg, None, 12, None, state=st2,
                                temperature=0.0, device="cpu")
    _, again2 = pt.generate_fast(tp, cfg, None, 12, None, state=st2,
                                 temperature=0.0, device="cpu")
    assert torch.equal(again, again2)


def test_state_and_prime_together_rejected(tiny):
    _, _, cfg, tp = tiny
    _, _, st = pt.generate_fast(tp, cfg, None, 2, temperature=0.0,
                                return_state=True, device="cpu")
    with pytest.raises(ValueError):
        pt.generate_fast(tp, cfg, None, 2, [1, 2], state=st, device="cpu")


def test_waveform_is_mu_law_expansion_of_classes(tiny):
    _, _, cfg, tp = tiny
    wav, cls = pt.generate_fast(tp, cfg, torch.Generator().manual_seed(0),
                                16, temperature=1.0, device="cpu")
    expect = pt.ops.mulaw.mu_law_expansion(
        (cls.numpy() / cfg.classes) * 2.0 - 1.0, cfg.classes)
    np.testing.assert_allclose(wav.numpy(), expect, atol=1e-6)


def test_sampling_follows_the_softmax():
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0]])
    u = torch.rand((20000, 1), generator=torch.Generator().manual_seed(0))
    draws = tg._sample(logits.expand(20000, 4), u[:, 0], 4, 1.0, 0.0)
    freq = torch.bincount(draws, minlength=4).double() / 20000
    np.testing.assert_allclose(freq.numpy(),
                               torch.softmax(logits[0], 0).numpy(), atol=0.015)
