"""The window API and speculative decoding of the port against the JAX
package: ``gen_step_window`` + ``commit_window`` against JAX's and against
chained ``gen_step`` calls, ``generate_fast(window_prime=True)``, and
``speculative_generate`` against JAX's ``generate_fast(temperature=0)`` and
JAX's own ``speculative_generate``.

Tolerances: f32 at atol = rtol = 1e-5 (the port's rule). Speculation's
classes are held off near-ties: a class may differ from the reference only
where the reference's top-2 logit gap is below NEAR_TIE (the verify pass's
``(k, R)`` products round unlike a step's ``(1, R)`` ones), and the flips
are counted."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.models import generate as jg
from pytorch_wavenet_tpu.models.speculative import (
    speculative_generate as j_speculative)
from pytorch_wavenet_tpu_torch.models import generate as tg
from pytorch_wavenet_tpu_torch.models import speculative as ts

TOL = dict(atol=1e-5, rtol=1e-5)
NEAR_TIE = 1e-4


def _np_params(cfg, seed):
    shapes = jax.eval_shape(lambda: wt.init_wavenet(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32), shapes)


def _both(name, seed, **kw):
    cfgj, cfgt = wt.get_config(name, **kw), pt.get_config(name, **kw)
    npp = _np_params(cfgj, seed)
    return (cfgj, jax.tree.map(jnp.asarray, npp), cfgt,
            pt.from_jax_params(npp, "cpu"))


@pytest.fixture(scope="module")
def tiny():
    return _both("tiny", 0)


@pytest.fixture(scope="module")
def draft():
    return _both("tiny", 7, layers=2)


def _roll_both(tiny, streams, n, seed):
    """JAX and port states after the same ``n`` random steps."""
    cfgj, jp, cfgt, tp = tiny
    hist = np.random.default_rng(seed).integers(0, cfgj.classes, (streams, n))
    js = jg.init_gen_state(cfgj, streams)
    ts_ = tg.init_gen_state(cfgt, streams, device="cpu")
    for i in range(n):
        _, js = jg.gen_step(jp, cfgj, js, jnp.asarray(hist[:, i], jnp.int32))
        _, ts_ = tg.gen_step(tp, cfgt, ts_, torch.from_numpy(hist[:, i]))
    return js, ts_


def _clone(state):
    return tg.GenState(tuple(b.clone() for b in state.buffers), state.t)


def _sequential(tp, cfg, state, window, cond=None, gcond=None):
    logits = []
    for i in range(window.shape[1]):
        lg, state = tg.gen_step(tp, cfg, state, window[:, i],
                                None if cond is None else cond[:, i], gcond)
        logits.append(lg)
    return (torch.stack(logits, dim=1) if logits else None), state


def _assert_rings(ts_, js):
    assert ts_.t == int(js.t)
    for bt, bj in zip(ts_.buffers, js.buffers):
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), **TOL)


@pytest.mark.parametrize("win", [1, 3, 8, 20])
def test_window_matches_jax_and_sequential_steps(tiny, win):
    """One window pass == JAX's window == ``win`` chained steps: logits, and
    rings after commit_window (a window of 20 writes a dilation-1 ring's two
    slots ten times each: the last write must win)."""
    cfgj, jp, cfgt, tp = tiny
    js, ts_ = _roll_both(tiny, 2, 5, 1)
    window = np.random.default_rng(2).integers(0, cfgj.classes, (2, win))
    lj, pj = jg.gen_step_window(jp, cfgj, js, jnp.asarray(window, jnp.int32))
    before = [b.clone() for b in ts_.buffers]
    lt, pend = tg.gen_step_window(tp, cfgt, ts_, torch.from_numpy(window))
    assert all(torch.equal(a, b) for a, b in zip(before, ts_.buffers)), \
        "gen_step_window wrote the rings"
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert lt.shape == (2, win, cfgt.classes) and pend.t == 5
    want_logits, want = _sequential(tp, cfgt, _clone(ts_),
                                    torch.from_numpy(window))
    np.testing.assert_allclose(lt.numpy(), want_logits.numpy(), **TOL)
    got = tg.commit_window(ts_, pend, win)
    _assert_rings(got, jg.commit_window(js, pj, win))
    assert got.t == want.t == 5 + win
    for a, b in zip(got.buffers, want.buffers):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_window_from_an_empty_state(tiny):
    cfgj, jp, cfgt, tp = tiny
    window = np.random.default_rng(3).integers(0, cfgj.classes, (1, 6))
    js = jg.init_gen_state(cfgj, 1)
    ts_ = tg.init_gen_state(cfgt, 1, device="cpu")
    lj, pj = jg.gen_step_window(jp, cfgj, js, jnp.asarray(window, jnp.int32))
    lt, pend = tg.gen_step_window(tp, cfgt, ts_, torch.from_numpy(window))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_rings(tg.commit_window(ts_, pend, 6), jg.commit_window(js, pj, 6))


@pytest.mark.parametrize("valid", [0, 1, 3, 7, 8])
def test_partial_commit_matches_jax(tiny, valid):
    """commit_window(v) == JAX's == consuming the first v inputs, with a
    0-d tensor for ``valid``; stepping on from it matches the sequential
    path."""
    cfgj, jp, cfgt, tp = tiny
    js, ts_ = _roll_both(tiny, 1, 9, 4)
    window = np.random.default_rng(5).integers(0, cfgj.classes, (1, 8))
    _, pj = jg.gen_step_window(jp, cfgj, js, jnp.asarray(window, jnp.int32))
    _, pend = tg.gen_step_window(tp, cfgt, ts_, torch.from_numpy(window))
    _, want = _sequential(tp, cfgt, _clone(ts_),
                          torch.from_numpy(window[:, :valid]))
    got = tg.commit_window(ts_, pend, torch.tensor(valid))
    _assert_rings(got, jg.commit_window(js, pj, valid))
    assert got.t == want.t == 9 + valid
    for a, b in zip(got.buffers, want.buffers):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    nxt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfgj.classes, (1, 4)))
    gl, _ = tg.gen_step_window(tp, cfgt, got, nxt)
    wl, _ = _sequential(tp, cfgt, want, nxt)
    np.testing.assert_allclose(gl.numpy(), wl.numpy(), **TOL)
    with pytest.raises(ValueError, match="valid must be"):
        tg.commit_window(got, pend, 9)


def test_conditioned_window_matches_jax(tiny):
    """cond rows per position (5 channels) and a global cond (3) broadcast
    over the window."""
    cfgj, jp, cfgt, tp = _both("tiny", 20, cond_channels=5,
                               gcond_channels=3)
    rng = np.random.default_rng(21)
    win = 7
    window = rng.integers(0, cfgj.classes, (2, win))
    cond = (0.4 * rng.standard_normal((2, win, 5))).astype(np.float32)
    g = rng.standard_normal((2, 3)).astype(np.float32)
    js = jg.init_gen_state(cfgj, 2)
    ts_ = tg.init_gen_state(cfgt, 2, device="cpu")
    lj, pj = jg.gen_step_window(jp, cfgj, js, jnp.asarray(window, jnp.int32),
                                cond=jnp.asarray(cond),
                                global_cond=jnp.asarray(g))
    lt, pend = tg.gen_step_window(tp, cfgt, ts_, torch.from_numpy(window),
                                  cond=torch.from_numpy(cond),
                                  global_cond=torch.from_numpy(g))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    want_logits, want = _sequential(
        tp, cfgt, _clone(ts_), torch.from_numpy(window),
        torch.from_numpy(cond), torch.from_numpy(g))
    np.testing.assert_allclose(lt.numpy(), want_logits.numpy(), **TOL)
    got = tg.commit_window(ts_, pend, win)
    _assert_rings(got, jg.commit_window(js, pj, win))
    for a, b in zip(got.buffers, want.buffers):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def _gaps(tp, cfg, prime, cls):
    """Top-2 logit gap of the teacher at every emitted position, on the
    emitted history (teacher-forced)."""
    full = torch.cat([torch.as_tensor(prime), cls[:, :-1]], dim=1)
    logits = pt.wavenet_logits(tp, cfg, full, out_len=cls.shape[1])
    top = torch.topk(logits, 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).numpy(), logits.argmax(-1).numpy()


def _held_off_near_ties(got, want, gaps):
    """Classes equal up to the first mismatch, which must sit at a near-tie
    (the rollouts part there); returns the flip count (0 or 1)."""
    got, want = np.asarray(got), np.asarray(want)
    off = np.flatnonzero(got[0] != want[0])
    if off.size == 0:
        return 0
    assert gaps[0, off[0]] < NEAR_TIE, (off[0], gaps[0, off[0]])
    return 1


def test_window_prime_matches_jax_and_the_stepwise_prime(tiny):
    cfgj, jp, cfgt, tp = tiny
    rng = np.random.default_rng(30)
    prime = rng.integers(0, cfgj.classes, (2, cfgj.receptive_field + 200))
    n = 40
    _, cj = wt.generate_fast(jp, cfgj, jax.random.PRNGKey(31), n,
                             jnp.asarray(prime, jnp.int32), temperature=0.0,
                             window_prime=True)
    _, ct, st = pt.generate_fast(tp, cfgt, None, n, prime, temperature=0.0,
                                 window_prime=True, return_state=True,
                                 device="cpu")
    _, cs = pt.generate_fast(tp, cfgt, None, n, prime, temperature=0.0,
                             device="cpu")
    flips = 0
    for s in range(2):
        gaps, _ = _gaps(tp, cfgt, prime[s:s + 1], ct[s:s + 1])
        flips += _held_off_near_ties(ct[s:s + 1], np.asarray(cj)[s:s + 1],
                                     gaps)
        flips += _held_off_near_ties(ct[s:s + 1], cs[s:s + 1], gaps)
    assert flips == 0, f"{flips} near-tie flips at this seed"
    # the rollout streams on from the window-primed state
    _, c2 = pt.generate_fast(tp, cfgt, None, 10, None, temperature=0.0,
                             state=st, device="cpu")
    _, c_all = pt.generate_fast(tp, cfgt, None, n + 10, prime,
                                temperature=0.0, device="cpu")
    assert torch.equal(torch.cat([ct, c2], dim=1), c_all)


def test_window_prime_conditioned_matches_stepwise(tiny):
    """The prime's cond rows are sliced per window, the rest of the
    timeline goes to the rollout."""
    cfgj, jp, cfgt, tp = _both("tiny", 40, cond_channels=5)
    rng = np.random.default_rng(41)
    prime = rng.integers(0, cfgj.classes, (1, 150))
    n = 12
    cond = (0.4 * rng.standard_normal((1, 149 + n, 5))).astype(np.float32)
    _, cj = wt.generate_fast(jp, cfgj, jax.random.PRNGKey(0), n,
                             jnp.asarray(prime, jnp.int32), temperature=0.0,
                             cond=jnp.asarray(cond), window_prime=True)
    _, ct = pt.generate_fast(tp, cfgt, None, n, prime, temperature=0.0,
                             cond=torch.from_numpy(cond), window_prime=True,
                             device="cpu")
    _, cs = pt.generate_fast(tp, cfgt, None, n, prime, temperature=0.0,
                             cond=torch.from_numpy(cond), device="cpu")
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert torch.equal(ct, cs)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_speculation_matches_jax(tiny, draft, k):
    """An unrelated draft: the classes are JAX's generate_fast(T=0) and
    JAX's speculation's off near-ties, the accept rate JAX's, and every
    class the teacher's argmax on the emitted history."""
    cfgj, jp, cfgt, tp = tiny
    dcj, dpj, dct, dpt = draft
    prime = np.random.default_rng(8).integers(
        0, cfgj.classes, (1, cfgj.receptive_field))
    n = 40
    w_fast, c_fast = wt.generate_fast(jp, cfgj, jax.random.PRNGKey(9), n,
                                      jnp.asarray(prime, jnp.int32),
                                      temperature=0.0)
    _, c_js, rate_j = j_speculative(jp, cfgj, dpj, dcj,
                                    jax.random.PRNGKey(9), n,
                                    jnp.asarray(prime, jnp.int32), k=k)
    ts.host_syncs = 0
    wav, cls, rate = pt.speculative_generate(tp, cfgt, dpt, dct, None, n,
                                             prime, k=k, device="cpu")
    assert cls.shape == wav.shape == (1, n) and cls.dtype == torch.long
    gaps, targmax = _gaps(tp, cfgt, prime, cls)
    near = gaps < NEAR_TIE
    assert np.all((cls.numpy() == targmax) | near)
    flips = (_held_off_near_ties(cls, c_fast, gaps)
             + _held_off_near_ties(cls, c_js, gaps))
    assert flips == 0, f"{flips} near-tie flips at this seed"
    assert rate == pytest.approx(float(rate_j), rel=1e-6)
    assert 1.0 <= rate <= k
    # one host read per verify pass: passes x rate = emitted, n .. n+k-1
    assert n <= rate * ts.host_syncs + 1e-6 < n + k
    np.testing.assert_allclose(wav.numpy(), np.asarray(w_fast), **TOL)


def test_perfect_draft_accepts_k(tiny):
    cfgj, jp, cfgt, tp = tiny
    prime = np.random.default_rng(10).integers(
        0, cfgj.classes, (1, cfgj.receptive_field))
    k = 6
    _, cls, rate = pt.speculative_generate(tp, cfgt, tp, cfgt, None, 24,
                                           prime, k=k, device="cpu")
    _, c_fast = pt.generate_fast(tp, cfgt, None, 24, prime, temperature=0.0,
                                 device="cpu")
    gaps, _ = _gaps(tp, cfgt, prime, cls)
    assert _held_off_near_ties(cls, c_fast, gaps) == 0
    assert rate == k


@pytest.mark.parametrize("accepted", [1, 3, 5])
def test_draft_commit_equals_sequential_steps_bitwise(draft, accepted):
    """Speculation's draft bookkeeping: k steps on a copy of the rings with
    their layer inputs recorded, then ``commit_window`` of the first
    ``accepted`` into the rings, equals ``accepted`` sequential steps
    bitwise (a dilation-1 ring of 2 slots takes several of them)."""
    _, _, dct, dpt = draft
    rng = np.random.default_rng(11)
    state = tg.init_gen_state(dct, 1, device="cpu")
    for c in rng.integers(0, dct.classes, 6):
        _, state = tg.gen_step(dpt, dct, state, torch.tensor([int(c)]))
    k = 5
    inputs = torch.from_numpy(rng.integers(0, dct.classes, (1, k)))
    want = _clone(state)
    for i in range(accepted):
        _, want = tg.gen_step(dpt, dct, want, inputs[:, i])
    work, records = _clone(state), []
    for i in range(k):
        rec = []
        _, work = tg.gen_step(dpt, dct, work, inputs[:, i], record=rec)
        records.append(rec)
    h_wins = tuple(torch.stack([r[l] for r in records], dim=1)
                   for l in range(dct.num_layers))
    got = tg.commit_window(state, tg.PendingWindow(h_wins, state.t),
                           accepted)
    assert got.t == want.t
    for a, b in zip(got.buffers, want.buffers):
        assert torch.equal(a, b)


def test_default_prime_and_refusals(tiny, draft):
    cfgj, jp, cfgt, tp = tiny
    dcj, dpj, dct, dpt = draft
    _, cls, _ = pt.speculative_generate(tp, cfgt, dpt, dct, None, 10, k=4,
                                        device="cpu")
    _, c_js, _ = j_speculative(jp, cfgj, dpj, dcj, jax.random.PRNGKey(0),
                               10, k=4)
    gaps, _ = _gaps(tp, cfgt, [[cfgt.classes // 2]], cls)
    assert _held_off_near_ties(cls, c_js, gaps) == 0
    with pytest.raises(ValueError, match="single-stream"):
        pt.speculative_generate(tp, cfgt, dpt, dct, None, 4,
                                np.zeros((2, 3), np.int64), device="cpu")
    with pytest.raises(ValueError, match="k must be"):
        pt.speculative_generate(tp, cfgt, dpt, dct, None, 4, k=0,
                                device="cpu")
    other = pt.get_config("tiny", classes=64)
    with pytest.raises(ValueError, match="codebook"):
        pt.speculative_generate(tp, cfgt, tp, other, None, 4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pt.speculative_generate(tp, cfgt, dpt, dct, None, 4)
