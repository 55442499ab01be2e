"""The mel-conditioned vocoder in the port against the JAX package: log-mel
features and upsamplers (``ops/mel.py``), the conditioned trunk, the
conditioned ``gen_step``, ``generate_fast``, ``generate`` and
``synthesize``. Weights come from the JAX package's ``init_wavenet`` and
cross with ``from_jax_params``; inputs from numpy seeds. f32 values are
held to atol = rtol = 1e-5 (JAX's CPU f32 products are full f32), argmax
rollouts class for class."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.models import generate as jg
from pytorch_wavenet_tpu.ops import mel as jmel
from pytorch_wavenet_tpu_torch.models import generate as tg
from pytorch_wavenet_tpu_torch.ops import mel as tmel

TOL = dict(atol=1e-5, rtol=1e-5)


def _models(name="tiny", **over):
    cfgj = wt.get_config(name, **over)
    cfgt = pt.get_config(name, **over)
    jp = wt.init_wavenet(jax.random.PRNGKey(0), cfgj)
    return cfgj, jp, cfgt, pt.from_jax_params(jax.tree.map(np.asarray, jp),
                                              "cpu")


def _normal(seed, shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ------------------------------------------------------------------ mel


def test_log_mel_spectrogram_matches_jax():
    t = np.arange(5000) / 16000.0
    wav = (0.4 * np.sin(2 * np.pi * 330 * t)
           + 0.1 * np.sin(2 * np.pi * 2000 * t)).astype(np.float32)
    batch = np.stack([wav, wav[::-1].copy()])
    for x, kw in ((wav, {}), (batch, dict(num_mels=8, n_fft=256,
                                          hop_length=64))):
        got = tmel.log_mel_spectrogram(x, **kw)
        np.testing.assert_array_equal(got, jmel.log_mel_spectrogram(x, **kw))
    assert tmel.log_mel_spectrogram(wav).shape == (1 + 5000 // 256, 80)
    np.testing.assert_array_equal(tmel.mel_filterbank(8, 256),
                                  jmel.mel_filterbank(8, 256))


@pytest.mark.parametrize("factors", [(12,), (3, 4), (2, 2, 3)])
def test_upsamplers_match_jax(factors):
    frames = _normal(7, (2, 9, 5), 1.0)
    want = np.asarray(jmel.upsample_frames(jnp.asarray(frames), 12, 100))
    got = tmel.upsample_frames(torch.from_numpy(frames), 12, 100).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tmel.upsample_frames_np(frames, 12, 100),
                               want, **TOL)
    up = tmel.linear_init_upsampler(factors, 5)
    got = tmel.upsample_frames_conv(
        {k: torch.from_numpy(v) for k, v in up.items()},
        torch.from_numpy(frames), factors, 100).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    rnd = {f"s{i}": _normal(20 + i, (2, r, 5, 5)) for i, r in
           enumerate(factors)}
    got = tmel.upsample_frames_conv(
        {k: torch.from_numpy(v) for k, v in rnd.items()},
        torch.from_numpy(frames), factors, 100).numpy()
    want = np.asarray(jmel.upsample_frames_conv(
        {k: jnp.asarray(v) for k, v in rnd.items()}, jnp.asarray(frames),
        factors, 100))
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError):
        tmel.upsample_frames_conv(
            {k: torch.from_numpy(v) for k, v in up.items()},
            torch.from_numpy(frames), factors, 109)


@pytest.mark.parametrize("tag", ["linear", "conv-lin-init", "conv-random"])
def test_expand_frames_window_chunk_invariant_and_matches_jax(tag):
    """Rows ``[off, off + count)`` expanded from a window of frames equal
    the same rows of a one-shot expansion bitwise (the pool ships frame
    windows), and the JAX function's."""
    hop, M, F = 8, 5, 40
    frames = _normal(7, (F, M), 1.0)
    total = F * hop
    factors = () if tag == "linear" else (2, 4)
    if tag == "conv-lin-init":
        up = tmel.linear_init_upsampler(factors, M)
    else:
        up = {"s0": _normal(8, (2, 2, M, M)), "s1": _normal(9, (2, 4, M, M))}
    tparams = {"cond_up": {k: torch.from_numpy(v) for k, v in up.items()}}
    jparams = {"cond_up": {k: jnp.asarray(v) for k, v in up.items()}}
    if not factors:
        tparams = jparams = None
    ext = np.concatenate(
        [frames, np.repeat(frames[-1:], len(factors) + 1, axis=0)])
    full = tmel.expand_frames_window(
        tparams, torch.from_numpy(ext)[None], hop,
        torch.zeros(1, dtype=torch.int32), total, factors)[0].numpy()
    jfull = np.asarray(jmel.expand_frames_window(
        jparams, jnp.asarray(ext)[None], hop, jnp.zeros(1, jnp.int32), total,
        factors))[0]
    np.testing.assert_allclose(full, jfull, **TOL)
    if not factors:
        np.testing.assert_array_equal(full, jfull)
    for off, count in [(0, 16), (3, 16), (13, 7), (hop - 1, 1), (250, 24),
                       (total - 24, 24)]:
        Fs = tmel.frames_window_len(count, hop, factors)
        fs = off // hop
        idx = np.minimum(fs + np.arange(Fs), F - 1)
        got = tmel.expand_frames_window(
            tparams, torch.from_numpy(frames[idx])[None], hop,
            torch.tensor([off - fs * hop]), count, factors)[0].numpy()
        np.testing.assert_array_equal(got, full[off:off + count],
                                      err_msg=f"{tag} off={off}")


# ---------------------------------------------------------------- model


def test_conditioned_init_and_round_trip():
    """The port's conditioned init has the JAX tree and count; params
    cross both ways with ``w_cond``, ``w_gcond`` and ``cond_up``."""
    over = dict(cond_upsample=(4, 4), gcond_channels=3)
    cfgj, jp, cfgt, tp = _models("tiny_vocoder", **over)
    own = pt.init_wavenet(cfgt, torch.Generator().manual_seed(0), "cpu")
    flat = {k: v for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert pt.parameter_count(own) == cfgt.parameter_count() \
        == wt.parameter_count(jp)
    assert own["layers"]["w_cond"].shape == (cfgt.num_layers, 8, 16)
    assert own["layers"]["w_gcond"].shape == (cfgt.num_layers, 3, 16)
    assert own["cond_up"]["s1"].shape == (2, 4, 8, 8)
    np.testing.assert_array_equal(own["cond_up"]["s0"].numpy(),
                                  np.asarray(jp["cond_up"]["s0"]))
    back = pt.to_numpy_params(tp)
    assert len(flat) == len(jax.tree.leaves(back))
    for path, v in flat.items():
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, np.asarray(v))
    twice = pt.from_jax_params(back, "cpu")
    for a, b in zip(jax.tree.leaves(pt.to_numpy_params(twice)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use", ["cond", "gcond", "both"])
def test_conditioned_logits_match_jax(use):
    cfgj, jp, cfgt, tp = _models("tiny", cond_channels=6, gcond_channels=3)
    N, T = 2, cfgj.item_length + 3
    x = np.random.default_rng(1).integers(0, cfgj.classes, (N, T))
    c = _normal(2, (N, T, 6)) if use != "gcond" else None
    g = _normal(3, (N, 3), 1.0) if use != "cond" else None
    yj = np.asarray(wt.wavenet_logits(
        jp, cfgj, jnp.asarray(x, jnp.int32), cfgj.output_length,
        cond=None if c is None else jnp.asarray(c),
        global_cond=None if g is None else jnp.asarray(g)))
    yt = pt.wavenet_logits(
        tp, cfgt, torch.from_numpy(x), cfgt.output_length,
        cond=None if c is None else torch.from_numpy(c),
        global_cond=None if g is None else torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(yt, yj, **TOL)
    y0 = pt.wavenet_logits(tp, cfgt, torch.from_numpy(x)).numpy()
    assert np.abs(yt - y0).max() > 1e-3  # conditioning changes the logits


def test_conditioned_logits_refusals():
    cfgj, jp, cfgt, tp = _models("tiny", cond_channels=6, gcond_channels=3)
    x = torch.zeros((2, cfgt.item_length), dtype=torch.long)
    with pytest.raises(ValueError, match="cond shape"):
        pt.wavenet_logits(tp, cfgt, x, cond=torch.zeros((2, 5, 6)))
    with pytest.raises(ValueError, match="global_cond shape"):
        pt.wavenet_logits(tp, cfgt, x, global_cond=torch.zeros((2, 4)))
    plain = pt.get_config("tiny")
    with pytest.raises(ValueError, match="cond_channels == 0"):
        pt.wavenet_logits(tp, plain, x, cond=torch.zeros(
            (2, plain.item_length, 6)))
    # the fused trunk takes local conditioning (the trunk kernels' cond
    # input) and refuses a passed global_cond, where the JAX package falls
    # back to its plain trunk
    fused = pt.get_config("tiny", cond_channels=6, gcond_channels=3,
                          trunk_kernel=True)
    cond = torch.from_numpy(_normal(2, (2, cfgt.item_length, 6), 1.0))
    np.testing.assert_allclose(
        pt.wavenet_logits(tp, fused, x, cond=cond).numpy(),
        pt.wavenet_logits(tp, cfgt, x, cond=cond).numpy(), **TOL)
    with pytest.raises(ValueError, match="global"):
        pt.wavenet_logits(tp, fused, x, global_cond=torch.zeros((2, 3)))


def test_upsample_cond_learnable_and_linear():
    cfgj, jp, cfgt, tp = _models("tiny", cond_channels=6,
                                 cond_upsample=(4, 4))
    frames = _normal(1, (2, 5, 6), 1.0)
    got = pt.upsample_cond(tp, cfgt, torch.from_numpy(frames), 16, 70)
    want = np.asarray(wt.upsample_cond(jp, cfgj, jnp.asarray(frames), 16, 70))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), tmel.upsample_frames_np(frames, 16, 70), **TOL)
    with pytest.raises(ValueError, match="multiply to 16"):
        pt.upsample_cond(tp, cfgt, torch.from_numpy(frames), 64, 70)
    lin = pt.get_config("tiny", cond_channels=6)
    np.testing.assert_array_equal(
        pt.upsample_cond({}, lin, torch.from_numpy(frames), 12, 50).numpy(),
        np.asarray(jmel.upsample_frames(jnp.asarray(frames), 12, 50)))


# ----------------------------------------------------------- generation


@pytest.fixture(scope="module")
def cond_model():
    return _models("tiny", cond_channels=6, gcond_channels=3)


def test_conditioned_gen_step_matches_jax(cond_model):
    cfgj, jp, cfgt, tp = cond_model
    n = 2 * tg.buffer_length(cfgt) + 3
    seq = np.random.default_rng(1).integers(0, cfgj.classes, (2, n))
    c = _normal(2, (n, 2, 6))
    g = _normal(3, (2, 3), 1.0)
    js = jg.init_gen_state(cfgj, 2)
    ts = tg.init_gen_state(cfgt, 2, device="cpu")
    for i in range(n):
        lj, js = jg.gen_step(jp, cfgj, js, jnp.asarray(seq[:, i], jnp.int32),
                             cond=jnp.asarray(c[i]),
                             global_cond=jnp.asarray(g))
        lt, ts = tg.gen_step(tp, cfgt, ts, torch.from_numpy(seq[:, i]),
                             cond=torch.from_numpy(c[i]),
                             global_cond=torch.from_numpy(g))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


@pytest.mark.parametrize("prime_len", [None, 1, 5])
def test_conditioned_generate_fast_matches_jax(cond_model, prime_len):
    cfgj, jp, cfgt, tp = cond_model
    rf, n = cfgj.receptive_field, 24
    ng = prime_len or rf
    prime = np.random.default_rng(4).integers(0, cfgj.classes, (2, ng))
    cond = _normal(5, (2, ng - 1 + n, 6))
    g = _normal(6, (2, 3), 1.0)
    _, cj = wt.generate_fast(jp, cfgj, jax.random.PRNGKey(0), n,
                             jnp.asarray(prime, jnp.int32), temperature=0.0,
                             cond=jnp.asarray(cond),
                             global_cond=jnp.asarray(g))
    _, ct = pt.generate_fast(tp, cfgt, None, n, prime, temperature=0.0,
                             cond=torch.from_numpy(cond),
                             global_cond=torch.from_numpy(g), device="cpu")
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    _, cu = pt.generate_fast(tp, cfgt, None, n, prime, temperature=0.0,
                             device="cpu")
    assert not np.array_equal(ct.numpy(), cu.numpy())
    # the naive oracle on the same timeline
    _, cn = pt.generate(tp, cfgt, None, n, prime, temperature=0.0,
                        cond=torch.from_numpy(cond),
                        global_cond=torch.from_numpy(g), device="cpu")
    np.testing.assert_array_equal(cn.numpy(), ct.numpy())
    with pytest.raises(ValueError, match="cond shape"):
        pt.generate_fast(tp, cfgt, None, n, prime, temperature=0.0,
                         cond=torch.from_numpy(cond[:, 1:]), device="cpu")


def test_conditioned_chunked_rollout_equals_one_shot(cond_model):
    """Each resumed chunk takes its own rows: [0, ng - 1 + n0) for the
    primed chunk, then n rows per chunk."""
    cfgj, jp, cfgt, tp = cond_model
    rf, n = cfgj.receptive_field, 30
    prime = np.random.default_rng(7).integers(0, cfgj.classes, (2, rf))
    cond = torch.from_numpy(_normal(8, (2, rf - 1 + n, 6)))
    g = torch.from_numpy(_normal(9, (2, 3), 1.0))
    _, ref = pt.generate_fast(tp, cfgt, None, n, prime, temperature=0.0,
                              cond=cond, global_cond=g, device="cpu")
    parts, state, pos = [], None, 0
    for i, m in enumerate((11, 7, 12)):
        rows = (rf - 1 + m) if i == 0 else m
        out = pt.generate_fast(
            tp, cfgt, None, m, prime if i == 0 else None, temperature=0.0,
            state=state, return_state=True, cond=cond[:, pos:pos + rows],
            global_cond=g, device="cpu")
        pos += rows
        parts.append(out[1])
        state = out[2]
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), ref.numpy())


@pytest.mark.parametrize("upsample", [(), (4, 4)])
def test_synthesize_matches_jax(upsample):
    hop, F, M = 16, 6, 6
    cfgj, jp, cfgt, tp = _models("tiny", cond_channels=M,
                                 cond_upsample=upsample)
    mel = _normal(1, (2, F, M), 1.0)
    _, cj = wt.synthesize(jp, cfgj, jax.random.PRNGKey(0), jnp.asarray(mel),
                          hop, temperature=0.0)
    _, ct = pt.synthesize(tp, cfgt, None, torch.from_numpy(mel), hop,
                          temperature=0.0, device="cpu")
    assert ct.shape == (2, F * hop)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    _, c1 = pt.synthesize(tp, cfgt, None, mel[0], hop, temperature=0.0,
                          num_samples=30, device="cpu")
    np.testing.assert_array_equal(c1[0].numpy(), ct[0, :30].numpy())
    with pytest.raises(ValueError, match="channels"):
        pt.synthesize(tp, cfgt, None, mel[..., :3], hop, device="cpu")
