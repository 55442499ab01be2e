"""Conditioned serving in the port on the CPU (plain versions of K1 and K4):
the batcher's rows and frames modes, the bf16 wire, the mode and shape
errors, and the server's POST /vocode single-stream and with --batcher.

A pooled conditioned request must equal, bitwise, its solo
``generate_fast_batched`` call with ``lane_seed=[seed]`` on the same rows
(in frames mode: the frames expanded over the whole timeline), and at
temperature 0 the JAX package's ``generate_fast`` on the same rows."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch.ops import mel as tmel
from pytorch_wavenet_tpu_torch.serving import ContinuousBatcher
from pytorch_wavenet_tpu_torch.serving import server as srv


def _models(name="tiny_vocoder", **over):
    cfgj, cfgt = wt.get_config(name, **over), pt.get_config(name, **over)
    jp = wt.init_wavenet(jax.random.PRNGKey(20), cfgj)
    return cfgj, jp, cfgt, pt.from_jax_params(jax.tree.map(np.asarray, jp),
                                              "cpu")


@pytest.fixture(scope="module")
def voc():
    return _models()


def _normal(seed, shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _solo(params, cfg, prime, n, rows, temperature=0.0, seed=0):
    _, cls = pt.generate_fast_batched(
        params, cfg, 0, n, np.asarray(prime)[None], temperature=temperature,
        lane_seed=[seed], cond=None if rows is None else rows[None],
        device="cpu")
    return cls[0].numpy()


def _jax_solo(jp, cfgj, prime, n, rows):
    _, cls = wt.generate_fast(
        jp, cfgj, jax.random.PRNGKey(9), n, jnp.asarray(prime)[None, :],
        temperature=0.0,
        cond=None if rows is None else jnp.asarray(rows)[None])
    return np.asarray(cls)[0]


def _wait_for(handle, k, timeout=60.0):
    deadline = time.time() + timeout
    while sum(p.size for p in handle._parts) < k:
        if handle.done() or time.time() > deadline:
            break
        time.sleep(0.01)


def _expanded(frames, total, hop, params=None, factors=()):
    """The whole timeline's rows, as the pool expands them window by
    window (the last frame replicated past the end)."""
    need = tmel.frames_window_len(total, hop, factors)
    idx = np.minimum(np.arange(max(frames.shape[0], need)),
                     frames.shape[0] - 1)
    return tmel.expand_frames_window(
        params, torch.from_numpy(frames[idx])[None], hop,
        torch.zeros(1, dtype=torch.long), total, factors)[0].numpy()


def test_rows_mode_requests_share_the_pool(voc):
    """Conditioned requests admitted into a busy pool equal their solo
    rollouts (and the JAX package's at temperature 0); an unconditioned
    request on the conditioned pool rides zero rows unaffected."""
    cfgj, jp, cfgt, tp = voc
    rf, M = cfgt.receptive_field, cfgt.cond_channels
    prime = np.random.default_rng(21).integers(0, cfgt.classes, rf)
    n1, n2, n3 = 17, 9, 14
    cond1 = _normal(22, (rf - 1 + n1, M))
    cond2 = _normal(23, (rf - 1 + n2, M))
    cond3 = _normal(24, (n3, M))
    b = ContinuousBatcher(tp, cfgt, lanes=3, chunk=6, device="cpu")
    try:
        plain = b.submit(prime, 20, temperature=0.0, seed=0)
        h1 = b.submit(prime, n1, temperature=0.0, cond=cond1, seed=0)
        _wait_for(h1, 8)
        h2 = b.submit(prime, n2, temperature=0.0, cond=cond2, seed=0)
        _, c1 = h1.result(timeout=120)
        _, c2 = h2.result(timeout=120)
        _, cp = plain.result(timeout=120)
        h3 = b.submit(prime[:1], n3, temperature=0.9, cond=cond3, seed=5)
        _, c3 = h3.result(timeout=120)
        assert b.stats()["bytes_up"] > 0
    finally:
        b.close()
    np.testing.assert_array_equal(c1, _solo(tp, cfgt, prime, n1, cond1))
    np.testing.assert_array_equal(c1, _jax_solo(jp, cfgj, prime, n1, cond1))
    np.testing.assert_array_equal(c2, _solo(tp, cfgt, prime, n2, cond2))
    np.testing.assert_array_equal(c2, _jax_solo(jp, cfgj, prime, n2, cond2))
    np.testing.assert_array_equal(cp, _solo(tp, cfgt, prime, 20, None))
    np.testing.assert_array_equal(
        c3, _solo(tp, cfgt, prime[:1], n3, cond3, 0.9, 5))


@pytest.mark.parametrize("factors", [(), (2, 2)])
def test_frames_mode_equals_solo_of_expanded_frames(factors):
    cfgj, jp, cfgt, tp = _models(cond_upsample=factors)
    rf, M, hop = cfgt.receptive_field, cfgt.cond_channels, 4
    prime = np.random.default_rng(31).integers(0, cfgt.classes, rf)
    n1, n2 = 17, 9

    def frames(seed, n):
        return _normal(seed, (-(-(rf - 1 + n) // hop) + 2, M))

    f1, f2 = frames(32, n1), frames(33, n2)
    b = ContinuousBatcher(tp, cfgt, lanes=3, chunk=6, cond_hop=hop,
                          light_chunk=5, light_threshold=0.4, device="cpu")
    try:
        b.prewarm()
        plain = b.submit(prime, 20, temperature=0.0, seed=0)
        h1 = b.submit(prime, n1, temperature=0.8, cond_frames=f1, seed=3)
        _wait_for(h1, 8)
        h2 = b.submit(prime, n2, temperature=0.0, cond_frames=f2, seed=0)
        _, c1 = h1.result(timeout=120)
        _, c2 = h2.result(timeout=120)
        _, cp = plain.result(timeout=120)
    finally:
        b.close()
    up = {"cond_up": tp["cond_up"]} if factors else None
    r1 = _expanded(f1, rf - 1 + n1, hop, up, factors)
    r2 = _expanded(f2, rf - 1 + n2, hop, up, factors)
    np.testing.assert_array_equal(c1, _solo(tp, cfgt, prime, n1, r1, 0.8, 3))
    np.testing.assert_array_equal(c2, _solo(tp, cfgt, prime, n2, r2))
    np.testing.assert_array_equal(c2, _jax_solo(jp, cfgj, prime, n2, r2))
    np.testing.assert_array_equal(cp, _solo(tp, cfgt, prime, 20, None))


def test_bf16_wire_equals_solo_of_rounded_frames(voc):
    _, _, cfgt, tp = voc
    rf, M, hop, n = cfgt.receptive_field, cfgt.cond_channels, 4, 21
    prime = np.random.default_rng(41).integers(0, cfgt.classes, 3)
    f = _normal(42, (-(-(3 - 1 + n) // hop) + 1, M), 1.0)
    b = ContinuousBatcher(tp, cfgt, lanes=2, chunk=5, cond_hop=hop,
                          cond_wire_dtype=torch.bfloat16, device="cpu")
    try:
        _, c = b.submit(prime, n, temperature=0.0, cond_frames=f,
                        seed=0).result(timeout=120)
        up = b.stats()["bytes_up"]
    finally:
        b.close()
    rounded = torch.from_numpy(f).to(torch.bfloat16).float().numpy()
    assert not np.array_equal(rounded, f)
    np.testing.assert_array_equal(
        c, _solo(tp, cfgt, prime, n, _expanded(rounded, 3 - 1 + n, hop)))
    assert up > 0


def test_cond_mode_and_shape_errors(voc):
    _, _, cfgt, tp = voc
    M = cfgt.cond_channels
    plain_cfg = pt.get_config("tiny")
    plain = pt.init_wavenet(plain_cfg, torch.Generator().manual_seed(0),
                            "cpu")
    b = ContinuousBatcher(plain, plain_cfg, lanes=2, chunk=4, device="cpu")
    try:
        with pytest.raises(ValueError, match="cond_channels"):
            b.submit([1], 4, cond=np.zeros((4, 8), np.float32))
    finally:
        b.close()
    with pytest.raises(ValueError, match="cond_channels"):
        ContinuousBatcher(plain, plain_cfg, lanes=2, chunk=4, cond_hop=4,
                          device="cpu")
    b = ContinuousBatcher(tp, cfgt, lanes=2, chunk=4, device="cpu")
    try:
        with pytest.raises(ValueError, match="cond shape"):
            b.submit([1], 4, cond=np.zeros((3, M), np.float32))
        with pytest.raises(ValueError, match="cond_hop"):
            b.submit([1], 4, cond_frames=np.zeros((4, M), np.float32))
        with pytest.raises(ValueError, match="not both"):
            b.submit([1], 4, cond=np.zeros((4, M), np.float32),
                     cond_frames=np.zeros((4, M), np.float32))
    finally:
        b.close()
    b = ContinuousBatcher(tp, cfgt, lanes=2, chunk=4, cond_hop=4,
                          device="cpu")
    try:
        with pytest.raises(ValueError, match="cond_frames"):
            b.submit([1], 4, cond=np.zeros((4, M), np.float32))
        with pytest.raises(ValueError, match="cond_frames shape"):
            b.submit([1], 9, cond_frames=np.zeros((2, M), np.float32))
        with pytest.raises(ValueError, match="cond_frames shape"):
            b.submit([1], 4, cond_frames=np.zeros((1, M - 1), np.float32))
    finally:
        b.close()
    cfg_up = pt.get_config("tiny_vocoder", cond_upsample=(2, 2))
    p_up = pt.init_wavenet(cfg_up, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="multiply to 4 != cond_hop 8"):
        ContinuousBatcher(p_up, cfg_up, lanes=2, chunk=4, cond_hop=8,
                          device="cpu")
    with pytest.raises(ValueError, match="cond_wire_dtype"):
        ContinuousBatcher(tp, cfgt, lanes=2, chunk=4, cond_hop=4,
                          cond_wire_dtype=torch.float16, device="cpu")


# --------------------------------------------------------------- server

HOP, NFFT = 16, 64


def _tone_wav(tmp_path):
    t = np.arange(400) / 16000.0
    path = tmp_path / "in.wav"
    pt.write_wav(str(path), 0.5 * np.sin(2 * np.pi * 440 * t), 16000)
    return path.read_bytes()


def _serve(ckpt_dir, extra):
    box, ready = {}, threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    th = threading.Thread(target=srv.main, kwargs=dict(
        argv=["--snapshot-path", str(ckpt_dir), "--port", "0", "--device",
              "cpu", "--max-samples", "4000"] + extra,
        on_ready=on_ready), daemon=True)
    th.start()
    assert ready.wait(60), "server did not start"
    return box["server"], th


@pytest.fixture(scope="module", params=["single", "batcher"])
def vocode_server(request, tmp_path_factory):
    cfg = pt.get_config("tiny_vocoder")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    d = tmp_path_factory.mktemp("vocode")
    pt.save_checkpoint(str(d), "voc", 1, params, cfg=cfg)
    extra = ([] if request.param == "single" else
             ["--batcher", "--lanes", "3", "--batch-chunk", "16",
              "--cond-hop", str(HOP)])
    server, th = _serve(d, extra)
    try:
        yield (f"http://127.0.0.1:{server.server_address[1]}", params, cfg,
               request.param, d)
    finally:
        server.shutdown()
        th.join(30)
        assert not th.is_alive()


def _vocode(base, blob, query):
    req = urllib.request.Request(base + "/vocode?" + query, data=blob,
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        out = r.read()
    assert out[:4] == b"RIFF" and out[36:40] == b"data"
    return np.frombuffer(out[44:], "<i2")


def test_vocode_returns_the_solo_rollout(vocode_server, tmp_path):
    base, params, cfg, mode, _ = vocode_server
    blob = _tone_wav(tmp_path)
    (tmp_path / "in.wav").write_bytes(blob)
    wav, sr = pt.load_audio(str(tmp_path / "in.wav"))
    mel = tmel.log_mel_spectrogram(wav, num_mels=cfg.cond_channels,
                                   n_fft=NFFT, hop_length=HOP)
    n = mel.shape[0] * HOP
    for seed, temp in ((1, 0.0), (2, 1.0)):
        got = _vocode(base, blob, f"hop_length={HOP}&n_fft={NFFT}"
                                  f"&seed={seed}&temperature={temp}")
        assert got.size == n
        if mode == "single":
            want, _ = pt.synthesize(
                params, cfg, srv.Synthesizer.kernel_seed(seed), mel, HOP,
                temperature=temp, backend=pt.generate_fast_fused,
                fuse_res=True, device="cpu")
            want = want[0].numpy()
        else:
            rows = _expanded(mel, n, HOP)
            _, cls = pt.generate_fast_batched(
                params, cfg, 0, n, np.full((1, 1), cfg.classes // 2),
                temperature=temp, lane_seed=[seed], cond=rows[None],
                fuse_res=True, skip_slab=cfg.skip_channels >= 256,
                device="cpu")
            want = pt.dequantize_to_f32(cls[0].numpy(), cfg.classes)
        pcm = np.clip(want * 32767.0, -32768, 32767).astype("<i2")
        np.testing.assert_array_equal(got, pcm)


def test_vocode_bad_requests_get_400(vocode_server, tmp_path):
    base, _, _, mode, _ = vocode_server
    blob = _tone_wav(tmp_path)
    long = tmp_path / "long.wav"  # 4112 samples: over --max-samples 4000
    pt.write_wav(str(long), np.zeros(4100), 16000)
    bad = [(b"RIFF" + b"\0" * 40, "hop_length=16"), (b"xy", ""),
           (long.read_bytes(), f"hop_length={HOP}&n_fft={NFFT}")]
    if mode == "batcher":  # the pool's hop is the server's
        bad.append((blob, "hop_length=8&n_fft=64"))
    for body, query in bad:
        with pytest.raises(urllib.error.HTTPError) as e:
            _vocode(base, body, query)
        assert e.value.code == 400


def test_vocode_on_an_unconditional_model_gets_400(tmp_path):
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    pt.save_checkpoint(str(tmp_path), "tiny", 1, params, cfg=cfg)
    server, th = _serve(tmp_path, [])
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _vocode(f"http://127.0.0.1:{server.server_address[1]}",
                    _tone_wav(tmp_path), "")
        assert e.value.code == 400
        assert "unconditional" in json.loads(e.value.read())["error"]
    finally:
        server.shutdown()
        th.join(30)
