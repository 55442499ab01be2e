"""The port's streaming server on the CPU (plain version of the fused
kernel): health, wav framing, chunked responses equal to one-shot calls,
prime handling."""

import json
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch.ops.mulaw import quantize_data
from pytorch_wavenet_tpu_torch.serving import server as srv


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    d = tmp_path_factory.mktemp("serve")
    pt.save_checkpoint(str(d), "tiny", 3, params, cfg=cfg)
    box = {}
    ready = threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    th = threading.Thread(target=srv.main, kwargs=dict(
        argv=["--snapshot-path", str(d), "--port", "0", "--device", "cpu",
              "--max-samples", "4000"],
        on_ready=on_ready), daemon=True)
    th.start()
    assert ready.wait(60), "server did not start"
    server = box["server"]
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        yield base, params, cfg
    finally:
        server.shutdown()
        th.join(10)
        assert not th.is_alive()


def _get_json(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def _wav(req):
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        blob = r.read()
    assert blob[:4] == b"RIFF" and blob[8:12] == b"WAVE"
    assert blob[12:16] == b"fmt " and blob[36:40] == b"data"
    assert struct.unpack("<I", blob[4:8])[0] == len(blob) - 8
    n = struct.unpack("<I", blob[40:44])[0] // 2
    pcm = np.frombuffer(blob[44:], "<i2")
    assert pcm.size == n
    return pcm


def _post(base, body):
    return urllib.request.Request(
        base + "/synthesize", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")


def _pcm(wav):
    return np.clip(wav.numpy()[0] * 32767.0, -32768, 32767).astype("<i2")


def _direct(params, cfg, seed, n, prime=None, temperature=0.0):
    """One-shot call with the server's per-request seed derivation."""
    kseed = int(torch.randint(0, 2**31 - 1, (1,),
                              generator=torch.Generator().manual_seed(seed)))
    first = None if prime is None else np.asarray(prime)[None]
    wav, _ = pt.generate_fast_fused(params, cfg, kseed, n, first,
                                    temperature=temperature, fuse_res=True,
                                    device="cpu")
    return _pcm(wav)


def test_health(served):
    base, params, cfg = served
    h = _get_json(base + "/health")
    assert h["status"] == "ok"
    assert h["backend"] == "cpu-plain"
    assert h["receptive_field"] == cfg.receptive_field
    assert h["parameter_count"] == pt.parameter_count(params)
    assert h["classes"] == cfg.classes and h["sample_rate"] == 16000


def test_two_requests_give_wavs_of_the_right_length(served):
    base, _, _ = served
    a = _wav(f"{base}/synthesize?num_samples=70&temperature=0.9&seed=1")
    b = _wav(_post(base, {"num_samples": 33, "temperature": 1.0, "seed": 2,
                          "chunk": 8}))
    assert a.size == 70 and b.size == 33


@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_chunked_response_equals_one_shot(served, temperature):
    base, params, cfg = served
    pcm = _wav(f"{base}/synthesize?num_samples=96&temperature={temperature}"
               f"&seed=3&chunk=25")
    np.testing.assert_array_equal(
        pcm, _direct(params, cfg, 3, 96, temperature=temperature))


def test_prime_is_cut_to_the_receptive_field(served):
    base, params, cfg = served
    rf = cfg.receptive_field
    prime = np.random.default_rng(5).integers(0, cfg.classes, rf + 50)
    long = _wav(_post(base, {"num_samples": 40, "temperature": 0,
                             "prime": prime.tolist(), "chunk": 16}))
    cut = _wav(_post(base, {"num_samples": 40, "temperature": 0,
                            "prime": prime[-rf:].tolist()}))
    np.testing.assert_array_equal(long, cut)
    np.testing.assert_array_equal(
        long, _direct(params, cfg, 0, 40, prime=prime[-rf:]))


def test_prime_audio_is_quantized(served):
    base, _, cfg = served
    audio = np.sin(np.linspace(0, 20, 30))
    a = _wav(_post(base, {"num_samples": 20, "temperature": 0,
                          "prime_audio": audio.tolist()}))
    b = _wav(_post(base, {"num_samples": 20, "temperature": 0,
                          "prime": quantize_data(audio, cfg.classes).tolist()}))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("body", [
    {"num_samples": 0}, {"num_samples": 5000}, {"chunk": 0},
    {"prime": [1, 99]}, {"prime": [[1]]}, {"temperature": "hot"},
])
def test_bad_requests_get_400(served, body):
    base, _, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_post(base, body), timeout=60)
    assert e.value.code == 400


def test_unknown_route_is_404(served):
    base, _, _ = served
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope", timeout=60)
    assert e.value.code == 404


def test_wav_header_layout():
    h = srv.wav_header(10, 8000)
    assert len(h) == 44
    assert struct.unpack("<IHHIIHH", h[16:36]) == (16, 1, 1, 8000, 16000, 2, 16)
    assert struct.unpack("<I", h[40:44])[0] == 20
