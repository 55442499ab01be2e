"""The port's streaming server on the CPU (plain versions of the kernels):
health, wav framing, chunked responses equal to one-shot calls, prime
handling; and the --batcher mode: /stats, concurrent requests equal to
their solo rollouts."""

import json
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch.ops.mulaw import dequantize_to_f32, quantize_data
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
    assert _get_json(base + "/stats") == {"backend": "cpu-plain"}
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope", timeout=60)
    assert e.value.code == 404


def test_wav_header_layout():
    h = srv.wav_header(10, 8000)
    assert len(h) == 44
    assert struct.unpack("<IHHIIHH", h[16:36]) == (16, 1, 1, 8000, 16000, 2, 16)
    assert struct.unpack("<I", h[40:44])[0] == 20


# ------------------------------------------------------------ --batcher mode


@pytest.fixture(scope="module")
def served_batcher(tmp_path_factory):
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(1), "cpu")
    d = tmp_path_factory.mktemp("serve_batcher")
    path = pt.save_checkpoint(str(d), "tiny", 5, params, cfg=cfg)
    box = {}
    ready = threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    th = threading.Thread(target=srv.main, kwargs=dict(
        argv=["--snapshot", path, "--port", "0", "--device", "cpu",
              "--batcher", "--lanes", "3", "--batch-chunk", "16",
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
        th.join(30)
        assert not th.is_alive()


def _pooled_solo(params, cfg, n, temperature, seed, prime=None):
    """The solo rollout a pooled request must equal: the pool's flags
    (fuse_res; tiny's skip width is below the skip_slab threshold) and the
    request's seed as its lane seed."""
    first = [cfg.classes // 2] if prime is None else prime
    _, cls = pt.generate_fast_batched(
        params, cfg, 0, n, np.asarray(first)[None], temperature=temperature,
        lane_seed=[seed], fuse_res=True, device="cpu")
    wav = dequantize_to_f32(cls[0].numpy(), cfg.classes)
    return np.clip(wav * 32767.0, -32768, 32767).astype("<i2")


def test_batcher_health_and_stats(served_batcher):
    base, params, cfg = served_batcher
    h = _get_json(base + "/health")
    assert h["status"] == "ok" and h["backend"] == "cpu-batcher"
    assert h["parameter_count"] == pt.parameter_count(params)
    s = _get_json(base + "/stats")
    assert s["backend"] == "cpu-batcher"
    assert s["lanes"] == 3 and s["chunk"] == 16 and s["light_chunk"] is None


def test_batcher_concurrent_requests_equal_solo(served_batcher):
    """More concurrent requests than lanes, mixed temperatures and primes:
    each response equals its solo rollout byte for byte, and /stats counts
    them all completed."""
    base, params, cfg = served_batcher
    before = _get_json(base + "/stats")["completed"]
    prime = np.random.default_rng(9).integers(0, cfg.classes, 7)
    reqs = [(50, 0.0, 1, None), (37, 0.9, 2, None), (61, 1.0, 3, prime),
            (20, 0.0, 4, prime), (45, 0.8, 5, None)]
    out = [None] * len(reqs)

    def fetch(i, n, temp, seed, pr):
        body = {"num_samples": n, "temperature": temp, "seed": seed}
        if pr is not None:
            body["prime"] = pr.tolist()
        out[i] = _wav(_post(base, body))

    threads = [threading.Thread(target=fetch, args=(i, *r))
               for i, r in enumerate(reqs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
        assert not t.is_alive()
    for pcm, (n, temp, seed, pr) in zip(out, reqs):
        np.testing.assert_array_equal(
            pcm, _pooled_solo(params, cfg, n, temp, seed, pr))
    s = _get_json(base + "/stats")
    assert s["completed"] - before == len(reqs)
    assert s["failed"] == 0 and s["active"] == 0


def test_batcher_get_and_bad_requests(served_batcher):
    base, params, cfg = served_batcher
    pcm = _wav(f"{base}/synthesize?num_samples=30&temperature=0.7&seed=8")
    np.testing.assert_array_equal(pcm, _pooled_solo(params, cfg, 30, 0.7, 8))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_post(base, {"num_samples": 0}), timeout=60)
    assert e.value.code == 400
    e.value.close()


def test_batcher_needs_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(1), "cpu")
    path = pt.save_checkpoint(str(tmp_path), "tiny", 1, params, cfg=cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        srv.main(["--snapshot", path, "--port", "0", "--batcher"])


def test_batcher_full_queue_gets_503(tmp_path):
    """With every lane busy and --max-pending requests waiting, a request
    is answered 503 before any audio; the accepted ones complete."""
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(2), "cpu")
    path = pt.save_checkpoint(str(tmp_path), "tiny", 1, params, cfg=cfg)
    box, ready = {}, threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    th = threading.Thread(target=srv.main, kwargs=dict(
        argv=["--snapshot", path, "--port", "0", "--device", "cpu",
              "--batcher", "--lanes", "1", "--batch-chunk", "8",
              "--max-pending", "1", "--max-samples", "4000"],
        on_ready=on_ready), daemon=True)
    th.start()
    assert ready.wait(60), "server did not start"
    server = box["server"]
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def wait_stats(key, value):
        deadline = time.time() + 60
        while _get_json(base + "/stats")[key] != value:
            assert time.time() < deadline, f"{key} never reached {value}"
            time.sleep(0.01)

    out = {}

    def fetch(name, n):
        out[name] = _wav(f"{base}/synthesize?num_samples={n}&temperature=0")

    try:
        busy = threading.Thread(target=fetch, args=("busy", 4000))
        busy.start()
        wait_stats("active", 1)
        queued = threading.Thread(target=fetch, args=("queued", 20))
        queued.start()
        wait_stats("queued", 1)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{base}/synthesize?num_samples=5",
                                   timeout=60)
        assert e.value.code == 503
        e.value.close()
        for t in (busy, queued):
            t.join(120)
            assert not t.is_alive()
        assert out["busy"].size == 4000 and out["queued"].size == 20
    finally:
        server.shutdown()
        th.join(30)
        assert not th.is_alive()
