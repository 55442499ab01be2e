"""The server's student backend on the CPU (``--student-snapshot``,
``--device cpu``): ``/synthesize`` equal to ``student_generate`` at the
clip's bucket of 8192 samples (a response is a prefix of its bucket's
draw), ``/vocode`` equal to ``student_synthesize``, prime -> 400,
``--batcher``/``--ema`` refused, ``/health``; the snapshot written by the
JAX package."""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.models import iaf as ji
from pytorch_wavenet_tpu.utils import checkpoints as jck
from pytorch_wavenet_tpu_torch.models import iaf as ti
from pytorch_wavenet_tpu_torch.ops import mel as tmel
from pytorch_wavenet_tpu_torch.serving import server as srv

SMALL = dict(flows=2, layers=3, residual_channels=8, dilation_channels=8,
             skip_channels=8, end_channels=8)
HOP, NFFT = 16, 64


def _snapshot(d, cond_channels):
    """A JAX-written student with random heads (not the identity)."""
    scfg = ji.IAFConfig(**SMALL, cond_channels=cond_channels)
    rng = np.random.default_rng(cond_channels)
    params = jax.tree.map(
        lambda x: rng.uniform(-0.2, 0.2, x.shape).astype(np.float32),
        ji.init_student(jax.random.PRNGKey(0), scfg))
    return jck.save_checkpoint(
        str(d), "student", 5, params,
        extra={"iaf_config": dataclasses.asdict(
            dataclasses.replace(scfg, compute_dtype=None))})


def _serve(snap, extra=()):
    box, ready = {}, threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    th = threading.Thread(target=srv.main, kwargs=dict(
        argv=["--student-snapshot", snap, "--port", "0", "--device", "cpu",
              "--max-samples", "20000", *extra],
        on_ready=on_ready), daemon=True)
    th.start()
    assert ready.wait(60), "server did not start"
    return box["server"], th


@pytest.fixture(scope="module", params=[0, 6], ids=["plain", "conditioned"])
def student_server(request, tmp_path_factory):
    snap = _snapshot(tmp_path_factory.mktemp("student"), request.param)
    params, scfg, _ = ti.load_student_snapshot(snap, device="cpu")
    server, th = _serve(snap)
    try:
        yield (f"http://127.0.0.1:{server.server_address[1]}", params, scfg,
               snap)
    finally:
        server.shutdown()
        th.join(30)
        assert not th.is_alive()


def _pcm(wav):
    return np.clip(np.asarray(wav) * 32767.0, -32768, 32767).astype("<i2")


def _wav(req):
    with urllib.request.urlopen(req, timeout=300) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        blob = r.read()
    assert blob[:4] == b"RIFF" and blob[36:40] == b"data"
    return np.frombuffer(blob[44:], "<i2")


def _post(base, path, body, raw=False):
    data = body if raw else json.dumps(body).encode()
    return urllib.request.Request(base + path, data=data, method="POST")


def test_health(student_server):
    base, params, scfg, _ = student_server
    with urllib.request.urlopen(base + "/health", timeout=60) as r:
        h = json.loads(r.read())
    assert h["backend"] == "iaf-student" and h["classes"] is None
    assert h["parameter_count"] == ti.student_parameter_count(params)
    assert h["receptive_field"] == scfg.receptive_field


def test_synthesize_is_a_prefix_of_the_bucket_draw(student_server):
    base, params, scfg, _ = student_server
    want = ti.student_generate(params, scfg,
                               torch.Generator().manual_seed(3), 8192,
                               device="cpu")[0].numpy()
    for n, chunk in ((100, 2048), (5000, 777), (8192, 2048)):
        got = _wav(base + f"/synthesize?num_samples={n}&seed=3&chunk={chunk}")
        np.testing.assert_array_equal(got, _pcm(want[:n]))
    # a clip past the bucket draws the next bucket's length
    got = _wav(_post(base, "/synthesize", {"num_samples": 9000, "seed": 4}))
    want2 = ti.student_generate(params, scfg,
                                torch.Generator().manual_seed(4), 16384,
                                device="cpu")[0].numpy()
    np.testing.assert_array_equal(got, _pcm(want2[:9000]))
    assert not np.array_equal(_pcm(want[:100]), got[:100])


@pytest.mark.parametrize("body", [{"prime": [1, 2, 3]},
                                  {"prime_audio": [0.1, -0.2]}])
def test_prime_gets_400(student_server, body):
    base = student_server[0]
    with pytest.raises(urllib.error.HTTPError) as e:
        _wav(_post(base, "/synthesize", body))
    assert e.value.code == 400
    assert "no autoregressive history" in json.loads(e.value.read())["error"]


def test_vocode(student_server, tmp_path):
    base, params, scfg, _ = student_server
    t = np.arange(400) / 16000.0
    path = tmp_path / "in.wav"
    pt.write_wav(str(path), 0.5 * np.sin(2 * np.pi * 440 * t), 16000)
    blob = path.read_bytes()
    query = f"/vocode?hop_length={HOP}&n_fft={NFFT}&seed=5"
    if not scfg.cond_channels:
        with pytest.raises(urllib.error.HTTPError) as e:
            _wav(_post(base, query, blob, raw=True))
        assert e.value.code == 400
        return
    got = _wav(_post(base, query, blob, raw=True))
    wav, _ = pt.load_audio(str(path))
    mel = tmel.log_mel_spectrogram(wav, num_mels=scfg.cond_channels,
                                   n_fft=NFFT, hop_length=HOP)
    n = mel.shape[0] * HOP
    want = ti.student_synthesize(params, scfg,
                                 torch.Generator().manual_seed(5), mel, HOP,
                                 num_samples=8192, device="cpu")
    assert got.size == n
    np.testing.assert_array_equal(got, _pcm(want[0, :n].numpy()))


def test_batcher_and_ema_are_refused(tmp_path):
    snap = _snapshot(tmp_path, 0)
    for flag in ("--batcher", "--ema"):
        with pytest.raises(SystemExit, match=flag.strip("-")):
            srv.main(["--student-snapshot", snap, "--device", "cpu", flag])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            srv.main(["--student-snapshot", snap])
