"""The server's remainder on the CPU (plain versions of the kernels), at
the ``tiny`` preset: ``/reload`` single-stream and through the batcher,
the snapshot follower (``--reload-interval``) rolling in a newer file and
a newer sharded directory of the JAX package, a pool that does not take
reloaded weights (503, the follower retrying), ``/profile``, ``--backend``
and ``--torch-snapshot``.

Every response is held byte for byte to the library call on the weights it
should come from: K1's wrapper (its plain version here) with the server's
seed derivation single-stream, the pool's solo rollout through the
batcher, ``generate_fast`` under ``--backend plain``. A converted
reference snapshot's params equal the JAX package's conversion bitwise,
and its served classes at temperature 0 equal JAX ``generate_fast``.
"""

import contextlib
import json
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.models import convert as jconv
from pytorch_wavenet_tpu.utils import checkpoints as jck
from pytorch_wavenet_tpu_torch.ops.mulaw import dequantize_to_f32
from pytorch_wavenet_tpu_torch.serving import server as srv
from test_convert import _random_state_dict, _save_reference_like_module


def _serve(argv):
    box, ready = {}, threading.Event()

    def on_ready(server):
        box["server"] = server
        ready.set()

    th = threading.Thread(target=srv.main, kwargs=dict(
        argv=argv + ["--port", "0", "--device", "cpu"], on_ready=on_ready),
        daemon=True)
    th.start()
    assert ready.wait(60), "server did not start"
    return box["server"], th


@contextlib.contextmanager
def _server(argv):
    server, th = _serve(argv)
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        th.join(30)
        assert not th.is_alive()


def _pcm_of(blob):
    assert blob[:4] == b"RIFF"
    return np.frombuffer(blob[44:], "<i2")


def _synth(base, n, seed, temperature=0.0, chunk=16):
    url = (f"{base}/synthesize?num_samples={n}&seed={seed}"
           f"&temperature={temperature}&chunk={chunk}")
    with urllib.request.urlopen(url, timeout=300) as r:
        return _pcm_of(r.read())


def _post(base, route, body=None, raw=None):
    """(status, JSON reply) of a POST."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(base + route, data=data or b"",
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _health(base):
    with urllib.request.urlopen(base + "/health", timeout=60) as r:
        return json.loads(r.read())


def _stats(base):
    with urllib.request.urlopen(base + "/stats", timeout=60) as r:
        return json.loads(r.read())


def _to_pcm(cls, classes):
    wav = dequantize_to_f32(np.asarray(cls), classes)
    return np.clip(wav * 32767.0, -32768, 32767).astype("<i2")


def _k1(params, cfg, n, seed, temperature=0.0):
    """The single-stream library call with the server's seed derivation."""
    _, cls = pt.generate_fast_fused(params, cfg, srv.Synthesizer.kernel_seed(
        seed), n, None, temperature=temperature, fuse_res=True, device="cpu")
    return _to_pcm(cls[0], cfg.classes)


def _pool(params, cfg, n, seed, temperature=0.0):
    """A pooled request's solo rollout (tiny's skip width is below the
    skip_slab threshold)."""
    _, cls = pt.generate_fast_batched(
        params, cfg, 0, n, [[cfg.classes // 2]], temperature=temperature,
        lane_seed=[seed], fuse_res=True, device="cpu")
    return _to_pcm(cls[0], cfg.classes)


def _params(cfg, seed):
    return pt.init_wavenet(cfg, torch.Generator().manual_seed(seed), "cpu")


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    """Snapshots A (step 1, in the served directory), B (step 2, apart),
    one with EMA weights E (step 3, apart) and one of another config."""
    cfg = pt.get_config("tiny")
    d = tmp_path_factory.mktemp("snaps")
    served, apart = str(d / "served"), str(d / "apart")
    p = {k: _params(cfg, s) for k, s in (("A", 1), ("B", 2), ("E", 3))}
    paths = {
        "A": pt.save_checkpoint(served, "tiny", 1, p["A"], cfg=cfg),
        "B": pt.save_checkpoint(apart, "tiny", 2, p["B"], cfg=cfg),
        "E": pt.save_checkpoint(
            apart, "ema", 3, p["A"], cfg=cfg,
            opt_state={"inner": {"count": np.zeros((), np.int32)},
                       "ema": pt.to_numpy_params(p["E"])}),
    }
    other = pt.get_config("tiny", residual_channels=4)
    paths["other"] = pt.save_checkpoint(apart, "other", 4, _params(other, 4),
                                        cfg=other)
    return cfg, p, paths, served


def test_reload_single_stream(snaps):
    cfg, p, paths, served = snaps
    with _server(["--snapshot", paths["A"], "--snapshot-path", served]) as b:
        np.testing.assert_array_equal(_synth(b, 40, 3, 0.9),
                                      _k1(p["A"], cfg, 40, 3, 0.9))
        assert _post(b, "/reload", {"snapshot": paths["B"]}) == (
            200, {"reloaded": True, "step": 2})
        got = _synth(b, 40, 3, 0.9)
        np.testing.assert_array_equal(got, _k1(p["B"], cfg, 40, 3, 0.9))
        assert not np.array_equal(got, _k1(p["A"], cfg, 40, 3, 0.9))
        # no body: the newest checkpoint under --snapshot-path
        assert _post(b, "/reload") == (200, {"reloaded": True, "step": 1})
        np.testing.assert_array_equal(_synth(b, 40, 4),
                                      _k1(p["A"], cfg, 40, 4))
        assert _post(b, "/reload", {"snapshot": paths["E"], "ema": True}) \
            == (200, {"reloaded": True, "step": 3})
        np.testing.assert_array_equal(_synth(b, 40, 5),
                                      _k1(p["E"], cfg, 40, 5))
        for body, match in (
                ({"snapshot": paths["other"]}, "config differs"),
                ({"snapshot": 5}, "path string"),
                ({"snapshot": paths["B"] + ".missing"}, "No such file"),
                ({"snapshot": paths["B"], "ema": True}, "no EMA")):
            code, reply = _post(b, "/reload", body)
            assert code == 400 and match in reply["error"], (body, reply)
        assert _post(b, "/reload", raw=b"[1]")[0] == 400
        assert _post(b, "/reload", raw=b"{nope")[0] == 400
        # the refusals left the EMA weights serving
        np.testing.assert_array_equal(_synth(b, 40, 5),
                                      _k1(p["E"], cfg, 40, 5))
        # /profile needs --profile-dir
        code, reply = _post(b, "/profile?seconds=0.1")
        assert code == 400 and "--profile-dir" in reply["error"]


def _wait_for(base, want, n, seed, tries=100):
    """Poll with requests until one equals ``want`` (the follower rolls a
    snapshot in within a few of its intervals)."""
    for _ in range(tries):
        got = _synth(base, n, seed)
        if np.array_equal(got, want):
            return True
        time.sleep(0.1)
    return False


def test_reload_through_the_batcher_and_the_follower(snaps, tmp_path):
    cfg, p, paths, _ = snaps
    d = str(tmp_path / "run")
    a = pt.save_checkpoint(d, "tiny", 1, p["A"], cfg=cfg)
    with _server(["--snapshot", a, "--snapshot-path", d, "--batcher",
                  "--lanes", "3", "--batch-chunk", "16",
                  "--reload-interval", "0.2"]) as b:
        assert _health(b)["backend"] == "cpu-batcher"
        np.testing.assert_array_equal(_synth(b, 40, 7),
                                      _pool(p["A"], cfg, 40, 7))
        # a long request streams on while the weights change under it
        box = {}
        th = threading.Thread(target=lambda: box.update(
            pcm=_synth(b, 600, 8, 0.9)))
        th.start()
        time.sleep(0.3)
        assert _post(b, "/reload", {"snapshot": paths["B"]}) == (
            200, {"reloaded": True, "step": 2})
        np.testing.assert_array_equal(_synth(b, 40, 9, 0.9),
                                      _pool(p["B"], cfg, 40, 9, 0.9))
        th.join(300)
        assert not th.is_alive() and box["pcm"].size == 600
        s = _stats(b)
        assert s["failed"] == 0 and s["completed"] >= 3
        code, reply = _post(b, "/reload", {"snapshot": paths["other"]})
        assert code == 400 and "config differs" in reply["error"]
        # the follower: a newer file, then a newer sharded directory
        # written by the JAX package
        p5 = _params(cfg, 5)
        pt.save_checkpoint(d, "tiny", 5, p5, cfg=cfg)
        assert _wait_for(b, _pool(p5, cfg, 40, 10), 40, 10)
        p9 = _params(cfg, 9)
        jck.save_checkpoint_sharded(d, "tiny", 9, pt.to_numpy_params(p9),
                                    cfg=wt.get_config("tiny"))
        assert _wait_for(b, _pool(p9, cfg, 40, 10), 40, 10)
        # a newer snapshot of another config fails to roll in: the
        # server keeps serving the weights it has
        pt.save_checkpoint(d, "tiny", 12, _params(
            pt.get_config("tiny", residual_channels=4), 12),
            cfg=pt.get_config("tiny", residual_channels=4))
        time.sleep(1.0)
        np.testing.assert_array_equal(_synth(b, 40, 10),
                                      _pool(p9, cfg, 40, 10))
        assert _stats(b)["failed"] == 0


def test_reload_when_the_pool_does_not_take_the_weights(snaps, tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """A pool that does not install reloaded weights in time: /reload
    answers 503, the follower prints the failure and retries at its next
    poll, and the old weights keep serving until a retry succeeds."""
    cfg, p, paths, _ = snaps
    d = str(tmp_path / "run")
    pt.save_checkpoint(d, "tiny", 1, p["A"], cfg=cfg)
    synth = srv.Synthesizer(p["A"], cfg, device="cpu",
                            batcher_opts=dict(lanes=2, chunk=16))
    monkeypatch.setattr(srv, "RELOAD_TIMEOUT_S", 0.2)
    take = synth.batcher.update_params
    # an installation event that never fires, as when the worker is stuck
    monkeypatch.setattr(synth.batcher, "update_params",
                        lambda params: threading.Event())
    server = ThreadingHTTPServer(
        ("127.0.0.1", 0), srv.make_handler(synth, 1000, None, d))
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    stop = threading.Event()
    follower = threading.Thread(target=srv._follow,
                                args=(synth, d, 0.05, False, stop),
                                daemon=True)
    follower.start()
    try:
        b = f"http://127.0.0.1:{server.server_address[1]}"
        code, reply = _post(b, "/reload", {"snapshot": paths["B"]})
        assert code == 503 and "did not take" in reply["error"]
        pt.save_checkpoint(d, "tiny", 5, p["B"], cfg=cfg)
        out = ""
        for _ in range(100):
            out += capsys.readouterr().out
            if out.count("did not take the new weights") >= 2:
                break
            time.sleep(0.05)
        assert out.count("did not take the new weights") >= 2, out
        assert follower.is_alive()
        np.testing.assert_array_equal(_synth(b, 40, 7),
                                      _pool(p["A"], cfg, 40, 7))
        monkeypatch.setattr(synth.batcher, "update_params", take)
        assert _wait_for(b, _pool(p["B"], cfg, 40, 7), 40, 7)
    finally:
        stop.set()
        follower.join(30)
        server.shutdown()
        th.join(30)
        server.server_close()
        synth.close()
    assert not follower.is_alive()


def test_profile(snaps, tmp_path, monkeypatch):
    cfg, p, paths, _ = snaps
    prof = str(tmp_path / "prof")
    with _server(["--snapshot", paths["A"], "--profile-dir", prof]) as b:
        box = {}
        th = threading.Thread(target=lambda: box.update(
            first=_post(b, "/profile?seconds=2")))
        th.start()
        time.sleep(0.3)
        code, reply = _post(b, "/profile?seconds=1")
        assert code == 409 and "running" in reply["error"]
        # requests are served during the capture
        np.testing.assert_array_equal(_synth(b, 40, 3),
                                      _k1(p["A"], cfg, 40, 3))
        assert th.is_alive()
        th.join(60)
        code, reply = box["first"]
        assert code == 200 and reply["seconds"] == 2.0
        assert os.path.dirname(reply["trace"]) == prof
        with open(reply["trace"]) as f:
            assert json.load(f)["traceEvents"]
        # clamped to [0.1, 60]; a bad value is 400
        assert _post(b, "/profile?seconds=0")[1]["seconds"] == 0.1
        assert _post(b, "/profile?seconds=x")[0] == 400

        # a trace that fails to stop answers 500 and frees the lock
        @contextlib.contextmanager
        def broken(log_dir):
            yield os.path.join(log_dir, "never.json")
            raise OSError("disk full")

        monkeypatch.setattr(srv.profiling, "trace", broken)
        code, reply = _post(b, "/profile?seconds=0.1")
        assert code == 500 and "disk full" in reply["error"]
        monkeypatch.undo()
        assert _post(b, "/profile?seconds=0.1")[0] == 200


def test_backend(snaps):
    cfg, p, paths, _ = snaps
    with pytest.raises(SystemExit, match="single-stream path"):
        srv.main(["--snapshot", paths["A"], "--backend", "plain",
                  "--batcher", "--device", "cpu"])
    for backend in ("xla", "fused"):
        with pytest.raises(ValueError, match="backend"):
            srv.Synthesizer(p["A"], cfg, device="cpu", backend=backend)
    with pytest.raises(ValueError, match="single-stream path"):
        srv.Synthesizer(p["A"], cfg, device="cpu", backend="plain",
                        batcher_opts={"lanes": 2})
    with _server(["--snapshot", paths["A"], "--backend", "auto"]) as b:
        assert _health(b)["backend"] == "cpu-plain"
    with _server(["--snapshot", paths["A"], "--backend", "plain"]) as b:
        assert _health(b)["backend"] == "cpu-plain"
        for temperature in (0.0, 0.9):
            _, cls = pt.generate_fast(p["A"], cfg,
                                      torch.Generator().manual_seed(6), 40,
                                      temperature=temperature, device="cpu")
            np.testing.assert_array_equal(
                _synth(b, 40, 6, temperature, chunk=15),
                _to_pcm(cls[0], cfg.classes))


def test_torch_snapshot(tmp_path):
    cfgj = wt.WaveNetConfig(layers=3, blocks=2, dilation_channels=8,
                            residual_channels=8, skip_channels=16,
                            end_channels=16, classes=32, bias=True)
    sd = _random_state_dict(cfgj, seed=21)
    path = str(tmp_path / "ref_model.pt")
    _save_reference_like_module(cfgj, sd, path)
    params, cfg = pt.load_reference_snapshot(path, device="cpu")
    jp, jcfg = jconv.load_reference_snapshot(path)
    # jax flattens dicts in key order: the leaves pair up by path
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_leaves_with_path(pt.to_numpy_params(params)),
            jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                             jp))):
        assert ka == kb and np.array_equal(a, b), ka
    with _server(["--torch-snapshot", path]) as b:
        h = _health(b)
        assert h["receptive_field"] == cfg.receptive_field
        assert h["parameter_count"] == cfgj.parameter_count()
        got = _synth(b, 40, 2)
    np.testing.assert_array_equal(got, _k1(params, cfg, 40, 2))
    _, cj = wt.generate_fast(jp, jcfg, jax.random.PRNGKey(0), 40,
                             jnp.full((1, 1), cfg.classes // 2, jnp.int32),
                             temperature=0.0)
    np.testing.assert_array_equal(got, _to_pcm(np.asarray(cj)[0],
                                               cfg.classes))
    # a bare state dict needs its split
    bare = str(tmp_path / "bare.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, bare)
    with pytest.raises(ValueError, match="layers, blocks"):
        srv.main(["--torch-snapshot", bare, "--device", "cpu"])
    with _server(["--torch-snapshot", bare, "--torch-layers", "3",
                  "--torch-blocks", "2"]) as b:
        np.testing.assert_array_equal(_synth(b, 40, 2), got)
    for extra, match in ((["--ema"], "ema"),
                         (["--student-snapshot", path], "two models")):
        with pytest.raises(SystemExit, match=match):
            srv.main(["--torch-snapshot", path, "--device", "cpu", *extra])


def test_follower_refused_with_a_student(tmp_path):
    with pytest.raises(SystemExit, match="cannot reload"):
        srv.main(["--student-snapshot", str(tmp_path / "s.ckpt"),
                  "--reload-interval", "1", "--device", "cpu"])
