"""The training remainder of the port against the JAX package, on the CPU
at the ``tiny`` preset: snapshots resumed across the packages for every
optimizer stack the training CLI builds (one taken in the middle of an
accumulation), the asynchronous checkpointer, ``generate_audio``, the CLI
with its new flags, ``serve --ema``, and the TensorBoard records.

Tolerances: a run resumed from the other package's snapshot ends within
atol = rtol = 1e-5 of that package's uninterrupted run (params and every
optimizer-state leaf; counts exactly); a run resumed from its own
package's snapshot ends there bitwise. ``generate_audio`` at temperature
0 gives the JAX function's classes until the first step whose top-2 logit
gap is under 1e-4 (a near-tie; the two sum in other orders). Event-file
payloads are byte-equal at a fixed wall time.
"""

import json
import os
import shutil
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.training import optimizers as jopt
from pytorch_wavenet_tpu.training.trainer import WaveNetTrainer as JaxTrainer
from pytorch_wavenet_tpu.training.trainer import (
    generate_audio as jax_generate_audio,
)
from pytorch_wavenet_tpu.utils import logging as jlogging
from pytorch_wavenet_tpu.utils import tensorboard as jtb
from pytorch_wavenet_tpu_torch.ops.mulaw import dequantize_to_f32
from pytorch_wavenet_tpu_torch.serving import server as srv
from pytorch_wavenet_tpu_torch.training import optimizers as topt
from pytorch_wavenet_tpu_torch.training import train as train_cli
from pytorch_wavenet_tpu_torch.training.trainer import generate_audio
from pytorch_wavenet_tpu_torch.utils import checkpoints as tck
from pytorch_wavenet_tpu_torch.utils import logging as tlogging
from pytorch_wavenet_tpu_torch.utils import tensorboard as ttb
from test_torch_optimizers import assert_state_close


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("audio")
    t = np.arange(16000) / 16000.0
    wav = 0.6 * np.sin(2 * np.pi * 110 * t) * np.sin(2 * np.pi * 0.5 * t)
    pt.write_wav(os.path.join(str(d), "sine.wav"), wav, 16000)
    return str(d)


@pytest.fixture(scope="module")
def dataset(audio_dir, tmp_path_factory):
    cfg = pt.get_config("tiny")
    return pt.WaveNetDataset(
        str(tmp_path_factory.mktemp("ds") / "d.npz"),
        item_length=cfg.item_length, target_length=cfg.output_length,
        file_location=audio_dir, classes=cfg.classes, test_stride=20)


def _stack(m, ms, opt, accum=1, ema=None, **kw):
    """The training CLI's stack in package ``m`` (``ms`` its MultiSteps)."""
    if opt == "sgd":
        tx = m.sgd_normalized(lr=1e-2, **kw)
    else:
        tx = m.reference_adam(m.lr_schedule(3e-3, *opt), **kw)
    if ema:
        tx = m.with_ema(tx, ema)
    return ms(tx, accum) if accum > 1 else tx


# every stack the training CLI builds: Adam under each schedule kind
# (with warmup, clip and decay), sgd_normalized with and without momentum,
# each with an EMA and with accumulation
CLI_STACKS = {
    "adam-constant": (("constant",), {}),
    "adam-cosine-warmup-clip-decay": (
        ("cosine", 2, 6, 0.1), dict(weight_decay=0.01, gradient_clipping=0.5)),
    "adam-exponential-warmup-ema": (("exponential", 1, 3, 0.5),
                                    dict(ema=0.9)),
    "sgd-momentum-ema": ("sgd", dict(momentum=0.9, ema=0.9)),
    "sgd": ("sgd", {}),
    "accum2-ema-adam-cosine": (("cosine", 1, 6, 0.1),
                               dict(accum=2, ema=0.9)),
    "accum3-sgd-momentum": ("sgd", dict(accum=3, momentum=0.9)),
}


def _build(name):
    opt, kw = CLI_STACKS[name]
    return (_stack(jopt, lambda tx, k: optax.MultiSteps(
                tx, every_k_schedule=k), opt, **kw),
            _stack(topt, topt.MultiSteps, opt, **kw))


class _Quiet(pt.Logger):
    def __init__(self):
        super().__init__(log_interval=10**9, validation_interval=10**9,
                         generate_interval=10**9)


@pytest.mark.parametrize("name", sorted(CLI_STACKS))
def test_snapshots_resume_across_packages(name, dataset, tmp_path):
    """Each package snapshots at micro-step 3 (for k = 2 in the middle of an
    accumulation: mini_step 1, a half-filled acc_grads); the other resumes
    it and ends at the writer's uninterrupted run within 1e-5; the port
    resumed from its own snapshot ends at its run bitwise."""
    cfg_j, cfg_t = wt.get_config("tiny"), pt.get_config("tiny")
    params_np = jax.tree.map(np.asarray, wt.init_wavenet(
        jax.random.PRNGKey(7), cfg_j))
    tx_j, tx_t = _build(name)
    run = dict(batch_size=4, epochs=10)

    def port(snap, interval=10**9):
        return pt.WaveNetTrainer(cfg_t, pt.from_jax_params(params_np, "cpu"),
                                 dataset, optimizer=tx_t, logger=_Quiet(),
                                 snapshot_path=snap, snapshot_name="m",
                                 snapshot_interval=interval, seed=3,
                                 device="cpu", num_workers=0)

    def jax_trainer(snap, interval=10**9):
        return JaxTrainer(cfg_j, jax.tree.map(jnp.asarray, params_np), dataset,
                          optimizer=tx_j, logger=_Quiet(), snapshot_path=snap,
                          snapshot_name="m", snapshot_interval=interval,
                          seed=3, num_workers=0)

    def port_state(tr):
        return pt.to_numpy_params(tr.params), tr.tx.state_dict(tr.opt_state)

    def bitwise(a, b):
        for (pa, x), (_, y) in zip(topt._leaves(dict(enumerate(a))),
                                   topt._leaves(dict(enumerate(b)))):
            assert (x is None and y is None) or np.array_equal(x, y), pa

    def jax_state(tr):
        return (jax.tree.map(np.asarray, tr.params),
                serialization.to_state_dict(jax.tree.map(np.asarray,
                                                         tr.opt_state)))

    snap_t, snap_j = str(tmp_path / "t"), str(tmp_path / "j")
    full_t = port(snap_t, 3)
    full_t.train(max_steps=6, **run)
    full_j = jax_trainer(snap_j, 3)
    full_j.train(max_steps=6, **run)
    for snap in (snap_t, snap_j):  # keep only the step-3 snapshots
        os.remove(tck.checkpoint_path(snap, "m", 6))
    if "accum2" in name:
        blob = pt.load_checkpoint(tck.latest_checkpoint(snap_j), "cpu")
        assert int(blob["opt_state"]["mini_step"]) == 1
        assert any(np.abs(a).max() > 0 for _, a in
                   topt._leaves(blob["opt_state"]["acc_grads"]))
    # the JAX snapshot, resumed by the port
    back = port(snap_j)
    assert back.resume() == 3
    back.train(continue_training_at_step=3, max_steps=6, **run)
    for got, ref in zip(port_state(back), jax_state(full_j)):
        assert_state_close(got, ref)
    # the port's snapshot, resumed by the JAX trainer with its template
    j = jax_trainer(snap_t)
    assert j.resume() == 3
    j.train(continue_training_at_step=3, max_steps=6, **run)
    for got, ref in zip(jax_state(j), port_state(full_t)):
        assert_state_close(got, ref)
    # and by the port: bitwise
    again = port(snap_t)
    assert again.resume() == 3
    again.train(continue_training_at_step=3, max_steps=6, **run)
    bitwise(port_state(again), port_state(full_t))


def test_async_checkpointer_writes_the_state_at_the_save(tmp_path):
    """Params and optimizer state changed in place after ``save`` do not
    reach the file; the optimizer state goes through ``state_dict`` on the
    worker."""
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    tx = topt.MultiSteps(topt.with_ema(topt.reference_adam(1e-3), 0.9), 2)
    state = tx.init(params)
    want_p = topt._map(lambda t: t.clone().numpy(), params)
    want_s = tx.state_dict(state)
    ck = tck.AsyncCheckpointer()
    gate = threading.Event()
    ck._ex.submit(gate.wait)  # hold the worker until the state has moved
    fut = ck.save(str(tmp_path), "m", 5, params, opt_state=state, cfg=cfg,
                  state_dict=tx.state_dict)
    with torch.no_grad():
        for _, t in topt._leaves(params):
            t.add_(1.0)
        state["inner_opt_state"]["ema"]["start"]["w"].add_(1.0)
    state["mini_step"] = 1
    assert not fut.done()
    gate.set()
    path = ck.wait()
    ck.close()
    blob = pt.load_checkpoint(path, device="cpu")
    assert blob["step"] == 5 and blob["config"] == cfg
    for (_, a), (_, b) in zip(topt._leaves(blob["params"]),
                              topt._leaves(want_p)):
        np.testing.assert_array_equal(a.numpy(), b)
    assert_state_close(blob["opt_state"], want_s)
    assert int(blob["opt_state"]["mini_step"]) == 0


def test_trainer_snapshot_is_async_and_train_waits(dataset, tmp_path):
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    tr = pt.WaveNetTrainer(cfg, params, dataset, logger=_Quiet(),
                           snapshot_path=str(tmp_path), snapshot_interval=2,
                           device="cpu", num_workers=0,
                           optimizer=topt.with_ema(topt.reference_adam(1e-3),
                                                   0.5))
    tr.train(batch_size=4, max_steps=4)
    assert tr._ckpt._pending is None  # train waited for the last save
    assert sorted(os.listdir(tmp_path)) == [
        "snapshot_0000000002.ckpt", "snapshot_0000000004.ckpt"]
    blob = pt.load_checkpoint(str(tmp_path / "snapshot_0000000004.ckpt"),
                              "cpu")
    for (_, a), (_, b) in zip(topt._leaves(blob["params"]),
                              topt._leaves(tr.params)):
        assert torch.equal(a, b.detach())
    names = [n for n, _ in tr.named_parameters()]
    assert names == [n for n, _ in tr.named_gradients()]
    assert "layers/w_in" in names and len(names) == len(
        list(topt._leaves(tr.params)))


def _near_tie_free_prefix(params, cfg, got, ref):
    """Steps before the first class that differs; that step must be a
    near-tie of the logits over the common prefix."""
    diff = np.nonzero(got != ref)[0]
    if not diff.size:
        return len(ref)
    t = int(diff[0])
    prefix = np.concatenate([[cfg.classes // 2], ref[:t]])[None]
    logits = pt.wavenet_logits(params, cfg, torch.from_numpy(prefix), 1)
    top = torch.topk(logits[0, -1].to(torch.float64), 2).values
    assert float(top[0] - top[1]) < 1e-4, (t, got[t], ref[t])
    return t


def _classes(wav, classes):
    levels = np.asarray(dequantize_to_f32(np.arange(classes), classes))
    return np.abs(np.asarray(wav)[..., None] - levels).argmin(-1)


def test_generate_audio_greedy_matches_jax():
    cfg_j, cfg_t = wt.get_config("tiny"), pt.get_config("tiny")
    params_np = jax.tree.map(np.asarray, wt.init_wavenet(
        jax.random.PRNGKey(3), cfg_j))
    ref = jax_generate_audio(jax.tree.map(jnp.asarray, params_np), cfg_j,
                             length=200, temperatures=(0.0, 0.0), seed=1)
    params = pt.from_jax_params(params_np, "cpu")
    got = generate_audio(params, cfg_t, length=200, temperatures=(0.0, 0.0),
                         seed=5, device="cpu")
    assert got.shape == ref.shape == (2, 200) and got.dtype == np.float32
    rc, gc = _classes(ref, cfg_t.classes), _classes(got, cfg_t.classes)
    for lane in range(2):
        n = _near_tie_free_prefix(params, cfg_t, gc[lane], rc[lane])
        assert n > 0
        np.testing.assert_allclose(got[lane, :n], ref[lane, :n], atol=1e-6)
    hot = generate_audio(params, cfg_t, length=64, temperatures=(1.0, 0.5),
                         seed=5, device="cpu")
    assert hot.shape == (2, 64) and np.all(np.abs(hot) <= 1.0 + 1e-6)
    np.testing.assert_array_equal(hot, generate_audio(
        params, cfg_t, length=64, temperatures=(1.0, 0.5), seed=5,
        device="cpu"))


FLAGS = ["--lr-schedule", "cosine", "--warmup-steps", "2", "--decay-steps",
         "6", "--min-lr-ratio", "0.1", "--accum-steps", "2", "--ema-decay",
         "0.9", "--clip", "1.0", "--weight-decay", "0.001"]


def _cli_base(audio_dir, tmp_path):
    data = str(tmp_path / "audio")
    if not os.path.isdir(data):
        shutil.copytree(audio_dir, data)
    return ["--data-dir", data, "--config", "tiny", "--batch-size", "4",
            "--device", "cpu", "--test-stride", "20", "--lr", "1e-3",
            "--log-interval", "3", "--validation-interval", "6"]


def test_training_cli_new_flags_snapshot_and_resume(audio_dir, tmp_path):
    """Every new flag at tiny: 6 micro-steps with snapshots at 3 (in the
    middle of an accumulation) and 6, the audio hook at step 6 into the
    event file; a run resumed from the step-3 snapshot ends at the
    uninterrupted run's params, EMA and optimizer state bitwise."""
    base = _cli_base(audio_dir, tmp_path) + FLAGS
    logs = str(tmp_path / "logs")
    a = train_cli.main(base + [
        "--snapshot-path", str(tmp_path / "a"), "--snapshot-interval", "3",
        "--max-steps", "6", "--log-dir", logs, "--generate-interval", "6",
        "--generate-length", "48"])
    a.logger.generate_thread.join(60)
    a.logger.flush()
    assert isinstance(a.tx, topt.MultiSteps) and a.opt_state["mini_step"] == 0
    snap = tck.checkpoint_path(str(tmp_path / "a"), "tiny_model", 3)
    os.makedirs(tmp_path / "b")
    shutil.copy(snap, tmp_path / "b")
    blob = pt.load_checkpoint(snap, "cpu")
    assert int(blob["opt_state"]["mini_step"]) == 1
    assert sorted(blob["opt_state"]["inner_opt_state"]) == ["ema", "inner"]
    b = train_cli.main(base + ["--snapshot-path", str(tmp_path / "b"),
                               "--max-steps", "6", "--resume",
                               "--generate-interval", "1000"])
    assert b.step == 6
    for (pa, x), (_, y) in zip(
            topt._leaves({"p": pt.to_numpy_params(a.params),
                          "o": a.tx.state_dict(a.opt_state)}),
            topt._leaves({"p": pt.to_numpy_params(b.params),
                          "o": b.tx.state_dict(b.opt_state)})):
        assert np.array_equal(x, y), pa
    events = ttb.read_events(a.logger.writer.path)
    kinds = {(t, k) for e in events for t, k, _ in e["values"]}
    assert {("loss", "scalar"), ("validation loss", "scalar"),
            ("layers/w_in", "histogram"), ("layers/w_in/grad", "histogram"),
            ("temperature_0.5/0", "audio"),
            ("temperature_1.0/0", "audio")} <= kinds


def test_training_cli_sgd_normalized_and_refusals(audio_dir, tmp_path):
    base = _cli_base(audio_dir, tmp_path) + [
        "--snapshot-path", str(tmp_path / "s"), "--max-steps", "3"]
    tr = train_cli.main(base + ["--optimizer", "sgd_normalized",
                                "--momentum", "0.9"])
    assert isinstance(tr.tx, topt.SGDNormalized) and tr.step == 3
    assert set(tr.tx.state_dict(tr.opt_state)) == {"momentum"}
    with pytest.raises(SystemExit, match="only apply to the adam"):
        train_cli.main(base + ["--optimizer", "sgd_normalized",
                               "--warmup-steps", "2"])
    with pytest.raises(ValueError, match="decay_steps"):
        train_cli.main(base + ["--lr-schedule", "cosine"])


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


def _synthesize(base, n, seed):
    with urllib.request.urlopen(
            f"{base}/synthesize?num_samples={n}&temperature=1.0&seed={seed}",
            timeout=120) as r:
        return np.frombuffer(r.read()[44:], "<i2")


def _solo(params, cfg, n, seed):
    kseed = int(torch.randint(0, 2**31 - 1, (1,),
                              generator=torch.Generator().manual_seed(seed)))
    wav, _ = pt.generate_fast_fused(params, cfg, kseed, n, None,
                                    temperature=1.0, fuse_res=True,
                                    device="cpu")
    return np.clip(wav.numpy()[0] * 32767.0, -32768, 32767).astype("<i2")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_serve_ema(writer, dataset, tmp_path):
    """``serve --ema`` answers with the EMA weights of a snapshot from
    either package (equal to a solo rollout of the EMA params that
    ``find_ema_state_dict`` takes from the same file), and refuses a
    snapshot without them."""
    cfg_j, cfg_t = wt.get_config("tiny"), pt.get_config("tiny")
    params_np = jax.tree.map(np.asarray, wt.init_wavenet(
        jax.random.PRNGKey(2), cfg_j))
    d = str(tmp_path / "snaps")
    if writer == "jax":
        tr = JaxTrainer(cfg_j, jax.tree.map(jnp.asarray, params_np), dataset,
                        optimizer=jopt.with_ema(jopt.reference_adam(3e-2),
                                                0.5),
                        logger=_Quiet(), snapshot_path=d,
                        snapshot_interval=3, num_workers=0)
    else:
        tr = pt.WaveNetTrainer(cfg_t, pt.from_jax_params(params_np, "cpu"),
                               dataset, optimizer=topt.with_ema(
                                   topt.reference_adam(3e-2), 0.5),
                               logger=_Quiet(), snapshot_path=d,
                               snapshot_interval=3, device="cpu",
                               num_workers=0)
    tr.train(batch_size=4, max_steps=3)
    path = tck.latest_checkpoint(d)
    blob = pt.load_checkpoint(path, "cpu")
    ema = pt.from_jax_params(topt.find_ema_state_dict(blob["opt_state"]),
                             "cpu")
    assert not all(torch.equal(a, b) for (_, a), (_, b) in zip(
        topt._leaves(ema), topt._leaves(blob["params"])))
    server, th = _serve(["--snapshot", path, "--ema"])
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        got = _synthesize(base, 40, 3)
    finally:
        server.shutdown()
        th.join(10)
    np.testing.assert_array_equal(got, _solo(ema, cfg_t, 40, 3))
    assert not np.array_equal(got, _solo(blob["params"], cfg_t, 40, 3))
    bare = str(tmp_path / "bare")
    pt.save_checkpoint(bare, "m", 1, blob["params"], cfg=cfg_t,
                       opt_state=topt.reference_adam(1e-3).state_dict(
                           topt.reference_adam(1e-3).init(blob["params"])))
    with pytest.raises(SystemExit, match="carries no EMA"):
        srv.main(["--snapshot-path", bare, "--ema", "--device", "cpu"])


class _FakeTrainer:
    def __init__(self, named, grads):
        self.named, self.grads = named, grads

    def named_parameters(self):
        return self.named

    def named_gradients(self):
        return self.grads

    def validate(self):
        return 2.5, 0.25


def test_tensorboard_records_equal_jax(tmp_path, monkeypatch):
    """At a fixed wall time the port's event file is byte-equal to the JAX
    writer's for the same scalars, histograms, audio and images, and the
    loggers write the same records (loss, per-parameter and per-gradient
    histograms, validation scalars, audio)."""
    assert ttb.crc32c(b"123456789") == 0xE3069283
    for mod in (jtb, ttb):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(1000).astype(np.float32)
    clip = np.sin(np.arange(800) / 9.0).astype(np.float32)
    img = rng.integers(0, 255, (6, 5, 3)).astype(np.uint8)
    paths = []
    for mod, d in ((jtb, "j"), (ttb, "t")):
        w = mod.SummaryWriter(str(tmp_path / d))
        w.add_scalar("loss", 1.25, 7)
        w.add_histogram("layers/w_in", vals, 7, bins=50)
        w.add_audio("temperature_1.0/0", clip, 7, sample_rate=16000)
        w.add_image("img", img, 7)
        w.close()
        paths.append(w.path)
    blobs = [open(p, "rb").read() for p in paths]
    assert blobs[0] == blobs[1]
    events = ttb.read_events(paths[1])
    assert events[0]["file_version"] == "brain.Event:2"
    assert [v[:2] for e in events[1:] for v in e["values"]] == [
        ("loss", "scalar"), ("layers/w_in", "histogram"),
        ("temperature_1.0/0", "audio"), ("img", "image")]
    assert events[1]["values"][0][2] == 1.25 and events[1]["step"] == 7
    # the loggers: the same records from the same values
    named = [("layers/w_in", vals.reshape(10, 100)), ("start/w", vals[:64])]
    grads = [(n, v * 0.5) for n, v in named]
    tnamed = [(n, torch.from_numpy(v)) for n, v in named]
    tgrads = [(n, torch.from_numpy(v)) for n, v in grads]
    for mod, d, nm, gr in ((jlogging, "jl", named, grads),
                           (tlogging, "tl", tnamed, tgrads)):
        lg = mod.TensorboardLogger(log_interval=2, validation_interval=2,
                                   generate_interval=10**9,
                                   log_dir=str(tmp_path / d))
        lg.trainer = _FakeTrainer(nm, gr)
        for step in (1, 2):
            lg.log(step, 0.5 * step)
        lg.audio_summary("temperature_0.5", clip[None], 2)
        lg.close()
        paths.append(lg.writer.path)
    assert open(paths[2], "rb").read() == open(paths[3], "rb").read()
    tags = [v[0] for e in ttb.read_events(paths[3]) for v in e["values"]]
    assert tags == ["loss", "layers/w_in", "start/w", "layers/w_in/grad",
                    "start/w/grad", "validation loss", "validation accuracy",
                    "temperature_0.5/0"]


def test_event_file_crc_is_checked(tmp_path):
    w = ttb.SummaryWriter(str(tmp_path))
    w.add_scalar("loss", 1.0, 1)
    w.close()
    data = bytearray(open(w.path, "rb").read())
    data[-6] ^= 0xFF  # a byte of the last payload
    open(w.path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        ttb.read_events(w.path)
    assert json.dumps(ttb.parse_fields(b"\x08\x96\x01")) == '{"1": [150]}'
