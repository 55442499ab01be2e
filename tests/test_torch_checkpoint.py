"""Checkpoints cross between the packages bitwise, and the port's msgpack
codec needs no msgpack package."""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch.utils import msgpack_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_params(cfg, seed):
    shapes = jax.eval_shape(lambda: wt.init_wavenet(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _assert_same_tree(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_same_tree(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y)


def test_jax_checkpoint_loads_in_port(tmp_path):
    cfg = wt.get_config("tiny")
    npp = _np_params(cfg, 0)
    path = wt.save_checkpoint(str(tmp_path), "m", 7,
                              jax.tree.map(jnp.asarray, npp), cfg=cfg,
                              extra={"note": "x"})
    blob = pt.load_checkpoint(path, device="cpu")
    assert blob["step"] == 7
    assert blob["config"] == pt.get_config("tiny")
    assert blob["extra"] == {"note": "x"}
    _assert_same_tree(pt.to_numpy_params(blob["params"]), npp)


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg = pt.get_config("test_small")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(3), "cpu")
    path = pt.save_checkpoint(str(tmp_path), "m", 12, params, cfg=cfg)
    blob = wt.load_checkpoint(path)
    assert blob["step"] == 12
    assert blob["config"] == wt.get_config("test_small")
    assert blob["opt_state"] is None
    _assert_same_tree(blob["params"], pt.to_numpy_params(params))


def test_optimizer_state_of_a_jax_checkpoint_comes_back_as_numpy(tmp_path):
    import optax

    cfg = wt.get_config("tiny")
    jp = jax.tree.map(jnp.asarray, _np_params(cfg, 1))
    opt = optax.adam(1e-3).init(jp)
    path = wt.save_checkpoint(str(tmp_path), "m", 3, jp, opt_state=opt,
                              cfg=cfg)
    blob = pt.load_checkpoint(path, device="cpu")
    mu = blob["opt_state"]["0"]["mu"]["end2"]["w"]
    np.testing.assert_array_equal(mu, np.asarray(opt[0].mu["end2"]["w"]))


def test_latest_checkpoint_picks_the_same_file(tmp_path):
    cfg = wt.get_config("tiny")
    jp = jax.tree.map(jnp.asarray, _np_params(cfg, 2))
    for step in (5, 40, 9):
        wt.save_checkpoint(str(tmp_path), "run", step, jp, cfg=cfg)
    p = pt.save_checkpoint(str(tmp_path), "other", 40,
                           pt.from_jax_params(_np_params(cfg, 2), "cpu"),
                           cfg=pt.get_config("tiny"))
    later = time.time() + 5
    os.utime(p, (later, later))  # same step, newer file: wins on mtime
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    assert pt.latest_checkpoint(str(tmp_path)) == \
        wt.latest_checkpoint(str(tmp_path)) == p
    blob = pt.load_latest_model_from(str(tmp_path), device="cpu")
    assert blob["step"] == 40
    assert pt.latest_checkpoint(str(tmp_path / "missing")) is None
    with pytest.raises(FileNotFoundError):
        pt.load_latest_model_from(str(tmp_path / "missing"), device="cpu")


def test_codec_matches_flax_on_mixed_values():
    from flax import serialization

    obj = {
        "a": np.arange(6, dtype=np.int32).reshape(2, 3),
        "b": np.float32(1.5),
        "c": [1, -1, -33, 200, 70000, -70000, 2**40, -(2**40)],
        "d": {"nested": "text" * 20, "none": None, "t": True, "f": False},
        "e": 3.25,
        "g": b"\x00\x01" * 200,
        "h": np.zeros((0, 4), np.float64),
        "i": np.ones(70000, np.uint8),
    }
    ours = msgpack_lite.unpackb(serialization.msgpack_serialize(obj))
    theirs = serialization.msgpack_restore(serialization.msgpack_serialize(obj))
    back = serialization.msgpack_restore(msgpack_lite.packb(obj))
    for decoded in (ours, back):
        np.testing.assert_array_equal(decoded["a"], obj["a"])
        assert decoded["b"] == obj["b"] and decoded["e"] == 3.25
        assert list(decoded["c"]) == obj["c"]
        assert decoded["d"] == obj["d"]
        assert decoded["g"] == obj["g"]
        assert decoded["h"].shape == (0, 4)
        np.testing.assert_array_equal(decoded["i"], obj["i"])
    assert theirs["d"] == ours["d"]


def test_codec_works_without_msgpack(tmp_path):
    """With msgpack hidden, the port writes and reads a checkpoint, and
    reads one that flax wrote."""
    cfg = wt.get_config("tiny")
    jax_ckpt = wt.save_checkpoint(str(tmp_path / "j"), "m", 1,
                                  jax.tree.map(jnp.asarray, _np_params(cfg, 4)),
                                  cfg=cfg)
    code = f"""
import sys
sys.modules["msgpack"] = None
import torch
import pytorch_wavenet_tpu_torch as pt
cfg = pt.get_config("tiny")
p = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
path = pt.save_checkpoint({str(tmp_path / "t")!r}, "m", 2, p, cfg=cfg)
b = pt.load_checkpoint(path, "cpu")
assert b["config"] == cfg and b["step"] == 2
assert torch.equal(b["params"]["layers"]["w_in"], p["layers"]["w_in"])
j = pt.load_checkpoint({jax_ckpt!r}, "cpu")
assert j["step"] == 1 and j["config"] == cfg
assert "msgpack" not in sys.modules or sys.modules["msgpack"] is None
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
