"""The port reads the JAX package's sharded checkpoints, on the CPU at the
``tiny`` preset.

A sharded checkpoint is a directory ``{name}_{step:010d}.ckpt.sharded``
(JAX ``utils/checkpoints.py::save_checkpoint_sharded``): a manifest and
one shard file per process. The JAX package writes them here from a
model and an Adam state sharded over a (4, 2) mesh of the suite's CPU
devices, so a leaf arrives in several entries. The port must pick the
snapshot the JAX package picks and read it bitwise: params, optimizer
state and extra. Incomplete directories are never picked, entry lists
restored as dicts of string indices are read, a hole in the coverage
raises, and a training run resumed from a sharded snapshot ends bitwise
where one resumed from the single file of the same step ends.
"""

import os
import shutil

import jax
import numpy as np
import pytest
from flax import serialization
from jax.sharding import Mesh

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.parallel.sharding import (shard_opt_state,
                                                   shard_params)
from pytorch_wavenet_tpu.training.optimizers import reference_adam
from pytorch_wavenet_tpu.utils import checkpoints as jck
from pytorch_wavenet_tpu_torch.training import optimizers as topt
from pytorch_wavenet_tpu_torch.training import train as train_cli
from pytorch_wavenet_tpu_torch.utils import checkpoints as tck


def _mesh():
    return Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))


@pytest.fixture(scope="module")
def sharded():
    cfg = wt.get_config("tiny")
    params = wt.init_wavenet(jax.random.PRNGKey(0), cfg)
    tx = reference_adam(1e-3, weight_decay=0.01, gradient_clipping=1.0)
    opt_state = tx.init(params)
    # one step, so the moments are not all zero
    grads = jax.tree_util.tree_map(lambda p: 0.01 * p + 0.001, params)
    _, opt_state = tx.update(grads, opt_state, params)
    mesh = _mesh()
    sp = shard_params(params, cfg, mesh)
    so = shard_opt_state(opt_state, sp, mesh)
    return cfg, params, opt_state, sp, so


def _assert_tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path


def _write_pair(tmp_path, sharded):
    """The JAX package writes a file at step 5 and a complete sharded
    directory at step 10."""
    cfg, params, opt_state, sp, so = sharded
    jck.save_checkpoint(str(tmp_path), "snap", 5, params, opt_state=opt_state,
                        cfg=cfg)
    return jck.save_checkpoint_sharded(str(tmp_path), "snap", 10, sp,
                                       opt_state=so, cfg=cfg,
                                       extra={"note": "sharded"})


def test_latest_and_load_equal_jax(sharded, tmp_path):
    """Fails before the port read sharded directories: it picked and
    loaded step 5."""
    p10 = _write_pair(tmp_path, sharded)
    assert jck.latest_checkpoint(str(tmp_path)) == p10
    assert tck.latest_checkpoint(str(tmp_path)) == p10
    ref = jck.load_checkpoint_sharded(p10)
    for blob in (pt.load_checkpoint(p10, "cpu"),
                 pt.load_latest_model_from(str(tmp_path), "cpu")):
        assert blob["step"] == ref["step"] == 10
        assert blob["config"].to_json() == ref["config"].to_json()
        assert blob["extra"] == ref["extra"] == {"note": "sharded"}
        _assert_tree_equal(pt.to_numpy_params(blob["params"]),
                           jax.tree_util.tree_map(np.asarray, ref["params"]))
        _assert_tree_equal(blob["opt_state"], ref["opt_state"])
    # the file of step 5 still reads as before
    f5 = tck.checkpoint_path(str(tmp_path), "snap", 5)
    assert pt.load_checkpoint(f5, "cpu")["step"] == 5


def test_incomplete_directory_is_never_picked(sharded, tmp_path):
    cfg, _, _, sp, so = sharded
    p10 = _write_pair(tmp_path, sharded)
    p30 = jck.save_checkpoint_sharded(str(tmp_path), "snap", 30, sp,
                                      opt_state=so, cfg=cfg)
    os.remove(os.path.join(p30, "shards_p0.msgpack"))
    assert jck.latest_checkpoint(str(tmp_path)) == p10
    assert tck.latest_checkpoint(str(tmp_path)) == p10
    with pytest.raises(FileNotFoundError, match="incomplete"):
        pt.load_checkpoint(p30, "cpu")
    shutil.rmtree(p30)
    os.makedirs(p30)  # no manifest at all
    assert tck.latest_checkpoint(str(tmp_path)) == p10
    with pytest.raises(FileNotFoundError, match="no manifest"):
        pt.load_checkpoint(p30, "cpu")


def _rewrite_shards(path, edit):
    sf = os.path.join(path, "shards_p0.msgpack")
    with open(sf, "rb") as f:
        blob = serialization.msgpack_restore(f.read())
    edit(blob["shards"])
    with open(sf, "wb") as f:
        f.write(serialization.msgpack_serialize(blob))


def test_entry_lists_as_dicts_of_string_indices(sharded, tmp_path):
    cfg, params, _, sp, so = sharded
    path = jck.save_checkpoint_sharded(str(tmp_path), "m", 1, sp,
                                       opt_state=so, cfg=cfg)

    def as_dicts(shards):
        for key, entries in shards.items():
            # reversed, so that only the sort by index restores the order
            shards[key] = {str(i): e for i, e in
                           reversed(list(enumerate(entries)))}

    _rewrite_shards(path, as_dicts)
    blob = pt.load_checkpoint(path, "cpu")
    _assert_tree_equal(pt.to_numpy_params(blob["params"]),
                       jax.tree_util.tree_map(np.asarray, params))
    _assert_tree_equal(blob["opt_state"],
                       jck.load_checkpoint_sharded(path)["opt_state"])


def test_coverage_check_raises(sharded, tmp_path):
    cfg, _, _, sp, _ = sharded
    path = jck.save_checkpoint_sharded(str(tmp_path), "m", 1, sp, cfg=cfg)
    amputated = []

    def drop_one(shards):
        key = next(k for k, v in shards.items()
                   if len(v) > 1 and k.startswith("params/"))
        shards[key].pop(0)
        amputated.append(key[len("params/"):])

    _rewrite_shards(path, drop_one)
    with pytest.raises(ValueError, match="missing data") as e:
        pt.load_checkpoint(path, "cpu")
    assert amputated[0] in str(e.value)


def test_resume_from_sharded_equals_resume_from_file(tmp_path):
    """The training CLI resumes from the JAX package's sharded form of its
    own step-3 snapshot (params sharded over the mesh) and ends bitwise
    where the resume from the file ends."""
    data = tmp_path / "audio"
    data.mkdir()
    t = np.arange(16000) / 16000.0
    pt.write_wav(str(data / "sine.wav"),
                 0.6 * np.sin(2 * np.pi * 110 * t), 16000)
    base = ["--data-dir", str(data), "--config", "tiny", "--batch-size", "4",
            "--device", "cpu", "--test-stride", "20", "--lr", "1e-3",
            "--log-interval", "100", "--validation-interval", "100",
            "--generate-interval", "1000",
            "--dataset-file", str(tmp_path / "d.npz")]
    train_cli.main(base + ["--snapshot-path", str(tmp_path / "a"),
                           "--snapshot-interval", "3", "--max-steps", "3"])
    snap = tck.checkpoint_path(str(tmp_path / "a"), "tiny_model", 3)
    os.makedirs(tmp_path / "file")
    shutil.copy(snap, tmp_path / "file")
    ref = jck.load_checkpoint(snap)
    cfg = ref["config"]
    sp = shard_params(ref["params"], cfg, _mesh())
    path = jck.save_checkpoint_sharded(str(tmp_path / "dir"), "tiny_model", 3,
                                       sp, opt_state=ref["opt_state"],
                                       cfg=cfg)
    assert tck.latest_checkpoint(str(tmp_path / "dir")) == path
    runs = [train_cli.main(base + ["--snapshot-path", str(tmp_path / d),
                                   "--snapshot-interval", "100",
                                   "--max-steps", "6", "--resume"])
            for d in ("file", "dir")]
    assert runs[0].step == runs[1].step == 6
    a, b = ({"p": pt.to_numpy_params(r.params),
             "o": r.tx.state_dict(r.opt_state)} for r in runs)
    for (pa, x), (_, y) in zip(topt._leaves(a), topt._leaves(b)):
        assert np.array_equal(x, y), pa
