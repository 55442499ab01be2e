"""The mesh-mode trainer, its sharded snapshots and the training CLI's
``--mesh-*`` on 2 gloo ranks, on the CPU at the ``tiny`` preset.

The trainer at meshes (2, 1) and (1, 2): a sharded snapshot written on the
checkpointer's thread at step 4, a run resumed from it that ends bitwise
where the uninterrupted one ends, and validation that computes each test
item once (equal to one rank's). The port's sharded snapshot is read by
the JAX package's ``load_checkpoint_sharded`` bitwise, ``latest_checkpoint``
of both packages picks it, and a shard with missing blocks or a missing
shard file is refused. The CLI runs under ``torch.distributed.run`` on 2
ranks, and ``--resume`` crosses between 1 and 2 ranks both ways.
"""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import pytorch_wavenet_tpu_torch as pt
import torch_parallel_cases as cases
from pytorch_wavenet_tpu.training.optimizers import reference_adam as jadam
from pytorch_wavenet_tpu.utils import checkpoints as jck
from pytorch_wavenet_tpu_torch.training import train as train_cli
from pytorch_wavenet_tpu_torch.utils import checkpoints as tck
from pytorch_wavenet_tpu_torch.utils.msgpack_lite import packb, unpackb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAP4 = "m_0000000004.ckpt.sharded"


def _audio(d):
    os.makedirs(d, exist_ok=True)
    t = np.arange(16000) / 16000.0
    pt.write_wav(os.path.join(d, "tone.wav"), 0.5 * np.sin(
        2 * np.pi * 330 * t) * np.sin(2 * np.pi * 1.5 * t), 16000)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trainer"))
    cfg = cases.config("tiny")
    ds_file = os.path.join(d, "ds.npz")
    pt.WaveNetDataset(dataset_file=ds_file, item_length=cfg.item_length,
                      target_length=cfg.output_length,
                      file_location=_audio(os.path.join(d, "audio")),
                      classes=cfg.classes, test_stride=cases.TEST_STRIDE)
    cases.spawn("trainer", 2, d, ds_file)
    return d


@pytest.mark.parametrize("mesh", ["21", "12"])
def test_trainer_snapshot_resume_validate(runs, mesh):
    got = cases.load(runs, f"trainer{mesh}")
    assert int(got["resumed_at"]) == 4
    for k in got:
        if k.startswith("at6/"):
            np.testing.assert_array_equal(got["resumed6/" + k[4:]], got[k])
    # written on the checkpointer's worker thread, once per rank
    assert [str(t).startswith("ckpt") for t in got["writer_threads"]] == [
        True]
    # each test item once across the mesh: one rank's validation
    cfg = cases.config("tiny")
    ds = cases.trainer_dataset(cfg, os.path.join(runs, "ds.npz"))
    ds.train = False
    assert len(ds) % cases.VALID_BATCH == 0
    ds.train = True
    one = pt.WaveNetTrainer(cfg, pt.from_jax_params(cases.params_of(cfg),
                                                   "cpu"), ds, lr=cases.LR,
                            num_workers=0, device="cpu")
    assert one.resume(os.path.join(runs, f"snaps{mesh}")) == 4
    loss, acc = one.validate(batch_size=cases.VALID_BATCH)
    np.testing.assert_allclose(got["validation"], [loss, acc], rtol=1e-5,
                               atol=1e-6)


def test_sharded_snapshot_read_by_jax_bitwise(runs):
    """The (1, 2) snapshot: JAX's reader gives the gathered params
    bitwise, the Adam state the port's reader gives, and both packages'
    ``latest_checkpoint`` pick it."""
    snaps = os.path.join(runs, "snaps12")
    path = os.path.join(snaps, SNAP4)
    got = cases.load(runs, "trainer12")
    cfgj = jck.load_checkpoint_sharded(path)["config"]
    tx = jadam(cases.LR)
    blob = jck.load_checkpoint_sharded(path)
    template = tx.init(jax.tree.map(np.asarray, blob["params"]))
    jblob = jck.load_checkpoint_sharded(path, opt_state_template=template)
    assert jblob["step"] == 4 and cfgj.skip_channels == 16
    for k, v in cases.flat(jblob["params"]).items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, got["at4/" + k], err_msg=k)
    tblob = tck.load_checkpoint_sharded(path)
    mu = cases.flat(jax.tree.map(np.asarray, jblob["opt_state"][0].mu))
    for k, v in cases.flat(tblob["opt_state"]["0"]["mu"]).items():
        np.testing.assert_array_equal(v, mu[k], err_msg=k)
    assert int(tblob["opt_state"]["0"]["count"]) == 4
    assert jck.latest_checkpoint(snaps) == tck.latest_checkpoint(snaps) == (
        path)


def test_sharded_snapshot_coverage_checked(runs, tmp_path):
    src = os.path.join(runs, "snaps12", SNAP4)
    holed = str(tmp_path / "holed" / SNAP4)
    shutil.copytree(src, holed)
    shard = os.path.join(holed, "shards_p1.msgpack")
    with open(shard, "rb") as f:
        blob = unpackb(f.read())
    assert "params/layers/w_skip" in blob["shards"]  # model block 1
    del blob["shards"]["params/layers/w_skip"]
    with open(shard, "wb") as f:
        f.write(packb(blob))
    for reader in (tck.load_checkpoint_sharded, jck.load_checkpoint_sharded):
        with pytest.raises(ValueError, match="missing data"):
            reader(holed)
    os.remove(shard)
    assert tck.latest_checkpoint(os.path.dirname(holed)) is None
    with pytest.raises(FileNotFoundError, match="incomplete"):
        tck.load_checkpoint_sharded(holed)


def _torchrun(args, out):
    """The training CLI on 2 CPU ranks; returns rank 0's output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m",
           "pytorch_wavenet_tpu_torch.training.train"] + args + [
               "--device", "cpu"]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=180)
    with open(out, "w") as f:
        f.write(r.stdout + r.stderr)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_cli_two_ranks_and_resume_across_rank_counts(tmp_path):
    audio = _audio(str(tmp_path / "audio"))
    base = ["--data-dir", audio, "--config", "tiny", "--batch-size", "4",
            "--snapshot-interval", "3", "--log-interval", "1",
            "--validation-interval", "3"]
    two = str(tmp_path / "two")
    out = _torchrun(base + ["--snapshot-path", two, "--max-steps", "3",
                            "--mesh-data", "1", "--mesh-model", "2"],
                    tmp_path / "two.log")
    assert "backend gloo" in out and "mesh: {'data': 1, 'model': 2}" in out
    assert out.count("loss at step") == 3  # rank 0 alone prints
    assert os.listdir(two) == ["tiny_model_0000000003.ckpt.sharded"]
    # 2 ranks -> 1 rank
    tr = train_cli.main(base + ["--snapshot-path", two, "--max-steps", "5",
                                "--resume", "--device", "cpu"])
    assert tr.step == 5 and tr.mesh is None
    # 1 rank -> 2 ranks (data-parallel), from a single-file snapshot
    one = str(tmp_path / "one")
    train_cli.main(base + ["--snapshot-path", one, "--max-steps", "3",
                           "--device", "cpu"])
    out = _torchrun(base + ["--snapshot-path", one, "--max-steps", "5",
                            "--resume", "--snapshot-interval", "5"],
                    tmp_path / "resume.log")
    assert "resuming at step 3" in out
    assert "mesh: {'data': 2, 'model': 1}" in out
    assert os.path.isdir(os.path.join(one,
                                      "tiny_model_0000000005.ckpt.sharded"))
    with pytest.raises(ValueError, match="1x2 != 1 ranks"):
        train_cli.main(base + ["--snapshot-path", one, "--max-steps", "1",
                               "--mesh-data", "1", "--mesh-model", "2",
                               "--device", "cpu"])
