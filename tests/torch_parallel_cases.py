"""Multi-process cases of the port's ``parallel/`` on the CPU (gloo).

Imports no JAX: each rank is a process started by :func:`spawn`, which
runs one group of cases per mesh size and writes each case's arrays to
``{out}/{case}_r{rank}.npz``; the tests compare them, in the pytest
process, with the JAX package and with the port on one rank. The inputs
are made here from seeds, so both sides build the same ones.

  python tests/torch_parallel_cases.py <store> <world> <rank> <out> <group>
"""

from __future__ import annotations

import faulthandler
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytorch_wavenet_tpu_torch as pt  # noqa: E402
from pytorch_wavenet_tpu_torch.models.convert import to_numpy_params  # noqa: E402

LR = 1e-3
CLIP = 0.05      # small enough that the clip acts at these sizes
SGD_LR = 1e-2
GLOBAL_BATCH = 8
TIME_T = 32      # tiny at kernel_size 3: rf 29, halo 8; 2 and 4 blocks
POOL_LANES, POOL_CHUNK = 8, 6
PIPE_N = 20
PIPE_SCALE = 0.5
TEST_STRIDE = 31   # the trainer's dataset: 128 test items, 16 batches of 8
VALID_BATCH = 8


# ------------------------------------------------------------- the inputs


def config(name: str, **kw):
    return pt.get_config(name, **kw)


def params_of(cfg, seed: int = 0, scale: float | None = None) -> dict:
    """Random params from a seed, as numpy: the init's, or uniform in
    ``[-scale, scale]`` (rollouts that do not settle on one class)."""
    params = to_numpy_params(pt.init_wavenet(
        cfg, torch.Generator().manual_seed(seed), "cpu"))
    if scale is None:
        return params
    rng = np.random.default_rng(seed)
    return {k: {kk: rng.uniform(-scale, scale, v.shape).astype(np.float32)
                for kk, v in d.items()} for k, d in params.items()}


def batch(cfg, n: int = GLOBAL_BATCH, seed: int = 1):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.classes, (n, cfg.item_length)).astype(np.int32)
    y = rng.integers(0, cfg.classes, (n, cfg.output_length)).astype(np.int32)
    cond = (rng.normal(size=(n, cfg.item_length, cfg.cond_channels))
            .astype(np.float32) if cfg.cond_channels else None)
    return x, y, cond


def step_configs() -> dict:
    """The train-step cases: the plain trunk, the trunk kernel (its plain
    versions on the CPU) and the conditioned vocoder."""
    return {"plain": config("tiny"),
            "tk": config("tiny", trunk_kernel=True),
            "cond": config("tiny_vocoder")}


def pool_inputs(cfg):
    rng = np.random.default_rng(30)
    prime = rng.integers(0, cfg.classes,
                         (POOL_LANES, cfg.receptive_field)).astype(np.int32)
    temps = np.asarray([0.0, 1.0, 0.7, 0.0, 1.3, 1.0, 0.0, 0.9], np.float32)
    seeds = np.arange(POOL_LANES, dtype=np.int32) * 17
    toffs = np.asarray([0, 3, 0, 0, -2, 0, 1, 0], np.int32)
    return prime, temps, seeds, toffs


def pool_state(cfg, params):
    """The pool after a one-step prime of every lane (the whole pool)."""
    prime, temps, seeds, toffs = pool_inputs(cfg)
    _, _, st = pt.generate_fast_batched(
        params, cfg, 0, 1, prime, temperature=temps, lane_seed=seeds,
        lane_clock=toffs, return_state=True, device="cpu")
    return st


def time_inputs(cfg):
    rng = np.random.default_rng(5)
    x = rng.integers(0, cfg.classes, (2, TIME_T)).astype(np.int32)
    t = rng.integers(0, cfg.classes, (2, TIME_T)).astype(np.int32)
    return x, t


def pipe_configs() -> dict:
    """Layer counts that divide into 2 and into 4 stages."""
    return {2: config("tiny"), 4: config("tiny", blocks=4)}


def pipe_prime(cfg, streams: int, seed: int = 7, length=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.classes,
                        (streams, length or cfg.receptive_field))


def flat(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree.detach().cpu().numpy() if isinstance(
            tree, torch.Tensor) else np.asarray(tree)
    return out


# ------------------------------------------------------------ the workers


def _tensors(tree):
    return pt.from_jax_params(tree, "cpu")


def case_step(mesh) -> dict:
    """Forward and one ``parallel_train_step`` on the global batch for each
    step config; with ``model > 1`` also the clipped Adam, two
    ``sgd_normalized`` steps and the gathered gradients."""
    from pytorch_wavenet_tpu_torch.parallel import sharding, training
    from pytorch_wavenet_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                         MODEL_AXIS,
                                                         all_gather,
                                                         axis_size)
    from pytorch_wavenet_tpu_torch.training.optimizers import (
        reference_adam, sgd_normalized)

    out = {}
    for name, cfg in step_configs().items():
        full = _tensors(params_of(cfg))
        x, y, cond = batch(cfg)
        local = sharding.shard_params(full, cfg, mesh)
        if name == "plain":
            rows = sharding.batch_sharding(mesh, len(x))
            with torch.no_grad():
                lg = pt.wavenet_logits(local, cfg, torch.from_numpy(x[rows]),
                                       mesh=mesh)
            out["logits"] = all_gather(lg, mesh, DATA_AXIS).numpy()
            out["w_skip_local_shape"] = np.asarray(
                local["layers"]["w_skip"].shape)
        tx = reference_adam(LR)
        p, o = training.make_sharded_train_state(cfg, full, tx, mesh)
        _, _, loss = training.parallel_train_step(
            p, o, cfg, tx, x, y, cond=cond, mesh=mesh, device="cpu")
        out[f"{name}/loss"] = loss.numpy()
        out.update(flat(sharding.gather_params(p, cfg, mesh),
                        f"{name}/params/"))
    if axis_size(mesh, MODEL_AXIS) > 1:
        cfg = config("tiny")
        full = _tensors(params_of(cfg))
        x, y, _ = batch(cfg)
        for name, tx, steps in (
                ("clip", reference_adam(LR, gradient_clipping=CLIP), 1),
                ("sgd", sgd_normalized(SGD_LR, momentum=0.9), 2)):
            p, o = training.make_sharded_train_state(cfg, full, tx, mesh)
            for _ in range(steps):
                training.parallel_train_step(p, o, cfg, tx, x, y, mesh=mesh,
                                             device="cpu")
            out.update(flat(sharding.gather_params(p, cfg, mesh),
                            f"{name}/params/"))
        p, o = training.make_sharded_train_state(cfg, full,
                                                 reference_adam(LR), mesh)
        xb, yb = training.put_batch(mesh, x, y, "cpu")
        _, grads = pt.train_step(p, o, cfg, reference_adam(LR), xb, yb,
                                 mesh=mesh)
        out.update(flat(sharding.gather_params(grads, cfg, mesh), "grads/"))
    return out


def case_generate(mesh) -> dict:
    """``sharded_generate_fast`` at T = 0 and 1, ``sharded_generate_fast_
    batched`` at T = 0 and 1, and the stream-count refusal."""
    from pytorch_wavenet_tpu_torch.parallel import training

    cfg = config("tiny")
    full = _tensors(params_of(cfg))
    prime = pipe_prime(cfg, 4, seed=21)
    out = {}
    for T in (0.0, 1.0):
        _, c = training.sharded_generate_fast(
            full, cfg, mesh, torch.Generator().manual_seed(6), 16, prime,
            temperature=T, device="cpu")
        out[f"fast_T{T}"] = c.numpy()
        _, c = training.sharded_generate_fast_batched(
            full, cfg, mesh, 22, 16, prime, temperature=T, device="cpu")
        out[f"batched_T{T}"] = c.numpy()
    try:
        training.sharded_generate_fast_batched(full, cfg, mesh, 22, 4,
                                               prime[:3], device="cpu")
    except ValueError as e:
        out["refused"] = np.asarray(str(e))
    return out


def case_iterator(mesh, dataset_file: str) -> dict:
    """Each rank's blocks of three global batches of 8 (after skipping
    one), all-gathered over data."""
    from pytorch_wavenet_tpu_torch.parallel.data_sharding import (
        ShardedBatchIterator)
    from pytorch_wavenet_tpu_torch.parallel.mesh import DATA_AXIS, all_gather

    ds = pt.WaveNetDataset(dataset_file=dataset_file, item_length=64,
                           target_length=8, file_location=None,
                           test_stride=50)
    out = {}
    for workers in (0, 2):
        it = ShardedBatchIterator(ds, 8, mesh, seed=3, skip_batches=1,
                                  num_workers=workers)
        for i, (x, y) in zip(range(3), it):
            out[f"w{workers}/x{i}"] = all_gather(
                torch.from_numpy(x), mesh, DATA_AXIS).numpy()
            out[f"w{workers}/y{i}"] = all_gather(
                torch.from_numpy(y), mesh, DATA_AXIS).numpy()
        out[f"w{workers}/len"] = np.asarray(len(it))
        out[f"w{workers}/local"] = np.asarray(it.local_batch_size)
    # the same blocks through data_parallel_batch_iterator over the global
    # batches, and rank 0's tensor replicated to every rank
    from pytorch_wavenet_tpu_torch.parallel.sharding import replicate
    from pytorch_wavenet_tpu_torch.parallel.training import (
        data_parallel_batch_iterator)

    glob = pt.BatchIterator(ds, 8, seed=3, skip_batches=1)
    mine = ShardedBatchIterator(ds, 8, mesh, seed=3, skip_batches=1)
    for (x, y), (xs, ys) in zip(data_parallel_batch_iterator(
            glob, mesh, "cpu"), mine):
        assert np.array_equal(x.numpy(), xs) and np.array_equal(y.numpy(), ys)
    rank = torch.distributed.get_rank()
    out["replicated"] = replicate(torch.full((3,), float(rank + 5)),
                                  mesh).numpy()
    return out


def case_time(mesh) -> dict:
    """The time-sharded logits (gathered over time), the loss and its
    gradients at kernel_size 3, and the three refusals."""
    from pytorch_wavenet_tpu_torch.parallel import time_sharding as ts
    from pytorch_wavenet_tpu_torch.parallel.mesh import DATA_AXIS, all_gather
    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

    cfg = config("tiny", kernel_size=3)
    full = _tensors(params_of(cfg, seed=4))
    x, t = time_inputs(cfg)
    out = {}
    with torch.no_grad():
        lg = ts.time_sharded_logits(full, cfg, x, mesh)
    out["logits"] = all_gather(lg, mesh, DATA_AXIS, dim=1).numpy()
    leaves = [v.requires_grad_(True) for _, v in _leaves(full)]
    loss = ts.time_sharded_loss(full, cfg, x, t, mesh)
    grads = torch.autograd.grad(loss, leaves)
    out["loss"] = loss.detach().numpy()
    for (path, _), g in zip(_leaves(full), grads):
        out["grads/" + "/".join(path)] = g.numpy()
    n = TIME_T // 2
    for name, xx in (("divisible", np.zeros((1, TIME_T + 1), np.int32)),
                     ("halo", np.zeros((1, 12), np.int32)),
                     ("receptive", np.zeros((1, n), np.int32))):
        try:
            if name == "receptive":
                ts.time_sharded_loss(full, cfg, xx, xx, mesh)
            else:
                ts.time_sharded_logits(full, cfg, xx, mesh)
        except ValueError as e:
            out[f"refused/{name}"] = np.asarray(str(e))
    return out


def case_pipe(n_stages: int) -> dict:
    """``generate_pipelined`` at T = 0, at T = 1 (with regularize), with
    gcond, with the default and a short prime, and its refusals."""
    from pytorch_wavenet_tpu_torch.parallel import pipeline

    cfg = pipe_configs()[n_stages]
    full = _tensors(params_of(cfg, scale=PIPE_SCALE))
    mesh = pipeline.make_pipeline_mesh(n_stages)
    S = 2 * n_stages
    prime = pipe_prime(cfg, S)
    out = {}
    _, out["T0"] = pipeline.generate_pipelined(
        full, cfg, mesh, 8, PIPE_N, prime, temperature=0.0, device="cpu")
    _, out["T1"] = pipeline.generate_pipelined(
        full, cfg, mesh, 10, 16, prime, temperature=1.0, regularize=0.01,
        device="cpu")
    _, out["default"] = pipeline.generate_pipelined(
        full, cfg, mesh, 14, 8, temperature=0.0, device="cpu")
    _, out["short"] = pipeline.generate_pipelined(
        full, cfg, mesh, 14, 8, pipe_prime(cfg, S, 15, 3), temperature=0.0,
        device="cpu")
    gcfg = config("tiny", gcond_channels=4, blocks=cfg.blocks)
    gp = _tensors(params_of(gcfg, seed=1, scale=PIPE_SCALE))
    gc = 5 * np.random.default_rng(12).normal(size=(S, 4)).astype(
        np.float32)
    _, out["gcond"] = pipeline.generate_pipelined(
        gp, gcfg, mesh, 13, 12, prime, temperature=0.0, global_cond=gc,
        device="cpu")
    out = {k: v.numpy() for k, v in out.items()}
    for name, kw in (
            ("stages", dict(cfg=config("tiny", blocks=1, layers=3))),
            ("groups", dict(first_samples=np.zeros((3, 5), np.int64))),
            ("gcond", dict(global_cond=np.zeros((n_stages, 4), np.float32)))):
        args = dict(cfg=cfg, first_samples=None, global_cond=None)
        args.update(kw)
        try:
            pipeline.generate_pipelined(
                full, args["cfg"], mesh, 0, 4, args["first_samples"],
                global_cond=args["global_cond"], device="cpu")
        except ValueError as e:
            out[f"refused/{name}"] = np.asarray(str(e))
    return out


def case_pool(mesh) -> dict:
    """``sharded_pool_step`` over the data axis, chained twice: classes and
    the gathered rings."""
    from pytorch_wavenet_tpu_torch.parallel import training
    from pytorch_wavenet_tpu_torch.parallel.mesh import DATA_AXIS, all_gather

    cfg = config("tiny")
    full = _tensors(params_of(cfg))
    _, temps, seeds, toffs = pool_inputs(cfg)
    st = training.shard_pool_state(pool_state(cfg, full), mesh)
    out = {}
    for i in range(2):
        cls, st = training.sharded_pool_step(
            full, cfg, mesh, 99 + i, POOL_CHUNK, st, temperature=temps,
            lane_seed=seeds, lane_clock=toffs, device="cpu")
        out[f"cls{i}"] = cls.numpy()
        out[f"ring{i}"] = all_gather(st.ring, mesh, DATA_AXIS, dim=1).numpy()
        out[f"next{i}"] = all_gather(st.cls, mesh, DATA_AXIS).numpy()
        out[f"t{i}"] = np.asarray(st.t)
    return out


def group_w2(out_dir: str, rank: int, dataset_file: str) -> None:
    from pytorch_wavenet_tpu_torch.parallel.mesh import make_mesh

    m21, m12 = make_mesh(2, 1), make_mesh(1, 2)
    _save(out_dir, "step21", rank, case_step(m21))
    _save(out_dir, "step12", rank, case_step(m12))
    _save(out_dir, "generate21", rank, case_generate(m21))
    _save(out_dir, "iterator21", rank, case_iterator(m21, dataset_file))
    try:
        make_mesh(2, 2)
    except ValueError as e:
        _save(out_dir, "mesh", rank, {"refused": np.asarray(str(e))})


def group_w4(out_dir: str, rank: int, dataset_file: str) -> None:
    from pytorch_wavenet_tpu_torch.parallel.mesh import make_mesh

    m22, m41 = make_mesh(2, 2), make_mesh(4, 1)
    _save(out_dir, "step22", rank, case_step(m22))
    _save(out_dir, "pool41", rank, case_pool(m41))


def case_trainer(mesh, tag: str, out_dir: str, dataset_file: str) -> dict:
    """The mesh-mode trainer: 6 steps with a sharded snapshot at step 4
    (the writer's thread recorded), a second trainer resumed from it and
    validated, then trained on to step 6."""
    import threading

    from pytorch_wavenet_tpu_torch.parallel.sharding import gather_params
    from pytorch_wavenet_tpu_torch.utils import checkpoints

    cfg = config("tiny")
    ds = trainer_dataset(cfg, dataset_file)
    params = _tensors(params_of(cfg))
    snap = os.path.join(out_dir, f"snaps{tag}")
    threads = []
    writer = checkpoints.save_checkpoint_sharded

    def spy(*a, **k):
        threads.append(threading.current_thread().name)
        return writer(*a, **k)

    checkpoints.save_checkpoint_sharded = spy
    kw = dict(lr=LR, mesh=mesh, snapshot_path=snap, snapshot_name="m",
              num_workers=0, device="cpu")
    tr = pt.WaveNetTrainer(cfg, params, ds, snapshot_interval=4, **kw)
    tr.train(batch_size=8, epochs=1, max_steps=6)
    out = flat(gather_params(tr.params, cfg, mesh), "at6/")
    tr2 = pt.WaveNetTrainer(cfg, params, ds, snapshot_interval=100, **kw)
    out["resumed_at"] = np.asarray(tr2.resume())
    out.update(flat(gather_params(tr2.params, cfg, mesh), "at4/"))
    out["validation"] = np.asarray(tr2.validate(batch_size=VALID_BATCH))
    tr2.train(batch_size=8, epochs=1, continue_training_at_step=4,
              max_steps=6)
    out.update(flat(gather_params(tr2.params, cfg, mesh), "resumed6/"))
    out["writer_threads"] = np.asarray(threads)
    return out


def trainer_dataset(cfg, dataset_file: str):
    return pt.WaveNetDataset(
        dataset_file=dataset_file, item_length=cfg.item_length,
        target_length=cfg.output_length, file_location=None,
        classes=cfg.classes, test_stride=TEST_STRIDE)


def group_trainer(out_dir: str, rank: int, dataset_file: str) -> None:
    from pytorch_wavenet_tpu_torch.parallel.mesh import make_mesh

    for d, m in ((2, 1), (1, 2)):
        tag = f"{d}{m}"
        _save(out_dir, f"trainer{tag}", rank,
              case_trainer(make_mesh(d, m), tag, out_dir, dataset_file))


def group_time_pipe(out_dir: str, rank: int, dataset_file: str) -> None:
    """The time-sharded trunk and the pipeline at the world size."""
    import torch.distributed as dist

    from pytorch_wavenet_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size()
    _save(out_dir, f"time{n}", rank, case_time(make_mesh(n, 1)))
    _save(out_dir, f"pipe{n}", rank, case_pipe(n))


GROUPS = {"w2": group_w2, "w4": group_w4, "tp": group_time_pipe,
          "trainer": group_trainer}


def _save(out_dir: str, case: str, rank: int, arrays: dict) -> None:
    np.savez(os.path.join(out_dir, f"{case}_r{rank}.npz"), **arrays)


# --------------------------------------------------------------- harness


def start(group: str, world: int, out_dir: str, dataset_file: str = "",
          timeout: float = 240.0, script: str | None = None) -> dict:
    """Start ``group`` on ``world`` CPU ranks (one process each, a
    ``file://`` store under ``out_dir``) of ``script`` (default this file;
    its ``_main`` takes the same arguments) without waiting: pass the
    result to :func:`finish`."""
    store = os.path.join(out_dir, f"{group}{world}.store")
    if os.path.exists(store):  # a store is good for one group only
        os.remove(store)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.pop("RANK", None)
    logs = [open(os.path.join(out_dir, f"{group}{world}_r{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(script or __file__), store,
         str(world), str(r), out_dir, group, str(timeout), dataset_file],
        cwd=REPO, env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    return dict(group=group, world=world, procs=procs, logs=logs,
                deadline=time.time() + timeout)


def finish(run: dict, may_fail=()) -> list[int]:
    """Wait for a started group; raises with every rank's output if a rank
    not in ``may_fail`` exits nonzero or the group outlives its timeout.
    Returns the ranks' exit codes."""
    procs, logs = run["procs"], run["logs"]
    try:
        for p in procs:
            p.wait(timeout=max(run["deadline"] - time.time(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    if any(p.returncode != 0 and r not in may_fail
           for r, p in enumerate(procs)):
        raise RuntimeError(f"{run['group']} on {run['world']} ranks failed: "
                           + "\n".join(f"--- rank {r} (rc {p.returncode})\n"
                                       f"{t[-3000:]}" for r, (p, t) in
                                       enumerate(zip(procs, texts))))
    return [p.returncode for p in procs]


def spawn(group: str, world: int, out_dir: str, dataset_file: str = "",
          timeout: float = 240.0) -> None:
    """Run ``group`` on ``world`` CPU ranks (one process each, a
    ``file://`` store under ``out_dir``); raises with every rank's output
    if any fails or the group outlives ``timeout``."""
    finish(start(group, world, out_dir, dataset_file, timeout))


def load(out_dir: str, case: str, rank: int = 0) -> dict:
    with np.load(os.path.join(out_dir, f"{case}_r{rank}.npz")) as z:
        return {k: z[k] for k in z.files}


def _main(argv) -> int:
    store, world, rank, out_dir, group, timeout = argv[:6]
    dataset_file = argv[6] if len(argv) > 6 else ""
    # a rank that hangs prints where before the harness kills it
    faulthandler.dump_traceback_later(float(timeout) - 5, exit=True)
    torch.set_num_threads(1)
    from pytorch_wavenet_tpu_torch.parallel.mesh import init_distributed

    init_distributed("cpu", init_method=f"file://{store}", rank=int(rank),
                     world_size=int(world))
    try:
        GROUPS[group](out_dir, int(rank), dataset_file)
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # the other ranks may wait on this one: do not linger
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
