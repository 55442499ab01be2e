"""Multi-process cases of the lane pool on a mesh (``ContinuousBatcher(
mesh=)`` on rank 0, ``follow_pool`` on the others) on the CPU (gloo).

Imports no JAX: each rank is a process started by
``torch_parallel_cases.start``, which runs one group of cases per world
size and writes each case's arrays to ``{out}/{case}_r{rank}.npz``; the
tests compare them, in the pytest process, with the port's one-rank pool,
its solo rollouts and the JAX package. The requests are made here from
seeds, so both sides build the same ones.

  python tests/torch_pool_mesh_cases.py <store> <world> <rank> <out> <group> <timeout>
"""

from __future__ import annotations

import faulthandler
import os
import sys
import time
import traceback

import numpy as np
import torch

import torch_parallel_cases as base

import pytorch_wavenet_tpu_torch as pt  # noqa: E402
from pytorch_wavenet_tpu_torch.serving import (ContinuousBatcher,  # noqa: E402
                                               follow_pool)
from pytorch_wavenet_tpu_torch.serving import batcher as bm  # noqa: E402

LANES, CHUNK = 4, 6
SCALE = 0.3       # uniform weights: rollouts that do not settle on a class
KILL_TIMEOUT = 20.0  # MESH_TIMEOUT of the pool whose follower is killed
SILENT_TIMEOUT = 4.0  # MESH_TIMEOUT of the pool whose follower goes silent
SILENT_SLEEP = 20.0  # how long that follower sleeps in a kernel call
RAISE_AT = 4      # the follower's kernel call that fails (exits, sleeps)

# (prime seed, prime length (None: the receptive field), samples,
#  temperature, request seed, samples of the previous request to wait for)
STAGGERED = [(1, None, 25, 0.0, 0, 0), (2, None, 17, 0.0, 0, 7),
             (3, None, 21, 0.9, 77, 0), (4, None, 19, 1.0, 5, 0)]
LATE = [(5, 4, 13, 0.7, 9, 0)]  # after the others: a reused lane
LIGHT = [(12, None, 30, 0.0, 0, 0), (13, None, 20, 0.0, 0, 5),
         (14, None, 12, 0.9, 4, 0), (15, None, 9, 0.0, 0, 0)]
LIGHT_OPTS = dict(lanes=LANES, chunk=8, light_chunk=2, light_threshold=0.5)
UPDATE = [(21, None, 15, 0.0, 0, 0), (22, None, 15, 0.9, 6, 0),
          (23, 3, 15, 1.0, 7, 0)]  # after the new weights are installed
DRAIN = [(31, None, 20, 0.0, 0, 0), (32, 2, 14, 0.8, 3, 0),
         (33, None, 9, 0.0, 0, 0)]
HOP, FACTORS = 4, (2, 2)  # frames mode: the learnable upsampler's factors
COND_N = (17, 9, 20)      # the conditioned requests' samples
VOC_SEED = 20


def tiny():
    """tiny at kernel size 3 with uniform weights: (cfg, params)."""
    cfg = pt.get_config("tiny", kernel_size=3)
    return cfg, base._tensors(base.params_of(cfg, 0, scale=SCALE))


def tiny_b(cfg):
    """The weights ``update_params`` installs."""
    return base._tensors(base.params_of(cfg, 1, scale=SCALE))


def vocoder(frames: bool):
    """tiny_vocoder (with the learnable upsampler in frames mode)."""
    cfg = pt.get_config("tiny_vocoder",
                        **({"cond_upsample": FACTORS} if frames else {}))
    return cfg, base._tensors(base.params_of(cfg, VOC_SEED))


def prime(cfg, seed: int, length=None) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.classes, length or cfg.receptive_field).astype(np.int32)


def normal(seed: int, shape, scale: float = 0.5) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def cond_inputs(cfg, frames: bool):
    """The conditioned case's three requests: (prime, samples, temperature,
    seed, conditioning) (rows, or frames at HOP); the third rides none."""
    rf, M = cfg.receptive_field, cfg.cond_channels
    out = []
    for i, (n, temp, seed) in enumerate(zip(COND_N, (0.0, 0.8, 0.0),
                                            (0, 3, 0))):
        total = rf - 1 + n
        c = (normal(40 + i, (-(-total // HOP) + 2, M), 1.0) if frames
             else normal(40 + i, (total, M)))
        out.append((prime(cfg, 50 + i), n, temp, seed, None if i == 2 else c))
    return out


def wait_for(handle, k: int, timeout: float = 60.0):
    deadline = time.time() + timeout
    while sum(p.size for p in handle._parts) < k:
        if handle.done() or time.time() > deadline:
            break
        time.sleep(0.005)


def run_requests(b, cfg, reqs) -> list[np.ndarray]:
    """Submit ``reqs`` (the tables above), each after its wait, and return
    every response's classes."""
    handles = []
    for ps, length, n, temp, seed, wait in reqs:
        if handles and wait:
            wait_for(handles[-1], wait)
        handles.append(b.submit(prime(cfg, ps, length), n, temperature=temp,
                                seed=seed))
    return [h.result(timeout=120)[1] for h in handles]


def _pool(cfg, params, mesh, rank, body, **opts):
    """Rank 0 runs ``body(batcher)`` on a pool over ``mesh``, every other
    rank follows it; returns rank 0's arrays (the followers' counters)."""
    opts.setdefault("lanes", LANES)
    opts.setdefault("chunk", CHUNK)
    if rank > 0:
        return {f"follower/{k}": np.asarray(v) for k, v in
                follow_pool(params, cfg, mesh, device="cpu", **opts).items()}
    b = ContinuousBatcher(params, cfg, mesh=mesh, device="cpu", **opts)
    try:
        out = body(b)
        out.update({f"stats/{k}": np.asarray(v) for k, v in b.stats().items()
                    if v is not None})
    finally:
        b.close()
    return out


# --------------------------------------------------------------- the cases


def case_staggered(mesh, rank) -> dict:
    """(a) Staggered greedy requests admitted mid-flight, seeded hot ones,
    then a request on a reused lane."""
    cfg, params = tiny()

    def body(b):
        got = run_requests(b, cfg, STAGGERED) + run_requests(b, cfg, LATE)
        return {f"cls{i}": c for i, c in enumerate(got)}

    return _pool(cfg, params, mesh, rank, body)


def case_refusals(mesh, rank) -> dict:
    """The refusals: lanes that do not divide over the data axis (both
    sides), a scheduler off rank 0 and a follower on rank 0."""
    cfg, params = tiny()
    out = {}
    for name, fn in (
            ("divisible", lambda: ContinuousBatcher(
                params, cfg, lanes=5, chunk=CHUNK, mesh=mesh, device="cpu")),
            ("divisible_follower", lambda: follow_pool(
                params, cfg, mesh, lanes=5, chunk=CHUNK, device="cpu")),
            ("wrong_rank", (lambda: follow_pool(
                params, cfg, mesh, lanes=LANES, chunk=CHUNK, device="cpu"))
             if rank == 0 else (lambda: ContinuousBatcher(
                 params, cfg, lanes=LANES, chunk=CHUNK, mesh=mesh,
                 device="cpu")))):
        try:
            fn()
        except ValueError as e:
            out[name] = np.asarray(str(e))
    return out


def case_conditioned(mesh, rank, frames: bool) -> dict:
    """(b) Conditioned requests (rows, or frames at a bf16 wire through the
    learnable upsampler) and an unconditioned one on the same pool."""
    cfg, params = vocoder(frames)
    reqs = cond_inputs(cfg, frames)
    key = "cond_frames" if frames else "cond"
    opts = dict(cond_hop=HOP, cond_wire_dtype=torch.bfloat16) if frames \
        else {}

    def body(b):
        (p0, n0, t0, s0, c0), (p1, n1, t1, s1, c1), (p2, n2, t2, s2, _) = reqs
        h0 = b.submit(p0, n0, temperature=t0, seed=s0, **{key: c0})
        wait_for(h0, 8)
        h1 = b.submit(p1, n1, temperature=t1, seed=s1, **{key: c1})
        h2 = b.submit(p2, n2, temperature=t2, seed=s2)
        return {f"cls{i}": h.result(timeout=120)[1]
                for i, h in enumerate((h0, h1, h2))}

    return _pool(cfg, params, mesh, rank, body, **opts)


def case_light(mesh, rank) -> dict:
    """(c) Adaptive chunking: light chunks, then full ones as the load
    crosses the threshold."""
    cfg, params = tiny()

    def body(b):
        return {f"cls{i}": c for i, c in
                enumerate(run_requests(b, cfg, LIGHT))}

    return _pool(cfg, params, mesh, rank, body, **LIGHT_OPTS)


def case_update(mesh, rank) -> dict:
    """(d) ``update_params`` while a request streams; the requests sent
    after its event run on the new weights on every rank."""
    cfg, params = tiny()

    def body(b):
        long = b.submit(prime(cfg, 20, 1), 120, temperature=0.0, seed=0)
        wait_for(long, 12)
        ev = b.update_params(tiny_b(cfg))
        installed = ev.wait(60)
        got = run_requests(b, cfg, UPDATE)
        long.result(timeout=120)
        out = {f"cls{i}": c for i, c in enumerate(got)}
        out["installed"] = np.asarray(installed)
        return out

    return _pool(cfg, params, mesh, rank, body)


def case_block(mesh, rank) -> dict:
    """(e) A follower's block step (``_Follower._step_pool`` on this rank's
    lanes and rows) against ``sharded_pool_step`` on the same block,
    chained twice: classes and rings gathered."""
    from pytorch_wavenet_tpu_torch.ops.cuda.gen_kernel_hbm import HbmGenState
    from pytorch_wavenet_tpu_torch.parallel import training
    from pytorch_wavenet_tpu_torch.parallel.mesh import DATA_AXIS, all_gather
    from pytorch_wavenet_tpu_torch.parallel.sharding import batch_sharding
    from pytorch_wavenet_tpu_torch.serving._mesh_pool import _Follower

    cfg = base.config("tiny")
    full = base._tensors(base.params_of(cfg))
    _, temps, seeds, toffs = base.pool_inputs(cfg)
    ref = training.shard_pool_state(base.pool_state(cfg, full), mesh)
    rows = batch_sharding(mesh, base.POOL_LANES)
    f = _Follower(full, cfg, mesh, lanes=base.POOL_LANES,
                  chunk=base.POOL_CHUNK, device="cpu")
    f._install_params(full)
    f._state = HbmGenState(ref.ring.clone(), ref.t, ref.cls.clone())
    f._clock = ref.t
    f._rows = (temps[rows], seeds[rows], toffs[rows])
    out = {}
    for i in range(2):
        cls, ref = training.sharded_pool_step(
            full, cfg, mesh, 0, base.POOL_CHUNK, ref, temperature=temps,
            lane_seed=seeds, lane_clock=toffs, device="cpu")
        mine = f._step_pool(base.POOL_CHUNK, *f._lane_args())
        out[f"ref{i}"] = cls.numpy()
        out[f"cls{i}"] = all_gather(mine, mesh, DATA_AXIS).numpy()
        out[f"ref_ring{i}"] = all_gather(ref.ring, mesh, DATA_AXIS,
                                         dim=1).numpy()
        out[f"ring{i}"] = all_gather(f._state.ring, mesh, DATA_AXIS,
                                     dim=1).numpy()
        out[f"clock{i}"] = np.asarray([f._clock, ref.t])
    return out


def _fail_on_call(k: int, action):
    """Make this process's ``k``-th kernel call (prime or step) run
    ``action`` instead, once."""
    real, calls = bm.run_batched, [0]

    def flaky(*a, **kw):
        calls[0] += 1
        if calls[0] == k:
            action()
        return real(*a, **kw)

    bm.run_batched = flaky


def _boom():
    raise RuntimeError("synthetic follower failure")


def case_follower_raises(mesh, rank) -> dict:
    """(f) A follower's kernel call raises: every rider on rank 0 fails
    with its error, then the pool (every rank re-bootstrapped) serves a
    request that equals its solo rollout."""
    cfg, params = tiny()
    if rank == 1:
        _fail_on_call(RAISE_AT, _boom)

    def body(b):
        hs = [b.submit(prime(cfg, 60 + i), 200, temperature=0.0)
              for i in range(3)]
        errors = []
        for h in hs:
            try:
                h.result(timeout=120)
                errors.append("")
            except Exception as e:  # noqa: BLE001 - recorded, checked
                errors.append(f"{type(e).__name__}: {e}")
        after = run_requests(b, cfg, [(64, None, 15, 0.0, 0, 0)])
        return {"errors": np.asarray(errors), "after": after[0]}

    return _pool(cfg, params, mesh, rank, body)


def case_drain(mesh, rank) -> dict:
    """(g) ``close(drain=True)`` right after the submissions finishes
    every accepted request; the followers' loops return."""
    cfg, params = tiny()
    if rank > 0:
        return {f"follower/{k}": np.asarray(v) for k, v in follow_pool(
            params, cfg, mesh, lanes=LANES, chunk=CHUNK,
            device="cpu").items()}
    b = ContinuousBatcher(params, cfg, lanes=LANES, chunk=CHUNK, mesh=mesh,
                          device="cpu")
    hs = [b.submit(prime(cfg, ps, length), n, temperature=temp, seed=seed)
          for ps, length, n, temp, seed, _ in DRAIN]
    b.close(drain=True)
    out = {f"cls{i}": h.result(timeout=1)[1] for i, h in enumerate(hs)}
    out["completed"] = np.asarray(b.stats()["completed"])
    return out


def _lost_follower(mesh, rank, timeout: float, action) -> dict:
    """A follower runs ``action`` at its ``RAISE_AT``-th kernel call, on a
    pool whose ``MESH_TIMEOUT`` is ``timeout``: rank 0's handles, how long
    they took to resolve, and whether the pool then refuses work."""
    cfg, params = tiny()
    bm.MESH_TIMEOUT = timeout  # read when the pool's sides are built
    opts = dict(lanes=LANES, chunk=CHUNK, device="cpu")
    if rank > 0:
        _fail_on_call(RAISE_AT, action)
        follow_pool(params, cfg, mesh, **opts)
        return {}
    b = ContinuousBatcher(params, cfg, mesh=mesh, **opts)
    t0 = time.time()
    hs = [b.submit(prime(cfg, 70 + i), 400, temperature=0.0)
          for i in range(3)]
    errors, resolved = [], []
    for h in hs:
        try:
            h.result(timeout=3 * timeout + 10)
            errors.append("")
        except Exception as e:  # noqa: BLE001 - recorded, checked
            errors.append(f"{type(e).__name__}: {e}")
        resolved.append(time.time() - t0)
    elapsed = max(resolved)
    try:
        b.submit(prime(cfg, 74), 5)
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    b.close()
    return {"errors": np.asarray(errors), "elapsed": np.asarray(elapsed),
            "refused": np.asarray(refused)}


def case_killed(mesh, rank) -> dict:
    """(f) A follower that dies mid-stream (its process exits at a kernel
    call): every handle on rank 0 resolves with an error within the pool's
    MESH_TIMEOUT, and the pool refuses new work."""
    return _lost_follower(mesh, rank, KILL_TIMEOUT, lambda: os._exit(3))


def case_silent(mesh, rank) -> dict:
    """(f) A follower that is alive but silent (it sleeps in a kernel call
    past the pool's MESH_TIMEOUT): rank 0's wait for its reply times out,
    every handle resolves with an error, and the pool refuses new work."""
    return _lost_follower(mesh, rank, SILENT_TIMEOUT,
                          lambda: time.sleep(SILENT_SLEEP))


# -------------------------------------------------------------- the groups


def group_pool(out_dir: str, rank: int, _dataset_file: str) -> None:
    """Every case at the world size (the failure cases on 2 ranks)."""
    import torch.distributed as dist

    from pytorch_wavenet_tpu_torch.parallel.mesh import make_mesh

    n = dist.get_world_size()
    mesh = make_mesh(n, 1)
    cases = [("staggered", case_staggered), ("refusals", case_refusals),
             ("rows", lambda m, r: case_conditioned(m, r, False)),
             ("frames", lambda m, r: case_conditioned(m, r, True)),
             ("light", case_light), ("update", case_update),
             ("block", case_block)]
    if n == 2:
        cases += [("raises", case_follower_raises), ("drain", case_drain)]
    for name, fn in cases:
        base._save(out_dir, f"{name}{n}", rank, fn(mesh, rank))


def _group_lost(name: str, case):
    """A group of one lost-follower case: the lost follower ends the
    process group, so the case runs alone and rank 0 leaves without
    closing it (the follower, if still alive, fails once rank 0 is gone)."""

    def group(out_dir: str, rank: int, _dataset_file: str) -> None:
        from pytorch_wavenet_tpu_torch.parallel.mesh import make_mesh

        out = case(make_mesh(2, 1), rank)
        base._save(out_dir, f"{name}2", rank, out)
        sys.stdout.flush()
        os._exit(0)

    return group


GROUPS = {"pool": group_pool, "killed": _group_lost("killed", case_killed),
          "silent": _group_lost("silent", case_silent)}


def _main(argv) -> int:
    store, world, rank, out_dir, group, timeout = argv[:6]
    faulthandler.dump_traceback_later(float(timeout) - 5, exit=True)
    torch.set_num_threads(1)
    from pytorch_wavenet_tpu_torch.parallel.mesh import init_distributed

    init_distributed("cpu", init_method=f"file://{store}", rank=int(rank),
                     world_size=int(world))
    try:
        GROUPS[group](out_dir, int(rank), "")
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # the other ranks may wait on this one: do not linger
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
