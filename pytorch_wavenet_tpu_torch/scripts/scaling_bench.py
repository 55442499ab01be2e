"""Training-scaling measurement: the JAX package's
``scripts/scaling_bench.py`` on ``torch.distributed``.

Runs the same ``parallel_train_step`` at world sizes 1, 2 and 4 (up to
``--max-ranks``), the global batch scaled with the data axis, and prints
the JAX script's line per size: ms a step, audio-seconds a second and the
scaling against linear. It starts the ranks itself (``spawn``, a
``file://`` store in a temporary directory), one process a rank, after
building the kernels once in this process. Where ranks share a card (one
H100, gloo) the line says so: the "scaling" there is the overhead of the
parallel path, not a scaling. Any rank that fails fails the run.

  python -m pytorch_wavenet_tpu_torch.scripts.scaling_bench --config chaconne
  python -m pytorch_wavenet_tpu_torch.scripts.scaling_bench --config tiny \\
      --per-device-batch 2 --steps 2 --max-ranks 2 --device cpu
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import tempfile
import time

import numpy as np
import torch


def measure(cfg, tx, mesh, global_batch: int, steps: int, dev):
    """Seconds a step (host clock over ``steps`` chained steps after one
    warm step, ending in a device synchronize) and audio-seconds a
    second."""
    from ..models.wavenet import init_wavenet
    from ..parallel.training import (make_sharded_train_state,
                                     parallel_train_step)

    params = init_wavenet(cfg, torch.Generator().manual_seed(0), dev)
    p, o = make_sharded_train_state(cfg, params, tx, mesh)
    rng = np.random.default_rng(1)
    x = rng.integers(0, cfg.classes, (global_batch, cfg.item_length),
                     dtype=np.int32)
    y = rng.integers(0, cfg.classes, (global_batch, cfg.output_length),
                     dtype=np.int32)
    _, _, loss = parallel_train_step(p, o, cfg, tx, x, y, mesh=mesh,
                                     device=dev)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(steps):
        _, _, loss = parallel_train_step(p, o, cfg, tx, x, y, mesh=mesh,
                                         device=dev)
    float(loss)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / steps
    return dt, global_batch * cfg.output_length / 16000.0 / dt


def _rank(rank: int, world: int, store: str, args, queue) -> None:
    """One rank of one world size: the measurement, put on ``queue`` by
    rank 0 (with every rank's kernel launches)."""
    from .. import config as config_mod
    from ..ops.cuda import trunk_kernel as tk
    from ..parallel.mesh import (DATA_AXIS, all_gather, axis_size,
                                 init_distributed, make_mesh)
    from ..training.optimizers import reference_adam

    dev = init_distributed(args.device, init_method=f"file://{store}",
                           rank=rank, world_size=world, local_rank=rank,
                           verbose=False)
    mesh = make_mesh(world // args.model_axis, args.model_axis)
    cfg = config_mod.get_config(args.config, trunk_kernel=True)
    data = axis_size(mesh, DATA_AXIS)
    tk.fwd_launches = tk.bwd_launches = 0
    dt, audio_s = measure(cfg, reference_adam(1e-4), mesh,
                          args.per_device_batch * data, args.steps, dev)
    counts = torch.tensor([tk.fwd_launches, tk.bwd_launches])
    if world > 1:
        counts = all_gather(counts[None], make_mesh(world, 1), DATA_AXIS)
    if rank == 0:
        queue.put(dict(data=data, model=args.model_axis,
                       batch=args.per_device_batch * data, ms=dt * 1e3,
                       audio_s=audio_s,
                       k2_launches=counts.reshape(-1, 2)[:, 0].tolist(),
                       k3_launches=counts.reshape(-1, 2)[:, 1].tolist()))
    torch.distributed.destroy_process_group()


def run_world(world: int, args, timeout: float = 600.0) -> dict:
    """Start ``world`` ranks and return rank 0's measurement; raises if a
    rank fails or the world outlives ``timeout``."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=_rank, args=(r, world,
                                                 os.path.join(d, "store"),
                                                 args, queue))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            out = queue.get(timeout=timeout)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"{world} ranks: exit codes {bad}")
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="chaconne")
    ap.add_argument("--per-device-batch", type=int, default=16)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--max-ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Measure every world size; returns their lines' figures."""
    from ..device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        from ..ops.cuda import build

        build.build(["trunk_fwd", "trunk_bwd"])  # once, before the ranks
        platform = torch.cuda.get_device_name(0)
    else:
        platform = "cpu"
    print(f"devices={cards} platform={platform} config={args.config}",
          flush=True)
    sizes = [n for n in (1, 2, 4)
             if n <= args.max_ranks and n % args.model_axis == 0]
    base, out = None, []
    for world in sizes:
        r = run_world(world, args)
        base = base or r["audio_s"]
        r["scaling_pct"] = r["audio_s"] / (base * r["data"]) * 100.0
        shared = (f"; {world} ranks share {cards} card(s) through gloo: the "
                  "parallel path's overhead, not a scaling"
                  if dev.type == "cuda" and world > cards else "")
        print(f"mesh data={r['data']} model={r['model']} batch={r['batch']}"
              f": {r['ms']:.2f} ms/step, {r['audio_s']:.2f} audio-s/s, "
              f"scaling {r['scaling_pct']:.0f}% of linear{shared}",
              flush=True)
        out.append(r)
    return out


if __name__ == "__main__":
    main()
