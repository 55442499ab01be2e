"""Serving endurance soak: randomized mixed load against one pool (the JAX
package's ``scripts/serving_soak.py``).

Where ``serving_bench`` measures steady-state capacity under uniform load,
this drives the batcher (the kernel K4 on the card) the way long-lived
traffic does: mixed request lengths (down to one sample), mixed
temperatures, cancels in flight, bursts and lulls, and with
``--reload-every`` live weight swaps through ``update_params``, for
``--seconds``; then it checks the pool's lifecycle invariants:

* every submitted handle resolved (completed, cancelled or failed:
  nothing hangs);
* the counters agree: ``admitted - completed - failed`` lies in
  ``[0, cancelled]`` (a cancel may land before admission), and after the
  drain ``outstanding == 0`` and every lane is free;
* spot-checked exactness: a sample of greedy (temperature 0) requests
  equals, bitwise, its solo rollout (``generate_fast_batched`` on one
  stream with the request's ``lane_seed`` and the pool's kernel settings)
  under arbitrary interleaving; skipped while reloads are on (a swap in
  mid-request changes the rollout);
* host memory stays bounded (RSS growth over the soak is reported).

A broken invariant exits with "SOAK FAILED". ``--device cpu`` runs the
kernel's plain version (the JAX script's ``--interpret``).

  python -m pytorch_wavenet_tpu_torch.scripts.serving_soak --config chaconne \\
      --lanes 256 --skip-slab --seconds 300 --reload-every 5
  python -m pytorch_wavenet_tpu_torch.scripts.serving_soak --config tiny \\
      --lanes 3 --chunk 32 --seconds 5 --max-samples 128 --device cpu
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import threading
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="chaconne")
    p.add_argument("--lanes", type=int, default=256)
    p.add_argument("--chunk", type=int, default=2048)
    p.add_argument("--seconds", type=float, default=300.0)
    p.add_argument("--workers", type=int, default=16)
    p.add_argument("--max-samples", type=int, default=16000)
    p.add_argument("--cancel-rate", type=float, default=0.1)
    p.add_argument("--reload-every", type=float, default=0.0,
                   help="seconds between live update_params swaps (0 = "
                        "off); spot checks are skipped while reloads are on")
    p.add_argument("--check-rate", type=float, default=0.05,
                   help="fraction of greedy requests checked against a solo "
                        "rollout (bitwise)")
    p.add_argument("--ring-dtype", choices=("f32", "bf16"), default="bf16")
    p.add_argument("--skip-slab", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (K4) or cpu (its plain version)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the soak; returns the report (raises SystemExit on a broken
    invariant)."""
    args = parse_args(argv)
    from .. import get_config, init_wavenet
    from ..device import resolve_device
    from ..ops.cuda.gen_kernel_hbm import generate_fast_batched
    from ..serving import ContinuousBatcher, RequestCancelled

    dev = resolve_device(args.device)
    cfg = get_config(args.config)
    params = init_wavenet(cfg, torch.Generator().manual_seed(args.seed), dev)
    ring_dtype = torch.bfloat16 if args.ring_dtype == "bf16" else torch.float32
    b = ContinuousBatcher(params, cfg, lanes=args.lanes, chunk=args.chunk,
                          seed=args.seed, ring_dtype=ring_dtype,
                          skip_slab=args.skip_slab, device=dev)
    b.prewarm()

    def solo(prime, n, seed):
        """The oracle: one stream, the request's own seed, the pool's
        kernel settings."""
        _, cls = generate_fast_batched(
            params, cfg, 0, n, prime[None],
            temperature=np.zeros(1, np.float32),
            lane_seed=np.asarray([seed], np.int32), ring_dtype=ring_dtype,
            device=dev, **b._kw)
        return cls[0].cpu().numpy()

    lock = threading.Lock()
    counts = dict(submitted=0, completed=0, cancelled=0, failed=0,
                  checked=0, mismatched=0, hung=0, worker_errors=0)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # a fixed size palette, as in the JAX script
    sizes = sorted({1, 7, 64, 501, 1024, min(2048, args.max_samples),
                    min(5000, args.max_samples), args.max_samples})
    stop = time.monotonic() + args.seconds

    def worker(wid):
        try:
            _worker(wid)
        except Exception as e:
            print(f"worker {wid} died: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            with lock:
                counts["worker_errors"] += 1

    def _worker(wid):
        rng = np.random.default_rng((args.seed, wid))
        while time.monotonic() < stop:
            n = int(rng.choice(sizes))
            temp = float(rng.choice([0.0, 1.0]))
            seed = int(rng.integers(0, 1 << 30))
            prime = np.asarray([cfg.classes // 2], np.int32)
            with lock:
                counts["submitted"] += 1
            try:
                h = b.submit(prime, n, temperature=temp, seed=seed)
            except RuntimeError:  # the pool closing at the soak's end
                with lock:
                    counts["submitted"] -= 1
                return
            if rng.random() < args.cancel_rate:
                time.sleep(float(rng.random() * 0.05))
                h.cancel()
            try:
                _, cls = h.result(timeout=600)
            except RequestCancelled:
                with lock:
                    counts["cancelled"] += 1
                continue
            except TimeoutError:
                with lock:
                    counts["hung"] += 1
                continue
            except Exception:
                with lock:
                    counts["failed"] += 1
                continue
            with lock:
                counts["completed"] += 1
            if temp == 0.0 and n <= 4 * args.chunk \
                    and args.reload_every == 0 \
                    and rng.random() < args.check_rate:
                try:
                    ok = np.array_equal(cls, solo(prime, n, seed))
                except Exception as e:
                    print(f"solo check error: {type(e).__name__}: {e}",
                          file=sys.stderr, flush=True)
                    with lock:
                        counts["worker_errors"] += 1
                    continue
                with lock:
                    counts["checked"] += 1
                    counts["mismatched"] += 0 if ok else 1

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(args.workers)]
    reloads = []
    if args.reload_every > 0:
        def reloader():
            k = 0
            while True:
                time.sleep(args.reload_every)
                if time.monotonic() >= stop:
                    return
                k += 1
                # the same tree and shapes, other values: a trainer's swap
                reloads.append(b.update_params(
                    {key: {n: t * (1.0 + 1e-4 * (k % 3))
                           for n, t in v.items()}
                     for key, v in params.items()}))
        threads.append(threading.Thread(target=reloader))
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    for installed in reloads:  # the pool takes a swap at its next loop
        installed.wait(60)
    b.close(drain=True, timeout=600)
    stats = b.stats()
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    report = {
        **counts,
        "wall_s": round(wall, 1),
        "pool_admitted": stats["admitted"],
        "pool_completed": stats["completed"],
        "pool_cancelled": stats["cancelled"],
        "pool_failed": stats["failed"],
        "pool_outstanding": stats["outstanding"],
        "pool_free": stats["free"],
        "pool_steps": stats["pool_steps"],
        "rss_growth_mb": round((rss1 - rss0) / 1024, 1),
        "reloads": len(reloads),
        "reloads_installed": sum(e.is_set() for e in reloads),
    }
    print(json.dumps(report) if args.json else report, flush=True)

    problems = []
    if counts["hung"]:
        problems.append(f"{counts['hung']} requests hung")
    if counts["mismatched"]:
        problems.append(f"{counts['mismatched']} greedy mismatches")
    if stats["outstanding"] != 0:
        problems.append(f"outstanding={stats['outstanding']} after drain")
    if stats["free"] != args.lanes:
        problems.append(f"leaked lanes: free={stats['free']}")
    # cancels can land before admission (still counted cancelled), so
    # admitted work resolves as completed, failed or a cancel after
    # admission
    gap = stats["admitted"] - stats["completed"] - stats["failed"]
    if not 0 <= gap <= stats["cancelled"]:
        problems.append(
            f"counter incoherence: admitted - completed - failed = {gap} "
            f"not within [0, cancelled={stats['cancelled']}]")
    if counts["worker_errors"]:
        problems.append(f"{counts['worker_errors']} worker errors")
    if problems:
        raise SystemExit("SOAK FAILED: " + "; ".join(problems))
    print(f"soak OK: {counts['completed']} completed / "
          f"{counts['cancelled']} cancelled / {counts['checked']} spot-"
          f"checked bitwise over {wall:.0f} s", file=sys.stderr, flush=True)
    return report


if __name__ == "__main__":
    main()
