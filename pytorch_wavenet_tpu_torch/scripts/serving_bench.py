"""Serving load benchmark: the continuous batcher under concurrent traffic
(the JAX package's ``scripts/serving_bench.py``).

Drives :class:`pytorch_wavenet_tpu_torch.serving.ContinuousBatcher` (the
engine behind ``serving.server --batcher``; the kernel K4 on the card)
with a closed-loop load generator: ``--concurrency`` requests are kept in
flight until ``--requests`` complete. It reports:

* aggregate throughput (samples/s over the completed requests) and the
  per-stream realtime factor at that load;
* time to first audio (submit to the first delivered chunk, lane
  admission wait included) p50/p95, and its decomposition from each
  request's ``GenerationHandle.timing`` (wait, prime and splice dispatch,
  first-sample sync), with the phase that dominates the p95 tail;
* request completion latency p50/p95, and the wire bytes of ``stats()``.

``--device-profile`` traces the measured window with
``utils/profiling.trace`` and reports K4's device time inside the window
(launches that straddle its edges count only their part inside), the
device-bound aggregate (samples over that time) and the wire bytes a
sample. The reference has no serving path (generation is a blocking
batch-1 script, wavenet_model.py:237), so there is no baseline column.

The load is closed-loop, as in the JAX package. ``--device cpu`` runs the
kernel's plain version (the JAX script's ``--interpret``); the TPU-only
``--stage-layers`` and ``--head-tiles`` are not ported.

``--mesh-data N`` (under ``torch.distributed.run`` with N ranks) splits
the pool's ``--lanes`` into N blocks, one a rank: rank 0 schedules the
pool (``ContinuousBatcher(mesh=)``), runs the load and prints the line,
with the cross-rank bytes of ``stats()`` (``mesh_*``) and rank 0's wait
for its followers (``t_gather``); every other rank runs its block
(``serving.batcher.follow_pool``) until rank 0 closes the pool.

  # capacity: saturate a 256-lane pool
  python -m pytorch_wavenet_tpu_torch.scripts.serving_bench --config chaconne \\
      --lanes 256 --concurrency 512 --requests 1024 --skip-slab --json
  # the vocoder, mel frames on the wire
  python -m pytorch_wavenet_tpu_torch.scripts.serving_bench --config vocoder \\
      --cond --cond-hop 256 --lanes 256 --concurrency 256 --requests 256
  # CPU smoke
  python -m pytorch_wavenet_tpu_torch.scripts.serving_bench --config tiny \\
      --lanes 3 --chunk 32 --concurrency 2 --requests 4 --num-samples 64 \\
      --device cpu
  # the pool on 2 ranks (add --device cpu without a card)
  python -m torch.distributed.run --standalone --nproc-per-node 2 \\
      -m pytorch_wavenet_tpu_torch.scripts.serving_bench --config chaconne \\
      --lanes 256 --concurrency 256 --requests 512 --mesh-data 2 --json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import threading
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="saber")
    p.add_argument("--snapshot", default=None,
                   help="checkpoint file (default: random init; serving "
                        "speed does not depend on the weights' values)")
    p.add_argument("--lanes", type=int, default=256)
    p.add_argument("--chunk", type=int, default=2048,
                   help="splice granularity in samples (the streaming "
                        "time-to-first-audio floor)")
    p.add_argument("--light-chunk", type=int, default=None,
                   help="dispatch this many steps a chunk while the pool "
                        "is lightly loaded (outputs do not depend on it)")
    p.add_argument("--concurrency", type=int, default=512,
                   help="closed-loop in-flight requests (> lanes saturates "
                        "the pool and measures capacity)")
    p.add_argument("--requests", type=int, default=1024)
    p.add_argument("--num-samples", type=int, default=16000)
    p.add_argument("--prime-len", type=int, default=1,
                   help="request prime length (1 = unprimed)")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--cond", action="store_true",
                   help="mel-conditioned load: every request carries its "
                        "own random conditioning timeline (needs a config "
                        "with cond_channels, e.g. --config vocoder)")
    p.add_argument("--cond-hop", type=int, default=256,
                   help="conditioned load ships mel FRAMES at this hop and "
                        "the pool expands them on the device; 0 = "
                        "per-sample rows")
    p.add_argument("--ring-dtype", choices=("f32", "bf16"), default="bf16")
    p.add_argument("--cond-wire", choices=("f32", "bf16"), default="f32",
                   help="frames-mode mel upload dtype (bf16 halves it)")
    p.add_argument("--exact-chain", action="store_true",
                   help="disable fuse_res (the reassociated serial chain)")
    p.add_argument("--skip-slab", action="store_true",
                   help="deferred one-product skip projection")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true",
                   help="emit one machine-readable JSON line at the end")
    p.add_argument("--device-profile", action="store_true",
                   help="trace the measured window and report K4's device "
                        "time in it and the device-bound aggregate")
    p.add_argument("--device", default="cuda",
                   help="cuda (K4) or cpu (its plain version)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help="shard the lane pool over this many ranks, under "
                        "torch.distributed.run with as many (--lanes is "
                        "the pool total)")
    return p.parse_args(argv)


def _q(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def ttfa_decomposition(timings: list[dict], summary: dict):
    """Print the TTFA phases of the requests with all marks, and the phase
    that dominates each request of the p95 tail; adds the p95 of the wait
    and of the first-sample sync to ``summary``."""
    full = [t for t in timings
            if all(k in t for k in ("t_submit", "t_admitted", "t_first"))]
    if not full:
        return
    phases = {
        "wait (submit->admitted)":
            [t["t_admitted"] - t["t_submit"] for t in full],
        "prime dispatch": [t["prime_s"] for t in full],
        "splice dispatch": [t["splice_s"] for t in full],
        "first-sample sync (admitted->first)":
            [t["t_first"] - t["t_admitted"] for t in full],
    }
    print(f"\nTTFA decomposition ({len(full)} requests with marks):")
    print(f"  {'phase':<38}{'p50 ms':>9}{'p95 ms':>9}{'max ms':>9}")
    for name, xs in phases.items():
        print(f"  {name:<38}{_q(xs, 50)*1e3:>9.1f}{_q(xs, 95)*1e3:>9.1f}"
              f"{max(xs)*1e3:>9.1f}")
    tt = [t["t_first"] - t["t_submit"] for t in full]
    cut = _q(tt, 95)
    tail = [t for t, v in zip(full, tt) if v >= cut]
    if tail:
        dom: dict[str, int] = {}
        for t in tail:
            parts = {
                "wait": t["t_admitted"] - t["t_submit"]
                - t["prime_s"] - t["splice_s"],
                "prime": t["prime_s"],
                "splice": t["splice_s"],
                "first_sync": t["t_first"] - t["t_admitted"],
            }
            k = max(parts, key=parts.get)
            dom[k] = dom.get(k, 0) + 1
        parts = ", ".join(f"{k}: {v}" for k, v in
                          sorted(dom.items(), key=lambda kv: -kv[1]))
        print(f"  p95-tail ({len(tail)} reqs >= {cut*1e3:.0f} ms) "
              f"dominated by: {parts}")
    summary["ttfa_wait_p95_ms"] = round(
        _q(phases["wait (submit->admitted)"], 95) * 1e3, 1)
    summary["ttfa_first_sync_p95_ms"] = round(
        _q(phases["first-sample sync (admitted->first)"], 95) * 1e3, 1)


def k4_busy_ms(trace_path: str) -> tuple[float, int, float]:
    """(K4's device ms inside the trace's capture span, the K4 launches
    overlapping it, the span in ms)."""
    from ..utils.profiling import (CAPTURE_SPAN, capture_window, clipped_ms,
                                   k4_events)

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    lo, hi = capture_window(events, CAPTURE_SPAN)
    ev = [e for e in k4_events(events)
          if float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    return clipped_ms(ev, lo, hi), len(ev), (hi - lo) / 1e3


def main(argv=None) -> dict:
    """Run the load; returns the summary (the ``--json`` line), or on a
    follower rank of ``--mesh-data`` its counters."""
    args = parse_args(argv)
    from .. import get_config, init_wavenet
    from ..device import card_description, resolve_device
    from ..serving import ContinuousBatcher, follow_pool
    from ..serving.batcher import MESH_TIMEOUT
    from ..utils.checkpoints import load_checkpoint

    mesh, rank = None, 0
    if args.mesh_data > 1:
        from ..parallel.mesh import init_distributed, make_mesh

        dev = init_distributed(args.device, timeout=MESH_TIMEOUT)
        mesh = make_mesh(args.mesh_data, 1)
        rank = torch.distributed.get_rank()
    else:
        dev = resolve_device(args.device)
    if args.snapshot:
        ck = load_checkpoint(args.snapshot, dev)
        params, cfg = ck["params"], ck["config"]
    else:
        cfg = get_config(args.config)
        params = init_wavenet(cfg, torch.Generator().manual_seed(args.seed),
                              dev)
    if args.cond and cfg.cond_channels == 0:
        raise SystemExit("--cond needs a conditioned config "
                         "(cfg.cond_channels > 0), e.g. --config vocoder")
    opts = dict(
        lanes=args.lanes, chunk=args.chunk, seed=args.seed,
        ring_dtype=torch.bfloat16 if args.ring_dtype == "bf16"
        else torch.float32,
        fuse_res=not args.exact_chain, skip_slab=args.skip_slab,
        cond_hop=args.cond_hop if (args.cond and args.cond_hop) else None,
        light_chunk=args.light_chunk,
        cond_wire_dtype=torch.bfloat16 if args.cond_wire == "bf16"
        else torch.float32,
        device=dev,
    )
    if mesh is not None:
        opts["mesh"] = mesh
    try:
        if rank > 0:  # this rank's lane block until rank 0 closes the pool
            return follow_pool(params, cfg, **opts)
        print(f"device {dev.type} ("
              f"{card_description() if dev.type == 'cuda' else 'cpu'})"
              + (f", the pool on {args.mesh_data} ranks" if mesh else ""),
              flush=True)
        batcher = ContinuousBatcher(params, cfg, **opts)
        try:
            return _drive(args, cfg, batcher)
        finally:
            batcher.close()
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _drive(args, cfg, batcher) -> dict:
    rng = np.random.default_rng(args.seed)

    def make_cond(n=None, rng=rng):
        # worker threads pass their own rng: numpy Generators are not
        # thread-safe
        if not args.cond:
            return None
        rows = args.prime_len - 1 + (n or args.num_samples)
        if args.cond_hop:  # frames on the wire (hop x less upload)
            rows = -(-rows // args.cond_hop)
        return rng.normal(
            0.0, 0.3, (rows, cfg.cond_channels)).astype(np.float32)

    cond_kw = "cond_frames" if (args.cond and args.cond_hop) else "cond"
    if args.prime_len == 1:
        primes = [np.asarray([cfg.classes // 2], np.int32)] * args.requests
    else:
        primes = [rng.integers(0, cfg.classes, args.prime_len,
                               dtype=np.int32) for _ in range(args.requests)]

    # warm-up so the measured window is steady-state serving: prewarm
    # builds the kernel and installs the weights, and a throwaway request
    # runs the admission and pool paths once
    t0 = time.perf_counter()
    batcher.prewarm()
    warm_n = min(args.num_samples, 2 * args.chunk)
    batcher.submit(primes[0], warm_n, temperature=args.temperature,
                   **{cond_kw: make_cond(warm_n)}).result(timeout=3600)
    print(f"warm-up: {time.perf_counter() - t0:.1f} s", flush=True)

    lock = threading.Lock()
    issued = 0
    failures = 0
    ttfa: list[float] = []
    latency: list[float] = []
    timings: list[dict] = []  # per-request batcher lifecycle marks

    def worker(wid=0):
        nonlocal issued, failures
        wrng = np.random.default_rng((args.seed, wid))
        while True:
            with lock:
                if issued >= args.requests:
                    return
                i = issued
                issued += 1
            first = []
            t_sub = time.perf_counter()
            try:
                h = batcher.submit(
                    primes[i], args.num_samples,
                    temperature=args.temperature, seed=i,
                    on_chunk=lambda c, f=first, t=t_sub: f.append(
                        time.perf_counter() - t) if not f else None,
                    **{cond_kw: make_cond(rng=wrng)},
                )
                _, cls = h.result(timeout=3600)
                t_done = time.perf_counter() - t_sub
                if cls.shape != (args.num_samples,):
                    raise RuntimeError(f"response shape {cls.shape}")
            except Exception as e:  # count it, keep loading the pool
                with lock:
                    failures += 1
                print(f"request {i} failed: {type(e).__name__}: {e}",
                      file=sys.stderr, flush=True)
                continue
            with lock:
                ttfa.append(first[0])
                latency.append(t_done)
                timings.append(dict(h.timing))

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(args.concurrency)]
    stats0 = batcher.stats()  # the warm-up's traffic is subtracted
    window = contextlib.nullcontext()
    if args.device_profile:
        from ..utils.profiling import trace

        window = trace(tempfile.mkdtemp(prefix="serving_prof_"))
    with window as trace_path:
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_start
    stats = batcher.stats()

    if not latency:
        raise SystemExit(f"all {args.requests} requests failed")
    total = len(latency) * args.num_samples  # completed requests only
    agg = total / wall
    summary = {
        "config": args.config, "cond": bool(args.cond),
        "lanes": args.lanes, "chunk": args.chunk,
        "concurrency": args.concurrency, "requests": args.requests,
        "completed": len(latency), "failed": failures,
        "num_samples": args.num_samples, "wall_s": round(wall, 3),
        "agg_samples_per_s": round(agg),
        "realtime_x": round(agg / args.sr, 1),
        "ttfa_p50_ms": round(_q(ttfa, 50) * 1e3, 1),
        "ttfa_p95_ms": round(_q(ttfa, 95) * 1e3, 1),
        "latency_p50_s": round(_q(latency, 50), 3),
        "latency_p95_s": round(_q(latency, 95), 3),
        # the worker loop's phases (where the pool's wall time went)
        **{k: v for k, v in stats.items()
           if k in ("pool_steps", "prime_calls") or k.startswith("t_")},
    }
    if "mesh_ranks" in stats:  # the traffic between the ranks
        summary["mesh_ranks"] = stats["mesh_ranks"]
        for k in ("mesh_bytes_out", "mesh_bytes_in", "mesh_step_bytes",
                  "mesh_admit_bytes"):
            summary[k] = stats[k] - stats0[k]
        steps = stats["pool_steps"] - stats0["pool_steps"]
        summary["mesh_step_bytes_per_step"] = round(
            summary["mesh_step_bytes"] / max(steps, 1))
    print(
        f"{len(latency)}/{args.requests} x {args.num_samples} samples, "
        f"{args.concurrency} in flight over {args.lanes} lanes "
        f"(chunk {args.chunk}): {agg:,.0f} samples/s aggregate "
        f"({agg / args.sr:,.1f}x realtime)\n"
        f"TTFA p50/p95: {summary['ttfa_p50_ms']:.0f}/"
        f"{summary['ttfa_p95_ms']:.0f} ms | completion p50/p95: "
        f"{summary['latency_p50_s']:.2f}/{summary['latency_p95_s']:.2f} s"
    )
    ttfa_decomposition(timings, summary)
    bytes_down = stats["bytes_down"] - stats0["bytes_down"]
    bytes_up = stats["bytes_up"] - stats0["bytes_up"]
    bps = (bytes_down + bytes_up) / max(total, 1)
    summary["bytes_down"] = bytes_down
    summary["bytes_up"] = bytes_up
    summary["wire_bytes_per_sample"] = round(bps, 3)
    if trace_path:
        busy_ms, launches, window_ms = k4_busy_ms(trace_path)
        if busy_ms:
            device_busy_s = busy_ms / 1e3
            engine = total / device_busy_s
            summary["device_busy_s"] = round(device_busy_s, 3)
            summary["device_bound_samples_per_s"] = round(engine)
            print(
                f"\ndevice-bound capacity:\n"
                f"  K4 busy {device_busy_s:.3f} s of a {window_ms / 1e3:.3f} "
                f"s window ({launches} launches overlap it; "
                f"{device_busy_s / (window_ms / 1e3):.0%} duty)\n"
                f"  device-time-bound aggregate: {engine:,.0f} samples/s "
                f"({engine/args.sr:,.0f}x realtime)\n"
                f"  wire: {bps:.2f} B/sample ({bytes_down/1e6:.1f} MB down "
                f"+ {bytes_up/1e6:.1f} MB up over {total:,} samples)")
        else:
            print("\n(the device profile holds no K4 launch: no device-"
                  "bound capacity on this device)")
    if args.json:
        print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
