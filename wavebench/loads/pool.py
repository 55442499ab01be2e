"""The lane pool (``serving/batcher.py::ContinuousBatcher``) under a
closed or an open loop.

Closed loop (``loop: closed``): ``clients`` callers each send their next
request when the last one completes, through the completion callbacks and
this one sender thread. The window opens and closes at the end of a
delivery (the pool hands out a chunk to all its riders at once), so it
holds whole deliveries: ``samples_per_s`` is every sample delivered in it
over its length.

Open loop (``loop: open``): one thread sends on the seeded schedule, and
each request is timed from when it was due. ``ttfa_p95_ms`` is over every
request due in the window; one that fails or never starts counts above
every success. The window is the schedule's.
"""

from __future__ import annotations

import queue
import time

import numpy as np
import torch

from .. import inputs, traffic
from ..tracing import span
from . import (RunRecord, free, judge_served, memory_peak, nearest_rank, now,
               port_config)

QUIET_S = 0.02     # no delivery for this long: the delivery has ended
POLL_S = 0.002
# a traced run starts its capture this long before the window opens: the
# profiler's start stalls the pool's worker for about a chunk
CAPTURE_LEAD_S = 2.0


class _Rec:
    __slots__ = ("req", "prime", "handle", "got", "t_submit", "t_first",
                 "t_done")

    def __init__(self, req, prime):
        self.req, self.prime = req, prime
        self.handle = None
        self.got = 0
        self.t_submit = self.t_first = self.t_done = None


def _ring_dtype(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def run(ctx) -> RunRecord:
    from pytorch_wavenet_tpu_torch.serving.batcher import ContinuousBatcher

    t_imported = now()
    m, mix, dev = ctx.model, ctx.mix, ctx.device
    cfg = port_config(m)
    C = cfg.classes
    params = inputs.make_weights(m, ctx.seed, dev)
    signal = inputs.make_signal(ctx.seed, int(mix.get("signal", 1 << 20)), C,
                                dev).cpu().numpy()
    pool = ContinuousBatcher(
        params, cfg, lanes=int(mix["lanes"]), chunk=int(mix["chunk"]),
        fuse_res=bool(mix.get("fuse_res", False)),
        skip_slab=bool(mix.get("skip_slab", False)),
        ring_dtype=_ring_dtype(mix.get("ring_dtype", "float32")),
        device=dev)
    rec = RunRecord()
    rec.x["t_imported"] = t_imported - ctx.t_process
    try:
        _drive(ctx, pool, cfg, signal, rec)
    finally:
        pool.close()
    checked = rec.x.pop("checked")
    del pool
    free(dev)
    judge_served(ctx, rec, params, checked)
    return rec


def _drive(ctx, pool, cfg, signal, rec: RunRecord):
    mix = ctx.mix
    C, lanes, chunk = cfg.classes, int(mix["lanes"]), int(mix["chunk"])
    rec.x["t_built"] = now() - ctx.t_process
    pool.prewarm()
    rec.x["t_prewarmed"] = now() - ctx.t_process
    reqs = traffic.requests(mix, ctx.seed, int(mix.get("max_requests",
                                                       200000)),
                            cfg.receptive_field, len(signal), C)
    # one warm-up request of the mix's shape (its prime length)
    warm = traffic.prime_of(reqs[0], signal, C)
    pool.submit(warm, chunk + 1, temperature=1.0, seed=1).result(timeout=600)
    ctx.capture.warm()
    rec.x["t_warmed"] = now() - ctx.t_process

    log: list = []       # (time, samples) of every delivery
    done_q: "queue.SimpleQueue[_Rec]" = queue.SimpleQueue()
    recs: list = []

    def submit(r: _Rec):
        def on_chunk(cls, r=r):
            t = time.perf_counter()
            n = len(cls)
            log.append((t, n))
            if r.t_first is None:
                r.t_first = t
            r.got += n
            if r.got >= r.req.length:
                r.t_done = t
                done_q.put(r)

        r.t_submit = now()
        with span("wavebench.submit"):
            r.handle = pool.submit(r.prime, r.req.length,
                                   temperature=r.req.temperature,
                                   on_chunk=on_chunk, seed=r.req.seed)
        recs.append(r)

    ramp = float(mix.get("ramp_s", 0.0))
    it = iter(reqs)
    closed = mix.get("loop", "closed") == "closed"
    t0 = now()
    if closed:
        for _ in range(int(mix["clients"])):
            req = next(it)
            submit(_Rec(req, traffic.prime_of(req, signal, C)))
        t_open, t_close, s0, s1 = _closed_loop(ctx, pool, it, signal, C, log,
                                               done_q, submit, t0 + ramp)
        window = [r for r in recs if t_open <= r.t_submit <= t_close]
    else:
        t_open = t0 + ramp
        t_close = t_open + ctx.seconds
        s0, s1, late = _open_loop(ctx, pool, it, signal, C, submit, t0,
                                  t_open, t_close)
        window = [r for r in recs if t_open <= t0 + r.req.due < t_close]
        _wait_first(window, t_close + 60.0)
        ttfa = [(r.t_first - (t0 + r.req.due)) if r.t_first is not None
                else float("inf") for r in window]
        rec.e2e["ttfa_p95_ms"] = 1e3 * nearest_rank(ttfa, 0.95)
        rec.x["ttfa_p50_ms"] = 1e3 * nearest_rank(ttfa, 0.5)
        rec.x["late_max_ms"] = 1e3 * max(late) if late else 0.0
        rec.x["admit_waits"] = [r.handle.timing["t_admitted"]
                                - r.handle.timing["t_submit"]
                                for r in window
                                if "t_admitted" in r.handle.timing]
    samples = sum(n for t, n in log if t_open < t <= t_close)
    rec.x["samples_in_window"] = samples
    if closed:
        rec.e2e["samples_per_s"] = samples / (t_close - t_open)
    rec.t_open, rec.t_close = t_open, t_close
    rec.x["setup_end"] = t_open
    rec.x["stats0"], rec.x["stats1"] = s0, s1
    rec.x["lanes"], rec.x["chunk"] = lanes, chunk
    # useful lane-steps in the window: the samples delivered, and the
    # prime classes ingested by the requests admitted in it
    admitted = [r for r in recs if r.handle is not None
                and t_open <= r.handle.timing.get("t_admitted", -1.0)
                <= t_close]
    rec.x["prime_steps"] = sum(r.req.prime_len - 1 for r in admitted)
    rec.x["admitted_in_window"] = len(admitted)
    rec.attempted = len(window)
    rec.failed = sum(1 for r in window if r.handle.done()
                     and r.got < r.req.length)
    rec.memory_peak_bytes = memory_peak(ctx.device)
    rec.x["checked"] = _pick_checked(ctx, recs, t_open, t_close, closed, t0)


def _closed_loop(ctx, pool, it, signal, C, log, done_q, submit, ramp_end):
    """Drive the clients; returns the window's edges and the pool's stats
    at them."""
    phase, edge = "ramp", ramp_end
    t_open = s0 = None
    while True:
        try:
            done_q.get(timeout=POLL_S)
            req = next(it)
            submit(_Rec(req, traffic.prime_of(req, signal, C)))
            continue
        except queue.Empty:
            pass
        t = now()
        last = log[-1][0] if log else 0.0
        if phase == "ramp" and t >= ramp_end - CAPTURE_LEAD_S:
            ctx.capture.start()
            phase = "leading"
        if phase == "leading" and t >= ramp_end:
            phase = "opening"
        if phase in ("opening", "closing") and last > edge \
                and t - last >= QUIET_S:
            if phase == "opening":
                t_open, s0 = last, pool.stats()
                edge = t_open + ctx.seconds
                phase = "closing"
            else:
                s1 = pool.stats()
                ctx.capture.stop()
                return t_open, last, s0, s1


def _open_loop(ctx, pool, it, signal, C, submit, t0, t_open, t_close):
    """Send on the schedule until the window closes; returns the pool's
    stats at the window's edges and how late each send was (s)."""
    late, s0 = [], None
    started = False
    for req in it:
        due = t0 + req.due
        if due >= t_close:
            break
        if not started and due >= t_open - CAPTURE_LEAD_S:
            ctx.capture.start()
            started = True
        if s0 is None and due >= t_open:
            s0 = pool.stats()
        wait = due - now()
        if wait > 0:
            time.sleep(wait)
        late.append(max(0.0, now() - due))
        submit(_Rec(req, traffic.prime_of(req, signal, C)))
    wait = t_close - now()
    if wait > 0:
        time.sleep(wait)
    s1 = pool.stats()
    ctx.capture.stop()
    return s0, s1, late


def _wait_first(window, deadline):
    while now() < deadline:
        if all(r.t_first is not None or r.handle.done() for r in window):
            return
        time.sleep(0.01)


def _pick_checked(ctx, recs, t_open, t_close, closed, t0):
    """A sample, drawn from the seed, of the window's finished requests,
    with the longest among them: ``(prime, served, temperature, seed)``."""
    if closed:
        pool_ = [r for r in recs if r.t_done is not None
                 and t_open <= r.t_submit and r.t_done <= t_close]
    else:
        pool_ = [r for r in recs if r.t_done is not None
                 and t_open <= t0 + r.req.due < t_close]
    n = int(ctx.mix.get("check_requests", 8))
    if not pool_:
        return []
    longest = max(pool_, key=lambda r: r.req.length)
    rest = [r for r in pool_ if r is not longest]
    r = inputs.rng(ctx.seed, inputs.CHECK)
    pick = [longest] + [rest[i] for i in r.permutation(len(rest))[:n - 1]]
    out = []
    for p in pick:
        _, cls = p.handle.result(timeout=0)
        out.append((p.prime, np.asarray(cls), p.req.temperature, p.req.seed))
    return out

