"""The lane pool in frames mode (``ContinuousBatcher(cond_hop=)``, a vocoder
fed acoustic frames) under the closed loop of ``loads/pool.py``: the same
clients, window and stats, each request carrying a seeded frame timeline.

Frames: a request's timeline (``ceil(total / hop)`` frames of ``M``
channels) is a smooth trajectory, a few slow cosines a channel, drawn from
``--seed`` and the request's own seed, so the program and the reference
get the same tensors (the reference makes them again from the checked
request). Weights: the harness's (``inputs.leaf_specs``) plus the
vocoder's own leaves (the input's previous-class tap, the conditioning
products and the phase-scale upsampler), drawn the same way.

The check reads requests that finished inside the window (those whose
delivery ended in it), the longest among them and a seeded sample of the
rest: at this model's step a request of 16,000 samples runs several
chunks, so few are both sent and finished inside one window.
"""

from __future__ import annotations

import math
import queue
import time

import numpy as np
import torch

from .. import inputs, traffic
from ..tracing import span
from . import RunRecord, free, memory_peak, now, port_config
from .pool import _closed_loop, _Rec

FRAMES = 5  # the stream of sub-seeds the frames are drawn from


def model_fields(m: dict) -> dict:
    """The vocoder's fields of ``WaveNetConfig`` beyond ``port_config``'s."""
    return dict(cond_channels=m["cond_channels"],
                cond_upsample=tuple(m["cond_upsample"]),
                cond_upsampler=m["cond_upsampler"],
                input_kernel=m["input_kernel"])


def hop_of(m: dict) -> int:
    return math.prod(m["cond_upsample"])


def make_weights(m: dict, seed: int, device) -> dict:
    """The params tree (f32, on ``device``) from ``seed``: U(-s, s) with s =
    1/sqrt(fan_in) per leaf, in one draw."""
    L = m["layers"] * m["blocks"]
    R, D, C, M = (m["residual_channels"], m["dilation_channels"],
                  m.get("classes", 256), m["cond_channels"])
    specs = inputs.leaf_specs(m) + [
        (("start", "w_prev"), (C, R), 2 * C),
        (("layers", "w_cond"), (L, M, 2 * D), M),
        (("cond_up", "w"), (hop_of(m),), 1),
        (("cond_up", "b"), (1,), 1),
    ]
    sizes = [math.prod(shape) for _, shape, _ in specs]
    g = torch.Generator(device=device).manual_seed(
        inputs.sub_seed(seed, inputs.WEIGHTS))
    flat = torch.rand(sum(sizes), generator=g, device=device,
                      dtype=torch.float32)
    tree: dict = {}
    for (path, shape, fan_in), part in zip(specs, flat.split(sizes)):
        s = 1.0 / math.sqrt(fan_in)
        tree.setdefault(path[0], {})[path[1]] = (
            part.view(shape) * (2 * s) - s).contiguous()
    return tree


def make_frames(seed: int, req_seed: int, total: int, m: dict) -> np.ndarray:
    """A request's frames ``(ceil(total / hop), M)`` f32: per channel the
    sum of three cosines of 2 to 40 frames a cycle (10 ms to 200 ms at a
    5 ms shift), random phases and levels, about unit scale."""
    hop, M = hop_of(m), m["cond_channels"]
    F_ = -(-total // hop)
    r = np.random.default_rng([inputs.sub_seed(seed, FRAMES), int(req_seed)])
    period = np.exp(r.uniform(np.log(2.0), np.log(40.0), (3, M)))
    phase = r.uniform(0, 2 * np.pi, (3, M))
    level = r.uniform(0.2, 0.6, (3, M))
    i = np.arange(F_, dtype=np.float64)[:, None, None]
    x = (level * np.cos(2 * np.pi * i / period + phase)).sum(1)
    return (x + r.normal(0.0, 0.3, M)).astype(np.float32)


class _FramesPool:
    """The pool as the closed loop drives it: each submit carries the
    request's frame timeline."""

    def __init__(self, pool, seed: int, m: dict):
        self._pool, self._seed, self._m = pool, seed, m

    def submit(self, prime, n, temperature=1.0, on_chunk=None, seed=None):
        frames = make_frames(self._seed, seed, len(prime) - 1 + n, self._m)
        return self._pool.submit(prime, n, temperature=temperature,
                                 on_chunk=on_chunk, seed=seed,
                                 cond_frames=frames)

    def __getattr__(self, name):
        return getattr(self._pool, name)


def run(ctx) -> RunRecord:
    from pytorch_wavenet_tpu_torch.serving.batcher import ContinuousBatcher

    t_imported = now()
    m, mix, dev = ctx.model, ctx.mix, ctx.device
    cfg = port_config(m, **model_fields(m))
    params = make_weights(m, ctx.seed, dev)
    signal = inputs.make_signal(ctx.seed, int(mix.get("signal", 1 << 20)),
                                cfg.classes, dev).cpu().numpy()
    wire = {"float32": torch.float32,
            "bfloat16": torch.bfloat16}[mix.get("cond_wire_dtype", "float32")]
    pool = ContinuousBatcher(
        params, cfg, lanes=int(mix["lanes"]), chunk=int(mix["chunk"]),
        cond_hop=int(mix["cond_hop"]), cond_wire_dtype=wire,
        ring_dtype={"float32": torch.float32}[mix.get("ring_dtype",
                                                      "float32")],
        device=dev)
    rec = RunRecord()
    rec.x["t_imported"] = t_imported - ctx.t_process
    try:
        _drive(ctx, _FramesPool(pool, ctx.seed, m), cfg, signal, rec)
    finally:
        pool.close()
    checked = rec.x.pop("checked")
    del pool
    free(dev)
    _judge(ctx, rec, params, checked)
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
    pool.submit(warm, chunk + 1, temperature=1.0, seed=1).result(timeout=900)
    ctx.capture.warm()
    rec.x["t_warmed"] = now() - ctx.t_process

    log: list = []
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

    it = iter(reqs)
    t0 = now()
    for _ in range(int(mix["clients"])):
        req = next(it)
        submit(_Rec(req, traffic.prime_of(req, signal, C)))
    t_open, t_close, s0, s1 = _closed_loop(
        ctx, pool, it, signal, C, log, done_q, submit,
        t0 + float(mix.get("ramp_s", 0.0)))
    samples = sum(n for t, n in log if t_open < t <= t_close)
    rec.x["samples_in_window"] = samples
    rec.e2e["samples_per_s"] = samples / (t_close - t_open)
    rec.t_open, rec.t_close = t_open, t_close
    rec.x["setup_end"] = t_open
    rec.x["stats0"], rec.x["stats1"] = s0, s1
    rec.x["lanes"], rec.x["chunk"] = lanes, chunk
    admitted = [r for r in recs if r.handle is not None
                and t_open <= r.handle.timing.get("t_admitted", -1.0)
                <= t_close]
    rec.x["prime_steps"] = sum(r.req.prime_len - 1 for r in admitted)
    rec.x["admitted_in_window"] = len(admitted)
    window = [r for r in recs if t_open <= r.t_submit <= t_close]
    rec.attempted = len(window)
    rec.failed = sum(1 for r in window if r.handle.done()
                     and r.got < r.req.length)
    rec.memory_peak_bytes = memory_peak(ctx.device)
    rec.x["checked"] = _pick_checked(ctx, recs, t_open, t_close)


def _pick_checked(ctx, recs, t_open, t_close):
    """The requests that finished inside the window: the longest and a
    sample, drawn from the seed, of the rest: ``(prime, served,
    temperature, seed)``."""
    done = [r for r in recs if r.t_done is not None
            and t_open <= r.t_done <= t_close]
    if not done:
        return []
    n = int(ctx.mix.get("check_requests", 8))
    longest = max(done, key=lambda r: r.req.length)
    rest = [r for r in done if r is not longest]
    g = inputs.rng(ctx.seed, inputs.CHECK)
    pick = [longest] + [rest[i] for i in g.permutation(len(rest))[:n - 1]]
    return [(p.prime, np.asarray(p.handle.result(timeout=0)[1]),
             p.req.temperature, p.req.seed) for p in pick]


def _judge(ctx, rec: RunRecord, params: dict, checked: list):
    """The served check (``reference/wnv.py``) over the frames each checked
    request was served with."""
    from ..reference import wnv

    if not checked:
        rec.compared = {"gap": float("inf")}
        rec.control = dict(rec.compared)
        return
    m = ctx.model
    rows = [(p, s, t, sd, make_frames(ctx.seed, sd, len(p) - 1 + len(s), m))
            for p, s, t, sd in checked]
    t_check = now()
    res = wnv.judge_served(params, m, hop_of(m), rows, ctx.device,
                           control=ctx.control)
    rec.x["check_s"] = now() - t_check
    rec.compared = {"gap": res["gap"]}
    rec.x["checked_positions"] = res["positions"]
    if ctx.control:
        rec.control = {"gap": res["control_gap"]}
        rec.readings["fault_gap"] = res["fault_gap"]
