"""One listener at a time: ``serving/server.py::Synthesizer.stream`` on
the single-stream backend (K1 on a card), requests back to back. The
window opens as the first timed request starts and closes as the first
request that ends past ``--seconds`` ends, so it holds whole requests,
primes included: ``stream_samples_per_s`` is every sample yielded in it
over its length."""

from __future__ import annotations

import traceback

import numpy as np
import torch

from .. import inputs, traffic
from ..tracing import span
from . import RunRecord, free, judge_served, memory_peak, now, port_config


def decode_table(classes: int) -> np.ndarray:
    """The waveform value of each class (mu-law, edge-based), ascending."""
    x = (np.arange(classes, dtype=np.float64) / classes) * 2.0 - 1.0
    mu = classes
    return np.sign(x) * (np.exp(np.abs(x) * np.log1p(mu)) - 1) / mu


def to_classes(wav: np.ndarray, classes: int) -> np.ndarray:
    """The class of each waveform value (the nearest in the table)."""
    t = decode_table(classes)
    mid = 0.5 * (t[1:] + t[:-1])
    return np.searchsorted(mid, wav.astype(np.float64)).astype(np.int64)


def kernel_seed(seed: int) -> int:
    """The single-stream noise seed of a request's ``seed``, as the server
    documents it (``Synthesizer.kernel_seed``)."""
    g = torch.Generator().manual_seed(seed)
    return int(torch.randint(0, 2**31 - 1, (1,), generator=g)) & 0x7FFFFFFF


def run(ctx) -> RunRecord:
    from pytorch_wavenet_tpu_torch.serving.server import Synthesizer

    m, mix, dev = ctx.model, ctx.mix, ctx.device
    cfg = port_config(m)
    C = cfg.classes
    chunk = int(mix["chunk"])
    params = inputs.make_weights(m, ctx.seed, dev)
    signal = inputs.make_signal(ctx.seed, int(mix.get("signal", 1 << 20)), C,
                                dev).cpu().numpy()
    synth = Synthesizer(params, cfg, device=dev)
    reqs = traffic.requests(mix, ctx.seed, int(mix.get("max_requests", 4096)),
                            cfg.receptive_field, len(signal), C)
    rec = RunRecord()

    def serve(req):
        prime = traffic.prime_of(req, signal, C)
        parts = []
        with span("wavebench.stream"):
            for wav in synth.stream(req.length, req.temperature, req.seed,
                                    chunk, prime=prime):
                parts.append(wav)
        return prime, np.concatenate(parts)

    rec.x["t_built"] = now() - ctx.t_process
    serve(reqs[-1])                       # warm-up: the cell's own shapes
    ctx.capture.warm()
    rec.x["t_warmed"] = now() - ctx.t_process
    ctx.capture.start()
    done, failed = [], 0
    t_open = t_end = now()
    for req in reqs:
        try:
            prime, wav = serve(req)
            done.append((req, prime, wav))
        except Exception:  # a failed request is counted, and the run goes on
            traceback.print_exc()
            failed += 1
        t_end = now()
        if t_end >= t_open + ctx.seconds:
            break
    ctx.capture.stop()
    rec.t_open, rec.t_close = t_open, t_end
    samples = sum(len(w) for _, _, w in done)
    rec.e2e["stream_samples_per_s"] = samples / (t_end - t_open)
    rec.attempted, rec.failed = len(done) + failed, failed
    rec.x.update(setup_end=t_open, samples_in_window=samples,
                 prime_steps=sum(r.prime_len - 1 for r, _, _ in done))
    rec.memory_peak_bytes = memory_peak(dev)
    del synth
    free(dev)
    r = inputs.rng(ctx.seed, inputs.CHECK)
    n = int(mix.get("check_requests", 4))
    pick = [done[i] for i in sorted(r.permutation(len(done))[:n])]
    checked = [(prime, to_classes(wav, C), req.temperature,
                kernel_seed(req.seed)) for req, prime, wav in pick]
    judge_served(ctx, rec, params, checked)
    return rec
