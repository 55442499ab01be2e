"""Autoregressive generation in plain PyTorch.

The counterpart of the JAX package's ``models/generate.py``:

* :func:`generate` — the naive O(receptive_field)-per-sample path, kept as
  the correctness oracle;
* :func:`generate_fast` — Fast-WaveNet generation over exactly-sized ring
  buffers, one :func:`gen_step` per sample;
* :func:`synthesize` — the vocoder: mel frames upsampled to per-sample
  conditioning rows, then a conditioned rollout of any of the backends;
* :func:`generate_long` — a rollout of any length through any backend in
  chunks, its state carried from one to the next;
* the window API, :func:`gen_step_window` and :func:`commit_window`: k
  steps in one trunk pass over the rings, committed afterwards for as many
  positions as turn out to be real (speculative decoding's verifier, and
  ``generate_fast(window_prime=True)``'s bulk prime).

Conditioning follows the JAX package's timeline: ``cond`` ``(S, total,
M)`` with ``total = num_given - 1 + num_samples``, row t conditioning the
step that consumes input sample t (the prime consumes rows ``[0,
num_given)``; a call resumed from a state consumes its own ``num_samples``
rows); ``global_cond`` ``(S, G)`` conditions every step.

The serving path runs the fused kernel instead
(``ops/cuda/gen_kernel.py``); this module is its reference and the home of
the ring-buffer semantics both share. At temperature 0 the three paths
(naive, fast, teacher-forced trunk) agree class for class.

Sampling at temperature > 0 is inverse-CDF over the tempered softmax with
one uniform per (step, stream) drawn from a ``torch.Generator``; it cannot
reproduce the JAX package's draws, which come from ``jax.random``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import WaveNetConfig
from ..device import resolve_device
from ..ops.mulaw import mu_law_expansion_torch
from .wavenet import (Params, _mm, check_cond, params_to, upsample_cond,
                      wavenet_logits)


class GenState(NamedTuple):
    """One ring buffer per layer: ``buffers[l][s, p, :]`` holds the
    residual-stream input of layer ``l`` for stream ``s`` written at time
    ``t`` with ``p = t mod P_l``, ``P_l = (k-1)*d_l + 1``. ``t`` is the
    global time cursor (a Python int)."""

    buffers: tuple  # L tensors, (S, P_l, R) each
    t: int


class StreamState(NamedTuple):
    """Streaming handle for :func:`generate_fast`: the ring state plus the
    next input class per stream. Passing it back (``first_samples=None``)
    continues the rollout with no re-priming, bitwise equal to one
    uninterrupted run at temperature 0."""

    gen: GenState
    cls: torch.Tensor  # (S,) int64 next input class


def buffer_length(cfg: WaveNetConfig, layer: int | None = None) -> int:
    """Ring length ``(kernel_size-1)*d + 1`` of ``layer`` (the longest
    layer's when ``layer`` is None)."""
    d = cfg.max_dilation if layer is None else cfg.dilations[layer]
    return (cfg.kernel_size - 1) * d + 1


def init_gen_state(cfg: WaveNetConfig, num_streams: int = 1,
                   device: str | torch.device = "cuda",
                   dtype=torch.float32) -> GenState:
    """Zero-filled rings."""
    dev = resolve_device(device)
    bufs = tuple(
        torch.zeros((num_streams, buffer_length(cfg, l),
                     cfg.residual_channels), dtype=dtype, device=dev)
        for l in range(cfg.num_layers)
    )
    return GenState(buffers=bufs, t=0)


def gen_step(params: Params, cfg: WaveNetConfig, state: GenState,
             cur_class: torch.Tensor, cond: torch.Tensor | None = None,
             global_cond: torch.Tensor | None = None, record: list | None = None
             ) -> tuple[torch.Tensor, GenState]:
    """One autoregressive step for all streams: logits ``(S, classes)``
    and the advanced state. ``cond``: this step's local conditioning ``(S,
    cond_channels)``; ``global_cond``: ``(S, gcond_channels)``.

    The ring slot of this step is written IN PLACE (the returned state
    shares the buffers of ``state``); the tap slots read here never equal
    the written slot, so the order of read and write does not matter.
    ``record``, when given, receives each layer's input ``h`` ``(S, R)``
    in layer order: the values written to the rings (speculative decoding
    commits them later with :func:`commit_window`)."""
    t = state.t
    h = params["start"]["w"][cur_class.long()]
    if "b" in params["start"]:
        h = h + params["start"]["b"]
    h = h.to(torch.float32)
    skip = torch.zeros((h.shape[0], cfg.skip_channels), dtype=torch.float32,
                       device=h.device)
    h, skip = advance_layers(params, cfg, state.buffers, t, h, skip,
                             range(cfg.num_layers), cond, global_cond, record)
    return step_head(params, cfg, skip), GenState(buffers=state.buffers,
                                                  t=t + 1)


def advance_layers(params: Params, cfg: WaveNetConfig, buffers, t: int,
                   h: torch.Tensor, skip: torch.Tensor, layers,
                   cond: torch.Tensor | None = None,
                   global_cond: torch.Tensor | None = None,
                   record: list | None = None):
    """:func:`gen_step`'s walk over ``layers`` (a run of layer indices,
    ``buffers[i]`` the ring of ``layers[i]``) at time ``t``: each ring
    slot written in place; returns the residual ``h`` and the running
    ``skip`` after the last of them (a pipeline stage runs its own run of
    layers with it)."""
    k = cfg.kernel_size
    cdt = cfg.compute_dtype
    lp = params["layers"]
    for buf, l in zip(buffers, layers):
        d = cfg.dilations[l]
        P = buf.shape[1]
        z = _mm(h, lp["w_in"][l, k - 1], cdt)
        for j in range(k - 1):
            idx = (t - (k - 1 - j) * d) % P
            z = z + _mm(buf[:, idx].to(torch.float32), lp["w_in"][l, j], cdt)
        buf[:, t % P] = h.to(buf.dtype)
        if record is not None:
            record.append(h)
        if cond is not None:
            z = z + _mm(cond, lp["w_cond"][l], cdt)
        if global_cond is not None:
            z = z + _mm(global_cond, lp["w_gcond"][l], cdt)
        if "b_in" in lp:
            z = z + lp["b_in"][l]
        f, g = z.chunk(2, dim=-1)
        u = torch.tanh(f) * torch.sigmoid(g)

        s = _mm(u, lp["w_skip"][l], cdt)
        if "b_skip" in lp:
            s = s + lp["b_skip"][l]
        skip = skip + s

        r = _mm(u, lp["w_res"][l], cdt)
        if "b_res" in lp:
            r = r + lp["b_res"][l]
        h = r + h
    return h, skip


def step_head(params: Params, cfg: WaveNetConfig, skip: torch.Tensor
              ) -> torch.Tensor:
    """relu -> end1 -> relu -> end2 on one step's summed skip ``(S, S_ch)``:
    the logits ``(S, classes)``."""
    cdt = cfg.compute_dtype
    y = torch.relu(skip)
    y = torch.relu(_mm(y, params["end1"]["w"], cdt) + params["end1"]["b"])
    return _mm(y, params["end2"]["w"], cdt) + params["end2"]["b"]


def _ring_span(buf: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Ring slots ``start, start+1, ...`` (mod P) of ``buf (S, P, R)``, ``n
    <= P`` of them: one slice, or two when they wrap (views and one
    concatenation; no index tensor goes to the device)."""
    P = buf.shape[1]
    if start + n <= P:
        return buf[:, start:start + n]
    return torch.cat([buf[:, start:], buf[:, :start + n - P]], dim=1)


class PendingWindow(NamedTuple):
    """The uncommitted ring writes of :func:`gen_step_window`: each layer's
    input over the window's positions, and the state's cursor when the
    window was computed. Speculative decoding decides how many positions
    were real after seeing the logits and commits that many."""

    h_wins: tuple  # L tensors, (S, k, R) each
    t: int


def gen_step_window(params: Params, cfg: WaveNetConfig, state: GenState,
                    window: torch.Tensor, cond: torch.Tensor | None = None,
                    global_cond: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, PendingWindow]:
    """``k`` autoregressive steps in one trunk pass over the ring state.

    ``window``: int ``(S, k)`` input classes for times ``t .. t+k-1``;
    ``cond``: ``(S, k, cond_channels)``, row i for position i;
    ``global_cond``: ``(S, gcond_channels)``. Returns logits ``(S, k,
    classes)``, row i predicting time ``t+i+1``, and a
    :class:`PendingWindow`; :func:`commit_window` advances the state by as
    many positions as turn out to be real. The rings are only read here.

    Each layer's tap product is one ``(S*k, R)`` product: for a tap that
    looks back ``m`` steps, positions ``i < m`` read ring slot ``(t+i-m) %
    P`` (times before the window) and positions ``i >= m`` the window's own
    input ``h[i-m]``. The taps add up in :func:`gen_step`'s order, so the
    logits equal ``k`` chained :func:`gen_step` calls up to the rounding of
    the wider products."""
    k = cfg.kernel_size
    cdt = cfg.compute_dtype
    t = state.t
    S, win = window.shape
    h = params["start"]["w"][window.long()]  # (S, k, R)
    if "b" in params["start"]:
        h = h + params["start"]["b"]
    h = h.to(torch.float32)

    skip = torch.zeros((S, win, cfg.skip_channels), dtype=torch.float32,
                       device=h.device)
    lp = params["layers"]
    h_wins = []
    for l, d in enumerate(cfg.dilations):
        buf = state.buffers[l]
        P = buf.shape[1]
        h_wins.append(h)
        z = _mm(h, lp["w_in"][l, k - 1], cdt)
        for j in range(k - 1):
            m = (k - 1 - j) * d  # this tap's lookback; m < P
            parts = [_ring_span(buf, (t - m) % P, min(m, win)).to(
                torch.float32)]
            if m < win:
                parts.append(h[:, :win - m])
            z = z + _mm(torch.cat(parts, dim=1), lp["w_in"][l, j], cdt)
        if cond is not None:
            z = z + _mm(cond, lp["w_cond"][l], cdt)
        if global_cond is not None:
            z = z + _mm(global_cond, lp["w_gcond"][l], cdt)[:, None, :]
        if "b_in" in lp:
            z = z + lp["b_in"][l]
        f, g = z.chunk(2, dim=-1)
        u = torch.tanh(f) * torch.sigmoid(g)

        s = _mm(u, lp["w_skip"][l], cdt)
        if "b_skip" in lp:
            s = s + lp["b_skip"][l]
        skip = skip + s

        r = _mm(u, lp["w_res"][l], cdt)
        if "b_res" in lp:
            r = r + lp["b_res"][l]
        h = r + h

    y = torch.relu(skip)
    y = torch.relu(_mm(y, params["end1"]["w"], cdt) + params["end1"]["b"])
    logits = _mm(y, params["end2"]["w"], cdt) + params["end2"]["b"]
    return logits, PendingWindow(h_wins=tuple(h_wins), t=t)


def commit_window(state: GenState, pending: PendingWindow,
                  valid) -> GenState:
    """Advance ``state`` by the first ``valid`` positions of a computed
    window (``0 <= valid <= k``; a 0-d tensor is read on the host): the
    ring slots of positions ``i < valid`` take the pending inputs, the
    cursor moves by ``valid``. Written IN PLACE, as :func:`gen_step`
    writes; the returned state shares the buffers of ``state``.

    A ring shorter than the window takes several of its positions in one
    slot (``P = 2`` at dilation 1). Sequential steps leave the last of them
    there, so only the last ``P`` valid positions are written, each to its
    own slot: no index repeats within one write."""
    v = int(valid)
    win = pending.h_wins[0].shape[1] if pending.h_wins else 0
    if not 0 <= v <= win:
        raise ValueError(f"valid must be in [0, {win}], got {v}")
    t = pending.t
    for buf, h_win in zip(state.buffers, pending.h_wins):
        P = buf.shape[1]
        n = min(v, P)  # positions v-n .. v-1, each to its own slot
        if n == 0:
            continue
        h = h_win[:, v - n:v].to(buf.dtype)
        start = (t + v - n) % P
        head = min(n, P - start)
        buf[:, start:start + head] = h[:, :head]
        if head < n:  # the slots wrap
            buf[:, :n - head] = h[:, head:]
    return GenState(buffers=state.buffers, t=t + v)


def _sample(logits: torch.Tensor, u: torch.Tensor, classes: int,
            temperature, regularize: float) -> torch.Tensor:
    """Temperature sampling with the optional quadratic regularizer toward
    the mid class; temperature <= 0 is the argmax (first index on ties).
    Inverse-CDF over the tempered softmax, one uniform ``u`` per stream.

    ``temperature`` may also be a per-stream ``(S,)`` tensor: streams at
    different temperatures share one rollout, and a stream at temperature
    <= 0 takes the argmax, bitwise the scalar temperature-0 rollout of that
    stream."""
    if regularize != 0.0:
        c = torch.arange(classes, dtype=torch.float32, device=logits.device)
        logits = logits - (c - classes / 2.0) ** 2 * regularize
    scalar = not isinstance(temperature, torch.Tensor)
    if scalar and temperature <= 0:
        return torch.argmax(logits, dim=-1)
    t = temperature if scalar else temperature.clamp(min=1e-6)[..., None]
    probs = torch.softmax(logits / t, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    idx = (u[..., None] > cdf).sum(dim=-1)
    drawn = torch.clamp(idx, max=classes - 1)
    if scalar:
        return drawn
    return torch.where(temperature > 0, drawn, torch.argmax(logits, dim=-1))


def _prime_2d(cfg: WaveNetConfig, first_samples, device) -> torch.Tensor:
    """``(S, num_given)`` int64 prime on ``device``; one mid-class sample
    when none is given."""
    if first_samples is None:
        return torch.full((1, 1), cfg.classes // 2, dtype=torch.long,
                          device=device)
    p = torch.as_tensor(first_samples).to(device=device, dtype=torch.long)
    return p.reshape(1, -1) if p.dim() == 1 else p


def classes_to_waveform(cls: torch.Tensor, classes: int) -> torch.Tensor:
    return mu_law_expansion_torch((cls.to(torch.float32) / classes) * 2.0 - 1.0,
                                  classes)


def _uniforms(generator, total: int, streams: int, device) -> torch.Tensor:
    if generator is None:
        generator = _default_generator()
    return torch.rand((total, streams), generator=generator).to(device)


@torch.no_grad()
def generate_fast(params: Params, cfg: WaveNetConfig,
                  generator: torch.Generator | None, num_samples: int,
                  first_samples=None, temperature=1.0,
                  regularize: float = 0.0, state: StreamState | None = None,
                  return_state: bool = False,
                  device: str | torch.device = "cuda",
                  cond: torch.Tensor | None = None,
                  global_cond: torch.Tensor | None = None,
                  window_prime: bool = False, progress_callback=None,
                  progress_interval: int = 1000):
    """Fast-WaveNet generation.

    ``first_samples``: int ``(S, num_given)`` prime per stream (or
    ``(num_given,)``); defaults to one mid-class sample. The given samples
    are pushed through the rings one step at a time and the last one is
    the first generation input. ``generator`` (a CPU ``torch.Generator``)
    draws the sampling uniforms; it may be None at temperature 0.
    ``cond`` ``(S, num_given - 1 + num_samples, cond_channels)`` and
    ``global_cond`` ``(S, gcond_channels)``: the module docstring's
    timeline (a resumed call takes ``num_samples`` rows).

    ``temperature``: a float, or a per-stream ``(S,)`` tensor (streams at
    temperature <= 0 take the argmax, bitwise their scalar temperature-0
    rollout: :func:`_sample`).

    ``progress_callback(done, total)`` is called every
    ``progress_interval`` samples: the rollout is split into streaming-state
    chunks at that cadence, one generator carried across them (None starts
    the one a single call would use), so the output does not change at any
    temperature; with ``cond`` each chunk takes its own rows.

    ``window_prime`` pushes a prime of more than one sample through
    :func:`gen_step_window` passes of 128 positions (then
    :func:`commit_window`) instead of one step each; the rollout then
    resumes from that state, so its uniforms are drawn for ``num_samples``
    steps only. The products are wider, so argmax rollouts agree with the
    stepwise prime except at near-ties.

    Returns ``(waveform (S, num_samples) float32, classes (S, num_samples)
    int64)``, plus the new :class:`StreamState` with ``return_state``."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    if window_prime and state is None and first_samples is not None:
        given = _prime_2d(cfg, first_samples, dev)
        S, num_given = given.shape
        if num_given > 1:
            cond, global_cond = _cond_to(cfg, S, num_given - 1 + num_samples,
                                         cond, global_cond, dev)
            gstate = init_gen_state(cfg, S, dev)
            pos, chunk = 0, 128
            while pos < num_given - 1:
                c = min(chunk, num_given - 1 - pos)
                _, pend = gen_step_window(
                    params, cfg, gstate, given[:, pos:pos + c],
                    None if cond is None else cond[:, pos:pos + c],
                    global_cond)
                gstate = commit_window(gstate, pend, c)
                pos += c
            state = StreamState(gen=gstate, cls=given[:, -1])
            first_samples = None
            cond = None if cond is None else cond[:, num_given - 1:]
    if progress_callback is None or num_samples <= progress_interval:
        out = _rollout(params, cfg, generator, num_samples, first_samples,
                       temperature, regularize, state, return_state, dev,
                       cond, global_cond)
        if progress_callback is not None:
            progress_callback(num_samples, num_samples)
        return out
    if generator is None:
        generator = _default_generator()
    wavs, clss = [], []
    done, cond_pos = 0, 0  # cond_pos: rows of the timeline consumed
    while done < num_samples:
        n = min(progress_interval, num_samples - done)
        first = first_samples if done == 0 else None
        cw = None
        if cond is not None:
            # only the first chunk can carry a prime of several samples;
            # resumed chunks enter with one (the state's next class)
            ng = 1 if first is None else _prime_2d(cfg, first, "cpu").shape[1]
            cw = cond[:, cond_pos:cond_pos + ng - 1 + n]
            cond_pos += ng - 1 + n
        wav, cls, state = _rollout(params, cfg, generator, n, first,
                                   temperature, regularize, state, True, dev,
                                   cw, global_cond)
        wavs.append(wav)
        clss.append(cls)
        done += n
        progress_callback(done, num_samples)
    wav, cls = torch.cat(wavs, dim=1), torch.cat(clss, dim=1)
    return (wav, cls, state) if return_state else (wav, cls)


def _default_generator() -> torch.Generator:
    """The uniforms' generator of a call given none."""
    return torch.Generator().manual_seed(0)


def _rollout(params, cfg, generator, num_samples, first_samples, temperature,
             regularize, state, return_state, dev, cond, global_cond,
             uniform_cols=None):
    """One uninterrupted :func:`generate_fast` rollout (params on ``dev``).
    ``uniform_cols`` ``(cols, S_all)``: the streams are the columns
    ``cols`` of a call on ``S_all`` streams, whose uniforms they take."""
    if state is not None:
        if first_samples is not None:
            raise ValueError("pass either first_samples or state, not both")
        given = state.cls.to(dev).reshape(-1, 1).long()
        # the caller's state stays as it was: roll on a copy of the rings
        gstate = GenState(tuple(b.clone() for b in state.gen.buffers),
                          state.gen.t)
    else:
        given = _prime_2d(cfg, first_samples, dev)
        gstate = init_gen_state(cfg, given.shape[0], dev)
    S, num_given = given.shape
    total = num_given - 1 + num_samples
    if not isinstance(temperature, (int, float)):
        temperature = torch.as_tensor(temperature).to(
            device=dev, dtype=torch.float32)
        if tuple(temperature.shape) != (S,):
            raise ValueError(f"temperature must be a float or have shape "
                             f"({S},), not {tuple(temperature.shape)}")
    cond, global_cond = _cond_to(cfg, S, total, cond, global_cond, dev)
    if uniform_cols is None:
        uniforms = _uniforms(generator, total, S, dev)
    else:
        cols, s_all = uniform_cols
        uniforms = _uniforms(generator, total, s_all, dev)[:, cols]

    cur = given[:, 0]
    samples = []
    for i in range(total):
        logits, gstate = gen_step(
            params, cfg, gstate, cur,
            None if cond is None else cond[:, i], global_cond)
        sampled = _sample(logits, uniforms[i], cfg.classes, temperature,
                          regularize)
        samples.append(sampled)
        cur = given[:, i + 1] if i + 1 < num_given else sampled
    out = torch.stack(samples[num_given - 1:], dim=1)
    wav = classes_to_waveform(out, cfg.classes)
    if not return_state:
        return wav, out
    return wav, out, StreamState(gen=gstate, cls=cur)


def _cond_to(cfg: WaveNetConfig, streams: int, total: int, cond,
             global_cond, device):
    """``cond`` and ``global_cond`` as f32 tensors on ``device``, checked
    against ``(streams, total, cond_channels)`` and ``(streams,
    gcond_channels)``."""
    def conv(x):
        return None if x is None else torch.as_tensor(x).to(
            device=device, dtype=torch.float32)

    cond, global_cond = conv(cond), conv(global_cond)
    check_cond(cfg, (streams, total), cond, global_cond)
    return cond, global_cond


@torch.no_grad()
def generate(params: Params, cfg: WaveNetConfig,
             generator: torch.Generator | None, num_samples: int,
             first_samples=None, temperature: float = 1.0,
             regularize: float = 0.0, device: str | torch.device = "cuda",
             cond: torch.Tensor | None = None,
             global_cond: torch.Tensor | None = None):
    """Naive generation: the full receptive-field window through the
    teacher-forced trunk per sample. O(rf) per step; the oracle for
    :func:`generate_fast`, conditioned ones included (``cond`` on the same
    ``(S, num_given - 1 + num_samples, M)`` timeline). Short primes are
    left-padded with class 0 (and the default prime is class 0, as in the
    JAX package)."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    rf = cfg.receptive_field
    if first_samples is None:
        given = torch.zeros((1, 1), dtype=torch.long, device=dev)
    else:
        given = _prime_2d(cfg, first_samples, dev)
    S, num_given = given.shape
    window = torch.zeros((S, rf), dtype=torch.long, device=dev)
    ng = min(num_given, rf)
    window[:, rf - ng:] = given[:, num_given - ng:]
    uniforms = _uniforms(generator, num_samples, S, dev)
    cond, global_cond = _cond_to(cfg, S, num_given - 1 + num_samples, cond,
                                 global_cond, dev)
    if cond is not None:
        # cond_pad[k] = cond[k - rf] (zero before the timeline): step i's
        # window covers samples [num_given + i - rf, num_given + i)
        cond_pad = torch.nn.functional.pad(cond, (0, 0, rf, 0))

    samples = []
    for i in range(num_samples):
        cw = (None if cond is None
              else cond_pad[:, num_given + i:num_given + i + rf])
        logits = wavenet_logits(params, cfg, window, out_len=1, cond=cw,
                                global_cond=global_cond)[:, 0, :]
        sampled = _sample(logits, uniforms[i], cfg.classes, temperature,
                          regularize)
        samples.append(sampled)
        window = torch.cat([window[:, 1:], sampled[:, None]], dim=1)
    out = torch.stack(samples, dim=1)
    return classes_to_waveform(out, cfg.classes), out


def synthesize(params: Params, cfg: WaveNetConfig, generator_or_seed,
               mel, hop_length: int, first_samples=None,
               temperature: float = 1.0, regularize: float = 0.0,
               global_cond=None, num_samples: int | None = None,
               backend=None, device: str | torch.device = "cuda", **kw):
    """Mel frames -> audio: the vocoder's entry point.

    ``mel`` ``(S, F, cond_channels)`` (or ``(F, cond_channels)``) log-mel
    frames at ``hop_length`` samples (``ops.mel.log_mel_spectrogram``) are
    upsampled to per-sample rows by :func:`models.wavenet.upsample_cond`
    and drive a conditioned rollout of ``backend``: :func:`generate_fast`
    (the default; ``generator_or_seed`` a ``torch.Generator`` or None) or
    the fused kernel's ``generate_fast_fused`` (an int seed), both with the
    ``cond=(S, total, M)`` contract; ``kw`` goes to the backend (e.g.
    ``fuse_res``). ``num_samples`` defaults to ``F * hop_length -
    num_given + 1``, so the rollout consumes exactly the conditioned
    timeline. Returns ``(waveform (S, num_samples) f32, classes)``."""
    if backend is None:
        backend = generate_fast
    dev = resolve_device(device)
    mel = torch.as_tensor(mel).to(device=dev, dtype=torch.float32)
    if mel.dim() == 2:
        mel = mel[None]
    S, F, M = mel.shape
    if cfg.cond_channels != M:
        raise ValueError(f"mel has {M} channels but cfg.cond_channels is "
                         f"{cfg.cond_channels}")
    if first_samples is None:
        first = torch.full((S, 1), cfg.classes // 2, dtype=torch.long)
    else:
        first = torch.as_tensor(first_samples).to(torch.long)
        if first.dim() == 1:
            first = first.reshape(1, -1)
        if first.shape[0] == 1 and S > 1:
            first = first.expand(S, -1)
    num_given = first.shape[1]
    if num_samples is None:
        num_samples = F * hop_length - num_given + 1
    total = num_given - 1 + num_samples
    cond = upsample_cond(params_to(params, dev), cfg, mel, hop_length, total)
    return backend(params, cfg, generator_or_seed, num_samples,
                   first.contiguous(), temperature=temperature,
                   regularize=regularize, cond=cond, global_cond=global_cond,
                   device=dev, **kw)


def generate_long(params: Params, cfg: WaveNetConfig, generator_or_seed,
                  num_samples: int, first_samples=None, temperature=1.0,
                  regularize: float = 0.0, chunk_size: int = 65536,
                  backend=None, progress_callback=None,
                  streaming: bool = True,
                  device: str | torch.device = "cuda", **kw):
    """Generation of any length by chunking a backend.

    ``backend``: :func:`generate_fast` (the default),
    ``ops.cuda.gen_kernel.generate_fast_fused`` (K1) or
    ``ops.cuda.gen_kernel_hbm.generate_fast_batched`` (K4); ``kw`` goes to
    it (``fuse_res``, ``skip_slab``, ``ring_dtype``). It runs in
    ``chunk_size`` pieces, and ``progress_callback(done, num_samples)`` is
    called after each. With ``streaming`` (the default) the backend's state
    flows from chunk to chunk (``state``/``return_state``), so the chunk
    boundaries change nothing; ``streaming=False`` re-primes each chunk with
    the last ``cfg.receptive_field`` samples of the history instead.

    The noise across chunks departs from the JAX package, which splits its
    key per chunk: K1 and K4 key their counter-hash noise by a seed and the
    absolute step, so every chunk gets the same int seed (drawn once from
    ``generator_or_seed``, a ``torch.Generator``, an int or None = 0, as a
    single call draws it), and :func:`generate_fast` carries one
    ``torch.Generator`` across the chunks (an int seeds a new one, None is
    its default). A streamed rollout then equals the backend's single call
    bitwise at every temperature. At temperature > 0 no rollout of the port
    equals the JAX package's: the random streams differ.

    Returns ``(waveform (S, num_samples) f32, classes (S, num_samples))``."""
    if backend is None:
        backend = generate_fast
    rf = cfg.receptive_field
    if chunk_size <= rf:
        raise ValueError(f"chunk_size {chunk_size} must exceed rf {rf}")
    dev = resolve_device(device)
    if backend is generate_fast:
        noise = (generator_or_seed
                 if isinstance(generator_or_seed, torch.Generator)
                 else _default_generator() if generator_or_seed is None
                 else torch.Generator().manual_seed(int(generator_or_seed)))
    else:
        from ..ops.cuda.gen_kernel import _seed_from

        noise = _seed_from(generator_or_seed)
    prime = _prime_2d(cfg, first_samples, dev)

    outs = []
    done = 0
    state = None
    while done < num_samples:
        n = min(chunk_size, num_samples - done)
        if streaming:
            _, cls, state = backend(
                params, cfg, noise, n, prime if state is None else None,
                temperature=temperature, regularize=regularize, state=state,
                return_state=True, device=dev, **kw)
        else:
            _, cls = backend(params, cfg, noise, n, prime,
                             temperature=temperature, regularize=regularize,
                             device=dev, **kw)
            # the next chunk continues from the history's tail
            prime = torch.cat([prime, cls.to(prime.dtype)], dim=1)[:, -rf:]
        outs.append(cls)
        done += n
        if progress_callback is not None:
            progress_callback(done, num_samples)
    out = torch.cat(outs, dim=1)
    return classes_to_waveform(out, cfg.classes), out
