"""Speculative argmax generation: a draft proposes, the teacher verifies.

The counterpart of the JAX package's ``models/speculative.py``. A small
draft WaveNet proposes ``k`` samples one :func:`gen_step` at a time; the
teacher scores all ``k`` in one :func:`gen_step_window` pass over its ring
state; the leading run where the draft equals the teacher's argmax is
accepted, and the first mismatch is replaced by the teacher's own argmax.
Each verify pass therefore emits between 1 and ``k`` samples, all of them
the teacher's argmax on the emitted history: the draft moves the speed,
never the classes.

The JAX package runs the loop as one on-device ``while_loop`` and stacks
the draft's per-step states in a scan. Here the rings are written in place,
so the draft steps run on a copy of its rings and record each layer's
input (``gen_step(record=...)``); after the verify pass those inputs are
committed into the draft's own rings for the accepted count, which leaves
them bitwise as that many sequential steps would. The accepted count is
read on the host once per verify pass (``host_syncs`` counts the reads);
everything else stays on the device.
"""

from __future__ import annotations

import torch

from ..config import WaveNetConfig
from ..device import resolve_device
from .generate import (GenState, PendingWindow, _prime_2d, classes_to_waveform,
                       commit_window, gen_step, gen_step_window,
                       init_gen_state)
from .wavenet import Params, params_to

# accepted counts read on the host since the count was last set to 0 (one
# per verify pass)
host_syncs = 0


def _prime_state(params: Params, cfg: WaveNetConfig, state: GenState,
                 given: torch.Tensor, chunk: int = 128) -> GenState:
    """Consume the input classes ``given (S, n)`` into ``state`` through
    window passes of ``chunk`` positions."""
    n = given.shape[1]
    pos = 0
    while pos < n:
        c = min(chunk, n - pos)
        _, pend = gen_step_window(params, cfg, state, given[:, pos:pos + c])
        state = commit_window(state, pend, c)
        pos += c
    return state


@torch.no_grad()
def speculative_generate(teacher_params: Params, tcfg: WaveNetConfig,
                         draft_params: Params, dcfg: WaveNetConfig,
                         generator: torch.Generator | None, num_samples: int,
                         first_samples=None, k: int = 8,
                         device: str | torch.device = "cuda"):
    """Argmax generation of the teacher through draft-and-verify.

    ``first_samples``: int ``(1, num_given)`` (or ``(num_given,)``); one
    stream only (speculation buys latency; the batched kernel serves
    throughput). Defaults to one mid-class sample. ``k``: the samples the
    draft proposes per verify pass. ``generator`` is accepted for the JAX
    signature and unused: an argmax rollout draws no noise.

    Returns ``(waveform (1, n) f32, classes (1, n) int64, accept_rate)``,
    ``accept_rate`` the mean samples emitted per verify pass (at most
    ``k``; exactly ``k`` when the draft is the teacher).

    Every class is the teacher's argmax on the emitted history, as in
    ``generate_fast(temperature=0)``. The JAX package states the classes
    bitwise equal to that rollout; here the verify pass forms ``(k, R)``
    products where the rollout forms ``(1, R)`` ones, which may round
    differently, so a class may differ where the teacher's top-2 logit gap
    is below 1e-4 (the port's near-tie rule), and the rollouts part
    there."""
    global host_syncs
    del generator
    if dcfg.classes != tcfg.classes:
        raise ValueError("draft and teacher must share the codebook")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    dev = resolve_device(device)
    prime = _prime_2d(tcfg, first_samples, dev)
    if prime.shape[0] != 1:
        raise ValueError("speculative_generate is single-stream; got "
                         f"{prime.shape[0]} streams")
    tparams = params_to(teacher_params, dev)
    dparams = params_to(draft_params, dev)
    tstate = init_gen_state(tcfg, 1, dev)
    dstate = init_gen_state(dcfg, 1, dev)
    if prime.shape[1] > 1:
        tstate = _prime_state(tparams, tcfg, tstate, prime[:, :-1])
        dstate = _prime_state(dparams, dcfg, dstate, prime[:, :-1])
    cur = prime[:, -1]

    out = torch.zeros((1, num_samples + k), dtype=torch.long, device=dev)
    cnt = iters = 0
    while cnt < num_samples:
        # 1. the draft proposes k samples on a copy of its rings, recording
        # each step's layer inputs
        work = GenState(tuple(b.clone() for b in dstate.buffers), dstate.t)
        records, proposed, x = [], [], cur
        for _ in range(k):
            rec = []
            logits, work = gen_step(dparams, dcfg, work, x, record=rec)
            records.append(rec)
            x = torch.argmax(logits, dim=-1)
            proposed.append(x)
        draft = torch.stack(proposed, dim=1)  # (1, k)

        # 2. the teacher verifies the k inputs [cur, d_0 .. d_{k-2}]
        win = torch.cat([cur[:, None], draft[:, :-1]], dim=1)
        logits, pend = gen_step_window(tparams, tcfg, tstate, win)
        targmax = torch.argmax(logits, dim=-1)  # (1, k)

        # 3. the leading run of matches, plus the teacher's correction
        v = torch.cumprod((draft[0] == targmax[0]).long(), dim=0).sum()
        a = int(torch.clamp(v + 1, max=k))  # the one host read of a pass
        host_syncs += 1

        # 4. commit exactly the consumed inputs to both models
        tstate = commit_window(tstate, pend, a)
        h_wins = tuple(torch.stack([r[l] for r in records], dim=1)
                       for l in range(dcfg.num_layers))
        dstate = commit_window(dstate, PendingWindow(h_wins, dstate.t), a)
        out[:, cnt:cnt + k] = targmax
        cur = targmax[:, a - 1]
        cnt += a
        iters += 1
    cls = out[:, :num_samples]
    return (classes_to_waveform(cls, tcfg.classes), cls,
            cnt / max(iters, 1))
