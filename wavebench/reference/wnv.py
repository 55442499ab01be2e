"""The WaveNet vocoder's teacher-forced forward in plain PyTorch, written
from its layer equations (kan-bayashi/PytorchWaveNetVocoder,
``src/nets/wavenet.py``) in the stacked params layout the harness makes
(``loads/frames_pool.py``), and the served-gap judge over its frames.

Input: a causal conv of kernel 2 over the one-hot classes, ``h0[t] =
w_prev[x[t-1]] + w[x[t]] + b`` (zero before the start). Upsampler: frame
i holds samples ``[80 i, 80 (i + 1))``, ``c[t] = f[t div 80] * up_w[t mod
80] + up_b``. Layer l (dilation ``2 ** (l mod 10)``): ``z = h(t - d) @
w_in[l, 0] + h(t) @ w_in[l, 1] + c(t) @ w_cond[l] + b_in[l]``; ``u =
tanh(z[:D]) * sigmoid(z[D:])``; the skip sum gathers ``u @ w_skip[l] +
b_skip[l]``; ``h <- h + u @ w_res[l] + b_res[l]``. Head: ``relu -> end1
-> relu -> end2``. Every product is f32 with TF32 off, or, for the
control, has both operands rounded to TF32 (``wavenet.mm``). The
positions are computed in blocks, each with the receptive field's history
before it, so a request of 96,000 positions fits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import noise
from .wavenet import dilations, mm, set_f32

BLOCK = 16384  # positions a block computes


def receptive_field(model: dict) -> int:
    return 2 + model["blocks"] * (2 ** model["layers"] - 1)


def cond_rows(p: dict, frames: torch.Tensor, hop: int,
              length: int) -> torch.Tensor:
    """The upsampler: frames ``(F, M)`` -> rows ``(length, M)`` (the last
    frame held past the timeline's end)."""
    t = torch.arange(length, device=frames.device)
    i = torch.clamp(torch.div(t, hop, rounding_mode="floor"),
                    max=frames.shape[0] - 1)
    return frames[i] * p["cond_up"]["w"][t % hop][:, None] + p["cond_up"]["b"]


def _logits(p: dict, model: dict, x: torch.Tensor, c: torch.Tensor,
            out_len: int, prec: str) -> torch.Tensor:
    """Logits ``(out_len, C)`` at the last ``out_len`` positions of ``x``
    ``(T,)`` under rows ``c`` ``(T, M)``, history before ``x`` zero."""
    D = model["dilation_channels"]
    lp = p["layers"]
    T = x.shape[0]
    prev = F.pad(p["start"]["w_prev"][x[:-1]], (0, 0, 1, 0))
    h = prev + p["start"]["w"][x] + p["start"]["b"]
    skip = 0.0
    for l, d in enumerate(dilations(model)):
        tap = F.pad(h, (0, 0, d, 0))[:T]
        z = (mm(tap, lp["w_in"][l, 0], prec) + mm(h, lp["w_in"][l, 1], prec)
             + mm(c, lp["w_cond"][l], prec) + lp["b_in"][l])
        u = torch.tanh(z[:, :D]) * torch.sigmoid(z[:, D:])
        skip = skip + mm(u[T - out_len:], lp["w_skip"][l], prec) \
            + lp["b_skip"][l]
        h = h + mm(u, lp["w_res"][l], prec) + lp["b_res"][l]
    y = torch.relu(mm(torch.relu(skip), p["end1"]["w"], prec) + p["end1"]["b"])
    return mm(y, p["end2"]["w"], prec) + p["end2"]["b"]


def logits(p: dict, model: dict, x: torch.Tensor, c: torch.Tensor,
           first: int, n: int, prec: str = "f32") -> torch.Tensor:
    """Logits ``(n, C)`` at positions ``first .. first + n - 1`` of the
    classes ``x`` ``(T,)`` under rows ``c`` ``(T, M)``; position t
    predicts x[t + 1]. Blocks of :data:`BLOCK` positions, each with the
    receptive field's history."""
    hist = receptive_field(model) - 1
    out = []
    for a in range(first, first + n, BLOCK):
        b = min(a + BLOCK, first + n)
        lo = max(0, a - hist)
        out.append(_logits(p, model, x[lo:b], c[lo:b], b - a, prec))
    return torch.cat(out)


@torch.no_grad()
def served_gaps(p: dict, model: dict, hop: int, prime: torch.Tensor,
                served: torch.Tensor, frames: torch.Tensor,
                temperature: float, seed: int, control: bool = False) -> dict:
    """Widest gaps of one request (``reference/judge.py``'s rule):
    ``{"gap": program's}`` and, with ``control``, ``"control_gap"`` and the
    altered class's ``"fault_gap"``."""
    P, n = prime.numel(), served.numel()
    seq = torch.cat([prime, served[:-1]])
    c = cond_rows(p, frames, hop, seq.numel())
    unit = temperature if temperature > 0 else 1.0
    sc = noise.scores(logits(p, model, seq, c, P - 1, n), P - 1,
                      temperature, seed)
    best = sc.max(dim=-1).values
    got = sc.gather(1, served[:, None])[:, 0]
    out = {"gap": unit * float((best - got).max())}
    if control:
        pick = noise.scores(logits(p, model, seq, c, P - 1, n, "tf32"), P - 1,
                            temperature, seed).argmax(dim=-1)
        out["control_gap"] = unit * float(
            (best - sc.gather(1, pick[:, None])[:, 0]).max())
        i = n // 2
        alt = (served[i] + 1) % sc.shape[1]
        out["fault_gap"] = unit * float(best[i] - sc[i, alt])
    return out


def judge_served(p: dict, model: dict, hop: int, checked: list, device,
                 control: bool = False) -> dict:
    """``checked``: ``(prime, served, temperature, seed, frames)`` per
    request (host arrays). Returns the widest gaps and the positions
    read."""
    set_f32()
    worst = {"gap": 0.0}
    if control:
        worst.update(control_gap=0.0, fault_gap=float("inf"))
    positions = 0
    for prime, served, temp, seed, frames in checked:
        g = served_gaps(
            p, model, hop,
            torch.as_tensor(prime, dtype=torch.int64).to(device),
            torch.as_tensor(served, dtype=torch.int64).to(device),
            torch.as_tensor(frames, dtype=torch.float32).to(device), temp,
            seed, control)
        for k, v in g.items():
            worst[k] = min(worst[k], v) if k == "fault_gap" else max(
                worst[k], v)
        positions += len(served)
    worst["positions"] = positions
    return worst
