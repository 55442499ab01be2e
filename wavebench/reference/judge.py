"""The comparison that decides ``correct``.

Served audio (the pool and the single stream): the reference runs once over
each checked request's prime and served classes, teacher-forced, and
reads at each served position the gap by which the served class's sampling
score lies below the best score the reference gives there (0 where they
agree), times the request's temperature, so that every gap is in the
logits' units. The number compared is the widest gap over the checked
requests.
The control reads, at the same positions, the gap of the class that a
TF32 reference puts first.

"""

from __future__ import annotations

import torch

from . import noise
from .wavenet import logits, set_f32


# ----------------------------------------------------------------- served

@torch.no_grad()
def served_gaps(p: dict, model: dict, prime: torch.Tensor,
                served: torch.Tensor, temperature: float, seed: int,
                control: bool = False) -> dict:
    """Widest gaps of one request: ``{"gap": program's}`` and, with
    ``control``, ``"control_gap"``. ``prime`` and ``served`` are int64 on
    the reference's device; served class i came out of request-local step
    ``len(prime) - 1 + i``."""
    P, n = prime.numel(), served.numel()
    seq = torch.cat([prime, served[:-1]])[None]
    first = P - 1
    # scores are logits / T + noise: gaps times T are in the logits' units
    unit = temperature if temperature > 0 else 1.0
    lg = logits(p, model, seq, n)[0]
    sc = noise.scores(lg, first, temperature, seed)
    best = sc.max(dim=-1).values
    got = sc.gather(1, served[:, None])[:, 0]
    out = {"gap": unit * float((best - got).max())}
    if control:
        lc = logits(p, model, seq, n, prec="tf32")[0]
        pick = noise.scores(lc, first, temperature, seed).argmax(dim=-1)
        out["control_gap"] = unit * float(
            (best - sc.gather(1, pick[:, None])[:, 0]).max())
        # the fault of one served class altered where it is produced
        i = n // 2
        alt = (served[i] + 1) % sc.shape[1]
        out["fault_gap"] = unit * float(best[i] - sc[i, alt])
    return out


def judge_served(p: dict, model: dict, checked: list, device,
                 control: bool = False) -> dict:
    """``checked``: ``(prime, served, temperature, seed)`` per request
    (host int arrays). Returns the widest gaps and the positions read."""
    set_f32()
    worst = {"gap": 0.0}
    if control:
        worst.update(control_gap=0.0, fault_gap=float("inf"))
    positions = 0
    for prime, served, temp, seed in checked:
        g = served_gaps(p, model,
                        torch.as_tensor(prime, dtype=torch.int64).to(device),
                        torch.as_tensor(served, dtype=torch.int64).to(device),
                        temp, seed, control)
        for k, v in g.items():
            # the fault reads what it reads at its least
            worst[k] = min(worst[k], v) if k == "fault_gap" else max(
                worst[k], v)
        positions += len(served)
    worst["positions"] = positions
    return worst
