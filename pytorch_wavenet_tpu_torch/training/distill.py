"""Probability density distillation: AR teacher -> parallel IAF student.

The counterpart of the JAX package's ``training/distill.py``. The student
(``models/iaf.py``) is trained on the one-draw estimate of

    KL( q_student || p_teacher )  =  E_{x~q} [ log q(x) - log p(x) ]

per step, between two distributions over the teacher's C mu-law classes:

* the student's output conditional at step t is Logistic(m_t, s_t);
  integrated over each mu-law bin it is an exact discrete distribution
  q_t(c), smooth in (m_t, s_t) through the logistic CDF;
* the teacher's p_t(c) is the softmax of its logits on the quantized draw,
  scored teacher-forced in one trunk pass.

The teacher is frozen: it scores ``quantize_data_torch(x)`` under
``torch.no_grad()`` (the JAX package's ``stop_gradient`` of the draw and of
the teacher's params), so with ``tcfg.trunk_kernel`` its trunk is the
forward kernel K2 on the card and the backward kernel K3 never runs.
Gradients reach the student through q_t only. An optional power loss
matches the draws' average log-power spectrum to real audio, and an rms
loss their level.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import WaveNetConfig
from ..models.iaf import IAFConfig, student_sample, student_state_dict
from ..models.wavenet import wavenet_logits
from ..ops.mulaw import mu_law_expansion, quantize_data_torch
from .optimizers import _leaves, _map


def mu_law_bin_edges(classes: int) -> np.ndarray:
    """Amplitude-space edges of the ``classes`` quantization bins,
    ``(classes + 1,)`` f32 with infinite outer edges (mass outside [-1, 1]
    belongs to the boundary classes, as the encoder clips): bin c spans
    ``[edges[c], edges[c+1])``, the expansion of the encoder's mu-law-space
    edges ``linspace(-1, 1, classes)``."""
    inner = mu_law_expansion(np.linspace(-1.0, 1.0, classes), classes)
    return np.concatenate([[-np.inf], inner[1:], [np.inf]]).astype(np.float32)


def student_bin_logprobs(m: torch.Tensor, log_s: torch.Tensor,
                         classes: int) -> torch.Tensor:
    """Per-step Logistic(m, exp(log_s)) discretised over the mu-law bins:
    probabilities ``(..., classes)`` summing to 1, each bin a difference of
    sigmoids. Only the finite inner edges enter (the boundary bins are CDF
    complements): an infinite edge times ``exp(-log_s)`` would make the
    gradient with respect to ``log_s`` a ``0 * inf`` NaN."""
    edges = torch.from_numpy(mu_law_bin_edges(classes)[1:-1]).to(m.device)
    zed = (edges - m[..., None]) * torch.exp(-log_s)[..., None]
    cdf = torch.sigmoid(zed)
    return torch.cat([cdf[..., :1], torch.diff(cdf, dim=-1),
                      1.0 - cdf[..., -1:]], dim=-1)


def power_spectrum(x: torch.Tensor, frame: int = 256,
                   hop: int = 64) -> torch.Tensor:
    """Batch- and frame-averaged log power spectrum ``(frame // 2 + 1,)``
    of ``x (B, T)``, under ``np.hanning``'s symmetric window."""
    T = x.shape[-1]
    n = (T - frame) // hop + 1
    idx = (torch.arange(n)[:, None] * hop + torch.arange(frame)).to(x.device)
    win = torch.hann_window(frame, periodic=False, dtype=torch.float32,
                            device=x.device)
    mag2 = torch.abs(torch.fft.rfft(x[:, idx] * win, dim=-1)) ** 2
    return torch.log(torch.mean(mag2, dim=(0, 1)) + 1e-8)


def teacher_logprobs(teacher_params, tcfg: WaveNetConfig, x: torch.Tensor,
                     cond=None, global_cond=None,
                     teacher_smooth: float = 0.0) -> torch.Tensor:
    """The frozen teacher's log-probabilities ``(B, T - rf, C)`` on the
    quantized ``x (B, T)``: logits teacher-forced (row i predicts position
    ``rf + i``; the last row, beyond the clip, is dropped), optionally
    label-smoothed ``p' = (1 - eps) p + eps / C`` (as ``logaddexp``).
    Under ``torch.no_grad()``: no graph reaches the teacher's params or the
    draw (the JAX package's ``stop_gradient``)."""
    rf = tcfg.receptive_field
    with torch.no_grad():
        xq = quantize_data_torch(x, tcfg.classes)
        logits = wavenet_logits(
            teacher_params, tcfg, xq, out_len=x.shape[1] - rf + 1,
            cond=None if cond is None or tcfg.cond_channels == 0 else cond,
            global_cond=(None if global_cond is None
                         or tcfg.gcond_channels == 0 else global_cond),
        )[:, :-1]
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        if teacher_smooth:
            logp = torch.logaddexp(
                logp + float(np.log1p(-teacher_smooth)),
                torch.tensor(float(np.log(teacher_smooth / tcfg.classes)),
                             device=logp.device))
    return logp


def distill_loss(student_params, teacher_params, scfg: IAFConfig,
                 tcfg: WaveNetConfig, generator_or_u, batch_size: int,
                 length: int, cond=None, global_cond=None, audio_ref=None,
                 power_weight: float = 0.0, rms_weight: float = 0.0,
                 teacher_smooth: float = 0.0, rms_per_item: bool = False):
    """One-draw estimate of the distillation objective: ``(loss, aux)``,
    aux holding ``kl``, ``rms`` and, when weighted, ``power`` and
    ``rms_loss``.

    ``generator_or_u``: a CPU ``torch.Generator`` for the base uniforms, or
    the uniforms ``(batch_size, length)`` themselves. ``length`` must exceed
    the teacher's receptive field (the first ``rf`` positions only prime
    the teacher). ``cond (B, length, M)`` conditions both models (each
    where it has cond channels); ``audio_ref (B', T')`` enables the power
    and rms terms. ``teacher_smooth`` label-smooths the teacher: a sharp
    teacher makes the KL's cheapest descent a runaway of ``log_s``;
    ``rms_per_item`` pins each draw's level to its own row of
    ``audio_ref`` (conditioned distillation) instead of the batch's. The
    rms and power terms read the unclipped draw: a clip has no gradient
    where the draw saturates."""
    rf = tcfg.receptive_field
    if length <= rf:
        raise ValueError(f"length {length} must exceed teacher rf {rf}")
    if isinstance(generator_or_u, torch.Generator) or generator_or_u is None:
        gen, u = generator_or_u, None
    else:
        gen, u = None, generator_or_u
    draw = student_sample(student_params, scfg, gen, (batch_size, length),
                          cond=cond, global_cond=global_cond, u=u)
    x = torch.clamp(draw.x, -1.0, 1.0)
    logp = teacher_logprobs(teacher_params, tcfg, x, cond, global_cond,
                            teacher_smooth)

    q = student_bin_logprobs(draw.m[:, rf:], draw.log_s[:, rf:],
                             tcfg.classes)
    logq = torch.log(torch.clamp(q, min=1e-12))
    kl = torch.mean(torch.sum(q * (logq - logp), dim=-1))

    aux = {"kl": kl, "rms": torch.sqrt(torch.mean(draw.x * draw.x))}
    loss = kl
    if power_weight and audio_ref is not None:
        p_loss = torch.mean(
            (power_spectrum(draw.x) - power_spectrum(audio_ref)) ** 2)
        aux["power"] = p_loss
        loss = loss + power_weight * p_loss
    if rms_weight and audio_ref is not None:
        if rms_per_item:
            dr = torch.sqrt(torch.mean(draw.x * draw.x, dim=-1))
            rr = torch.sqrt(torch.mean(audio_ref * audio_ref, dim=-1))
            r_loss = torch.mean(
                (torch.log(dr + 1e-6) - torch.log(rr + 1e-6)) ** 2)
        else:
            r_loss = (torch.log(aux["rms"] + 1e-6) - torch.log(
                torch.sqrt(torch.mean(audio_ref ** 2)) + 1e-6)) ** 2
        aux["rms_loss"] = r_loss
        loss = loss + rms_weight * r_loss
    return loss, aux


def distill_step(student_params, opt_state: dict, teacher_params,
                 scfg: IAFConfig, tcfg: WaveNetConfig, tx, generator_or_u,
                 batch_size: int, length: int, cond=None, global_cond=None,
                 audio_ref=None, power_weight: float = 0.0,
                 rms_weight: float = 0.0, teacher_smooth: float = 0.0,
                 rms_per_item: bool = False):
    """One distillation update of the student (the teacher frozen):
    ``(student_params, opt_state, loss, aux)``, the params and the state
    updated in place. ``tx`` is a port optimizer (the CLI's is
    ``reference_adam(lr, gradient_clipping=1.0)``, optax's
    ``chain(clip_by_global_norm(1.0), adam(lr))``) whose state comes from
    ``tx.init(student_state_dict(student_params))``: it works on the
    state-dict view, so its state has optax's layout."""
    view = student_state_dict(student_params)
    leaves = [p for _, p in _leaves(view)]
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = distill_loss(
        student_params, teacher_params, scfg, tcfg, generator_or_u,
        batch_size, length, cond=cond, global_cond=global_cond,
        audio_ref=audio_ref, power_weight=power_weight,
        rms_weight=rms_weight, teacher_smooth=teacher_smooth,
        rms_per_item=rms_per_item)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, grads)])
    tx.step(view, _map(lambda _: next(it), view), opt_state)
    return (student_params, opt_state, loss.detach(),
            {k: v.detach() for k, v in aux.items()})
