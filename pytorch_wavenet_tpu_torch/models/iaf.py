"""Inverse-autoregressive-flow student for Parallel-WaveNet distillation.

The counterpart of the JAX package's ``models/iaf.py``, in plain PyTorch
with autograd. The student draws audio as one parallel transform of white
logistic noise,

    x = flow_F( ... flow_1(z0) ... ),      z0_t ~ Logistic(0, 1)

where each flow is a small causal WaveNet over its input noise: ``z'_t =
z_t * s_t + mu_t`` with ``(mu_t, log s_t)`` functions of ``z_{<t}`` only.
Every flow evaluates all T positions in one teacher-forced trunk pass, so a
clip costs F trunk passes and no serial loop. Given the noise history, the
output at t is ``Logistic(m_t, s_tot_t)``, with ``m`` and ``s_tot``
accumulated through the affine flows: what distillation trains against
(``training/distill.py``).

Params keep the JAX package's tree: ``{"flows": (flow_0, ..., flow_F-1)}``,
each flow the teacher's stacked layout (``start``, ``layers``, ``end1``,
``end2``) with one input channel and two outputs. Checkpoints store the
tuple in flax's state-dict layout, ``{"flows": {"0": ..., "1": ...}}``
(:func:`student_state_dict`), so either package reads the other's student
snapshots.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from .wavenet import _conv_init, _mm, params_to

StudentParams = Any


@dataclasses.dataclass(frozen=True)
class IAFConfig:
    """Student architecture. Flows share one shape; dilations reset per
    block as in the teacher (``WaveNetConfig.dilations``)."""

    flows: int = 4
    layers: int = 10
    blocks: int = 1
    residual_channels: int = 64
    dilation_channels: int = 64
    skip_channels: int = 64
    end_channels: int = 64
    kernel_size: int = 2
    cond_channels: int = 0
    gcond_channels: int = 0
    bias: bool = True
    compute_dtype: Any = torch.float32

    @property
    def dilations(self) -> tuple[int, ...]:
        return tuple(2 ** l for _ in range(self.blocks)
                     for l in range(self.layers))

    @property
    def num_layers(self) -> int:
        return self.layers * self.blocks

    @property
    def receptive_field(self) -> int:
        return 1 + self.blocks * (self.kernel_size - 1) * (2 ** self.layers - 1)


class StudentSample(NamedTuple):
    """One parallel draw: audio ``x (B, T)``; the per-step output
    conditional ``Logistic(m, exp(log_s))`` given the noise history; the
    base noise ``z0``; ``log_q (B,)``, the draw's log-density under the
    student (the base log-pdf minus the summed log-scales)."""

    x: torch.Tensor
    m: torch.Tensor
    log_s: torch.Tensor
    z0: torch.Tensor
    log_q: torch.Tensor


def init_student(scfg: IAFConfig, generator: torch.Generator,
                 init_scale: float = 1.0,
                 device: str | torch.device = "cuda") -> StudentParams:
    """Random student params (the JAX package's tree and shapes; draws on
    the CPU ``generator``, then moved to ``device``). Every flow's last
    layer ``end2`` is zero, so each flow starts as the identity and the
    student as pure logistic noise.

    ``init_scale`` != 1 sets the last flow's log-scale bias so that the
    composed transform starts as ``x = init_scale * z0``: the inverse of
    the soft bound ``log_s = 7 tanh(b / 7)``, ``b = 7 artanh(log(s) / 7)``.
    Logistic(0, 1) noise (std 1.81) sits where a mu-law teacher's
    log-probability is flat; match the data, ``init_scale ~ rms / 1.81``."""
    dev = resolve_device(device)
    L, k = scfg.num_layers, scfg.kernel_size
    R, D, S, E = (scfg.residual_channels, scfg.dilation_channels,
                  scfg.skip_channels, scfg.end_channels)
    g = generator
    zeros = dict(dtype=torch.float32, device=dev)
    flows = []
    for _ in range(scfg.flows):
        fp = {
            "start": {"w": _conv_init(g, (1, R), 1, dev)},
            "layers": {
                "w_in": _conv_init(g, (L, k, R, 2 * D), R * k, dev),
                "w_res": _conv_init(g, (L, D, R), D, dev),
                "w_skip": _conv_init(g, (L, D, S), D, dev),
            },
            "end1": {"w": _conv_init(g, (S, E), S, dev),
                     "b": torch.zeros((E,), **zeros)},
            "end2": {"w": torch.zeros((E, 2), **zeros),
                     "b": torch.zeros((2,), **zeros)},
        }
        if scfg.bias:
            fp["start"]["b"] = _conv_init(g, (R,), 1, dev)
            fp["layers"]["b_in"] = _conv_init(g, (L, 2 * D), R * k, dev)
            fp["layers"]["b_res"] = _conv_init(g, (L, R), D, dev)
            fp["layers"]["b_skip"] = _conv_init(g, (L, S), D, dev)
        if scfg.cond_channels:
            M = scfg.cond_channels
            fp["layers"]["w_cond"] = _conv_init(g, (L, M, 2 * D), M, dev)
        if scfg.gcond_channels:
            G = scfg.gcond_channels
            fp["layers"]["w_gcond"] = _conv_init(g, (L, G, 2 * D), G, dev)
        flows.append(fp)
    if init_scale != 1.0:
        tgt = float(np.log(init_scale))
        if abs(tgt) >= 7.0:
            raise ValueError(f"init_scale {init_scale} outside the "
                             "log-scale soft bound (+/-7 nats)")
        b = 7.0 * float(np.arctanh(tgt / 7.0))
        flows[-1]["end2"]["b"] = torch.tensor([0.0, b], **zeros)
    return {"flows": tuple(flows)}


def flow_transform(fp, scfg: IAFConfig, z: torch.Tensor,
                   cond: torch.Tensor | None = None,
                   global_cond: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One flow's ``(mu, log_s)``, each ``(B, T)``, from ``z (B, T)``.

    The input is shifted one step right before the trunk, so position t
    sees ``z_{<t}`` only (history before the clip is zero, as in the
    teacher's taps). ``cond (B, T, M)`` rows align with the output
    positions and are not shifted; ``global_cond`` is ``(B, G)``. The
    log-scale is soft-bounded, ``7 tanh(log_s / 7)``."""
    k = scfg.kernel_size
    cdt = scfg.compute_dtype
    B, T = z.shape
    zin = F.pad(z[:, :-1], (1, 0))[..., None]  # (B, T, 1)
    h = _mm(zin, fp["start"]["w"], cdt)
    if "b" in fp["start"]:
        h = h + fp["start"]["b"]
    h = h.to(torch.float32)

    lp = fp["layers"]
    skip = torch.zeros((B, T, scfg.skip_channels), dtype=torch.float32,
                       device=z.device)
    for l, d in enumerate(scfg.dilations):
        zl = _mm(h, lp["w_in"][l, k - 1], cdt)
        for j in range(k - 1):
            shift = (k - 1 - j) * d
            tap = F.pad(h, (0, 0, shift, 0))[:, :T, :]
            zl = zl + _mm(tap, lp["w_in"][l, j], cdt)
        if cond is not None:
            zl = zl + _mm(cond, lp["w_cond"][l], cdt)
        if global_cond is not None:
            zl = zl + _mm(global_cond, lp["w_gcond"][l], cdt)[:, None, :]
        if "b_in" in lp:
            zl = zl + lp["b_in"][l]
        f, g = zl.chunk(2, dim=-1)
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
    y = torch.relu(_mm(y, fp["end1"]["w"], cdt) + fp["end1"]["b"])
    out = _mm(y, fp["end2"]["w"], cdt) + fp["end2"]["b"]  # (B, T, 2)
    return out[..., 0], 7.0 * torch.tanh(out[..., 1] / 7.0)


def _logistic_logpdf(z: torch.Tensor) -> torch.Tensor:
    """log pdf of Logistic(0, 1): ``-z - 2 softplus(-z)``."""
    return -z - 2.0 * F.softplus(-z)


def base_uniforms(generator: torch.Generator | None,
                  shape: tuple[int, int]) -> torch.Tensor:
    """The base uniforms of a draw, on ``[1e-5, 1 - 1e-5)`` as the JAX
    package draws them (``minval + (maxval - minval) * U``), from a CPU
    ``generator`` (seed 0 when None): one seed gives the same draw on every
    device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    lo, hi = 1e-5, 1.0 - 1e-5
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return torch.clamp(lo + (hi - lo) * u, min=lo)


def _device_of(params) -> torch.device:
    return params["flows"][0]["start"]["w"].device


def student_sample(params: StudentParams, scfg: IAFConfig,
                   generator: torch.Generator | None, shape: tuple[int, int],
                   cond: torch.Tensor | None = None,
                   global_cond: torch.Tensor | None = None,
                   u: torch.Tensor | None = None) -> StudentSample:
    """Draw ``shape = (B, T)`` audio in one parallel pass (F flow trunks) on
    the params' device; differentiable in the params through the
    reparameterised noise. ``u``: the base uniforms ``(B, T)`` on ``[1e-5,
    1 - 1e-5)`` (:func:`base_uniforms` of ``generator`` when None); ``z0 =
    log u - log1p(-u)``."""
    if cond is not None and scfg.cond_channels == 0:
        raise ValueError("cond given but scfg.cond_channels == 0")
    if global_cond is not None and scfg.gcond_channels == 0:
        raise ValueError("global_cond given but scfg.gcond_channels == 0")
    dev = _device_of(params)
    B, T = shape
    if u is None:
        u = base_uniforms(generator, (B, T))
    u = torch.as_tensor(u).to(device=dev, dtype=torch.float32)
    if tuple(u.shape) != (B, T):
        raise ValueError(f"u shape {tuple(u.shape)} must be {(B, T)}")
    z0 = torch.log(u) - torch.log1p(-u)  # Logistic(0, 1)

    z = z0
    m = torch.zeros((B, T), dtype=torch.float32, device=dev)
    log_s_tot = torch.zeros((B, T), dtype=torch.float32, device=dev)
    for fp in params["flows"]:
        mu, log_s = flow_transform(fp, scfg, z, cond, global_cond)
        s = torch.exp(log_s)
        z = z * s + mu
        m = m * s + mu
        log_s_tot = log_s_tot + log_s
    log_q = torch.sum(_logistic_logpdf(z0) - log_s_tot, dim=1)
    return StudentSample(x=z, m=m, log_s=log_s_tot, z0=z0, log_q=log_q)


@torch.no_grad()
def student_generate(params: StudentParams, scfg: IAFConfig,
                     generator: torch.Generator | None, num_samples: int,
                     num_streams: int = 1, cond: torch.Tensor | None = None,
                     global_cond: torch.Tensor | None = None,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """The serving entry: ``(num_streams, num_samples)`` f32 audio in [-1,
    1] from one parallel pass on ``device``: no autoregression, no rings.
    ``cond`` ``(num_streams, num_samples, M)`` rows."""
    dev = resolve_device(device)
    params = params_to(params, dev)
    if cond is not None:
        cond = torch.as_tensor(cond).to(device=dev, dtype=torch.float32)
    if global_cond is not None:
        global_cond = torch.as_tensor(global_cond).to(device=dev,
                                                      dtype=torch.float32)
    out = student_sample(params, scfg, generator, (num_streams, num_samples),
                         cond=cond, global_cond=global_cond)
    return torch.clamp(out.x, -1.0, 1.0)


def student_parameter_count(params: StudentParams) -> int:
    return sum(int(x.numel()) for x in _flat(params))


def _flat(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _flat(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _flat(v)
    else:
        yield tree


def student_state_dict(params: StudentParams) -> dict:
    """The tree in flax's state-dict layout, ``{"flows": {"0": flow_0,
    ...}}``, sharing the tensors (no copies): the layout of checkpoints and
    of the optimizer's state."""
    return {"flows": {str(i): fp for i, fp in enumerate(params["flows"])}}


def student_from_state_dict(sd: dict) -> StudentParams:
    """Inverse of :func:`student_state_dict`."""
    flows = sd["flows"]
    if isinstance(flows, dict):
        flows = [flows[key] for key in sorted(flows, key=int)]
    return {"flows": tuple(flows)}


def _check_like(got, want, path="params"):
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"the snapshot's {path} does not have the "
                             "student's structure")
        for key in want:
            _check_like(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, tuple):
        if not isinstance(got, tuple) or len(got) != len(want):
            raise ValueError(f"the snapshot's {path} holds "
                             f"{len(got)} flows, expected {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            _check_like(a, b, f"{path}.{i}")
    elif tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"{path} shape {tuple(got.shape)} != "
                         f"{tuple(want.shape)}")


def load_student_snapshot(path: str, scfg: IAFConfig | None = None,
                          device: str | torch.device = "cuda"):
    """Read a student checkpoint written by either package's distillation
    CLI: ``(params, scfg, step)``. The architecture comes from the
    checkpoint's ``iaf_config`` extra, whose fields that are not None
    replace those of ``scfg`` (default :class:`IAFConfig`): the snapshot
    stores ``compute_dtype`` as None."""
    from ..utils.checkpoints import load_checkpoint

    blob = load_checkpoint(path, device)
    scfg = scfg or IAFConfig()
    saved = (blob.get("extra") or {}).get("iaf_config")
    if saved:
        names = {f.name for f in dataclasses.fields(scfg)}
        scfg = dataclasses.replace(
            scfg, **{k: v for k, v in saved.items()
                     if k in names and v is not None})
    params = student_from_state_dict(blob["params"])
    template = init_student(scfg, torch.Generator().manual_seed(0),
                            device="cpu")
    _check_like(params, template)
    return params, scfg, blob["step"]


def student_synthesize(params: StudentParams, scfg: IAFConfig,
                       generator: torch.Generator | None, mel,
                       hop_length: int, num_samples: int | None = None,
                       global_cond=None,
                       device: str | torch.device = "cuda") -> torch.Tensor:
    """Mel frames -> audio in one parallel pass: the Parallel-WaveNet
    vocoder. ``mel`` ``(S, F, cond_channels)`` (or 2-D for one stream)
    log-mel frames at ``hop_length`` samples are linearly upsampled
    (``ops.mel.upsample_frames``) to rows aligned with the output
    positions. ``num_samples`` defaults to ``F * hop_length``; rows past
    the last frame repeat it. Returns ``(S, num_samples)`` f32 in [-1,
    1]."""
    from ..ops.mel import upsample_frames

    if scfg.cond_channels == 0:
        raise ValueError("this student is unconditional "
                         "(scfg.cond_channels == 0)")
    dev = resolve_device(device)
    mel = torch.as_tensor(mel).to(device=dev, dtype=torch.float32)
    if mel.dim() == 2:
        mel = mel[None]
    S, Fr, M = mel.shape
    if M != scfg.cond_channels:
        raise ValueError(f"mel has {M} channels but scfg.cond_channels "
                         f"is {scfg.cond_channels}")
    if num_samples is None:
        num_samples = Fr * hop_length
    rows = upsample_frames(mel, hop_length, num_samples)
    return student_generate(params, scfg, generator, num_samples,
                            num_streams=S, cond=rows,
                            global_cond=global_cond, device=dev)
