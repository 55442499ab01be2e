"""Optimizers with optax's arithmetic: the JAX package's
``training/optimizers.py`` in PyTorch.

Every optimizer here is a transform with one small interface, which the
trainer calls:

* ``init(params)`` -> a state (nested dicts of tensors and ints);
* ``step(params, grads, state, mesh=None)`` updates ``params`` and the
  state in place (the JAX package returns new ones) and returns the state.
  Under a model-parallel ``mesh`` (``parallel.mesh``) the params and grads
  are this rank's blocks, and a norm (the global-norm clip,
  ``sgd_normalized``'s per-leaf norm) is the logical leaf's: a sharded
  leaf's squares are summed over the ``model`` group, a replicated leaf's
  counted once, so every mesh takes the step one rank takes;
* ``state_dict(state)`` -> the state in optax's state-dict layout (what
  ``flax.serialization.to_state_dict`` gives for the JAX optimizer), numpy
  leaves; ``load_state_dict(blob, params)`` takes it back, tensors on the
  params' devices. So either package resumes from the other's checkpoint.

The transforms:

* :func:`reference_adam`: optional global-norm clip, then L2 weight decay
  folded into the gradient, then Adam (``b1 = 0.9, b2 = 0.999, eps =
  1e-8``, ``eps`` added to ``sqrt(nu_hat)`` after the bias correction, as
  optax does; ``torch.optim.Adam`` has placed it differently across
  versions, so it is not used), then the learning rate: a float or an
  :class:`LRSchedule` from :func:`lr_schedule`. Layout: the chain's entries
  under ``"0"``, ``"1"``, ...; clip and decay ``{}``, Adam ``{"count",
  "mu", "nu"}``, the learning rate ``{}`` (a float) or ``{"count"}`` (a
  schedule, read at the count before the step: with a warmup the first
  update is zero).
* :func:`sgd_normalized`: the reference's ``SGDNormalized``, the step
  ``lr * g / ||g||`` per tensor, then decay, momentum (zero-initialised, as
  the JAX package does) and Nesterov. Layout ``{"momentum": tree}``, or
  ``{"momentum": None}`` without momentum.
* :func:`with_ema`: an exponential moving average of the params after each
  applied update, ``{"inner": ..., "ema": tree}``; :func:`ema_params` and
  :func:`find_ema_state_dict` pull it out.
* :class:`MultiSteps`: gradient accumulation over ``k`` micro-steps
  (optax's running mean ``acc + (g - acc) / (n + 1)``); the inner step runs
  once every ``k`` calls with the mean, which then restarts at zero; the
  params do not move in between. Layout ``{"mini_step", "gradient_step",
  "inner_opt_state", "acc_grads", "skip_state": {}}``. An EMA goes inside
  it, so the average moves once per applied update.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.mesh import MODEL_AXIS, all_reduce, axis_size
from ..parallel.sharding import model_sharded

f32 = np.float32


def _leaves(tree, prefix=()):
    """``(path, tensor)`` pairs in sorted-key order (the order in which JAX
    flattens a dict)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def _map(fn, tree):
    """The tree with ``fn`` applied to each leaf, leaves visited in the
    order of :func:`_leaves`."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def _zeros(params):
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _to_np(tree):
    """Host copies (never views of a live CPU tensor)."""
    return _map(lambda x: x.detach().to("cpu", copy=True).numpy(), tree)


def _take(tree, like, what="state"):
    """Nested numpy ``tree`` -> f32 tensors shaped and placed as ``like``."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"the checkpoint's {what} does not have the "
                             "params' structure")
        return {k: _take(tree[k], v, what) for k, v in like.items()}
    t = torch.from_numpy(np.array(tree, np.float32, copy=True))
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"{what} shape {tuple(t.shape)} does not match the "
                         f"param {tuple(like.shape)}")
    return t.to(like.device)


def _sq_sum(pairs, mesh) -> torch.Tensor:
    """The sum of squares of the logical leaves of ``(path, tensor)``
    ``pairs``: on one rank (or ``model = 1``) the plain sum; under a
    model-parallel mesh the sharded leaves' local sums are added over the
    ``model`` group (one collective), the replicated ones counted once."""
    if axis_size(mesh, MODEL_AXIS) == 1:
        return sum(torch.sum(x * x) for _, x in pairs)
    rep = sum(torch.sum(x * x) for p, x in pairs if not model_sharded(p))
    sh = sum(torch.sum(x * x) for p, x in pairs if model_sharded(p))
    return rep + all_reduce(sh, mesh, MODEL_AXIS)


def _leaf_sq(path, x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of squares of one logical leaf (its blocks' sums added
    over ``model`` when it is sharded)."""
    sq = torch.sum(x.to(torch.float32) ** 2)
    if model_sharded(path):
        sq = all_reduce(sq, mesh, MODEL_AXIS)
    return sq


def _count(x) -> np.ndarray:
    return np.asarray(x, np.int32)


def _keys(blob, want: set, what: str):
    if not isinstance(blob, dict) or set(blob) != want:
        got = sorted(blob) if isinstance(blob, dict) else type(blob).__name__
        raise ValueError(f"the checkpoint's opt_state is not this optimizer's "
                         f"chain: {what} expects {sorted(want)}, found {got}")


# ------------------------------------------------------------- schedules


def _f32_of(fn, *args) -> np.float32:
    """``fn`` of f32 arguments, computed in f64 and rounded once: this
    gives XLA's f32 ``cos`` and ``pow`` on the CPU bit for bit at the
    schedules' arguments, where numpy's f32 versions are off by an ulp."""
    return f32(fn(*(np.float64(a) for a in args)))


class LRSchedule:
    """A learning rate as a function of the update count, each value in
    float32 in optax's order of operations (``cosine_decay_schedule``,
    ``exponential_decay``, ``linear_schedule`` and ``join_schedules``)."""

    def __init__(self, lr: float, kind: str, warmup_steps: int = 0,
                 decay_steps: int | None = None, min_lr_ratio: float = 0.0):
        self.lr = float(lr)
        self.kind = kind
        self.warmup_steps = int(warmup_steps)
        self.decay_steps = decay_steps
        self.min_lr_ratio = float(min_lr_ratio)

    def _main(self, count: int) -> np.float32:
        lr, T = self.lr, self.decay_steps
        if self.kind == "constant":
            return f32(lr)
        if self.kind == "cosine":
            c = np.minimum(f32(count), f32(T))
            cosine = f32(0.5) * (f32(1) + _f32_of(
                np.cos, f32(math.pi) * c / f32(T)))
            alpha = self.min_lr_ratio
            return f32(lr) * (f32(1 - alpha) * cosine + f32(alpha))
        # exponential: lr * rate ** (count / T)
        if count <= 0:
            return f32(lr)
        p = f32(count) / f32(T)
        return f32(lr) * _f32_of(np.power, f32(self.min_lr_ratio), p)

    def __call__(self, count: int) -> np.float32:
        count = int(count)
        w = self.warmup_steps
        if not w:
            return f32(self._main(count))
        if count < w:  # linear 0 -> lr over the warmup
            frac = f32(1) - f32(min(max(count, 0), w)) / f32(w)
            return f32(-self.lr) * frac + f32(self.lr)
        return f32(self._main(count - w))


def lr_schedule(lr: float, kind: str = "constant", warmup_steps: int = 0,
                decay_steps: int | None = None, min_lr_ratio: float = 0.0):
    """The JAX package's ``lr_schedule``: ``constant``, ``cosine`` (to ``lr
    * min_lr_ratio`` over ``decay_steps``) or ``exponential`` (``lr *
    min_lr_ratio ** (step / decay_steps)``), after a linear 0 -> lr warmup
    of ``warmup_steps``. A constant without warmup is returned as the plain
    float (so the optimizer state stays schedule-free)."""
    if kind == "constant":
        if not warmup_steps:
            return lr
    elif kind == "cosine":
        if not decay_steps:
            raise ValueError("cosine schedule needs decay_steps")
    elif kind == "exponential":
        if not decay_steps:
            raise ValueError("exponential schedule needs decay_steps")
        if not 0.0 < min_lr_ratio < 1.0:
            raise ValueError("exponential schedule needs min_lr_ratio "
                             "in (0, 1) — the decay per decay_steps")
    else:
        raise ValueError(f"unknown schedule kind {kind!r}")
    return LRSchedule(lr, kind, warmup_steps, decay_steps, min_lr_ratio)


# ------------------------------------------------------------------ Adam


class ReferenceAdam:
    """Clip, decay, Adam and the learning rate (a float or a schedule).

    ``init(params)`` returns ``{"count": int, "mu": tree, "nu": tree}``
    (plus ``"lr_count"`` with a schedule: optax keeps the schedule's count
    apart from Adam's)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr, weight_decay: float = 0.0,
                 gradient_clipping: float | None = None):
        self.lr = lr if isinstance(lr, LRSchedule) else float(lr)
        self.weight_decay = float(weight_decay)
        self.gradient_clipping = gradient_clipping

    @property
    def scheduled(self) -> bool:
        return isinstance(self.lr, LRSchedule)

    def init(self, params) -> dict:
        state = {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}
        if self.scheduled:
            state["lr_count"] = 0
        return state

    @torch.no_grad()
    def step(self, params, grads, state: dict, mesh=None) -> dict:
        p = [x for _, x in _leaves(params)]
        paths = [path for path, _ in _leaves(grads)]
        g = [x.to(torch.float32) for _, x in _leaves(grads)]
        mu = [x for _, x in _leaves(state["mu"])]
        nu = [x for _, x in _leaves(state["nu"])]
        if self.gradient_clipping is not None:
            norm = torch.sqrt(_sq_sum(list(zip(paths, g)), mesh))
            clip = float(self.gradient_clipping)
            keep = norm < clip
            g = [torch.where(keep, x, (x / norm) * clip) for x in g]
        if self.weight_decay != 0.0:
            g = [x + self.weight_decay * w for x, w in zip(g, p)]
        count = state["count"] + 1
        # the bias corrections in f32, as optax computes them
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        if self.scheduled:
            lr = float(self.lr(state["lr_count"]))
            state["lr_count"] += 1
        else:
            lr = self.lr
        for w, x, m, v in zip(p, g, mu, nu):
            m.copy_((1.0 - self.b1) * x + self.b1 * m)
            v.copy_((1.0 - self.b2) * (x * x) + self.b2 * v)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            w.add_(-lr * upd)
        state["count"] = count
        return state

    def _adam_index(self) -> int:
        return int(self.gradient_clipping is not None) + int(
            self.weight_decay != 0.0)

    def state_dict(self, state: dict) -> dict:
        i = self._adam_index()
        out = {str(j): {} for j in range(i + 2)}
        out[str(i)] = {"count": _count(state["count"]),
                       "mu": _to_np(state["mu"]), "nu": _to_np(state["nu"])}
        if self.scheduled:
            out[str(i + 1)] = {"count": _count(state["lr_count"])}
        return out

    def load_state_dict(self, blob: dict, params) -> dict:
        i = self._adam_index()
        _keys(blob, {str(j) for j in range(i + 2)},
              "clip/decay/Adam/learning rate (clip or decay settings differ?)")
        for j in range(i):
            _keys(blob[str(j)], set(), "clip/decay")
        _keys(blob[str(i)], {"count", "mu", "nu"}, "Adam")
        _keys(blob[str(i + 1)], {"count"} if self.scheduled else set(),
              "the learning rate (a schedule against a constant?)")
        adam = blob[str(i)]
        state = {"count": int(np.asarray(adam["count"])),
                 "mu": _take(adam["mu"], params, "Adam's mu"),
                 "nu": _take(adam["nu"], params, "Adam's nu")}
        if self.scheduled:
            state["lr_count"] = int(np.asarray(blob[str(i + 1)]["count"]))
        return state


def reference_adam(lr, weight_decay: float = 0.0,
                   gradient_clipping: float | None = None) -> ReferenceAdam:
    """The reference trainer's default optimizer (see :class:`ReferenceAdam`);
    ``lr`` a float or a schedule from :func:`lr_schedule`."""
    return ReferenceAdam(lr, weight_decay, gradient_clipping)


# ---------------------------------------------------------- SGDNormalized


class SGDNormalized:
    """The reference's ``SGDNormalized``: ``d = lr * g / max(||g||, 1e-12)``
    per tensor, ``+ weight_decay * p``, then momentum ``buf = momentum * buf
    + (1 - dampening) * d`` from a zero buffer (Nesterov: ``d + momentum *
    buf``), ``p -= d``. State ``{"momentum": tree or None}``."""

    def __init__(self, lr: float = 1e-4, momentum: float = 0.0,
                 dampening: float = 0.0, weight_decay: float = 0.0,
                 nesterov: bool = False):
        if nesterov and (momentum <= 0 or dampening != 0):
            raise ValueError("Nesterov momentum requires a momentum and zero "
                             "dampening")
        if isinstance(lr, LRSchedule):
            raise ValueError("sgd_normalized takes a constant learning rate")
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.dampening = float(dampening)
        self.weight_decay = float(weight_decay)
        self.nesterov = nesterov

    def init(self, params) -> dict:
        return {"momentum": _zeros(params) if self.momentum != 0 else None}

    @torch.no_grad()
    def step(self, params, grads, state: dict, mesh=None) -> dict:
        p = [x for _, x in _leaves(params)]
        g = list(_leaves(grads))
        bufs = ([x for _, x in _leaves(state["momentum"])]
                if self.momentum != 0 else [None] * len(p))
        for w, (path, x), buf in zip(p, g, bufs):
            n = torch.sqrt(_leaf_sq(path, x, mesh))
            d = (self.lr / torch.clamp(n, min=1e-12)) * x
            if self.weight_decay != 0:
                d = d + self.weight_decay * w
            if buf is not None:
                buf.copy_(self.momentum * buf + (1 - self.dampening) * d)
                d = d + self.momentum * buf if self.nesterov else buf
            w.sub_(d)
        return state

    def state_dict(self, state: dict) -> dict:
        m = state["momentum"]
        return {"momentum": None if m is None else _to_np(m)}

    def load_state_dict(self, blob: dict, params) -> dict:
        _keys(blob, {"momentum"}, "sgd_normalized")
        m = blob["momentum"]
        if (m is None) != (self.momentum == 0):
            raise ValueError("the checkpoint's sgd_normalized momentum buffer "
                             "does not match --momentum (zero against "
                             "nonzero)")
        return {"momentum": None if m is None
                else _take(m, params, "the momentum")}


def sgd_normalized(lr: float = 1e-4, momentum: float = 0.0,
                   dampening: float = 0.0, weight_decay: float = 0.0,
                   nesterov: bool = False) -> SGDNormalized:
    return SGDNormalized(lr, momentum, dampening, weight_decay, nesterov)


# -------------------------------------------------------------------- EMA


class WithEma:
    """``inner``, then ``ema = decay * ema + (1 - decay) * params`` on the
    updated params. State ``{"inner": ..., "ema": tree}``."""

    def __init__(self, inner, decay: float = 0.9999):
        self.inner = inner
        self.decay = float(decay)

    def init(self, params) -> dict:
        return {"inner": self.inner.init(params),
                "ema": _map(lambda p: p.detach().to(torch.float32).clone(),
                            params)}

    @torch.no_grad()
    def step(self, params, grads, state: dict, mesh=None) -> dict:
        self.inner.step(params, grads, state["inner"], mesh)
        d = self.decay
        for (_, e), (_, p) in zip(_leaves(state["ema"]), _leaves(params)):
            e.copy_(d * e + (1.0 - d) * p)
        return state

    def state_dict(self, state: dict) -> dict:
        return {"inner": self.inner.state_dict(state["inner"]),
                "ema": _to_np(state["ema"])}

    def load_state_dict(self, blob: dict, params) -> dict:
        _keys(blob, {"inner", "ema"}, "with_ema")
        return {"inner": self.inner.load_state_dict(blob["inner"], params),
                "ema": _take(blob["ema"], params, "the EMA")}


def with_ema(tx, decay: float = 0.9999) -> WithEma:
    """Track an exponential moving average of the params beside ``tx``."""
    return WithEma(tx, decay)


def find_ema_state_dict(opt_state_dict):
    """The EMA tree in an optimizer state (a live one of this module, or a
    checkpoint's ``opt_state`` from either package: the same nesting), at
    any depth; None if there is none."""
    if isinstance(opt_state_dict, dict):
        if "ema" in opt_state_dict and "inner" in opt_state_dict:
            return opt_state_dict["ema"]
        for v in opt_state_dict.values():
            got = find_ema_state_dict(v)
            if got is not None:
                return got
    return None


def ema_params(opt_state):
    """The EMA params of a live state built with :func:`with_ema` (at any
    wrapping depth); None if absent."""
    return find_ema_state_dict(opt_state)


# -------------------------------------------------------------- MultiSteps


class MultiSteps:
    """optax's ``MultiSteps(inner, every_k_schedule=k)`` with the mean of
    the micro-steps' gradients (``use_grad_mean``)."""

    def __init__(self, inner, every_k_schedule: int):
        if int(every_k_schedule) < 1:
            raise ValueError("every_k_schedule must be at least 1")
        self.inner = inner
        self.k = int(every_k_schedule)

    def init(self, params) -> dict:
        return {"mini_step": 0, "gradient_step": 0,
                "inner_opt_state": self.inner.init(params),
                "acc_grads": _zeros(params), "skip_state": {}}

    @torch.no_grad()
    def step(self, params, grads, state: dict, mesh=None) -> dict:
        n = state["mini_step"]
        acc = [a for _, a in _leaves(state["acc_grads"])]
        for a, (_, g) in zip(acc, _leaves(grads)):
            a.copy_(a + (g - a) / (n + 1))
        if n == self.k - 1:
            self.inner.step(params, state["acc_grads"],
                            state["inner_opt_state"], mesh)
            state["gradient_step"] += 1
            for a in acc:
                a.zero_()
        state["mini_step"] = (n + 1) % self.k
        return state

    def state_dict(self, state: dict) -> dict:
        return {"mini_step": _count(state["mini_step"]),
                "gradient_step": _count(state["gradient_step"]),
                "inner_opt_state": self.inner.state_dict(
                    state["inner_opt_state"]),
                "acc_grads": _to_np(state["acc_grads"]), "skip_state": {}}

    def load_state_dict(self, blob: dict, params) -> dict:
        _keys(blob, {"mini_step", "gradient_step", "inner_opt_state",
                     "acc_grads", "skip_state"}, "MultiSteps")
        return {"mini_step": int(np.asarray(blob["mini_step"])),
                "gradient_step": int(np.asarray(blob["gradient_step"])),
                "inner_opt_state": self.inner.load_state_dict(
                    blob["inner_opt_state"], params),
                "acc_grads": _take(blob["acc_grads"], params,
                                   "the accumulated gradients"),
                "skip_state": {}}


def build_optimizer(name: str = "adam", lr: float = 1e-4,
                    momentum: float = 0.0, weight_decay: float = 0.0,
                    clip: float | None = None, schedule: str = "constant",
                    warmup_steps: int = 0, decay_steps: int | None = None,
                    min_lr_ratio: float = 0.0, ema_decay: float | None = None,
                    accum_steps: int = 1):
    """The optimizer stack of the training CLI (the JAX script's order):
    Adam with the schedule or ``sgd_normalized`` (which refuses a
    schedule), wrapped in :func:`with_ema` with ``ema_decay``, wrapped in
    :class:`MultiSteps` with ``accum_steps > 1`` (so the EMA moves once per
    applied update)."""
    sched = lr_schedule(lr, schedule, warmup_steps, decay_steps, min_lr_ratio)
    if name == "sgd_normalized":
        if not isinstance(sched, float):
            raise ValueError("--lr-schedule/--warmup-steps only apply to "
                             "the adam optimizer")
        tx = sgd_normalized(lr=lr, momentum=momentum,
                            weight_decay=weight_decay)
    elif name == "adam":
        tx = reference_adam(sched, weight_decay, clip)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if ema_decay:
        tx = with_ema(tx, ema_decay)
    if accum_steps > 1:
        tx = MultiSteps(tx, accum_steps)
    return tx
