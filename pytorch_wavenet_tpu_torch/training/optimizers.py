"""The reference trainer's optimizer with optax's arithmetic.

:func:`reference_adam` is the JAX package's ``reference_adam`` (optional
global-norm clip, then L2 weight decay folded into the gradient, then Adam
with ``b1 = 0.9, b2 = 0.999, eps = 1e-8`` and the learning rate) written
out in PyTorch, step for step as optax computes it: ``eps`` is added to
``sqrt(nu_hat)`` after the bias correction (``torch.optim.Adam`` has placed
it differently across versions, so it is not used). The update runs in
place on the params' tensors.

The state maps to and from optax's state-dict layout, which is what a
checkpoint holds: the chain's entries under ``"0"``, ``"1"``, ...; the
clip and the decay are empty entries ``{}``, Adam's is ``{"count", "mu",
"nu"}`` and the learning rate's is ``{}``. So either package resumes from
the other's checkpoint. The JAX package's ``lr_schedule``,
``sgd_normalized``, ``with_ema`` and ``MultiSteps`` are not ported.
"""

from __future__ import annotations

import numpy as np
import torch


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


class ReferenceAdam:
    """Clip, decay and Adam with a constant learning rate.

    ``init(params)`` returns the state ``{"count": int, "mu": tree, "nu":
    tree}``; ``step(params, grads, state)`` updates ``params`` and the
    state's moments in place and returns the state."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, weight_decay: float = 0.0,
                 gradient_clipping: float | None = None):
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.gradient_clipping = gradient_clipping

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return {"count": 0, "mu": _map(zeros, params),
                "nu": _map(zeros, params)}

    @torch.no_grad()
    def step(self, params, grads, state: dict) -> dict:
        p = [x for _, x in _leaves(params)]
        g = [x.to(torch.float32) for _, x in _leaves(grads)]
        mu = [x for _, x in _leaves(state["mu"])]
        nu = [x for _, x in _leaves(state["nu"])]
        if self.gradient_clipping is not None:
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            clip = float(self.gradient_clipping)
            keep = norm < clip
            g = [torch.where(keep, x, (x / norm) * clip) for x in g]
        if self.weight_decay != 0.0:
            g = [x + self.weight_decay * w for x, w in zip(g, p)]
        count = state["count"] + 1
        # the bias corrections in f32, as optax computes them
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        for w, x, m, v in zip(p, g, mu, nu):
            m.copy_((1.0 - self.b1) * x + self.b1 * m)
            v.copy_((1.0 - self.b2) * (x * x) + self.b2 * v)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            w.add_(-self.lr * upd)
        state["count"] = count
        return state

    # ------------------------------------------------------- optax layout

    def _adam_index(self) -> int:
        return int(self.gradient_clipping is not None) + int(
            self.weight_decay != 0.0)

    def state_dict(self, state: dict) -> dict:
        """The state in optax's state-dict layout, numpy leaves."""
        to_np = lambda x: x.detach().cpu().numpy()
        out = {str(i): {} for i in range(self._adam_index() + 2)}
        out[str(self._adam_index())] = {
            "count": np.asarray(state["count"], np.int32),
            "mu": _map(to_np, state["mu"]), "nu": _map(to_np, state["nu"])}
        return out

    def load_state_dict(self, blob: dict, params) -> dict:
        """A state from optax's layout (as a checkpoint holds it), moments
        on the params' devices."""
        i = str(self._adam_index())
        if set(blob) != {str(j) for j in range(len(blob))} or i not in blob \
                or set(blob[i]) != {"count", "mu", "nu"}:
            raise ValueError("the checkpoint's opt_state is not this "
                             "optimizer's chain (clip/decay settings differ?)")
        adam = blob[i]

        def take(tree, like):
            if isinstance(like, dict):
                return {k: take(tree[k], v) for k, v in like.items()}
            t = torch.from_numpy(np.array(tree, np.float32, copy=True))
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"moment shape {tuple(t.shape)} does not "
                                 f"match the param {tuple(like.shape)}")
            return t.to(like.device)

        return {"count": int(np.asarray(adam["count"])),
                "mu": take(adam["mu"], params), "nu": take(adam["nu"], params)}


def reference_adam(lr: float, weight_decay: float = 0.0,
                   gradient_clipping: float | None = None) -> ReferenceAdam:
    """The reference trainer's default optimizer (see :class:`ReferenceAdam`)."""
    return ReferenceAdam(lr, weight_decay, gradient_clipping)
