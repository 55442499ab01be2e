"""The training trunk: CUDA kernels K2 (forward) and K3 (backward), their
plain PyTorch versions and the autograd Function around them.

The kernels (``csrc/trunk_fwd.cu``, ``csrc/trunk_bwd.cu``) replace the JAX
package's Pallas TPU kernels ``ops/pallas/trunk_kernel.py::fused_trunk``
(forward) and ``_trunk_bwd`` (its custom VJP). The function is the residual
trunk of an unconditioned WaveNet over one training window, ``h0 (N, T, R)``
with ``T = receptive_field + out_len - 1``: per layer l (dilation d, tap j
looking back ``m = (k-1-j)*d``, history before the window zero)

    z = sum_j h(t - m_j) @ w_in[l, j] + b_in[l]
    u = tanh(z[:D]) * sigmoid(z[D:])
    h <- h + u @ w_res[l] + b_res[l]

and the result is every layer's ``u`` over the output window, ``(N,
out_len, L*D)`` with layer-major columns: exactly what the skip projection
reads. The final residual stream is never needed.

Per-layer windows: layer l's gated unit reaches the output only on ``[s_l,
T)`` (the output window widened by every later layer's lookback), so both
kernels compute there only; the backward reads layer l's input stream on
``[sp_l, T)`` (``sp_l = max(0, s_l - (k-1)*d_l)``), and the forward saves it
there, in ``save_dtype``. The TPU kernel's 128-lane rounding of the windows,
its front pad and pair stacking are layout choices that do not change the
function, and have no counterpart here.

:func:`trunk_fwd_plain` and :func:`trunk_bwd_plain` compute the function
with PyTorch ops; the backward is written out (not autograd), recomputing
z, tanh and sigmoid from the saves the way K3 does, so K3 can be held
against it alone. :func:`trunk_fwd_cuda` and :func:`trunk_bwd_cuda` launch
the kernels; :func:`fused_trunk` runs the plain versions only for tensors
on the CPU and the kernels for CUDA tensors (which raise rather than fall
back). ``fwd_launches`` and ``bwd_launches`` count wrapper calls that
launched their kernels (K2 launches L CUDA kernels per call, one per layer;
K3 3L: per layer the gate gradients, the fixed-order reduction of the
weight gradients and the stream gradient).
"""

from __future__ import annotations

import ctypes

import torch

from ...config import WaveNetConfig

# wrapper calls that launched their kernels since the count was last set to
# 0 (the plain versions do not count)
fwd_launches = 0
bwd_launches = 0


def windows(cfg: WaveNetConfig, out_len: int) -> tuple[list[int], list[int]]:
    """``(s, sp)``: layer l computes its gated unit on ``[s[l], T)`` and the
    backward reads its input stream on ``[sp[l], T)``."""
    k, dil, L = cfg.kernel_size, cfg.dilations, cfg.num_layers
    T = cfg.receptive_field + out_len - 1
    s = [0] * L
    s[L - 1] = T - out_len
    for l in range(L - 1, 0, -1):
        s[l - 1] = max(0, s[l] - (k - 1) * dil[l])
    sp = [max(0, s[l] - (k - 1) * dil[l]) for l in range(L)]
    return s, sp


def _taps(h: torch.Tensor, cfg: WaveNetConfig, d: int) -> torch.Tensor:
    """``(N, W, k*R)``: row t holds ``[h(t - m_0), ..., h(t - m_{k-1})]``
    (tap j looks back ``(k-1-j)*d``, zero before the window), the row order
    of ``w_in[l]`` flattened to ``(k*R, 2D)``."""
    k, T = cfg.kernel_size, h.shape[1]
    parts = []
    for j in range(k):
        m = (k - 1 - j) * d
        parts.append(torch.nn.functional.pad(h, (0, 0, m, 0))[:, :T] if m
                     else h)
    return torch.cat(parts, dim=-1)


def _layer_weights(params, cfg: WaveNetConfig, l: int):
    lp = params["layers"]
    k, R, D = cfg.kernel_size, cfg.residual_channels, cfg.dilation_channels
    w = lp["w_in"][l].reshape(k * R, 2 * D)
    b_in = lp["b_in"][l] if "b_in" in lp else None
    b_res = lp["b_res"][l] if "b_res" in lp else None
    return w, lp["w_res"][l], b_in, b_res


# ----------------------------------------------------------- plain versions


@torch.no_grad()
def trunk_fwd_plain(params, cfg: WaveNetConfig, h0: torch.Tensor,
                    out_len: int, save_dtype=torch.bfloat16):
    """K2's function: ``(u (N, out_len, L*D) f32, saves (L, N, T, R)
    save_dtype)``. Every layer runs over the whole window (positions
    outside ``[s_l, T)`` never reach ``u``); ``saves[l]`` is layer l's
    input stream."""
    N, T, R = h0.shape
    L, D = cfg.num_layers, cfg.dilation_channels
    h = h0.to(torch.float32)
    saves = torch.empty((L, N, T, R), dtype=save_dtype, device=h0.device)
    u_out = torch.empty((N, out_len, L * D), dtype=torch.float32,
                        device=h0.device)
    for l, d in enumerate(cfg.dilations):
        saves[l] = h
        w, w_res, b_in, b_res = _layer_weights(params, cfg, l)
        z = _taps(h, cfg, d) @ w
        if b_in is not None:
            z = z + b_in
        u = torch.tanh(z[..., :D]) * torch.sigmoid(z[..., D:])
        u_out[:, :, l * D:(l + 1) * D] = u[:, T - out_len:]
        if l + 1 < L:
            r = u @ w_res
            if b_res is not None:
                r = r + b_res
            h = h + r
    return u_out, saves


@torch.no_grad()
def trunk_bwd_plain(params, cfg: WaveNetConfig, saves: torch.Tensor,
                    du: torch.Tensor, out_len: int):
    """K3's function, written out: the reverse layer walk over the saves
    and the units' cotangent ``du (N, out_len, L*D)``. Returns ``(dh0 (N, T,
    R), dw_in (L, k, R, 2D), dw_res (L, D, R), db_in (L, 2D), db_res (L,
    R))``, all f32. Layer l recomputes z, tanh and sigmoid from
    ``saves[l]`` on ``[s_l, T)``; its stream gradient goes back to ``[sp_l,
    T)`` (the whole window for layer 0)."""
    L, N, T, R = saves.shape
    k, D = cfg.kernel_size, cfg.dilation_channels
    dev = saves.device
    s, _ = windows(cfg, out_len)
    f32 = torch.float32
    dw_in = torch.zeros((L, k * R, 2 * D), dtype=f32, device=dev)
    dw_res = torch.zeros((L, D, R), dtype=f32, device=dev)
    db_in = torch.zeros((L, 2 * D), dtype=f32, device=dev)
    db_res = torch.zeros((L, R), dtype=f32, device=dev)
    dh_next = torch.zeros((N, T, R), dtype=f32, device=dev)
    o = T - out_len
    for l in range(L - 1, -1, -1):
        d, sl = cfg.dilations[l], s[l]
        w, w_res, b_in, _ = _layer_weights(params, cfg, l)
        v = _taps(saves[l].to(f32), cfg, d)[:, sl:]       # (N, W, k*R)
        z = v @ w
        if b_in is not None:
            z = z + b_in
        a = torch.tanh(z[..., :D])
        sg = torch.sigmoid(z[..., D:])
        dhn = dh_next[:, sl:]
        g = dhn @ w_res.T                                  # (N, W, D)
        g[:, o - sl:] += du[:, :, l * D:(l + 1) * D]
        dz = torch.cat([g * sg * (1.0 - a * a), g * a * (sg * (1.0 - sg))],
                       dim=-1)                             # (N, W, 2D)
        dw_in[l] = torch.einsum("ntk,ntc->kc", v, dz)
        dw_res[l] = torch.einsum("ntd,ntr->dr", a * sg, dhn)
        db_in[l] = dz.sum(dim=(0, 1))
        db_res[l] = dhn.sum(dim=(0, 1))
        dv = dz @ w.T                                      # (N, W, k*R)
        dh = torch.zeros_like(dh_next)
        dh[:, sl:] = dhn + dv[..., (k - 1) * R:]
        for j in range(k - 1):
            m = (k - 1 - j) * d
            lo = max(sl - m, 0)  # taps landing before the window drop
            dh[:, lo:T - m] += dv[:, lo + m - sl:, j * R:(j + 1) * R]
        dh_next = dh
    return (dh_next, dw_in.reshape(L, k, R, 2 * D), dw_res, db_in, db_res)


# ------------------------------------------------------------------ kernels

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_INTS = ctypes.POINTER(ctypes.c_int)


def _bind(name: str):
    from .build import load

    lib = load(name)
    if name == "trunk_fwd":
        fn = lib.wavenet_trunk_fwd
        if fn.argtypes is None:
            fn.argtypes = [_PTR] * 9 + [_INT] * 7 + [_INTS] * 3 + [_INT, _PTR]
            fn.restype = _INT
    else:
        fn = lib.wavenet_trunk_bwd
        if fn.argtypes is None:
            fn.argtypes = ([_PTR] * 13 + [_INT] * 7 + [_INTS] * 3
                           + [_INT, _PTR])
            fn.restype = _INT
            lib.wavenet_trunk_bwd_scratch.argtypes = [_INT] * 5
            lib.wavenet_trunk_bwd_scratch.restype = ctypes.c_longlong
    return lib


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _check_config(cfg: WaveNetConfig) -> None:
    if cfg.kernel_size < 2:
        raise ValueError("the trunk kernels need kernel_size >= 2")
    if cfg.stream_dtype != torch.float32:
        raise ValueError("the trunk kernels take f32 streams only "
                         f"(stream_dtype {cfg.stream_dtype})")
    if cfg.cond_channels or cfg.gcond_channels:
        raise ValueError("the trunk kernels take unconditioned models only")


def _weights(params, cfg: WaveNetConfig, dev: torch.device) -> dict:
    """The kernels' weight operands: contiguous f32 on ``dev`` in the
    params' own layout, zero biases where the model has none."""
    L, k = cfg.num_layers, cfg.kernel_size
    R, D = cfg.residual_channels, cfg.dilation_channels
    lp = params["layers"]
    shapes = {"w_in": (L, k, R, 2 * D), "w_res": (L, D, R),
              "b_in": (L, 2 * D), "b_res": (L, R)}
    out = {}
    for name, shape in shapes.items():
        x = lp.get(name)
        if x is None and name.startswith("b_"):
            x = torch.zeros(shape, dtype=torch.float32, device=dev)
        if tuple(x.shape) != shape:
            raise ValueError(f"layers.{name} must have shape {shape}, not "
                             f"{tuple(x.shape)}")
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"layers.{name} must be f32 on {dev}")
        out[name] = x.detach().contiguous()
    return out


def _check_stream(name, x, shape, dtypes, dev):
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, not "
                         f"{tuple(x.shape)}")
    if x.device != dev:
        raise ValueError(f"{name} must be on {dev}, not {x.device}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name} must be {dtypes}, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def trunk_fwd_cuda(params, cfg: WaveNetConfig, h0: torch.Tensor,
                   out_len: int, save_dtype=torch.bfloat16):
    """Launch K2 on the current stream with the contract of
    :func:`trunk_fwd_plain` (saves valid on ``[sp_l, T)`` only). Raises on
    operands the kernel does not take and if the launch fails."""
    global fwd_launches
    _check_config(cfg)
    dev = h0.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {dev}")
    if save_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"save_dtype must be f32 or bf16, not {save_dtype}")
    L, R, D = cfg.num_layers, cfg.residual_channels, cfg.dilation_channels
    T = cfg.receptive_field + out_len - 1
    if h0.dim() != 3 or h0.shape[0] < 1 or out_len < 1:
        raise ValueError("h0 must be (N, T, R) with N >= 1, out_len >= 1")
    N = h0.shape[0]
    _check_stream("h0", h0, (N, T, R), (torch.float32,), dev)
    w = _weights(params, cfg, dev)
    s, sp = windows(cfg, out_len)
    u = torch.empty((N, out_len, L * D), dtype=torch.float32, device=dev)
    saves = torch.empty((L, N, T, R), dtype=save_dtype, device=dev)
    bf16 = save_dtype == torch.bfloat16
    # f32 saves are the layer walk's stream itself; bf16 saves need an f32
    # ping-pong pair beside them
    bufs = (torch.empty((2, N, T, R), dtype=torch.float32, device=dev)
            if bf16 else saves)
    err = _bind("trunk_fwd").wavenet_trunk_fwd(
        h0.data_ptr(), w["w_in"].data_ptr(), w["w_res"].data_ptr(),
        w["b_in"].data_ptr(), w["b_res"].data_ptr(), bufs[0].data_ptr(),
        bufs[min(1, bufs.shape[0] - 1)].data_ptr(), saves.data_ptr(),
        u.data_ptr(), N, T, out_len, L, cfg.kernel_size, R, D,
        _ints(cfg.dilations), _ints(s), _ints(sp), int(bf16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"trunk_fwd launch failed: error {err}")
    fwd_launches += 1
    return u, saves


def trunk_bwd_cuda(params, cfg: WaveNetConfig, saves: torch.Tensor,
                   du: torch.Tensor, out_len: int):
    """Launch K3 on the current stream with the contract of
    :func:`trunk_bwd_plain`. The weight gradients are reduced over the
    batch and time in a fixed order, with no atomics: two calls on the
    same inputs give bitwise-equal results."""
    global bwd_launches
    _check_config(cfg)
    dev = saves.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {dev}")
    L, k = cfg.num_layers, cfg.kernel_size
    R, D = cfg.residual_channels, cfg.dilation_channels
    T = cfg.receptive_field + out_len - 1
    if saves.dim() != 4 or saves.shape[1] < 1 or out_len < 1:
        raise ValueError("saves must be (L, N, T, R) with N >= 1")
    N = saves.shape[1]
    _check_stream("saves", saves, (L, N, T, R),
                  (torch.float32, torch.bfloat16), dev)
    _check_stream("du", du, (N, out_len, L * D), (torch.float32,), dev)
    w = _weights(params, cfg, dev)
    s, sp = windows(cfg, out_len)
    f32 = dict(dtype=torch.float32, device=dev)
    lib = _bind("trunk_bwd")
    dz = torch.empty((N, T, 2 * D), **f32)
    dh = torch.empty((2, N, T, R), **f32)
    partial = torch.empty(
        (lib.wavenet_trunk_bwd_scratch(N, T, k, R, D),), **f32)
    dw_in = torch.empty((L, k, R, 2 * D), **f32)
    dw_res = torch.empty((L, D, R), **f32)
    db_in = torch.empty((L, 2 * D), **f32)
    db_res = torch.empty((L, R), **f32)
    err = lib.wavenet_trunk_bwd(
        saves.data_ptr(), du.data_ptr(), w["w_in"].data_ptr(),
        w["w_res"].data_ptr(), w["b_in"].data_ptr(), dz.data_ptr(),
        dh[0].data_ptr(), dh[1].data_ptr(), partial.data_ptr(),
        dw_in.data_ptr(), dw_res.data_ptr(), db_in.data_ptr(),
        db_res.data_ptr(), N, T, out_len, L, k, R, D,
        _ints(cfg.dilations), _ints(s), _ints(sp),
        int(saves.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"trunk_bwd launch failed: error {err}")
    bwd_launches += 1
    return dh[0], dw_in, dw_res, db_in, db_res


def run_fwd(params, cfg, h0, out_len, save_dtype):
    """The plain version for tensors on the CPU, K2 for CUDA tensors."""
    if h0.device.type == "cpu":
        return trunk_fwd_plain(params, cfg, h0, out_len, save_dtype)
    return trunk_fwd_cuda(params, cfg, h0, out_len, save_dtype)


def run_bwd(params, cfg, saves, du, out_len):
    """The plain version for tensors on the CPU, K3 for CUDA tensors."""
    if saves.device.type == "cpu":
        return trunk_bwd_plain(params, cfg, saves, du, out_len)
    return trunk_bwd_cuda(params, cfg, saves, du, out_len)


# ----------------------------------------------------------------- wrapper


class FusedTrunk(torch.autograd.Function):
    """``u = trunk(h0, w_in, w_res, b_in, b_res)`` with K3 (or its plain
    version) as the backward. ``b_in``/``b_res`` may be None (a model
    without biases)."""

    @staticmethod
    def forward(ctx, h0, w_in, w_res, b_in, b_res, cfg, out_len, save_dtype):
        layers = {"w_in": w_in.detach(), "w_res": w_res.detach()}
        if b_in is not None:
            layers["b_in"] = b_in.detach()
        if b_res is not None:
            layers["b_res"] = b_res.detach()
        u, saves = run_fwd({"layers": layers}, cfg, h0.detach(), out_len,
                           save_dtype)
        ctx.save_for_backward(saves)
        ctx.layers, ctx.cfg, ctx.out_len = layers, cfg, out_len
        ctx.has_bias = (b_in is not None, b_res is not None)
        return u

    @staticmethod
    def backward(ctx, du):
        (saves,) = ctx.saved_tensors
        dh0, dw_in, dw_res, db_in, db_res = run_bwd(
            {"layers": ctx.layers}, ctx.cfg, saves,
            du.to(torch.float32).contiguous(), ctx.out_len)
        return (dh0, dw_in, dw_res, db_in if ctx.has_bias[0] else None,
                db_res if ctx.has_bias[1] else None, None, None, None)


def fused_trunk(params, cfg: WaveNetConfig, h0: torch.Tensor, out_len: int,
                *, cond=None, save_dtype=torch.bfloat16,
                out_dtype=torch.float32, raw: bool = False) -> torch.Tensor:
    """The residual trunk through K2/K3 (CUDA tensors) or their plain
    versions (CPU tensors), differentiable in ``params['layers']`` and
    ``h0``. The contract of the JAX package's ``fused_trunk`` for
    unconditioned models with an f32 stream.

    ``h0``: the embedded input stream ``(N, T, R)``, ``T = receptive_field +
    out_len - 1``. Returns every layer's gated units over the output window,
    ``(N, out_len, L*D)`` in ``out_dtype``; the kernel writes this layout
    itself, so ``raw=True`` only views it as ``(N, out_len, L, D)``.
    ``save_dtype``: the per-layer stream saves the backward reads (bf16
    default; f32 for tight gradient checks)."""
    if cond is not None:
        raise ValueError("local conditioning is not ported to the trunk "
                         "kernels yet")
    _check_config(cfg)
    N, T, R = h0.shape
    Texp = cfg.receptive_field + out_len - 1
    if T != Texp:
        raise ValueError(
            f"h0 length {T} != receptive_field + out_len - 1 = {Texp}")
    lp = params["layers"]
    u = FusedTrunk.apply(h0.to(torch.float32).contiguous(), lp["w_in"],
                         lp["w_res"], lp.get("b_in"), lp.get("b_res"), cfg,
                         out_len, save_dtype)
    u = u.to(out_dtype)
    if raw:
        return u.view(N, out_len, cfg.num_layers, cfg.dilation_channels)
    return u
