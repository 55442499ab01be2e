"""The training trunk: CUDA kernels K2 (forward) and K3 (backward), their
plain PyTorch versions and the autograd Function around them.

The kernels (``csrc/trunk_fwd.cu``, ``csrc/trunk_bwd.cu``) replace the JAX
package's Pallas TPU kernels ``ops/pallas/trunk_kernel.py::fused_trunk``
(forward) and ``_trunk_bwd`` (its custom VJP). The function is the residual
trunk of a WaveNet over one training window, ``h0 (N, T, R)`` with ``T =
receptive_field + out_len - 1``, optionally with local conditioning ``cond
(N, T, M)`` (the vocoder's upsampled mel rows): per layer l (dilation d,
tap j looking back ``m = (k-1-j)*d``, history before the window zero)

    z = sum_j h(t - m_j) @ w_in[l, j] + b_in[l]  (+ cond[t] @ w_cond[l])
    u = tanh(z[:D]) * sigmoid(z[D:])
    h <- h + u @ w_res[l] + b_res[l]

``cfg.stream_dtype`` is f32 or bf16, as in the JAX kernel. With a bf16
stream the stream is stored in bf16 between layers (h0 rounded on entry,
each layer's update ``round((h + u @ w_res) + b_res)`` summed in f32 and
rounded once), and the kernel's matrix operands are the stream's type too:
w_in, w_res, w_cond and cond are rounded to bf16 (the biases stay f32),
every product sums in f32 and u stays f32. The backward of each rounding
is the identity. The saves are then the stream itself, so f32 saves of a
bf16 stream hold the same values as bf16 ones, and give bitwise the same
gradients.

and the result is every layer's ``u`` over the output window, ``(N,
out_len, L*D)`` with layer-major columns: exactly what the skip projection
reads. The final residual stream is never needed.

Per-layer windows: layer l's gated unit reaches the output only on ``[s_l,
T)`` (the output window widened by every later layer's lookback), so both
kernels compute there only; the backward reads layer l's input stream on
``[sp_l, T)`` (``sp_l = max(0, s_l - (k-1)*d_l)``), and the forward saves it
there, in ``save_dtype``. With cond the backward also gives ``dw_cond`` and
``dcond`` (the learnable upsampler trains through it), which is zero before
layer 0's window. The TPU kernel's 128-lane rounding of the windows,
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
K3 L + 2: one fused launch per layer, the gather of dh0 and the
fixed-order reduction of every layer's partial weight gradients).

Both kernels form their products on the tensor cores in 3xTF32 from the
tile core ``csrc/trunk_core.cuh``; the cond product is the tap product's
depth extended from ``k*Rp`` to ``k*Rp + Mp`` (cond staged beside the tap
rows, w_cond packed below w_in), compiled apart from the unconditioned
kernels. The Python below sets what the kernels read: the packed weights
(:func:`pack_weights`, widths padded to 16, the gate's halves interleaved),
the tile of positions a block takes and what
it keeps in shared memory (:func:`fwd_plan`, :func:`bwd_plan`), and K3's
partial slots (:func:`bwd_geometry`), which depend on the shapes alone.
"""

from __future__ import annotations

import ctypes
import functools

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


def bf16_stream(cfg: WaveNetConfig) -> bool:
    """Whether the stream (and the kernels' matrix operands) is bf16."""
    return cfg.stream_dtype == torch.bfloat16


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (to nearest, ties to even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _layer_weights(params, cfg: WaveNetConfig, l: int):
    """``(w_in (k*R, 2D), w_res, b_in, b_res)`` of layer l as the kernels
    read them: the matrices rounded to bf16 under a bf16 stream; a missing
    bias is None."""
    lp = params["layers"]
    k, R, D = cfg.kernel_size, cfg.residual_channels, cfg.dilation_channels
    w = lp["w_in"][l].reshape(k * R, 2 * D)
    w_res = lp["w_res"][l]
    if bf16_stream(cfg):
        w, w_res = round_bf16(w), round_bf16(w_res)
    b_in = lp["b_in"][l] if "b_in" in lp else None
    b_res = lp["b_res"][l] if "b_res" in lp else None
    return w, w_res, b_in, b_res


def _cond_weight(params, cfg: WaveNetConfig, l: int):
    """Layer l's w_cond (M, 2D) as the kernels read it (rounded to bf16
    under a bf16 stream)."""
    w = params["layers"]["w_cond"][l]
    return round_bf16(w) if bf16_stream(cfg) else w


# ----------------------------------------------------------- plain versions


def layer_fwd_plain(params, cfg: WaveNetConfig, l: int, h: torch.Tensor,
                    cond=None):
    """One layer of K2's function over the whole window: ``(u (N, T, D),
    h' (N, T, R))`` from the layer's input stream ``h`` (f32 holding the
    stream's values; ``cond`` already rounded under a bf16 stream). With an
    f32 stream ``h' = h + (u @ w_res + b_res)``; with a bf16 one ``h' =
    round((h + u @ w_res) + b_res)``, the JAX kernel's order."""
    T, D = h.shape[1], cfg.dilation_channels
    w, w_res, b_in, b_res = _layer_weights(params, cfg, l)
    z = _taps(h, cfg, cfg.dilations[l]) @ w
    if b_in is not None:
        z = z + b_in
    if cond is not None:
        z = z + cond @ _cond_weight(params, cfg, l)
    u = torch.tanh(z[..., :D]) * torch.sigmoid(z[..., D:])
    r = u @ w_res
    if bf16_stream(cfg):
        h = h + r
        if b_res is not None:
            h = h + b_res
        return u, round_bf16(h)
    if b_res is not None:
        r = r + b_res
    return u, h + r


@torch.no_grad()
def trunk_fwd_plain(params, cfg: WaveNetConfig, h0: torch.Tensor,
                    out_len: int, save_dtype=torch.bfloat16, cond=None):
    """K2's function: ``(u (N, out_len, L*D) f32, saves (L, N, T, R)
    save_dtype)``. Every layer runs over the whole window (positions
    outside ``[s_l, T)`` never reach ``u``); ``saves[l]`` is layer l's
    input stream. ``cond (N, T, M)`` adds ``cond @ w_cond[l]`` after the
    bias, the JAX kernel's order. Under a bf16 stream h0 and cond are
    rounded on entry (:func:`layer_fwd_plain`)."""
    N, T, R = h0.shape
    L, D = cfg.num_layers, cfg.dilation_channels
    h = h0.to(torch.float32)
    if bf16_stream(cfg):
        h = round_bf16(h)
        cond = None if cond is None else round_bf16(cond)
    saves = torch.empty((L, N, T, R), dtype=save_dtype, device=h0.device)
    u_out = torch.empty((N, out_len, L * D), dtype=torch.float32,
                        device=h0.device)
    for l in range(L):
        saves[l] = h
        u, h = layer_fwd_plain(params, cfg, l, h, cond)
        u_out[:, :, l * D:(l + 1) * D] = u[:, T - out_len:]
    return u_out, saves


@torch.no_grad()
def trunk_bwd_plain(params, cfg: WaveNetConfig, saves: torch.Tensor,
                    du: torch.Tensor, out_len: int, cond=None,
                    need_dcond: bool = True):
    """K3's function, written out: the reverse layer walk over the saves
    and the units' cotangent ``du (N, out_len, L*D)``. Returns ``(dh0 (N, T,
    R), dw_in (L, k, R, 2D), dw_res (L, D, R), db_in (L, 2D), db_res (L,
    R))``, all f32, and with ``cond (N, T, M)`` also ``dw_cond (L, M, 2D)``
    and ``dcond (N, T, M)`` (None unless ``need_dcond``). Layer l
    recomputes z, tanh and sigmoid from ``saves[l]`` on ``[s_l, T)``; its
    stream gradient goes back to ``[sp_l, T)`` (the whole window for layer
    0), its cond gradient to ``[s_l, T)``, summed from the top layer
    down. Under a bf16 stream the matrices and cond are rounded as in the
    forward."""
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
    if cond is not None:
        if bf16_stream(cfg):
            cond = round_bf16(cond)
        dw_cond = torch.zeros(params["layers"]["w_cond"].shape, dtype=f32,
                              device=dev)
        dcond = torch.zeros(cond.shape, dtype=f32, device=dev) \
            if need_dcond else None
    o = T - out_len
    for l in range(L - 1, -1, -1):
        d, sl = cfg.dilations[l], s[l]
        w, w_res, b_in, _ = _layer_weights(params, cfg, l)
        w_cond = _cond_weight(params, cfg, l) if cond is not None else None
        v = _taps(saves[l].to(f32), cfg, d)[:, sl:]       # (N, W, k*R)
        z = v @ w
        if b_in is not None:
            z = z + b_in
        if cond is not None:
            z = z + cond[:, sl:] @ w_cond
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
        if cond is not None:
            dw_cond[l] = torch.einsum("ntm,ntc->mc", cond[:, sl:], dz)
            if dcond is not None:
                dcond[:, sl:] += dz @ w_cond.T
        dv = dz @ w.T                                      # (N, W, k*R)
        dh = torch.zeros_like(dh_next)
        dh[:, sl:] = dhn + dv[..., (k - 1) * R:]
        for j in range(k - 1):
            m = (k - 1 - j) * d
            lo = max(sl - m, 0)  # taps landing before the window drop
            dh[:, lo:T - m] += dv[:, lo + m - sl:, j * R:(j + 1) * R]
        dh_next = dh
    out = (dh_next, dw_in.reshape(L, k, R, 2 * D), dw_res, db_in, db_res)
    return out + (dw_cond, dcond) if cond is not None else out


# ------------------------------------------------------ the kernels' layout

SMEM_LIMIT = 232_448  # bytes of shared memory a block can have on an H100
MAX_SLOTS = 256       # K3's partial slots per layer, at most


def _pad16(x: int) -> int:
    return -(-x // 16) * 16


def padded_widths(cfg: WaveNetConfig) -> tuple[int, int]:
    """``(Rp, Dp)``: R and D padded to whole m-tiles of 16 rows."""
    return _pad16(cfg.residual_channels), _pad16(cfg.dilation_channels)


def cond_width(M: int) -> int:
    """Mp: the cond channels padded to whole k-steps (0 without cond)."""
    return _pad16(M)


def layer_size(cfg: WaveNetConfig, Mp: int = 0) -> int:
    """P, the floats of one layer's packed weights (and of one partial
    slot): ``[w_in (k*Rp, 2Dp) | w_cond (Mp, 2Dp) | w_res (Dp, Rp) | b_in
    (2Dp) | b_res (Rp)]``, w_cond only with cond (``Mp > 0``)."""
    Rp, Dp = padded_widths(cfg)
    return (cfg.kernel_size * Rp + Mp) * 2 * Dp + Dp * Rp + 2 * Dp + Rp


def _lda(cols: int) -> int:  # csrc/trunk_core.cuh
    return cols + 4


def _ldb(cols: int) -> int:
    return cols + 8


def fwd_smem(tm: int, k: int, Rp: int, Dp: int, wsm: bool,
             Mp: int = 0, bs: bool = False) -> int:
    """K2's shared memory per block in bytes (csrc/trunk_fwd.cu,
    smem_floats): biases, tap rows (and cond rows: ``k*Rp + Mp`` columns),
    u (first, with a bf16 stream ``bs``, the staged bf16 tap rows), and
    the weights (w_in and w_cond) under ``wsm``."""
    KC, D2 = k * Rp + Mp, 2 * Dp
    f = D2 + Rp + tm * (_lda(KC) + max(_lda(Dp), k * Rp // 2 if bs else 0))
    if wsm:
        f += KC * _ldb(D2) + Dp * _ldb(Rp)
    return 4 * f


def bwd_smem(tm: int, k: int, Rp: int, Dp: int, wsm: bool,
             acc_smem: bool, Mp: int = 0) -> int:
    """K3's shared memory per block of a layer launch in bytes
    (csrc/trunk_bwd.cu, smem_floats): biases, tap and cond rows, dh_next,
    dz (first the staged rows of the layer above's dv), u (first the staged
    bf16 tap rows), the weights under ``wsm`` and the partial sums under
    ``acc_smem`` (w_cond's and dw_cond's ``Mp`` rows with cond)."""
    KR, D2 = k * Rp, 2 * Dp
    KC = KR + Mp
    f = D2 + tm * (_lda(KC) + _lda(Rp) + max(_lda(D2), KR)
                   + max(_lda(Dp), KR // 2))
    if wsm:
        f += KC * _ldb(D2) + Dp * _lda(Rp)
    if acc_smem:
        f += KC * _ldb(D2) + Dp * _ldb(Rp) + D2 + Rp
    return 4 * f


def fwd_plan(cfg: WaveNetConfig, Mp: int = 0) -> tuple[int, bool]:
    """``(TM, wsm)`` for K2 (with ``Mp`` padded cond channels and the
    config's stream dtype): the widest tile of positions whose block fits,
    with the weights in shared memory where they fit, else read from
    L2."""
    Rp, Dp = padded_widths(cfg)
    for wsm in (True, False):
        for tm in (64, 32, 16):
            if fwd_smem(tm, cfg.kernel_size, Rp, Dp, wsm, Mp,
                        bf16_stream(cfg)) <= SMEM_LIMIT:
                return tm, wsm
    raise ValueError("the trunk's widths are too large for the kernels "
                     f"(kernel_size {cfg.kernel_size}, R {Rp}, D {Dp})")


def bwd_plan(cfg: WaveNetConfig, Mp: int = 0) -> tuple[int, bool, bool]:
    """``(TM, wsm, acc_smem)`` for K3 (with ``Mp`` padded cond channels):
    the widest tile whose block fits, preferring the weights and then the
    partial sums in shared memory (else the weights are read from L2 and
    the sums kept in the block's own slot in device memory)."""
    Rp, Dp = padded_widths(cfg)
    for wsm, acc in ((True, True), (True, False), (False, False)):
        for tm in (64, 32, 16):
            if bwd_smem(tm, cfg.kernel_size, Rp, Dp, wsm, acc,
                        Mp) <= SMEM_LIMIT:
                return tm, wsm, acc
    raise ValueError("the trunk's widths are too large for the kernels "
                     f"(kernel_size {cfg.kernel_size}, R {Rp}, D {Dp})")


def bwd_geometry(cfg: WaveNetConfig, out_len: int, N: int, tm: int) -> dict:
    """K3's partial slots, from the shapes alone. Layer l's window ``[s_l,
    T)`` is cut into ``tpi[l]`` tiles of ``tm`` positions per item, tile
    ``n * tpi[l] + i`` starting at ``s_l + i * tm`` of item n. The
    ``slots`` blocks of a layer launch each walk ``per[l]`` consecutive
    tiles in order (block b: tiles ``[b * per[l], min((b + 1) * per[l],
    ntiles[l]))``) and write one partial slot, so the sums' order never
    depends on the card."""
    T = cfg.receptive_field + out_len - 1
    s, _ = windows(cfg, out_len)
    tpi = [-(-(T - sl) // tm) for sl in s]
    ntiles = [N * x for x in tpi]
    slots = min(MAX_SLOTS, max(ntiles))
    per = [-(-nt // slots) for nt in ntiles]
    return dict(tpi=tpi, ntiles=ntiles, per=per, slots=slots)


@functools.lru_cache(maxsize=16)
def _pack_index(L: int, k: int, R: int, D: int, M: int) -> torch.Tensor:
    """For each float of the packed weights (L, P), its index in the flat
    ``[w_in | w_res | b_in | b_res | w_cond | 0]`` of the params' layout
    (the last index, a zero, for the padding; no w_cond when M is 0). The
    gate's halves are interleaved by 8-column tiles: packed column ``16c +
    8h + i`` is half h of channel ``8c + i``."""
    Rp, Dp, Mp = _pad16(R), _pad16(D), cond_width(M)
    o_wr = L * k * R * 2 * D
    o_bi = o_wr + L * D * R
    o_br = o_bi + L * 2 * D
    o_wc = o_br + L * R
    zero = o_wc + L * M * 2 * D
    ar = torch.arange

    def pick(valid, idx):
        return torch.where(valid, idx, torch.full_like(idx, zero))

    l6 = ar(L).view(L, 1, 1, 1, 1, 1)
    j, r = ar(k).view(1, k, 1, 1, 1, 1), ar(Rp).view(1, 1, Rp, 1, 1, 1)
    ct = ar(Dp // 8).view(1, 1, 1, Dp // 8, 1, 1)
    h, i = ar(2).view(1, 1, 1, 1, 2, 1), ar(8).view(1, 1, 1, 1, 1, 8)
    c = 8 * ct + i
    w_in = pick((r < R) & (c < D),
                ((l6 * k + j) * R + r) * 2 * D + h * D + c)
    m5 = ar(Mp).view(1, Mp, 1, 1, 1)
    c5 = 8 * ar(Dp // 8).view(1, 1, Dp // 8, 1, 1) + ar(8).view(1, 1, 1, 1, 8)
    l5, h5 = ar(L).view(L, 1, 1, 1, 1), ar(2).view(1, 1, 1, 2, 1)
    w_cond = pick((m5 < M) & (c5 < D),
                  o_wc + (l5 * M + m5) * 2 * D + h5 * D + c5)
    l3, c3, r3 = ar(L).view(L, 1, 1), ar(Dp).view(1, Dp, 1), ar(Rp).view(
        1, 1, Rp)
    w_res = pick((c3 < D) & (r3 < R), o_wr + (l3 * D + c3) * R + r3)
    l4 = ar(L).view(L, 1, 1, 1)
    ct4 = ar(Dp // 8).view(1, Dp // 8, 1, 1)
    h4, i4 = ar(2).view(1, 1, 2, 1), ar(8).view(1, 1, 1, 8)
    c4 = 8 * ct4 + i4
    b_in = pick(c4 < D, o_bi + l4 * 2 * D + h4 * D + c4)
    l2, r2 = ar(L).view(L, 1), ar(Rp).view(1, Rp)
    b_res = pick(r2 < R, o_br + l2 * R + r2)
    parts = (w_in, w_cond, w_res, b_in, b_res) if M else (w_in, w_res, b_in,
                                                          b_res)
    return torch.cat([x.reshape(L, -1) for x in parts], dim=1).reshape(-1)


@functools.lru_cache(maxsize=16)
def _unpack_index(L: int, k: int, R: int, D: int, M: int) -> torch.Tensor:
    """The inverse of :func:`_pack_index`: for each float of the params'
    flat ``[w_in | w_res | b_in | b_res | w_cond]``, its index in (L, P)."""
    idx = _pack_index(L, k, R, D, M)
    n_src = L * (k * R * 2 * D + D * R + 2 * D + R + M * 2 * D)
    inv = torch.empty(n_src, dtype=torch.int64)
    real = idx < n_src
    inv[idx[real]] = torch.arange(idx.numel())[real]
    return inv


_dev_index: dict = {}


def _index(which, cfg: WaveNetConfig, M: int,
           dev: torch.device) -> torch.Tensor:
    key = (which.__name__, cfg.num_layers, cfg.kernel_size,
           cfg.residual_channels, cfg.dilation_channels, M, str(dev))
    x = _dev_index.get(key)
    if x is None:
        x = _dev_index[key] = which(*key[1:6]).to(dev)
    return x


def pack_weights(w: dict, cfg: WaveNetConfig) -> torch.Tensor:
    """The kernels' weight operand, (L, P) f32 (:func:`layer_size`): per
    layer ``[w_in | w_cond | w_res | b_in | b_res]``, R, D and M padded
    with zeros to multiples of 16, w_in as (k*Rp, 2Dp), w_cond as (Mp,
    2Dp) right below it (the tap product's depth extended by the cond
    rows), and w_in, w_cond and b_in with the gate's halves interleaved by
    8-column tiles. ``w`` in the params' layout (biases present, zero where
    the model has none; ``w_cond (L, M, 2D)`` only with cond). One
    gather."""
    M = w["w_cond"].shape[1] if "w_cond" in w else 0
    flat = torch.cat([w["w_in"].reshape(-1), w["w_res"].reshape(-1),
                      w["b_in"].reshape(-1), w["b_res"].reshape(-1)]
                     + ([w["w_cond"].reshape(-1)] if M else [])
                     + [w["w_in"].new_zeros(1)])
    return flat[_index(_pack_index, cfg, M, flat.device)].view(
        cfg.num_layers, layer_size(cfg, cond_width(M)))


def unpack_grads(g: torch.Tensor, cfg: WaveNetConfig, M: int = 0):
    """``(dw_in (L, k, R, 2D), dw_res (L, D, R), db_in (L, 2D), db_res (L,
    R))``, and ``dw_cond (L, M, 2D)`` with ``M`` cond channels, from
    gradients in the packed layout (L, P): the inverse of
    :func:`pack_weights`. One gather; the results are views of its
    result."""
    L, k = cfg.num_layers, cfg.kernel_size
    R, D = cfg.residual_channels, cfg.dilation_channels
    flat = g.reshape(-1)[_index(_unpack_index, cfg, M, g.device)]
    sizes = (L * k * R * 2 * D, L * D * R, L * 2 * D, L * R, L * M * 2 * D)
    dw_in, dw_res, db_in, db_res, dw_cond = torch.split(flat, sizes)
    out = (dw_in.view(L, k, R, 2 * D), dw_res.view(L, D, R),
           db_in.view(L, 2 * D), db_res.view(L, R))
    return out + (dw_cond.view(L, M, 2 * D),) if M else out


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
            fn.argtypes = ([_PTR] * 7 + [_INT] * 11 + [_INTS] * 3 + [_INT] * 3
                           + [_PTR])
            fn.restype = _INT
            lib.wavenet_trunk_fwd_smem.argtypes = [_INT] * 7
            lib.wavenet_trunk_fwd_smem.restype = _INT
    else:
        fn = lib.wavenet_trunk_bwd
        if fn.argtypes is None:
            fn.argtypes = ([_PTR] * 10 + [_INT] * 11 + [_INTS] * 5
                           + [_INT] * 5 + [_PTR])
            fn.restype = _INT
            lib.wavenet_trunk_bwd_smem.argtypes = [_INT] * 7
            lib.wavenet_trunk_bwd_smem.restype = _INT
    return lib


def _ints(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


def _check_config(cfg: WaveNetConfig) -> None:
    """What the kernels refuse whatever the inputs. A model with global
    conditioning channels passes: the caller refuses a passed
    ``global_cond`` (models/wavenet.py), as the JAX package leaves its
    fused trunk only then."""
    if cfg.kernel_size < 2:
        raise ValueError("the trunk kernels need kernel_size >= 2")
    if cfg.stream_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("the trunk kernels take f32 and bf16 streams "
                         f"(stream_dtype {cfg.stream_dtype})")


# the kernels' stream modes (csrc/trunk_fwd.cu, csrc/trunk_bwd.cu)
F32_SAVES, BF16_SAVES, BF16_STREAM = 0, 1, 2


def _weights(params, cfg: WaveNetConfig, dev: torch.device,
             cond: bool = False) -> dict:
    """The kernels' weight operands: contiguous f32 on ``dev`` in the
    params' own layout, zero biases where the model has none, and w_cond
    with ``cond``; the matrices rounded to bf16 under a bf16 stream."""
    L, k = cfg.num_layers, cfg.kernel_size
    R, D = cfg.residual_channels, cfg.dilation_channels
    lp = params["layers"]
    shapes = {"w_in": (L, k, R, 2 * D), "w_res": (L, D, R),
              "b_in": (L, 2 * D), "b_res": (L, R)}
    if cond:
        shapes["w_cond"] = (L, cfg.cond_channels, 2 * D)
    out = {}
    for name, shape in shapes.items():
        x = lp.get(name)
        if x is None and name.startswith("b_"):
            x = torch.zeros(shape, dtype=torch.float32, device=dev)
        if x is None or tuple(x.shape) != shape:
            raise ValueError(f"layers.{name} must have shape {shape}, not "
                             f"{None if x is None else tuple(x.shape)}")
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"layers.{name} must be f32 on {dev}")
        x = x.detach()
        if bf16_stream(cfg) and not name.startswith("b_"):
            x = round_bf16(x)
        out[name] = x.contiguous()
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
                   out_len: int, save_dtype=torch.bfloat16, cond=None):
    """Launch K2 on the current stream with the contract of
    :func:`trunk_fwd_plain` (saves valid on ``[sp_l, T)`` only). With a
    bf16 stream the kernel walks a bf16 stream that is the bf16 saves
    (layer l reads ``saves[l]`` and writes ``saves[l+1]``); f32 saves are
    those values widened. Raises on operands the kernel does not take and
    if the launch fails."""
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
    M = cfg.cond_channels if cond is not None else 0
    bs = bf16_stream(cfg)
    if cond is not None:
        _check_stream("cond", cond, (N, T, M), (torch.float32,), dev)
        if bs:
            cond = round_bf16(cond)
    w = _weights(params, cfg, dev, cond is not None)
    s, sp = windows(cfg, out_len)
    u = torch.empty((N, out_len, L * D), dtype=torch.float32, device=dev)
    if bs:
        mode = BF16_STREAM
        saves = torch.empty((L, N, T, R), dtype=torch.bfloat16, device=dev)
        saves[0].copy_(h0)  # the stream enters rounded
        bufs = saves
    else:
        mode = BF16_SAVES if save_dtype == torch.bfloat16 else F32_SAVES
        saves = torch.empty((L, N, T, R), dtype=save_dtype, device=dev)
        # f32 saves are the layer walk's stream itself; bf16 saves of an
        # f32 stream need an f32 ping-pong pair beside them
        bufs = (torch.empty((2, N, T, R), dtype=torch.float32, device=dev)
                if mode == BF16_SAVES else saves)
    Rp, Dp = padded_widths(cfg)
    Mp = cond_width(M)
    tm, wsm = fwd_plan(cfg, Mp)
    packed = pack_weights(w, cfg)
    err = _bind("trunk_fwd").wavenet_trunk_fwd(
        h0.data_ptr(), packed.data_ptr(), bufs[0].data_ptr(),
        bufs[min(1, bufs.shape[0] - 1)].data_ptr(), saves.data_ptr(),
        u.data_ptr(), cond.data_ptr() if M else None, N, T, out_len, L,
        cfg.kernel_size, R, D, Rp, Dp, M, Mp, _ints(cfg.dilations), _ints(s),
        _ints(sp), mode, tm, int(wsm),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"trunk_fwd launch failed: error {err}")
    fwd_launches += 1
    return u, saves.to(save_dtype)


def trunk_bwd_cuda(params, cfg: WaveNetConfig, saves: torch.Tensor,
                   du: torch.Tensor, out_len: int, cond=None,
                   need_dcond: bool = True):
    """Launch K3 on the current stream with the contract of
    :func:`trunk_bwd_plain`. The weight gradients are reduced over the
    batch and time in a fixed order, and dcond is summed layer by layer
    from the top, with no atomics: two calls on the same inputs give
    bitwise-equal results. Under a bf16 stream f32 saves are read as the
    bf16 values they hold (the JAX kernel casts them to the stream dtype
    on load), so they give the bf16 saves' gradients bitwise."""
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
    M = cfg.cond_channels if cond is not None else 0
    bs = bf16_stream(cfg)
    if cond is not None:
        _check_stream("cond", cond, (N, T, M), (torch.float32,), dev)
        if bs:
            cond = round_bf16(cond)
    if bs:
        mode = BF16_STREAM
        saves = saves.to(torch.bfloat16)
    else:
        mode = BF16_SAVES if saves.dtype == torch.bfloat16 else F32_SAVES
    w = _weights(params, cfg, dev, cond is not None)
    s, _ = windows(cfg, out_len)
    f32 = dict(dtype=torch.float32, device=dev)
    Rp, Dp = padded_widths(cfg)
    Mp = cond_width(M)
    tm, wsm, acc_smem = bwd_plan(cfg, Mp)
    geo = bwd_geometry(cfg, out_len, N, tm)
    P, S = layer_size(cfg, Mp), geo["slots"]
    dv = torch.empty((2, N, T, k * Rp), **f32)
    slots = torch.empty((L, S, P), **f32)
    grads = torch.empty((L, P), **f32)
    dh0 = torch.empty((N, T, R), **f32)
    # every layer adds its dz @ w_cond^T to its window's rows
    dcond = torch.zeros((N, T, M), **f32) if M and need_dcond else None
    packed = pack_weights(w, cfg)
    err = _bind("trunk_bwd").wavenet_trunk_bwd(
        saves.data_ptr(), du.data_ptr(), packed.data_ptr(),
        dv[0].data_ptr(), dv[1].data_ptr(), slots.data_ptr(),
        grads.data_ptr(), dh0.data_ptr(), cond.data_ptr() if M else None,
        dcond.data_ptr() if dcond is not None else None, N, T, out_len, L, k,
        R, D, Rp, Dp, M, Mp, _ints(cfg.dilations), _ints(s),
        _ints(geo["tpi"]), _ints(geo["ntiles"]), _ints(geo["per"]), S, tm,
        int(wsm), int(acc_smem), mode,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"trunk_bwd launch failed: error {err}")
    bwd_launches += 1
    out = (dh0, *unpack_grads(grads, cfg, M))
    return out + (dcond,) if M else out


def run_fwd(params, cfg, h0, out_len, save_dtype, cond=None):
    """The plain version for tensors on the CPU, K2 for CUDA tensors."""
    if h0.device.type == "cpu":
        return trunk_fwd_plain(params, cfg, h0, out_len, save_dtype, cond)
    return trunk_fwd_cuda(params, cfg, h0, out_len, save_dtype, cond)


def run_bwd(params, cfg, saves, du, out_len, cond=None, need_dcond=True):
    """The plain version for tensors on the CPU, K3 for CUDA tensors."""
    if saves.device.type == "cpu":
        return trunk_bwd_plain(params, cfg, saves, du, out_len, cond,
                               need_dcond)
    return trunk_bwd_cuda(params, cfg, saves, du, out_len, cond, need_dcond)


# ----------------------------------------------------------------- wrapper


class FusedTrunk(torch.autograd.Function):
    """``u = trunk(h0, w_in, w_res, b_in, b_res, cond, w_cond)`` with K3 (or
    its plain version) as the backward. ``b_in``/``b_res`` may be None (a
    model without biases), ``cond``/``w_cond`` None (no local
    conditioning). dcond is computed only when cond needs a gradient (the
    learnable upsampler's; linear interpolation needs none)."""

    @staticmethod
    def forward(ctx, h0, w_in, w_res, b_in, b_res, cond, w_cond, cfg,
                out_len, save_dtype):
        layers = {"w_in": w_in.detach(), "w_res": w_res.detach()}
        if b_in is not None:
            layers["b_in"] = b_in.detach()
        if b_res is not None:
            layers["b_res"] = b_res.detach()
        if cond is not None:
            layers["w_cond"] = w_cond.detach()
            cond = cond.detach()
        u, saves = run_fwd({"layers": layers}, cfg, h0.detach(), out_len,
                           save_dtype, cond)
        ctx.save_for_backward(saves, cond)
        ctx.layers, ctx.cfg, ctx.out_len = layers, cfg, out_len
        ctx.has_bias = (b_in is not None, b_res is not None)
        return u

    @staticmethod
    def backward(ctx, du):
        saves, cond = ctx.saved_tensors
        out = run_bwd({"layers": ctx.layers}, ctx.cfg, saves,
                      du.to(torch.float32).contiguous(), ctx.out_len, cond,
                      ctx.needs_input_grad[5])
        dh0, dw_in, dw_res, db_in, db_res = out[:5]
        dw_cond, dcond = out[5:] if cond is not None else (None, None)
        return (dh0, dw_in, dw_res, db_in if ctx.has_bias[0] else None,
                db_res if ctx.has_bias[1] else None, dcond, dw_cond, None,
                None, None)


def fused_trunk(params, cfg: WaveNetConfig, h0: torch.Tensor, out_len: int,
                *, cond=None, save_dtype=torch.bfloat16,
                out_dtype=torch.float32, raw: bool = False) -> torch.Tensor:
    """The residual trunk through K2/K3 (CUDA tensors) or their plain
    versions (CPU tensors), differentiable in ``params['layers']``, ``h0``
    and ``cond``. The contract of the JAX package's ``fused_trunk`` with an
    f32 or a bf16 stream (``cfg.stream_dtype``). With a bf16 stream, h0
    and each layer's output stream are rounded to bf16 between layers;
    w_in, w_res, w_cond and cond are rounded to bf16; every sum stays in
    f32; the saves are the stream itself, so f32 and bf16 saves give
    bitwise-equal gradients.

    ``h0``: the embedded input stream ``(N, T, R)``, ``T = receptive_field +
    out_len - 1``. ``cond``: local conditioning ``(N, T, cond_channels)``
    (the vocoder's upsampled mel rows), entering every layer's gate through
    ``layers.w_cond``. Returns every layer's gated units over the output
    window, ``(N, out_len, L*D)`` in ``out_dtype``; the kernel writes this
    layout itself, so ``raw=True`` only views it as ``(N, out_len, L, D)``.
    ``save_dtype``: the per-layer stream saves the backward reads (bf16
    default; f32 for tight gradient checks)."""
    _check_config(cfg)
    N, T, R = h0.shape
    Texp = cfg.receptive_field + out_len - 1
    if T != Texp:
        raise ValueError(
            f"h0 length {T} != receptive_field + out_len - 1 = {Texp}")
    lp = params["layers"]
    w_cond = None
    if cond is not None:
        want = (N, T, cfg.cond_channels)
        if not cfg.cond_channels or tuple(cond.shape) != want:
            raise ValueError(f"cond shape {tuple(cond.shape)} must be {want} "
                             "(N, T, cond_channels)")
        cond, w_cond = cond.to(torch.float32).contiguous(), lp["w_cond"]
    u = FusedTrunk.apply(h0.to(torch.float32).contiguous(), lp["w_in"],
                         lp["w_res"], lp.get("b_in"), lp.get("b_res"), cond,
                         w_cond, cfg, out_len, save_dtype)
    u = u.to(out_dtype)
    if raw:
        return u.view(N, out_len, cfg.num_layers, cfg.dilation_channels)
    return u
