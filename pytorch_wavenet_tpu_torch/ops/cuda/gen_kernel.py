"""Fused generation loop: the CUDA kernel K1, its plain PyTorch version and
the wrapper that picks between them.

The kernel (``csrc/gen_kernel.cu``) replaces the JAX package's Pallas TPU
kernel ``ops/pallas/gen_kernel.py::generate_fast_fused``: the whole
autoregressive loop (priming, generation, sampling, feedback, ring state)
runs in ONE launch per call, on one thread block cluster whose 8-lane tile
holds all streams (``csrc/gen_cluster.cuh``, shared with K4). Its source
says what bounds it on an H100 and what the design does about that. The
layer chain's weights are packed per rank of the cluster here
(:func:`pack_chain`), where the CPU tests reach the layout.

:func:`fused_plain` computes the same function with PyTorch ops, step by
step, on any device. The wrapper :func:`generate_fast_fused` runs the
plain version only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises. ``launches`` counts kernel launches,
``headless_launches`` those of the headless kernel.

Conditioning (the vocoder) follows the TPU kernel: local conditioning
``cond`` ``(S, total, M)`` and global ``global_cond`` ``(S, G)`` are
projected to per-layer gate inputs outside the kernel, in one full-f32
product over the call's steps (:func:`project_cond`), and the kernel adds
them beside the tap products.

Sampling at temperature > 0 adds counter-hash Gumbel noise (the int32 hash
of the JAX package's HBM kernel, keyed by class, stream, absolute step and
seed), so the kernel and the plain version draw the same noise, and a
chunked rollout equals a single shot at every temperature when the seed is
the same. The TPU kernel's on-core PRNG has no counterpart here: at
temperature > 0 rollouts differ from the JAX package's.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import torch

from ...config import WaveNetConfig
from ...device import resolve_device
from ...models.generate import classes_to_waveform
from ...models.wavenet import Params, params_to

# launches since the counts were last set to 0: of the kernel (one a
# call) and of its headless version (one more a call with ``head_from``
# above 0, launched first); the plain version counts neither
launches = 0
headless_launches = 0

MAX_STREAMS = 8  # the lanes of the kernel's one tile
CLUSTER = 16     # blocks of K1's one cluster (faster than 8: PERF.md)


class FusedGenState(NamedTuple):
    """Streaming state of :func:`generate_fast_fused`: the rings, the
    absolute steps completed and the next input class per stream. Passing
    it back continues the rollout with no re-priming, bitwise equal to an
    uninterrupted run."""

    rings: tuple        # L tensors, (P_l * streams, R) f32; row slot*streams + s
    t: int              # absolute steps completed
    cls: torch.Tensor   # (streams,) int32 next input class


def periods(cfg: WaveNetConfig) -> list[int]:
    return [(cfg.kernel_size - 1) * d + 1 for d in cfg.dilations]


def ring_views(rings: torch.Tensor, cfg: WaveNetConfig,
               streams: int) -> list[torch.Tensor]:
    """Per-layer ``(P_l * streams, R)`` views of the flat ring buffer
    (layer after layer, row ``slot * streams + s``)."""
    R, views, off = cfg.residual_channels, [], 0
    for P in periods(cfg):
        views.append(rings[off:off + P * streams * R].view(P * streams, R))
        off += P * streams * R
    return views


def prepare_weights(params: Params, cfg: WaveNetConfig,
                    fuse_res: bool) -> dict:
    """The kernel's operands, contiguous f32 on the params' device: fused
    filter|gate taps, [skip|res] output weights, zero biases where the
    model has none and, under ``fuse_res``, the chain weights
    ``wf[l] = w_res[l] @ w_cur[l+1]`` and ``bf[l] = b_res[l] @ w_cur[l+1]
    + b_in[l+1]``; ``chain``: those of the layer chain packed per rank of
    the :data:`CLUSTER`-block cluster, see :func:`pack_chain`."""
    w = base_weights(params, cfg, fuse_res)
    w["chain"] = pack_chain(w, cfg, fuse_res, False, CLUSTER)
    return w


def base_weights(params: Params, cfg: WaveNetConfig, fuse_res: bool) -> dict:
    """:func:`prepare_weights` without the packed chain."""
    L, k = cfg.num_layers, cfg.kernel_size
    R, D, S = cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels
    lp = params["layers"]
    f32 = torch.float32
    dev = lp["w_in"].device

    def get(tree, name, shape):
        x = tree.get(name)
        return torch.zeros(shape, dtype=f32, device=dev) if x is None else x

    w_tap = lp["w_in"].to(f32).contiguous()
    b_in = get(lp, "b_in", (L, 2 * D)).to(f32).contiguous()
    w = {
        "w_start": params["start"]["w"].to(f32).contiguous(),
        "b_start": get(params["start"], "b", (R,)).to(f32).contiguous(),
        "w_tap": w_tap,
        "b_in": b_in,
        "w_out": torch.cat([lp["w_skip"].to(f32), lp["w_res"].to(f32)],
                           dim=2).contiguous(),
        "b_out": torch.cat([get(lp, "b_skip", (L, S)).to(f32),
                            get(lp, "b_res", (L, R)).to(f32)],
                           dim=1).contiguous(),
        "w_end1": params["end1"]["w"].to(f32).contiguous(),
        "b_end1": params["end1"]["b"].to(f32).contiguous(),
        "w_end2": params["end2"]["w"].to(f32).contiguous(),
        "b_end2": params["end2"]["b"].to(f32).contiguous(),
    }
    if fuse_res:
        w_res = lp["w_res"].to(f32)
        w_cur = w_tap[:, k - 1]
        b_res = get(lp, "b_res", (L, R)).to(f32)
        w["wf"] = torch.einsum("ldr,lrm->ldm", w_res[:-1],
                               w_cur[1:]).contiguous()
        w["bf"] = (torch.einsum("lr,lrm->lm", b_res[:-1], w_cur[1:])
                   + b_in[1:]).contiguous()
    return w


# ------------------------------------------------ the cluster core's layout

SMEM_LIMIT = 232448  # bytes of shared memory an H100 block may use
PART_ROWS = 15 * 16  # the head's partial sums: 15 warps' 16-column tiles


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def chain_dims(cfg: WaveNetConfig, cluster: int, fuse_res: bool) -> dict:
    """The per-rank chain layout of ``csrc/gen_cluster.cuh`` (``Chain``):
    gate column slots ``ndm`` (rank q owns filter and gate channels q +
    j*cluster), residual slots ``nrm``, tap blocks ``nlt`` (the layers q +
    m*cluster), tap rows ``KT``, rows ``TS`` of an owned layer's slot in
    shared memory (its tap rows, then its h until the ring write), floats
    per layer ``PL`` and per rank ``F``."""
    L, k = cfg.num_layers, cfg.kernel_size
    R, D = cfg.residual_channels, cfg.dilation_channels
    ndm, nrm, nlt = _cdiv(D, cluster), _cdiv(R, cluster), _cdiv(L, cluster)
    KT = (k - 1) * R
    PL = R * 2 * ndm + 2 * ndm + D * nrm + nrm + (D * 2 * ndm if fuse_res
                                                  else 0)
    base = nlt * KT * 2 * D
    return dict(ndm=ndm, nrm=nrm, nlt=nlt, KT=KT, TS=max(KT, R), PL=PL,
                base=base, F=base + L * PL)


def pack_chain(w: dict, cfg: WaveNetConfig, fuse_res: bool, skip_slab: bool,
               cluster: int) -> torch.Tensor:
    """The chain's weights as ``(cluster, F)`` f32, row q what rank q of
    the cluster holds in shared memory: the tap rows ``w_tap[l, :k-1]`` of
    its layers l = q + m*cluster, then per layer its columns of ``w_cur =
    w_tap[l, k-1]`` and of the gate bias (``b_in[0]``, then ``bf[l-1]``
    under ``fuse_res``, else ``b_in[l]``), its residual columns of the
    residual weights and bias (``w_res``/``b_res`` under ``skip_slab``,
    else the residual part of ``w_out``/``b_out``) and, under
    ``fuse_res``, its columns of ``wf[l]`` (zeros for the last layer).
    Slots past a width hold zeros. Reads the operands of
    :func:`base_weights` (or the K4 ones), which stay as they are."""
    L, k = cfg.num_layers, cfg.kernel_size
    R, D, S = cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels
    fuse_res = fuse_res and L > 1
    dims = chain_dims(cfg, cluster, fuse_res)
    ndm, nrm, nlt, KT = dims["ndm"], dims["nrm"], dims["nlt"], dims["KT"]
    w_tap = w["w_tap"]
    dev, f32 = w_tap.device, torch.float32
    if skip_slab:
        w_res, b_res = w["w_res"], w["b_res"]
    else:
        w_res, b_res = w["w_out"][:, :, S:], w["b_out"][:, S:]
    bz = w["b_in"]
    if fuse_res:
        bz = torch.cat([w["b_in"][:1], w["bf"]], dim=0)
    taps = w_tap[:, :k - 1].reshape(L, KT, 2 * D)
    rows = []
    for q in range(cluster):
        c = q + cluster * torch.arange(ndm, device=dev)
        cmask = torch.cat([c < D, c < D])
        cols = torch.cat([c, D + c]).clamp(max=2 * D - 1)
        r = q + cluster * torch.arange(nrm, device=dev)
        rmask = r < R
        r = r.clamp(max=R - 1)
        lt = q + cluster * torch.arange(nlt, device=dev)
        tblk = torch.where((lt < L)[:, None, None],
                           taps[lt.clamp(max=L - 1)], torch.zeros((), dtype=f32,
                                                                  device=dev))
        zero = torch.zeros((), dtype=f32, device=dev)
        parts = [
            torch.where(cmask, w_tap[:, k - 1][:, :, cols], zero),  # (L, R, 2ndm)
            torch.where(cmask, bz[:, cols], zero),                  # (L, 2ndm)
            torch.where(rmask, w_res[:, :, r], zero),               # (L, D, nrm)
            torch.where(rmask, b_res[:, r], zero),                  # (L, nrm)
        ]
        if fuse_res:
            wf = torch.where(cmask, w["wf"][:, :, cols], zero)
            parts.append(torch.cat([wf, torch.zeros((1, D, 2 * ndm),
                                                    dtype=f32, device=dev)]))
        per_layer = torch.cat([p.reshape(L, -1) for p in parts], dim=1)
        rows.append(torch.cat([tblk.reshape(-1), per_layer.reshape(-1)]))
    out = torch.stack(rows).contiguous()
    assert out.shape == (cluster, dims["F"])
    return out


def _col_block(n: int, cluster: int) -> int:
    """Head output columns per rank: blocks of 16."""
    return _cdiv(_cdiv(n, cluster), 16) * 16


def shared_bytes_for(cfg: WaveNetConfig, tile: int, cluster: int,
                     fuse_res: bool, cond_rows: int = 0) -> tuple[int, bool]:
    """Dynamic shared memory of one block of the cluster core at ``tile``
    lanes and ``cluster`` blocks, and whether the chain weights are
    resident in it (``csrc/gen_cluster.cuh``, ``shared_bytes``): the
    taps (then h) of the rank's layers, ``cond_rows`` rows of the step's
    conditioning (:func:`cond_rows`), their products for its columns, two
    h rows, the slab of u (reused for the skip row and y1), a column
    scratch, the head's partial sums (in the tap products' rows when they
    are large enough), the argmax table and the next classes, then the
    per-layer chain weights (the tap weights are read from L2). K4's bf16
    and int8 rings stage their tap rows inside the tap rows: the layout
    does not depend on the ring's dtype."""
    L, R, D = cfg.num_layers, cfg.residual_channels, cfg.dilation_channels
    S, E, C = cfg.skip_channels, cfg.end_channels, cfg.classes
    fuse_res = fuse_res and L > 1
    d = chain_dims(cfg, cluster, fuse_res)
    srows = max(_col_block(S, cluster), _col_block(E, cluster),
                _col_block(C, cluster))
    tz_rows = L * 2 * d["ndm"]
    nonblob = (d["nlt"] * d["TS"] * tile + cond_rows * tile
               + tz_rows * tile + 2 * R * tile
               + max(L * D, S, E) * tile
               + srows * tile
               + (0 if PART_ROWS <= tz_rows else PART_ROWS * tile)
               + 2 * cluster * tile + tile + (4 - tile % 4) % 4)
    layers = L * d["PL"]
    resident = (nonblob + layers) * 4 <= SMEM_LIMIT
    return (nonblob + (layers if resident else 0)) * 4, resident


def cond_rows(cfg: WaveNetConfig, cluster: int, fuse_res: bool) -> int:
    """Rows of K1's conditioning slab: the projected rows (2D each) of a
    rank's ``nlt`` layers."""
    return (chain_dims(cfg, cluster, fuse_res and cfg.num_layers > 1)["nlt"]
            * 2 * cfg.dilation_channels)


@contextlib.contextmanager
def full_f32():
    """CUDA f32 products in full f32 inside the block (TF32 off), as the
    JAX package's f32 einsums; the previous setting is restored."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def project_cond(params: Params, cfg: WaveNetConfig, cond, global_cond,
                 streams: int, total: int):
    """The kernel's conditioning operands, as the TPU kernel projects them
    outside its loop, in full f32: ``cond`` ``(streams, total, M)`` ->
    ``(total, L, streams, 2D)`` (step t, layer l, stream s: ``cond[s, t]
    @ w_cond[l]``) and ``global_cond`` ``(streams, G)`` -> ``(L, streams,
    2D)``; None stays None. Raises on shapes other than those. The cond
    rows take ``total * L * streams * 2D * 4`` bytes: 31.5 MB per
    2048-step chunk of one stream at the vocoder preset (30 layers, D =
    64), 246 MB for a one-shot 16000-sample clip."""
    from ...models.wavenet import check_cond

    lp = params["layers"]
    dev = lp["w_in"].device

    def conv(x):
        return None if x is None else torch.as_tensor(x).to(
            device=dev, dtype=torch.float32)

    cond, global_cond = conv(cond), conv(global_cond)
    check_cond(cfg, (streams, total), cond, global_cond)
    with full_f32():
        if cond is not None:
            cond = torch.einsum("stm,lmd->tlsd", cond,
                                lp["w_cond"].to(torch.float32)).contiguous()
        if global_cond is not None:
            global_cond = torch.einsum(
                "sg,lgd->lsd", global_cond,
                lp["w_gcond"].to(torch.float32)).contiguous()
    return cond, global_cond


# ------------------------------------------------------- counter-hash noise

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``(x * m) mod 2**32`` for int64 ``x`` in [0, 2**32) without int64
    overflow: the multiplier goes in two 16-bit halves."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def counter_uniform(idx, tloc, seed, device) -> torch.Tensor:
    """Uniforms in [1e-7, 1 - 1e-7] from the counter hash of ``(idx, tloc,
    seed)`` (ints or integer tensors, broadcast together): the int32
    mixing of the JAX package's ``gen_kernel_hbm.py::hash_gumbel`` and of
    ``csrc/gen_common.cuh``, in int64 arithmetic masked to 32 bits, so
    negative and wrapping values hash as the int32 kernels see them."""
    def u32(v):
        return torch.as_tensor(v, dtype=torch.int64, device=device) & _M32

    x = _mul32(u32(idx), 0x9E3779B9)
    x = x ^ _mul32(u32(tloc), 0x85EBCA6B)
    x = x ^ u32(seed)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp(u, 1e-7, 1.0 - 1e-7)


def hash_uniform(ta: int, seed: int, streams: int, classes: int,
                 device) -> torch.Tensor:
    """Uniforms ``(streams, classes)`` for absolute step ``ta``, K1's
    keying: index ``class * streams + stream``, one seed."""
    c = torch.arange(classes, dtype=torch.int64, device=device)
    s = torch.arange(streams, dtype=torch.int64, device=device)
    return counter_uniform(c[None, :] * streams + s[:, None], ta, seed,
                           device)


def hash_gumbel(ta: int, seed: int, streams: int, classes: int,
                device) -> torch.Tensor:
    """Gumbel noise ``(streams, classes)`` for absolute step ``ta``, the
    kernel's ``hash_gumbel``."""
    u = hash_uniform(ta, seed, streams, classes, device)
    return -torch.log(-torch.log(u))


# ------------------------------------------------------------ plain version


@torch.no_grad()
def fused_plain(w: dict, cfg: WaveNetConfig, prime: torch.Tensor,
                rings: torch.Tensor, t0: int, total: int, temperature: float,
                regularize: float, seed: int, fuse_res: bool,
                return_gaps: bool = False, cond: torch.Tensor | None = None,
                gcond: torch.Tensor | None = None, head_from: int = 0):
    """The kernel's function in PyTorch ops: ``total`` steps for every
    stream of ``prime`` (int32 ``(streams, num_given)``), updating the flat
    ``rings`` in place. ``cond`` ``(total, L, streams, 2D)`` and ``gcond``
    ``(L, streams, 2D)``: the projected conditioning of
    :func:`project_cond`, added to each layer's gate input after the taps.
    Returns the sampled classes ``(streams, total)`` int32, and with
    ``return_gaps`` also the per-step gap between the two best sampling
    scores ``(streams, total)`` (what decides whether a
    differently-rounded version may pick another class).

    Steps ``t < head_from`` (:func:`check_head_from`) are teacher-forced
    and run without the head: the chain and the ring writes only, no skip
    row, logits or sampling. Their class is the prime's next one,
    ``prime[:, t + 1]``, and their gap ``inf`` (no draw to flip); the ring
    and every later class are those of ``head_from = 0`` bitwise."""
    L, k = cfg.num_layers, cfg.kernel_size
    D, S, C = cfg.dilation_channels, cfg.skip_channels, cfg.classes
    streams, num_given = prime.shape
    check_head_from(head_from, num_given)
    per = periods(cfg)
    views = ring_views(rings, cfg, streams)
    if regularize != 0.0:
        c = torch.arange(C, dtype=torch.float32, device=prime.device)
        reg = (c - C / 2.0) ** 2 * regularize
    all_cls = torch.empty((streams, total), dtype=torch.int32,
                          device=prime.device)
    gaps = torch.empty((streams, total), dtype=torch.float32,
                       device=prime.device) if return_gaps else None
    cls = prime[:, 0].long()
    for t in range(total):
        ta = t0 + t
        h = w["w_start"][cls] + w["b_start"]
        skip = torch.zeros((streams, S), dtype=torch.float32,
                           device=h.device)

        def rows(l, slot):
            return views[l][slot * streams:(slot + 1) * streams]

        # ring taps of every layer read before any write of this step (a
        # tap never reads the slot written at this step)
        tap_dots = [[rows(l, (ta - (k - 1 - j) * d) % per[l]) @ w["w_tap"][l, j]
                     for j in range(k - 1)]
                    for l, d in enumerate(cfg.dilations)]

        def extras(l, z):
            for j in range(k - 1):
                z = z + tap_dots[l][j]
            if cond is not None:
                z = z + cond[t, l]
            if gcond is not None:
                z = z + gcond[l]
            return z

        head = t >= head_from
        if not fuse_res:
            for l in range(L):
                z = extras(l, h @ w["w_tap"][l, k - 1] + w["b_in"][l])
                u = torch.tanh(z[:, :D]) * torch.sigmoid(z[:, D:])
                sr = u @ w["w_out"][l] + w["b_out"][l]
                if head:
                    skip = skip + sr[:, :S]
                rows(l, ta % per[l]).copy_(h)
                h = h + sr[:, S:]
        else:
            z = extras(0, h @ w["w_tap"][0, k - 1] + w["b_in"][0])
            for l in range(L):
                rows(l, ta % per[l]).copy_(h)
                if l + 1 < L:
                    pre = extras(l + 1, h @ w["w_tap"][l + 1, k - 1]
                                 + w["bf"][l])
                u = torch.tanh(z[:, :D]) * torch.sigmoid(z[:, D:])
                if l + 1 < L:
                    z = pre + u @ w["wf"][l]
                sr = u @ w["w_out"][l] + w["b_out"][l]
                if head:
                    skip = skip + sr[:, :S]
                h = h + sr[:, S:]

        if not head:
            cls = prime[:, t + 1].long()
            all_cls[:, t] = prime[:, t + 1]
            if return_gaps:
                gaps[:, t] = float("inf")
            continue
        y = torch.relu(skip)
        y = torch.relu(y @ w["w_end1"] + w["b_end1"])
        score = y @ w["w_end2"] + w["b_end2"]
        if regularize != 0.0:
            score = score - reg
        if temperature > 0:
            score = score / temperature + hash_gumbel(ta, seed, streams, C,
                                                      score.device)
        sampled = torch.argmax(score, dim=-1)
        all_cls[:, t] = sampled.to(torch.int32)
        if return_gaps:
            top2 = torch.topk(score, 2, dim=-1).values
            gaps[:, t] = top2[:, 0] - top2[:, 1]
        cls = prime[:, t + 1].long() if t + 1 < num_given else sampled
    return (all_cls, gaps) if return_gaps else all_cls


def check_head_from(head_from: int, num_given: int) -> None:
    """Raise unless ``head_from``, the first step whose class the caller
    reads, lies in ``[0, num_given)``: a step before it must be
    teacher-forced (its next input the prime's), and 0 runs the head on
    every step."""
    if not 0 <= head_from < num_given:
        raise ValueError(f"head_from {head_from} must lie in [0, "
                         f"num_given = {num_given})")


# ------------------------------------------------------------------ kernel

_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _bind():
    from .build import load

    lib = load("gen_kernel")
    fn = lib.wavenet_gen_fused
    if fn.argtypes is None:
        fn.argtypes = ([_PTR] * 11 + [_INT] + [_PTR] * 4 + [_INT] * 12
                       + [ctypes.c_float, ctypes.c_float, _INT, _INT, _INT,
                          _INT, _PTR, _PTR])
        fn.restype = _INT
        lib.wavenet_gen_fused_smem.argtypes = [_INT] * 10 + [_PTR]
        lib.wavenet_gen_fused_smem.restype = _INT
    return lib


def check_layout(lib, smem_fn, args: tuple, expect: tuple[int, bool]):
    """Raise unless the library's shared-memory layout (``smem_fn(*args,
    &resident)``) is the one this module computes (``expect``)."""
    res = ctypes.c_int(0)
    got = (getattr(lib, smem_fn)(*args, ctypes.byref(res)), bool(res.value))
    if got != expect:
        raise RuntimeError(f"{smem_fn}: the kernel's layout {got} differs "
                           f"from the wrapper's {expect}")


def cluster_fits(cfg: WaveNetConfig, tile: int, cluster: int,
                 fuse_res: bool, cond_rows: int = 0) -> int:
    """The shared bytes of one block; raises ``ValueError`` (naming the
    limit) for a config whose buffers do not fit a block even with the
    chain weights read from L2."""
    nbytes, _ = shared_bytes_for(cfg, tile, cluster, fuse_res, cond_rows)
    if nbytes > SMEM_LIMIT:
        raise ValueError(f"{nbytes} bytes of shared memory per block at "
                         f"{tile} lanes and a cluster of {cluster}: over "
                         f"the {SMEM_LIMIT} bytes a block may use")
    return nbytes


def shared_bytes(cfg: WaveNetConfig, fuse_res: bool,
                 cond: bool = False) -> int:
    """Dynamic shared memory of one block of the kernel's cluster, with a
    conditioning slab under ``cond``."""
    rows = cond_rows(cfg, CLUSTER, fuse_res) if cond else 0
    return shared_bytes_for(cfg, MAX_STREAMS, CLUSTER, fuse_res, rows)[0]


def operand_shapes(cfg: WaveNetConfig, fuse_res: bool) -> dict:
    """The shape of each operand of :func:`prepare_weights` that the
    kernel reads."""
    L, k, C = cfg.num_layers, cfg.kernel_size, cfg.classes
    R, D = cfg.residual_channels, cfg.dilation_channels
    S, E = cfg.skip_channels, cfg.end_channels
    shapes = {"w_start": (C, R), "b_start": (R,), "w_tap": (L, k, R, 2 * D),
              "b_in": (L, 2 * D), "w_out": (L, D, S + R), "b_out": (L, S + R),
              "w_end1": (S, E), "b_end1": (E,), "w_end2": (E, C),
              "b_end2": (C,),
              "chain": (CLUSTER, chain_dims(cfg, CLUSTER,
                                            fuse_res and L > 1)["F"])}
    if fuse_res:
        shapes.update(wf=(L - 1, D, 2 * D), bf=(L - 1, 2 * D))
    return shapes


def _launch_fused(w, cfg, prime, rings, t0, total, temperature, regularize,
                  seed, fuse_res, max_clusters=None, cond=None, gcond=None,
                  head_from=0):
    dev = prime.device
    streams, num_given = prime.shape
    per, R = periods(cfg), cfg.residual_channels
    offs = [0]
    for P in per[:-1]:
        offs.append(offs[-1] + P * streams * R)
    meta = torch.tensor([[d, P, o] for d, P, o in
                         zip(cfg.dilations, per, offs)],
                        dtype=torch.int32).to(dev)
    out = torch.empty((streams, total), dtype=torch.int32, device=dev)
    lib = _bind()
    fuse = fuse_res and cfg.num_layers > 1
    dims = (cfg.num_layers, cfg.kernel_size, R, cfg.dilation_channels,
            cfg.skip_channels, cfg.end_channels, cfg.classes)
    rows = 0 if cond is None else cond_rows(cfg, CLUSTER, fuse)
    check_layout(lib, "wavenet_gen_fused_smem",
                 (CLUSTER, *dims, int(fuse), rows),
                 shared_bytes_for(cfg, MAX_STREAMS, CLUSTER, fuse, rows))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.wavenet_gen_fused(
        w["w_start"].data_ptr(), w["b_start"].data_ptr(),
        w["chain"].data_ptr(), w["w_out"].data_ptr(), w["b_out"].data_ptr(),
        w["w_end1"].data_ptr(), w["b_end1"].data_ptr(),
        w["w_end2"].data_ptr(), w["b_end2"].data_ptr(),
        None if cond is None else cond.data_ptr(),
        None if gcond is None else gcond.data_ptr(), rows,
        prime.data_ptr(), meta.data_ptr(), rings.data_ptr(), out.data_ptr(),
        streams, num_given, total, t0, *dims, w["chain"].shape[1],
        float(temperature), float(regularize), int(seed), int(fuse),
        int(head_from), CLUSTER, stream,
        None if max_clusters is None else ctypes.byref(max_clusters))
    if err != 0:
        raise RuntimeError(f"gen_kernel launch failed: error {err}")
    return out


def max_active_clusters(cfg: WaveNetConfig, fuse_res: bool) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the kernel's cluster."""
    dev = torch.device("cuda")
    w = {"chain": torch.empty((CLUSTER, 1), device=dev)}
    for name in ("w_start", "b_start", "w_out", "b_out", "w_end1", "b_end1",
                 "w_end2", "b_end2"):
        w[name] = w["chain"]
    n = ctypes.c_int(0)
    cluster_fits(cfg, MAX_STREAMS, CLUSTER, fuse_res)
    _launch_fused(w, cfg, torch.zeros((1, 1), dtype=torch.int32, device=dev),
                  w["chain"], 0, 1, 0.0, 0.0, 0, fuse_res, max_clusters=n)
    return n.value


def fused_cuda(w: dict, cfg: WaveNetConfig, prime: torch.Tensor,
               rings: torch.Tensor, t0: int, total: int, temperature: float,
               regularize: float, seed: int, fuse_res: bool,
               cond: torch.Tensor | None = None,
               gcond: torch.Tensor | None = None,
               head_from: int = 0) -> torch.Tensor:
    """Launch the kernel on the current stream with the same contract as
    :func:`fused_plain` (no gaps), on one cluster of :data:`CLUSTER`
    blocks: steps before ``head_from`` run without the head. Raises on
    operands that do not match ``cfg`` (the kernel would read out of
    bounds) and if the launch fails."""
    global launches, headless_launches
    if prime.dim() != 2:
        raise ValueError(f"prime must be (streams, num_given), not "
                         f"{tuple(prime.shape)}")
    streams, num_given = prime.shape
    if not 1 <= streams <= MAX_STREAMS:
        raise ValueError(f"{streams} streams: the kernel takes 1 to "
                         f"{MAX_STREAMS}")
    if num_given < 1 or total < 1:
        raise ValueError(f"{num_given} prime classes and {total} steps: "
                         f"the kernel needs at least one of each")
    check_head_from(head_from, num_given)
    if t0 < 0 or t0 + total >= 2**31:
        raise ValueError("absolute steps must lie in [0, 2**31)")
    rows = 0 if cond is None else cond_rows(cfg, CLUSTER, fuse_res)
    cluster_fits(cfg, MAX_STREAMS, CLUSTER, fuse_res, rows)
    shapes = operand_shapes(cfg, fuse_res)
    L, D = cfg.num_layers, cfg.dilation_channels
    extra = {"cond": (cond, (total, L, streams, 2 * D)),
             "gcond": (gcond, (L, streams, 2 * D))}
    for name, (x, shape) in extra.items():
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, not "
                             f"{tuple(x.shape)}")
    for name, shape in shapes.items():
        x = w.get(name)
        if x is None or tuple(x.shape) != shape:
            raise ValueError(f"weight {name} must have shape {shape}, not "
                             f"{None if x is None else tuple(x.shape)}")
    per = periods(cfg)
    R = cfg.residual_channels
    if rings.numel() != sum(per) * streams * R:
        raise ValueError("rings do not match the config and stream count")
    dev = prime.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {dev}")
    for name, x in [(n, w[n]) for n in shapes] + [
            (n, x) for n, (x, _) in extra.items() if x is not None]:
        if x.device != dev or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"operand {name} must be contiguous f32 on {dev}")
    if (rings.device != dev or rings.dtype != torch.float32
            or not rings.is_contiguous()):
        raise ValueError(f"rings must be contiguous f32 on {dev}")
    if prime.dtype != torch.int32 or not prime.is_contiguous():
        raise ValueError("prime must be contiguous int32")
    out = _launch_fused(w, cfg, prime, rings, t0, total, temperature,
                        regularize, seed, fuse_res, cond=cond, gcond=gcond,
                        head_from=head_from)
    launches += 1
    headless_launches += int(head_from > 0)
    return out


# ----------------------------------------------------------------- wrapper


def _seed_from(generator_or_seed) -> int:
    if generator_or_seed is None:
        return 0
    if isinstance(generator_or_seed, torch.Generator):
        return int(torch.randint(0, 2**31 - 1, (1,),
                                 generator=generator_or_seed))
    return int(generator_or_seed) & 0x7FFFFFFF


@torch.no_grad()
def generate_fast_fused(params: Params, cfg: WaveNetConfig,
                        generator_or_seed=None, num_samples: int = 1,
                        first_samples=None, temperature: float = 1.0,
                        regularize: float = 0.0,
                        state: FusedGenState | None = None,
                        return_state: bool = False, fuse_res: bool = False,
                        device: str | torch.device = "cuda",
                        cond=None, global_cond=None):
    """Fused generation for up to 8 streams, the same contract as
    ``models.generate.generate_fast``: ``first_samples`` int ``(S,
    num_given)`` (or ``(num_given,)``, default one mid-class sample);
    ``cond`` ``(S, num_given - 1 + num_samples, M)`` (row t conditions the
    step that consumes input sample t; a resumed call takes its own
    ``num_samples`` rows) and ``global_cond`` ``(S, G)``, projected by
    :func:`project_cond` (whose docstring gives the bytes).
    Returns ``(waveform (S, num_samples) f32, classes (S, num_samples)
    int32)``, plus a :class:`FusedGenState` with ``return_state``; passing
    that state back (``first_samples=None``) continues the rollout.

    ``generator_or_seed`` (int, ``torch.Generator`` or None = 0) keys the
    sampling noise; keep it the same across the chunks of one rollout.
    ``fuse_res`` shortens the serial chain with pre-multiplied weights: the
    same function, reassociated (logits agree to about 1e-5).

    The ``num_given - 1`` teacher-forced steps of a prime run without the
    head (``head_from``): the reference keeps only their queues too, and
    the rings and returned classes are those of a call with the head on
    every step, bitwise.

    On ``device="cpu"`` this runs :func:`fused_plain`; on a CUDA device it
    launches the kernel. The call is three profiler spans in a row:
    ``k1.prepare`` (the operands), ``k1.launch`` (the kernel, or its plain
    version) and ``k1.finish`` (the waveform and the state's views).

    A config that takes the wide-chain kernel (``gen_kernel_wide.
    wide_needed``: the kernel-2 input, or a chain no cluster holds, as at
    ``wnv512``) runs there instead, through
    ``gen_kernel_hbm.generate_fast_batched`` with the same noise keying
    (its plain version on the CPU); its state is that function's
    ``HbmGenState``, passed back the same way."""
    from . import gen_kernel_wide

    if gen_kernel_wide.wide_needed(cfg):
        from .gen_kernel_hbm import generate_fast_batched

        return generate_fast_batched(
            params, cfg, _seed_from(generator_or_seed), num_samples,
            first_samples, temperature, regularize, state, return_state,
            device=device, cond=cond, global_cond=global_cond)
    with torch.profiler.record_function("k1.prepare"):
        dev = resolve_device(device)
        params = params_to(params, dev)
        C = cfg.classes
        if state is not None:
            if first_samples is not None:
                raise ValueError("pass either first_samples or state, not "
                                 "both")
            prime = state.cls.to(dev, torch.int32).reshape(-1, 1)
            t0 = int(state.t)
        else:
            if first_samples is None:
                first_samples = torch.full((1, 1), C // 2,
                                           dtype=torch.int32)
            prime = torch.as_tensor(first_samples).to(dev, torch.int32)
            if prime.dim() == 1:
                prime = prime.reshape(1, -1)
            t0 = 0
        prime = prime.contiguous()
        streams, num_given = prime.shape
        total = num_given - 1 + num_samples
        if not 1 <= streams <= MAX_STREAMS:
            raise ValueError(f"{streams} streams: the fused kernel takes 1 "
                             f"to {MAX_STREAMS}")
        if num_given < 1 or num_samples < 1:
            raise ValueError("need at least one prime class and one sample")
        if t0 + total >= 2**31:
            raise ValueError("absolute step count overflows int32")
        if bool(((prime < 0) | (prime >= C)).any()):
            raise ValueError(f"prime classes must lie in [0, {C})")

        R = cfg.residual_channels
        per = periods(cfg)
        if state is not None:
            if len(state.rings) != len(per) or any(
                    r.shape != (P * streams, R)
                    for r, P in zip(state.rings, per)):
                raise ValueError("state rings do not match the config")
            rings = torch.cat([r.to(dev, torch.float32).reshape(-1)
                               for r in state.rings])
        else:
            rings = torch.zeros(sum(per) * streams * R,
                                dtype=torch.float32, device=dev)
        cproj, gproj = project_cond(params, cfg, cond, global_cond, streams,
                                    total)
        w = prepare_weights(params, cfg, fuse_res)
        seed = _seed_from(generator_or_seed)
    run = fused_plain if dev.type == "cpu" else fused_cuda
    with torch.profiler.record_function("k1.launch"):
        all_cls = run(w, cfg, prime, rings, t0, total, temperature,
                      regularize, seed, fuse_res, cond=cproj, gcond=gproj,
                      head_from=num_given - 1)
    with torch.profiler.record_function("k1.finish"):
        cls = all_cls[:, num_given - 1:total]
        wav = classes_to_waveform(cls, C)
        if not return_state:
            return wav, cls
        new_state = FusedGenState(
            rings=tuple(ring_views(rings, cfg, streams)), t=t0 + total,
            cls=all_cls[:, total - 1].clone())
        return wav, cls, new_state

