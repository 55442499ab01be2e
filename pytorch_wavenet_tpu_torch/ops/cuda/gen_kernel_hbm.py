"""Batched many-stream generation: the CUDA kernel K4, its plain PyTorch
version and the wrapper that picks between them.

The kernel (``csrc/gen_kernel_hbm.cu``) replaces the JAX package's Pallas
TPU kernel ``ops/pallas/gen_kernel_hbm.py::generate_fast_batched``: the
autoregressive loop of many independent streams ("lanes") in ONE launch
per call, the ring state in device memory in the JAX layout
``(sum_l P_l * R, streams)`` (row ``(ring_off[l] + slot) * R + r``), so a
state compares with the JAX package's as it is. It runs on the cluster
core of ``csrc/gen_cluster.cuh``: one thread block cluster of 8 SMs per
tile of ``tile`` lanes. Its source says what bounds it on an H100 and
what the design does about that. Every product sums in an order fixed by
the config alone, so a lane's classes and ring do not depend on the tile
width, its slot or the pool around it.

Semantics carried over from the TPU kernel:

* a fresh call allocates the ring uninitialised; a tap with lookback ``m``
  contributes only once ``ta >= m`` (``ta`` the absolute step), and is
  never read before that (the kernel stages 0.0 through a select, so its
  sums group the same rows at every step and a fresh call equals a rollout
  over zeroed history bitwise);
* a resumed call continues at the state's absolute time; ``lane_clock``
  moves only the noise counter, never a ring slot;
* ``fuse_res`` (pre-multiplied chain weights) and ``skip_slab`` (the skip
  projection as one ``(L*D, S)`` product after the layer walk)
  reassociate sums: the same function, logits within f32 rounding;
* sampling is per-lane: lanes with temperature > 0 draw
  ``argmax(logits / max(T, 1e-6) + gumbel)``, the others take the argmax
  (first index on ties). The Gumbel noise is the JAX package's int32
  counter hash, keyed by ``(class, ta + lane_clock, lane_seed)`` with
  ``lane_seed``, else by ``(class * streams + lane, ta, seed)``.

Ring dtypes, as in the TPU kernel (``ring_dtype``): f32; bf16, the ring
stores each layer's h rounded to bf16 while in-register h stays f32 within
a step (taps read the bf16 values, widened); int8, the ring stores
``clip(round(h * 127 / scale_l), -127, 127)`` with a per-layer scale
(:func:`calibrate_ring_scales`), whose dequant ``scale_l / 127`` is folded
into the lookback tap weights on the host. Under ``skip_slab`` with a bf16
or int8 ring the skip row's operands, the slab of u and the skip weights,
are rounded to bf16 (their products summed in f32).

Differences from the JAX package: a scalar temperature > 0 without
``lane_seed`` goes to the per-lane counter-hash path (the TPU kernel draws
from the TPU's own PRNG there, which has no counter-part), so such
rollouts differ from the JAX package's; any stream count >= 1 and any
residual width runs as it is (the TPU kernel pads to 128 lanes, and on
the TPU needs R % 16 for bf16 rings and R % 32 for int8 ones, its sublane
tiles); a resumed state keeps its ring dtype, and a call raises when it
is not ``ring_dtype`` (the JAX package casts it).

Conditioning, as in the TPU kernel: local conditioning ``cond`` ``(S,
total, M)`` enters the kernel as raw rows ``(total, M, S)`` and each layer
adds ``cond_t @ w_cond[l]`` inside the loop (projecting outside would
write ``total * L * S * 2D`` floats); global conditioning ``(S, G)`` is
projected outside to an ``(L, 2D, S)`` table (:func:`project_gcond`).

:func:`batched_plain` computes the function with PyTorch ops, one step at
a time, on any device. :func:`run_batched` runs it only for tensors on the
CPU; for CUDA tensors it launches the kernel (:func:`batched_cuda`) or
raises. ``launches`` counts kernel launches.

A config with the kernel-2 input (``cfg.input_kernel`` 2: ``h0 =
w_prev[x[t-1]] + w[x[t]] + b``) keeps each lane's previous class in one
more ring row, the last, as ``class + 1`` (0: none, as a zeroed column
reads), read only once ``ta >= 1``. Such a config, and any whose chain no
tile of the cluster core holds (the ``wnv512`` preset's R = D = 512), runs
on the wide-chain kernel KW (``gen_kernel_wide.py``) instead of K4:
:func:`run_batched` dispatches, :func:`prepare_weights` prepares its
operands, and :func:`batched_plain` is its plain version too.

Teacher-forced steps whose class no caller reads (``head_from``: the
first step that is read) run without the head, on the kernel and its
plain version alike: the chain and the ring writes only.
:func:`generate_fast_batched` and the lane pool's prime pass ``num_given -
1``; ``headless_launches`` counts the launches of the headless kernel
that runs those steps.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ...config import WaveNetConfig
from ...device import resolve_device
from ...models.generate import classes_to_waveform
from ...models.wavenet import Params, params_to
from . import gen_kernel as k1
from . import gen_kernel_wide as kw
from .gen_kernel import (
    _seed_from,
    check_head_from,
    counter_uniform,
    full_f32,
    periods,
)

# launches since the counts were last set to 0: of the kernel (one a
# call) and of its headless version (one more a call with ``head_from``
# above 0, launched first); the plain version counts neither
launches = 0
headless_launches = 0

TILES = (8, 16, 24)  # lanes per cluster the kernel is compiled for
# ring dtypes and the library each is compiled into
RING_LIBS = {torch.float32: "gen_kernel_hbm",
             torch.bfloat16: "gen_kernel_hbm_bf16",
             torch.int8: "gen_kernel_hbm_int8"}
CLUSTER = 8          # blocks per cluster (16 lost in every sweep: PERF.md)
# the phases of a step that ``batched_cuda(timers=...)`` times
PHASES = ("tap products", "chain work", "chain barriers", "skip row",
          "ring writes + end1", "end2", "sampling")


class HbmGenState(NamedTuple):
    """Streaming state of :func:`generate_fast_batched`: the ring, the
    absolute steps completed and the next input class per stream. Passing
    it back continues every stream with no re-priming, bitwise equal to an
    uninterrupted run."""

    ring: torch.Tensor  # (ring_rows(cfg), streams) in the ring dtype
    t: int              # absolute steps completed
    cls: torch.Tensor   # (streams,) int32 next input class


def ring_offsets(cfg: WaveNetConfig) -> list[int]:
    """First ring slot of each layer (``ring_off`` of the JAX kernel)."""
    return np.cumsum([0] + periods(cfg))[:-1].tolist()


def ring_rows(cfg: WaveNetConfig) -> int:
    """The ring's rows: every layer's slots, and with the kernel-2 input
    the previous-class row."""
    return (sum(periods(cfg)) * cfg.residual_channels
            + int(cfg.input_kernel == 2))


def is_wide(w: dict) -> bool:
    """``w`` (:func:`prepare_weights`) is for the wide-chain kernel."""
    return "wide" in w


def prepare_weights(params: Params, cfg: WaveNetConfig, fuse_res: bool,
                    skip_slab: bool, ring_dtype=torch.float32,
                    ring_scales=None) -> dict:
    """K4's operands, contiguous f32 on the params' device: K1's (see
    ``gen_kernel.base_weights``: fused filter|gate taps, [skip|res]
    output weights, zero biases where the model has none, the ``fuse_res``
    chain weights) and under ``skip_slab`` the residual-only output weights
    ``w_res``/``b_res``, the concatenated skip weights ``w_skip`` ``(L*D,
    S)`` and the pre-summed skip bias ``b_skip`` ``(S,)`` in place of the
    [skip|res] pair. ``meta`` int32 ``(L, 3)`` holds each layer's dilation,
    period and first ring slot, on the device once rather than per launch
    (a host-to-device copy from pageable memory waits for the stream).
    ``chain`` packs the layer chain's weights per rank of the
    :data:`CLUSTER`-block cluster (``gen_kernel.pack_chain``). A
    conditioned model adds ``w_cond`` ``(L, M, 2D)``, which the kernel
    reads from L2 (and ``w_gcond``, for :func:`project_gcond`).

    ``ring_dtype`` (f32, bf16 or int8) is recorded under ``"ring_dtype"``:
    the operands serve rings of that dtype only. With a bf16 or int8 ring
    and ``skip_slab``, ``w_skip`` is rounded to bf16. int8 rings take
    ``ring_scales`` ``(L,)`` (:func:`calibrate_ring_scales`): the lookback
    taps ``w_tap[:, :k-1]`` are multiplied by ``scale / 127`` (the
    dequant) and ``qscale`` ``(L,)`` holds the store scale ``127 /
    scale``, both in f32 as the JAX package computes them."""
    if ring_dtype not in RING_LIBS:
        raise ValueError(f"ring_dtype must be one of {list(RING_LIBS)}, "
                         f"not {ring_dtype}")
    if kw.wide_needed(cfg):
        return _wide_weights(params, cfg, ring_dtype)
    if (ring_dtype == torch.int8) != (ring_scales is not None):
        raise ValueError("int8 rings need per-layer ring_scales (and only "
                         "they take them): calibrate_ring_scales()")
    fuse_res = fuse_res and cfg.num_layers > 1
    w = k1.base_weights(params, cfg, fuse_res)
    for name in ("w_cond", "w_gcond"):
        if name in params["layers"]:
            w[name] = params["layers"][name].to(torch.float32).contiguous()
    w["meta"] = _meta(cfg, w["w_tap"].device)
    if skip_slab:
        L, D, S = cfg.num_layers, cfg.dilation_channels, cfg.skip_channels
        b_out = w.pop("b_out")
        w_out = w.pop("w_out")
        w["w_res"] = w_out[:, :, S:].contiguous()
        w["b_res"] = b_out[:, S:].contiguous()
        w["w_skip"] = w_out[:, :, :S].reshape(L * D, S).contiguous()
        w["b_skip"] = b_out[:, :S].sum(dim=0).contiguous()
        if ring_dtype != torch.float32:
            w["w_skip"] = w["w_skip"].to(torch.bfloat16).to(torch.float32)
    if ring_dtype == torch.int8:
        # f32 divisions on the host: torch divides by (and into) a scalar
        # through its reciprocal on some devices, one ulp off jnp's
        sc = np.asarray(_host(ring_scales), np.float32)
        if sc.shape != (cfg.num_layers,):
            raise ValueError(f"ring_scales must have shape "
                             f"({cfg.num_layers},), not {sc.shape}")
        dev, k = w["w_tap"].device, cfg.kernel_size
        deq = torch.from_numpy(sc / np.float32(127.0)).to(dev)
        w_tap = w["w_tap"]  # may be the params' own tensor: not in place
        w["w_tap"] = torch.cat(
            [w_tap[:, :k - 1] * deq[:, None, None, None],
             w_tap[:, k - 1:]], dim=1).contiguous()
        w["qscale"] = torch.from_numpy(np.float32(127.0) / sc).to(dev)
    w["chain"] = k1.pack_chain(w, cfg, fuse_res, skip_slab, CLUSTER)
    w["ring_dtype"] = ring_dtype
    return w


def _meta(cfg: WaveNetConfig, device) -> torch.Tensor:
    """Each layer's dilation, period and first ring slot, int32 ``(L, 3)``
    on ``device``."""
    return torch.tensor(
        [[d, P, o] for d, P, o in zip(cfg.dilations, periods(cfg),
                                      ring_offsets(cfg))],
        dtype=torch.int32).to(device)


def _wide_weights(params: Params, cfg: WaveNetConfig, ring_dtype) -> dict:
    """:func:`prepare_weights` for the wide-chain kernel: K1's base
    operands without ``fuse_res`` or the packed chain, ``w_cond``,
    ``w_prev`` (the kernel-2 input's tap on the previous class) and
    ``meta``; the kernel's packing is made at its first launch
    (``"wide"``)."""
    if ring_dtype != torch.float32:
        raise ValueError(f"{ring_dtype} rings: the wide-chain kernel takes "
                         f"f32 rings only")
    if cfg.kernel_size != 2:
        raise ValueError("the wide-chain kernel takes kernel_size 2")
    w = k1.base_weights(params, cfg, False)
    if "w_cond" in params["layers"]:
        w["w_cond"] = params["layers"]["w_cond"].to(torch.float32).contiguous()
    if cfg.input_kernel == 2:
        w["w_prev"] = params["start"]["w_prev"].to(torch.float32).contiguous()
    w["meta"] = _meta(cfg, w["w_tap"].device)
    w["ring_dtype"] = ring_dtype
    w["wide"] = None
    return w


def operand_shapes(cfg: WaveNetConfig, fuse_res: bool,
                   skip_slab: bool) -> dict:
    """The shape of each operand of :func:`prepare_weights` that the kernel
    reads."""
    L, k, C = cfg.num_layers, cfg.kernel_size, cfg.classes
    R, D = cfg.residual_channels, cfg.dilation_channels
    S, E = cfg.skip_channels, cfg.end_channels
    shapes = {"w_start": (C, R), "b_start": (R,), "w_tap": (L, k, R, 2 * D),
              "b_in": (L, 2 * D), "w_end1": (S, E), "b_end1": (E,),
              "w_end2": (E, C), "b_end2": (C,), "meta": (L, 3),
              "chain": (CLUSTER, k1.chain_dims(cfg, CLUSTER,
                                               fuse_res and L > 1)["F"])}
    if skip_slab:
        shapes.update(w_res=(L, D, R), b_res=(L, R), w_skip=(L * D, S),
                      b_skip=(S,))
    else:
        shapes.update(w_out=(L, D, S + R), b_out=(L, S + R))
    if fuse_res and L > 1:
        shapes.update(wf=(L - 1, D, 2 * D), bf=(L - 1, 2 * D))
    return shapes


def project_gcond(w: dict, cfg: WaveNetConfig, global_cond,
                  streams: int) -> torch.Tensor | None:
    """Global conditioning ``(streams, G)`` -> the kernel's ``(L, 2D,
    streams)`` table (``global_cond[s] @ w_gcond[l]``, full f32); None
    stays None."""
    if global_cond is None:
        return None
    from ...models.wavenet import check_cond

    g = torch.as_tensor(global_cond).to(device=w["w_tap"].device,
                                        dtype=torch.float32)
    check_cond(cfg, (streams,), None, g)
    with full_f32():
        return torch.einsum("sg,lgd->lds", g, w["w_gcond"]).contiguous()


# ------------------------------------------------------------ plain version


@torch.no_grad()
def batched_plain(w: dict, cfg: WaveNetConfig, prime: torch.Tensor,
                  ring: torch.Tensor, t0: int, total: int,
                  temps: torch.Tensor, seeds: torch.Tensor,
                  toffs: torch.Tensor, seed: int, regularize: float,
                  fuse_res: bool, skip_slab: bool, lane_seed: bool,
                  return_gaps: bool = False,
                  cond: torch.Tensor | None = None,
                  gcond: torch.Tensor | None = None, head_from: int = 0):
    """The kernel's function in PyTorch ops: ``total`` steps from absolute
    step ``t0`` for every lane of ``prime`` (int32 ``(streams,
    num_given)``), updating ``ring`` ``(sum P * R, streams)`` in place.
    ``temps`` ``(streams,)`` f32, ``seeds``/``toffs`` ``(streams,)`` int32
    (read under ``lane_seed``), ``seed`` the one seed otherwise. ``cond``
    ``(total, M, streams)`` rows (step t's at ``cond[t]``, times
    ``w["w_cond"][l]`` in each layer) and ``gcond`` ``(L, 2D, streams)``
    (:func:`project_gcond`) add to the gate inputs after the taps. The
    ring's dtype is the one ``w`` was prepared for: a bf16 ring stores h
    rounded, an int8 one its counts at ``w["qscale"]``; taps read the
    stored values widened to f32 (int8 counts times the folded weights),
    and under ``skip_slab`` the slab of u is rounded to bf16. Returns
    the sampled classes ``(streams, total)`` int32 and, with
    ``return_gaps``, the per-step gap between the two best sampling scores
    ``(streams, total)`` (what decides whether a differently-rounded
    version may pick another class). The sums follow the JAX kernel's
    order. Steps ``t < head_from`` run without the head, as
    ``gen_kernel.fused_plain`` says: class ``prime[:, t + 1]``, gap
    ``inf``, the ring and later classes bitwise those of ``head_from =
    0``. With the kernel-2 input the ring's last row carries each lane's
    previous class (the module docstring); weights for the wide-chain
    kernel (:func:`is_wide`) take neither ``fuse_res`` nor ``skip_slab``."""
    if is_wide(w):
        fuse_res = skip_slab = False
    L, k = cfg.num_layers, cfg.kernel_size
    R, D, S, C = (cfg.residual_channels, cfg.dilation_channels,
                  cfg.skip_channels, cfg.classes)
    fuse_res = fuse_res and L > 1
    streams, num_given = prime.shape
    check_head_from(head_from, num_given)
    dev = prime.device
    per, first = periods(cfg), ring_offsets(cfg)
    rdt = _check_ring_dtype(w, ring)
    slots = ring[:sum(per) * R].view(sum(per), R, streams)
    prev_row = ring[-1] if cfg.input_kernel == 2 else None
    w_cur = w["w_tap"][:, k - 1]
    hot = temps > 0
    any_hot = bool(hot.any())
    tdiv = torch.clamp(temps, min=1e-6)[:, None]
    cidx = torch.arange(C, dtype=torch.int64, device=dev)
    lanes = torch.arange(streams, dtype=torch.int64, device=dev)
    if regularize != 0.0:
        reg = (cidx.to(torch.float32) - C / 2.0) ** 2 * regularize
    all_cls = torch.empty((streams, total), dtype=torch.int32, device=dev)
    gaps = (torch.empty((streams, total), dtype=torch.float32, device=dev)
            if return_gaps else None)
    cls = prime[:, 0].long()
    for t in range(total):
        ta = t0 + t
        head = t >= head_from
        h = w["w_start"][cls]
        if prev_row is not None:  # the kernel-2 input's previous class
            pv = prev_row.to(torch.float32)
            valid = (pv > 0.5) & (ta >= 1)
            p = torch.clamp(pv.long() - 1, 0, C - 1)
            h = torch.where(valid[:, None], w["w_prev"][p] + h, h)
            prev_row.copy_(cls.to(prev_row.dtype) + 1)
        h = h + w["b_start"]
        skip = torch.zeros((streams, S), dtype=torch.float32, device=dev)
        slab = []

        def extras(l, z):
            # predicated taps: skipped (never read) while ta < lookback
            d, P = cfg.dilations[l], per[l]
            for j in range(k - 1):
                m = (k - 1 - j) * d
                if ta >= m:
                    tap = slots[first[l] + (ta - m) % P].T.to(torch.float32)
                    z = z + tap @ w["w_tap"][l, j]
            if cond is not None:
                z = z + cond[t].T @ w["w_cond"][l]
            if gcond is not None:
                z = z + gcond[l].T
            return z

        def write(l, h):
            if rdt == torch.int8:  # jnp.round and torch.round: half to even
                h = torch.clamp(torch.round(h * w["qscale"][l]), -127.0,
                                127.0)
            slots[first[l] + ta % per[l]] = h.T  # bf16: rounds to nearest

        def consume(l, u, h, skip):
            if skip_slab:
                if head:
                    slab.append(u if rdt == torch.float32 else
                                u.to(torch.bfloat16).to(torch.float32))
                return h + (u @ w["w_res"][l] + w["b_res"][l]), skip
            sr = u @ w["w_out"][l] + w["b_out"][l]
            return h + sr[:, S:], skip + sr[:, :S] if head else skip

        if not fuse_res:
            for l in range(L):
                write(l, h)
                z = extras(l, h @ w_cur[l] + w["b_in"][l])
                u = torch.tanh(z[:, :D]) * torch.sigmoid(z[:, D:])
                h, skip = consume(l, u, h, skip)
        else:
            z = extras(0, h @ w_cur[0] + w["b_in"][0])
            for l in range(L):
                write(l, h)
                if l + 1 < L:
                    pre = extras(l + 1, h @ w_cur[l + 1] + w["bf"][l])
                u = torch.tanh(z[:, :D]) * torch.sigmoid(z[:, D:])
                if l + 1 < L:
                    z = pre + u @ w["wf"][l]
                h, skip = consume(l, u, h, skip)

        if not head:
            cls = prime[:, t + 1].long()
            all_cls[:, t] = prime[:, t + 1]
            if return_gaps:
                gaps[:, t] = float("inf")
            continue
        if skip_slab:
            row = torch.cat(slab, dim=1) @ w["w_skip"] + w["b_skip"]
        else:
            row = skip
        y = torch.relu(row)
        y = torch.relu(y @ w["w_end1"] + w["b_end1"])
        score = y @ w["w_end2"] + w["b_end2"]
        if regularize != 0.0:
            score = score - reg
        if any_hot:
            if lane_seed:
                u01 = counter_uniform(cidx[None, :],
                                      ta + toffs.long()[:, None],
                                      seeds.long()[:, None], dev)
            else:
                u01 = counter_uniform(cidx[None, :] * streams + lanes[:, None],
                                      ta, seed, dev)
            drawn = score / tdiv - torch.log(-torch.log(u01))
            score = torch.where(hot[:, None], drawn, score)
        sampled = torch.argmax(score, dim=-1)
        all_cls[:, t] = sampled.to(torch.int32)
        if return_gaps:
            top2 = torch.topk(score, 2, dim=-1).values
            gaps[:, t] = top2[:, 0] - top2[:, 1]
        cls = prime[:, t + 1].long() if t + 1 < num_given else sampled
    return (all_cls, gaps) if return_gaps else all_cls


# ------------------------------------------------------------------ kernel

def _check_ring_dtype(w: dict, ring: torch.Tensor) -> torch.dtype:
    """The ring's dtype; raises unless ``w`` was prepared for it."""
    want = w.get("ring_dtype", torch.float32)
    if ring.dtype != want:
        raise ValueError(f"the ring is {ring.dtype} but the weights were "
                         f"prepared for {want} rings")
    return want


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _bind(ring_dtype=torch.float32):
    from .build import load

    lib = load(RING_LIBS[ring_dtype])
    fn = lib.wavenet_gen_batched
    if fn.argtypes is None:
        fn.argtypes = ([_PTR] * 12 + [_INT] + [_PTR] * 8 + [_INT] * 12
                       + [ctypes.c_float] + [_INT] * 7 + [_PTR] * 3)
        fn.restype = _INT
        lib.wavenet_gen_batched_smem.argtypes = [_INT] * 11 + [_PTR]
        lib.wavenet_gen_batched_smem.restype = _INT
    return lib


def shared_bytes(cfg: WaveNetConfig, tile: int, fuse_res: bool,
                 cond: bool = False) -> int:
    """Dynamic shared memory of one block of the kernel at ``tile`` lanes
    per cluster (the chain's weights included when they fit;
    ``gen_kernel.shared_bytes_for``), with the conditioning slab (M rows)
    under ``cond``; the same at every ring dtype."""
    rows = cfg.cond_channels if cond else 0
    return k1.shared_bytes_for(cfg, tile, CLUSTER, fuse_res, rows)[0]


def default_tile(streams: int, cfg: WaveNetConfig, fuse_res: bool,
                 active, cond_rows: int = 0) -> int:
    """Lanes per cluster: the narrowest compiled width whose clusters all
    run at once (``active(tile)``: how many clusters of that width the card
    runs at once, :func:`max_active_clusters` on the card) with the chain's
    weights resident, else the widest with them resident, else the widest
    that fits (PERF.md section 5: the width sweep). ``cond_rows``: the
    conditioning slab's rows (M with local conditioning, else 0)."""
    def smem(t):
        return k1.shared_bytes_for(cfg, t, CLUSTER, fuse_res, cond_rows)

    fits = [t for t in TILES if smem(t)[0] <= k1.SMEM_LIMIT]
    if not fits:
        raise ValueError(f"no tile width of {TILES} fits a block's "
                         f"{k1.SMEM_LIMIT} bytes of shared memory")
    resident = [t for t in fits if smem(t)[1]]
    for t in resident:
        if -(-streams // t) <= active(t):
            return t
    return (resident or fits)[-1]


def _launch(w, cfg, prime, ring, t0, total, temps, seeds, toffs, seed,
            regularize, fuse_res, skip_slab, lane_seed, tile,
            max_clusters=None, timers=None, cond=None, gcond=None,
            cond_rows=None, head_from=0):
    dev = prime.device
    streams, num_given = prime.shape
    out = torch.empty((streams, total), dtype=torch.int32, device=dev)
    lib = _bind(ring.dtype)
    dims = (cfg.num_layers, cfg.kernel_size, cfg.residual_channels,
            cfg.dilation_channels, cfg.skip_channels, cfg.end_channels,
            cfg.classes)
    rows = cond_rows
    if rows is None:  # the slab's rows: M with local conditioning
        rows = 0 if cond is None else cfg.cond_channels
    k1.check_layout(lib, "wavenet_gen_batched_smem",
                    (tile, CLUSTER, *dims, int(fuse_res), rows),
                    k1.shared_bytes_for(cfg, tile, CLUSTER, fuse_res, rows))
    skip_w, skip_b = (("w_skip", "b_skip") if skip_slab
                      else ("w_out", "b_out"))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.wavenet_gen_batched(
        w["w_start"].data_ptr(), w["b_start"].data_ptr(),
        w["chain"].data_ptr(), w[skip_w].data_ptr(), w[skip_b].data_ptr(),
        w["w_end1"].data_ptr(), w["b_end1"].data_ptr(),
        w["w_end2"].data_ptr(), w["b_end2"].data_ptr(),
        None if cond is None else cond.data_ptr(),
        None if cond is None else w["w_cond"].data_ptr(),
        None if gcond is None else gcond.data_ptr(), rows,
        w["qscale"].data_ptr() if "qscale" in w else None,
        temps.data_ptr(), seeds.data_ptr(), toffs.data_ptr(),
        prime.data_ptr(), w["meta"].data_ptr(), ring.data_ptr(),
        out.data_ptr(), streams, num_given, total, t0, *dims,
        w["chain"].shape[1], float(regularize), int(seed), int(fuse_res),
        int(bool(skip_slab)), int(bool(lane_seed)), int(head_from), tile,
        CLUSTER, stream,
        None if max_clusters is None else ctypes.byref(max_clusters),
        None if timers is None else timers.data_ptr())
    if err != 0:
        raise RuntimeError(f"gen_kernel_hbm launch failed: error {err}")
    return out


@functools.lru_cache(maxsize=None)
def max_active_clusters(cfg: WaveNetConfig, tile: int, fuse_res: bool,
                        skip_slab: bool, cond_rows: int = 0,
                        ring_dtype=torch.float32) -> int:
    """``cudaOccupancyMaxActiveClusters`` of the kernel at ``tile`` lanes
    per cluster (with a conditioning slab of ``cond_rows`` rows, for rings
    of ``ring_dtype``) on the current card (nothing is launched;
    cached)."""
    fuse_res = fuse_res and cfg.num_layers > 1
    k1.cluster_fits(cfg, tile, CLUSTER, fuse_res, cond_rows)
    dev = torch.device("cuda")
    x = torch.empty((CLUSTER, 1), device=dev)
    ring = torch.empty((CLUSTER, 1), dtype=ring_dtype, device=dev)
    i = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    w = {name: x for name in ("w_start", "b_start", "chain", "w_skip",
                              "b_skip", "w_out", "b_out", "w_end1", "b_end1",
                              "w_end2", "b_end2")}
    w["meta"] = i
    n = ctypes.c_int(0)
    _launch(w, cfg, i, ring, 0, 1, x, i, i, 0, 0.0, fuse_res, skip_slab,
            False, tile, max_clusters=n, cond_rows=cond_rows)
    return n.value


def batched_cuda(w: dict, cfg: WaveNetConfig, prime: torch.Tensor,
                 ring: torch.Tensor, t0: int, total: int,
                 temps: torch.Tensor, seeds: torch.Tensor,
                 toffs: torch.Tensor, seed: int, regularize: float,
                 fuse_res: bool, skip_slab: bool, lane_seed: bool,
                 tile: int | None = None,
                 timers: torch.Tensor | None = None,
                 cond: torch.Tensor | None = None,
                 gcond: torch.Tensor | None = None,
                 head_from: int = 0) -> torch.Tensor:
    """Launch the kernel on the current stream with the contract of
    :func:`batched_plain` (no gaps): steps before ``head_from`` run
    without the head. ``tile`` lanes per cluster, one of
    ``TILES``: callers leave it to :func:`default_tile`; the tests and
    ``chip_smoke.py``'s sweep set it. Every lane's classes and ring are
    bitwise the same at any tile width. The ring's dtype (f32, bf16 or
    int8) picks the kernel; ``w`` must have been prepared for it
    (:func:`prepare_weights`). Raises on operands that do not match
    ``cfg`` (the kernel would read out of bounds), on a width, config or
    ring dtype the kernel does not take, and if the launch fails.
    ``timers``, an int64 ``(len(PHASES),)`` tensor on the device, receives
    the ns the first block spends in each of ``PHASES`` over the call (a
    headless step adds to the chain's phases, "ring writes + end1" and
    "sampling" only)."""
    global launches, headless_launches
    fuse_res = fuse_res and cfg.num_layers > 1
    if prime.dim() != 2:
        raise ValueError(f"prime must be (streams, num_given), not "
                         f"{tuple(prime.shape)}")
    streams, num_given = prime.shape
    if streams < 1 or num_given < 1 or total < 1:
        raise ValueError(f"{streams} streams, {num_given} prime classes and "
                         f"{total} steps: the kernel needs at least one of "
                         f"each")
    check_head_from(head_from, num_given)
    if t0 < 0 or t0 + total >= 2**31:
        raise ValueError("absolute steps must lie in [0, 2**31)")
    if tile is not None and tile not in TILES:
        raise ValueError(f"tile {tile}: the kernel is compiled for {TILES} "
                         f"lanes per cluster")
    rows = 0 if cond is None else cfg.cond_channels
    rdt = _check_ring_dtype(w, ring)
    k1.cluster_fits(cfg, tile or TILES[0], CLUSTER, fuse_res, rows)
    shapes = operand_shapes(cfg, fuse_res, skip_slab)
    if rdt == torch.int8:
        shapes["qscale"] = (cfg.num_layers,)
    L, D, M = cfg.num_layers, cfg.dilation_channels, cfg.cond_channels
    extra = {}
    if cond is not None:
        if M == 0:
            raise ValueError("cond given but cfg.cond_channels == 0")
        shapes["w_cond"] = (L, M, 2 * D)
        extra["cond"] = (cond, (total, M, streams))
    if gcond is not None:
        extra["gcond"] = (gcond, (L, 2 * D, streams))
    for name, (x, shape) in extra.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, not "
                             f"{tuple(x.shape)}")
    for name, shape in shapes.items():
        x = w.get(name)
        if x is None or tuple(x.shape) != shape:
            raise ValueError(f"weight {name} must have shape {shape}, not "
                             f"{None if x is None else tuple(x.shape)}")
    if tuple(ring.shape) != (ring_rows(cfg), streams):
        raise ValueError(f"ring must be {(ring_rows(cfg), streams)}, not "
                         f"{tuple(ring.shape)}")
    for name, x, dt in (("temps", temps, torch.float32),
                        ("seeds", seeds, torch.int32),
                        ("toffs", toffs, torch.int32)):
        if tuple(x.shape) != (streams,) or x.dtype != dt:
            raise ValueError(f"{name} must be ({streams},) {dt}")
    dev = prime.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {dev}")
    for name in shapes:
        x = w[name]
        dt = torch.int32 if name == "meta" else torch.float32
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"weight {name} must be contiguous {dt} on {dev}")
    for name, x in [("ring", ring), ("temps", temps), ("seeds", seeds),
                    ("toffs", toffs)] + [(n, x) for n, (x, _) in
                                         extra.items()]:
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    for name, (x, _) in extra.items():
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be f32")
    if ring.data_ptr() % 4:
        raise ValueError("the ring's data must be 4-byte aligned")
    if prime.dtype != torch.int32 or not prime.is_contiguous():
        raise ValueError("prime must be contiguous int32")
    if tile is None:
        tile = default_tile(streams, cfg, fuse_res, lambda t: (
            max_active_clusters(cfg, t, fuse_res, skip_slab, rows, rdt)),
            rows)
    if timers is not None and (tuple(timers.shape) != (len(PHASES),)
                               or timers.device != dev
                               or timers.dtype != torch.int64):
        raise ValueError(f"timers must be ({len(PHASES)},) int64 on {dev}")
    out = _launch(w, cfg, prime, ring, t0, total, temps, seeds, toffs, seed,
                  regularize, fuse_res, skip_slab, lane_seed, tile,
                  timers=timers, cond=cond, gcond=gcond, head_from=head_from)
    launches += 1
    headless_launches += int(head_from > 0)
    return out


def run_batched(w: dict, cfg: WaveNetConfig, prime: torch.Tensor,
                ring: torch.Tensor, t0: int, total: int, temps: torch.Tensor,
                seeds: torch.Tensor, toffs: torch.Tensor, seed: int,
                regularize: float, fuse_res: bool, skip_slab: bool,
                lane_seed: bool, cond: torch.Tensor | None = None,
                gcond: torch.Tensor | None = None,
                head_from: int = 0) -> torch.Tensor:
    """The plain version for tensors on the CPU, the kernel for CUDA
    tensors (which raises rather than fall back): the wide-chain kernel
    for weights prepared for it (:func:`is_wide`), else K4."""
    if prime.device.type != "cpu" and is_wide(w):
        if gcond is not None:
            raise ValueError("the wide-chain kernel takes no global "
                             "conditioning")
        return kw.wide_cuda(w, cfg, prime, ring, t0, total, temps, seeds,
                            toffs, seed, regularize, lane_seed, cond=cond,
                            head_from=head_from)
    run = batched_plain if prime.device.type == "cpu" else batched_cuda
    return run(w, cfg, prime, ring, t0, total, temps, seeds, toffs, seed,
               regularize, fuse_res, skip_slab, lane_seed, cond=cond,
               gcond=gcond, head_from=head_from)


# ----------------------------------------------------------------- wrapper


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _int32_bits(x) -> np.ndarray:
    """Integers wrapped into int32, as the JAX package's ``jnp.asarray(x,
    jnp.int32)`` leaves a seed or a clock."""
    return (_host(x).astype(np.int64) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32)


def _lane_row(x, streams: int, dtype, name: str, device) -> torch.Tensor:
    t = torch.as_tensor(_host(x)).to(device=device, dtype=dtype)
    if tuple(t.shape) != (streams,):
        raise ValueError(f"{name} must have shape ({streams},), not "
                         f"{tuple(t.shape)}")
    return t.contiguous()


@torch.no_grad()
def generate_fast_batched(params: Params, cfg: WaveNetConfig,
                          generator_or_seed=None, num_samples: int = 1,
                          first_samples=None, temperature=1.0,
                          regularize: float = 0.0,
                          state: HbmGenState | None = None,
                          return_state: bool = False, fuse_res: bool = False,
                          skip_slab: bool = False, lane_seed=None,
                          lane_clock=None,
                          device: str | torch.device = "cuda",
                          cond=None, global_cond=None,
                          ring_dtype=torch.float32, ring_scales=None):
    """Batched generation for any number of streams, the contract of the
    JAX package's ``generate_fast_batched``.

    ``ring_dtype``: f32, bf16 or int8 (the module docstring); int8 takes
    per-layer ``ring_scales`` ``(L,)`` from :func:`calibrate_ring_scales`,
    and a chunked rollout must pass the same scales with every chunk. A
    resumed ``state`` keeps its ring's dtype, which must be
    ``ring_dtype``.

    ``cond`` ``(streams, num_given - 1 + num_samples, M)``: row t
    conditions the step that consumes input sample t (a resumed call takes
    its own ``num_samples`` rows); ``global_cond`` ``(streams, G)``.

    ``first_samples`` int ``(streams, num_given)`` (or ``(num_given,)``,
    default one mid-class sample). Returns ``(waveform (streams,
    num_samples) f32, classes (streams, num_samples) int32)``, plus an
    :class:`HbmGenState` with ``return_state``; passing it back
    (``first_samples=None``) continues every stream (the caller's state is
    left as it was).

    ``temperature``: a scalar or a per-stream ``(streams,)`` array; lanes
    with temperature <= 0 take the argmax. ``lane_seed`` ``(streams,)``
    int32 keys each stream's noise by its own seed and request-local step
    (``ta + lane_clock``, ``lane_clock`` default zeros), so a stream's
    rollout is the same whatever shares the call; a scalar temperature is
    broadcast. Without ``lane_seed``, ``generator_or_seed`` (int,
    ``torch.Generator`` or None = 0) keys one noise for the call.

    The ``num_given - 1`` teacher-forced steps of a prime run without the
    head (``head_from``): the ring and the returned classes are those of a
    call with the head on every step, bitwise.

    On ``device="cpu"`` this runs :func:`batched_plain`; on a CUDA device
    it launches the kernel: K4, or the wide-chain kernel where the config
    needs it (``gen_kernel_wide.wide_needed``: the kernel-2 input, or a
    chain no tile of K4 holds)."""
    if lane_clock is not None and lane_seed is None:
        raise ValueError("lane_clock only rebases the lane_seed noise "
                         "counters: pass lane_seed too")
    dev = resolve_device(device)
    params = params_to(params, dev)
    C = cfg.classes
    rows = ring_rows(cfg)
    if state is not None:
        if first_samples is not None:
            raise ValueError("pass either first_samples or state, not both")
        prime = state.cls.to(dev, torch.int32).reshape(-1, 1)
        t0 = int(state.t)
        if tuple(state.ring.shape) != (rows, prime.shape[0]):
            raise ValueError(f"state ring {tuple(state.ring.shape)} does not "
                             f"match the config and {prime.shape[0]} streams")
        if state.ring.dtype != ring_dtype:
            raise ValueError(f"the state's ring is {state.ring.dtype}, not "
                             f"ring_dtype {ring_dtype}: a ring keeps its "
                             f"dtype across calls")
        ring = state.ring.to(dev).clone()
    else:
        if first_samples is None:
            first_samples = torch.full((1, 1), C // 2, dtype=torch.int32)
        prime = torch.as_tensor(_host(first_samples)).to(dev, torch.int32)
        if prime.dim() == 1:
            prime = prime.reshape(1, -1)
        t0 = 0
        ring = None
    prime = prime.contiguous()
    if prime.dim() != 2:
        raise ValueError("first_samples must be (streams, num_given)")
    streams, num_given = prime.shape
    total = num_given - 1 + num_samples
    if streams < 1 or num_given < 1 or num_samples < 1:
        raise ValueError("need at least one stream, one prime class and one "
                         "sample")
    if t0 + total >= 2**31:
        raise ValueError("absolute step count overflows int32")
    if bool(((prime < 0) | (prime >= C)).any()):
        raise ValueError(f"prime classes must lie in [0, {C})")
    if ring is None:  # uninitialised: the taps are predicated on ta >= m
        ring = torch.empty((rows, streams), dtype=ring_dtype, device=dev)

    if _host(temperature).ndim == 0:
        temps = torch.full((streams,), float(temperature),
                           dtype=torch.float32, device=dev)
    else:
        temps = _lane_row(temperature, streams, torch.float32,
                          "temperature", dev)
    if lane_seed is not None:
        seeds = _lane_row(_int32_bits(lane_seed), streams, torch.int32,
                          "lane_seed", dev)
        toffs = (torch.zeros_like(seeds) if lane_clock is None else
                 _lane_row(_int32_bits(lane_clock), streams, torch.int32,
                           "lane_clock", dev))
    else:
        seeds = toffs = torch.zeros((streams,), dtype=torch.int32,
                                    device=dev)
    w = prepare_weights(params, cfg, fuse_res, skip_slab, ring_dtype,
                        ring_scales)
    if cond is not None:
        from ...models.wavenet import check_cond

        cond = torch.as_tensor(cond).to(device=dev, dtype=torch.float32)
        check_cond(cfg, (streams, total), cond, None)
        cond = cond.permute(1, 2, 0).contiguous()  # (total, M, streams)
    gcond = project_gcond(w, cfg, global_cond, streams)
    all_cls = run_batched(w, cfg, prime, ring, t0, total, temps, seeds,
                          toffs, _seed_from(generator_or_seed), regularize,
                          fuse_res, skip_slab, lane_seed is not None,
                          cond=cond, gcond=gcond, head_from=num_given - 1)

    cls = all_cls[:, num_given - 1:total]
    wav = classes_to_waveform(cls, C)
    if not return_state:
        return wav, cls
    return wav, cls, HbmGenState(ring=ring, t=t0 + total,
                                 cls=all_cls[:, total - 1].clone())


def calibrate_ring_scales(params: Params, cfg: WaveNetConfig,
                          first_samples, num_samples: int = 256,
                          margin: float = 1.05, **kwargs) -> torch.Tensor:
    """Per-layer ``|h|`` scales ``(L,)`` f32 for int8 rings, as the JAX
    package's ``calibrate_ring_scales``: a bf16-ring rollout (greedy unless
    ``temperature`` is given; ``kwargs`` go to
    :func:`generate_fast_batched`, ``device`` among them), then each
    layer's max ``|ring|`` over its whole period window, floored at 1e-3,
    times ``margin``. The rollout must write every ring slot (taps are
    predicated, slots start uninitialised), so the clip ``num_given - 1 +
    num_samples`` must reach the longest period; a receptive-field prime
    always does. A chunked rollout reuses one calibration for the life of
    its ring."""
    prime = _host(first_samples)
    total = np.atleast_2d(prime).shape[1] - 1 + num_samples
    max_period = max(periods(cfg))
    if total < max_period:
        raise ValueError(
            f"calibration needs >= {max_period} total steps to write every "
            f"ring slot, got {total}: prime with a receptive-field window")
    kwargs.setdefault("temperature", 0.0)
    _, _, st = generate_fast_batched(
        params, cfg, num_samples=num_samples, first_samples=prime,
        return_state=True, ring_dtype=torch.bfloat16, **kwargs)
    ring = np.abs(st.ring.float().cpu().numpy())
    R, off = cfg.residual_channels, ring_offsets(cfg)
    peak = np.array([ring[off[l] * R:(off[l] + P) * R].max()
                     for l, P in enumerate(periods(cfg))], np.float32)
    return torch.from_numpy(np.maximum(peak, np.float32(1e-3))
                            * np.float32(margin))
