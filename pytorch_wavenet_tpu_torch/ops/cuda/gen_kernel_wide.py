"""Batched many-stream generation for a wide chain: the CUDA kernel KW and
its wrapper.

K4's cluster core (``gen_kernel_hbm.py``) keeps a tile's chain weights in
the shared memory of its cluster; at the published vocoder widths (the
``wnv512`` preset: R = D = 512, 30 layers, 178 MB of weights) no tile
fits, and the kernel-2 input (``cfg.input_kernel`` 2) is not in it at all.
There :func:`~pytorch_wavenet_tpu_torch.ops.cuda.gen_kernel_hbm.run_batched`
launches this kernel (``csrc/gen_kernel_wide.cu``, whose source says what
bounds it and what its design does about that): one persistent
cooperative launch a call that walks the steps and layers, each layer's
two products split over every SM with the pool's lanes as the tensor
cores' N, so all lanes share one read of the weights a step. It computes
the function of K4's plain version ``gen_kernel_hbm.batched_plain`` (which
the CPU runs, and which states the semantics): the same ring layout, taps,
conditioning rows, ``head_from``, sampling and counter-hash noise; f32
rings only, no global conditioning; ``fuse_res`` and ``skip_slab`` (the
cluster core's reassociations) do not apply. Every product sums in an
order fixed by the config alone, so a lane's classes and ring are the same
bits at any lane count or grid size.

``launches`` counts the kernel's launches; :func:`wide_needed` says when a
config takes this kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...config import WaveNetConfig
from . import gen_kernel as k1

launches = 0

# the kernel's tile: rows x lanes, and the depth of a pipeline stage
BM, BN, KC = 32, 64, 64
# the phases of a call that ``timers`` receives, in ns (block 0's view)
PHASES = ("gate products", "residual + skip products", "grid barriers",
          "input rows", "end1", "end2", "sampling")


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


@functools.lru_cache(maxsize=None)
def wide_needed(cfg: WaveNetConfig) -> bool:
    """The config takes this kernel: it has the kernel-2 input, or no tile
    width of K4's cluster core fits a block with local conditioning's
    slab (cached: every generation call asks)."""
    if cfg.input_kernel != 1:
        return True
    from .gen_kernel_hbm import CLUSTER, TILES

    return all(k1.shared_bytes_for(cfg, t, CLUSTER, False,
                                   cfg.cond_channels)[0] > k1.SMEM_LIMIT
               for t in TILES)


def dims(cfg: WaveNetConfig) -> dict:
    """The padded sizes of the packed operands: gate rows in groups of 16
    channels (tanh rows, then sigmoid rows, of the same channels), K padded
    to the pipeline's depth, the residual and skip rows each padded to the
    tile's rows."""
    R, D, S = cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels
    E, C, M = cfg.end_channels, cfg.classes, cfg.cond_channels
    return dict(M1p=2 * _up(D, 16), K1p=_up(2 * R + M, KC), Rp=_up(R, BM),
                Sp=_up(S, BM), K2p=_up(D, KC), Ep=_up(E, BM), K3p=_up(S, KC),
                Cp=_up(C, BM), K4p=_up(E, KC))


def gate_rows(cfg: WaveNetConfig) -> torch.Tensor:
    """For each packed gate row, the column of the ``2D`` gate input it
    holds, or -1 for a padding row."""
    D = cfg.dilation_channels
    rows = []
    for c0 in range(0, _up(D, 16), 16):
        ch = torch.arange(c0, c0 + 16)
        rows += [torch.where(ch < D, ch, -1), torch.where(ch < D, ch + D, -1)]
    return torch.cat(rows)


def pack(w: dict, cfg: WaveNetConfig) -> dict:
    """The kernel's operands from ``gen_kernel_hbm.prepare_weights``'s
    (``w_tap``, ``b_in``, ``w_cond``, ``w_out``/``b_out``, the head):
    row-major ``(rows, K)`` f32 with zero padding. ``W1[l]`` row i holds
    gate input ``gate_rows(cfg)[i]`` over K = [tap R | h R | cond M];
    ``W2[l]`` holds the residual rows, then the skip rows; ``E1`` and
    ``E2`` are the head's transposes."""
    L, R, D = cfg.num_layers, cfg.residual_channels, cfg.dilation_channels
    S, E, C, M = (cfg.skip_channels, cfg.end_channels, cfg.classes,
                  cfg.cond_channels)
    dm = dims(cfg)
    dev, f32 = w["w_tap"].device, torch.float32
    zeros = lambda *s: torch.zeros(s, dtype=f32, device=dev)  # noqa: E731
    rows = gate_rows(cfg).to(dev)
    keep = rows >= 0
    W1 = zeros(L, dm["M1p"], dm["K1p"])
    full = torch.cat([w["w_tap"][:, 0], w["w_tap"][:, 1]]
                     + ([w["w_cond"]] if M else []), dim=1)  # (L, K1, 2D)
    W1[:, keep, :full.shape[1]] = full.transpose(1, 2)[:, rows[keep]]
    b1 = zeros(L, dm["M1p"])
    b1[:, keep] = w["b_in"][:, rows[keep]]
    Rp, Sp = dm["Rp"], dm["Sp"]
    W2 = zeros(L, Rp + Sp, dm["K2p"])
    b2 = zeros(L, Rp + Sp)
    wo, bo = w["w_out"], w["b_out"]  # (L, D, S + R): skip | res
    W2[:, :R, :D] = wo[:, :, S:].transpose(1, 2)
    W2[:, Rp:Rp + S, :D] = wo[:, :, :S].transpose(1, 2)
    b2[:, :R], b2[:, Rp:Rp + S] = bo[:, S:], bo[:, :S]
    E1 = zeros(dm["Ep"], dm["K3p"])
    E1[:E, :S] = w["w_end1"].T
    be1 = zeros(dm["Ep"])
    be1[:E] = w["b_end1"]
    E2 = zeros(dm["Cp"], dm["K4p"])
    E2[:C, :E] = w["w_end2"].T
    be2 = zeros(dm["Cp"])
    be2[:C] = w["b_end2"]
    return dict(W1=W1, b1=b1, W2=W2, b2=b2, E1=E1, be1=be1, E2=E2, be2=be2)


_PTR = ctypes.c_void_p


def _bind():
    from .build import load

    lib = load("gen_kernel_wide")
    fn = lib.wavenet_gen_wide
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_PTR), ctypes.POINTER(ctypes.c_int),
                       ctypes.c_float, _PTR]
        fn.restype = ctypes.c_int
    return lib


def wide_cuda(w: dict, cfg: WaveNetConfig, prime: torch.Tensor,
              ring: torch.Tensor, t0: int, total: int, temps: torch.Tensor,
              seeds: torch.Tensor, toffs: torch.Tensor, seed: int,
              regularize: float, lane_seed: bool,
              cond: torch.Tensor | None = None, head_from: int = 0,
              timers: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on the current stream with the contract of
    ``gen_kernel_hbm.batched_plain`` (f32 rings, no ``gcond``): returns the
    classes ``(streams, total)`` int32 and updates ``ring`` in place.
    ``w`` is ``prepare_weights``' dict for the config (packed here at first
    use, under ``"wide"``). ``timers``, int64 ``(len(PHASES),)`` on the
    device, receives the ns block 0 spends in each phase. Raises on
    operands the kernel does not take and if the launch fails."""
    global launches
    from .gen_kernel_hbm import ring_rows

    streams, num_given = prime.shape
    k1.check_head_from(head_from, num_given)
    dev = prime.device
    if dev.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {dev}")
    if ring.dtype != torch.float32:
        raise ValueError("the wide kernel takes f32 rings only")
    if tuple(ring.shape) != (ring_rows(cfg), streams):
        raise ValueError(f"ring must be {(ring_rows(cfg), streams)}, not "
                         f"{tuple(ring.shape)}")
    if cfg.classes > 2**24:
        raise ValueError("the ring's previous-class row holds classes "
                         "below 2**24")
    if t0 < 0 or t0 + total >= 2**31 or total < 1:
        raise ValueError("steps must lie in [0, 2**31) and total >= 1")
    M = cfg.cond_channels
    if cond is not None and tuple(cond.shape) != (total, M, streams):
        raise ValueError(f"cond must have shape {(total, M, streams)}, not "
                         f"{tuple(cond.shape)}")
    for name, x, dt in (("prime", prime, torch.int32),
                        ("temps", temps, torch.float32),
                        ("seeds", seeds, torch.int32),
                        ("toffs", toffs, torch.int32), ("ring", ring, None),
                        ("cond", cond, torch.float32)):
        if x is None:
            continue
        if x.device != dev or not x.is_contiguous() or (
                dt is not None and x.dtype != dt):
            raise ValueError(f"{name} must be contiguous {dt or ''} on {dev}")
    if streams % 4:
        # the kernel copies the lanes' rows in 16-byte pieces: run padded
        # to a multiple of 4 lanes and drop the scratch lanes (a lane's
        # bits do not depend on the lane count)
        k = -streams % 4
        F = torch.nn.functional
        ring_p = F.pad(ring, (0, k))
        out = wide_cuda(
            w, cfg, F.pad(prime, (0, 0, 0, k)), ring_p, t0, total,
            F.pad(temps, (0, k)), F.pad(seeds, (0, k)), F.pad(toffs, (0, k)),
            seed, regularize, lane_seed,
            cond=None if cond is None else F.pad(cond, (0, k)),
            head_from=head_from, timers=timers)
        ring.copy_(ring_p[:, :streams])
        return out[:streams]
    if w.get("wide") is None:
        w["wide"] = pack(w, cfg)
    p = w["wide"]
    dm = dims(cfg)
    D, S, E, C = (cfg.dilation_channels, cfg.skip_channels,
                  cfg.end_channels, cfg.classes)
    f32 = torch.float32
    out = torch.empty((streams, total), dtype=torch.int32, device=dev)
    scratch = {n: torch.empty(shape, dtype=f32, device=dev)
               for n, shape in (("U", (D, streams)), ("skip", (S, streams)),
                                ("Y", (E, streams)),
                                ("logits", (streams, C)))}
    cur = torch.empty((streams,), dtype=torch.int32, device=dev)
    bar = torch.empty((1,), dtype=torch.int64, device=dev)
    if timers is not None and (tuple(timers.shape) != (len(PHASES),)
                               or timers.dtype != torch.int64
                               or timers.device != dev):
        raise ValueError(f"timers must be ({len(PHASES)},) int64 on {dev}")
    prev = w.get("w_prev")
    ptrs = [None if prev is None else prev.data_ptr(),
            w["w_start"].data_ptr(), w["b_start"].data_ptr(),
            *(p[n].data_ptr() for n in ("W1", "b1", "W2", "b2", "E1", "be1",
                                        "E2", "be2")),
            None if cond is None else cond.data_ptr(), temps.data_ptr(),
            seeds.data_ptr(), toffs.data_ptr(), prime.data_ptr(),
            w["meta"].data_ptr(), ring.data_ptr(), out.data_ptr(),
            *(scratch[n].data_ptr() for n in ("U", "skip", "Y", "logits")),
            cur.data_ptr(), bar.data_ptr(),
            None if timers is None else timers.data_ptr()]
    extra = ring_rows(cfg) - 1 if cfg.input_kernel == 2 else -1
    ints = [streams, num_given, total, t0, cfg.num_layers,
            cfg.residual_channels, D, S, E, C, M, dm["M1p"], dm["K1p"],
            dm["Rp"], dm["Sp"], dm["K2p"], dm["Ep"], dm["K3p"], dm["Cp"],
            dm["K4p"], extra, int(seed) & 0x7FFFFFFF, int(bool(lane_seed)),
            int(head_from)]
    lib = _bind()
    err = lib.wavenet_gen_wide(
        (_PTR * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
        float(regularize), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gen_kernel_wide launch failed: error {err}")
    launches += 1
    return out
