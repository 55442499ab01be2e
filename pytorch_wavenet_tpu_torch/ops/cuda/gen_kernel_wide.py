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
two products split into tiles of 64 lanes x 32 weight rows (the lanes on
wgmma's M) over every SM, in clusters of 2 along the rows that load each
stage of the lanes' rows once between them, so all lanes share one read
of the weights a step. A producer warpgroup fills a 6-stage ring with bulk
copies under mbarriers; two consumer warpgroups, each on half of every
stage's depth, split the lanes' values into TF32 hi and lo in registers
and multiply them by the weights' hi and lo, which :func:`pack` splits
once on the host (so the kernel reads twice the weights' bytes: 356 MB a
``wnv512`` step). The grid barriers are split: the consumers arrive and
go on, a producer waits before copying what the phase before wrote, and
the gate's K runs tap, conditioning rows, h (:func:`k_parts`) so its taps
and conditioning rows load before the barrier. Tile plan by lane count: tiles
of 64 lanes, the last ragged, the streams padded to a multiple of 4;
clusters of 2, or 1 where that takes fewer rounds.

It computes the function of K4's plain version
``gen_kernel_hbm.batched_plain`` (which the CPU runs, and which states the
semantics): the same ring layout, taps, conditioning rows, ``head_from``,
sampling and counter-hash noise; f32 rings only, no global conditioning;
``fuse_res`` and ``skip_slab`` (the cluster core's reassociations) do not
apply. Every product sums its 8-deep steps in order over the padded depth,
its three terms (a_lo b_hi, a_hi b_lo, a_hi b_hi) apart until the end, an
order fixed by the config alone, so a lane's classes and ring are the same
bits at any lane count, tile, cluster or grid size.

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

# the kernel's tile: lanes x weight rows, and the depth of a stage
BL, BR, KC = 64, 32, 64
# within each 8-deep wgmma step, the stage row that logical k reads: the
# kernel's lanes' values for k = t come from row 2t, for k = t + 4 from
# row 2t + 1 (conflict-free reads of the swizzled boxes)
K_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
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
    """The padded sizes of the packed operands: gate rows in tiles of 8
    channels (tanh rows, then sigmoid rows, of the same channels), every
    other product's rows (the residual and skip rows each) padded to the
    tile's rows; K is made of parts (the gate's tap, h and cond rows), each
    padded to the depth of a stage, so a stage reads one part."""
    R, D, S = cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels
    E, C, M = cfg.end_channels, cfg.classes, cfg.cond_channels
    return dict(M1p=2 * _up(D, BR // 2), K1p=2 * _up(R, KC) + _up(M, KC),
                Rp=_up(R, BR), Sp=_up(S, BR), K2p=_up(D, KC), Ep=_up(E, BR),
                K3p=_up(S, KC), Cp=_up(C, BR), K4p=_up(E, KC))


def gate_rows(cfg: WaveNetConfig) -> torch.Tensor:
    """For each packed gate row, the column of the ``2D`` gate input it
    holds, or -1 for a padding row."""
    D, h = cfg.dilation_channels, 8
    rows = []
    for c0 in range(0, _up(D, BR // 2), h):
        ch = torch.arange(c0, c0 + h)
        rows += [torch.where(ch < D, ch, -1), torch.where(ch < D, ch + D, -1)]
    return torch.cat(rows)


def pack_rows(w: dict, cfg: WaveNetConfig) -> dict:
    """The kernel's operands from ``gen_kernel_hbm.prepare_weights``'s
    (``w_tap``, ``b_in``, ``w_cond``, ``w_out``/``b_out``, the head) as
    row-major ``(rows, K)`` f32 with zero padding, before :func:`pack`
    orders, splits and tiles them. ``W1[l]`` row i holds gate input
    ``gate_rows(cfg)[i]`` over K = [tap R | cond M | h R], each part
    starting at a multiple of ``KC`` (:func:`k_parts`); ``W2[l]`` holds
    the residual rows, then the skip rows; ``E1`` and ``E2`` are the
    head's transposes."""
    L, R, D = cfg.num_layers, cfg.residual_channels, cfg.dilation_channels
    S, E, C, M = (cfg.skip_channels, cfg.end_channels, cfg.classes,
                  cfg.cond_channels)
    dm = dims(cfg)
    dev, f32 = w["w_tap"].device, torch.float32
    zeros = lambda *s: torch.zeros(s, dtype=f32, device=dev)  # noqa: E731
    rows = gate_rows(cfg).to(dev)
    keep = rows >= 0
    W1 = zeros(L, dm["M1p"], dm["K1p"])
    parts = [w["w_tap"][:, 0], w["w_tap"][:, 1]] + ([w["w_cond"]] if M else [])
    for k0, part in zip(k_parts(cfg), parts):  # part (L, n, 2D)
        W1[:, keep, k0:k0 + part.shape[1]] = part.transpose(1, 2)[:, rows[keep]]
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


def k_parts(cfg: WaveNetConfig) -> tuple[int, ...]:
    """Where the gate product's parts (tap, h, cond) start in its K, which
    runs tap, cond, h: the kernel copies the parts no earlier phase wrote
    (the taps, the conditioning rows) before the grid barrier that h
    waits for."""
    r = _up(cfg.residual_channels, KC)
    return (0, r + _up(cfg.cond_channels, KC), r)


def k_order(m: torch.Tensor) -> torch.Tensor:
    """``(..., K)`` with each 8 columns in the kernel's order
    (``K_ORDER``): column 8b + j takes column 8b + K_ORDER[j]."""
    *lead, k = m.shape
    idx = torch.tensor(K_ORDER, device=m.device)
    return m.reshape(*lead, k // 8, 8)[..., idx].reshape(*lead, k)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (f32) as hi + lo, both f32: hi rounded to TF32's 10 mantissa
    bits (ties away from zero, the kernel's ``tf32_split`` in
    ``csrc/tf32.cuh``), lo = x - hi, which is exact."""
    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0x1000) & 0xFFFFE000
    hi = torch.where(b >= 2**31, b - 2**32, b).to(torch.int32).view(
        torch.float32)
    return hi, x - hi


def tile(m: torch.Tensor) -> torch.Tensor:
    """Row-major ``(..., rows, K)`` (rows a multiple of 8, K of ``KC``) as
    the kernel reads it: ``(..., K / KC, rows / 8, KC / 4, 8, 4)``, each
    stage's 8-row groups the K-major core matrices (8 rows x 4 k, 128
    contiguous bytes) of wgmma's B operand, so a tile's 16 rows of a stage
    are one contiguous 4 KB copy."""
    *lead, rows, k = m.shape
    t = m.reshape(*lead, rows // 8, 8, k // KC, KC // 4, 4)
    n = len(lead)
    return t.permute(*range(n), n + 2, n, n + 3, n + 1, n + 4).contiguous()


def untile(t: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`tile`."""
    *lead, ks, groups, cores, _, _ = t.shape
    n = len(lead)
    return t.permute(*range(n), n + 1, n + 3, n, n + 2, n + 4).reshape(
        *lead, groups * 8, ks * cores * 4)


def pack(w: dict, cfg: WaveNetConfig) -> dict:
    """:func:`pack_rows`' operands as the kernel reads them: each product's
    weights with K in the kernel's order (:func:`k_order`), split into TF32
    hi and lo (:func:`tf32_split`) and tiled (:func:`tile`), stacked on a
    new axis before the rows' (``W1`` is ``(L, 2, K1p / KC, M1p / 8, KC /
    4, 8, 4)``, hi then lo); the biases as they are."""
    p = pack_rows(w, cfg)
    for n in ("W1", "W2", "E1", "E2"):
        hi, lo = tf32_split(k_order(p[n]))
        p[n] = torch.stack([tile(hi), tile(lo)], dim=p[n].dim() - 2)
    return p


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
    from .gen_kernel import periods
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
    slots = sum(periods(cfg))
    ints = [streams, num_given, total, t0, cfg.num_layers,
            cfg.residual_channels, D, S, E, C, M, dm["M1p"], dm["K1p"],
            dm["Rp"], dm["Sp"], dm["K2p"], dm["Ep"], dm["K3p"], dm["Cp"],
            dm["K4p"], extra, int(seed) & 0x7FFFFFFF, int(bool(lane_seed)),
            int(head_from), slots]
    lib = _bind()
    err = lib.wavenet_gen_wide(
        (_PTR * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
        float(regularize), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gen_kernel_wide launch failed: error {err}")
    launches += 1
    return out
