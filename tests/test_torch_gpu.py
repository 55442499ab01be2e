"""The CUDA kernels K1, K4, K2 and K3 (K2/K3 also with local conditioning)
against their plain versions, on a card (marked ``gpu``; each test skips
without one).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch: ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (``--noconftest``: the suite's conftest imports
JAX)."""

import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel as gk
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as ghbm
from pytorch_wavenet_tpu_torch.ops.cuda import trunk_kernel as tk


def _prime(cfg, streams, seed, length=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.classes,
                        (streams, length or cfg.receptive_field))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip; see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tiny", "test_small"])
@pytest.mark.parametrize("fuse_res", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_kernel_matches_plain_on_card(card, name, fuse_res, temperature):
    """Teacher-forced classes agree except at near-ties of the plain
    version's scores (the two sum in different orders; 1e-4 is far above
    f32 rounding of these logits)."""
    cfg = pt.get_config(name)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), card)
    w = gk.prepare_weights(params, cfg, fuse_res)
    prime = torch.from_numpy(_prime(cfg, 3, 1, cfg.receptive_field + 40)).to(
        card, torch.int32)
    total = prime.shape[1] - 1 + 8
    size = sum(gk.periods(cfg)) * 3 * cfg.residual_channels
    rk = torch.zeros(size, device=card)
    rp = torch.zeros(size, device=card)
    before = gk.launches
    ck = gk.fused_cuda(w, cfg, prime, rk, 0, total, temperature, 0.05, 4,
                       fuse_res)
    torch.cuda.synchronize()
    assert gk.launches == before + 1
    cp, gaps = gk.fused_plain(w, cfg, prime, rp, 0, total, temperature, 0.05,
                              4, fuse_res, return_gaps=True)
    forced = slice(0, prime.shape[1] - 1)
    bad = (ck[:, forced] != cp[:, forced]) & (gaps[:, forced] >= 1e-4)
    assert not bool(bad.any())
    torch.testing.assert_close(rk, rp, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_kernel_resume_bitwise_on_card(card):
    cfg = pt.get_config("test_small")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(1), card)
    prime = _prime(cfg, 2, 2)
    kw = dict(temperature=1.0, fuse_res=True, device=card)
    _, c_all = pt.generate_fast_fused(params, cfg, 9, 300, prime, **kw)
    _, c1, st = pt.generate_fast_fused(params, cfg, 9, 100, prime,
                                       return_state=True, **kw)
    _, c2, st = pt.generate_fast_fused(params, cfg, 9, 150, None, state=st,
                                       return_state=True, **kw)
    _, c3 = pt.generate_fast_fused(params, cfg, 9, 50, None, state=st, **kw)
    assert torch.equal(torch.cat([c1, c2, c3], dim=1), c_all)


# ------------------------------------------------------------------ K4

K4_VARIANTS = {"exact": (False, False), "fuse_res": (True, False),
               "skip_slab": (False, True), "fuse_res_skip_slab": (True, True)}


def _k4_case(card, name, lanes, temperature, seed=0):
    cfg = pt.get_config(name)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(seed), card)
    temps = torch.full((lanes,), temperature, device=card)
    temps[::3] = 0.0  # greedy lanes beside hot ones
    seeds = torch.arange(lanes, dtype=torch.int32, device=card) * 7 - 3
    toffs = torch.arange(lanes, dtype=torch.int32, device=card) % 5
    return cfg, params, temps, seeds, toffs


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tiny", "test_small"])
@pytest.mark.parametrize("variant", sorted(K4_VARIANTS))
@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("lanes", [1, 3, 130])
def test_k4_matches_plain_on_card(card, name, variant, temperature, lanes):
    """Teacher-forced classes agree except at near-ties of the plain
    version's scores (top-2 gap < 1e-4: the two sum in different orders);
    rings within 1e-4."""
    fuse, slab = K4_VARIANTS[variant]
    cfg, params, temps, seeds, toffs = _k4_case(card, name, lanes,
                                                temperature)
    w = ghbm.prepare_weights(params, cfg, fuse, slab)
    prime = torch.from_numpy(_prime(cfg, lanes, 1, cfg.receptive_field + 40)
                             ).to(card, torch.int32)
    total = prime.shape[1] - 1 + 8
    rk = torch.zeros(ghbm.ring_rows(cfg), lanes, device=card)
    rp = rk.clone()
    before = ghbm.launches
    ck = ghbm.batched_cuda(w, cfg, prime, rk, 0, total, temps, seeds, toffs,
                           4, 0.05, fuse, slab, True)
    torch.cuda.synchronize()
    assert ghbm.launches == before + 1
    cp, gaps = ghbm.batched_plain(w, cfg, prime, rp, 0, total, temps, seeds,
                                  toffs, 4, 0.05, fuse, slab, True,
                                  return_gaps=True)
    forced = slice(0, prime.shape[1] - 1)
    bad = (ck[:, forced] != cp[:, forced]) & (gaps[:, forced] >= 1e-4)
    assert not bool(bad.any())
    torch.testing.assert_close(rk, rp, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", ghbm.TILES)
def test_k4_tiles_and_one_seed_noise_on_card(card, tile):
    """Every compiled width of lanes per cluster, with a tail tile (130
    lanes), and the one-seed noise keying agree with the plain version."""
    cfg, params, temps, seeds, toffs = _k4_case(card, "test_small", 130, 1.0)
    w = ghbm.prepare_weights(params, cfg, True, True)
    prime = torch.from_numpy(_prime(cfg, 130, 2, 48)).to(card, torch.int32)
    rk = torch.zeros(ghbm.ring_rows(cfg), 130, device=card)
    rp = rk.clone()
    ck = ghbm.batched_cuda(w, cfg, prime, rk, 0, 47 + 8, temps, seeds, toffs,
                           77, 0.0, True, True, False, tile=tile)
    torch.cuda.synchronize()
    cp, gaps = ghbm.batched_plain(w, cfg, prime, rp, 0, 47 + 8, temps, seeds,
                                  toffs, 77, 0.0, True, True, False,
                                  return_gaps=True)
    bad = (ck[:, :47] != cp[:, :47]) & (gaps[:, :47] >= 1e-4)
    assert not bool(bad.any())
    torch.testing.assert_close(rk, rp, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("fuse_res,skip_slab", [(False, False), (True, True)])
def test_k4_resume_bitwise_and_nan_rings_on_card(card, fuse_res, skip_slab):
    """Chunks resumed from the state equal one shot bitwise (classes and
    ring); a fresh call's taps are predicated, so a NaN-filled ring gives
    the classes of a zeroed one."""
    cfg = pt.get_config("test_small")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(1), card)
    prime = _prime(cfg, 3, 2)
    kw = dict(temperature=[0.9, 0.0, 1.0], lane_seed=[5, 6, 7],
              lane_clock=[0, 2, 9], fuse_res=fuse_res, skip_slab=skip_slab,
              device=card)
    _, c_all, s_all = pt.generate_fast_batched(params, cfg, 0, 300, prime,
                                               return_state=True, **kw)
    parts, st = [], None
    for i, n in enumerate((100, 150, 50)):
        _, c, st = pt.generate_fast_batched(
            params, cfg, 0, n, prime if i == 0 else None, state=st,
            return_state=True, **kw)
        parts.append(c)
    assert torch.equal(torch.cat(parts, dim=1), c_all)
    assert torch.equal(st.ring, s_all.ring)

    w = ghbm.prepare_weights(params, cfg, fuse_res, skip_slab)
    p2 = torch.from_numpy(prime[:, :2]).to(card, torch.int32).contiguous()
    lanes = (torch.tensor([0.9, 0.0, 1.0], device=card),
             torch.tensor([5, 6, 7], dtype=torch.int32, device=card),
             torch.zeros(3, dtype=torch.int32, device=card))
    out = []
    for fill in (float("nan"), 0.0):
        ring = torch.full((ghbm.ring_rows(cfg), 3), fill, device=card)
        out.append(ghbm.batched_cuda(w, cfg, p2, ring, 0, 64, *lanes, 0, 0.0,
                                     fuse_res, skip_slab, True))
    torch.cuda.synchronize()
    assert torch.equal(out[0], out[1])


def _roll_ring(cfg, ring, delta):
    """The ring as a call started ``delta`` steps later would hold it: each
    layer's slot s moves to (s + delta) mod P."""
    R, out = cfg.residual_channels, torch.empty_like(ring)
    for first, P in zip(ghbm.ring_offsets(cfg), ghbm.periods(cfg)):
        blk = ring[first * R:(first + P) * R].view(P, R, -1)
        out[first * R:(first + P) * R] = torch.roll(
            blk, delta % P, dims=0).reshape(P * R, -1)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("fuse_res,skip_slab", [(False, False), (True, True)])
@pytest.mark.parametrize("lanes", [3, 600])
def test_k4_fresh_call_equals_rollout_over_zeroed_history_on_card(
        card, fuse_res, skip_slab, lanes):
    """What the pool's exactness rests on: a fresh call from one class (a
    NaN-filled ring) equals, bitwise, the same rollout at t0 = max(period)
    over a zeroed ring with the same request-local noise clock (classes,
    and the ring rolled by t0). 3 lanes run 2-lane tiles, 600 lanes 4-lane
    tiles."""
    cfg, params, temps, seeds, toffs = _k4_case(card, "test_small", lanes,
                                                0.9)
    w = ghbm.prepare_weights(params, cfg, fuse_res, skip_slab)
    clock = max(ghbm.periods(cfg))
    n = clock + 40  # every slot written
    one = torch.from_numpy(_prime(cfg, lanes, 3, 1)).to(card, torch.int32)
    r_fresh = torch.full((ghbm.ring_rows(cfg), lanes), float("nan"),
                         device=card)
    c_fresh = ghbm.batched_cuda(w, cfg, one, r_fresh, 0, n, temps, seeds,
                                toffs, 0, 0.0, fuse_res, skip_slab, True)
    r_pool = torch.zeros_like(r_fresh)
    c_pool = ghbm.batched_cuda(w, cfg, one, r_pool, clock, n, temps, seeds,
                               toffs - clock, 0, 0.0, fuse_res, skip_slab,
                               True)
    torch.cuda.synchronize()
    assert torch.equal(c_fresh, c_pool)
    assert torch.equal(_roll_ring(cfg, r_fresh, clock), r_pool)


# ------------------------------------------------------------------ K2/K3

TRUNK_CASES = [  # (preset[:RxD], batch, kernel_size, bias, output_length)
    ("tiny", 3, 2, True, 1),
    ("tiny", 2, 3, True, 20),
    ("tiny", 3, 2, False, 128),
    ("test_small", 2, 2, False, 20),
    ("test_small", 3, 3, False, 128),
    ("test_small", 4, 2, True, 1024),
    ("chaconne_wide", 3, 2, True, 20),
    ("chaconne_wide", 2, 3, True, 128),
    ("chaconne_wide", 4, 2, False, 1024),
    # widths the tile core pads to multiples of 16 (10: 4-byte copies)
    ("test_small:12x20", 2, 2, True, 64),
    ("test_small:12x20", 3, 3, False, 20),
    ("test_small:10x14", 2, 2, True, 20),
    # R = D = 64: four times the shared weights (a 32-position K3 tile)
    ("chaconne_wide:64x64", 2, 2, True, 64),
    ("chaconne_wide:64x64", 3, 3, False, 128),
    # wider still: K3's partial sums in its slot in device memory (80),
    # both kernels' weights read from L2 (128)
    ("test_small:80x80", 2, 2, True, 64),
    ("test_small:128x128", 2, 2, True, 20),
]


def _trunk_config(name, **kw):
    """A preset, with ``name:RxD`` overriding its residual and dilation
    widths."""
    name, _, widths = name.partition(":")
    if widths:
        r, d = map(int, widths.split("x"))
        kw.update(residual_channels=r, dilation_channels=d)
    return pt.get_config(name, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("name,batch,k,bias,out_len", TRUNK_CASES)
@pytest.mark.parametrize("save_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_trunk_kernels_match_plain_on_card(card, name, batch, k, bias,
                                           out_len, save_dtype):
    """K2's units within 1e-5 x max(1, |u|) of the plain version; its saves
    agree with the plain version's on each layer's window; K3's gradients within
    1e-5 x max(1, scale) of the plain version on the same saves, and two K3
    calls bitwise equal (fixed-order reductions, no atomics)."""
    cfg = _trunk_config(name, kernel_size=k, bias=bias)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(2), card)
    T = cfg.receptive_field + out_len - 1
    rng = np.random.default_rng(5)
    h0 = torch.from_numpy(rng.uniform(-1, 1, (batch, T, cfg.residual_channels))
                          .astype(np.float32)).to(card)
    du = torch.from_numpy(rng.uniform(-1, 1, (batch, out_len, cfg.num_layers
                                              * cfg.dilation_channels))
                          .astype(np.float32) / (batch * out_len)).to(card)
    before = (tk.fwd_launches, tk.bwd_launches)
    uk, sk = tk.trunk_fwd_cuda(params, cfg, h0, out_len, save_dtype)
    gk = tk.trunk_bwd_cuda(params, cfg, sk, du, out_len)
    again = tk.trunk_bwd_cuda(params, cfg, sk, du, out_len)
    torch.cuda.synchronize()
    assert (tk.fwd_launches, tk.bwd_launches) == (before[0] + 1,
                                                  before[1] + 2)
    up, sp_ = tk.trunk_fwd_plain(params, cfg, h0, out_len, save_dtype)
    assert float(((uk - up).abs() / up.abs().clamp(min=1.0)).max()) <= 1e-5
    _, win = tk.windows(cfg, out_len)
    for l, lo in enumerate(win):
        # bf16: the two f32 streams differ by rounding, which may move a
        # save by one bf16 step (2**-8 relative)
        tol = 1e-2 if save_dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(sk[l][:, lo:].float(),
                                   sp_[l][:, lo:].float(), atol=tol, rtol=tol)
    gp = tk.trunk_bwd_plain(params, cfg, sk, du, out_len)  # K2's saves
    for a, b in zip(gk, gp):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))
    assert all(torch.equal(a, b) for a, b in zip(gk, again))


@pytest.mark.gpu
def test_trunk_bwd_repeats_bitwise_at_the_main_path_shapes(card):
    """Three K3 calls at chaconne_wide, batch 16, out 1024 (bf16 saves, the
    train step's) give bitwise-equal gradients: the partial slots and their
    reduction are fixed by the shapes, with no atomics."""
    cfg = pt.get_config("chaconne_wide")
    out_len, batch = 1024, 16
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(3), card)
    T = cfg.receptive_field + out_len - 1
    rng = np.random.default_rng(9)
    h0 = torch.from_numpy(rng.uniform(-1, 1, (batch, T, cfg.residual_channels))
                          .astype(np.float32)).to(card)
    du = torch.from_numpy(rng.uniform(-1, 1, (batch, out_len, cfg.num_layers
                                              * cfg.dilation_channels))
                          .astype(np.float32) / (batch * out_len)).to(card)
    _, saves = tk.trunk_fwd_cuda(params, cfg, h0, out_len)
    before = tk.bwd_launches
    runs = [tk.trunk_bwd_cuda(params, cfg, saves, du, out_len)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert tk.bwd_launches == before + 3
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    gp = tk.trunk_bwd_plain(params, cfg, saves, du, out_len)
    for a, b in zip(runs[0], gp):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


@pytest.mark.gpu
def test_trunk_train_step_on_card_equals_plain_model(card):
    """Gradients of a whole loss through K2/K3 (f32 saves) equal autograd
    of the plain model within 1e-5 x max(1, scale)."""
    import dataclasses
    import functools

    cfg = pt.get_config("test_small", output_length=64)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(4), card)
    leaves = [p.requires_grad_(True) for p in
              (params["start"]["w"], *params["layers"].values())]
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(0, cfg.classes, (3, cfg.item_length))
                         ).to(card)
    y = torch.from_numpy(rng.integers(0, cfg.classes, (3, 64))).to(card)

    def grads(c):
        return torch.autograd.grad(pt.cross_entropy_loss(params, c, x, y),
                                   leaves)

    ref = grads(cfg)
    orig = tk.fused_trunk
    try:
        tk.fused_trunk = functools.partial(orig, save_dtype=torch.float32)
        got = grads(dataclasses.replace(cfg, trunk_kernel=True))
    finally:
        tk.fused_trunk = orig
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


@pytest.mark.gpu
def test_trunk_launchers_refuse_what_the_kernels_do_not_take(card):
    """Local conditioning (and a model with global channels) passes, and so
    does a bf16 stream; an f16 stream, wrong shapes, a strided stream or
    cond, CPU tensors and a passed ``global_cond`` raise."""
    import dataclasses

    cfg = pt.get_config("tiny_vocoder", gcond_channels=4)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), card)
    T = cfg.receptive_field + 3
    h0 = torch.zeros((2, T, cfg.residual_channels), device=card)
    with pytest.raises(ValueError, match="f32 and bf16 streams"):
        tk.trunk_fwd_cuda(params, pt.get_config(
            "tiny", stream_dtype=torch.float16), h0, 4)
    u, saves = tk.trunk_fwd_cuda(params, pt.get_config(
        "tiny", stream_dtype=torch.bfloat16), h0, 4)
    assert saves.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="shape"):
        tk.trunk_fwd_cuda(params, cfg, h0[:, 1:], 4)
    with pytest.raises(ValueError, match="contiguous"):
        tk.trunk_fwd_cuda(params, cfg, h0.transpose(0, 1).contiguous()
                          .transpose(0, 1), 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.trunk_fwd_cuda(params, cfg, h0.cpu(), 4)
    cond = torch.ones((2, T, cfg.cond_channels), device=card)
    u, saves = tk.trunk_fwd_cuda(params, cfg, h0, 4, cond=cond)
    assert len(tk.trunk_bwd_cuda(params, cfg, saves, torch.zeros_like(u), 4,
                                 cond=cond)) == 7
    with pytest.raises(ValueError, match="cond"):
        tk.trunk_fwd_cuda(params, cfg, h0, 4, cond=cond[..., 1:].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tk.trunk_fwd_cuda(params, cfg, h0, 4, cond=cond.transpose(
            0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError, match="cond"):
        tk.trunk_bwd_cuda(params, cfg, saves, torch.zeros_like(u), 4,
                          cond=cond.cpu())
    x = torch.zeros((2, T), dtype=torch.long, device=card)
    with pytest.raises(ValueError, match="global"):
        pt.wavenet_logits(params, dataclasses.replace(cfg, trunk_kernel=True),
                          x, 4, cond=cond,
                          global_cond=torch.zeros((2, 4), device=card))


@pytest.mark.gpu
@pytest.mark.parametrize("name,batch,k,bias,out_len", TRUNK_CASES)
@pytest.mark.parametrize("M", [8, 80, 20])
@pytest.mark.parametrize("save_dtype,need_dcond", [
    (torch.float32, True), (torch.bfloat16, True), (torch.float32, False)],
    ids=["f32", "bf16", "f32-no-dcond"])
def test_conditioned_trunk_kernels_match_plain_on_card(
        card, name, batch, k, bias, out_len, M, save_dtype, need_dcond):
    """K2 with cond (M mel channels; 20 is not a multiple of 16) within
    1e-5 x max(1, |u|) of its plain version; K3's gradients, dW_cond and
    dcond (or none, when not asked for) within 1e-5 x max(1, scale) of the
    plain version's on the same saves; two K3 calls bitwise equal."""
    cfg = _trunk_config(name, kernel_size=k, bias=bias, cond_channels=M)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(2), card)
    T = cfg.receptive_field + out_len - 1
    rng = np.random.default_rng(7)
    h0 = torch.from_numpy(rng.uniform(-1, 1, (batch, T, cfg.residual_channels))
                          .astype(np.float32)).to(card)
    cond = torch.from_numpy(rng.standard_normal((batch, T, M))
                            .astype(np.float32)).to(card)
    du = torch.from_numpy(rng.uniform(-1, 1, (batch, out_len, cfg.num_layers
                                              * cfg.dilation_channels))
                          .astype(np.float32) / (batch * out_len)).to(card)
    before = (tk.fwd_launches, tk.bwd_launches)
    uk, sk = tk.trunk_fwd_cuda(params, cfg, h0, out_len, save_dtype, cond)
    gk = tk.trunk_bwd_cuda(params, cfg, sk, du, out_len, cond, need_dcond)
    again = tk.trunk_bwd_cuda(params, cfg, sk, du, out_len, cond, need_dcond)
    torch.cuda.synchronize()
    assert (tk.fwd_launches, tk.bwd_launches) == (before[0] + 1,
                                                  before[1] + 2)
    up, _ = tk.trunk_fwd_plain(params, cfg, h0, out_len, save_dtype, cond)
    assert float(((uk - up).abs() / up.abs().clamp(min=1.0)).max()) <= 1e-5
    gp = tk.trunk_bwd_plain(params, cfg, sk, du, out_len, cond, need_dcond)
    assert len(gk) == len(gp) == 7
    assert (gk[6] is None) == (not need_dcond)
    for a, b in zip(gk, gp):
        if b is None:
            continue
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))
    assert all(a is None and b is None or torch.equal(a, b)
               for a, b in zip(gk, again))


@pytest.mark.gpu
def test_conditioned_trunk_bwd_repeats_bitwise_at_the_vocoder(card):
    """Three conditioned K3 calls at the vocoder (R = D = 64, 80 mel
    channels), batch 4, out 1024, bf16 saves: dW_cond and dcond (summed in
    place layer by layer) and every other gradient bitwise equal."""
    cfg = pt.get_config("vocoder")
    out_len, batch = 1024, 4
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(3), card)
    T = cfg.receptive_field + out_len - 1
    rng = np.random.default_rng(10)
    h0 = torch.from_numpy(rng.uniform(-1, 1, (batch, T, cfg.residual_channels))
                          .astype(np.float32)).to(card)
    cond = torch.from_numpy(rng.standard_normal((batch, T, 80))
                            .astype(np.float32)).to(card)
    du = torch.from_numpy(rng.uniform(-1, 1, (batch, out_len, cfg.num_layers
                                              * cfg.dilation_channels))
                          .astype(np.float32) / (batch * out_len)).to(card)
    _, saves = tk.trunk_fwd_cuda(params, cfg, h0, out_len, cond=cond)
    runs = [tk.trunk_bwd_cuda(params, cfg, saves, du, out_len, cond)
            for _ in range(3)]
    torch.cuda.synchronize()
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))
    gp = tk.trunk_bwd_plain(params, cfg, saves, du, out_len, cond)
    for a, b in zip(runs[0], gp):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


@pytest.mark.gpu
def test_conditioned_train_step_on_card_equals_plain_model(card):
    """A conditioned train step's gradients through K2/K3 (f32 saves), the
    learnable upsampler's and w_cond's included, equal autograd of the
    plain model within 1e-5 x max(1, scale)."""
    import dataclasses
    import functools

    from pytorch_wavenet_tpu_torch.training.optimizers import _leaves

    cfg = pt.get_config("tiny_vocoder", output_length=64,
                        cond_upsample=(2, 2))
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(4), card)
    leaves = [p.requires_grad_(True) for _, p in _leaves(params)]
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(0, cfg.classes, (3, cfg.item_length))
                         ).to(card)
    y = torch.from_numpy(rng.integers(0, cfg.classes, (3, 64))).to(card)
    frames = torch.from_numpy(rng.standard_normal(
        (3, 1 + cfg.item_length // 4, cfg.cond_channels)).astype(
            np.float32)).to(card)

    def grads(c):
        return torch.autograd.grad(
            pt.cross_entropy_loss(params, c, x, y, frames, 4), leaves)

    ref = grads(cfg)
    orig = tk.fused_trunk
    before = (tk.fwd_launches, tk.bwd_launches)
    try:
        tk.fused_trunk = functools.partial(orig, save_dtype=torch.float32)
        got = grads(dataclasses.replace(cfg, trunk_kernel=True))
    finally:
        tk.fused_trunk = orig
    assert (tk.fwd_launches, tk.bwd_launches) == (before[0] + 1,
                                                  before[1] + 1)
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


# ------------------------------------------- the cluster core at chaconne

def _chaconne_k4(card, lanes, fuse_res, skip_slab, **overrides):
    cfg, params, temps, seeds, toffs = _k4_case(card, "chaconne", lanes, 0.9)
    if overrides:
        cfg = pt.get_config("chaconne", **overrides)
        params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), card)
    w = ghbm.prepare_weights(params, cfg, fuse_res, skip_slab)
    return cfg, params, w, temps, seeds, toffs


def _k4_against_plain(card, cfg, w, lanes, fuse_res, skip_slab, temps,
                      seeds, toffs, n_prime=80, steps=8, **kw):
    prime = torch.from_numpy(_prime(cfg, lanes, 1, n_prime)).to(card,
                                                                 torch.int32)
    total = n_prime - 1 + steps
    rk = torch.zeros(ghbm.ring_rows(cfg), lanes, device=card)
    rp = rk.clone()
    ck = ghbm.batched_cuda(w, cfg, prime, rk, 0, total, temps, seeds, toffs,
                           4, 0.05, fuse_res, skip_slab, True, **kw)
    torch.cuda.synchronize()
    cp, gaps = ghbm.batched_plain(w, cfg, prime, rp, 0, total, temps, seeds,
                                  toffs, 4, 0.05, fuse_res, skip_slab, True,
                                  return_gaps=True)
    forced = slice(0, n_prime - 1)
    bad = (ck[:, forced] != cp[:, forced]) & (gaps[:, forced] >= 1e-4)
    assert not bool(bad.any())
    torch.testing.assert_close(rk, rp, atol=1e-4, rtol=1e-4)
    return ck, rk


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [16, 200, 256, 1024])
@pytest.mark.parametrize("fuse_res,skip_slab", [(False, False), (True, True)],
                         ids=["exact", "fuse_res_skip_slab"])
def test_k4_chaconne_matches_plain_on_card(card, lanes, fuse_res, skip_slab):
    """K4 at chaconne widths and pool sizes (a ragged last cluster at 200
    lanes): teacher-forced classes off near-ties of 1e-4, rings within
    1e-4 of the plain version."""
    cfg, _, w, temps, seeds, toffs = _chaconne_k4(card, lanes, fuse_res,
                                                  skip_slab)
    before = ghbm.launches
    _k4_against_plain(card, cfg, w, lanes, fuse_res, skip_slab, temps,
                      seeds, toffs)
    assert ghbm.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("fuse_res,skip_slab", [(False, False), (True, True)],
                         ids=["exact", "fuse_res_skip_slab"])
def test_k4_same_lanes_at_two_widths_bitwise_on_card(card, fuse_res,
                                                     skip_slab):
    """A lane's classes and ring do not depend on its tile: the same 200
    lanes at 8, 16 and 24 lanes per cluster are bitwise equal."""
    cfg, _, w, temps, seeds, toffs = _chaconne_k4(card, 200, fuse_res,
                                                  skip_slab)
    runs = [_k4_against_plain(card, cfg, w, 200, fuse_res, skip_slab, temps,
                              seeds, toffs, n_prime=40, steps=60, tile=tile)
            for tile in ghbm.TILES]
    for c, r in runs[1:]:
        assert torch.equal(c, runs[0][0]) and torch.equal(r, runs[0][1])


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 2, 513])
def test_k4_resumed_chunk_at_offset_bitwise_on_card(card, offset):
    """A chunk resumed at t0 = offset (the first step's taps are issued
    before the call's loop) continues a rollout bitwise: classes and ring
    equal one shot; at 0 over a zeroed ring instead of a NaN-filled one."""
    cfg, _, w, temps, seeds, toffs = _chaconne_k4(card, 40, True, True)
    one = torch.from_numpy(_prime(cfg, 40, 3, 1)).to(card, torch.int32)
    rows = ghbm.ring_rows(cfg)
    r_all = torch.full((rows, 40), float("nan"), device=card)
    c_all = ghbm.batched_cuda(w, cfg, one, r_all, 0, 600, temps, seeds, toffs,
                              0, 0.0, True, True, True)
    ring = torch.zeros(rows, 40, device=card)
    parts, p = [], one
    if offset:
        parts.append(ghbm.batched_cuda(w, cfg, one, ring, 0, offset, temps,
                                       seeds, toffs, 0, 0.0, True, True, True))
        p = parts[-1][:, -1:].contiguous()
    parts.append(ghbm.batched_cuda(w, cfg, p, ring, offset, 600 - offset,
                                   temps, seeds, toffs, 0, 0.0, True, True,
                                   True))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=1), c_all)
    assert torch.equal(ring, r_all)


@pytest.mark.gpu
def test_k4_streamed_chain_weights_on_card(card):
    """R = D = 64: the chain's weights (about 2.9 MB) do not fit 8 SMs'
    shared memory and are read from L2; the kernel still agrees with its
    plain version."""
    cfg = pt.get_config("chaconne", residual_channels=64,
                        dilation_channels=64)
    tile = ghbm.default_tile(24, cfg, True, lambda t: (
        ghbm.max_active_clusters(cfg, t, True, True)))
    assert not ghbm.k1.shared_bytes_for(cfg, tile, ghbm.CLUSTER, True)[1]
    _, _, w, temps, seeds, toffs = _chaconne_k4(
        card, 24, True, True, residual_channels=64, dilation_channels=64)
    _k4_against_plain(card, cfg, w, 24, True, True, temps, seeds, toffs)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel_size", [1, 3])
@pytest.mark.parametrize("fuse_res,skip_slab", [(False, False), (True, True)],
                         ids=["exact", "fuse_res_skip_slab"])
def test_k4_kernel_sizes_match_plain_on_card(card, kernel_size, fuse_res,
                                             skip_slab):
    """K4 at chaconne widths with kernel_size 1 (no taps: a rank's slot
    per owned layer holds only h) and 3 (two tap rows per layer) against
    its plain version, at two widths, bitwise equal between them."""
    cfg, _, w, temps, seeds, toffs = _chaconne_k4(
        card, 40, fuse_res, skip_slab, kernel_size=kernel_size)
    runs = [_k4_against_plain(card, cfg, w, 40, fuse_res, skip_slab, temps,
                              seeds, toffs, tile=tile) for tile in (8, 24)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def _k1_against_plain(card, cfg, streams, fuse_res):
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), card)
    w = gk.prepare_weights(params, cfg, fuse_res)
    prime = torch.from_numpy(_prime(cfg, streams, 1, 120)).to(card,
                                                             torch.int32)
    total = prime.shape[1] - 1 + 8
    size = sum(gk.periods(cfg)) * streams * cfg.residual_channels
    rk = torch.zeros(size, device=card)
    rp = torch.zeros(size, device=card)
    ck = gk.fused_cuda(w, cfg, prime, rk, 0, total, 0.9, 0.0, 4, fuse_res)
    torch.cuda.synchronize()
    cp, gaps = gk.fused_plain(w, cfg, prime, rp, 0, total, 0.9, 0.0, 4,
                              fuse_res, return_gaps=True)
    forced = slice(0, prime.shape[1] - 1)
    bad = (ck[:, forced] != cp[:, forced]) & (gaps[:, forced] >= 1e-4)
    assert not bool(bad.any())
    torch.testing.assert_close(rk, rp, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kernel_size", [1, 3])
@pytest.mark.parametrize("fuse_res", [False, True])
def test_k1_kernel_sizes_match_plain_on_card(card, kernel_size, fuse_res):
    """K1 at chaconne widths with kernel_size 1 and 3, 3 streams:
    teacher-forced classes off near-ties, rings within 1e-4."""
    _k1_against_plain(card, pt.get_config("chaconne",
                                          kernel_size=kernel_size), 3,
                      fuse_res)


@pytest.mark.gpu
@pytest.mark.parametrize("streams", [1, 3, 8])
@pytest.mark.parametrize("fuse_res", [False, True])
def test_k1_chaconne_matches_plain_on_card(card, streams, fuse_res):
    """K1 at chaconne widths, one cluster holding 1, 3 or 8 streams:
    teacher-forced classes off near-ties, rings within 1e-4."""
    _k1_against_plain(card, pt.get_config("chaconne"), streams, fuse_res)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 2, 513])
def test_k1_resumed_chunk_at_offset_bitwise_on_card(card, offset):
    """K1: a chunk resumed from the state at t0 = offset equals one shot
    bitwise, classes and rings."""
    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(1), card)
    one = _prime(cfg, 3, 4, 1)
    kw = dict(temperature=1.0, fuse_res=True, return_state=True, device=card)
    _, c_all, s_all = pt.generate_fast_fused(params, cfg, 9, 600, one, **kw)
    if offset:
        _, ca, st = pt.generate_fast_fused(params, cfg, 9, offset, one, **kw)
    else:
        ca = c_all[:, :0]
        st = pt.FusedGenState(
            rings=tuple(torch.zeros_like(r) for r in s_all.rings), t=0,
            cls=torch.from_numpy(one[:, 0]).to(card, torch.int32))
    _, cb, st = pt.generate_fast_fused(params, cfg, 9, 600 - offset, None,
                                       state=st, **kw)
    assert torch.equal(torch.cat([ca, cb], dim=1), c_all)
    assert all(torch.equal(a, b) for a, b in zip(st.rings, s_all.rings))


# ------------------------------- conditioning in K1 and K4 (the vocoder)

COND_MODELS = {  # the vocoder's widths (R = D = 64, 80 mel channels) and
    # the unit-test vocoder, each with 3 global channels
    "tiny_vocoder": dict(gcond_channels=3),
    "vocoder": dict(gcond_channels=3),
}


def _cond_model(card, name):
    cfg = pt.get_config(name, **COND_MODELS[name])
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(2), card)
    return cfg, params


def _cond_rows(card, shape, seed, scale=0.5):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(card)


def _k1_cond_against_plain(card, cfg, params, streams, fuse_res, n_prime=80,
                           steps=8):
    w = gk.prepare_weights(params, cfg, fuse_res)
    prime = torch.from_numpy(_prime(cfg, streams, 1, n_prime)).to(
        card, torch.int32)
    total = n_prime - 1 + steps
    cond, gcond = gk.project_cond(
        params, cfg, _cond_rows(card, (streams, total, cfg.cond_channels), 3),
        _cond_rows(card, (streams, cfg.gcond_channels), 4, 1.0), streams,
        total)
    size = sum(gk.periods(cfg)) * streams * cfg.residual_channels
    rk = torch.zeros(size, device=card)
    rp = torch.zeros(size, device=card)
    before = gk.launches
    ck = gk.fused_cuda(w, cfg, prime, rk, 0, total, 0.9, 0.0, 4, fuse_res,
                       cond=cond, gcond=gcond)
    torch.cuda.synchronize()
    assert gk.launches == before + 1
    cp, gaps = gk.fused_plain(w, cfg, prime, rp, 0, total, 0.9, 0.0, 4,
                              fuse_res, return_gaps=True, cond=cond,
                              gcond=gcond)
    forced = slice(0, n_prime - 1)
    bad = (ck[:, forced] != cp[:, forced]) & (gaps[:, forced] >= 1e-4)
    assert not bool(bad.any())
    torch.testing.assert_close(rk, rp, atol=1e-4, rtol=1e-4)
    # the conditioning reaches the classes
    cu = gk.fused_plain(w, cfg, prime, torch.zeros_like(rp), 0, total, 0.9,
                        0.0, 4, fuse_res)
    assert not torch.equal(cu, cp)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(COND_MODELS))
@pytest.mark.parametrize("streams", [1, 3])
@pytest.mark.parametrize("fuse_res", [False, True])
def test_k1_conditioned_matches_plain_on_card(card, name, streams, fuse_res):
    """K1 with projected cond and gcond rows: teacher-forced classes off
    near-ties of 1e-4, rings within 1e-4 of the plain version."""
    cfg, params = _cond_model(card, name)
    _k1_cond_against_plain(card, cfg, params, streams, fuse_res)


@pytest.mark.gpu
def test_k1_conditioned_chunks_bitwise_on_card(card):
    """At the vocoder's widths a rollout in resumed chunks, each with its
    own cond rows, equals one shot bitwise, classes and rings."""
    cfg, params = _cond_model(card, "vocoder")
    one = _prime(cfg, 2, 4, 1)
    cond = _cond_rows(card, (2, 300, cfg.cond_channels), 5)
    g = _cond_rows(card, (2, cfg.gcond_channels), 6, 1.0)
    kw = dict(temperature=1.0, fuse_res=True, return_state=True, device=card,
              global_cond=g)
    _, c_all, s_all = pt.generate_fast_fused(params, cfg, 9, 300, one,
                                             cond=cond, **kw)
    parts, st, pos = [], None, 0
    for m in (1, 120, 179):
        _, c, st = pt.generate_fast_fused(
            params, cfg, 9, m, one if st is None else None, state=st,
            cond=cond[:, pos:pos + m], **kw)
        pos += m
        parts.append(c)
    assert torch.equal(torch.cat(parts, dim=1), c_all)
    assert all(torch.equal(a, b) for a, b in zip(st.rings, s_all.rings))


def _k4_cond_case(card, name, lanes, total, fuse_res, skip_slab):
    cfg, params = _cond_model(card, name)
    _, _, temps, seeds, toffs = _k4_case(card, "tiny", lanes, 0.9)
    w = ghbm.prepare_weights(params, cfg, fuse_res, skip_slab)
    cond = _cond_rows(card, (total, cfg.cond_channels, lanes), 7)
    gcond = ghbm.project_gcond(
        w, cfg, _cond_rows(card, (lanes, cfg.gcond_channels), 8, 1.0), lanes)
    return cfg, w, temps, seeds, toffs, cond, gcond


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(COND_MODELS))
@pytest.mark.parametrize("lanes", [3, 200])
@pytest.mark.parametrize("fuse_res,skip_slab", [(False, False), (True, True)],
                         ids=["exact", "fuse_res_skip_slab"])
def test_k4_conditioned_matches_plain_on_card(card, name, lanes, fuse_res,
                                              skip_slab):
    """K4 with cond rows (the product with w_cond in the kernel) and gcond
    rows: teacher-forced classes off near-ties of 1e-4, rings within 1e-4
    of the plain version."""
    n_prime, steps = 60, 8
    total = n_prime - 1 + steps
    cfg, w, temps, seeds, toffs, cond, gcond = _k4_cond_case(
        card, name, lanes, total, fuse_res, skip_slab)
    prime = torch.from_numpy(_prime(cfg, lanes, 1, n_prime)).to(
        card, torch.int32)
    rk = torch.zeros(ghbm.ring_rows(cfg), lanes, device=card)
    rp = rk.clone()
    before = ghbm.launches
    ck = ghbm.batched_cuda(w, cfg, prime, rk, 0, total, temps, seeds, toffs,
                           4, 0.05, fuse_res, skip_slab, True, cond=cond,
                           gcond=gcond)
    torch.cuda.synchronize()
    assert ghbm.launches == before + 1
    cp, gaps = ghbm.batched_plain(w, cfg, prime, rp, 0, total, temps, seeds,
                                  toffs, 4, 0.05, fuse_res, skip_slab, True,
                                  return_gaps=True, cond=cond, gcond=gcond)
    forced = slice(0, n_prime - 1)
    bad = (ck[:, forced] != cp[:, forced]) & (gaps[:, forced] >= 1e-4)
    assert not bool(bad.any())
    torch.testing.assert_close(rk, rp, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 2, 513])
def test_k4_conditioned_chunks_at_offset_bitwise_on_card(card, offset):
    """At the vocoder's widths: the same 40 lanes at 8 and 16 lanes per
    cluster are bitwise equal, and a rollout resumed at t0 = offset, each
    chunk with its own cond rows, equals one shot bitwise."""
    cfg, w, temps, seeds, toffs, cond, gcond = _k4_cond_case(
        card, "vocoder", 40, 600, True, True)
    one = torch.from_numpy(_prime(cfg, 40, 3, 1)).to(card, torch.int32)
    rows = ghbm.ring_rows(cfg)
    runs = []
    for tile in (8, 16):
        r = torch.zeros(rows, 40, device=card)
        c = ghbm.batched_cuda(w, cfg, one, r, 0, 600, temps, seeds, toffs, 0,
                              0.0, True, True, True, tile=tile, cond=cond,
                              gcond=gcond)
        runs.append((c, r))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    ring = torch.zeros(rows, 40, device=card)
    parts, p = [], one
    if offset:
        parts.append(ghbm.batched_cuda(
            w, cfg, one, ring, 0, offset, temps, seeds, toffs, 0, 0.0, True,
            True, True, cond=cond[:offset].contiguous(), gcond=gcond))
        p = parts[-1][:, -1:].contiguous()
    parts.append(ghbm.batched_cuda(
        w, cfg, p, ring, offset, 600 - offset, temps, seeds, toffs, 0, 0.0,
        True, True, True, cond=cond[offset:].contiguous(), gcond=gcond))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=1), runs[0][0])
    assert torch.equal(ring, runs[0][1])


# ----------------------------- reduced-precision inputs: bf16 stream, rings

U_TOL = 1e-5


def _bf16_flips_ok(a, b):
    """a and b (bf16) differ by at most one bf16 ulp of the larger, or,
    within 1e-5 of 0, by the f32 sums' own difference (which decides the
    rounding of a value near 0)."""
    fa, fb = a.float(), b.float()
    m = torch.maximum(fa.abs(), fb.abs()).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    return bool(((fa - fb).abs() <= ulp + U_TOL).all())


BF16_TRUNK_CASES = [  # (preset[:RxD], batch, kernel_size, out_len, cond M)
    ("tiny", 2, 2, 20, 0),
    ("test_small", 2, 3, 64, 0),
    ("test_small:12x20", 2, 2, 64, 0),  # plain loads of the bf16 taps
    ("test_small:80x80", 2, 2, 64, 0),  # K3's sums in its slot, L2 weights
    ("chaconne_wide", 2, 2, 1024, 0),
    ("chaconne_wide", 16, 2, 1024, 0),  # the main path's shapes
    ("tiny", 2, 2, 20, 8),
    ("vocoder", 2, 2, 256, 80),
]


@pytest.mark.gpu
@pytest.mark.parametrize("name,batch,k,out_len,M", BF16_TRUNK_CASES)
def test_bf16_stream_trunk_kernels_match_plain_on_card(card, name, batch, k,
                                                       out_len, M):
    """K2 and K3 at a bf16 stream: layer by layer from K2's own stream, its
    units within 1e-5 x max(1, |u|) of the plain layer's and the stream it
    writes within one bf16 ulp; K3 on K2's saves within 1e-5 x max(1,
    scale) of the plain version, two calls bitwise equal, and f32 saves
    (the same values) giving bitwise the same gradients."""
    kw = dict(cond_channels=M) if M else {}
    cfg = _trunk_config(name, kernel_size=k, stream_dtype=torch.bfloat16,
                        **kw)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(2), card)
    T = cfg.receptive_field + out_len - 1
    rng = np.random.default_rng(5)
    h0 = torch.from_numpy(rng.uniform(-1, 1, (batch, T, cfg.residual_channels))
                          .astype(np.float32)).to(card)
    du = torch.from_numpy(rng.uniform(-1, 1, (batch, out_len, cfg.num_layers
                                              * cfg.dilation_channels))
                          .astype(np.float32) / (batch * out_len)).to(card)
    cond = (torch.from_numpy(rng.normal(0, 2, (batch, T, M)).astype(
        np.float32)).to(card) if M else None)
    uk, sk = tk.trunk_fwd_cuda(params, cfg, h0, out_len, torch.bfloat16, cond)
    uk32, sk32 = tk.trunk_fwd_cuda(params, cfg, h0, out_len, torch.float32,
                                   cond)
    torch.cuda.synchronize()
    assert sk.dtype == torch.bfloat16 and torch.equal(uk, uk32)
    s, sp = tk.windows(cfg, out_len)
    cr = None if cond is None else tk.round_bf16(cond)
    D, L = cfg.dilation_channels, cfg.num_layers
    for l in range(L):
        assert torch.equal(sk32[l, :, sp[l]:], sk[l, :, sp[l]:].float())
        u, hn = tk.layer_fwd_plain(params, cfg, l, sk[l].float(), cr)
        ref = u[:, T - out_len:]
        got = uk[:, :, l * D:(l + 1) * D]
        assert float(((got - ref).abs() / ref.abs().clamp(min=1)).max()) \
            <= U_TOL
        if l + 1 < L:
            assert _bf16_flips_ok(hn[:, s[l]:].to(torch.bfloat16),
                                  sk[l + 1, :, s[l]:])
    gk = tk.trunk_bwd_cuda(params, cfg, sk, du, out_len, cond)
    again = tk.trunk_bwd_cuda(params, cfg, sk, du, out_len, cond)
    g32 = tk.trunk_bwd_cuda(params, cfg, sk32, du, out_len, cond)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(gk, again))
    assert all(torch.equal(a, b) for a, b in zip(gk, g32))
    gp = tk.trunk_bwd_plain(params, cfg, sk, du, out_len, cond)
    for a, b in zip(gk, gp):
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))


def _ring_ok(a, b):
    if a.dtype == torch.int8:
        return bool(((a.int() - b.int()).abs() <= 1).all())
    return _bf16_flips_ok(a, b)


def _ring_weights(card, name, rdt, fuse_res, skip_slab, gcond=0):
    kw = dict(gcond_channels=gcond) if gcond else {}
    cfg = pt.get_config(name, **kw)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), card)
    scales = None
    if rdt == torch.int8:
        scales = ghbm.calibrate_ring_scales(
            params, cfg, _prime(cfg, 4, 9), num_samples=32, device=card)
    return cfg, params, ghbm.prepare_weights(params, cfg, fuse_res,
                                             skip_slab, rdt, scales)


RING_CASES = [(rdt, tile, fr, ss) for rdt in (torch.bfloat16, torch.int8)
              for tile in ghbm.TILES
              for fr, ss in ((False, False), (True, True))]


@pytest.mark.gpu
@pytest.mark.parametrize("rdt,tile,fuse_res,skip_slab", RING_CASES,
                         ids=[f"{str(r)[6:]}-tile{t}-{'fused' if f else 'exact'}"
                              for r, t, f, _ in RING_CASES])
def test_k4_rings_match_plain_on_card(card, rdt, tile, fuse_res, skip_slab):
    """K4 with bf16 and int8 rings (chaconne, 100 lanes: a ragged last
    cluster at every width), step by step from the kernel's own state
    against the plain version: classes off near-ties of 1e-4, the ring
    slots written within one bf16 ulp or one int8 count; then three
    resumed chunks equal one shot bitwise, and the lockstep's one-step
    launches equal the one shot too."""
    cfg, _, w = _ring_weights(card, "chaconne", rdt, fuse_res, skip_slab)
    lanes, clock = 100, 513
    temps = torch.tensor([(0.0, 0.9, 1.0)[i % 3] for i in range(lanes)],
                         device=card)
    seeds = torch.arange(lanes, dtype=torch.int32, device=card) * 31 - 7
    toffs = torch.arange(lanes, dtype=torch.int32, device=card) % 5
    prime = torch.from_numpy(_prime(cfg, lanes, 3, 24)).to(card, torch.int32)
    ring = torch.zeros(ghbm.ring_rows(cfg), lanes, dtype=rdt, device=card)
    args = (temps, seeds, toffs, 0, 0.0, fuse_res, skip_slab, True)
    start = ring.clone()
    one = ghbm.batched_cuda(w, cfg, prime, ring, clock, 48, *args, tile=tile)
    one_ring = ring
    r = start.clone()
    rp = torch.empty_like(r)
    p = prime[:, :1].contiguous()
    cls = []
    for t in range(48):
        if t < prime.shape[1]:
            p = prime[:, t:t + 1].contiguous()
        rp.copy_(r)
        ck = ghbm.batched_cuda(w, cfg, p, r, clock + t, 1, *args, tile=tile)
        torch.cuda.synchronize()
        cp, gaps = ghbm.batched_plain(w, cfg, p, rp, clock + t, 1, *args,
                                      return_gaps=True)
        assert not bool(((ck != cp) & (gaps >= 1e-4)).any())
        assert _ring_ok(r, rp)
        cls.append(ck)
        p = ck
    assert torch.equal(torch.cat(cls, dim=1), one) and torch.equal(r,
                                                                   one_ring)
    r3, parts, p, t0 = start.clone(), [], prime, clock
    for m in (5, 20, 23):
        parts.append(ghbm.batched_cuda(w, cfg, p, r3, t0, m, *args,
                                       tile=tile))
        p, t0 = prime[:, t0 - clock + m:] if t0 - clock + m < prime.shape[
            1] else parts[-1][:, -1:], t0 + m
        p = p.contiguous()
    assert torch.equal(torch.cat(parts, dim=1), one)
    assert torch.equal(r3, one_ring)


@pytest.mark.gpu
@pytest.mark.parametrize("rdt", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
def test_k4_rings_conditioned_and_odd_streams_on_card(card, rdt):
    """The conditioned kernel (cond + gcond, tiny_vocoder) and a ring whose
    rows start at odd byte offsets (37 lanes: a tile's row of a bf16 or
    int8 ring lies at any alignment), step by step against the plain
    version."""
    cfg, params, w = _ring_weights(card, "tiny_vocoder", rdt, True, True,
                                   gcond=4)
    lanes, steps, clock = 37, 40, max(ghbm.periods(cfg))
    g = torch.Generator().manual_seed(4)
    cond = torch.randn((steps, cfg.cond_channels, lanes), generator=g).to(card)
    gcond = ghbm.project_gcond(w, cfg, torch.randn((lanes, 4), generator=g),
                               lanes)
    temps = torch.full((lanes,), 0.9, device=card)
    seeds = torch.arange(lanes, dtype=torch.int32, device=card)
    toffs = torch.zeros(lanes, dtype=torch.int32, device=card)
    args = (temps, seeds, toffs, 0, 0.0, True, True, True)
    r = torch.zeros(ghbm.ring_rows(cfg), lanes, dtype=rdt, device=card)
    rp = torch.empty_like(r)
    p = torch.from_numpy(_prime(cfg, lanes, 5, 1)).to(card, torch.int32)
    start = r.clone()
    one = ghbm.batched_cuda(w, cfg, p, start, clock, steps, *args, cond=cond,
                            gcond=gcond)
    cls = []
    for t in range(steps):
        rp.copy_(r)
        ck = ghbm.batched_cuda(w, cfg, p, r, clock + t, 1, *args,
                               cond=cond[t:t + 1].contiguous(), gcond=gcond)
        torch.cuda.synchronize()
        cp, gaps = ghbm.batched_plain(w, cfg, p, rp, clock + t, 1, *args,
                                      return_gaps=True,
                                      cond=cond[t:t + 1].contiguous(),
                                      gcond=gcond)
        assert not bool(((ck != cp) & (gaps >= 1e-4)).any())
        assert _ring_ok(r, rp)
        cls.append(ck)
        p = ck
    assert torch.equal(torch.cat(cls, dim=1), one) and torch.equal(r, start)


@pytest.mark.gpu
def test_k4_ring_launcher_checks_on_card(card):
    """A ring of another dtype than the weights were prepared for, a ring
    not 4-byte aligned, and int8 weights without their scales raise before
    anything launches."""
    cfg, _, w = _ring_weights(card, "tiny", torch.bfloat16, False, False)
    lanes = 3
    z = torch.zeros(lanes, dtype=torch.int32, device=card)
    args = (torch.zeros(lanes, device=card), z, z, 0, 0.0, False, False,
            True)
    p = z.view(lanes, 1)
    rows = ghbm.ring_rows(cfg)
    before = ghbm.launches
    with pytest.raises(ValueError, match="prepared for"):
        ghbm.batched_cuda(w, cfg, p, torch.zeros(rows, lanes, device=card),
                          0, 2, *args)
    big = torch.zeros(rows * lanes + 1, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="aligned"):
        ghbm.batched_cuda(w, cfg, p, big[1:].view(rows, lanes), 0, 2, *args)
    w8 = dict(w, ring_dtype=torch.int8)
    with pytest.raises(ValueError, match="qscale"):
        ghbm.batched_cuda(w8, cfg, p, torch.zeros(rows, lanes,
                                                  dtype=torch.int8,
                                                  device=card), 0, 2, *args)
    assert ghbm.launches == before


# ------------------------------------------------- the training remainder


@pytest.mark.gpu
def test_generate_audio_on_card_matches_plain(card):
    """The audio hook's rollout: K4 on the card (one launch, one lane per
    temperature) against its plain version on the CPU, greedy lanes class
    for class up to a near-tie of the plain version's logits."""
    from pytorch_wavenet_tpu_torch.training.trainer import generate_audio

    cfg = pt.get_config("test_small")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(3), "cpu")
    before = ghbm.launches
    got = generate_audio(pt.from_jax_params(pt.to_numpy_params(params), card),
                         cfg, length=300, temperatures=(0.0, 0.0, 1.0),
                         seed=4, device=card)
    assert ghbm.launches == before + 1
    ref = generate_audio(params, cfg, length=300, temperatures=(0.0, 0.0, 1.0),
                         seed=4, device="cpu")
    assert got.shape == ref.shape == (3, 300)
    # the classes behind the clips (the card's and the CPU's dequantizers
    # may differ by an f32 ulp)
    levels = np.asarray(pt.dequantize_to_f32(np.arange(cfg.classes),
                                             cfg.classes))
    gc, rc = (np.abs(w[..., None] - levels).argmin(-1) for w in (got, ref))
    np.testing.assert_allclose(got, levels[gc], atol=1e-6)
    for lane in range(2):
        diff = np.nonzero(gc[lane] != rc[lane])[0]
        t = int(diff[0]) if diff.size else 300
        if t < 300:  # the first difference must be a near-tie
            prefix = np.concatenate([[cfg.classes // 2], rc[lane, :t]])[None]
            logits = pt.wavenet_logits(params, cfg, torch.from_numpy(prefix),
                                       1)[0, -1].to(torch.float64)
            top = torch.topk(logits, 2).values
            assert float(top[0] - top[1]) < 1e-4, (lane, t)
        assert t > 0
        np.testing.assert_allclose(got[lane, :t], ref[lane, :t], atol=1e-6)


@pytest.mark.gpu
def test_async_checkpointer_on_card(card, tmp_path):
    """Steps that update the params and the optimizer state in place on the
    card, queued between the save and the worker's copy, do not reach the
    file."""
    from pytorch_wavenet_tpu_torch.training import optimizers as topt
    from pytorch_wavenet_tpu_torch.utils.checkpoints import AsyncCheckpointer

    cfg = pt.get_config("test_small")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), card)
    tx = topt.MultiSteps(topt.with_ema(topt.reference_adam(1e-3), 0.9), 2)
    state = tx.init(params)
    grads = topt._map(lambda p: torch.full_like(p, 0.5), params)
    tx.step(params, grads, state)  # mini_step 1, a half-filled mean
    want_p = pt.to_numpy_params(params)
    want_s = tx.state_dict(state)
    ck = AsyncCheckpointer()
    ck.save(str(tmp_path), "m", 1, params, opt_state=state, cfg=cfg,
            state_dict=tx.state_dict)
    for _ in range(6):  # in place, on the training stream
        tx.step(params, grads, state)
    path = ck.wait()
    ck.close()
    blob = pt.load_checkpoint(path, device="cpu")
    for (_, a), (_, b) in zip(topt._leaves(blob["params"]),
                              topt._leaves(want_p)):
        np.testing.assert_array_equal(a.numpy(), b)
    for (pa, a), (_, b) in zip(topt._leaves(blob["opt_state"]),
                               topt._leaves(want_s)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(pa))
    assert int(blob["opt_state"]["mini_step"]) == 1
    assert int(blob["opt_state"]["gradient_step"]) == 0
    assert state["gradient_step"] == 3  # 7 micro-steps of k = 2


@pytest.mark.gpu
def test_native_codec_loads_on_card_machine(card):
    from pytorch_wavenet_tpu_torch.data import native

    from pytorch_wavenet_tpu_torch.ops.mulaw import quantize_data

    assert native.available() and native.get_lib().native_abi_version() == 1
    x = np.linspace(-1, 1, 1001, dtype=np.float32)
    q = native.mu_law_quantize(x, 256)
    assert q.dtype == np.uint8 and np.all(np.diff(q.astype(int)) >= 0)
    assert np.abs(q.astype(int) - quantize_data(x, 256)).max() <= 1


# ------------------------------------------ speculation and distillation


def _gen_clone(state):
    return pt.GenState(tuple(b.clone() for b in state.buffers), state.t)


@pytest.mark.gpu
@pytest.mark.parametrize("win", [1, 8, 20])
def test_window_matches_sequential_steps_on_card(card, win):
    """gen_step_window on the card against ``win`` chained gen_steps:
    logits within 1e-5 x max(1, |y|), and rings after commit_window
    bitwise (the committed values are the window's own layer inputs, which
    equal the steps' up to the rounding of the wider products; with the
    window's inputs written by the steps, the rings match bitwise)."""
    cfg = pt.get_config("test_small")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(3), card)
    hist = torch.from_numpy(_prime(cfg, 1, 4, 40)).to(card)
    state = pt.init_gen_state(cfg, 1, card)
    for i in range(hist.shape[1]):
        _, state = pt.gen_step(params, cfg, state, hist[:, i])
    window = torch.from_numpy(_prime(cfg, 1, 5, win)).to(card)
    logits, pend = pt.gen_step_window(params, cfg, state, window)
    seq, want = [], _gen_clone(state)
    for i in range(win):
        lg, want = pt.gen_step(params, cfg, want, window[:, i])
        seq.append(lg)
    seq = torch.stack(seq, dim=1)
    assert bool(((logits - seq).abs() <= 1e-5 * seq.abs().clamp(min=1.0))
                .all())
    got = pt.commit_window(_gen_clone(state), pend, win)
    assert got.t == want.t
    for a, b in zip(got.buffers, want.buffers):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    # the draft's bookkeeping: recorded step inputs committed bitwise
    from pytorch_wavenet_tpu_torch.models.generate import PendingWindow
    work, recs = _gen_clone(state), []
    for i in range(win):
        rec = []
        _, work = pt.gen_step(params, cfg, work, window[:, i], record=rec)
        recs.append(rec)
    h = tuple(torch.stack([r[l] for r in recs], dim=1)
              for l in range(cfg.num_layers))
    got = pt.commit_window(_gen_clone(state), PendingWindow(h, state.t), win)
    assert all(torch.equal(a, b) for a, b in zip(got.buffers, want.buffers))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4, 8])
def test_speculation_matches_plain_rollout_on_card(card, k):
    """Speculation's classes equal generate_fast(T=0) on the card off
    near-ties (the first difference, if any, at a top-2 gap below 1e-4);
    a draft equal to the teacher accepts exactly k."""
    cfg = pt.get_config("test_small")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(6), card)
    dcfg = pt.get_config("test_small", blocks=1)
    draft = pt.init_wavenet(dcfg, torch.Generator().manual_seed(7), card)
    prime = _prime(cfg, 1, 8)
    n = 96
    _, want = pt.generate_fast(params, cfg, None, n, prime, temperature=0.0,
                               device=card)
    for dp, dc in ((draft, dcfg), (params, cfg)):
        _, cls, rate = pt.speculative_generate(params, cfg, dp, dc, None, n,
                                               prime, k=k, device=card)
        off = torch.nonzero(cls[0] != want[0])
        if off.numel():
            i = int(off[0])
            full = torch.cat([torch.as_tensor(prime, device=card),
                              want[:, :i]], dim=1)
            top = pt.wavenet_logits(params, cfg, full, out_len=1)[0, 0]
            gap = torch.topk(top, 2).values
            assert float(gap[0] - gap[1]) < 1e-4
        if dp is params:
            assert rate == k


@pytest.mark.gpu
@pytest.mark.parametrize("cond", [False, True], ids=["chaconne", "vocoder"])
def test_k2_at_the_distillation_shape_on_card(card, cond):
    """K2 at the distillation path's shape (N = 4, out 931, not a multiple
    of the 64-position tile) against its plain version: units within 1e-5
    x max(1, |u|)."""
    name = "vocoder" if cond else "chaconne"
    cfg = pt.get_config(name)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(9), card)
    out_len = 4000 - cfg.receptive_field + 1
    T = cfg.receptive_field + out_len - 1
    g = torch.Generator().manual_seed(10)
    h0 = (torch.rand((4, T, cfg.residual_channels), generator=g) * 2
          - 1).to(card)
    c = ((torch.rand((4, T, cfg.cond_channels), generator=g) * 2 - 1).to(card)
         if cond else None)
    before = tk.fwd_launches
    uk, _ = tk.trunk_fwd_cuda(params, cfg, h0, out_len, cond=c)
    torch.cuda.synchronize()
    assert tk.fwd_launches == before + 1
    assert uk.shape == (4, 931, cfg.num_layers * cfg.dilation_channels)
    up, _ = tk.trunk_fwd_plain(params, cfg, h0, out_len, cond=c)
    assert bool(((uk - up).abs() <= 1e-5 * up.abs().clamp(min=1.0)).all())


@pytest.mark.gpu
def test_student_on_card_matches_cpu(card):
    """The student's draw on the card against the CPU's from the same
    uniforms (one CPU generator), and a distillation step's loss with the
    teacher through K2 against the plain trunk."""
    import dataclasses

    from pytorch_wavenet_tpu_torch.models import iaf
    from pytorch_wavenet_tpu_torch.models.wavenet import params_to
    from pytorch_wavenet_tpu_torch.training import distill

    scfg = pt.IAFConfig(flows=2, layers=4, residual_channels=16,
                        dilation_channels=16, skip_channels=16,
                        end_channels=16, cond_channels=8)
    params = pt.init_student(scfg, torch.Generator().manual_seed(11),
                             init_scale=0.3, device="cpu")
    params["flows"][-1]["end2"]["w"].uniform_(
        -0.1, 0.1, generator=torch.Generator().manual_seed(15))
    rows = torch.rand((2, 500, 8), generator=torch.Generator().manual_seed(1))
    a = pt.student_generate(params, scfg, torch.Generator().manual_seed(12),
                            500, 2, cond=rows, device="cpu")
    b = pt.student_generate(params, scfg, torch.Generator().manual_seed(12),
                            500, 2, cond=rows, device=card)
    torch.testing.assert_close(b.cpu(), a, atol=1e-5, rtol=1e-5)
    tcfg = pt.get_config("tiny_vocoder", trunk_kernel=True)
    teacher = pt.init_wavenet(tcfg, torch.Generator().manual_seed(13), card)
    scard = params_to(params, card)
    u = iaf.base_uniforms(torch.Generator().manual_seed(14), (2, 500))
    before = (tk.fwd_launches, tk.bwd_launches)
    lk, _ = distill.distill_loss(scard, teacher, scfg, tcfg, u, 2, 500,
                                 cond=rows.to(card), teacher_smooth=1e-3)
    # the teacher's trunk is K2 alone: the frozen teacher has no backward
    assert (tk.fwd_launches, tk.bwd_launches) == (before[0] + 1, before[1])
    lp, _ = distill.distill_loss(scard, teacher, scfg,
                                 dataclasses.replace(tcfg, trunk_kernel=False),
                                 u, 2, 500, cond=rows.to(card),
                                 teacher_smooth=1e-3)
    assert abs(float(lk) - float(lp)) <= 1e-5 * max(1.0, abs(float(lp)))


# ------------------------------------------- generation and serving remainder


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.9])
@pytest.mark.parametrize("backend", ["k1", "k4"])
def test_generate_long_streams_bitwise_on_card(card, backend, temperature):
    """``generate_long`` through K1 and K4 equals one call bitwise at every
    temperature: the same int seed keys each chunk's noise."""
    cfg = pt.get_config("test_small")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(4), card)
    fn, streams, kw = {
        "k1": (pt.generate_fast_fused, 2, dict(fuse_res=True)),
        "k4": (pt.generate_fast_batched, 40,
               dict(fuse_res=True, skip_slab=True)),
    }[backend]
    prime = _prime(cfg, streams, 6, 50)
    _, one = fn(params, cfg, 17, 3000, prime, temperature=temperature,
                device=card, **kw)
    calls = []
    _, chunked = pt.generate_long(
        params, cfg, 17, 3000, prime, temperature=temperature,
        chunk_size=1100, backend=fn, device=card,
        progress_callback=lambda d, t: calls.append((d, t)), **kw)
    assert torch.equal(chunked, one)
    assert calls == [(1100, 3000), (2200, 3000), (3000, 3000)]


@pytest.mark.gpu
def test_reload_through_the_pool_on_card(card, tmp_path):
    """``Synthesizer.reload`` hands the pool (K4) new weights; a request
    admitted after it equals its solo rollout on them bitwise."""
    from pytorch_wavenet_tpu_torch.serving.server import Synthesizer

    cfg = pt.get_config("test_small")
    pa = pt.init_wavenet(cfg, torch.Generator().manual_seed(5), card)
    pb = pt.init_wavenet(cfg, torch.Generator().manual_seed(6), card)
    path = pt.save_checkpoint(str(tmp_path), "b", 2, pb, cfg=cfg)
    synth = Synthesizer(pa, cfg, device=card, batcher_opts=dict(
        lanes=16, chunk=128, fuse_res=True))
    try:
        assert synth.reload(path, str(tmp_path)) == 2
        prime = np.asarray([cfg.classes // 2], np.int32)
        _, got = synth.batcher.submit(prime, 300, temperature=0.9,
                                      seed=11).result(timeout=300)
        assert synth.batcher.stats()["failed"] == 0
    finally:
        synth.close()
    _, solo = pt.generate_fast_batched(pb, cfg, 0, 300, prime[None],
                                       temperature=0.9, lane_seed=[11],
                                       fuse_res=True, device=card)
    assert np.array_equal(got, solo[0].cpu().numpy())


@pytest.mark.gpu
def test_profiling_trace_names_k1_on_card(card, tmp_path):
    """A ``profiling.trace`` capture holds K1's launch (the cluster core's
    kernel with its K1 flag) with a device duration, overlapping the
    capture's marked window."""
    import json
    import re

    from pytorch_wavenet_tpu_torch.utils import profiling

    cfg = pt.get_config("test_small")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(7), card)
    pt.generate_fast_fused(params, cfg, 0, 4, device=card)  # build, load
    with profiling.trace(str(tmp_path)) as path:
        pt.generate_fast_fused(params, cfg, 0, 256, temperature=0.0,
                               device=card)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    k1 = [e for e in events if re.search(
        r"gen_cluster_kernel(<\d+, true|ILi\d+ELb1)", e.get("name", ""))]
    assert k1 and all(e.get("dur", 0) > 0 for e in k1)
    # the capture's window, which the launch overlaps
    span = [e for e in events if e.get("name") == profiling.CAPTURE_SPAN
            and e.get("cat") == "user_annotation"]
    assert len(span) == 1
    lo, hi = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    assert all(e["ts"] < hi and e["ts"] + e["dur"] > lo for e in k1)


@pytest.mark.gpu
def test_bench_prints_its_metric_through_k1_on_card(card, capsys):
    """The port's one-line metric: one JSON line with bench.py's keys and
    metric name, a positive rate, every call through K1 (a warm call and
    two timed ones)."""
    import json

    from pytorch_wavenet_tpu_torch import bench

    before = gk.launches
    r = bench.main(["--num-samples", "4096"])
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    blob = json.loads(lines[0])
    assert set(blob) == {"metric", "value", "unit", "vs_baseline"}
    assert blob["metric"] == "fast_generation_throughput_1stream_10x4"
    assert blob["unit"] == "samples/s" and blob["value"] > 0
    assert r["launches"] == 3 and gk.launches - before == 3
    assert out.err.startswith("# ") and "us/step" in out.err


@pytest.mark.gpu
def test_serving_soak_on_card_holds_its_invariants(card):
    """A two-second soak on the card (K4 under mixed lengths, cancels and
    temperatures), every greedy request checked bitwise against its solo
    K4 rollout."""
    from pytorch_wavenet_tpu_torch.scripts import serving_soak

    before = ghbm.launches
    r = serving_soak.main(["--config", "chaconne", "--lanes", "32",
                           "--chunk", "256", "--seconds", "2",
                           "--max-samples", "1024", "--workers", "4",
                           "--check-rate", "1", "--skip-slab", "--json"])
    assert r["hung"] == r["mismatched"] == r["worker_errors"] == 0
    assert r["failed"] == r["pool_failed"] == 0 and r["checked"] > 0
    assert r["pool_outstanding"] == 0 and r["pool_free"] == 32
    assert 0 <= r["pool_admitted"] - r["pool_completed"] - r["pool_failed"] \
        <= r["pool_cancelled"]
    assert r["completed"] > 0 and ghbm.launches > before


@pytest.mark.gpu
def test_pool_device_counters_match_k4_in_a_trace_on_card(card, tmp_path):
    """On the card ``t_prime_device`` and ``t_chunk_device`` grow over a
    burst of primed requests, and their sum lies within 5 % of K4's device
    time, by kernel name, in a ``profiling.trace`` capture of the same
    burst; the worker's ``pool.*`` spans are in the capture too."""
    import json
    import time

    from pytorch_wavenet_tpu_torch.serving import ContinuousBatcher
    from pytorch_wavenet_tpu_torch.utils import profiling

    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(8), card)
    pool = ContinuousBatcher(params, cfg, lanes=16, chunk=256, device=card)
    keys = ("t_prime_device", "t_chunk_device")
    try:
        pool.prewarm()
        s0 = pool.stats()
        with profiling.trace(str(tmp_path)) as path:
            hs = [pool.submit(_prime(cfg, 1, i)[0], 1024, seed=i)
                  for i in range(8)]
            for h in hs:
                h.result(timeout=300)
            # the chunk in flight at the last delivery ends in the capture
            time.sleep(0.5)
            s1 = pool.stats()
    finally:
        pool.close()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    lo, hi = profiling.capture_window(events)
    k4_s = profiling.clipped_ms(profiling.k4_events(events), lo, hi) / 1e3
    prime, chunk = (s1[k] - s0[k] for k in keys)
    assert prime > 0 and chunk > 0 and s1["prime_calls"] >= 1
    assert abs(prime + chunk - k4_s) <= 0.05 * k4_s, (prime, chunk, k4_s)
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"pool.prime_dispatch", "pool.dispatch", "pool.deliver"} <= names


# ------------------------------------- headless teacher-forced steps (head_from)

def _headless_equal(ck, rk, c0, r0, prime):
    """A call with ``head_from = num_given - 1`` (``ck``, ring ``rk``)
    against the same call with the head on every step (``c0``, ``r0``):
    the ring and the classes from ``num_given - 1`` on bitwise equal, each
    headless position the prime's next class."""
    ng = prime.shape[1]
    assert torch.equal(rk, r0)
    assert torch.equal(ck[:, ng - 1:], c0[:, ng - 1:])
    assert torch.equal(ck[:, :ng - 1], prime[:, 1:])


HEAD_K4 = [(rdt, tile, fr) for rdt in (torch.float32, torch.bfloat16,
                                       torch.int8)
           for tile in ghbm.TILES for fr in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("rdt,tile,fuse_res", HEAD_K4,
                         ids=[f"{str(r)[6:]}-tile{t}-{'fused' if f else 'exact'}"
                              for r, t, f in HEAD_K4])
def test_k4_headless_prime_bitwise_on_card(card, rdt, tile, fuse_res):
    """K4 at chaconne, 40 lanes (a ragged last cluster at every width), a
    600-class prime (every ring wraps) and 40 steps after it: with
    ``head_from = num_given - 1`` the ring and the classes read are bitwise
    those of ``head_from = 0``, at every width and ring dtype, exact and
    fuse_res + skip_slab; a call launches the kernel once, and the
    headless kernel once more where ``head_from`` is above 0."""
    cfg, _, w = _ring_weights(card, "chaconne", rdt, fuse_res, fuse_res)
    _, _, temps, seeds, toffs = _k4_case(card, "tiny", 40, 0.9)
    prime = torch.from_numpy(_prime(cfg, 40, 6, 600)).to(card, torch.int32)
    total = prime.shape[1] - 1 + 40
    runs = []
    for head_from in (0, prime.shape[1] - 1):
        ring = torch.zeros(ghbm.ring_rows(cfg), 40, dtype=rdt, device=card)
        before = (ghbm.launches, ghbm.headless_launches)
        c = ghbm.batched_cuda(w, cfg, prime, ring, 0, total, temps, seeds,
                              toffs, 4, 0.05, fuse_res, fuse_res, True,
                              tile=tile, head_from=head_from)
        torch.cuda.synchronize()
        assert (ghbm.launches - before[0],
                ghbm.headless_launches - before[1]) == (1, int(head_from > 0))
        runs.append((c, ring))
    _headless_equal(*runs[1], *runs[0], prime)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", ghbm.TILES)
@pytest.mark.parametrize("fuse_res", [False, True], ids=["exact", "fused"])
def test_k4_headless_prime_conditioned_bitwise_on_card(card, tile, fuse_res):
    """K4 with cond rows and gcond at ``tiny_vocoder``: the prime's
    headless steps keep the ring and the classes read bitwise."""
    n_prime, lanes = 90, 37
    total = n_prime - 1 + 30
    cfg, w, temps, seeds, toffs, cond, gcond = _k4_cond_case(
        card, "tiny_vocoder", lanes, total, fuse_res, fuse_res)
    prime = torch.from_numpy(_prime(cfg, lanes, 7, n_prime)).to(
        card, torch.int32)
    runs = []
    for head_from in (0, n_prime - 1):
        ring = torch.zeros(ghbm.ring_rows(cfg), lanes, device=card)
        c = ghbm.batched_cuda(w, cfg, prime, ring, 0, total, temps, seeds,
                              toffs, 4, 0.05, fuse_res, fuse_res, True,
                              tile=tile, cond=cond, gcond=gcond,
                              head_from=head_from)
        runs.append((c, ring))
    torch.cuda.synchronize()
    _headless_equal(*runs[1], *runs[0], prime)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["chaconne", "tiny_vocoder"])
@pytest.mark.parametrize("fuse_res", [False, True], ids=["exact", "fuse_res"])
def test_k1_headless_prime_bitwise_on_card(card, name, fuse_res):
    """K1, 3 streams: a 3070-class prime at chaconne (the stream's), or at
    ``tiny_vocoder`` 90 classes with projected cond and gcond rows; with
    ``head_from = num_given - 1`` the rings and the classes read are
    bitwise those of ``head_from = 0``; a call launches the kernel once,
    and the headless kernel once more where ``head_from`` is above 0."""
    if name == "chaconne":
        cfg = pt.get_config(name)
        params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), card)
    else:
        cfg, params = _cond_model(card, name)
    streams = 3
    n_prime = cfg.receptive_field if name == "chaconne" else 90
    prime = torch.from_numpy(_prime(cfg, streams, 8, n_prime)).to(
        card, torch.int32)
    ng = prime.shape[1]
    total = ng - 1 + 40
    cond = gcond = None
    if cfg.cond_channels:
        cond, gcond = gk.project_cond(
            params, cfg,
            _cond_rows(card, (streams, total, cfg.cond_channels), 3),
            _cond_rows(card, (streams, cfg.gcond_channels), 4, 1.0), streams,
            total)
    w = gk.prepare_weights(params, cfg, fuse_res)
    runs = []
    for head_from in (0, ng - 1):
        rings = torch.zeros(sum(gk.periods(cfg)) * streams
                            * cfg.residual_channels, device=card)
        before = (gk.launches, gk.headless_launches)
        c = gk.fused_cuda(w, cfg, prime, rings, 0, total, 0.9, 0.05, 4,
                          fuse_res, cond=cond, gcond=gcond,
                          head_from=head_from)
        torch.cuda.synchronize()
        assert (gk.launches - before[0],
                gk.headless_launches - before[1]) == (1, int(head_from > 0))
        runs.append((c, rings))
    _headless_equal(*runs[1], *runs[0], prime)


@pytest.mark.gpu
def test_pooled_primed_request_headless_equals_full_head_on_card(card):
    """A pooled request primed with a receptive field of classes at
    chaconne: its prime call runs 3069 headless steps a lane
    (``stats()["headless_steps"]``) and its classes equal, bitwise, both
    its solo ``generate_fast_batched`` rollout and one K4 call with the
    head on every step."""
    from pytorch_wavenet_tpu_torch.serving import ContinuousBatcher

    cfg = pt.get_config("chaconne")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(9), card)
    primes = [_prime(cfg, 1, 20 + i)[0] for i in range(2)]
    n = 700
    pool = ContinuousBatcher(params, cfg, lanes=16, chunk=256, fuse_res=True,
                             skip_slab=True, device=card)
    try:
        pool.prewarm()
        hs = [pool.submit(p, n, temperature=0.9, seed=40 + i)
              for i, p in enumerate(primes)]
        got = [h.result(timeout=300)[1] for h in hs]
        assert pool.stats()["headless_steps"] == 2 * (cfg.receptive_field - 1)
    finally:
        pool.close()
    w = ghbm.prepare_weights(params, cfg, True, True)
    temps = torch.full((1,), 0.9, device=card)
    toffs = torch.zeros(1, dtype=torch.int32, device=card)
    for i, p in enumerate(primes):
        _, solo = pt.generate_fast_batched(
            params, cfg, 0, n, p[None], temperature=0.9, lane_seed=[40 + i],
            fuse_res=True, skip_slab=True, device=card)
        assert np.array_equal(got[i], solo[0].cpu().numpy())
        prime = torch.from_numpy(p[None]).to(card, torch.int32)
        seeds = torch.full((1,), 40 + i, dtype=torch.int32, device=card)
        full = ghbm.batched_cuda(
            w, cfg, prime, torch.empty(ghbm.ring_rows(cfg), 1, device=card),
            0, len(p) - 1 + n, temps, seeds, toffs, 0, 0.0, True, True, True)
        assert np.array_equal(got[i], full[0, len(p) - 1:].cpu().numpy())
