"""The CUDA kernels K1, K4, K2 and K3 against their plain versions, on a
card (marked ``gpu``; each test skips without one).

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
    """Every compiled tile width, with a tail tile (130 lanes), and the
    one-seed noise keying agree with the plain version."""
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

TRUNK_CASES = [  # (preset, batch, kernel_size, bias, output_length)
    ("tiny", 3, 2, True, 1),
    ("tiny", 2, 3, True, 20),
    ("tiny", 3, 2, False, 128),
    ("test_small", 2, 2, False, 20),
    ("test_small", 3, 3, False, 128),
    ("test_small", 4, 2, True, 1024),
    ("chaconne_wide", 3, 2, True, 20),
    ("chaconne_wide", 2, 3, True, 128),
    ("chaconne_wide", 4, 2, False, 1024),
]


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
    cfg = pt.get_config(name, kernel_size=k, bias=bias)
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
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), card)
    T = cfg.receptive_field + 3
    h0 = torch.zeros((2, T, cfg.residual_channels), device=card)
    with pytest.raises(ValueError, match="f32 streams"):
        tk.trunk_fwd_cuda(params, pt.get_config(
            "tiny", stream_dtype=torch.bfloat16), h0, 4)
    with pytest.raises(ValueError, match="shape"):
        tk.trunk_fwd_cuda(params, cfg, h0[:, 1:], 4)
    with pytest.raises(ValueError, match="contiguous"):
        tk.trunk_fwd_cuda(params, cfg, h0.transpose(0, 1).contiguous()
                          .transpose(0, 1), 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.trunk_fwd_cuda(params, cfg, h0.cpu(), 4)
