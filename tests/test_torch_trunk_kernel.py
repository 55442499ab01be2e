"""The port's training trunk (``ops/cuda/trunk_kernel.py``, plain versions
on the CPU) against the JAX package's ``fused_trunk`` run as its own tests
run it here (Pallas in interpret mode), on the same params and inputs.

Tolerances: units and logits at atol 5e-6 / rtol 1e-5 (both sides are full
f32 on the CPU; tests/test_trunk_kernel.py holds the JAX kernel to its XLA
trunk at the same tolerance); gradients with f32 saves within 1e-5 x
max(1, scale), with bf16 saves within 2e-2 x max(1, scale) (the rule of
tests/test_trunk_kernel.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.models.wavenet import embed_inputs as jax_embed
from pytorch_wavenet_tpu.models.wavenet import wavenet_logits as jax_logits
from pytorch_wavenet_tpu.ops.pallas import trunk_kernel as jtk
from pytorch_wavenet_tpu_torch.ops.cuda import trunk_kernel as tk


def _setup(out_len, N=2, seed=0, **kw):
    cfg_j = wt.get_config("tiny", **kw)
    cfg_t = pt.get_config("tiny", **kw)
    params_j = wt.init_wavenet(jax.random.PRNGKey(seed), cfg_j)
    params_np = jax.tree.map(np.asarray, params_j)
    rng = np.random.default_rng(seed + 1)
    x = rng.integers(0, cfg_j.classes, (N, cfg_j.receptive_field + out_len - 1))
    return cfg_j, cfg_t, params_np, x


CASES = [  # tests/test_trunk_kernel.py:46-56
    ({}, 2, 20), ({}, 3, 20), ({"kernel_size": 3}, 2, 20),
    ({"bias": False}, 2, 20), ({}, 2, 1), ({}, 4, 128),
    ({"kernel_size": 3}, 2, 256),
]


@pytest.mark.parametrize("kw,N,out_len", CASES)
def test_units_and_logits_match_jax_fused_trunk(kw, N, out_len):
    cfg_j, cfg_t, params_np, x = _setup(out_len, N=N, **kw)
    pj = jax.tree.map(jnp.asarray, params_np)
    h0 = jax_embed(pj, cfg_j, jnp.asarray(x))
    u_j = np.asarray(jtk.fused_trunk(pj, cfg_j, h0, out_len))
    p_t = pt.from_jax_params(params_np, "cpu")
    u_t = tk.fused_trunk(p_t, cfg_t, torch.from_numpy(np.array(h0)),
                         out_len)
    assert u_t.shape == (N, out_len, cfg_t.num_layers
                         * cfg_t.dilation_channels)
    np.testing.assert_allclose(u_t.numpy(), u_j, atol=5e-6, rtol=1e-5)
    ref = np.asarray(jax_logits(pj, dataclasses.replace(
        cfg_j, trunk_kernel=True), jnp.asarray(x), out_len))
    got = pt.wavenet_logits(p_t, dataclasses.replace(cfg_t, trunk_kernel=True),
                            torch.from_numpy(x), out_len)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-6, rtol=1e-5)


def _grads_pair(kw, N, out_len, save_j, save_t):
    """Gradients of the same loss through the JAX fused trunk (its save
    dtype pinned, as tests/test_trunk_kernel.py:_grad_pair does) and the
    port's."""
    cfg_j, cfg_t, params_np, x = _setup(out_len, N=N, **kw)
    tgt = np.random.default_rng(9).integers(0, cfg_j.classes, (N, out_len))

    def loss_j(p):
        ls = jax.nn.log_softmax(jax_logits(
            p, dataclasses.replace(cfg_j, trunk_kernel=True), jnp.asarray(x),
            out_len))
        return -jnp.mean(jnp.take_along_axis(ls, jnp.asarray(tgt)[..., None],
                                             axis=-1))

    orig_j = jtk.fused_trunk
    try:
        jtk.fused_trunk = functools.partial(orig_j, save_dtype=save_j)
        g_j = jax.grad(loss_j)(jax.tree.map(jnp.asarray, params_np))
    finally:
        jtk.fused_trunk = orig_j
    p_t = pt.from_jax_params(params_np, "cpu")
    leaves = [(k1, k2) for k1 in sorted(p_t) for k2 in sorted(p_t[k1])]
    for k1, k2 in leaves:
        p_t[k1][k2].requires_grad_(True)
    logits = None
    orig_t = tk.fused_trunk
    try:
        tk.fused_trunk = functools.partial(orig_t, save_dtype=save_t)
        logits = pt.wavenet_logits(
            p_t, dataclasses.replace(cfg_t, trunk_kernel=True),
            torch.from_numpy(x), out_len)
    finally:
        tk.fused_trunk = orig_t
    loss = -torch.mean(torch.gather(torch.log_softmax(logits, -1), -1,
                                    torch.from_numpy(tgt)[..., None]))
    g_t = torch.autograd.grad(loss, [p_t[a][b] for a, b in leaves])
    return [(f"{a}.{b}", np.asarray(g_j[a][b]), g.numpy())
            for (a, b), g in zip(leaves, g_t)]


def _assert_close_scaled(pairs, rel):
    for name, ref, got in pairs:
        err = float(np.max(np.abs(ref - got)))
        scale = float(np.max(np.abs(ref)))
        assert err <= rel * max(1.0, scale), f"{name}: {err:.3e} ({scale:.3e})"


@pytest.mark.parametrize("kw,N,out_len", [
    ({}, 2, 20), ({}, 3, 20), ({"kernel_size": 3}, 2, 20),
    ({"bias": False}, 2, 20), ({}, 4, 128),
])
def test_grads_with_f32_saves_match_jax(kw, N, out_len):
    pairs = _grads_pair(kw, N, out_len, jnp.float32, torch.float32)
    assert len(pairs) == (12 if kw.get("bias", True) else 8)
    _assert_close_scaled(pairs, 1e-5)


def test_grads_with_bf16_saves_match_jax_at_bf16_scale():
    _assert_close_scaled(_grads_pair({}, 2, 20, jnp.bfloat16,
                                     torch.bfloat16), 2e-2)


@pytest.mark.parametrize("kw,N,out_len", [({}, 3, 20),
                                          ({"kernel_size": 3}, 2, 7),
                                          ({"bias": False}, 2, 1),
                                          ({"cond_channels": 8}, 3, 20),
                                          ({"cond_channels": 20,
                                            "kernel_size": 3}, 2, 7)])
@pytest.mark.parametrize("save_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_backward_equals_autograd_of_plain_forward(kw, N, out_len,
                                                         save_dtype):
    """trunk_bwd_plain (written out, recomputing from the saves) against
    autograd of trunk_fwd_plain, with cond (dw_cond, dcond) where the config
    has cond channels: within 1e-5 x max(1, scale) with f32 saves; with
    bf16 saves the recompute reads rounded streams, so 2e-2."""
    cfg = pt.get_config("tiny", **kw)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(1), "cpu")
    T = cfg.receptive_field + out_len - 1
    rng = np.random.default_rng(2)
    h0 = torch.from_numpy(rng.uniform(-1, 1, (N, T, cfg.residual_channels))
                          .astype(np.float32)).requires_grad_(True)
    du = torch.from_numpy(rng.uniform(-1, 1, (N, out_len, cfg.num_layers
                                              * cfg.dilation_channels))
                          .astype(np.float32))
    lp = params["layers"]
    names = [n for n in ("b_in", "b_res", "w_in", "w_res", "w_cond")
             if n in lp]
    for n in names:
        lp[n].requires_grad_(True)
    cond = None
    if cfg.cond_channels:
        cond = torch.from_numpy(rng.standard_normal(
            (N, T, cfg.cond_channels)).astype(np.float32)).requires_grad_(True)
    u, _ = tk.trunk_fwd_plain.__wrapped__(params, cfg, h0, out_len,
                                          torch.float32, cond)
    wrt = [h0] + ([cond] if cond is not None else [])
    ref = torch.autograd.grad((u * du).sum(), wrt + [lp[n] for n in names])
    c = cond.detach() if cond is not None else None
    _, saves = tk.trunk_fwd_plain(params, cfg, h0.detach(), out_len,
                                  save_dtype, c)
    out = tk.trunk_bwd_plain(params, cfg, saves, du, out_len, c)
    got = dict(zip(("h0", "w_in", "w_res", "b_in", "b_res", "w_cond",
                    "cond"), out))
    rel = 1e-5 if save_dtype == torch.float32 else 2e-2
    _assert_close_scaled(
        [(n, r.numpy(), got[n].numpy())
         for n, r in zip(["h0"] + (["cond"] if c is not None else []) + names,
                         ref)], rel)


def test_rejects_what_the_trunk_does_not_take():
    """Local conditioning passes (and a model with global channels, given no
    ``global_cond``), and so does a bf16 stream; a passed ``global_cond``,
    an f16 stream, a short window, kernel_size 1 and a cond of the wrong
    shape raise."""
    cfg = pt.get_config("tiny_vocoder", gcond_channels=4)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    T = cfg.receptive_field + 19
    h0 = torch.zeros((2, T, cfg.residual_channels))
    with pytest.raises(ValueError, match="receptive_field"):
        tk.fused_trunk(params, cfg, h0[:, :-1], 20)
    with pytest.raises(ValueError, match="kernel_size"):
        tk.fused_trunk(params, pt.get_config("tiny", kernel_size=1), h0, 20)
    with pytest.raises(ValueError, match="f32 and bf16 streams"):
        tk.fused_trunk(params, pt.get_config(
            "tiny", stream_dtype=torch.float16), h0, 20)
    assert tk.fused_trunk(params, pt.get_config(
        "tiny", stream_dtype=torch.bfloat16), h0, 20).shape == (
            2, 20, cfg.num_layers * cfg.dilation_channels)
    cond = torch.ones((2, T, cfg.cond_channels))
    assert tk.fused_trunk(params, cfg, h0, 20, cond=cond).shape == (
        2, 20, cfg.num_layers * cfg.dilation_channels)
    with pytest.raises(ValueError, match="cond_channels"):
        tk.fused_trunk(params, cfg, h0, 20, cond=cond[..., 1:])
    x = torch.zeros((2, T), dtype=torch.long)
    with pytest.raises(ValueError, match="global"):
        pt.wavenet_logits(params, dataclasses.replace(cfg, trunk_kernel=True),
                          x, 20, cond=cond,
                          global_cond=torch.zeros((2, cfg.gcond_channels)))
    # a CPU tensor never reaches the CUDA launchers' kernels
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.trunk_fwd_cuda(params, cfg, h0, 20)
    u, saves = tk.trunk_fwd_plain(params, cfg, h0, 20)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.trunk_bwd_cuda(params, cfg, saves, torch.zeros_like(u), 20)
    assert tk.fwd_launches == 0 and tk.bwd_launches == 0


def test_raw_view_and_longer_window():
    """``raw=True`` views the units as (N, out, L, D); a longer input is cut
    to its trailing window, as the plain trunk reads it."""
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, cfg.classes,
                                      (2, cfg.receptive_field + 16)))
    ref = pt.wavenet_logits(params, cfg, x, 12)
    got = pt.wavenet_logits(params, dataclasses.replace(cfg, trunk_kernel=True),
                            x, 12)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-6, rtol=1e-5)
    h0 = pt.embed_inputs(params, cfg, x[:, 5:])
    raw = tk.fused_trunk(params, cfg, h0, 12, raw=True)
    assert raw.shape == (2, 12, cfg.num_layers, cfg.dilation_channels)


def test_longer_conditioned_window_and_dcond_on_demand(monkeypatch):
    """A conditioned input longer than the window is cut to its trailing
    window (cond with it), as the plain trunk reads it; the backward
    computes dcond only when cond needs a gradient (the learnable
    upsampler's; frames interpolated linearly need none)."""
    cfg = pt.get_config("tiny_vocoder")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(4)
    T = cfg.receptive_field + 16
    x = torch.from_numpy(rng.integers(0, cfg.classes, (2, T)))
    cond = torch.from_numpy(rng.standard_normal(
        (2, T, cfg.cond_channels)).astype(np.float32))
    ref = pt.wavenet_logits(params, cfg, x, 12, cond=cond)
    fused = dataclasses.replace(cfg, trunk_kernel=True)
    got = pt.wavenet_logits(params, fused, x, 12, cond=cond)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=5e-6, rtol=1e-5)
    asked = []
    real = tk.trunk_bwd_plain

    def spy(*args):
        asked.append(args[-1])
        return real(*args)

    monkeypatch.setattr(tk, "trunk_bwd_plain", spy)
    lp = params["layers"]
    lp["w_cond"].requires_grad_(True)
    for c in (cond, cond.clone().requires_grad_(True)):
        y = pt.wavenet_logits(params, fused, x, 12, cond=c)
        wrt = [lp["w_cond"]] + ([c] if c.requires_grad else [])
        g = torch.autograd.grad(y.sum(), wrt)
        assert all(bool(torch.isfinite(t).all()) for t in g)
        if c.requires_grad:  # only the trailing window's rows get one
            assert float(g[1][:, :T - (cfg.receptive_field + 11)]
                         .abs().max()) == 0.0
            assert float(g[1].abs().max()) > 0.0
    assert asked == [False, True]


# ------------------------------------------- the CUDA kernels' Python side

LAYOUT_CASES = [  # (preset, overrides)
    ("tiny", {}),
    ("tiny", {"kernel_size": 3, "bias": False}),
    ("test_small", {"residual_channels": 12, "dilation_channels": 20}),
    ("chaconne_wide", {}),
    ("chaconne_wide", {"residual_channels": 64, "dilation_channels": 64}),
    ("chaconne_wide", {"kernel_size": 3}),
]


@pytest.mark.parametrize("name,kw", LAYOUT_CASES)
def test_pack_weights_pads_interleaves_and_round_trips(name, kw):
    """The kernels' packed weights: R and D padded with zeros to multiples
    of 16, w_in as (k*Rp, 2Dp) with the gate's halves interleaved by
    8-column tiles, per layer [w_in | w_res | b_in | b_res]; unpacking
    gives the params back exactly."""
    cfg = pt.get_config(name, **kw)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(3), "cpu")
    w = tk._weights(params, cfg, torch.device("cpu"))
    L, k = cfg.num_layers, cfg.kernel_size
    R, D = cfg.residual_channels, cfg.dilation_channels
    Rp, Dp = tk.padded_widths(cfg)
    assert Rp % 16 == 0 and Dp % 16 == 0 and Rp - R < 16 and Dp - D < 16
    packed = tk.pack_weights(w, cfg)
    assert packed.shape == (L, tk.layer_size(cfg))
    KR = k * Rp
    w_in = packed[:, :KR * 2 * Dp].view(L, k, Rp, Dp // 8, 2, 8)
    w_res = packed[:, KR * 2 * Dp:KR * 2 * Dp + Dp * Rp].view(L, Dp, Rp)
    rest = packed[:, KR * 2 * Dp + Dp * Rp:]
    b_in, b_res = rest[:, :2 * Dp].view(L, Dp // 8, 2, 8), rest[:, 2 * Dp:]
    # un-interleave: (L, k, Rp, 2, Dp)
    w_in = w_in.permute(0, 1, 2, 4, 3, 5).reshape(L, k, Rp, 2, Dp)
    b_in = b_in.permute(0, 2, 1, 3).reshape(L, 2, Dp)
    assert torch.equal(w_in[:, :, :R, 0, :D], w["w_in"][..., :D])
    assert torch.equal(w_in[:, :, :R, 1, :D], w["w_in"][..., D:])
    assert torch.equal(w_res[:, :D, :R], w["w_res"])
    assert torch.equal(b_in[:, 0, :D], w["b_in"][:, :D])
    assert torch.equal(b_in[:, 1, :D], w["b_in"][:, D:])
    assert torch.equal(b_res[:, :R], w["b_res"])
    pad = (w_in[:, :, R:].abs().sum() + w_in[..., D:].abs().sum()
           + w_res[:, D:].abs().sum() + w_res[:, :, R:].abs().sum()
           + b_in[..., D:].abs().sum() + b_res[:, R:].abs().sum())
    assert float(pad) == 0.0
    back = tk.unpack_grads(packed, cfg)
    for got, n in zip(back, ("w_in", "w_res", "b_in", "b_res")):
        assert torch.equal(got, w[n]), n


@pytest.mark.parametrize("name,kw", [("tiny_vocoder", {}),
                                     ("tiny_vocoder", {"cond_channels": 20,
                                                       "kernel_size": 3}),
                                     ("vocoder", {})])
def test_pack_weights_places_w_cond_below_w_in(name, kw):
    """With cond, w_cond (M padded to Mp) sits right below w_in in each
    layer's packed weights, its gate halves interleaved like w_in's, so the
    tap product's depth runs on into it; the rest of the layout follows
    it, and unpacking gives every weight back exactly."""
    cfg = pt.get_config(name, **kw)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(4), "cpu")
    w = tk._weights(params, cfg, torch.device("cpu"), cond=True)
    L, k, M = cfg.num_layers, cfg.kernel_size, cfg.cond_channels
    R, D = cfg.residual_channels, cfg.dilation_channels
    Rp, Dp = tk.padded_widths(cfg)
    Mp = tk.cond_width(M)
    packed = tk.pack_weights(w, cfg)
    assert packed.shape == (L, tk.layer_size(cfg, Mp))
    o = k * Rp * 2 * Dp
    wc = packed[:, o:o + Mp * 2 * Dp].view(L, Mp, Dp // 8, 2, 8)
    wc = wc.permute(0, 1, 3, 2, 4).reshape(L, Mp, 2, Dp)
    assert torch.equal(wc[:, :M, 0, :D], w["w_cond"][..., :D])
    assert torch.equal(wc[:, :M, 1, :D], w["w_cond"][..., D:])
    assert float(wc[:, M:].abs().sum() + wc[..., D:].abs().sum()) == 0.0
    w_res = packed[:, o + Mp * 2 * Dp:o + Mp * 2 * Dp + Dp * Rp]
    assert torch.equal(w_res.view(L, Dp, Rp)[:, :D, :R], w["w_res"])
    back = tk.unpack_grads(packed, cfg, M)
    for got, n in zip(back, ("w_in", "w_res", "b_in", "b_res", "w_cond")):
        assert torch.equal(got, w[n]), n


def _slot_tiles(geo, l, slot):
    """The tiles layer l's block ``slot`` walks, in order (the loop bounds
    of csrc/trunk_bwd.cu's layer launch)."""
    per, nt = geo["per"][l], geo["ntiles"][l]
    return range(min(slot * per, nt), min((slot + 1) * per, nt))


@pytest.mark.parametrize("name,kw", LAYOUT_CASES)
@pytest.mark.parametrize("N,out_len", [(1, 1), (3, 20), (16, 1024)])
def test_slot_geometry_covers_each_window_once_in_order(name, kw, N,
                                                        out_len):
    """K3's partial slots: every position of every layer's window lies in
    exactly one tile of exactly one slot, a slot's tiles are consecutive
    and in order, and the slot count depends only on the shapes."""
    cfg = pt.get_config(name, **kw)
    tm = tk.bwd_plan(cfg)[0]
    geo = tk.bwd_geometry(cfg, out_len, N, tm)
    assert geo == tk.bwd_geometry(cfg, out_len, N, tm)
    S = geo["slots"]
    assert 1 <= S <= tk.MAX_SLOTS
    s, _ = tk.windows(cfg, out_len)
    T = cfg.receptive_field + out_len - 1
    for l in range(cfg.num_layers):
        tiles = [t for b in range(S) for t in _slot_tiles(geo, l, b)]
        assert tiles == list(range(geo["ntiles"][l]))
        assert all(len(_slot_tiles(geo, l, b)) <= geo["per"][l]
                   for b in range(S))
        tpi = geo["tpi"][l]
        seen = torch.zeros((N, T), dtype=torch.int64)
        for tile in tiles:
            n, t0 = tile // tpi, s[l] + (tile % tpi) * tm
            seen[n, t0:min(t0 + tm, T)] += 1
        assert int(seen[:, s[l]:].min()) == 1
        assert int(seen[:, s[l]:].max()) == 1
        assert int(seen[:, :s[l]].sum()) == 0


# each LAYOUT_CASES row's tile plans without cond: (fwd_plan, bwd_plan)
PLANS = [((64, True), (64, True, True)), ((64, True), (64, True, True)),
         ((64, True), (64, True, True)), ((64, True), (64, True, True)),
         ((64, True), (32, True, True)), ((64, True), (64, True, True))]


@pytest.mark.parametrize("case,plans", list(zip(LAYOUT_CASES, PLANS)))
def test_tile_plans_without_cond_stay_as_they_were(case, plans):
    """Mp = 0 gives every unconditioned width the plans and sizes it had
    before conditioning entered the kernels."""
    cfg = pt.get_config(case[0], **case[1])
    assert (tk.fwd_plan(cfg), tk.bwd_plan(cfg)) == plans
    assert (tk.fwd_plan(cfg, 0), tk.bwd_plan(cfg, 0)) == plans
    Rp, Dp = tk.padded_widths(cfg)
    k = cfg.kernel_size
    assert tk.layer_size(cfg, 0) == k * Rp * 2 * Dp + Dp * Rp + 2 * Dp + Rp
    for tm in (16, 32, 64):
        for wsm in (False, True):
            assert tk.fwd_smem(tm, k, Rp, Dp, wsm, 0) == tk.fwd_smem(
                tm, k, Rp, Dp, wsm)
            assert tk.fwd_smem(tm, k, Rp, Dp, wsm) == 4 * (
                2 * Dp + Rp + tm * (k * Rp + 4 + Dp + 4)
                + wsm * (k * Rp * (2 * Dp + 8) + Dp * (Rp + 8)))


@pytest.mark.parametrize("name,kw", [
    ("tiny_vocoder", {}),
    ("tiny_vocoder", {"cond_channels": 20, "kernel_size": 3}),
    ("vocoder", {}),
    ("vocoder", {"cond_channels": 8}),
    ("chaconne_wide", {"cond_channels": 80}),
    ("test_small", {"residual_channels": 128, "dilation_channels": 128,
                    "cond_channels": 80})])
def test_conditioned_tile_plans_fit_a_block(name, kw):
    """With cond (Mp columns more in the tap rows, Mp rows more in the
    weights and K3's partial sums) every plan fits the card's shared memory;
    at the vocoder K2 keeps its 64-wide tile with the weights on chip and
    K3 a 32-wide tile with the weights on chip and its sums in the slot."""
    cfg = pt.get_config(name, **kw)
    Rp, Dp = tk.padded_widths(cfg)
    Mp = tk.cond_width(cfg.cond_channels)
    assert Mp % 16 == 0 and 0 <= Mp - cfg.cond_channels < 16
    k = cfg.kernel_size
    tm, wsm = tk.fwd_plan(cfg, Mp)
    assert tk.fwd_smem(tm, k, Rp, Dp, wsm, Mp) <= tk.SMEM_LIMIT
    tm, wsm, acc = tk.bwd_plan(cfg, Mp)
    assert tk.bwd_smem(tm, k, Rp, Dp, wsm, acc, Mp) <= tk.SMEM_LIMIT
    assert tk.layer_size(cfg, Mp) == tk.layer_size(cfg) + Mp * 2 * Dp
    if (name, kw) == ("vocoder", {}):
        assert tk.fwd_plan(cfg, Mp) == (64, True)
        assert tk.bwd_plan(cfg, Mp) == (32, True, False)
        assert tk.layer_size(cfg, Mp) == 30912


@pytest.mark.parametrize("name,kw", LAYOUT_CASES + [
    ("chaconne_wide", {"residual_channels": 64, "dilation_channels": 64,
                       "kernel_size": 3}),
    ("chaconne_wide", {"residual_channels": 100, "dilation_channels": 90})])
def test_tile_plans_fit_a_block(name, kw):
    """Every width gets a tile of 16, 32 or 64 positions whose block fits
    the card's shared memory; at chaconne_wide both kernels hold a 64-wide
    tile, the weights and (K3) the partial sums on chip."""
    cfg = pt.get_config(name, **kw)
    Rp, Dp = tk.padded_widths(cfg)
    k = cfg.kernel_size
    tm, wsm = tk.fwd_plan(cfg)
    assert tm in (16, 32, 64) and tk.fwd_smem(tm, k, Rp, Dp,
                                              wsm) <= tk.SMEM_LIMIT
    tm, wsm, acc = tk.bwd_plan(cfg)
    assert tm in (16, 32, 64) and tk.bwd_smem(tm, k, Rp, Dp, wsm,
                                              acc) <= tk.SMEM_LIMIT
    if (name, kw) == ("chaconne_wide", {}):
        assert tk.fwd_plan(cfg) == (64, True)
        assert tk.bwd_plan(cfg) == (64, True, True)


def _tf32_split(x):
    """The kernels' split (csrc/tf32.cuh): hi rounded to TF32 by integer
    rounding, lo = x - hi, of which the tensor cores read the TF32 top
    bits (modelled as truncation)."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -8192).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & -8192).view(torch.float32)
    return hi, lo


def _mm3(a, b):
    """a @ b as the kernels form it: a_lo b_hi + a_hi b_lo + a_hi b_hi,
    accumulated (here in f64) and rounded to f32."""
    ah, al = _tf32_split(a)
    bh, bl = _tf32_split(b)
    d = torch.float64
    return (al.to(d) @ bh.to(d) + ah.to(d) @ bl.to(d)
            + ah.to(d) @ bh.to(d)).to(torch.float32)


def _fwd_3xtf32(params, cfg, h0, out_len):
    """trunk_fwd_plain with every product in 3xTF32."""
    N, T, R = h0.shape
    L, D = cfg.num_layers, cfg.dilation_channels
    h, us = h0, []
    for l, d in enumerate(cfg.dilations):
        w, w_res, b_in, b_res = tk._layer_weights(params, cfg, l)
        z = _mm3(tk._taps(h, cfg, d), w) + b_in
        u = torch.tanh(z[..., :D]) * torch.sigmoid(z[..., D:])
        us.append(u[:, T - out_len:])
        h = h + (_mm3(u, w_res) + b_res)
    return torch.cat(us, dim=-1)


def _bwd_3xtf32(params, cfg, saves, du, out_len):
    """trunk_bwd_plain with every product in 3xTF32."""
    L, N, T, R = saves.shape
    k, D = cfg.kernel_size, cfg.dilation_channels
    s, _ = tk.windows(cfg, out_len)
    o, grads = T - out_len, []
    dh_next = torch.zeros((N, T, R))
    for l in range(L - 1, -1, -1):
        d, sl = cfg.dilations[l], s[l]
        w, w_res, b_in, _ = tk._layer_weights(params, cfg, l)
        v = tk._taps(saves[l].float(), cfg, d)[:, sl:]
        z = _mm3(v, w) + b_in
        a, sg = torch.tanh(z[..., :D]), torch.sigmoid(z[..., D:])
        dhn = dh_next[:, sl:]
        g = _mm3(dhn, w_res.T)
        g[:, o - sl:] += du[:, :, l * D:(l + 1) * D]
        dz = torch.cat([g * sg * (1.0 - a * a), g * a * (sg * (1.0 - sg))],
                       dim=-1)
        flat = lambda x: x.reshape(-1, x.shape[-1])  # noqa: E731
        grads.append((_mm3(flat(v).T, flat(dz)).reshape(k, R, 2 * D),
                      _mm3(flat(a * sg).T, flat(dhn)), dz.sum(dim=(0, 1)),
                      dhn.sum(dim=(0, 1))))
        dv = _mm3(dz, w.T)
        dh = torch.zeros_like(dh_next)
        dh[:, sl:] = dhn + dv[..., (k - 1) * R:]
        for j in range(k - 1):
            m = (k - 1 - j) * d
            lo = max(sl - m, 0)
            dh[:, lo:T - m] += dv[:, lo + m - sl:, j * R:(j + 1) * R]
        dh_next = dh
    grads.reverse()
    return (dh_next, *(torch.stack(x) for x in zip(*grads)))


@pytest.mark.parametrize("save_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_3xtf32_products_stay_within_the_trunk_tolerances(save_dtype):
    """The kernels' arithmetic, emulated: with every product of the trunk
    in 3xTF32 (tf32.cuh's split) at chaconne_wide widths, the units stay
    within 1e-5 x max(1, |u|) of the f32 plain version and the gradients
    (on the same saves) within 1e-5 x max(1, scale): the tolerances the
    card's checks hold K2 and K3 to."""
    cfg = pt.get_config("chaconne_wide")
    out_len, N = 16, 2
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(7), "cpu")
    T = cfg.receptive_field + out_len - 1
    rng = np.random.default_rng(8)
    h0 = torch.from_numpy(rng.uniform(-1, 1, (N, T, cfg.residual_channels))
                          .astype(np.float32))
    du = torch.from_numpy((rng.uniform(-1, 1, (N, out_len, cfg.num_layers
                                               * cfg.dilation_channels))
                           / (N * out_len)).astype(np.float32))
    u_ref, saves = tk.trunk_fwd_plain(params, cfg, h0, out_len, save_dtype)
    with torch.no_grad():
        u = _fwd_3xtf32(params, cfg, h0, out_len)
        got = _bwd_3xtf32(params, cfg, saves, du, out_len)
    assert float(((u - u_ref).abs() / u_ref.abs().clamp(min=1.0)).max()) \
        <= 1e-5
    ref = tk.trunk_bwd_plain(params, cfg, saves, du, out_len)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(b.abs().max()))
