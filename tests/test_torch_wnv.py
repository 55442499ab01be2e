"""The WaveNet vocoder of PytorchWaveNetVocoder in the port (the ``wnv512``
preset, and ``tiny_wnv`` of the same shape at tiny widths): the kernel-2
input, the phase-scale upsampler, the converter from the source's layout,
generation through the plain version of the wide-chain kernel (with the
ring's previous-class row), the lane pool's frames mode and the one-stream
path, all on the CPU against ``plain_wnv`` (the source's equations in
plain torch). Every existing preset keeps its forward and its JSON."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import plain_wnv
import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch.models import convert
from pytorch_wavenet_tpu_torch.models import wavenet as W
from pytorch_wavenet_tpu_torch.ops import mel
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel as gk
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as ghbm
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_wide as kw
from pytorch_wavenet_tpu_torch.serving import ContinuousBatcher

# f32 logits of a 6-layer tiny model summed in two orders: about 1e-6
ATOL = 2e-5


@pytest.fixture(scope="module")
def wnv():
    """tiny_wnv with random weights; the upsampler's scales and bias are
    drawn too (the init's are 1 and 0)."""
    cfg = pt.get_config("tiny_wnv")
    g = torch.Generator().manual_seed(19)
    params = W.init_wavenet(cfg, g, "cpu")
    params["cond_up"] = {"w": torch.rand(cfg.cond_hop, generator=g) + 0.5,
                         "b": torch.rand(1, generator=g) - 0.5}
    return cfg, params


def _frames(seed, n, cfg, total):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (n, -(-total // cfg.cond_hop), cfg.cond_channels)).astype(np.float32))


def _ref(cfg, sd, x, frames):
    return plain_wnv.forward(sd, x, frames, cfg.layers, cfg.blocks)


def test_teacher_forced_logits_match_plain_reference(wnv):
    cfg, params = wnv
    x = torch.randint(0, cfg.classes, (2, 61), generator=torch.Generator()
                      .manual_seed(1))
    frames = _frames(2, 2, cfg, 61)
    cond = W.upsample_cond(params, cfg, frames, cfg.cond_hop, 61)
    got = W.wavenet_logits(params, cfg, x, 61, cond=cond)
    want = _ref(cfg, plain_wnv.to_source(params, cfg.layers, cfg.blocks), x,
                frames)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    # the one-hot input takes the same two taps
    onehot = torch.nn.functional.one_hot(x, cfg.classes).float()
    torch.testing.assert_close(W.wavenet_logits(params, cfg, onehot, 61,
                                                cond=cond), got,
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("chunks", [(9,), (4, 5), (1, 3, 5)])
def test_prime_then_generation_matches_full_forward(wnv, chunks):
    """A prime of 7 classes, then 9 served samples through batched_plain in
    ``chunks`` calls (the ring and its previous-class row carried from one
    to the next): each served class is the reference's best score at its
    position (noise keyed as the pool keys it), and each gap between the
    two best scores is the reference's."""
    cfg, params = wnv
    P, n = 7, sum(chunks)
    prime = torch.randint(0, cfg.classes, (2, P), generator=torch.Generator()
                          .manual_seed(3), dtype=torch.int32)
    frames = _frames(4, 2, cfg, P - 1 + n)
    rows = W.upsample_cond(params, cfg, frames, cfg.cond_hop, P - 1 + n)
    w = ghbm.prepare_weights(params, cfg, False, False)
    assert ghbm.is_wide(w)
    ring = torch.empty((ghbm.ring_rows(cfg), 2))
    temps = torch.tensor([1.0, 0.0])
    seeds = torch.tensor([5, 6], dtype=torch.int32)
    toffs = torch.zeros(2, dtype=torch.int32)
    cls_all, gaps_all, t0, inp, used = [], [], 0, prime, 0
    for i, c in enumerate(chunks):
        total = (P - 1 + c) if i == 0 else c
        cond = rows[:, used:used + total].permute(1, 2, 0).contiguous()
        cls, gaps = ghbm.batched_plain(
            w, cfg, inp, ring, t0, total, temps, seeds, toffs, 0, 0.0, False,
            False, True, return_gaps=True, cond=cond,
            head_from=P - 1 if i == 0 else 0)
        keep = slice(P - 1, None) if i == 0 else slice(None)
        cls_all.append(cls[:, keep])
        gaps_all.append(gaps[:, keep])
        t0, used = t0 + total, used + total
        inp = cls[:, -1:].contiguous()
    served = torch.cat(cls_all, 1).long()
    gaps = torch.cat(gaps_all, 1)
    seq = torch.cat([prime.long(), served[:, :-1]], 1)
    lg = _ref(cfg, plain_wnv.to_source(params, cfg.layers, cfg.blocks), seq,
              frames)[:, P - 1:]
    from pytorch_wavenet_tpu_torch.ops.cuda.gen_kernel import counter_uniform

    for s in range(2):
        sc = lg[s]
        if temps[s] > 0:
            step = torch.arange(P - 1, P - 1 + n)[:, None]
            u = counter_uniform(torch.arange(cfg.classes)[None], step,
                                int(seeds[s]), "cpu")
            sc = sc / temps[s] - torch.log(-torch.log(u))
        top = torch.topk(sc, 2, dim=-1).values
        torch.testing.assert_close(gaps[s], top[:, 0] - top[:, 1],
                                   atol=1e-4, rtol=0)
        sure = gaps[s] > 1e-3
        assert torch.equal(served[s][sure], sc.argmax(-1)[sure])
    # the previous-class row holds the last step's input class + 1
    assert torch.equal(ring[-1], seq[:, -1].float() + 1)


def test_frames_expansion_same_bits_for_every_chunking(wnv):
    cfg, params = wnv
    hop, total = cfg.cond_hop, 37
    frames = _frames(5, 1, cfg, total)[0]
    whole = mel.upsample_frames_phase(params["cond_up"], frames, hop, total)
    up = {"cond_up": params["cond_up"]}
    for cuts in ([37], [5, 11, 21], [1] * 37, [3, 34]):
        off, parts = 0, []
        for count in cuts:
            Fs = mel.frames_window_len(count, hop)
            fs = off // hop
            idx = np.minimum(fs + np.arange(Fs), frames.shape[0] - 1)
            parts.append(mel.expand_frames_window(
                up, frames[idx][None], hop, torch.tensor([off - fs * hop]),
                count, phase_scale=True)[0])
            off += count
        assert torch.equal(torch.cat(parts), whole)
    # the source's ConvTranspose2d gives the same rows
    ref = plain_wnv.upsample(plain_wnv.to_source(params, cfg.layers,
                                                 cfg.blocks), frames[None])
    torch.testing.assert_close(whole, ref[0].T[:total], atol=1e-6, rtol=0)


def test_converter_maps_source_layout(wnv):
    cfg, _ = wnv
    sd = plain_wnv.init_source(dict(C=cfg.classes, R=cfg.residual_channels,
                                    S=cfg.skip_channels,
                                    M=cfg.cond_channels, hop=cfg.cond_hop,
                                    layers=cfg.layers, blocks=cfg.blocks),
                               torch.Generator().manual_seed(8))
    params = convert.from_wnv_state_dict(
        {k: v.numpy() for k, v in sd.items()}, cfg, "cpu")
    assert W.parameter_count(params) == cfg.parameter_count()
    x = torch.randint(0, cfg.classes, (2, 45), generator=torch.Generator()
                      .manual_seed(9))
    frames = _frames(10, 2, cfg, 45)
    got = W.wavenet_logits(params, cfg, x, 45, cond=W.upsample_cond(
        params, cfg, frames, cfg.cond_hop, 45))
    torch.testing.assert_close(got, _ref(cfg, sd, x, frames), atol=ATOL,
                               rtol=0)
    with pytest.raises(ValueError, match="input_kernel 2"):
        convert.from_wnv_state_dict(sd, pt.get_config("tiny_vocoder"), "cpu")


def test_parameter_count_and_receptive_field():
    cfg = pt.get_config("wnv512")
    assert cfg.parameter_count() == 44_562_001
    assert cfg.receptive_field == 3071 and cfg.cond_hop == 80
    tiny = pt.get_config("tiny_wnv")
    p = W.init_wavenet(tiny, torch.Generator().manual_seed(0), "cpu")
    assert W.parameter_count(p) == tiny.parameter_count()
    assert pt.WaveNetConfig.from_json(cfg.to_json()) == cfg


@pytest.mark.parametrize("name", ["tiny", "tiny_vocoder", "test_small",
                                  "chaconne", "vocoder"])
def test_existing_presets_unchanged(name):
    """The new fields sit at their defaults: the JSON blob has none of
    them (the JAX package reads it as before), the init makes the JAX
    package's leaves at their shapes, and the forward is the JAX
    package's on the same weights."""
    cfg = pt.get_config(name)
    assert cfg.input_kernel == 1 and cfg.cond_upsampler == "conv"
    blob = json.loads(cfg.to_json())
    assert "input_kernel" not in blob and "cond_upsampler" not in blob
    assert dataclasses.asdict(wt.WaveNetConfig.from_json(cfg.to_json())) \
        .keys() <= dataclasses.asdict(cfg).keys()
    assert not kw.wide_needed(cfg)
    if name in ("chaconne", "vocoder"):
        return
    params = W.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
    assert "w_prev" not in params["start"]
    jp = convert.to_numpy_params(params)
    shapes = jax.eval_shape(lambda: wt.init_wavenet(jax.random.PRNGKey(0),
                                                    wt.get_config(name)))
    assert jax.tree.map(lambda x: x.shape, jp) == jax.tree.map(
        lambda x: x.shape, shapes)
    x = np.random.default_rng(0).integers(0, cfg.classes,
                                          (2, cfg.receptive_field + 3))
    cond = None
    if cfg.cond_channels:
        cond = np.random.default_rng(1).standard_normal(
            (*x.shape, cfg.cond_channels)).astype(np.float32)
    want = np.asarray(wt.wavenet_logits(
        jp, wt.get_config(name), jax.numpy.asarray(x), 4,
        cond=None if cond is None else jax.numpy.asarray(cond)))
    got = W.wavenet_logits(params, cfg, torch.from_numpy(x), 4,
                           cond=None if cond is None
                           else torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _kernel_operands(p):
    """The kernel's packed weights (``gen_kernel_wide.pack``) decoded: hi
    + lo of each product, row-major, K in the kernel's order."""
    out = {}
    for n in ("W1", "W2", "E1", "E2"):
        hi, lo = p[n].unbind(p[n].dim() - 6)
        out[n] = kw.untile(hi) + kw.untile(lo)
    return out


def test_wide_packing_reproduces_the_gate_and_output_products(wnv):
    """The kernel's packed operands (``gen_kernel_wide.pack``), decoded and
    applied as plain products to lanes' rows laid out as the kernel reads
    them (each part of K at its ``k_parts`` offset, K in ``k_order``),
    give the plain version's gate inputs and [res | skip] rows."""
    cfg, params = wnv
    w = ghbm.prepare_weights(params, cfg, False, False)
    p = kw.pack(w, cfg)
    ops = _kernel_operands(p)
    dm = kw.dims(cfg)
    R, D, S, M = (cfg.residual_channels, cfg.dilation_channels,
                  cfg.skip_channels, cfg.cond_channels)
    g = torch.Generator().manual_seed(11)
    tap, cur, c = (torch.randn(5, n, generator=g) for n in (R, R, M))
    b = torch.zeros(dm["K1p"], 5)
    for k0, part in zip(kw.k_parts(cfg), (tap, cur, c)):
        b[k0:k0 + part.shape[1]] = part.T
    b = kw.k_order(b.T).T
    rows = kw.gate_rows(cfg)
    for l in range(cfg.num_layers):
        z = tap @ w["w_tap"][l, 0] + cur @ w["w_tap"][l, 1] + \
            c @ w["w_cond"][l] + w["b_in"][l]
        packed = (ops["W1"][l] @ b).T + p["b1"][l]
        torch.testing.assert_close(packed[:, rows >= 0],
                                   z[:, rows[rows >= 0]], atol=1e-5, rtol=0)
        assert torch.all(packed[:, rows < 0] == 0)
        u = torch.randn(5, D, generator=g)
        bu = torch.zeros(dm["K2p"], 5)
        bu[:D] = u.T
        out = (ops["W2"][l] @ kw.k_order(bu.T).T).T + p["b2"][l]
        sr = u @ w["w_out"][l] + w["b_out"][l]
        torch.testing.assert_close(out[:, :R], sr[:, S:], atol=1e-5, rtol=0)
        torch.testing.assert_close(out[:, dm["Rp"]:dm["Rp"] + S], sr[:, :S],
                                   atol=1e-5, rtol=0)


def _odd_wide():
    """A wide config of uneven widths, so every padding of the packed
    operands is partial."""
    return dataclasses.replace(
        pt.get_config("tiny_wnv"), residual_channels=72, dilation_channels=20,
        skip_channels=40, end_channels=24, classes=40, cond_channels=5)


@pytest.mark.parametrize("name", ["tiny_wnv", "wnv512", "odd"])
def test_wide_dims_pad_rows_to_tiles_and_each_k_part_to_a_stage(name):
    """Rows pad to the tile's 32 (the gate's to 16 channels, their tanh and
    sigmoid rows); each part of K (tap, cond, h in that order: the kernel
    copies the parts no earlier phase wrote first) starts at a multiple of
    a stage's depth and has room for its rows."""
    cfg = _odd_wide() if name == "odd" else pt.get_config(name)
    dm = kw.dims(cfg)
    R, D, M = (cfg.residual_channels, cfg.dilation_channels,
               cfg.cond_channels)
    assert dm["M1p"] == 2 * -(-D // 16) * 16
    for n, width in (("Rp", R), ("Sp", cfg.skip_channels),
                     ("Ep", cfg.end_channels), ("Cp", cfg.classes)):
        assert dm[n] % kw.BR == 0 and width <= dm[n] < width + kw.BR
    tap, h, cond = kw.k_parts(cfg)  # in K: tap, cond, h
    assert tap == 0
    for k0, k1, n in ((tap, cond, R), (cond, h, M), (h, dm["K1p"], R)):
        assert k0 % kw.KC == 0 and n <= k1 - k0 < n + kw.KC
    for n, width in (("K2p", D), ("K3p", cfg.skip_channels),
                     ("K4p", cfg.end_channels)):
        assert dm[n] % kw.KC == 0 and width <= dm[n] < width + kw.KC
    if name == "wnv512":
        assert dm == dict(M1p=1024, K1p=1088, Rp=512, Sp=256, K2p=512,
                          Ep=256, K3p=256, Cp=256, K4p=256)


def test_wide_gate_rows_pair_tanh_and_sigmoid_rows_of_8_channels():
    """Each 16 packed gate rows hold the tanh rows and then the sigmoid
    rows of the same 8 channels (a thread of the kernel holds both of each
    of its channels); a tile of 32 rows holds two such groups."""
    cfg = _odd_wide()
    D = cfg.dilation_channels
    rows = kw.gate_rows(cfg).view(-1, 2, 8)  # groups: tanh, sigmoid rows
    assert rows.shape[0] * 16 == kw.dims(cfg)["M1p"]
    assert kw.dims(cfg)["M1p"] % kw.BR == 0
    ch = torch.arange(rows.shape[0] * 8).view(-1, 8)
    assert torch.equal(rows[:, 0], torch.where(ch < D, ch, -1))
    assert torch.equal(rows[:, 1], torch.where(ch < D, ch + D, -1))


def test_wide_tile_is_wgmma_core_matrices_a_stage_and_inverts():
    """``tile`` puts each stage's 8-row groups as K-major core matrices (8
    rows x 4 k, contiguous), a tile's 16 rows of a stage as one contiguous
    block; ``untile`` inverts it."""
    x = torch.randn(3, 48, 192)
    t = kw.tile(x)
    assert t.shape == (3, 3, 6, 16, 8, 4)
    assert torch.equal(kw.untile(t), x)
    for kc, grp, core, r, j in ((0, 0, 0, 0, 0), (2, 5, 15, 7, 3),
                                (1, 3, 6, 2, 1)):
        assert t[1, kc, grp, core, r, j] == x[1, 8 * grp + r,
                                               64 * kc + 4 * core + j]
    flat = t.reshape(3, 3, -1)  # stage kc: row tiles of 16 x 64, in order
    tile1 = flat[2, 1, 1024:2048].view(2, 16, 8, 4)
    assert torch.equal(kw.untile(tile1[None]), x[2, 16:32, 64:128])


def test_wide_k_order_permutes_within_each_8_deep_step():
    k = torch.arange(24.)
    assert kw.k_order(k).tolist() == [
        b + j for b in (0, 8, 16) for j in kw.K_ORDER]
    w, x = torch.randn(5, 64), torch.randn(64, 3)
    torch.testing.assert_close(kw.k_order(w) @ kw.k_order(x.T).T, w @ x)


def test_wide_weights_split_into_tf32_hi_and_exact_lo():
    """Every packed product's weights are hi + lo exactly, the kernel's
    order of ``pack_rows``' weights; hi is TF32 (the low 13 bits zero) and
    lo at most 2^-11 of the weight."""
    cfg = _odd_wide()
    params = W.init_wavenet(cfg, torch.Generator().manual_seed(23), "cpu")
    w = ghbm.prepare_weights(params, cfg, False, False)
    p, rows = kw.pack(w, cfg), kw.pack_rows(w, cfg)
    dm = kw.dims(cfg)
    L = cfg.num_layers
    shapes = dict(W1=(L, 2, dm["K1p"] // 64, dm["M1p"] // 8, 16, 8, 4),
                  W2=(L, 2, dm["K2p"] // 64, (dm["Rp"] + dm["Sp"]) // 8, 16,
                      8, 4),
                  E1=(2, dm["K3p"] // 64, dm["Ep"] // 8, 16, 8, 4),
                  E2=(2, dm["K4p"] // 64, dm["Cp"] // 8, 16, 8, 4))
    for n in ("W1", "W2", "E1", "E2"):
        assert tuple(p[n].shape) == shapes[n]
        hi, lo = (kw.untile(x) for x in p[n].unbind(p[n].dim() - 6))
        want = kw.k_order(rows[n])
        assert torch.equal(hi + lo, want)
        assert torch.all(hi.view(torch.int32) & 0x1FFF == 0)
        assert torch.all(lo.abs() <= want.abs() * 2.0**-11)
        assert torch.count_nonzero(lo) > 0
    for n in ("b1", "b2", "be1", "be2"):
        assert torch.equal(p[n], rows[n])


def _solo(params, cfg, prime, n, frames, temperature, seed):
    total = len(prime) - 1 + n
    rows = mel.upsample_frames_phase(params["cond_up"], frames,
                                     cfg.cond_hop, total)
    _, cls = pt.generate_fast_batched(
        params, cfg, 0, n, np.asarray(prime)[None], temperature=temperature,
        lane_seed=[seed], cond=rows[None], device="cpu")
    return cls[0].numpy()


def test_pool_frames_mode_equals_solo_rollouts(wnv):
    """The lane pool in frames mode with the phase upsampler: each request
    (unprimed, as a vocoder starts, and primed) equals its solo rollout
    bitwise, across chunk boundaries, admissions and the splice of the
    previous-class row."""
    cfg, params = wnv
    rng = np.random.default_rng(12)
    reqs = []
    for i, (plen, n) in enumerate([(1, 21), (1, 9), (5, 30), (1, 14),
                                   (3, 17)]):
        prime = (np.full(1, cfg.classes // 2) if plen == 1 else
                 rng.integers(0, cfg.classes, plen)).astype(np.int32)
        reqs.append((prime, n, [1.0, 0.0][i % 2], 40 + i,
                     _frames(50 + i, 1, cfg, plen - 1 + n)[0].numpy()))
    b = ContinuousBatcher(params, cfg, lanes=3, chunk=8, cond_hop=4,
                          device="cpu")
    try:
        hs = [b.submit(p, n, temperature=t, seed=s, cond_frames=f)
              for p, n, t, s, f in reqs]
        got = [h.result(timeout=120)[1] for h in hs]
        assert b.stats()["wide_launches"] == 0  # the plain version ran
    finally:
        b.close()
    for (p, n, t, s, f), cls in zip(reqs, got):
        want = _solo(params, cfg, p, n, torch.from_numpy(f), t, s)
        assert np.array_equal(np.asarray(cls), want)


def test_one_stream_runs_the_wide_path(wnv):
    """generate_fast_fused at a wide config runs generate_fast_batched (the
    plain version on the CPU) rather than raising in K1's tile check; its
    chunks resume bitwise."""
    cfg, params = wnv
    prime = np.array([[3, 9, 1]], np.int32)
    rows = torch.randn(1, 2 + 20, cfg.cond_channels,
                       generator=torch.Generator().manual_seed(13))
    _, whole = gk.generate_fast_fused(params, cfg, 7, 20, prime,
                                      temperature=1.0, device="cpu",
                                      cond=rows)
    _, want = pt.generate_fast_batched(params, cfg, 7, 20, prime,
                                       temperature=1.0, device="cpu",
                                       cond=rows)
    assert torch.equal(whole, want)
    _, a, st = gk.generate_fast_fused(params, cfg, 7, 8, prime,
                                      temperature=1.0, device="cpu",
                                      cond=rows[:, :10], return_state=True)
    _, b = gk.generate_fast_fused(params, cfg, 7, 12, None, temperature=1.0,
                                  device="cpu", cond=rows[:, 10:], state=st)
    assert torch.equal(torch.cat([a, b], 1), whole)
