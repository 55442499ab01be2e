"""Conditioning in the generation kernels K1 and K4 (the vocoder's serving
path): their plain PyTorch versions on the CPU against the JAX package's
Pallas kernels in interpret mode with ``cond`` and ``global_cond``, the
row accounting of resumed chunks, and the launchers' operand checks. The
CUDA kernels are held against the plain versions on a card in
test_torch_gpu.py.

Weights come from the JAX package's ``init_wavenet``; classes must match
class for class (temperature 0, and > 0 through ``lane_seed``'s counter
hash in K4), rings within atol = rtol = 1e-5 (JAX's CPU f32 products are
full f32; the two sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.ops.pallas.gen_kernel import (
    generate_fast_fused as jax_fused,
)
from pytorch_wavenet_tpu.ops.pallas.gen_kernel_hbm import (
    generate_fast_batched as jax_batched,
)
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel as gk
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as ghbm

TOL = dict(atol=1e-5, rtol=1e-5)


def _models(name, **over):
    cfgj, cfgt = wt.get_config(name, **over), pt.get_config(name, **over)
    jp = wt.init_wavenet(jax.random.PRNGKey(0), cfgj)
    return cfgj, jp, cfgt, pt.from_jax_params(jax.tree.map(np.asarray, jp),
                                              "cpu")


@pytest.fixture(scope="module")
def cond6():
    """tiny with 6 cond channels (6 pads to 8 rows in the TPU kernel K4)
    and 3 global ones."""
    return _models("tiny", cond_channels=6, gcond_channels=3)


@pytest.fixture(scope="module")
def vocoder():
    return _models("tiny_vocoder", gcond_channels=3)


def _normal(seed, shape, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _inputs(cfg, streams, ng, n, seed=0):
    rng = np.random.default_rng(seed)
    prime = rng.integers(0, cfg.classes, (streams, ng))
    cond = _normal(seed + 1, (streams, ng - 1 + n, cfg.cond_channels))
    g = _normal(seed + 2, (streams, cfg.gcond_channels), 1.0)
    return prime, cond, g


def _jax_seed(key):
    return int(jax.random.randint(key, (1, 1), 0, np.iinfo(np.int32).max,
                                  jnp.int32)[0, 0])


# ----------------------------------------------------------------- K1

K1_CASES = {
    "cond": dict(cond=True, gcond=False),
    "gcond": dict(cond=False, gcond=True),
    "both": dict(cond=True, gcond=True),
    "both_fuse_res": dict(cond=True, gcond=True, fuse_res=True),
    "cond_short_prime_fuse_res": dict(cond=True, gcond=False, ng=3,
                                      fuse_res=True),
}


@pytest.mark.parametrize("model", ["cond6", "vocoder"])
@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_plain_matches_jax_pallas_kernel(model, case, request):
    cfgj, jp, cfgt, tp = request.getfixturevalue(model)
    spec = K1_CASES[case]
    n = 40
    ng = spec.get("ng", cfgj.receptive_field)
    prime, cond, g = _inputs(cfgj, 2, ng, n, 3)
    c = cond if spec["cond"] else None
    gc = g if spec["gcond"] else None
    kw = dict(temperature=0.0, fuse_res=spec.get("fuse_res", False))
    _, cj, sj = jax_fused(
        jp, cfgj, jax.random.PRNGKey(0), n, jnp.asarray(prime, jnp.int32),
        cond=None if c is None else jnp.asarray(c),
        global_cond=None if gc is None else jnp.asarray(gc),
        return_state=True, interpret=True, **kw)
    before = gk.launches
    _, ct, st = pt.generate_fast_fused(
        tp, cfgt, 0, n, prime, cond=c, global_cond=gc, return_state=True,
        device="cpu", **kw)
    assert gk.launches == before
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    for rt, rj in zip(st.rings, sj.rings):
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), **TOL)
    # conditioning changes the classes
    _, cu = pt.generate_fast_fused(tp, cfgt, 0, n, prime, device="cpu", **kw)
    assert not np.array_equal(cu.numpy(), ct.numpy())


@pytest.mark.parametrize("fuse_res", [False, True])
def test_k1_plain_resumed_chunks_equal_one_shot(cond6, fuse_res):
    """Each chunk takes its own rows: ``[0, ng - 1 + n0)``, then ``n``."""
    _, _, cfgt, tp = cond6
    rf, n = cfgt.receptive_field, 36
    prime, cond, g = _inputs(cfgt, 2, rf, n, 5)
    kw = dict(temperature=0.9, fuse_res=fuse_res, device="cpu")
    _, ref = pt.generate_fast_fused(tp, cfgt, 4, n, prime, cond=cond,
                                    global_cond=g, **kw)
    parts, state, pos = [], None, 0
    for i, m in enumerate((13, 1, 22)):
        rows = rf - 1 + m if i == 0 else m
        _, cls, state = pt.generate_fast_fused(
            tp, cfgt, 4, m, prime if i == 0 else None, state=state,
            return_state=True, cond=cond[:, pos:pos + rows], global_cond=g,
            **kw)
        pos += rows
        parts.append(cls)
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), ref.numpy())


def test_k1_plain_matches_generate_fast(cond6):
    _, _, cfgt, tp = cond6
    prime, cond, g = _inputs(cfgt, 3, 4, 25, 8)
    _, cf = pt.generate_fast_fused(tp, cfgt, 0, 25, prime, temperature=0.0,
                                   cond=cond, global_cond=g, device="cpu")
    _, cx = pt.generate_fast(tp, cfgt, None, 25, prime, temperature=0.0,
                             cond=cond, global_cond=g, device="cpu")
    np.testing.assert_array_equal(cf.numpy(), cx.numpy())


def test_k1_cond_checks(cond6):
    _, _, cfgt, tp = cond6
    prime, cond, g = _inputs(cfgt, 2, 3, 8, 1)
    with pytest.raises(ValueError, match="cond shape"):
        pt.generate_fast_fused(tp, cfgt, 0, 8, prime, cond=cond[:, 1:],
                               device="cpu")
    with pytest.raises(ValueError, match="global_cond shape"):
        pt.generate_fast_fused(tp, cfgt, 0, 8, prime, global_cond=g[:1],
                               device="cpu")
    plain = pt.get_config("tiny")
    with pytest.raises(ValueError, match="cond_channels == 0"):
        pt.generate_fast_fused(tp, plain, 0, 8, prime, cond=cond,
                               device="cpu")
    # the launcher checks the projected rows before the device
    w = gk.prepare_weights(tp, cfgt, False)
    rings = torch.zeros(sum(gk.periods(cfgt)) * 2 * cfgt.residual_channels)
    p32 = torch.as_tensor(prime, dtype=torch.int32)
    L, D = cfgt.num_layers, cfgt.dilation_channels
    bad = {"cond": torch.zeros((9, L, 2, 2 * D)),
           "gcond": torch.zeros((L, 3, 2 * D))}
    for name, x in bad.items():
        with pytest.raises(ValueError, match=f"{name} must have shape"):
            gk.fused_cuda(w, cfgt, p32, rings, 0, 10, 0.0, 0.0, 0, False,
                          **{name: x})


def test_k1_shared_bytes_count_the_cond_slab():
    cfg = pt.get_config("vocoder")
    rows = gk.cond_rows(cfg, gk.CLUSTER, True)
    assert rows == 2 * 2 * 64  # nlt = ceil(30 / 16) layers of 2D rows
    base = gk.shared_bytes(cfg, True)
    assert gk.shared_bytes(cfg, True, cond=True) == base + rows * 8 * 4
    assert gk.shared_bytes(cfg, True, cond=True) <= gk.SMEM_LIMIT


# ----------------------------------------------------------------- K4

K4_CASES = {
    "cond": dict(cond=True, gcond=False),
    "gcond": dict(cond=False, gcond=True),
    "both_fused": dict(cond=True, gcond=True, fuse_res=True,
                       skip_slab=True),
    "both_hot_lane_seed": dict(cond=True, gcond=True, ng=6,
                               temperature=[0.0, 0.9, 1.1],
                               lane_seed=[3, -8, 70],
                               lane_clock=[0, 5, -2]),
}


@pytest.mark.parametrize("model", ["cond6", "vocoder"])
@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_plain_matches_jax_pallas_kernel(model, case, request):
    cfgj, jp, cfgt, tp = request.getfixturevalue(model)
    spec = K4_CASES[case]
    n = 24
    ng = spec.get("ng", cfgj.receptive_field)
    prime, cond, g = _inputs(cfgj, 3, ng, n, 11)
    c = cond if spec["cond"] else None
    gc = g if spec["gcond"] else None
    temp = spec.get("temperature", 0.0)
    key = jax.random.PRNGKey(5)
    kw = dict(fuse_res=spec.get("fuse_res", False),
              skip_slab=spec.get("skip_slab", False))
    jkw, tkw = dict(kw), dict(kw)
    for name in ("lane_seed", "lane_clock"):
        if name in spec:
            jkw[name] = jnp.asarray(spec[name], jnp.int32)
            tkw[name] = spec[name]
    _, cj, sj = jax_batched(
        jp, cfgj, key, n, jnp.asarray(prime, jnp.int32),
        temperature=(jnp.asarray(temp, jnp.float32) if np.ndim(temp)
                     else temp),
        cond=None if c is None else jnp.asarray(c),
        global_cond=None if gc is None else jnp.asarray(gc),
        return_state=True, interpret=True, **jkw)
    before = ghbm.launches
    _, ct, st = pt.generate_fast_batched(
        tp, cfgt, _jax_seed(key), n, prime, temperature=temp, cond=c,
        global_cond=gc, return_state=True, device="cpu", **tkw)
    assert ghbm.launches == before
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    if ng + n > (cfgt.kernel_size - 1) * cfgt.max_dilation + 1:
        np.testing.assert_allclose(st.ring.numpy(), np.asarray(sj.ring),
                                   **TOL)
    _, cu = pt.generate_fast_batched(
        tp, cfgt, _jax_seed(key), n, prime, temperature=temp,
        device="cpu", **tkw)
    assert not np.array_equal(cu.numpy(), ct.numpy())


@pytest.mark.parametrize("t0", [0, 1, 2, 513])
def test_k4_plain_resumed_chunks_equal_one_shot(vocoder, t0):
    """A rollout resumed at absolute step ``t0`` (the pool's clock) in
    chunks, each with its own rows, equals one call bitwise."""
    _, _, cfgt, tp = vocoder
    rng = np.random.default_rng(t0)
    S, n = 3, 30
    ring = torch.from_numpy(rng.uniform(-0.5, 0.5, (
        ghbm.ring_rows(cfgt), S)).astype(np.float32))
    cls0 = torch.from_numpy(rng.integers(0, cfgt.classes, S).astype(np.int32))
    cond = _normal(t0 + 1, (S, n, cfgt.cond_channels))
    g = _normal(t0 + 2, (S, cfgt.gcond_channels), 1.0)
    kw = dict(temperature=[0.0, 0.8, 1.0], lane_seed=[4, 5, 6],
              fuse_res=True, skip_slab=True, device="cpu", global_cond=g)
    state = ghbm.HbmGenState(ring=ring, t=t0, cls=cls0)
    _, ref, _ = pt.generate_fast_batched(tp, cfgt, 0, n, None, state=state,
                                         return_state=True, cond=cond, **kw)
    parts, st, pos = [], state, 0
    for m in (7, 1, 22):
        _, cls, st = pt.generate_fast_batched(
            tp, cfgt, 0, m, None, state=st, return_state=True,
            cond=cond[:, pos:pos + m], **kw)
        pos += m
        parts.append(cls)
    np.testing.assert_array_equal(torch.cat(parts, 1).numpy(), ref.numpy())


def test_k4_plain_fresh_call_equals_rollout_over_zeroed_history(vocoder):
    """A fresh conditioned call equals the same rollout resumed at
    max(period) over a zeroed ring: the taps a fresh call skips are
    exactly zero history, the conditioning is added at every step."""
    _, _, cfgt, tp = vocoder
    S, n = 3, 20
    prime, cond, g = _inputs(cfgt, S, 1, n, 21)
    per = max(ghbm.periods(cfgt))
    kw = dict(temperature=[0.0, 0.7, 1.0], lane_seed=[9, 8, 7],
              device="cpu", global_cond=g)
    _, fresh = pt.generate_fast_batched(tp, cfgt, 0, n, prime, cond=cond,
                                        **kw)
    state = ghbm.HbmGenState(
        ring=torch.zeros((ghbm.ring_rows(cfgt), S)), t=per,
        cls=torch.as_tensor(prime[:, 0], dtype=torch.int32))
    _, resumed = pt.generate_fast_batched(
        tp, cfgt, 0, n, None, state=state, cond=cond,
        lane_clock=[-per] * S, **kw)
    np.testing.assert_array_equal(fresh.numpy(), resumed.numpy())


def test_k4_cond_shape_errors(cond6):
    _, _, cfgt, tp = cond6
    prime = np.zeros((2, 1), np.int64)
    with pytest.raises(ValueError, match="cond shape"):
        pt.generate_fast_batched(tp, cfgt, 0, 8, prime,
                                 cond=np.zeros((2, 3, 6), np.float32),
                                 device="cpu")
    with pytest.raises(ValueError, match="global_cond shape"):
        pt.generate_fast_batched(tp, cfgt, 0, 8, prime,
                                 global_cond=np.zeros((2, 4), np.float32),
                                 device="cpu")
    plain = pt.get_config("tiny")
    with pytest.raises(ValueError, match="cond_channels == 0"):
        pt.generate_fast_batched(tp, plain, 0, 8, prime,
                                 cond=np.zeros((2, 8, 6), np.float32),
                                 device="cpu")
    # the launcher checks the rows before the device
    w = ghbm.prepare_weights(tp, cfgt, False, False)
    ring = torch.zeros((ghbm.ring_rows(cfgt), 2))
    p32 = torch.zeros((2, 1), dtype=torch.int32)
    lane = (torch.zeros(2), torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32))
    L, D = cfgt.num_layers, cfgt.dilation_channels
    for name, x in {"cond": torch.zeros((8, 5, 2)),
                    "gcond": torch.zeros((L, D, 2))}.items():
        with pytest.raises(ValueError, match=f"{name} must have shape"):
            ghbm.batched_cuda(w, cfgt, p32, ring, 0, 8, *lane, 0, 0.0,
                              False, False, False, **{name: x})


@pytest.mark.parametrize("lanes", [24, 200, 256])
def test_k4_default_tile_counts_the_cond_slab(lanes):
    """At the vocoder's widths a block of 24 lanes does not fit (the slab
    of u is L*D = 1920 rows): the default tile is 16 lanes, with or
    without the cond slab, whose M rows ``shared_bytes`` counts."""
    cfg = pt.get_config("vocoder")
    for tile in ghbm.TILES:
        assert (ghbm.shared_bytes(cfg, tile, True, cond=True)
                == ghbm.shared_bytes(cfg, tile, True) + 80 * tile * 4)
    rows = cfg.cond_channels
    tile = ghbm.default_tile(lanes, cfg, True, lambda t: 15, rows)
    assert tile == 16
    assert ghbm.shared_bytes(cfg, tile, True, cond=True) <= gk.SMEM_LIMIT
    assert ghbm.shared_bytes(cfg, 24, True) > gk.SMEM_LIMIT
