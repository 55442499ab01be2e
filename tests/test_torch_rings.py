"""Batched generation (kernel K4's plain version) with bf16 and int8 rings
(``ring_dtype``, the server's ``--bf16-rings``, ``calibrate_ring_scales``)
against the JAX package's Pallas kernel in interpret mode, chunked resumes,
the state's ring dtype, the batcher at bf16 rings and the server flag.

Tolerances: classes, bf16 rings and int8 rings equal exactly. Both sides
round (bf16) or quantize (int8, ``round`` half to even on both) the same
f32 values at the same places, and their f32 sums, which run in other
orders, land no value of these small rollouts on the other side of a
rounding boundary (measured: the rings equal bitwise). The scales are
equal too: they are maxima of equal bf16 rings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.ops.pallas.gen_kernel_hbm import (
    calibrate_ring_scales as jax_calibrate,
)
from pytorch_wavenet_tpu.ops.pallas.gen_kernel_hbm import (
    generate_fast_batched as jax_batched,
)
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as ghbm
from pytorch_wavenet_tpu_torch.serving import ContinuousBatcher
from pytorch_wavenet_tpu_torch.serving import server as srv

RINGS = {"bf16": (jnp.bfloat16, torch.bfloat16),
         "int8": (jnp.int8, torch.int8)}


def _np_params(cfg, seed):
    shapes = jax.eval_shape(lambda: wt.init_wavenet(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def tiny():
    cfgj, cfgt = wt.get_config("tiny"), pt.get_config("tiny")
    npp = _np_params(cfgj, 0)
    prime = np.random.default_rng(7).integers(0, cfgj.classes,
                                              (4, cfgj.receptive_field))
    return cfgj, jax.tree.map(jnp.asarray, npp), cfgt, \
        pt.from_jax_params(npp, "cpu"), prime


@pytest.fixture(scope="module")
def scales(tiny):
    """The JAX package's calibration: a greedy bf16-ring rollout."""
    cfgj, jp, _, _, prime = tiny
    return np.array(jax_calibrate(jp, cfgj, jax.random.PRNGKey(0),
                                  jnp.asarray(prime, jnp.int32),
                                  num_samples=16, interpret=True))


def test_calibrate_ring_scales_matches_jax(tiny, scales):
    _, _, cfgt, tp, prime = tiny
    got = ghbm.calibrate_ring_scales(tp, cfgt, prime, num_samples=16,
                                     device="cpu")
    assert got.dtype == torch.float32 and got.shape == (cfgt.num_layers,)
    np.testing.assert_array_equal(got.numpy(), scales)
    with pytest.raises(ValueError, match="ring slot"):
        ghbm.calibrate_ring_scales(tp, cfgt, prime[:, :3], num_samples=2,
                                   device="cpu")


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_plain_matches_jax_pallas_kernel(tiny, scales, ring):
    """Classes (greedy and hot lanes with lane seeds), the state's clock,
    next classes and its ring in the ring's own dtype, fuse_res +
    skip_slab (the serving flags, where the slab of u is bf16)."""
    cfgj, jp, cfgt, tp, prime = tiny
    jdt, tdt = RINGS[ring]
    temps, seeds = [0.0, 0.9, 0.0, 1.0], [5, -3, 7, 2**31 - 1]
    sc = ring == "int8"
    _, cj, sj = jax_batched(
        jp, cfgj, jax.random.PRNGKey(3), 24, jnp.asarray(prime, jnp.int32),
        temperature=jnp.asarray(temps, jnp.float32), return_state=True,
        interpret=True, ring_dtype=jdt,
        ring_scales=jnp.asarray(scales) if sc else None,
        lane_seed=jnp.asarray(seeds, jnp.int32), fuse_res=True,
        skip_slab=True)
    _, ct, st = pt.generate_fast_batched(
        tp, cfgt, 0, 24, prime, temperature=temps, return_state=True,
        device="cpu", ring_dtype=tdt, ring_scales=scales if sc else None,
        lane_seed=seeds, fuse_res=True, skip_slab=True)
    cj = np.asarray(cj)
    assert len(np.unique(cj[1])) > 1  # a hot lane samples
    np.testing.assert_array_equal(ct.numpy(), cj)
    assert st.t == int(sj.t)
    np.testing.assert_array_equal(st.cls.numpy(), np.asarray(sj.cls))
    assert st.ring.dtype == tdt
    np.testing.assert_array_equal(st.ring.to(torch.float32).numpy(),
                                  np.asarray(sj.ring).astype(np.float32))


@pytest.mark.parametrize("ring", sorted(RINGS))
@pytest.mark.parametrize("flags", [dict(), dict(fuse_res=True,
                                                skip_slab=True)],
                         ids=["exact", "fuse_res-skip_slab"])
def test_chunked_resume_equals_one_shot(tiny, scales, ring, flags):
    """Three resumed chunks equal one call bitwise, classes and ring; the
    ring keeps its dtype from chunk to chunk."""
    _, _, cfgt, tp, prime = tiny
    tdt = RINGS[ring][1]
    kw = dict(ring_dtype=tdt, device="cpu", return_state=True,
              temperature=[0.0, 0.9, 0.0, 1.0], lane_seed=[1, 2, 3, 4],
              ring_scales=scales if ring == "int8" else None, **flags)
    _, one, s1 = pt.generate_fast_batched(tp, cfgt, 0, 30, prime, **kw)
    parts, st = [], None
    for i, n in enumerate((7, 11, 12)):
        _, c, st = pt.generate_fast_batched(
            tp, cfgt, 0, n, prime if i == 0 else None, state=st,
            lane_clock=None if i == 0 else [0] * 4, **kw)
        assert st.ring.dtype == tdt
        parts.append(c)
    assert torch.equal(torch.cat(parts, dim=1), one)
    assert torch.equal(st.ring, s1.ring) and st.t == s1.t


def test_resumed_state_keeps_its_ring_dtype(tiny, scales):
    """The repair: a resumed state is never cast. Its ring must have the
    call's ``ring_dtype`` (an int8 ring cast to f32 would be read as h
    values, not counts), and a call that disagrees raises."""
    _, _, cfgt, tp, prime = tiny
    _, _, st = pt.generate_fast_batched(
        tp, cfgt, 0, 5, prime, temperature=0.0, return_state=True,
        device="cpu", ring_dtype=torch.int8, ring_scales=scales)
    assert st.ring.dtype == torch.int8
    for rdt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="keeps its dtype"):
            pt.generate_fast_batched(tp, cfgt, 0, 3, state=st,
                                     temperature=0.0, device="cpu",
                                     ring_dtype=rdt)
    _, _, s2 = pt.generate_fast_batched(
        tp, cfgt, 0, 3, state=st, temperature=0.0, return_state=True,
        device="cpu", ring_dtype=torch.int8, ring_scales=scales)
    assert s2.ring.dtype == torch.int8 and s2.t == st.t + 3
    _, _, sf = pt.generate_fast_batched(tp, cfgt, 0, 5, prime,
                                        temperature=0.0, return_state=True,
                                        device="cpu")
    with pytest.raises(ValueError, match="keeps its dtype"):
        pt.generate_fast_batched(tp, cfgt, 0, 3, state=sf, temperature=0.0,
                                 device="cpu", ring_dtype=torch.bfloat16)


def test_ring_operands_are_checked(tiny, scales):
    """int8 rings take scales of one per layer and only they take scales;
    weights prepared for one ring dtype refuse a ring of another."""
    _, _, cfgt, tp, prime = tiny
    with pytest.raises(ValueError, match="ring_scales"):
        pt.generate_fast_batched(tp, cfgt, 0, 3, prime, device="cpu",
                                 ring_dtype=torch.int8)
    with pytest.raises(ValueError, match="ring_scales"):
        pt.generate_fast_batched(tp, cfgt, 0, 3, prime, device="cpu",
                                 ring_scales=scales)
    with pytest.raises(ValueError, match="shape"):
        pt.generate_fast_batched(tp, cfgt, 0, 3, prime, device="cpu",
                                 ring_dtype=torch.int8,
                                 ring_scales=scales[:-1])
    with pytest.raises(ValueError, match="ring_dtype"):
        pt.generate_fast_batched(tp, cfgt, 0, 3, prime, device="cpu",
                                 ring_dtype=torch.float16)
    w = ghbm.prepare_weights(tp, cfgt, False, False, torch.bfloat16)
    ring = torch.zeros((ghbm.ring_rows(cfgt), 1))
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="prepared for"):
        ghbm.batched_plain(w, cfgt, z.view(1, 1), ring, 0, 2,
                           torch.zeros(1), z, z, 0, 0.0, False, False, True)
    # the lookback taps take the dequant; the params are not touched
    w8 = ghbm.prepare_weights(tp, cfgt, False, False, torch.int8, scales)
    k = cfgt.kernel_size
    np.testing.assert_array_equal(
        w8["w_tap"][:, :k - 1].numpy(),
        (tp["layers"]["w_in"][:, :k - 1]
         * (torch.from_numpy(scales) / 127.0)[:, None, None, None]).numpy())
    assert torch.equal(w8["w_tap"][:, k - 1], tp["layers"]["w_in"][:, k - 1])
    np.testing.assert_array_equal(w8["qscale"].numpy(),
                                  np.float32(127.0) / scales)


def test_batcher_bf16_rings_pooled_equals_solo(tiny):
    """A pool with bf16 rings: requests admitted at different times, greedy
    and hot, equal their solo bf16-ring rollouts bitwise (the prime's ring,
    the bootstrap ring and the splice keep the dtype)."""
    _, _, cfgt, tp, _ = tiny
    flags = dict(fuse_res=True, skip_slab=True)
    b = ContinuousBatcher(tp, cfgt, lanes=3, chunk=6, device="cpu",
                          ring_dtype=torch.bfloat16, **flags)
    reqs = [(1, 25, 0.0, 0), (2, 18, 0.9, 11), (3, 11, 1.0, 12)]
    try:
        assert b.ring_dtype == torch.bfloat16
        handles = []
        for ps, n, temp, seed in reqs:
            prime = np.random.default_rng(ps).integers(
                0, cfgt.classes, cfgt.receptive_field)
            handles.append((b.submit(prime, n, temperature=temp, seed=seed),
                            prime, n, temp, seed))
        for h, prime, n, temp, seed in handles:
            _, cls = h.result(timeout=120)
            _, solo = pt.generate_fast_batched(
                tp, cfgt, 0, n, prime[None], temperature=temp,
                lane_seed=[seed], device="cpu", ring_dtype=torch.bfloat16,
                **flags)
            np.testing.assert_array_equal(cls, solo[0].numpy())
        assert b._state.ring.dtype == torch.bfloat16
    finally:
        b.close()
    with pytest.raises(ValueError, match="ring_dtype"):
        ContinuousBatcher(tp, cfgt, device="cpu", ring_dtype=torch.int8)


def test_server_bf16_rings_flag_reaches_the_batcher(tmp_path, monkeypatch):
    """``--bf16-rings`` puts ``ring_dtype=bf16`` into the batcher's options
    (as the JAX server's ``batcher_opts``); without it the pool keeps f32
    rings."""
    cfg = pt.get_config("tiny")
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(1), "cpu")
    path = pt.save_checkpoint(str(tmp_path), "tiny", 1, params, cfg=cfg)
    seen = []

    class Stop(Exception):
        pass

    def synth(params, cfg, sr, device, batcher_opts=None):
        seen.append(batcher_opts)
        raise Stop

    monkeypatch.setattr(srv, "Synthesizer", synth)
    base = ["--snapshot", path, "--port", "0", "--device", "cpu",
            "--batcher"]
    for extra in (["--bf16-rings"], []):
        with pytest.raises(Stop):
            srv.main(base + extra)
    assert seen[0]["ring_dtype"] == torch.bfloat16
    assert "ring_dtype" not in seen[1]
    assert srv.parse_args(["--bf16-rings"]).bf16_rings
    assert not srv.parse_args([]).bf16_rings
