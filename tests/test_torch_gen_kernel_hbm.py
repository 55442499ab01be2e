"""Batched many-stream generation (kernel K4): its plain PyTorch version on
the CPU against the JAX package's Pallas kernel in interpret mode, the
streaming state, tap predication and the launcher's checks. The CUDA
kernel itself is tested on a card in test_torch_gpu.py.

Tolerance: classes equal, rings within atol = rtol = 1e-5 (the JAX CPU
backend's f32 dots are full f32; the two sum in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.ops.pallas.gen_kernel_hbm import (
    generate_fast_batched as jax_batched,
)
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel_hbm as ghbm

TOL = dict(atol=1e-5, rtol=1e-5)


def _np_params(cfg, seed):
    shapes = jax.eval_shape(lambda: wt.init_wavenet(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def tiny():
    cfgj = wt.get_config("tiny", kernel_size=3)
    cfgt = pt.get_config("tiny", kernel_size=3)
    npp = _np_params(cfgj, 0)
    return (cfgj, jax.tree.map(jnp.asarray, npp), cfgt,
            pt.from_jax_params(npp, "cpu"))


def _prime(cfg, streams, seed, length=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.classes,
                        (streams, length or cfg.receptive_field))


def _max_period(cfg):
    return (cfg.kernel_size - 1) * cfg.max_dilation + 1


def _jax_seed(key):
    """The integer seed the JAX call derives from its key (one-seed hash)."""
    return int(jax.random.randint(key, (1, 1), 0, np.iinfo(np.int32).max,
                                  jnp.int32)[0, 0])


CASES = {
    "full_rf_prime": dict(prime=("rf", 3), n=24),
    "short_prime": dict(prime=(5, 2), n=20),
    "default_prime": dict(prime=None, n=12),
    "wraparound": dict(prime=("rf", 1), n="wrap"),
    "regularize": dict(prime=("rf", 2), n=16, regularize=0.05),
    "fuse_res": dict(prime=("rf", 3), n=24, fuse_res=True),
    "skip_slab": dict(prime=(4, 3), n=24, skip_slab=True),
    "fuse_res_skip_slab": dict(prime=("rf", 4), n=24, fuse_res=True,
                               skip_slab=True),
    "lane_seed_hot": dict(prime=("rf", 4), n=24,
                          temperature=[0.0, 0.9, 1.0, 0.9],
                          lane_seed=[11, -5, 2**31 - 1, 11],
                          lane_clock=[0, 3, -7, 100]),
    "lane_seed_hot_fused": dict(prime=(6, 3), n=20, temperature=0.8,
                                lane_seed=[1, 2, 3], fuse_res=True,
                                skip_slab=True),
    "one_seed_hot": dict(prime=("rf", 3), n=24,
                         temperature=[1.0, 0.0, 0.7]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_pallas_kernel(tiny, case):
    cfgj, jp, cfgt, tp = tiny
    spec = CASES[case]
    n = spec["n"] if spec["n"] != "wrap" else 2 * _max_period(cfgj) + 3
    prime = None
    if spec["prime"] is not None:
        length, streams = spec["prime"]
        prime = _prime(cfgj, streams, 7,
                       cfgj.receptive_field if length == "rf" else length)
    temp = spec.get("temperature", 0.0)
    key = jax.random.PRNGKey(3)
    kw = dict(regularize=spec.get("regularize", 0.0),
              fuse_res=spec.get("fuse_res", False),
              skip_slab=spec.get("skip_slab", False))
    jkw, tkw = dict(kw), dict(kw)
    for name in ("lane_seed", "lane_clock"):
        if name in spec:
            jkw[name] = jnp.asarray(np.asarray(spec[name], np.int64)
                                    .astype(np.int32))
            tkw[name] = spec[name]
    _, cj, sj = jax_batched(
        jp, cfgj, key, n,
        None if prime is None else jnp.asarray(prime, jnp.int32),
        temperature=(jnp.asarray(temp, jnp.float32) if np.ndim(temp)
                     else temp),
        return_state=True, interpret=True, **jkw)
    before = ghbm.launches
    _, ct, st = pt.generate_fast_batched(
        tp, cfgt, _jax_seed(key), n, prime, temperature=temp,
        return_state=True, device="cpu", **tkw)
    assert ghbm.launches == before  # the plain version launches nothing
    cj = np.asarray(cj)
    if np.any(np.asarray(temp) > 0):
        assert len(np.unique(cj)) > 1  # sampling, not greedy
    np.testing.assert_array_equal(ct.numpy(), cj)
    assert st.t == int(sj.t)
    np.testing.assert_array_equal(st.cls.numpy(), np.asarray(sj.cls))
    if n + (0 if prime is None else prime.shape[1]) > _max_period(cfgj):
        # every slot written: the whole ring compares
        np.testing.assert_allclose(st.ring.numpy(), np.asarray(sj.ring),
                                   **TOL)


def test_state_layout_matches_jax(tiny):
    """The ring is (sum P_l * R, streams), row (ring_off[l] + slot) * R + r:
    each layer's block holds the residual-stream inputs the JAX kernel
    wrote, slot t mod P_l."""
    cfgj, jp, cfgt, tp = tiny
    prime = _prime(cfgj, 2, 4)
    _, _, sj = jax_batched(jp, cfgj, jax.random.PRNGKey(0), 9,
                           jnp.asarray(prime, jnp.int32), temperature=0.0,
                           return_state=True, interpret=True)
    _, ct, st = pt.generate_fast_batched(tp, cfgt, 0, 9, prime,
                                         temperature=0.0, return_state=True,
                                         device="cpu")
    per = ghbm.periods(cfgt)
    R = cfgt.residual_channels
    assert tuple(st.ring.shape) == np.asarray(sj.ring).shape == (
        sum(per) * R, 2)
    assert st.ring.dtype == torch.float32 and st.cls.dtype == torch.int32
    assert ghbm.ring_offsets(cfgt) == np.cumsum([0] + per)[:-1].tolist()
    for l, (first, P) in enumerate(zip(ghbm.ring_offsets(cfgt), per)):
        blk = st.ring[first * R:(first + P) * R]
        np.testing.assert_allclose(
            blk.numpy(), np.asarray(sj.ring)[first * R:(first + P) * R],
            **TOL)
    # the last written slot of layer 0 holds the embed of the last input,
    # the sample of the step before
    t_last = int(sj.t) - 1
    h0 = tp["start"]["w"][int(ct[0, -2])] + tp["start"]["b"]
    row = (t_last % per[0]) * R
    np.testing.assert_allclose(st.ring[row:row + R, 0].numpy(), h0.numpy(),
                               **TOL)


@pytest.mark.parametrize("variant", [
    dict(temperature=0.0),
    dict(temperature=[0.9, 0.0, 1.0], lane_seed=[4, 5, 6],
         lane_clock=[2, 0, 9], fuse_res=True, skip_slab=True),
])
def test_resumed_chunks_equal_one_shot(tiny, variant):
    """Three chunks resumed from the state (clock offsets >= 2 on every
    resumed call) equal one shot bitwise, classes and ring; the JAX
    kernel's chunked rollout agrees."""
    cfgj, jp, cfgt, tp = tiny
    prime = _prime(cfgt, 3, 5)
    kw = dict(device="cpu", **variant)
    _, c_all, s_all = pt.generate_fast_batched(tp, cfgt, 0, 30, prime,
                                               return_state=True, **kw)
    parts, st = [], None
    for i, n in enumerate((10, 10, 10)):
        _, c, st = pt.generate_fast_batched(
            tp, cfgt, 0, n, prime if i == 0 else None, state=st,
            return_state=True, **kw)
        parts.append(c)
        assert st.t >= 2
    assert torch.equal(torch.cat(parts, dim=1), c_all)
    assert torch.equal(st.ring, s_all.ring) and torch.equal(st.cls, s_all.cls)
    assert st.t == s_all.t == prime.shape[1] - 1 + 30

    jkw = {k: (jnp.asarray(v, jnp.float32) if k == "temperature"
               else jnp.asarray(v, jnp.int32)) if np.ndim(v) else v
           for k, v in variant.items()}
    jparts, sj = [], None
    for i, n in enumerate((10, 10, 10)):
        _, c, sj = jax_batched(
            jp, cfgj, jax.random.PRNGKey(0), n,
            jnp.asarray(prime, jnp.int32) if i == 0 else None, state=sj,
            return_state=True, interpret=True, **jkw)
        jparts.append(np.asarray(c))
    np.testing.assert_array_equal(c_all.numpy(), np.concatenate(jparts, 1))


def test_unwritten_slots_are_never_read(tiny):
    """A fresh call predicates its taps on ta >= lookback: a NaN-filled ring
    gives the same classes as a zeroed one, and the slots it wrote agree."""
    _, _, cfg, tp = tiny
    w = ghbm.prepare_weights(tp, cfg, True, True)
    prime = torch.from_numpy(_prime(cfg, 3, 6, 2)).to(torch.int32)
    streams, rows = 3, ghbm.ring_rows(cfg)
    temps = torch.tensor([0.0, 0.9, 1.0])
    seeds = torch.tensor([1, 2, 3], dtype=torch.int32)
    toffs = torch.zeros(3, dtype=torch.int32)
    out = []
    for fill in (float("nan"), 0.0):
        ring = torch.full((rows, streams), fill)
        cls = ghbm.batched_plain(w, cfg, prime, ring, 0, 6, temps, seeds,
                                 toffs, 0, 0.0, True, True, True)
        out.append((cls, ring))
    assert torch.equal(out[0][0], out[1][0])
    written = ~torch.isnan(out[0][1])
    assert written.any() and not written.all()
    assert torch.equal(out[0][1][written], out[1][1][written])


def _roll_ring(cfg, ring, delta):
    """The ring as a call started ``delta`` steps later would hold it: each
    layer's slot s moves to (s + delta) mod P."""
    R, out = cfg.residual_channels, torch.empty_like(ring)
    for first, P in zip(ghbm.ring_offsets(cfg), ghbm.periods(cfg)):
        blk = ring[first * R:(first + P) * R].view(P, R, -1)
        out[first * R:(first + P) * R] = torch.roll(
            blk, delta % P, dims=0).reshape(P * R, -1)
    return out


@pytest.mark.parametrize("fuse_res,skip_slab", [(False, False), (True, True)])
def test_fresh_call_equals_rollout_over_zeroed_history(tiny, fuse_res,
                                                       skip_slab):
    """What the pool relies on: a fresh call from one class equals, bitwise,
    the same rollout resumed at t0 = max(period) over a zeroed ring with the
    same request-local noise clock (classes, and the ring rolled by t0)."""
    _, _, cfg, tp = tiny
    clock = _max_period(cfg)
    n = clock + 5  # every slot written
    prime = _prime(cfg, 3, 9, 1)
    kw = dict(temperature=[0.9, 0.0, 1.0], lane_seed=[3, 4, 5],
              fuse_res=fuse_res, skip_slab=skip_slab, return_state=True,
              device="cpu")
    _, c_fresh, s_fresh = pt.generate_fast_batched(
        tp, cfg, 0, n, prime, lane_clock=[0, 2, 7], **kw)
    zeroed = ghbm.HbmGenState(
        ring=torch.zeros(ghbm.ring_rows(cfg), 3), t=clock,
        cls=torch.from_numpy(prime[:, 0]).to(torch.int32))
    _, c_pool, s_pool = pt.generate_fast_batched(
        tp, cfg, 0, n, state=zeroed,
        lane_clock=[-clock, 2 - clock, 7 - clock], **kw)
    assert torch.equal(c_fresh, c_pool)
    assert torch.equal(_roll_ring(cfg, s_fresh.ring, clock), s_pool.ring)


def test_same_lane_seed_same_draws_anywhere(tiny):
    """Under lane_seed a stream's rollout does not depend on its lane or on
    the streams beside it."""
    _, _, cfg, tp = tiny
    prime = _prime(cfg, 3, 8)
    kw = dict(temperature=1.0, device="cpu")
    _, c3 = pt.generate_fast_batched(tp, cfg, 0, 20, prime,
                                     lane_seed=[7, 8, 9], **kw)
    _, c1 = pt.generate_fast_batched(tp, cfg, 99, 20, prime[2:],
                                     lane_seed=[9], **kw)
    assert torch.equal(c3[2:], c1)
    assert not torch.equal(c3[0], c3[1])


def test_wrapper_rejects_bad_inputs(tiny):
    _, _, cfg, tp = tiny
    bad = [
        dict(first_samples=[1, cfg.classes]),
        dict(first_samples=np.zeros((1, 0), np.int64)),
        dict(first_samples=[[1], [2]], temperature=[0.5]),
        dict(first_samples=[[1], [2]], lane_seed=[1]),
        dict(lane_clock=[1]),
    ]
    for kw in bad:
        with pytest.raises(ValueError):
            pt.generate_fast_batched(tp, cfg, 0, 4, device="cpu", **kw)
    _, _, st = pt.generate_fast_batched(tp, cfg, 0, 2, return_state=True,
                                        device="cpu")
    with pytest.raises(ValueError):
        pt.generate_fast_batched(tp, cfg, 0, 2, [1], state=st, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pt.generate_fast_batched(tp, cfg, 0, 2)  # default device


def _bad_launches(cfg, w, prime, ring, lanes):
    def without(name):
        return {k: v for k, v in w.items() if k != name}

    def cut(name):
        return {**w, name: w[name][..., :-1].contiguous()}

    return {
        "w_skip_shape": dict(w=cut("w_skip")),
        "w_end1_shape": dict(w=cut("w_end1")),
        "missing_wf": dict(w=without("wf")),
        "exact_needs_w_out": dict(skip_slab=False),
        "ring_shape": dict(ring=ring[:-1]),
        "temps_shape": dict(temps=lanes[0][:-1]),
        "seeds_dtype": dict(seeds=lanes[1].long()),
        "empty_prime": dict(prime=prime[:, :0]),
        "no_steps": dict(total=0),
        "bad_tile": dict(tile=32),
        "odd_tile": dict(tile=3),
        "unfittable_tile": dict(tile=24, cfg=pt.get_config(
            "chaconne", residual_channels=64, dilation_channels=64)),
    }


@pytest.mark.parametrize("case", sorted(
    ["w_skip_shape", "w_end1_shape", "missing_wf", "exact_needs_w_out",
     "ring_shape", "temps_shape", "seeds_dtype", "empty_prime", "no_steps",
     "bad_tile", "odd_tile", "unfittable_tile"]))
def test_launcher_checks_operands_before_the_device(tiny, case):
    """Operands that disagree with the config raise before any launch,
    whatever their device; the kernel would read out of bounds."""
    _, _, cfg, tp = tiny
    w = ghbm.prepare_weights(tp, cfg, True, True)
    prime = torch.zeros((2, 3), dtype=torch.int32)
    ring = torch.zeros((ghbm.ring_rows(cfg), 2))
    lanes = (torch.zeros(2), torch.zeros(2, dtype=torch.int32),
             torch.zeros(2, dtype=torch.int32))
    args = dict(w=w, prime=prime, ring=ring, total=5, temps=lanes[0],
                seeds=lanes[1], toffs=lanes[2], skip_slab=True, tile=None,
                cfg=cfg)
    args.update(_bad_launches(cfg, w, prime, ring, lanes)[case])

    def launch(a):
        return ghbm.batched_cuda(a["w"], a["cfg"], a["prime"], a["ring"], 0,
                                 a["total"], a["temps"], a["seeds"],
                                 a["toffs"], 0, 0.0, True, a["skip_slab"],
                                 True, tile=a["tile"])

    with pytest.raises(ValueError) as err:
        launch(args)
    assert "CUDA tensors" not in str(err.value)
    if case == "unfittable_tile":
        assert "232448 bytes" in str(err.value)
    good = dict(w=w, prime=prime, ring=ring, total=5, temps=lanes[0],
                seeds=lanes[1], toffs=lanes[2], skip_slab=True, tile=None,
                cfg=cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        launch(good)
    assert ghbm.launches == 0


def _unpack_chain(chain, cfg, fuse_res, cluster):
    """The layer chain's weights back from the per-rank packing: the tap
    rows, w_cur, the gate biases, the residual weights and biases and wf
    (fuse_res), as full tensors."""
    L, k = cfg.num_layers, cfg.kernel_size
    R, D = cfg.residual_channels, cfg.dilation_channels
    d = ghbm.k1.chain_dims(cfg, cluster, fuse_res)
    ndm, nrm, nlt, KT = d["ndm"], d["nrm"], d["nlt"], d["KT"]
    taps = torch.full((L, KT, 2 * D), float("nan"))
    w_cur = torch.full((L, R, 2 * D), float("nan"))
    bz = torch.full((L, 2 * D), float("nan"))
    w_res = torch.full((L, D, R), float("nan"))
    b_res = torch.full((L, R), float("nan"))
    wf = torch.full((L, D, 2 * D), float("nan"))
    for q in range(cluster):
        row = chain[q]
        for m in range(nlt):
            if q + m * cluster < L:
                taps[q + m * cluster] = row[m * KT * 2 * D:
                                            (m + 1) * KT * 2 * D].view(KT, 2 * D)
        layers = row[d["base"]:].view(L, d["PL"])
        sizes = [R * 2 * ndm, 2 * ndm, D * nrm, nrm] + (
            [D * 2 * ndm] if fuse_res else [])
        parts = torch.split(layers, sizes, dim=1)
        for j in range(ndm):
            c = q + j * cluster
            if c < D:
                for col, slot in ((c, j), (D + c, ndm + j)):
                    w_cur[:, :, col] = parts[0].view(L, R, 2 * ndm)[:, :, slot]
                    bz[:, col] = parts[1][:, slot]
                    if fuse_res:
                        wf[:, :, col] = parts[4].view(L, D, 2 * ndm)[:, :, slot]
        for j in range(nrm):
            r = q + j * cluster
            if r < R:
                w_res[:, :, r] = parts[2].view(L, D, nrm)[:, :, j]
                b_res[:, r] = parts[3][:, j]
    return taps, w_cur, bz, w_res, b_res, wf


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("fuse_res,skip_slab", [(False, False), (True, True),
                                                (True, False)])
def test_chain_packing_round_trips(tiny, cluster, fuse_res, skip_slab):
    """Each rank's packed chain slice holds exactly prepare_weights' tensors
    for its channels and layers: unpacked, they equal them bitwise (at K4's
    cluster of 8 and at K1's 16)."""
    _, _, cfg, tp = tiny
    L, k, S = cfg.num_layers, cfg.kernel_size, cfg.skip_channels
    w = ghbm.prepare_weights(tp, cfg, fuse_res, skip_slab)
    assert tuple(w["chain"].shape) == (
        ghbm.CLUSTER, ghbm.k1.chain_dims(cfg, ghbm.CLUSTER, fuse_res)["F"])
    w["chain"] = ghbm.k1.pack_chain(w, cfg, fuse_res, skip_slab, cluster)
    assert tuple(w["chain"].shape) == (
        cluster, ghbm.k1.chain_dims(cfg, cluster, fuse_res)["F"])
    taps, w_cur, bz, w_res, b_res, wf = _unpack_chain(w["chain"], cfg,
                                                      fuse_res, cluster)
    R, D = cfg.residual_channels, cfg.dilation_channels
    assert torch.equal(taps, w["w_tap"][:, :k - 1].reshape(L, -1, 2 * D))
    assert torch.equal(w_cur, w["w_tap"][:, k - 1])
    want_bz = (torch.cat([w["b_in"][:1], w["bf"]]) if fuse_res
               else w["b_in"])
    assert torch.equal(bz, want_bz)
    if skip_slab:
        assert torch.equal(w_res, w["w_res"]) and torch.equal(b_res,
                                                              w["b_res"])
    else:
        assert torch.equal(w_res, w["w_out"][:, :, S:])
        assert torch.equal(b_res, w["b_out"][:, S:])
    if fuse_res:
        assert torch.equal(wf[:-1], w["wf"])
    # the kernel's own packing is the one at its cluster size
    if cluster == ghbm.CLUSTER:
        assert torch.equal(w["chain"], ghbm.prepare_weights(
            tp, cfg, fuse_res, skip_slab)["chain"])


@pytest.mark.parametrize("name,overrides", [
    ("chaconne", {}), ("saber", {}),
    ("chaconne", dict(residual_channels=64, dilation_channels=64))],
    ids=["chaconne", "saber", "R_D_64"])
@pytest.mark.parametrize("lanes", [1, 200, 256, 1024])
def test_default_tile_fits_shared_memory(name, overrides, lanes):
    """The default width fits a block's 232,448 bytes; at chaconne and
    saber the chain weights are resident in it; at R = D = 64 under
    fuse_res on 8 SMs they do not fit and are read from L2. ``active`` is
    what the card reports: 15 clusters of 8 at once on an H100
    (``max_active_clusters``, PERF.md)."""
    cfg = pt.get_config(name, **overrides)
    for fuse_res in (False, True):
        tile = ghbm.default_tile(lanes, cfg, fuse_res, lambda t: 15)
        assert tile in ghbm.TILES
        nbytes = ghbm.shared_bytes(cfg, tile, fuse_res)
        assert nbytes <= 232448
        resident = ghbm.k1.shared_bytes_for(cfg, tile, ghbm.CLUSTER,
                                            fuse_res)[1]
        assert resident or overrides
    if overrides:  # about 2.9 MB of chain weights: more than 8 SMs hold
        tile = ghbm.default_tile(lanes, cfg, True, lambda t: 15)
        assert not ghbm.k1.shared_bytes_for(cfg, tile, 8, True)[1]
    # serving's pool: every cluster at once on the card
    tile = ghbm.default_tile(256, pt.get_config("chaconne"), True,
                             lambda t: 15)
    assert -(-256 // tile) <= 15
    # no width runs 1024 lanes at once: the widest with the chain resident
    assert ghbm.default_tile(1024, pt.get_config("chaconne"), True,
                             lambda t: 15) == 24


@pytest.mark.parametrize("name", ["tiny", "tiny_vocoder"])
@pytest.mark.parametrize("variant", ["exact", "fuse_res"])
def test_headless_prime_steps_keep_ring_and_read_classes(name, variant):
    """Steps before ``head_from = num_given - 1`` run without the head: the
    ring and the classes from ``num_given - 1`` on are bitwise those of
    ``head_from = 0``, and each headless position holds the prime's next
    class (gap inf). fuse_res runs with skip_slab, the pool's flags."""
    fuse = variant == "fuse_res"
    cfg = pt.get_config(name, **({"gcond_channels": 3}
                                 if name == "tiny_vocoder" else {}))
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(21), "cpu")
    lanes = 3
    prime = torch.from_numpy(
        _prime(cfg, lanes, 21, cfg.receptive_field + 4)).to(torch.int32)
    ng = prime.shape[1]
    total = ng - 1 + 9
    w = ghbm.prepare_weights(params, cfg, fuse, fuse)
    temps = torch.tensor([0.0, 0.9, 1.0])
    seeds = torch.tensor([5, 6, 7], dtype=torch.int32)
    toffs = torch.tensor([0, 3, 1], dtype=torch.int32)
    kcond = gcond = None
    if cfg.cond_channels:
        g = torch.Generator().manual_seed(22)
        kcond = torch.randn((total, cfg.cond_channels, lanes), generator=g)
        gcond = ghbm.project_gcond(
            w, cfg, torch.randn((lanes, cfg.gcond_channels), generator=g),
            lanes)
    runs = []
    for head_from in (0, ng - 1):
        ring = torch.zeros(ghbm.ring_rows(cfg), lanes)
        cls, gaps = ghbm.batched_plain(
            w, cfg, prime, ring, 0, total, temps, seeds, toffs, 4, 0.05, fuse,
            fuse, True, return_gaps=True, cond=kcond, gcond=gcond,
            head_from=head_from)
        runs.append((cls, gaps, ring))
    (c0, g0, r0), (c1, g1, r1) = runs
    assert torch.equal(r0, r1)
    assert torch.equal(c0[:, ng - 1:], c1[:, ng - 1:])
    assert torch.equal(g0[:, ng - 1:], g1[:, ng - 1:])
    assert torch.equal(c1[:, :ng - 1], prime[:, 1:])
    assert bool(torch.isinf(g1[:, :ng - 1]).all())
    with pytest.raises(ValueError, match="head_from"):
        ghbm.batched_plain(w, cfg, prime, r1, 0, total, temps, seeds, toffs,
                           4, 0.05, fuse, fuse, True, cond=kcond, gcond=gcond,
                           head_from=ng)


def test_generate_fast_batched_primes_without_the_head(tiny, monkeypatch):
    """The entry point passes ``head_from = num_given - 1`` (0 for a resumed
    call), and its classes and state are those of the head on every step."""
    _, _, cfg, tp = tiny
    prime = _prime(cfg, 2, 12)
    seen, real = [], ghbm.batched_plain

    def full_head(*a, **k):
        seen.append(k["head_from"])
        return real(*a, **{**k, "head_from": 0})

    kw = dict(temperature=[0.0, 1.0], lane_seed=[1, 2], return_state=True,
              device="cpu")
    _, c, st = pt.generate_fast_batched(tp, cfg, 0, 11, prime, **kw)
    _, c2, _ = pt.generate_fast_batched(tp, cfg, 0, 5, state=st, **kw)
    monkeypatch.setattr(ghbm, "batched_plain", full_head)
    _, c_ref, st_ref = pt.generate_fast_batched(tp, cfg, 0, 11, prime, **kw)
    _, c2_ref, _ = pt.generate_fast_batched(tp, cfg, 0, 5, state=st_ref,
                                            **kw)
    assert seen == [prime.shape[1] - 1, 0]
    assert torch.equal(c, c_ref) and torch.equal(c2, c2_ref)
    assert torch.equal(st.ring, st_ref.ring) and torch.equal(st.cls,
                                                             st_ref.cls)
