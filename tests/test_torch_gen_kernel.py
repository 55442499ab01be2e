"""The fused generation loop (kernel K1): its plain PyTorch version on the
CPU against the JAX package's Pallas kernel in interpret mode, the
streaming state and the counter-hash noise. The CUDA kernel itself is
tested on a card in test_torch_gpu.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.models.generate import buffer_length
from pytorch_wavenet_tpu.ops.pallas.gen_kernel import (
    generate_fast_fused as jax_fused,
)
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel as gk


def _np_params(cfg, seed):
    shapes = jax.eval_shape(lambda: wt.init_wavenet(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: rng.uniform(-0.3, 0.3, s.shape).astype(np.float32), shapes)


@pytest.fixture(scope="module")
def tiny():
    cfgj, cfgt = wt.get_config("tiny"), pt.get_config("tiny")
    npp = _np_params(cfgj, 0)
    return (cfgj, jax.tree.map(jnp.asarray, npp), cfgt,
            pt.from_jax_params(npp, "cpu"))


def _prime(cfg, streams, seed, length=None):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.classes,
                        (streams, length or cfg.receptive_field))


CASES = {
    "full_rf_prime": dict(prime=("rf", 2), n=40),
    "short_prime": dict(prime=(3, 1), n=32),
    "default_prime": dict(prime=None, n=12),
    "wraparound": dict(prime=("rf", 1), n="wrap"),
    "regularize": dict(prime=("rf", 2), n=24, regularize=0.05),
    "fuse_res": dict(prime=("rf", 2), n=40, fuse_res=True),
    "fuse_res_short_prime": dict(prime=(5, 3), n=30, fuse_res=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_pallas_kernel(tiny, case):
    cfgj, jp, cfgt, tp = tiny
    spec = CASES[case]
    n = spec["n"] if spec["n"] != "wrap" else 2 * buffer_length(cfgj) + 3
    prime = None
    if spec["prime"] is not None:
        length, streams = spec["prime"]
        prime = _prime(cfgj, streams, 7,
                       cfgj.receptive_field if length == "rf" else length)
    kw = dict(temperature=0.0, regularize=spec.get("regularize", 0.0),
              fuse_res=spec.get("fuse_res", False))
    _, cj, sj = jax_fused(
        jp, cfgj, jax.random.PRNGKey(0), n,
        None if prime is None else jnp.asarray(prime, jnp.int32),
        return_state=True, interpret=True, **kw)
    before = gk.launches
    _, ct, st = pt.generate_fast_fused(tp, cfgt, 0, n, prime,
                                       return_state=True, device="cpu", **kw)
    assert gk.launches == before  # the plain version launches nothing
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    # the streaming state has the JAX package's layout and values
    assert st.t == int(sj.t)
    np.testing.assert_array_equal(st.cls.numpy(), np.asarray(sj.cls))
    for rt, rj in zip(st.rings, sj.rings):
        assert tuple(rt.shape) == rj.shape
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj),
                                   atol=1e-5, rtol=1e-5)


def test_plain_matches_generate_fast_at_t0(tiny):
    _, _, cfg, tp = tiny
    prime = _prime(cfg, 3, 8)
    _, cf = pt.generate_fast_fused(tp, cfg, 0, 30, prime, temperature=0.0,
                                   device="cpu")
    _, cx = pt.generate_fast(tp, cfg, None, 30, prime, temperature=0.0,
                             device="cpu")
    np.testing.assert_array_equal(cf.numpy(), cx.numpy())


@pytest.mark.parametrize("temperature,fuse_res", [
    (0.0, False), (1.0, False), (0.7, True),
])
def test_resume_equals_one_shot_bitwise(tiny, temperature, fuse_res):
    _, _, cfg, tp = tiny
    prime = _prime(cfg, 2, 9)
    kw = dict(temperature=temperature, fuse_res=fuse_res, device="cpu")
    w_all, c_all = pt.generate_fast_fused(tp, cfg, 21, 60, prime, **kw)
    _, c1, st = pt.generate_fast_fused(tp, cfg, 21, 25, prime,
                                       return_state=True, **kw)
    _, c2, st = pt.generate_fast_fused(tp, cfg, 21, 20, None, state=st,
                                       return_state=True, **kw)
    w3, c3 = pt.generate_fast_fused(tp, cfg, 21, 15, None, state=st, **kw)
    assert torch.equal(torch.cat([c1, c2, c3], dim=1), c_all)
    assert torch.equal(w3, w_all[:, -15:])
    assert st.t == cfg.receptive_field - 1 + 45


def test_same_seed_same_rollout_at_temperature(tiny):
    _, _, cfg, tp = tiny
    prime = _prime(cfg, 2, 10, 4)
    runs = [pt.generate_fast_fused(tp, cfg, seed, 48, prime, temperature=1.0,
                                   device="cpu")[1] for seed in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    gen = [pt.generate_fast_fused(
        tp, cfg, torch.Generator().manual_seed(3), 16, prime,
        temperature=1.0, device="cpu")[1] for _ in range(2)]
    assert torch.equal(gen[0], gen[1])


def test_hash_noise_matches_uint32_arithmetic():
    """The int64-masked hash equals the same mixing in numpy uint32, whose
    arithmetic wraps like the kernel's."""
    streams, classes, seed = 3, 40, 123456789
    for ta in (0, 1, 77, 2**31 - 5):
        got = gk.hash_uniform(ta, seed, streams, classes, "cpu").numpy()
        c = np.arange(classes, dtype=np.uint32)[None, :]
        s = np.arange(streams, dtype=np.uint32)[:, None]
        with np.errstate(over="ignore"):
            x = (c * np.uint32(streams) + s) * np.uint32(0x9E3779B9)
            x ^= np.uint32(ta) * np.uint32(0x85EBCA6B)
            x ^= np.uint32(seed)
            x ^= x >> np.uint32(16)
            x *= np.uint32(0x85EBCA6B)
            x ^= x >> np.uint32(13)
            x *= np.uint32(0xC2B2AE35)
            x ^= x >> np.uint32(16)
        u = (x >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24))
        u = np.clip(u, np.float32(1e-7), np.float32(1.0 - 1e-7))
        np.testing.assert_array_equal(got, u)
        # f32 logarithms of two libraries: a few ulp apart
        np.testing.assert_allclose(
            gk.hash_gumbel(ta, seed, streams, classes, "cpu").numpy(),
            -np.log(-np.log(u)), atol=1e-6)


def test_wrapper_rejects_bad_inputs(tiny):
    _, _, cfg, tp = tiny
    with pytest.raises(ValueError):
        pt.generate_fast_fused(tp, cfg, 0, 4, np.zeros((9, 3), np.int64),
                               device="cpu")
    with pytest.raises(ValueError):
        pt.generate_fast_fused(tp, cfg, 0, 4, [1, cfg.classes], device="cpu")
    _, _, st = pt.generate_fast_fused(tp, cfg, 0, 2, return_state=True,
                                      device="cpu")
    with pytest.raises(ValueError):
        pt.generate_fast_fused(tp, cfg, 0, 2, [1], state=st, device="cpu")
    with pytest.raises(ValueError):
        pt.generate_fast_fused(tp, cfg, 0, 4, np.zeros((1, 0), np.int64),
                               device="cpu")


def _bad_operands(cfg, w, prime, rings):
    """Each case breaks one operand of the launcher."""
    def without(name):
        return {k: v for k, v in w.items() if k != name}

    def reshaped(name):
        return {**w, name: w[name][..., :-1].contiguous()}

    return {
        "w_out_shape": (reshaped("w_out"), prime, 5, True),
        "w_end2_shape": (reshaped("w_end2"), prime, 5, True),
        "w_tap_shape": (reshaped("w_tap"), prime, 5, False),
        "missing_wf": (without("wf"), prime, 5, True),
        "empty_prime": (w, prime[:, :0], 5, True),
        "no_steps": (w, prime, 0, True),
        "nine_streams": (w, prime.repeat(9, 1), 5, True),
        "bad_cluster": ({**w, "chain": torch.zeros((8, w["chain"].shape[1]))},
                        prime, 5, True),
    }


@pytest.mark.parametrize("case", ["w_out_shape", "w_end2_shape", "w_tap_shape",
                                  "missing_wf", "empty_prime", "no_steps",
                                  "nine_streams", "bad_cluster"])
def test_launcher_checks_operands_before_the_device(tiny, case):
    """Operands that disagree with the config raise before any launch,
    whatever their device; the kernel would read out of bounds."""
    _, _, cfg, tp = tiny
    w = gk.prepare_weights(tp, cfg, True)
    prime = torch.zeros((1, 2), dtype=torch.int32)
    rings = torch.zeros(sum(gk.periods(cfg)) * cfg.residual_channels)
    bw, bprime, total, fuse = _bad_operands(cfg, w, prime, rings)[case]
    with pytest.raises(ValueError) as err:
        gk.fused_cuda(bw, cfg, bprime, rings, 0, total, 0.0, 0.0, 0, fuse)
    assert "CUDA tensors" not in str(err.value)
    # the well-formed call gets as far as the device check
    with pytest.raises(ValueError, match="CUDA tensors"):
        gk.fused_cuda(w, cfg, prime, rings, 0, 5, 0.0, 0.0, 0, True)
    assert gk.launches == 0


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("fuse_res", [False, True])
def test_chain_packing_round_trips(tiny, cluster, fuse_res):
    """K1's packed chain: rank q holds the tap rows of layers q + m*cluster
    and, per layer, its gate columns (channels q + j*cluster) of w_cur and
    of the gate bias (bf under fuse_res), its residual columns of w_out's
    residual part and b_out's, and its columns of wf; the rest is 0 (at
    K1's cluster of 16 and at K4's 8)."""
    _, _, cfg, tp = tiny
    L, k, S = cfg.num_layers, cfg.kernel_size, cfg.skip_channels
    R, D = cfg.residual_channels, cfg.dilation_channels
    w = gk.prepare_weights(tp, cfg, fuse_res)
    assert w["chain"].shape[0] == gk.CLUSTER
    w["chain"] = gk.pack_chain(w, cfg, fuse_res, False, cluster)
    d = gk.chain_dims(cfg, cluster, fuse_res)
    assert tuple(w["chain"].shape) == (cluster, d["F"])
    bz = torch.cat([w["b_in"][:1], w["bf"]]) if fuse_res else w["b_in"]
    for q in range(cluster):
        row = w["chain"][q]
        taps = row[:d["base"]].view(d["nlt"], d["KT"], 2 * D)
        for m in range(d["nlt"]):
            l = q + m * cluster
            want = (w["w_tap"][l, :k - 1].reshape(d["KT"], 2 * D) if l < L
                    else torch.zeros(d["KT"], 2 * D))
            assert torch.equal(taps[m], want)
        layers = row[d["base"]:].view(L, d["PL"])
        sizes = [R * 2 * d["ndm"], 2 * d["ndm"], D * d["nrm"], d["nrm"]] + (
            [D * 2 * d["ndm"]] if fuse_res else [])
        wc, b, wr, br, *wf = torch.split(layers, sizes, dim=1)
        c = q + cluster * torch.arange(d["ndm"])
        cols = torch.cat([c, D + c])
        ok = torch.cat([c < D, c < D])
        assert torch.equal(wc.view(L, R, -1)[:, :, ok],
                           w["w_tap"][:, k - 1][:, :, cols[ok]])
        assert not wc.view(L, R, -1)[:, :, ~ok].any()
        assert torch.equal(b[:, ok], bz[:, cols[ok]])
        r = q + cluster * torch.arange(d["nrm"])
        rk = r < R
        assert torch.equal(wr.view(L, D, -1)[:, :, rk],
                           w["w_out"][:, :, S + r[rk]])
        assert torch.equal(br[:, rk], w["b_out"][:, S + r[rk]])
        if fuse_res:
            got = wf[0].view(L, D, -1)
            assert torch.equal(got[:-1][:, :, ok], w["wf"][:, :, cols[ok]])
            assert not got[-1].any()


@pytest.mark.parametrize("name", ["chaconne", "saber", "test_small"])
def test_shared_bytes_fit_a_block(name):
    """K1's one 8-lane tile fits a block's 232,448 bytes, chain weights
    resident in its cluster of 16."""
    cfg = pt.get_config(name)
    for fuse_res in (False, True):
        assert gk.shared_bytes(cfg, fuse_res) <= 232448
        assert gk.shared_bytes_for(cfg, gk.MAX_STREAMS, gk.CLUSTER,
                                   fuse_res)[1]


@pytest.mark.parametrize("kernel_size", [1, 2, 3])
def test_owned_layer_slot_holds_taps_and_h(kernel_size):
    """A rank's slot per owned layer holds the layer's (k-1)R tap rows and,
    once they are consumed, its R rows of h until the ring write: at
    kernel_size 1 there are no taps and the slot is still R rows (the
    kernel would otherwise keep every layer's h over the tap products)."""
    cfg = pt.get_config("chaconne", kernel_size=kernel_size)
    R, tile = cfg.residual_channels, gk.MAX_STREAMS
    d = gk.chain_dims(cfg, gk.CLUSTER, True)
    assert d["KT"] == (kernel_size - 1) * R
    assert d["TS"] == max(d["KT"], R)
    one = pt.get_config("chaconne", kernel_size=1)
    two = pt.get_config("chaconne", kernel_size=2)
    # k = 1 and k = 2 differ only in the tap weights, which stay in L2
    assert (gk.shared_bytes_for(one, tile, gk.CLUSTER, True)
            == gk.shared_bytes_for(two, tile, gk.CLUSTER, True))


@pytest.mark.parametrize("name", ["tiny", "tiny_vocoder"])
@pytest.mark.parametrize("fuse_res", [False, True], ids=["exact", "fuse_res"])
def test_headless_prime_steps_keep_rings_and_read_classes(name, fuse_res):
    """Steps before ``head_from = num_given - 1`` run without the head: the
    rings and the classes from ``num_given - 1`` on are bitwise those of
    ``head_from = 0``, and each headless position holds the prime's next
    class (gap inf); ``tiny_vocoder`` with projected cond and global cond
    rows."""
    cfg = pt.get_config(name, **({"gcond_channels": 3}
                                 if name == "tiny_vocoder" else {}))
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(4), "cpu")
    streams = 3
    prime = torch.from_numpy(
        _prime(cfg, streams, 4, cfg.receptive_field + 4)).to(torch.int32)
    ng = prime.shape[1]
    total = ng - 1 + 9
    cond = glob = None
    if cfg.cond_channels:
        g = torch.Generator().manual_seed(5)
        cond = torch.randn((streams, total, cfg.cond_channels), generator=g)
        glob = torch.randn((streams, cfg.gcond_channels), generator=g)
    cproj, gproj = gk.project_cond(params, cfg, cond, glob, streams, total)
    w = gk.prepare_weights(params, cfg, fuse_res)
    runs = []
    for head_from in (0, ng - 1):
        rings = torch.zeros(sum(gk.periods(cfg)) * streams
                            * cfg.residual_channels)
        cls, gaps = gk.fused_plain(w, cfg, prime, rings, 0, total, 0.9, 0.05,
                                   7, fuse_res, return_gaps=True, cond=cproj,
                                   gcond=gproj, head_from=head_from)
        runs.append((cls, gaps, rings))
    (c0, g0, r0), (c1, g1, r1) = runs
    assert torch.equal(r0, r1)
    assert torch.equal(c0[:, ng - 1:], c1[:, ng - 1:])
    assert torch.equal(g0[:, ng - 1:], g1[:, ng - 1:])
    assert torch.equal(c1[:, :ng - 1], prime[:, 1:])
    assert bool(torch.isinf(g1[:, :ng - 1]).all())
    with pytest.raises(ValueError, match="head_from"):
        gk.fused_plain(w, cfg, prime, r1, 0, total, 0.9, 0.05, 7, fuse_res,
                       cond=cproj, gcond=gproj, head_from=-1)


def test_generate_fast_fused_primes_without_the_head(tiny, monkeypatch):
    """The entry point passes ``head_from = num_given - 1`` (0 for a resumed
    call), and its classes and state are those of the head on every step."""
    _, _, cfg, tp = tiny
    prime = _prime(cfg, 2, 13)
    seen, real = [], gk.fused_plain

    def full_head(*a, **k):
        seen.append(k["head_from"])
        return real(*a, **{**k, "head_from": 0})

    kw = dict(temperature=1.0, return_state=True, device="cpu")
    _, c, st = pt.generate_fast_fused(tp, cfg, 3, 11, prime, **kw)
    _, c2, _ = pt.generate_fast_fused(tp, cfg, 3, 5, state=st, **kw)
    monkeypatch.setattr(gk, "fused_plain", full_head)
    _, c_ref, st_ref = pt.generate_fast_fused(tp, cfg, 3, 11, prime, **kw)
    _, c2_ref, _ = pt.generate_fast_fused(tp, cfg, 3, 5, state=st_ref, **kw)
    assert seen == [prime.shape[1] - 1, 0]
    assert torch.equal(c, c_ref) and torch.equal(c2, c2_ref)
    assert all(torch.equal(a, b) for a, b in zip(st.rings, st_ref.rings))
    assert torch.equal(st.cls, st_ref.cls)
