"""The CUDA kernel K1 against its plain version, on a card (marked ``gpu``;
each test skips without one).

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch: ``python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (``--noconftest``: the suite's conftest imports
JAX)."""

import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch.ops.cuda import gen_kernel as gk


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
