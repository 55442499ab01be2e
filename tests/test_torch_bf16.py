"""bf16 products in the port against the JAX package's.

The JAX package takes every product at ``compute_dtype=bfloat16`` as
``jnp.matmul(a.astype(bf16), w.astype(bf16), preferred_element_type=f32)``:
the inputs are rounded to bf16 and the product is kept in f32. The port
must do the same (round the inputs, then multiply in f32), never round the
product itself. Weights come from the JAX package's ``init_wavenet`` and
cross with ``from_jax_params``.

Tolerances: at ``tiny`` the two packages round the same inputs to bf16
and sum products of bf16 values, which are exact in f32, in nearly the
same order, so they agree to about 1e-8: atol = rtol = 1e-5. At
``test_small`` some inputs of a bf16 product are themselves f32 sums that
the two packages add in different orders; when such a sum lies near a bf16
rounding boundary the two round it to neighbouring bf16 values, one bf16
ulp apart (2**-8 relative), and that difference passes through the rest of
the network: 2e-4 to 3.2e-4 in the logits, so 1e-3 there. A product
rounded to bf16 (the fault) moves ``tiny``'s logits by 1.3e-3 to 1.6e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.models import generate as jg
from pytorch_wavenet_tpu.models.wavenet import embed_inputs as jax_embed
from pytorch_wavenet_tpu_torch.models import generate as tg

TOL = {"tiny": 1e-5, "test_small": 1e-3}


def _bf16(name):
    cfgj = dataclasses.replace(wt.get_config(name),
                               compute_dtype=jnp.bfloat16)
    cfgt = pt.get_config(name, compute_dtype=torch.bfloat16)
    jp = wt.init_wavenet(jax.random.PRNGKey(0), cfgj)
    tp = pt.from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    return cfgj, jp, cfgt, tp


@pytest.mark.parametrize("name,out_len", [("tiny", 8), ("tiny", 130),
                                          ("test_small", 16)])
def test_wavenet_logits_bf16_match_jax(name, out_len):
    cfgj, jp, cfgt, tp = _bf16(name)
    x = np.random.default_rng(1).integers(
        0, cfgj.classes, (2, cfgj.receptive_field + out_len - 1))
    yj = np.asarray(wt.wavenet_logits(jp, cfgj, jnp.asarray(x, jnp.int32),
                                      out_len=out_len))
    yt = pt.wavenet_logits(tp, cfgt, torch.from_numpy(x),
                           out_len=out_len).numpy()
    tol = TOL[name]
    np.testing.assert_allclose(yt, yj, atol=tol, rtol=tol)


def test_float_embed_bf16_matches_jax():
    """The embed of float inputs ``(N, T, classes)`` is a bf16 product too
    (soft inputs: a one-hot row picks one bf16 weight, which a second
    rounding leaves as it is). A sum of 32 products, in either order: 1e-6."""
    cfgj, jp, cfgt, tp = _bf16("tiny")
    x = np.random.default_rng(2).uniform(0, 1, (2, 9, cfgj.classes))
    x = x.astype(np.float32)
    hj = np.asarray(jax_embed(jp, cfgj, jnp.asarray(x)))
    ht = pt.embed_inputs(tp, cfgt, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ht, hj, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["tiny", "test_small"])
def test_gen_step_bf16_matches_jax(name):
    cfgj, jp, cfgt, tp = _bf16(name)
    n = 40
    seq = np.random.default_rng(3).integers(0, cfgj.classes, (2, n))
    js = jg.init_gen_state(cfgj, 2)
    ts = tg.init_gen_state(cfgt, 2, device="cpu")
    tol = TOL[name]
    for i in range(n):
        lj, js = jg.gen_step(jp, cfgj, js, jnp.asarray(seq[:, i], jnp.int32))
        lt, ts = tg.gen_step(tp, cfgt, ts, torch.from_numpy(seq[:, i]))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=tol,
                                   rtol=tol)
