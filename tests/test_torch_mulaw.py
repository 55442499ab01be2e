"""The port's mu-law codec against the JAX package's, numpy and on-device
versions, on seeded arrays and the edge values tests/test_mulaw.py pins."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_wavenet_tpu.ops import mulaw as jm
from pytorch_wavenet_tpu_torch.ops import mulaw as tm


@pytest.mark.parametrize("classes", [16, 256])
def test_numpy_codec_is_the_same(classes):
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, 2000)
    np.testing.assert_array_equal(tm.mu_law_encoding(x, classes),
                                  jm.mu_law_encoding(x, classes))
    np.testing.assert_array_equal(tm.mu_law_expansion(x, classes),
                                  jm.mu_law_expansion(x, classes))
    q = jm.quantize_data(x, classes)
    np.testing.assert_array_equal(tm.quantize_data(x, classes), q)
    np.testing.assert_array_equal(tm.dequantize_data(q, classes),
                                  jm.dequantize_data(q, classes))
    np.testing.assert_array_equal(tm.dequantize_to_f32(q, classes),
                                  jm.dequantize_to_f32(q, classes))


def test_edge_values():
    q = tm.quantize_data(np.array([-1.0, 0.0, 1.0]), 256)
    np.testing.assert_array_equal(q, jm.quantize_data(np.array([-1.0, 0.0, 1.0]), 256))
    assert q[0] == 0 and q[2] == 255
    edges = np.array([0, 128, 255])
    x = (edges / 256) * 2.0 - 1.0
    expected = np.sign(x) * (np.exp(np.abs(x) * np.log(257)) - 1) / 256
    np.testing.assert_allclose(tm.dequantize_data(edges, 256), expected,
                               rtol=1e-12)


@pytest.mark.parametrize("classes", [16, 256])
def test_torch_codec_matches_jnp(classes):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, 1000).astype(np.float32)
    # f32 transcendentals of two libraries: a few ulp apart
    np.testing.assert_allclose(
        tm.mu_law_encoding_torch(torch.from_numpy(x), classes).numpy(),
        np.asarray(jm.mu_law_encoding_jnp(jnp.asarray(x), classes)),
        atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(
        tm.mu_law_expansion_torch(torch.from_numpy(x), classes).numpy(),
        np.asarray(jm.mu_law_expansion_jnp(jnp.asarray(x), classes)),
        atol=1e-6, rtol=1e-5)
    # quantization differs only where f32 rounding straddles a bin edge
    qt = tm.quantize_data_torch(torch.from_numpy(x), classes).numpy()
    qj = np.asarray(jm.quantize_data_jnp(jnp.asarray(x), classes))
    assert np.abs(qt - qj).max() <= 1
    assert (qt != qj).mean() < 0.01


def test_torch_decode_matches_host_f32_decode():
    q = np.arange(256)
    dev = tm.dequantize_data_torch(torch.from_numpy(q), 256).numpy()
    np.testing.assert_allclose(dev, jm.dequantize_to_f32(q, 256),
                               atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(
        dev, np.asarray(jm.dequantize_data_jnp(jnp.asarray(q), 256)),
        atol=1e-6, rtol=1e-5)
