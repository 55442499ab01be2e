"""The port's config against the JAX package's: presets, JSON both ways,
derived sizes."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt

_DTYPE_FIELDS = ("compute_dtype", "stream_dtype")
# the port's fields and presets the JAX package has no counterpart of (the
# PytorchWaveNetVocoder's kernel-2 input and phase-scale upsampler); on
# every shared preset the fields sit at their defaults
PORT_ONLY_FIELDS = {"input_kernel": 1, "cond_upsampler": "conv"}
PORT_ONLY_PRESETS = {"wnv512", "tiny_wnv"}


def _plain_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in _DTYPE_FIELDS and f.name not in PORT_ONLY_FIELDS}


def _port_only_at_defaults(ct):
    return all(getattr(ct, k) == v for k, v in PORT_ONLY_FIELDS.items())


def test_same_preset_names():
    assert set(pt.PRESETS) - PORT_ONLY_PRESETS == set(wt.config.PRESETS)
    assert PORT_ONLY_PRESETS <= set(pt.PRESETS)


@pytest.mark.parametrize("name", sorted(wt.config.PRESETS))
def test_preset_matches_field_by_field(name):
    cj, ct = wt.get_config(name), pt.get_config(name)
    assert [f.name for f in dataclasses.fields(cj)] == \
        [f.name for f in dataclasses.fields(ct)
         if f.name not in PORT_ONLY_FIELDS]
    assert _plain_fields(cj) == _plain_fields(ct)
    assert _port_only_at_defaults(ct)
    for f in _DTYPE_FIELDS:
        assert np.dtype(getattr(cj, f)).name == \
            pt.config.dtype_name(getattr(ct, f))
    assert cj.receptive_field == ct.receptive_field
    assert cj.item_length == ct.item_length
    assert cj.dilations == ct.dilations
    assert cj.parameter_count() == ct.parameter_count()


@pytest.mark.parametrize("name", ["chaconne", "saber", "tiny", "vocoder"])
def test_json_reads_across_packages(name):
    import jax.numpy as jnp

    cj = wt.get_config(name, compute_dtype=jnp.bfloat16, cond_upsample=(4, 4))
    ct = pt.WaveNetConfig.from_json(cj.to_json())
    assert ct.compute_dtype == torch.bfloat16
    assert ct.cond_upsample == (4, 4)
    assert _plain_fields(ct) == _plain_fields(cj)
    assert _port_only_at_defaults(ct)
    back = wt.WaveNetConfig.from_json(ct.to_json())
    assert back == cj


def test_from_json_ignores_unknown_keys():
    import json

    d = json.loads(pt.get_config("tiny").to_json())
    d["some_future_knob"] = 3
    assert pt.WaveNetConfig.from_json(json.dumps(d)) == pt.get_config("tiny")


@pytest.mark.parametrize("name", ["tiny", "test_small", "chaconne"])
def test_parameter_count_of_init(name):
    cfg = pt.get_config(name)
    params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    jp = wt.init_wavenet(jax.random.PRNGKey(0), wt.get_config(name))
    assert pt.parameter_count(params) == cfg.parameter_count() == \
        wt.parameter_count(jp)
