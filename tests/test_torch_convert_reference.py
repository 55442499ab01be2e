"""The port's reference-snapshot converters against the JAX package's
``models/convert.py``, on the CPU.

Every converter is held to the JAX one on the same reference state dict:
configs equal (their JSON), params equal bitwise through
``to_numpy_params`` (both only transpose and copy), the round trip through
``to_reference_state_dict`` exact. Whole-module pickles are fabricated as
``tests/test_convert.py`` fabricates them (a stub ``wavenet_model``
module, never the reference package). The (layers, blocks) split is never
guessed, and the module's attributes are cross-checked. The converted
model's logits agree with JAX ``wavenet_logits`` within atol = rtol =
1e-5, and with the independent torch convolution oracle of
``tests/test_convert.py``.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.models import convert as jconv
from pytorch_wavenet_tpu_torch.models import convert as tconv
from test_convert import (_random_state_dict, _save_reference_like_module,
                          _torch_reference_forward)

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = {
    "bias-k2": dict(layers=3, blocks=2, dilation_channels=4,
                    residual_channels=6, skip_channels=5, end_channels=7,
                    classes=16, bias=True),
    "nobias-k3": dict(layers=2, blocks=3, dilation_channels=5,
                      residual_channels=4, skip_channels=6, end_channels=3,
                      classes=8, kernel_size=3),
}


def _case(name, seed=0):
    cfg = wt.WaveNetConfig(**CASES[name])
    return cfg, _random_state_dict(cfg, seed=seed)


def _assert_params_equal(tp, jp):
    a = pt.to_numpy_params(tp)
    b = {k: {n: np.asarray(v) for n, v in d.items()} for k, d in jp.items()}
    assert sorted(a) == sorted(b)
    for k in a:
        assert sorted(a[k]) == sorted(b[k]), k
        for n in a[k]:
            assert a[k][n].dtype == b[k][n].dtype, (k, n)
            assert np.array_equal(a[k][n], b[k][n]), (k, n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_config_from_state_dict_matches_jax(name):
    cfg, sd = _case(name)
    L, B = cfg.layers, cfg.blocks
    for kw in (dict(layers=L), dict(blocks=B), dict(layers=L, blocks=B),
               dict(layers=L, blocks=B, output_length=7)):
        got = tconv.config_from_state_dict(sd, **kw)
        assert isinstance(got, pt.WaveNetConfig)
        assert got.to_json() == jconv.config_from_state_dict(sd, **kw).to_json()
    assert got.dilations == cfg.dilations and got.output_length == 7


@pytest.mark.parametrize("name", sorted(CASES))
def test_from_and_to_reference_state_dict_match_jax(name):
    cfg, sd = _case(name, seed=3)
    tcfg = pt.WaveNetConfig(**CASES[name])
    tp = tconv.from_reference_state_dict(sd, tcfg, "cpu")
    jp = jconv.from_reference_state_dict(sd, cfg)
    _assert_params_equal(tp, jp)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for d in tp.values() for t in d.values())
    back = tconv.to_reference_state_dict(tp, tcfg)
    jback = jconv.to_reference_state_dict(jp, cfg)
    assert sorted(back) == sorted(jback) == sorted(sd)
    for k in sd:
        assert np.array_equal(back[k], jback[k]), k
        assert np.array_equal(back[k], sd[k]), k


def test_the_split_is_never_guessed():
    cfg = wt.WaveNetConfig(layers=3, blocks=2, dilation_channels=4,
                           residual_channels=4, skip_channels=4,
                           end_channels=4, classes=8)
    sd = _random_state_dict(cfg, seed=12)
    for mod in (tconv, jconv):
        with pytest.raises(ValueError, match="layers, blocks"):
            mod.config_from_state_dict(sd)
        with pytest.raises(ValueError, match="not divisible"):
            mod.config_from_state_dict(sd, layers=4)
        with pytest.raises(ValueError, match="not divisible"):
            mod.config_from_state_dict(sd, blocks=4)
        with pytest.raises(ValueError, match=r"layers\*blocks"):
            mod.config_from_state_dict(sd, layers=3, blocks=3)


def test_whole_module_pickle_chaconne_shaped(tmp_path):
    """A 10x3-shaped module (thin channels) loads with the 3 x (2^0..2^9)
    schedule and rf 3070, equal to the JAX package's load; the stub
    modules leave ``sys.modules`` as they found it."""
    cfg = wt.WaveNetConfig(layers=10, blocks=3, dilation_channels=2,
                           residual_channels=2, skip_channels=4,
                           end_channels=4, classes=8, output_length=16,
                           bias=True)
    sd = _random_state_dict(cfg, seed=13)
    path = str(tmp_path / "chaconne_shaped.pt")
    _save_reference_like_module(cfg, sd, path)
    before = set(sys.modules)
    tp, tcfg = tconv.load_reference_snapshot(path, device="cpu")
    assert set(sys.modules) == before
    jp, jcfg = jconv.load_reference_snapshot(path)
    assert tcfg.to_json() == jcfg.to_json()
    assert tcfg.layers == 10 and tcfg.blocks == 3
    assert tcfg.receptive_field == 3070 and tcfg.output_length == 16
    _assert_params_equal(tp, jp)
    tsd, tarch = tconv.load_torch_snapshot(path)
    jsd, jarch = jconv.load_torch_snapshot(path)
    assert tarch == jarch and tarch["layers"] == 10
    assert sorted(tsd) == sorted(jsd)
    assert all(np.array_equal(tsd[k], jsd[k]) for k in tsd)
    assert tconv.config_from_snapshot_arch(tsd, tarch).to_json() == \
        jconv.config_from_snapshot_arch(jsd, jarch).to_json()
    # explicit arguments win over the pickled attributes
    tp5, tcfg5 = tconv.load_reference_snapshot(path, layers=5, blocks=6,
                                               device="cpu")
    _, jcfg5 = jconv.load_reference_snapshot(path, layers=5, blocks=6)
    assert tcfg5.to_json() == jcfg5.to_json() and tcfg5.blocks == 6
    # overrides go to the config
    _, bcfg = tconv.load_reference_snapshot(
        path, device="cpu", compute_dtype=torch.bfloat16)
    assert bcfg.compute_dtype == torch.bfloat16


def test_bare_state_dict_needs_the_split(tmp_path):
    cfg = wt.WaveNetConfig(layers=2, blocks=2, dilation_channels=4,
                           residual_channels=4, skip_channels=4,
                           end_channels=4, classes=8)
    sd = _random_state_dict(cfg, seed=16)
    path = str(tmp_path / "bare.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    assert tconv.load_torch_snapshot(path)[1] is None
    with pytest.raises(ValueError, match="layers, blocks"):
        tconv.load_reference_snapshot(path, device="cpu")
    tp, tcfg = tconv.load_reference_snapshot(path, layers=2, blocks=2,
                                             device="cpu")
    jp, jcfg = jconv.load_reference_snapshot(path, layers=2, blocks=2)
    assert tcfg.to_json() == jcfg.to_json()
    _assert_params_equal(tp, jp)


@pytest.mark.parametrize("attr,value,match", [
    ("kernel_size", 3, "kernel_size"),
    ("classes", 9, "classes"),
    ("dilations", [(1, 1), (1, 1), (1, 2), (2, 1)], "dilation schedule"),
    ("receptive_field", 99, "receptive_field"),
])
def test_cross_check_errors(attr, value, match):
    cfg = wt.WaveNetConfig(layers=2, blocks=2, dilation_channels=4,
                           residual_channels=4, skip_channels=4,
                           end_channels=4, classes=8)
    sd = _random_state_dict(cfg, seed=17)
    arch = {"layers": 2, "blocks": 2, "kernel_size": 2, "classes": 8,
            "dilations": [(1, 1), (2, 1), (1, 2), (2, 1)],
            "receptive_field": cfg.receptive_field}
    assert tconv.config_from_snapshot_arch(sd, arch).to_json() == \
        jconv.config_from_snapshot_arch(sd, arch).to_json()
    arch[attr] = value
    for mod in (tconv, jconv):
        with pytest.raises(ValueError, match=match):
            mod.config_from_snapshot_arch(sd, arch)


def test_converted_logits_match_jax_and_the_oracle(tmp_path):
    cfg = wt.WaveNetConfig(layers=3, blocks=2, dilation_channels=8,
                           residual_channels=8, skip_channels=8,
                           end_channels=8, classes=16, output_length=5,
                           bias=True)
    sd = _random_state_dict(cfg, seed=14)
    path = str(tmp_path / "snap_module.pt")
    _save_reference_like_module(cfg, sd, path)
    tp, tcfg = tconv.load_reference_snapshot(path, device="cpu")
    jp, jcfg = jconv.load_reference_snapshot(path)
    x = np.random.default_rng(15).integers(
        0, cfg.classes, (2, tcfg.receptive_field + 4))
    lt = pt.wavenet_logits(tp, tcfg, torch.from_numpy(x)).numpy()
    lj = np.asarray(wt.wavenet_logits(jp, jcfg, jnp.asarray(x)))
    np.testing.assert_allclose(lt, lj, **TOL)
    oracle = _torch_reference_forward(sd, cfg, x).transpose(0, 2, 1)
    np.testing.assert_allclose(lt, oracle[:, -lt.shape[1]:], **TOL)
