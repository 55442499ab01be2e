"""Carry params between the JAX package's numpy trees, reference torch
snapshots and the port.

Both packages use the same nested layout (``models/wavenet.py``; the
student's flows are a tuple, ``models/iaf.py``), so conversion is a
leaf-by-leaf copy; checkpoints and the tests go through
:func:`from_jax_params` and :func:`to_numpy_params`.

The reference (pytorch-wavenet) pickles whole ``WaveNetModel`` modules;
:func:`load_reference_snapshot` reads one (or a bare state dict) into the
port's params and config. Layout (a torch Conv1d weight is ``(out_ch,
in_ch, k)``):

* ``start_conv.weight (R, C, 1)``        -> ``start.w (C, R)``
* ``filter_convs.{i}.weight (D, R, k)``  -> ``layers.w_in[i, j, r, :D]``,
  kernel index j == tap j (oldest tap first: tap j reads time ``t -
  (k-1-j)*d``)
* ``gate_convs.{i}.weight``              -> ``layers.w_in[i, j, r, D:]``
* ``residual_convs.{i}.weight (R, D, 1)`` -> ``layers.w_res[i] (D, R)``
* ``skip_convs.{i}.weight (S, D, 1)``    -> ``layers.w_skip[i] (D, S)``
* ``end_conv_1.weight (E, S, 1)``        -> ``end1.w (S, E)``; bias kept
* ``end_conv_2.weight (C, E, 1)``        -> ``end2.w (E, C)``; bias kept

The WaveNet vocoder of kan-bayashi/PytorchWaveNetVocoder
(``src/nets/wavenet.py``, class ``WaveNet``) has a layout of its own, read
by :func:`from_wnv_state_dict` into a config with ``input_kernel`` 2 and
the phase-scale upsampler (the ``wnv512`` preset).
"""

from __future__ import annotations

import dataclasses
import sys
import types
from typing import Mapping

import numpy as np
import torch

from ..config import WaveNetConfig
from ..device import resolve_device


def from_jax_params(tree, device: str | torch.device = "cuda"):
    """Nested dicts, tuples and lists of array-likes (numpy, or anything
    ``np.asarray`` takes) -> the same tree of torch tensors on ``device``
    (lists become tuples, as JAX's pytrees hold the student's flows)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return tuple(conv(v) for v in x)
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def to_numpy_params(params):
    """Port params -> the same dicts of numpy arrays (host copies; numpy
    leaves pass through, and None stays None: optax's empty optional
    states, such as ``sgd_normalized`` without momentum). Tuples and lists
    become dicts keyed ``"0"``, ``"1"``, ...: flax's state-dict layout, the
    one checkpoints store (the student's flows)."""
    if params is None:
        return None
    if isinstance(params, dict):
        return {k: to_numpy_params(v) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return {str(i): to_numpy_params(v) for i, v in enumerate(params)}
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return np.asarray(params)


def config_from_state_dict(sd: Mapping[str, np.ndarray], *,
                           layers: int | None = None,
                           blocks: int | None = None,
                           output_length: int | None = None
                           ) -> WaveNetConfig:
    """The architecture from parameter shapes.

    Widths, kernel size and bias follow from the shapes; the (layers,
    blocks) split does not: every gated layer's conv has the same shape
    whatever its dilation, so a flat state dict cannot show where the
    doubling schedule restarts, and a wrong guess gives a wrong receptive
    field and a wrong rollout. So the split must be passed (``layers``
    and/or ``blocks``), or read off a whole-module pickle by
    :func:`load_reference_snapshot`."""
    n = len({k.split(".")[1] for k in sd if k.startswith("filter_convs.")})
    if layers is None and blocks is None:
        raise ValueError(
            f"state dict has {n} gated layers but the (layers, blocks) "
            "split is not recoverable from parameter shapes: pass layers= "
            "and/or blocks=, or load the whole-module snapshot with "
            "load_reference_snapshot(), which carries them")
    if layers is None:
        if n % blocks:
            raise ValueError(f"{n} layers not divisible by blocks={blocks}")
        layers = n // blocks
    if blocks is None:
        if n % layers:
            raise ValueError(f"{n} layers not divisible by layers={layers}")
        blocks = n // layers
    if layers * blocks != n:
        raise ValueError(f"layers*blocks = {layers}*{blocks} != {n} gated "
                         "layers found in the state dict")
    D, R, k = sd["filter_convs.0.weight"].shape
    kwargs = dict(
        layers=layers, blocks=blocks, dilation_channels=D,
        residual_channels=R, skip_channels=sd["skip_convs.0.weight"].shape[0],
        end_channels=sd["end_conv_1.weight"].shape[0],
        classes=sd["end_conv_2.weight"].shape[0], kernel_size=k,
        bias="filter_convs.0.bias" in sd)
    if output_length is not None:
        kwargs["output_length"] = output_length
    return WaveNetConfig(**kwargs)


def from_reference_state_dict(sd: Mapping[str, np.ndarray],
                              cfg: WaveNetConfig,
                              device: str | torch.device = "cuda"):
    """The port's params (f32 tensors on ``device``) from reference-named
    arrays."""
    L, k = cfg.num_layers, cfg.kernel_size
    R, D, S = cfg.residual_channels, cfg.dilation_channels, cfg.skip_channels

    def w(name):
        return np.asarray(sd[name], dtype=np.float32)

    w_in = np.zeros((L, k, R, 2 * D), np.float32)
    w_res = np.zeros((L, D, R), np.float32)
    w_skip = np.zeros((L, D, S), np.float32)
    for i in range(L):
        w_in[i, :, :, :D] = w(f"filter_convs.{i}.weight").transpose(2, 1, 0)
        w_in[i, :, :, D:] = w(f"gate_convs.{i}.weight").transpose(2, 1, 0)
        w_res[i] = w(f"residual_convs.{i}.weight")[:, :, 0].T
        w_skip[i] = w(f"skip_convs.{i}.weight")[:, :, 0].T
    params = {
        "start": {"w": w("start_conv.weight")[:, :, 0].T},
        "layers": {"w_in": w_in, "w_res": w_res, "w_skip": w_skip},
        "end1": {"w": w("end_conv_1.weight")[:, :, 0].T,
                 "b": w("end_conv_1.bias")},
        "end2": {"w": w("end_conv_2.weight")[:, :, 0].T,
                 "b": w("end_conv_2.bias")},
    }
    if cfg.bias:
        params["start"]["b"] = w("start_conv.bias")
        b_in = np.zeros((L, 2 * D), np.float32)
        b_res = np.zeros((L, R), np.float32)
        b_skip = np.zeros((L, S), np.float32)
        for i in range(L):
            b_in[i, :D] = w(f"filter_convs.{i}.bias")
            b_in[i, D:] = w(f"gate_convs.{i}.bias")
            b_res[i] = w(f"residual_convs.{i}.bias")
            b_skip[i] = w(f"skip_convs.{i}.bias")
        params["layers"].update(b_in=b_in, b_res=b_res, b_skip=b_skip)
    return from_jax_params(params, device)


def from_wnv_state_dict(sd: Mapping[str, np.ndarray], cfg: WaveNetConfig,
                        device: str | torch.device = "cuda"):
    """The port's params from a PytorchWaveNetVocoder ``WaveNet`` state dict
    (Conv1d weights ``(out_ch, in_ch, k)``, kernel index 0 the older tap):

    * ``causal.conv.weight (R, C, 2)`` -> ``start.w_prev`` (tap 0, the
      previous class) and ``start.w`` (tap 1), ``causal.conv.bias`` ->
      ``start.b``
    * ``dil_tanh.{l}.conv`` -> ``layers.w_in[l, :, :, :D]``,
      ``dil_sigmoid.{l}.conv`` -> ``layers.w_in[l, :, :, D:]`` (the port
      gates ``tanh(first half) * sigmoid(second half)``)
    * ``aux_1x1_tanh.{l}`` / ``aux_1x1_sigmoid.{l}`` ``(D, M, 1)`` ->
      ``layers.w_cond[l]``'s two halves; each half of ``layers.b_in[l]`` is
      the dilated conv's bias plus the aux conv's
    * ``res_1x1.{l}`` -> ``layers.w_res``/``b_res``, ``skip_1x1.{l}`` ->
      ``layers.w_skip``/``b_skip``
    * ``conv_post_1`` / ``conv_post_2`` -> ``end1`` / ``end2``
    * ``upsampling.conv.weight (1, 1, 1, hop)`` -> ``cond_up.w (hop,)``,
      its bias -> ``cond_up.b (1,)``"""
    if cfg.input_kernel != 2 or cfg.cond_upsampler != "phase" \
            or cfg.kernel_size != 2 or not cfg.bias:
        raise ValueError("the vocoder's layout needs input_kernel 2, "
                         "kernel_size 2, bias and the phase upsampler")
    L, R, D = cfg.num_layers, cfg.residual_channels, cfg.dilation_channels

    def w(name):
        return np.asarray(sd[name], dtype=np.float32)

    causal = w("causal.conv.weight")
    lay = {n: np.zeros(shape, np.float32) for n, shape in (
        ("w_in", (L, 2, R, 2 * D)), ("b_in", (L, 2 * D)),
        ("w_cond", (L, cfg.cond_channels, 2 * D)),
        ("w_res", (L, D, R)), ("b_res", (L, R)),
        ("w_skip", (L, D, cfg.skip_channels)),
        ("b_skip", (L, cfg.skip_channels)))}
    for i in range(L):
        for half, gate in ((slice(0, D), "tanh"), (slice(D, 2 * D),
                                                    "sigmoid")):
            lay["w_in"][i, :, :, half] = w(
                f"dil_{gate}.{i}.conv.weight").transpose(2, 1, 0)
            lay["w_cond"][i, :, half] = w(
                f"aux_1x1_{gate}.{i}.weight")[:, :, 0].T
            lay["b_in"][i, half] = (w(f"dil_{gate}.{i}.conv.bias")
                                    + w(f"aux_1x1_{gate}.{i}.bias"))
        lay["w_res"][i] = w(f"res_1x1.{i}.weight")[:, :, 0].T
        lay["b_res"][i] = w(f"res_1x1.{i}.bias")
        lay["w_skip"][i] = w(f"skip_1x1.{i}.weight")[:, :, 0].T
        lay["b_skip"][i] = w(f"skip_1x1.{i}.bias")
    params = {
        "start": {"w": causal[:, :, 1].T, "w_prev": causal[:, :, 0].T,
                  "b": w("causal.conv.bias")},
        "layers": lay,
        "end1": {"w": w("conv_post_1.weight")[:, :, 0].T,
                 "b": w("conv_post_1.bias")},
        "end2": {"w": w("conv_post_2.weight")[:, :, 0].T,
                 "b": w("conv_post_2.bias")},
        "cond_up": {"w": w("upsampling.conv.weight").reshape(-1),
                    "b": w("upsampling.conv.bias").reshape(1)},
    }
    if params["cond_up"]["w"].shape != (cfg.cond_hop,):
        raise ValueError(f"upsampling.conv holds "
                         f"{params['cond_up']['w'].shape[0]} phases, the "
                         f"config's hop is {cfg.cond_hop}")
    return from_jax_params(params, device)


def to_reference_state_dict(params, cfg: WaveNetConfig) -> dict:
    """The inverse of :func:`from_reference_state_dict`: reference-named
    numpy arrays (a snapshot a reference user can inspect)."""
    p = to_numpy_params(params)
    L, D = cfg.num_layers, cfg.dilation_channels
    lp = p["layers"]
    sd = {
        "start_conv.weight": p["start"]["w"].T[:, :, None],
        "end_conv_1.weight": p["end1"]["w"].T[:, :, None],
        "end_conv_1.bias": p["end1"]["b"],
        "end_conv_2.weight": p["end2"]["w"].T[:, :, None],
        "end_conv_2.bias": p["end2"]["b"],
    }
    for i in range(L):
        w_in = lp["w_in"][i]  # (k, R, 2D)
        sd[f"filter_convs.{i}.weight"] = w_in[:, :, :D].transpose(2, 1, 0)
        sd[f"gate_convs.{i}.weight"] = w_in[:, :, D:].transpose(2, 1, 0)
        sd[f"residual_convs.{i}.weight"] = lp["w_res"][i].T[:, :, None]
        sd[f"skip_convs.{i}.weight"] = lp["w_skip"][i].T[:, :, None]
        if cfg.bias:
            sd[f"filter_convs.{i}.bias"] = lp["b_in"][i][:D]
            sd[f"gate_convs.{i}.bias"] = lp["b_in"][i][D:]
            sd[f"residual_convs.{i}.bias"] = lp["b_res"][i]
            sd[f"skip_convs.{i}.bias"] = lp["b_skip"][i]
    if cfg.bias:
        sd["start_conv.bias"] = p["start"]["b"]
    return sd


# the reference module's attributes that pin the architecture;
# ``dilations`` is the per-layer (new_dilation, init_dilation) schedule,
# redundant with (layers, blocks) and kept for the cross-check
_ARCH_ATTRS = ("layers", "blocks", "kernel_size", "classes", "output_length",
               "dilations", "receptive_field")


def _stub_reference_modules() -> dict:
    """Importable stand-ins for the reference's modules, so that a
    whole-module pickle (``torch.save(model, ...)``) unpickles without the
    reference package. Pickle rebuilds an ``nn.Module`` subclass without
    calling ``__init__``, so an empty subclass of the right name gets the
    real parameter tree (``state_dict()`` works) and the plain attributes;
    other classes in the pickle (the generation queues) become featureless
    objects."""
    stubs = {}
    for name in ("wavenet_model", "wavenet_modules"):
        mod = types.ModuleType(name)
        mod.__getattr__ = (
            lambda attr, _name=name: _make_stub_class(_name, attr))
        stubs[name] = mod
    return stubs


def _make_stub_class(module_name: str, attr: str):
    if attr.startswith("__"):
        raise AttributeError(attr)
    base = (torch.nn.Module,) if attr == "WaveNetModel" else ()
    cls = type(attr, base, {})
    cls.__module__ = module_name
    return cls


def load_torch_snapshot(path: str) -> tuple[dict, dict | None]:
    """Read a reference snapshot file: ``(state_dict, arch)``, the state
    dict as reference-named numpy arrays and ``arch`` the pickled module's
    architecture attributes (``layers``, ``blocks``, ``kernel_size``, ...),
    or None for a bare state dict, which carries none.

    A whole-module pickle is read with stub modules put into
    ``sys.modules`` for the load and taken out again. It is a pickle:
    ``torch.load(weights_only=False)`` runs what the file says, so load
    only snapshots you trust."""
    stubs = _stub_reference_modules()
    injected = [n for n in stubs if n not in sys.modules]
    for n in injected:
        sys.modules[n] = stubs[n]
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    finally:
        for n in injected:
            sys.modules.pop(n, None)
    arch = None
    if hasattr(obj, "state_dict"):
        sd = obj.state_dict()
        arch = {a: getattr(obj, a) for a in _ARCH_ATTRS if hasattr(obj, a)}
    else:
        sd = obj
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}, arch


def config_from_snapshot_arch(sd: Mapping[str, np.ndarray],
                              arch: Mapping) -> WaveNetConfig:
    """A config from a state dict and the pickled module's architecture
    attributes, each cross-checked against the other."""
    cfg = config_from_state_dict(
        sd, layers=int(arch["layers"]), blocks=int(arch["blocks"]),
        output_length=(int(arch["output_length"]) if "output_length" in arch
                       else None))
    if "kernel_size" in arch and int(arch["kernel_size"]) != cfg.kernel_size:
        raise ValueError(f"module says kernel_size={arch['kernel_size']} but "
                         f"weights have k={cfg.kernel_size}")
    if "classes" in arch and int(arch["classes"]) != cfg.classes:
        raise ValueError(f"module says classes={arch['classes']} but weights "
                         f"have C={cfg.classes}")
    if "dilations" in arch and arch["dilations"]:
        got = tuple(int(d[0]) if isinstance(d, (tuple, list)) else int(d)
                    for d in arch["dilations"])
        if got != cfg.dilations:
            raise ValueError(
                f"module dilation schedule {got} does not match the "
                f"(layers={cfg.layers}, blocks={cfg.blocks}) doubling "
                f"schedule {cfg.dilations}")
    if ("receptive_field" in arch
            and int(arch["receptive_field"]) != cfg.receptive_field):
        raise ValueError(f"module receptive_field={arch['receptive_field']} "
                         f"!= derived {cfg.receptive_field}")
    return cfg


def load_reference_snapshot(path: str, *, layers: int | None = None,
                            blocks: int | None = None,
                            output_length: int | None = None,
                            device: str | torch.device = "cuda",
                            **config_overrides):
    """A reference snapshot as ``(params, cfg)``, the params on ``device``.

    Whole-module pickles carry their architecture; bare state dicts need
    the (layers, blocks) split passed. Explicit arguments win over the
    pickled attributes. ``config_overrides`` go to ``dataclasses.replace``
    on the config (e.g. ``compute_dtype=torch.bfloat16``)."""
    sd, arch = load_torch_snapshot(path)
    if arch is not None and "layers" in arch and "blocks" in arch:
        if layers is not None or blocks is not None \
                or output_length is not None:
            cfg = config_from_state_dict(
                sd,
                layers=int(arch["layers"]) if layers is None else layers,
                blocks=int(arch["blocks"]) if blocks is None else blocks,
                output_length=output_length)
        else:
            cfg = config_from_snapshot_arch(sd, arch)
    else:
        cfg = config_from_state_dict(sd, layers=layers, blocks=blocks,
                                     output_length=output_length)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    return from_reference_state_dict(sd, cfg, device), cfg
