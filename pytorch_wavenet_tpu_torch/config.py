"""Model configuration for the PyTorch/CUDA port.

The same frozen dataclass, field names and presets as the JAX package's
``pytorch_wavenet_tpu/config.py`` (copied, not imported: that package pulls
in JAX on import). Dtype fields hold ``torch.dtype``s; the JSON blob names
them the way the JAX package does (``"float32"``), so a config written by
either package reads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import torch

# JSON dtype name <-> torch dtype (the JAX package writes jnp.dtype(...).name)
_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def dtype_name(dtype: torch.dtype) -> str:
    for name, dt in _DTYPES.items():
        if dt == dtype:
            return name
    raise ValueError(f"unsupported dtype {dtype}")


@dataclasses.dataclass(frozen=True)
class WaveNetConfig:
    """Hyperparameters of a WaveNet stack (see the JAX package's
    ``WaveNetConfig`` for what each field means)."""

    layers: int = 10
    blocks: int = 4
    dilation_channels: int = 32
    residual_channels: int = 32
    skip_channels: int = 256
    end_channels: int = 256
    classes: int = 256
    output_length: int = 32
    kernel_size: int = 2
    bias: bool = False
    cond_channels: int = 0
    gcond_channels: int = 0
    cond_upsample: tuple[int, ...] = ()
    # "conv": the learnable transposed-conv stack of cond_upsample
    # (cond_up.s{i}); "phase": one scale a phase of the hop, shared over the
    # channels, and one bias (cond_up.w (hop,), cond_up.b (1,)), the
    # PytorchWaveNetVocoder's ConvTranspose2d(1, 1, (1, hop))
    cond_upsampler: str = "conv"
    # taps of the input convolution over the one-hot classes: 1 is the
    # start conv, 2 also reads x[t-1] through start.w_prev (a causal conv
    # of kernel 2, zero before the start)
    input_kernel: int = 1
    compute_dtype: Any = torch.float32
    stream_dtype: Any = torch.float32
    remat: bool = False
    fuse_skip: bool | None = None
    trunk_kernel: bool = False

    @property
    def num_layers(self) -> int:
        return self.blocks * self.layers

    @property
    def dilations(self) -> tuple[int, ...]:
        """Doubles each layer, resets per block."""
        return tuple(2 ** (i % self.layers) for i in range(self.num_layers))

    @property
    def max_dilation(self) -> int:
        return 2 ** (self.layers - 1)

    @property
    def receptive_field(self) -> int:
        """1 + blocks * (kernel_size-1) * (2^layers - 1): 3070 for 10x3,
        4093 for 10x4; one more for each input tap past the first (3071
        at wnv512)."""
        return (self.input_kernel + self.blocks * (self.kernel_size - 1)
                * (2**self.layers - 1))

    @property
    def item_length(self) -> int:
        return self.receptive_field + self.output_length - 1

    def parameter_count(self) -> int:
        """Analytic parameter count."""
        c, r, d, s, e, k = (
            self.classes,
            self.residual_channels,
            self.dilation_channels,
            self.skip_channels,
            self.end_channels,
            self.kernel_size,
        )
        n = self.input_kernel * c * r
        per_layer = 2 * (k * r * d) + d * r + d * s
        if self.cond_channels:
            per_layer += self.cond_channels * 2 * d
        if self.gcond_channels:
            per_layer += self.gcond_channels * 2 * d
        if self.bias:
            n += r
            per_layer += 2 * d + r + s
        n += self.num_layers * per_layer
        n += s * e + e
        n += e * c + c
        if self.cond_channels and self.cond_upsample:
            m = self.cond_channels
            if self.cond_upsampler == "phase":
                n += self.cond_hop + 1
            else:
                n += sum(2 * r * m * m for r in self.cond_upsample)
        return n

    @property
    def cond_hop(self) -> int:
        """Samples a conditioning frame spans: the product of
        ``cond_upsample``."""
        hop = 1
        for r in self.cond_upsample:
            hop *= r
        return hop

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["compute_dtype"] = dtype_name(self.compute_dtype)
        d["stream_dtype"] = dtype_name(self.stream_dtype)
        # fields newer than the JAX package's stay out of the blob at their
        # defaults, so a config either package writes reads as before
        for name in ("cond_upsampler", "input_kernel"):
            if d[name] == _DEFAULTS[name]:
                del d[name]
        return json.dumps(d)

    @classmethod
    def from_json(cls, s: str) -> "WaveNetConfig":
        d = json.loads(s)
        d["compute_dtype"] = _DTYPES[d["compute_dtype"]]
        # older snapshots predate the stream_dtype knob
        if "stream_dtype" in d:
            d["stream_dtype"] = _DTYPES[d["stream_dtype"]]
        if "cond_upsample" in d:
            d["cond_upsample"] = tuple(d["cond_upsample"])
        # unknown keys (older or newer writers) do not fail a load
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(WaveNetConfig)}

PRESETS: dict[str, WaveNetConfig] = {
    "chaconne": WaveNetConfig(
        layers=10,
        blocks=3,
        dilation_channels=32,
        residual_channels=32,
        skip_channels=1024,
        end_channels=512,
        output_length=16,
        bias=True,
    ),
    "saber": WaveNetConfig(
        layers=10,
        blocks=4,
        dilation_channels=32,
        residual_channels=32,
        skip_channels=32,
        end_channels=32,
        output_length=64,
        bias=False,
    ),
    "test_small": WaveNetConfig(
        layers=8,
        blocks=4,
        dilation_channels=16,
        residual_channels=16,
        skip_channels=32,
        end_channels=32,
        output_length=8,
        bias=False,
    ),
    "chaconne_wide": WaveNetConfig(
        layers=10,
        blocks=3,
        dilation_channels=32,
        residual_channels=32,
        skip_channels=1024,
        end_channels=512,
        output_length=1024,
        bias=True,
    ),
    "vocoder": WaveNetConfig(
        layers=10,
        blocks=3,
        dilation_channels=64,
        residual_channels=64,
        skip_channels=1024,
        end_channels=512,
        output_length=1024,
        bias=True,
        cond_channels=80,
    ),
    "tiny": WaveNetConfig(
        layers=3,
        blocks=2,
        dilation_channels=8,
        residual_channels=8,
        skip_channels=16,
        end_channels=16,
        classes=32,
        output_length=4,
        bias=True,
    ),
    "tiny_vocoder": WaveNetConfig(
        layers=3,
        blocks=2,
        dilation_channels=8,
        residual_channels=8,
        skip_channels=16,
        end_channels=16,
        classes=32,
        output_length=4,
        bias=True,
        cond_channels=8,
    ),
    # the WaveNet vocoder of kan-bayashi/PytorchWaveNetVocoder
    # (src/nets/wavenet.py; egs/arctic/sd/run.sh): 28-dimensional acoustic
    # frames at a 5 ms shift (80 samples at 16 kHz), 44,562,001 parameters
    "wnv512": WaveNetConfig(
        layers=10,
        blocks=3,
        dilation_channels=512,
        residual_channels=512,
        skip_channels=256,
        end_channels=256,
        classes=256,
        output_length=1024,
        bias=True,
        cond_channels=28,
        cond_upsample=(80,),
        cond_upsampler="phase",
        input_kernel=2,
    ),
    "tiny_wnv": WaveNetConfig(
        layers=3,
        blocks=2,
        dilation_channels=8,
        residual_channels=8,
        skip_channels=16,
        end_channels=16,
        classes=32,
        output_length=4,
        bias=True,
        cond_channels=4,
        cond_upsample=(4,),
        cond_upsampler="phase",
        input_kernel=2,
    ),
}


def get_config(name: str, **overrides) -> WaveNetConfig:
    cfg = PRESETS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
