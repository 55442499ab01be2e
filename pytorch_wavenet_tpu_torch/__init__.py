"""pytorch_wavenet_tpu_torch: the PyTorch/CUDA port of pytorch_wavenet_tpu.

WaveNet for one NVIDIA H100: the plain PyTorch model, Fast-WaveNet
generation, checkpoints in the JAX package's format, single-stream serving
through a hand-written CUDA kernel for the fused generation loop
(``ops/cuda/gen_kernel.py``), and continuous-batching serving of many
streams (``serving/batcher.py``) through a hand-written CUDA kernel for
batched generation (``ops/cuda/gen_kernel_hbm.py``), and training
(``training/``: the numpy data layer, the reference Adam, the trainer and
its CLI) with the trunk through hand-written CUDA kernels for its forward
and backward (``ops/cuda/trunk_kernel.py``); the kernel sources are in
``csrc/``. Importing the package
builds nothing and touches no device; kernels build with ``nvcc`` at first
use. Entry points take ``device`` (default ``"cuda"``, which raises when no
card is present); ``device="cpu"`` runs the plain PyTorch versions.
"""

from .config import PRESETS, WaveNetConfig, get_config
from .data.audio_io import load_audio, write_wav
from .data.dataset import BatchIterator, PrefetchBatchIterator, WaveNetDataset
from .models.convert import from_jax_params, to_numpy_params
from .models.generate import (
    GenState,
    StreamState,
    buffer_length,
    gen_step,
    generate,
    generate_fast,
    init_gen_state,
)
from .models.wavenet import (
    embed_inputs,
    forward,
    init_wavenet,
    parameter_count,
    wavenet_logits,
)
from .ops.cuda.gen_kernel import FusedGenState, generate_fast_fused
from .ops.cuda.gen_kernel_hbm import HbmGenState, generate_fast_batched
from .ops.cuda.trunk_kernel import fused_trunk
from .serving.batcher import ContinuousBatcher
from .ops.mulaw import (
    dequantize_data,
    dequantize_to_f32,
    mu_law_encoding,
    mu_law_expansion,
    quantize_data,
)
from .training.optimizers import reference_adam
from .training.trainer import (
    WaveNetTrainer,
    cross_entropy_loss,
    eval_step,
    train_step,
)
from .utils.logging import Logger
from .utils.checkpoints import (
    latest_checkpoint,
    load_checkpoint,
    load_latest_model_from,
    save_checkpoint,
)

__all__ = [
    "PRESETS", "WaveNetConfig", "get_config",
    "load_audio", "write_wav", "BatchIterator", "PrefetchBatchIterator",
    "WaveNetDataset",
    "from_jax_params", "to_numpy_params",
    "GenState", "StreamState", "buffer_length", "gen_step", "generate",
    "generate_fast", "init_gen_state",
    "embed_inputs", "forward", "init_wavenet", "parameter_count",
    "wavenet_logits",
    "FusedGenState", "generate_fast_fused",
    "HbmGenState", "generate_fast_batched", "ContinuousBatcher",
    "fused_trunk", "reference_adam", "WaveNetTrainer", "cross_entropy_loss",
    "eval_step", "train_step", "Logger",
    "dequantize_data", "dequantize_to_f32", "mu_law_encoding",
    "mu_law_expansion", "quantize_data",
    "latest_checkpoint", "load_checkpoint", "load_latest_model_from",
    "save_checkpoint",
]
