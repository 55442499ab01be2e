"""pytorch_wavenet_tpu_torch: the PyTorch/CUDA port of pytorch_wavenet_tpu.

WaveNet for one NVIDIA H100: the plain PyTorch model, Fast-WaveNet
generation, the mel-conditioned vocoder (``ops/mel.py``,
``models.generate.synthesize``), checkpoints in the JAX package's format,
single-stream serving
through a hand-written CUDA kernel for the fused generation loop
(``ops/cuda/gen_kernel.py``), and continuous-batching serving of many
streams (``serving/batcher.py``) through a hand-written CUDA kernel for
batched generation (``ops/cuda/gen_kernel_hbm.py``), and training
(``training/``: the data layer with the vocoder's mel features and the
native audio codec, the reference Adam with schedules, SGDNormalized, an
EMA and gradient accumulation, the trainer with asynchronous snapshots,
TensorBoard logging and the audio hook, and its CLI) with the trunk
through hand-written CUDA kernels for its forward
and backward (``ops/cuda/trunk_kernel.py``); speculative decoding over the
window API (``models/speculative.py``), and Parallel-WaveNet distillation
(``models/iaf.py``, ``training/distill.py`` and its CLI, the teacher
scored through the forward kernel) with the server's student backend; the
reference's L0 shims (``ops/dilated.py``, ``ops/queues.py``), graph and
parameter summaries (``utils/visualize.py``), and the single-card tools
(``bench.py``, the one-line metric; ``scripts/``: ``benchmark``,
``serving_bench``, ``serving_soak``, ``distill_demo``, ``make_demo_data``,
each run as ``python -m pytorch_wavenet_tpu_torch.scripts.<name>``); the
multi-rank layer on ``torch.distributed`` (``parallel/``: meshes, the
data- and model-parallel train step, sharded generation and pool step,
time sharding, pipelined generation; the trainer's and the training CLI's
mesh mode with sharded snapshots; ``scripts.scaling_bench``); the
kernel sources are in ``csrc/``. Importing the package
builds nothing and touches no device; kernels build with ``nvcc`` at first
use. Entry points take ``device`` (default ``"cuda"``, which raises when no
card is present); ``device="cpu"`` runs the plain PyTorch versions.
"""

from .config import PRESETS, WaveNetConfig, get_config
from .data.audio_io import list_all_audio_files, load_audio, write_wav
from .data.dataset import BatchIterator, PrefetchBatchIterator, WaveNetDataset
from .data.mel_dataset import MelWaveNetDataset
from .models.convert import (
    config_from_state_dict,
    from_jax_params,
    from_reference_state_dict,
    load_reference_snapshot,
    load_torch_snapshot,
    to_numpy_params,
    to_reference_state_dict,
)
from .models.generate import (
    GenState,
    PendingWindow,
    StreamState,
    buffer_length,
    commit_window,
    gen_step,
    gen_step_window,
    generate,
    generate_fast,
    generate_long,
    init_gen_state,
    synthesize,
)
from .models.iaf import (
    IAFConfig,
    init_student,
    student_generate,
    student_sample,
    student_synthesize,
)
from .models.speculative import speculative_generate
from .models.wavenet import (
    embed_inputs,
    forward,
    init_wavenet,
    parameter_count,
    upsample_cond,
    wavenet_logits,
)
from .ops.cuda.gen_kernel import FusedGenState, generate_fast_fused
from .ops.cuda.gen_kernel_hbm import HbmGenState, generate_fast_batched
from .ops.cuda.trunk_kernel import fused_trunk
from .ops.dilated import constant_pad_1d, dilate
from .ops.queues import DilatedQueue
from .serving.batcher import ContinuousBatcher
from .ops.mulaw import (
    dequantize_data,
    dequantize_to_f32,
    mu_law_encoding,
    mu_law_expansion,
    quantize_data,
)
from .training.distill import distill_loss, distill_step
from .training.optimizers import (
    MultiSteps,
    ema_params,
    lr_schedule,
    reference_adam,
    sgd_normalized,
    with_ema,
)
from .training.trainer import (
    WaveNetTrainer,
    cross_entropy_loss,
    eval_step,
    generate_audio,
    train_step,
)
from .utils.logging import Logger, TensorboardLogger
from .utils.checkpoints import (
    AsyncCheckpointer,
    latest_checkpoint,
    load_checkpoint,
    load_checkpoint_sharded,
    load_latest_model_from,
    save_checkpoint,
)

__all__ = [
    "PRESETS", "WaveNetConfig", "get_config",
    "load_audio", "write_wav", "list_all_audio_files", "BatchIterator",
    "PrefetchBatchIterator",
    "WaveNetDataset", "MelWaveNetDataset",
    "from_jax_params", "to_numpy_params", "config_from_state_dict",
    "from_reference_state_dict", "to_reference_state_dict",
    "load_reference_snapshot", "load_torch_snapshot",
    "GenState", "StreamState", "buffer_length", "gen_step", "generate",
    "generate_fast", "generate_long", "init_gen_state", "synthesize", "PendingWindow",
    "gen_step_window", "commit_window", "speculative_generate",
    "IAFConfig", "init_student", "student_sample", "student_generate",
    "student_synthesize", "distill_loss", "distill_step",
    "embed_inputs", "forward", "init_wavenet", "parameter_count",
    "upsample_cond", "wavenet_logits",
    "FusedGenState", "generate_fast_fused",
    "HbmGenState", "generate_fast_batched", "ContinuousBatcher",
    "fused_trunk", "constant_pad_1d", "dilate", "DilatedQueue",
    "reference_adam", "lr_schedule", "sgd_normalized",
    "with_ema", "ema_params", "MultiSteps", "WaveNetTrainer",
    "cross_entropy_loss",
    "eval_step", "generate_audio", "train_step", "Logger",
    "TensorboardLogger", "AsyncCheckpointer",
    "dequantize_data", "dequantize_to_f32", "mu_law_encoding",
    "mu_law_expansion", "quantize_data",
    "latest_checkpoint", "load_checkpoint", "load_checkpoint_sharded",
    "load_latest_model_from",
    "save_checkpoint",
]
