"""The port imports neither JAX nor the JAX package, and importing it has
no side effects (no build, no device)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import pytorch_wavenet_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "pytorch_wavenet_tpu_torch.data.mel_dataset" in names
for new in ("data.native", "utils.tensorboard", "models.speculative",
            "models.iaf", "training.distill", "training.distill_cli",
            "utils.profiling", "generate_cli", "bench", "utils.visualize",
            "ops.dilated", "ops.queues", "scripts.make_demo_data",
            "scripts.benchmark", "scripts.serving_bench",
            "scripts.serving_soak", "scripts.distill_demo",
            "parallel.mesh", "parallel.sharding", "parallel.training",
            "parallel.data_sharding", "parallel.time_sharding",
            "parallel.pipeline", "scripts.scaling_bench",
            "serving._mesh_pool"):
    assert "pytorch_wavenet_tpu_torch." + new in names
banned = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack",
                                 "pytorch_wavenet_tpu")]
assert not banned, banned
from pytorch_wavenet_tpu_torch.ops.cuda import build, gen_kernel
assert not build._libs and gen_kernel.launches == 0
assert not build.BUILD_DIR.exists() or not any(build.BUILD_DIR.glob("*.tmp.*"))
print(len(names))
"""


def test_no_jax_import():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14  # every submodule was imported


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    for name in ("jax", "flax", "optax", "msgpack", "pytorch_wavenet_tpu."):
        assert f"import {name}" not in src
        assert f"from {name}" not in src
    assert "pytorch_wavenet_tpu import" not in src


_BLOCKED = """
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "pytorch_wavenet_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import pytorch_wavenet_tpu_torch.serving.batcher as bm
import pytorch_wavenet_tpu_torch.ops.cuda.gen_kernel_hbm as ghbm
from pytorch_wavenet_tpu_torch.serving import ContinuousBatcher
assert ghbm.launches == 0 and bm.ContinuousBatcher is ContinuousBatcher
print("ok")
"""


def test_batched_path_imports_with_jax_blocked():
    """The batcher and the batched kernel's module import with every import
    of JAX or of the JAX package made to fail."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_BLOCKED_TRAINING = _BLOCKED.split("import pytorch_wavenet_tpu_torch.serving")[0] + """
import pytorch_wavenet_tpu_torch.data.audio_io
import pytorch_wavenet_tpu_torch.data.dataset as ds
import pytorch_wavenet_tpu_torch.ops.cuda.trunk_kernel as tk
import pytorch_wavenet_tpu_torch.training.optimizers
import pytorch_wavenet_tpu_torch.training.train as cli
import pytorch_wavenet_tpu_torch.training.trainer as tr
import pytorch_wavenet_tpu_torch.utils.logging as lg
import pytorch_wavenet_tpu_torch.data.native as nat
import pytorch_wavenet_tpu_torch.serving.server as srv
import pytorch_wavenet_tpu_torch.training.optimizers as opt
import pytorch_wavenet_tpu_torch.utils.checkpoints as ck
import pytorch_wavenet_tpu_torch.utils.tensorboard as tb
from pytorch_wavenet_tpu_torch.ops.cuda import build
assert tk.fwd_launches == 0 and tk.bwd_launches == 0 and not build._libs
assert tr.WaveNetTrainer and ds.WaveNetDataset and lg.Logger and cli.main
assert tr.generate_audio and lg.TensorboardLogger and ck.AsyncCheckpointer
assert opt.MultiSteps and opt.with_ema and opt.sgd_normalized and tb.read_events
assert srv.find_ema_state_dict is opt.find_ema_state_dict
assert nat._lib is None and not nat._tried  # importing builds nothing
print("ok")
"""


def test_training_path_imports_with_jax_blocked():
    """The training modules (data layer with the native codec's bindings,
    trunk kernels' module, optimizers, trainer, CLI, loggers with the
    TensorBoard writer, the asynchronous checkpointer, the server with
    ``--ema``) import with every import of JAX or of the JAX package made
    to fail, and build nothing."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED_TRAINING], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_BLOCKED_VOCODER = _BLOCKED.split("import pytorch_wavenet_tpu_torch.serving")[0] + """
import numpy as np
import torch
import pytorch_wavenet_tpu_torch as pt
import pytorch_wavenet_tpu_torch.ops.mel as mel
import pytorch_wavenet_tpu_torch.serving.server as srv
from pytorch_wavenet_tpu_torch.ops.cuda import build, gen_kernel, gen_kernel_hbm
cfg = pt.get_config("tiny_vocoder", cond_upsample=(2, 2))
params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
frames = mel.log_mel_spectrogram(np.sin(np.arange(300) / 7.0), num_mels=8,
                                 n_fft=64, hop_length=4)
_, a = pt.synthesize(params, cfg, None, frames[:6], 4, temperature=0.0,
                     device="cpu")
_, b = pt.synthesize(params, cfg, 0, frames[:6], 4, temperature=0.0,
                     backend=pt.generate_fast_fused, device="cpu")
pool = pt.ContinuousBatcher(params, cfg, lanes=2, chunk=8, cond_hop=4,
                            device="cpu")
_, c = pool.submit([cfg.classes // 2], 24, temperature=0.0,
                   cond_frames=frames[:6], seed=0).result(timeout=60)
pool.close()
assert a.shape == (1, 24) and np.array_equal(a.numpy(), b.numpy())
assert c.shape == (24,) and srv.Synthesizer.vocode
assert gen_kernel.launches == 0 and gen_kernel_hbm.launches == 0
assert not build._libs
print("ok")
"""


def test_conditioned_paths_run_with_jax_blocked():
    """The vocoder's modules (log-mel features and upsamplers, synthesize,
    K1's and K4's conditioned plain versions, the batcher's frames mode,
    the server's /vocode) import and run on the CPU with every import of
    JAX or of the JAX package made to fail, and build nothing."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED_VOCODER], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_BLOCKED_DISTILL = _BLOCKED.split("import pytorch_wavenet_tpu_torch.serving")[0] + """
import torch
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch.models import iaf, speculative
from pytorch_wavenet_tpu_torch.ops.cuda import build, trunk_kernel
from pytorch_wavenet_tpu_torch.training import distill, distill_cli
import pytorch_wavenet_tpu_torch.serving.server as srv
cfg = pt.get_config("tiny", trunk_kernel=True)
params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
draft = pt.init_wavenet(pt.get_config("tiny", layers=2),
                        torch.Generator().manual_seed(1), "cpu")
_, cls, rate = pt.speculative_generate(params, cfg, draft,
                                       pt.get_config("tiny", layers=2), None,
                                       12, k=4, device="cpu")
scfg = pt.IAFConfig(flows=2, layers=2, residual_channels=4,
                    dilation_channels=4, skip_channels=4, end_channels=4)
student = pt.init_student(scfg, torch.Generator().manual_seed(2),
                          init_scale=0.2, device="cpu")
tx = pt.reference_adam(1e-3, gradient_clipping=1.0)
opt = tx.init(iaf.student_state_dict(student))
_, opt, loss, aux = pt.distill_step(student, opt, params, scfg, cfg, tx,
                                    torch.Generator().manual_seed(3), 2, 40)
wav = pt.student_generate(student, scfg, None, 32, device="cpu")
assert cls.shape == (1, 12) and 1.0 <= rate <= 4 and wav.shape == (1, 32)
assert torch.isfinite(loss) and opt["count"] == 1 and srv.Synthesizer
assert distill_cli.parse_args(["--teacher-snapshot", "x"]).device == "cuda"
assert trunk_kernel.fwd_launches == 0 and not build._libs
print("ok")
"""


def test_speculation_and_distillation_run_with_jax_blocked():
    """Speculation, the student, a distillation step with the teacher's
    trunk through K2's plain version, the distillation CLI's module and the
    server's student backend import and run on the CPU with every import of
    JAX or of the JAX package made to fail, and build nothing."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED_DISTILL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_BLOCKED_SLICE11 = _BLOCKED.split("import pytorch_wavenet_tpu_torch.serving")[0] + """
import os, tempfile
import numpy as np
import torch
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch import generate_cli
from pytorch_wavenet_tpu_torch.models import convert
from pytorch_wavenet_tpu_torch.ops.cuda import build, gen_kernel
from pytorch_wavenet_tpu_torch.utils import checkpoints as ck, profiling
from pytorch_wavenet_tpu_torch.utils.msgpack_lite import packb
import pytorch_wavenet_tpu_torch.serving.server as srv
cfg = pt.get_config("tiny")
params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
d = tempfile.mkdtemp()
_, a = pt.generate_long(params, cfg, 3, 40, chunk_size=16, fuse_res=True,
                        backend=pt.generate_fast_fused, device="cpu")
_, b = pt.generate_fast_fused(params, cfg, 3, 40, fuse_res=True, device="cpu")
assert torch.equal(a, b)
sd = convert.to_reference_state_dict(params, cfg)
torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}, os.path.join(d, "ref.pt"))
back, rcfg = pt.load_reference_snapshot(os.path.join(d, "ref.pt"),
                                        layers=cfg.layers, blocks=cfg.blocks,
                                        device="cpu")
for k in params:
    for n in params[k]:
        assert torch.equal(back[k][n], params[k][n]), (k, n)
# a one-process sharded checkpoint in the JAX package's layout
npp = pt.to_numpy_params(params)
skel = {k: {n: {"__sharded_array__": [list(v.shape), str(v.dtype)]}
            for n, v in d_.items()} for k, d_ in npp.items()}
shards = {f"params/{k}/{n}": [{"index": [[0, s] for s in v.shape],
                               "data": v}]
          for k, d_ in npp.items() for n, v in d_.items()}
sdir = os.path.join(d, "snaps", "m_0000000004.ckpt.sharded")
os.makedirs(sdir)
open(os.path.join(sdir, "shards_p0.msgpack"), "wb").write(
    packb({"process": 0, "shards": shards}))
open(os.path.join(sdir, "manifest.msgpack"), "wb").write(packb({
    "format": "pytorch_wavenet_tpu/sharded/1", "step": 4,
    "config": cfg.to_json(), "process_count": 1, "params": skel,
    "opt_state": None, "extra": {}}))
assert ck.latest_checkpoint(os.path.join(d, "snaps")) == sdir
blob = pt.load_checkpoint(sdir, "cpu")
assert blob["step"] == 4 and blob["config"] == cfg
assert all(torch.equal(blob["params"][k][n], params[k][n])
           for k in params for n in params[k])
with profiling.trace(os.path.join(d, "prof")) as path:
    pass
assert os.path.isfile(path)
out = os.path.join(d, "x.wav")
wav = generate_cli.main(["--snapshot-path", os.path.join(d, "snaps"),
                         "--num-samples", "8", "--out", out,
                         "--device", "cpu"])
assert wav.shape == (1, 8) and os.path.isfile(out)
assert srv.Synthesizer.reload and srv.BACKENDS
assert gen_kernel.launches == 0 and not build._libs
print("ok")
"""


def test_generation_and_serving_remainder_run_with_jax_blocked():
    """The sharded-checkpoint reader, ``generate_long``, the reference
    converters, profiling, the server's remainder and the generate CLI
    import and run on the CPU with every import of JAX or of the JAX
    package made to fail, and build nothing."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED_SLICE11], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


_BLOCKED_TOOLS = _BLOCKED.split("import pytorch_wavenet_tpu_torch.serving")[0] + """
import sys
import torch
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch import bench
from pytorch_wavenet_tpu_torch.ops import dilated, queues
from pytorch_wavenet_tpu_torch.ops.cuda import build, gen_kernel, gen_kernel_hbm
from pytorch_wavenet_tpu_torch.scripts import (benchmark, distill_demo,
                                               make_demo_data, serving_bench,
                                               serving_soak)
from pytorch_wavenet_tpu_torch.utils import visualize
# importing a tool runs nothing: no argument parsed, no device touched
assert bench.METRIC and benchmark.SWEEP and serving_soak.parse_args([])
assert serving_bench.parse_args([]).device == "cuda"
assert distill_demo.parse_args([]).teacher_steps == 4000
assert make_demo_data.synthesize(0.01, 0).size == 9600
q = pt.DilatedQueue.create(4, 2).enqueue(torch.ones(2))
assert float(q.dequeue()[0].sum()) == 2.0 and pt.dilate is dilated.dilate
cfg = pt.get_config("tiny")
params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
assert "total" in visualize.param_summary(params)
assert gen_kernel.launches == 0 and gen_kernel_hbm.launches == 0
assert not build._libs and queues.DilatedQueue is pt.DilatedQueue
print("ok")
"""


def test_tools_and_shims_import_with_jax_blocked():
    """The one-line metric, the single-card tools, the L0 shims and the
    visualization utilities import and run their host parts with every
    import of JAX or of the JAX package made to fail, and importing a tool
    runs nothing."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED_TOOLS], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


_BLOCKED_PARALLEL = _BLOCKED.split("import pytorch_wavenet_tpu_torch.serving")[0] + """
import torch
import torch.distributed as dist
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu_torch.parallel import (data_sharding, mesh, pipeline,
                                                sharding, time_sharding,
                                                training)
from pytorch_wavenet_tpu_torch.scripts import scaling_bench
from pytorch_wavenet_tpu_torch.ops.cuda import build
m = mesh.make_mesh(1, 1)
cfg = pt.get_config("tiny")
params = pt.init_wavenet(cfg, torch.Generator().manual_seed(0), "cpu")
back = sharding.gather_params(sharding.shard_params(params, cfg, m), cfg, m)
assert all(torch.equal(back[k][kk], params[k][kk]) for k in params
           for kk in params[k])
assert not dist.is_initialized() and not build._libs
assert scaling_bench.main and pipeline.PIPE_AXIS == "pipe"
print("ok")
"""


def test_parallel_path_imports_with_jax_blocked():
    """The multi-rank layer and ``scaling_bench`` import with every import
    of JAX or of the JAX package made to fail; on the trivial mesh the
    blocks are the params and no process group is formed."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED_PARALLEL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
