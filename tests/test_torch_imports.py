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
