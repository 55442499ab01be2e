"""Nothing the harness runs loads JAX or the JAX package, and the
reference loads nothing of the port. Each check runs in a fresh process
under an import hook that refuses a module by the whole of its top-level
name (the part before the first dot), so ``pytorch_wavenet_tpu_torch``
passes where ``pytorch_wavenet_tpu`` is refused."""

import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

HOOK = """
import sys
REFUSED = set({refused!r})
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".", 1)[0] in REFUSED:
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {root!r})
"""


def _run(refused, body):
    code = HOOK.format(refused=sorted(refused), root=str(ROOT)) + \
        textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)


def test_the_hook_compares_whole_names():
    r = _run({"pytorch_wavenet_tpu"}, """
        import pytorch_wavenet_tpu_torch
        try:
            import pytorch_wavenet_tpu
        except ImportError:
            print("refused")
    """)
    assert r.returncode == 0, r.stderr
    assert "refused" in r.stdout


def test_harness_runs_without_jax():
    # every module of the harness, and a whole run of each kind at a tiny
    # size on the CPU, which loads what the port's entry points load
    r = _run({"jax", "jaxlib", "flax", "pytorch_wavenet_tpu"}, """
        import pkgutil, importlib, wavebench
        for m in pkgutil.walk_packages(wavebench.__path__, "wavebench."):
            if ".tests" not in m.name:
                importlib.import_module(m.name)
        from wavebench.tests.helpers import run_tiny
        from wavebench.bench import forbidden_modules
        for cell in ("chaconne.stream", "chaconne.pool_saturated",
                     "chaconne.pool_open"):
            assert run_tiny(cell, seconds=0.5)["correct"], cell
        assert forbidden_modules() == [], forbidden_modules()
        print("ok")
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ok" in r.stdout


def test_reference_imports_nothing_of_the_port():
    r = _run({"jax", "jaxlib", "flax", "pytorch_wavenet_tpu",
              "pytorch_wavenet_tpu_torch"}, """
        import wavebench.reference.wavenet, wavebench.reference.noise
        import wavebench.reference.judge, wavebench.roofline
        import wavebench.inputs, wavebench.traffic
        print("ok")
    """)
    assert r.returncode == 0, r.stderr[-3000:]
    imports = re.compile(r"^\s*(from|import)\s+(\.\.|pytorch_wavenet_tpu"
                         r"|jax|flax|wavebench\.(?!reference))", re.M)
    for src in (ROOT / "wavebench" / "reference").glob("*.py"):
        assert not imports.search(src.read_text()), src


def test_forbidden_modules_flags_whole_names(monkeypatch):
    from wavebench import bench

    monkeypatch.setitem(sys.modules, "jax", object())
    monkeypatch.setitem(sys.modules, "pytorch_wavenet_tpu_torch.x", object())
    assert bench.forbidden_modules() == ["jax"]


def test_no_card_no_result():
    """Without a CUDA card the run exits non-zero and prints no result."""
    argv = ["--workload", "chaconne.stream", "--seed", "1", "--seconds", "1"]
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "wavebench/run.py", *argv],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env=env)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
