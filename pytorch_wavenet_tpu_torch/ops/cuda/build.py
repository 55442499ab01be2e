"""Build the port's CUDA sources and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/lib<name>.so`` inside the package (listed in ``.gitignore``) at
first use, and is rebuilt when its source is newer than the library. The
sources have a plain C interface, so a build takes seconds: nothing
includes PyTorch's headers. Pointers and the stream go through ``ctypes``
as ``c_void_p``.

The sources ship as package data (``pyproject.toml``); the libraries are
built beside them, so the package directory must be writable: a checkout,
an editable install, or an install into a directory the user owns.

Nothing here runs at import time; the CPU tests import this module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # a server's worker thread and its caller


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing, or older than its source or any shared
    header (``csrc/*.cuh``)."""
    so = library_path(name)
    if not so.exists():
        return True
    sources = [SRC_DIR / f"{name}.cu", *SRC_DIR.glob("*.cuh")]
    return so.stat().st_mtime < max(p.stat().st_mtime for p in sources)


def _start(name: str, verbose: bool) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.so.tmp.{os.getpid()}"
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build(names: list[str] | None = None, verbose: bool = False) -> dict:
    """Compile the named sources (default: every ``csrc/*.cu``), one
    ``nvcc`` each, all started together. Returns ``{name: compiler
    output}``; raises on the first failed build. With ``verbose`` the
    output carries ``-Xptxas -v`` (registers, shared memory, spills) and
    every source is rebuilt."""
    if names is None:
        names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    todo = [n for n in names if verbose or _stale(n)]
    running = {n: _start(n, verbose) for n in todo}
    logs = {}
    for n, (proc, tmp) in running.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for csrc/{n}.cu "
                               f"(exit {proc.returncode}):\n{out}")
        os.replace(tmp, library_path(n))
        _libs.pop(n, None)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it first when it
    is missing or stale."""
    with _load_lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
