"""ctypes bindings of the native audio codec (``csrc/audio_native.cc``): the
JAX package's ``data/native.py``.

Host code, not a device kernel: the mu-law quantizer and dequantizer, the
PCM16 mixdown and the batched window gather of the training data layer.
The source builds with ``g++`` at first use into the package's ``build/``
directory (beside the CUDA libraries, under the same lock), and is rebuilt
when it is newer than its library. Where no C++ compiler is present every
entry point falls back to numpy: the same windows, and a quantizer that may
differ from the native one by one class, rarely, where a sample lies within
rounding of a bucket edge (the native one works in f32, numpy in f64).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ..ops.cuda import build as _build
from ..ops.mulaw import dequantize_data, quantize_data

SRC = _build.SRC_DIR / "audio_native.cc"
LIB_PATH = _build.BUILD_DIR / "libaudio_native.so"

_lib = None
_tried = False


def _compile() -> bool:
    """Build the library if it is missing or older than its source; False
    when there is no working ``g++``."""
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= SRC.stat().st_mtime:
        return True
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.tmp.{os.getpid()}")
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-fPIC", "-shared",
                        "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, LIB_PATH)
    return True


def get_lib():
    """The loaded library (building it first if needed), or None."""
    global _lib, _tried
    with _build._load_lock:
        if _tried:
            return _lib
        _tried = True
        if not SRC.exists() or not _compile():
            return None
        try:
            lib = ctypes.CDLL(str(LIB_PATH))
        except OSError:
            return None
        c_i64, c_i32 = ctypes.c_int64, ctypes.c_int32
        ptr = lambda dt: np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")
        p_f32, p_u8, p_i16 = ptr(np.float32), ptr(np.uint8), ptr(np.int16)
        p_i32, p_i64 = ptr(np.int32), ptr(np.int64)
        lib.mu_law_quantize.argtypes = [p_f32, p_u8, c_i64, c_i32]
        lib.mu_law_dequantize.argtypes = [p_u8, p_f32, c_i64, c_i32]
        lib.pcm16_to_float_mono.argtypes = [p_i16, p_f32, c_i64, c_i32]
        lib.gather_windows.argtypes = [p_u8, c_i64, p_i64, c_i32, c_i32,
                                       c_i32, p_i32, p_i32]
        lib.native_abi_version.restype = c_i32
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def mu_law_quantize(x: np.ndarray, classes: int) -> np.ndarray:
    """Waveform -> uint8 classes (reference: audio_data.py:133-137)."""
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float32)
    if lib is None:
        return quantize_data(x, classes).astype(np.uint8)
    out = np.empty(x.shape, np.uint8)
    lib.mu_law_quantize(x.reshape(-1), out.reshape(-1), x.size, classes)
    return out


def mu_law_dequantize(q: np.ndarray, classes: int) -> np.ndarray:
    """uint8 classes -> f32 waveform (reference: wavenet_model.py:296)."""
    lib = get_lib()
    q = np.ascontiguousarray(q, np.uint8)
    if lib is None:
        return dequantize_data(q, classes).astype(np.float32)
    out = np.empty(q.shape, np.float32)
    lib.mu_law_dequantize(q.reshape(-1), out.reshape(-1), q.size, classes)
    return out


def pcm16_to_float_mono(pcm: np.ndarray, channels: int) -> np.ndarray:
    """Interleaved int16 PCM -> f32 mono in [-1, 1)."""
    lib = get_lib()
    pcm = np.ascontiguousarray(pcm, np.int16)
    frames = pcm.size // channels
    if lib is None:
        x = pcm.astype(np.float32).reshape(frames, channels) / 32768.0
        return x.mean(axis=1) if channels > 1 else x[:, 0]
    out = np.empty(frames, np.float32)
    lib.pcm16_to_float_mono(pcm.reshape(-1), out, frames, channels)
    return out


def gather_windows(stream: np.ndarray, starts: np.ndarray, item_len: int,
                   target_len: int) -> tuple[np.ndarray, np.ndarray]:
    """int32 inputs ``(B, item_len)`` from ``stream[s : s + item_len]`` and
    targets ``(B, target_len)`` ending at ``s + item_len + 1``, for each
    start ``s``."""
    lib = get_lib()
    stream = np.ascontiguousarray(stream, np.uint8)
    starts = np.ascontiguousarray(starts, np.int64)
    if not 0 < target_len <= item_len + 1 or (starts.size and (
            starts.min() < 0 or starts.max() + item_len + 1 > stream.size)):
        raise IndexError(f"windows of {item_len + 1} bytes at starts "
                         f"{starts.min()}..{starts.max()} (targets "
                         f"{target_len}) leave the {stream.size}-byte stream")
    if lib is None:
        return gather_windows_numpy(stream, starts, item_len, target_len)
    b = len(starts)
    x = np.empty((b, item_len), np.int32)
    y = np.empty((b, target_len), np.int32)
    lib.gather_windows(stream, stream.size, starts, b, item_len, target_len,
                       x, y)
    return x, y


def gather_windows_numpy(stream: np.ndarray, starts: np.ndarray,
                         item_len: int, target_len: int):
    """:func:`gather_windows` in numpy (one fancy-indexed read)."""
    cols = np.arange(item_len + 1, dtype=np.int64)
    win = np.asarray(stream[starts[:, None] + cols[None, :]], np.int32)
    return (np.ascontiguousarray(win[:, :item_len]),
            np.ascontiguousarray(win[:, item_len + 1 - target_len:]))
