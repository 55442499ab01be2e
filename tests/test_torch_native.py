"""The port's native audio codec (``csrc/audio_native.cc`` through
``data/native.py``) against the JAX package's native library and against
the numpy codec, on the CPU; the datasets that both packages write; the
compressed-audio decode chain.

Tolerances: the port's native functions equal the JAX package's exactly
(the same source and compiler flags); against numpy the quantizer may
differ by one class at a sample within rounding of a bucket edge (f32
against f64; tests/test_native.py bounds that share at 5e-3), the
dequantizer within 1e-5, the PCM mixdown within 1e-4 and the window
gather exactly.
"""

import os
import shutil
import sys
import zipfile

import numpy as np
import pytest

import pytorch_wavenet_tpu as wt
import pytorch_wavenet_tpu_torch as pt
from pytorch_wavenet_tpu.data import native as jnative
from pytorch_wavenet_tpu_torch.data import audio_io
from pytorch_wavenet_tpu_torch.data import native
from pytorch_wavenet_tpu_torch.ops.cuda import build
from pytorch_wavenet_tpu_torch.ops.mulaw import dequantize_data, quantize_data


@pytest.fixture(scope="module")
def libs():
    lib = native.get_lib()
    if lib is None or jnative.get_lib() is None:
        pytest.skip("no C++ compiler: the numpy paths run")
    return lib


def test_library_builds_into_the_package(libs):
    assert libs.native_abi_version() == 1
    assert native.LIB_PATH.parent == build.BUILD_DIR
    assert native.LIB_PATH.exists() and native.available()


@pytest.mark.parametrize("classes", [256, 32])
def test_quantize_matches_jax_native_and_numpy(libs, classes):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 20000),
                        [-1.0, 0.0, 1.0, 1e-9, -1e-9]]).astype(np.float32)
    got = native.mu_law_quantize(x, classes)
    np.testing.assert_array_equal(got, jnative.mu_law_quantize(x, classes))
    diff = np.abs(got.astype(int) - quantize_data(x.astype(np.float64),
                                                  classes))
    assert diff.max() <= 1 and (diff != 0).mean() < 5e-3


def test_dequantize_pcm_and_gather_match(libs):
    q = np.arange(256, dtype=np.uint8)
    got = native.mu_law_dequantize(q, 256)
    np.testing.assert_array_equal(got, jnative.mu_law_dequantize(q, 256))
    np.testing.assert_allclose(got, dequantize_data(q, 256), atol=1e-5)
    rng = np.random.default_rng(1)
    pcm = rng.integers(-32768, 32767, 4000).astype(np.int16)
    for ch in (1, 2):
        got = native.pcm16_to_float_mono(pcm, ch)
        np.testing.assert_array_equal(got,
                                      jnative.pcm16_to_float_mono(pcm, ch))
        ref = (pcm.astype(np.float32) / 32768.0).reshape(-1, ch).mean(axis=1)
        np.testing.assert_allclose(got, ref, atol=1e-4)
    stream = rng.integers(0, 256, 5000).astype(np.uint8)
    starts = rng.integers(0, 5000 - 70, 9).astype(np.int64)
    got = native.gather_windows(stream, starts, 64, 5)
    for a, b, c in zip(got, jnative.gather_windows(stream, starts, 64, 5),
                       native.gather_windows_numpy(stream, starts, 64, 5)):
        assert a.dtype == np.int32 and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # a window past the stream's end, or a negative start, raises before
    # the pointers reach the library
    for bad in ([5000 - 64], [-1]):
        with pytest.raises(IndexError, match="leave the"):
            native.gather_windows(stream, np.asarray(bad), 64, 5)


def _tone(path, seconds=1.0):
    rng = np.random.default_rng(2)
    t = np.arange(int(16000 * seconds)) / 16000.0
    wav = (0.6 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 0.7 * t)
           + 0.03 * rng.standard_normal(t.shape))
    pt.write_wav(path, wav, 16000)


def test_dataset_npz_equals_jax_byte_for_byte(libs, tmp_path):
    """Both packages quantize through the native library, so the arrays in
    the two ``dataset.npz`` files are the same bytes (the zip members'
    timestamps aside); the batches gathered natively equal the numpy
    gather's."""
    src = tmp_path / "src"
    src.mkdir()
    _tone(str(src / "a.wav"))
    _tone(str(src / "b.wav"), 0.5)
    cfg = pt.get_config("tiny")
    kw = dict(item_length=cfg.item_length, target_length=cfg.output_length,
              classes=cfg.classes, test_stride=20)
    files = {}
    for name, mod in (("j", wt), ("t", pt)):
        d = tmp_path / name
        shutil.copytree(src, d)
        ds = mod.WaveNetDataset(str(d / "dataset.npz"), file_location=str(d),
                                **kw)
        with zipfile.ZipFile(d / "dataset.npz") as z:
            files[name] = {n: z.read(n) for n in z.namelist()}
        if mod is pt:
            idx = np.arange(0, len(ds), 7)[:16]
            starts = np.asarray([ds.sample_index(int(i)) for i in idx])
            ref = native.gather_windows_numpy(ds.flat_stream, starts,
                                              cfg.item_length,
                                              cfg.output_length)
            for a, b in zip(ds.get_batch(idx), ref):
                np.testing.assert_array_equal(a, b)
    assert sorted(files["t"]) == ["arr_0.npy", "arr_1.npy"]
    assert files["t"] == files["j"]


def test_numpy_fallback_without_a_compiler(monkeypatch, tmp_path):
    """With no library every entry point runs its numpy path: the same
    windows, the numpy quantizer."""
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    x = np.linspace(-1, 1, 999, dtype=np.float32)
    np.testing.assert_array_equal(native.mu_law_quantize(x, 256),
                                  quantize_data(x, 256).astype(np.uint8))
    np.testing.assert_array_equal(
        native.mu_law_dequantize(np.arange(256, dtype=np.uint8), 256),
        dequantize_data(np.arange(256), 256).astype(np.float32))
    stream = np.arange(200, dtype=np.uint8)
    x, y = native.gather_windows(stream, np.asarray([0, 50]), 10, 3)
    np.testing.assert_array_equal(x[1], np.arange(50, 60))
    np.testing.assert_array_equal(y[1], np.arange(58, 61))
    stereo = np.asarray([16384, -16384, 32767, 32767], np.int16)
    np.testing.assert_allclose(native.pcm16_to_float_mono(stereo, 2),
                               [0.0, 32767 / 32768], atol=1e-6)
    _tone(str(tmp_path / "a.wav"))
    cfg = pt.get_config("tiny")
    ds = pt.WaveNetDataset(str(tmp_path / "d.npz"), item_length=cfg.item_length,
                           target_length=cfg.output_length,
                           file_location=str(tmp_path), classes=cfg.classes)
    wav, _ = pt.load_audio(str(tmp_path / "a.wav"))
    np.testing.assert_array_equal(ds.data["arr_0"], quantize_data(
        wav, cfg.classes).astype(np.uint8))


def test_decode_compressed_names_every_backend(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "librosa", None)
    monkeypatch.setitem(sys.modules, "soundfile", None)
    monkeypatch.setattr(audio_io.shutil, "which", lambda name: None)
    path = str(tmp_path / "clip.mp3")
    open(path, "wb").write(b"\xff\xfb" + bytes(100))
    with pytest.raises(ValueError, match="tried: ") as e:
        pt.load_audio(path)
    msg = str(e.value)
    for backend in ("librosa (not installed)", "soundfile (not installed)",
                    "ffmpeg (not on PATH)"):
        assert backend in msg
    assert ".mp3" in audio_io.AUDIO_EXTENSIONS
    assert audio_io.list_all_audio_files(str(tmp_path)) == [path]


def test_decode_compressed_through_ffmpeg(monkeypatch, tmp_path):
    """The ffmpeg leg: the subprocess's f32 PCM on stdout is the clip (a
    stand-in ``ffmpeg`` on PATH writes known samples)."""
    monkeypatch.setitem(sys.modules, "librosa", None)
    monkeypatch.setitem(sys.modules, "soundfile", None)
    want = np.linspace(-0.5, 0.5, 321, dtype=np.float32)
    raw = tmp_path / "pcm.bin"
    want.astype("<f4").tofile(raw)
    fake = tmp_path / "bin" / "ffmpeg"
    fake.parent.mkdir()
    fake.write_text(f"#!/bin/sh\ncat {raw}\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    path = str(tmp_path / "clip.mp3")
    open(path, "wb").write(b"ID3")
    got, sr = pt.load_audio(path, sampling_rate=8000)
    assert sr == 8000
    np.testing.assert_array_equal(got, want)
