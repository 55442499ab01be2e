"""Audio file I/O on numpy: a copy of the JAX package's ``data/audio_io.py``
(WAV and AIFF reading, mixdown, linear resampling, peak normalization,
16-bit WAV writing). Compressed formats (mp3) are not read: convert them to
WAV first.
"""

from __future__ import annotations

import os
import struct
import wave
import numpy as np

AUDIO_EXTENSIONS = (".wav", ".aif", ".aiff")


def list_all_audio_files(location: str) -> list[str]:
    """Recursively list audio files (reference: audio_data.py:140-148)."""
    audio_files = []
    for dirpath, _dirnames, filenames in os.walk(location):
        for filename in sorted(filenames):
            if filename.lower().endswith(AUDIO_EXTENSIONS):
                audio_files.append(os.path.join(dirpath, filename))
    if not audio_files:
        print("found no audio files in " + location)
    return audio_files


def _decode_pcm(raw: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    """Interleaved PCM bytes -> float32 in [-1, 1), shape (frames, channels)."""
    if sampwidth == 1:  # unsigned 8-bit
        x = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
        x = (x - 128.0) / 128.0
    elif sampwidth == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif sampwidth == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported PCM sample width {sampwidth}")
    return x.reshape(-1, n_channels)


def _read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a RIFF WAV. Handles PCM via the stdlib wave module and IEEE
    float chunks by manual RIFF parsing."""
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            data = _decode_pcm(
                w.readframes(w.getnframes()), w.getsampwidth(), w.getnchannels()
            )
            return data, sr
    except wave.Error:
        pass
    # manual parse (float WAVs, WAVE_FORMAT_EXTENSIBLE)
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, raw = 12, None, None
    while pos + 8 <= len(blob):
        cid, size = blob[pos : pos + 4], struct.unpack("<I", blob[pos + 4 : pos + 8])[0]
        body = blob[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, n_channels, sr, _, _, bits = fmt
    if audio_format == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        data = np.frombuffer(raw, dtype=dt).astype(np.float32).reshape(-1, n_channels)
    else:
        data = _decode_pcm(raw, bits // 8, n_channels)
    return data, sr


def _read_aiff(path: str) -> tuple[np.ndarray, int]:
    """Read an AIFF (big-endian PCM)."""
    import aifc

    with aifc.open(path, "rb") as a:
        sr = int(a.getframerate())
        sw, nch = a.getsampwidth(), a.getnchannels()
        raw = a.readframes(a.getnframes())
    if sw == 2:
        x = np.frombuffer(raw, dtype=">i2").astype(np.float32) / 32768.0
    elif sw == 1:
        x = np.frombuffer(raw, dtype=np.int8).astype(np.float32) / 128.0
    elif sw == 4:
        x = np.frombuffer(raw, dtype=">i4").astype(np.float32) / float(1 << 31)
    else:
        raise ValueError(f"unsupported AIFF sample width {sw}")
    return x.reshape(-1, nch), sr


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Band-limited-ish linear resampler (mono 1-D input)."""
    if sr_in == sr_out:
        return x
    n_out = int(round(len(x) * sr_out / sr_in))
    t_out = np.arange(n_out, dtype=np.float64) * (sr_in / sr_out)
    return np.interp(t_out, np.arange(len(x), dtype=np.float64), x).astype(np.float32)


def normalize(x: np.ndarray) -> np.ndarray:
    """Peak normalize (librosa.util.normalize default: inf-norm of 1)."""
    peak = np.max(np.abs(x))
    return x if peak == 0 else (x / peak).astype(np.float32)


def load_audio(
    path: str,
    sampling_rate: int = 16000,
    mono: bool = True,
) -> tuple[np.ndarray, int]:
    """Load an audio file -> (float32 waveform, sampling_rate), resampled and
    mixed down like the reference's librosa.load call
    (reference: audio_data.py:69-71)."""
    lower = path.lower()
    if lower.endswith(".wav"):
        data, sr = _read_wav(path)
    elif lower.endswith((".aif", ".aiff")):
        data, sr = _read_aiff(path)
    else:
        raise ValueError(f"{path}: only WAV and AIFF files are read; "
                         "convert compressed audio to WAV first")
    if mono and data.ndim == 2:
        data = data.mean(axis=1)
    else:
        data = data.reshape(-1)
    data = resample(data.astype(np.float32), sr, sampling_rate)
    return data, sampling_rate


def write_wav(path: str, x: np.ndarray, sr: int = 16000) -> None:
    """Write mono float waveform to 16-bit PCM WAV (the reference writes via
    librosa.output.write_wav, generate_script.py:35)."""
    x = np.asarray(x, dtype=np.float32).reshape(-1)
    pcm = np.clip(x * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
