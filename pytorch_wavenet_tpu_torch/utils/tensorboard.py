"""Dependency-free TensorBoard event-file writer: a copy of the JAX
package's ``utils/tensorboard.py`` (numpy and the standard library), plus
:func:`read_events`, a reader that checks every record's CRC.

The reference needs the whole tensorflow package to write summary protos
(reference: model_logging.py:1,71,95-157). This module hand-encodes the
small fixed subset of the proto schema TensorBoard reads (Event, Summary:
scalar, histogram, image, audio) and TFRecord framing with masked CRC32C.

The wire format:
* TFRecord: u64-le length, masked crc32c(length), payload, masked
  crc32c(payload); mask = ((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff.
* Event proto: wall_time(double,1), step(int64,2), file_version(string,3),
  summary(msg,5). The first record carries file_version "brain.Event:2".
* Summary.Value: tag(1), simple_value(float,2), image(msg,4), histo(msg,5),
  audio(msg,6).
"""

from __future__ import annotations

import io
import os
import socket
import struct
import time
import wave
import zlib

import numpy as np

# ------------------------------------------------------------------ crc32c

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78  # Castagnoli, reflected
        table = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table[i] = crc
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------- proto encoding


def _varint(n: int) -> bytes:
    out = b""
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(int(value))


def _f_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", float(value))


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", float(value))


def _f_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _f_string(field: int, value: str) -> bytes:
    return _f_bytes(field, value.encode("utf-8"))


def _f_packed_doubles(field: int, values) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in values)
    return _f_bytes(field, payload)


def encode_histogram(values: np.ndarray, bins: int = 200) -> bytes:
    """HistogramProto (the reference builds the same fields from np.histogram,
    model_logging.py:131-157): min(1) max(2) num(3) sum(4) sum_squares(5)
    bucket_limit(6, packed) bucket(7, packed)."""
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    counts, bin_edges = np.histogram(values, bins=bins)
    msg = b""
    msg += _f_double(1, values.min() if values.size else 0.0)
    msg += _f_double(2, values.max() if values.size else 0.0)
    msg += _f_double(3, float(values.size))
    msg += _f_double(4, float(values.sum()))
    msg += _f_double(5, float((values**2).sum()))
    msg += _f_packed_doubles(6, bin_edges[1:])  # drop left edge of first bin
    msg += _f_packed_doubles(7, counts.astype(np.float64))
    return msg


def encode_wav(samples: np.ndarray, sample_rate: int) -> bytes:
    """Mono float waveform -> 16-bit PCM WAV bytes."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def encode_png(img: np.ndarray) -> bytes:
    """Minimal PNG encoder: uint8 grayscale (H, W) or RGB (H, W, 3)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        scale = 255.0 / (hi - lo) if hi > lo else 1.0
        img = ((img - lo) * scale).astype(np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (
            struct.pack(">I", len(body))
            + tag
            + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def _summary(value_msgs: list[bytes]) -> bytes:
    return b"".join(_f_bytes(1, v) for v in value_msgs)


def _event(step: int | None, summary: bytes | None, file_version: str | None = None) -> bytes:
    msg = _f_double(1, time.time())
    if step is not None:
        msg += _f_varint(2, step)
    if file_version is not None:
        msg += _f_string(3, file_version)
    if summary is not None:
        msg += _f_bytes(5, summary)
    return msg


# ------------------------------------------------------------------ writer


class SummaryWriter:
    """Append-only TB event-file writer (API shaped like
    torch.utils.tensorboard / tf.summary.FileWriter, which the reference
    uses at model_logging.py:71)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._path = os.path.join(log_dir, fname)
        self._file = open(self._path, "ab")
        self._write_record(_event(None, None, file_version="brain.Event:2"))

    @property
    def path(self) -> str:
        return self._path

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", masked_crc32c(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", masked_crc32c(payload)))

    def _add(self, step: int, value_msg: bytes):
        self._write_record(_event(step, _summary([value_msg])))

    def add_scalar(self, tag: str, value: float, step: int):
        self._add(step, _f_string(1, tag) + _f_float(2, float(value)))

    def add_histogram(self, tag: str, values, step: int, bins: int = 200):
        self._add(step, _f_string(1, tag) + _f_bytes(5, encode_histogram(values, bins)))

    def add_image(self, tag: str, img, step: int):
        img = np.asarray(img)
        png = encode_png(img)
        h, w = img.shape[:2]
        c = 1 if img.ndim == 2 else img.shape[2]
        image_msg = (
            _f_varint(1, h) + _f_varint(2, w) + _f_varint(3, c) + _f_bytes(4, png)
        )
        self._add(step, _f_string(1, tag) + _f_bytes(4, image_msg))

    def add_audio(self, tag: str, samples, step: int, sample_rate: int = 16000):
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        audio_msg = (
            _f_float(1, float(sample_rate))
            + _f_varint(2, 1)
            + _f_varint(3, len(samples))
            + _f_bytes(4, encode_wav(samples, sample_rate))
            + _f_string(5, "audio/wav")
        )
        self._add(step, _f_string(1, tag) + _f_bytes(6, audio_msg))

    def flush(self):
        self._file.flush()

    def close(self):
        self._file.flush()
        self._file.close()


# ------------------------------------------------------------------ reader


def _read_varint(msg: bytes, pos: int) -> tuple[int, int]:
    val = shift = 0
    while True:
        b = msg[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return val, pos


def parse_fields(msg: bytes) -> dict:
    """A protobuf message -> ``{field number: [values]}`` (varints as int,
    fixed64 as double, fixed32 as float, length-delimited as bytes)."""
    fields: dict = {}
    pos = 0
    while pos < len(msg):
        key, pos = _read_varint(msg, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(msg, pos)
        elif wire == 1:
            val = struct.unpack("<d", msg[pos:pos + 8])[0]
            pos += 8
        elif wire == 5:
            val = struct.unpack("<f", msg[pos:pos + 4])[0]
            pos += 4
        elif wire == 2:
            n, pos = _read_varint(msg, pos)
            val = msg[pos:pos + n]
            pos += n
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        fields.setdefault(field, []).append(val)
    return fields


_KINDS = {2: "scalar", 4: "image", 5: "histogram", 6: "audio"}


def read_events(path: str) -> list[dict]:
    """The records of an event file, each CRC checked (a mismatch raises):
    ``{"step", "wall_time", "file_version", "values": [(tag, kind, value
    bytes or float)]}`` per event."""
    with open(path, "rb") as f:
        data = f.read()
    events, pos = [], 0
    while pos < len(data):
        header = data[pos:pos + 8]
        (length,) = struct.unpack("<Q", header)
        (len_crc,) = struct.unpack("<I", data[pos + 8:pos + 12])
        payload = data[pos + 12:pos + 12 + length]
        (crc,) = struct.unpack("<I", data[pos + 12 + length:pos + 16 + length])
        if len_crc != masked_crc32c(header) or crc != masked_crc32c(payload):
            raise ValueError(f"{path}: bad CRC in the record at byte {pos}")
        pos += 16 + length
        ev = parse_fields(payload)
        values = []
        for v in (parse_fields(ev[5][0]).get(1, []) if 5 in ev else []):
            f = parse_fields(v)
            n = next(n for n in _KINDS if n in f)
            values.append((f[1][0].decode(), _KINDS[n], f[n][0]))
        events.append({"step": ev.get(2, [None])[0],
                       "wall_time": ev[1][0],
                       "file_version": (ev[3][0].decode() if 3 in ev
                                        else None),
                       "values": values})
    return events
