"""A small msgpack encoder/decoder for the subset that flax checkpoints use.

The JAX package writes checkpoints with ``flax.serialization``; the machine
with the card has no ``msgpack`` package, so the port carries its own codec
for: maps, arrays, str, bin, int, float, nil, bool, and flax's ext types
1 (ndarray) and 3 (numpy scalar), each a msgpack ``(shape, dtype name,
raw C-order bytes)`` triple. Other ext types and flax's chunked encoding
of arrays over 1 GiB are refused.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# ------------------------------------------------------------------ encode


def _pack_int(n: int, out: list) -> None:
    if 0 <= n <= 0x7F:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif 0 <= n <= 0xFF:
        out.append(b"\xcc" + struct.pack("B", n))
    elif 0 <= n <= 0xFFFF:
        out.append(b"\xcd" + struct.pack(">H", n))
    elif 0 <= n <= 0xFFFFFFFF:
        out.append(b"\xce" + struct.pack(">I", n))
    elif 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + struct.pack(">Q", n))
    elif -0x80 <= n < 0:
        out.append(b"\xd0" + struct.pack(">b", n))
    elif -0x8000 <= n < 0:
        out.append(b"\xd1" + struct.pack(">h", n))
    elif -0x80000000 <= n < 0:
        out.append(b"\xd2" + struct.pack(">i", n))
    elif -0x8000000000000000 <= n < 0:
        out.append(b"\xd3" + struct.pack(">q", n))
    else:
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: int, fixmax: int, codes: tuple, out: list) -> None:
    """Header of a str/bin/array/map of length n (codes: 8/16/32-bit forms,
    None where the format has none)."""
    if fix is not None and n <= fixmax:
        out.append(struct.pack("B", fix | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack("BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _pack_ext(code: int, data: bytes, out: list) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack("Bb", fixed[n], code))
    elif n <= 0xFF:
        out.append(struct.pack("BBb", 0xC7, n, code))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(data)


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(b)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def _array_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured dtypes are not supported")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# ------------------------------------------------------------------ decode


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]


def _array_from_payload(payload: bytes) -> np.ndarray:
    shape, name, buf = unpackb(payload)
    if isinstance(name, bytes):
        name = name.decode()
    shape = tuple(int(s) for s in shape)
    if name == "bfloat16":
        # exact widening: a bfloat16 is the top half of a float32
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_payload(data)
    if code == _EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def _decode(r: _Reader):
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    if b in (0xC4, 0xC5, 0xC6):
        n = r.unpack({0xC4: "B", 0xC5: ">H", 0xC6: ">I"}[b])
        return bytes(r.take(n))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: "B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack("b")
        return _ext(code, bytes(r.take(n)))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    ints = {0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
        n = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[b]
        code = r.unpack("b")
        return _ext(code, bytes(r.take(n)))
    if b in (0xD9, 0xDA, 0xDB):
        n = r.unpack({0xD9: "B", 0xDA: ">H", 0xDB: ">I"}[b])
        return bytes(r.take(n)).decode("utf-8")
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_decode(r) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    if "__msgpack_chunked_array__" in out:
        raise ValueError("chunked (>1 GiB) arrays are not supported")
    return out


def unpackb(data: bytes):
    r = _Reader(data)
    obj = _decode(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj
