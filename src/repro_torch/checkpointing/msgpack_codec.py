"""The subset of MessagePack that the checkpoint manifest uses, without the
``msgpack`` package: maps, arrays, str, bin, int, float64, bool and nil.

``packb`` writes the bytes ``msgpack.packb`` writes for such a value (its
defaults: str as str, bytes as bin, floats as float64, every int and
container in its smallest form, maps in insertion order); ``unpackb``
reads them back as ``msgpack.unpackb`` does (arrays as lists, str as
str).  Anything else raises ``TypeError`` (packing) or ``ValueError``
(unpacking: truncated or trailing bytes, an unknown or extension type)."""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _head(out: List[bytes], n: int, fix: int, fix_max: int,
          wide: Tuple[int, ...]) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    the 8/16/32-bit forms (type bytes ``wide``, None where absent) that
    holds ``n``."""
    if n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, limit in zip(wide, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} is too large for msgpack")


def _int(out: List[bytes], v: int) -> None:
    if 0 <= v < 128:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if v < limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"{v} does not fit msgpack's uint64")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f"{v} does not fit msgpack's int64")


def _pack(out: List[bytes], v: Any) -> None:
    if v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(v, (bytes, bytearray)):
        _head(out, len(v), 0, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(v))
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    else:
        raise TypeError(f"can not serialize {type(v).__name__!r} object")


def packb(value: Any) -> bytes:
    out: List[bytes] = []
    _pack(out, value)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data is truncated")
        chunk = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-width types: type byte -> struct format
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# length-prefixed types: type byte -> (kind, length format)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


def _read(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b]
    elif b in _SCALARS:
        return r.unpack(_SCALARS[b])
    elif b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")
    if kind == "str":
        try:
            return r.take(n).decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack str is not utf-8: {e}") from e
    if kind == "bin":
        return r.take(n)
    if kind == "array":
        return [_read(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _read(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map "
                             "key")
        out[k] = _read(r)
    return out


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    value = _read(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack data has extra bytes after the value")
    return value
