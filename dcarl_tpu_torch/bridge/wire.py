"""The msgpack subset of the planner <-> agent protocol, without the
``msgpack`` package.

The planner sends a list of floats and ints (the state and two flags)
and the agent answers with an int (lane protocol) or a list of floats
(VEG protocol).  :func:`packb` encodes exactly as ``msgpack.packb`` does
by default, and :class:`Unpacker` decodes as ``msgpack.Unpacker(raw=False)``
does, for the types below.  Any other type raises: the codec never
guesses.

Encoded: ``None``, booleans, ints in their smallest form (positive and
negative fixint, then uint8-64 for positive and int8-64 for negative
values), Python floats as float64 (``0xcb``), lists and tuples as
fixarray, array16 or array32 (decoded as lists).  Decoded besides:
float32 (``0xca``) and str (fixstr, str8, str16, str32, UTF-8).
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

_INT_FORMATS = (  # (lowest, highest, type byte, struct format)
    (0, 0xFF, 0xCC, ">B"), (0, 0xFFFF, 0xCD, ">H"),
    (0, 0xFFFFFFFF, 0xCE, ">I"), (0, 0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"),
    (-0x80, -1, 0xD0, ">b"), (-0x8000, -1, 0xD1, ">h"),
    (-0x80000000, -1, 0xD2, ">i"), (-0x8000000000000000, -1, 0xD3, ">q"))


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        if -0x20 <= obj < 0x80:
            out.append(struct.pack(">b", obj) if obj < 0 else bytes((obj,)))
            return
        for lo, hi, code, fmt in _INT_FORMATS:
            if lo <= obj <= hi:
                out.append(bytes((code,)) + struct.pack(fmt, obj))
                return
        raise OverflowError(f"int {obj} does not fit msgpack's 64 bits")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes((0x90 | n,)))
        elif n <= 0xFFFF:
            out.append(b"\xdc" + struct.pack(">H", n))
        elif n <= 0xFFFFFFFF:
            out.append(b"\xdd" + struct.pack(">I", n))
        else:
            raise ValueError(f"array of {n} items is too long for msgpack")
        for item in obj:
            _pack(item, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes (``msgpack.packb(obj)``'s bytes)."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Incomplete(Exception):
    """The buffer ends inside an object: wait for more bytes."""


# type byte -> (struct format, payload bytes) of the fixed-size scalars
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8),
            0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
            0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
# type byte -> struct format of a length prefix
_STR_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY_LEN = {0xDC: ">H", 0xDD: ">I"}


def _take(buf, pos: int, n: int) -> Tuple[bytes, int]:
    if pos + n > len(buf):
        raise _Incomplete
    return bytes(buf[pos:pos + n]), pos + n


def _length(buf, pos: int, fmt: str) -> Tuple[int, int]:
    raw, pos = _take(buf, pos, struct.calcsize(fmt))
    return struct.unpack(fmt, raw)[0], pos


def _unpack(buf, pos: int) -> Tuple[Any, int]:
    if pos >= len(buf):
        raise _Incomplete
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _SCALARS:
        fmt, n = _SCALARS[b]
        raw, pos = _take(buf, pos, n)
        return struct.unpack(fmt, raw)[0], pos
    if 0xA0 <= b <= 0xBF or b in _STR_LEN:
        n = b & 0x1F if b <= 0xBF else None
        if n is None:
            n, pos = _length(buf, pos, _STR_LEN[b])
        raw, pos = _take(buf, pos, n)
        return raw.decode("utf-8"), pos
    if 0x90 <= b <= 0x9F or b in _ARRAY_LEN:
        n = b & 0x0F if b <= 0x9F else None
        if n is None:
            n, pos = _length(buf, pos, _ARRAY_LEN[b])
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos)
            items.append(item)
        return items, pos
    raise ValueError(f"msgpack type byte 0x{b:02x} is outside the protocol")


class Unpacker:
    """Streaming decoder: :meth:`feed` bytes as they arrive, iterate the
    whole objects decoded so far.  An object split across feeds is
    returned once its last byte has come."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, data: bytes) -> None:
        self._buf += data

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        try:
            obj, pos = _unpack(self._buf, 0)
        except _Incomplete:
            raise StopIteration from None
        del self._buf[:pos]
        return obj
