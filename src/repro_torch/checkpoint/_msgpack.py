"""A small MessagePack codec for scheduler-state files.

The JAX package writes scheduler state with ``msgpack.packb`` and reads it
with ``msgpack.unpackb`` (msgpack 1.x defaults: ``use_bin_type=True``,
``raw=False``, ``strict_map_key=True``). The port must not need the
``msgpack`` package, so it keeps this codec, which gives the same bytes for
the types scheduler state holds:

- ``None``, ``bool``;
- ``int`` in the smallest encoding msgpack picks (positive and negative
  fixint, uint8-64 for values >= 0, int8-64 below -32);
- ``float`` as float64 (msgpack's default);
- ``str`` (fixstr, str8, str16, str32);
- ``list`` and ``tuple`` (fixarray, array16, array32);
- ``dict`` (fixmap, map16, map32), in insertion order.

Subclasses of these (``numpy.float64`` is a ``float``) are packed as their
base type, as msgpack packs them; any other type raises ``TypeError``. The
decoder returns lists for arrays and ``str`` for strings, and refuses a map
key that is not a ``str``, as ``strict_map_key`` does.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

__all__ = ["packb", "unpackb"]

_U16, _U32, _U64 = (struct.Struct(">H"), struct.Struct(">I"),
                    struct.Struct(">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(">b"), struct.Struct(">h"),
                         struct.Struct(">i"), struct.Struct(">q"))
_F64 = struct.Struct(">d")


def _pack_int(x: int, out: List[bytes]) -> None:
    if 0 <= x < 0x80:
        out.append(bytes((x,)))
    elif x >= 0:
        if x <= 0xFF:
            out.append(b"\xcc" + bytes((x,)))
        elif x <= 0xFFFF:
            out.append(b"\xcd" + _U16.pack(x))
        elif x <= 0xFFFFFFFF:
            out.append(b"\xce" + _U32.pack(x))
        elif x <= 0xFFFFFFFFFFFFFFFF:
            out.append(b"\xcf" + _U64.pack(x))
        else:
            raise OverflowError("Integer value out of range")
    elif x >= -32:
        out.append(bytes((x & 0xFF,)))
    elif x >= -0x80:
        out.append(b"\xd0" + _I8.pack(x))
    elif x >= -0x8000:
        out.append(b"\xd1" + _I16.pack(x))
    elif x >= -0x80000000:
        out.append(b"\xd2" + _I32.pack(x))
    elif x >= -0x8000000000000000:
        out.append(b"\xd3" + _I64.pack(x))
    else:
        raise OverflowError("Integer value out of range")


def _header(n: int, fix_tag: int, fix_max: int, tags: Tuple[int, ...],
            out: List[bytes]) -> None:
    """A length header: ``fix_tag | n`` below ``fix_max``, else the first
    of ``tags`` (8-, 16-, 32-bit length; 0 where the family has none) that
    holds ``n``."""
    if n < fix_max:
        out.append(bytes((fix_tag | n,)))
    elif tags[0] and n <= 0xFF:
        out.append(bytes((tags[0], n)))
    elif n <= 0xFFFF:
        out.append(bytes((tags[1],)) + _U16.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(bytes((tags[2],)) + _U32.pack(n))
    else:
        raise ValueError("object too large to pack")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 16, (0, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 16, (0, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as ``msgpack.packb(obj)`` encodes it."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack data ends early")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def unpack(self, st: struct.Struct):
        return st.unpack(self.take(st.size))[0]

    def length(self, tag: int, t8: int) -> int:
        """The length after ``tag``, of a family whose 8-, 16- and 32-bit
        length tags are ``t8``, ``t8 + 1`` and ``t8 + 2``."""
        width = tag - t8
        if width == 0:
            return self.take(1)[0]
        return self.unpack(_U16 if width == 1 else _U32)

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b == 0xCB:
            return self.unpack(_F64)
        if b == 0xCC:
            return self.take(1)[0]
        if 0xCD <= b <= 0xCF:
            return self.unpack((_U16, _U32, _U64)[b - 0xCD])
        if 0xD0 <= b <= 0xD3:
            return self.unpack((_I8, _I16, _I32, _I64)[b - 0xD0])
        if 0xD9 <= b <= 0xDB:
            return self.text(self.length(b, 0xD9))
        if b in (0xDC, 0xDD):
            return self.array(self.length(b, 0xDB))
        if b in (0xDE, 0xDF):
            return self.map(self.length(b, 0xDD))
        raise ValueError(f"msgpack type 0x{b:02x} is not supported here")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            if not isinstance(k, str):
                raise ValueError(f"{type(k).__name__} is not allowed for "
                                 f"map key when strict_map_key=True")
            out[k] = self.value()
        return out


def unpackb(data: bytes) -> Any:
    """The object ``msgpack.unpackb(data)`` returns (lists for arrays,
    ``str`` for strings); raises ``ValueError`` on trailing bytes."""
    r = _Reader(bytes(data))
    obj = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of extra data")
    return obj
