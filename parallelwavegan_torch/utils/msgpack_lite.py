"""A small msgpack codec covering what flax checkpoints contain.

Maps, arrays, str, bin, ints, floats, nil, bool and ext (fixext 1-16,
ext 8/16/32). Encoding picks the smallest form, as msgpack-python does, so
a tree read from a flax file and written back gives the same bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional, Tuple


class ExtType(NamedTuple):
    code: int
    data: bytes


ExtHook = Callable[[int, bytes], Any]

_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_FIXEXT_CODE = {n: code for code, n in _FIXEXT.items()}
# tag -> (struct format of the length or value, kind)
_SIZED = {
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}


def unpackb(data: bytes, ext_hook: Optional[ExtHook] = None) -> Any:
    """Decode one msgpack object; ext payloads go to ext_hook(code, data)."""
    buf = memoryview(data)
    obj, pos = _decode(buf, 0, ext_hook)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} trailing bytes after msgpack object")
    return obj


def _take(buf: memoryview, pos: int, n: int) -> Tuple[bytes, int]:
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")
    return bytes(buf[pos : pos + n]), pos + n


def _decode(buf: memoryview, pos: int, ext_hook: Optional[ExtHook]):
    tag = buf[pos]
    pos += 1
    if tag <= 0x7F:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if 0x80 <= tag <= 0x8F:
        return _decode_map(buf, pos, tag & 0x0F, ext_hook)
    if 0x90 <= tag <= 0x9F:
        return _decode_array(buf, pos, tag & 0x0F, ext_hook)
    if 0xA0 <= tag <= 0xBF:
        raw, pos = _take(buf, pos, tag & 0x1F)
        return raw.decode("utf-8"), pos
    if tag == 0xC0:
        return None, pos
    if tag in (0xC2, 0xC3):
        return tag == 0xC3, pos
    if tag in _SCALARS:
        fmt = _SCALARS[tag]
        raw, pos = _take(buf, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], pos
    if tag in _FIXEXT:
        code, pos = _take(buf, pos, 1)
        payload, pos = _take(buf, pos, _FIXEXT[tag])
        return _ext(struct.unpack(">b", code)[0], payload, ext_hook), pos
    if tag in _SIZED:
        fmt, kind = _SIZED[tag]
        raw, pos = _take(buf, pos, struct.calcsize(fmt))
        n = struct.unpack(fmt, raw)[0]
        if kind == "map":
            return _decode_map(buf, pos, n, ext_hook)
        if kind == "array":
            return _decode_array(buf, pos, n, ext_hook)
        if kind == "ext":
            code, pos = _take(buf, pos, 1)
            payload, pos = _take(buf, pos, n)
            return _ext(struct.unpack(">b", code)[0], payload, ext_hook), pos
        raw, pos = _take(buf, pos, n)
        return (raw.decode("utf-8") if kind == "str" else raw), pos
    raise ValueError(f"unsupported msgpack tag 0x{tag:02x}")


def _ext(code: int, payload: bytes, ext_hook: Optional[ExtHook]) -> Any:
    return ext_hook(code, payload) if ext_hook else ExtType(code, payload)


def _decode_map(buf, pos, n, ext_hook):
    out = {}
    for _ in range(n):
        key, pos = _decode(buf, pos, ext_hook)
        out[key], pos = _decode(buf, pos, ext_hook)
    return out, pos


def _decode_array(buf, pos, n, ext_hook):
    out = []
    for _ in range(n):
        item, pos = _decode(buf, pos, ext_hook)
        out.append(item)
    return out, pos


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    """Encode obj; ``default`` turns other types into encodable ones."""
    out = bytearray()
    _encode(obj, out, default)
    return bytes(out)


def _header(out: bytearray, n: int, fix: Optional[Tuple[int, int]],
            tags: Tuple[int, int, int]) -> None:
    """fix = (base tag, limit) of the fix form; tags for 8/16/32-bit sizes
    (0 where the form does not exist)."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
    elif tags[0] and n < 0x100:
        out += struct.pack(">BB", tags[0], n)
    elif n < 0x10000:
        out += struct.pack(">BH", tags[1], n)
    else:
        out += struct.pack(">BI", tags[2], n)


def _encode_int(obj: int, out: bytearray) -> None:
    if 0 <= obj < 0x80:
        out.append(obj)
    elif -32 <= obj < 0:
        out.append(obj + 0x100)
    elif obj > 0:
        for tag, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                (0xCE, ">I", 0xFFFFFFFF),
                                (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if obj <= limit:
                out += struct.pack(">B", tag) + struct.pack(fmt, obj)
                return
        raise OverflowError(f"int {obj} too large for msgpack")
    else:
        for tag, fmt, limit in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                (0xD2, ">i", -0x80000000),
                                (0xD3, ">q", -0x8000000000000000)):
            if obj >= limit:
                out += struct.pack(">B", tag) + struct.pack(fmt, obj)
                return
        raise OverflowError(f"int {obj} too small for msgpack")


def _encode(obj: Any, out: bytearray, default) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _encode_int(obj, out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(out, len(raw), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _header(out, len(raw), None, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, ExtType):
        n = len(obj.data)
        if n in _FIXEXT_CODE:
            out.append(_FIXEXT_CODE[n])
        else:
            _header(out, n, None, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", obj.code) + obj.data
    elif isinstance(obj, dict):
        _header(out, len(obj), (0x80, 16), (0, 0xDE, 0xDF))
        for key, value in obj.items():
            _encode(key, out, default)
            _encode(value, out, default)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), (0x90, 16), (0, 0xDC, 0xDD))
        for item in obj:
            _encode(item, out, default)
    elif default is not None:
        converted = default(obj)
        if converted is obj:
            raise TypeError(f"cannot msgpack {type(obj).__name__}")
        _encode(converted, out, None)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")
