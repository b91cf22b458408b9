"""A reader of the ``.gckpt`` format, written for the benchmark alone.

A ``.gckpt`` is one msgpack document: nested maps of strings whose leaves
are msgpack extension objects of type 1 (an array: the msgpack triple
(shape, dtype name, raw bytes)) or type 3 (a scalar, the same triple).
bfloat16 leaves are stored as their raw 16 bits. This decoder covers the
msgpack types such a file uses and raises on anything else.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _array(payload: bytes) -> torch.Tensor:
    (shape, dtype_name, raw), _ = _decode(payload, 0)
    if dtype_name == "bfloat16":
        bits = np.frombuffer(raw, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)
    return torch.from_numpy(arr.copy())


def _ext(code: int, payload: bytes) -> Any:
    if code == 1:
        return _array(payload)
    if code == 3:
        return _array(payload).reshape(())
    raise ValueError(f"msgpack extension type {code} is not a .gckpt leaf")


def _decode(buf: bytes, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _list(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return buf[pos:pos + n].decode(), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    sized = {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4}
    if b in sized:
        n, pos = _uint(buf, pos, sized[b])
        data = buf[pos:pos + n]
        return (data.decode() if b >= 0xD9 else bytes(data)), pos + n
    if b in (0xC7, 0xC8, 0xC9):
        n, pos = _uint(buf, pos, {0xC7: 1, 0xC8: 2, 0xC9: 4}[b])
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    if 0xD4 <= b <= 0xD8:
        n = 1 << (b - 0xD4)
        code = struct.unpack_from(">b", buf, pos)[0]
        return _ext(code, buf[pos + 1:pos + 1 + n]), pos + 1 + n
    if b == 0xCA:
        return struct.unpack_from(">f", buf, pos)[0], pos + 4
    if b == 0xCB:
        return struct.unpack_from(">d", buf, pos)[0], pos + 8
    if 0xCC <= b <= 0xCF:
        return _uint(buf, pos, 1 << (b - 0xCC))
    if 0xD0 <= b <= 0xD3:
        n = 1 << (b - 0xD0)
        fmt = {1: ">b", 2: ">h", 4: ">i", 8: ">q"}[n]
        return struct.unpack_from(fmt, buf, pos)[0], pos + n
    if b in (0xDC, 0xDD):
        n, pos = _uint(buf, pos, 2 if b == 0xDC else 4)
        return _list(buf, pos, n)
    if b in (0xDE, 0xDF):
        n, pos = _uint(buf, pos, 2 if b == 0xDE else 4)
        return _map(buf, pos, n)
    raise ValueError(f"msgpack type byte {b:#x} is not used by a .gckpt")


def _uint(buf: bytes, pos: int, n: int) -> Tuple[int, int]:
    return int.from_bytes(buf[pos:pos + n], "big"), pos + n


def _list(buf: bytes, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _decode(buf, pos)
        out.append(item)
    return out, pos


def _map(buf: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _decode(buf, pos)
        out[key], pos = _decode(buf, pos)
    return out, pos


def read_gckpt(path: str) -> Dict[str, Any]:
    """The file's tree: nested dicts of CPU tensors."""
    with open(path, "rb") as f:
        buf = f.read()
    tree, end = _decode(buf, 0)
    if end != len(buf):
        raise ValueError(f"{path}: {len(buf) - end} bytes after the document")
    return tree


def flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"a": {"b": t}} -> {"a.b": t}."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out
