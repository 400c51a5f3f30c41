"""Minimal MessagePack codec (no external dependency).

The reference CLI dumps parsed streams as rmp-serde msgpack
(``flacenc-bin/src/main.rs:301-316``); this module provides the msgpack
container for the same feature (`--dump-struct`). Supports the types the
component serde tree uses: nil, bool, int, float64, str, bytes, array, map.
Spec: https://github.com/msgpack/msgpack/blob/master/spec.md
"""

from __future__ import annotations

import struct
from typing import Any


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(o: Any, out: bytearray) -> None:
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif isinstance(o, int):
        _pack_int(o, out)
    elif isinstance(o, float):
        out.append(0xCB)
        out += struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode("utf-8")
        n = len(b)
        if n <= 31:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += bytes([0xD9, n])
        elif n <= 0xFFFF:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += b
    elif isinstance(o, (bytes, bytearray)):
        n = len(o)
        if n <= 0xFF:
            out += bytes([0xC4, n])
        elif n <= 0xFFFF:
            out += b"\xc5" + struct.pack(">H", n)
        else:
            out += b"\xc6" + struct.pack(">I", n)
        out += bytes(o)
    elif isinstance(o, (list, tuple)):
        n = len(o)
        if n <= 15:
            out.append(0x90 | n)
        elif n <= 0xFFFF:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for v in o:
            _pack(v, out)
    elif isinstance(o, dict):
        n = len(o)
        if n <= 15:
            out.append(0x80 | n)
        elif n <= 0xFFFF:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    else:
        # numpy scalars and the like
        import numpy as np

        if isinstance(o, np.integer):
            _pack_int(int(o), out)
            return
        if isinstance(o, np.floating):
            _pack(float(o), out)
            return
        raise TypeError(f"cannot msgpack {type(o)!r}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v <= 0x7F:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif 0 <= v <= 0xFF:
        out += bytes([0xCC, v])
    elif 0 <= v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif 0 <= v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif 0 <= v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif -0x8000 <= v < 0:
        out += b"\xd1" + struct.pack(">h", v)
    elif -0x80000000 <= v < 0:
        out += b"\xd2" + struct.pack(">i", v)
    elif -0x8000000000000000 <= v < 0:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"int out of msgpack range: {v}")


def unpackb(data: bytes) -> Any:
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"trailing msgpack bytes at {pos}")
    return obj


def _unpack(mv: memoryview, pos: int):
    b = mv[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(mv, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(mv, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(mv[pos:pos + n], "utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in (0xC4, 0xC5, 0xC6):
        w = {0xC4: 1, 0xC5: 2, 0xC6: 4}[b]
        n = int.from_bytes(mv[pos:pos + w], "big")
        pos += w
        return bytes(mv[pos:pos + n]), pos + n
    if b == 0xCA:
        return struct.unpack(">f", mv[pos:pos + 4])[0], pos + 4
    if b == 0xCB:
        return struct.unpack(">d", mv[pos:pos + 8])[0], pos + 8
    if b in (0xCC, 0xCD, 0xCE, 0xCF):
        w = 1 << (b - 0xCC)
        return int.from_bytes(mv[pos:pos + w], "big"), pos + w
    if b in (0xD0, 0xD1, 0xD2, 0xD3):
        w = 1 << (b - 0xD0)
        return int.from_bytes(mv[pos:pos + w], "big", signed=True), pos + w
    if b in (0xD9, 0xDA, 0xDB):
        w = {0xD9: 1, 0xDA: 2, 0xDB: 4}[b]
        n = int.from_bytes(mv[pos:pos + w], "big")
        pos += w
        return str(mv[pos:pos + n], "utf-8"), pos + n
    if b in (0xDC, 0xDD):
        w = 2 if b == 0xDC else 4
        n = int.from_bytes(mv[pos:pos + w], "big")
        return _unpack_array(mv, pos + w, n)
    if b in (0xDE, 0xDF):
        w = 2 if b == 0xDE else 4
        n = int.from_bytes(mv[pos:pos + w], "big")
        return _unpack_map(mv, pos + w, n)
    raise ValueError(f"unsupported msgpack byte {b:#x}")


def _unpack_array(mv: memoryview, pos: int, n: int):
    out = []
    for _ in range(n):
        v, pos = _unpack(mv, pos)
        out.append(v)
    return out, pos


def _unpack_map(mv: memoryview, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _unpack(mv, pos)
        v, pos = _unpack(mv, pos)
        out[k] = v
    return out, pos
