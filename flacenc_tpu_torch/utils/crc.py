"""FLAC CRCs (pure-python fallback; the native packer has its own tables).

FLAC uses CRC-8 (poly 0x07, init 0) for frame headers and CRC-16
(poly 0x8005, init 0, no reflection) for whole frames — the same algorithms
the reference selects as ``CRC_8_SMBUS``/``CRC_16_UMTS``
(``flacenc-rs/src/component/bitrepr.rs:39-40``).
"""

from __future__ import annotations

import numpy as np


def _make_crc8_table(poly: int = 0x07) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint8)
    for i in range(256):
        c = i
        for _ in range(8):
            c = ((c << 1) ^ poly) & 0xFF if (c & 0x80) else (c << 1) & 0xFF
        table[i] = c
    return table


def _make_crc16_table(poly: int = 0x8005) -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for i in range(256):
        c = i << 8
        for _ in range(8):
            c = ((c << 1) ^ poly) & 0xFFFF if (c & 0x8000) else (c << 1) & 0xFFFF
        table[i] = c
    return table


_CRC8_TABLE = _make_crc8_table()
_CRC16_TABLE = _make_crc16_table()


def _native_crc():
    try:
        from .. import native

        lib = native._load()
        if lib is None:
            return None, None
        import ctypes

        if getattr(lib.flacenc_crc16, "argtypes", None) is None:
            lib.flacenc_crc16.restype = ctypes.c_uint16
            lib.flacenc_crc16.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.flacenc_crc8.restype = ctypes.c_uint8
            lib.flacenc_crc8.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        return lib.flacenc_crc8, lib.flacenc_crc16
    except Exception:  # pragma: no cover
        return None, None


_N8, _N16 = None, None
_NATIVE_TRIED = False


def _ensure_native():
    global _N8, _N16, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _N8, _N16 = _native_crc()
        _NATIVE_TRIED = True


def crc8(data: bytes, init: int = 0) -> int:
    _ensure_native()
    if _N8 is not None and init == 0:
        return int(_N8(bytes(data), len(data)))
    crc = init
    t = _CRC8_TABLE
    for b in data:
        crc = int(t[crc ^ b])
    return crc


def crc16(data: bytes, init: int = 0) -> int:
    _ensure_native()
    if _N16 is not None and init == 0:
        return int(_N16(bytes(data), len(data)))
    crc = init
    t = _CRC16_TABLE
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ int(t[((crc >> 8) ^ b) & 0xFF])
    return crc
