"""UTF-8-like frame/sample-number coding used by FLAC frame headers.

Semantics mirror ``flacenc-rs/src/component/bitrepr.rs:109-170``:
values up to 36 bits are encoded with a UTF-8-style head byte and 6-bit
continuation bytes (head byte 0xFE for 6 trailing bytes).
"""

from __future__ import annotations

from ..errors import RangeError

_UTF8_HEADS = [0x80, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC, 0xFE]


def encode_to_utf8like(val: int) -> bytes:
    if val < 0:
        raise RangeError("input", "must be non-negative", val)
    code_bits = val.bit_length()
    if code_bits <= 7:
        return bytes([val])
    if code_bits > 36:
        raise RangeError("input", "cannot exceed 36 bits.", val)
    trailing_bytes = (code_bits - 2) // 5
    capacity = trailing_bytes * 6 + 6 - trailing_bytes
    first_bits = 6 - trailing_bytes
    v = (val << (64 - capacity)) & ((1 << 64) - 1)
    if trailing_bytes == 6:
        head_byte = 0xFE
    else:
        head_byte = _UTF8_HEADS[trailing_bytes] | ((v >> (64 - first_bits)) & 0xFF)
    out = [head_byte]
    v = (v << first_bits) & ((1 << 64) - 1)
    for _ in range(trailing_bytes):
        out.append(0x80 | (v >> 58))
        v = (v << 6) & ((1 << 64) - 1)
    return bytes(out)


def utf8like_bytesize(val: int) -> int:
    code_bits = val.bit_length()
    if code_bits <= 7:
        return 1
    return 1 + (code_bits - 2) // 5
