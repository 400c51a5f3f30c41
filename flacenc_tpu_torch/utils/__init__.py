"""Host-side helpers: CRCs, UTF-8-like numbers, byte packing."""

from .crc import crc8, crc16
from .utf8like import encode_to_utf8like, utf8like_bytesize

__all__ = ["crc8", "crc16", "encode_to_utf8like", "utf8like_bytesize"]
