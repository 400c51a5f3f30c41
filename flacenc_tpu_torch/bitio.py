"""Bit-level output sink (Python oracle path).

Mirrors the `BitSink` abstraction of ``flacenc-rs/src/bitsink.rs``:
MSB-first bit packing into a growable byte buffer. The production encoder
uses the C++ packer in ``native/``; this class is the readable
reference implementation used by the component model's ``write`` methods and
by tests.
"""

from __future__ import annotations


class BitSink:
    """MSB-first bit writer backed by a ``bytearray``."""

    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0  # partial byte, left-aligned in the low `_nbits` bits
        self._nbits = 0  # bits currently held in _acc (0..7)

    def __len__(self) -> int:
        """Total number of bits written."""
        return len(self._buf) * 8 + self._nbits

    def write_lsbs(self, value: int, n: int) -> None:
        """Write the lowest `n` bits of non-negative `value`, MSB first."""
        if n == 0:
            return
        value &= (1 << n) - 1
        acc = (self._acc << n) | value
        nbits = self._nbits + n
        while nbits >= 8:
            nbits -= 8
            self._buf.append((acc >> nbits) & 0xFF)
        self._acc = acc & ((1 << nbits) - 1)
        self._nbits = nbits

    def write_msbs(self, value: int, width: int, n: int) -> None:
        """Write the top `n` bits of a `width`-bit value, MSB first
        (bitsink.rs write_msbs; width plays the role of the Rust type)."""
        self.write_lsbs(value >> (width - n), n)

    def write_twoc(self, value: int, n: int) -> None:
        """Write `value` as an `n`-bit two's-complement integer."""
        self.write_lsbs(value & ((1 << n) - 1), n)

    def write_zeros(self, n: int) -> None:
        if n == 0:
            return
        nbits = self._nbits + n
        if nbits < 8:
            self._acc <<= n
            self._nbits = nbits
            return
        # flush the partial byte padded with zeros, then whole zero bytes
        self._buf.append((self._acc << (8 - self._nbits)) & 0xFF if self._nbits else 0)
        remaining = nbits - 8
        self._buf.extend(b"\x00" * (remaining // 8))
        self._acc = 0
        self._nbits = remaining % 8

    def write_unary(self, q: int) -> None:
        """`q` zeros followed by a one (Rice quotient)."""
        self.write_zeros(q)
        self.write_lsbs(1, 1)

    def align_to_byte(self) -> None:
        if self._nbits:
            self._buf.append((self._acc << (8 - self._nbits)) & 0xFF)
            self._acc = 0
            self._nbits = 0

    def write_bytes_aligned(self, data: bytes) -> None:
        assert self._nbits == 0, "write_bytes_aligned requires byte alignment"
        self._buf.extend(data)

    def as_bytes(self) -> bytes:
        assert self._nbits == 0, "sink is not byte-aligned"
        return bytes(self._buf)

    def to_bitstring(self) -> str:
        """Debug rendering: '_'-separated bytes, '*' for pending tail bits."""
        parts = [format(b, "08b") for b in self._buf]
        if self._nbits:
            tail = format(self._acc, f"0{self._nbits}b") + "*" * (8 - self._nbits)
            parts.append(tail)
        return "_".join(parts)
