"""Reproduction of Rust `rand` 0.8 StdRng semantics (ChaCha12).

The reference's seeded noise generator uses
``rand::rngs::StdRng::seed_from_u64`` + ``Open01`` f32 sampling
(``flacenc-rs/src/sigen.rs:227-233``). To reproduce its test fixtures
bit-for-bit we implement:

- ``seed_from_u64``: PCG32-based seed expansion (rand_core 0.6),
- ChaCha12 keystream, djb layout (64-bit block counter in words 12-13,
  64-bit stream id = 0 in words 14-15), words emitted LE in block order,
- ``Open01`` f32: 23 fraction bits -> [1, 2) minus (1 - 2^-24).

The ChaCha permutation is validated against the RFC 7539 quarter-round and
block-function vectors (tests/test_stdrng.py).
"""

from __future__ import annotations

import numpy as np

_M32 = np.uint32(0xFFFFFFFF)


def seed_from_u64(state: int) -> bytes:
    """rand_core 0.6 SeedableRng::seed_from_u64 -> 32-byte seed."""
    MUL = 6364136223846793005
    INC = 11634580027462260723
    mask = (1 << 64) - 1
    out = bytearray()
    s = state & mask
    for _ in range(8):
        s = (s * MUL + INC) & mask
        xorshifted = (((s >> 18) ^ s) >> 27) & 0xFFFFFFFF
        rot = (s >> 59) & 0x1F
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & 0xFFFFFFFF
        out += int(x).to_bytes(4, "little")
    return bytes(out)


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return ((x << np.uint32(n)) | (x >> np.uint32(32 - n))) & _M32


def chacha12_blocks(key_words: np.ndarray, counter0: int, nblocks: int) -> np.ndarray:
    """ChaCha12 keystream: (nblocks, 16) uint32 output words.

    State: 4 constants, 8 key words, 64-bit counter (words 12-13), 64-bit
    stream id 0 (words 14-15). Vectorized over blocks.
    """
    n = nblocks
    x = np.zeros((16, n), dtype=np.uint32)
    consts = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], np.uint32)
    for i in range(4):
        x[i] = consts[i]
    for i in range(8):
        x[4 + i] = key_words[i]
    ctr = (np.arange(n, dtype=np.uint64) + np.uint64(counter0))
    x[12] = (ctr & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    x[13] = (ctr >> np.uint64(32)).astype(np.uint32)
    x[14] = 0
    x[15] = 0
    init = x.copy()

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _M32
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _M32
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _M32
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _M32
        x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(6):  # 12 rounds = 6 double-rounds
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)

    out = (x + init) & _M32
    return out.T.copy()  # (nblocks, 16)


class StdRng:
    """Sequential u32/f32 sampler matching rand 0.8 StdRng."""

    def __init__(self, seed_u64: int) -> None:
        seed = seed_from_u64(seed_u64)
        self.key = np.frombuffer(seed, dtype="<u4")
        self.counter = 0
        self.buf = np.zeros(0, dtype=np.uint32)
        self.pos = 0

    def next_u32s(self, n: int) -> np.ndarray:
        while len(self.buf) - self.pos < n:
            blocks = max(4, -(-n // 16))
            fresh = chacha12_blocks(self.key, self.counter, blocks).reshape(-1)
            self.counter += blocks
            self.buf = np.concatenate([self.buf[self.pos :], fresh])
            self.pos = 0
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def open01_f32(self, n: int) -> np.ndarray:
        """rand's Open01 for f32: fraction -> [1,2) minus (1 - 2^-24)."""
        v = self.next_u32s(n)
        bits = (v >> np.uint32(9)) | np.uint32(0x3F800000)
        f = bits.view(np.float32)
        return (f - np.float32(1.0 - 2.0 ** -24)).astype(np.float32)
