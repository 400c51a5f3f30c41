"""Minimal WAV (RIFF PCM) reader/writer for the CLI.

The analogue of the reference CLI's hound-based source
(``flacenc-rs/flacenc-bin/src/source.rs``): header parse + raw block
reads, with the 8-bit offset-binary -> two's-complement fixup
(source.rs:119-124).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from .errors import SourceError
from .source import (Seekable, deinterleave_blocks,
                     le_bytes_to_samples, samples_to_le_bytes)


def read_wav(path: str) -> Tuple[np.ndarray, int, int, int]:
    """Returns (interleaved int32 samples, channels, bits_per_sample, rate)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise SourceError(SourceError.INVALID_FORMAT, path)
        fmt = None
        data = None
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            tag, size = head[:4], struct.unpack("<I", head[4:])[0]
            if tag == b"fmt ":
                fmt = f.read(size)
            elif tag == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
            if size & 1 and tag in (b"fmt ", b"data"):
                f.seek(1, 1)
        if fmt is None or data is None:
            raise SourceError(SourceError.INVALID_FORMAT, path)
        audio_format, channels, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
        if audio_format == 0xFFFE and len(fmt) >= 26:  # WAVE_FORMAT_EXTENSIBLE
            audio_format = struct.unpack("<H", fmt[24:26])[0]
        if audio_format != 1:  # PCM only
            raise SourceError(SourceError.UNSUPPORTED_FORMAT, path)
        if not (8 <= bits <= 32):
            raise SourceError(SourceError.UNSUPPORTED_FORMAT, path)
        # container bytes per sample = ceil(bits/8): 12-bit PCM is stored
        # right-aligned sign-extended in 2 bytes, 20-bit in 3 (hound does
        # the same in the reference CLI)
        bytes_per_sample = -(-bits // 8)
        n = len(data) // bytes_per_sample
        if bits == 8:
            # WAV 8-bit is unsigned (0..255) offset binary
            samples = np.frombuffer(data[:n], dtype=np.uint8).astype(np.int32) - 128
        else:
            samples = le_bytes_to_samples(data[: n * bytes_per_sample], bytes_per_sample)
        return samples.astype(np.int32), channels, bits, rate


def write_wav(path: str, interleaved: np.ndarray, channels: int, bits: int, rate: int) -> None:
    bytes_per_sample = -(-bits // 8)
    if bits == 8:
        payload = (np.asarray(interleaved, np.int32) + 128).astype(np.uint8).tobytes()
    else:
        payload = samples_to_le_bytes(np.asarray(interleaved, np.int32), bytes_per_sample)
    byte_rate = rate * channels * bytes_per_sample
    block_align = channels * bytes_per_sample
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload) + (len(payload) & 1)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, channels, rate, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)
        if len(payload) & 1:
            f.write(b"\x00")  # RIFF chunks are word-aligned


class WavFileSource(Seekable):
    """Streaming WAV source (Source + Seekable analogue,
    flacenc-bin/src/source.rs:54-133 and source.rs:499-538): parses the
    header once, then reads PCM in block-sized chunks from disk."""

    def __init__(self, path: str) -> None:
        from .errors import SourceError

        self._path = path
        self._f = open(path, "rb")
        riff = self._f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise SourceError(SourceError.INVALID_FORMAT, path)
        self._data_start = None
        self._data_len = 0
        fmt = None
        while True:
            head = self._f.read(8)
            if len(head) < 8:
                break
            tag, size = head[:4], struct.unpack("<I", head[4:])[0]
            if tag == b"fmt ":
                fmt = self._f.read(size + (size & 1))
            elif tag == b"data":
                self._data_start = self._f.tell()
                self._data_len = size
                self._f.seek(size + (size & 1), 1)
            else:
                self._f.seek(size + (size & 1), 1)
        if fmt is None or self._data_start is None:
            raise SourceError(SourceError.INVALID_FORMAT, path)
        audio_format, self._channels, self._rate, _, _, self._bits = struct.unpack(
            "<HHIIHH", fmt[:16]
        )
        if audio_format == 0xFFFE and len(fmt) >= 26:
            audio_format = struct.unpack("<H", fmt[24:26])[0]
        if audio_format != 1:
            raise SourceError(SourceError.UNSUPPORTED_FORMAT, path)
        if not (8 <= self._bits <= 32):
            raise SourceError(SourceError.UNSUPPORTED_FORMAT, path)
        self._bytes_per_sample = -(-self._bits // 8)  # ceil: 12-bit -> 2B
        self._pos = 0  # bytes consumed within data chunk
        self._f.seek(self._data_start)

    def channels(self) -> int:
        return self._channels

    def bits_per_sample(self) -> int:
        return self._bits

    def sample_rate(self) -> int:
        return self._rate

    def len_hint(self):
        return self._data_len // (self._bytes_per_sample * self._channels)

    def __len__(self) -> int:
        return self._data_len // (self._bytes_per_sample * self._channels)

    # Seekable (source.rs:499-538)
    def seek_samples(self, n: int) -> None:
        byte = n * self._bytes_per_sample * self._channels
        if byte > self._data_len:
            raise ValueError(
                f"seek_samples({n}) is past the end of the data chunk"
            )
        self._pos = byte
        self._f.seek(self._data_start + byte)

    def read_samples(self, block_size: int, dest) -> int:
        framebuf, context = dest if isinstance(dest, tuple) else (dest, None)
        want = block_size * self._channels * self._bytes_per_sample
        remaining = self._data_len - self._pos
        raw = self._f.read(min(want, remaining))
        if not raw:
            return 0
        self._pos += len(raw)
        if self._bits == 8:
            samples = (
                np.frombuffer(raw, dtype=np.uint8).astype(np.int32) - 128
            )
        else:
            samples = le_bytes_to_samples(raw, self._bytes_per_sample)
        framebuf.fill_interleaved(samples)
        if context is not None:
            if self._bits == 8:
                context.fill_interleaved(samples)
            else:
                context.fill_le_bytes(raw, self._bytes_per_sample)
        return len(samples) // self._channels

    def read_blocks_batch(self, n_blocks: int, block_size: int, context):
        """Bulk fast path (see `Source.read_blocks_batch`): one disk
        read, one md5 fill over the RAW little-endian file bytes (zero
        sample-width conversion on the hash path), one vectorized
        deinterleave per batch."""
        C = self._channels
        bpsam = self._bytes_per_sample
        block_bytes = block_size * C * bpsam
        avail = (self._data_len - self._pos) // block_bytes
        k = min(n_blocks, avail)
        if k <= 0:
            return np.empty((0, C, block_size), np.int32)
        raw = self._f.read(k * block_bytes)
        if len(raw) < k * block_bytes:  # short file despite header claim
            k = len(raw) // block_bytes
            keep = k * block_bytes
            # the fd consumed the partial tail bytes too; rewind so the
            # per-block read_samples fallback still encodes them as the
            # tail block (bulk and per-block paths must match bytes)
            self._f.seek(self._data_start + self._pos + keep)
            raw = raw[:keep]
            if k <= 0:
                return np.empty((0, C, block_size), np.int32)
        self._pos += len(raw)
        if self._bits == 8:
            samples = (
                np.frombuffer(raw, dtype=np.uint8).astype(np.int16) - 128
            )
            if context is not None:
                context.fill_interleaved(samples, copy=False, blocks=k)
        elif bpsam == 2 and self._bits <= 16:
            # int16 fast path: the file bytes ARE the samples (no widen;
            # half the deinterleave/upload/pack memory traffic). The
            # pipeline's per-batch range check still validates bps < 16.
            samples = np.frombuffer(raw, dtype="<i2")
            if context is not None:
                context.fill_le_bytes(raw, bpsam, blocks=k)
        else:
            samples = le_bytes_to_samples(raw, bpsam)
            if context is not None:
                context.fill_le_bytes(raw, bpsam, blocks=k)
        return deinterleave_blocks(samples, k, block_size, C)

    def close(self) -> None:
        self._f.close()
