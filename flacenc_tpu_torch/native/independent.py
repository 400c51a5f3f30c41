"""ctypes binding for the clean-room independent decoder oracle.

`decode_stream(data)` decodes a complete FLAC byte stream through
``native/decoder.cpp`` — a from-scratch spec implementation sharing zero
code with the Python component model or the encoder-side packer — and
returns the interleaved samples plus header facts. It fills the role of
the third-party claxon decoder in the reference's integrity tests
(flacenc-rs/src/test_helper.rs:131-185): the fourth oracle that
cannot share a bug with the encoder.

Intentionally NOT wired into any encode path — tests only.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np

_lib = None
_load_error: Optional[Exception] = None


class IndependentDecode(NamedTuple):
    samples: np.ndarray   # interleaved int32
    channels: int
    bits_per_sample: int
    sample_rate: int
    total_samples: int    # STREAMINFO field (0 = unknown)
    n_frames: int
    md5: bytes            # STREAMINFO md5 field (16 bytes)
    min_block_size: int
    max_block_size: int


class IndependentDecodeError(ValueError):
    """Spec violation reported by the clean-room decoder."""


_ERRORS = {
    -1: "missing fLaC magic",
    -2: "truncated stream",
    -3: "bad metadata",
    -4: "lost frame sync",
    -5: "bad frame header",
    -6: "frame header CRC-8 mismatch",
    -7: "frame CRC-16 mismatch",
    -8: "bad subframe",
    -9: "bad residual",
    -10: "bad channel layout",
    -11: "bad UTF-8-like number",
}


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        from .build import build_decoder

        lib = ctypes.CDLL(build_decoder())
        fn = lib.flacenc_decode_stream
        fn.restype = ctypes.c_int32
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ]
        _lib = lib
    except Exception as e:  # pragma: no cover - toolchain missing
        _load_error = e
    return _lib


def available() -> bool:
    return _load() is not None


def decode_stream(data: bytes) -> IndependentDecode:
    """Full independent decode; raises IndependentDecodeError on any
    spec violation (bad magic, CRC mismatch, malformed subframe, ...)."""
    lib = _load()
    assert lib is not None, f"independent decoder unavailable: {_load_error}"
    buf = np.frombuffer(data, dtype=np.uint8)
    info = np.zeros(10, np.int64)
    md5 = np.zeros(16, np.uint8)

    def call(cap: int):
        out = np.empty(max(cap, 1), np.int32)
        rc = lib.flacenc_decode_stream(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            info.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            md5.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return rc, out

    # STREAMINFO usually knows the sample count; retry once if it lied
    first_guess = 0
    if len(data) >= 42:
        total = int.from_bytes(data[21:26], "big") & ((1 << 36) - 1)
        channels = ((data[20] >> 1) & 0x7) + 1
        # clamp so a corrupt/malicious 36-bit total cannot demand a
        # ~2^36-element allocation and OOM the fuzz/test process. The
        # bound must stay ABOVE real high-compression ratios (constant
        # subframes reach ~0.02 bits/sample, i.e. ~400 samples/byte) or
        # legitimate streams pay a full decode-retry round; 2048
        # samples/byte clears that by 5x while capping a 1 KB malicious
        # header at a ~16 MB allocation
        first_guess = min(total * channels,
                          max(len(data) * 2048, 1 << 20))
    rc, out = call(first_guess)
    if rc == 1:
        rc, out = call(int(info[8]))
    if rc < 0:
        raise IndependentDecodeError(
            _ERRORS.get(rc, f"decode error {rc}")
        )
    assert rc == 0, rc
    return IndependentDecode(
        samples=out[: int(info[7])],
        channels=int(info[3]),
        bits_per_sample=int(info[4]),
        sample_rate=int(info[2]),
        total_samples=int(info[5]),
        n_frames=int(info[6]),
        md5=bytes(md5),
        min_block_size=int(info[0]),
        max_block_size=int(info[1]),
    )
