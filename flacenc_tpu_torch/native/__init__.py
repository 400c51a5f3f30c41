"""ctypes bindings for the port's native C++ library (``packer.cpp``).

The packer consumes the device pipeline's decisions and the raw blocks and
emits FLAC frame bytes in one call per batch (the bit-serial stage the
reference implements in ``src/bitsink.rs``/``bitrepr.rs``). The batched
path has no fallback: without the library, `pack_frames_recompute` and
strict mode raise. The parser, the decoder's LPC synthesis and the numpy
oracle's strict estimates use the library when it loads and their Python
code otherwise. The library is built on first use (``build.py``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

# Reusable per-thread output buffer for pack_frames_recompute: a fresh
# ~10 MB np.empty per batch costs several ms of page faults INSIDE the
# C++ pack (first touch of every 4 KB page); reusing keeps the pages hot.
# Thread-local because the packer may run concurrently from io threads.
_pack_scratch = threading.local()


def _scratch_out(capacity: int) -> np.ndarray:
    buf = getattr(_pack_scratch, "out", None)
    if buf is None or buf.size < capacity:
        buf = np.empty(capacity, dtype=np.uint8)
        _pack_scratch.out = buf
    return buf

_lib = None
_load_error: Optional[Exception] = None


def _load():
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        from .build import build

        lib = ctypes.CDLL(build())
        _lib = lib
    except Exception as e:  # pragma: no cover - toolchain missing
        _load_error = e
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pack_frames_recompute(
    blocks: np.ndarray,        # (F, C, T) int32 raw input channels
    assign: np.ndarray,        # (F,) int32 stereo assignment code
    sf_type: np.ndarray,       # (F, C) int32
    order: np.ndarray,         # (F, C) int32
    qcoefs: np.ndarray,        # (F, C, 24) int32
    shift: np.ndarray,         # (F, C) int32
    rice_order: np.ndarray,    # (F, C) int32
    rice_params: np.ndarray,   # (F, C, P) int32
    ch_tag: np.ndarray,        # (F,) int32
    frame_numbers: np.ndarray, # (F,) int64
    bps_base: int,
    precision: int,
    bs_spec: Tuple[int, int, int],
    sr_spec: Tuple[int, int, int],
    ss_tag: int,
    n_threads: int = 0,
) -> Tuple[bytes, np.ndarray]:
    """Packs frames from device DECISIONS only.

    Stored channels (M/S) and chosen-predictor residuals are recomputed in
    C++ from the raw input blocks — residuals never cross the device link.

    Frames are independent, so the batch is packed by `n_threads` worker
    threads (callers resolve it via `parallel.determine_worker_count`:
    config.workers -> env FLACENC_WORKERS -> FLACENC_PACK_THREADS -> all
    cores; 1 = sequential) into worst-case regions compacted in order
    afterward — bytes are identical either way.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native packer unavailable: {_load_error!r}")
    # int16 blocks take the `16` entry point (bps<=16 fast path: raw
    # channels are sign-extended inline in C++, so no int32 copy of the
    # batch is ever materialized); any other dtype widens to int32.
    narrow = blocks.dtype == np.int16
    entry = (lib.flacenc_pack_frames_recompute16 if narrow
             else lib.flacenc_pack_frames_recompute)
    blk_ctype = ctypes.c_int16 if narrow else ctypes.c_int32
    if getattr(entry, "argtypes", None) is None:
        entry.restype = ctypes.c_int64
        entry.argtypes = (
            [ctypes.POINTER(blk_ctype)]
            + [ctypes.POINTER(ctypes.c_int32)] * 8
            + [ctypes.POINTER(ctypes.c_int64)]
            + [ctypes.c_int32] * 13
            + [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
               ctypes.POINTER(ctypes.c_int64), ctypes.c_int32]
        )
    if n_threads < 1:
        from ..parallel import determine_worker_count

        n_threads = determine_worker_count()
    n_threads = min(n_threads, 64)  # worker spawn is per call; cap fan-out
    F, C, T = blocks.shape
    P = rice_params.shape[-1]

    def c32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    blocks = (np.ascontiguousarray(blocks) if narrow else c32(blocks))
    assign = c32(assign); sf_type = c32(sf_type)
    order = c32(order); qcoefs = c32(qcoefs); shift = c32(shift)
    rice_order = c32(rice_order); rice_params = c32(rice_params)
    ch_tag = c32(ch_tag)
    frame_numbers = np.ascontiguousarray(frame_numbers, dtype=np.int64)

    capacity = F * (64 + C * (T * 5 + 64))
    out = _scratch_out(capacity)
    sizes = np.zeros(F, dtype=np.int64)
    total = entry(
        _ptr(blocks, blk_ctype), _ptr(assign, ctypes.c_int32),
        _ptr(sf_type, ctypes.c_int32), _ptr(order, ctypes.c_int32),
        _ptr(qcoefs, ctypes.c_int32), _ptr(shift, ctypes.c_int32),
        _ptr(rice_order, ctypes.c_int32), _ptr(rice_params, ctypes.c_int32),
        _ptr(ch_tag, ctypes.c_int32), _ptr(frame_numbers, ctypes.c_int64),
        F, C, T, P, bps_base, precision,
        bs_spec[0], bs_spec[1], bs_spec[2],
        sr_spec[0], sr_spec[1], sr_spec[2],
        ss_tag,
        _ptr(out, ctypes.c_uint8), capacity,
        _ptr(sizes, ctypes.c_int64), n_threads,
    )
    assert total >= 0, "native packer capacity exceeded"
    return out[:total].tobytes(), sizes


def estimate_entropy_strict(
    errors: np.ndarray, warmup: int, partitions: int
) -> Optional[int]:
    """Sequential-f32 entropy estimate (reference stable-build semantics)."""
    lib = _load()
    if lib is None:
        return None
    fn = lib.flacenc_estimate_entropy
    if getattr(fn, "argtypes", None) is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
    err = np.ascontiguousarray(errors, np.int32)
    return int(fn(_ptr(err, ctypes.c_int32), len(err), warmup, partitions))


def strict_fixed_order(
    signals: np.ndarray, bps: np.ndarray, max_order: int, partitions: int
):
    """Strict ApproxEnt fixed-LPC order selection for N channels.

    signals (N, T) int32, bps (N,) int32 ->
    (order (N,) int32, est_bits (N,) int64); None if the lib is missing.
    """
    lib = _load()
    if lib is None:
        return None
    fn = lib.flacenc_strict_fixed_order
    if getattr(fn, "argtypes", None) is None:
        fn.restype = None
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ]
    signals = np.ascontiguousarray(signals, np.int32)
    bps = np.ascontiguousarray(bps, np.int32)
    N, T = signals.shape
    order = np.zeros(N, np.int32)
    est = np.zeros(N, np.int64)
    fn(
        _ptr(signals, ctypes.c_int32), _ptr(bps, ctypes.c_int32),
        N, T, max_order, partitions,
        _ptr(order, ctypes.c_int32), _ptr(est, ctypes.c_int64),
    )
    return order, est


def lpc_synthesis(
    warm_up: np.ndarray, coefs: np.ndarray, shift: int, residual: np.ndarray
) -> Optional[np.ndarray]:
    """C++ IIR synthesis for the decoder; None when the lib is missing."""
    lib = _load()
    if lib is None:
        return None
    if getattr(lib.flacenc_lpc_synthesis, "argtypes", None) is None:
        lib.flacenc_lpc_synthesis.restype = None
        lib.flacenc_lpc_synthesis.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
        ]
    n = len(residual)
    order = len(coefs)
    out = np.zeros(n, dtype=np.int32)
    out[:order] = np.asarray(warm_up[:order], np.int32)
    res = np.ascontiguousarray(residual, np.int32)
    cfs = np.ascontiguousarray(coefs, np.int32)
    lib.flacenc_lpc_synthesis(
        _ptr(out, ctypes.c_int32), _ptr(res, ctypes.c_int32),
        _ptr(cfs, ctypes.c_int32), order, shift, n,
    )
    return out


def strict_qlpc(
    signals: np.ndarray, window: np.ndarray, lpc_order: int, precision: int
):
    """Strict-float QLPC (stable-reference semantics) for N channels.

    signals (N, T) int32, window (T,) float32 ->
    (qcoefs (N, 24) int32, order (N,) int32, shift (N,) int32).
    Returns None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    if getattr(lib.flacenc_strict_qlpc, "argtypes", None) is None:
        lib.flacenc_strict_qlpc.restype = None
        lib.flacenc_strict_qlpc.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
    signals = np.ascontiguousarray(signals, np.int32)
    window = np.ascontiguousarray(window, np.float32)
    N, T = signals.shape
    qcoefs = np.zeros((N, 24), np.int32)
    order = np.zeros(N, np.int32)
    shift = np.zeros(N, np.int32)
    lib.flacenc_strict_qlpc(
        _ptr(signals, ctypes.c_int32), _ptr(window, ctypes.c_float),
        N, T, lpc_order, precision,
        _ptr(qcoefs, ctypes.c_int32), _ptr(order, ctypes.c_int32),
        _ptr(shift, ctypes.c_int32),
    )
    return qcoefs, order, shift


def parse_samples(data, bit_offset: int, count: int, bps: int):
    """C++ fixed-width signed sample run (the parser's verbatim/warm-up
    fast path): returns (new_bit_offset, (count,) int32 samples), None
    when the native library is unavailable; raises ValueError on
    truncation."""
    lib = _load()
    if lib is None:
        return None
    fn = lib.flacenc_parse_samples
    if getattr(fn, "argtypes", None) is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ]
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(count, np.int32)
    new_pos = fn(
        _ptr(buf, ctypes.c_uint8), len(data) * 8, bit_offset,
        count, bps, _ptr(out, ctypes.c_int32),
    )
    if new_pos < 0:
        raise ValueError("truncated sample run")
    return int(new_pos), out


def parse_residual(data: bytes, bit_offset: int, block_size: int, warmup: int):
    """C++ residual parse; returns (new_offset, order, params, q, r) or
    None when the native library is unavailable. Raises ValueError on
    malformed input (matching the Python parser's ParseError conditions)."""
    lib = _load()
    if lib is None:
        return None
    fn = lib.flacenc_parse_residual
    if getattr(fn, "argtypes", None) is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ]
    buf = np.frombuffer(data, dtype=np.uint8)
    order = np.zeros(1, np.int32)
    params = np.zeros(1 << 15, np.int32)
    q = np.zeros(block_size, np.uint32)
    r = np.zeros(block_size, np.uint32)
    new_pos = fn(
        _ptr(buf, ctypes.c_uint8), len(data) * 8, bit_offset,
        block_size, warmup,
        _ptr(order, ctypes.c_int32), _ptr(params, ctypes.c_int32),
        _ptr(q, ctypes.c_uint32), _ptr(r, ctypes.c_uint32),
    )
    if new_pos < 0:
        raise ValueError("malformed residual")
    nparts = 1 << int(order[0])
    return int(new_pos), int(order[0]), params[:nparts].copy(), q, r
