"""ctypes bindings for the port's native C++ library (``packer.cpp``).

The packer consumes the device pipeline's decisions and the raw blocks and
emits FLAC frame bytes in one call per batch (the bit-serial stage the
reference implements in ``src/bitsink.rs``/``bitrepr.rs``); it also scans
and packs the upload wires of ``ops/upack.py``. The batched path has no
fallback: without the library, `pack_frames_recompute`, `pack_frames`,
`compute_errors`, `pack_upload`, `pack_rice` and strict mode raise (the
"python" packer needs none of them; the wire scans return NotImplemented
and ``ops/upack.py`` takes its numpy path). The parser, the decoder's LPC synthesis and the numpy
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


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native packer unavailable: {_load_error!r}")
    return lib


def pack_frames(
    signal: np.ndarray,        # (F, C, T) int32 stored channel signals
    errors: np.ndarray,        # (F, C, T) int32 chosen-predictor residuals
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
    bs_spec: Tuple[int, int, int],  # (tag, extra_bits, extra_val)
    sr_spec: Tuple[int, int, int],
    ss_tag: int,
) -> Tuple[bytes, np.ndarray]:
    """Packs a batch of frames from the stored-channel signals and the
    residuals the device shipped ("native" packer); returns (concatenated
    bytes, per-frame sizes). Raises when the library is missing."""
    fn = _require().flacenc_pack_frames
    if getattr(fn, "argtypes", None) is None:
        fn.restype = ctypes.c_int64
        fn.argtypes = (
            [ctypes.POINTER(ctypes.c_int32)] * 9
            + [ctypes.POINTER(ctypes.c_int64)]
            + [ctypes.c_int32] * 13
            + [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
               ctypes.POINTER(ctypes.c_int64)]
        )
    F, C, T = signal.shape
    P = rice_params.shape[-1]

    def c32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    signal = c32(signal); errors = c32(errors); sf_type = c32(sf_type)
    order = c32(order); qcoefs = c32(qcoefs); shift = c32(shift)
    rice_order = c32(rice_order); rice_params = c32(rice_params)
    ch_tag = c32(ch_tag)
    frame_numbers = np.ascontiguousarray(frame_numbers, dtype=np.int64)

    capacity = F * (64 + C * (T * 5 + 64))
    out = _scratch_out(capacity)
    sizes = np.zeros(F, dtype=np.int64)
    total = fn(
        _ptr(signal, ctypes.c_int32), _ptr(errors, ctypes.c_int32),
        _ptr(sf_type, ctypes.c_int32), _ptr(order, ctypes.c_int32),
        _ptr(qcoefs, ctypes.c_int32), _ptr(shift, ctypes.c_int32),
        _ptr(rice_order, ctypes.c_int32), _ptr(rice_params, ctypes.c_int32),
        _ptr(ch_tag, ctypes.c_int32), _ptr(frame_numbers, ctypes.c_int64),
        F, C, T, P, bps_base, precision,
        bs_spec[0], bs_spec[1], bs_spec[2],
        sr_spec[0], sr_spec[1], sr_spec[2],
        ss_tag,
        _ptr(out, ctypes.c_uint8), capacity,
        _ptr(sizes, ctypes.c_int64),
    )
    if total < 0:
        raise RuntimeError("native packer capacity exceeded")
    return out[:total].tobytes(), sizes


def compute_errors(
    signals: np.ndarray, is_lpc: np.ndarray, order: np.ndarray,
    qcoefs: np.ndarray, shift: np.ndarray,
) -> np.ndarray:
    """Batched exact residual recompute (fixed cascade / QLPC FIR) for the
    channels whose residual did not fit int16: signals (N, T) int32 ->
    (N, T) int32 errors. Raises when the library is missing."""
    fn = _require().flacenc_compute_errors
    if getattr(fn, "argtypes", None) is None:
        fn.restype = None
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]

    def c32(a):
        return np.ascontiguousarray(a, dtype=np.int32)

    signals = c32(signals)
    N, T = signals.shape
    is_lpc = c32(is_lpc); order = c32(order); shift = c32(shift)
    qcoefs = c32(qcoefs)
    if qcoefs.shape != (N, 24):
        raise ValueError(f"qcoefs shape {qcoefs.shape} is not ({N}, 24)")
    err = np.empty((N, T), np.int32)
    fn(
        _ptr(signals, ctypes.c_int32), N, T,
        _ptr(is_lpc, ctypes.c_int32), _ptr(order, ctypes.c_int32),
        _ptr(qcoefs, ctypes.c_int32), _ptr(shift, ctypes.c_int32),
        _ptr(err, ctypes.c_int32),
    )
    return err


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
    lib = _require()
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


# ---------------------------------------------------------------------------
# upload wires (ops/upack.py): scans and packs of a (..., T) int16/int32 chunk
# ---------------------------------------------------------------------------


def _chunk(chunk: np.ndarray):
    """(contiguous array, its ctype, narrow): int16 chunks are read as they
    are (the `16` entry points sign-extend inline), others as int32."""
    narrow = chunk.dtype == np.int16
    x = np.ascontiguousarray(chunk) if narrow else np.ascontiguousarray(chunk, dtype=np.int32)
    return x, (ctypes.c_int16 if narrow else ctypes.c_int32), narrow


def scan_upload(chunk: np.ndarray):
    """C++ single-pass (order, width) choice of the fixed-width wire:
    the narrowest format that fits the batch's d1/d2 ranges, None when
    none fits (the caller uploads raw), NotImplemented without the
    library (`ops.upack.scan` is its numpy twin)."""
    lib = _load()
    if lib is None:
        return NotImplemented
    fn = lib.flacenc_scan_upload
    if getattr(fn, "argtypes", None) is None:
        fn.restype = ctypes.c_int32
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
    x = np.ascontiguousarray(chunk, dtype=np.int32)
    T = x.shape[-1]
    rows = x.size // T if T else 0
    meta = np.zeros(2, np.int32)
    ok = fn(_ptr(x, ctypes.c_int32), rows, T, _ptr(meta, ctypes.c_int32))
    return (int(meta[0]), int(meta[1])) if ok else None


def pack_upload(chunk: np.ndarray, order: int, width: int):
    """C++ single-pass delta pack at a fixed (order, width): (..., T) int,
    T % 16 == 0 -> ((..., T*width/32) uint32 words, (..., 2) int32
    firsts). Raises without the library."""
    lib = _require()
    x, in_ctype, narrow = _chunk(chunk)
    fn = lib.flacenc_pack_upload16 if narrow else lib.flacenc_pack_upload
    if getattr(fn, "argtypes", None) is None:
        fn.restype = None
        fn.argtypes = [
            ctypes.POINTER(in_ctype), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
        ]
    T = x.shape[-1]
    if T % 16 or T * width % 32:
        raise ValueError(f"block size {T} does not hold whole {width}-bit field groups")
    rows = x.size // T if T else 0
    words = np.empty(x.shape[:-1] + (T * width // 32,), np.uint32)
    firsts = np.empty(x.shape[:-1] + (2,), np.int32)
    fn(_ptr(x, in_ctype), rows, T, order, width,
       _ptr(words, ctypes.c_uint32), _ptr(firsts, ctypes.c_int32))
    return words, firsts


def scan_rice(chunk: np.ndarray):
    """C++ single-pass rice-wire statistics: (..., 2, 26) int64 sums
    S[..., order-1, p] = sum_t(zigzag(delta_order)[t] >> p) for orders
    1-2, or NotImplemented without the library."""
    lib = _load()
    if lib is None:
        return NotImplemented
    fn = lib.flacenc_scan_rice
    if getattr(fn, "argtypes", None) is None:
        fn.restype = None
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
    x = np.ascontiguousarray(chunk, dtype=np.int32)
    T = x.shape[-1]
    rows = x.size // T if T else 0
    sums = np.zeros((rows, 2, 26), np.int64)
    fn(_ptr(x, ctypes.c_int32), rows, T, _ptr(sums, ctypes.c_int64))
    return sums.reshape(x.shape[:-1] + (2, 26))


def rice4_supported() -> bool:
    """True when the loaded library has the order-3/4 wire entry points
    (the port builds its library from its own source, so it always has)."""
    lib = _load()
    return lib is not None and hasattr(lib, "flacenc_scan_wire4")


def scan_wire(chunk: np.ndarray, stride: int = 1):
    """C++ fused wire scan, one pass for both upload-wire statistics:
    ((..., NORD, 26) int64 rice sums for delta orders 1..NORD (4 here),
    (4,) int32 [d1_min, d1_max, d2_min, d2_max]), or NotImplemented
    without the library. `stride` > 1 samples the rice sums (every
    stride-th sample, unscaled); the min/max stay exact."""
    lib = _load()
    if lib is None:
        return NotImplemented
    x, in_ctype, narrow = _chunk(chunk)
    four = hasattr(lib, "flacenc_scan_wire4")
    if four:
        fn = lib.flacenc_scan_wire16_4 if narrow else lib.flacenc_scan_wire4
    else:
        fn = lib.flacenc_scan_wire16 if narrow else lib.flacenc_scan_wire
    if getattr(fn, "argtypes", None) is None:
        fn.restype = None
        fn.argtypes = [
            ctypes.POINTER(in_ctype), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ]
    T = x.shape[-1]
    rows = x.size // T if T else 0
    nord = 4 if four else 2
    sums = np.zeros((rows, nord, 26), np.int64)
    mm = np.zeros(4, np.int32)
    fn(_ptr(x, in_ctype), rows, T, stride, _ptr(sums, ctypes.c_int64), _ptr(mm, ctypes.c_int32))
    return sums.reshape(x.shape[:-1] + (nord, 26)), mm


def pack_rice(chunk: np.ndarray, order: int, p: int, wu: int):
    """C++ single-pass rice-wire pack at a fixed (order, p) with a static
    per-row unary budget of `wu` words: (..., T) int -> (lo (..., T*p/32)
    u32, unary (..., wu) u32, firsts (..., 2 or 4) i32: [x0, x1] for orders
    1-2, the four difference warm-ups for orders 3-4), or None when a row
    overflows the budget. Raises without the library."""
    lib = _require()
    if order > 2 and not rice4_supported():
        raise RuntimeError("the native library has no order-3/4 wire entry points")
    x, in_ctype, narrow = _chunk(chunk)
    fn = lib.flacenc_pack_rice16 if narrow else lib.flacenc_pack_rice
    if getattr(fn, "argtypes", None) is None:
        fn.restype = ctypes.c_int32
        fn.argtypes = [
            ctypes.POINTER(in_ctype), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int32),
        ]
    T = x.shape[-1]
    if T * p % 32:
        raise ValueError(f"block size {T} does not hold whole {p}-bit low-plane groups")
    rows = x.size // T if T else 0
    lo = np.empty(x.shape[:-1] + (T * p // 32,), np.uint32)
    unary = np.empty(x.shape[:-1] + (wu,), np.uint32)
    firsts = np.empty(x.shape[:-1] + (2 if order <= 2 else 4,), np.int32)
    ok = fn(_ptr(x, in_ctype), rows, T, order, p, wu,
            _ptr(lo, ctypes.c_uint32), _ptr(unary, ctypes.c_uint32),
            _ptr(firsts, ctypes.c_int32))
    return (lo, unary, firsts) if ok else None
