"""Plain NumPy analysis of one block: the fixed predictors, the windowed
autocorrelation and Levinson recursion, quantization, the QLPC residual,
the ApproxEnt order estimate and the partitioned-Rice parameter search.

Frozen copy of ``flacenc_tpu_torch/ops/ref_np.py`` and the Tukey window of
``flacenc_tpu_torch/ops/windows.py`` at commit 4f28b57, cut to what the
autocorrelation path of the default configuration reaches (no direct MSE,
no IRLS). Those files follow flacenc-rs ``src/lpc.rs`` and ``src/rice.rs``.
The one addition is `qlpc_dtype`: the float type the autocorrelation and
the Levinson recursion run in. The configuration states float64; float32
is the lower-precision control that ``benchmark.control`` runs.

Imports nothing but NumPy and the C library's ``cosf``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
from typing import List, Tuple

import numpy as np

MAX_LPC_ORDER = 24
MIN_SHIFT, MAX_SHIFT = 0, 15
MAX_PARTITION_ORDER = 15
MIN_PARTITION_SIZE = 64
MAX_P_TO_BITS = (1 << 27) - 1
_U32 = 0xFFFFFFFF
_F32_2PI = np.float32(2.0) * np.float32(math.pi)


@functools.cache
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = libm.cosf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float]
    return fn


@functools.cache
def tukey(alpha: float, length: int) -> np.ndarray:
    """f32 Tukey window (lpc.rs:96-120), with libm's cosf as Rust's f32::cos."""
    if alpha == 0.0:
        return np.ones(length, dtype=np.float32)
    cosf = _cosf()
    a = np.float32(alpha)
    max_t = np.float32(length) - np.float32(1.0)
    alpha_len = a * max_t
    t = np.arange(length, dtype=np.float32)
    half = alpha_len / np.float32(2.0)

    def lobe(arg):
        c = np.array([cosf(ctypes.c_float(float(v))) for v in arg], dtype=np.float32)
        return np.float32(0.5) * (np.float32(1.0) - c)

    rise = lobe((_F32_2PI * t) / alpha_len)
    fall = lobe((_F32_2PI * (max_t - t)) / alpha_len)
    w = np.where(t < half, rise, np.where(t < max_t - half, np.float32(1.0), fall))
    w = w.astype(np.float32)
    w.setflags(write=False)
    return w


def wrap_i32(v: np.ndarray) -> np.ndarray:
    """Two's-complement wrap of int64 values into int32 (Rust `as i32`)."""
    return (((v.astype(np.int64) + (1 << 31)) & _U32) - (1 << 31)).astype(np.int32)


def fixed_errors(signal: np.ndarray, max_order: int = 4) -> List[np.ndarray]:
    """e_0..e_max_order, e_{k+1}[t] = e_k[t] - e_k[t-1] with e_k[-1] = 0,
    i32 wrapping (coding.rs:178-197)."""
    errors = [np.asarray(signal, dtype=np.int32)]
    for _ in range(max_order):
        prev = errors[-1]
        shifted = np.zeros_like(prev)
        shifted[1:] = prev[:-1]
        errors.append((prev - shifted).astype(np.int32))
    return errors


def estimate_entropy(errors: np.ndarray, warmup_len: int, partitions: int) -> int:
    """ApproxEnt bit estimate of a residual (coding.rs:200-227), in f32."""
    block_size = len(errors)
    partition_size = -(-block_size // partitions)
    offset = 0
    acc = 0
    abs_f32 = np.abs(errors.astype(np.int64)).astype(np.float32)
    for _ in range(partitions):
        end = min(block_size, offset + partition_size)
        partition_len = end - offset
        if end >= warmup_len:
            sample_count = min(end - warmup_len, partition_len)
            sum_errors = np.float32(abs_f32[offset:end].sum(dtype=np.float32))
            avg = sum_errors * np.float32(2.0) / (np.float32(sample_count) + np.float32(0.00001))
            with np.errstate(divide="ignore", invalid="ignore"):
                geom_p = np.float32(1.0) / (avg + np.float32(1.0))
                xent = avg * (-np.log2(np.float32(1.0) - geom_p, dtype=np.float32)) + (
                    -np.log2(geom_p, dtype=np.float32))
            contrib = xent * np.float32(sample_count)
            if not np.isnan(contrib) and contrib > 0:
                acc += int(contrib)
        offset = end
    return acc


def auto_correlation(lags: int, sig_f32: np.ndarray, dtype=np.float64) -> np.ndarray:
    """corr[tau] = sum_{t=lags-1}^{T-1} x[t] x[t-tau], accumulated in `dtype`
    (lpc.rs:542-548: the first lags - 1 products are left out)."""
    x = sig_f32.astype(dtype)
    T = len(x)
    warm = lags - 1
    y = x[warm:T]
    return np.array([np.dot(y, x[warm - tau:T - tau]) for tau in range(lags)], dtype=dtype)


def levinson(coefs: np.ndarray, ys: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Solve the symmetric Toeplitz system T x = y (lpc.rs:633-705) in
    `dtype`; an order whose reflection denominator is exactly zero is
    skipped, as the compiled reference does."""
    f = dtype
    order = len(ys)
    coefs = np.asarray(coefs, dtype=f)
    ys = np.asarray(ys, dtype=f)
    dest = np.zeros(order, dtype=f)
    if coefs[0] == 0.0:
        return dest
    forward = np.zeros(order, dtype=f)
    forward[0] = f(1.0) / coefs[0]
    dest[0] = ys[0] / coefs[0]
    for n in range(1, order):
        error = f(0.0)
        for d in range(n):
            error = f(error + coefs[n - d] * forward[d])
        denom = f(1.0) - error * error
        if denom == 0.0:
            continue
        alpha = f(1.0) / denom
        beta = -alpha * error
        nxt = np.array([alpha * forward[d] + beta * forward[n - d] for d in range(n + 1)],
                       dtype=f)
        forward[: n + 1] = nxt
        delta = f(0.0)
        for d in range(n):
            delta = f(delta + coefs[n - d] * dest[d])
        for d in range(n + 1):
            dest[d] = f(dest[d] + (ys[n] - delta) * forward[n - d])
    return dest


def lpc_coefs(signal: np.ndarray, alpha: float, order: int, dtype=np.float64) -> np.ndarray:
    """Unquantized LPC coefficients by autocorrelation + Levinson
    (lpc.rs:760-810), the window applied in f32 (lpc.rs:739-756)."""
    w = (signal.astype(np.float32) * tukey(alpha, len(signal))).astype(np.float32)
    corr = auto_correlation(order + 1, w, dtype)
    return levinson(corr[0:order], corr[1:order + 1], dtype).astype(np.float64)


def _round_half_away(x: float) -> float:
    """Rust f64::round: nearest, half away from zero, no double rounding."""
    fl = math.floor(abs(x))
    mag = fl + (abs(x) - fl >= 0.5)
    return -mag if x < 0.0 else float(mag)


def quantize(coefs: np.ndarray, precision: int) -> Tuple[np.ndarray, int, int]:
    """(qcoefs[order], order, shift) (lpc.rs:234-302): trailing zero
    coefficients are cut, the order is at least 1."""
    max_abs = float(np.max(np.abs(coefs)))
    abs_log2 = -32752 if max_abs == 0.0 else max(int(math.ceil(math.log2(max_abs))), -32752)
    shift = int(np.clip((precision - 1) - abs_log2, MIN_SHIFT, MAX_SHIFT))
    lo, hi = -(1 << (precision - 1)), (1 << (precision - 1)) - 1
    scale = float(2.0 ** shift)
    q = np.zeros(len(coefs), dtype=np.int64)
    for n, c in enumerate(coefs):
        scaled = min(max(_round_half_away(float(c) * scale), -32768.0), 32767.0)
        q[n] = min(max(int(scaled), lo), hi)
    nz = np.nonzero(q)[0]
    order = max(1, int(nz[-1]) + 1 if len(nz) else 0)
    return q[:order].astype(np.int16), order, shift


def lpc_errors(qcoefs: np.ndarray, shift: int, signal: np.ndarray) -> np.ndarray:
    """err[t] = x[t] - ((sum_k c[k] x[t-1-k]) >> shift) in i64, wrapped to
    i32; err[:order] = 0 (lpc.rs:306-390)."""
    order = len(qcoefs)
    x = signal.astype(np.int64)
    acc = np.zeros(len(signal), dtype=np.int64)
    for k in range(order):
        acc[k + 1:] += int(qcoefs[k]) * x[: len(signal) - k - 1]
    err = x - (acc >> shift)
    err[:order] = 0
    return wrap_i32(err)


def zigzag(v: np.ndarray) -> np.ndarray:
    """(|v| << 1) - (v < 0) as u32 (rice.rs:169-176)."""
    v64 = v.astype(np.int64)
    return (((np.abs(v64) << 1) - (v64 < 0)) & _U32).astype(np.uint32)


def finest_partition_order(size: int, min_part_size: int) -> int:
    """rice.rs:157-165."""
    max_splits = size // min_part_size
    if max_splits == 0:
        return 0
    trailing = (size & -size).bit_length() - 1 if size else 0
    return min(MAX_PARTITION_ORDER, max_splits.bit_length() - 1, trailing)


def _bit_table(z: np.ndarray, offset: int) -> np.ndarray:
    """bits[p] for p in 0..=31 of one partition, clamped (rice.rs:65-103)."""
    ps = np.arange(32, dtype=np.uint64)
    sums = (z.astype(np.uint64)[:, None] >> ps[None, :]).sum(axis=0, dtype=np.uint64)
    bits = np.minimum(sums, MAX_P_TO_BITS)
    return np.minimum(bits + offset + len(z) * (ps + 1), MAX_P_TO_BITS).astype(np.uint32)


def _minimizer(table: np.ndarray, max_p: int) -> Tuple[int, int]:
    """(argmin p, min bits), ties to the smaller p (rice.rs:115-141)."""
    ps = np.arange(32, dtype=np.uint64)
    bits = np.where(ps <= max_p, table.astype(np.uint64), _U32)
    m = int((((bits << np.uint64(5)) & _U32) | ps).min())
    return m & 0x1F, m >> 5


def _merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.minimum(a.astype(np.int64) + b.astype(np.int64) - 4, MAX_P_TO_BITS).astype(np.uint32)


def rice_parameters(errors: np.ndarray, warmup: int, max_p: int) -> Tuple[int, np.ndarray]:
    """(partition order, parameters) of the bottom-up search (rice.rs:246-299)."""
    size = len(errors)
    order = finest_partition_order(size, max(MIN_PARTITION_SIZE, warmup))
    nparts = 1 << order
    z = zigzag(np.asarray(errors, dtype=np.int32))
    part = size // nparts
    tables = [_bit_table(z[max(p * part, warmup):(p + 1) * part], 4) for p in range(nparts)]

    def evaluate(tbls):
        found = [_minimizer(t, max_p) for t in tbls]
        return np.array([p for p, _ in found], dtype=np.uint8), sum(b for _, b in found)

    best_ps, best_bits = evaluate(tables)
    best_order = order
    while nparts > 1:
        tables = [_merge(tables[2 * i], tables[2 * i + 1]) for i in range(nparts // 2)]
        nparts //= 2
        order -= 1
        ps, bits = evaluate(tables)
        if bits < best_bits:
            best_bits, best_ps, best_order = bits, ps, order
    return best_order, best_ps[: 1 << best_order]
