"""Scalar-faithful numpy implementations of the reference DSP semantics.

These functions reproduce the integer/float behavior of the reference's
``src/lpc.rs`` and ``src/rice.rs`` and serve three roles:

1. the parity oracle for the JAX device kernels (device<->numpy tests replace
   the reference's SIMD<->scalar parity tests, SURVEY.md §4),
2. the spec each device kernel is written against,
3. the actual encode path for tail blocks (avoids per-length jit
   re-specialization).

Documented deviation: f64 sums use numpy's pairwise order and plain
multiply-add instead of the reference's sequential FMA; see DESIGN.md
"Exactness contract".
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from .. import constants
from ..config import Window
from .windows import get_window

MAX_LPC_ORDER = constants.qlpc.MAX_ORDER  # 24
MAX_P_TO_BITS = (1 << 27) - 1  # rice.rs:51
_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Fixed LPC (coding.rs:178-197)
# ---------------------------------------------------------------------------


def fixed_lpc_errors(signal: np.ndarray, max_order: int = 4) -> List[np.ndarray]:
    """Difference cascades e_0..e_max_order with e_k[-1]=0 carry semantics.

    e_{k+1}[t] = e_k[t] - e_k[t-1] (e_k[-1] = 0), i32 wrapping arithmetic.
    The first `k` entries of e_k are partial diffs, matching the reference.
    """
    errors = [np.asarray(signal, dtype=np.int32)]
    for _ in range(max_order):
        prev = errors[-1]
        shifted = np.zeros_like(prev)
        shifted[1:] = prev[:-1]
        errors.append((prev - shifted).astype(np.int32))
    return errors


# ---------------------------------------------------------------------------
# Windowed autocorrelation + Levinson (lpc.rs:392-705)
# ---------------------------------------------------------------------------


def windowed_signal(signal: np.ndarray, window: Window) -> np.ndarray:
    """i32 -> f32 cast times f32 window (lpc.rs:739-756)."""
    w = get_window(window, len(signal))
    return (signal.astype(np.float32) * w).astype(np.float32)


def auto_correlation(order: int, sig_f32: np.ndarray) -> np.ndarray:
    """corr[tau] = sum_{t=order-1}^{T-1} x[t] * x[t-tau], f64 accumulation.

    `order` here is the number of lags (reference passes lpc_order + 1);
    the first `order - 1` products are excluded (lpc.rs:542-548).
    """
    T = len(sig_f32)
    x = sig_f32.astype(np.float64)
    warm = order - 1
    dest = np.zeros(order, dtype=np.float64)
    y = x[warm:T]
    for tau in range(order):
        dest[tau] = np.dot(y, x[warm - tau : T - tau])
    return dest


def symmetric_levinson_recursion(coefs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Solve the symmetric-Toeplitz system T x = y (lpc.rs:633-705).

    T[i][j] = coefs[|i-j|]; an order whose reflection denominator is
    exactly zero is skipped (see the semantics note below).
    """
    order = len(ys)
    dest = np.zeros(order, dtype=np.float64)
    assert coefs[0] >= 0.0, "signal energy must be non-negative"
    if coefs[0] == 0.0:
        assert not (np.any(coefs != 0.0) or np.any(ys != 0.0)), (
            "If signal is digital silence, all coefficients must be zero."
        )
        return dest

    # Degenerate-denominator semantics (lpc.rs:664-683): the reference's
    # `continue` binds to the inner `for n` loop — NOT the outer `loop`,
    # which its own `#[allow(clippy::never_loop)]` confirms never repeats —
    # so an order whose reflection denominator is exactly zero is simply
    # SKIPPED (forward/dest untouched) and the diagonal-loading update is
    # dead code. We reproduce the compiled behavior, not the go-to the
    # comment wished for.
    forward = np.zeros(order, dtype=np.float64)
    forward[0] = 1.0 / coefs[0]
    dest[0] = ys[0] / coefs[0]
    for n in range(1, order):
        error = 0.0
        for d in range(n):
            error += coefs[n - d] * forward[d]
        denom = 1.0 - error * error
        if denom == 0.0:
            continue  # skip this order, like the reference
        alpha = 1.0 / denom
        beta = -alpha * error
        forward_next = np.zeros(order, dtype=np.float64)
        for d in range(n + 1):
            forward_next[d] = alpha * forward[d] + beta * forward[n - d]
        forward[: n + 1] = forward_next[: n + 1]
        delta = 0.0
        for d in range(n):
            delta += coefs[n - d] * dest[d]
        for d in range(n + 1):
            dest[d] = dest[d] + (ys[n] - delta) * forward[n - d]
    return dest


def lpc_from_autocorr(signal: np.ndarray, window: Window, lpc_order: int) -> np.ndarray:
    """Unquantized f64 LPC coefficients (lpc.rs:760-810, 916-930)."""
    if lpc_order == 0:
        return np.zeros(0, dtype=np.float64)
    sig = windowed_signal(signal, window)
    corr = auto_correlation(lpc_order + 1, sig)
    assert np.all(np.isfinite(corr)), "corr_coefs must be normal or zero."
    coefs = symmetric_levinson_recursion(corr[0:lpc_order], corr[1 : lpc_order + 1])
    assert np.all(np.isfinite(coefs))
    return coefs


# ---------------------------------------------------------------------------
# Quantization (lpc.rs:234-302)
# ---------------------------------------------------------------------------


def find_shift(coefs: np.ndarray, precision: int) -> int:
    assert precision <= 15 and len(coefs) > 0
    max_abs = float(np.max(np.abs(coefs)))
    if max_abs == 0.0:
        abs_log2 = -32752  # ceil(log2(0)) = -inf, clamped to i16::MIN + 16
    else:
        abs_log2 = max(int(math.ceil(math.log2(max_abs))), -32752)
    shift = (precision - 1) - abs_log2
    return int(np.clip(shift, constants.qlpc.MIN_SHIFT, constants.qlpc.MAX_SHIFT))


def _round_half_away(x: float) -> float:
    """Rust f64::round: nearest, half away from zero, with NO double
    rounding — floor(x + 0.5) would round 0.49999999999999994 (the largest
    double below 0.5, where x + 0.5 rounds up to exactly 1.0) to 1."""
    f = math.floor(abs(x))
    mag = f + (abs(x) - f >= 0.5)
    return -mag if x < 0.0 else float(mag)


def quantize_parameters(coefs: np.ndarray, precision: int) -> Tuple[np.ndarray, int, int]:
    """Returns (qcoefs[order], order, shift); mirrors lpc.rs:273-302.

    Tail zeros of the MAX_LPC_ORDER-sized buffer are truncated; order >= 1.
    """
    if len(coefs) == 0:
        return np.zeros(0, dtype=np.int16), 0, 0
    shift = find_shift(coefs, precision)
    q = np.zeros(MAX_LPC_ORDER, dtype=np.int64)
    lim_lo, lim_hi = -(1 << (precision - 1)), (1 << (precision - 1)) - 1
    scale = float(2.0 ** shift)
    for n, c in enumerate(coefs):
        scaled = _round_half_away(float(c) * scale)
        scaled = min(max(scaled, -32768.0), 32767.0)  # i16 clamp (lpc.rs:263-269)
        q[n] = min(max(int(scaled), lim_lo), lim_hi)
    nz = np.nonzero(q)[0]
    order = max(1, int(nz[-1]) + 1 if len(nz) else 0)
    return q[:order].astype(np.int16), order, shift


def compute_error(
    qcoefs: np.ndarray, shift: int, signal: np.ndarray
) -> np.ndarray:
    """QLPC residual: err[t] = x[t] - ((sum_k c[k] x[t-1-k]) >> shift).

    Always evaluated in i64 and wrapped to i32; provably equal to the
    reference's dual i32/i64 paths (lpc.rs:306-390). errors[0..order] = 0.
    """
    order = len(qcoefs)
    x = signal.astype(np.int64)
    acc = np.zeros(len(signal), dtype=np.int64)
    for k in range(order):
        acc[k + 1 :] += int(qcoefs[k]) * x[: len(signal) - k - 1]
    err = x - (acc >> shift)
    err[:order] = 0
    return wrap_i32(err)


def wrap_i32(v: np.ndarray) -> np.ndarray:
    """Two's-complement wrap of int64 values into int32 (Rust `as i32`)."""
    return (
        ((v.astype(np.int64) + (1 << 31)) & _U32) - (1 << 31)
    ).astype(np.int32)


# ---------------------------------------------------------------------------
# Rice coding (rice.rs)
# ---------------------------------------------------------------------------


def encode_signbit(v: np.ndarray) -> np.ndarray:
    """Zigzag: (|v| << 1) - (v < 0), as u32 (rice.rs:169-176)."""
    v64 = np.abs(v.astype(np.int64))
    z = (v64 << 1) - (v.astype(np.int64) < 0)
    return (z & _U32).astype(np.uint32)


def decode_signbit(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.uint64)
    mag = (z >> np.uint64(1)).astype(np.int64)
    return np.where(z & np.uint64(1), -(mag + 1), mag).astype(np.int32)


def finest_partition_order(size: int, min_part_size: int) -> int:
    """rice.rs:157-165."""
    assert min_part_size >= 1
    max_splits = size // min_part_size
    if max_splits == 0:
        return 0
    max_order_for_min_part = max_splits.bit_length() - 1
    trailing = (size & -size).bit_length() - 1 if size else 0
    return min(constants.rice.MAX_PARTITION_ORDER, max_order_for_min_part, trailing)


def prc_bit_table(errors_z: np.ndarray, offset: int) -> np.ndarray:
    """Bit cost per rice parameter p in 0..=31 for one partition.

    bits[p] = clamp(sum(z >> p)) + offset + len * (p + 1), clamped to
    MAX_P_TO_BITS (rice.rs:65-103; i64-sum deviation per DESIGN.md).
    """
    n = len(errors_z)
    ps = np.arange(32, dtype=np.uint64)
    sums = (errors_z.astype(np.uint64)[:, None] >> ps[None, :]).sum(
        axis=0, dtype=np.uint64
    )
    bits = np.minimum(sums, MAX_P_TO_BITS)
    bits = np.minimum(bits + offset + n * (ps + 1), MAX_P_TO_BITS)
    return bits.astype(np.uint32)


def table_minimizer(table: np.ndarray, max_p: int) -> Tuple[int, int]:
    """(argmin p, min bits) with reference tie-breaking (rice.rs:115-141)."""
    ps = np.arange(32, dtype=np.uint64)
    bits = np.where(ps <= max_p, table.astype(np.uint64), _U32)
    packed = ((bits << np.uint64(5)) & _U32) | ps
    m = int(packed.min())
    return m & 0x1F, m >> 5


def merge_tables(a: np.ndarray, b: np.ndarray, offset: int = 4) -> np.ndarray:
    return np.minimum(
        (a.astype(np.int64) + b.astype(np.int64) - offset), MAX_P_TO_BITS
    ).astype(np.uint32)


class PrcParameter:
    """Partitioned-Rice parameter set (rice.rs:220-234)."""

    __slots__ = ("order", "ps", "code_bits")

    def __init__(self, order: int, ps: np.ndarray, code_bits: int) -> None:
        self.order = order
        self.ps = ps
        self.code_bits = code_bits


def find_partitioned_rice_parameter(
    signal: np.ndarray, warmup_length: int, max_p: int
) -> PrcParameter:
    """Bottom-up partition-order search (rice.rs:246-299)."""
    size = len(signal)
    partition_order = finest_partition_order(
        size, max(constants.rice.MIN_PARTITION_SIZE, warmup_length)
    )
    nparts = 1 << partition_order
    z = encode_signbit(np.asarray(signal, dtype=np.int32))
    part_size = size // nparts
    tables = []
    for p in range(nparts):
        start = max(p * part_size, warmup_length)
        end = (p + 1) * part_size
        tables.append(prc_bit_table(z[start:end], 4))

    def eval_partitions(tbls):
        ps, total = [], 0
        for t in tbls:
            p, bits = table_minimizer(t, max_p)
            ps.append(p)
            total += bits
        return np.asarray(ps, dtype=np.uint8), total

    min_ps, min_bits = eval_partitions(tables)
    min_order = partition_order
    while nparts > 1:
        tables = [
            merge_tables(tables[2 * i], tables[2 * i + 1]) for i in range(nparts // 2)
        ]
        nparts //= 2
        partition_order -= 1
        ps, bits = eval_partitions(tables)
        if bits < min_bits:
            min_bits, min_ps, min_order = bits, ps, partition_order
    return PrcParameter(min_order, min_ps[: 1 << min_order], min_bits)


def quotients_and_remainders(
    errors: np.ndarray, prc: PrcParameter, warmup_length: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample Rice split for the chosen partition params
    (coding.rs:92-170)."""
    block_size = len(errors)
    nparts = 1 << prc.order
    part_size = block_size >> prc.order
    z = encode_signbit(np.asarray(errors, dtype=np.int32))
    ps = np.repeat(prc.ps.astype(np.uint32), part_size)
    quotients = (z >> ps).astype(np.uint32)
    remainders = (z & ((np.uint32(1) << ps) - np.uint32(1))).astype(np.uint32)
    quotients[:warmup_length] = 0
    remainders[:warmup_length] = 0
    return quotients, remainders


# ---------------------------------------------------------------------------
# Entropy-based order estimate (coding.rs:200-227)
# ---------------------------------------------------------------------------


def estimate_entropy(errors: np.ndarray, warmup_len: int, partitions: int) -> int:
    block_size = len(errors)
    partition_size = -(-block_size // partitions)
    offset = 0
    acc = 0
    abs_f32 = np.abs(errors.astype(np.int64)).astype(np.float32)
    for _p in range(partitions):
        end = min(block_size, offset + partition_size)
        partition_len = end - offset
        if end >= warmup_len:
            sample_count = min(end - warmup_len, partition_len)
            sum_errors = np.float32(abs_f32[offset:end].sum(dtype=np.float32))
            avg_errors = sum_errors * np.float32(2.0) / (
                np.float32(sample_count) + np.float32(0.00001)
            )
            with np.errstate(divide="ignore", invalid="ignore"):
                geom_p = np.float32(1.0) / (avg_errors + np.float32(1.0))
                xent = avg_errors * (
                    -np.log2(np.float32(1.0) - geom_p, dtype=np.float32)
                ) + (-np.log2(geom_p, dtype=np.float32))
            contrib = xent * np.float32(sample_count)
            if not np.isnan(contrib) and contrib > 0:
                acc += int(contrib)
        offset = end
    return acc


# ---------------------------------------------------------------------------
# Experimental LPC estimation (lpc.rs:813-913, feature "experimental")
# ---------------------------------------------------------------------------


def weighted_auto_correlation(
    order: int, sig_f32: np.ndarray, weights: Optional[np.ndarray] = None
) -> np.ndarray:
    """corr[tau] = sum_{t=order-1}^{T-1} x[t-tau] * f64(f32(w[t] * x[t])).

    Weight application happens in f32 like the reference's `VecWeight`
    (lpc.rs:194-203) before the f64 accumulation.
    """
    x = sig_f32.astype(np.float64)
    T = len(x)
    warm = order - 1
    if weights is not None:
        wy = (
            np.asarray(weights[warm:T], np.float32) * sig_f32[warm:T]
        ).astype(np.float32).astype(np.float64)
    else:
        wy = x[warm:T]
    dest = np.zeros(order, dtype=np.float64)
    for tau in range(order):
        dest[tau] = np.dot(x[warm - tau : T - tau], wy)
    return dest


def weighted_lagged_outer_prod_sum(
    order: int, sig_f32: np.ndarray, weights: Optional[np.ndarray], t_shift: int
) -> np.ndarray:
    """M[i, j] = sum_{t=order-1}^{len-1} s[t-i] * f64(f32(w[t+shift] s[t-j]))
    (lpc.rs:571-600 with ShiftedWeight; the weight multiply is f32)."""
    T = len(sig_f32)
    M = np.zeros((order, order), dtype=np.float64)
    s = sig_f32.astype(np.float64)
    if weights is not None:
        w_t = np.asarray(
            weights[order - 1 + t_shift : T + t_shift], np.float32
        )
    else:
        w_t = None
    for i in range(order):
        si = s[order - 1 - i : T - i]
        for j in range(i, order):
            sj32 = sig_f32[order - 1 - j : T - j]
            wx = (w_t * sj32).astype(np.float32) if w_t is not None else sj32
            acc = float(np.dot(si, wx.astype(np.float64)))
            M[i, j] = acc
            M[j, i] = acc
    return M


def _solve_spd(M: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Cholesky solve with the reference's doubling regularization retry
    (lpc.rs:885-894). Solves THROUGH the Cholesky factor (forward + back
    substitution), like the reference's nalgebra cholesky().solve_mut and
    the device kernel (ops/lpc.py cholesky_solve_spd) — an LU solve of the
    same system differs by ~1e-13 relative and would add an undocumented
    deviation class."""
    regularizer = 0.0
    order = M.shape[0]
    Mr = M.copy()
    while True:
        try:
            L = np.linalg.cholesky(Mr)
        except np.linalg.LinAlgError:
            old = regularizer
            regularizer = max(1.0, regularizer + regularizer)
            Mr[np.arange(order), np.arange(order)] += regularizer - old
            continue
        z = np.zeros(order, dtype=np.float64)
        for i in range(order):
            z[i] = (y[i] - float(L[i, :i] @ z[:i])) / L[i, i]
        x = np.zeros(order, dtype=np.float64)
        for i in range(order - 1, -1, -1):
            x[i] = (z[i] - float(L[i + 1 :, i] @ x[i + 1 :])) / L[i, i]
        return x


def lpc_with_direct_mse(
    signal: np.ndarray, window: Window, lpc_order: int,
    weights: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Direct-MSE (covariance-method) LPC (lpc.rs:853-913)."""
    w = windowed_signal(signal, window)
    corr = weighted_auto_correlation(lpc_order + 1, w, weights)
    M = weighted_lagged_outer_prod_sum(lpc_order, w[: len(w) - 1], weights, 1)
    return _solve_spd(M, corr[1:].copy())


def compute_raw_errors(signal: np.ndarray, coefs: np.ndarray) -> np.ndarray:
    """Float prediction errors (lpc.rs:606-618): err[t] = pred - signal.

    The reference accumulates with f32 mul_add (FMA). CPython 3.12 has no
    math.fma, so each step computes the product+sum exactly in f64 and
    rounds once to f32 — equal to FMA except on double-rounding ties
    (the f64 intermediate is itself rounded; measure-zero corner).
    Vectorized over t (independent samples); the j-loop stays sequential
    like the reference's tap order."""
    order = len(coefs)
    T = len(signal)
    errors = np.zeros(T, dtype=np.float32)
    if T <= order:
        return errors
    sig32 = signal.astype(np.float32)
    sig64 = sig32.astype(np.float64)
    e = (-sig64[order:]).astype(np.float32)
    for j in range(order):
        cj = np.float64(np.float32(coefs[j]))
        e = (cj * sig64[order - 1 - j : T - 1 - j] + e.astype(np.float64)).astype(
            np.float32
        )
    errors[order:] = e
    return errors


def lpc_with_irls_mae(
    signal: np.ndarray, window: Window, lpc_order: int, steps: int
) -> np.ndarray:
    """IRLS mean-absolute-error optimization (lpc.rs:814-850)."""
    weights = np.ones(len(signal), dtype=np.float32)
    best_coefs = None
    best_error = np.inf
    normalizer = np.float32(np.max(np.abs(signal)))
    for _ in range(steps + 1):
        coefs = lpc_with_direct_mse(signal, window, lpc_order, weights)
        raw = compute_raw_errors(signal, coefs)
        # sequential f32 fold like the reference's iter().sum::<f32>()
        # (numpy's pairwise sum is a different f32 rounding order)
        sum_abs = 0.0
        for v in np.abs(raw):
            sum_abs = float(np.float32(sum_abs + v))
        if sum_abs < best_error:
            best_error = sum_abs
            best_coefs = coefs
        err = np.abs(raw[lpc_order:])
        w = np.maximum(np.maximum(err, 1.0) / normalizer, 0.01) ** np.float32(-1.2)
        weights[lpc_order:] = w
    return best_coefs
