"""Batched quantized LPC (port of the main-path half of ``flacenc_tpu/ops/lpc.py``).

- windowing is a float32 product with the shared bit-exact window
  (lpc.rs:739-756);
- autocorrelation is a float64 lagged reduction with the reference's
  warm-up exclusion (lpc.rs:542-548);
- Levinson-Durbin runs in float64, batched, unrolled over the static order,
  with an order whose reflection denominator is exactly zero skipped
  (lpc.rs:633-705). Its short dot products accumulate left to right, the
  numpy oracle's order, so the CPU and CUDA results are the same;
- `find_shift` is ceil(log2()) corrected by exact powers of two
  (lpc.rs:234-254);
- the residual FIR runs in int64 and wraps to int32 (lpc.rs:306-390).

The experimental estimators (lpc.rs:813-913) follow at the end: the
direct-MSE covariance solve by an unrolled Cholesky with the reference's
doubling regularisation retry, and IRLS mean-absolute-error refinement.

The JAX package set float64 globally (x64); here every float step names its
dtype.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import torch

from .. import constants

from .fixed import wrap_i32

MAX_LPC_ORDER = constants.qlpc.MAX_ORDER  # 24

_F64 = torch.float64


def apply_window(signal: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """(..., T) int -> float32 windowed signal."""
    return signal.to(torch.float32) * window.to(torch.float32)


def auto_correlation(sig_f32: torch.Tensor, lpc_order: int) -> torch.Tensor:
    """(..., T) float32 -> (..., order+1) float64 lagged products:
    corr[tau] = sum_{t >= order} x[t] * x[t-tau]."""
    x = sig_f32.to(_F64)
    T = x.shape[-1]
    y = x[..., lpc_order:]
    lags = [
        (y * x[..., lpc_order - tau : T - tau]).sum(dim=-1)
        for tau in range(lpc_order + 1)
    ]
    return torch.stack(lags, dim=-1)


def _dot_in_order(a: torch.Tensor, b: torch.Tensor, n: int) -> torch.Tensor:
    """sum_{d<n} a[..., d] * b[..., d], accumulated left to right."""
    acc = torch.zeros(a.shape[:-1], dtype=_F64, device=a.device)
    for d in range(n):
        acc = acc + a[..., d] * b[..., d]
    return acc


def levinson(corr: torch.Tensor, lpc_order: int) -> torch.Tensor:
    """Batched symmetric-Toeplitz solve (lpc.rs:633-705).

    corr: (..., order+1) float64. Solves T x = y with T[i][j] = corr[|i-j|],
    y = corr[1:]. Returns (..., order) float64. Digital silence
    (corr[0] == 0) gives zeros; an order whose reflection denominator is
    exactly zero is skipped, like the compiled reference."""
    corr = corr.to(_F64)
    dev = corr.device
    batch_shape = corr.shape[:-1]
    coefs = corr[..., :lpc_order]
    ys = corr[..., 1 : lpc_order + 1]
    silent = corr[..., 0] == 0.0

    c0 = coefs[..., 0]
    safe_c0 = torch.where(c0 == 0.0, torch.ones_like(c0), c0)
    forward = torch.zeros(batch_shape + (lpc_order,), dtype=_F64, device=dev)
    dest = torch.zeros(batch_shape + (lpc_order,), dtype=_F64, device=dev)
    forward[..., 0] = 1.0 / safe_c0
    dest[..., 0] = ys[..., 0] / safe_c0
    for n in range(1, lpc_order):
        cn = torch.flip(coefs[..., 1 : n + 1], dims=(-1,))  # cn[d] = coefs[n-d]
        error = _dot_in_order(cn, forward, n)
        denom = 1.0 - error * error
        skip = denom == 0.0
        alpha = 1.0 / torch.where(skip, torch.ones_like(denom), denom)
        beta = -alpha * error
        fwd = forward[..., : n + 1]
        fwd_next = alpha[..., None] * fwd + beta[..., None] * torch.flip(fwd, dims=(-1,))
        forward[..., : n + 1] = torch.where(skip[..., None], fwd, fwd_next)
        delta = _dot_in_order(cn, dest, n)
        upd = (ys[..., n] - delta)[..., None] * torch.flip(forward[..., : n + 1], dims=(-1,))
        upd = torch.where(skip[..., None], torch.zeros_like(upd), upd)
        dest[..., : n + 1] = dest[..., : n + 1] + upd
    return torch.where(silent[..., None], torch.zeros_like(dest), dest)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """Exact 2.0**k in float64 for integer-valued k in [-1022, 1023]."""
    return ((k.to(torch.int64) + 1023) << 52).view(_F64)


def find_shift(coefs: torch.Tensor, precision: int) -> torch.Tensor:
    """Quantization shift per batch element (lpc.rs:234-254), exact.

    ceil(log2(x)) is the smallest integer k with 2^k >= x; log2 gives k
    within one ulp and one exact power-of-two comparison in each direction
    corrects it."""
    max_abs = coefs.abs().amax(dim=-1)
    zero = max_abs == 0.0
    safe = torch.where(zero, torch.ones_like(max_abs), max_abs)
    k0 = torch.clamp(torch.ceil(torch.log2(safe)), -1020.0, 1020.0)
    k = k0 + (_pow2(k0) < safe).to(_F64) - (_pow2(k0 - 1.0) >= safe).to(_F64)
    abs_log2 = torch.where(zero, -32752, k.to(torch.int32))  # log2(0) clamp
    abs_log2 = torch.clamp(abs_log2, min=-32752)
    shift = (precision - 1) - abs_log2
    return torch.clamp(
        shift, constants.qlpc.MIN_SHIFT, constants.qlpc.MAX_SHIFT
    ).to(torch.int32)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Rust f64::round: nearest, half away from zero, no double rounding."""
    f = torch.floor(x.abs())
    mag = f + ((x.abs() - f) >= 0.5).to(_F64)
    return torch.where(x < 0, -mag, mag)


def quantize_parameters(
    coefs: torch.Tensor, precision: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(..., order) float64 -> (qcoefs (..., MAX_LPC_ORDER) int32,
    order (...,) int32, shift (...,) int32); mirrors lpc.rs:273-302 with
    tail-zero truncation."""
    lpc_order = coefs.shape[-1]
    dev = coefs.device
    shift = find_shift(coefs, precision)
    scaled = _round_half_away(coefs.to(_F64) * _pow2(shift)[..., None])
    scaled = torch.clamp(scaled, -32768.0, 32767.0)  # i16 clamp
    lim_lo = -(1 << (precision - 1))
    lim_hi = (1 << (precision - 1)) - 1
    q = torch.clamp(scaled.to(torch.int32), lim_lo, lim_hi)
    q = torch.nn.functional.pad(q, (0, MAX_LPC_ORDER - lpc_order))
    idx = torch.arange(1, MAX_LPC_ORDER + 1, dtype=torch.int32, device=dev)
    order = torch.where(q != 0, idx, 0).amax(dim=-1)
    order = torch.clamp(order, min=1)
    mask = idx <= order[..., None]
    return torch.where(mask, q, 0), order, shift


def compute_error(
    qcoefs: torch.Tensor,
    order: torch.Tensor,
    shift: torch.Tensor,
    signal: torch.Tensor,
    max_taps: int = MAX_LPC_ORDER,
) -> torch.Tensor:
    """QLPC residual FIR (lpc.rs:306-390), int64-exact, wrapped to int32.

    qcoefs: (..., MAX_LPC_ORDER) int32 (zeros beyond order); signal (..., T).
    err[t] = x[t] - ((sum_k c[k] * x[t-1-k]) >> shift) for t >= order, else
    0. `max_taps` caps the FIR at the config's lpc_order (the coefficients
    beyond it are zero)."""
    x = signal.to(torch.int64)
    T = x.shape[-1]
    acc = torch.zeros_like(x)
    for k in range(min(max_taps, MAX_LPC_ORDER)):
        c = qcoefs[..., k].to(torch.int64)[..., None]
        acc = acc + c * torch.nn.functional.pad(x[..., : T - k - 1], (k + 1, 0))
    err = x - (acc >> shift.to(torch.int64)[..., None])  # arithmetic shift
    t_idx = torch.arange(T, dtype=torch.int64, device=x.device)
    err = torch.where(t_idx < order.to(torch.int64)[..., None], 0, err)
    return wrap_i32(err)


# ---------------------------------------------------------------------------
# Experimental LPC estimation (lpc.rs:813-913)
# ---------------------------------------------------------------------------

_F32 = torch.float32
_NEG_1_2 = float(np.float32(-1.2))  # the IRLS exponent, exact in float32
# the regularisation doubles from 1.0 and reaches float64 infinity after
# ~1025 rounds; a row that still fails then never will
_MAX_RETRY_ROUNDS = 1100


def lagged_outer_prod_sum(win: torch.Tensor, lpc_order: int, weights=None) -> torch.Tensor:
    """Batched covariance matrix M[i, j] = sum_t s[t-i] s[t-j] w(t+1).

    `win`: (..., T) float32 windowed signal; s = win[..., :-1] and t runs
    over [order-1, T-2], the reference's ShiftedWeight<1> call
    (lpc.rs:878-883). The weight multiply is float32; the contraction is a
    float64 batched matmul."""
    s32 = win[..., :-1]
    T1 = s32.shape[-1]
    lo = lpc_order - 1
    # S[..., i, t] = s[t + lo - i] for t in [0, T1 - lo)
    S32 = torch.stack([s32[..., lo - i : T1 - i] for i in range(lpc_order)], dim=-2)
    S = S32.to(_F64)
    if weights is not None:
        w_t = weights[..., None, lo + 1 : T1 + 1].to(_F32)
        Wside = (S32 * w_t).to(_F64)
    else:
        Wside = S
    return torch.matmul(S, Wside.transpose(-1, -2))


def _fold(products: torch.Tensor) -> torch.Tensor:
    """sum over the last (non-empty) axis, accumulated left to right:
    Python `sum`'s order in the JAX solver."""
    acc = products[..., 0]
    for k in range(1, products.shape[-1]):
        acc = acc + products[..., k]
    return acc


def cholesky_solve_spd(M: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched unrolled Cholesky solve; returns (x, failed).

    failed is True where M is not SPD (a non-positive or NaN pivot), the
    nalgebra failure that triggers the reference's regularisation retry
    (lpc.rs:885-894). Every entry is computed in the JAX solver's operation
    order (each inner sum left to right), vectorised over the batch and,
    within a column, over its rows, so the rounding is the same. An empty
    sum is skipped: x - 0.0 == x."""
    n = y.shape[-1]
    batch = y.shape[:-1]
    M = M.to(_F64)
    y = y.to(_F64)
    L = torch.zeros(batch + (n, n), dtype=_F64, device=y.device)
    failed = torch.zeros(batch, dtype=torch.bool, device=y.device)
    for j in range(n):
        lj = L[..., j, :j]
        d = M[..., j, j] - _fold(lj * lj) if j else M[..., j, j]
        failed = failed | (d <= 0.0) | torch.isnan(d)
        dj = torch.sqrt(torch.where(d <= 0.0, torch.ones_like(d), d))
        L[..., j, j] = dj
        if j + 1 < n:
            off = M[..., j + 1 :, j]
            if j:
                off = off - _fold(L[..., j + 1 :, :j] * lj[..., None, :])
            L[..., j + 1 :, j] = off / dj[..., None]
    # forward substitution L z = y
    z = []
    for i in range(n):
        acc = y[..., i]
        if i:
            acc = acc - _fold(L[..., i, :i] * torch.stack(z, dim=-1))
        z.append(acc / L[..., i, i])
    # backward substitution L^T x = z
    x = [None] * n
    for i in range(n - 1, -1, -1):
        acc = z[i]
        if i + 1 < n:
            acc = acc - _fold(L[..., i + 1 :, i] * torch.stack(x[i + 1 :], dim=-1))
        x[i] = acc / L[..., i, i]
    return torch.stack(x, dim=-1), failed


def solve_spd_with_retry(M: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """Cholesky solve with the reference's regularisation retry; returns
    (x, retry rounds).

    Rows that fail get M + reg * I with reg doubling from 1.0 (lpc.rs:
    885-894) until none fails; each round re-solves the whole batch, like
    the JAX `lax.while_loop`. The loop runs on the host: every round, the
    first attempt included, costs one device-to-host sync to read
    `failed.any()`, so a forward that reaches this solver cannot be
    captured in a CUDA graph."""
    n = y.shape[-1]
    M = M.to(_F64)
    eye = torch.eye(n, dtype=_F64, device=y.device)
    reg = torch.zeros(y.shape[:-1], dtype=_F64, device=y.device)
    x, failed = cholesky_solve_spd(M + reg[..., None, None] * eye, y)
    rounds = 0
    while bool(failed.any()):
        if rounds == _MAX_RETRY_ROUNDS:
            raise FloatingPointError(
                "Cholesky regularisation retry did not converge (non-finite "
                "covariance matrix)"
            )
        reg = torch.where(failed, torch.clamp(reg + reg, min=1.0), reg)
        x, still = cholesky_solve_spd(M + reg[..., None, None] * eye, y)
        failed = still & failed
        rounds += 1
    return x, rounds


def weighted_auto_correlation(win: torch.Tensor, lpc_order: int, weights=None) -> torch.Tensor:
    """corr[tau] = sum_{t >= order} x[t-tau] * f64(f32(w[t] x[t]))."""
    x = win.to(_F64)
    T = x.shape[-1]
    warm = lpc_order
    if weights is not None:
        wy = (win[..., warm:].to(_F32) * weights[..., warm:].to(_F32)).to(_F64)
    else:
        wy = x[..., warm:]
    lags = [(wy * x[..., warm - tau : T - tau]).sum(dim=-1) for tau in range(lpc_order + 1)]
    return torch.stack(lags, dim=-1)


def lpc_direct_mse(win: torch.Tensor, lpc_order: int, weights=None) -> torch.Tensor:
    """Direct-MSE (covariance) LPC (lpc.rs:853-913): (..., T) float32
    windowed signal -> (..., order) float64 coefficients."""
    corr = weighted_auto_correlation(win, lpc_order, weights)
    M = lagged_outer_prod_sum(win, lpc_order, weights)
    return solve_spd_with_retry(M, corr[..., 1:])[0]


def compute_raw_errors_f32(signal: torch.Tensor, coefs: torch.Tensor) -> torch.Tensor:
    """Float32 prediction errors err[t] = pred - signal (lpc.rs:606-618),
    zero for t < order. Each tap is a separate float32 multiply and add
    (no fused multiply-add), in tap order."""
    order = coefs.shape[-1]
    sig = signal.to(_F32)
    T = sig.shape[-1]
    err = -sig
    for j in range(order):
        c = coefs[..., j].to(_F32)[..., None]
        err = c * torch.nn.functional.pad(sig[..., : T - 1 - j], (j + 1, 0)) + err
    t_idx = torch.arange(T, device=sig.device)
    return torch.where(t_idx < order, torch.zeros_like(err), err)


def lpc_irls_mae(signal: torch.Tensor, win: torch.Tensor, lpc_order: int,
                 steps: int) -> torch.Tensor:
    """IRLS mean-absolute-error LPC (lpc.rs:814-850): `steps` + 1 weighted
    direct-MSE solves, keeping the coefficients with the smallest float32
    sum of |error| (a later solve replaces them only if strictly smaller).
    The weights are max(|e|, 1) / max|signal| clamped below at 0.01 and
    raised to float32(-1.2), all float32 values."""
    T = signal.shape[-1]
    batch = signal.shape[:-1]
    dev = signal.device
    weights = torch.ones(batch + (T,), dtype=_F32, device=dev)
    best = torch.zeros(batch + (lpc_order,), dtype=_F64, device=dev)
    best_err = torch.full(batch, float("inf"), dtype=_F32, device=dev)
    normalizer = signal.abs().amax(dim=-1).to(_F32)[..., None]
    warm = torch.arange(T, device=dev) < lpc_order
    for _ in range(steps + 1):
        coefs = lpc_direct_mse(win, lpc_order, weights)
        raw = compute_raw_errors_f32(signal, coefs)
        sum_abs = raw.abs().sum(dim=-1, dtype=_F32)
        better = sum_abs < best_err
        best = torch.where(better[..., None], coefs, best)
        best_err = torch.where(better, sum_abs, best_err)
        base = torch.clamp(torch.clamp(raw.abs(), min=1.0) / normalizer, min=0.01)
        # the power is taken in float64 and rounded once: the correctly
        # rounded float32 result, the same on CPU and CUDA (their float32
        # pow kernels differ from it in ~2 % of inputs)
        w = (base.to(_F64) ** _NEG_1_2).to(_F32)
        weights = torch.where(warm, weights, w)
    return best
