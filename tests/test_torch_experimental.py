"""Port parity for the experimental LPC estimators (direct MSE and IRLS):
each function of ``flacenc_tpu_torch.ops.lpc`` against its JAX twin in
``flacenc_tpu.ops.lpc`` on the same seeded inputs, the `BatchEncoder`
decisions against the JAX program, and the stream against the numpy
oracle. Shapes stay small (B <= 4, T <= 1024) so that JAX's trace of the
unrolled solver stays cheap."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from flacenc_tpu import config, sigen  # noqa: E402
from flacenc_tpu.component import decode_stream, parse_stream  # noqa: E402
from flacenc_tpu.config import Window  # noqa: E402
from flacenc_tpu.models import batch_encoder as jbe  # noqa: E402
from flacenc_tpu.models import reference_encoder  # noqa: E402
from flacenc_tpu.ops import lpc as jlpc  # noqa: E402
from flacenc_tpu.ops.windows import get_window  # noqa: E402
from flacenc_tpu.source import MemSource  # noqa: E402

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.ops import lpc as tlpc  # noqa: E402

RTOL = 1e-9  # float64 results: XLA and torch sum in different orders
T = 1024


def _signals(B=4, T_=T, bps=16):
    return np.stack([
        sigen.Sine(90 + 7 * i, 0.4).noise_with_seed(i + 1, 0.02).to_vec_quantized(bps, T_)
        for i in range(B)
    ]).astype(np.int32)


def _windowed(sig, window=Window.rectangle()):
    w = get_window(window, sig.shape[-1])
    return (jlpc.apply_window(jnp.asarray(sig), w),
            tlpc.apply_window(torch.from_numpy(sig), torch.from_numpy(w.copy())))


def _weights(B, T_, seed=3):
    return np.random.default_rng(seed).uniform(0.05, 3.0, (B, T_)).astype(np.float32)


def _close(got, exp, rtol=RTOL):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape and got.dtype == exp.dtype
    scale = np.max(np.abs(exp))
    assert np.max(np.abs(got - exp)) <= rtol * scale, np.max(np.abs(got - exp)) / scale


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("order", [1, 8])
def test_covariance_and_weighted_autocorrelation_match_jax(order, weighted):
    sig = _signals()
    wj, wt = _windowed(sig, Window.tukey(0.3))
    w = _weights(*sig.shape) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    _close(tlpc.lagged_outer_prod_sum(wt, order, tw).numpy(),
           jlpc.lagged_outer_prod_sum(wj, order, jw), rtol=1e-12)
    _close(tlpc.weighted_auto_correlation(wt, order, tw).numpy(),
           jlpc.weighted_auto_correlation(wj, order, jw), rtol=1e-12)


def _spd_cases(n=6, seed=0):
    """SPD, singular, indefinite and NaN matrices: the solver's pass and
    fail paths side by side in one batch."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(4, n, n))
    M = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(n)  # SPD
    v = rng.normal(size=n)
    M[1] = np.outer(v, v)  # rank 1: a zero pivot
    M[2] = -5.0 * np.eye(n) + 0.01 * M[0]  # indefinite: needs reg > ~5
    M[3, 2, 2] = np.nan
    y = rng.normal(size=(4, n))
    return M, y


def test_cholesky_failed_mask_and_solution_match_jax():
    M, y = _spd_cases()
    xj, fj = jlpc.cholesky_solve_spd(jnp.asarray(M), jnp.asarray(y))
    xt, ft = tlpc.cholesky_solve_spd(torch.from_numpy(M), torch.from_numpy(y))
    assert np.array_equal(ft.numpy(), np.asarray(fj))
    assert ft.numpy().tolist() == [False, True, True, True]
    _close(xt.numpy()[0], np.asarray(xj)[0])


def _jax_retry_rounds(M, y):
    """The rounds of the JAX `lax.while_loop` in `_solve_spd_with_retry`,
    replayed step by step with the JAX solver."""
    n = y.shape[-1]
    reg = jnp.zeros(y.shape[:-1])
    _, failed = jlpc.cholesky_solve_spd(M, y)
    rounds = 0
    while bool(jnp.any(failed)):
        reg = jnp.where(failed, jnp.maximum(1.0, reg + reg), reg)
        _, f = jlpc.cholesky_solve_spd(M + reg[..., None, None] * jnp.eye(n), y)
        failed = f & failed
        rounds += 1
    return rounds


@pytest.mark.parametrize("rows", [[0], [0, 1], [0, 1, 2]])
def test_retry_rounds_and_solution_match_jax(rows):
    M, y = _spd_cases()
    M, y = jnp.asarray(M[rows]), jnp.asarray(y[rows])
    xt, rounds = tlpc.solve_spd_with_retry(torch.from_numpy(np.array(M)),
                                           torch.from_numpy(np.array(y)))
    assert rounds == _jax_retry_rounds(M, y) == {1: 0, 2: 1, 3: 4}[len(rows)]
    _close(xt.numpy(), jlpc._solve_spd_with_retry(M, y))


def test_retry_gives_up_on_a_nan_matrix():
    M, y = _spd_cases()
    with pytest.raises(FloatingPointError):
        tlpc.solve_spd_with_retry(torch.from_numpy(M[3:]), torch.from_numpy(y[3:]))


@pytest.mark.parametrize("order", [2, 8])
def test_direct_mse_matches_jax(order):
    sig = _signals()
    wj, wt = _windowed(sig)
    w = _weights(*sig.shape)
    _close(tlpc.lpc_direct_mse(wt, order).numpy(), jlpc.lpc_direct_mse(wj, order))
    _close(tlpc.lpc_direct_mse(wt, order, torch.from_numpy(w)).numpy(),
           jlpc.lpc_direct_mse(wj, order, jnp.asarray(w)))


def test_raw_errors_match_jax_exactly():
    sig = _signals()
    coefs = np.random.default_rng(1).normal(0, 0.5, (4, 8))
    got = tlpc.compute_raw_errors_f32(torch.from_numpy(sig), torch.from_numpy(coefs))
    exp = jlpc.compute_raw_errors_f32(jnp.asarray(sig), jnp.asarray(coefs))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(exp))


def _jax_irls_rounded_pow(signal, win, lpc_order, steps):
    """`flacenc_tpu.ops.lpc.lpc_irls_mae` line for line, built from its JAX
    parts, with the weight power rounded from float64 as in the port. XLA
    takes float32 pow from the C library, which differs from the correctly
    rounded value in ~0.06 % of inputs (by one ulp)."""
    T_ = signal.shape[-1]
    weights = jnp.ones(signal.shape, jnp.float32)
    best = jnp.zeros(signal.shape[:-1] + (lpc_order,))
    best_err = jnp.full(signal.shape[:-1], jnp.inf, jnp.float32)
    normalizer = jnp.max(jnp.abs(signal), axis=-1).astype(jnp.float32)[..., None]
    for _ in range(steps + 1):
        coefs = jlpc.lpc_direct_mse(win, lpc_order, weights)
        raw = jlpc.compute_raw_errors_f32(signal, coefs)
        sum_abs = jnp.abs(raw).sum(axis=-1, dtype=jnp.float32)
        better = sum_abs < best_err
        best = jnp.where(better[..., None], coefs, best)
        best_err = jnp.where(better, sum_abs, best_err)
        base = jnp.maximum(jnp.maximum(jnp.abs(raw), 1.0) / normalizer, 0.01)
        w = (base.astype(jnp.float64) ** float(np.float32(-1.2))).astype(jnp.float32)
        weights = jnp.where(jnp.arange(T_) < lpc_order, weights, w)
    return best


def test_irls_matches_jax():
    sig = _signals(B=2)
    wj, wt = _windowed(sig)
    got = tlpc.lpc_irls_mae(torch.from_numpy(sig), wt, 4, 2).numpy()
    _close(got, _jax_irls_rounded_pow(jnp.asarray(sig), wj, 4, 2))
    # against the JAX function itself, one-ulp pow differences included
    _close(got, jlpc.lpc_irls_mae(jnp.asarray(sig), wj, 4, 2), rtol=1e-4)


def _experimental_cfg(mae_steps=0, lpc_order=None):
    cfg = config.Encoder()
    cfg.subframe_coding.qlpc.use_direct_mse = True
    cfg.subframe_coding.qlpc.mae_optimization_steps = mae_steps
    cfg.subframe_coding.qlpc.window = Window.rectangle()
    if lpc_order is not None:
        cfg.subframe_coding.qlpc.lpc_order = lpc_order
    return cfg


def _stereo_blocks(n_blocks=4, block=512):
    n = n_blocks * block
    chans = [sigen.Sine(90 + c, 0.4).noise_with_seed(c + 1, 0.01).to_vec_quantized(16, n)
             for c in range(2)]
    return np.stack(chans).reshape(2, n_blocks, block).transpose(1, 0, 2).copy().astype(np.int32)


@pytest.mark.parametrize("mae_steps", [0, 2])
def test_decisions_match_jax(mae_steps):
    cfg = _experimental_cfg(mae_steps, lpc_order=6)
    blocks = _stereo_blocks()
    exp = np.asarray(jbe._cached_encoder_fn(cfg.to_toml(), 2, 16, 512, False, True)(blocks))
    got = tbe.BatchEncoder(cfg, 2, 16, 512)(torch.from_numpy(blocks)).numpy()
    assert np.array_equal(got, exp)
    assert tbe.T_LPC in tbe.split_decisions(got, 2).sf_type


def test_stream_bytes_match_oracle():
    """The signal of tests/test_experimental.py::test_experimental_device_matches_oracle."""
    n = 1024 * 2 + 100
    x = np.zeros(2 * n, np.int32)
    x[0::2] = sigen.Sine(90, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
    x[1::2] = sigen.Sine(91, 0.4).noise_with_seed(2, 0.01).to_vec_quantized(16, n)
    cfg = _experimental_cfg().into_verified()
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 1024, device="cpu"
    ).to_bytes()
    oracle = reference_encoder.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 1024
    ).to_bytes()
    assert got == oracle
    assert np.array_equal(decode_stream(parse_stream(got)), x)
