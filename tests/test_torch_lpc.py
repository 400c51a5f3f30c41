"""Port parity: QLPC ops (flacenc_tpu_torch.ops.lpc) against the JAX
package's ops/lpc.py, on the same numpy inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flacenc_tpu import config, sigen  # noqa: E402
from flacenc_tpu.ops import lpc as jlpc  # noqa: E402
from flacenc_tpu.ops import ref_np  # noqa: E402
from flacenc_tpu.ops.windows import get_window  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch.ops import lpc as tlpc  # noqa: E402
from flacenc_tpu_torch.ops.windows import get_window as tget_window  # noqa: E402

ORDER = 10
PRECISION = 15
T = 1024


def _signals(bps=16):
    """(2, 2, T) int32: sigen sines with noise, and seeded noise."""
    rows = [
        sigen.Sine(128, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(bps, T),
        sigen.Sine(440, 0.3).noise_with_seed(2, 0.1).to_vec_quantized(bps, T),
        sigen.Noise(0.5, seed0=3).to_vec_quantized(bps, T),
        np.random.default_rng(4).integers(-1000, 1000, T),
    ]
    return np.stack(rows).reshape(2, 2, T).astype(np.int32)


def _window():
    return get_window(config.Window(), T)


_jax_levinson = jax.jit(jlpc.levinson, static_argnums=1)
_jax_quantize = jax.jit(jlpc.quantize_parameters, static_argnums=1)
_jax_compute_error = jax.jit(jlpc.compute_error, static_argnames="max_taps")


@jax.jit
def _jax_coefs(sig, window):
    win = jlpc.apply_window(sig, window)
    corr = jlpc.auto_correlation(win, ORDER)
    return win, corr, jlpc.levinson(corr, ORDER)


def _port_coefs(sig):
    twindow = tget_window(tconfig.Window(), T)
    assert np.array_equal(twindow, _window())
    win = tlpc.apply_window(torch.from_numpy(sig), torch.from_numpy(twindow.copy()))
    corr = tlpc.auto_correlation(win, ORDER)
    return win, corr, tlpc.levinson(corr, ORDER)


def test_window_autocorrelation_levinson():
    sig = _signals()
    jwin, jcorr, jco = (np.array(a) for a in _jax_coefs(jnp.asarray(sig), _window()))
    win, corr, co = _port_coefs(sig)
    assert win.dtype == torch.float32 and np.array_equal(win.numpy(), jwin)
    assert corr.dtype == torch.float64
    # the f64 sums run in another order than XLA's
    np.testing.assert_allclose(corr.numpy(), jcorr, rtol=1e-12)
    # on the JAX corr itself Levinson is well conditioned for these signals
    co_same = tlpc.levinson(torch.from_numpy(jcorr), ORDER).numpy()
    np.testing.assert_allclose(co_same, jco, rtol=1e-9)
    np.testing.assert_allclose(co.numpy(), jco, rtol=1e-9)


def test_levinson_zero_denominator_skips_order():
    """A constant signal makes the reflection error exactly +-1: the order
    is skipped, as in tests/test_lpc.py, and the port agrees exactly."""
    sig = np.full(1024, 777.0)
    corr = np.asarray(
        [float(np.dot(sig[10:], sig[10 - t: 1024 - t])) for t in range(11)]
    )
    exp = ref_np.symmetric_levinson_recursion(corr[:10], corr[1:11])
    got = tlpc.levinson(torch.from_numpy(corr)[None, :], 10).numpy()[0]
    assert np.array_equal(got, exp)
    assert np.array_equal(got, np.asarray(_jax_levinson(jnp.asarray(corr)[None, :], 10))[0])


def test_levinson_silence_gives_zeros():
    got = tlpc.levinson(torch.zeros((3, ORDER + 1), dtype=torch.float64), ORDER)
    assert torch.equal(got, torch.zeros((3, ORDER), dtype=torch.float64))


def _coef_cases():
    """(N, ORDER) f64 coefficients: Levinson outputs of sigen signals plus
    seeded ones spanning the shift range, zero rows and exact halves."""
    _, _, co = _jax_coefs(jnp.asarray(_signals()), _window())
    rng = np.random.default_rng(5)
    seeded = rng.standard_normal((16, ORDER)) * np.exp2(rng.integers(-12, 6, (16, 1)))
    special = np.zeros((4, ORDER))
    special[1, 0] = 1.0        # exact power of two
    special[2, :3] = [0.5, -0.25, 1.5]
    special[3, 0] = 2.0 ** -20  # tiny: shift clamps to MAX_SHIFT
    return np.concatenate([np.asarray(co).reshape(-1, ORDER), seeded, special])


def test_find_shift_and_quantize_exact():
    co = _coef_cases()
    shift = tlpc.find_shift(torch.from_numpy(co), PRECISION).numpy()
    assert np.array_equal(shift, np.asarray(jlpc.find_shift(jnp.asarray(co), PRECISION)))
    q, order, qshift = (t.numpy() for t in tlpc.quantize_parameters(
        torch.from_numpy(co), PRECISION))
    jq, jorder, jshift = (np.asarray(a) for a in _jax_quantize(
        jnp.asarray(co), PRECISION))
    assert np.array_equal(q, jq) and np.array_equal(order, jorder)
    assert np.array_equal(qshift, jshift)
    assert q.dtype == np.int32 and q.shape == (len(co), jlpc.MAX_LPC_ORDER)
    # and the numpy oracle, row by row
    for i, c in enumerate(co):
        rq, rorder, rshift = ref_np.quantize_parameters(c, PRECISION)
        assert (rorder, rshift) == (order[i], qshift[i]), i
        assert np.array_equal(q[i, :rorder], rq), i


@pytest.mark.parametrize("bps", [16, 24])
def test_compute_error_exact(bps):
    sig = _signals(bps)
    _, _, co = _jax_coefs(jnp.asarray(sig), _window())
    jq, jorder, jshift = _jax_quantize(co, PRECISION)
    exp = np.asarray(_jax_compute_error(jq, jorder, jshift, jnp.asarray(sig), max_taps=ORDER))
    got = tlpc.compute_error(
        torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(jorder)),
        torch.from_numpy(np.array(jshift)), torch.from_numpy(sig), max_taps=ORDER,
    ).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, exp)


def test_compute_error_wraps_like_jax():
    # huge coefficients on full-range samples overflow int32: wrap exactly
    rng = np.random.default_rng(6)
    sig = rng.integers(-(1 << 23), 1 << 23, (2, T)).astype(np.int32)
    q = np.zeros((2, jlpc.MAX_LPC_ORDER), np.int32)
    q[:, :4] = [[16383, -16384, 16383, -16384], [9000, 1, -2, 3]]
    order = np.array([4, 4], np.int32)
    shift = np.array([0, 15], np.int32)
    exp = np.asarray(_jax_compute_error(*(jnp.asarray(a) for a in (q, order, shift, sig))))
    got = tlpc.compute_error(*(torch.from_numpy(a) for a in (q, order, shift, sig))).numpy()
    assert np.array_equal(got, exp)
