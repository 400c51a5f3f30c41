"""Port parity for strict mode (``strict_lpc``): the strict host arrays, the
strict decisions against the JAX program given the same arrays, and strict
streams against the JAX package's and the numpy oracle's, byte for byte."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu import config, sigen  # noqa: E402
from flacenc_tpu.component import decode_stream, parse_stream  # noqa: E402
from flacenc_tpu.models import batch_encoder as jbe  # noqa: E402
from flacenc_tpu.models import reference_encoder  # noqa: E402
from flacenc_tpu.ops.windows import get_window  # noqa: E402
from flacenc_tpu.source import MemSource  # noqa: E402

import flacenc_tpu  # noqa: E402
import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch import native as tnative  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.ops.windows import get_window as tget_window  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402

T = 1024


def _port(cfg):
    """The port's copy of a JAX-package config."""
    return tconfig.Encoder.from_dict(cfg.to_dict())


def _interleaved(C, n, bps=16):
    x = np.zeros(C * n, np.int32)
    for c in range(C):
        x[c::C] = sigen.Sine(90 + 3 * c, 0.4).noise_with_seed(c + 1, 0.02).to_vec_quantized(bps, n)
    return x


def _blocks(C, n_blocks=4, bps=16):
    x = _interleaved(C, n_blocks * T, bps)
    return x.reshape(n_blocks, T, C).transpose(0, 2, 1).copy()


def _bitcount():
    cfg = config.Encoder()
    cfg.subframe_coding.fixed.order_sel = config.OrderSel(type="BitCount")
    return cfg


@pytest.mark.parametrize("C,make_cfg", [
    (1, config.Encoder), (2, config.Encoder), (2, _bitcount),
])
def test_strict_decisions_match_jax_given_the_same_host_arrays(C, make_cfg):
    cfg = make_cfg()
    tcfg = _port(cfg)
    blocks = _blocks(C)
    window = get_window(cfg.subframe_coding.qlpc.window, T)
    twindow = tget_window(tcfg.subframe_coding.qlpc.window, T)
    assert np.array_equal(twindow, window)
    ext = tbe._strict_ext_arrays(blocks, tcfg, C, 16, twindow)
    jext = jbe._strict_ext_arrays(blocks, cfg, C, 16, window)
    assert len(ext) == (5 if cfg.subframe_coding.fixed.order_sel.type == "ApproxEnt" else 3)
    for a, b in zip(ext, jext):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    exp = np.asarray(jbe._cached_encoder_fn(cfg.to_toml(), C, 16, T, True, True)(blocks, *jext))
    enc = tbe.BatchEncoder(tcfg, C, 16, T, strict_lpc=True)
    got = enc(torch.from_numpy(blocks), *map(torch.from_numpy, ext)).numpy()
    assert np.array_equal(got, exp)
    with pytest.raises(ValueError, match="host arrays"):
        enc(torch.from_numpy(blocks))


@pytest.mark.parametrize("C,n_samples,batch_size", [
    (1, T * 5 + 77, 2),  # two full batches, a padded one, a ragged tail
    (2, T * 3 + 500, 64),  # shorter than one batch
])
def test_strict_stream_bytes_match_jax_and_oracle(C, n_samples, batch_size):
    x = _interleaved(C, n_samples)
    cfg = config.Encoder().into_verified()
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        tconfig.Encoder().into_verified(), TMemSource(x, C, 16, 44100), T,
        batch_size=batch_size, device="cpu", strict_lpc=True,
    ).to_bytes()
    jax_bytes = flacenc_tpu.encode_with_fixed_block_size(
        cfg, MemSource(x, C, 16, 44100), T, batch_size=8, strict_lpc=True
    ).to_bytes()
    oracle = reference_encoder.encode_with_fixed_block_size(
        cfg, MemSource(x, C, 16, 44100), T, strict_lpc=True
    ).to_bytes()
    assert got == jax_bytes == oracle
    assert np.array_equal(decode_stream(parse_stream(got)), x)


def _direct_mse(config_mod=tconfig):
    cfg = config_mod.Encoder()
    cfg.subframe_coding.qlpc.use_direct_mse = True
    return cfg


def test_explicit_strict_with_direct_mse_raises():
    """The rule of tests/test_lpc.py::test_explicit_strict_with_experimental_config_raises."""
    x = np.zeros(2 * 256, np.int32)
    with pytest.raises(ValueError, match="strict_lpc"):
        flacenc_tpu_torch.encode_with_fixed_block_size(
            _direct_mse().into_verified(), TMemSource(x, 2, 16, 44100), 256,
            batch_size=2, device="cpu", strict_lpc=True,
        )


def test_strictness_from_the_environment(monkeypatch):
    """FLACENC_STRICT_LPC=1 turns strict mode on when `strict_lpc` is None,
    and falls back to the default mode with direct MSE; False overrides it."""
    monkeypatch.setenv("FLACENC_STRICT_LPC", "1")
    assert tbe.resolve_strict(None, tconfig.Encoder()) is True
    assert tbe.resolve_strict(False, tconfig.Encoder()) is False
    assert tbe.resolve_strict(None, _direct_mse()) is False
    x = _interleaved(2, T * 2 + 10)

    def encode(cfg, strict):
        return flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg.into_verified(), TMemSource(x, 2, 16, 44100), T, device="cpu",
            strict_lpc=strict,
        ).to_bytes()

    assert encode(tconfig.Encoder(), None) == encode(tconfig.Encoder(), True)
    assert encode(_direct_mse(), None) == reference_encoder.encode_with_fixed_block_size(
        _direct_mse(config).into_verified(), MemSource(x, 2, 16, 44100), T
    ).to_bytes()
    monkeypatch.delenv("FLACENC_STRICT_LPC")
    assert tbe.resolve_strict(None, tconfig.Encoder()) is False


def test_strict_without_native_library_raises(monkeypatch):
    monkeypatch.setattr(tnative, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native library"):
        flacenc_tpu_torch.encode_with_fixed_block_size(
            tconfig.Encoder(), TMemSource(_interleaved(2, T * 2), 2, 16, 44100), T,
            device="cpu", strict_lpc=True,
        )
