"""Port parity for the residual-shipping outputs and the packers: the port's
`BatchEncoder(decisions_only=False)` and its `wire_encoded` pair against the
JAX program's, field by field; streams from every packer ("python",
"native", "native2", "auto") against each other and against the JAX
package's same packer, byte for byte; the native `pack_frames` and
`compute_errors` bindings against the JAX package's. All comparisons are
exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu import config, sigen  # noqa: E402
from flacenc_tpu import native as jnative  # noqa: E402
from flacenc_tpu.component import decode_stream, parse_stream  # noqa: E402
from flacenc_tpu.models import batch_encoder as jbe  # noqa: E402
from flacenc_tpu.parallel import encode_corpus as jencode_corpus  # noqa: E402
from flacenc_tpu.source import MemSource  # noqa: E402

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch import native as tnative  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402

pytestmark = pytest.mark.skipif(
    not (jnative.available() and tnative.available()), reason="native library unavailable"
)

PACKERS = ("python", "native", "native2", "auto")


def _port(cfg):
    return tconfig.Encoder.from_dict(cfg.to_dict())


def _signal(nch, n, bps, noise=0.02, f0=128, step=2):
    x = np.zeros(nch * n, np.int32)
    for ch in range(nch):
        x[ch::nch] = sigen.Sine(f0 + step * ch, 0.4 if noise < 0.1 else 0.6) \
            .noise_with_seed(ch + 1, noise).to_vec_quantized(bps, n)
    return x


def _blocks(x, nch, T):
    n = len(x) // nch // T
    return x[: n * T * nch].reshape(n, T, nch).transpose(0, 2, 1).copy().astype(np.int32)


# ---------------------------------------------------------------------------
# DeviceEncoded and the wire pair
# ---------------------------------------------------------------------------

def _cfg_with(**sub):
    cfg = config.Encoder()
    for k, v in sub.items():
        setattr(cfg.subframe_coding, k, v)
    return cfg


_ENCODED_CASES = {
    "mono_8": (_cfg_with(), 1, 8, 0.02),
    "mono_16": (_cfg_with(), 1, 16, 0.02),
    "mono_24": (_cfg_with(), 1, 24, 0.02),
    "stereo_8": (_cfg_with(), 2, 8, 0.02),
    "stereo_16": (_cfg_with(), 2, 16, 0.02),
    "stereo_24": (_cfg_with(), 2, 24, 0.02),
    "stereo_24_beyond_int16": (_cfg_with(), 2, 24, 0.2),
    "no_fixed": (_cfg_with(use_fixed=False), 2, 16, 0.02),
    "no_lpc": (_cfg_with(use_lpc=False), 2, 16, 0.02),
}


def _encoded_both(name):
    cfg, C, bps, noise = _ENCODED_CASES[name]
    T = 1024
    blocks = _blocks(_signal(C, 4 * T, bps, noise, f0=97, step=1), C, T)
    blocks[0, 0] = 321  # a constant channel
    jfn = jbe._cached_encoder_fn(cfg.to_toml(), C, bps, T, False, False)
    exp = jfn(blocks)
    got = tbe.BatchEncoder(_port(cfg), C, bps, T, decisions_only=False)(torch.from_numpy(blocks))
    return cfg, C, bps, T, blocks, got, exp


@pytest.mark.parametrize("name", list(_ENCODED_CASES))
def test_device_encoded_fields_match_jax(name):
    _, C, bps, T, _, got, exp = _encoded_both(name)
    assert isinstance(got, tbe.DeviceEncoded)
    assert got._fields == exp._fields
    for field in got._fields:
        g, e = getattr(got, field).numpy(), np.asarray(getattr(exp, field))
        assert g.shape == e.shape, field
        assert g.dtype.kind == e.dtype.kind, field
        assert np.array_equal(g, e), field
    assert got.errors.dtype == torch.int16 and got.fits16.dtype == torch.bool
    fits = got.fits16.numpy()
    if name == "stereo_24_beyond_int16":
        # some predicted channel overflowed int16: the host recomputes it
        assert (~fits & (got.sf_type.numpy() >= tbe.T_FIXED)).any()
    elif bps <= 16:
        assert fits.all()


@pytest.mark.parametrize("name", ["stereo_16", "stereo_24_beyond_int16", "mono_24"])
def test_wire_encoded_pair_matches_jax(name):
    cfg, C, bps, T, blocks, got, _ = _encoded_both(name)
    jfn = jbe._cached_encoder_fn(cfg.to_toml(), C, bps, T, False, False, wire_encoded=True)
    jwire, jerr = jfn(blocks)
    wire, err = tbe.BatchEncoder(_port(cfg), C, bps, T, wire_encoded=True)(torch.from_numpy(blocks))
    assert wire.dtype == torch.int32 and err.dtype == torch.int16
    assert np.array_equal(wire.numpy(), np.asarray(jwire))
    assert np.array_equal(err.numpy(), np.asarray(jerr))
    # the host split gives back every field, as the JAX split does
    split = tbe.split_encoded(wire.numpy(), err.numpy(), C)
    jsplit = jbe.split_encoded(np.asarray(jwire), np.asarray(jerr), C)
    for field in split._fields:
        assert np.array_equal(getattr(split, field), getattr(jsplit, field)), field
        assert np.array_equal(getattr(split, field), getattr(got, field).numpy()), field
    assert np.array_equal(tbe.coalesce_encoded_small(got).numpy(), wire.numpy())


def test_wire_encoded_implies_residuals():
    """`wire_encoded` returns the residual pair whatever `decisions_only`
    says, as the JAX program does."""
    enc = tbe.BatchEncoder(tconfig.Encoder(), 1, 16, 256, decisions_only=True, wire_encoded=True)
    out = enc(torch.zeros((2, 1, 256), dtype=torch.int32))
    assert isinstance(out, tuple) and len(out) == 2 and out[1].shape == (2, 1, 256)


# ---------------------------------------------------------------------------
# Host packers: stream bytes on the matrix of tests/test_packers.py
# ---------------------------------------------------------------------------

def _toml_cfg(toml):
    return config.Encoder.from_toml(toml)


_STREAM_CASES = {
    # name: (cfg, nch, bps, n, block, batch, rate, strict)
    "stereo_16": (config.Encoder(), 2, 16, 1024 * 5 + 321, 1024, 4, 44100, False),
    "stereo_16_strict": (config.Encoder(), 2, 16, 1024 * 5 + 321, 1024, 4, 44100, True),
    "mono_16": (config.Encoder(), 1, 16, 1024 * 3, 1024, 2, 48000, False),
    "3ch_8": (config.Encoder(), 3, 8, 1024 * 3, 1024, 2, 48000, False),
    "stereo_24": (config.Encoder(), 2, 24, 1024 * 3, 1024, 2, 48000, False),
    "beyond_int16": (config.Encoder(), 2, 24, 2048 * 2, 2048, 2, 96000, False),
    "bitcount": (_toml_cfg('[subframe_coding.fixed.order_sel]\ntype = "BitCount"\n'),
                 2, 16, 1024 * 3, 1024, 4, 44100, False),
    "direct_mse": (_toml_cfg("[subframe_coding.qlpc]\nuse_direct_mse = true\n"),
                   2, 16, 1024 * 3, 1024, 4, 44100, False),
    "no_midside": (_toml_cfg("[stereo_coding]\nuse_midside = false\n"),
                   2, 16, 1024 * 3, 1024, 4, 44100, False),
}

_STREAMS = {}


def _stream_input(name):
    cfg, nch, bps, n, block, batch, rate, strict = _STREAM_CASES[name]
    if name == "beyond_int16":
        return _signal(nch, n, bps, noise=0.2, f0=97, step=1)
    if name in ("mono_16", "3ch_8"):
        return _signal(nch, n, bps, noise=0.05, f0=97, step=5)
    return _signal(nch, n, bps, noise=0.05 if name in ("bitcount", "direct_mse", "no_midside")
                   else 0.02)


def _stream(name, impl, packer):
    key = (name, impl, packer)
    if key not in _STREAMS:
        cfg, nch, bps, n, block, batch, rate, strict = _STREAM_CASES[name]
        x = _stream_input(name)
        if impl == "port":
            s = flacenc_tpu_torch.encode_with_fixed_block_size(
                _port(cfg).into_verified(), TMemSource(x, nch, bps, rate), block,
                batch_size=batch, device="cpu", packer=packer, strict_lpc=strict,
            )
        else:
            s = jbe.encode_with_fixed_block_size(
                cfg.into_verified(), MemSource(x, nch, bps, rate), block,
                batch_size=batch, packer=packer, strict_lpc=strict,
            )
        _STREAMS[key] = (x, s.to_bytes())
    return _STREAMS[key]


@pytest.mark.parametrize("packer", PACKERS)
@pytest.mark.parametrize("name", list(_STREAM_CASES))
def test_packer_bytes_match_jax_and_each_other(name, packer):
    x, got = _stream(name, "port", packer)
    _, exp = _stream(name, "jax", packer)
    assert got == exp
    _, native2 = _stream(name, "port", "native2")
    assert got == native2
    assert np.array_equal(decode_stream(parse_stream(got)), x)


def test_resolve_packer(monkeypatch):
    assert tbe.resolve_packer("auto") == "native2"
    for p in ("native2", "native", "python"):
        assert tbe.resolve_packer(p) == p
    with pytest.raises(ValueError, match="packer"):
        tbe.resolve_packer("fast")
    monkeypatch.setattr(tnative, "available", lambda: False)
    assert tbe.resolve_packer("auto") == "python"


def test_python_packer_without_native_library(monkeypatch):
    """Without the native library "auto" is the python packer and the
    overflow channels are recomputed by the numpy oracle's kernels; the
    bytes stay those of the C++ packers."""
    _, exp = _stream("beyond_int16", "port", "native2")
    cfg, nch, bps, n, block, batch, rate, _ = _STREAM_CASES["beyond_int16"]
    x = _stream_input("beyond_int16")
    calls = []
    real = tbe._host_errors

    def spy(enc, signal):
        calls.append(int(((~enc.fits16) & (enc.sf_type >= tbe.T_FIXED)).sum()))
        return real(enc, signal)

    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tbe, "_host_errors", spy)
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        _port(cfg), TMemSource(x, nch, bps, rate), block, batch_size=batch, device="cpu",
    ).to_bytes()
    assert got == exp
    assert sum(calls) > 0


def test_host_errors_scalar_path_equals_native(monkeypatch):
    cfg, C, bps, T, blocks, got, _ = _encoded_both("stereo_24_beyond_int16")
    enc = tbe.DeviceEncoded(*(f.numpy() for f in got))
    signal = tbe._slot_signals(blocks, enc.assign, C)
    fast = tbe._host_errors(enc, signal)
    monkeypatch.setattr(tnative, "available", lambda: False)
    slow = tbe._host_errors(enc, signal)
    assert np.array_equal(fast, slow)
    # and both equal the JAX package's recompute
    assert np.array_equal(fast, jbe._host_errors(enc, signal, cfg))


def test_quotients_remainders_and_slot_signals_match_jax():
    cfg, C, bps, T, blocks, got, _ = _encoded_both("stereo_16")
    enc = tbe.DeviceEncoded(*(f.numpy() for f in got))
    assert np.array_equal(tbe._slot_signals(blocks, enc.assign, C),
                          jbe._slot_signals(blocks, enc.assign, C))
    errors = enc.errors.astype(np.int32)
    warmup = np.where(enc.sf_type >= tbe.T_FIXED, enc.order, 0)
    q, r = tbe._quotients_remainders_batch(errors, enc.rice_params, enc.rice_order, warmup)
    jq, jr = jbe._quotients_remainders_batch(errors, enc.rice_params, enc.rice_order, warmup)
    assert q.dtype == np.uint32 and np.array_equal(q, jq) and np.array_equal(r, jr)


@pytest.mark.parametrize("packer", ["native", "python"])
def test_packer_stats_and_frames(packer):
    x = _signal(2, 1024 * 9 + 7, 16)
    stats = {}
    s = flacenc_tpu_torch.encode_with_fixed_block_size(
        tconfig.Encoder(), TMemSource(x, 2, 16, 44100), 1024, batch_size=4, device="cpu",
        packer=packer, stats=stats,
    )
    assert stats["batches"] == 3 and stats["frames"] == 10
    assert set(stats) == {"read_s", "submit_s", "device_wait_s", "pack_s",
                          "batches", "frames", "wall_s", "wire_batches", "grouped_batches",
                          "captures", "capture_s", "captures_background",
                          "capture_background_s", "link_mbps", "max_inflight",
                          "staging_reused", "staging_allocated", "staging_waited",
                          "upload_bytes", "upload_samples", "upload_raw_batches",
                          "link_bytes", "link_s"}
    assert stats["wire_batches"] == {"None": 3} and stats["captures"] == 0
    assert np.array_equal(decode_stream(parse_stream(s.to_bytes())), x)


def test_encode_corpus_native_packer_matches_jax():
    srcs = []
    for i, (n, rate) in enumerate([(1024 * 5 + 17, 44100), (1024 * 2, 48000), (700, 44100)]):
        srcs.append((f"f{i}", _signal(2, n, 16, f0=90 + 3 * i), rate))
    cfg = config.Encoder()
    got, stats = flacenc_tpu_torch.encode_corpus(
        [(name, TMemSource(x, 2, 16, rate)) for name, x, rate in srcs], _port(cfg), 1024,
        batch_size=4, device="cpu", packer="native",
    )
    exp, _ = jencode_corpus(
        [(name, MemSource(x, 2, 16, rate)) for name, x, rate in srcs], cfg.into_verified(), 1024,
        batch_size=4, packer="native",
    )
    default, _ = flacenc_tpu_torch.encode_corpus(
        [(name, TMemSource(x, 2, 16, rate)) for name, x, rate in srcs], _port(cfg), 1024,
        batch_size=4, device="cpu",
    )
    for name, x, _ in srcs:
        assert got[name].to_bytes() == exp[name].to_bytes() == default[name].to_bytes()
    assert stats.batches >= 2


# ---------------------------------------------------------------------------
# Native bindings
# ---------------------------------------------------------------------------

def _pack_args(name):
    cfg, C, bps, T, blocks, got, _ = _encoded_both(name)
    enc = tbe.DeviceEncoded(*(f.numpy() for f in got))
    signal = tbe._slot_signals(blocks, enc.assign, C)
    errors = tbe._host_errors(enc, signal)
    ch_tag, bs, sr, ss = tbe._header_specs(enc.assign, C, bps, 44100, T)
    return (signal, errors, enc.sf_type, enc.order, enc.qcoefs, enc.shift, enc.rice_order,
            enc.rice_params, ch_tag, np.arange(len(blocks), dtype=np.int64) + 3,
            bps, cfg.subframe_coding.qlpc.quant_precision, bs, sr, ss)


@pytest.mark.parametrize("name", ["stereo_16", "mono_24", "stereo_24_beyond_int16", "no_lpc"])
def test_native_pack_frames_matches_jax_binding(name):
    args = _pack_args(name)
    data, sizes = tnative.pack_frames(*args)
    jdata, jsizes = jnative.pack_frames(*args)
    assert data == jdata and np.array_equal(sizes, jsizes)
    assert sizes.sum() == len(data) and len(sizes) == args[0].shape[0]


def test_native_compute_errors_matches_jax_binding():
    rng = np.random.default_rng(5)
    N, T = 12, 777
    signals = rng.integers(-(1 << 23), 1 << 23, (N, T)).astype(np.int32)
    is_lpc = (np.arange(N) % 2).astype(np.int32)
    order = np.where(is_lpc == 1, rng.integers(1, 25, N), rng.integers(0, 5, N)).astype(np.int32)
    qcoefs = rng.integers(-(1 << 14), 1 << 14, (N, 24)).astype(np.int32)
    qcoefs[np.arange(24)[None, :] >= order[:, None]] = 0
    shift = rng.integers(0, 16, N).astype(np.int32)
    got = tnative.compute_errors(signals, is_lpc, order, qcoefs, shift)
    exp = jnative.compute_errors(signals, is_lpc, order, qcoefs, shift)
    assert got.dtype == np.int32 and np.array_equal(got, exp)
    with pytest.raises(ValueError, match="qcoefs"):
        tnative.compute_errors(signals, is_lpc, order, qcoefs[:, :10], shift)


def test_native_bindings_raise_without_library(monkeypatch):
    monkeypatch.setattr(tnative, "_load", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.compute_errors(np.zeros((1, 8), np.int32), np.zeros(1, np.int32),
                               np.zeros(1, np.int32), np.zeros((1, 24), np.int32),
                               np.zeros(1, np.int32))
    with pytest.raises(RuntimeError, match="unavailable"):
        tnative.pack_frames(*_pack_args("mono_16"))
