"""The port's own copies of the host modules against the JAX package's
originals, on the same seeded numpy inputs: signal generators, WAV files,
CRCs and UTF-8-like numbers, the parser and both decoders, config dict round
trips, the command line's parser and its `--oracle` encode, and the native
library's build."""

import ctypes
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu import cli as jcli  # noqa: E402
from flacenc_tpu import config as jconfig  # noqa: E402
from flacenc_tpu import sigen as jsigen  # noqa: E402
from flacenc_tpu import wav as jwav  # noqa: E402
from flacenc_tpu.component import decode_stream as jdecode_stream  # noqa: E402
from flacenc_tpu.component import parse_stream as jparse_stream  # noqa: E402
from flacenc_tpu.models import reference_encoder as jreference  # noqa: E402
from flacenc_tpu.native import independent as jindependent  # noqa: E402
from flacenc_tpu.source import MemSource as JMemSource  # noqa: E402
from flacenc_tpu.utils import crc as jcrc  # noqa: E402
from flacenc_tpu.utils import utf8like as jutf8  # noqa: E402

from flacenc_tpu_torch import cli as tcli  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch import sigen as tsigen  # noqa: E402
from flacenc_tpu_torch import wav as twav  # noqa: E402
from flacenc_tpu_torch.component import decode_stream as tdecode_stream  # noqa: E402
from flacenc_tpu_torch.component import parse_stream as tparse_stream  # noqa: E402
from flacenc_tpu_torch.native import build as tbuild  # noqa: E402
from flacenc_tpu_torch.native import independent as tindependent  # noqa: E402
from flacenc_tpu_torch.utils import crc as tcrc  # noqa: E402
from flacenc_tpu_torch.utils import utf8like as tutf8  # noqa: E402

_SIGNALS = {
    "sine": lambda sg: sg.Sine(100, 0.4),
    "sine_phase": lambda sg: sg.Sine.with_initial_phase(37, 0.9, 1.25),
    "square": lambda sg: sg.Square(50, 0.3),
    "dc": lambda sg: sg.Dc(-0.2),
    "noise": lambda sg: sg.Noise.with_seed(11, 0.5),
    "sine_noise": lambda sg: sg.Sine(128, 0.4).noise_with_seed(1, 0.01),
    "mix_clip": lambda sg: sg.Sine(90, 0.8).mix(sg.Square(7, 0.6)).clip(),
    "concat": lambda sg: sg.Sine(64, 0.5).concat(1000, sg.Noise.with_seed(3, 0.2)),
}


@pytest.mark.parametrize("bps", [8, 16, 24])
@pytest.mark.parametrize("name", list(_SIGNALS))
def test_sigen_signals_equal(name, bps):
    make = _SIGNALS[name]
    got = make(tsigen).to_vec_quantized(bps, 3000)
    exp = make(jsigen).to_vec_quantized(bps, 3000)
    assert got.dtype == exp.dtype and np.array_equal(got, exp)


def _interleaved(channels, bps, n, seed):
    rng = np.random.default_rng(seed)
    lo = -(1 << (bps - 1))
    return rng.integers(lo, -lo, channels * n).astype(np.int32)


@pytest.mark.parametrize("channels,bps,rate", [(1, 8, 8000), (2, 16, 44100),
                                               (2, 24, 96000), (6, 16, 48000)])
def test_wav_write_and_read_equal(tmp_path, channels, bps, rate):
    x = _interleaved(channels, bps, 1234, seed=bps)
    twav.write_wav(str(tmp_path / "t.wav"), x, channels, bps, rate)
    jwav.write_wav(str(tmp_path / "j.wav"), x, channels, bps, rate)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    t_read, j_read = twav.read_wav(str(tmp_path / "j.wav")), jwav.read_wav(str(tmp_path / "t.wav"))
    assert np.array_equal(t_read[0], x) and np.array_equal(j_read[0], x)
    assert t_read[1:] == j_read[1:] == (channels, bps, rate)
    src = twav.WavFileSource(str(tmp_path / "j.wav"))
    assert (src.channels(), src.bits_per_sample(), src.sample_rate(), src.len_hint()) == (
        channels, bps, rate, 1234)


@pytest.mark.parametrize("n", [0, 1, 7, 64, 1000, 4099])
def test_crcs_equal(n):
    data = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8).tobytes()
    assert tcrc.crc8(data) == jcrc.crc8(data)
    assert tcrc.crc16(data) == jcrc.crc16(data)
    # the pure-python tables (the paths taken with a nonzero init)
    assert tcrc.crc8(data, init=5) == jcrc.crc8(data, init=5)
    assert tcrc.crc16(data, init=0x1234) == jcrc.crc16(data, init=0x1234)


def test_utf8like_equal():
    values = [0, 1, 0x7F, 0x80, 0x7FF, 0x800, 0xFFFF, 0x10000, 0x1FFFFF, 0x200000,
              0x3FFFFFF, 0x4000000, 0x7FFFFFFF, 0x80000000, (1 << 36) - 1]
    values += np.random.default_rng(0).integers(0, 1 << 36, 200).tolist()
    for v in values:
        assert tutf8.encode_to_utf8like(v) == jutf8.encode_to_utf8like(v), v
        assert tutf8.utf8like_bytesize(v) == jutf8.utf8like_bytesize(v), v
    with pytest.raises(Exception) as t_err:
        tutf8.encode_to_utf8like(1 << 36)
    with pytest.raises(Exception) as j_err:
        jutf8.encode_to_utf8like(1 << 36)
    assert type(t_err.value).__name__ == type(j_err.value).__name__


def _stream_bytes(channels, bps, n, block_size, edit=None):
    cfg = jconfig.Encoder()
    if edit is not None:
        edit(cfg)
    x = np.zeros(channels * n, np.int32)
    for c in range(channels):
        x[c::channels] = jsigen.Sine(90 + 13 * c, 0.5).noise_with_seed(c + 4, 0.05) \
            .to_vec_quantized(bps, n)
    data = jreference.encode_with_fixed_block_size(
        cfg.into_verified(), JMemSource(x, channels, bps, 44100), block_size
    ).to_bytes()
    return x, data


def _fixed_only(cfg):
    cfg.subframe_coding.use_lpc = False


@pytest.mark.parametrize("channels,bps,n,block_size,edit", [
    (1, 16, 5000, 1024, None),
    (2, 16, 4500, 1024, None),
    (2, 24, 3000, 512, None),
    (2, 8, 2100, 256, _fixed_only),
    (3, 16, 2000, 4096, None),
], ids=["mono16", "stereo16", "stereo24", "stereo8_fixed", "three_ch_one_frame"])
def test_parse_and_decode_equal(channels, bps, n, block_size, edit):
    x, data = _stream_bytes(channels, bps, n, block_size, edit)
    t_stream, j_stream = tparse_stream(data), jparse_stream(data)
    assert t_stream.to_bytes() == j_stream.to_bytes() == data
    t_info, j_info = t_stream.stream_info(), j_stream.stream_info()
    assert (t_info.md5, t_info.total_samples, t_info.channels, t_info.bits_per_sample) == (
        j_info.md5, j_info.total_samples, j_info.channels, j_info.bits_per_sample)
    assert t_stream.frame_count() == j_stream.frame_count()
    t_dec, j_dec = tdecode_stream(t_stream), jdecode_stream(j_stream)
    assert np.array_equal(t_dec, j_dec) and np.array_equal(t_dec.reshape(-1), x)
    t_ind, j_ind = tindependent.decode_stream(data), jindependent.decode_stream(data)
    assert np.array_equal(t_ind.samples, j_ind.samples) and np.array_equal(t_ind.samples, x)
    assert t_ind._asdict().keys() == j_ind._asdict().keys()
    for key in t_ind._fields:
        if key != "samples":
            assert getattr(t_ind, key) == getattr(j_ind, key), key


def test_corrupt_stream_raises_alike():
    _, data = _stream_bytes(2, 16, 4500, 1024)
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 0xFF
    with pytest.raises(Exception) as t_err:
        tparse_stream(bytes(bad))
    with pytest.raises(Exception) as j_err:
        jparse_stream(bytes(bad))
    assert type(t_err.value).__name__ == type(j_err.value).__name__ == "ParseError"
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(tindependent.IndependentDecodeError):
        tindependent.decode_stream(bytes(bad))


def _cfg_edit(name, cfg_mod):
    """Each config the port's tests use, built with `cfg_mod`."""
    cfg = cfg_mod.Encoder()
    sub, st, qlpc = cfg.subframe_coding, cfg.stereo_coding, cfg.subframe_coding.qlpc
    if name == "bitcount":
        sub.fixed.order_sel = cfg_mod.OrderSel(type="BitCount")
    elif name == "bitcount_max_order_2":
        sub.fixed.order_sel = cfg_mod.OrderSel(type="BitCount")
        sub.fixed.max_order = 2
    elif name == "direct_mse":
        qlpc.use_direct_mse = True
        qlpc.window = cfg_mod.Window.rectangle()
        qlpc.lpc_order = 6
    elif name == "irls":
        qlpc.use_direct_mse = True
        qlpc.mae_optimization_steps = 2
    elif name == "subframe_switches":
        sub.use_constant, sub.use_fixed, sub.use_lpc = False, True, False
    elif name == "stereo_switches":
        st.use_leftside, st.use_rightside, st.use_midside = False, True, False
    elif name == "workers":
        cfg.workers = 3
        cfg.multithread = False
    elif name == "tuned":
        cfg.block_size = 1152
        qlpc.lpc_order, qlpc.quant_precision = 12, 13
        qlpc.window = cfg_mod.Window.tukey(0.25)
        sub.prc.max_parameter = 14
    return cfg


_CONFIGS = ["default", "bitcount", "bitcount_max_order_2", "direct_mse", "irls",
            "subframe_switches", "stereo_switches", "workers", "tuned"]


@pytest.mark.parametrize("name", _CONFIGS)
def test_encoder_dict_round_trip(name):
    jcfg = _cfg_edit(name, jconfig)
    tcfg = tconfig.Encoder.from_dict(jcfg.to_dict())
    assert tcfg == _cfg_edit(name, tconfig)
    assert tcfg.to_dict() == jcfg.to_dict()
    assert tcfg.to_toml() == jcfg.to_toml()
    assert jconfig.Encoder.from_dict(tcfg.to_dict()) == jcfg
    assert tconfig.Encoder.from_toml(jcfg.to_toml()) == tcfg
    assert tcfg.into_verified().inner is tcfg


def test_invalid_config_rejected_alike():
    for cfg_mod in (jconfig, tconfig):
        cfg = cfg_mod.Encoder()
        cfg.subframe_coding.qlpc.lpc_order = 40
        with pytest.raises(Exception) as err:
            cfg.into_verified()
        assert type(err.value).__name__ == "VerifyError"


_ARGVS = [
    ["encode", "in.wav", "-o", "out.flac"],
    ["encode", "in.wav", "-o", "out.flac", "-c", "cfg.toml", "--dump-config", "d.toml",
     "--block-size", "1152", "--batch-size", "16", "--cpu-only", "--strict-float"],
    ["encode", "in.wav", "--output", "o.flac", "--oracle", "--profile-trace", "tr"],
    ["encode-corpus", "a.wav", "b.wav", "-d", "out", "--batch-size", "8", "--cpu-only"],
    ["encode-corpus", "a.wav", "--output-dir", "out", "-c", "c.toml", "--strict-float",
     "--block-size", "4096"],
    ["decode", "in.flac", "-o", "out.wav"],
    ["decode", "in.flac", "-o", "out.wav", "--dump-struct", "s.json", "--no-verify"],
    [],
]


@pytest.mark.parametrize("argv", _ARGVS, ids=lambda a: " ".join(a[:1] + a[-1:]) or "empty")
def test_cli_parser_equal(argv):
    assert vars(tcli._build_parser().parse_args(argv)) == vars(jcli._build_parser().parse_args(argv))


@pytest.mark.parametrize("argv", [["encode", "in.wav"], ["encode", "a", "-o", "b", "--batch-size", "0"],
                                  ["decode", "x.flac"], ["bogus"]])
def test_cli_parser_rejects_alike(argv, capsys):
    for parser in (tcli._build_parser(), jcli._build_parser()):
        with pytest.raises(SystemExit) as err:
            parser.parse_args(argv)
        assert err.value.code == 2
    capsys.readouterr()


def test_cli_parser_options_equal():
    """Every subcommand has the same options, defaults and types."""
    def options(parser):
        subs = parser._subparsers._group_actions[0].choices
        return {name: sorted((a.dest, tuple(a.option_strings), repr(a.default), a.nargs,
                              getattr(a.type, "__name__", None), a.required)
                             for a in sub._actions)
                for name, sub in subs.items()}
    assert options(tcli._build_parser()) == options(jcli._build_parser())
    assert (tcli.EX_USAGE, tcli.EX_DATAERR, tcli.EX_NOINPUT, tcli.EX_SOFTWARE,
            tcli.EX_CANTCREAT, tcli.EX_IOERR) == (jcli.EX_USAGE, jcli.EX_DATAERR,
                                                  jcli.EX_NOINPUT, jcli.EX_SOFTWARE,
                                                  jcli.EX_CANTCREAT, jcli.EX_IOERR)


@pytest.mark.parametrize("channels,extra", [(2, []), (1, []), (2, ["--strict-float"]),
                                            (2, ["--block-size", "512"])],
                         ids=["stereo", "mono", "strict", "block_512"])
def test_oracle_bytes_equal_jax_cli(tmp_path, channels, extra):
    x = _interleaved(channels, 16, 3000, seed=channels)
    x = (np.cumsum(x.reshape(-1, channels), axis=0) // 64).astype(np.int32).reshape(-1)
    x = np.clip(x, -32768, 32767)
    wav = str(tmp_path / "in.wav")
    twav.write_wav(wav, x, channels, 16, 44100)
    out_t, out_j = str(tmp_path / "t.flac"), str(tmp_path / "j.flac")
    assert tcli.main(["encode", wav, "-o", out_t, "--oracle", *extra]) == 0
    assert jcli.main(["encode", wav, "-o", out_j, "--oracle", *extra]) == 0
    with open(out_t, "rb") as ft, open(out_j, "rb") as fj:
        data = ft.read()
        assert data == fj.read()
    back = str(tmp_path / "back.wav")
    assert tcli.main(["decode", out_t, "-o", back, "--dump-struct", str(tmp_path / "s.msgpack")]) == 0
    assert np.array_equal(twav.read_wav(back)[0], x)


def test_oracle_strict_with_direct_mse_fails_alike(tmp_path):
    wav = str(tmp_path / "in.wav")
    twav.write_wav(wav, _interleaved(2, 16, 2000, seed=5), 2, 16, 44100)
    toml = tmp_path / "c.toml"
    toml.write_text(_cfg_edit("direct_mse", tconfig).to_toml())
    argv = ["encode", wav, "-o", str(tmp_path / "x.flac"), "-c", str(toml), "--oracle",
            "--strict-float"]
    assert tcli.main(list(argv)) == jcli.main(list(argv)) == tcli.EX_SOFTWARE


def test_dump_struct_equal(tmp_path):
    _, data = _stream_bytes(2, 16, 4500, 1024)
    (tmp_path / "in.flac").write_bytes(data)
    for name, mod in (("t", tcli), ("j", jcli)):
        for ext in ("json", "msgpack"):
            rc = mod.main(["decode", str(tmp_path / "in.flac"), "-o", str(tmp_path / f"{name}.wav"),
                           "--dump-struct", str(tmp_path / f"{name}.{ext}")])
            assert rc == 0
    for ext in ("json", "msgpack", "wav"):
        assert (tmp_path / f"t.{ext}").read_bytes() == (tmp_path / f"j.{ext}").read_bytes()


def test_native_library_builds_once_under_concurrency(tmp_path, monkeypatch):
    """Concurrent first uses compile once, into a hashed name under the
    build directory, and every caller loads a whole library."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", str(tmp_path))
    paths, errors = [], []

    def use():
        try:
            path = tbuild.build_decoder()
            ctypes.CDLL(path).flacenc_decode_stream
            paths.append(path)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=use) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert len(set(paths)) == 1 and len(paths) == 4
    lib = os.path.basename(paths[0])
    assert lib.startswith("libflacenc_torch_decoder-") and lib.endswith(".so")
    assert sorted(n for n in os.listdir(tmp_path) if not n.startswith(".")) == [lib]
    assert tbuild.library_path(tbuild.DEC_SRC, "flacenc_torch_decoder") == paths[0]
    # the packer's library lives in the port's build directory, not beside its source
    assert os.path.dirname(tbuild.library_path(tbuild.SRC, "x")) == str(tmp_path)


# ---------------------------------------------------------------------------
# component.verify and component.serde: the cases of tests/test_verify.py and
# tests/test_serde.py on both packages, with the same outcomes and dumps
# ---------------------------------------------------------------------------

from flacenc_tpu import errors as jerrors  # noqa: E402
from flacenc_tpu.component import datatype as jdatatype  # noqa: E402
from flacenc_tpu.component import serde as jserde  # noqa: E402
from flacenc_tpu.component import verify as jverify  # noqa: E402
from flacenc_tpu_torch import errors as terrors  # noqa: E402
from flacenc_tpu_torch.component import datatype as tdatatype  # noqa: E402
from flacenc_tpu_torch.component import serde as tserde  # noqa: E402
from flacenc_tpu_torch.component import verify as tverify  # noqa: E402
from flacenc_tpu_torch.models import reference_encoder as treference  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402

_PKG = {
    "jax": (jconfig, jreference, JMemSource, jverify, jserde, jdatatype, jerrors.VerifyError),
    "port": (tconfig, treference, TMemSource, tverify, tserde, tdatatype, terrors.VerifyError),
}


def _component_stream(pkg, n=3000, square=False):
    cfg_mod, ref, mem, *_ = _PKG[pkg]
    x = np.zeros(2 * n, np.int32)
    x[0::2] = jsigen.Sine(90, 0.4).noise_with_seed(1, 0.02).to_vec_quantized(16, n)
    second = jsigen.Square(70, 0.3) if square else jsigen.Sine(91, 0.4)
    x[1::2] = second.noise_with_seed(2, 0.02).to_vec_quantized(16, n)
    return ref.encode_with_fixed_block_size(
        cfg_mod.Encoder().into_verified(), mem(x, 2, 16, 44100), 1024
    )


def _random_residual(pkg, seed, warmup):
    """tests/test_component.py's make_random_residual, in either package."""
    rng = np.random.default_rng(seed)
    block_size = 4096
    partition_order = int(rng.integers(0, 5))
    params = rng.integers(0, 15, 1 << partition_order).astype(np.uint8)
    ps = np.repeat(params.astype(np.uint32), block_size >> partition_order)
    quotients = rng.integers(0, 16, block_size).astype(np.uint32)
    remainders = (rng.integers(0, 1 << 20, block_size).astype(np.uint32)
                  & ((np.uint32(1) << ps) - 1)).astype(np.uint32)
    quotients[:warmup] = 0
    remainders[:warmup] = 0
    return _PKG[pkg][5].Residual(partition_order, block_size, warmup, params, quotients, remainders)


def _verify_outcome(pkg, case):
    """(raised, message) of one tests/test_verify.py case."""
    V, VerifyError = _PKG[pkg][3], _PKG[pkg][6]
    try:
        if case == "stream_verifies":
            V.verify_stream(_component_stream(pkg))
        elif case == "residual_ok":
            V.verify_residual(_random_residual(pkg, 0, 4))
        elif case == "residual_warmup_corrupt":
            res = _random_residual(pkg, 0, 4)
            res.quotients[0] = 5
            V.verify_residual(res)
        elif case == "residual_remainder_overflow":
            res = _random_residual(pkg, 1, 0)
            res.remainders[10] = 1 << int(res.rice_params[0])
            V.verify_residual(res)
        elif case == "frame_stale_bitstream":
            frame = _component_stream(pkg).frames()[0]
            frame.precompute_bitstream()
            V.verify_frame(frame)
            frame.precomputed_bitstream = frame.precomputed_bitstream[:-1] + b"\x00"
            V.verify_frame(frame)
        elif case == "stream_bad_frame_numbers":
            stream = _component_stream(pkg)
            stream.frames()[1].header_mut().set_frame_number(5)
            V.verify_stream(stream)
        elif case == "lpc_coef_precision":
            lpc = [s for f in _component_stream(pkg).frames() for s in f.subframes()
                   if isinstance(s, _PKG[pkg][5].Lpc)]
            assert lpc, "no LPC subframe"
            lpc[0].parameters.coefs[0] = 1 << 14  # >= 2^(precision-1)
            V.verify_subframe(lpc[0])
    except VerifyError as e:
        return True, str(e)
    return False, None


@pytest.mark.parametrize("case", [
    "stream_verifies", "residual_ok", "residual_warmup_corrupt",
    "residual_remainder_overflow", "frame_stale_bitstream", "stream_bad_frame_numbers",
    "lpc_coef_precision",
])
def test_verify_outcomes_equal(case):
    got, exp = _verify_outcome("port", case), _verify_outcome("jax", case)
    assert got == exp
    assert got[0] == (case not in ("stream_verifies", "residual_ok"))


def test_serde_dict_round_trip_equal():
    import json

    s_t, s_j = _component_stream("port", 2600, True), _component_stream("jax", 2600, True)
    d_t, d_j = tserde.stream_to_dict(s_t), jserde.stream_to_dict(s_j)
    assert json.dumps(d_t, sort_keys=True) == json.dumps(d_j, sort_keys=True)
    assert tserde.stream_from_dict(d_t).to_bytes() == s_t.to_bytes() == s_j.to_bytes()
    # each package loads the other's dump
    assert tserde.stream_from_dict(d_j).to_bytes() == jserde.stream_from_dict(d_t).to_bytes()


def test_serde_dump_with_metadata_and_cache_equal(tmp_path):
    paths = {}
    for pkg in ("port", "jax"):
        datatype, serde = _PKG[pkg][5], _PKG[pkg][4]
        s = _component_stream(pkg, 2600, True)
        s.add_metadata_block(datatype.MetadataBlock.new_unknown(4, b"\x01\x02\x03"))
        for f in s.frames():
            f.precompute_bitstream()
        paths[pkg] = tmp_path / f"{pkg}.json"
        serde.dump_stream(s, str(paths[pkg]), include_bitstream_cache=True)
        s2 = serde.load_stream(str(paths[pkg]))
        assert s2.to_bytes() == s.to_bytes()
        assert s2.frames()[0].precomputed_bitstream is not None
    assert paths["port"].read_text() == paths["jax"].read_text()
