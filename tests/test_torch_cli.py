"""The port's command line (``python -m flacenc_tpu_torch.cli``) against the
JAX package's: the same bytes with `--cpu-only`, decode round trips,
`--strict-float`, the exit codes, and no CPU fallback without a card."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu import cli as jax_cli  # noqa: E402
from flacenc_tpu import config, sigen  # noqa: E402
from flacenc_tpu.models import reference_encoder  # noqa: E402
from flacenc_tpu.wav import WavFileSource, read_wav, write_wav  # noqa: E402

from flacenc_tpu_torch import cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _make_wav(path, channels=2, bps=16, rate=44100, n=5000, seed=0):
    x = np.zeros(channels * n, np.int32)
    for ch in range(channels):
        x[ch::channels] = (
            sigen.Sine(100 + 7 * ch + seed, 0.4)
            .noise_with_seed(seed * 10 + ch, 0.02)
            .to_vec_quantized(bps, n)
        )
    write_wav(str(path), x, channels, bps, rate)
    return x


def _encode_both(tmp_path, *extra, channels=2):
    wav = tmp_path / "in.wav"
    x = _make_wav(wav, channels=channels)
    args = ["--block-size", "1024", "--cpu-only", *extra]
    assert cli.main(["encode", str(wav), "-o", str(tmp_path / "port.flac"), *args]) == 0
    assert jax_cli.main(["encode", str(wav), "-o", str(tmp_path / "jax.flac"), *args]) == 0
    return x, (tmp_path / "port.flac").read_bytes(), (tmp_path / "jax.flac").read_bytes()


@pytest.mark.parametrize("channels", [1, 2])
def test_encode_cpu_only_matches_jax_cli_and_decodes(tmp_path, channels):
    x, port, jax_bytes = _encode_both(tmp_path, "--batch-size", "2", channels=channels)
    assert port == jax_bytes
    back = tmp_path / "back.wav"
    assert cli.main(["decode", str(tmp_path / "port.flac"), "-o", str(back)]) == 0
    samples, ch, bps, rate = read_wav(str(back))
    assert (ch, bps, rate) == (channels, 16, 44100)
    assert np.array_equal(samples, x)


def test_strict_float_matches_jax_cli_and_oracle(tmp_path):
    x, port, jax_bytes = _encode_both(tmp_path, "--strict-float")
    cfg = config.Encoder()
    cfg.block_size = 1024
    oracle = reference_encoder.encode_with_fixed_block_size(
        cfg.into_verified(), WavFileSource(str(tmp_path / "in.wav")), 1024, strict_lpc=True
    ).to_bytes()
    assert port == jax_bytes == oracle


def test_oracle_and_dump_config(tmp_path):
    wav = tmp_path / "in.wav"
    _make_wav(wav)
    toml = tmp_path / "cfg.toml"
    rc = cli.main(["encode", str(wav), "-o", str(tmp_path / "o.flac"), "--oracle",
                   "--block-size", "1024", "--dump-config", str(toml)])
    assert rc == 0
    assert config.Encoder.from_toml(toml.read_text()).block_size == 1024
    rc = cli.main([str(wav), "-o", str(tmp_path / "c.flac"), "-c", str(toml), "--cpu-only"])
    assert rc == 0
    assert (tmp_path / "c.flac").read_bytes() == (tmp_path / "o.flac").read_bytes()


def test_profile_trace_writes_a_trace(tmp_path):
    wav = tmp_path / "in.wav"
    _make_wav(wav, n=2100)
    rc = cli.main(["encode", str(wav), "-o", str(tmp_path / "o.flac"), "--cpu-only",
                   "--block-size", "1024", "--profile-trace", str(tmp_path / "trace")])
    assert rc == 0
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_encode_corpus_matches_jax_cli(tmp_path):
    paths = []
    for i, (n, rate) in enumerate([(5000, 44100), (2500, 48000), (700, 44100)]):
        paths.append(str(tmp_path / f"f{i}.wav"))
        _make_wav(paths[-1], n=n, rate=rate, seed=i)
    common = ["--block-size", "1024", "--batch-size", "8", "--cpu-only"]
    assert cli.main(["encode-corpus", *paths, "-d", str(tmp_path / "port"), *common]) == 0
    assert jax_cli.main(["encode-corpus", *paths, "-d", str(tmp_path / "jax"), *common]) == 0
    for i in range(3):
        name = f"f{i}.flac"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.parametrize("case", ["no_command", "missing_input", "missing_config",
                                  "bad_output", "corrupt_flac"])
def test_exit_codes_match_jax_cli(tmp_path, case):
    wav = tmp_path / "in.wav"
    _make_wav(wav, n=2100)
    flac = tmp_path / "ok.flac"
    cli.main(["encode", str(wav), "-o", str(flac), "--cpu-only", "--block-size", "1024"])
    bad = bytearray(flac.read_bytes())
    bad[len(bad) // 2] ^= 0xFF
    (tmp_path / "bad.flac").write_bytes(bytes(bad))
    argv = {
        "no_command": [],
        "missing_input": ["encode", str(tmp_path / "nope.wav"), "-o", str(tmp_path / "x.flac"),
                          "--cpu-only"],
        "missing_config": ["encode", str(wav), "-o", str(tmp_path / "x.flac"), "-c",
                           str(tmp_path / "nope.toml"), "--cpu-only"],
        "bad_output": ["encode", str(wav), "-o", str(tmp_path / "no" / "dir" / "x.flac"),
                       "--cpu-only"],
        "corrupt_flac": ["decode", str(tmp_path / "bad.flac"), "-o", str(tmp_path / "x.wav")],
    }[case]
    expected = {"no_command": 64, "missing_input": 66, "missing_config": 66,
                "bad_output": 73, "corrupt_flac": 66}[case]
    assert cli.main(list(argv)) == jax_cli.main(list(argv)) == expected


def test_cuda_without_card_exits_nonzero_without_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    wav = tmp_path / "in.wav"
    _make_wav(wav, n=2100)
    out = tmp_path / "out.flac"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "flacenc_tpu_torch.cli", "encode", str(wav), "-o", str(out)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 70, proc.stderr
    assert "is_available() is false" in proc.stderr
    assert "falling back" not in proc.stderr + proc.stdout
    assert not out.exists()
