"""The port's config matrix (``flacenc_tpu_torch.tools.hwconfigs``) on the
CPU, held against the JAX package's ``tools/hwconfigs.py`` on the same
audio: every row's bits/sample equals the JAX tool's encode."""

import importlib.util
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu_torch import tools  # noqa: E402
from flacenc_tpu_torch.tools import hwconfigs, stereo_audio  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """These encodes run beside other test workers: one torch thread and one
    pack thread keep them from oversubscribing the cores (the packers give
    the same bytes for any thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("FLACENC_PACK_THREADS", "1")
    yield
    torch.set_num_threads(threads)


def _jax_hwconfigs():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_hwconfigs", os.path.join(REPO, "tools", "hwconfigs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _short_warm_ups(monkeypatch):
    """The tool's 20 s and 10 s warm-up encodes cut to 1 s, to keep the CPU
    run short; the timed audio is untouched."""
    def short(make):
        return lambda seconds, *a: make(1.0 if seconds in (10.0, 20.0) else seconds, *a)

    monkeypatch.setattr(hwconfigs, "mono_audio", short(hwconfigs.mono_audio))
    monkeypatch.setattr(tools, "stereo_audio", short(tools.stereo_audio))


@pytest.mark.parametrize("seconds", [0.5, 1.3])
def test_mono_audio_equals_jax(seconds):
    got = hwconfigs.mono_audio(seconds)
    assert got.dtype == np.int32
    assert np.array_equal(got, _jax_hwconfigs().mono_audio(seconds))


# Past 0.65 s the 24/96 tone of the hi-res row has frames whose default-mode
# LPC solve (f64, ill-conditioned on a near-pure tone) comes out differently
# in the JAX program, its numpy oracle and the port (ROADMAP queue 3); strict
# mode is byte-equal there (`test_hires_audio_strict_bytes_equal_jax`).
SECONDS = 0.6


def test_five_rows_bits_equal_jax(tmp_path, capsys, monkeypatch):
    """`--seconds 0.6 --gap 0 --cpu-only`: five rows without an error, each
    row's bits/sample equal to the JAX tool's `timed_encode` (its corpus row:
    `encode_corpus`) of the same audio; the table goes where `--out` says."""
    from flacenc_tpu import config
    from flacenc_tpu.parallel import encode_corpus
    from flacenc_tpu.source import MemSource

    jax_hw = _jax_hwconfigs()
    _short_warm_ups(monkeypatch)
    out = tmp_path / "matrix.md"
    assert hwconfigs.main(["--cpu-only", "--seconds", str(SECONDS), "--gap", "0",
                           "--out", str(out)]) == 0
    rows = {r.pop("config"): r for r in (json.loads(line) for line in
                                         capsys.readouterr().out.splitlines()
                                         if line.startswith("{"))}
    assert len(rows) == 5 and not any("error" in r for r in rows.values())
    # the raw upload keeps the JAX racer from compiling packed-wire programs
    # on the CPU (a wire never changes the bytes)
    monkeypatch.setenv("FLACENC_PACKED_UPLOAD", "0")

    def cfg(use_lpc=True, direct_mse=False):
        c = config.Encoder()
        c.subframe_coding.use_lpc = use_lpc
        c.subframe_coding.qlpc.use_direct_mse = direct_mse
        return c.into_verified()

    cases = {
        "fixed-only (mono 16/44.1)": (cfg(use_lpc=False), jax_hw.mono_audio(SECONDS), 1, 16,
                                      44100),
        "default (stereo 16/44.1)": (cfg(), jax_hw.stereo_audio(SECONDS, 44100, 16), 2, 16,
                                     44100),
        "hi-res (stereo 24/96)": (cfg(), jax_hw.stereo_audio(SECONDS, 96000, 24), 2, 24, 96000),
        "experimental (direct-MSE)": (cfg(direct_mse=True),
                                      jax_hw.stereo_audio(SECONDS, 44100, 16), 2, 16, 44100),
    }
    for name, (c, audio, ch, bps, rate) in cases.items():
        exp = jax_hw.timed_encode(c, audio, ch, bps, rate, 4096, 256, trials=1)
        assert rows[name]["bits_per_sample"] == exp["bits_per_sample"], name
        assert rows[name]["audio_s"] == exp["audio_s"], name

    base = jax_hw.stereo_audio(16.0, 44100, 16)  # 4 files of max(0.6 / 4, 4) s
    n_file = (len(base) // 4) // 2 * 2
    sources = [(f"f{i:02d}", MemSource(base[i * n_file: (i + 1) * n_file], 2, 16, 44100))
               for i in range(4)]
    streams, _ = encode_corpus(sources, cfg(), 4096, batch_size=256)
    total = sum(len(s.to_bytes()) for s in streams.values())
    corpus = rows["corpus (4 track-length files, stereo 16/44.1)"]
    assert corpus["bits_per_sample"] == round(total * 8 / (4 * n_file), 4)
    assert corpus["files"] == 4

    text = out.read_text()
    assert text.startswith("# Hardware config matrix") and "Backend: `cpu`." in text
    assert sum(line.startswith(f"| {name} |") for line in text.splitlines()
               for name in rows) == 5


def test_hires_audio_strict_bytes_equal_jax():
    """The hi-res row's 2 s of 24/96 audio in strict mode: the port's stream
    equals the JAX program's byte for byte (default mode differs in a few
    frames, as the JAX program and its own oracle do; see SECONDS)."""
    import flacenc_tpu
    from flacenc_tpu import config
    from flacenc_tpu.source import MemSource

    import flacenc_tpu_torch
    from flacenc_tpu_torch import config as tconfig
    from flacenc_tpu_torch.source import MemSource as TMemSource

    audio = stereo_audio(2.0, 96000, 24)
    exp = flacenc_tpu.encode_with_fixed_block_size(
        config.Encoder().into_verified(), MemSource(audio, 2, 24, 96000), 4096,
        batch_size=256, strict_lpc=True).to_bytes()
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        tconfig.Encoder().into_verified(), TMemSource(audio, 2, 24, 96000), 4096,
        batch_size=256, strict_lpc=True, device="cpu").to_bytes()
    assert got == exp


def test_failed_row_is_kept_and_exits_nonzero(tmp_path, monkeypatch, capsys):
    """A config that raises keeps its row (with the error) and the others
    still run, as in the JAX tool; the tool then exits 1."""
    real = hwconfigs.timed_encode

    def failing(cfg, audio, ch, *args, **kw):
        if ch == 1:
            raise FloatingPointError("injected")
        return real(cfg, audio, ch, *args, **kw)

    monkeypatch.setattr(hwconfigs, "timed_encode", failing)
    _short_warm_ups(monkeypatch)
    out = tmp_path / "m.md"
    skip = "hi-res (stereo 24/96),experimental,corpus"  # by name or first word
    assert hwconfigs.main(["--cpu-only", "--seconds", "1", "--gap", "0", "--skip", skip,
                           "--out", str(out)]) == 1
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    assert [r["config"] for r in rows] == ["fixed-only (mono 16/44.1)", "default (stereo 16/44.1)"]
    assert rows[0]["error"] == "FloatingPointError: injected" and "error" not in rows[1]
    assert "| fixed-only (mono 16/44.1) | FAILED |" in out.read_text()
