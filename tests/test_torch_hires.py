"""The port at 24-bit / 96 kHz stereo, the hi-res deployment, on the CPU:
each upload wire forced in turn (raw int32, and the dense wires "w", "r"
and "m") gives the raw wire's stream and the JAX package's, byte for byte;
the runner's ``upload_bytes`` counts the payload bytes each batch shipped
(after a fallback too) and ``upload_samples`` the padded batches' samples,
in the stream path and the corpus; ``submit.upload`` is recorded once a
batch under FLACENC_TIMELINE=1, and never without it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu import config  # noqa: E402
from flacenc_tpu.component import decode_stream, parse_stream  # noqa: E402
from flacenc_tpu.models import batch_encoder as jbe  # noqa: E402
from flacenc_tpu.source import MemSource  # noqa: E402

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402

RATE, BPS, C, T, B = 96000, 24, 2, 4096, 4
N = 8 * T + 1234  # two batches of four full blocks, and a ragged tail
FULL = (1 << (BPS - 1)) - 1


def _interleave(a, b) -> np.ndarray:
    x = np.zeros(2 * N, np.int32)
    x[0::2], x[1::2] = a, b
    return x


def _signal(kind: str) -> np.ndarray:
    """Seeded 24-bit stereo that takes upload wire `kind` under a forced
    pack: a random walk "w" (order-1 deltas of a fixed width), noisy tones
    "r" (rice), correlated channels "m" (mid/side rice). Each carries noise
    enough to keep its LPC analysis well conditioned: on a near-pure tone
    the default mode's float decisions may differ from the JAX package's
    (lossless; strict mode resolves it, ``test_torch_hwconfigs``)."""
    rng = np.random.default_rng({"w": 241, "r": 242, "m": 243, "raw": 244}[kind])
    t = np.arange(N, dtype=np.float64)
    if kind == "w":
        a, b = (np.clip(np.cumsum(rng.integers(-20000, 20001, N)), -FULL - 1, FULL)
                for _ in range(2))
    elif kind == "m":
        base = 0.4 * FULL * np.sin(2 * np.pi * 331 / RATE * t) + \
            0.2 * FULL * np.sin(2 * np.pi * 1200 / RATE * t)
        a, b = (np.round(base) + rng.integers(-2000, 2000, N) for _ in range(2))
    else:
        a, b = (np.round(0.5 * FULL * np.sin(2 * np.pi * f / RATE * t)
                         + rng.normal(0, 2000, N)) for f in (440, 523))
    return _interleave(a, b)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # a fetch-wait seed left by an earlier test could switch to grouped round trips
    monkeypatch.setattr(tbe, "_LAST_FETCH_EWMA", None)
    for var in ("FLACENC_INLINE_DISPATCH", "FLACENC_FETCH_GROUP", "FLACENC_PACKED_UPLOAD",
                "FLACENC_TIMELINE"):
        monkeypatch.delenv(var, raising=False)


def _port(x, **kw):
    """(stream bytes, stats) of the port's encode on the CPU."""
    stats = {}
    cfg = tconfig.Encoder().into_verified()
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, TMemSource(x, C, BPS, RATE), T, batch_size=B, device="cpu", stats=stats, **kw)
    return got.to_bytes(), stats


def _kinds(stats) -> set:
    return {eval(k)[0] if k != "None" else None for k in stats["wire_batches"]}


def _packed_bytes(stats) -> int:
    """The payload bytes of the runner's ``packed`` marks, one a batch."""
    return sum(e[4] for e in stats["timeline"] if e[0] == "packed")


@pytest.mark.parametrize("kind", ["raw", "w", "r", "m"])
def test_forced_wire_equals_raw_and_jax(kind, monkeypatch):
    monkeypatch.setenv("FLACENC_TIMELINE", "1")
    x = _signal(kind)
    up = False if kind == "raw" else True
    got, stats = _port(x, upload_pack=up)
    assert _kinds(stats) == {None if kind == "raw" else kind}, stats["wire_batches"]
    jcfg = config.Encoder().into_verified()
    jstats = {}
    want = jbe.encode_with_fixed_block_size(
        jcfg, MemSource(x, C, BPS, RATE), T, batch_size=B, stats=jstats,
        upload_pack=up).to_bytes()
    assert stats["wire_batches"] == jstats["wire_batches"]
    assert got == want
    assert got == _port(x, upload_pack=False)[0]
    assert np.array_equal(decode_stream(parse_stream(got)), x)
    assert stats["batches"] == 2 and stats["upload_samples"] == 2 * B * C * T
    assert stats["upload_bytes"] == _packed_bytes(stats)
    if kind == "raw":
        assert stats["upload_bytes"] == 4 * stats["upload_samples"]
    else:
        assert 0 < stats["upload_bytes"] < 4 * stats["upload_samples"]


def test_racer_counts_the_bytes_shipped_after_a_fallback(monkeypatch):
    """Under the racer a batch whose chosen wire is still warming ships on
    a warm one (raw at hi-res: no delta16 above 16 bits), and the counter
    holds what shipped."""
    monkeypatch.setenv("FLACENC_TIMELINE", "1")
    x = _signal("r")
    runs = [_port(x, upload_pack="auto") for _ in range(2)]
    tbe.wait_all_warms(timeout=600)
    runs.append(_port(x, upload_pack="auto"))
    raw = _port(x, upload_pack=False)[0]
    for got, stats in runs:
        assert got == raw
        assert _kinds(stats) <= {None, "w", "r", "m"}
        assert stats["upload_bytes"] == _packed_bytes(stats)
        raw_batches = stats["wire_batches"].get("None", 0)
        assert (stats["upload_bytes"] == 4 * stats["upload_samples"]) == (raw_batches == 2)
    assert runs[0][1]["wire_batches"].get("None", 0) >= 1  # the first batch fell back


@pytest.mark.parametrize("on", [True, False])
def test_submit_upload_span_once_a_batch(on, monkeypatch):
    if on:
        monkeypatch.setenv("FLACENC_TIMELINE", "1")
    _, stats = _port(_signal("w"), upload_pack=True)
    if not on:
        assert "spans" not in stats
        return
    uploads = [s for s in stats["spans"] if s["name"] == "submit.upload"]
    assert sorted(s["seq"] for s in uploads) == list(range(stats["batches"]))
    assert {s["thread"] for s in uploads} == {"MainThread"}
    assert all(s["end_ns"] >= s["start_ns"] and s["cpu_ns"] is None for s in uploads)


def test_corpus_counts_uploads():
    x = _signal("raw")
    streams, stats = flacenc_tpu_torch.encode_corpus(
        [("a", TMemSource(x, C, BPS, RATE)), ("b", TMemSource(x, C, BPS, RATE))],
        tconfig.Encoder(), T, batch_size=B, device="cpu", upload_pack=False)
    assert stats.upload_samples == stats.batches * B * C * T > 0
    assert stats.upload_bytes == 4 * stats.upload_samples
    assert np.array_equal(decode_stream(parse_stream(streams["a"].to_bytes())), x)
