"""Port parity for corpus encoding: `flacenc_tpu_torch.encode_corpus`
against the port's single-file encodes and the JAX package's
`encode_corpus`, byte for byte."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu import config, sigen  # noqa: E402
from flacenc_tpu.component import decode_stream, parse_stream  # noqa: E402
from flacenc_tpu.parallel import encode_corpus as jax_encode_corpus  # noqa: E402
from flacenc_tpu.source import MemSource  # noqa: E402

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402

T = 1024
BATCH = 8


def _clip(n, seed, C=2, bps=16):
    x = np.zeros(C * n, np.int32)
    for c in range(C):
        x[c::C] = sigen.Sine(80 + 11 * seed + c, 0.4).noise_with_seed(seed * 7 + c, 0.02) \
            .to_vec_quantized(bps, n)
    return x


# mixed rates; files longer than a batch (aligned bulk reads), shorter
# than one, and a lone ragged tail
_FILES = [(T * 19 + 300, 44100), (T * 3 + 10, 48000), (T * 8, 44100),
          (500, 48000), (T * 5 + 1, 44100)]


def _sources(C=2, source=TMemSource):
    return [(f"f{i}", source(_clip(n, i, C), C, 16, rate))
            for i, (n, rate) in enumerate(_FILES)]


@pytest.mark.parametrize("strict", [False, True])
def test_corpus_matches_single_file_and_jax(strict):
    cfg = tconfig.Encoder().into_verified()
    streams, stats = flacenc_tpu_torch.encode_corpus(
        _sources(), cfg, T, batch_size=BATCH, device="cpu", strict_lpc=strict
    )
    jax_streams, _ = jax_encode_corpus(_sources(source=MemSource), config.Encoder().into_verified(),
                                       T, batch_size=BATCH, strict_lpc=strict)
    assert stats.files == len(_FILES)
    assert stats.tail_frames == sum(n % T > 0 for n, _ in _FILES)
    assert stats.frames == sum(-(-n // T) for n, _ in _FILES)
    for (name, src), (n, rate) in zip(_sources(), _FILES):
        got = streams[name].to_bytes()
        alone = flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg, src, T, batch_size=BATCH, device="cpu", strict_lpc=strict
        ).to_bytes()
        assert got == alone == jax_streams[name].to_bytes(), name
        assert streams[name].stream_info().sample_rate == rate
        assert np.array_equal(decode_stream(parse_stream(got)).reshape(-1),
                              _clip(n, int(name[1:])))


def test_corpus_mono_per_block_sources():
    """Sources without the bulk read go through the per-block path."""

    class NoBulk(TMemSource):
        def read_blocks_batch(self, n_blocks, block_size, context):
            return None

    files = [(T * 9 + 5, 44100), (T * 2, 44100)]
    srcs = [(f"m{i}", NoBulk(_clip(n, i, C=1), 1, 16, r)) for i, (n, r) in enumerate(files)]
    cfg = tconfig.Encoder()
    streams, stats = flacenc_tpu_torch.encode_corpus(srcs, cfg, T, batch_size=BATCH, device="cpu")
    assert stats.batches == 2
    for i, (n, rate) in enumerate(files):
        alone = flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg, TMemSource(_clip(n, i, C=1), 1, 16, rate), T, device="cpu"
        ).to_bytes()
        assert streams[f"m{i}"].to_bytes() == alone


def test_corpus_rejects_mismatched_sources():
    cfg = tconfig.Encoder()
    for other in (TMemSource(_clip(T, 0, C=1), 1, 16, 44100),
                  TMemSource(_clip(T, 0), 2, 24, 44100)):
        with pytest.raises(ValueError, match="share channel count"):
            flacenc_tpu_torch.encode_corpus(
                [("a", TMemSource(_clip(T, 0), 2, 16, 44100)), ("b", other)], cfg, T,
                device="cpu",
            )
    assert flacenc_tpu_torch.encode_corpus([], cfg, T, device="cpu")[0] == {}


def test_corpus_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="is_available"):
        flacenc_tpu_torch.encode_corpus(
            [("a", TMemSource(_clip(T, 0), 2, 16, 44100))], tconfig.Encoder(), T
        )
