"""The plain reference against the program on a short CPU encode, and the
reference's own frames through its decoder."""

import numpy as np
import pytest

from benchmark import check, programs, traffic
from benchmark.reference import encoder, flac

FMT = {"sample_rate": 44100, "bits_per_sample": 16, "channels": 2}
BLOCK = 4096


@pytest.fixture(scope="module")
def cfg():
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__), "configs", "cd_default_1card.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def sources():
    # every program alone, 6 blocks and a ragged tail, one source of the
    # mix, and white noise
    rng = np.random.default_rng(4)
    out = [traffic.Source(k, programs.quantize(f(rng, 6 * BLOCK + 1000, 44100), 16), 44100)
           for k, f in programs.PROGRAMS.items()]
    mixed = traffic.generate(traffic.load_mix("album"), FMT, 4, scale=0.002)[0]
    noise = np.random.default_rng(1).integers(-32768, 32768, (3 * BLOCK + 50, 2))
    return out + [mixed, traffic.Source("white_noise", noise.astype(np.int32), 44100)]


def _program_stream(cfg, src):
    from flacenc_tpu_torch import config as pconfig
    from flacenc_tpu_torch.models import batch_encoder as be
    from flacenc_tpu_torch.source import MemSource

    enc = pconfig.Encoder.from_dict(cfg["encoder"]).into_verified()
    return be.encode_with_fixed_block_size(
        enc, MemSource(src.pcm.reshape(-1), 2, 16, 44100), BLOCK, batch_size=8,
        device="cpu").to_bytes()


def test_reference_frames_equal_the_programs(cfg, sources):
    kinds = set()
    for src in sources:
        data = _program_stream(cfg, src)
        fault, index = check._stream_fault(data, src.pcm, FMT, BLOCK)
        assert fault is None, (src.name, fault)
        for i, (a, b, h) in enumerate(index):
            block = src.pcm[i * BLOCK:(i + 1) * BLOCK]
            ref = encoder.encode_frame(cfg["encoder"], block, 44100, 16, i)
            assert ref == data[a:b], (src.name, i)
            assert np.array_equal(flac.decode_frame(ref, 44100, 16, 2), block)
            kinds.add(h.assign)
    assert len(kinds) >= 2


def test_subframe_kinds_round_trip(cfg):
    rng = np.random.default_rng(3)
    blocks = {
        "constant": np.full((BLOCK, 2), 7, np.int32),
        "verbatim": rng.integers(-32768, 32768, (BLOCK, 2)).astype(np.int32),
        "short": rng.integers(-100, 100, (40, 2)).astype(np.int32),
        "tonal": traffic.generate(traffic.load_mix("album"), FMT, 1, 0.01)[0].pcm[:BLOCK],
    }
    for name, block in blocks.items():
        frame = encoder.encode_frame(cfg["encoder"], block, 44100, 16, 300000)
        assert np.array_equal(flac.decode_frame(frame, 44100, 16, 2), block), name


def test_decoder_refuses_a_flipped_bit(cfg):
    block = traffic.generate(traffic.load_mix("album"), FMT, 2, 0.01)[0].pcm[:BLOCK]
    frame = bytearray(encoder.encode_frame(cfg["encoder"], block, 44100, 16, 5))
    frame[len(frame) // 2] ^= 0x10
    with pytest.raises(flac.FormatError):
        flac.decode_frame(bytes(frame), 44100, 16, 2)


def test_md5_matches_the_program(cfg, sources):
    src = sources[0]
    data = _program_stream(cfg, src)
    assert flac.read_streaminfo(data).md5 == check.pcm_md5(src.pcm, 16)
