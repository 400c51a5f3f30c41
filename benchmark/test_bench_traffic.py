"""The traffic generator: the same seed gives the same calls, another
seed other samples but the same set of lengths and the same kind of work."""

import numpy as np
import pytest

from benchmark import traffic

FMT = {"sample_rate": 44100, "bits_per_sample": 16, "channels": 2}


@pytest.fixture(scope="module")
def mix():
    return traffic.load_mix("album")


def test_same_seed_same_calls(mix):
    a = traffic.generate(mix, FMT, 123, scale=0.02)
    b = traffic.generate(mix, FMT, 123, scale=0.02)
    assert [s.name for s in a] == [s.name for s in b]
    assert all(np.array_equal(x.pcm, y.pcm) for x, y in zip(a, b))


def test_other_seed_other_samples_same_lengths(mix):
    a = traffic.generate(mix, FMT, 123, scale=0.02)
    b = traffic.generate(mix, FMT, 2**31 + 77, scale=0.02)
    assert sorted(s.frames for s in a) == sorted(s.frames for s in b)
    assert [s.name for s in a] != [s.name for s in b]
    same = {s.name: s for s in a}
    assert not any(np.array_equal(s.pcm, same[s.name].pcm) for s in b)


def test_material_seed_same_work_every_seed(mix):
    """With the mix's material seed every run seed encodes the same sources,
    rotated, reversed or inverted: the same samples up to clipping."""
    a = {s.name: s.pcm for s in traffic.generate(mix, FMT, 123, scale=0.02)}
    b = {s.name: s.pcm for s in traffic.generate(mix, FMT, 2**31 + 77, scale=0.02)}
    for name, pcm in a.items():
        x, y = np.abs(pcm.astype(np.int64)), np.abs(b[name].astype(np.int64))
        assert abs(int(x.sum()) - int(y.sum())) <= int((x == 32768).sum() + (y == 32768).sum())
    free = traffic.generate(dict(mix, material_seed=None), FMT, 123, scale=0.02)
    assert not any(np.array_equal(s.pcm, a[s.name]) for s in free)


def test_lengths_are_quantiles():
    even = traffic.lengths({"kind": "even", "lo": 150, "hi": 420}, 12)
    assert even[0] == pytest.approx(150 + 270 / 24) and even[-1] == pytest.approx(420 - 270 / 24)
    logu = traffic.lengths({"kind": "log_uniform", "lo": 2, "hi": 60}, 4)
    assert logu[0] == pytest.approx(2 * 30 ** 0.125) and logu[-1] == pytest.approx(60 / 30 ** 0.125)


def test_shares_and_rates(mix):
    assert traffic.shares({"a": 0.5, "b": 0.3, "c": 0.2}, 7) == ["a", "a", "a", "a", "b", "b", "c"]
    lib = dict(mix, items=6, sample_rates={"44100": 0.5, "48000": 0.5})
    for seed in (1, 2):
        out = traffic.generate(lib, FMT, seed, scale=0.01)
        assert sorted(s.rate for s in out) == [44100] * 3 + [48000] * 3
    a, b = (traffic.generate(dict(lib, material_seed=None), FMT, seed, scale=0.01)
            for seed in (1, 2))
    assert [s.rate for s in a] != [s.rate for s in b]
    # with a material seed each source keeps its rate, whatever the run's seed
    a, b = (traffic.generate(lib, FMT, seed, scale=0.01) for seed in (1, 2))
    assert {s.name: s.rate for s in a} == {s.name: s.rate for s in b}


def test_arrivals_same_gaps_other_order(mix):
    open_mix = dict(mix, loop="open", rate_per_s=10)
    a, b = (traffic.arrivals(open_mix, 30.0, seed) for seed in (5, 6))
    assert a == traffic.arrivals(open_mix, 30.0, 5) and a != b
    assert a[0] == b[0] == 0.0 and all(x < y for x, y in zip(a, a[1:]))
    assert len(a) == len(b) == 300


def test_channels_and_depth(mix):
    for ch, bps in ((1, 24), (3, 16)):
        out = traffic.generate(mix, dict(FMT, channels=ch, bits_per_sample=bps), 9, scale=0.01)
        assert all(s.pcm.shape[1] == ch and s.pcm.max() < 2 ** (bps - 1) for s in out)
    assert traffic.generate(mix, dict(FMT, bits_per_sample=24), 9, scale=0.01)[0].pcm.max() > 2 ** 16


def test_mix_file_asks_only_for_what_is_done(mix):
    traffic.check_mix(mix)
    for bad in ({"loop": "poisson"}, {"call": "encode"}, {"length_s": {"kind": "zipf"}},
                {"sections": {"speech": 1.0}}, {"loop": "open"}, {"callers": 0},
                {"warm": [{"upload": "twice", "scale": 0.1}]}):
        with pytest.raises(ValueError):
            traffic.check_mix(dict(mix, **bad))


def test_pcm_is_in_range_and_stereo(mix):
    for s in traffic.generate(mix, FMT, 9, scale=0.01):
        assert s.pcm.dtype == np.int32 and s.pcm.shape[1] == 2
        assert s.pcm.min() >= -32768 and s.pcm.max() <= 32767
