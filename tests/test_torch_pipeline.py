"""The port's pipeline at FLACENC_PIPELINE_DEPTH with the pack on io
workers (`BatchRunner`): at every depth, for every packer, in strict mode,
over a packed wire and with grouped round trips, the stream and corpus
bytes equal the JAX package's; `max_inflight` reaches the depth and never
passes it; the pack runs on the pool; a worker's error comes out of the
entry as itself and leaves no thread behind; and the port's
``tools.overlap.analyze`` equals the JAX package's ``tools/overlap.py`` on
every key the JAX tool reports (the port adds the issue span). All on the
CPU."""

import functools
import importlib.util
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu import config, sigen  # noqa: E402
from flacenc_tpu.models import batch_encoder as jbe  # noqa: E402
from flacenc_tpu.parallel import encode_corpus as jax_encode_corpus  # noqa: E402
from flacenc_tpu.source import MemSource  # noqa: E402

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch import constants as tconstants  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402
from flacenc_tpu_torch.source import Source as TSource  # noqa: E402
from flacenc_tpu_torch.tools import overlap  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 512
N = T * 23 + 77  # 12 batches of 2 at block 512, the last one padded, and a tail
DEPTHS = [1, 2, 4, 8]


@pytest.fixture(autouse=True)
def _fresh_fetch_ewma(monkeypatch):
    """Each test's runners start without the process-wide fetch-wait seed:
    a seed left by slow CPU waits in an earlier test would switch a runner
    to grouped round trips."""
    monkeypatch.setattr(tbe, "_LAST_FETCH_EWMA", None)


def _walk(n: int, seed: int = 3) -> np.ndarray:
    """Stereo random walks of small steps: `try_pack` takes the rice wire."""
    rng = np.random.default_rng(seed)
    x = np.zeros(2 * n, np.int32)
    for ch in range(2):
        x[ch::2] = np.clip(np.cumsum(rng.integers(-40, 41, n)), -30000, 30000)
    return x


def _tones(n: int, seed: int = 1) -> np.ndarray:
    x = np.zeros(2 * n, np.int32)
    for ch in range(2):
        x[ch::2] = sigen.Sine(90 + 7 * seed + ch, 0.4).noise_with_seed(seed + ch, 0.02) \
            .to_vec_quantized(16, n)
    return x


@functools.lru_cache(maxsize=None)
def _jax_bytes(signal: str, strict: bool) -> bytes:
    x = _walk(N) if signal == "walk" else _tones(N)
    return jbe.encode_with_fixed_block_size(
        config.Encoder().into_verified(), MemSource(x, 2, 16, 44100), T, batch_size=2,
        mesh=None, strict_lpc=strict,
    ).to_bytes()


# (packer, strict, upload_pack, FLACENC_FETCH_GROUP, signal)
VARIANTS = {
    "native2": ("native2", False, False, "1", "tones"),
    "native": ("native", False, False, "1", "tones"),
    "python": ("python", False, False, "1", "tones"),
    "strict": ("native2", True, False, "1", "tones"),
    "forced r": ("native2", False, True, "1", "walk"),
    "group 2": ("native2", False, False, "2", "tones"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("depth", DEPTHS)
def test_stream_bytes_equal_jax_at_every_depth(depth, variant, monkeypatch):
    packer, strict, upload_pack, group, signal = VARIANTS[variant]
    monkeypatch.setattr(tconstants.par, "FRAMEBUF_MULTIPLICITY", depth)
    monkeypatch.setenv("FLACENC_FETCH_GROUP", group)
    x = _walk(N) if signal == "walk" else _tones(N)
    runs = 2 if group != "1" else 1  # the first of two warms the grouped program
    for _ in range(runs):
        stats = {}
        got = flacenc_tpu_torch.encode_with_fixed_block_size(
            tconfig.Encoder(), TMemSource(x, 2, 16, 44100), T, batch_size=2, device="cpu",
            packer=packer, strict_lpc=strict, upload_pack=upload_pack, stats=stats,
        ).to_bytes()
        tbe.wait_group_warms()
    assert got == _jax_bytes(signal, strict)
    assert stats["batches"] == 12
    if group == "2":
        assert stats["grouped_batches"] == 12
        assert stats["max_inflight"] == max(depth, 3)
    else:
        assert stats["max_inflight"] == depth
    if upload_pack:
        assert {eval(k)[0] for k in stats["wire_batches"]} == {"r"}, stats["wire_batches"]


_FILES = [(T * 19 + 300, 44100), (T * 3 + 10, 48000), (T * 8, 44100), (500, 48000),
          (T * 5 + 1, 44100)]


@functools.lru_cache(maxsize=None)
def _jax_corpus() -> dict:
    streams, _ = jax_encode_corpus(
        [(f"f{i}", MemSource(_tones(n, i), 2, 16, r)) for i, (n, r) in enumerate(_FILES)],
        config.Encoder().into_verified(), T, batch_size=2, mesh=None,
    )
    return {name: s.to_bytes() for name, s in streams.items()}


@pytest.mark.parametrize("depth", DEPTHS)
def test_corpus_bytes_equal_jax_at_every_depth(depth, monkeypatch):
    monkeypatch.setattr(tconstants.par, "FRAMEBUF_MULTIPLICITY", depth)
    streams, stats = flacenc_tpu_torch.encode_corpus(
        [(f"f{i}", TMemSource(_tones(n, i), 2, 16, r)) for i, (n, r) in enumerate(_FILES)],
        tconfig.Encoder(), T, batch_size=2, device="cpu",
    )
    assert {name: s.to_bytes() for name, s in streams.items()} == _jax_corpus()
    assert stats.max_inflight_batches == depth


class _GenSource(TSource):
    """Blocks made on the fly from a seed: nothing is held up front."""

    def __init__(self, seed, n):
        self._seed, self._n, self._off = seed, n, 0

    def channels(self):
        return 2

    def bits_per_sample(self):
        return 16

    def sample_rate(self):
        return 44100

    def len_hint(self):
        return self._n

    def read_samples(self, block_size, dest):
        framebuf, context = dest if isinstance(dest, tuple) else (dest, None)
        end = min(self._off + block_size, self._n)
        if end == self._off:
            return 0
        rng = np.random.default_rng(self._seed * 1000 + self._off)
        chunk = rng.integers(-2000, 2000, (end - self._off) * 2, np.int32)
        framebuf.fill_interleaved(chunk)
        if context is not None:
            context.fill_interleaved(chunk)
        n = end - self._off
        self._off = end
        return n


@pytest.mark.parametrize("depth", [3, 8])
def test_corpus_inflight_bounded_by_depth(depth, monkeypatch):
    """A corpus of many batches from generated sources (the counterpart of
    tests/test_parallel.py's bound): 1 <= max_inflight_batches <= depth, the
    depth reached, and every file equal to its stream encode."""
    monkeypatch.setattr(tconstants.par, "FRAMEBUF_MULTIPLICITY", depth)
    block, batch = 256, 4
    lens = (block * 40, block * 33 + 77, block * 29)
    streams, stats = flacenc_tpu_torch.encode_corpus(
        [(f"g{i}", _GenSource(i, n)) for i, n in enumerate(lens)], tconfig.Encoder(), block,
        batch_size=batch, device="cpu",
    )
    assert 1 <= stats.max_inflight_batches <= depth
    assert stats.max_inflight_batches == depth
    assert stats.batches >= sum(n // block for n in lens) // batch
    assert stats.read_s >= 0 and stats.device_wait_s >= 0 and stats.pack_s > 0
    for i, n in enumerate(lens):
        alone = flacenc_tpu_torch.encode_with_fixed_block_size(
            tconfig.Encoder(), _GenSource(i, n), block, batch_size=batch, device="cpu",
        ).to_bytes()
        assert streams[f"g{i}"].to_bytes() == alone


def test_pack_runs_on_the_io_workers(monkeypatch):
    threads = []
    real = tbe._ASSEMBLERS["native2"]

    def spy(*args):
        threads.append(threading.current_thread().name)
        return real(*args)

    monkeypatch.setitem(tbe._ASSEMBLERS, "native2", spy)
    stats = {}
    flacenc_tpu_torch.encode_with_fixed_block_size(
        tconfig.Encoder(), TMemSource(_tones(N), 2, 16, 44100), T, batch_size=2, device="cpu",
        packer="native2", stats=stats,
    )
    assert len(threads) == 12 and all(t.startswith("flacenc-io") for t in threads), threads
    assert stats["pack_s"] > 0


class _Boom(Exception):
    pass


def _io_threads():
    return {t for t in threading.enumerate() if t.name.startswith("flacenc-io")}


@pytest.mark.parametrize("entry", ["stream", "corpus"])
def test_worker_error_propagates_and_leaves_no_thread(entry, monkeypatch):
    """A packer error on a worker comes out of the entry as itself; the
    runner's workers are all joined."""
    calls = []
    real = tbe._ASSEMBLERS["native2"]

    def failing(*args):
        calls.append(1)
        if len(calls) == 3:
            raise _Boom("packer failed on the third batch")
        return real(*args)

    monkeypatch.setitem(tbe._ASSEMBLERS, "native2", failing)
    before = _io_threads()
    with pytest.raises(_Boom, match="third batch"):
        if entry == "stream":
            flacenc_tpu_torch.encode_with_fixed_block_size(
                tconfig.Encoder(), TMemSource(_tones(N), 2, 16, 44100), T, batch_size=2,
                device="cpu", packer="native2",
            )
        else:
            flacenc_tpu_torch.encode_corpus(
                [("a", TMemSource(_tones(N), 2, 16, 44100))], tconfig.Encoder(), T,
                batch_size=2, device="cpu", packer="native2",
            )
    assert not {t for t in _io_threads() - before if t.is_alive()}


class _FailingEvent:
    def synchronize(self):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_device_error_at_the_wait_propagates(monkeypatch):
    """An error raised by a batch's event wait (on a card, a CUDA error)
    comes out of `drain` as itself, and `close` joins the workers."""
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 2, "cpu", upload_pack=False)
    real = runner._run

    def run(*args, **kw):
        host, _, inputs = real(*args, **kw)
        return host, [_FailingEvent()], inputs

    monkeypatch.setattr(runner, "_run", run)
    blocks = _tones(2 * T).reshape(2, T, 2).transpose(0, 2, 1).copy()
    try:
        assert runner.submit(blocks, np.arange(2), 44100) is None
        with pytest.raises(RuntimeError, match="illegal memory access"):
            list(runner.drain())
    finally:
        runner.close()
    assert all(not t.is_alive() for t in runner._pool._threads)


def _jax_overlap():
    spec = importlib.util.spec_from_file_location(
        "jax_tools_overlap", os.path.join(REPO, "tools", "overlap.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic_timeline(seed: int):
    """A made-up timeline in the pipeline's vocabulary: reads, submits (some
    with a drain nested inside), worker fetches, and grouped round trips."""
    rng = np.random.default_rng(seed)
    t, events = 0.0, []
    for i in range(int(rng.integers(3, 12))):
        events += [("read_start", i, t), ("read_done", i, t + rng.uniform(0, 0.01))]
        t += 0.01
        events += [("submit", i, t), ("packed", i, t + rng.uniform(0.001, 0.005), "raw", 100)]
        if rng.integers(0, 2):
            a = t + rng.uniform(0, 0.004)
            events += [("drain_start", i - 1, a), ("drain_done", i - 1, a + rng.uniform(0, 0.01))]
        events += [("fetch_start", i, t + 0.006), ("fetch_done", i, t + rng.uniform(0.007, 0.02))]
        if rng.integers(0, 3) == 0:
            events += [("gtrip_start", i, t), ("gasm_done", i, t + rng.uniform(0.01, 0.03))]
        t += rng.uniform(0.005, 0.02)
    rng.shuffle(events)
    return events, t + 0.01


def _equal_to_jax_and_issue_keys(got: dict, jax: dict) -> None:
    """The port's split equals JAX's on every key JAX's reports; the port
    adds the issue span alone."""
    assert {k: got[k] for k in jax} == jax
    assert set(got) - set(jax) == {"issue_s", "n_issues"}


@pytest.mark.parametrize("seed", range(6))
def test_overlap_analyze_equals_jax_on_synthetic_timelines(seed):
    events, wall = _synthetic_timeline(seed)
    _equal_to_jax_and_issue_keys(overlap.analyze(events, wall),
                                 _jax_overlap().analyze(events, wall))


@pytest.mark.parametrize("group", ["1", "2"])
def test_overlap_analyze_equals_jax_on_a_cpu_timeline(group, monkeypatch):
    monkeypatch.setenv("FLACENC_TIMELINE", "1")
    monkeypatch.setenv("FLACENC_FETCH_GROUP", group)
    stats = {}
    flacenc_tpu_torch.encode_with_fixed_block_size(
        tconfig.Encoder(), TMemSource(_tones(N), 2, 16, 44100), T, batch_size=2, device="cpu",
        stats=stats,
    )
    timeline = stats["timeline"]
    names = {e[0] for e in timeline}
    worker = ({"gtrip_start", "gfetch_done", "gasm_done"} if group == "2"
              else {"fetch_start", "fetch_done"})
    assert worker | {"asm_done", "drain_start", "drain_done"} <= names
    assert [e[2] for e in timeline] == sorted(e[2] for e in timeline)  # one clock, in order
    got = overlap.analyze(timeline, stats["wall_s"])
    _equal_to_jax_and_issue_keys(got, _jax_overlap().analyze(timeline, stats["wall_s"]))
    assert got["issue_s"] > 0
    if group == "2":
        assert got["n_group_trips"] == 6 and got["n_fetches"] == 0 and got["n_issues"] == 6
    else:
        assert got["n_fetches"] == 12 and got["n_issues"] == 12



def test_slow_pack_does_not_engage_auto_grouping(monkeypatch):
    """The download-wait EWMA that gates auto grouping takes the worker's
    pack seconds out of the caller's wait: at depth 1 the caller waits for
    every pack, and a slow pack is not a slow link."""
    import time

    real = tbe._ASSEMBLERS["native2"]

    def slow(*args):
        time.sleep(0.03)  # twice `_GROUP_FETCH_MIN_S`
        return real(*args)

    monkeypatch.setitem(tbe._ASSEMBLERS, "native2", slow)
    monkeypatch.setattr(tconstants.par, "FRAMEBUF_MULTIPLICITY", 1)
    monkeypatch.setattr(tbe, "_LAST_FETCH_EWMA", None)
    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    stats = {}
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        tconfig.Encoder(), TMemSource(_tones(N), 2, 16, 44100), T, batch_size=2, device="cpu",
        packer="native2", stats=stats,
    ).to_bytes()
    assert got == _jax_bytes("tones", False)
    assert stats["grouped_batches"] == 0 and stats["max_inflight"] == 1
    assert stats["device_wait_s"] >= 12 * 0.03 and tbe._LAST_FETCH_EWMA < tbe._GROUP_FETCH_MIN_S
