"""The runner's dispatch lane (`BatchRunner`'s default issue path, the JAX
package's ``_updf_plain`` / ``_upload_dispatch_fetch`` /
``_roundtrip_group``) against FLACENC_INLINE_DISPATCH (its kill switch,
which issues on the caller's thread). On the CPU, at a small size: both
paths give the JAX package's bytes on every case; the program call and the
strict host arrays run on the lane by default and on the caller under the
switch, and the lane launches batches in submit order; a program that
raises on the lane fails the entry with its own exception and leaves no
thread; the timeline holds the JAX package's event names; and
``tools.overlap`` reads the issue span from a hand-made timeline."""

import functools
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
from flacenc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402
from flacenc_tpu_torch.tools import overlap  # noqa: E402

T = 512
N = T * 23 + 77  # 12 batches of 2 at block 512, the last one padded, and a tail
LANE = "flacenc-lane"


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One torch thread and one pack thread: the bytes depend on neither,
    and the test workers run beside each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("FLACENC_PACK_THREADS", "1")
    monkeypatch.setenv("FLACENC_TIMELINE", "1")
    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    yield
    torch.set_num_threads(threads)


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
def _jax(signal: str, strict: bool):
    """JAX's bytes and timeline event names for the signal (every wire,
    group size, packer and mesh gives these bytes)."""
    x = _walk(N) if signal == "walk" else _tones(N)
    stats = {}
    stream = jbe.encode_with_fixed_block_size(
        config.Encoder().into_verified(), MemSource(x, 2, 16, 44100), T, batch_size=2,
        mesh=None, strict_lpc=strict, stats=stats,
    )
    return stream.to_bytes(), frozenset(e[0] for e in stats["timeline"])


# name -> (signal, strict, packer, upload_pack, FLACENC_FETCH_GROUP, depth, mesh replicas)
CASES = {
    "native2 depth 1": ("tones", False, "native2", False, "1", 1, 0),
    "native2 depth 8": ("tones", False, "native2", False, "1", 8, 0),
    "strict": ("tones", True, "native2", False, "1", 8, 0),
    "forced r": ("walk", False, "native2", True, "1", 8, 0),
    "group 2": ("tones", False, "native2", False, "2", 8, 0),
    "native packer": ("tones", False, "native", False, "1", 8, 0),
    "mesh 2": ("tones", False, "native2", False, "1", 8, 2),
}


def _spy(monkeypatch):
    """Record the thread of every program call and strict-array call, and
    the batches each launch task issues, in call order."""
    seen = {"program": [], "strict": [], "seqs": []}
    call, strict = tbe.Program.__call__, tbe._strict_ext_arrays
    launch, trip = tbe.BatchRunner._launch, tbe.BatchRunner._roundtrip_group

    def spy_call(self, *inputs):
        seen["program"].append(threading.current_thread().name)
        return call(self, *inputs)

    def spy_strict(*args):
        seen["strict"].append(threading.current_thread().name)
        return strict(*args)

    def spy_launch(self, batch):
        if batch.group is None:  # a partial group's batches: recorded by its trip
            seen["seqs"].append(batch.seq)
        return launch(self, batch)

    def spy_trip(self, entries):
        seen["seqs"].extend(e.seq for e in entries)
        return trip(self, entries)

    monkeypatch.setattr(tbe.Program, "__call__", spy_call)
    monkeypatch.setattr(tbe, "_strict_ext_arrays", spy_strict)
    monkeypatch.setattr(tbe.BatchRunner, "_launch", spy_launch)
    monkeypatch.setattr(tbe.BatchRunner, "_roundtrip_group", spy_trip)
    return seen


@pytest.mark.parametrize("case", list(CASES))
def test_lane_and_inline_bytes_equal_jax(case, monkeypatch):
    signal, strict, packer, upload_pack, group, depth, replicas = CASES[case]
    monkeypatch.setattr(tconstants.par, "FRAMEBUF_MULTIPLICITY", depth)
    monkeypatch.setenv("FLACENC_FETCH_GROUP", group)
    mesh = pmesh.block_mesh(["cpu"] * replicas) if replicas else None
    x = _walk(N) if signal == "walk" else _tones(N)
    want, jax_names = _jax(signal, strict)
    caller = threading.current_thread().name
    if group != "1":  # the grouped program warms on the capture thread: warm it first
        flacenc_tpu_torch.encode_with_fixed_block_size(
            tconfig.Encoder(), TMemSource(x, 2, 16, 44100), T, batch_size=2, device="cpu",
            packer=packer, strict_lpc=strict, upload_pack=upload_pack, mesh=mesh)
        tbe.wait_group_warms()
    seen = _spy(monkeypatch)
    for inline in (False, True):
        if inline:
            monkeypatch.setenv("FLACENC_INLINE_DISPATCH", "1")
        for calls in seen.values():
            calls.clear()
        stats = {}
        got = flacenc_tpu_torch.encode_with_fixed_block_size(
            tconfig.Encoder(), TMemSource(x, 2, 16, 44100), T, batch_size=2, device="cpu",
            packer=packer, strict_lpc=strict, upload_pack=upload_pack, mesh=mesh, stats=stats,
        ).to_bytes()
        assert got == want, inline
        assert stats["batches"] == 12 and stats["max_inflight"] == (
            max(depth, 3) if group == "2" else depth)
        calls = seen["program"] + seen["strict"]
        assert len(seen["program"]) == (6 if group == "2" else 12) * max(1, replicas)
        assert len(seen["strict"]) == (12 if strict else 0)
        if inline:
            assert set(calls) == {caller}
        else:
            assert all(name.startswith(LANE) for name in calls), calls
        assert seen["seqs"] == list(range(12))  # one launch each, in submit order
        names = {e[0] for e in stats["timeline"]}
        if group == "1":
            assert jax_names <= names and "issued" in names, jax_names - names
        else:
            assert {"gtrip_start", "gissued", "gfetch_done", "gasm_done"} <= names
        if upload_pack:
            assert {eval(k)[0] for k in stats["wire_batches"]} == {"r"}, stats["wire_batches"]


_FILES = [(T * 11 + 300, 44100), (T * 3 + 10, 48000), (500, 48000), (T * 5 + 1, 44100)]


def test_corpus_on_the_lane_equals_jax(monkeypatch):
    sources = [(f"f{i}", _tones(n, i), r) for i, (n, r) in enumerate(_FILES)]
    want, _ = jax_encode_corpus(
        [(name, MemSource(x, 2, 16, r)) for name, x, r in sources],
        config.Encoder().into_verified(), T, batch_size=2, mesh=None,
    )
    seen = _spy(monkeypatch)
    for inline in (False, True):
        if inline:
            monkeypatch.setenv("FLACENC_INLINE_DISPATCH", "1")
        for calls in seen.values():
            calls.clear()
        streams, stats = flacenc_tpu_torch.encode_corpus(
            [(name, TMemSource(x, 2, 16, r)) for name, x, r in sources], tconfig.Encoder(), T,
            batch_size=2, device="cpu",
        )
        assert {k: s.to_bytes() for k, s in streams.items()} == {
            k: s.to_bytes() for k, s in want.items()}
        assert seen["program"] and all(
            name.startswith(LANE) != inline for name in seen["program"])
        assert seen["seqs"] == list(range(stats.batches))


class _Boom(Exception):
    pass


def _runner_threads():
    return {t for t in threading.enumerate() if t.name.startswith("flacenc-")}


@pytest.mark.parametrize("entry", ["stream", "corpus"])
def test_program_error_on_the_lane_propagates_and_leaves_no_thread(entry, monkeypatch):
    """The third program call raises on the lane: the entry raises it as
    itself, no call ran on the caller's thread (nothing falls back to an
    inline issue), and the lane and the workers are all joined."""
    threads = []
    call = tbe.Program.__call__

    def failing(self, *inputs):
        threads.append(threading.current_thread().name)
        if len(threads) == 3:
            raise _Boom("the third program call failed")
        return call(self, *inputs)

    monkeypatch.setattr(tbe.Program, "__call__", failing)
    before = _runner_threads()
    x = _tones(N)
    with pytest.raises(_Boom, match="third program call"):
        if entry == "stream":
            flacenc_tpu_torch.encode_with_fixed_block_size(
                tconfig.Encoder(), TMemSource(x, 2, 16, 44100), T, batch_size=2, device="cpu")
        else:
            flacenc_tpu_torch.encode_corpus(
                [("a", TMemSource(x, 2, 16, 44100))], tconfig.Encoder(), T, batch_size=2,
                device="cpu")
    assert len(threads) >= 3 and all(name.startswith(LANE) for name in threads), threads
    assert not {t for t in _runner_threads() - before if t.is_alive()}


def test_inline_switched_on_mid_stream_waits_for_the_lane(monkeypatch):
    """FLACENC_INLINE_DISPATCH is read at each launch: switched on after
    some batches went to the lane, the caller issues the next one only
    once the lane has finished, so launches stay in submit order."""
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 2, "cpu", upload_pack=False)
    seen = _spy(monkeypatch)
    x = _tones(6 * T)
    blocks = x.reshape(6, T, 2).transpose(0, 2, 1).copy()
    try:
        frames = []
        for i in range(3):
            if i == 2:
                monkeypatch.setenv("FLACENC_INLINE_DISPATCH", "1")
            result = runner.submit(blocks[2 * i:2 * i + 2], np.arange(2 * i, 2 * i + 2), 44100)
            frames += result.frames if result else []
        for result in runner.drain():
            frames += result.frames
    finally:
        runner.close()
    assert seen["seqs"] == [0, 1, 2] and len(frames) == 6
    caller = threading.current_thread().name
    assert [n.startswith(LANE) for n in seen["program"]] == [True, True, False]
    assert seen["program"][2] == caller
    assert all(not t.is_alive() for t in runner._lane._threads)


def test_overlap_reads_the_issue_span():
    """The issue's busy seconds of a hand-made timeline: a launch starts at
    its `packed` mark or at the end of the lane's previous task, a group's
    round trip at `gtrip_start`, and a partial group's launches inside its
    round trip count once."""
    events = [
        ("packed", 0, 1.0), ("issued", 0, 1.5),
        ("packed", 1, 1.25), ("issued", 1, 2.0),        # queued behind batch 0
        ("packed", 2, 3.0), ("issued", 2, 3.25),
        ("packed", 3, 4.0), ("packed", 4, 4.125),       # parked, then a full group
        ("gtrip_start", 3, 4.5), ("gissued", 3, 5.0),
        ("packed", 5, 6.0), ("gtrip_start", 5, 6.5),    # a partial group of one
        ("issued", 5, 6.75), ("gissued", 5, 7.0),
    ]
    got = overlap.analyze(events, 8.0)
    assert got["issue_s"] == 0.5 + 0.5 + 0.25 + 0.5 + 0.5 and got["n_issues"] == 6


def test_runners_in_many_threads_share_the_registry(monkeypatch):
    """Twelve encodes in twelve threads at once (more threads than cores),
    the interpreter switching threads every microsecond, from an empty
    registry whose module takes 50 ms to build: they build one program for
    their one key and all call it, every forward is counted once, and each
    stream equals its encode alone."""
    import sys
    import time

    xs = [_tones(8 * T, seed) for seed in range(12)]

    def encode(x):
        return flacenc_tpu_torch.encode_with_fixed_block_size(
            tconfig.Encoder(), TMemSource(x, 2, 16, 44100), T, batch_size=2, device="cpu",
        ).to_bytes()

    want = [encode(x) for x in xs]
    monkeypatch.setattr(tbe, "_PROGRAMS", type(tbe._PROGRAMS)())
    programs = set()
    call = tbe.Program.__call__

    def spy_call(self, *inputs):
        programs.add(id(self))
        return call(self, *inputs)

    class SlowBuild(tbe.BatchEncoder):
        def __init__(self, *args, **kw):
            time.sleep(0.05)  # a registry miss in every thread at once
            super().__init__(*args, **kw)

    monkeypatch.setattr(tbe.Program, "__call__", spy_call)
    monkeypatch.setattr(tbe, "BatchEncoder", SlowBuild)
    got, errors = [None] * len(xs), []
    forwards = tbe.PROGRAM_COUNTS["forwards"]
    barrier = threading.Barrier(len(xs))

    def run(i):
        try:
            barrier.wait(30)
            got[i] = encode(xs[i])
        except BaseException as e:  # noqa: BLE001 - reported by the test thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert got == want
    assert len(tbe._PROGRAMS) == 1 and len(programs) == 1
    assert tbe.PROGRAM_COUNTS["forwards"] - forwards == len(xs) * 4
