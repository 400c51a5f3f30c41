"""The background warm (the JAX pipeline's background compile) in the port:
when the racer runs and the stream is not strict, a program the stream
meets for the first time runs once on its device's capture thread while
the batches ship on a warm wire, and a grouped program is warmed there
before batches group. All on the CPU, at a small size, held against the
JAX package's `BatchPipeline` on the same seeded blocks and config: the
warm set, the fallback wire, the wire sequence under a pinned racer and
the bytes; a warm held open, a failing warm, the shared deadline of
`wait_all_warms`, the modes without background warms, the registry's
eviction rule, the corpus and a two-replica mesh."""

import collections
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu import config  # noqa: E402
from flacenc_tpu.models import batch_encoder as jbe  # noqa: E402
from flacenc_tpu.parallel import encode_corpus as jax_encode_corpus  # noqa: E402
from flacenc_tpu.source import MemSource  # noqa: E402

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402

T = 512
CAPTURE = "flacenc-capture"


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """An empty registry and empty racers in both packages, one torch
    thread, no grouping unless a test pins it, the lane issue path."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(tbe, "_PROGRAMS", collections.OrderedDict())
    monkeypatch.setattr(tbe, "_LINK_ESTS", {})
    monkeypatch.setattr(jbe, "_LINK_ESTS", {})
    monkeypatch.setattr(jbe, "_WARMED_WIRES", set())
    monkeypatch.setattr(jbe, "_WARMED_GROUPS", set())
    monkeypatch.setenv("FLACENC_PACK_THREADS", "1")
    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    monkeypatch.delenv("FLACENC_PACKED_UPLOAD", raising=False)
    yield
    tbe.wait_all_warms()
    torch.set_num_threads(threads)


def _blocks(n: int = 8, seed: int = 9):
    rng = np.random.default_rng(seed)
    return [np.cumsum(rng.integers(-120, 121, (2, T)), -1).astype(np.int32) for _ in range(n)]


def _pin(est, fastest: str = "pack") -> None:
    """The racer's estimates with `fastest` ten times faster than the rest
    (and its switch vote one short), so that it picks `fastest` now."""
    est.secs = {"raw": 1.0, "d": 1.0, "pack": 1.0}
    est.secs[fastest] = 0.1
    est.nbytes = {k: 1_000_000 for k in est.secs}
    est.age = {k: 0 for k in est.secs}
    est.t_sample = {k: time.perf_counter() for k in est.secs}
    est.mbps = 10.0
    est._vote = (fastest, tbe._SWITCH_VOTES - 1)
    est._probe = None


class _Gate:
    """Holds the port's warms (those `held(program)` picks) until `open`."""

    def __init__(self, monkeypatch, held=lambda prog: True):
        self.event = threading.Event()
        self.held = []
        warm = tbe.Program._warm

        def gated(prog, make_inputs):
            if held(prog):
                self.held.append(prog)
                self.event.wait(60)
            return warm(prog, make_inputs)

        monkeypatch.setattr(tbe.Program, "_warm", gated)

    def open(self) -> None:
        self.event.set()

    def wait_held(self, n: int) -> bool:
        """Whether `n` warms reach the gate within 60 s."""
        deadline = time.monotonic() + 60
        while len(self.held) < n and time.monotonic() < deadline:
            time.sleep(0.01)
        return len(self.held) == n


def _jax_gate(monkeypatch) -> threading.Event:
    """Holds the JAX package's background compiles until the event is set
    (they call `_cached_encoder_fn` on a compile thread)."""
    event = threading.Event()
    build = jbe._cached_encoder_fn
    main = threading.current_thread()

    def gated(*args, **kw):
        if threading.current_thread() is not main:
            event.wait(60)
        return build(*args, **kw)

    monkeypatch.setattr(jbe, "_cached_encoder_fn", gated)
    return event


def _stream_bytes(frames) -> bytes:
    return b"".join(f.precomputed_bitstream for f in frames)


def _raw_bytes(blocks, batch=1, **kw) -> bytes:
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, batch, "cpu", upload_pack=False, **kw)
    try:
        return _drive(runner, blocks, batch)[0]
    finally:
        runner.close()


def _drive(obj, blocks, batch=1, before=None, after=None):
    """Submit `blocks` `batch` at a time to a runner or a JAX pipeline,
    calling `before(i)` and `after(i)` around submit i; returns (stream
    bytes, the wire kind of each batch)."""
    frames, kinds = [], []
    for i in range(0, len(blocks), batch):
        if before:
            before(i // batch)
        result = obj.submit(list(blocks[i:i + batch]), np.arange(i, i + batch), 44100)
        kinds.append(obj._wire_kind)
        if result:
            frames += result.frames
        if after:
            after(i // batch)
    drained = obj.drain() if isinstance(obj, tbe.BatchRunner) else obj.drain_all()
    frames += [f for result in drained for f in result.frames]
    return _stream_bytes(frames), kinds


def _first_runs():
    """wire -> the thread names that ran each registry program first."""
    out = collections.defaultdict(set)
    for prog in tbe._PROGRAMS.values():
        out[prog.key[6]].add(prog.first_run)
    return out


def _threads():
    return {t for t in threading.enumerate() if t.name.startswith("flacenc-")}


def test_async_wire_compile_fallback_equals_jax(monkeypatch):
    """The port of the JAX package's `test_async_wire_compile_fallback`,
    run beside it: the racer pinned to "pack", the first batch ships raw
    while the pre-warm set (delta16 and the scanned dense wire) warms in
    the background, equal to JAX's set; with every warm waited for after
    each batch, the wire sequence is JAX's, "pack" engages, and the bytes
    equal JAX's and the raw-only stream. No program but raw ran first on
    the lane."""
    blocks = _blocks(6)
    gate, jax_gate = _Gate(monkeypatch), _jax_gate(monkeypatch)
    pipe = jbe.BatchPipeline(config.Encoder(), 2, 16, T, 1, upload_pack="auto")
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 1, "cpu", upload_pack="auto")
    assert pipe.async_compile and runner.async_compile
    warm_sets = {}

    def after(obj, name):
        def settle(i):
            if i == 0:
                warm_sets[name] = set(obj._warming)
                gate.open() if name == "port" else jax_gate.set()
            for fut in list(obj._warming.values()) + [obj._group_warm]:
                if fut is not None:
                    fut.result(timeout=120)
        return settle

    try:
        jbytes, jkinds = _drive(pipe, blocks, before=lambda i: _pin(pipe._est),
                                after=after(pipe, "jax"))
        tbytes, tkinds = _drive(runner, blocks, before=lambda i: _pin(runner._est),
                                after=after(runner, "port"))
    finally:
        pipe.close()
        runner.close()
    assert tkinds[0] == "raw" and len(warm_sets["port"]) == 2
    assert warm_sets["port"] == warm_sets["jax"] and ("d", 2) in warm_sets["port"]
    assert tkinds == jkinds and "pack" in tkinds[1:]
    assert {repr(k): v for k, v in runner.wire_counts.items()} == \
        {repr(k): v for k, v in pipe.wire_counts.items()}
    assert tbytes == jbytes == _raw_bytes(blocks)
    runs = _first_runs()
    assert all(t.startswith("flacenc-lane") for t in runs.pop(None))
    assert runs and all(t.startswith(CAPTURE) for ts in runs.values() for t in ts), runs


def test_a_warm_held_open_ships_the_fallback(monkeypatch):
    """The dense wire's warm is held open: every batch that picks it ships
    on the fallback, raw until the runner has found delta16 warm (the racer
    asked for it once), delta16 after; a second runner finds delta16 warm
    in the registry at once and falls back to it from its first batch.
    Once the warm is released, the dense wire engages; the bytes equal the
    raw-only stream throughout."""
    blocks = _blocks(10)
    gate = _Gate(monkeypatch, held=lambda prog: prog.key[6] is not None
                 and prog.key[6][0] != "d")
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 1, "cpu", upload_pack="auto")
    second = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 1, "cpu", upload_pack="auto")
    schedule = ["pack", "pack", "pack", "d", "pack", "pack", "pack", "pack", "pack", "pack"]
    seen = {}

    def dense(r):
        return next(w for w in r._warming if w[0] != "d")

    def before(i):
        if i == 7:  # release the dense wire's warm and wait for it
            gate.open()
            tbe.wait_all_warms()
        _pin(runner._est, schedule[i])

    def after(i):
        if i == 0:
            runner._warming[("d", 2)].result(timeout=60)  # the dense one is held
            assert gate.wait_held(1)
            tbe.wait_wire_warms(timeout=0.2)  # it returns with the dense warm held
            assert not runner._warming[dense(runner)].done()
        if i == 5:  # a second runner, the dense warm still held
            _pin(second._est, "pack")
            second.submit([blocks[0]], np.arange(1), 44100)
            seen["second"] = second._wire_kind
            seen["second_bytes"] = _stream_bytes(
                [f for result in second.drain() for f in result.frames])

    try:
        got, kinds = _drive(runner, blocks, before=before, after=after)
    finally:
        gate.open()
        runner.close()
        second.close()
    assert kinds[:3] == ["raw"] * 3  # delta16 is warm, but this runner has not asked
    assert kinds[3] == "d"            # the racer picked delta16: now known warm
    assert kinds[4:7] == ["d"] * 3    # the held dense wire falls back to delta16
    assert kinds[7:] == ["pack"] * 3  # released
    assert seen["second"] == "d" and not second._warmed
    assert got == _raw_bytes(blocks)
    assert seen["second_bytes"] == _raw_bytes(blocks[:1])


def test_grouped_warm_held_open_goes_batch_by_batch(monkeypatch):
    """FLACENC_FETCH_GROUP=2 with the grouped program's warm held open:
    the batches go one by one (none on a grouped program); once it is
    released they group. The grouped program ran first on the capture
    thread, and the bytes equal the JAX package's at the same G."""
    monkeypatch.setenv("FLACENC_FETCH_GROUP", "2")
    blocks = _blocks(10, seed=4)
    gate = _Gate(monkeypatch, held=lambda prog: prog.key[10] > 0)
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 1, "cpu", upload_pack=False)
    grouped = []

    def before(i):
        if i == 4:
            assert runner.grouped_batches == 0 and gate.wait_held(1)
            gate.open()
            tbe.wait_group_warms()

    try:
        got, _ = _drive(runner, blocks, before=before,
                        after=lambda i: grouped.append(runner.grouped_batches))
    finally:
        gate.open()
        runner.close()
    assert grouped[:4] == [0] * 4 and runner.grouped_batches == 6
    pipe = jbe.BatchPipeline(config.Encoder(), 2, 16, T, 1, upload_pack=False)
    try:
        want, _ = _drive(pipe, blocks)
    finally:
        pipe.close()
        jbe.wait_group_warms()
    assert got == want == _raw_bytes(blocks)
    runs = {prog.key[10]: prog.first_run for prog in tbe._PROGRAMS.values()}
    assert runs[2].startswith(CAPTURE) and runs[0].startswith("flacenc-lane"), runs


class _Boom(Exception):
    pass


def test_a_failing_warm_raises_from_the_next_submit(monkeypatch):
    """A dense wire's warm fails on the capture thread: `wait_all_warms`
    returns its error and raises nothing, the failure is counted, the
    failed program leaves the registry, the next `submit` that asks for
    that wire raises the warm's error, and the runner closes and the
    capture threads are joined with no thread left."""
    blocks = _blocks(4)
    gate = _Gate(monkeypatch)
    build = tbe._build_module

    def failing(cfg, nch, bps, block_size, strict_lpc, wire, *args):
        if wire is not None and wire[0] != "d":
            raise _Boom(f"the warm of {wire} failed")
        return build(cfg, nch, bps, block_size, strict_lpc, wire, *args)

    monkeypatch.setattr(tbe, "_build_module", failing)
    tbe.close_capture_threads()
    before = _threads()
    failed = tbe.CAPTURE_COUNTS["warms_failed"]
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 1, "cpu", upload_pack="auto")
    try:
        _pin(runner._est)
        runner.submit([blocks[0]], np.arange(1), 44100)
        assert runner._wire_kind == "raw"
        dense = next(w for w in runner._warming if w[0] != "d")
        gate.open()
        t0 = time.monotonic()
        errors = tbe.wait_all_warms(timeout=30)
        assert time.monotonic() - t0 < 30
        assert [type(e) for e in errors] == [_Boom]
        assert tbe.CAPTURE_COUNTS["warms_failed"] == failed + 1
        assert isinstance(runner._warming[dense].exception(), _Boom)
        assert all(p.key[6] != dense for p in tbe._PROGRAMS.values())
        _pin(runner._est)
        with pytest.raises(_Boom, match="failed"):
            runner.submit([blocks[1]], np.arange(1, 2), 44100)
    finally:
        runner.close()
        tbe.close_capture_threads()
    assert not {t for t in _threads() - before if t.is_alive()}


def test_wait_all_warms_shares_one_deadline(monkeypatch):
    """Three warms held open (two wires, one group): `wait_all_warms(
    timeout=1.0)` returns after about 1 s, not 1 s a warm, raises nothing
    and synchronizes no device; released, they all finish."""
    blocks = _blocks(2)
    gate = _Gate(monkeypatch)
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a))
    monkeypatch.setenv("FLACENC_FETCH_GROUP", "2")
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 1, "cpu", upload_pack="auto")
    try:
        _pin(runner._est)
        runner.submit([blocks[0]], np.arange(1), 44100)
        pending = list(runner._warming.values()) + [runner._group_warm]
        assert len(pending) == 3 and gate.wait_held(1)
        t0 = time.monotonic()
        tbe.wait_all_warms(timeout=1.0)
        waited = time.monotonic() - t0
        assert 0.9 < waited < 2.5, waited
        assert not any(f.done() for f in pending)
        gate.open()
        for fut in pending:
            fut.result(timeout=60)
    finally:
        gate.open()
        runner.close()
    assert not syncs


@pytest.mark.parametrize("upload_pack,strict,want", [
    ("auto", False, True), ("auto", True, False), (True, False, False),
    ("delta", False, False), (False, False, False), ("env", False, False),
])
def test_background_warms_only_when_racing_and_not_strict(upload_pack, strict, want):
    """`async_compile` is the JAX package's `upload_mode == "auto" and not
    strict_lpc`: strict and forced wires first-run their programs on the
    lane, as JAX compiles them inline (on the CPU "env" does not race)."""
    pipe = jbe.BatchPipeline(config.Encoder(), 2, 16, T, 1, upload_pack=upload_pack,
                             strict_lpc=strict)
    try:
        jax_async = pipe.async_compile
    finally:
        pipe.close()
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 1, "cpu", strict_lpc=strict,
                             upload_pack=upload_pack)
    runner.close()
    assert runner.async_compile == jax_async == want


@pytest.mark.parametrize("upload_pack,kind", [(True, "w"), ("delta", "d")])
def test_forced_wires_first_run_on_the_lane(upload_pack, kind):
    """Without background warms the forced wire's program is first run on
    the lane, and no warm is queued."""
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 1, "cpu", upload_pack=upload_pack)
    try:
        _drive(runner, _blocks(3))
    finally:
        runner.close()
    assert not runner._warming and not runner._warmed
    runs = _first_runs()
    assert {w[0] for w in runs} == {kind}
    assert all(t.startswith("flacenc-lane") for ts in runs.values() for t in ts)


def test_a_warming_program_survives_eviction(monkeypatch):
    """The registry evicts its least recently used entry, but never one
    whose warm has not finished: a program held warming outlives 64 newer
    entries, and goes once its warm is done."""
    gate = _Gate(monkeypatch)
    cfg = tconfig.Encoder()
    cpu = torch.device("cpu")

    def get(rows):
        shapes = (((rows, 2, 256), "torch.int16"),)
        return tbe.program_for(cfg, 2, 16, 256, False, "native2", None, shapes, cpu)

    first = get(1)
    ready, queued = first.warm(lambda: [torch.zeros((1, 2, 256), dtype=torch.int16)])
    assert queued == [first] and first.warming()
    for rows in range(2, 2 + tbe._PROGRAM_CACHE_SIZE):
        get(rows)
    assert first.key in tbe._PROGRAMS and len(tbe._PROGRAMS) == tbe._PROGRAM_CACHE_SIZE
    assert get(2).key not in list(tbe._PROGRAMS)[:1]  # the oldest cold entry went
    gate.open()
    ready.result(timeout=60)
    assert not first.warming() and first.first_run.startswith(CAPTURE)
    get(1000)
    assert first.key not in tbe._PROGRAMS


def _walk(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.zeros(2 * n, np.int32)
    for ch in range(2):
        x[ch::2] = np.clip(np.cumsum(rng.integers(-90, 91, n)), -30000, 30000)
    return x


def test_auto_stream_equals_jax_and_first_runs_off_the_lane():
    """The whole slice: `encode_with_fixed_block_size` with the racer on
    (upload_pack="auto") gives the JAX package's bytes, and every program
    but raw ran first on the capture thread; the report splits the
    captures by thread (none on the CPU)."""
    x = _walk(T * 13 + 77, seed=5)
    jcfg = config.Encoder().into_verified()
    want = jbe.encode_with_fixed_block_size(jcfg, MemSource(x, 2, 16, 44100), T, batch_size=2,
                                            mesh=None).to_bytes()
    stats = {}
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        tconfig.Encoder.from_dict(jcfg.inner.to_dict()), TMemSource(x, 2, 16, 44100), T,
        batch_size=2, device="cpu", upload_pack="auto", stats=stats).to_bytes()
    assert got == want
    runs = _first_runs()
    assert all(t.startswith("flacenc-lane") for t in runs.pop(None))
    assert runs and all(t.startswith(CAPTURE) for ts in runs.values() for t in ts), runs
    assert (stats["captures"], stats["captures_background"]) == (0, 0)
    assert stats["capture_s"] == stats["capture_background_s"] == 0.0


def test_corpus_prewarms_once_and_later_files_find_programs_warm(monkeypatch):
    """`encode_corpus` with the racer on: its one runner pre-warms on the
    first file's first batch only, every program but raw runs first on the
    capture thread, and the streams equal the JAX package's corpus."""
    files = [_walk(T * n + 33, seed=s) for n, s in ((7, 1), (5, 2), (6, 3))]
    prewarms = []
    prewarm = tbe.BatchRunner._prewarm
    monkeypatch.setattr(tbe.BatchRunner, "_prewarm",
                        lambda self, chunk: (prewarms.append(1), prewarm(self, chunk))[1])
    want, _ = jax_encode_corpus([(f"f{i}", MemSource(x, 2, 16, 44100))
                                 for i, x in enumerate(files)],
                                config.Encoder().into_verified(), T, batch_size=2, mesh=None)
    streams, stats = flacenc_tpu_torch.encode_corpus(
        [(f"f{i}", TMemSource(x, 2, 16, 44100)) for i, x in enumerate(files)],
        tconfig.Encoder(), T, batch_size=2, device="cpu", upload_pack="auto")
    assert {k: s.to_bytes() for k, s in streams.items()} == {
        k: s.to_bytes() for k, s in want.items()}
    assert prewarms == [1]
    runs = _first_runs()
    assert all(t.startswith("flacenc-lane") for t in runs.pop(None))
    assert runs and all(t.startswith(CAPTURE) for ts in runs.values() for t in ts), runs
    assert stats.captures_background == 0  # eager on the CPU: no graph


def test_a_mesh_program_is_ready_when_every_replica_is(monkeypatch):
    """Over a two-replica mesh a warm warms both replicas, and the sharded
    program is ready only once both are: with replica 1's warm held, the
    dense wire falls back while replica 0 is ready; released, it engages.
    The bytes equal the raw-only stream."""
    m = pmesh.block_mesh(["cpu"] * 2)
    gate = _Gate(monkeypatch, held=lambda prog: prog.key[6] is not None
                 and prog.key[6][0] != "d" and prog.replica[1] == 1)
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 2, "cpu", mesh=m, upload_pack="auto")
    blocks = _blocks(8, seed=6)
    seen = {}

    def after(i):
        if i == 0:
            dense = next(w for w in runner._warming if w[0] != "d")
            sharded = runner._programs[next(k for k in runner._programs if k[0] == dense)]
            sharded.replicas[0].ready.result(timeout=60)
            seen["replicas"] = [r.ready.done() for r in sharded.replicas]
            seen["ready"] = sharded.ready.done()
        if i >= 1:  # released after the second batch; each new wire waited for
            gate.open()
            tbe.wait_all_warms()

    try:
        got, kinds = _drive(runner, blocks, batch=2, before=lambda i: _pin(runner._est),
                            after=after)
    finally:
        gate.open()
        runner.close()
    assert seen == {"replicas": [True, False], "ready": False}
    assert kinds[:2] == ["raw", "raw"] and "pack" in kinds[2:]
    assert got == _raw_bytes(blocks, batch=2)
    assert {p.replica[1] for p in tbe._PROGRAMS.values() if p.key[6] is not None} == {0, 1}


@pytest.mark.parametrize("group", ["1", "2"])
def test_every_forward_serves_a_batch_or_a_warm(group, monkeypatch):
    """The forward counts the launch checks are held to: with the racer on
    (and G = 2), every forward a stream runs is one of its batches' or one
    its warms ran off the lane, counted in `warm_forwards`; the bytes equal
    the JAX package's."""
    monkeypatch.setenv("FLACENC_FETCH_GROUP", group)
    x = _walk(T * 11 + 5, seed=8)
    jcfg = config.Encoder().into_verified()
    want = jbe.encode_with_fixed_block_size(jcfg, MemSource(x, 2, 16, 44100), T, batch_size=2,
                                            mesh=None).to_bytes()
    jbe.wait_all_warms()
    tbe.wait_all_warms()
    before = dict(tbe.PROGRAM_COUNTS)
    stats = {}
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        tconfig.Encoder.from_dict(jcfg.inner.to_dict()), TMemSource(x, 2, 16, 44100), T,
        batch_size=2, device="cpu", upload_pack="auto", stats=stats).to_bytes()
    assert tbe.wait_all_warms() == []
    forwards = tbe.PROGRAM_COUNTS["forwards"] - before["forwards"]
    warm = tbe.PROGRAM_COUNTS["warm_forwards"] - before["warm_forwards"]
    assert warm >= 2 and forwards == stats["batches"] + warm, (forwards, warm, stats["batches"])
    assert got == want


def test_a_card_program_is_made_under_the_registry_lock_without_deadlock():
    """`program_for` makes a card program (one that captures, with its
    memory pool's lock) while it holds the registry lock: making it takes
    no lock of the registry's, so it returns at once, and two programs of
    one replica share their pool lock. Nothing touches a card here: the
    module is built at first use."""
    cfg = tconfig.Encoder()
    cuda = torch.device("cuda", 0)
    made = []

    def make(rows):
        shapes = (((rows, 2, 256), "torch.int16"),)
        made.append(tbe.program_for(cfg, 2, 16, 256, False, "native2", None, shapes, cuda))

    thread = threading.Thread(target=lambda: [make(1), make(2)], daemon=True)
    thread.start()
    thread.join(30)
    assert not thread.is_alive(), "program_for deadlocked making a card program"
    assert [p.capture for p in made] == [True, True] and made[0]._module is None
    assert made[0].pool_lock is made[1].pool_lock
