"""The process's pinned staging pool (``batch_encoder.StagingPool``), on the
CPU with events faked (anything with `query()` and `synchronize()`): a slot
is not handed out again while its last copy is pending, distinct (device,
shape, dtype) keys never share a slot, at the cap an acquisition waits on
the slot released first, an output slot comes back after its batch's
assembly, a later runner reuses an earlier one's slots, the keys kept are
bounded, and threads never hold one slot at once. The card's staged path,
run on the CPU (slots unpinned, no events), gives the unstaged path's bytes
on every packer, wire, G, strict and a mesh, and its counts reach `stats`;
without it they stay 0. A slot's fill copies contiguous and strided
sources alike. The host splits of the downloaded outputs never
alias the buffer they read."""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch import native, sigen  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from flacenc_tpu_torch.source import MemSource  # noqa: E402

CPU = torch.device("cpu")
SHAPE = (4, 2, 64)
T = 256


class FakeEvent:
    """A copy that is pending until `done`, or until someone waits on it."""

    def __init__(self, done=False):
        self.done = done
        self.waits = 0

    def query(self):
        return self.done

    def synchronize(self):
        self.waits += 1
        self.done = True


@pytest.fixture
def pool(monkeypatch):
    """A fresh pool in the runners' place."""
    fresh = tbe.StagingPool()
    monkeypatch.setattr(tbe, "_STAGING", fresh)
    return fresh


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in ("FLACENC_PACKED_UPLOAD", "FLACENC_FETCH_GROUP", "FLACENC_INLINE_DISPATCH",
                 "FLACENC_STRICT_LPC", "FLACENC_TIMELINE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("FLACENC_PACK_THREADS", "1")


def _runner(**kw):
    return tbe.BatchRunner(tconfig.Encoder(), 2, 16, T, 2, "cpu", mesh=None, **kw)


def test_a_pending_slot_is_not_handed_out_until_its_event_completes(pool):
    first, how = pool.acquire(CPU, SHAPE, torch.int16, cap=3)
    assert how == "allocated" and first.held
    copy = FakeEvent()
    pool.release(first, [copy])
    second, how = pool.acquire(CPU, SHAPE, torch.int16, cap=3)
    assert how == "allocated" and second is not first
    pool.release(second, [FakeEvent()])
    copy.done = True
    again, how = pool.acquire(CPU, SHAPE, torch.int16, cap=3)
    assert (again, how) == (first, "reused") and copy.waits == 0
    assert again.events == ()  # a handed-out slot carries no stale events


@pytest.mark.parametrize("other", [
    ("meta", SHAPE, torch.int16), ("cpu", (4, 2, 32), torch.int16),
    ("cpu", SHAPE, torch.int32), ("cpu", (2, 4, 64), torch.int16),
], ids=["device", "shape", "dtype", "same_size"])
def test_distinct_keys_never_share_a_slot(pool, other):
    # the device only names the key here: a buffer is pinned for a card alone
    a, _ = pool.acquire(CPU, SHAPE, torch.int16, cap=3)
    pool.release(a)
    b, how = pool.acquire(torch.device(other[0]), other[1], other[2], cap=3)
    assert how == "allocated" and b is not a and b.tensor.data_ptr() != a.tensor.data_ptr()
    assert tuple(b.tensor.shape) == other[1] and b.tensor.dtype == other[2]
    c, how = pool.acquire(CPU, SHAPE, torch.int16, cap=3)
    assert (c, how) == (a, "reused")


def test_at_the_cap_an_acquisition_waits_on_the_oldest_slot(pool):
    runner = _runner()
    try:
        slots, events = [], []
        for _ in range(runner.staging_cap):
            slots.append(runner._stage(SHAPE, torch.int16))
        for slot in slots:
            events.append(FakeEvent())
            tbe._STAGING.release(slot, [events[-1]])
        got = runner._stage(SHAPE, torch.int16)
        assert got is slots[0] and events[0].waits == 1
        assert all(e.waits == 0 for e in events[1:])
        assert runner.report()["staging_waited"] == 1
        assert runner.report()["staging_allocated"] == runner.staging_cap
        assert runner.report()["staging_reused"] == 1
    finally:
        runner.close()


def test_with_every_slot_held_the_key_grows_past_the_cap(pool):
    held = [pool.acquire(CPU, SHAPE, torch.int16, cap=2)[0] for _ in range(3)]
    assert len({id(s) for s in held}) == 3
    pool.release(held[1], [FakeEvent()])
    slot, how = pool.acquire(CPU, SHAPE, torch.int16, cap=2)
    assert (slot, how) == (held[1], "waited")


def test_an_output_slot_comes_back_only_after_its_assembly(pool, monkeypatch):
    runner = _runner(packer="python")
    try:
        slot = runner._stage((2, 9), torch.int32)
        errors = runner._stage((2, 2, T), torch.int16)
        seen = []

        def assemble(enc, *args):
            # a rival acquisition of the same key meanwhile gets another slot
            rival, _ = tbe._STAGING.acquire(CPU, (2, 9), torch.int32, cap=9)
            seen.append((slot.held, errors.held, rival is not slot))
            tbe._STAGING.release(rival)
            return []

        monkeypatch.setattr(runner, "assemble", assemble)
        monkeypatch.setattr(tbe, "split_encoded", lambda *a: None)
        batch = tbe._Batch(np.zeros((2, 2, T), np.int32), np.arange(2), 44100, None, (), None,
                           "raw", 0, 0)
        batch.outputs, batch.staged = (slot.tensor, errors.tensor), [slot, errors]
        assert [frames for frames, _ in runner._fetch_assemble([batch])] == [[]]
        assert seen == [(True, True, True)]
        assert not slot.held and not errors.held and batch.staged is None
    finally:
        runner.close()


def test_close_gives_back_the_slots_of_batches_never_assembled(pool):
    runner = _runner()
    slot = runner._stage(SHAPE, torch.int16)
    batch = tbe._Batch(np.zeros((2, 2, T), np.int32), np.arange(2), 44100, None, (), None,
                       "raw", 0, 0)
    batch.staged = [slot]
    runner._inflight.append(batch)
    runner.close()
    assert not slot.held


def test_a_later_runner_reuses_an_earlier_runners_slots(pool):
    first = _runner()
    slots = [first._stage(SHAPE, torch.int16), first._stage((2, 9), torch.int32)]
    for slot in slots:
        tbe._STAGING.release(slot, [FakeEvent(done=True)])
    first.close()
    second = _runner()
    try:
        again = [second._stage(SHAPE, torch.int16), second._stage((2, 9), torch.int32)]
        assert again == slots
        counts = second.report()
        assert (counts["staging_reused"], counts["staging_allocated"],
                counts["staging_waited"]) == (2, 0, 0)
    finally:
        second.close()


def test_keys_beyond_the_bound_drop_the_least_recent_idle_one(pool, monkeypatch):
    monkeypatch.setattr(tbe, "_STAGING_KEYS", 2)
    a, _ = pool.acquire(CPU, (1, 8), torch.int16, cap=3)  # held: never dropped
    b, _ = pool.acquire(CPU, (2, 8), torch.int16, cap=3)
    pool.release(b)
    pool.acquire(CPU, (3, 8), torch.int16, cap=3)
    assert [k[1] for k in pool._slots] == [(1, 8), (3, 8)]
    pool.release(a)  # its key is kept
    assert pool.acquire(CPU, (1, 8), torch.int16, cap=3) == (a, "reused")


def test_threads_never_hold_one_slot_at_once(pool):
    """More threads than cores acquire and release one key under a short
    switch interval: a slot handed to two holders at once would show as an
    owner overwritten."""
    owners, clash, stop = {}, [], threading.Event()

    def work(i):
        while not stop.is_set():
            slot, _ = pool.acquire(CPU, (2, 16), torch.int32, cap=3)
            if owners.setdefault(id(slot), i) != i:
                clash.append(id(slot))
            owners.pop(id(slot), None)
            pool.release(slot, [FakeEvent(done=bool(i % 2))])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        stop.wait(1.0)
        stop.set()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not clash


def _tones(n, seed):
    x = np.zeros(2 * n, np.int32)
    for ch in range(2):
        x[ch::2] = sigen.Sine(90 + 7 * seed + ch, 0.4).noise_with_seed(seed + ch, 0.02) \
            .to_vec_quantized(16, n)
    return x


def _walk(n, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros(2 * n, np.int32)
    for ch in range(2):
        x[ch::2] = np.clip(np.cumsum(rng.integers(-40, 41, n)), -30000, 30000)
    return x


class _StagedRunner(tbe.BatchRunner):
    """A CPU runner on the card's staged path: slots of the pool (unpinned
    on the CPU) for the uploads and the outputs, and no events."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.on_cuda = True


N = T * 2 * 7 + 77  # 7 batches of 2, and a tail


@pytest.mark.parametrize("packer,up,group,strict,mesh", [
    ("auto", False, "0", False, None), ("auto", "delta", "0", False, None),
    ("auto", True, "0", False, None), ("auto", False, "2", False, None),
    ("auto", False, "0", True, None), ("native", False, "0", False, None),
    ("python", False, "0", False, None), ("auto", True, "0", False, 2),
], ids=["raw", "delta16", "dense", "group2", "strict", "native", "python", "mesh2"])
def test_staged_path_gives_the_unstaged_bytes(pool, monkeypatch, packer, up, group, strict,
                                              mesh):
    if packer != "python" and not native.available():
        pytest.skip("the native library does not load")
    monkeypatch.setenv("FLACENC_FETCH_GROUP", group)
    cfg = tconfig.Encoder()
    kw = dict(batch_size=2, device="cpu", packer=packer, strict_lpc=strict, upload_pack=up,
              mesh=pmesh.block_mesh(["cpu"] * mesh) if mesh else None)
    signals = [_tones(N, 1), _walk(N, 2), _tones(N, 3)]
    plain = [flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), T, **kw).to_bytes() for x in signals]
    if group != "0":
        tbe.wait_all_warms()
    monkeypatch.setattr(tbe, "BatchRunner", _StagedRunner)
    allocated = 0
    for x, want in zip(signals, plain):
        stats = {}
        got = flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg, MemSource(x, 2, 16, 44100), T, stats=stats, **kw).to_bytes()
        assert got == want
        # at least an upload and an output slot a batch (a group's: for G batches)
        assert stats["staging_reused"] + stats["staging_allocated"] >= stats["batches"] > 0
        assert stats["staging_waited"] == 0  # nothing pending on the CPU
        allocated += stats["staging_allocated"]
    assert stats["staging_reused"] > 0
    # uploads go back at once, the outputs after their assembly: a few
    # slots a key serve every call
    keys = len(pool._slots)
    assert allocated == sum(len(v) for v in pool._slots.values())
    assert allocated <= keys * (tbe.constants.par.FRAMEBUF_MULTIPLICITY + 2)
    assert not any(s.held for v in pool._slots.values() for s in v)


def test_staging_counts_stay_zero_on_the_cpu(pool):
    stats = {}
    flacenc_tpu_torch.encode_with_fixed_block_size(
        tconfig.Encoder(), MemSource(_tones(N, 1), 2, 16, 44100), T, batch_size=2,
        device="cpu", stats=stats)
    assert (stats["staging_reused"], stats["staging_allocated"],
            stats["staging_waited"]) == (0, 0, 0)
    assert stats["batches"] > 0 and not pool._slots


@pytest.mark.parametrize("make", [
    lambda r: r.integers(-9, 9, (4, 2, 64)).astype(np.int16),
    lambda r: r.integers(-9, 9, (4, 64, 2)).astype(np.int16).transpose(0, 2, 1),
    lambda r: r.integers(0, 1 << 32, (4, 2, 16), dtype=np.uint32),
    lambda r: r.random((4, 2, 64))[:, :, ::2],
    lambda r: np.zeros((0, 2, 64), np.int32),
], ids=["int16", "strided", "uint32", "f64_step", "empty"])
def test_fill_copies_every_source_layout(make):
    a = tbe._program_array(make(np.random.default_rng(7)))
    slot = torch.full(a.shape, 99, dtype=tbe._torch_dtype(a.dtype))
    tbe._fill(slot, a)
    assert np.array_equal(slot.numpy(), a)


@pytest.mark.parametrize("rows", [1, 4])
def test_host_splits_never_alias_the_downloaded_buffer(rows):
    C = 2
    width = 1 + C * (5 + tbe.constants.qlpc.MAX_ORDER + 4)
    rng = np.random.default_rng(rows)
    wire = rng.integers(0, 2, (rows, width + C)).astype(np.int32)
    errors = rng.integers(-9, 9, (rows, C, T)).astype(np.int16)
    dec = tbe.split_decisions(wire[:, :-C], C)
    enc = tbe.split_encoded(wire, errors, C)
    for field in list(dec) + list(enc):
        assert not np.shares_memory(field, wire) and not np.shares_memory(field, errors)
        assert field.flags.c_contiguous
    assert np.array_equal(enc.errors, errors)
