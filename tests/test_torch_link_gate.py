"""The link gate in front of the upload-wire racer (`batch_encoder.link_gate`):
its decision as a pure function, the process-wide cost tables it reads
(`Costs`: the link's seconds a byte per card, fed by event-timed uploads of
every wire, and the caller's pack seconds per kind), the runner's link
counters, and on the CPU: no link is ever measured there, so the racer
decides every batch as before; the forced wires are never gated; and a gate
forced closed or open by a planted measurement changes no byte, on one
device or over a mesh of 2 and 4. All on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch import device as tdevice  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402

MIB = 1 << 20
BLOCK, BATCH = 1024, 4


# ---------------------------------------------------------------------------
# the decision
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("link_bps,raw_bytes,pack_s,raw", [
    (20e9, MIB, {"d": 0.7e-3, "pack": 3e-3}, True),      # a PCIe card: 52 us against 0.7 ms
    (100e6, MIB, {"d": 0.7e-3, "pack": 3e-3}, False),    # a slow link: 10.5 ms
    (2e9, 2 * MIB, {"d": 0.7e-3, "pack": 3e-3}, False),  # 1.05 ms: delta16 packs sooner
    (2e9, 2 * MIB, {"pack": 3e-3}, True),                # without delta16 raw still wins
    (None, MIB, {"d": 0.7e-3}, False),                   # the link unmeasured
    (0.0, MIB, {"d": 0.7e-3}, False),
    (20e9, MIB, {}, False),                              # no pack measured
    (MIB / 1e-3, MIB, {"d": 1e-3}, False),               # borderline: equal is not below
    (MIB / 0.999e-3, MIB, {"d": 1e-3}, True),            # just below
], ids=["fast", "slow", "delta_beats", "int32_fast", "link_unmeasured", "link_zero",
        "packs_unmeasured", "borderline_equal", "borderline_below"])
def test_gate_decision(link_bps, raw_bytes, pack_s, raw):
    assert tbe.link_gate(link_bps, raw_bytes, pack_s) is raw


@pytest.mark.parametrize("samples,want", [
    ([1.0], 1.0),
    ([1.0, 0.25], 0.5),        # an improvement is adopted at once, capped at 2x the sample
    ([1.0, 0.01], 0.02),
    ([0.5, 4.0], 2 ** 0.5),    # a stall moves it halfway in log
    ([1.0, 0.0, -1.0], 1.0),   # no sample at or below zero
], ids=["first", "improve", "improve_capped", "stall", "ignored"])
def test_costs_settle_like_the_racer(samples, want):
    costs = tbe.Costs()
    for s in samples:
        costs.note("k", s)
    assert costs.get("k") == pytest.approx(want, rel=1e-12)
    assert costs.get("other") is None


# ---------------------------------------------------------------------------
# the link estimate, fed by event readings of every wire
# ---------------------------------------------------------------------------

class _Event:
    """Stands in for a timing CUDA event: `elapsed_time` in ms, as torch's."""

    def __init__(self, ms=0.0):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def _timing(dev, nbytes, seconds):
    return tdevice.LinkTiming(dev, nbytes, _Event(0.0), _Event(seconds * 1e3))


@pytest.fixture
def fresh(monkeypatch):
    """Empty cost tables for the test (the process keeps its own)."""
    monkeypatch.setattr(tbe, "_LINK_COSTS", tbe.Costs())
    monkeypatch.setattr(tbe, "_PACK_COSTS", tbe.Costs())
    monkeypatch.delenv("FLACENC_PACKED_UPLOAD", raising=False)
    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    monkeypatch.setattr(tbe, "_LINK_ESTS", {})


def _runner(devices=None, **kw):
    r = tbe.BatchRunner(tconfig.Encoder(), 2, 16, BLOCK, BATCH, "cpu", **kw)
    if devices is not None:
        r.devices = tuple(torch.device(d) for d in devices)
    return r


@pytest.mark.parametrize("devices,want_gbps", [
    (["cuda:0"], 20.0), (["cuda:1"], 10.0), (["cuda:0", "cuda:1"], 20.0),
    (["cuda:0", "cuda:0"], 20.0), (["cuda:0", "cuda:2"], None), (["cpu"], None),
], ids=["card0", "card1", "mesh_slowest_share", "mesh_one_card_twice", "mesh_unmeasured",
        "cpu"])
def test_link_estimate_per_card_from_mixed_wires(fresh, devices, want_gbps):
    """Readings from a raw batch (1 MiB) and packed ones (0.4 MiB, 0.3 MiB)
    at one bandwidth give that bandwidth: the link does not depend on the
    wire. Over a mesh each card takes its shards' share and the slowest
    share sets the batch's bandwidth; a card never read leaves it unknown."""
    feeder = _runner()
    try:
        feeder._note_link([_timing("cuda:0", MIB, MIB / 20e9),
                           _timing("cuda:1", 400_000, 400_000 / 10e9)])
        feeder._note_link([_timing("cuda:0", 400_000, 400_000 / 20e9)])
        feeder._note_link([_timing("cuda:0", 300_000, 300_000 / 20e9),
                           _timing("cuda:1", MIB, MIB / 10e9)])
        feeder._note_link(())
        report = feeder.report()
        assert report["link_bytes"] == 2 * MIB + 1_100_000
        assert report["link_s"] == pytest.approx(
            (MIB + 700_000) / 20e9 + (MIB + 400_000) / 10e9, rel=1e-9)
    finally:
        feeder.close()
    r = _runner(devices)
    try:
        got = r._link_bps()
    finally:
        r.close()
    if want_gbps is None:
        assert got is None
    else:
        assert got / 1e9 == pytest.approx(want_gbps, rel=1e-9)


def test_collect_uploads_off_a_card_records_nothing():
    x = torch.zeros(1024, dtype=torch.int16)
    with tdevice.timed_upload(torch.device("cuda", 0), [x]):
        pass  # no collector: nothing recorded, no CUDA call
    with tdevice.collect_uploads() as timings:
        with tdevice.timed_upload(torch.device("cpu"), [x]):
            pass
        with tdevice.collect_uploads() as inner:
            pass
    assert timings == [] and inner == []


# ---------------------------------------------------------------------------
# on the encode path
# ---------------------------------------------------------------------------

def _smooth(n=BLOCK * BATCH * 3 + 333, seed=6):
    """A random walk in stereo (interleaved), which the dense and delta16
    wires both pack."""
    rng = np.random.default_rng(seed)
    x = np.zeros(2 * n, np.int32)
    for ch in range(2):
        x[ch::2] = np.clip(np.cumsum(rng.integers(-300, 301, n)), -30000, 30000)
    return x


def _encode(x, mesh=None, batch=BATCH, **kw):
    stats = {}
    data = flacenc_tpu_torch.encode_with_fixed_block_size(
        tconfig.Encoder().into_verified(), TMemSource(x, 2, 16, 44100), BLOCK,
        batch_size=batch, device="cpu", stats=stats, mesh=mesh, **kw).to_bytes()
    return data, stats


def _kinds(stats):
    return {None if k == "None" else eval(k)[0] for k in stats["wire_batches"]}


def _plant(link_s_per_byte, pack_s=1e-3):
    """A measured link on the CPU and measured packs of this shape: what a
    card would have read."""
    tbe._LINK_COSTS.note("cpu", link_s_per_byte)
    key = (tbe._shape_bucket(BATCH * 2 * BLOCK), 16)
    for kind in ("d", "pack"):
        tbe._PACK_COSTS.note(key + (kind,), pack_s)


def _count_choices(monkeypatch):
    calls = []
    choose = tbe.LinkEstimator.choose

    def counted(self, kinds, current):
        calls.append(current)
        return choose(self, kinds, current)

    monkeypatch.setattr(tbe.LinkEstimator, "choose", counted)
    return calls


def test_cpu_racer_asks_for_every_batch_though_packs_are_measured(fresh, monkeypatch):
    """On the CPU nothing times a link, so with packs measured by a forced
    encode the gate stays open: "auto" asks the racer for every batch and
    warms the packed wires on the first, as before the gate."""
    x = _smooth()
    _encode(x, upload_pack=True)
    _encode(x, upload_pack="delta")
    key = (tbe._shape_bucket(BATCH * 2 * BLOCK), 16)
    assert tbe._PACK_COSTS.get(key + ("pack",)) > 0 and tbe._PACK_COSTS.get(key + ("d",)) > 0
    assert tbe._LINK_COSTS.get("cpu") is None
    calls = _count_choices(monkeypatch)
    prewarms = []
    prewarm = tbe.BatchRunner._prewarm
    monkeypatch.setattr(tbe.BatchRunner, "_prewarm",
                        lambda self, chunk: prewarms.append(1) or prewarm(self, chunk))
    data, stats = _encode(x, upload_pack="auto")
    tbe.wait_all_warms()
    assert len(calls) == stats["batches"] > 1 and prewarms == [1]
    assert (stats["link_bytes"], stats["link_s"]) == (0, 0.0)
    assert stats["upload_raw_batches"] == stats["wire_batches"].get("None", 0)
    assert data == _encode(x, upload_pack=False)[0]


@pytest.mark.parametrize("up,env,want", [
    (True, None, {"w"}), ("delta", None, {"d"}), (False, None, {None}),
    ("env", "1", {"w"}), ("env", "d", {"d"}), ("env", "0", {None}),
], ids=["dense", "delta16", "raw", "env_dense", "env_delta16", "env_raw"])
def test_forced_wires_are_never_gated(fresh, monkeypatch, up, env, want):
    """With the gate planted shut (a link far faster than any pack), every
    forced mode still ships its own wire, and the bytes are raw's."""
    if env is not None:
        monkeypatch.setenv("FLACENC_PACKED_UPLOAD", env)
    _plant(link_s_per_byte=1e-12)
    calls = _count_choices(monkeypatch)
    x = _smooth()
    data, stats = _encode(x, upload_pack=up)
    assert _kinds(stats) == want and not calls
    assert stats["upload_raw_batches"] == (stats["batches"] if want == {None} else 0)
    monkeypatch.delenv("FLACENC_PACKED_UPLOAD", raising=False)
    assert data == _encode(x, upload_pack=False)[0]


@pytest.mark.parametrize("gate", ["closed", "open"])
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_gate_closed_or_open_gives_raw_bytes(fresh, monkeypatch, gate, n_dev):
    """A planted fast link (closed) ships every batch raw without asking
    the racer and warms no packed wire; a planted slow link (open) asks the
    racer for every batch. Either way, on one device or over a CPU mesh of
    2 and 4 replicas, the bytes equal the raw encode's."""
    _plant(link_s_per_byte=1e-12 if gate == "closed" else 1e-3)
    calls = _count_choices(monkeypatch)
    prewarms = []
    prewarm = tbe.BatchRunner._prewarm
    monkeypatch.setattr(tbe.BatchRunner, "_prewarm",
                        lambda self, chunk: prewarms.append(1) or prewarm(self, chunk))
    mesh = pmesh.block_mesh(["cpu"] * n_dev) if n_dev > 1 else None
    x = _smooth()
    data, stats = _encode(x, mesh=mesh, upload_pack="auto")
    tbe.wait_all_warms()
    if gate == "closed":
        assert not calls and not prewarms
        assert stats["wire_batches"] == {"None": stats["batches"]}
        assert stats["upload_raw_batches"] == stats["batches"] > 1
    else:
        assert len(calls) == stats["batches"] and prewarms == [1]
    assert data == _encode(x, upload_pack=False)[0]


def test_racer_packs_feed_the_pack_costs_and_close_the_gate(fresh, monkeypatch):
    """A cold process with a fast link: the racer's explored batches time
    their packs, and once a pack is measured the gate ships raw. The first
    batch's warm scans feed nothing."""
    tbe._LINK_COSTS.note("cpu", 1e-12)
    prewarm = tbe.BatchRunner._prewarm
    seen = []

    def watched(self, chunk):
        prewarm(self, chunk)
        seen.append(dict(tbe._PACK_COSTS._costs))

    monkeypatch.setattr(tbe.BatchRunner, "_prewarm", watched)
    r = _runner(upload_pack="auto")
    # the racer explores delta16 once raw has a gap (its gaps on the CPU
    # are slow enough); drive it so: raw measured, a link under 400 MB/s
    r._est.update(10_000, 1.0, "raw")
    x = _smooth().reshape(-1, 2)
    blocks = [x[i * BLOCK:(i + 1) * BLOCK].T.copy() for i in range(3 * BATCH)]
    kinds = []
    try:
        for b in range(3):
            r.submit(blocks[b * BATCH:(b + 1) * BATCH], np.arange(b * BATCH, (b + 1) * BATCH),
                     44100)
            kinds.append(r._wire_kind)
        list(r.drain())
    finally:
        r.close()
        tbe.wait_all_warms()
    assert seen == [{}]
    key = (tbe._shape_bucket(BATCH * 2 * BLOCK), 16, "d")
    assert tbe._PACK_COSTS.get(key) > 0
    assert kinds[-1] == "raw" and r.stats["upload_raw_batches"] >= 1


@pytest.mark.parametrize("bps,itemsize,raw_bytes", [(16, 4, 2), (16, 2, 2), (24, 4, 4)])
def test_raw_bytes_the_gate_prices(fresh, monkeypatch, bps, itemsize, raw_bytes):
    """The gate prices raw as it ships: int16 at 16 bits, int32 above."""
    seen = []
    monkeypatch.setattr(tbe, "link_gate", lambda bps_, n, pack_s: seen.append(n) or False)
    r = tbe.BatchRunner(tconfig.Encoder(), 2, bps, BLOCK, BATCH, "cpu", upload_pack="auto")
    try:
        r._raw_wins(np.zeros((BATCH, 2, BLOCK), np.dtype(f"int{8 * itemsize}")))
    finally:
        r.close()
    assert seen == [BATCH * 2 * BLOCK * raw_bytes]
