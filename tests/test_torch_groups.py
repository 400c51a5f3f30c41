"""Port parity for grouped round trips and the program registry, and the
wires of the hi-res and strict paths: FLACENC_FETCH_GROUP=G (G = 2, 4)
gives the JAX package's stream of the same G and the raw stream; a
grouped `BatchEncoder` returns the per-batch outputs stacked; the 24-bit
rice wire and strict mode under a packed wire give the JAX package's
bytes; the registry hands out one program per key, LRU-bounded, eager on
the CPU. All on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu.component import decode_stream, parse_stream  # noqa: E402
from flacenc_tpu.models import batch_encoder as jbe  # noqa: E402

from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402

from test_torch_wires import encode_pair, port_bytes  # noqa: E402


def _walk(n: int, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.zeros(2 * n, np.int32)
    for ch in range(2):
        x[ch::2] = np.clip(np.cumsum(rng.integers(-120, 121, n)), -30000, 30000)
    return x


@pytest.mark.parametrize("group", [2, 4])
def test_grouped_round_trips_equal_jax_same_group_and_raw(group, monkeypatch):
    """11 blocks at batch 1: full groups through one stacked forward each,
    the partial tail group batch by batch; bytes equal JAX's same G and the
    ungrouped encode."""
    x = _walk(512 * 11 + 77)
    monkeypatch.setenv("FLACENC_FETCH_GROUP", str(group))
    # the grouped program warms on the capture thread; warm it first, so
    # that every batch of the encode below groups
    port_bytes(x, 2, 16, block_size=512, batch_size=1, upload_pack=False)
    tbe.wait_group_warms()
    try:
        tbytes, tstats, jbytes, _ = encode_pair(x, 2, 16, block_size=512, batch_size=1,
                                                upload_pack=False)
    finally:
        jbe.wait_group_warms()
    assert tstats["grouped_batches"] == 11 and tstats["batches"] == 11
    assert tbytes == jbytes
    monkeypatch.setenv("FLACENC_FETCH_GROUP", "1")
    stats = {}
    assert tbytes == port_bytes(x, 2, 16, block_size=512, batch_size=1, upload_pack=False,
                                stats=stats)
    assert stats["grouped_batches"] == 0
    assert np.array_equal(decode_stream(parse_stream(tbytes)), x)


def test_grouped_packed_wire_equals_raw(monkeypatch):
    """G = 2 over the rice wire: the group stacks the wire payloads."""
    n = 512 * 6
    t = np.arange(n, dtype=np.float64)
    x = np.zeros(2 * n, np.int32)
    x[0::2] = np.round(15000 * np.sin(2 * np.pi * 180 / 44100 * t))
    x[1::2] = np.round(12000 * np.sin(2 * np.pi * 300 / 44100 * t))
    monkeypatch.setenv("FLACENC_FETCH_GROUP", "2")
    port_bytes(x, 2, 16, block_size=512, batch_size=1, upload_pack=True)  # warms the group
    tbe.wait_group_warms()
    stats = {}
    got = port_bytes(x, 2, 16, block_size=512, batch_size=1, upload_pack=True, stats=stats)
    assert stats["grouped_batches"] == 6
    assert all(k != "None" for k in stats["wire_batches"]), stats["wire_batches"]
    monkeypatch.setenv("FLACENC_FETCH_GROUP", "1")
    assert got == port_bytes(x, 2, 16, block_size=512, batch_size=1, upload_pack=False)


def test_auto_grouping_follows_the_download_wait(monkeypatch):
    """Unpinned, grouping engages once the download-wait EWMA (seeded from
    the process's last runner) exceeds `_GROUP_FETCH_MIN_S`, and the
    grouped waits feed it back, so a recovered link de-escalates."""
    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    monkeypatch.setattr(tbe, "_LAST_FETCH_EWMA", 10.0)
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, 512, 1, "cpu", upload_pack=False)
    assert runner.fetch_group == 0 and runner._fetch_ewma == 10.0
    blocks = _walk(512 * 9).reshape(-1, 512, 2).transpose(0, 2, 1)
    # the grouped program warms on the capture thread before batches group:
    # warm it first
    shapes = (((4, 1, 2, 512), "torch.int16"),)
    prog = tbe.program_for(tconfig.Encoder(), 2, 16, 512, False, "native2", None, shapes,
                           torch.device("cpu"), grouped=4)
    prog.warm(lambda: [torch.zeros((4, 1, 2, 512), dtype=torch.int16)])[0].result(timeout=60)
    out = []
    for i in range(4):
        out.append(runner.submit(blocks[i:i + 1].copy(), [i], 44100))
    assert runner.grouped_batches == 4 and all(r is None for r in out)
    out.extend(runner.drain())
    assert runner._fetch_ewma < 8.0  # 0.7 * 10 + 0.3 * (a CPU wait)
    monkeypatch.setattr(tbe, "_GROUP_FETCH_MIN_S", 1e9)
    for i in range(4, 8):
        runner.submit(blocks[i:i + 1].copy(), [i], 44100)
    out.extend(runner.drain())
    assert runner.grouped_batches == 4  # de-escalated: per batch again
    assert tbe._LAST_FETCH_EWMA == runner._fetch_ewma


@pytest.mark.parametrize("packer", ["native2", "native"])
def test_grouped_module_returns_the_batches_stacked(packer):
    rng = np.random.default_rng(4)
    blocks = np.clip(np.cumsum(rng.integers(-300, 301, (3, 2, 2, 256)), -1),
                     -32768, 32767).astype(np.int16)
    cfg = tconfig.Encoder()
    one = tbe.BatchEncoder(cfg, 2, 16, 256, wire_encoded=packer == "native")
    grouped = tbe.BatchEncoder(cfg, 2, 16, 256, wire_encoded=packer == "native", grouped=3)
    x = torch.from_numpy(blocks)
    with torch.inference_mode():
        got = grouped(x)
        want = [one(x[g]) for g in range(3)]
    if isinstance(got, torch.Tensor):
        assert torch.equal(got, torch.stack(want))
    else:
        for i, field in enumerate(got):
            assert torch.equal(field, torch.stack([w[i] for w in want]))


def test_hires_rice_wire_equals_jax_and_raw():
    """24-bit stereo over the packed wire (high rice parameters, int32
    upload otherwise) gives JAX's bytes of the same wire and the raw bytes."""
    n = 1024 * 5
    t = np.arange(n, dtype=np.float64)
    rng = np.random.default_rng(5)
    base = 4_000_000 * np.sin(2 * np.pi * 200 / 44100 * t)
    x = np.zeros(2 * n, np.int32)
    x[0::2] = np.round(base + rng.integers(-3000, 3000, n))
    x[1::2] = np.round(0.7 * base + rng.integers(-3000, 3000, n))
    tbytes, tstats, jbytes, jstats = encode_pair(x, 2, 24, upload_pack=True)
    assert tstats["wire_batches"] == jstats["wire_batches"]
    assert all(k != "None" for k in tstats["wire_batches"])
    assert tbytes == jbytes == port_bytes(x, 2, 24, upload_pack=False)


def test_strict_mode_with_a_packed_wire_equals_jax_and_raw():
    """The strict host arrays ride after the wire's payload."""
    n = 1024 * 3 + 77
    x = np.zeros(2 * n, np.int32)
    from flacenc_tpu import sigen

    x[0::2] = sigen.Sine(128, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
    x[1::2] = sigen.Sine(130, 0.4).noise_with_seed(2, 0.01).to_vec_quantized(16, n)
    tbytes, tstats, jbytes, jstats = encode_pair(x, 2, 16, strict_lpc=True, upload_pack=True)
    assert tstats["wire_batches"] == jstats["wire_batches"]
    assert all(k != "None" for k in tstats["wire_batches"])
    assert tbytes == jbytes == port_bytes(x, 2, 16, strict_lpc=True, upload_pack=False)


# ---------------------------------------------------------------------------
# the program registry
# ---------------------------------------------------------------------------


def test_registry_one_program_per_key_and_lru_bound(monkeypatch):
    monkeypatch.setattr(tbe, "_PROGRAMS", type(tbe._PROGRAMS)())
    monkeypatch.setattr(tbe, "_PROGRAM_CACHE_SIZE", 3)
    cfg = tconfig.Encoder()
    cpu = torch.device("cpu")
    shapes = (((4, 2, 256), "torch.int16"),)

    def get(wire=None, grouped=0, bps=16):
        return tbe.program_for(cfg, 2, bps, 256, False, "native2", wire, shapes, cpu,
                               grouped=grouped)

    a = get()
    assert get() is a and not a.capture  # the CPU runs the eager module
    b, c = get(("d", 2)), get(grouped=2)
    assert b.module.packed_wire == ("d", 2) and c.module.grouped == 2
    get()  # a is used again: b is now the least recently used
    get(bps=8)
    assert len(tbe._PROGRAMS) == 3 and b.key not in tbe._PROGRAMS and a.key in tbe._PROGRAMS
    tbe.wait_all_warms()  # nothing pending on the CPU
    tbe.wait_wire_warms()
    tbe.wait_group_warms()


def test_a_new_runner_reuses_the_registry(monkeypatch):
    monkeypatch.setattr(tbe, "_PROGRAMS", type(tbe._PROGRAMS)())
    x = _walk(512 * 4)
    progs = []
    for _ in range(2):
        port_bytes(x, 2, 16, block_size=512, batch_size=2, upload_pack="delta")
        progs.append(list(tbe._PROGRAMS.values()))
    assert len(progs[1]) == 1 and progs[1][0] is progs[0][0]  # the same entry, not rebuilt
    assert progs[0][0].key[6] == ("d", 2)


def test_capture_rule():
    """Forwards that sync (direct MSE, IRLS) stay eager; strict mode and
    every other config are captured on a card."""
    cfg = tconfig.Encoder()
    assert tbe.graph_capturable(cfg, False, 4096)
    cfg.subframe_coding.qlpc.use_direct_mse = True
    assert not tbe.graph_capturable(cfg, False, 4096)
    assert tbe.graph_capturable(cfg, True, 4096)
    assert tbe.graph_capturable(cfg, False, 32)  # too short to predict
    cfg.subframe_coding.use_lpc = False
    assert tbe.graph_capturable(cfg, False, 4096)


def test_timeline_events_in_stats(monkeypatch):
    """FLACENC_TIMELINE=1 puts (event, batch, perf_counter, ...) tuples of
    every stage into `stats["timeline"]`, in time order per batch."""
    monkeypatch.setenv("FLACENC_TIMELINE", "1")
    stats = {}
    port_bytes(_walk(512 * 5), 2, 16, block_size=512, batch_size=2, upload_pack="delta",
               stats=stats)
    events = stats["timeline"]
    names = {e[0] for e in events}
    assert {"read_start", "read_done", "submit", "packed", "issued", "drain_start",
            "fetch_done", "asm_done", "drain_done"} <= names
    for seq in range(3):
        times = [e[2] for e in events if e[1] == seq and e[0] != "read_start"
                 and e[0] != "read_done"]
        assert times == sorted(times) and len(times) >= 7
    packed = [e for e in events if e[0] == "packed"]
    assert all(e[3] == "d" and e[4] > 0 for e in packed)
    monkeypatch.delenv("FLACENC_TIMELINE")
    stats = {}
    port_bytes(_walk(512 * 3), 2, 16, block_size=512, batch_size=2, stats=stats)
    assert "timeline" not in stats


def test_corpus_takes_upload_pack():
    """`encode_corpus(upload_pack=...)`: the packed corpus equals the raw one
    file for file, and its stats name the wires."""
    from flacenc_tpu_torch import encode_corpus
    from flacenc_tpu_torch.source import MemSource as TMemSource

    files = [_walk(512 * 5 + 77, seed=s) for s in (1, 2, 3)]
    out = {}
    for up in (True, False):
        srcs = [(f"f{i}", TMemSource(x, 2, 16, 44100)) for i, x in enumerate(files)]
        streams, stats = encode_corpus(srcs, tconfig.Encoder(), 512, batch_size=4,
                                       device="cpu", upload_pack=up)
        out[up] = {k: s.to_bytes() for k, s in streams.items()}
        assert (set(stats.wire_batches) == {"None"}) == (not up), stats.wire_batches
    assert out[True] == out[False]
