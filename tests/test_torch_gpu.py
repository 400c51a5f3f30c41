"""Card-only checks of the port: the CUDA Rice kernels (tensor-core and
transpose) against their plain PyTorch version, and the whole device
program on CUDA against the CPU on
every path (mono, stereo, 24-bit, fixed-only, BitCount, strict, direct MSE
and IRLS); the captured CUDA graphs of the program registry against their
eager forwards, and the upload wires and grouped round trips on the card.

The dispatch lane (the runner's default issue path) against
FLACENC_INLINE_DISPATCH on every wire and G=4, a capture on the lane beside
other threads' CUDA calls, and two runners sharing one program.

The background warm: a capture on the capture thread while another
runner's lane replays graphs of the same memory pool, pins host memory and
waits on events, a check replay that holds the pool against older graphs,
and `wait_all_warms` while a capture is open.

The split over real cards, with two or more visible (`cards` skips
otherwise, naming the count): equal bytes on one card, two and all; each
card's Rice runs 2 x its forwards; a replica captured on card 1's capture
thread while card 0 replays; each shard's copy on its own card before that
card's replay, with shards that differ; the kernel's first launch on each
card. A capture into a memory pool whose every graph was evicted (which
evictions of per-card replicas cause).

The pinned staging slots: a slot whose copy to the card is pending is not
refilled, and three calls in a row on every wire, G=4, strict and a
two-card mesh give the CPU path's bytes.

The link gate: the event-timed uploads read the card's link above 1 GB/s;
once a forced packed encode has measured the packs, the default path on
album material ships raw after its first batch and counts it in `stats`;
its bytes equal the forced raw and packed encodes'.

The tests of a background capture started by the racer plant empty pack
costs, so that the link gate stays open and the racer warms its wires.

Every test here carries the `gpu` marker and skips without a card. This
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py -m gpu -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu_torch import config, sigen  # noqa: E402
from flacenc_tpu_torch.source import MemSource  # noqa: E402
from flacenc_tpu_torch.models import reference_encoder  # noqa: E402
from flacenc_tpu_torch.ops.windows import get_window  # noqa: E402

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.ops import rice, rice_tables  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _kernel_vs_plain(errors, warmup, device):
    finest = rice.finest_partition_order(errors.shape[-1], 64)
    e = torch.from_numpy(errors).to(device)
    w = torch.from_numpy(warmup).to(device)
    before = rice_tables.launches()
    got = rice_tables.rice_cost_tables(e, w, finest)
    assert rice_tables.launches() == before + 1  # counted by the kernel on the card
    assert torch.equal(got, rice_tables.rice_cost_tables_plain(e, w, finest))


@pytest.mark.parametrize("T", [1024, 4096, 16384, 4095, 32767, 32])
def test_kernel_matches_plain(cuda, T):
    rng = np.random.default_rng(T)
    errors = rng.integers(-(1 << 20), 1 << 20, (8, 4, T)).astype(np.int32)
    warmup = rng.integers(0, 25, (8, 4)).astype(np.int32)
    _kernel_vs_plain(errors, warmup, cuda)


def test_unaligned_input_takes_the_transpose_kernel(cuda):
    rng = np.random.default_rng(3)
    errors = rng.integers(-(1 << 20), 1 << 20, (4, 4, 4096)).astype(np.int32)
    warmup = rng.integers(0, 25, (4, 4)).astype(np.int32)
    flat = torch.empty(errors.size + 1, dtype=torch.int32, device=cuda)
    e = flat[1:].view(errors.shape)  # 4 bytes past an aligned start
    e.copy_(torch.from_numpy(errors))
    w = torch.from_numpy(warmup).to(cuda)
    assert rice_tables.launch_plan(4096, 6, e.data_ptr()).kernel == "transpose"
    got = rice_tables.rice_cost_tables(e, w, 6)
    torch.cuda.synchronize()
    assert torch.equal(got, rice_tables.rice_cost_tables_plain(e, w, 6))


def test_kernel_saturation_and_int32_limits(cuda):
    errors = np.zeros((3, 1, 1024), np.int32)
    errors[0, 0, :2] = [(1 << 30) + 1, -((1 << 30) + 2)]
    errors[0, 0, 70] = np.iinfo(np.int32).min
    errors[1, 0, :8] = -(1 << 27)
    errors[2, 0] = np.random.default_rng(0).integers(
        np.iinfo(np.int32).min, np.iinfo(np.int32).max, 1024
    )
    _kernel_vs_plain(errors, np.array([[0], [0], [24]], np.int32), cuda)


def _bitcount(c):
    c.subframe_coding.fixed.order_sel = config.OrderSel(type="BitCount")


def _fixed_only(c):
    c.subframe_coding.use_lpc = False


def _direct_mse(steps):
    def edit(c):
        c.subframe_coding.qlpc.use_direct_mse = True
        c.subframe_coding.qlpc.mae_optimization_steps = steps
    return edit


@pytest.mark.parametrize("C,bps,edit,strict", [
    (1, 16, None, False), (2, 16, None, False), (2, 24, None, False),
    (1, 16, _fixed_only, False), (2, 16, _bitcount, False), (2, 16, None, True),
    (2, 16, _direct_mse(0), False), (2, 16, _direct_mse(2), False),
], ids=["mono", "stereo", "stereo24", "mono_fixed_only", "bitcount", "strict",
        "direct_mse", "irls"])
def test_decisions_match_cpu(cuda, C, bps, edit, strict):
    n = 8 * 1024
    chans = [
        sigen.Sine(128 + 9 * c, 0.4).noise_with_seed(c + 1, 0.01).to_vec_quantized(bps, n)
        for c in range(C)
    ]
    blocks = np.stack(chans).reshape(C, 8, 1024).transpose(1, 0, 2).copy().astype(np.int32)
    cfg = config.Encoder()
    if edit is not None:
        edit(cfg)
    ext = ()
    if strict:
        window = get_window(cfg.subframe_coding.qlpc.window, 1024)
        ext = tuple(map(torch.from_numpy, tbe._strict_ext_arrays(blocks, cfg, C, bps, window)))
    enc = tbe.BatchEncoder(cfg, C, bps, 1024, strict_lpc=strict)
    x = torch.from_numpy(blocks)
    cpu = enc(x, *ext)
    gpu = enc.to(cuda)(x.to(cuda), *(a.to(cuda) for a in ext)).cpu()
    assert torch.equal(cpu, gpu)


def test_stream_matches_oracle(cuda):
    n = 8 * 4096 + 1234
    x = np.zeros(2 * n, np.int32)
    x[0::2] = sigen.Sine(128, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
    x[1::2] = sigen.Sine(130, 0.4).noise_with_seed(2, 0.01).to_vec_quantized(16, n)
    cfg = config.Encoder().into_verified()
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, device="cuda"
    ).to_bytes()
    oracle = reference_encoder.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096
    ).to_bytes()
    assert got == oracle


def test_strict_stream_and_corpus_on_card(cuda):
    """Strict bytes equal the oracle's strict bytes; a corpus stream equals
    the file encoded alone, on the card."""
    n = 8 * 4096 + 1234
    x = np.zeros(2 * n, np.int32)
    x[0::2] = sigen.Sine(128, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
    x[1::2] = sigen.Sine(130, 0.4).noise_with_seed(2, 0.01).to_vec_quantized(16, n)
    cfg = config.Encoder().into_verified()
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, device="cuda", strict_lpc=True
    ).to_bytes()
    assert got == reference_encoder.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, strict_lpc=True
    ).to_bytes()
    streams, _ = flacenc_tpu_torch.encode_corpus(
        [("a", MemSource(x, 2, 16, 44100)), ("b", MemSource(x[: 2 * 5000], 2, 16, 48000))],
        cfg, 4096, batch_size=8, device="cuda",
    )
    assert streams["a"].to_bytes() == flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, device="cuda"
    ).to_bytes()


def _stereo(n, bps=16, noise=0.01):
    x = np.zeros(2 * n, np.int32)
    x[0::2] = sigen.Sine(97, 0.6).noise_with_seed(1, noise).to_vec_quantized(bps, n)
    x[1::2] = sigen.Sine(98, 0.6).noise_with_seed(2, noise).to_vec_quantized(bps, n)
    return x


@pytest.mark.parametrize("bps,noise", [(16, 0.01), (24, 0.2)], ids=["cd", "beyond_int16"])
def test_device_encoded_matches_cpu(cuda, bps, noise):
    """`decisions_only=False` on the card equals the CPU field by field,
    residuals and fits16 included (the 24-bit noise overflows int16)."""
    x = _stereo(8 * 1024, bps, noise)
    blocks = torch.from_numpy(x.reshape(8, 1024, 2).transpose(0, 2, 1).copy())
    enc = tbe.BatchEncoder(config.Encoder(), 2, bps, 1024, decisions_only=False)
    cpu = enc(blocks)
    gpu = enc.to(cuda)(blocks.to(cuda))
    for field, a, b in zip(cpu._fields, cpu, gpu):
        assert torch.equal(a, b.cpu()), field
    if bps == 24:
        assert not bool(cpu.fits16.all())


@pytest.mark.parametrize("packer", ["native", "python"])
def test_residual_packers_on_card(cuda, packer):
    x = _stereo(6 * 2048 + 77, 24, 0.2)
    cfg = config.Encoder().into_verified()
    kw = dict(batch_size=4, device="cuda")
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 24, 96000), 2048, packer=packer, **kw).to_bytes()
    assert got == flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 24, 96000), 2048, packer="native2", **kw).to_bytes()


def test_mesh_of_replicas_on_one_card(cuda):
    from flacenc_tpu_torch.parallel import mesh

    x = _stereo(9 * 4096 + 5)
    cfg = config.Encoder().into_verified()
    m = mesh.block_mesh([cuda, cuda])
    before, forwards = rice_tables.launches(), tbe.PROGRAM_COUNTS["forwards"]
    lane, background = tbe.CAPTURE_COUNTS["lane"], tbe.CAPTURE_COUNTS["background"]
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, batch_size=4, device="cuda", mesh=m).to_bytes()
    tbe.wait_all_warms()
    forwards = tbe.PROGRAM_COUNTS["forwards"] - forwards
    lane = tbe.CAPTURE_COUNTS["lane"] - lane
    background = tbe.CAPTURE_COUNTS["background"] - background
    # 3 batches x 2 shards, plus each replica's capture warm-up on a new key
    # (a lane capture's first replay is its batch's forward) and the warm-up
    # and first replay of each capture on the capture thread (the racer's wires)
    assert lane <= 2 and forwards == 3 * 2 + lane + 2 * background
    assert rice_tables.launches() - before == 2 * forwards  # 2 per forward
    assert got == flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, batch_size=4, device="cuda", mesh=None).to_bytes()
    assert mesh.dryrun_multichip(2)["total_bits"] > 0


def test_mesh_replicas_captured_out_of_order(cuda):
    """Replica 1's graph captured before replica 0's: a mesh replays every
    replica before it downloads any, and each replica's captures have a
    pool of their own, so neither replay overwrites the other's outputs."""
    from flacenc_tpu_torch.parallel import mesh

    x = _stereo(9 * 4096 + 5)
    cfg = config.Encoder().into_verified()
    m = mesh.block_mesh([cuda, cuda])
    dev = m.devices[1]
    shapes = (((2, 2, 4096), "torch.int16"),)
    first = tbe.program_for(cfg.inner, 2, 16, 4096, False, "native2", None, shapes, dev,
                            replica=(repr(m), 1))
    with torch.inference_mode():
        first(torch.zeros((2, 2, 4096), dtype=torch.int16, device=dev))
    kw = dict(batch_size=4, device="cuda", upload_pack=False)
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, mesh=m, **kw).to_bytes()
    assert first.graph is not None and first.key in tbe._PROGRAMS
    assert got == flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, mesh=None, **kw).to_bytes()


def test_fuzz_tiers_on_card(cuda):
    from flacenc_tpu_torch import fuzz

    assert fuzz.run(range(5), strict=True)["cases"] == 5
    out = fuzz.run(range(10))
    assert out["cases"] == 10 and all(d["strict_equal"] for d in out["divergences"])


def _walk(n, seed=3):
    rng = np.random.default_rng(seed)
    x = np.zeros(2 * n, np.int32)
    for ch in range(2):
        x[ch::2] = np.clip(np.cumsum(rng.integers(-500, 501, n)), -30000, 30000)
    return x


@pytest.mark.parametrize("up,group,strict", [
    (True, "1", False), ("delta", "1", False), ("auto", "1", False), (False, "4", False),
    (True, "2", False), (True, "1", True),
])
def test_wires_groups_and_graphs_on_card(cuda, up, group, strict, monkeypatch):
    """Every wire, G and strict under a packed wire give the raw upload's
    bytes on the card, and every graph the registry captured replays to
    its eager forward's outputs."""
    monkeypatch.setenv("FLACENC_FETCH_GROUP", group)
    cfg = config.Encoder().into_verified()
    for x in (_stereo(13 * 2048 + 77), _walk(13 * 2048 + 5)):
        # mesh=None: a grouped round trip is a one-card mechanism, never
        # engaged over a mesh, which "auto" would make of a host whose card
        # count divides the batch
        kw = dict(batch_size=2, device="cuda", strict_lpc=strict, mesh=None)
        if group != "1":  # the grouped program warms on the capture thread: warm it first
            flacenc_tpu_torch.encode_with_fixed_block_size(
                cfg, MemSource(x, 2, 16, 44100), 2048, upload_pack=up, **kw)
            tbe.wait_all_warms()
        stats = {}
        got = flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg, MemSource(x, 2, 16, 44100), 2048, upload_pack=up, stats=stats, **kw).to_bytes()
        monkeypatch.setenv("FLACENC_FETCH_GROUP", "1")
        raw = flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg, MemSource(x, 2, 16, 44100), 2048, upload_pack=False, **kw).to_bytes()
        monkeypatch.setenv("FLACENC_FETCH_GROUP", group)
        assert got == raw, stats["wire_batches"]
        if group != "1":
            assert stats["grouped_batches"] == stats["batches"]
    tbe.wait_all_warms()
    progs = [p for p in tbe._PROGRAMS.values() if p.capture]
    assert progs and all(p.checked for p in progs)
    with torch.inference_mode():
        for p in progs:
            with tbe._on_card(p.device):  # earlier tests' replicas live on every card
                p.graph.replay()
                out = p.static_out
                out = (out.clone() if isinstance(out, torch.Tensor)
                       else tuple(t.clone() for t in out))
                assert tbe._outputs_equal(out, p.module(*p.static_in)), p.key[5:]


def test_replays_count_their_rice_launches(cuda):
    """The card counts the Rice kernel's runs inside graph replays as it
    counts eager launches: 2 per forward, the capture's eager warm-up
    included; direct MSE stays eager."""
    x = _stereo(5 * 4096)
    for use_direct_mse, capture in ((False, True), (True, False)):
        cfg = config.Encoder()
        cfg.subframe_coding.qlpc.use_direct_mse = use_direct_mse
        rice_tables.reset_launches()
        forwards = tbe.PROGRAM_COUNTS["forwards"]
        flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg, MemSource(x, 2, 16, 44100), 4096, batch_size=2, device="cuda",
            upload_pack=False)
        forwards = tbe.PROGRAM_COUNTS["forwards"] - forwards
        assert rice_tables.launches() == 2 * forwards and forwards >= 3
        shapes = (((2, 2, 4096), "torch.int16"),)
        dev = torch.device("cuda", torch.cuda.current_device())
        prog = tbe.program_for(cfg, 2, 16, 4096, False, "native2", None, shapes, dev)
        assert prog.capture == capture and (prog.graph is not None) == capture
        if capture:
            rice_tables.reset_launches()
            with torch.inference_mode():
                prog.graph.replay()
            assert rice_tables.launches() == 2  # one replay runs both searches


def _encode_bytes(x, **kw):
    cfg = config.Encoder().into_verified()
    return flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 2048, batch_size=2, device="cuda", **kw).to_bytes()


def _lane_and_inline(x, monkeypatch, **kw):
    """The bytes issued on the dispatch lane, then under the kill switch."""
    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    lane = _encode_bytes(x, **kw)
    monkeypatch.setenv("FLACENC_INLINE_DISPATCH", "1")
    inline = _encode_bytes(x, **{k: v for k, v in kw.items() if k != "stats"})
    monkeypatch.delenv("FLACENC_INLINE_DISPATCH")
    return lane, inline


@pytest.mark.parametrize("up,group", [
    (False, "1"), (True, "1"), ("delta", "1"), ("auto", "1"), (False, "4"),
])
def test_lane_equals_inline_on_card(cuda, up, group, monkeypatch):
    """Every wire and G=4 give the same bytes issued on the dispatch lane
    and on the caller's thread (FLACENC_INLINE_DISPATCH)."""
    monkeypatch.setenv("FLACENC_FETCH_GROUP", group)
    for x in (_stereo(13 * 2048 + 77), _walk(13 * 2048 + 5)):
        if group != "1":  # the grouped program warms on the capture thread: warm it first
            _encode_bytes(x, upload_pack=up, mesh=None)
            tbe.wait_all_warms()
        stats = {}
        # mesh=None: grouping is a one-card mechanism, never engaged over a mesh
        lane, inline = _lane_and_inline(x, monkeypatch, upload_pack=up, stats=stats, mesh=None)
        assert lane == inline
        if group != "1":
            assert stats["grouped_batches"] == stats["batches"]


def test_capture_on_the_lane_beside_pins_and_waits(cuda, monkeypatch):
    """A fresh key is captured on the lane while another thread pins a
    host buffer no earlier allocation could serve and waits on an event
    of its own (an io worker waiting on an earlier batch; the caller
    pinning the next): the capture's "thread_local" error mode lets both
    run, and the bytes equal the inline path's."""
    import threading

    x = _stereo(6 * 2048 + 9)
    monkeypatch.setattr(tbe, "_PROGRAMS", type(tbe._PROGRAMS)())  # every key fresh
    capturing, beside_done = threading.Event(), threading.Event()
    forward = tbe.BatchEncoder.forward
    lane_threads, errors = [], []

    def held_forward(self, *inputs):
        if torch.cuda.is_current_stream_capturing() and not capturing.is_set():
            lane_threads.append(threading.current_thread().name)
            capturing.set()
            beside_done.wait(60)
        return forward(self, *inputs)

    def beside():
        try:
            assert capturing.wait(60)
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                src = torch.arange(1 << 20, dtype=torch.int32, device=cuda)
                host = torch.empty((1 << 26) + 4099, dtype=torch.int32, pin_memory=True)
                host[: 1 << 20].copy_(src, non_blocking=True)
                event = torch.cuda.Event()
                event.record(side)
            event.synchronize()
            assert int(host[(1 << 20) - 1]) == (1 << 20) - 1
        except BaseException as e:  # noqa: BLE001 - reported by the test thread
            errors.append(e)
        finally:
            beside_done.set()

    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    monkeypatch.setattr(tbe.BatchEncoder, "forward", held_forward)
    helper = threading.Thread(target=beside)
    helper.start()
    got = _encode_bytes(x, upload_pack=False)
    helper.join(60)
    assert not helper.is_alive() and not errors, errors
    assert lane_threads and lane_threads[0].startswith("flacenc-lane")
    monkeypatch.setattr(tbe.BatchEncoder, "forward", forward)
    assert got == _lane_and_inline(x, monkeypatch, upload_pack=False)[1]


def test_lane_counts_two_rice_launches_a_forward(cuda, monkeypatch):
    """The card counts 2 Rice runs for every forward the lane issues (the
    capture's warm-up included)."""
    rice_tables.reset_launches()
    forwards = tbe.PROGRAM_COUNTS["forwards"]
    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    stats = {}
    _encode_bytes(_stereo(9 * 2048 + 5), upload_pack=False, stats=stats)
    forwards = tbe.PROGRAM_COUNTS["forwards"] - forwards
    assert forwards >= stats["batches"] == 5
    assert rice_tables.launches() == 2 * forwards


def test_two_runners_in_two_threads_share_a_program(cuda, monkeypatch):
    """Two encodes in two threads, started together three times, run the
    same registry program (one key): the program's lock keeps each one's
    copy-in, replay and download together, so each gets its own bytes."""
    import threading

    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    xs = [_stereo(11 * 2048 + 3), _walk(11 * 2048 + 3)]
    want = [_encode_bytes(x, upload_pack=False) for x in xs]
    keys = len(tbe._PROGRAMS)
    barrier = threading.Barrier(2)
    got, errors = [[], []], []

    def run(i):
        try:
            for _ in range(3):
                barrier.wait(60)
                got[i].append(_encode_bytes(xs[i], upload_pack=False))
        except BaseException as e:  # noqa: BLE001 - reported by the test thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert got == [[want[0]] * 3, [want[1]] * 3]
    assert len(tbe._PROGRAMS) == keys  # no key was added: both ran the shared program


def _gate_open(monkeypatch):
    """No pack measured (earlier tests' packs forgotten for this one): the
    link gate stays open until the racer's own packs are timed."""
    monkeypatch.setattr(tbe, "_PACK_COSTS", tbe.Costs())


def _held_background_capture(monkeypatch):
    """Hold the first capture on a capture thread open, mid-forward, until
    the returned `release` event is set; `capturing` is set once it is."""
    import threading

    capturing, release = threading.Event(), threading.Event()
    forward = tbe.BatchEncoder.forward

    def held_forward(self, *inputs):
        if (torch.cuda.is_current_stream_capturing() and not capturing.is_set()
                and threading.current_thread().name.startswith("flacenc-capture")):
            capturing.set()
            release.wait(120)
        return forward(self, *inputs)

    monkeypatch.setattr(tbe.BatchEncoder, "forward", held_forward)
    return capturing, release


def test_background_capture_beside_replays_of_the_same_pool(cuda, monkeypatch):
    """A racer's wire is captured on the capture thread, held open mid-
    capture, while a second runner in another thread encodes three times
    on raw: its lane replays a graph from the same memory pool (one card,
    no mesh), pins its uploads and waits on its download events meanwhile.
    Both streams equal their encodes alone, and the raw program was the
    only capture on a lane."""
    import threading

    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    xs = [_walk(11 * 2048 + 3), _stereo(11 * 2048 + 3)]
    want = [_encode_bytes(x, upload_pack=False) for x in xs]  # raw: captured, replayed
    monkeypatch.setattr(tbe, "_PROGRAMS", type(tbe._PROGRAMS)(
        (k, p) for k, p in tbe._PROGRAMS.items() if p.key[6] is None))  # wires fresh
    _gate_open(monkeypatch)
    capturing, release = _held_background_capture(monkeypatch)
    got, errors = [], []

    def beside():
        try:
            assert capturing.wait(120)
            got.extend(_encode_bytes(xs[1], upload_pack=False) for _ in range(3))
        except BaseException as e:  # noqa: BLE001 - reported by the test thread
            errors.append(e)
        finally:
            release.set()

    lane = tbe.CAPTURE_COUNTS["lane"]
    helper = threading.Thread(target=beside)
    helper.start()
    racer = _encode_bytes(xs[0], upload_pack="auto")
    helper.join(300)
    failed = tbe.wait_all_warms()
    assert not helper.is_alive() and not errors, errors
    assert racer == want[0] and got == [want[1]] * 3
    assert capturing.is_set() and tbe.CAPTURE_COUNTS["lane"] == lane  # raw was warm
    assert not failed, failed


def test_check_replay_holds_the_pool_against_older_graphs(cuda, monkeypatch):
    """A background capture's check replay and its read of the outputs
    hold the pool lock: a graph captured later may keep its outputs in the
    blocks an older graph of the same pool uses for its intermediates, so
    no lane may replay the older graph (the raw program) in between. The
    check is held open for 1 s after its replay while a second runner
    starts encoding raw on another thread: every raw replay after the
    check began comes after it, every check passes, and both streams
    equal their encodes alone."""
    import threading
    import time

    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    xs = [_walk(11 * 2048 + 3), _stereo(11 * 2048 + 3)]
    want = [_encode_bytes(x, upload_pack=False) for x in xs]  # raw: captured, replayed
    monkeypatch.setattr(tbe, "_PROGRAMS", type(tbe._PROGRAMS)(
        (k, p) for k, p in tbe._PROGRAMS.items() if p.key[6] is None))  # wires fresh
    _gate_open(monkeypatch)
    in_check, order = threading.Event(), []
    equal, call = tbe._outputs_equal, tbe.Program.__call__

    def held_equal(a, b):
        if threading.current_thread().name.startswith("flacenc-capture") \
                and not in_check.is_set():
            in_check.set()
            time.sleep(1.0)  # the second runner's lane tries to replay meanwhile
            order.append("check")
        return equal(a, b)

    def spy(self, *inputs):
        if in_check.is_set() and self.key[6] is None:
            order.append("raw replay")
        return call(self, *inputs)

    monkeypatch.setattr(tbe, "_outputs_equal", held_equal)
    monkeypatch.setattr(tbe.Program, "__call__", spy)
    got, errors = [], []

    def beside():
        try:
            assert in_check.wait(120)
            got.extend(_encode_bytes(xs[1], upload_pack=False) for _ in range(2))
        except BaseException as e:  # noqa: BLE001 - reported by the test thread
            errors.append(e)

    helper = threading.Thread(target=beside)
    helper.start()
    racer = _encode_bytes(xs[0], upload_pack="auto")
    helper.join(300)
    failed = tbe.wait_all_warms()
    assert not helper.is_alive() and not errors, errors
    assert not failed, failed
    assert order[0] == "check" and "raw replay" in order, order
    assert racer == want[0] and got == [want[1]] * 2
    assert all(p.checked for p in tbe._PROGRAMS.values() if p.capture and p.graph is not None)


def test_background_capture_beside_pins_and_waits(cuda, monkeypatch):
    """While a capture is held open on the capture thread, this thread
    pins a host buffer no earlier allocation could serve, copies into it
    on a stream of its own and waits on an event: the capture's
    "thread_local" error mode lets both run, and the capture completes."""
    monkeypatch.setattr(tbe, "_PROGRAMS", type(tbe._PROGRAMS)())
    capturing, release = _held_background_capture(monkeypatch)
    shapes = (((2, 2, 2048), "torch.int16"),)
    dev = torch.device("cuda", torch.cuda.current_device())
    prog = tbe.program_for(config.Encoder(), 2, 16, 2048, False, "native2", None, shapes, dev)
    ready, queued = prog.warm(lambda: [torch.zeros((2, 2, 2048), dtype=torch.int16)])
    try:
        assert queued == [prog] and capturing.wait(120)
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            src = torch.arange(1 << 20, dtype=torch.int32, device=cuda)
            host = torch.empty((1 << 26) + 4099, dtype=torch.int32, pin_memory=True)
            host[: 1 << 20].copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        event.synchronize()
        assert int(host[(1 << 20) - 1]) == (1 << 20) - 1
    finally:
        release.set()
    ready.result(timeout=120)
    assert prog.captured_by == "background" and prog.checked
    assert prog.first_run.startswith("flacenc-capture")


def test_wait_all_warms_during_an_open_capture(cuda, monkeypatch):
    """`wait_all_warms(timeout)` while a capture is held open returns after
    about `timeout`, raises nothing and synchronizes no device; released,
    the warm finishes and the wire engages with the raw stream's bytes."""
    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    monkeypatch.setattr(tbe, "_PROGRAMS", type(tbe._PROGRAMS)())
    x = _walk(11 * 2048 + 3)
    want = _encode_bytes(x, upload_pack=False)
    _gate_open(monkeypatch)
    capturing, release = _held_background_capture(monkeypatch)
    syncs = []
    sync = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(a) or sync(*a))
    runner = tbe.BatchRunner(config.Encoder(), 2, 16, 2048, 2, "cuda", upload_pack="auto")
    blocks = x[: 2 * 2 * 2048 * 2].reshape(-1, 2048, 2).transpose(0, 2, 1).copy()
    try:
        runner.submit(blocks[:2], np.arange(2), 44100)
        assert capturing.wait(120)
        import time

        t0 = time.monotonic()
        tbe.wait_all_warms(timeout=0.5)
        waited = time.monotonic() - t0
        assert 0.4 < waited < 5.0 and not syncs, (waited, syncs)
    finally:
        release.set()
        list(runner.drain())
        runner.close()
    tbe.wait_all_warms()
    assert not syncs
    assert _encode_bytes(x, upload_pack="auto") == want


def test_a_pool_whose_graphs_were_all_evicted_takes_a_new_capture(cuda, monkeypatch):
    """A replica's memory pool whose every program was evicted, its graph
    collected, still takes a new capture: the allocator frees a pool once
    its last graph is gone and refuses a capture into its handle after, so
    the registry keeps one graph of each pool. Over a mesh of cards each
    key is one entry per card, and evictions empty whole pools."""
    import gc

    monkeypatch.setattr(tbe, "_PROGRAMS", type(tbe._PROGRAMS)())
    dev = torch.device("cuda", torch.cuda.current_device())

    def capture(T):
        shapes = (((2, 2, T), "torch.int16"),)
        prog = tbe.program_for(config.Encoder(), 2, 16, T, False, "native2", None, shapes, dev,
                               replica=("a pool emptied by evictions", 0))
        with torch.inference_mode():
            prog(torch.zeros((2, 2, T), dtype=torch.int16, device=dev))
        assert prog.graph is not None and prog.checked
        return prog.key

    tbe._PROGRAMS.pop(capture(1024))  # evicted: the last reference to its graph
    gc.collect()
    capture(2048)


@pytest.fixture
def cards():
    """Every visible card, when two or more are; skips otherwise, naming
    the count (decided here, in the test, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA cards; {n} visible")
    return [torch.device("cuda", i) for i in range(n)]


def _card_counts():
    """(Rice runs by card, forwards by card) of the process, warms settled."""
    assert not tbe.wait_all_warms()
    return rice_tables.launches_by_card(), dict(tbe.DEVICE_FORWARDS)


def test_bytes_equal_on_one_two_and_all_cards(cards, monkeypatch):
    """The default path with `mesh=None` on cuda:0, a mesh of cuda:0 and
    cuda:1, and `mesh="auto"` over every card: equal bytes; each card
    counted 2 Rice runs for every forward it ran, and every card of each
    split counted some."""
    from flacenc_tpu_torch.parallel import mesh

    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    n = len(cards)
    x = _stereo(9 * 4 * n * 512 + 5)
    cfg = config.Encoder().into_verified()
    got = {}
    for name, m, split in (("one", None, cards[:1]), ("two", mesh.block_mesh(cards[:2]), cards[:2]),
                           ("all", "auto", cards)):
        _card_counts()
        rice_tables.reset_launches()
        forwards = dict(tbe.DEVICE_FORWARDS)
        got[name] = flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg, MemSource(x, 2, 16, 44100), 512, batch_size=4 * n, device=cards[0],
            mesh=m).to_bytes()
        runs, after = _card_counts()
        ran = {d: after.get(d, 0) - forwards.get(d, 0) for d in after if d.startswith("cuda")}
        for d in set(runs) | set(ran):
            assert runs.get(d, 0) == 2 * ran.get(d, 0), (name, d, runs, ran)
        assert all(runs.get(str(d), 0) > 0 for d in split), (name, runs)
        assert set(d for d, r in runs.items() if r) == {str(d) for d in split}, (name, runs)
    assert got["one"] == got["two"] == got["all"]


def test_card_1_captures_while_card_0_replays(cards, monkeypatch):
    """A replica's capture on card 1's capture thread, held open mid-
    capture, while an encode on card 0 replays its warm program batch
    after batch: the encode finishes meanwhile (each card captures under
    its own lock), its bytes equal its encode alone, and the held capture
    then completes, checked, on card 1."""
    import threading

    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    x = _stereo(11 * 2048 + 3)
    want = _encode_bytes(x, upload_pack=False, mesh=None)  # card 0's raw program: captured
    capturing, release = threading.Event(), threading.Event()
    forward = tbe.BatchEncoder.forward

    def held_forward(self, *inputs):
        if (torch.cuda.is_current_stream_capturing() and not capturing.is_set()
                and threading.current_thread().name.startswith(f"flacenc-capture-{cards[1]}")):
            capturing.set()
            release.wait(120)
        return forward(self, *inputs)

    monkeypatch.setattr(tbe.BatchEncoder, "forward", held_forward)
    shapes = (((2, 2, 2048), "torch.int16"),)
    prog = tbe.program_for(config.Encoder(), 2, 16, 2048, False, "native2", None, shapes,
                           cards[1], replica=("held on card 1", 1))  # a fresh key
    ready, queued = prog.warm(lambda: [torch.zeros((2, 2, 2048), dtype=torch.int16)])
    try:
        assert queued == [prog] and capturing.wait(120)
        got = [_encode_bytes(x, upload_pack=False, mesh=None) for _ in range(2)]
        assert not ready.done()  # card 1's capture was open all along
    finally:
        release.set()
    ready.result(timeout=120)
    assert got == [want, want]
    assert prog.captured_by == "background" and prog.checked and prog.device == cards[1]


def test_each_shard_reaches_its_card_before_its_replay(cards):
    """A split batch whose shards differ, six times over, launched as the
    dispatch lane launches it (card 0 current, each replica's lock held):
    every replica's outputs lie on its own card and equal the eager
    forward of its own shard, so each shard's copy landed on its card
    before that card's replay read it."""
    import contextlib

    from flacenc_tpu_torch.parallel import mesh

    n, per = len(cards), 2
    m = mesh.block_mesh(cards)
    cfg = config.Encoder()
    shapes = (((per, 2, 4096), "torch.int16"),)
    sharded = mesh.ShardedEncoder([
        tbe.program_for(cfg, 2, 16, 4096, False, "native2", None, shapes, d,
                        replica=(repr(m), i)) for i, d in enumerate(cards)], m)
    eager = tbe.BatchEncoder(cfg, 2, 16, 4096).to(cards[0])
    rng = np.random.default_rng(11)
    for _ in range(6):
        scale = rng.integers(100, 20000, (n * per, 1, 1))
        blocks = (rng.standard_normal((n * per, 2, 4096)) * scale).astype(np.int16)
        host = torch.from_numpy(blocks).pin_memory()
        with torch.inference_mode(), tbe._on_card(cards[0]), contextlib.ExitStack() as held:
            for rep in sharded.replicas:
                held.enter_context(rep.lock)
            outs = sharded.launch(host)
            got = [(sl, out.device, out.cpu()) for sl, out in outs]
            want = eager(torch.from_numpy(blocks).to(cards[0])).cpu()
        for i, (sl, dev, out) in enumerate(got):
            assert dev == cards[i]
            assert torch.equal(out, want[sl]), i


def test_first_launch_on_each_card_loads_the_kernel(cards):
    """In a fresh process, the Rice kernel's first launch on each card,
    outside any capture, loads it there: each equals its plain version and
    is counted by its own card alone."""
    import os
    import subprocess
    import sys

    code = (
        "import numpy as np, torch\n"
        "from flacenc_tpu_torch.ops import rice_tables\n"
        "rng = np.random.default_rng(5)\n"
        "e = rng.integers(-(1 << 20), 1 << 20, (16, 4, 4096)).astype(np.int32)\n"
        "w = rng.integers(0, 25, (16, 4)).astype(np.int32)\n"
        "for i in range(torch.cuda.device_count()):\n"
        "    d = torch.device('cuda', i)\n"
        "    a, b = torch.from_numpy(e).to(d), torch.from_numpy(w).to(d)\n"
        "    assert torch.equal(rice_tables.rice_cost_tables(a, b, 6),\n"
        "                       rice_tables.rice_cost_tables_plain(a, b, 6)), i\n"
        "    runs = rice_tables.launches_by_card()\n"
        "    assert runs == {f'cuda:{j}': 1 for j in range(i + 1)}, runs\n"
        "print('ok', torch.cuda.device_count())\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["ok", str(len(cards))]


def _frame_bytes(results):
    return [f.to_frame_bytes() for r in results for f in r.frames]


def test_a_pending_upload_keeps_its_slot(cuda, monkeypatch):
    """A staging slot is not refilled while its copy to the card is pending.
    Behind a long sleep on the card's stream, a slot's copy lands its own
    samples though the next acquisition of its key came meanwhile (and got
    another slot); a runner's next batch of the same key, submitted while
    the first batch's copy and replay wait behind the sleep, fills another
    slot, and both batches' frames equal the CPU's."""
    monkeypatch.setattr(tbe, "_STAGING", tbe.StagingPool())
    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    B, T = 4, 4096
    rng = np.random.default_rng(16)
    blocks = [np.cumsum(rng.integers(-300, 301, (B, 2, T)), -1).clip(-30000, 30000)
              .astype(np.int32) for _ in range(3)]
    # the pool alone: one slot's copy pending, the key's next acquisition
    card = torch.device("cuda", torch.cuda.current_device())
    shape, src = (B, 2, T), [b.astype(np.int16) for b in blocks[:2]]
    first, _ = tbe._STAGING.acquire(card, shape, torch.int16, cap=3)
    np.copyto(first.tensor.numpy(), src[0])
    torch.cuda._sleep(int(1e9))  # ~0.5 s of the card's clock
    on_card = first.tensor.to(card, non_blocking=True)
    tbe._STAGING.release(first, [tbe._recorded(card)])
    second, how = tbe._STAGING.acquire(card, shape, torch.int16, cap=3)
    assert second is not first and how == "allocated"
    np.copyto(second.tensor.numpy(), src[1])
    torch.cuda.synchronize()
    assert np.array_equal(on_card.cpu().numpy(), src[0])
    tbe._STAGING.release(second)

    cfg = config.Encoder()
    nums = np.arange(B)
    want = []
    for dev in ("cpu", card):
        runner = tbe.BatchRunner(cfg, 2, 16, T, B, dev, mesh=None, upload_pack=False)
        try:
            runner.submit(blocks[0], nums, 44100)  # the first run captures (it syncs)
            done = list(runner.drain())
            if dev != "cpu":
                torch.cuda._sleep(int(1e9))
            runner.submit(blocks[1], nums + B, 44100)
            runner.submit(blocks[2], nums + 2 * B, 44100)
            if dev != "cpu":
                runner._lane_tail.result()  # both issued, the first copy still pending
                ins = tbe._STAGING._slots[(str(card), shape, torch.int16)]
                assert len(ins) == 2 and not all(e.query() for s in ins for e in s.events)
            done += list(runner.drain())
        finally:
            runner.close()
        want.append(_frame_bytes(done))
    assert want[1] == want[0]


def _staged_calls(x_list, device, **kw):
    """Each signal's bytes and stats, one call each, batches of 2 at 2048."""
    cfg = config.Encoder().into_verified()
    out = []
    for x in x_list:
        stats = {}
        data = flacenc_tpu_torch.encode_with_fixed_block_size(
            cfg, MemSource(x, 2, 16, 44100), 2048, batch_size=2, device=device, stats=stats,
            **kw).to_bytes()
        out.append((data, stats))
    return out


def _three_signals():
    """Three signals of more than 3 x the slot cap in batches of 2 at 2048."""
    cap = max(2, tbe.constants.par.FRAMEBUF_MULTIPLICITY) + 1
    n = (3 * cap + 2) * 2 * 2048 + 77
    return [_stereo(n), _walk(n, seed=5), _stereo(n, noise=0.05)]


@pytest.mark.parametrize("up,group,strict", [
    (False, "1", False), ("delta", "1", False), (True, "1", False), (False, "4", False),
    (False, "1", True),
], ids=["raw", "delta16", "dense", "group4", "strict"])
def test_staged_calls_equal_the_cpu(cuda, up, group, strict, monkeypatch):
    """Three calls in a row, each longer than 3 x the slot cap in batches,
    reuse the pool's slots across batches and calls and give the CPU path's
    bytes on every wire, G=4 and strict."""
    monkeypatch.delenv("FLACENC_INLINE_DISPATCH", raising=False)
    monkeypatch.setenv("FLACENC_FETCH_GROUP", group)
    signals = _three_signals()
    kw = dict(strict_lpc=strict, mesh=None)
    if group != "1":  # the grouped program warms on the capture thread: warm it first
        _staged_calls(signals[:1], cuda, upload_pack=up, **kw)
        tbe.wait_all_warms()
    got = _staged_calls(signals, cuda, upload_pack=up, **kw)
    want = _staged_calls(signals, "cpu", upload_pack=False, **kw)
    assert [d for d, _ in got] == [d for d, _ in want]
    for _, stats in got:
        # an upload and an output slot a batch, or a round trip of G batches
        acquired = stats["staging_reused"] + stats["staging_allocated"]
        assert acquired >= 2 * stats["batches"] // int(group) > 0
        if group != "1":
            assert stats["grouped_batches"] == stats["batches"]
    assert got[-1][1]["staging_reused"] > 0


def test_staged_calls_over_two_cards_equal_the_cpu(cards, monkeypatch):
    """A two-replica mesh (cuda:0, cuda:1) slices one pinned slot per shard:
    three calls give the CPU path's bytes."""
    from flacenc_tpu_torch.parallel import mesh

    monkeypatch.delenv("FLACENC_FETCH_GROUP", raising=False)
    signals = _three_signals()
    got = _staged_calls(signals, cards[0], mesh=mesh.block_mesh(cards[:2]))
    want = _staged_calls(signals, "cpu", mesh=None, upload_pack=False)
    assert [d for d, _ in got] == [d for d, _ in want]
    assert all(s["staging_reused"] > 0 for _, s in got[1:])


def _album(scale=0.05, seed=7):
    """The benchmark's album at `scale` of its length, its tracks back to
    back as one interleaved CD stream."""
    from benchmark import traffic

    fmt = {"sample_rate": 44100, "bits_per_sample": 16, "channels": 2}
    sources = traffic.generate(traffic.load_mix("album"), fmt, seed, scale)
    return np.concatenate([src.pcm for src in sources]).reshape(-1)


def _album_bytes(x, **kw):
    cfg = config.Encoder().into_verified()
    return flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, batch_size=16, device="cuda", mesh=None,
        **kw).to_bytes()


def test_event_timed_link_reads_above_1_gbps(cuda, monkeypatch):
    """Raw uploads timed by CUDA events read the card's link faster than
    1 GB/s, and their per-byte cost lands in the card's link estimate. A
    first run that captures its graph times no copy, so at most one batch's
    upload goes untimed."""
    monkeypatch.setattr(tbe, "_LINK_COSTS", tbe.Costs())
    stats = {}
    _album_bytes(_album(0.01), upload_pack=False, stats=stats)
    per_batch = stats["upload_bytes"] // stats["batches"]
    assert stats["upload_bytes"] >= stats["link_bytes"] >= stats["upload_bytes"] - per_batch > 0
    gbps = stats["link_bytes"] / stats["link_s"] / 1e9
    assert gbps > 1.0, gbps
    card = str(torch.device("cuda", torch.cuda.current_device()))
    assert 1.0 / tbe._LINK_COSTS.get(card) > 1e9


def test_default_path_ships_raw_once_the_link_and_packs_are_measured(cuda, monkeypatch):
    """A forced packed encode of album material measures the link and the
    packs; the default path (the racer behind the gate) then ships at least
    99 % of its batches after the first raw, counts them in `stats`, and
    its bytes equal the forced raw and packed encodes'."""
    for name in ("FLACENC_PACKED_UPLOAD", "FLACENC_FETCH_GROUP", "FLACENC_INLINE_DISPATCH"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(tbe, "_LINK_COSTS", tbe.Costs())
    monkeypatch.setattr(tbe, "_PACK_COSTS", tbe.Costs())
    x = _album()
    packed_stats, stats = {}, {}
    packed = _album_bytes(x, upload_pack=True, stats=packed_stats)
    assert packed_stats["upload_raw_batches"] < packed_stats["batches"]
    tbe.wait_all_warms()
    got = _album_bytes(x, stats=stats)
    assert {"upload_raw_batches", "link_bytes", "link_s"} <= set(stats)
    after_first = stats["batches"] - 1
    assert after_first >= 100
    assert stats["upload_raw_batches"] - 1 >= 0.99 * after_first, stats["wire_batches"]
    assert stats["link_bytes"] > 0 and stats["link_s"] > 0
    assert got == packed == _album_bytes(x, upload_pack=False)
