"""Card-only checks of the port: the CUDA Rice kernels (tensor-core and
transpose) against their plain PyTorch version, and the whole device
program on CUDA against the CPU on
every path (mono, stereo, 24-bit, fixed-only, BitCount, strict, direct MSE
and IRLS); the captured CUDA graphs of the program registry against their
eager forwards, and the upload wires and grouped round trips on the card.

The dispatch lane (the runner's default issue path) against
FLACENC_INLINE_DISPATCH on every wire and G=4, a capture on the lane beside
other threads' CUDA calls, and two runners sharing one program.

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
    got = flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, MemSource(x, 2, 16, 44100), 4096, batch_size=4, device="cuda", mesh=m).to_bytes()
    forwards = tbe.PROGRAM_COUNTS["forwards"] - forwards
    # 3 batches x 2 shards, plus each replica's capture warm-up on a new key
    assert forwards in (3 * 2, 3 * 2 + 2)
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
        kw = dict(batch_size=2, device="cuda", strict_lpc=strict)
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
    progs = [p for p in tbe._PROGRAMS.values() if p.capture]
    assert progs and all(p.checked for p in progs)
    with torch.inference_mode():
        for p in progs:
            p.graph.replay()
            out = p.static_out
            out = out.clone() if isinstance(out, torch.Tensor) else tuple(t.clone() for t in out)
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
        stats = {}
        lane, inline = _lane_and_inline(x, monkeypatch, upload_pack=up, stats=stats)
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
