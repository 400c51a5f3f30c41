"""Port parity for the upload wires on the encode path: each forced wire
("w", "r", "m", "d") gives the JAX package's stream of the same wire and
the port's raw stream, byte for byte; the racer (`LinkEstimator`) makes the
JAX package's choices on the same feed sequences; the upload modes and
their environment variable, the rice/ms plan cache and the drain-gap feed
behave as the JAX package's `BatchPipeline`. All on the CPU."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu import config  # noqa: E402
from flacenc_tpu.component import decode_stream, parse_stream  # noqa: E402
from flacenc_tpu.models import batch_encoder as jbe  # noqa: E402
from flacenc_tpu.source import MemSource  # noqa: E402

import flacenc_tpu_torch  # noqa: E402
from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.ops import upack as tup  # noqa: E402
from flacenc_tpu_torch.source import MemSource as TMemSource  # noqa: E402


def _interleave(*channels) -> np.ndarray:
    x = np.zeros(len(channels) * len(channels[0]), np.int32)
    for ch, c in enumerate(channels):
        x[ch::len(channels)] = c
    return x


def _signals():
    """name -> (interleaved x, channels, bps, the wire kind it takes)."""
    n = 1024 * 5 + 100
    rng = np.random.default_rng(17)
    t = np.arange(n, dtype=np.float64)
    walk = [np.clip(np.cumsum(rng.integers(-500, 501, n)), -30000, 30000) for _ in range(2)]
    base = 9000 * np.sin(2 * np.pi * 331 / 44100 * t)
    return {
        "w": (_interleave(*walk), 2, 16, "w"),
        "r": (_interleave(np.round(15000 * np.sin(2 * np.pi * 180 / 44100 * t)),
                          np.round(12000 * np.sin(2 * np.pi * 300 / 44100 * t))), 2, 16, "r"),
        "m": (_interleave(*(np.round(base) + rng.integers(-40, 40, n) for _ in range(2))),
              2, 16, "m"),
        "d": (_interleave(*walk), 2, 16, "d"),
    }


def encode_pair(x, nch, bps, block_size=1024, batch_size=4, **kw):
    """(port bytes, port stats, JAX bytes, JAX stats) of one encode."""
    jcfg = config.Encoder().into_verified()
    tcfg = tconfig.Encoder.from_dict(jcfg.inner.to_dict()).into_verified()
    jstats, tstats = {}, {}
    jbytes = jbe.encode_with_fixed_block_size(
        jcfg, MemSource(x, nch, bps, 44100), block_size, batch_size=batch_size,
        stats=jstats, **kw).to_bytes()
    tbytes = flacenc_tpu_torch.encode_with_fixed_block_size(
        tcfg, TMemSource(x, nch, bps, 44100), block_size, batch_size=batch_size,
        device="cpu", stats=tstats, **kw).to_bytes()
    return tbytes, tstats, jbytes, jstats


def port_bytes(x, nch, bps, block_size=1024, batch_size=4, **kw):
    cfg = tconfig.Encoder().into_verified()
    return flacenc_tpu_torch.encode_with_fixed_block_size(
        cfg, TMemSource(x, nch, bps, 44100), block_size, batch_size=batch_size,
        device="cpu", **kw).to_bytes()


@pytest.mark.parametrize("name", ["w", "r", "m", "d"])
def test_forced_wire_stream_equals_jax_same_wire_and_raw(name):
    x, nch, bps, kind = _signals()[name]
    up = "delta" if kind == "d" else True
    tbytes, tstats, jbytes, jstats = encode_pair(x, nch, bps, upload_pack=up)
    kinds = {eval(k)[0] if k != "None" else None for k in tstats["wire_batches"]}
    assert kinds == {kind}, tstats["wire_batches"]
    assert tstats["wire_batches"] == jstats["wire_batches"]
    assert tbytes == jbytes
    assert tbytes == port_bytes(x, nch, bps, upload_pack=False)
    assert np.array_equal(decode_stream(parse_stream(tbytes)), x)


def test_noise_falls_back_to_raw_under_a_forced_wire():
    """Full-scale noise: nothing beats the int16 upload, the batch ships raw
    under upload_pack=True, and the bytes equal the raw encode."""
    y = np.random.default_rng(3).integers(-32768, 32768, 2 * 1024 * 3).astype(np.int32)
    stats = {}
    got = port_bytes(y, 2, 16, stats=stats, upload_pack=True)
    assert stats["wire_batches"] == {"None": 1}
    assert got == port_bytes(y, 2, 16, upload_pack=False)


# ---------------------------------------------------------------------------
# the racer
# ---------------------------------------------------------------------------


def _drive(ops):
    """Apply one feed sequence to the JAX estimator and the port's, op by op,
    and collect both sides' choose() answers and end states."""
    ests = (jbe.LinkEstimator(), tbe.LinkEstimator())
    answers = ([], [])
    for op in ops:
        for side, est in enumerate(ests):
            if op[0] == "update":
                est.update(*op[1:])
            elif op[0] == "stale":  # the kind's last sample is `op[2]` s older
                est.t_sample[op[1]] -= op[2]
            elif op[0] == "initial":
                answers[side].append(est.initial_kind(op[1]))
            else:
                answers[side].append(est.choose(op[1], op[2]))
    states = [(e.secs, e.nbytes, e.age, e._probe, e._vote, e.mbps) for e in ests]
    return answers, states


def _scripted_feeds():
    K, RP = ("raw", "d", "pack"), ("raw", "pack")
    fast = [("choose", K, "raw")] + [("update", 4_000_000, 0.002, "raw")] * 3 + [
        ("choose", K, "raw"), ("initial", K)]
    slow = [("choose", K, "raw"), ("update", 4_000_000, 0.2, "raw"),
            ("choose", K, "raw"), ("choose", K, "raw"), ("update", 4_000_000, 0.11, "d"),
            ("choose", K, "d"), ("choose", K, "d"), ("update", 2_600_000, 0.08, "pack"),
            ("choose", K, "pack"), ("update", 4_000_000, 0.051, "d"), ("choose", K, "pack"),
            ("initial", K)]
    regime = list(slow)
    for _ in range(2 * 16 + 2):
        regime += [("update", 2_600_000, 0.03, "pack"), ("choose", RP, "pack")]
    regime += [("update", 4_000_000, 0.01, "raw"), ("choose", RP, "pack"),
               ("update", 4_000_000, 0.01, "raw")] + [("choose", RP, "pack")] * 3
    stale = [("update", 4_000_000, 0.01, "raw"), ("update", 4_000_000, 0.30, "d"),
             ("update", 2_600_000, 0.05, "pack"), ("stale", "raw", 20.0), ("stale", "d", 20.0)]
    stale += [("update", 2_600_000, 0.05, "pack"), ("choose", K, "pack")] * 5
    lucky = [("update", 4_000_000, 0.2, "raw"), ("update", 4_000_000, 0.15, "d"),
             ("update", 2_600_000, 0.06, "pack")]
    lucky += [("update", 2_600_000, 0.06, "pack"), ("choose", K, "pack")] * 3
    lucky += [("update", 4_000_000, 0.02, "raw"), ("choose", K, "pack"),
              ("update", 4_000_000, 0.4, "raw"), ("choose", K, "pack"),
              ("update", 4_000_000, 0.01, "raw"), ("update", 4_000_000, 0.01, "raw"),
              ("choose", K, "pack"), ("choose", K, "pack")]
    return {"fast link": fast, "slow link": slow, "regime change": regime,
            "stale estimate": stale, "lucky sample": lucky}


def _random_feed(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    kinds = ("raw", "d", "pack") if seed % 2 else ("raw", "pack")
    ops, current = [], "raw"
    for _ in range(n):
        r = rng.random()
        if r < 0.45:
            k = kinds[rng.integers(len(kinds))]
            ops.append(("update", int(rng.integers(1, 5_000_000)),
                        float(10 ** rng.uniform(-3.5, 0)), k))
        elif r < 0.5:
            ops.append(("stale", kinds[rng.integers(len(kinds))], float(rng.uniform(0, 30))))
        else:
            ops.append(("choose", kinds, current))
            current = kinds[rng.integers(len(kinds))]
    return [op for op in ops if op[0] != "stale"] if seed % 3 == 0 else ops


@pytest.mark.parametrize("feed", list(_scripted_feeds()) + [f"random {s}" for s in range(6)])
def test_racer_choices_equal_jax_on_the_same_feeds(feed):
    ops = (_scripted_feeds()[feed] if not feed.startswith("random")
           else _random_feed(int(feed.split()[1])))
    # a "stale" op needs a sample of that kind first
    ops = [op for i, op in enumerate(ops)
           if op[0] != "stale" or any(o[0] == "update" and o[3] == op[1] for o in ops[:i])]
    answers, states = _drive(ops)
    assert answers[0] == answers[1]
    assert states[0] == states[1]


def test_racer_constants_and_buckets_equal_jax():
    for name in ("_FAST_LINK_MBPS", "_EXPLORE_EVERY", "_EXPLORE_MAX_RATIO", "_PROBE_LEN",
                 "_SWITCH_VOTES", "_FRESH_AGE", "_FRESH_SECONDS", "_PLAN_RESCAN_EVERY",
                 "_FETCH_GROUP_AUTO", "_GROUP_FETCH_MIN_S"):
        assert getattr(tbe, name) == getattr(jbe, name), name
    for spb in (0, 1, 4096, 64 * 2 * 4096, 256 * 2 * 4096, 10**9):
        assert tbe._shape_bucket(spb) == jbe._shape_bucket(spb)


def test_link_estimators_shared_per_shape_bucket(monkeypatch):
    monkeypatch.setattr(tbe, "_LINK_ESTS", {})
    cfg = tconfig.Encoder()
    r64 = tbe.BatchRunner(cfg, 2, 16, 4096, 64, "cpu", upload_pack="auto")
    r256 = tbe.BatchRunner(cfg, 2, 16, 4096, 256, "cpu", upload_pack="auto")
    r64b = tbe.BatchRunner(cfg, 2, 16, 4096, 64, "cpu", upload_pack="auto")
    assert r64._est is not r256._est and r64._est is r64b._est


# ---------------------------------------------------------------------------
# modes, plan cache, drain-gap feed
# ---------------------------------------------------------------------------


def _modes(runner_or_pipe):
    p = runner_or_pipe
    return (p.upload_mode, p.upload_pack, p._wire_kind, p._eligible_pack, p._delta_eligible)


@pytest.mark.parametrize("env,arg,bps,block", [
    ("0", "env", 16, 1024), ("1", "env", 16, 1024), ("d", "env", 16, 1024),
    (None, "env", 16, 1024), (None, "auto", 16, 1024), (None, True, 24, 1024),
    (None, "delta", 16, 1024), (None, False, 16, 1024), (None, "env", 24, 1024),
    ("1", "env", 32, 1024), ("1", "env", 16, 1016),
])
def test_upload_modes_equal_jax(env, arg, bps, block, monkeypatch):
    """FLACENC_PACKED_UPLOAD and `upload_pack` resolve as in the JAX package
    (on the CPU the unset variable leaves the upload raw, as JAX does on a
    cpu platform; "auto" forces the racer)."""
    if env is None:
        monkeypatch.delenv("FLACENC_PACKED_UPLOAD", raising=False)
    else:
        monkeypatch.setenv("FLACENC_PACKED_UPLOAD", env)
    monkeypatch.setattr(tbe, "_LINK_ESTS", {})
    monkeypatch.setattr(jbe, "_LINK_ESTS", {})
    pipe = jbe.BatchPipeline(config.Encoder(), 2, bps, block, 4, upload_pack=arg)
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, bps, block, 4, "cpu", upload_pack=arg)
    try:
        assert _modes(runner) == _modes(pipe)
    finally:
        pipe.close()


@pytest.mark.parametrize("bps,block,arg", [(32, 1024, True), (16, 1016, True),
                                           (24, 1024, "delta")])
def test_ineligible_forced_wires_raise_like_jax(bps, block, arg):
    with pytest.raises(ValueError):
        jbe.BatchPipeline(config.Encoder(), 2, bps, block, 4, upload_pack=arg)
    with pytest.raises(ValueError):
        tbe.BatchRunner(tconfig.Encoder(), 2, bps, block, 4, "cpu", upload_pack=arg)


def _cache_sequence(kind: str):
    rng = np.random.default_rng(7)
    if kind == "r":
        quiet = np.cumsum(rng.integers(-50, 51, (4, 2, 512)), -1).astype(np.int32)
        quiet[:, 0, ::97] += 9000
        quiet[:, 1, 31::89] -= 9000
        loud = rng.integers(-30000, 30000, (4, 2, 512)).astype(np.int32)
    else:
        from test_torch_upack import _correlated

        quiet = _correlated(4, 512, seed=3, spread=10)
        loud = _correlated(4, 512, seed=4, spread=4000)
    return [quiet, quiet, loud, quiet, quiet] + [quiet] * 17


@pytest.mark.parametrize("kind", ["r", "m"])
def test_plan_cache_reuse_and_rescan_equal_jax(kind, monkeypatch):
    """`_try_pack_cached` packs a steady batch from the cached plan without
    a scan, rescans on a unary overflow and every `_PLAN_RESCAN_EVERY`
    batches, and hands out the JAX pipeline's wires and payloads."""
    scans = {"port": 0}
    real = tup.try_pack
    monkeypatch.setattr(tup, "try_pack",
                        lambda *a, **k: scans.__setitem__("port", scans["port"] + 1) or real(*a, **k))
    pipe = jbe.BatchPipeline(config.Encoder(), 2, 16, 512, 4, upload_pack="auto")
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, 512, 4, "cpu", upload_pack="auto")
    try:
        seen = []
        for chunk in _cache_sequence(kind):
            got, ref = runner._try_pack_cached(chunk), pipe._try_pack_cached(chunk)
            assert (got is None) == (ref is None)
            if got is not None:
                assert got[0] == ref[0]
                for a, b in zip(got[1], ref[1]):
                    np.testing.assert_array_equal(a, b)
            seen.append((got and got[0][0], scans["port"], runner._rice_plan_age))
        assert seen[0][0] == kind and seen[1][1] == 1  # the second batch: no scan
        assert seen[2][1] == 2                       # the loud batch overflowed: rescan
        assert scans["port"] >= 3                    # an aged-out plan was rescanned
        assert (runner._rice_plan, runner._rice_plan_age) == (pipe._rice_plan,
                                                              pipe._rice_plan_age)
    finally:
        pipe.close()


def test_drain_gap_feeds_homogeneous_pairs_only(monkeypatch):
    """The racer hears a drain gap only when the drained batch and the one
    drained before it share a wire kind, and only from a saturated queue."""
    runner = tbe.BatchRunner(tconfig.Encoder(), 2, 16, 256, 2, "cpu", upload_pack=False)
    heard = []
    monkeypatch.setattr(runner._est, "update", lambda nb, s, k="raw": heard.append(k))
    monkeypatch.setattr(runner, "assemble", lambda *a: [])
    for i, kind in enumerate(("raw", "raw", "pack", "d", "d", "d")):
        b = tbe._Batch(np.zeros((2, 2, 256), np.int32), np.arange(2), 44100, None, (), None,
                       kind, 100, i)
        b.outputs = (torch.zeros((2, tbe_width(2, 256)), dtype=torch.int32),)
        runner._inflight.append(b)
    list(runner.drain())
    assert heard == ["raw", "d"]


def tbe_width(C: int, T: int) -> int:
    from flacenc_tpu_torch import constants
    from flacenc_tpu_torch.ops import rice

    P = 1 << rice.finest_partition_order(T, constants.rice.MIN_PARTITION_SIZE)
    return 1 + C * (5 + constants.qlpc.MAX_ORDER + P)


def test_racer_flips_mid_stream_change_no_bytes(monkeypatch):
    """A racer driven raw -> pack -> delta -> raw between batches changes the
    wire only: the bytes equal an all-raw encode."""
    rng = np.random.default_rng(5)
    blocks = [np.cumsum(rng.integers(-120, 121, (2, 512)), -1).astype(np.int32)
              for _ in range(8)]

    def seed(est, fastest):
        base = {"raw": 1.0, "d": 1.0, "pack": 1.0}
        base[fastest] = 0.1
        est.secs = dict(base)
        est.nbytes = {k: 1_000_000 for k in base}
        est.age = {k: 0 for k in base}
        est.t_sample = {k: time.perf_counter() for k in base}
        est.mbps = 10.0
        est._vote = (fastest, tbe._SWITCH_VOTES - 1)
        est._probe = None

    def run(schedule):
        monkeypatch.setattr(tbe, "_LINK_ESTS", {})
        r = tbe.BatchRunner(tconfig.Encoder(), 2, 16, 512, 2, "cpu", upload_pack="auto")
        assert r.upload_mode == "auto"
        frames, wires = [], []
        for i, blk in enumerate(blocks):
            seed(r._est, schedule(i))
            res = r.submit([blk], np.asarray([i]), 44100)
            wires.append(r._wire_kind)
            if res:
                frames.extend(res.frames)
        frames.extend(f for res in r.drain() for f in res.frames)
        return b"".join(f.precomputed_bitstream for f in frames), wires

    def flips(i):
        return {2: "pack", 3: "pack", 4: "d", 5: "d"}.get(i, "raw")

    # the racer warms a wire's program on the capture thread and ships on
    # raw until it is warm: warm every program of the schedule first
    run(flips)
    tbe.wait_all_warms()
    data_flip, wires = run(flips)
    data_raw, wires_raw = run(lambda i: "raw")
    assert wires[2] == "pack" and wires[4] == "d" and wires[0] == wires[7] == "raw"
    assert set(wires_raw) == {"raw"}
    assert data_flip == data_raw
