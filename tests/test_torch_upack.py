"""Port parity for the upload wire formats (``ops/upack.py``): the port's
numpy half against the JAX package's numpy half, the port's C++ scans and
packs against its numpy copy and against the JAX package's library, and
the port's torch unpack ops against the JAX package's XLA ones, element
for element, on the same seeded payloads (orders 1-4, every field width,
rice parameters 0-25, long unary runs, 24-bit content, mixed mid/side
plane orders). All comparisons are exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu import native as jnative  # noqa: E402
from flacenc_tpu.ops import upack as jup  # noqa: E402

from flacenc_tpu_torch import native as tnative  # noqa: E402
from flacenc_tpu_torch.ops import upack as tup  # noqa: E402


def _t(a: np.ndarray) -> torch.Tensor:
    """A host payload array as the runner uploads it (u32 bits in int32)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _smooth(rng, shape, scale, lim=32767):
    return np.clip(np.cumsum(rng.integers(-scale, scale + 1, shape), -1),
                   -lim - 1, lim).astype(np.int32)


def _budget(x, order, p):
    T = x.shape[-1]
    sums = tup.scan_rice_np(x).reshape(-1, 4, 26)
    wu = -(-int((sums[:, order - 1, p] + T).max()) // 32)
    return -(-wu // 16) * 16


def _correlated(B, T, bps=16, seed=7, spread=40):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100.0
    amp = (1 << (bps - 1)) * 0.4
    base = (amp * np.sin(2 * np.pi * 331 * t[None, :]
                         * (1 + 0.002 * rng.standard_normal((B, 1))))).astype(np.int32)
    lim = 1 << (bps - 1)
    lr = [base + rng.integers(-spread, spread, (B, T)).astype(np.int32) for _ in range(2)]
    return np.clip(np.stack(lr, axis=1), -lim, lim - 1).astype(np.int32)


# ---------------------------------------------------------------------------
# host half: numpy copies, C++ scans and packs
# ---------------------------------------------------------------------------


def test_constants_match_the_jax_package():
    assert tup.WIDTHS == jup.WIDTHS and tup.ORDERS == jup.ORDERS
    assert (tup.GROUP, tup.MAX_PACK_BPS) == (jup.GROUP, jup.MAX_PACK_BPS)
    assert (tup._RICE_NP, tup._RICE_ORDERS, tup._FIRSTS_BYTES) == (
        jup._RICE_NP, jup._RICE_ORDERS, jup._FIRSTS_BYTES)
    for T in (16, 512, 4096, 32768):
        assert tup._wu_bucket(T) == jup._wu_bucket(T)


@pytest.mark.parametrize("shape", [(3, 2, 112), (1, 2, 4096), (5, 96)])
def test_scan_and_fixed_width_pack_match_jax_and_native(shape):
    rng = np.random.default_rng(7)
    for scale in (60, 120, 250, 500, 1000, 2000, 5000):
        x = np.clip(np.cumsum(rng.integers(-scale, scale, shape), -1),
                    -(2**28), 2**28).astype(np.int32)
        fmt = tup.scan(x)
        assert fmt == jup.scan(x) == tnative.scan_upload(x) == jnative.scan_upload(x)
        if fmt is None:
            continue
        ref = jup.pack(x, *fmt)
        for got in (tup.pack(x, *fmt), tnative.pack_upload(x, *fmt),
                    tnative.pack_upload(x.astype(np.int64), *fmt)):
            for a, b in zip(got, ref):
                np.testing.assert_array_equal(a, b)
    # range edges of every width, and int32 extremes (wrapping deltas)
    for w in tup.WIDTHS:
        edge = np.zeros((1, 32), np.int32)
        edge[0, 1::2] = (1 << (w - 1)) - 1
        assert tup.scan(edge) == jup.scan(edge) == tnative.scan_upload(edge)
    ext = np.zeros((1, 32), np.int32)
    ext[0, 0] = 2**31 - 1
    ext[0, 1:] = -(2**31)
    assert tup.scan(ext) == tnative.scan_upload(ext) == (1, 8)
    for a, b in zip(tnative.pack_upload(ext, 1, 8), jup.pack(ext, 1, 8)):
        np.testing.assert_array_equal(a, b)


def test_rice_scans_and_packs_match_jax_and_native():
    rng = np.random.default_rng(21)
    x = _smooth(rng, (3, 2, 512), 700)
    sums = tup.scan_rice_np(x)
    np.testing.assert_array_equal(sums, jup.scan_rice_np(x))
    np.testing.assert_array_equal(tnative.scan_rice(x), jup.scan_rice_np(x, orders=2))
    nat, mm = tnative.scan_wire(x)
    jnat, jmm = jnative.scan_wire(x)
    np.testing.assert_array_equal(nat, sums)
    np.testing.assert_array_equal(nat, jnat)
    np.testing.assert_array_equal(mm, jmm)
    # int16 storage takes the narrow entry points: same sums and packs
    nat16, mm16 = tnative.scan_wire(x.astype(np.int16))
    np.testing.assert_array_equal(nat16, nat)
    np.testing.assert_array_equal(mm16, mm)
    for order in (1, 2, 3, 4):
        for p in (0, 3, 8, 16, 25):
            wu = _budget(x, order, p)
            ref = jup.pack_rice(x, order, p, wu)
            for got in (tup.pack_rice(x, order, p, wu), tnative.pack_rice(x, order, p, wu),
                        tnative.pack_rice(x.astype(np.int16), order, p, wu)):
                for a, b in zip(got, ref):
                    np.testing.assert_array_equal(a, b)
    # unary overflow -> None on every path
    assert tup.pack_rice(x, 1, 0, 16) is None and tnative.pack_rice(x, 1, 0, 16) is None
    for sums_np, T, margin in ((sums, 512, 1.0), (sums, 512, 1.25)):
        assert tup.rice_plan(sums_np, T, margin) == jup.rice_plan(sums_np, T, margin)
    sampled, mm4 = tnative.scan_wire(x, 4)
    np.testing.assert_array_equal(mm4, mm)  # the min/max stay exact at any stride
    np.testing.assert_array_equal(sampled, jnative.scan_wire(x, 4)[0])


def _try_pack_inputs():
    rng = np.random.default_rng(3)
    t = np.arange(4 * 1024, dtype=np.float64)
    tone = np.round(18000 * np.sin(2 * np.pi * 220 / 44100 * t)
                    + 40 * np.sin(2 * np.pi * 6000 / 44100 * t)).astype(np.int32)
    hi_t = np.arange(512 * 6) / 96000.0
    hi = (np.round(4e6 * np.sin(2 * np.pi * 196 * hi_t) + 2e6 * np.sin(2 * np.pi * 392.7 * hi_t))
          .astype(np.int64) + rng.integers(-12, 13, 512 * 6))
    return {
        "tonal mono (rice)": (tone.reshape(4, 1, 1024), 16),
        "correlated stereo (mid/side)": (_correlated(4, 1024), 16),
        "smooth stereo": (_smooth(rng, (4, 2, 512), 120), 16),
        "16-bit noise (raw)": (rng.integers(-32768, 32768, (2, 2, 64)).astype(np.int32), 16),
        "24-bit noise (wide)": ((rng.integers(-32768, 32768, (2, 2, 64)) << 8).astype(np.int32),
                                24),
        "24-bit oversampled (order 3)": (
            np.clip(hi, -(1 << 23), (1 << 23) - 1).astype(np.int32).reshape(6, 1, 512), 24),
        "32-bit (never packed)": (rng.integers(-5, 5, (2, 2, 64)).astype(np.int32), 32),
    }


@pytest.mark.parametrize("name", list(_try_pack_inputs()))
def test_try_pack_matches_jax(name):
    x, bps = _try_pack_inputs()[name]
    got, ref = tup.try_pack(x, bps), jup.try_pack(x, bps)
    assert (got is None) == (ref is None)
    if got is None:
        return
    assert got[0] == ref[0]
    for a, b in zip(got[1], ref[1]):
        np.testing.assert_array_equal(a, b)
    # int16 storage packs the same for bps <= 16
    if bps <= 16:
        narrow = tup.try_pack(x.astype(np.int16), bps)
        assert narrow[0] == got[0]
        for a, b in zip(narrow[1], got[1]):
            np.testing.assert_array_equal(a, b)


def test_ms_and_delta_host_halves_match_jax():
    x = _correlated(3, 512)
    m, s = tup.ms_planes(x)
    jm, js = jup.ms_planes(x)
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(s, js)
    plans = tup.plan_ms(tup.scan_rice_np(m), tup.scan_rice_np(s), 512)
    assert plans == jup.plan_ms(jup.scan_rice_np(m), jup.scan_rice_np(s), 512)
    (om, pm, wum), (os2, ps, wus), _ = plans
    got, ref = tup.pack_ms(x, om, pm, wum, os2, ps, wus), jup.pack_ms(x, om, pm, wum, os2, ps, wus)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tup.pad_ms_unary(got, wum, wus, wum + 16, wus + 48),
                    jup.pad_ms_unary(ref, wum, wus, wum + 16, wus + 48)):
        np.testing.assert_array_equal(a, b)
    for order in (1, 2):
        (w1, (d1, f1)), (w2, (d2, f2)) = tup.pack_delta(x, order), jup.pack_delta(x, order)
        assert w1 == w2 and d1.dtype == np.int16
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(f1, f2)


# ---------------------------------------------------------------------------
# device half: torch unpack ops against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", tup.ORDERS)
def test_unpack_fixed_width_matches_jax(order):
    rng = np.random.default_rng(1)
    for width in tup.WIDTHS:
        T = 512 if width % 2 else 256
        lim = 1 << (width - 1)
        d = rng.integers(-lim, lim, (3, 2, T), np.int64)
        d[..., :order] = 0
        x = d.copy()
        for _ in range(order):
            x = np.cumsum(x, -1)
        x = (x + rng.integers(-20000, 20000, (3, 2, 1))).astype(np.int32)
        words, firsts = tnative.pack_upload(x, order, width)
        got = tup.unpack(_t(words), _t(firsts), T, order, width).numpy()
        ref = np.asarray(jup.unpack(words, firsts, T, order, width))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, x)
    ext = np.zeros((1, 32), np.int32)
    ext[0, 0] = 2**31 - 1
    ext[0, 1:] = -(2**31)
    w, f = tup.pack(ext, 1, 8)
    np.testing.assert_array_equal(tup.unpack(_t(w), _t(f), 32, 1, 8).numpy(), ext)


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_unpack_rice_matches_jax_for_every_parameter(order):
    """p = 0..25 at one order each: small p makes long unary runs (up to
    thousands of zero bits a sample), large p empty ones; 24-bit content."""
    rng = np.random.default_rng(40 + order)
    T = 256
    x = _smooth(rng, (2, 2, T), 3000, lim=(1 << 23) - 1)
    for p in range(26):
        wu = _budget(x, order, p)
        lo, unary, firsts = tnative.pack_rice(x, order, p, wu)
        got = tup.unpack_rice(_t(lo), _t(unary), _t(firsts), T, order, p).numpy()
        ref = np.asarray(jup.unpack_rice(lo, unary, firsts, T, order, p))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, x)


def test_unpack_ms_and_delta_match_jax():
    T = 512
    ext = np.zeros((1, 2, T), np.int32)  # full-scale anti-correlated: s spans 17 bits
    ext[0, 0, 0::2] = 32767
    ext[0, 1, 0::2] = -32768
    ext[0, 0, 1::2] = -32768
    ext[0, 1, 1::2] = 32767
    rng = np.random.default_rng(44)
    t = np.arange(T * 4) / 96000.0
    base = np.round(3e6 * np.sin(2 * np.pi * 220 * t)).astype(np.int64)
    mixed = np.stack([  # mid plane order >= 3 (4 warm-up lanes), side <= 2
        np.clip(base + rng.integers(-9, 10, T * 4), -(1 << 23), (1 << 23) - 1)
        .astype(np.int32).reshape(4, T) for _ in range(2)], axis=1)
    for x in (_correlated(3, T), ext, _correlated(2, T, bps=24, spread=5000), mixed):
        m, s = tup.ms_planes(x)
        (om, pm, wum), (os2, ps, wus), _ = tup.plan_ms(tup.scan_rice_np(m),
                                                       tup.scan_rice_np(s), T)
        payload = tup.pack_ms(x, om, pm, wum, os2, ps, wus)
        for fm, fs, pl in ((wum, wus, payload),
                           (wum + 16, wus + 48, tup.pad_ms_unary(payload, wum, wus,
                                                                 wum + 16, wus + 48))):
            got = tup.unpack_ms(*map(_t, pl), T, om, pm, fm, os2, ps, fs).numpy()
            ref = np.asarray(jup.unpack_ms(*pl, T, om, pm, fm, os2, ps, fs))
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, x)
    m, s = tup.ms_planes(mixed)
    assert tup.rice_plan(tup.scan_rice_np(m), T)[0] >= 3
    assert tup.rice_plan(tup.scan_rice_np(s), T)[0] <= 2

    cases = [
        _smooth(rng, (3, 2, 256), 300),
        rng.integers(-32768, 32768, (2, 2, 256)).astype(np.int32),
        np.tile(np.array([-32768, 32767], np.int32), 128)[None, None],
    ]
    for order in (1, 2):
        for x in cases:
            _, (d, f) = tup.pack_delta(x, order)
            got = tup.unpack_delta(_t(d), _t(f), x.shape[-1], order).numpy()
            ref = np.asarray(jup.unpack_delta(d, f, x.shape[-1], order))
            np.testing.assert_array_equal(got, ref)
            np.testing.assert_array_equal(got, x)


def test_unpack_wire_dispatch_and_uint32_inputs():
    """`unpack_wire` takes each wire's payload (u32 words as uint32 tensors
    too) and reports how many inputs it consumed."""
    rng = np.random.default_rng(5)
    x = _smooth(rng, (2, 2, 256), 200)
    cases = [(("d", 2), tup.pack_delta(x, 2)[1])]
    for wire_payload in (tup.try_pack(x, 16), tup.try_pack(_correlated(2, 256), 16)):
        cases.append(wire_payload)
    order, width = tup.scan(x)
    cases.append((("w", order, width), tup.pack(x, order, width)))
    for wire, payload in cases:
        want = x if wire[0] != "m" else _correlated(2, 256)
        blocks, n = tup.unpack_wire(wire, [torch.from_numpy(np.ascontiguousarray(a))
                                           for a in payload], 256)
        assert n == len(payload)
        np.testing.assert_array_equal(blocks.numpy(), want)
    with pytest.raises(ValueError):
        tup.unpack_wire(("z", 1), [], 256)
