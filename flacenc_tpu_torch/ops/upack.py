"""Packed host->device wire formats for PCM uploads (port of ``flacenc_tpu/ops/upack.py``).

The host may ship a batch's PCM in a packed form instead of raw int16 /
int32 samples; the device reconstructs the exact blocks with static-shape
integer ops before the encoder runs, so output bytes never depend on the
wire. The host ships fixed-order delta residuals `d[t] = diff^order(x)[t]`
(orders 1-4, FLAC's own fixed-predictor range); warm-up values travel
separately as int32 ([x0, x1] for orders 1-2, the four difference warm-ups
(Δ^j x)[j] for orders 3-4), in one of these forms:

("w", order, width) — fixed width: little-endian `width`-bit two's
complement fields, width in {8..12, 14, 16, 18, 20} (odd widths need
T % 32 == 0). The widths above 12 only matter for hi-res input (bps 17-24).

("r", order, p, Wu) — rice coded: the zigzag z of the deltas splits into a
fixed p-bit low plane (same field layout) and a unary quotient substream
(q = z >> p as q zeros then a one, LSB first, zero padded to the static per
row word budget Wu). Decoding needs no sequential bit cursor: the t-th
terminator one-bit is the t-th smallest position of a set bit, found by one
sort per row (`unpack_rice`).

("m", om, pm, wum, os, ps, wus) — mid/side rice (stereo only): the FLAC
m = (l+r)>>1, s = l-r transform first, then an independent rice plane each,
concatenated into the same three-array payload as "r". Decoding is two
plane decodes and the exact inversion l = m + ((s + (s&1)) >> 1), r = l - s.

("d", order) — delta16: the deltas as plain int16 (the same nominal bytes as
raw PCM, near-zero host CPU); wrapping int16 deltas reconstruct exactly for
bps <= 16, because equality mod 2^16 is equality when x fits int16.

`try_pack` picks the smallest dense wire for a batch from one fused C++ scan
(`native.scan_wire`), or None when nothing beats the raw upload; the numpy
functions here are the portable path and the parity oracle of the C++
passes. The device half (`unpack`, `unpack_rice`, `unpack_ms`,
`unpack_delta`) is plain torch ops, as it was XLA ops in JAX. torch has no
shifts on uint32, so u32 values are held in int64 with `& 0xFFFFFFFF`, and
the wrapping int32 arithmetic of the JAX reconstruction is done in int64
and wrapped back to int32 once per step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# allowed field widths, narrowest first: 8-12 cover 16-bit material; 14-20
# cover hi-res (bps <= 24) deltas (width 16 only pays there: for bps <= 16
# it equals the raw int16 upload and try_pack rejects it)
WIDTHS = (8, 9, 10, 11, 12, 14, 16, 18, 20)
ORDERS = (1, 2)              # delta orders of the fixed-width wire
# block sizes must be a multiple of GROUP (even widths' bit groups divide
# 16 samples); the odd widths (9, 11) also need T % 32 == 0
GROUP = 16
# widest PCM the packed wires accept: deltas of bps-bit samples span bps+2
# bits and the rice zigzag must fit uint32 on both sides of the wire
MAX_PACK_BPS = 24

_U32 = 0xFFFFFFFF


def words_per_block(T: int, width: int) -> int:
    if T % GROUP != 0:
        raise ValueError(f"block size must be a multiple of {GROUP} (got {T})")
    return T * width // 32


def _deltas(x: np.ndarray, order: int) -> np.ndarray:
    """diff^order with the first `order` entries zeroed (wrapping int32)."""
    d = x.astype(np.int32)
    for _ in range(order):
        nxt = np.zeros_like(d)
        # numpy int32 subtraction wraps, as the C++ pack and the device's
        # wrapping reconstruction do
        nxt[..., 1:] = d[..., 1:] - d[..., :-1]
        d = nxt
    d[..., :order] = 0
    return d


def width_from_minmax(lo1: int, hi1: int, lo2: int, hi2: int,
                      T: int) -> Optional[Tuple[int, int]]:
    """Narrowest fitting (order, width) from precomputed delta ranges
    (`scan`'s rules applied to `native.scan_wire`'s min/max); ties prefer
    the lower order."""
    best = None
    for order, lo, hi in ((1, lo1, hi1), (2, lo2, hi2)):
        for w in WIDTHS:
            if (T * w) % 32 != 0:
                continue
            if lo >= -(1 << (w - 1)) and hi <= (1 << (w - 1)) - 1:
                if best is None or w < best[1]:
                    best = (order, w)
                break
    return best


def scan(chunk: np.ndarray) -> Optional[Tuple[int, int]]:
    """Narrowest fitting (order, width) for the batch, or None (raw).
    numpy oracle of `native.scan_upload`; ties prefer the lower order."""
    x = chunk.astype(np.int32)
    if x.shape[-1] < 2:
        return None
    T = x.shape[-1]
    best = None
    for order in ORDERS:
        d = _deltas(x, order)
        lo, hi = (int(d.min()), int(d.max())) if d.size else (0, 0)
        for w in WIDTHS:
            if (T * w) % 32 != 0:
                continue
            if lo >= -(1 << (w - 1)) and hi <= (1 << (w - 1)) - 1:
                if best is None or w < best[1]:
                    best = (order, w)
                break
    return best


def _pack_fields(u: np.ndarray, width: int) -> np.ndarray:
    """(..., T) unsigned fields of `width` bits -> (..., T*width/32) uint32
    words, field t at bits [t*width, (t+1)*width) of the row's
    little-endian bitstream (per group of lcm(width, 32) bits)."""
    G = np.lcm(width, 32) // width
    Wg = G * width // 32
    ug = u.reshape(u.shape[:-1] + (-1, G)).astype(np.uint64)
    words = np.zeros(ug.shape[:-1] + (Wg,), np.uint64)
    for j in range(G):
        bit = j * width
        k, off = bit // 32, bit % 32
        words[..., k] |= (ug[..., j] << off) & np.uint64(_U32)
        if off + width > 32:
            words[..., k + 1] |= ug[..., j] >> (32 - off)
    return words.astype(np.uint32).reshape(u.shape[:-1] + (u.shape[-1] * width // 32,))


def _firsts2(x: np.ndarray) -> np.ndarray:
    """(..., 2) int32 [x0, x1] (x1 = x0 for one-sample rows)."""
    firsts = np.zeros(x.shape[:-1] + (2,), np.int32)
    firsts[..., 0] = x[..., 0]
    firsts[..., 1] = x[..., 1] if x.shape[-1] > 1 else x[..., 0]
    return firsts


def pack(chunk: np.ndarray, order: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(..., T) int -> ((..., T*width/32) uint32 words, (..., 2) int32
    firsts). numpy oracle of `native.pack_upload`."""
    x = chunk.astype(np.int32)
    words_per_block(x.shape[-1], width)
    u = _deltas(x, order).astype(np.uint32) & np.uint32((1 << width) - 1)
    return np.ascontiguousarray(_pack_fields(u, width)), _firsts2(x)


# rice-coded wire ("r"): zigzag z of the order-`order` delta stream, a fixed
# p-bit low plane and a unary quotient substream padded to a static per-row
# word budget Wu

_RICE_NP = 26   # candidate rice parameters 0..25 (24-bit deltas -> 27-bit z)
_RICE_ORDERS = 4  # delta orders 1..4
_FIRSTS_BYTES = 8  # per-row int32 x2 (orders 1-2; orders 3-4 ship 4)


def firsts_width(order: int) -> int:
    """Per-row firsts lanes: [x0, x1] for orders 1-2, the four difference
    warm-ups [x0, (Δx)[1], (Δ²x)[2], (Δ³x)[3]] for orders 3-4."""
    return 2 if order <= 2 else 4


def _warmups(x: np.ndarray, order: int) -> np.ndarray:
    """(..., 4) int32 difference warm-ups: entry j is (Δ^j x)[j], what
    `_reconstruct`'s level-by-level cumsum re-integrates."""
    d = x.astype(np.int32)
    out = np.zeros(x.shape[:-1] + (4,), np.int32)
    out[..., 0] = d[..., 0]
    for j in range(1, 4):
        nxt = np.zeros_like(d)
        nxt[..., 1:] = d[..., 1:] - d[..., :-1]
        d = nxt
        out[..., j] = d[..., j] if d.shape[-1] > j else 0
    return out


def _wu_bucket(T: int) -> int:
    """Unary-budget rounding (words): coarse enough that program keys stay
    stable across batches, fine enough that padding stays under ~1
    bit/sample."""
    return max(16, T // 64)


def _zigzag(d: np.ndarray) -> np.ndarray:
    return ((d.astype(np.int64) << 1) ^ (d.astype(np.int64) >> 63)).astype(np.uint32)


def scan_rice_np(chunk: np.ndarray, orders: int = _RICE_ORDERS) -> np.ndarray:
    """numpy oracle of the native rice scans: (..., orders, 26) int64
    S[..., order-1, p] = sum_t(zigzag(delta_order)[t] >> p)."""
    x = chunk.astype(np.int32)
    out = np.zeros(x.shape[:-1] + (orders, _RICE_NP), np.int64)
    for order in range(1, orders + 1):
        z = _zigzag(_deltas(x, order)).astype(np.int64)
        for p in range(_RICE_NP):
            out[..., order - 1, p] = (z >> p).sum(axis=-1)
    return out


def rice_plan(sums: np.ndarray, T: int, wu_margin: float = 1.0):
    """(order, p, Wu, wire_bytes) from scan sums, or None.

    Exact accounting: lo plane rows*(T*p/32)*4 bytes + unary plane rows*Wu*4
    (Wu = the batch's largest row budget, bucketed) + firsts; p keeps
    T*p % 32 == 0. `wu_margin` > 1 pads the winner's unary budget (for
    sampled sums); formats are ranked by their unpadded cost."""
    n_orders = sums.shape[-2]
    flat = sums.reshape(-1, n_orders, _RICE_NP)
    R = flat.shape[0]
    bucket = _wu_bucket(T)
    best = None
    for order in range(1, n_orders + 1):
        if order >= T:
            continue  # warm-ups would cover the whole block
        fb = firsts_width(order) * 4
        for p in range(_RICE_NP):
            if (T * p) % 32 != 0:
                continue
            row_bits = flat[:, order - 1, p] + T  # unary bits per row
            wu = int(-(-int(row_bits.max()) // 32))
            wu = -(-wu // bucket) * bucket
            nbytes = R * ((T * p // 32) * 4 + wu * 4 + fb)
            if best is None or nbytes < best[3]:
                best = (order, p, wu, nbytes)
    if best is not None and wu_margin > 1.0:
        order, p, wu, nbytes = best
        pad = int(-(-int(wu * wu_margin) // bucket)) * bucket
        best = (order, p, pad, R * ((T * p // 32) * 4 + pad * 4 + firsts_width(order) * 4))
    return best


def pack_rice(chunk: np.ndarray, order: int, p: int, wu: int):
    """numpy oracle of `native.pack_rice`: (..., T) -> (lo (..., T*p/32)
    u32, unary (..., wu) u32, firsts (..., firsts_width(order)) i32), or
    None if a row overflows the unary budget."""
    x = chunk.astype(np.int32)
    T = x.shape[-1]
    z = _zigzag(_deltas(x, order))
    q = (z >> p).astype(np.int64)
    ubits = q.sum(axis=-1) + T
    if ubits.max() > wu * 32:
        return None
    if p:
        lo = _pack_fields(z & np.uint32((1 << p) - 1), p)
    else:
        lo = np.zeros(x.shape[:-1] + (0,), np.uint32)
    # terminator one-bit positions are prefix sums of (q + 1); LSB-first bit
    # order, so little-endian packbits gives little-endian u32 words
    unary = np.zeros(x.shape[:-1] + (wu * 32,), np.uint8)
    term = np.cumsum(q + 1, axis=-1) - 1
    np.put_along_axis(unary, term, 1, axis=-1)
    unary = (
        np.ascontiguousarray(np.packbits(unary, axis=-1, bitorder="little"))
        .view(np.uint32)
        .reshape(x.shape[:-1] + (wu,))
    )
    firsts = _firsts2(x) if order <= 2 else _warmups(x, order)
    return lo, unary, firsts


def ms_planes(chunk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """FLAC mid/side transform of a (B, 2, T) stereo chunk: two contiguous
    (B, T) int32 planes m = (l+r)>>1, s = l-r (coding.rs:469-527)."""
    l = chunk[:, 0].astype(np.int64)
    r = chunk[:, 1].astype(np.int64)
    m = np.ascontiguousarray(((l + r) >> 1).astype(np.int32))
    s = np.ascontiguousarray((l - r).astype(np.int32))
    return m, s


def plan_ms(sums_m: np.ndarray, sums_s: np.ndarray, T: int):
    """Per-plane rice plans: (plan_m, plan_s, total_bytes) or None, each
    plan (order, p, Wu) chosen independently."""
    pm = rice_plan(sums_m, T)
    ps = rice_plan(sums_s, T)
    if pm is None or ps is None:
        return None
    return pm[:3], ps[:3], pm[3] + ps[3]


def _pk_for(order: int):
    """pack_rice for this delta order: the C++ pass when the library loads
    (with the order-3/4 layout), the numpy oracle otherwise."""
    from .. import native

    if native.available() and (order <= 2 or native.rice4_supported()):
        return native.pack_rice
    return pack_rice


def pack_ms(chunk: np.ndarray, om: int, pm: int, wum: int,
            os2: int, ps: int, wus: int, planes=None):
    """The ("m", om, pm, wum, os2, ps, wus) wire: the mid/side transform,
    then an independent rice plane each, concatenated into (lo (B, Lm+Ls)
    u32, unary (B, wum+wus) u32, firsts (B, Fm+Fs) i32). None if either
    plane overflows its budget. `planes` passes precomputed (m, s)."""
    m, s = ms_planes(chunk) if planes is None else planes
    a = _pk_for(om)(m, om, pm, wum)
    if a is None:
        return None
    b = _pk_for(os2)(s, os2, ps, wus)
    if b is None:
        return None
    return tuple(np.concatenate([u, v], axis=-1) for u, v in zip(a, b))


def pad_ms_unary(payload, wum: int, wus: int, fm: int, fs: int):
    """Re-pad an ms payload's unary planes to the sticky floors (fm >= wum,
    fs >= wus); zero words past a plane's terminators are decode-inert."""
    lo, unary, firsts = payload
    segs = [unary[..., :wum]]
    if fm > wum:
        segs.append(np.zeros(unary.shape[:-1] + (fm - wum,), np.uint32))
    segs.append(unary[..., wum:])
    if fs > wus:
        segs.append(np.zeros(unary.shape[:-1] + (fs - wus,), np.uint32))
    return lo, np.concatenate(segs, axis=-1), firsts


def _ms_plan_for(chunk: np.ndarray, bps: int):
    """Scan-only ms planning: ((m, s) planes, (plan_m, plan_s), bytes), or
    None when the chunk is not eligible stereo."""
    from .. import native

    if chunk.ndim != 3 or chunk.shape[1] != 2 or bps > MAX_PACK_BPS or chunk.shape[-1] < 2:
        return None
    T = chunk.shape[-1]
    planes = ms_planes(chunk)
    m, s = planes
    fm = native.scan_wire(m)
    if fm is not NotImplemented:
        sums_m = fm[0]
        sums_s = native.scan_wire(s)[0]
    else:
        sums_m = scan_rice_np(m)
        sums_s = scan_rice_np(s)
    plans = plan_ms(np.asarray(sums_m), np.asarray(sums_s), T)
    if plans is None:
        return None
    return planes, plans[:2], plans[2]


def pack_delta(chunk: np.ndarray, order: int = 2):
    """The ("d", order) wire: order-`order` wrapping deltas as plain int16.
    Returns (wire, (deltas int16, firsts int32))."""
    x = np.asarray(chunk, dtype=np.int16)  # int16 chunks pass without a copy
    d = x
    for _ in range(order):
        nxt = np.zeros_like(d)
        nxt[..., 1:] = d[..., 1:] - d[..., :-1]  # int16 wraps
        d = nxt
    d[..., :order] = 0
    return ("d", order), (d, _firsts2(x))


def try_pack(chunk: np.ndarray, bps: int = 16):
    """Adaptive pack: (wire, payload) or None (upload raw).

    The smallest wire wins: fixed width when the data is near
    incompressible, rice when entropy coding pays, mid/side rice on
    correlated stereo, raw when nothing beats the plain upload (int16 for
    bps <= 16, int32 above). One fused C++ scan (`native.scan_wire`) and a
    C++ pack when the library loads, the numpy oracle otherwise."""
    from .. import native

    if bps > MAX_PACK_BPS:
        return None
    T = chunk.shape[-1]
    rows = chunk.size // T if T else 0
    if rows == 0 or T < 2:
        return None
    fused = native.scan_wire(chunk)
    use_native = fused is not NotImplemented
    if use_native:
        sums, mm = fused
        fmt = width_from_minmax(int(mm[0]), int(mm[1]), int(mm[2]), int(mm[3]), T)
    else:
        fmt = scan(chunk)
        sums = scan_rice_np(chunk)
    raw_bytes = rows * T * (2 if bps <= 16 else 4)
    width_bytes = None
    if fmt is not None:
        width_bytes = rows * ((T * fmt[1] // 32) * 4 + _FIRSTS_BYTES)
        if width_bytes >= raw_bytes:
            fmt = width_bytes = None  # a wide field can lose to raw
    rice = rice_plan(np.asarray(sums), T)
    if rice is not None and rice[3] >= raw_bytes:
        rice = None
    ms = _ms_plan_for(chunk, bps)
    if ms is not None and ms[2] < min(
            x for x in (raw_bytes, width_bytes, rice[3] if rice else None) if x is not None):
        planes, ((om, pm, wum), (os2, ps, wus)), _ = ms
        packed = pack_ms(chunk, om, pm, wum, os2, ps, wus, planes=planes)
        if packed is not None:
            return ("m", om, pm, wum, os2, ps, wus), packed
    if rice is not None and (width_bytes is None or rice[3] < width_bytes):
        r_order, p, wu, _ = rice
        packed = _pk_for(r_order)(chunk, r_order, p, wu)
        if packed is not None:
            return ("r", r_order, p, wu), packed
    if fmt is None:
        return None
    order, width = fmt
    packed = native.pack_upload(chunk, order, width) if use_native else pack(chunk, order, width)
    return ("w", order, width), packed


# ---------------------------------------------------------------------------
# Device half: torch ops on the uploaded payload
# ---------------------------------------------------------------------------


def _u32(t: torch.Tensor) -> torch.Tensor:
    """u32 words (a uint32 tensor, or its bits in an int32 one) as int64."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    return t.to(torch.int64) & _U32


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the same value mod 2^32 in [-2^31, 2^31), still int64."""
    return ((v + (1 << 31)) & _U32) - (1 << 31)


def _extract_fields(words: torch.Tensor, T: int, width: int) -> torch.Tensor:
    """LSB-first fixed-width field extraction: (..., T*width/32) u32 words
    -> (..., T) int64 fields in [0, 2^width) (static shifts, no gathers)."""
    G = int(np.lcm(width, 32)) // width
    Wg = G * width // 32
    w = _u32(words)
    g = w.reshape(w.shape[:-1] + (-1, Wg))
    mask = (1 << width) - 1
    fields = []
    for j in range(G):
        bit = j * width
        k, off = bit // 32, bit % 32
        v = g[..., k] >> off if off else g[..., k]
        if off + width > 32:
            v = v | (g[..., k + 1] << (32 - off))
        fields.append(v & mask)
    return torch.stack(fields, dim=-1).reshape(w.shape[:-1] + (T,))


def _reconstruct(d: torch.Tensor, firsts: torch.Tensor, T: int, order: int) -> torch.Tensor:
    """Delta reconstruction, exact in wrapping int32 arithmetic (the true
    x fits int32, so equality mod 2^32 is equality): order 1 is x0 +
    cumsum(d); order 2 the closed form x0 + t*(x1-x0) + cumsum(cumsum(d));
    orders 3-4 integrate level by level, each pass seeding slot j-1 with
    its warm-up (an out-of-place update) before the cumsum. Returns int32."""
    d = d.to(torch.int64)
    f = firsts.to(torch.int64)
    x0 = f[..., :1]
    if order == 1:
        y = x0 + torch.cumsum(d, dim=-1)
    elif order == 2:
        t = torch.arange(T, dtype=torch.int64, device=d.device)
        c = _wrap32(torch.cumsum(_wrap32(torch.cumsum(d, dim=-1)), dim=-1))
        y = x0 + t * (f[..., 1:2] - x0) + c
    else:
        y = d
        idx = torch.arange(T, device=d.device)
        for j in range(order, 0, -1):
            y = torch.where(idx == j - 1, f[..., j - 1:j], y)
            y = _wrap32(torch.cumsum(y, dim=-1))
    return _wrap32(y).to(torch.int32)


def unpack(words: torch.Tensor, firsts: torch.Tensor, T: int,
           order: int = 1, width: int = 12) -> torch.Tensor:
    """Inverse of `pack`: (..., W) u32 words -> (..., T) int32."""
    u = _extract_fields(words, T, width)
    sign = 1 << (width - 1)
    return _reconstruct((u ^ sign) - sign, firsts, T, order)


def unpack_delta(d: torch.Tensor, firsts: torch.Tensor, T: int, order: int) -> torch.Tensor:
    """Inverse of `pack_delta`: the reconstruction of the sign-extended
    wrapped int16 deltas is congruent to x mod 2^16, so a final wrap to
    int16 recovers x exactly (|x| < 2^15). Returns int32."""
    v = _reconstruct(d.to(torch.int32), firsts, T, order).to(torch.int64)
    return (((v & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int32)


def unpack_rice(lo: torch.Tensor, unary: torch.Tensor, firsts: torch.Tensor,
                T: int, order: int, p: int) -> torch.Tensor:
    """Inverse of `pack_rice`, decoded in parallel by sort compaction: the
    position of sample t's terminator one-bit is the t-th smallest of
    {j : bit j set}, taken from one sort per row (ones keyed by position,
    zeros pushed past the end; the keys are distinct), so
    q_t = pos_t - pos_{t-1} - 1 with static shapes. Zero padding past the
    T-th terminator sorts into the dropped tail. Returns int32."""
    u = _u32(unary)
    lead = u.shape[:-1]
    U = u.shape[-1] * 32
    shifts = torch.arange(32, dtype=torch.int64, device=u.device)
    bits = ((u[..., None] >> shifts) & 1).reshape(lead + (U,))
    j = torch.arange(U, dtype=torch.int64, device=u.device)
    key = torch.where(bits == 1, j, U + j)
    pos = torch.sort(key, dim=-1).values[..., :T]
    prev = torch.cat([torch.full(lead + (1,), -1, dtype=torch.int64, device=u.device),
                      pos[..., :-1]], dim=-1)
    z = ((pos - prev - 1) << p) & _U32
    if p:
        z = z | _extract_fields(lo, T, p)
    d = (z >> 1) ^ -(z & 1)
    return _reconstruct(d, firsts, T, order)


def unpack_ms(lo: torch.Tensor, unary: torch.Tensor, firsts: torch.Tensor,
              T: int, om: int, pm: int, wum: int,
              os2: int, ps: int, wus: int) -> torch.Tensor:
    """Inverse of `pack_ms`: per-plane rice decode at static slice
    boundaries (Lm = T*pm/32 low words, wum unary words, firsts_width(om)
    firsts), then l = m + ((s + (s&1)) >> 1), r = l - s (l+r and l-r share
    parity, so the floor the forward transform dropped is recoverable).
    Returns (B, 2, T) int32."""
    Lm = T * pm // 32
    Fm = firsts_width(om)
    m = unpack_rice(lo[..., :Lm], unary[..., :wum], firsts[..., :Fm], T, om, pm)
    s = unpack_rice(lo[..., Lm:], unary[..., wum:], firsts[..., Fm:], T, os2, ps)
    m64, s64 = m.to(torch.int64), s.to(torch.int64)
    l = m64 + ((s64 + (s64 & 1)) >> 1)
    return torch.stack([l, l - s64], dim=1).to(torch.int32)


def unpack_wire(wire, payload, T: int) -> Tuple[torch.Tensor, int]:
    """The blocks a wire's payload carries, on the payload's device, and
    how many leading inputs the payload took: (blocks (B, C, T), n)."""
    kind = wire[0]
    if kind == "r":
        _, order, p, _wu = wire
        return unpack_rice(payload[0], payload[1], payload[2], T, order, p), 3
    if kind == "m":
        _, om, pm, wum, os2, ps, wus = wire
        return unpack_ms(payload[0], payload[1], payload[2], T, om, pm, wum, os2, ps, wus), 3
    if kind == "d":
        return unpack_delta(payload[0], payload[1], T, wire[1]), 2
    if kind == "w":
        _, order, width = wire
        return unpack(payload[0], payload[1], T, order, width), 2
    raise ValueError(f"unknown upload wire {wire!r}")
