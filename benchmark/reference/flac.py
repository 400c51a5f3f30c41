"""Plain FLAC bitstream pieces: the CRCs, a frame writer, a frame reader
and decoder, the STREAMINFO reader and a scan that finds every frame of a
fixed-blocksize stream.

Written from the FLAC format specification (RFC 9639); the bit layout of
each subframe and of the Rice-coded residual follows flacenc-rs
``src/component/bitrepr.rs``. Imports nothing but NumPy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .dsp import zigzag


def _crc_table(poly: int, width: int) -> List[int]:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = []
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) & mask if c & top else (c << 1) & mask
        table.append(c)
    return table


_CRC8 = _crc_table(0x07, 8)
_CRC16 = _crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = _CRC8[c ^ b]
    return c


def crc16(data: bytes) -> int:
    c = 0
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ _CRC16[(c >> 8) ^ b]
    return c


BLOCK_SIZE_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9, 1024: 10,
                    2048: 11, 4096: 12, 8192: 13, 16384: 14, 32768: 15}
RATE_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6, 24000: 7,
              32000: 8, 44100: 9, 48000: 10, 96000: 11}
BPS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
# channel assignment codes of a stereo frame
INDEPENDENT, LEFT_SIDE, RIGHT_SIDE, MID_SIDE = 1, 8, 9, 10


def utf8_number(v: int) -> bytes:
    """The frame number in FLAC's extended UTF-8 coding."""
    if v < 0x80:
        return bytes([v])
    for n, limit in ((2, 1 << 11), (3, 1 << 16), (4, 1 << 21), (5, 1 << 26), (6, 1 << 31),
                     (7, 1 << 36)):
        if v < limit:
            break
    out = []
    for _ in range(n - 1):
        out.append(0x80 | (v & 0x3F))
        v >>= 6
    head = (0xFF << (8 - n)) & 0xFF
    return bytes([head | v] + out[::-1])


def frame_header(block_size: int, rate: int, assign: int, bps: int, number: int) -> bytes:
    """A fixed-blocksize frame header with its CRC-8."""
    bs_code = BLOCK_SIZE_CODES.get(block_size, 6 if block_size <= 256 else 7)
    if rate in RATE_CODES:
        rate_code, rate_extra = RATE_CODES[rate], b""
    elif rate % 1000 == 0 and rate // 1000 <= 0xFF:
        rate_code, rate_extra = 12, bytes([rate // 1000])
    elif rate % 10 == 0 and rate // 10 <= 0xFFFF:
        rate_code, rate_extra = 14, (rate // 10).to_bytes(2, "big")
    else:
        rate_code, rate_extra = 13, rate.to_bytes(2, "big")
    body = bytes([0xFF, 0xF8, (bs_code << 4) | rate_code, (assign << 4) | (BPS_CODES.get(bps, 0) << 1)])
    body += utf8_number(number)
    if bs_code == 6:
        body += bytes([block_size - 1])
    elif bs_code == 7:
        body += (block_size - 1).to_bytes(2, "big")
    body += rate_extra
    return body + bytes([crc8(body)])


# --------------------------------------------------------------------------
# Subframes as the encoder describes them
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Subframe:
    """One coded channel: kind "constant", "verbatim", "fixed" or "lpc".
    `samples` is the channel's signal (constant: its first sample holds the
    value); `residual` the predictor's errors, `rice_order` / `rice_params`
    the partition order and the parameter of each partition."""

    kind: str
    bps: int
    samples: np.ndarray
    order: int = 0
    qcoefs: Optional[np.ndarray] = None
    precision: int = 0
    shift: int = 0
    residual: Optional[np.ndarray] = None
    rice_order: int = 0
    rice_params: Optional[np.ndarray] = None

    def residual_bits(self) -> int:
        n = len(self.samples)
        nparts = 1 << self.rice_order
        ps = np.repeat(self.rice_params.astype(np.int64), n >> self.rice_order)
        q = (zigzag(self.residual).astype(np.int64) >> ps)[self.order:]
        param_bits = 5 if int(self.rice_params.max()) > 14 else 4
        return 6 + nparts * param_bits + int(q.sum()) + len(q) + int(ps[self.order:].sum())

    def bits(self) -> int:
        if self.kind == "constant":
            return 8 + self.bps
        if self.kind == "verbatim":
            return 8 + len(self.samples) * self.bps
        head = 8 + self.bps * self.order
        if self.kind == "lpc":
            head += 4 + 5 + self.precision * self.order
        return head + self.residual_bits()


def _fields_to_bits(values: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """MSB-first bits of each unsigned value in its width, concatenated. A
    value wider than 64 bits is 1 after zeros (a unary code)."""
    widths = widths.astype(np.int64)
    total = int(widths.sum())
    idx = np.repeat(np.arange(len(widths)), widths)
    starts = np.cumsum(widths) - widths
    pos = np.arange(total, dtype=np.int64) - starts[idx]
    shift = np.minimum(widths[idx] - 1 - pos, 63).astype(np.uint64)
    return ((values.astype(np.uint64)[idx] >> shift) & np.uint64(1)).astype(np.uint8)


def _twoc(v, w: int) -> np.ndarray:
    return np.asarray(v, dtype=np.int64) & ((1 << w) - 1)


def _subframe_fields(sf: Subframe) -> Tuple[list, list]:
    vals, wids = [], []

    def put(v, w):
        v = np.atleast_1d(np.asarray(v, dtype=np.int64))
        vals.append(v)
        wids.append(np.full(len(v), w, dtype=np.int64) if np.ndim(w) == 0 else np.asarray(w))

    if sf.kind == "constant":
        put(0x00, 8)
        put(_twoc(sf.samples[0], sf.bps), sf.bps)
        return vals, wids
    if sf.kind == "verbatim":
        put(0x02, 8)
        put(_twoc(sf.samples, sf.bps), sf.bps)
        return vals, wids
    if sf.kind == "fixed":
        put(0x10 | (sf.order << 1), 8)
    else:
        put(0x40 | ((sf.order - 1) << 1), 8)
    if sf.order:
        put(_twoc(sf.samples[: sf.order], sf.bps), sf.bps)
    if sf.kind == "lpc":
        put(sf.precision - 1, 4)
        put(_twoc(sf.shift, 5), 5)
        put(_twoc(sf.qcoefs[: sf.order], sf.precision), sf.precision)
    rice2 = int(sf.rice_params.max()) > 14
    put(((1 if rice2 else 0) << 4) | sf.rice_order, 6)
    n = len(sf.samples)
    part = n >> sf.rice_order
    z = zigzag(sf.residual).astype(np.int64)
    for p, rp in enumerate(sf.rice_params.astype(np.int64)):
        put(int(rp), 5 if rice2 else 4)
        zz = z[max(p * part, sf.order):(p + 1) * part]
        q = zz >> rp
        # q zeros and the stop bit, then the low rp bits
        vals.append(np.stack([np.ones_like(q), zz & ((1 << int(rp)) - 1)], 1).ravel())
        wids.append(np.stack([q + 1, np.full_like(q, rp)], 1).ravel())
    return vals, wids


def write_frame(header: bytes, subframes: Sequence[Subframe]) -> bytes:
    """Frame bytes: header, subframes, zero padding to a byte, CRC-16."""
    vals, wids = [np.frombuffer(header, np.uint8).astype(np.int64)], [np.full(len(header), 8)]
    for sf in subframes:
        v, w = _subframe_fields(sf)
        vals += v
        wids += w
    bits = _fields_to_bits(np.concatenate(vals), np.concatenate(wids))
    body = np.packbits(bits).tobytes()
    c = crc16(body)
    return body + bytes([c >> 8, c & 0xFF])


# --------------------------------------------------------------------------
# Reading
# --------------------------------------------------------------------------


class FormatError(ValueError):
    """Bytes that are not the FLAC the reader expects."""


@dataclasses.dataclass
class StreamInfo:
    min_block: int
    max_block: int
    min_frame: int
    max_frame: int
    rate: int
    channels: int
    bps: int
    total_samples: int
    md5: bytes
    frames_at: int  # byte offset of the first frame


def read_streaminfo(data: bytes) -> StreamInfo:
    """STREAMINFO of a stream; the metadata blocks after it are skipped."""
    if data[:4] != b"fLaC":
        raise FormatError("no fLaC marker")
    pos, info, last = 4, None, False
    while not last:
        if pos + 4 > len(data):
            raise FormatError("metadata runs past the end")
        last, kind = bool(data[pos] & 0x80), data[pos] & 0x7F
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + size]
        if kind == 0:
            if size != 34 or info is not None:
                raise FormatError("bad STREAMINFO block")
            v = int.from_bytes(body[10:18], "big")
            info = dict(min_block=int.from_bytes(body[0:2], "big"),
                        max_block=int.from_bytes(body[2:4], "big"),
                        min_frame=int.from_bytes(body[4:7], "big"),
                        max_frame=int.from_bytes(body[7:10], "big"),
                        rate=v >> 44, channels=((v >> 41) & 7) + 1, bps=((v >> 36) & 31) + 1,
                        total_samples=v & ((1 << 36) - 1), md5=bytes(body[18:34]))
        pos += 4 + size
    if info is None:
        raise FormatError("no STREAMINFO")
    return StreamInfo(frames_at=pos, **info)


def _read_utf8(data: bytes, pos: int) -> Tuple[int, int]:
    b = data[pos]
    if b < 0x80:
        return b, pos + 1
    n = 0
    while n < 8 and b & (0x80 >> n):
        n += 1
    if n < 2 or n > 7:
        raise FormatError("bad coded number")
    v = b & (0x7F >> n) if n < 7 else 0
    for k in range(1, n):
        c = data[pos + k]
        if c & 0xC0 != 0x80:
            raise FormatError("bad coded number")
        v = (v << 6) | (c & 0x3F)
    return v, pos + n


@dataclasses.dataclass
class Header:
    block_size: int
    assign: int
    number: int
    length: int  # header bytes, CRC-8 included


_BS_OF_CODE = {v: k for k, v in BLOCK_SIZE_CODES.items()}
_BPS_OF_CODE = {v: k for k, v in BPS_CODES.items()}


def read_header(data: bytes, pos: int, rate: int, bps: int) -> Header:
    """The fixed-blocksize frame header at `pos`, checked against the
    stream's rate and depth and against its CRC-8."""
    if pos + 6 > len(data) or data[pos] != 0xFF or data[pos + 1] != 0xF8:
        raise FormatError("no frame sync")
    bs_code, rate_code = data[pos + 2] >> 4, data[pos + 2] & 15
    assign, bps_code = data[pos + 3] >> 4, (data[pos + 3] >> 1) & 7
    if data[pos + 3] & 1 or bs_code == 0 or rate_code == 15 or assign > 10:
        raise FormatError("reserved header field")
    number, p = _read_utf8(data, pos + 4)
    if bs_code == 6:
        block_size, p = data[p] + 1, p + 1
    elif bs_code == 7:
        block_size, p = int.from_bytes(data[p:p + 2], "big") + 1, p + 2
    else:
        block_size = _BS_OF_CODE[bs_code]
    p += {12: 1, 13: 2, 14: 2}.get(rate_code, 0)
    if rate_code and rate_code < 12 and RATE_CODES.get(rate) != rate_code:
        raise FormatError("sample rate differs from STREAMINFO")
    if bps_code and _BPS_OF_CODE.get(bps_code) != bps:
        raise FormatError("sample size differs from STREAMINFO")
    if crc8(data[pos:p]) != data[p]:
        raise FormatError("header CRC-8")
    return Header(block_size, assign, number, p + 1 - pos)


def index_frames(data: bytes, info: StreamInfo) -> List[Tuple[int, int, Header]]:
    """[(start, end, header)] of every frame, in order: each frame starts
    at the first sync after the previous header whose header reads as the
    next frame number with a valid CRC-8, and the last one ends with the
    data. Raises FormatError where that chain breaks."""
    raw = np.frombuffer(data, np.uint8)
    syncs = np.flatnonzero((raw[:-1] == 0xFF) & (raw[1:] == 0xF8))
    syncs = syncs[syncs >= info.frames_at]
    out, pos, k = [], info.frames_at, 0
    while pos < len(data):
        h = read_header(data, pos, info.rate, info.bps)
        if h.number != len(out):
            raise FormatError(f"frame {len(out)} carries number {h.number}")
        nxt = len(data)
        k = int(np.searchsorted(syncs, pos + h.length))
        while k < len(syncs):
            try:
                if read_header(data, int(syncs[k]), info.rate, info.bps).number == len(out) + 1:
                    nxt = int(syncs[k])
                    break
            except (FormatError, IndexError, KeyError):
                pass
            k += 1
        out.append((pos, nxt, h))
        pos = nxt
    return out


class _Bits:
    def __init__(self, data: bytes, pos_bits: int):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = pos_bits
        ones = np.flatnonzero(self.bits)
        # next_one[i]: the first 1 at or after bit i
        self.next_one = np.full(len(self.bits) + 1, len(self.bits), dtype=np.int64)
        self.next_one[ones] = ones
        self.next_one = np.minimum.accumulate(self.next_one[::-1])[::-1]

    def u(self, w: int) -> int:
        if w == 0:
            return 0
        if self.pos + w > len(self.bits):
            raise FormatError("frame runs past its end")
        v = 0
        for b in self.bits[self.pos:self.pos + w]:
            v = (v << 1) | int(b)
        self.pos += w
        return v

    def s(self, w: int) -> int:
        v = self.u(w)
        return v - (1 << w) if w and v >> (w - 1) else v

    def signed_array(self, n: int, w: int) -> np.ndarray:
        if self.pos + n * w > len(self.bits):
            raise FormatError("frame runs past its end")
        chunk = self.bits[self.pos:self.pos + n * w].reshape(n, w).astype(np.int64)
        self.pos += n * w
        v = chunk @ (1 << np.arange(w - 1, -1, -1, dtype=np.int64))
        return np.where(v >> (w - 1) == 1, v - (1 << w), v)

    def rice(self, n: int, p: int) -> np.ndarray:
        stops = np.empty(n, dtype=np.int64)
        pos, nxt, end = self.pos, self.next_one, len(self.bits)
        for i in range(n):
            s = nxt[pos]
            if s >= end:
                raise FormatError("residual runs past its end")
            stops[i] = s
            pos = s + 1 + p
        if pos > end:
            raise FormatError("residual runs past its end")
        starts = np.concatenate([[self.pos], stops[:-1] + 1 + p]) if n else stops
        q = stops - starts
        r = np.zeros(n, dtype=np.int64)
        for j in range(p):
            r = (r << 1) | self.bits[stops + 1 + j]
        self.pos = pos
        z = (q << p) | r
        return np.where(z & 1, -(z >> 1) - 1, z >> 1)


def _subframe(br: _Bits, n: int, bps: int) -> np.ndarray:
    if br.u(1):
        raise FormatError("subframe padding bit set")
    kind = br.u(6)
    if br.u(1):
        raise FormatError("wasted bits are not written by this encoder")
    if kind == 0:
        return np.full(n, br.s(bps), dtype=np.int64)
    if kind == 1:
        return br.signed_array(n, bps)
    coefs, shift = None, 0
    if 8 <= kind <= 12:
        order = kind - 8
    elif kind >= 32:
        order = kind - 31
    else:
        raise FormatError(f"reserved subframe type {kind}")
    x = np.zeros(n, dtype=np.int64)
    x[:order] = br.signed_array(order, bps) if order else []
    if kind >= 32:
        precision = br.u(4) + 1
        if precision == 16:
            raise FormatError("invalid QLPC precision")
        shift = br.s(5)
        coefs = br.signed_array(order, precision)
    method = br.u(2)
    if method > 1:
        raise FormatError("reserved residual coding method")
    porder = br.u(4)
    part = n >> porder
    res = np.zeros(n, dtype=np.int64)
    for p in range(1 << porder):
        rp = br.u(5 if method else 4)
        if rp == (31 if method else 15):
            raise FormatError("escaped partitions are not written by this encoder")
        lo = max(p * part, order)
        res[lo:(p + 1) * part] = br.rice((p + 1) * part - lo, rp)
    if coefs is None:
        # the fixed predictors of orders 0-4 as LPC coefficients, shift 0
        c = [[], [1], [2, -1], [3, -3, 1], [4, -6, 4, -1]][order]
    else:
        c = [int(v) for v in coefs]
    out = x[:order].tolist()
    for t in range(order, n):
        acc = 0
        for k in range(order):
            acc += c[k] * out[t - 1 - k]
        out.append(int(res[t]) + (acc >> shift))
    return np.asarray(out, dtype=np.int64)


def decode_frame(frame: bytes, rate: int, bps: int, channels: int) -> np.ndarray:
    """(block size, channels) int64 samples of one frame, after its header
    CRC-8 and its CRC-16 are checked."""
    if len(frame) < 8 or crc16(frame[:-2]) != int.from_bytes(frame[-2:], "big"):
        raise FormatError("frame CRC-16")
    h = read_header(frame, 0, rate, bps)
    n = h.block_size
    if channels == 2:
        extra = {LEFT_SIDE: (0, 1), RIGHT_SIDE: (1, 0), MID_SIDE: (0, 1)}.get(h.assign, (0, 0))
        if h.assign not in (INDEPENDENT, LEFT_SIDE, RIGHT_SIDE, MID_SIDE):
            raise FormatError("not a stereo assignment")
    else:
        if h.assign != channels - 1:
            raise FormatError("channel count differs from STREAMINFO")
        extra = (0,) * channels
    br = _Bits(frame[:-2], 8 * h.length)
    subs = [_subframe(br, n, bps + e) for e in extra]
    if len(br.bits) - br.pos >= 8 or br.bits[br.pos:].any():
        raise FormatError("frame padding is not zero")
    if channels == 2:
        a, b = subs
        if h.assign == LEFT_SIDE:
            subs = [a, a - b]
        elif h.assign == RIGHT_SIDE:
            subs = [a + b, b]
        elif h.assign == MID_SIDE:
            m = (a << 1) | (b & 1)
            subs = [(m + b) >> 1, (m - b) >> 1]
    return np.stack(subs, axis=1)
