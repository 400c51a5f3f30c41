"""FLAC bitstream parser (stream -> component tree).

Mirrors ``flacenc-rs/src/component/parser.rs`` (feature "decode"):
parses `fLaC` magic, metadata blocks, and frames with per-frame CRC-16
verification. Serves as the independent round-trip oracle for the encoder
(SURVEY.md §4 tier 3) and backs the CLI `decode` subcommand.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..errors import FlacencError
from ..utils.crc import crc8, crc16
from .datatype import (
    BlockSizeSpec,
    ChannelAssignment,
    Constant,
    FixedLpc,
    Frame,
    FrameHeader,
    Lpc,
    MetadataBlock,
    QuantizedParameters,
    Residual,
    SampleRateSpec,
    SampleSizeSpec,
    Stream,
    StreamInfo,
    SubFrame,
    Verbatim,
)


class ParseError(FlacencError):
    pass


class BitReader:
    """MSB-first bit reader over bytes."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos  # bit position

    def read(self, n: int) -> int:
        end = self.pos + n
        if end > len(self.data) * 8:
            raise ParseError("unexpected end of stream")
        first_byte = self.pos >> 3
        last_byte = (end + 7) >> 3
        chunk = int.from_bytes(self.data[first_byte:last_byte], "big")
        chunk >>= (last_byte * 8) - end
        self.pos = end
        return chunk & ((1 << n) - 1)

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        assert self.pos % 8 == 0
        return self.pos >> 3

    def at_end(self) -> bool:
        return self.pos >= len(self.data) * 8


def parse_utf8like(r: BitReader) -> int:
    """utf8_code (parser.rs:382-416), reproduced exactly: heads below 0xE0
    (including 0x80-0xBF) take ONE trailing byte with acc = head & 0x1F,
    0xFF is rejected, and continuation bytes are masked (& 0x3F) without
    validation — byte-level behavior matches the reference parser."""
    head = r.read(8)
    if head < 0x80:
        return head & 0x7F
    if head < 0xE0:
        n, val = 1, head & 0x1F
    elif head < 0xF0:
        n, val = 2, head & 0x0F
    elif head < 0xF8:
        n, val = 3, head & 0x07
    elif head < 0xFC:
        n, val = 4, head & 0x03
    elif head < 0xFE:
        n, val = 5, head & 0x01
    elif head == 0xFE:
        n, val = 6, 0
    else:
        raise ParseError("invalid utf8-like head byte 0xFF")
    for _ in range(n):
        val = (val << 6) | (r.read(8) & 0x3F)
    return val


def parse_stream_info(data: bytes) -> StreamInfo:
    r = BitReader(data)
    min_bs = r.read(16)
    max_bs = r.read(16)
    min_fs = r.read(24)
    max_fs = r.read(24)
    rate = r.read(20)
    ch = r.read(3) + 1
    bps = r.read(5) + 1
    total = r.read(36)
    md5 = bytes(r.read(8) for _ in range(16))
    info = StreamInfo(rate, ch, bps)
    info.min_block_size = min_bs
    info.max_block_size = max_bs
    info.min_frame_size = min_fs
    info.max_frame_size = max_fs
    info.total_samples = total
    info.md5 = md5
    return info


def _parse_block_size_spec(r: BitReader, tag: int) -> BlockSizeSpec:
    """block_size_code (parser.rs:329-352): the WIRE tag is preserved so
    re-serialization is byte-identical (a legal stream may use tag 7 with
    extra=4095 for block size 4096 instead of the canonical tag 12)."""
    if tag == 1:
        return BlockSizeSpec(1, None, 192)
    if 2 <= tag <= 5:
        return BlockSizeSpec(tag, None, 576 << (tag - 2))
    if tag == 6:
        x = r.read(8)
        return BlockSizeSpec(6, x, x + 1)
    if tag == 7:
        x = r.read(16)
        return BlockSizeSpec(7, x, x + 1)
    if 8 <= tag <= 15:
        return BlockSizeSpec(tag, None, 256 << (tag - 8))
    raise ParseError(f"reserved block size tag {tag}")


def _parse_sample_rate_spec(r: BitReader, tag: int) -> SampleRateSpec:
    """sample_rate_code (parser.rs:354-380), wire tag preserved (tag 13
    Hz=44100 must NOT canonicalize to tag 9; Hz=0 is legal)."""
    if tag == 0:
        return SampleRateSpec.UNSPECIFIED
    if tag == 12:
        x = r.read(8)
        return SampleRateSpec(12, x, x * 1000)
    if tag == 13:
        x = r.read(16)
        return SampleRateSpec(13, x, x)
    if tag == 14:
        x = r.read(16)
        return SampleRateSpec(14, x, x * 10)
    if tag == 15:
        raise ParseError("invalid sample rate tag 15")
    return SampleRateSpec(tag, None, SampleRateSpec._TAG_TO_FREQ[tag])


def parse_frame_header(r: BitReader) -> Tuple[FrameHeader, int]:
    """Returns (header, block_size); `r` must be byte-aligned at frame start."""
    start = r.byte_pos()
    # 15-bit tag: 14-bit sync code + mandatory-zero reserved bit
    # (parser.rs:263 bit_tag(0x7FFC, 15))
    sync = r.read(15)
    if sync != 0x7FFC:
        raise ParseError(f"bad sync code {sync:#x}")
    variable = r.read(1) == 1
    bs_tag = r.read(4)
    sr_tag = r.read(4)
    ch_tag = r.read(4)
    ss_tag = r.read(3)
    if r.read(1) != 0:  # parser.rs:270 bit_tag(0, 1)
        raise ParseError("reserved frame-header bit must be zero")
    number = parse_utf8like(r)
    bs_spec = _parse_block_size_spec(r, bs_tag)
    sr_spec = _parse_sample_rate_spec(r, sr_tag)
    header_end = (r.pos + 7) >> 3
    expected_crc = r.read(8)
    actual = crc8(r.data[start : header_end])
    if actual != expected_crc:
        raise ParseError(f"frame header CRC-8 mismatch ({actual} != {expected_crc})")
    ch_info = ChannelAssignment.from_tag(ch_tag)
    if ch_info is None:
        raise ParseError(f"bad channel assignment tag {ch_tag}")
    header = FrameHeader(bs_spec, ch_info, SampleSizeSpec(ss_tag), sr_spec)
    if variable:
        header.set_start_sample_number(number)
    else:
        header.set_frame_number(number)
    return header, bs_spec.size


def parse_residual(r: BitReader, block_size: int, warmup: int) -> Residual:
    from .. import native

    if native.available():
        try:
            res = native.parse_residual(r.data, r.pos, block_size, warmup)
        except ValueError as e:
            raise ParseError(str(e))
        if res is not None:
            new_pos, order, params, q, rem = res
            r.pos = new_pos
            return Residual(
                order, block_size, warmup, params.astype(np.uint8), q, rem
            )
    method = r.read(2)
    if method > 1:
        raise ParseError(f"unsupported residual method {method}")
    param_bits = 5 if method == 1 else 4
    order = r.read(4)
    nparts = 1 << order
    part_len = block_size >> order
    if part_len << order != block_size or part_len <= 0:
        raise ParseError("invalid partition order for block size")
    rice_params = np.zeros(nparts, dtype=np.uint8)
    quotients = np.zeros(block_size, dtype=np.uint32)
    remainders = np.zeros(block_size, dtype=np.uint32)
    offset = 0
    for p in range(nparts):
        rice_p = r.read(param_bits)
        if rice_p == (1 << param_bits) - 1:
            raise ParseError("verbatim rice partitions are not supported")
        rice_params[p] = rice_p
        start = max(warmup, offset)
        offset += part_len
        for t in range(start, offset):
            quotients[t] = r.read_unary()
            remainders[t] = r.read(rice_p) if rice_p else 0
    return Residual(order, block_size, warmup, rice_params, quotients, remainders)


def _read_samples(r: BitReader, count: int, bps: int) -> np.ndarray:
    """Fixed-width signed sample run: C++ fast path (the verbatim hot
    loop, parser.rs:705-712 raw_samples) with the per-sample Python
    reader as the portable fallback / oracle."""
    from .. import native

    if count >= 8 and native.available():
        try:
            res = native.parse_samples(r.data, r.pos, count, bps)
        except ValueError as e:
            raise ParseError(str(e))
        if res is not None:
            r.pos, samples = res[0], res[1]
            return samples
    return np.asarray([r.read_signed(bps) for _ in range(count)], np.int32)


def parse_subframe(r: BitReader, block_size: int, bps: int) -> SubFrame:
    if r.read(1) != 0:
        raise ParseError("subframe header must start with 0")
    type_tag = r.read(6)
    wasted_flag = r.read(1)
    if wasted_flag:
        raise ParseError("wasted bits are not supported")
    if type_tag == 0:
        return Constant(block_size, r.read_signed(bps), bps)
    if type_tag == 1:
        return Verbatim(_read_samples(r, block_size, bps), bps)
    if (type_tag & 0x38) == 0x08 and (type_tag & 0x07) <= 4:
        order = type_tag & 0x07
        warm_up = _read_samples(r, order, bps)
        residual = parse_residual(r, block_size, order)
        return FixedLpc(warm_up, residual, bps)
    if type_tag & 0x20:
        order = (type_tag & 0x1F) + 1
        warm_up = _read_samples(r, order, bps)
        precision = r.read(4) + 1
        shift = r.read_signed(5)
        coefs = np.asarray(
            [r.read_signed(precision) for _ in range(order)], np.int16
        )
        residual = parse_residual(r, block_size, order)
        return Lpc(warm_up, QuantizedParameters(coefs, order, shift, precision), residual, bps)
    raise ParseError(f"reserved subframe type {type_tag:#x}")


def parse_frame(
    r: BitReader, stream_info: StreamInfo, verify_crc: bool = True
) -> Frame:
    frame_start = r.byte_pos()
    header, block_size = parse_frame_header(r)
    nch = (
        header.channel_assignment.channels
        if header.channel_assignment.kind == ChannelAssignment.INDEPENDENT
        else 2
    )
    base_bps = header.sample_size_spec.into_bits() or stream_info.bits_per_sample
    subframes = []
    for ch in range(nch):
        bps = base_bps + header.channel_assignment.bits_per_sample_offset(ch)
        subframes.append(parse_subframe(r, block_size, bps))
    r.align()
    body_end = r.byte_pos()
    expected = r.read(16)
    if verify_crc:
        actual = crc16(r.data[frame_start:body_end])
        if actual != expected:
            raise ParseError(f"frame CRC-16 mismatch ({actual} != {expected})")
    return Frame(header, subframes)


def parse_stream(data: bytes, verify_crc: bool = True) -> Stream:
    """parser.rs:49-87."""
    if data[:4] != b"fLaC":
        raise ParseError("missing fLaC magic")
    r = BitReader(data, 32)
    stream = None
    is_last = False
    first = True
    while not is_last:
        header_byte = r.read(8)
        is_last = bool(header_byte & 0x80)
        typetag = header_byte & 0x7F
        length = r.read(24)
        # the reader is byte-aligned here: slice the body in one step
        # (a per-byte read loop costs ~1000x more on MB-sized blocks)
        bstart = r.byte_pos()
        body = bytes(r.data[bstart : bstart + length])
        if len(body) != length:
            raise ParseError("truncated metadata block")
        r.pos += 8 * length
        if first:
            # the first metadata block must be STREAMINFO (parser.rs:55-60)
            if typetag != 0:
                raise ParseError("first metadata block is not STREAMINFO")
            info = parse_stream_info(body)
            stream = Stream(info.sample_rate, info.channels, info.bits_per_sample)
            stream.stream_info_ = info
            first = False
        else:
            # later blocks (any type, incl. a duplicate type-0) are kept
            # verbatim as opaque metadata blobs sliced by the declared
            # 24-bit length. Deliberate, spec-conformant deviation from the
            # reference, which re-parses ANY type-0 body structurally and
            # consumes 34 bytes regardless of the declared length
            # (parser.rs:97-127): on well-formed streams the two agree
            # byte-for-byte (duplicate STREAMINFO blocks declare length 34
            # and round-trip bit-exactly as Unknown here); on malformed
            # streams (type-0 with length != 34) we honor the declared
            # length, keeping re-serialization byte-identical to the input
            stream.metadata_.append(MetadataBlock(is_last, typetag, body))
    if stream is None:
        raise ParseError("missing STREAMINFO block")
    while not r.at_end():
        frame = parse_frame(r, stream.stream_info(), verify_crc)
        stream.frames_.append(frame)
    return stream
