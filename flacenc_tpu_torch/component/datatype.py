"""FLAC component model (AST) with exact bit-layout serialization.

Python mirror of ``flacenc-rs/src/component/datatype.rs`` and
``bitrepr.rs``: every component knows its exact encoded size
(``count_bits``) and how to serialize itself MSB-first (``write``).
`Residual` holds numpy arrays so device-computed batches can be wrapped
without copies. The C++ packer produces byte-identical output on the fast
path; these methods are the readable oracle.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Iterable, List, Optional, Sequence, Union

import numpy as np

from .. import constants
from ..bitio import BitSink
from ..errors import RangeError, VerifyError
from ..utils.crc import crc8, crc16
from ..utils.utf8like import encode_to_utf8like, utf8like_bytesize


# ---------------------------------------------------------------------------
# Frame-header specifier enums (datatype.rs:1218-1544)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockSizeSpec:
    """Block-size field of a frame header (datatype.rs:1218-1295)."""

    tag: int
    extra: Optional[int]  # value written in the trailing 8/16-bit field
    size: int

    @staticmethod
    def from_size(size: int) -> "BlockSizeSpec":
        if size == 192:
            return BlockSizeSpec(1, None, size)
        if size in (576, 1152, 2304, 4608):
            return BlockSizeSpec(2 + (size // 576).bit_length() - 1, None, size)
        if size in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768):
            return BlockSizeSpec(8 + (size // 256).bit_length() - 1, None, size)
        if size <= 256:
            return BlockSizeSpec(6, size - 1, size)
        return BlockSizeSpec(7, size - 1, size)

    def count_extra_bits(self) -> int:
        return {6: 8, 7: 16}.get(self.tag, 0)

    def write_extra_bits(self, dest: BitSink) -> None:
        if self.tag == 6:
            dest.write_lsbs(self.extra, 8)
        elif self.tag == 7:
            dest.write_lsbs(self.extra, 16)


@dataclasses.dataclass(frozen=True)
class SampleSizeSpec:
    """Sample-size (bps) field of a frame header (datatype.rs:1304-1375)."""

    tag: int

    _BITS_TO_TAG = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
    _TAG_TO_BITS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

    UNSPECIFIED: ClassVar["SampleSizeSpec"]  # set below

    @staticmethod
    def from_bits(bits: int) -> "SampleSizeSpec":
        tag = SampleSizeSpec._BITS_TO_TAG.get(bits)
        return SampleSizeSpec(tag) if tag is not None else SampleSizeSpec(0)

    def into_bits(self) -> Optional[int]:
        return self._TAG_TO_BITS.get(self.tag)


SampleSizeSpec.UNSPECIFIED = SampleSizeSpec(0)


@dataclasses.dataclass(frozen=True)
class SampleRateSpec:
    """Sample-rate field of a frame header (datatype.rs:1384-1544)."""

    tag: int
    extra: Optional[int]
    freq: Optional[int]

    _COMMON = {
        88_200: 1, 176_400: 2, 192_000: 3, 8_000: 4, 16_000: 5, 22_050: 6,
        24_000: 7, 32_000: 8, 44_100: 9, 48_000: 10, 96_000: 11,
    }
    _TAG_TO_FREQ = {v: k for k, v in _COMMON.items()}

    UNSPECIFIED: ClassVar["SampleRateSpec"]  # set below

    @staticmethod
    def from_freq(freq: int) -> Optional["SampleRateSpec"]:
        tag = SampleRateSpec._COMMON.get(freq)
        if tag is not None:
            return SampleRateSpec(tag, None, freq)
        # KHz, then DaHz, then Hz (from_freq order in datatype.rs:1432-1459)
        if freq % 1000 == 0 and freq // 1000 <= 0xFF:
            return SampleRateSpec(12, freq // 1000, freq)
        if freq % 10 == 0 and freq // 10 <= 0xFFFF:
            return SampleRateSpec(14, freq // 10, freq)
        if freq <= 0xFFFF:
            return SampleRateSpec(13, freq, freq)
        return None

    def count_extra_bits(self) -> int:
        return {12: 8, 13: 16, 14: 16}.get(self.tag, 0)

    def write_extra_bits(self, dest: BitSink) -> None:
        if self.tag == 12:
            dest.write_lsbs(self.extra, 8)
        elif self.tag in (13, 14):
            dest.write_lsbs(self.extra, 16)


SampleRateSpec.UNSPECIFIED = SampleRateSpec(0, None, None)


class ChannelAssignment:
    """Channel assignment (datatype.rs:1083-1197)."""

    __slots__ = ("kind", "channels")

    INDEPENDENT = "independent"
    LEFT_SIDE = "left_side"
    RIGHT_SIDE = "right_side"
    MID_SIDE = "mid_side"

    def __init__(self, kind: str, channels: int = 2) -> None:
        self.kind = kind
        self.channels = channels

    @staticmethod
    def independent(ch: int) -> "ChannelAssignment":
        return ChannelAssignment(ChannelAssignment.INDEPENDENT, ch)

    @staticmethod
    def left_side() -> "ChannelAssignment":
        return ChannelAssignment(ChannelAssignment.LEFT_SIDE)

    @staticmethod
    def right_side() -> "ChannelAssignment":
        return ChannelAssignment(ChannelAssignment.RIGHT_SIDE)

    @staticmethod
    def mid_side() -> "ChannelAssignment":
        return ChannelAssignment(ChannelAssignment.MID_SIDE)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, ChannelAssignment)
            and self.kind == other.kind
            and (self.kind != self.INDEPENDENT or self.channels == other.channels)
        )

    def __repr__(self) -> str:
        if self.kind == self.INDEPENDENT:
            return f"Independent({self.channels})"
        return self.kind

    def tag(self) -> int:
        if self.kind == self.INDEPENDENT:
            return self.channels - 1
        return {self.LEFT_SIDE: 0x8, self.RIGHT_SIDE: 0x9, self.MID_SIDE: 0xA}[self.kind]

    @staticmethod
    def from_tag(tag: int) -> Optional["ChannelAssignment"]:
        if 0 <= tag < 8:
            return ChannelAssignment.independent(tag + 1)
        return {
            0x8: ChannelAssignment.left_side(),
            0x9: ChannelAssignment.right_side(),
            0xA: ChannelAssignment.mid_side(),
        }.get(tag)

    def bits_per_sample_offset(self, ch: int) -> int:
        """Side channels store one extra bit (datatype.rs:1145-1160)."""
        side_ch = {self.LEFT_SIDE: 1, self.RIGHT_SIDE: 0, self.MID_SIDE: 1}.get(self.kind)
        return 1 if side_ch == ch else 0

    def select_channels(self, l, r, m, s):
        """Pick the two stored subframes for this mode (datatype.rs:1174-1192)."""
        if self.kind == self.INDEPENDENT:
            return (l, r)
        if self.kind == self.LEFT_SIDE:
            return (l, s)
        if self.kind == self.RIGHT_SIDE:
            return (s, r)
        return (m, s)

    def count_bits(self) -> int:
        return 4

    def write(self, dest: BitSink) -> None:
        if self.kind == self.INDEPENDENT and self.channels > 8:
            raise RangeError("#channel", "cannot exceed 8", self.channels)
        dest.write_lsbs(self.tag(), 4)


# ---------------------------------------------------------------------------
# Residual (datatype.rs:2266-2413, bitrepr.rs:530-597)
# ---------------------------------------------------------------------------


class Residual:
    """Partitioned-Rice-coded residual signal."""

    __slots__ = (
        "partition_order", "block_size", "warmup_length", "rice_params",
        "quotients", "remainders", "sum_quotients", "sum_rice_params",
    )

    def __init__(
        self,
        partition_order: int,
        block_size: int,
        warmup_length: int,
        rice_params: Sequence[int],
        quotients: np.ndarray,
        remainders: np.ndarray,
    ) -> None:
        self.partition_order = int(partition_order)
        self.block_size = int(block_size)
        self.warmup_length = int(warmup_length)
        self.rice_params = np.asarray(rice_params, dtype=np.uint8)
        self.quotients = np.ascontiguousarray(quotients, dtype=np.uint32)
        self.remainders = np.ascontiguousarray(remainders, dtype=np.uint32)
        if len(self.rice_params) != 1 << self.partition_order:
            raise ValueError(
                f"rice_params must have 2**partition_order entries: got "
                f"{len(self.rice_params)} for order {self.partition_order}"
            )
        # cached sums (datatype.rs:2326-2332)
        self.sum_quotients = int(self.quotients.sum(dtype=np.uint64))
        self.sum_rice_params = int(self.rice_params.sum(dtype=np.uint64))

    @property
    def nparts(self) -> int:
        return 1 << self.partition_order

    def uses_rice2(self) -> bool:
        return bool((self.rice_params[: self.nparts] > 14).any())

    def count_bits(self) -> int:
        """Exact encoded size (bitrepr.rs:533-543)."""
        quotient_bits = self.sum_quotients + self.block_size - self.warmup_length
        remainder_bits = self.sum_rice_params * (self.block_size >> self.partition_order)
        remainder_bits -= self.warmup_length * int(self.rice_params[0])
        param_bits = 5 if self.uses_rice2() else 4
        return 2 + 4 + self.nparts * param_bits + quotient_bits + remainder_bits

    def write(self, dest: BitSink) -> None:
        nparts = self.nparts
        use_rice2 = self.uses_rice2()
        method_bits, param_bits = (1, 5) if use_rice2 else (0, 4)
        dest.write_lsbs((method_bits << 4) | self.partition_order, 6)
        part_len = self.block_size >> self.partition_order
        quotients = self.quotients
        remainders = self.remainders
        offset = 0
        for p in range(nparts):
            rice_p = int(self.rice_params[p])
            dest.write_lsbs(rice_p, param_bits)
            start = max(self.warmup_length, offset)
            offset += part_len
            startbit = 1 << rice_p
            for t in range(start, offset):
                dest.write_zeros(int(quotients[t]))
                dest.write_lsbs(int(remainders[t]) | startbit, rice_p + 1)

    def decode(self) -> np.ndarray:
        """Inverse zigzag of quotient/remainder pairs (decode.rs:220-238)."""
        ps = np.repeat(
            self.rice_params[: self.nparts].astype(np.uint64),
            self.block_size >> self.partition_order,
        )
        z = (self.quotients.astype(np.uint64) << ps) | self.remainders
        v = (z >> np.uint64(1)).astype(np.int64)
        neg = (z & np.uint64(1)) == 1
        out = np.where(neg, -(v + 1), v).astype(np.int32)
        out[: self.warmup_length] = 0
        return out


# ---------------------------------------------------------------------------
# Subframes (datatype.rs:1782-2264)
# ---------------------------------------------------------------------------


class Constant:
    """Constant subframe (datatype.rs:1820-1891)."""

    __slots__ = ("block_size", "dc_offset", "bits_per_sample")

    def __init__(self, block_size: int, dc_offset: int, bits_per_sample: int) -> None:
        self.block_size = int(block_size)
        self.dc_offset = int(dc_offset)
        self.bits_per_sample = int(bits_per_sample)

    def count_bits(self) -> int:
        return 8 + self.bits_per_sample

    def write(self, dest: BitSink) -> None:
        dest.write_lsbs(0x00, 8)
        dest.write_twoc(self.dc_offset, self.bits_per_sample)

    def decode(self) -> np.ndarray:
        return np.full(self.block_size, self.dc_offset, dtype=np.int32)


class Verbatim:
    """Verbatim subframe (datatype.rs:1893-1962)."""

    __slots__ = ("samples", "bits_per_sample")

    def __init__(self, samples: np.ndarray, bits_per_sample: int) -> None:
        self.samples = np.array(samples, dtype=np.int32, copy=True)
        self.bits_per_sample = int(bits_per_sample)

    @staticmethod
    def count_bits_from_metadata(block_size: int, bits_per_sample: int) -> int:
        return 8 + block_size * bits_per_sample

    def count_bits(self) -> int:
        return self.count_bits_from_metadata(len(self.samples), self.bits_per_sample)

    def write(self, dest: BitSink) -> None:
        dest.write_lsbs(0x02, 8)
        bps = self.bits_per_sample
        for v in self.samples:
            dest.write_twoc(int(v), bps)

    def decode(self) -> np.ndarray:
        return self.samples.copy()


class FixedLpc:
    """Fixed-predictor subframe (datatype.rs:1964-2052)."""

    __slots__ = ("warm_up", "residual", "bits_per_sample")

    def __init__(self, warm_up: Sequence[int], residual: Residual, bits_per_sample: int) -> None:
        self.warm_up = np.array(warm_up, dtype=np.int32, copy=True)
        if len(self.warm_up) > constants.fixed.MAX_LPC_ORDER:
            raise ValueError(
                f"fixed-LPC warm_up length {len(self.warm_up)} exceeds "
                f"MAX_LPC_ORDER={constants.fixed.MAX_LPC_ORDER}"
            )
        self.residual = residual
        self.bits_per_sample = int(bits_per_sample)

    @property
    def order(self) -> int:
        return len(self.warm_up)

    def count_bits(self) -> int:
        return 8 + self.bits_per_sample * self.order + self.residual.count_bits()

    def write(self, dest: BitSink) -> None:
        dest.write_lsbs(0x10 | (self.order << 1), 8)
        for v in self.warm_up:
            dest.write_twoc(int(v), self.bits_per_sample)
        self.residual.write(dest)


class QuantizedParameters:
    """Quantized LPC coefficients (datatype.rs:2161-2264)."""

    __slots__ = ("coefs", "order", "shift", "precision")

    def __init__(self, coefs: Sequence[int], order: int, shift: int, precision: int) -> None:
        self.coefs = np.asarray(coefs[:order], dtype=np.int16)
        self.order = int(order)
        self.shift = int(shift)
        self.precision = int(precision)

    def dequantized(self) -> np.ndarray:
        return self.coefs.astype(np.float64) / (2.0 ** self.shift)


class Lpc:
    """Quantized-LPC subframe (datatype.rs:2054-2159)."""

    __slots__ = ("warm_up", "parameters", "residual", "bits_per_sample")

    def __init__(
        self,
        warm_up: Sequence[int],
        parameters: QuantizedParameters,
        residual: Residual,
        bits_per_sample: int,
    ) -> None:
        self.warm_up = np.array(warm_up, dtype=np.int32, copy=True)
        self.parameters = parameters
        self.residual = residual
        self.bits_per_sample = int(bits_per_sample)

    @property
    def order(self) -> int:
        return self.parameters.order

    def count_bits(self) -> int:
        return (
            8
            + self.bits_per_sample * self.order
            + 4
            + 5
            + self.parameters.precision * self.order
            + self.residual.count_bits()
        )

    def write(self, dest: BitSink) -> None:
        dest.write_lsbs(0x40 | ((self.order - 1) << 1), 8)
        for v in self.warm_up[: self.order]:
            dest.write_twoc(int(v), self.bits_per_sample)
        if not self.parameters.precision < 16:
            raise ValueError(
                f"QLPC precision {self.parameters.precision} must be < 16"
            )
        dest.write_lsbs(self.parameters.precision - 1, 4)
        if self.parameters.shift < 0:
            raise ValueError("negative QLPC shift is unsupported")
        dest.write_twoc(self.parameters.shift, 5)
        for c in self.parameters.coefs:
            dest.write_twoc(int(c), self.parameters.precision)
        self.residual.write(dest)


SubFrame = Union[Constant, Verbatim, FixedLpc, Lpc]


# ---------------------------------------------------------------------------
# Frame header / frame (datatype.rs:1546-1775, 817-1077)
# ---------------------------------------------------------------------------


class FrameHeader:
    """FLAC frame header (fixed- or variable-blocking)."""

    __slots__ = (
        "variable_block_size", "block_size_spec", "channel_assignment",
        "sample_size_spec", "sample_rate_spec", "frame_number",
        "start_sample_number",
    )

    def __init__(
        self,
        block_size_spec: BlockSizeSpec,
        channel_assignment: ChannelAssignment,
        sample_size_spec: SampleSizeSpec,
        sample_rate_spec: SampleRateSpec,
    ) -> None:
        # from_specs defaults to variable blocking (datatype.rs:1560-1576);
        # encoders flip to fixed via set_frame_number.
        self.variable_block_size = True
        self.block_size_spec = block_size_spec
        self.channel_assignment = channel_assignment
        self.sample_size_spec = sample_size_spec
        self.sample_rate_spec = sample_rate_spec
        self.frame_number = 0
        self.start_sample_number = 0

    def block_size(self) -> int:
        return self.block_size_spec.size

    def is_variable_blocking(self) -> bool:
        return self.variable_block_size

    def set_frame_number(self, n: int) -> None:
        self.variable_block_size = False
        self.frame_number = n

    def set_start_sample_number(self, n: int) -> None:
        self.variable_block_size = True
        self.start_sample_number = n

    def reset_channel_assignment(self, ch: ChannelAssignment) -> None:
        self.channel_assignment = ch

    def count_bits(self) -> int:
        ret = 40
        if self.variable_block_size:
            ret += 8 * utf8like_bytesize(self.start_sample_number)
        else:
            ret += 8 * utf8like_bytesize(self.frame_number)
        ret += self.block_size_spec.count_extra_bits()
        ret += self.sample_rate_spec.count_extra_bits()
        return ret

    def to_bytes(self) -> bytes:
        """Header bytes including trailing CRC-8 (bitrepr.rs:373-419)."""
        sink = BitSink()
        header_word = 0xFFF8 + (1 if self.variable_block_size else 0)
        sink.write_lsbs(header_word, 16)
        sink.write_lsbs((self.block_size_spec.tag << 4) | self.sample_rate_spec.tag, 8)
        self.channel_assignment.write(sink)
        sink.write_lsbs(self.sample_size_spec.tag << 1, 4)
        if self.variable_block_size:
            sink.write_bytes_aligned(encode_to_utf8like(self.start_sample_number))
        else:
            sink.write_bytes_aligned(encode_to_utf8like(self.frame_number))
        self.block_size_spec.write_extra_bits(sink)
        self.sample_rate_spec.write_extra_bits(sink)
        body = sink.as_bytes()
        return body + bytes([crc8(body)])

    def write(self, dest: BitSink) -> None:
        dest.write_bytes_aligned(self.to_bytes())


class Frame:
    """FLAC frame: header + subframes + optional cached bitstream."""

    __slots__ = ("header_", "subframes_", "precomputed_bitstream")

    def __init__(self, header: FrameHeader, subframes: List[SubFrame]) -> None:
        self.header_ = header
        self.subframes_ = subframes
        self.precomputed_bitstream: Optional[bytes] = None

    def header(self) -> FrameHeader:
        return self.header_

    def header_mut(self) -> FrameHeader:
        self.precomputed_bitstream = None
        return self.header_

    def subframes(self) -> List[SubFrame]:
        return self.subframes_

    def subframe(self, ch: int) -> Optional[SubFrame]:
        return self.subframes_[ch] if ch < len(self.subframes_) else None

    def add_subframe(self, sub: SubFrame) -> None:
        self.precomputed_bitstream = None
        self.subframes_.append(sub)

    def block_size(self) -> int:
        return self.header_.block_size()

    def to_frame_bytes(self) -> bytes:
        """Serialize this frame standalone: header+subframes, byte-aligned,
        with trailing CRC-16 (bitrepr.rs:289-320)."""
        if self.precomputed_bitstream is not None:
            return self.precomputed_bitstream
        sink = BitSink()
        self.header_.write(sink)
        for sub in self.subframes_:
            sub.write(sink)
        sink.align_to_byte()
        body = sink.as_bytes()
        c = crc16(body)
        return body + bytes([c >> 8, c & 0xFF])

    def precompute_bitstream(self) -> None:
        if self.precomputed_bitstream is None:
            self.precomputed_bitstream = self.to_frame_bytes()

    def count_bits(self) -> int:
        if self.precomputed_bitstream is not None:
            return len(self.precomputed_bitstream) * 8
        header = self.header_.count_bits()
        body = sum(s.count_bits() for s in self.subframes_)
        aligned = ((header + body + 7) >> 3) << 3
        return aligned + 16

    def write(self, dest: BitSink) -> None:
        dest.write_bytes_aligned(self.to_frame_bytes())

    def into_stereo_channels(self):
        if len(self.subframes_) != 2:
            raise ValueError("into_stereo_channels requires 2 channels")
        return self.header_, self.subframes_[0], self.subframes_[1]


# ---------------------------------------------------------------------------
# Metadata / stream (datatype.rs:65-815)
# ---------------------------------------------------------------------------


class StreamInfo:
    """STREAMINFO metadata block body (datatype.rs:433-815)."""

    __slots__ = (
        "min_block_size", "max_block_size", "min_frame_size", "max_frame_size",
        "sample_rate", "channels", "bits_per_sample", "total_samples", "md5",
    )

    def __init__(self, sample_rate: int, channels: int, bits_per_sample: int) -> None:
        if not (1 <= sample_rate < (1 << 20)):
            raise VerifyError("stream_info.sample_rate", "must fit in 20 bits and be nonzero")
        if not (1 <= channels <= constants.MAX_CHANNELS):
            raise VerifyError("stream_info.channels", "must be in 1..=8")
        if not (constants.MIN_BITS_PER_SAMPLE <= bits_per_sample <= constants.MAX_BITS_PER_SAMPLE):
            raise VerifyError("stream_info.bits_per_sample", "must be in 8..=24")
        self.min_block_size = 0xFFFF
        self.max_block_size = 0
        self.min_frame_size = 0xFFFFFFFF
        self.max_frame_size = 0
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits_per_sample = bits_per_sample
        self.total_samples = 0
        self.md5 = bytes(16)

    def update_frame_info(self, frame: Frame) -> None:
        """Fold one frame's sizes into the stats (datatype.rs:514-523)."""
        block_size = frame.block_size()
        self.min_block_size = min(block_size, self.min_block_size)
        self.max_block_size = max(block_size, self.max_block_size)
        frame_size_in_bytes = frame.count_bits() // 8
        self.min_frame_size = min(frame_size_in_bytes, self.min_frame_size)
        self.max_frame_size = max(frame_size_in_bytes, self.max_frame_size)
        self.total_samples += block_size

    def set_block_sizes(self, min_value: int, max_value: int) -> None:
        if not (min_value <= max_value):
            raise VerifyError("min_block_size", "must be smaller than `max_block_size`")
        self.min_block_size = min_value
        self.max_block_size = max_value

    def set_frame_sizes(self, min_value: int, max_value: int) -> None:
        if not (min_value <= max_value):
            raise VerifyError("min_frame_size", "must be smaller than `max_frame_size`")
        self.min_frame_size = min_value
        self.max_frame_size = max_value

    def set_total_samples(self, n: int) -> None:
        self.total_samples = n

    def set_md5_digest(self, digest: bytes) -> None:
        if len(digest) != 16:
            raise ValueError(f"md5 digest must be 16 bytes, got {len(digest)}")
        self.md5 = bytes(digest)

    def count_bits(self) -> int:
        return 272

    def write(self, dest: BitSink) -> None:
        dest.write_lsbs(self.min_block_size, 16)
        dest.write_lsbs(self.max_block_size, 16)
        dest.write_lsbs(self.min_frame_size, 24)
        dest.write_lsbs(self.max_frame_size, 24)
        dest.write_lsbs(self.sample_rate, 20)
        dest.write_lsbs(self.channels - 1, 3)
        dest.write_lsbs(self.bits_per_sample - 1, 5)
        dest.write_lsbs(self.total_samples, 36)
        dest.write_bytes_aligned(self.md5)


class MetadataBlock:
    """Metadata block wrapper with is_last chaining (datatype.rs:327-430)."""

    __slots__ = ("is_last", "typetag", "data")

    STREAMINFO_TAG = 0

    def __init__(self, is_last: bool, typetag: int, data) -> None:
        self.is_last = is_last
        self.typetag = typetag
        self.data = data  # StreamInfo or raw bytes

    @staticmethod
    def from_stream_info(info: StreamInfo, is_last: bool) -> "MetadataBlock":
        return MetadataBlock(is_last, MetadataBlock.STREAMINFO_TAG, info)

    @staticmethod
    def new_unknown(tag: int, data: bytes, is_last: bool = False) -> "MetadataBlock":
        if not (1 <= tag < 127):
            raise VerifyError("metadata_block.typetag", "must be in 1..=126")
        return MetadataBlock(is_last, tag, bytes(data))

    def data_bits(self) -> int:
        if isinstance(self.data, StreamInfo):
            return self.data.count_bits()
        return len(self.data) * 8

    def count_bits(self) -> int:
        return 32 + self.data_bits()

    def write(self, dest: BitSink) -> None:
        block_type = self.typetag + (0x80 if self.is_last else 0x00)
        dest.write_lsbs(block_type, 8)
        dest.write_lsbs(self.data_bits() // 8, 24)
        if isinstance(self.data, StreamInfo):
            self.data.write(dest)
        else:
            dest.write_bytes_aligned(self.data)


class Stream:
    """Complete FLAC stream: fLaC magic + metadata + frames."""

    __slots__ = ("stream_info_", "metadata_", "frames_")

    def __init__(self, sample_rate: int, channels: int, bits_per_sample: int) -> None:
        self.stream_info_ = StreamInfo(sample_rate, channels, bits_per_sample)
        self.metadata_: List[MetadataBlock] = []
        self.frames_: List[Frame] = []

    def stream_info(self) -> StreamInfo:
        return self.stream_info_

    def stream_info_mut(self) -> StreamInfo:
        return self.stream_info_

    def metadata(self) -> List[MetadataBlock]:
        return self.metadata_

    def add_metadata_block(self, block: MetadataBlock) -> None:
        block.is_last = True
        if self.metadata_:
            self.metadata_[-1].is_last = False
        self.metadata_.append(block)

    def frames(self) -> List[Frame]:
        return self.frames_

    def frame(self, n: int) -> Optional[Frame]:
        return self.frames_[n] if n < len(self.frames_) else None

    def frame_count(self) -> int:
        return len(self.frames_)

    def add_frame(self, frame: Frame) -> None:
        """Appends a frame and updates STREAMINFO (datatype.rs:184-188)."""
        self.stream_info_.update_frame_info(frame)
        self.frames_.append(frame)

    def count_bits(self) -> int:
        ret = 32 + 32 + self.stream_info_.count_bits()
        ret += sum(m.count_bits() for m in self.metadata_)
        ret += sum(f.count_bits() for f in self.frames_)
        return ret

    def write(self, dest: BitSink) -> None:
        dest.write_bytes_aligned(b"fLaC")
        info_block = MetadataBlock.from_stream_info(self.stream_info_, not self.metadata_)
        info_block.write(dest)
        for m in self.metadata_:
            m.write(dest)
        for f in self.frames_:
            f.write(dest)

    def to_bytes(self) -> bytes:
        sink = BitSink()
        self.write(sink)
        return sink.as_bytes()
