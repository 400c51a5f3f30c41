"""FLAC component model: datatypes, serialization, verification, decoding."""

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
from .decode import decode_frame, decode_stream, decode_subframe
from .parser import ParseError, parse_stream

__all__ = [
    "BlockSizeSpec",
    "ChannelAssignment",
    "Constant",
    "FixedLpc",
    "Frame",
    "FrameHeader",
    "Lpc",
    "MetadataBlock",
    "QuantizedParameters",
    "Residual",
    "SampleRateSpec",
    "SampleSizeSpec",
    "Stream",
    "StreamInfo",
    "SubFrame",
    "Verbatim",
    "decode_frame",
    "decode_stream",
    "decode_subframe",
    "parse_stream",
    "ParseError",
]
