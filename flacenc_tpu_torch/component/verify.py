"""Structural validation of the component tree.

Mirrors ``flacenc-rs/src/component/verify.rs``: every component can be
checked for FLAC-spec validity before serialization; `Frame.verify`
recomputes cached bitstreams and compares, `Residual.verify` checks warmup
zeros, remainder ranges and cached sums, `Stream.verify` checks the
metadata is_last chain and sequential fixed-blocking frame numbers.
"""

from __future__ import annotations

import numpy as np

from .. import constants
from ..errors import VerifyError
from .datatype import (
    ChannelAssignment,
    Constant,
    FixedLpc,
    Frame,
    FrameHeader,
    Lpc,
    MetadataBlock,
    Residual,
    Stream,
    StreamInfo,
    Verbatim,
)


def _check_block_size(name: str, size: int) -> None:
    if not (1 <= size <= constants.MAX_BLOCK_SIZE):
        raise VerifyError(name, f"block size {size} out of range")


def _check_bps(name: str, bps: int) -> None:
    # verify.rs:51-67 (verify_bps!): MIN..=MAX+1 (+1 covers side channels,
    # bps 25) and a multiple of 4, or 4n+1 for the side channel
    if not (
        constants.MIN_BITS_PER_SAMPLE
        <= bps
        <= constants.MAX_BITS_PER_SAMPLE + 1
    ):
        raise VerifyError(name, f"bits-per-sample {bps} out of range")
    if bps % 4 not in (0, 1):
        raise VerifyError(
            name, "must be a multiple of 4 (or 4n + 1 for side-channel)"
        )


def _check_sample_range(name: str, samples: np.ndarray, bps: int) -> None:
    if len(samples) == 0:
        return
    lo, hi = -(1 << (bps - 1)), (1 << (bps - 1)) - 1
    if int(samples.min()) < lo or int(samples.max()) > hi:
        raise VerifyError(name, f"samples exceed {bps}-bit range")


def verify_residual(res: Residual) -> None:
    """verify.rs:274-332."""
    nparts = 1 << res.partition_order
    if len(res.rice_params) < nparts:
        raise VerifyError("residual.rice_params", "fewer params than partitions")
    if res.block_size % nparts != 0:
        raise VerifyError(
            "residual.partition_order", "block size not divisible by partitions"
        )
    if (res.block_size >> res.partition_order) < res.warmup_length:
        raise VerifyError("residual.warmup_length", "warmup exceeds first partition")
    if np.any(res.quotients[: res.warmup_length] != 0) or np.any(
        res.remainders[: res.warmup_length] != 0
    ):
        raise VerifyError("residual.quotients", "warmup region must be zero")
    part_len = res.block_size >> res.partition_order
    ps = np.repeat(res.rice_params[:nparts].astype(np.uint32), part_len)
    lim = np.uint32(1) << ps
    if np.any(res.remainders >= lim):
        raise VerifyError("residual.remainders", "remainder exceeds rice parameter")
    if int(res.quotients.sum(dtype=np.uint64)) != res.sum_quotients:
        raise VerifyError("residual.sum_quotients", "cached sum mismatch")
    if int(res.rice_params[:nparts].sum(dtype=np.uint64)) != res.sum_rice_params:
        raise VerifyError("residual.sum_rice_params", "cached sum mismatch")


def verify_subframe(sub) -> None:
    if isinstance(sub, Constant):
        _check_bps("constant.bits_per_sample", sub.bits_per_sample)
        _check_sample_range(
            "constant.dc_offset", np.asarray([sub.dc_offset]), sub.bits_per_sample
        )
    elif isinstance(sub, Verbatim):
        _check_bps("verbatim.bits_per_sample", sub.bits_per_sample)
        _check_sample_range("verbatim.samples", sub.samples, sub.bits_per_sample)
    elif isinstance(sub, FixedLpc):
        if sub.order > constants.fixed.MAX_LPC_ORDER:
            raise VerifyError("fixed_lpc.order", "exceeds maximum fixed order")
        _check_sample_range("fixed_lpc.warm_up", sub.warm_up, sub.bits_per_sample)
        try:
            verify_residual(sub.residual)
        except VerifyError as e:
            raise e.within("fixed_lpc")
    elif isinstance(sub, Lpc):
        p = sub.parameters
        if not (1 <= p.order <= constants.qlpc.MAX_ORDER):
            raise VerifyError("lpc.order", "order out of range")
        if not (1 <= p.precision <= constants.qlpc.MAX_PRECISION):
            raise VerifyError("lpc.precision", "precision out of range")
        if not (constants.qlpc.MIN_SHIFT <= p.shift <= constants.qlpc.MAX_SHIFT):
            raise VerifyError("lpc.shift", "shift out of range")
        lim = 1 << (p.precision - 1)
        if np.any(p.coefs < -lim) or np.any(p.coefs >= lim):
            raise VerifyError("lpc.coefs", "coefficient exceeds precision")
        _check_sample_range("lpc.warm_up", sub.warm_up, sub.bits_per_sample)
        try:
            verify_residual(sub.residual)
        except VerifyError as e:
            raise e.within("lpc")
    else:
        raise VerifyError("subframe", f"unknown subframe type {type(sub)}")


def verify_frame(frame: Frame) -> None:
    """verify.rs:155-185 — includes recomputing any cached bitstream."""
    header = frame.header()
    _check_block_size("frame.block_size", header.block_size())
    nch_expected = (
        header.channel_assignment.channels
        if header.channel_assignment.kind == ChannelAssignment.INDEPENDENT
        else 2
    )
    if frame.subframes() and len(frame.subframes()) != nch_expected:
        raise VerifyError("frame.subframes", "channel count mismatch")
    for i, sub in enumerate(frame.subframes()):
        try:
            verify_subframe(sub)
        except VerifyError as e:
            raise e.within(f"frame.subframes[{i}]")
    if frame.precomputed_bitstream is not None and frame.subframes():
        cached = frame.precomputed_bitstream
        frame.precomputed_bitstream = None
        try:
            fresh = frame.to_frame_bytes()
        finally:
            frame.precomputed_bitstream = cached
        if fresh != cached:
            raise VerifyError(
                "frame.precomputed_bitstream", "cached bitstream is stale"
            )


def verify_stream_info(info: StreamInfo) -> None:
    """verify.rs:133-153: block/frame-size ordering gated on non-empty
    streams (total_samples == 0 means nothing folded in yet), plus the
    unconditional rate/channels/bps bounds."""
    if info.total_samples != 0:
        if info.min_block_size > info.max_block_size:
            raise VerifyError(
                "stream_info.min_block_size",
                "must be smaller than `max_block_size`",
            )
        _check_block_size("stream_info.min_block_size", info.min_block_size)
        _check_block_size("stream_info.max_block_size", info.max_block_size)
        if info.min_frame_size > info.max_frame_size:
            raise VerifyError(
                "stream_info.min_frame_size",
                "must be smaller than `max_frame_size`",
            )
    if info.sample_rate > 96_000:
        raise VerifyError("stream_info.sample_rate", "out of range")
    if not (1 <= info.channels <= constants.MAX_CHANNELS):
        raise VerifyError("stream_info.channels", "out of range")
    _check_bps("stream_info.bits_per_sample", info.bits_per_sample)


def verify_stream(stream: Stream) -> None:
    """verify.rs:78-115: is_last chain, then fixed-blocking (sequential
    frame numbers + STREAMINFO min==max) or variable-blocking (cumulative
    start-sample numbers, datatype.rs:266-314) frame validation."""
    verify_stream_info(stream.stream_info())
    for i, m in enumerate(stream.metadata()):
        is_tail = i == len(stream.metadata()) - 1
        if m.is_last != is_tail:
            raise VerifyError(f"stream.metadata[{i}].is_last", "chain broken")
    frames = stream.frames()
    if not frames:
        return
    if frames[0].header().is_variable_blocking():
        current = 0
        for i, frame in enumerate(frames):
            if not frame.header().is_variable_blocking():
                raise VerifyError(
                    f"stream.frames[{i}].header.variable_block_size",
                    "must be same for all frames",
                )
            if frame.header().start_sample_number != current:
                raise VerifyError(
                    f"stream.frames[{i}].header.start_sample_number",
                    "must be the sum of the block sizes of the preceding frames",
                )
            try:
                verify_frame(frame)
            except VerifyError as e:
                raise e.within(f"stream.frames[{i}]")
            current = (current + frame.header().block_size()) % (1 << 64)
        return
    info = stream.stream_info()
    if info.min_block_size != info.max_block_size:
        raise VerifyError(
            "stream.min_block_size",
            "must be equal for fixed-blocking streams",
        )
    for i, frame in enumerate(frames):
        if frame.header().is_variable_blocking():
            raise VerifyError(
                f"stream.frames[{i}].header.variable_block_size",
                "must be same for all frames",
            )
        if frame.header().frame_number != i:
            raise VerifyError(
                f"stream.frames[{i}].frame_number", "must be sequential"
            )
        try:
            verify_frame(frame)
        except VerifyError as e:
            raise e.within(f"stream.frames[{i}]")
