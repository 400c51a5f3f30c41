"""Component -> signal decoding (test/verification oracle).

Mirrors ``flacenc-rs/src/component/decode.rs``: Rice residual decode,
fixed/QLPC IIR synthesis, and stereo de-rotation.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .datatype import (
    ChannelAssignment,
    Constant,
    FixedLpc,
    Frame,
    Lpc,
    Stream,
    SubFrame,
    Verbatim,
)

# decode.rs:179-185
FIXED_LPC_COEFS = [
    [],
    [1],
    [2, -1],
    [3, -3, 1],
    [4, -6, 4, -1],
]


def decode_lpc(warm_up: np.ndarray, coefs: List[int], shift: int, residual) -> np.ndarray:
    """Shared fixed/QLPC synthesis (decode.rs:159-177).

    Uses the native C++ IIR when available (the synthesis recursion is
    inherently sequential); falls back to the scalar Python loop.
    """
    errors = residual.decode()
    n = residual.block_size
    order = len(coefs)
    from .. import native

    fast = native.lpc_synthesis(
        np.asarray(warm_up[:order], np.int32),
        np.asarray(coefs, np.int32),
        shift,
        errors,
    )
    if fast is not None:
        return fast
    out = np.zeros(n, dtype=np.int64)
    out[:order] = np.asarray(warm_up[:order], dtype=np.int64)
    c = np.asarray(coefs, dtype=np.int64)
    err = errors.astype(np.int64)
    for t in range(order, n):
        pred = 0
        for k in range(order):
            pred += c[k] * out[t - 1 - k]
        out[t] = (pred >> shift) + err[t]
    return out.astype(np.int32)


def decode_subframe(sub: SubFrame) -> np.ndarray:
    if isinstance(sub, Constant):
        return sub.decode()
    if isinstance(sub, Verbatim):
        return sub.decode()
    if isinstance(sub, FixedLpc):
        return decode_lpc(sub.warm_up, FIXED_LPC_COEFS[sub.order], 0, sub.residual)
    if isinstance(sub, Lpc):
        return decode_lpc(
            sub.warm_up, list(sub.parameters.coefs), sub.parameters.shift, sub.residual
        )
    raise TypeError(f"unknown subframe type {type(sub)}")


def decode_frame(frame: Frame) -> np.ndarray:
    """Returns interleaved int32 samples (decode.rs:56-113)."""
    ch_info = frame.header().channel_assignment
    chans = [decode_subframe(s) for s in frame.subframes()]
    if ch_info.kind == ChannelAssignment.INDEPENDENT:
        stacked = np.stack(chans, axis=1)
        return stacked.reshape(-1)
    a, b = chans[0].astype(np.int64), chans[1].astype(np.int64)
    if ch_info.kind == ChannelAssignment.LEFT_SIDE:
        l, s = a, b
        r = l - s
    elif ch_info.kind == ChannelAssignment.RIGHT_SIDE:
        s, r = a, b
        l = r + s
    else:  # mid-side: stored m = (l+r)>>1, s = l-r
        m, s = a, b
        m2 = (m << 1) + (s & 1)
        l = (m2 + s) >> 1
        r = (m2 - s) >> 1
    return np.stack([l.astype(np.int32), r.astype(np.int32)], axis=1).reshape(-1)


def decode_stream(stream: Stream) -> np.ndarray:
    """Interleaved int32 samples of all frames."""
    parts = [decode_frame(f) for f in stream.frames()]
    if not parts:
        return np.zeros(0, dtype=np.int32)
    return np.concatenate(parts)
