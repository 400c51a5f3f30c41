"""Batched fixed predictors (port of ``flacenc_tpu/ops/fixed.py``).

All five difference-cascade orders are computed for every block/channel as
`(..., 5, T)` tensors (coding.rs:178-197); the partitioned entropy estimator
(coding.rs:200-227) runs in float32 with the partition loop unrolled.
"""

from __future__ import annotations

import torch

from .. import constants

MAX_FIXED_ORDER = constants.fixed.MAX_LPC_ORDER  # 4


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of int64 values into int32 (Rust `as i32`)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def fixed_lpc_errors(signal: torch.Tensor) -> torch.Tensor:
    """Difference cascades: (..., T) int -> (..., 5, T) int32, wrapping.

    e_{k+1}[t] = e_k[t] - e_k[t-1] with e_k[-1] = 0. The cascade runs exactly
    in int64 (|e_4| < 2^36) and wraps once at the end, which equals
    wrapping after every step."""
    errs = [signal.to(torch.int64)]
    for _ in range(MAX_FIXED_ORDER):
        prev = errs[-1]
        shifted = torch.nn.functional.pad(prev[..., :-1], (1, 0))
        errs.append(prev - shifted)
    return wrap_i32(torch.stack(errs, dim=-2))


def estimate_entropy(
    errors: torch.Tensor, warmup_len: torch.Tensor, partitions: int, block_size: int
) -> torch.Tensor:
    """Approximate bit-cost estimate (coding.rs:200-227), float32 semantics.

    `errors`: (..., T) int32; `warmup_len`: (...,) int. Returns (...,) int64
    accumulated truncated partition costs."""
    # every float step runs in float32: the Python scalars below take the
    # float32 tensor's dtype (as jnp.float32 constants do), and as kernel
    # arguments they need no host-to-device copy
    f32 = torch.float32
    partition_size = -(-block_size // partitions)
    abs_f32 = errors.abs().to(f32)
    acc = torch.zeros(errors.shape[:-1], dtype=torch.int64, device=errors.device)
    warm = warmup_len.to(torch.int64)
    offset = 0
    for _p in range(partitions):
        end = min(block_size, offset + partition_size)
        partition_len = end - offset
        if partition_len <= 0:
            break
        # reference guard: `if end >= warmup_len`
        active = end >= warm
        sample_count = torch.clamp(end - warm, max=partition_len).to(f32)
        sum_errors = abs_f32[..., offset:end].sum(dim=-1, dtype=f32)
        avg_errors = sum_errors * 2.0 / (sample_count + 0.00001)
        geom_p = 1.0 / (avg_errors + 1.0)
        # avg == 0 gives 0 * -inf = NaN; Rust's `as usize` maps NaN/neg to 0,
        # and torch's cast of NaN is undefined, so mask before the cast
        xent = avg_errors * (-torch.log2(1.0 - geom_p)) + (-torch.log2(geom_p))
        contrib = xent * sample_count
        contrib = torch.where(
            torch.isnan(contrib) | (contrib < 0) | ~active, 0.0, contrib
        )
        acc = acc + contrib.to(torch.int64)  # f32 -> int truncates
        offset = end
    return acc
