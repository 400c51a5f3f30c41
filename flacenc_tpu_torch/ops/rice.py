"""Batched partitioned-Rice parameter search (port of ``flacenc_tpu/ops/rice.py``).

The finest-order cost table is a dense ``(..., nparts, 32)`` tensor of
shifted sums (``rice_tables``: the hand CUDA kernel on the card); coarser
orders come from a pairwise merge, and the (parameter, order) argmins are
packed-integer reductions with the reference's tie-breaking ((bits << 5) | p
with u32 wrap, rice.rs:115-141). u32 values live in int64 with explicit
``& 0xFFFFFFFF`` masks, since torch has no shifts or min on uint32.

Partition sums accumulate in i64 and clamp once to (1<<27)-1, the JAX
package's default rule (its DESIGN.md deviation note).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .. import constants

from . import rice_tables
from .rice_tables import MAX_P_TO_BITS, N_P, encode_signbit

__all__ = [
    "MAX_P_TO_BITS",
    "RiceSearchResult",
    "encode_signbit",
    "find_partitioned_rice_parameters",
    "finest_partition_order",
    "residual_count_bits",
]

_U32 = 0xFFFFFFFF


def finest_partition_order(size: int, min_part_size: int) -> int:
    """Static finest partition order (rice.rs:157-165)."""
    if min_part_size < 1:
        raise ValueError(f"min_part_size must be >= 1, got {min_part_size}")
    max_splits = size // min_part_size
    if max_splits == 0:
        return 0
    max_order = max_splits.bit_length() - 1
    trailing = (size & -size).bit_length() - 1 if size else 0
    return min(constants.rice.MAX_PARTITION_ORDER, max_order, trailing)


class RiceSearchResult(NamedTuple):
    """Best partitioned-Rice parameters per batch element; leading dims
    ``...``, ``max_parts`` = 2**finest_order."""

    partition_order: torch.Tensor  # (...,) int32
    params: torch.Tensor  # (..., max_parts) int32; valid for first 2**order
    code_bits: torch.Tensor  # (...,) int64 table cost (incl. 4-bit offsets)
    use_rice2: torch.Tensor  # (...,) bool: any selected param > 14


def _finest_tables(
    errors: torch.Tensor, warmup: torch.Tensor, finest_order: int
) -> torch.Tensor:
    """(..., nparts, 32) int64 cost tables at the finest partition order.

    bits[part, p] = clamp(sum_{t in part, t >= warmup}(z[t] >> p)
                          + 4 + len_part * (p + 1))
    where partition 0 loses the warmup samples (rice.rs:270-276)."""
    lead, T = errors.shape[:-1], errors.shape[-1]
    nparts = 1 << finest_order
    sums = rice_tables.rice_cost_tables(
        errors.reshape(-1, 1, T).to(torch.int32).contiguous(),
        warmup.reshape(-1, 1).to(torch.int32).contiguous(),
        finest_order,
    ).reshape(lead + (nparts, N_P)).to(torch.int64)
    dev = errors.device
    lens = torch.full(lead + (nparts,), T // nparts, dtype=torch.int64, device=dev)
    lens[..., 0] -= warmup.to(torch.int64)
    ps = torch.arange(1, N_P + 1, dtype=torch.int64, device=dev)
    return torch.clamp(sums + 4 + lens[..., None] * ps, max=MAX_P_TO_BITS)


def _minimize_tables(
    tables: torch.Tensor, max_p: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-partition (param int32, bits int64) with reference tie-breaking:
    packed = ((bits << 5) & u32) | p, masked entries use bits = u32::MAX, so
    they pack as 0xFFFFFFE0 | p; the min prefers smaller p on ties."""
    ps = torch.arange(N_P, dtype=torch.int64, device=tables.device)
    bits = torch.where(ps <= max_p, tables & _U32, _U32)
    packed = ((bits << 5) & _U32) | ps
    m = packed.amin(dim=-1)
    return (m & 0x1F).to(torch.int32), m >> 5


def find_partitioned_rice_parameters(
    errors: torch.Tensor,
    warmup: torch.Tensor,
    block_size: int,
    max_p: int,
) -> RiceSearchResult:
    """Full bottom-up search over partition orders (rice.rs:246-299).

    `errors`: (..., T) int32 residuals; `warmup`: (...,) warmup lengths
    (< MIN_PARTITION_SIZE, so the finest order is static)."""
    finest = finest_partition_order(block_size, constants.rice.MIN_PARTITION_SIZE)
    max_parts = 1 << finest
    tables = _finest_tables(errors, warmup, finest)
    dev = errors.device
    batch_shape = errors.shape[:-1]

    # per-order results, finest first, so the first-minimum argmin lets the
    # finest order win ties like the reference's strict-`<` loop
    # (rice.rs:277-291)
    all_params = []
    all_bits = []
    order_tables = tables
    for order in range(finest, -1, -1):
        params_o, bits_o = _minimize_tables(order_tables, max_p)
        all_bits.append(bits_o.sum(dim=-1))
        pad = torch.zeros(
            batch_shape + (max_parts - (1 << order),), dtype=torch.int32, device=dev
        )
        all_params.append(torch.cat([params_o, pad], dim=-1))
        if order > 0:
            merged = order_tables[..., 0::2, :] + order_tables[..., 1::2, :] - 4
            order_tables = torch.clamp(merged, max=MAX_P_TO_BITS)

    bits_by_order = torch.stack(all_bits, dim=-1)  # (..., n_orders)
    params_by_order = torch.stack(all_params, dim=-2)  # (..., n_orders, max_parts)
    best_idx = torch.argmin(bits_by_order, dim=-1)  # first minimum
    best_order = (finest - best_idx).to(torch.int32)
    best_bits = torch.take_along_dim(bits_by_order, best_idx[..., None], dim=-1)[..., 0]
    best_params = torch.take_along_dim(
        params_by_order, best_idx[..., None, None], dim=-2
    )[..., 0, :]
    # params beyond 2**best_order are padding; mask them for the rice2 check
    part_idx = torch.arange(max_parts, dtype=torch.int32, device=dev)
    valid = part_idx < (1 << best_order.to(torch.int64))[..., None]
    use_rice2 = torch.any(valid & (best_params > 14), dim=-1)
    return RiceSearchResult(
        best_order, torch.where(valid, best_params, 0), best_bits, use_rice2
    )


def residual_count_bits(res: RiceSearchResult) -> torch.Tensor:
    """Exact `Residual::count_bits` from search outputs (bitrepr.rs:533-543):
    code_bits + 6 + (2**order if RICE2)."""
    nparts = 1 << res.partition_order.to(torch.int64)
    return res.code_bits + 6 + torch.where(res.use_rice2, nparts, 0)
