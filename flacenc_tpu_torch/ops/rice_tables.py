"""Finest-partition Rice cost tables: the hand CUDA kernel and its plain twin.

Replaces ``flacenc_tpu/ops/pallas_rice.py:rice_cost_tables_pallas``. For
every (block, candidate channel) row it zigzags the residuals, zeroes the
samples before the row's warmup, and sums ``z >> p`` over each finest
partition for p = 0..31, clamped to ``MAX_P_TO_BITS``. The sums are exact
and clamp once (the JAX default path's rule, ``ops/rice.py:78-85``), so the
port's decisions equal that path's on every input.

The kernels (``csrc/rice_tables.cu``) count bit planes: with c_k the number
of samples whose zigzag value has bit k set, ``sum z >> p`` is
``sum_{k >= p} c_k 2**(k - p)``, finished per partition by the recurrence
S_p = c_p + 2 S_{p+1}. The tensor cores count the bits of 64-sample (and
other short) partitions; warp bit transposes take any other shape
(`launch_plan`). At the main path's shape (B*K = 256 rows of T = 4096) a call
moves 6.29 MB, 1.88 us at the H100's 3.35 TB/s; the source's note gives the
design.

`rice_cost_tables` launches the kernel for a CUDA tensor and runs the plain
PyTorch version, `rice_cost_tables_plain`, only for a CPU tensor. `launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

MAX_P_TO_BITS = (1 << 27) - 1  # rice.rs:51
N_P = 32  # tables cover rice parameters 0..=31
_U32 = 0xFFFFFFFF

MAX_BLOCK_SIZE = 32767  # the kernel's 32-bit scan is exact up to here
MMA_MAX_PART = 1024  # csrc/rice_tables.cu kMmaMaxPart
MAX_PARTS_PER_BLOCK = 16  # csrc/rice_tables.cu kMaxPartsPerBlock
STEPS_PER_BLOCK = 16  # 32-sample steps a transpose block aims for: 4 per warp

launches = 0  # kernel launches since import (reset by callers that count)

_lib: Optional[ctypes.CDLL] = None


def encode_signbit(v: torch.Tensor) -> torch.Tensor:
    """Zigzag (|v| << 1) - (v < 0) as u32 values held in int64
    (rice.rs:169-176; torch has no shifts or min on uint32)."""
    v64 = v.to(torch.int64)
    z = (v64.abs() << 1) - (v64 < 0).to(torch.int64)
    return z & _U32


def rice_cost_tables_plain(
    errors: torch.Tensor, warmup: torch.Tensor, finest_order: int
) -> torch.Tensor:
    """(B, K, T) int32 residuals, (B, K) warmups -> (B, K, nparts, 32) int32
    clamped shifted sums (no length terms): `_finest_tables` without them."""
    B, K, T = errors.shape
    nparts = 1 << finest_order
    z = encode_signbit(errors)
    t_idx = torch.arange(T, dtype=torch.int64, device=errors.device)
    z = torch.where(t_idx < warmup[..., None].to(torch.int64), 0, z)
    zp = z.reshape(B, K, nparts, T // nparts)
    sums = torch.stack([(zp >> p).sum(dim=-1) for p in range(N_P)], dim=-1)
    return torch.clamp(sums, max=MAX_P_TO_BITS).to(torch.int32)


class Plan(NamedTuple):
    """How `rice_cost_tables` launches: `kernel` "mma" (tensor-core bit
    counts) or "transpose" (warp bit transposes, `parts_per_block`
    partitions of a row per block)."""

    kernel: str
    parts_per_block: int = 0


def launch_plan(block_size: int, finest_order: int, data_ptr: int) -> Plan:
    """The kernel for a (rows, block_size) int32 input at `data_ptr`.

    Partitions of 16..`MMA_MAX_PART` samples, a multiple of 16, on a 16-byte
    aligned input go to the tensor cores: every power-of-two block size from
    64 up takes this road, its finest partitions holding 64 samples. Any
    other shape goes to the warp transposes, a block taking enough whole
    partitions of a row for about `STEPS_PER_BLOCK` 32-sample steps (a power
    of two at most `MAX_PARTS_PER_BLOCK`)."""
    part_len = block_size >> finest_order
    if part_len % 16 == 0 and part_len <= MMA_MAX_PART and data_ptr % 16 == 0:
        return Plan("mma")
    steps = -(-part_len // 32)
    parts = min(1 << finest_order, MAX_PARTS_PER_BLOCK, max(1, STEPS_PER_BLOCK // steps))
    return Plan("transpose", 1 << (parts.bit_length() - 1))


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from ..csrc.build import build

        lib = ctypes.CDLL(build())
        args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        lib.flacenc_rice_cost_tables_mma.restype = ctypes.c_int
        lib.flacenc_rice_cost_tables_mma.argtypes = args + [ctypes.c_void_p]
        lib.flacenc_rice_cost_tables_transpose.restype = ctypes.c_int
        lib.flacenc_rice_cost_tables_transpose.argtypes = args + [ctypes.c_int, ctypes.c_void_p]
        lib.flacenc_cuda_error_string.restype = ctypes.c_char_p
        lib.flacenc_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def rice_cost_tables(
    errors: torch.Tensor, warmup: torch.Tensor, finest_order: int
) -> torch.Tensor:
    """(B, K, T) int32 residuals, (B, K) int32 warmups ->
    (B, K, 2**finest_order, 32) int32 clamped shifted sums.

    CUDA tensors go through the hand kernel; CPU tensors through
    `rice_cost_tables_plain`. Anything else raises."""
    global launches
    if errors.dim() != 3 or errors.dtype != torch.int32:
        raise ValueError(
            f"errors must be (B, K, T) int32, got {tuple(errors.shape)} {errors.dtype}"
        )
    B, K, T = errors.shape
    if warmup.shape != (B, K) or warmup.dtype != torch.int32:
        raise ValueError(
            f"warmup must be ({B}, {K}) int32, got {tuple(warmup.shape)} {warmup.dtype}"
        )
    if warmup.device != errors.device:
        raise ValueError(f"warmup on {warmup.device}, errors on {errors.device}")
    if not 0 <= finest_order <= 15 or T % (1 << finest_order):
        raise ValueError(f"block size {T} does not split into 2**{finest_order} partitions")
    if T > MAX_BLOCK_SIZE:
        raise ValueError(f"block size {T} exceeds {MAX_BLOCK_SIZE}")
    if errors.device.type == "cpu":
        return rice_cost_tables_plain(errors, warmup, finest_order)
    if errors.device.type != "cuda":
        raise ValueError(f"rice_cost_tables runs on cuda or cpu, not {errors.device}")
    if not (errors.is_contiguous() and warmup.is_contiguous()):
        raise ValueError("errors and warmup must be contiguous")
    out = torch.empty(
        (B, K, 1 << finest_order, N_P), dtype=torch.int32, device=errors.device
    )
    plan = launch_plan(T, finest_order, errors.data_ptr())
    lib = _load()
    with torch.cuda.device(errors.device):
        stream = torch.cuda.current_stream(errors.device).cuda_stream
        args = (errors.data_ptr(), warmup.data_ptr(), out.data_ptr(), B * K, T, finest_order)
        if plan.kernel == "mma":
            rc = lib.flacenc_rice_cost_tables_mma(*args, stream)
        else:
            rc = lib.flacenc_rice_cost_tables_transpose(*args, plan.parts_per_block, stream)
    if rc != 0:
        raise RuntimeError(
            "rice_cost_tables launch failed: "
            + lib.flacenc_cuda_error_string(rc).decode()
        )
    launches += 1
    return out
