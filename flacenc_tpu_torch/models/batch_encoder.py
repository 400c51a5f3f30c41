"""Batched frame encoder on PyTorch (port of ``flacenc_tpu/models/batch_encoder.py``).

Device half: `BatchEncoder`, an `nn.Module` standing for the JAX package's
``build_encoder_fn``. One forward pass evaluates every predictor candidate
(constant / fixed orders 0-4 / QLPC) for every block, channel and stereo
mode of a `(B, C, T)` batch and selects with exact integer bit-cost argmins
that reproduce the reference's decision procedure (coding.rs:384-527),
tie-breaking included. By default it returns one (B, F) int32 decisions
array laid out by `coalesce_decisions`; with `decisions_only=False` it also
returns the chosen residuals (`DeviceEncoded`), and with `wire_encoded` the
two-buffer form of those (`coalesce_encoded_small`, the int16 residuals).

The forward can also take a packed upload wire (``ops/upack.py``) in place
of the blocks, and G stacked batches at once (grouped round trips).

Host half: `BatchRunner` picks each batch's upload wire (the racer
`LinkEstimator`, or a fixed mode) and, on its dispatch lane, uploads it
(with the strict host arrays of `_strict_ext_arrays` in strict mode) and
runs the registry's program for it (`program_for`: on a card a captured
CUDA graph, replayed), on one
device or split over a `parallel.mesh` of replicas, and packs the frames
with one of three packers: "native2" (the default) hands the decisions to the C++
packer (``native.pack_frames_recompute``), which rebuilds each residual
from the raw blocks; "native" packs the downloaded residuals in C++
(`pack_frames_native`); "python" builds `component` objects from them
(`frames_from_device`). `encode_with_fixed_block_size` reads a source into
it; the ragged tail goes through the numpy oracle
(``models/reference_encoder.py``).

Stereo candidates are indexed L=0, R=1, M=2, S=3; assignment codes are
0=LR, 1=LS, 2=RS, 3=MS (selection order matches coding.rs:500-522).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import functools
import os
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import config as config_mod
from .. import constants, native, trace
from ..component.datatype import (
    BlockSizeSpec,
    ChannelAssignment,
    Constant,
    FixedLpc,
    Frame,
    Lpc,
    QuantizedParameters,
    Residual,
    SampleRateSpec,
    SampleSizeSpec,
    Stream,
    Verbatim,
)
from ..device import collect_uploads
from ..device import multi_process as _multi_process
from ..device import name_card
from ..device import on_card as _on_card
from ..device import resolve_device, timed_upload
from ..errors import Verified
from ..log import info_stats
from ..ops import fixed as ops_fixed
from ..ops import lpc as ops_lpc
from ..ops import ref_np
from ..ops import rice as ops_rice
from ..ops import upack
from ..ops.windows import get_window
from ..parallel import determine_worker_count
from ..parallel import mesh as pmesh
from ..source import AsyncContext, FrameBuf, Source, verify_sample_range
from . import reference_encoder

# subframe type codes shared with the host packer
T_CONSTANT, T_VERBATIM, T_FIXED, T_LPC = 0, 1, 2, 3

# stereo candidate indices and assignment tables
_L, _R, _M, _S = 0, 1, 2, 3
_SLOT0 = np.array([_L, _L, _S, _M], dtype=np.int32)  # per assignment code
_SLOT1 = np.array([_R, _S, _R, _S], dtype=np.int32)
_ASSIGN_TAGS = np.array([1, 8, 9, 10], dtype=np.int32)  # FLAC header tags
# assignment code -> ChannelAssignment (immutable; shared by the packers)
_CH_INFO_BY_CODE = [
    ChannelAssignment.independent(2),
    ChannelAssignment.left_side(),
    ChannelAssignment.right_side(),
    ChannelAssignment.mid_side(),
]

DEFAULT_BATCH = 64
PACKERS = ("auto", "native2", "native", "python")

# fixed column groups of the coalesced decisions row, before the variable
# qcoefs (C*24) + rice_params (C*P) tail: assign, then 5 per-channel cols
_WIRE_FIXED_COLS = 5


class DeviceEncoded(NamedTuple):
    """Per-(block, stored-channel) decisions plus the chosen residuals:
    tensors on the device side, numpy arrays after `split_encoded`. The
    stored-channel signals are not shipped: the host holds the blocks and
    rebuilds M/S itself (`_slot_signals`)."""

    assign: object       # (B,) int32 assignment code (stereo) or 0
    sf_type: object      # (B, C) int32 subframe type code
    order: object        # (B, C) int32 predictor order
    qcoefs: object       # (B, C, MAX_LPC_ORDER) int32
    shift: object        # (B, C) int32
    rice_order: object   # (B, C) int32 partition order
    rice_params: object  # (B, C, max_parts) int32
    errors: object       # (B, C, T) int16 chosen-predictor residual, wrapped
    fits16: object       # (B, C) bool: the residual fits int16 (else the
                         #   host recomputes that channel, `_host_errors`)
    sf_bits: object      # (B, C) int64 exact subframe bit counts


class DeviceDecisions(NamedTuple):
    """Per-(block, stored-channel) decisions: tensors on the device side,
    numpy arrays after `split_decisions`."""

    assign: object       # (B,) int32 assignment code (stereo) or 0
    sf_type: object      # (B, C) int32 subframe type code
    order: object        # (B, C) int32 predictor order
    qcoefs: object       # (B, C, MAX_LPC_ORDER) int32
    shift: object        # (B, C) int32
    rice_order: object   # (B, C) int32 partition order
    rice_params: object  # (B, C, max_parts) int32
    sf_bits: object      # (B, C) int64 exact subframe bit counts


def coalesce_decisions(dec: DeviceDecisions) -> torch.Tensor:
    """Flatten DeviceDecisions tensors into ONE (B, F) int32 tensor.

    sf_bits fits int32 exactly: a chosen subframe never exceeds the verbatim
    fallback, 8 + 32767*25 bits < 2^20 (coding.rs:403-417)."""
    B = dec.assign.shape[0]
    cols = [
        dec.assign[:, None],
        dec.sf_type,
        dec.order,
        dec.shift,
        dec.rice_order,
        dec.sf_bits,
        dec.qcoefs.reshape(B, -1),
        dec.rice_params.reshape(B, -1),
    ]
    return torch.cat([c.to(torch.int32) for c in cols], dim=1)


def coalesce_encoded_small(enc: DeviceEncoded) -> torch.Tensor:
    """Every `DeviceEncoded` field but the residuals as one (B, F + C) int32
    tensor: the decisions layout plus a trailing fits16 column group."""
    small = coalesce_decisions(DeviceDecisions(
        assign=enc.assign, sf_type=enc.sf_type, order=enc.order,
        qcoefs=enc.qcoefs, shift=enc.shift, rice_order=enc.rice_order,
        rice_params=enc.rice_params, sf_bits=enc.sf_bits,
    ))
    return torch.cat([small, enc.fits16.to(torch.int32)], dim=1)


def split_encoded(wire: np.ndarray, errors: np.ndarray, nchannels: int) -> DeviceEncoded:
    """Host-side inverse of the (`coalesce_encoded_small`, errors) pair.
    Every field is a copy: the inputs may be staging slots that go back to
    their pool after the assembly."""
    C = nchannels
    dec = split_decisions(wire[:, :-C], C)
    return DeviceEncoded(
        assign=dec.assign, sf_type=dec.sf_type, order=dec.order,
        qcoefs=dec.qcoefs, shift=dec.shift, rice_order=dec.rice_order,
        rice_params=dec.rice_params, sf_bits=dec.sf_bits,
        errors=np.array(errors, order="C"),
        fits16=np.ascontiguousarray(wire[:, -C:]).astype(bool),
    )


def split_decisions(arr: np.ndarray, nchannels: int) -> DeviceDecisions:
    """Host-side inverse of `coalesce_decisions` on a numpy (B, F) array.
    Every field is a C-contiguous copy, never a view of `arr`."""
    B, F = arr.shape
    C = nchannels
    q = constants.qlpc.MAX_ORDER
    P = (F - 1 - C * (_WIRE_FIXED_COLS + q)) // C
    if P < 1 or F != 1 + C * (_WIRE_FIXED_COLS + q + P):
        raise ValueError(
            f"coalesced decisions width {F} is not 1 + {C} * "
            f"({_WIRE_FIXED_COLS} + {q} + P) for any partition count P >= 1"
        )
    o = 1
    fields = []
    for _ in range(_WIRE_FIXED_COLS):
        fields.append(arr[:, o:o + C])
        o += C
    sf_type, order, shift, rice_order, sf_bits = fields
    qcoefs = arr[:, o:o + C * q].reshape(B, C, q)
    o += C * q
    rice_params = arr[:, o:].reshape(B, C, P)
    return DeviceDecisions(
        assign=np.array(arr[:, 0], order="C"),
        sf_type=np.array(sf_type, order="C"),
        order=np.array(order, order="C"),
        qcoefs=np.array(qcoefs, order="C"),
        shift=np.array(shift, order="C"),
        rice_order=np.array(rice_order, order="C"),
        rice_params=np.array(rice_params, order="C"),
        sf_bits=np.array(sf_bits, dtype=np.int64, order="C"),
    )


def _fixed_search(sub, sig: torch.Tensor, bps_v: torch.Tensor, T: int, max_p: int,
                  ext_fixed=None):
    """Fixed-predictor order selection and its Rice search (coding.rs:298-331).

    ApproxEnt picks the order by the entropy estimate (or takes the strict
    host's (order, est_bits) in `ext_fixed`) and searches Rice parameters
    for that order only; BitCount runs a full Rice search for every order
    0..max_order and picks the exact cost. Both keep the lowest order on a
    tie. Returns (order, exact bits, estimate, RiceSearchResult, the
    (B, K, 5, T) residuals of every order)."""
    B, K = sig.shape[:2]
    dev = sig.device
    i32, i64 = torch.int32, torch.int64
    errs = ops_fixed.fixed_lpc_errors(sig)  # (B, K, 5, T)
    n_orders = sub.fixed.max_order + 1
    order_sel = sub.fixed.order_sel
    if order_sel.type == "ApproxEnt":
        if ext_fixed is not None:
            fx_order, fx_est = ext_fixed
        else:
            ests = []
            for o in range(n_orders):
                w = torch.full((B, K), o, dtype=i32, device=dev)
                est = ops_fixed.estimate_entropy(errs[:, :, o, :], w, order_sel.partitions, T)
                ests.append(est + bps_v * o)
            est_bits = torch.stack(ests, dim=-1)  # (B, K, n_orders)
            fx_order = torch.argmin(est_bits, dim=-1).to(i32)
            fx_est = est_bits.amin(dim=-1)
        fx_err = torch.take_along_dim(errs, fx_order.to(i64)[..., None, None], dim=2)[:, :, 0, :]
        fx_rice = ops_rice.find_partitioned_rice_parameters(fx_err, fx_order, T, max_p)
    else:  # BitCount
        per_order = [
            ops_rice.find_partitioned_rice_parameters(
                errs[:, :, o, :], torch.full((B, K), o, dtype=i32, device=dev), T, max_p
            )
            for o in range(n_orders)
        ]
        bits_o = torch.stack([bps_v * o + r.code_bits for o, r in enumerate(per_order)], dim=-1)
        fx_order = torch.argmin(bits_o, dim=-1).to(i32)
        fx_est = bits_o.amin(dim=-1)
        idx = fx_order.to(i64)[..., None]

        def pick(field):
            stacked = torch.stack([getattr(r, field) for r in per_order], dim=-1)
            return torch.take_along_dim(stacked, idx, dim=-1)[..., 0]

        params = torch.take_along_dim(
            torch.stack([r.params for r in per_order], dim=2), idx[..., None], dim=2
        )[:, :, 0, :]
        fx_rice = ops_rice.RiceSearchResult(
            pick("partition_order"), params, pick("code_bits"), pick("use_rice2")
        )
    fx_bits = 8 + bps_v * fx_order + ops_rice.residual_count_bits(fx_rice)
    return fx_order, fx_bits, fx_est, fx_rice, errs


def _lpc_search(sub, sig: torch.Tensor, bps_v: torch.Tensor, T: int, max_p: int,
                window: torch.Tensor, ext_qlpc=None):
    """Quantized LPC and its Rice search (coding.rs:333-381).

    The coefficients come from the strict host's `ext_qlpc` = (qcoefs,
    order, shift) when given; otherwise from autocorrelation + Levinson, or
    with `use_direct_mse` from the covariance solve, refined by IRLS when
    `mae_optimization_steps` > 0 (coding.rs:333-351). Returns (qcoefs,
    order, shift, RiceSearchResult, exact bits, residuals)."""
    qlpc = sub.qlpc
    if ext_qlpc is not None:
        qcoefs, q_order, q_shift = ext_qlpc
    else:
        win = ops_lpc.apply_window(sig, window)
        if qlpc.use_direct_mse and qlpc.mae_optimization_steps > 0:
            coefs = ops_lpc.lpc_irls_mae(sig, win, qlpc.lpc_order, qlpc.mae_optimization_steps)
        elif qlpc.use_direct_mse:
            coefs = ops_lpc.lpc_direct_mse(win, qlpc.lpc_order)
        else:
            corr = ops_lpc.auto_correlation(win, qlpc.lpc_order)
            coefs = ops_lpc.levinson(corr, qlpc.lpc_order)
        qcoefs, q_order, q_shift = ops_lpc.quantize_parameters(coefs, qlpc.quant_precision)
    lpc_err = ops_lpc.compute_error(qcoefs, q_order, q_shift, sig, max_taps=qlpc.lpc_order)
    lpc_rice = ops_rice.find_partitioned_rice_parameters(lpc_err, q_order, T, max_p)
    q_order64 = q_order.to(torch.int64)
    lpc_bits = (
        8 + bps_v * q_order64 + 4 + 5 + qlpc.quant_precision * q_order64
        + ops_rice.residual_count_bits(lpc_rice)
    )
    return qcoefs, q_order, q_shift, lpc_rice, lpc_bits, lpc_err


def _subframe_candidates(cfg, sig: torch.Tensor, bps_v: torch.Tensor,
                         block_size: int, window: torch.Tensor,
                         ext_qlpc=None, ext_fixed=None,
                         with_errors: bool = False) -> dict:
    """Evaluate all predictor candidates for candidate channels.

    sig: (B, K, T) int32; bps_v: (1, K) int64 bits per sample of each
    candidate; `ext_qlpc` / `ext_fixed`: the strict host arrays (see
    `_strict_ext_arrays`). Returns the per-(B, K) selection tensors of the
    decisions layout; `with_errors` adds "errors", the chosen predictor's
    residual (the fixed one unless LPC won, zeros where a predictor is off
    or the block is too short) wrapped to int16, and "fits16", whether it
    fits int16 unwrapped."""
    sub = cfg.subframe_coding
    B, K, T = sig.shape
    dev = sig.device
    i32, i64 = torch.int32, torch.int64
    max_p = sub.prc.max_parameter
    too_short = T < constants.MIN_BLOCK_SIZE_FOR_PREDICTION

    is_const = torch.all(sig == sig[..., :1], dim=-1)  # (B, K)
    verbatim_bits = 8 + T * bps_v  # (1, K)

    finest = ops_rice.finest_partition_order(T, constants.rice.MIN_PARTITION_SIZE)
    max_parts = 1 << finest

    zero_i = torch.zeros((B, K), dtype=i32, device=dev)
    zero_b = torch.zeros((B, K), dtype=torch.bool, device=dev)
    zero_parts = torch.zeros((B, K, max_parts), dtype=i32, device=dev)
    big = torch.full((B, K), 1 << 62, dtype=i64, device=dev)
    no_rice = ops_rice.RiceSearchResult(
        zero_i, zero_parts, torch.zeros((B, K), dtype=i64, device=dev), zero_b
    )

    if sub.use_fixed and not too_short:
        fx_order, fx_bits, fx_est, fx_rice, fx_errs = _fixed_search(
            sub, sig, bps_v, T, max_p, ext_fixed
        )
        fx_some = fx_est < verbatim_bits
    else:
        fx_order, fx_bits, fx_some, fx_rice = zero_i, big, zero_b, no_rice
        fx_errs = None

    use_lpc = sub.use_lpc and not too_short
    if use_lpc:
        qcoefs, q_order, q_shift, lpc_rice, lpc_bits, lpc_err = _lpc_search(
            sub, sig, bps_v, T, max_p, window, ext_qlpc
        )
    else:
        qcoefs = torch.zeros((B, K, ops_lpc.MAX_LPC_ORDER), dtype=i32, device=dev)
        q_order, q_shift, lpc_rice, lpc_bits = zero_i, zero_i, no_rice, big
        lpc_err = None

    # ---- selection (coding.rs:384-418) ----
    baseline = torch.where(fx_some, torch.minimum(verbatim_bits, fx_bits), verbatim_bits)
    lpc_some = (lpc_bits < baseline) if use_lpc else zero_b
    pred_some = lpc_some | fx_some
    pred_bits = torch.where(lpc_some, lpc_bits, fx_bits)
    pred_type = torch.where(lpc_some, T_LPC, T_FIXED)
    use_pred = pred_some & (pred_bits < verbatim_bits)

    sf_type = torch.where(use_pred, pred_type, T_VERBATIM).to(i32)
    sf_bits = torch.where(use_pred, pred_bits, verbatim_bits)
    if sub.use_constant:
        sf_type = torch.where(is_const, T_CONSTANT, sf_type)
        sf_bits = torch.where(is_const, 8 + bps_v, sf_bits)

    is_lpc = sf_type == T_LPC
    order = torch.where(is_lpc, q_order, torch.where(sf_type == T_FIXED, fx_order, 0))
    out = {
        "sf_type": sf_type,
        "sf_bits": sf_bits,
        "order": order.to(i32),
        "qcoefs": qcoefs,
        "shift": q_shift,
        "rice_order": torch.where(
            is_lpc, lpc_rice.partition_order, fx_rice.partition_order
        ),
        "rice_params": torch.where(is_lpc[..., None], lpc_rice.params, fx_rice.params),
    }
    if with_errors:
        zeros = torch.zeros((B, K, T), dtype=i32, device=dev)
        fx_err = zeros if fx_errs is None else torch.take_along_dim(
            fx_errs, fx_order.to(i64)[..., None, None], dim=2
        )[:, :, 0, :]
        errors = torch.where(is_lpc[..., None], zeros if lpc_err is None else lpc_err, fx_err)
        out["fits16"] = ((errors >= -32768) & (errors <= 32767)).all(dim=-1)
        out["errors"] = errors.to(torch.int16)  # wraps, as XLA's convert does
    return out


class BatchEncoder(nn.Module):
    """The device program for one (config, C, bps, T): (B, C, T) int16/int32
    blocks -> decisions, the port of ``build_encoder_fn``.

    `cfg` is a `config.Encoder` (or its `Verified` wrapper), the config the
    JAX package's ``build_encoder_fn`` takes; the only other
    state is the float32 analysis window, held as a buffer so `.to(device)`
    moves it. Every predictor option of the config is covered (BitCount,
    direct MSE / IRLS, any subset of stereo modes and subframe types, 1-8
    channels, block sizes 32-32767). With `strict_lpc` the forward pass
    takes the strict host arrays after the blocks (see `forward`).

    Outputs: with `decisions_only` (the default, the "native2" packer's
    program) one (B, F) int32 `coalesce_decisions` tensor; with
    `decisions_only=False` a `DeviceEncoded` of tensors, residuals
    included; with `wire_encoded` (which implies residuals) the pair
    (`coalesce_encoded_small`, (B, C, T) int16 residuals) that the "native"
    and "python" packers download.

    `packed_wire` (a wire tuple of ``ops/upack.py``: ("w", order, width),
    ("r", order, p, Wu), ("m", om, pm, wum, os, ps, wus) or ("d", order))
    makes the forward take that wire's payload arrays in place of the
    blocks and rebuild the exact blocks first; the outputs do not change.
    `grouped` = G > 0 makes it take every input stacked G deep and return
    every output stacked G deep: G batches through one call (the JAX
    program's ``lax.map`` over G)."""

    def __init__(self, cfg, nchannels: int, bps: int, block_size: int, *,
                 strict_lpc: bool = False, decisions_only: bool = True,
                 packed_wire=None, wire_encoded: bool = False, grouped: int = 0):
        super().__init__()
        cfg = cfg.inner if isinstance(cfg, Verified) else cfg
        if packed_wire is not None and packed_wire[0] not in ("w", "r", "m", "d"):
            raise ValueError(f"unknown upload wire {packed_wire!r}")
        if packed_wire is not None and packed_wire[0] == "m" and nchannels != 2:
            raise ValueError("the mid/side wire carries stereo blocks only")
        if grouped < 0:
            raise ValueError(f"grouped must be 0 or a group size, not {grouped}")
        self.packed_wire = tuple(packed_wire) if packed_wire is not None else None
        self.grouped = grouped
        self.decisions_only = decisions_only and not wire_encoded
        self.wire_encoded = wire_encoded
        self.cfg = cfg
        self.strict_lpc = strict_lpc
        self.nchannels = nchannels
        self.block_size = block_size
        window = get_window(cfg.subframe_coding.qlpc.window, block_size)
        self.register_buffer("window", torch.from_numpy(window.copy()))
        # per-candidate bits per sample (side takes one more), the enabled
        # stereo assignment codes and their slot tables live on the device
        # so a forward pass copies nothing from the host
        stereo = nchannels == 2
        bps_k = [bps, bps, bps, bps + 1] if stereo else [bps] * nchannels
        self.register_buffer("bps_v", torch.tensor([bps_k], dtype=torch.int64))
        st = cfg.stereo_coding
        codes = [0] + [code for flag, code in ((st.use_leftside, 1),
                                                (st.use_rightside, 2),
                                                (st.use_midside, 3)) if flag]
        self.register_buffer("codes", torch.tensor(codes, dtype=torch.int64))
        self.register_buffer(
            "slots", torch.from_numpy(np.stack([_SLOT0, _SLOT1], axis=-1)).long()
        )

    def forward(self, *inputs: torch.Tensor):
        """(B, C, T) blocks (or the payload of `packed_wire`), then the
        strict host arrays -> the output named in the class docstring; with
        `grouped` every input and output has a leading group axis.

        In strict mode the host arrays are (qcoefs, order, shift) for every
        candidate channel, plus (fixed order, est_bits) when the fixed order
        is selected by ApproxEnt: `_strict_ext_arrays` on the same blocks,
        on the blocks' device."""
        if not self.grouped:
            return self._encode(*inputs)
        outs = [self._encode(*(x[g] for x in inputs)) for g in range(inputs[0].shape[0])]
        first = outs[0]
        if isinstance(first, torch.Tensor):
            return torch.stack(outs)
        fields = [torch.stack(parts) for parts in zip(*outs)]
        return type(first)(*fields) if hasattr(first, "_fields") else tuple(fields)

    def _encode(self, *inputs: torch.Tensor):
        """One batch: the wire's payload is unpacked first (`packed_wire`)."""
        if self.packed_wire is not None:
            blocks, n = upack.unpack_wire(self.packed_wire, inputs, self.block_size)
            ext = inputs[n:]
        else:
            blocks, ext = inputs[0], inputs[1:]
        B, C, T = blocks.shape
        if C != self.nchannels or T != self.block_size:
            raise ValueError(
                f"blocks {tuple(blocks.shape)} do not match (B, {self.nchannels}, "
                f"{self.block_size})"
            )
        if len(ext) not in ((3, 5) if self.strict_lpc else (0,)):
            raise ValueError(
                f"{len(ext)} host arrays given; strict mode takes 3 or 5, "
                "the default mode none"
            )
        blocks = blocks.to(torch.int32)
        stereo = C == 2
        if stereo:
            l = blocks[:, 0, :].to(torch.int64)
            r = blocks[:, 1, :].to(torch.int64)
            mid = ((l + r) >> 1).to(torch.int32)
            side = (l - r).to(torch.int32)
            cand = torch.stack([blocks[:, 0, :], blocks[:, 1, :], mid, side], dim=1)
        else:
            cand = blocks
        res = _subframe_candidates(
            self.cfg, cand, self.bps_v, T, self.window,
            ext_qlpc=ext[:3] or None, ext_fixed=ext[3:5] or None,
            with_errors=not self.decisions_only,
        )

        if stereo:
            bits = res["sf_bits"]  # (B, 4)
            # combo bits of every assignment code, in code order
            every = torch.stack([
                bits[:, _L] + bits[:, _R],  # 0: LR
                bits[:, _L] + bits[:, _S],  # 1: LS
                bits[:, _R] + bits[:, _S],  # 2: RS
                bits[:, _M] + bits[:, _S],  # 3: MS
            ], dim=-1)
            # strict `<` update loop over the enabled codes: the first
            # minimum wins (coding.rs:515-522)
            best = torch.argmin(every[:, self.codes], dim=-1)
            assign = self.codes[best]
            slots = self.slots[assign]  # (B, 2) candidate index per slot

            def gather(a):
                idx = slots.reshape(slots.shape + (1,) * (a.dim() - 2))
                return torch.take_along_dim(a, idx, dim=1)

            res = {k: gather(v) for k, v in res.items()}
            assign = assign.to(torch.int32)
        else:
            assign = torch.zeros((B,), dtype=torch.int32, device=blocks.device)

        if self.decisions_only:
            return coalesce_decisions(DeviceDecisions(assign=assign, **res))
        enc = DeviceEncoded(assign=assign, **res)
        if self.wire_encoded:
            return coalesce_encoded_small(enc), enc.errors
        return enc


# ---------------------------------------------------------------------------
# Host half
# ---------------------------------------------------------------------------


def _assemble_frames(assign, nchannels, frame_numbers, sample_rate, bps,
                     block_size, data, sizes) -> List[Frame]:
    """`Frame` objects carrying slices of the packed bitstream
    (datatype.rs:1036-1049). Every header of a batch shares its specs, so
    the (up to four) header variants are built once and copied per frame."""
    stereo = nchannels == 2
    assignments = (
        _CH_INFO_BY_CODE if stereo else [ChannelAssignment.independent(nchannels)]
    )
    templates = [
        reference_encoder._new_frame_header(block_size, ch, sample_rate, bps)
        for ch in assignments
    ]
    for t in templates:
        t.set_frame_number(0)  # fixed-blocking flip once; copies keep it
    codes = np.asarray(assign).tolist() if stereo else None
    nums = np.asarray(frame_numbers).tolist()
    view = memoryview(data)
    frames: List[Frame] = []
    offset = 0
    for b, size in enumerate(np.asarray(sizes).tolist()):
        header = copy.copy(templates[codes[b] if stereo else 0])
        header.frame_number = nums[b]
        frame = Frame(header, [])
        frame.precomputed_bitstream = bytes(view[offset:offset + size])
        offset += size
        frames.append(frame)
    return frames


def _header_specs(assign: np.ndarray, nchannels: int, bps: int, sample_rate: int,
                  block_size: int):
    """The native packers' per-frame channel tags and shared header specs:
    (ch_tag (B,), (block-size tag, extra bits, extra), (rate tag, extra bits,
    extra), sample-size tag)."""
    if nchannels == 2:
        ch_tag = _ASSIGN_TAGS[assign]
    else:
        ch_tag = np.full(assign.shape[0], nchannels - 1, dtype=np.int32)
    bs = BlockSizeSpec.from_size(block_size)
    # rate 0/None means "not provided" -> the unspecified tag
    sr = (
        SampleRateSpec.from_freq(sample_rate) if sample_rate else None
    ) or SampleRateSpec.UNSPECIFIED
    return (
        ch_tag,
        (bs.tag, bs.count_extra_bits(), bs.extra or 0),
        (sr.tag, sr.count_extra_bits(), sr.extra or 0),
        SampleSizeSpec.from_bits(bps).tag,
    )


def pack_frames_decisions(dec: DeviceDecisions, blocks: np.ndarray, frame_numbers,
                          cfg, nchannels: int, bps: int, sample_rate: int,
                          block_size: int) -> List[Frame]:
    """Frames from numpy decisions and the raw (B, C, T) blocks ("native2").

    The C++ packer recomputes the stored channels and residuals from the
    raw blocks, on `determine_worker_count(cfg)` threads."""
    ch_tag, bs, sr, ss = _header_specs(dec.assign, nchannels, bps, sample_rate, block_size)
    data, sizes = native.pack_frames_recompute(
        blocks, dec.assign, dec.sf_type, dec.order, dec.qcoefs, dec.shift,
        dec.rice_order, dec.rice_params, ch_tag,
        np.asarray(frame_numbers, dtype=np.int64),
        bps, cfg.subframe_coding.qlpc.quant_precision, bs, sr, ss,
        n_threads=determine_worker_count(cfg),
    )
    return _assemble_frames(
        dec.assign, nchannels, frame_numbers, sample_rate, bps, block_size,
        data, sizes,
    )


def _quotients_remainders_batch(errors: np.ndarray, rice_params: np.ndarray,
                                rice_order: np.ndarray, warmup: np.ndarray):
    """Per-sample Rice split of a whole batch: errors (B, C, T) int32,
    rice_params (B, C, P), rice_order and warmup (B, C) -> (quotients,
    remainders), both (B, C, T) uint32 and zero before the warmup. numpy,
    because torch's uint32 has no shifts."""
    B, C, T = errors.shape
    v64 = np.abs(errors.astype(np.int64))
    z = ((v64 << 1) - (errors < 0)).astype(np.uint32)
    t_idx = np.arange(T, dtype=np.int64)
    nparts = (1 << rice_order.astype(np.int64))[..., None]  # (B, C, 1)
    pidx = (t_idx[None, None, :] * nparts) // T
    p_t = np.take_along_axis(rice_params, pidx, axis=2).astype(np.uint32)
    q = z >> p_t
    r = z & ((np.uint32(1) << p_t) - np.uint32(1))
    warm_mask = t_idx[None, None, :] < warmup[..., None]
    q[warm_mask] = 0
    r[warm_mask] = 0
    return q, r


def _slot_signals(blocks: np.ndarray, assign: np.ndarray, nchannels: int) -> np.ndarray:
    """The stored-channel signals, rebuilt on the host: L and R are the
    input blocks, M and S two vector ops (coding.rs:478-484)."""
    if nchannels != 2:
        return np.ascontiguousarray(blocks, dtype=np.int32)
    idx = np.stack([_SLOT0[assign], _SLOT1[assign]], axis=1)[..., None]
    cand = _candidate_signals(blocks, 2)
    return np.ascontiguousarray(np.take_along_axis(cand, idx, axis=1))


def _host_errors(enc: DeviceEncoded, signal: np.ndarray) -> np.ndarray:
    """The downloaded int16 residuals as int32, with every predicted channel
    whose residual did not fit int16 (`fits16` false) recomputed exactly:
    by one batched C++ call over those channels (``native.compute_errors``,
    the kernels the recompute packer uses) when the native library loads,
    else by the numpy oracle's kernels one channel at a time."""
    errors = enc.errors.astype(np.int32)
    needs_fix = (~enc.fits16) & (enc.sf_type >= T_FIXED)
    if not needs_fix.any():
        return errors
    bs, cs = np.nonzero(needs_fix)
    sf_type, order = enc.sf_type[bs, cs], enc.order[bs, cs]
    if native.available():
        errors[bs, cs] = native.compute_errors(
            signal[bs, cs], (sf_type == T_LPC).astype(np.int32), order,
            enc.qcoefs[bs, cs], enc.shift[bs, cs],
        )
        return errors
    for b, c, t, o in zip(bs, cs, sf_type, order):
        if t == T_FIXED:
            errors[b, c] = ref_np.fixed_lpc_errors(signal[b, c])[o]
        else:
            errors[b, c] = ref_np.compute_error(
                enc.qcoefs[b, c, :o].astype(np.int16), int(enc.shift[b, c]), signal[b, c]
            )
    return errors


def pack_frames_native(enc: DeviceEncoded, blocks: np.ndarray, frame_numbers, cfg,
                       nchannels: int, bps: int, sample_rate: int,
                       block_size: int) -> List[Frame]:
    """Frames from numpy `DeviceEncoded` outputs and the raw blocks
    ("native"): the C++ packer writes the downloaded residuals (overflow
    channels recomputed by `_host_errors`)."""
    ch_tag, bs, sr, ss = _header_specs(enc.assign, nchannels, bps, sample_rate, block_size)
    signal = _slot_signals(blocks, enc.assign, nchannels)
    data, sizes = native.pack_frames(
        signal, _host_errors(enc, signal), enc.sf_type, enc.order,
        enc.qcoefs, enc.shift, enc.rice_order, enc.rice_params, ch_tag,
        np.asarray(frame_numbers, dtype=np.int64),
        bps, cfg.subframe_coding.qlpc.quant_precision, bs, sr, ss,
    )
    return _assemble_frames(
        enc.assign, nchannels, frame_numbers, sample_rate, bps, block_size,
        data, sizes,
    )


def frames_from_device(enc: DeviceEncoded, blocks: np.ndarray, frame_numbers, cfg,
                       nchannels: int, bps: int, sample_rate: int,
                       block_size: int) -> List[Frame]:
    """`component` frames built from numpy `DeviceEncoded` outputs ("python",
    the packer that needs no native library): one subframe object per
    channel, serialized by the component model."""
    precision = cfg.subframe_coding.qlpc.quant_precision
    signal = _slot_signals(blocks, enc.assign, nchannels)
    errors = _host_errors(enc, signal)
    B, C, T = signal.shape
    warmup = np.where(enc.sf_type >= T_FIXED, enc.order, 0)
    qarr, rarr = _quotients_remainders_batch(errors, enc.rice_params, enc.rice_order, warmup)

    frames = []
    for b in range(B):
        if nchannels == 2:
            ch_info = _CH_INFO_BY_CODE[enc.assign[b]]
        else:
            ch_info = ChannelAssignment.independent(nchannels)
        header = reference_encoder._new_frame_header(T, ch_info, sample_rate, bps)
        header.set_frame_number(int(frame_numbers[b]))
        subframes = []
        for c in range(C):
            bps_c = bps + ch_info.bits_per_sample_offset(c)
            t = enc.sf_type[b, c]
            sig = signal[b, c]
            if t == T_CONSTANT:
                subframes.append(Constant(T, int(sig[0]), bps_c))
            elif t == T_VERBATIM:
                subframes.append(Verbatim(sig, bps_c))
            else:
                o = int(enc.order[b, c])
                rice_order = int(enc.rice_order[b, c])
                residual = Residual(
                    rice_order, T, o,
                    enc.rice_params[b, c, :1 << rice_order].astype(np.uint8),
                    qarr[b, c], rarr[b, c],
                )
                if t == T_FIXED:
                    subframes.append(FixedLpc(sig[:o], residual, bps_c))
                else:
                    params = QuantizedParameters(
                        enc.qcoefs[b, c, :o].astype(np.int16), o,
                        int(enc.shift[b, c]), precision,
                    )
                    subframes.append(Lpc(sig[:o], params, residual, bps_c))
        frames.append(Frame(header, subframes))
    return frames


_ASSEMBLERS = {
    "native2": pack_frames_decisions,
    "native": pack_frames_native,
    "python": frames_from_device,
}


def resolve_packer(packer: str) -> str:
    """The packer as the JAX package resolves it: "auto" is "native2"
    (decisions only; the C++ packer recomputes the residuals) when the
    native library loads, else "python"."""
    if packer not in PACKERS:
        raise ValueError(f"packer must be one of {PACKERS}, not {packer!r}")
    if packer == "auto":
        return "native2" if native.available() else "python"
    return packer


def _kind(wire) -> str:
    """The racer's kind of an upload wire: "raw", "d" or "pack"."""
    return "raw" if wire is None else ("d" if wire[0] == "d" else "pack")


def _program_array(a: np.ndarray) -> np.ndarray:
    """A host array as a program takes it: uint32 words viewed as int32."""
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _host_tensors(arrays) -> List[torch.Tensor]:
    """Host arrays as the CPU tensors a program takes (uint32 words as int32)."""
    return [torch.from_numpy(np.ascontiguousarray(_program_array(a))) for a in arrays]


def _input_shapes(tensors) -> tuple:
    """((shape, dtype name), ...) of a program's inputs: part of its
    registry key."""
    return tuple((tuple(x.shape), str(x.dtype)) for x in tensors)


def _bucket_pad(chunk: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad a partial batch with zero blocks to the full batch size, so one
    module shape serves the whole stream. Zero blocks are constant
    subframes; their decisions are dropped before packing."""
    n = chunk.shape[0]
    if n == batch_size:
        return chunk
    pad = np.zeros((batch_size - n,) + chunk.shape[1:], chunk.dtype)
    return np.concatenate([chunk, pad])


def _candidate_signals(chunk: np.ndarray, nchannels: int) -> np.ndarray:
    """Host-side candidate channels (L, R, M, S for stereo)."""
    if nchannels != 2:
        return chunk
    l = chunk[:, 0].astype(np.int64)
    r = chunk[:, 1].astype(np.int64)
    return np.stack(
        [chunk[:, 0], chunk[:, 1],
         ((l + r) >> 1).astype(np.int32), (l - r).astype(np.int32)],
        axis=1,
    )


def _strict_ext_arrays(chunk: np.ndarray, cfg, nchannels: int, bps: int, window):
    """Strict-mode host arrays for every candidate channel of a (B, C, T)
    batch: (qcoefs, order, shift) from the native sequential-FMA
    estimator, plus (fixed order, est_bits) from the native sequential-f32
    entropy when the fixed order is selected by ApproxEnt. Both follow the
    reference stable build's float semantics exactly. Raises when the
    native library is missing: strict mode never encodes on without it."""
    if not native.available():
        raise RuntimeError(
            "strict mode requires the native library "
            f"(build failed: {native._load_error!r}); "
            "run `python -m flacenc_tpu_torch.native.build`"
        )
    sub = cfg.subframe_coding
    cand = _candidate_signals(chunk, nchannels)
    B, K, T = cand.shape
    flat = np.ascontiguousarray(cand.reshape(B * K, T), dtype=np.int32)
    q, o, sh = native.strict_qlpc(flat, window, sub.qlpc.lpc_order, sub.qlpc.quant_precision)
    ext = [
        q.reshape(B, K, ops_lpc.MAX_LPC_ORDER),
        o.reshape(B, K).astype(np.int32),
        sh.reshape(B, K).astype(np.int32),
    ]
    if sub.use_fixed and sub.fixed.order_sel.type == "ApproxEnt":
        bps_k = np.array([bps, bps, bps, bps + 1] if nchannels == 2 else [bps] * K, np.int32)
        bps_flat = np.broadcast_to(bps_k, (B, K)).reshape(B * K).copy()
        fo, fe = native.strict_fixed_order(
            flat, bps_flat, sub.fixed.max_order, sub.fixed.order_sel.partitions
        )
        ext += [fo.reshape(B, K).astype(np.int32), fe.reshape(B, K)]
    return tuple(ext)


def resolve_strict(strict_lpc: Optional[bool], cfg) -> bool:
    """Strict mode as the JAX package decides it: `None` reads
    ``FLACENC_STRICT_LPC=1``. Strict mode covers the autocorrelation method
    only, so with `use_direct_mse` an explicit `True` raises and strictness
    from the environment falls back to the default mode."""
    explicit = strict_lpc is True
    if strict_lpc is None:
        strict_lpc = os.environ.get("FLACENC_STRICT_LPC", "") == "1"
    if cfg.subframe_coding.qlpc.use_direct_mse:
        if explicit:
            raise ValueError(
                "strict_lpc covers the autocorrelation method; the "
                "experimental direct-MSE/IRLS estimators have no strict "
                "float path (the reference gates them behind the "
                "'experimental' feature)"
            )
        return False
    return bool(strict_lpc)


# ---------------------------------------------------------------------------
# The upload-wire racer (port of the JAX package's LinkEstimator)
# ---------------------------------------------------------------------------

# a raw wire measured faster than this is not the bottleneck (PCIe class):
# stay on the zero-CPU raw wire and explore no packed format
_FAST_LINK_MBPS = 400.0
# decisions between re-probes of a currently losing wire kind
_EXPLORE_EVERY = 16
# never re-probe a kind predicted worse than this ratio against the current
_EXPLORE_MAX_RATIO = 3.0
# consecutive batches per probe: a drain gap is credited only when the
# drained batch and its predecessor share a wire kind, so a probe holds its
# kind for 2 batches and the second one reads clean
_PROBE_LEN = 2
# consecutive winning `choose` calls before the incumbent is dethroned
_SWITCH_VOTES = 2
# an estimate may win a switch only if sampled within this many decisions
# and this many wall seconds (a link's speed shifts between windows)
_FRESH_AGE = 32
_FRESH_SECONDS = 15.0
# batches between full `try_pack` scans while a cached rice plan packs cleanly
_PLAN_RESCAN_EVERY = 16
# grouped round trips: G batches' payloads stacked, uploaded and run as one
# forward, one (G, B, F) download. Auto mode engages only once the measured
# download-wait EWMA exceeds _GROUP_FETCH_MIN_S; FLACENC_FETCH_GROUP pins G
# (1 = never group)
_FETCH_GROUP_AUTO = 4
_GROUP_FETCH_MIN_S = 0.015
# last measured download-wait EWMA in this process (None until a batch has
# been waited for): seeds a new runner's auto-group gate
_LAST_FETCH_EWMA: Optional[float] = None


class LinkEstimator:
    """Per-wire-kind batch-time racer.

    - `update(nbytes, seconds, kind)` feeds a drained batch's completion gap
      into the kind's geometric EWMA (gaps at full pipeline depth measure
      the bottleneck stage: the link and the wire's own host cost, whichever
      binds). The caller feeds only gaps whose drained batch shares its kind
      with the batch drained just before it (homogeneous pairs).
    - `choose(kinds, current)` returns the kind with the smallest predicted
      gap among kinds with fresh estimates (sampled within `_FRESH_AGE`
      decisions and `_FRESH_SECONDS`), with a 10 % preference for the
      incumbent and a `_SWITCH_VOTES`-decision debounce. Stale kinds are
      reachable only through a `_PROBE_LEN`-batch re-probe, gated by the
      bytes-predicted cost at the incumbent's current speed. A cold start
      measures raw first; packed kinds are explored only once a raw gap
      shows the link slower than `_FAST_LINK_MBPS`.

    Wire kinds: "raw" (int16/int32 PCM), "d" (delta16), "pack" (the dense
    "w"/"r"/"m" wires of ``ops/upack.try_pack``). Output bytes never depend
    on the wire."""

    def __init__(self) -> None:
        self.secs: dict = {}      # kind -> EWMA seconds per batch
        self.nbytes: dict = {}    # kind -> EWMA wire bytes per batch
        self.age: dict = {}       # kind -> choose() calls since sampled
        self.t_sample: dict = {}  # kind -> wall time of the last sample
        self.mbps: Optional[float] = None  # latest effective MB/s (stats)
        self._probe: Optional[tuple] = None  # (kind, batches remaining)
        self._vote: Optional[tuple] = None   # (challenger kind, wins)

    def update(self, nbytes: int, seconds: float, kind: str = "raw") -> None:
        if seconds <= 0 or nbytes <= 0:
            return
        self.mbps = max(nbytes / seconds / 1e6, 1e-3)
        prev = self.secs.get(kind)
        # geometric EWMA that adopts improvements faster (capped at 2x the
        # new sample): stalls inflate a gap, nothing deflates it below the
        # wire's true cost
        self.secs[kind] = (
            seconds if prev is None else min(float((prev * seconds) ** 0.5), 2.0 * seconds)
        )
        prevb = self.nbytes.get(kind)
        self.nbytes[kind] = nbytes if prevb is None else float((prevb * nbytes) ** 0.5)
        self.age[kind] = 0
        self.t_sample[kind] = time.perf_counter()

    def _link_is_fast(self) -> bool:
        raw_s, raw_b = self.secs.get("raw"), self.nbytes.get("raw")
        return raw_s is not None and raw_b is not None and (
            raw_b / raw_s / 1e6 > _FAST_LINK_MBPS
        )

    def _is_fresh(self, kind: str) -> bool:
        t = self.t_sample.get(kind)
        return (
            kind in self.secs
            and self.age.get(kind, _FRESH_AGE + 1) <= _FRESH_AGE
            and t is not None
            and time.perf_counter() - t <= _FRESH_SECONDS
        )

    def initial_kind(self, kinds) -> str:
        """A new runner's starting kind: raw when unproven or on a fast
        link, else the smallest-bytes measured kind."""
        if "raw" not in self.secs or self._link_is_fast():
            return "raw"
        known = [k for k in kinds if k in self.nbytes]
        if not known:
            return "raw"
        return min(known, key=lambda k: self.nbytes[k])

    def choose(self, kinds, current: str) -> str:
        # ages tick per decision, so re-probes fire even while wire churn
        # keeps update() calls sparse
        for k in kinds:
            self.age[k] = self.age.get(k, _FRESH_AGE + 1) + 1
        if self._probe is not None:
            k, n = self._probe
            self._probe = None
            if n > 0 and k in kinds:
                self._probe = (k, n - 1)
                return k
        known = {k: self.secs[k] for k in kinds if k in self.secs}
        if "raw" not in known:
            return "raw"  # cold start: measure the zero-CPU wire first
        if len(known) < len(kinds):
            # unexplored kinds: probe each once, unless raw already shows
            # the link is not the bottleneck
            if self._link_is_fast():
                return "raw"
            for k in kinds:
                if k not in known:
                    self._probe = (k, _PROBE_LEN - 1)
                    return k
        cur = known.get(current, float("inf"))
        cur_bytes = self.nbytes.get(current)
        mbps_cur = (
            cur_bytes / cur / 1e6
            if cur_bytes and cur not in (0.0, float("inf")) else self.mbps
        )
        # stale re-probe, gated by the bytes-predicted cost at the
        # incumbent's speed (clearly losing kinds are probed half as often)
        for k in kinds:
            if k == current or self.age.get(k, 0) < _EXPLORE_EVERY:
                continue
            pred = (
                self.nbytes[k] / (mbps_cur * 1e6)
                if mbps_cur and k in self.nbytes else known.get(k)
            )
            if pred is None or pred > cur * _EXPLORE_MAX_RATIO:
                continue
            if pred > cur * 1.2 and self.age.get(k, 0) < 2 * _EXPLORE_EVERY:
                continue
            self.age[k] = 0
            self._probe = (k, _PROBE_LEN - 1)
            return k
        fresh = {k: v for k, v in known.items() if self._is_fresh(k)}
        if current not in fresh:
            if current in known:
                return current
            return self.initial_kind(kinds)
        best = min(fresh, key=fresh.get)
        if best != current and fresh[best] < cur * 0.9:
            # debounce: a challenger holds its win across _SWITCH_VOTES
            # consecutive decisions before it takes over
            k, n = self._vote if self._vote and self._vote[0] == best else (best, 0)
            n += 1
            if n >= _SWITCH_VOTES:
                self._vote = None
                return best
            self._vote = (k, n)
            return current
        self._vote = None
        return current


# process-wide estimators keyed by payload-shape bucket (log2 of samples per
# batch): the racer keeps learning across encodes of one shape, and batches
# of very different sizes, whose gaps are incomparable, do not mix
_LINK_ESTS: dict = {}


def _shape_bucket(samples_per_batch: int) -> int:
    return max(samples_per_batch, 1).bit_length()


def _link_est_for(bucket: int) -> LinkEstimator:
    est = _LINK_ESTS.get(bucket)
    if est is None:
        est = _LINK_ESTS[bucket] = LinkEstimator()
    return est


# ---------------------------------------------------------------------------
# The link gate: raw PCM ships without the racer while the link, timed on
# the card, moves it in less time than the caller takes to pack any wire
# ---------------------------------------------------------------------------


class Costs:
    """Process-wide costs by key, each a geometric EWMA that adopts an
    improvement at once (capped at 2x the new sample), as the racer's
    estimates do: a stall inflates a cost, nothing deflates it below the
    true one. Safe to feed from several threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._costs: dict = {}

    def note(self, key, sample: float) -> None:
        if sample <= 0:
            return
        with self._lock:
            prev = self._costs.get(key)
            self._costs[key] = sample if prev is None else min(
                float((prev * sample) ** 0.5), 2.0 * sample)

    def get(self, key) -> Optional[float]:
        return self._costs.get(key)


# str(device) -> seconds a byte of its host-to-device link, from the
# event-timed uploads of every wire (`BatchRunner._note_link`)
_LINK_COSTS = Costs()
# (payload-shape bucket, bps, packed kind) -> the caller's seconds to pack
# one batch on that kind's wire (`BatchRunner._upload`)
_PACK_COSTS = Costs()


def link_gate(link_bps: Optional[float], raw_bytes: int, pack_s: dict) -> bool:
    """Whether a batch ships raw PCM without asking the racer: its
    `raw_bytes` over the measured link bandwidth (bytes a second) take less
    time than the least of the measured pack seconds in `pack_s` (packed
    kind -> seconds). A packed wire moves work from the link to the caller's
    thread, which then pays at least that pack, so on such a link no wire
    finishes a batch sooner than raw. False, for the racer, while either
    is unmeasured."""
    if not link_bps or not pack_s:
        return False
    return raw_bytes / link_bps < min(pack_s.values())


# ---------------------------------------------------------------------------
# The program registry: one module, and on a card one CUDA graph, per key
# ---------------------------------------------------------------------------

_PROGRAM_CACHE_SIZE = 64  # entries, least recently used evicted first (not while warming)
_PROGRAMS: "collections.OrderedDict[tuple, Program]" = collections.OrderedDict()
# (device, mesh replica) -> the memory pool that replica's captures share.
# Graphs of one pool may reuse each other's intermediates, so a replay's
# outputs are copied out before the next replay from the same pool; the
# replicas of a mesh replay one after another before any copy, so each has
# a pool of its own.
_GRAPH_POOLS: dict = {}
# (device, mesh replica) -> the first graph captured in that pool, kept for
# the process: the allocator frees a pool once its last graph is gone and
# then refuses a capture into the same handle, which a pool whose graphs
# were all evicted (over a mesh of cards, each key is one entry per card)
# would otherwise meet. Never replayed; the pool's blocks stay reserved
# while any of its graphs lives anyway.
_POOL_ANCHORS: dict = {}
# batch forwards run by the programs (a grouped call runs G): "forwards"
# all of them, "warm_forwards" those that served no batch (a capture's
# warm-up, a background capture's check replay, an eager background warm),
# so that forwards == batch forwards + warm_forwards: what launch counts
# are held to
PROGRAM_COUNTS = {"forwards": 0, "warm_forwards": 0}
# the same "forwards" by the device that ran them (str(device) -> forwards):
# over a mesh of cards, what each card's Rice runs are held to
DEVICE_FORWARDS: dict = {}
# graph captures in the process and their wall seconds, by the thread that
# ran them: "lane" (a dispatch lane, or the caller's thread under
# FLACENC_INLINE_DISPATCH) or "background" (a device's capture thread); and
# the background warms that failed
CAPTURE_COUNTS = {"lane": 0, "lane_s": 0.0, "background": 0, "background_s": 0.0,
                  "warms_failed": 0}
# the registry, the pools and the counts are shared by every runner's
# dispatch lane and by the capture threads
_REGISTRY_LOCK = threading.Lock()
_COUNTS_LOCK = threading.Lock()
_CAPTURE_LOCKS: dict = {}    # str(device) -> the lock every capture on it holds
_CAPTURE_POOLS: dict = {}    # str(device) -> its capture thread (an executor of one)
# (device, mesh replica) -> the lock held from a replay from that replica's
# memory pool to the download (or, for a capture's check, the read) of its
# outputs: a later replay of another graph of the pool may overwrite them
_POOL_LOCKS: dict = {}


def _count_forwards(device: torch.device, n: int, warm: int = 0) -> None:
    with _COUNTS_LOCK:
        PROGRAM_COUNTS["forwards"] += n
        PROGRAM_COUNTS["warm_forwards"] += warm
        DEVICE_FORWARDS[str(device)] = DEVICE_FORWARDS.get(str(device), 0) + n


def _count_capture(where: str, seconds: float) -> None:
    with _COUNTS_LOCK:
        CAPTURE_COUNTS[where] += 1
        CAPTURE_COUNTS[where + "_s"] += seconds


def _outputs_equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _graph_pool(dev: torch.device, replica: tuple):
    with _REGISTRY_LOCK:
        pool = _GRAPH_POOLS.get((dev, replica))
        if pool is None:
            pool = _GRAPH_POOLS[(dev, replica)] = torch.cuda.graph_pool_handle()
    return pool


def _pool_lock(dev: torch.device, replica: tuple):
    # no lock of its own: `program_for` makes programs holding _REGISTRY_LOCK,
    # and one `setdefault` is atomic
    return _POOL_LOCKS.setdefault((dev, replica), threading.RLock())


def _per_device(table: dict, dev: torch.device, make):
    with _REGISTRY_LOCK:
        item = table.get(str(dev))
        if item is None:
            item = table[str(dev)] = make(dev)
    return item


def _capture_pool(dev: torch.device) -> concurrent.futures.ThreadPoolExecutor:
    """The device's capture thread: one worker that runs warms
    (`Program.warm`) one at a time in the order they were queued, so that
    two captures never overlap. It lives until `close_capture_threads`."""
    return _per_device(_CAPTURE_POOLS, dev, lambda d: concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix=f"flacenc-capture-{d}"))


def close_capture_threads() -> None:
    """Finish the queued warms and join every device's capture thread; a
    later warm starts a new one."""
    with _REGISTRY_LOCK:
        pools = list(_CAPTURE_POOLS.values())
        _CAPTURE_POOLS.clear()
    for pool in pools:
        pool.shutdown(wait=True)


class Program:
    """One registry entry: a `BatchEncoder` on one device and, when
    `capture` (a card, and a forward that never syncs), the CUDA graph of
    its forward with static input and output buffers.

    `ready` resolves once the program has run once: on a card, once its
    forward is captured, replayed and checked against an eager warm-up (a
    failure raises); without `capture`, once one eager forward has run. The
    first run happens either on a dispatch lane, at the first call, or on
    the device's capture thread, when `warm` queued it there: the JAX
    package's background compile and first run, which `BatchRunner` asks
    for when it races the wires, so that its lane only ever calls a program
    already run (the raw program of a stream's first batch apart). A warm
    that fails sets its error on `ready` and drops the entry from the
    registry, so that a later runner tries afresh.

    A capture copies its inputs into fresh static buffers, runs the module
    once eagerly on a side stream (the warm-up), captures the forward into
    a graph in its replica's memory pool on that stream, replays it on the
    device's default stream and checks that the replay's outputs equal the
    warm-up's (`checked`). Before it begins it waits for its side stream
    only: a device-wide sync could land inside another thread's capture.
    Captures on one device hold one lock, so they never overlap, and use
    the "thread_local" error mode, so other threads may replay, pin host
    memory and wait on events meanwhile. Later calls copy their inputs
    into the static buffers and replay. A call's copies from the host are
    timed on the card (`device.timed_upload`). A replay overwrites the static
    outputs, and those of a graph may lie in the blocks another graph of
    its pool uses for its intermediates, so from a replay to the download
    (or the check's read) of its outputs the replayer holds `pool_lock`,
    one per memory pool; the caller also holds `lock` from the call to the
    download's event (a registry program is shared by every runner in the
    process, and a warm holds it too). A lane takes its programs' locks
    before their pool locks, and the capture thread never waits for a pool
    lock while it holds the capture lock. Every call and replay runs on
    the device's default stream (`_on_card`). Without `capture` a call
    runs the module eagerly. The module is built at its first use."""

    def __init__(self, key: tuple, build, device: torch.device, capture: bool,
                 replica: tuple = (), batches: int = 1):
        self.key = key
        self._build = build  # makes the module
        self._module: Optional[nn.Module] = None
        self.device = device
        self.replica = replica
        self.capture = capture and device.type == "cuda"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: List[torch.Tensor] = []
        self.static_out = None
        self.batches = batches  # batch forwards one call runs
        self.checked: Optional[bool] = None  # replay == eager on the first call
        self.capture_s = 0.0     # wall seconds of the capture (warm-up, capture, check)
        self.captured_by: Optional[str] = None  # "lane" or "background"
        self.first_run: Optional[str] = None    # the thread that ran it first
        self.ready: concurrent.futures.Future = concurrent.futures.Future()
        self._warm_queued = False
        self._build_lock = threading.Lock()
        self.lock = threading.Lock()  # held from a call to its outputs' download event
        self.pool_lock = (_pool_lock(device, replica) if self.capture
                          else contextlib.nullcontext())

    @property
    def module(self) -> nn.Module:
        if self._module is None:
            with self._build_lock:
                if self._module is None:
                    self._module = self._build()
        return self._module

    def warming(self) -> bool:
        """Whether a warm is queued or running and has not finished."""
        return self._warm_queued and not self.ready.done()

    def _ran(self) -> None:
        """Called, holding `lock`, after a first run that succeeded."""
        if self.first_run is None:
            self.first_run = threading.current_thread().name
        if not self.ready.done():
            self.ready.set_result(None)

    def __call__(self, *inputs: torch.Tensor):
        with _on_card(self.device):
            if not self.capture:
                with timed_upload(self.device, inputs):
                    xs = [x.to(self.device, non_blocking=True) for x in inputs]
                out = self.module(*xs)
                _count_forwards(self.device, self.batches)
                self._ran()
                return out
            if self.graph is None:
                return self._capture(inputs, "lane")
            with timed_upload(self.device, inputs):
                for static, x in zip(self.static_in, inputs):
                    static.copy_(x, non_blocking=True)
            self.graph.replay()
        _count_forwards(self.device, self.batches)
        return self.static_out

    def warm(self, make_inputs) -> tuple:
        """Queue the program's first run on its device's capture thread,
        on the host tensors `make_inputs()` returns there, unless it has
        run or a warm is queued. Returns (`ready`, [this program] if this
        call queued the warm, else [])."""
        with _REGISTRY_LOCK:
            queued = not self._warm_queued and not self.ready.done()
            self._warm_queued = self._warm_queued or queued
        if queued:
            _capture_pool(self.device).submit(self._warm, make_inputs)
        return self.ready, [self] if queued else []

    def _warm(self, make_inputs) -> None:
        """Capture thread: the first run, holding `lock`; an error goes to
        `ready`, and the entry leaves the registry."""
        try:
            with torch.inference_mode(), _on_card(self.device), self.lock:
                if self.ready.done():
                    return
                inputs = make_inputs()
                if self.capture:
                    self._capture(inputs, "background")
                else:
                    self.module(*(x.to(self.device) for x in inputs))
                    _count_forwards(self.device, self.batches, warm=self.batches)
                    self._ran()
        except BaseException as e:  # noqa: BLE001 - raised where the runner asks for it
            with _REGISTRY_LOCK:
                if _PROGRAMS.get(self.key) is self:
                    del _PROGRAMS[self.key]
            with _COUNTS_LOCK:
                CAPTURE_COUNTS["warms_failed"] += 1
            if not self.ready.done():
                self.ready.set_exception(name_card(e, self.device))

    def _capture(self, inputs, where: str):
        t0 = time.perf_counter()
        dev = self.device
        module = self.module
        with torch.cuda.device(dev):
            with _per_device(_CAPTURE_LOCKS, dev, lambda _: threading.Lock()):
                self.static_in = [torch.empty(x.shape, dtype=x.dtype, device=dev)
                                  for x in inputs]
                for static, x in zip(self.static_in, inputs):
                    static.copy_(x, non_blocking=True)
                main = torch.cuda.current_stream(dev)
                side = torch.cuda.Stream(dev)
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    eager = module(*self.static_in)
                graph = torch.cuda.CUDAGraph()
                # capture_begin/end on the side stream, as `torch.cuda.graph`
                # does, without its device sync, gc.collect() and
                # empty_cache(): the sync could land inside another thread's
                # capture, the other two cost tens to hundreds of ms in a
                # process holding a stream's frames, and the cache they empty
                # is what the next forward allocates from
                side.synchronize()
                with torch.cuda.stream(side):
                    graph.capture_begin(pool=_graph_pool(dev, self.replica),
                                        capture_error_mode="thread_local")
                    try:
                        out = module(*self.static_in)
                    finally:
                        graph.capture_end()
                main.wait_stream(side)
                _POOL_ANCHORS.setdefault((dev, self.replica), graph)
            # the check: replay and read the outputs before another graph of
            # the pool replays (a lane already holds the pool lock)
            with self.pool_lock:
                graph.replay()
                # the warm-up's and the replay's; on a lane the replay is its batch's
                _count_forwards(dev, 2 * self.batches,
                                warm=self.batches if where == "lane" else 2 * self.batches)
                self.checked = _outputs_equal(out, eager)
            if not self.checked:
                raise RuntimeError(f"the CUDA graph of {self.key[5:8]} on {dev} differs from its "
                                   "eager forward")
            self.graph, self.static_out = graph, out
        self.capture_s = time.perf_counter() - t0
        self.captured_by = where
        _count_capture(where, self.capture_s)
        self._ran()
        return out


def graph_capturable(cfg, strict_lpc: bool, block_size: int) -> bool:
    """Whether the forward can be captured: the direct-MSE and IRLS solvers
    sync on `failed.any()` once per solve, so their forwards stay eager (in
    strict mode the host supplies the coefficients and nothing syncs)."""
    sub = cfg.subframe_coding
    syncs = (sub.use_lpc and sub.qlpc.use_direct_mse and not strict_lpc
             and block_size >= constants.MIN_BLOCK_SIZE_FOR_PREDICTION)
    return not syncs


def program_for(cfg, nch: int, bps: int, block_size: int, strict_lpc: bool, packer: str,
                wire, shapes: tuple, device: torch.device, grouped: int = 0,
                replica: tuple = ()) -> Program:
    """The registry's program for a key (config, C, bps, T, strict, packer,
    wire, input shapes and dtypes, device, replica of a mesh, G), inserted
    on a miss, the least recently used of `_PROGRAM_CACHE_SIZE` entries
    evicted (a program being warmed stays until its warm ends). Safe to
    call from several threads."""
    key = (cfg.to_toml(), nch, bps, block_size, strict_lpc, packer, wire, shapes,
           str(device), replica, grouped)
    with _REGISTRY_LOCK:
        prog = _PROGRAMS.get(key)
        if prog is not None:
            _PROGRAMS.move_to_end(key)
            return prog
        build = functools.partial(_build_module, cfg, nch, bps, block_size, strict_lpc,
                                  wire, packer, grouped, device)
        prog = Program(key, build, device, graph_capturable(cfg, strict_lpc, block_size),
                       replica, batches=max(1, grouped))
        _PROGRAMS[key] = prog
        while len(_PROGRAMS) > _PROGRAM_CACHE_SIZE:
            old = next((k for k, p in _PROGRAMS.items() if not p.warming()), None)
            if old is None:
                break
            del _PROGRAMS[old]
    return prog


def _build_module(cfg, nch, bps, block_size, strict_lpc, wire, packer, grouped, device):
    return BatchEncoder(
        cfg, nch, bps, block_size, strict_lpc=strict_lpc, packed_wire=wire,
        wire_encoded=packer != "native2", grouped=grouped,
    ).to(device)


# ---------------------------------------------------------------------------
# Pinned staging: host buffers the dispatch lanes upload from and download
# into, kept for the process
# ---------------------------------------------------------------------------

_STAGING_KEYS = _PROGRAM_CACHE_SIZE  # keys kept, least recently used dropped first


class _Slot:
    """One kept host buffer: `held` from its acquisition to its release;
    released, it is free once every one of `events` has completed."""

    __slots__ = ("key", "tensor", "events", "held")

    def __init__(self, key: tuple, tensor: torch.Tensor):
        self.key = key
        self.tensor = tensor
        self.events: tuple = ()
        self.held = True


class StagingPool:
    """Host buffers, pinned for a card, kept across batches, runners and
    calls, keyed by (device, shape, dtype): the uploads a dispatch lane
    fills with one copy from its host arrays, and the buffers it downloads a
    batch's outputs into. A `BatchRunner` is built and closed every call of
    `encode_with_fixed_block_size`, so the buffers outlive it, as the graph
    pools do.

    `acquire` hands out a released slot whose events have all completed
    ("reused"); with none, a new one while the key holds fewer than `cap`
    ("allocated"), or a new one past `cap` when every slot of the key is
    held; else it waits on the events of the slot released first
    ("waited"). `release` gives a slot back with the events that end its
    last use: an upload's, recorded on each card's default stream after
    the copies that read it; none for a download whose events its reader
    has waited on. An event is anything with `query()` and
    `synchronize()`. Keys beyond `_STAGING_KEYS` drop the least recently
    used key none of whose slots is held (the allocator keeps a dropped
    buffer's memory until the copies recorded on it have completed). One
    lock of its own guards the table; waits happen outside it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slots: "collections.OrderedDict[tuple, List[_Slot]]" = collections.OrderedDict()

    def acquire(self, device: torch.device, shape: tuple, dtype: torch.dtype,
                cap: int) -> tuple:
        """(slot, "reused" | "allocated" | "waited") of a held slot."""
        key = (str(device), tuple(shape), dtype)
        with self._lock:
            slots = self._slots.setdefault(key, [])
            self._slots.move_to_end(key)
            idle = [s for s in slots if not s.held]
            slot = next((s for s in idle if all(e.query() for e in s.events)), None)
            how = "reused"
            if slot is None and (len(slots) < cap or not idle):
                slot = _Slot(key, torch.empty(shape, dtype=dtype,
                                              pin_memory=torch.device(device).type == "cuda"))
                slots.append(slot)
                how = "allocated"
                self._evict()
            elif slot is None:
                slot, how = idle[0], "waited"
            slot.held = True
            events, slot.events = slot.events, ()
        if how == "waited":
            for event in events:
                event.synchronize()
        return slot, how

    def release(self, slot: _Slot, events=()) -> None:
        with self._lock:
            slot.events = tuple(events)
            slot.held = False
            slots = self._slots.get(slot.key)
            if slots is not None:  # the oldest release first
                slots.remove(slot)
                slots.append(slot)

    def _evict(self) -> None:
        while len(self._slots) > _STAGING_KEYS:
            old = next((k for k, v in self._slots.items() if not any(s.held for s in v)), None)
            if old is None:
                return
            del self._slots[old]


_STAGING = StagingPool()


def _recorded(dev: torch.device) -> torch.cuda.Event:
    """A CUDA event recorded on the card's default stream now."""
    event = torch.cuda.Event()
    event.record(torch.cuda.default_stream(dev))
    return event


def _fill(slot: torch.Tensor, a: np.ndarray) -> None:
    """Copy `a` into the host tensor `slot` of its shape and dtype: a
    C-contiguous array by a memoryview assignment, one memcpy that keeps
    the interpreter lock (a copy that lets it go, as numpy's and ATen's do,
    then waits to get it back from the threads that keep it busy, up to a
    switch interval), a strided or empty one by `np.copyto`."""
    if a.flags.c_contiguous and a.size:
        memoryview(slot.numpy()).cast("B")[:] = memoryview(a).cast("B")
    else:
        np.copyto(slot.numpy(), a)


@functools.lru_cache(maxsize=None)
def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


# outstanding warm futures, as in the JAX package: of the per-batch wire
# programs (`BatchRunner._start_warm`) and of the grouped programs
# (`_warm_group`); a caller blocks on them after a warm-up encode with
# `wait_wire_warms` / `wait_group_warms` / `wait_all_warms`. Each append
# prunes the futures that have succeeded (a failed one stays until a wait
# reports it).
_WIRE_WARM_FUTURES: list = []
_GROUP_WARM_FUTURES: list = []
_WARMS_LOCK = threading.Lock()


def _track(pending: list, future) -> None:
    with _WARMS_LOCK:
        pending[:] = [f for f in pending if not f.done() or f.exception() is not None]
        pending.append(future)


def _drain_warm_futures(pending, timeout: Optional[float]) -> list:
    """Wait on each warm future under ONE shared deadline, going on past
    failures: a failed or slow warm leaves its runner on a fallback (the
    per-batch path, or a warm wire), a valid state, so one bad warm must not
    abandon the other waits or raise into the caller. Returns the errors of
    the warms that failed."""
    deadline = None if timeout is None else time.monotonic() + timeout
    errors = []
    for fut in pending:
        try:
            left = None if deadline is None else max(0.0, deadline - time.monotonic())
            fut.result(timeout=left)
        except concurrent.futures.TimeoutError:
            continue
        except Exception as e:  # noqa: BLE001 - a warm's error, reported to the caller
            errors.append(e)
    return errors


def _take(pending: list) -> list:
    with _WARMS_LOCK:
        taken = list(pending)
        pending.clear()
    return taken


def wait_wire_warms(timeout: Optional[float] = None) -> list:
    """Block until every outstanding background warm of a wire program has
    settled, or `timeout` seconds have passed (None: no limit). Never
    raises, never synchronizes a device: returns the errors of the warms
    that failed (each also raises from the next `submit` that asks for its
    wire)."""
    return _drain_warm_futures(_take(_WIRE_WARM_FUTURES), timeout)


def wait_group_warms(timeout: Optional[float] = None) -> list:
    """As `wait_wire_warms`, for the grouped programs."""
    return _drain_warm_futures(_take(_GROUP_WARM_FUTURES), timeout)


def wait_all_warms(timeout: Optional[float] = None) -> list:
    """One barrier for measurement programs: the wire warms, then the
    grouped warms, under one shared deadline (each half gets what is left).
    Never raises, never synchronizes a device; returns the failed warms'
    errors."""
    t0 = time.monotonic()
    errors = wait_wire_warms(timeout)
    left = None if timeout is None else max(0.0, timeout - (time.monotonic() - t0))
    return errors + wait_group_warms(left)


class BatchResult(NamedTuple):
    """One packed batch: its frames (padding rows dropped) and the cookie
    the caller submitted with it."""

    frames: List[Frame]
    cookie: object


class _Batch:
    """One submitted batch: host copies of its inputs and, once launched,
    of its outputs."""

    __slots__ = ("blocks", "nums", "rate", "cookie", "payload", "wire", "kind", "nbytes",
                 "seq", "outputs", "staged", "done", "group", "issue", "future", "slot",
                 "link")

    def __init__(self, blocks, nums, rate, cookie, payload, wire, kind, nbytes, seq):
        self.blocks = blocks    # (n, C, T) real (unpadded) blocks
        self.nums = nums        # (n,) frame numbers
        self.rate = rate        # sample rate for the frame headers
        self.cookie = cookie
        self.payload = payload  # the host arrays the program takes
        self.wire = wire        # upload wire tuple, None for raw PCM
        self.kind = kind        # racer kind: "raw", "d" or "pack"
        self.nbytes = nbytes    # upload bytes
        self.seq = seq          # submit sequence number (timeline id)
        self.outputs = None     # output tensors on the host (pinned on a card)
        self.staged = None      # the staging slots of those outputs (a group's first batch)
        self.done: list = []    # CUDA events recorded after the downloads
        self.group = None       # the grouped round trip it rides, if any
        self.issue = None       # the dispatch lane's future of its launch (or its group's)
        self.future = None      # the io worker's [(frames, pack_s)] for it
        self.slot = 0           # its index in that result (its place in the group)
        self.link = ()          # the `device.LinkTiming`s of its upload (a group's first batch)


def _mesh_device_count(mesh, batch_size: int, dev: torch.device) -> int:
    """Devices the batch axis would be split over at this batch size (0:
    none): an explicit mesh's size; for "auto" the visible CUDA device
    count when `_auto_mesh` would engage it. The short-stream clamp uses it
    so it never shrinks the batch to a size the mesh cannot split."""
    if mesh is None:
        return 0
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', None or a BlockMesh, not {mesh!r}")
        if _multi_process():
            # each rank of a multi-process run encodes its own share of a
            # corpus; splitting a rank's batch over every card of the host
            # would put all ranks on all cards
            return 0
        n = torch.cuda.device_count() if dev.type == "cuda" else 0
        return n if n > 1 and batch_size % n == 0 else 0
    return mesh.size


def _home_device(mesh, device) -> torch.device:
    """The runner's device: an explicit mesh's first device (the mesh
    places the batch), else `device`."""
    if mesh is None or isinstance(mesh, str):
        return resolve_device(device)
    return mesh.devices[0]


def _auto_mesh(mesh, batch_size: int, dev: torch.device):
    """Resolve the `mesh` argument: "auto" splits the batch axis over every
    visible CUDA device when `dev` is a card, more than one is visible, the
    batch divides evenly (the par.rs worker-pool map) and the process is not
    one rank of a multi-process group; None keeps one device; a
    `parallel.mesh.BlockMesh` is used as it is. Returns the mesh or None."""
    if isinstance(mesh, str):
        return pmesh.block_mesh() if _mesh_device_count(mesh, batch_size, dev) else None
    return mesh


class BatchRunner:
    """Runs batches of blocks through the registry's programs and packs
    them: the port's stand-in for the JAX package's ``BatchPipeline``,
    shared by `encode_with_fixed_block_size` and ``parallel.encode_corpus``.

    `packer` ("auto", "native2", "native" or "python", resolved by
    `resolve_packer`) picks the module's outputs and the host assembly:
    "native2" downloads the (B, F) decisions; "native" and "python"
    download the `wire_encoded` pair, decisions plus fits16 and the int16
    residuals. `mesh` ("auto", None or a `parallel.mesh.BlockMesh`, see
    `_auto_mesh`) splits every batch over replicas, one program each; each
    shard's outputs land in their rows of one host buffer.

    Programs come from the process-wide registry (`program_for`): on a card
    each is a captured CUDA graph replayed for every batch (the direct-MSE
    and IRLS forwards, which sync, run eagerly), on the CPU the eager module.
    When the racer runs and the stream is not strict (`async_compile`, the
    JAX package's rule), a program's first run (on a card its capture)
    happens on its device's capture thread, never on the lane, but for the
    raw program: the first batch warms the delta16 wire and the wire its
    scan picks (`_prewarm`), and a batch whose chosen wire is not warm yet
    starts its warm and ships on delta16 if this runner knows it warm, else
    raw (`_fallback_wire`); `wire_batches` counts the wire used. A grouped
    program is warmed on the capture thread in every mode, and batches go
    one by one until it is warm. Readiness is decided on the caller's
    thread, in `submit`; a warm that failed raises from the next `submit`
    that asks for its wire or group. `wait_all_warms` waits for the warms.

    `upload_pack` picks the upload wire ("env" reads FLACENC_PACKED_UPLOAD:
    unset races the wires, "1" the dense wire, "d" the delta16 wire, "0"
    raw): True forces the dense wires of ``ops.upack.try_pack`` (raises when
    bps > 24 or the block size is not a multiple of 16), "delta" the delta16
    wire (bps <= 16 only), False raw PCM, "auto" the racer (`LinkEstimator`,
    fed by the drain gaps of homogeneous pairs) behind the link gate
    (`link_gate`): a batch ships raw without asking the racer while raw's
    bytes over the card's link, as timed by CUDA events around the uploads
    of every wire (`_LINK_COSTS`), take less time than the least the caller
    has taken to pack a batch of this shape on any packed wire
    (`_PACK_COSTS`); the CPU has no link, so there the racer alone decides.
    Unset, the racer runs only for the "native2" packer on a card. The
    forced wires are never gated. FLACENC_FETCH_GROUP=G stacks G
    batches into one grouped round trip; unset, grouping engages when the
    measured download wait exceeds `_GROUP_FETCH_MIN_S`.
    No wire and no G changes the bytes.

    `submit` pads a batch to `batch_size` with zero blocks, range-checks it
    and packs its upload wire on the caller's thread (or parks it in the
    open group), then hands the rest of its device lifetime to the
    runner's dispatch lane, one thread taking batches in submit order (the
    JAX package's io tasks ``_updf_plain``, ``_upload_dispatch_fetch`` and
    ``_roundtrip_group``): the strict host arrays when strict, the upload
    (on a card through slots of the process's pinned `StagingPool`, filled
    by one copy), the program call (copy-in and replay, or the eager
    forward), the download enqueue into pinned slots and its CUDA event, a
    full group as one task. The
    lane then hands the wait for the downloads and the host pack to one of
    `max(2, depth)` io workers. One lane keeps the stream order a graph
    replay needs (it overwrites its static outputs, so a batch's download
    is enqueued before the next replay), and each `Program`'s lock keeps it
    across runners. FLACENC_INLINE_DISPATCH (read at each launch; any
    non-empty value) issues on the caller's thread instead, the JAX
    package's kill switch. `submit` returns the oldest batch's frames once
    `depth` (``constants.par.FRAMEBUF_MULTIPLICITY``,
    FLACENC_PIPELINE_DEPTH) are in flight, at least G + 1 while grouping.
    An exception on the lane or a worker comes out of `submit` or `drain`
    as itself when its batch drains; nothing is retried. `drain` yields
    what is still in flight, oldest first; `close` shuts the lane, then
    the workers down.

    `stats` holds wall-clock totals: submit_s (the caller's pad, range
    check and wire pack; under FLACENC_INLINE_DISPATCH also the strict
    arrays, upload and launch), device_wait_s (the caller blocked on the
    lane's issue and a worker's result), pack_s (the workers' assembly
    seconds), batches and max_inflight, upload_bytes and upload_samples
    (each batch's payload bytes as shipped, after any fallback, and the
    padded batch's samples), and upload_raw_batches (the batches shipped on
    raw PCM); `staging` counts its acquisitions of staging slots, and
    `link` the event-timed uploads whose timings its io workers read
    (link_bytes, and link_s on the card's clock; 0 on the CPU).
    FLACENC_TIMELINE=1 gives the runner a `trace.Tracer` (`tracer`, else None): its point events,
    (event, batch, perf_counter, ...) tuples from every thread in time
    order, are `report()`'s `timeline`, and `tracer.report()` hands out
    `spans` (``submit.upload``, the wire's choice and pack, on the caller;
    ``lane.queue``, and ``lane.launch`` with its children, on the lane;
    ``io.wait`` on the workers; see ``trace``) and `trace_clock`
    (perf_to_unix_ns)."""

    def __init__(self, cfg, nch: int, bps: int, block_size: int, batch_size: int,
                 device: str | torch.device = "cuda", strict_lpc: bool = False,
                 packer: str = "auto", mesh="auto", upload_pack="env"):
        self.packer = resolve_packer(packer)
        self.dev = _home_device(mesh, device)
        self.mesh = _auto_mesh(mesh, batch_size, self.dev)
        self.cfg, self.nch, self.bps = cfg, nch, bps
        self.block_size, self.batch_size = block_size, batch_size
        self.strict_lpc = strict_lpc
        self.devices = self.mesh.devices if self.mesh is not None else (self.dev,)
        self.on_cuda = any(d.type == "cuda" for d in self.devices)
        self.assemble = _ASSEMBLERS[self.packer]
        self.strict_window = (
            get_window(cfg.subframe_coding.qlpc.window, block_size) if strict_lpc else None
        )
        self.stats = {"submit_s": 0.0, "device_wait_s": 0.0, "pack_s": 0.0, "batches": 0,
                      "max_inflight": 0, "upload_bytes": 0, "upload_samples": 0,
                      "upload_raw_batches": 0}
        self._inflight: List[_Batch] = []
        self.depth = constants.par.FRAMEBUF_MULTIPLICITY
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(2, self.depth), thread_name_prefix="flacenc-io")
        self._lane = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="flacenc-lane")
        self._lane_tail: Optional[concurrent.futures.Future] = None  # the last lane task
        self._programs: dict = {}  # (wire, shapes, G) -> Program, or a mesh's ShardedEncoder of them
        self._init_upload(upload_pack)
        # background warms (the JAX package's background compile): when the
        # racer runs and the stream is not strict, a wire's program that is
        # not warm yet is warmed on its device's capture thread while the
        # batches ship on a warm wire (`_wire_ready`, `_fallback_wire`)
        self.async_compile = self.upload_mode == "auto" and not strict_lpc
        self._warming: dict = {}       # wire -> the ready future of its warm
        self._ready_wires: set = set()  # wires known to run without a first run
        self._warmed: List[Program] = []  # programs whose warm this runner queued
        self._group_warm: Optional[concurrent.futures.Future] = None
        self._group_key: Optional[tuple] = None  # (wire, payload shapes) of that program
        self._est = _link_est_for(_shape_bucket(batch_size * nch * block_size))
        self._pack_key = (_shape_bucket(batch_size * nch * block_size), bps)  # `_PACK_COSTS`
        # wire kind of the last submitted batch: the racer's incumbent
        self._wire_kind = {"on": "pack", "delta": "d"}.get(self.upload_mode, "raw")
        if self.upload_mode == "auto":
            self._wire_kind = self._est.initial_kind(self._kinds())
        self.upload_pack = self._wire_kind != "raw"
        self._last_drain: Optional[float] = None
        self._prev_drain_kind: Optional[str] = None
        # the last rice/ms plan, reused until it overflows or ages out
        self._rice_plan: Optional[tuple] = None
        self._rice_plan_age = 0
        self.wire_counts: dict = {}   # wire tuple (None = raw) -> batches
        self._wu_sticky: dict = {}    # rice unary budgets only grow: few keys
        self.fetch_group = int(os.environ.get("FLACENC_FETCH_GROUP", "0") or 0)
        self._fetch_ewma: Optional[float] = _LAST_FETCH_EWMA
        self._group_open: List[_Batch] = []
        self.grouped_batches = 0
        self.captures = 0  # programs this runner captured (0 when all were cached)
        self.capture_s = 0.0  # wall seconds those captures took, on the issuing thread
        self._report_lock = threading.Lock()  # captures: written by the lane, read by report
        # acquisitions of `_STAGING` slots (uploads and downloads, on a card):
        # from a kept slot ("waited" too: on its last use's event) or new
        self.staging = {"staging_reused": 0, "staging_allocated": 0, "staging_waited": 0}
        self.staging_cap = max(2, self.depth) + 1  # slots a key keeps: batches in flight + 1
        # the event-timed uploads whose seconds the io workers read (`_note_link`)
        self.link = {"link_bytes": 0, "link_s": 0.0}
        self.tracer: Optional[trace.Tracer] = trace.Tracer() if trace.enabled() else None
        self._seq = 0

    # -- upload wires -------------------------------------------------------

    def _init_upload(self, upload_pack) -> None:
        """`upload_mode` ("off", "on", "delta" or "auto") and the wires'
        eligibility, by the JAX package's rules."""
        explicit_pack = upload_pack is True
        explicit_auto = upload_pack == "auto"
        if upload_pack == "env":
            env = os.environ.get("FLACENC_PACKED_UPLOAD", "")
            upload_pack = {"": "auto", "1": True, "d": "delta"}.get(env, False)
        self.upload_mode = "off"
        eligible = False
        if upload_pack:
            # the dense and rice wires cover hi-res (bps <= 24); delta16's
            # mod-2^16 reconstruction holds for bps <= 16 only
            eligible = self.bps <= upack.MAX_PACK_BPS and self.block_size % upack.GROUP == 0
            if explicit_pack and not eligible:
                raise ValueError(
                    f"upload_pack=True requires bits_per_sample <= {upack.MAX_PACK_BPS} "
                    f"and a block size divisible by {upack.GROUP} "
                    f"(got bps={self.bps}, block_size={self.block_size})"
                )
            if upload_pack == "auto":
                # race only on the decisions path, and on the CPU (no link:
                # uploads are memcpys) only when "auto" was asked for
                if eligible and native.available() and self.packer == "native2":
                    if explicit_auto or self.on_cuda:
                        self.upload_mode = "auto"
            elif eligible:
                if upload_pack == "delta" and self.bps > 16:
                    raise ValueError(
                        "upload_pack='delta' requires bits_per_sample <= 16 "
                        "(wrapped int16 deltas cannot represent hi-res "
                        f"samples; got bps={self.bps})"
                    )
                self.upload_mode = "delta" if upload_pack == "delta" else "on"
        self._eligible_pack = eligible
        self._delta_eligible = eligible and self.bps <= 16

    def _kinds(self) -> tuple:
        return ("raw", "d", "pack") if self._delta_eligible else ("raw", "pack")

    def _try_pack_cached(self, chunk):
        """`upack.try_pack` with plan reuse: a cached rice or mid/side plan
        packs the next batch without a scan, at the plan's own unary
        budgets; an overflow, a non-rice plan or `_PLAN_RESCAN_EVERY`
        batches take the full scan."""
        plan = self._rice_plan
        self._rice_plan_age += 1
        if plan is not None and self._rice_plan_age < _PLAN_RESCAN_EVERY:
            if plan[0] == "m":
                packed = upack.pack_ms(chunk, *plan[1:])
                if packed is not None:
                    return plan, packed
            elif plan[0] == "r":
                _, order, p, wu = plan
                packed = upack._pk_for(order)(chunk, order, p, wu)
                if packed is not None:
                    return plan, packed
        packed = upack.try_pack(chunk, self.bps)
        self._rice_plan = packed[0] if packed is not None else None
        self._rice_plan_age = 0
        return packed

    def _sticky(self, wire, payload):
        """Pad a rice or mid/side payload's unary budget up to the largest
        already used for its (order, p) so that quieter batches reuse one
        program (zero padding is decode-inert)."""
        if wire[0] == "r":
            _, o, p, wu = wire
            floor = self._wu_sticky.get((o, p), 0)
            if wu >= floor:
                self._wu_sticky[(o, p)] = wu
                return wire, payload
            lo, unary, firsts = payload
            unary = np.concatenate(
                [unary, np.zeros(unary.shape[:-1] + (floor - wu,), np.uint32)], axis=-1)
            return ("r", o, p, floor), (lo, unary, firsts)
        if wire[0] == "m":
            _, om, pm, wum, os2, ps, wus = wire
            key = ("m", om, pm, os2, ps)
            fm, fs = self._wu_sticky.get(key, (0, 0))
            fm, fs = max(fm, wum), max(fs, wus)
            self._wu_sticky[key] = (fm, fs)
            if fm > wum or fs > wus:
                payload = upack.pad_ms_unary(payload, wum, wus, fm, fs)
                wire = ("m", om, pm, fm, os2, ps, fs)
        return wire, payload

    def _link_bps(self) -> Optional[float]:
        """The measured link bandwidth for a whole batch, bytes a second:
        over a mesh each card takes its shards' share of the bytes, and the
        slowest share sets it. None while a card is unmeasured (always on
        the CPU, which has no link)."""
        worst = 0.0
        for dev, shards in collections.Counter(str(d) for d in self.devices).items():
            per_byte = _LINK_COSTS.get(dev)
            if per_byte is None:
                return None
            worst = max(worst, per_byte * shards / len(self.devices))
        return 1.0 / worst

    def _raw_wins(self, chunk: np.ndarray) -> bool:
        """The link gate (`link_gate`) for this batch, on the measured
        link and this shape's measured packs."""
        raw_bytes = chunk.size * (2 if self.bps <= 16 else chunk.dtype.itemsize)
        pack_s = {}
        for kind in self._kinds()[1:]:
            seconds = _PACK_COSTS.get(self._pack_key + (kind,))
            if seconds is not None:
                pack_s[kind] = seconds
        return link_gate(self._link_bps(), raw_bytes, pack_s)

    def _upload(self, chunk: np.ndarray):
        """(wire, payload arrays, kind) for this batch: the racer's (or the
        mode's) kind, packed; raw when nothing beats it. The racer is asked
        only while the link gate is open (`_raw_wins`): closed, the batch
        ships raw and the first batch warms no packed wire. The caller's
        seconds of each pack feed `_PACK_COSTS`."""
        kind = "raw"
        gated = False
        if self._eligible_pack:
            if self.upload_mode == "auto":
                gated = self._raw_wins(chunk)
                if not gated:
                    kind = self._est.choose(self._kinds(), self._wire_kind)
            elif self.upload_mode == "on":
                kind = "pack"
            elif self.upload_mode == "delta":
                kind = "d"
        if self.async_compile and not gated and not self.wire_counts and not self._warming:
            self._prewarm(chunk)
        if kind == "raw":
            return None, self._raw(chunk), "raw"
        t0 = time.perf_counter()
        packed = self._try_pack_cached(chunk) if kind == "pack" else upack.pack_delta(chunk)
        if packed is not None:
            packed = self._sticky(*packed)
        _PACK_COSTS.note(self._pack_key + (kind,), time.perf_counter() - t0)
        if packed is None:
            return None, self._raw(chunk), "raw"
        wire, payload = packed
        return wire, tuple(payload), _kind(wire)

    def _raw(self, chunk: np.ndarray) -> tuple:
        # int16 upload when bps <= 16 halves the host->device bytes
        return (chunk if self.bps > 16 or chunk.dtype == np.int16 else chunk.astype(np.int16),)

    # -- background warms (the JAX package's `_start_warm` and its kin) ------

    def _wire_ready(self, wire, payload) -> bool:
        """Whether `wire`'s program can run without a first run on the
        lane: raw always (its program is the one first run on the lane), a
        wire this runner already found warm, a program an earlier runner
        warmed (the registry entry), or one whose warm has finished, whose
        error this raises."""
        if wire is None or wire in self._ready_wires:
            return True
        ready = self._warming.get(wire)
        if ready is None:
            ready = self._program(wire, _input_shapes(_host_tensors(payload))).ready
        if not ready.done():
            return False
        ready.result()
        self._ready_wires.add(wire)
        return True

    def _start_warm(self, wire, payload) -> None:
        """Warm `wire`'s program on its capture thread, on this payload,
        unless it is warming or already ran well."""
        if wire in self._warming:
            return
        prog = self._program(wire, _input_shapes(_host_tensors(payload)))
        if prog.ready.done() and prog.ready.exception() is None:
            self._ready_wires.add(wire)
            return
        ready, queued = prog.warm(lambda: _host_tensors(payload))
        self._warmed += queued
        self._warming[wire] = ready
        _track(_WIRE_WARM_FUTURES, ready)

    def _prewarm(self, chunk: np.ndarray) -> None:
        """On the first batch: warm the delta16 wire (bps <= 16) and the
        dense wire the batch's full scan picks, seeding the sticky unary
        budgets with the latter."""
        if self._delta_eligible:
            self._start_warm(*upack.pack_delta(chunk))
        packed = upack.try_pack(chunk, self.bps)
        if packed is not None:
            wire, payload = packed
            if wire[0] == "r":
                self._wu_sticky[(wire[1], wire[2])] = wire[3]
            elif wire[0] == "m":
                _, om, pm, wum, os2, ps, wus = wire
                self._wu_sticky[("m", om, pm, os2, ps)] = (wum, wus)
            self._start_warm(wire, payload)

    def _fallback_wire(self, chunk: np.ndarray) -> tuple:
        """(wire, payload) of a warm wire for a batch whose chosen wire is
        warming: delta16 once this runner knows it warm, else raw."""
        if self._delta_eligible and ("d", 2) in self._ready_wires:
            wire, payload = upack.pack_delta(chunk)
            return wire, tuple(payload)
        return None, self._raw(chunk)

    def _warm_group(self, wire, payload) -> None:
        """Warm the grouped program of this wire and payload shapes on its
        capture thread, on the payload stacked G deep."""
        g = self.fetch_group or _FETCH_GROUP_AUTO
        shapes = _input_shapes(_host_tensors(payload))
        self._group_key = (wire, shapes)
        prog = self._program(wire, tuple(((g,) + s, d) for s, d in shapes), grouped=g)
        ready, queued = prog.warm(lambda: _host_tensors([np.stack([a] * g) for a in payload]))
        self._warmed += queued
        self._group_warm = ready
        if not ready.done():
            _track(_GROUP_WARM_FUTURES, ready)

    # -- programs and launches ---------------------------------------------

    def _mark(self, event: str, idx, *extra) -> None:
        tracer = self.tracer
        if tracer is not None:
            tracer.mark(event, idx, *extra)

    def _program(self, wire, shapes: tuple, grouped: int = 0):
        """The runner's program for inputs of these (shape, dtype) pairs:
        the registry's program on its device, or over a mesh a
        ``parallel.mesh.ShardedEncoder`` whose replicas are the registry's
        programs for the shards."""
        key = (wire, shapes, grouped)
        prog = self._programs.get(key)
        if prog is None:
            build = functools.partial(program_for, self.cfg, self.nch, self.bps,
                                      self.block_size, self.strict_lpc, self.packer, wire,
                                      grouped=grouped)
            if self.mesh is None:
                prog = build(shapes, self.dev)
            else:  # grouping never runs over a mesh (`_group_target`)
                per = self.batch_size // self.mesh.size
                shard_shapes = tuple(((per,) + s[1:], d) for s, d in shapes)
                prog = pmesh.ShardedEncoder([
                    build(shard_shapes, dev, replica=(repr(self.mesh), i))
                    for i, dev in enumerate(self.mesh.devices)], self.mesh)
            self._programs[key] = prog
        return prog

    def _stage(self, shape: tuple, dtype: torch.dtype) -> _Slot:
        """A held slot of the process's pinned staging pool (`_STAGING`) on
        the runner's device, counted in `report()`."""
        slot, how = _STAGING.acquire(self.dev, shape, dtype, self.staging_cap)
        with self._report_lock:
            self.staging["staging_allocated" if how == "allocated" else "staging_reused"] += 1
            self.staging["staging_waited"] += how == "waited"
        return slot

    def _unstage(self, batch: _Batch) -> None:
        """Give the batch's output slots back (once; a group's ride on its
        first batch): nothing built from them outlives the assembly."""
        slots, batch.staged = batch.staged, None
        for slot in slots or ():
            _STAGING.release(slot)

    def _card_events(self) -> list:
        """An event recorded now on each card's default stream."""
        return [_recorded(dev) for dev in dict.fromkeys(self.devices) if dev.type == "cuda"]

    def _run(self, wire, arrays, grouped: int = 0, seq: Optional[int] = None):
        """Upload `arrays`, run the program (over a mesh each replica on its
        shard) and enqueue every output's download into its rows of one
        host buffer, behind one CUDA event per card. On a card the upload
        goes through slots of the pinned staging pool, each filled by one
        copy and released behind an event per card recorded after the
        program call (whose copies read it), and the outputs land in slots
        of the same pool, which the batch holds until its assembly. It
        sets the thread's inference mode, device and stream itself, and
        holds every program's lock, then every program's pool lock, from
        its call to the event's record. Traced, its parts are the spans
        ``lane.launch.pin`` (the upload slots acquired, any wait included,
        and filled), ``.lock_wait``, ``.replay`` (none for a first run that
        captures) and ``.download`` (the output slots, the copies, the
        events) of batch `seq`. Returns (host outputs, events, output
        slots)."""
        tracer = self.tracer
        staged_in: List[_Slot] = []
        with torch.inference_mode(), _on_card(self.dev), contextlib.ExitStack() as held:
            if self.on_cuda:
                with trace.span(tracer, "lane.launch.pin", seq):
                    for a in map(_program_array, arrays):
                        staged_in.append(self._stage(a.shape, _torch_dtype(a.dtype)))
                        _fill(staged_in[-1].tensor, a)
                inputs = [s.tensor for s in staged_in]
            else:
                inputs = _host_tensors(arrays)
            prog = self._program(wire, _input_shapes(inputs), grouped)
            sharded = isinstance(prog, pmesh.ShardedEncoder)
            progs = prog.replicas if sharded else [prog]
            with trace.span(tracer, "lane.launch.lock_wait", seq):
                for p in progs:  # in mesh order, so two runners never hold them crosswise
                    held.enter_context(p.lock)
                for p in progs:
                    held.enter_context(p.pool_lock)
            fresh = [p for p in progs if p.capture and p.graph is None]
            try:
                with trace.span(None if fresh else tracer, "lane.launch.replay", seq):
                    shards = prog.launch(*inputs) if sharded else [(slice(None), prog(*inputs))]
            finally:
                if staged_in:
                    uploaded = self._card_events()
                    for slot in staged_in:
                        _STAGING.release(slot, uploaded)
            with self._report_lock:
                self.captures += len(fresh)
                self.capture_s += sum(p.capture_s for p in fresh)
            outs = [(sl, (out,) if isinstance(out, torch.Tensor) else tuple(out))
                    for sl, out in shards]
            rows = inputs[0].shape[0]
            with trace.span(tracer, "lane.launch.download", seq):
                shapes = [((rows,) + o.shape[1:], o.dtype) for o in outs[0][1]]
                if self.on_cuda:
                    staged_out = [self._stage(shape, dtype) for shape, dtype in shapes]
                    host = [s.tensor for s in staged_out]
                else:
                    staged_out = []
                    host = [torch.empty(shape, dtype=dtype) for shape, dtype in shapes]
                done = {}
                for sl, out in outs:
                    dev = out[0].device
                    with _on_card(dev):
                        for h, o in zip(host, out):
                            h[sl].copy_(o, non_blocking=self.on_cuda)
                        if dev.type == "cuda":
                            done[dev] = _recorded(dev)
        return host, list(done.values()), staged_out

    def _issue(self, task, *args) -> concurrent.futures.Future:
        """Run `task` (a batch's launch or a group's round trip) on the
        dispatch lane, after every task submitted before it. Under
        FLACENC_INLINE_DISPATCH it runs here, on the caller's thread, once
        the lane has finished what it holds, and the future returned is
        already done."""
        if not os.environ.get("FLACENC_INLINE_DISPATCH"):
            if self.tracer is not None:
                task, args = self._after_queue, (task, time.perf_counter_ns()) + args
            self._lane_tail = self._lane.submit(task, *args)
            return self._lane_tail
        if self._lane_tail is not None:  # switched on mid-stream: keep the launch order
            self._lane_tail.result()
            self._lane_tail = None
        task(*args)
        done: concurrent.futures.Future = concurrent.futures.Future()
        done.set_result(None)
        return done

    def _after_queue(self, task, queued_ns: int, item) -> None:
        """Dispatch lane, traced: the ``lane.queue`` span of `item` (a
        batch, or a group's batches) from its hand-off to now, then
        `task`."""
        self.tracer.record("lane.queue", item.seq if isinstance(item, _Batch) else item[0].seq,
                           queued_ns)
        task(item)

    def _launch(self, batch: _Batch) -> None:
        """Upload and run one batch, enqueue its downloads, and hand the
        wait and the pack to a worker (the JAX package's ``_updf_plain``
        and, when strict, ``_upload_dispatch_fetch``). The strict host
        arrays are computed here, before the upload they ride in. Traced,
        the whole task is the ``lane.launch`` span, with the lane thread's
        CPU time, and the `issued` mark and the hand-off to a worker its
        ``.handoff`` child."""
        with trace.span(self.tracer, "lane.launch", batch.seq, cpu=True):
            arrays = batch.payload
            if self.strict_window is not None:
                chunk = _bucket_pad(batch.blocks, self.batch_size)
                arrays = arrays + _strict_ext_arrays(chunk, self.cfg, self.nch, self.bps,
                                                     self.strict_window)
            with collect_uploads() as link:
                batch.outputs, batch.done, batch.staged = self._run(batch.wire, arrays,
                                                                    seq=batch.seq)
            batch.link = link
            with trace.span(self.tracer, "lane.launch.handoff", batch.seq):
                self._mark("issued", batch.seq)
                batch.future = self._pool.submit(self._fetch_assemble, [batch])

    def _fetch_assemble(self, entries: List[_Batch]):
        """io worker: wait for the entries' downloads (one batch, or a
        grouped round trip's batches, which share their events), then pack
        each, and give their output slots back to the staging pool; the
        waits done, the upload's timings are read (`_note_link`). Returns
        [(frames, pack seconds)] in entry order. Traced, the
        wait is one ``io.wait`` span for the entries, with the worker
        thread's CPU time."""
        grouped = len(entries) > 1
        first = entries[0].seq
        if not grouped:
            self._mark("fetch_start", first)
        out = []
        try:
            with trace.span(self.tracer, "io.wait", first, cpu=True):
                for event in entries[0].done:
                    event.synchronize()
            self._note_link(entries[0].link)
            if grouped:
                self._mark("gfetch_done", first, len(entries))
            else:
                self._mark("fetch_done", first)
            for batch in entries:
                t1 = time.perf_counter()
                n = batch.blocks.shape[0]
                host = [h.numpy()[:n] for h in batch.outputs]
                if self.packer == "native2":
                    enc = split_decisions(host[0], self.nch)
                else:
                    enc = split_encoded(host[0], host[1], self.nch)
                frames = self.assemble(
                    enc, batch.blocks, batch.nums, self.cfg, self.nch, self.bps,
                    batch.rate, self.block_size,
                )
                out.append((frames, time.perf_counter() - t1))
                self._mark("asm_done", batch.seq)
        finally:
            self._unstage(entries[0])
        if grouped:
            self._mark("gasm_done", first, len(entries))
        return out

    def _note_link(self, timings) -> None:
        """io worker, once a batch's downloads have completed (and with
        them every copy enqueued before): each timed upload's seconds on its
        card feed the card's link cost in `_LINK_COSTS`, and the runner's
        link_bytes and link_s."""
        if not timings:
            return
        nbytes, seconds = 0, 0.0
        for t in timings:
            s = t.seconds()
            _LINK_COSTS.note(t.device, s / t.nbytes)
            nbytes += t.nbytes
            seconds += s
        with self._report_lock:
            self.link["link_bytes"] += nbytes
            self.link["link_s"] += seconds

    # -- grouped round trips ------------------------------------------------

    def _group_target(self, wire, payload) -> int:
        """Round-trip group size for this batch: 1 (alone) unless the
        "native2" packer runs unsplit and not strict, either
        FLACENC_FETCH_GROUP pins G > 1 or the download-wait EWMA shows a
        slow link, and the grouped program of this wire and these payload
        shapes is warm; until it is, its warm runs on the capture thread
        (its error raises here)."""
        if self.packer != "native2" or self.mesh is not None or self.strict_lpc:
            return 1
        g = self.fetch_group or _FETCH_GROUP_AUTO
        if g <= 1:
            return 1
        if not self.fetch_group:
            f = self._fetch_ewma
            if f is None or f <= _GROUP_FETCH_MIN_S:
                return 1
        if self._group_key != (wire, _input_shapes(_host_tensors(payload))):
            self._warm_group(wire, payload)
        if not self._group_warm.done():
            return 1
        self._group_warm.result()
        return g

    def _flush_group(self) -> None:
        """Hand the open group to the dispatch lane as one task
        (`_roundtrip_group`)."""
        entries, self._group_open = self._group_open, []
        if not entries:
            return
        self.grouped_batches += len(entries)
        group = {"entries": len(entries), "left": len(entries), "waited": False,
                 "nbytes": sum(e.nbytes for e in entries)}
        for e in entries:
            e.group = group
        issue = self._issue(self._roundtrip_group, entries)
        for e in entries:
            e.issue = issue

    def _roundtrip_group(self, entries: List[_Batch]) -> None:
        """Dispatch lane: launch a group. A full one is one stacked upload,
        one grouped forward and one (G, B, F) download, waited for and
        packed by one worker; a partial one (stream end, a wire or shape
        change) goes batch by batch with the per-batch program."""
        self._mark("gtrip_start", entries[0].seq, len(entries))
        if len(entries) == (self.fetch_group or _FETCH_GROUP_AUTO):
            first = entries[0].seq
            with trace.span(self.tracer, "lane.launch", first, cpu=True):
                stacked = [np.stack([e.payload[i] for e in entries])
                           for i in range(len(entries[0].payload))]
                with collect_uploads() as link:
                    (host,), done, entries[0].staged = self._run(
                        entries[0].wire, stacked, grouped=len(entries), seq=first)
                entries[0].link = link
                for g, e in enumerate(entries):
                    e.outputs, e.done, e.slot = (host[g],), done, g
                with trace.span(self.tracer, "lane.launch.handoff", first):
                    future = self._pool.submit(self._fetch_assemble, entries)
            for e in entries:
                e.future = future
        else:
            for e in entries:
                self._launch(e)
        self._mark("gissued", entries[0].seq, len(entries))

    # -- submit and drain ---------------------------------------------------

    def submit(self, blocks, nums, rate: int, cookie=None) -> Optional[BatchResult]:
        """Queue one batch: a (k, C, T) array or a list of (C, T) blocks,
        k <= batch_size, with their frame numbers. Returns the oldest
        batch's result once `depth` batches (at least G + 1 while grouping)
        are in flight, else None."""
        t0 = time.perf_counter()
        seq = self._seq
        self._seq += 1
        self._mark("submit", seq)
        if not isinstance(blocks, np.ndarray):
            blocks = np.stack(blocks)
        chunk = _bucket_pad(blocks, self.batch_size)
        verify_sample_range(chunk, self.bps)
        with trace.span(self.tracer, "submit.upload", seq):
            wire, payload, kind = self._upload(chunk)
            if self.async_compile and not self._wire_ready(wire, payload):
                # the chosen wire's program warms on the capture thread; this
                # batch ships on a warm wire, so the stream never waits for it
                self._start_warm(wire, payload)
                wire, payload = self._fallback_wire(chunk)
                kind = _kind(wire)
        nbytes = sum(a.nbytes for a in payload)
        self.stats["upload_bytes"] += nbytes
        self.stats["upload_samples"] += chunk.size
        self.stats["upload_raw_batches"] += wire is None
        self._wire_kind = kind
        self.upload_pack = wire is not None
        self.wire_counts[wire] = self.wire_counts.get(wire, 0) + 1
        self._mark("packed", seq, kind, nbytes)
        batch = _Batch(blocks, np.asarray(nums), rate, cookie, payload, wire, kind, nbytes, seq)
        open_ = self._group_open
        if open_ and (open_[0].wire != wire or [a.shape for a in open_[0].payload]
                      != [a.shape for a in payload]):
            self._flush_group()  # mixed payloads never stack into one group
        g = self._group_target(wire, payload)
        if g > 1:
            self._group_open.append(batch)
            if len(self._group_open) >= g:
                self._flush_group()
        else:
            batch.issue = self._issue(self._launch, batch)
        self._inflight.append(batch)
        self.stats["max_inflight"] = max(self.stats["max_inflight"], len(self._inflight))
        self.stats["submit_s"] += time.perf_counter() - t0
        if len(self._inflight) >= (max(self.depth, g + 1) if g > 1 else self.depth):
            return self._drain_one()
        return None

    def _drain_one(self) -> BatchResult:
        """The oldest batch's frames: the lane's issue, then its worker's
        result."""
        saturated = len(self._inflight) >= 2
        batch = self._inflight.pop(0)
        if batch.issue is None and batch.outputs is None:  # parked in the open group
            self._flush_group()
        self._mark("drain_start", batch.seq)
        t0 = time.perf_counter()
        if batch.issue is not None:
            batch.issue.result()
        t_issued = time.perf_counter()
        if batch.future is None:  # handed in launched, without a worker
            batch.future = self._pool.submit(self._fetch_assemble, [batch])
        packed = batch.future.result()
        t1 = time.perf_counter()
        frames, pack_s = packed[batch.slot]
        group = batch.group
        if group is None or not group["waited"]:
            # download-wait EWMA: how long this thread waited for the
            # downloads once the lane had issued the batch, the worker's
            # pack seconds taken out (a group's wait is shared by its
            # batches); the lane's strict arrays and eager forwards are no
            # link
            waited = max(0.0, t1 - t_issued - sum(s for _, s in packed))
            share = waited if group is None else waited / group["entries"]
            prev = self._fetch_ewma
            self._fetch_ewma = share if prev is None else 0.7 * prev + 0.3 * share
            global _LAST_FETCH_EWMA
            _LAST_FETCH_EWMA = self._fetch_ewma
            if group is not None:
                group["waited"] = True
        self._feed_racer(batch, saturated, t1)
        self.stats["device_wait_s"] += t1 - t0
        self.stats["pack_s"] += pack_s
        self.stats["batches"] += 1
        batch.outputs = batch.issue = batch.future = None
        self._mark("drain_done", batch.seq)
        return BatchResult(frames, batch.cookie)

    def _feed_racer(self, batch: _Batch, saturated: bool, now: float) -> None:
        """The racer's sample: the completion gap since the previous drain,
        when this batch and the one drained before it share a wire kind (a
        gap across a wire flip measures the mix). A group gives one sample
        at its last batch, the gap over the whole group divided by G."""
        group, kind = batch.group, batch.kind
        if group is not None:
            group["left"] -= 1
            if group["left"]:
                return
        if self._last_drain is not None and saturated and kind == self._prev_drain_kind:
            if group is None:
                self._est.update(batch.nbytes, now - self._last_drain, kind)
            else:
                g = group["entries"]
                self._est.update(group["nbytes"] / g, (now - self._last_drain) / g, kind)
        self._prev_drain_kind = kind
        self._last_drain = now

    def drain(self) -> Iterator[BatchResult]:
        """Pack every batch still in flight, oldest first."""
        self._flush_group()
        while self._inflight:
            yield self._drain_one()

    def close(self) -> None:
        """Shut the dispatch lane, then the io workers down (a running
        launch may still hand its batch to a worker): work not started is
        cancelled, running work is finished, and every thread is joined.
        The warms this runner queued run on, on the device's capture
        thread (as the JAX package's background compiles do;
        `wait_all_warms` waits for them, `close_capture_threads` joins the
        thread). The output slots of batches whose assembly never ran go
        back to the staging pool."""
        self._lane.shutdown(wait=True, cancel_futures=True)
        self._pool.shutdown(wait=True, cancel_futures=True)
        for batch in self._inflight:
            self._unstage(batch)

    def report(self) -> dict:
        """The runner's wire, group, program, staging and link counts, for
        `stats`."""
        with self._report_lock:
            captures, capture_s = self.captures, self.capture_s
            staging = dict(self.staging)
            link = dict(self.link)
        background = [p for p in self._warmed if p.captured_by == "background"]
        out = {
            "wire_batches": {repr(k): v for k, v in self.wire_counts.items()},
            "grouped_batches": self.grouped_batches,
            "captures": captures,
            "capture_s": capture_s,
            "captures_background": len(background),
            "capture_background_s": sum((p.capture_s for p in background), 0.0),
            "link_mbps": round(self._est.mbps, 1) if self._est.mbps else None,
            **staging,
            **link,
        }
        if self.tracer is not None:
            out["timeline"] = list(self.tracer.points)
        return out


def encode_with_fixed_block_size(
    config: Verified[config_mod.Encoder] | config_mod.Encoder,
    src: Source,
    block_size: int,
    batch_size: int = DEFAULT_BATCH,
    device: str | torch.device = "cuda",
    stats: Optional[dict] = None,
    strict_lpc: Optional[bool] = None,
    packer: str = "auto",
    mesh="auto",
    upload_pack="env",
) -> Stream:
    """Batched stream encoder on PyTorch (public entry).

    Full blocks run through `BatchEncoder` in batches on `device` ("cuda",
    the default, raises when no card is visible; "cpu" runs only when asked
    for), driven by a `BatchRunner`. The ragged tail block, if any, goes
    through the numpy oracle. "cuda" without an index is the current card;
    in one rank of a `torch.distributed` group of more than one process it
    is the rank's own card, LOCAL_RANK modulo the visible card count
    (without LOCAL_RANK the group rank, which raises when the group has
    more ranks than the host has cards: ``device.rank_card``). "cuda:i" is
    always card i, and a card that is not visible raises.

    `strict_lpc` (None reads ``FLACENC_STRICT_LPC=1``) computes the QLPC
    parameters, and the ApproxEnt fixed order, on the host with the
    reference stable build's float semantics (the native library),
    so streams are byte-identical to it; see `resolve_strict` for the rule
    with `use_direct_mse`.

    `packer`: "auto" (the default: "native2" when the native library
    loads, else "python"), "native2" (decisions only; the C++ packer
    recomputes the residuals from the blocks), "native" (the card ships
    the int16 residuals, the C++ packer writes them) or "python"
    (`component` objects built from the shipped residuals). Every packer
    gives the same bytes.

    `mesh`: "auto" (the default) splits each batch over every visible CUDA
    device when `device` is a card, more than one is visible, the batch
    divides evenly and the process is not one rank of a multi-process
    group; a `parallel.mesh.BlockMesh` (which may repeat a device)
    places the shards itself; None keeps one device. Blocks are
    independent, so the mesh changes throughput, never bytes.

    `upload_pack`: "env" (the default) reads FLACENC_PACKED_UPLOAD ("1" the
    dense packed wires, "0" raw, "d" the delta16 wire, unset the per-wire
    racer, which runs for the "native2" packer on a card); True forces the
    dense wires (raises when bps > 24 or the block size is not a multiple
    of 16), "delta" the delta16 wire, False raw PCM, "auto" the racer
    anywhere. FLACENC_FETCH_GROUP=G runs G batches per round trip (see
    `BatchRunner`). The wire and G never change the bytes.

    `stats`: optional dict filled in place with wall-clock totals: read_s,
    submit_s (pad, range check, wire pack; the strict arrays, upload and
    launch run on the runner's dispatch lane, or here too under
    FLACENC_INLINE_DISPATCH), device_wait_s (the caller's thread blocked on
    a batch's issue, downloads and pack, run by the lane and an io worker),
    pack_s (the workers' pack seconds), batches,
    max_inflight (at most FLACENC_PIPELINE_DEPTH), upload_bytes and
    upload_samples (the batches' upload payload bytes as shipped, and their
    padded samples: 4 bytes a sample on the raw int32 wire), frames and
    wall_s, upload_raw_batches (the batches shipped on raw PCM); and
    the runner's wire_batches (batches per upload wire), grouped_batches,
    captures and capture_s (CUDA graphs this encode captured on its lane,
    and their seconds), captures_background and capture_background_s (those
    its warms captured on a capture thread), link_mbps, and staging_reused,
    staging_allocated and staging_waited (the runner's acquisitions of
    pinned staging slots, uploads and downloads: from a kept slot, new, and
    of those kept the ones that waited on the slot's last copy; 0 on the
    CPU), link_bytes and link_s (the uploads timed by CUDA events on the
    card, their bytes and seconds; 0 on the CPU). With
    FLACENC_TIMELINE=1 also timeline (the runner's stage marks), spans
    (this call's, as dicts: name, call, seq, thread, start_ns and end_ns
    on `perf_counter_ns`, cpu_ns of the thread where kept, parent, id; the
    runner's, plus ``call.setup``, ``call.close``, ``call.tail`` and
    ``call.assemble`` here) and trace_clock (perf_to_unix_ns: add it to a
    span's stamps to read them on `torch.profiler`'s clock). A JSON line of
    the run's counts is
    logged at INFO (``FLACENC_LOG=info``)."""
    cfg = config.inner if isinstance(config, Verified) else config
    strict_lpc = resolve_strict(strict_lpc, cfg)
    nch = src.channels()
    bps = src.bits_per_sample()
    rate = src.sample_rate()
    stream = Stream(rate, nch, bps)

    total_hint = src.len_hint()
    if total_hint is not None:
        full_blocks = total_hint // block_size
        if 0 < full_blocks < batch_size:
            # short stream: clamp the padded batch to the next power of two
            # (>= 8) so padding stays < 2x; never raise the caller's size
            cand = max(8, 1 << (full_blocks - 1).bit_length())
            n_dev = _mesh_device_count(mesh, batch_size, _home_device(mesh, device))
            if n_dev:
                # a split batch stays a positive multiple of the mesh size
                cand = -(-max(cand, n_dev) // n_dev) * n_dev
            batch_size = min(batch_size, cand)
    setup_ns = time.perf_counter_ns() if trace.enabled() else None
    runner = BatchRunner(cfg, nch, bps, block_size, batch_size, device, strict_lpc,
                         packer=packer, mesh=mesh, upload_pack=upload_pack)
    # MD5 on a worker thread behind a bounded queue (par.rs:196-277)
    context = AsyncContext(bps, nch)
    tracer = runner.tracer
    if tracer is not None and setup_ns is not None:
        tracer.record("call.setup", None, setup_ns)

    frames: List[Frame] = []
    read_s = 0.0
    t_start = time.perf_counter()

    def submit(blocks: np.ndarray, first: int) -> None:
        result = runner.submit(blocks, np.arange(first, first + blocks.shape[0]), rate)
        if result is not None:
            frames.extend(result.frames)

    tail: Optional[np.ndarray] = None
    try:
        n_full = 0
        framebuf = FrameBuf(nch, block_size)
        # bulk path: whole (k, C, T) batches with one md5 fill each
        while True:
            t0 = time.perf_counter()
            runner._mark("read_start", n_full // batch_size)
            bulk = src.read_blocks_batch(batch_size, block_size, context)
            runner._mark("read_done", n_full // batch_size)
            read_s += time.perf_counter() - t0
            if bulk is None:
                break
            k = bulk.shape[0]
            if k:
                submit(bulk, n_full)
                n_full += k
            if k < batch_size:
                break  # no further full block exists
        pending: List[np.ndarray] = []
        while True:
            t0 = time.perf_counter()
            read = src.read_samples(block_size, (framebuf, context))
            read_s += time.perf_counter() - t0
            if read == 0:
                break
            if read < block_size:
                # a short read is the final (tail) block (source.rs:462)
                tail = framebuf.samples[:, :read].copy()
                break
            pending.append(framebuf.samples.copy())
            if len(pending) == batch_size:
                submit(np.stack(pending), n_full)
                n_full += batch_size
                pending = []
        if pending:
            submit(np.stack(pending), n_full)
        for result in runner.drain():
            frames.extend(result.frames)
    finally:
        with trace.span(tracer, "call.close"):
            runner.close()
            context.shutdown()  # join the MD5 worker (no-op if already done)

    if tail is not None:
        with trace.span(tracer, "call.tail"):
            fb = FrameBuf(nch, tail.shape[1])
            fb.fill_interleaved(np.ascontiguousarray(tail.T).reshape(-1))
            frames.append(reference_encoder.encode_fixed_size_frame(
                cfg, fb, len(frames), stream.stream_info(), strict_lpc=strict_lpc
            ))

    with trace.span(tracer, "call.assemble"):
        for frame in frames:
            stream.add_frame(frame)
        if stream.frame_count() > 0:
            mx = stream.stream_info().max_block_size
            stream.stream_info_mut().set_block_sizes(mx, mx)
        stream.stream_info_mut().set_md5_digest(context.md5_digest())
        total = src.len_hint()
        stream.stream_info_mut().set_total_samples(
            total if total is not None else context.total_samples()
        )
        report = runner.report()
    if stats is not None:
        stats.update(wall_s=time.perf_counter() - t_start, frames=len(frames),
                     read_s=read_s, **runner.stats, **report)
        if tracer is not None:
            stats.update(tracer.report())
    # the stream path's run counts (the par-mode JSONL line, par.rs:414-421)
    info_stats(
        event="stream_encode", frames=len(frames), batches=runner.stats["batches"],
        wire_batches=report["wire_batches"], link_mbps=report["link_mbps"],
        md5_overdue=context.worker.overdue, max_inflight_batches=runner.stats["max_inflight"],
    )
    return stream
