"""Batched frame encoder on PyTorch (port of ``flacenc_tpu/models/batch_encoder.py``).

Device half: `BatchEncoder`, an `nn.Module` standing for the JAX package's
``build_encoder_fn(..., decisions_only=True)``. One forward pass evaluates
every predictor candidate (constant / fixed orders 0-4 / QLPC) for every
block, channel and stereo mode of a `(B, C, T)` batch and selects with exact
integer bit-cost argmins that reproduce the reference's decision procedure
(coding.rs:384-527), tie-breaking included. It returns one (B, F) int32
decisions array laid out by `coalesce_decisions`.

Host half: `BatchRunner` uploads batches (with the strict host arrays of
`_strict_ext_arrays` in strict mode), runs the module and hands the
decisions to the C++ packer (``native.pack_frames_recompute``), which
rebuilds each residual from the raw blocks and writes the frames.
`encode_with_fixed_block_size` reads a source into it; the ragged tail goes
through the numpy oracle (``models/reference_encoder.py``).

Stereo candidates are indexed L=0, R=1, M=2, S=3; assignment codes are
0=LR, 1=LS, 2=RS, 3=MS (selection order matches coding.rs:500-522).
"""

from __future__ import annotations

import copy
import os
import time
from typing import Iterator, List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import config as config_mod
from .. import constants, native
from ..component.datatype import (
    BlockSizeSpec,
    ChannelAssignment,
    Frame,
    SampleRateSpec,
    SampleSizeSpec,
    Stream,
)
from ..device import resolve_device
from ..errors import Verified
from ..ops import fixed as ops_fixed
from ..ops import lpc as ops_lpc
from ..ops import rice as ops_rice
from ..ops.windows import get_window
from ..parallel import determine_worker_count
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

# fixed column groups of the coalesced decisions row, before the variable
# qcoefs (C*24) + rice_params (C*P) tail: assign, then 5 per-channel cols
_WIRE_FIXED_COLS = 5


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


def split_decisions(arr: np.ndarray, nchannels: int) -> DeviceDecisions:
    """Host-side inverse of `coalesce_decisions` on a numpy (B, F) array."""
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
        assign=np.ascontiguousarray(arr[:, 0]),
        sf_type=np.ascontiguousarray(sf_type),
        order=np.ascontiguousarray(order),
        qcoefs=np.ascontiguousarray(qcoefs),
        shift=np.ascontiguousarray(shift),
        rice_order=np.ascontiguousarray(rice_order),
        rice_params=np.ascontiguousarray(rice_params),
        sf_bits=np.ascontiguousarray(sf_bits).astype(np.int64),
    )


def _fixed_search(sub, sig: torch.Tensor, bps_v: torch.Tensor, T: int, max_p: int,
                  ext_fixed=None):
    """Fixed-predictor order selection and its Rice search (coding.rs:298-331).

    ApproxEnt picks the order by the entropy estimate (or takes the strict
    host's (order, est_bits) in `ext_fixed`) and searches Rice parameters
    for that order only; BitCount runs a full Rice search for every order
    0..max_order and picks the exact cost. Both keep the lowest order on a
    tie. Returns (order, exact bits, estimate, RiceSearchResult)."""
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
    return fx_order, fx_bits, fx_est, fx_rice


def _lpc_search(sub, sig: torch.Tensor, bps_v: torch.Tensor, T: int, max_p: int,
                window: torch.Tensor, ext_qlpc=None):
    """Quantized LPC and its Rice search (coding.rs:333-381).

    The coefficients come from the strict host's `ext_qlpc` = (qcoefs,
    order, shift) when given; otherwise from autocorrelation + Levinson, or
    with `use_direct_mse` from the covariance solve, refined by IRLS when
    `mae_optimization_steps` > 0 (coding.rs:333-351). Returns (qcoefs,
    order, shift, RiceSearchResult, exact bits)."""
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
    return qcoefs, q_order, q_shift, lpc_rice, lpc_bits


def _subframe_candidates(cfg, sig: torch.Tensor, bps_v: torch.Tensor,
                         block_size: int, window: torch.Tensor,
                         ext_qlpc=None, ext_fixed=None) -> dict:
    """Evaluate all predictor candidates for candidate channels.

    sig: (B, K, T) int32; bps_v: (1, K) int64 bits per sample of each
    candidate; `ext_qlpc` / `ext_fixed`: the strict host arrays (see
    `_strict_ext_arrays`). Returns the per-(B, K) selection tensors of the
    decisions layout."""
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
        fx_order, fx_bits, fx_est, fx_rice = _fixed_search(sub, sig, bps_v, T, max_p, ext_fixed)
        fx_some = fx_est < verbatim_bits
    else:
        fx_order, fx_bits, fx_some, fx_rice = zero_i, big, zero_b, no_rice

    use_lpc = sub.use_lpc and not too_short
    if use_lpc:
        qcoefs, q_order, q_shift, lpc_rice, lpc_bits = _lpc_search(
            sub, sig, bps_v, T, max_p, window, ext_qlpc
        )
    else:
        qcoefs = torch.zeros((B, K, ops_lpc.MAX_LPC_ORDER), dtype=i32, device=dev)
        q_order, q_shift, lpc_rice, lpc_bits = zero_i, zero_i, no_rice, big

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
    return {
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


class BatchEncoder(nn.Module):
    """The device program for one (config, C, bps, T): (B, C, T) int16/int32
    blocks -> (B, F) int32 coalesced decisions.

    `cfg` is a `config.Encoder` (or its `Verified` wrapper), the config the
    JAX package's ``build_encoder_fn`` takes; the only other
    state is the float32 analysis window, held as a buffer so `.to(device)`
    moves it. Every predictor option of the config is covered (BitCount,
    direct MSE / IRLS, any subset of stereo modes and subframe types, 1-8
    channels, block sizes 32-32767). With `strict_lpc` the forward pass
    takes the strict host arrays after the blocks (see `forward`). The
    residual-shipping outputs and the upload wires of the JAX program raise
    `NotImplementedError` naming the ROADMAP.md queue-1 item that ports
    them."""

    def __init__(self, cfg, nchannels: int, bps: int, block_size: int, *,
                 strict_lpc: bool = False, decisions_only: bool = True,
                 packed_wire=None, wire_encoded: bool = False, grouped: int = 0):
        super().__init__()
        cfg = cfg.inner if isinstance(cfg, Verified) else cfg
        if not decisions_only or wire_encoded:
            raise NotImplementedError(
                "residual-shipping outputs (decisions_only=False, wire_encoded) "
                "are ROADMAP.md queue 1, item 9"
            )
        if packed_wire is not None or grouped:
            raise NotImplementedError(
                "packed upload wires and grouped round trips are ROADMAP.md "
                "queue 1, item 13"
            )
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

    def forward(self, blocks: torch.Tensor, *ext: torch.Tensor) -> torch.Tensor:
        """(B, C, T) blocks -> (B, F) int32 decisions.

        In strict mode `ext` is (qcoefs, order, shift) for every candidate
        channel, plus (fixed order, est_bits) when the fixed order is
        selected by ApproxEnt: `_strict_ext_arrays` on the same blocks,
        on the blocks' device."""
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

        return coalesce_decisions(DeviceDecisions(assign=assign, **res))


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


def pack_frames_decisions(wire: np.ndarray, blocks: np.ndarray, frame_numbers,
                          cfg, nchannels: int, bps: int, sample_rate: int,
                          block_size: int, n_threads: int) -> List[Frame]:
    """Frames from a (B, F) decisions array and the raw (B, C, T) blocks.

    The C++ packer recomputes the stored channels and residuals from the
    raw blocks on `n_threads` threads."""
    dec = split_decisions(wire, nchannels)
    B = dec.assign.shape[0]
    if nchannels == 2:
        ch_tag = _ASSIGN_TAGS[dec.assign]
    else:
        ch_tag = np.full(B, nchannels - 1, dtype=np.int32)
    bs = BlockSizeSpec.from_size(block_size)
    # rate 0/None means "not provided" -> the unspecified tag
    sr = (
        SampleRateSpec.from_freq(sample_rate) if sample_rate else None
    ) or SampleRateSpec.UNSPECIFIED
    ss = SampleSizeSpec.from_bits(bps)
    data, sizes = native.pack_frames_recompute(
        blocks, dec.assign, dec.sf_type, dec.order, dec.qcoefs, dec.shift,
        dec.rice_order, dec.rice_params, ch_tag,
        np.asarray(frame_numbers, dtype=np.int64),
        bps, cfg.subframe_coding.qlpc.quant_precision,
        (bs.tag, bs.count_extra_bits(), bs.extra or 0),
        (sr.tag, sr.count_extra_bits(), sr.extra or 0),
        ss.tag,
        n_threads=n_threads,
    )
    return _assemble_frames(
        dec.assign, nchannels, frame_numbers, sample_rate, bps, block_size,
        data, sizes,
    )


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


class BatchResult(NamedTuple):
    """One packed batch: its frames (padding rows dropped) and the cookie
    the caller submitted with it."""

    frames: List[Frame]
    cookie: object


class _Batch(NamedTuple):
    """One batch in flight: host copies of its inputs and its decisions."""

    blocks: np.ndarray       # (n, C, T) real (unpadded) blocks
    nums: np.ndarray         # (n,) frame numbers
    rate: int                # sample rate for the frame headers
    cookie: object
    decisions: torch.Tensor  # (B, F) int32 on the host (pinned for CUDA)
    done: Optional[torch.cuda.Event]  # recorded after the download (CUDA)


class BatchRunner:
    """Runs batches of blocks through one `BatchEncoder` and packs them: the
    port's stand-in for the JAX package's ``BatchPipeline``, shared by
    `encode_with_fixed_block_size` and ``parallel.encode_corpus``.

    `submit` pads a batch to `batch_size` with zero blocks, range-checks it,
    computes the strict host arrays when strict, uploads and launches it,
    then packs the batch before it: the host packs batch i (and computes
    batch i+1's strict arrays) while the card runs batch i+1, a one-deep
    overlap. `drain` packs what is still in flight.

    `stats` holds wall-clock totals: submit_s (pad, range check, strict
    arrays, upload, launch), device_wait_s (waiting for the decisions),
    pack_s and batches."""

    def __init__(self, cfg, nch: int, bps: int, block_size: int, batch_size: int,
                 device: str | torch.device = "cuda", strict_lpc: bool = False):
        self.dev = resolve_device(device)
        self.cfg, self.nch, self.bps = cfg, nch, bps
        self.block_size, self.batch_size = block_size, batch_size
        self.encoder = BatchEncoder(cfg, nch, bps, block_size, strict_lpc=strict_lpc).to(self.dev)
        self.strict_window = (
            get_window(cfg.subframe_coding.qlpc.window, block_size) if strict_lpc else None
        )
        self.n_threads = determine_worker_count(cfg)
        self.stats = {"submit_s": 0.0, "device_wait_s": 0.0, "pack_s": 0.0, "batches": 0}
        self._inflight: List[_Batch] = []

    def _launch(self, blocks: np.ndarray, nums: np.ndarray, rate: int, cookie) -> _Batch:
        chunk = _bucket_pad(blocks, self.batch_size)
        verify_sample_range(chunk, self.bps)
        # int16 upload when bps <= 16 halves the host->device bytes
        up = chunk if self.bps > 16 or chunk.dtype == np.int16 else chunk.astype(np.int16)
        arrays = [up]
        if self.strict_window is not None:
            arrays += _strict_ext_arrays(chunk, self.cfg, self.nch, self.bps, self.strict_window)
        inputs = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
        on_cuda = self.dev.type == "cuda"
        with torch.inference_mode():
            if on_cuda:
                inputs = [x.pin_memory().to(self.dev, non_blocking=True) for x in inputs]
            out = self.encoder(*inputs)
            done = None
            if on_cuda:
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
                out = host
        return _Batch(blocks, nums, rate, cookie, out, done)

    def _finish(self, batch: _Batch) -> BatchResult:
        t0 = time.perf_counter()
        if batch.done is not None:
            batch.done.synchronize()
        t1 = time.perf_counter()
        n = batch.blocks.shape[0]
        frames = pack_frames_decisions(
            batch.decisions.numpy()[:n], batch.blocks, batch.nums, self.cfg, self.nch,
            self.bps, batch.rate, self.block_size, self.n_threads,
        )
        self.stats["device_wait_s"] += t1 - t0
        self.stats["pack_s"] += time.perf_counter() - t1
        self.stats["batches"] += 1
        return BatchResult(frames, batch.cookie)

    def submit(self, blocks, nums, rate: int, cookie=None) -> Optional[BatchResult]:
        """Queue one batch: a (k, C, T) array or a list of (C, T) blocks,
        k <= batch_size, with their frame numbers. Returns the previous
        batch's result, or None while nothing else is in flight."""
        t0 = time.perf_counter()
        if not isinstance(blocks, np.ndarray):
            blocks = np.stack(blocks)
        self._inflight.append(self._launch(blocks, np.asarray(nums), rate, cookie))
        self.stats["submit_s"] += time.perf_counter() - t0
        if len(self._inflight) > 1:
            return self._finish(self._inflight.pop(0))
        return None

    def drain(self) -> Iterator[BatchResult]:
        """Pack every batch still in flight, oldest first."""
        while self._inflight:
            yield self._finish(self._inflight.pop(0))


def encode_with_fixed_block_size(
    config: Verified[config_mod.Encoder] | config_mod.Encoder,
    src: Source,
    block_size: int,
    batch_size: int = DEFAULT_BATCH,
    device: str | torch.device = "cuda",
    stats: Optional[dict] = None,
    strict_lpc: Optional[bool] = None,
) -> Stream:
    """Batched stream encoder on PyTorch (public entry).

    Full blocks run through `BatchEncoder` in batches on `device` ("cuda",
    the default, raises when no card is visible; "cpu" runs only when asked
    for), driven by a `BatchRunner`. The ragged tail block, if any, goes
    through the numpy oracle.

    `strict_lpc` (None reads ``FLACENC_STRICT_LPC=1``) computes the QLPC
    parameters, and the ApproxEnt fixed order, on the host with the
    reference stable build's float semantics (the native library),
    so streams are byte-identical to it; see `resolve_strict` for the rule
    with `use_direct_mse`.

    `stats`: optional dict filled in place with wall-clock totals: read_s,
    submit_s (pad, range check, strict arrays, upload, launch),
    device_wait_s (waiting for the decisions), pack_s, batches, frames and
    wall_s."""
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
            batch_size = min(batch_size, max(8, 1 << (full_blocks - 1).bit_length()))
    runner = BatchRunner(cfg, nch, bps, block_size, batch_size, device, strict_lpc)
    # MD5 on a worker thread behind a bounded queue (par.rs:196-277)
    context = AsyncContext(bps, nch)

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
            bulk = src.read_blocks_batch(batch_size, block_size, context)
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
        context.shutdown()  # join the MD5 worker (no-op if already done)

    if tail is not None:
        fb = FrameBuf(nch, tail.shape[1])
        fb.fill_interleaved(np.ascontiguousarray(tail.T).reshape(-1))
        frames.append(reference_encoder.encode_fixed_size_frame(
            cfg, fb, len(frames), stream.stream_info(), strict_lpc=strict_lpc
        ))

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
    if stats is not None:
        stats.update(wall_s=time.perf_counter() - t_start, frames=len(frames),
                     read_s=read_s, **runner.stats)
    return stream
