"""The plain reference encoder: one fixed-size block in, one FLAC frame out.

The controller is a frozen copy of ``flacenc_tpu_torch/models/
reference_encoder.py`` at commit 4f28b57 (itself flacenc-rs
``src/coding.rs``), cut to the settings a configuration file of this
benchmark states: the Constant / Fixed / QLPC / Verbatim candidates, the
fixed order by ApproxEnt or by exact bit count, QLPC by autocorrelation +
Levinson, and the four-way stereo search. It builds frames with
``reference.flac`` and imports nothing of the program.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import dsp, flac

MIN_BLOCK_SIZE_FOR_PREDICTION = 64


def _fixed(sub: dict, x: np.ndarray, bps: int, verbatim_bits: int) -> Optional[flac.Subframe]:
    """The fixed predictor the order selector picks (coding.rs:230-331), or
    None where its estimate does not beat verbatim."""
    max_p = sub["prc"]["max_parameter"]
    sel = sub["fixed"]["order_sel"]
    errors = dsp.fixed_errors(x, 4)[: sub["fixed"]["max_order"] + 1]

    def make(order, err, rice=None):
        ro, ps = rice if rice is not None else dsp.rice_parameters(err, order, max_p)
        return flac.Subframe("fixed", bps, x, order=order, residual=err, rice_order=ro,
                             rice_params=ps)

    best = None
    if sel["type"] == "BitCount":
        for order, err in enumerate(errors):
            cand = make(order, err)
            bits = cand.bits() - 8
            if best is None or bits < best[1]:
                best = (cand, bits)
        return best[0] if best[1] < verbatim_bits else None
    for order, err in enumerate(errors):
        bits = dsp.estimate_entropy(err, order, sel["partitions"]) + bps * order
        if best is None or bits < best[1]:
            best = (order, bits)
    if best[1] >= verbatim_bits:
        return None
    return make(best[0], errors[best[0]])


def _lpc(sub: dict, x: np.ndarray, bps: int, qlpc_dtype) -> flac.Subframe:
    """QLPC by autocorrelation + Levinson (coding.rs:333-381)."""
    q = sub["qlpc"]
    if q.get("use_direct_mse") or q["window"]["type"] not in ("Tukey", "Rectangle"):
        raise ValueError("the reference covers autocorrelation QLPC with a Tukey window")
    alpha = q["window"].get("alpha", 0.0) if q["window"]["type"] == "Tukey" else 0.0
    coefs = dsp.lpc_coefs(x, alpha, q["lpc_order"], qlpc_dtype)
    qc, order, shift = dsp.quantize(coefs[: q["lpc_order"]], q["quant_precision"])
    err = dsp.lpc_errors(qc, shift, x)
    ro, ps = dsp.rice_parameters(err, order, sub["prc"]["max_parameter"])
    return flac.Subframe("lpc", bps, x, order=order, qcoefs=qc, precision=q["quant_precision"],
                         shift=shift, residual=err, rice_order=ro, rice_params=ps)


def encode_subframe(sub: dict, x: np.ndarray, bps: int, qlpc_dtype=np.float64) -> flac.Subframe:
    """Candidate generation and selection (coding.rs:384-418)."""
    if sub["use_constant"] and bool((x == x[0]).all()):
        return flac.Subframe("constant", bps, x)
    verbatim_bits = 8 + len(x) * bps
    predict = len(x) >= MIN_BLOCK_SIZE_FOR_PREDICTION
    fixed = _fixed(sub, x, bps, verbatim_bits) if predict and sub["use_fixed"] else None
    baseline = min(verbatim_bits, fixed.bits()) if fixed is not None else verbatim_bits
    chosen = fixed
    if predict and sub["use_lpc"]:
        lpc = _lpc(sub, x, bps, qlpc_dtype)
        if lpc.bits() < baseline:
            chosen = lpc
    if chosen is not None and chosen.bits() < verbatim_bits:
        return chosen
    return flac.Subframe("verbatim", bps, x)


def encode_frame(encoder: dict, block: np.ndarray, rate: int, bps: int, number: int,
                 qlpc_dtype=np.float64) -> bytes:
    """Frame `number` of a fixed-blocksize stream from its (n, channels)
    samples, with the stereo search for two channels (coding.rs:421-544)."""
    sub = encoder["subframe_coding"]
    chans = [np.ascontiguousarray(block[:, c]).astype(np.int32) for c in range(block.shape[1])]
    if len(chans) != 2:
        subs = [encode_subframe(sub, x, bps, qlpc_dtype) for x in chans]
        return flac.write_frame(flac.frame_header(len(block), rate, len(chans) - 1, bps, number),
                                subs)
    l64, r64 = chans[0].astype(np.int64), chans[1].astype(np.int64)
    mid = ((l64 + r64) >> 1).astype(np.int32)
    side = (l64 - r64).astype(np.int32)
    sf_l = encode_subframe(sub, chans[0], bps, qlpc_dtype)
    sf_r = encode_subframe(sub, chans[1], bps, qlpc_dtype)
    sf_m = encode_subframe(sub, mid, bps, qlpc_dtype)
    sf_s = encode_subframe(sub, side, bps + 1, qlpc_dtype)
    bl, br, bm, bs = sf_l.bits(), sf_r.bits(), sf_m.bits(), sf_s.bits()
    st = encoder["stereo_coding"]
    best, pair = bl + br, (flac.INDEPENDENT, sf_l, sf_r)
    # the first strict minimum wins (coding.rs:515-522)
    for flag, bits, cand in (("use_leftside", bl + bs, (flac.LEFT_SIDE, sf_l, sf_s)),
                             ("use_rightside", br + bs, (flac.RIGHT_SIDE, sf_s, sf_r)),
                             ("use_midside", bm + bs, (flac.MID_SIDE, sf_m, sf_s))):
        if st[flag] and bits < best:
            best, pair = bits, cand
    assign, a, b = pair
    return flac.write_frame(flac.frame_header(len(block), rate, assign, bps, number), [a, b])
