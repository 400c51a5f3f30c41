"""The least time the card could take for the work the program does, from
the work's shapes alone, whatever implements it.

Peaks are the published ones of one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates, 700 W): 34 TFLOP/s in float64 outside the tensor cores,
67 TFLOP/s in float32 outside them (integer work is held to the same rate,
as ``chip_smoke.py`` holds the Rice kernel), and 3.35 TB/s of HBM.
"""

from __future__ import annotations

PEAKS = {"f64": 34e12, "int_f32": 67e12, "bytes": 3.35e12}
RICE_PARAMS = 32  # the kernel's table has a column for every p in 0..31


def kernel_bound_ms(rows: int, T: int, finest: int) -> float:
    """Least time of one Rice cost-table launch: the larger of its bytes
    (residuals and warm-ups read once, tables written once) over the memory
    rate and its operations (a shift and an add for every sample and p)
    over the non-tensor rate. Frozen copy of ``chip_smoke.py``
    `kernel_bound_ms` at commit 4f28b57."""
    nbytes = rows * T * 4 + rows * 4 + rows * (1 << finest) * RICE_PARAMS * 4
    ops = 2 * RICE_PARAMS * rows * T
    return max(nbytes / PEAKS["bytes"], ops / PEAKS["int_f32"]) * 1e3


def finest_order(T: int, min_part: int = 64, max_order: int = 15) -> int:
    """The finest Rice partition order of a block (rice.rs:157-165)."""
    splits = T // min_part
    if not splits:
        return 0
    return min(max_order, splits.bit_length() - 1, (T & -T).bit_length() - 1)


def candidates(channels: int) -> int:
    """Signals searched per block: L, R, M, S for stereo, else each channel."""
    return 4 if channels == 2 else channels


def forward_work(batch: int, channels: int, T: int, bps: int, encoder: dict) -> dict:
    """Operations by class and bytes of one forward over `batch` blocks of
    `channels` x `T` samples under the configuration's `encoder` settings:

    - int_f32: the M/S candidates (add, shift, subtract a sample); the fixed
      cascade (one subtraction per order and sample); ApproxEnt (an abs and
      an add per order and sample, and ~8 per partition); the window (a
      multiply a sample); the QLPC residual FIR (a multiply and an add per
      tap and sample, a shift and a subtraction a sample); the zigzag of
      the two residuals searched (3 a sample); the two Rice cost tables as
      `kernel_bound_ms` counts them; their merges and argmins (3 per table
      entry); the order, subframe and stereo argmins;
    - f64: the autocorrelation (a multiply and an add per lag and sample)
      and the Levinson recursion;
    - bytes: the batch's PCM read once and the decisions written once.
    """
    sub = encoder["subframe_coding"]
    K = candidates(channels)
    order = sub["qlpc"]["lpc_order"] if sub["use_lpc"] else 0
    max_order = sub["fixed"]["max_order"] if sub["use_fixed"] else -1
    parts = sub["fixed"]["order_sel"].get("partitions", 0)
    fin = finest_order(T)
    searched = int(sub["use_fixed"]) + int(sub["use_lpc"])
    per_block = 3 * T if channels == 2 else 0
    per_block += K * max(max_order, 0) * T
    per_block += K * (max_order + 1) * (2 * T + 8 * parts)
    if order:
        per_block += K * T + K * (2 * order * T + 2 * T)
    per_block += searched * K * (3 * T + 2 * RICE_PARAMS * T + 3 * (1 << fin) * RICE_PARAMS)
    per_block += K * (max_order + 1 + 3) + 4
    f64 = 0
    if order:
        lev = sum(7 * n + 6 for n in range(1, order))
        f64 = K * (2 * (order + 1) * (T - order) + lev)
    width = 2 if bps <= 16 else 4
    decisions = 1 + channels * (5 + 24 + (1 << fin))
    return {"int_f32": batch * per_block, "f64": batch * f64,
            "bytes": batch * (channels * T * width + decisions * 4)}


def bound_ms(work: dict) -> tuple:
    """(least ms, the class that sets it) of `work` at the peaks."""
    times = {k: work[k] / PEAKS[k] * 1e3 for k in PEAKS}
    worst = max(times, key=times.get)
    return times[worst], worst
