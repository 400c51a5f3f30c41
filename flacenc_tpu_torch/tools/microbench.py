"""Per-stage and per-op times of one `BatchEncoder` forward, the host packer
and MD5 rates, and the Rice kernel against its plain version (the port's
counterpart of the JAX package's ``tools/microbench.py``).

    python -m flacenc_tpu_torch.tools.microbench [--batch 64] [--block 4096]
        [--reps 20] [--kernel-sweep] [--cpu-only]

Each stage runs on the stages before it, on seeded 16-bit stereo blocks
under the default config: the candidate channels (L, R, M, S), the fixed
predictor search (residuals of orders 0-4, ApproxEnt, its Rice search),
the LPC search (window, autocorrelation, Levinson, quantization, residual,
its Rice search), one Rice parameter search alone, and the whole forward;
"rest of forward" (the subframe and stereo selection and the coalesce) is
the forward less the first three. For each: `device_ms`, the median over
`--reps` replays of a CUDA graph of the stage timed by CUDA events (the
card's own time, no host launch cost), and `host_ms`, the median wall
time of one eager call (what the host spends enqueueing it; the card idles
when this is the larger). With ``--cpu-only`` both are the eager wall
time. Then the Rice cost-table kernel and its plain version at the
forward's shape.

The per-op rows are the JAX tool's, under its names, on its seeded
(batch, 4, block) int32 input: the fixed residual cascade, five ApproxEnt
estimates, the window, the f64 autocorrelation and Levinson, the i64 FIR,
the full Rice search and direct-MSE LPC (which syncs once per solve, so
its `device_ms` is the CUDA-event span of one eager call). The host rows
are the C++ packer on one batch's decisions (ms a batch and x-realtime
alone) and MD5 in MB/s, each the median of `--reps` calls.

``--kernel-sweep`` (the JAX tool's ``--pallas-sweep``) runs only the Rice
kernel against its plain version over block 1024 / 4096 / 16384 x batch
32 / 128 / 512 with 4 channels, both timed as CUDA-graph replays, prints a
winner column, and raises unless the kernel's tables equal the plain
version's on every shape.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import config, constants, native
from ..models import batch_encoder as be
from ..ops import fixed as ops_fixed
from ..ops import lpc as ops_lpc
from ..ops import rice as ops_rice
from ..ops import rice_tables
from ..ops.windows import get_window

SWEEP_BLOCKS = (1024, 4096, 16384)
SWEEP_BATCHES = (32, 128, 512)
SWEEP_CALLS = 10  # calls of a function per timed graph replay in the sweep


def time_stage(fn, dev: torch.device, reps: int, capture: bool = True) -> dict:
    """{"device_ms", "host_ms"} of `fn()` (see the module docstring), after
    two warm-up calls. With `capture` False (a function that syncs, or that
    replays a graph itself) `device_ms` is the median span of CUDA events
    around one eager call."""
    for _ in range(2):
        fn()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    host_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            torch.cuda.synchronize(dev)
    host = statistics.median(host_ms)
    if not cuda:
        return {"device_ms": host, "host_ms": host}
    run = fn
    if capture:
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()  # a warm-up on the capture stream
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.cuda.graph(graph):
            fn()
        run = graph.replay
    device_ms = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
    return {"device_ms": statistics.median(device_ms), "host_ms": host}


def op_rows(dev: torch.device, B: int, T: int, reps: int) -> dict:
    """The JAX tool's per-op rows on its seeded (B, 4, T) int32 input."""
    rng = np.random.default_rng(0)
    sig = torch.from_numpy(rng.integers(-(1 << 14), 1 << 14, (B, 4, T), np.int32)).to(dev)
    win = torch.from_numpy(get_window(config.Window(), T).copy()).to(dev)
    warm = torch.full((B, 4), 10, dtype=torch.int32, device=dev)
    qc = torch.from_numpy(rng.integers(-16000, 16000, (B, 4, 24), np.int32)).to(dev)
    order = torch.full((B, 4), 10, dtype=torch.int32, device=dev)
    shift = torch.full((B, 4), 12, dtype=torch.int32, device=dev)
    ops = {
        "fixed_lpc_errors (5 orders)": lambda: ops_fixed.fixed_lpc_errors(sig),
        "estimate_entropy x5": lambda: [ops_fixed.estimate_entropy(sig, warm, 16, T)
                                        for _ in range(5)],
        "windowing f32": lambda: ops_lpc.apply_window(sig, win),
        "autocorr f64 (order 10)": lambda: ops_lpc.auto_correlation(
            ops_lpc.apply_window(sig, win), 10),
        "+levinson f64 (order 10)": lambda: ops_lpc.levinson(ops_lpc.auto_correlation(
            ops_lpc.apply_window(sig, win), 10), 10),
        "compute_error i64 FIR (10 taps)": lambda: ops_lpc.compute_error(
            qc, order, shift, sig, max_taps=10),
        "rice search (full)": lambda: ops_rice.find_partitioned_rice_parameters(
            sig, warm, T, 30),
    }
    out = {name: time_stage(fn, dev, reps) for name, fn in ops.items()}
    out["direct-MSE LPC (order 10)"] = time_stage(
        lambda: ops_lpc.lpc_direct_mse(ops_lpc.apply_window(sig, win), 10), dev, reps,
        capture=False)
    return out


def host_rows(enc: be.BatchEncoder, blocks: torch.Tensor, cfg, reps: int) -> dict:
    """The C++ packer on one batch's decisions (skipped without the native
    library, as in the JAX tool) and MD5 over the batch's PCM."""
    B, C, T = blocks.shape
    host_blocks = blocks.cpu().numpy()
    out = {}
    if native.available():
        dec = be.split_decisions(enc(blocks).cpu().numpy(), C)
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            be.pack_frames_decisions(dec, host_blocks, np.arange(B), cfg, C, 16, 44100, T)
            ms.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(ms)
        out["host packer (decisions recompute)"] = {
            "ms_per_batch": ms, "x_realtime": B * T / 44100 / (ms / 1e3)}
    pcm = host_blocks.astype("<i2").tobytes()
    s = []
    for _ in range(reps):
        t0 = time.perf_counter()
        hashlib.md5(pcm).digest()
        s.append(time.perf_counter() - t0)
    out["md5"] = {"mb_per_s": len(pcm) / statistics.median(s) / 1e6}
    return out


def kernel_sweep(dev: torch.device, reps: int) -> list:
    """The Rice kernel against its plain version over `SWEEP_BLOCKS` x
    `SWEEP_BATCHES` (4 channels, the JAX sweep's seeded residuals and
    warm-ups of 10); each time is one call's, `SWEEP_CALLS` calls captured
    per graph replay. Raises unless the kernel's tables equal the plain
    version's on every shape."""
    rng = np.random.default_rng(0)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# Rice cost tables, CUDA kernel vs plain torch ({name}, median of {reps}); "
          "ms per call")
    print(f"{'B':>5s} {'T':>6s} {'finest':>6s} {'plain':>10s} {'kernel':>10s} {'winner':>7s}")
    rows = []
    fns = {"plain": rice_tables.rice_cost_tables_plain, "kernel": rice_tables.rice_cost_tables}
    for T in SWEEP_BLOCKS:
        finest = ops_rice.finest_partition_order(T, constants.rice.MIN_PARTITION_SIZE)
        for B in SWEEP_BATCHES:
            err = torch.from_numpy(rng.integers(-(1 << 14), 1 << 14, (B, 4, T), np.int32)).to(dev)
            warm = torch.full((B, 4), 10, dtype=torch.int32, device=dev)
            got = rice_tables.rice_cost_tables(err, warm, finest)
            exp = rice_tables.rice_cost_tables_plain(err, warm, finest)
            max_abs_err = int((got.to(torch.int64) - exp.to(torch.int64)).abs().max())
            if max_abs_err or not torch.equal(got, exp):
                raise AssertionError(f"rice_cost_tables differs from its plain version at "
                                     f"B={B} T={T}: max_abs_err {max_abs_err}")
            ms = {}
            for which, f in fns.items():
                t = time_stage(lambda f=f: [f(err, warm, finest) for _ in range(SWEEP_CALLS)],
                               dev, reps)
                ms[which] = t["device_ms"] / SWEEP_CALLS
            winner = "KERNEL" if ms["kernel"] < ms["plain"] else "plain"
            print(f"{B:5d} {T:6d} {finest:6d} {ms['plain']:10.5f} {ms['kernel']:10.5f} "
                  f"{winner:>7s}")
            rows.append({"batch": B, "channels": 4, "block": T, "finest": finest,
                         "plain_ms": ms["plain"], "kernel_ms": ms["kernel"], "winner": winner,
                         "max_abs_err": max_abs_err})
            del err, got, exp
    print(json.dumps({"device": name, "reps": reps, "sweep": rows}))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flacenc_tpu_torch.tools.microbench")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernel-sweep", action="store_true",
                    help="run the Rice kernel vs plain sweep over batch x block and exit")
    ap.add_argument("--cpu-only", action="store_true", help="run on the CPU, not on cuda")
    args = ap.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device("cpu" if args.cpu_only else "cuda")
    if args.kernel_sweep:
        kernel_sweep(dev, args.reps)
        return 0
    B, T = args.batch, args.block
    cfg = config.Encoder()
    sub = cfg.subframe_coding
    enc = be.BatchEncoder(cfg, 2, 16, T).to(dev)
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(rng.integers(-(1 << 14), 1 << 14, (B, 2, T)).astype(np.int16)).to(dev)
    finest = ops_rice.finest_partition_order(T, constants.rice.MIN_PARTITION_SIZE)
    max_p = sub.prc.max_parameter

    def candidates():
        b = blocks.to(torch.int32)
        l, r = b[:, 0].to(torch.int64), b[:, 1].to(torch.int64)
        return torch.stack([b[:, 0], b[:, 1], ((l + r) >> 1).to(torch.int32),
                            (l - r).to(torch.int32)], dim=1)

    with torch.inference_mode():
        cand = candidates()
        fx = be._fixed_search(sub, cand, enc.bps_v, T, max_p)
        fx_err = torch.take_along_dim(fx[4], fx[0].to(torch.int64)[..., None, None], dim=2)[:, :, 0]
        stages = {
            "candidates": candidates,
            "fixed search": lambda: be._fixed_search(sub, cand, enc.bps_v, T, max_p),
            "lpc search": lambda: be._lpc_search(sub, cand, enc.bps_v, T, max_p, enc.window),
            "rice search": lambda: ops_rice.find_partitioned_rice_parameters(
                fx_err, fx[0], T, max_p),
            "forward": lambda: enc(blocks),
        }
        out = {name: time_stage(fn, dev, args.reps) for name, fn in stages.items()}
        parts = ("candidates", "fixed search", "lpc search")
        out["rest of forward"] = {
            k: out["forward"][k] - sum(out[p][k] for p in parts) for k in ("device_ms", "host_ms")
        }
        warm = torch.full(fx_err.shape[:2], 4, dtype=torch.int32, device=dev)
        out["rice_cost_tables"] = time_stage(
            lambda: rice_tables.rice_cost_tables(fx_err, warm, finest), dev, args.reps)
        out["rice_cost_tables_plain"] = time_stage(
            lambda: rice_tables.rice_cost_tables_plain(fx_err, warm, finest), dev, args.reps)
        ops = op_rows(dev, B, T, args.reps)
        ops["FULL encode step (decisions)"] = dict(
            out["forward"], x_realtime=B * T / 44100 / (out["forward"]["device_ms"] / 1e3))
        host = host_rows(enc, blocks, cfg, args.reps)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# one forward, batch {B}, 2 channels (4 candidates), T={T}, default config, "
          f"median of {args.reps}; {name}")
    print(f"{'stage':26s} {'device ms':>12s} {'host ms':>12s}")
    for stage, t in out.items():
        print(f"{stage:26s} {t['device_ms']:12.4f} {t['host_ms']:12.4f}")
    print(f"# device ops (batch={B}, 4 candidate channels, T={T})")
    print(f"{'op':34s} {'device ms':>12s} {'host ms':>12s} {'us/frame':>10s}")
    for op, t in ops.items():
        print(f"{op:34s} {t['device_ms']:12.4f} {t['host_ms']:12.4f} "
              f"{t['device_ms'] / B * 1e3:10.2f}")
    for row, t in host.items():
        print(f"# {row}: " + ", ".join(f"{k} {v:.2f}" for k, v in t.items()))
    print(json.dumps({"device": name, "batch": B, "block": T, "stages": out, "ops": ops,
                      "host": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
