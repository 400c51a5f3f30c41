"""Per-stage times of one `BatchEncoder` forward, and the Rice kernel against
its plain version (the port's counterpart of the JAX package's
``tools/microbench.py``).

    python -m flacenc_tpu_torch.tools.microbench [--batch 64] [--block 4096]
        [--reps 20] [--cpu-only]

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
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import config, constants
from ..models import batch_encoder as be
from ..ops import rice as ops_rice
from ..ops import rice_tables


def time_stage(fn, dev: torch.device, reps: int) -> dict:
    """{"device_ms", "host_ms"} of `fn()` (see the module docstring), after
    two warm-up calls."""
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
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()  # a warm-up on the capture stream
    torch.cuda.current_stream(dev).wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    device_ms = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        device_ms.append(start.elapsed_time(end))
    return {"device_ms": statistics.median(device_ms), "host_ms": host}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flacenc_tpu_torch.tools.microbench")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cpu-only", action="store_true", help="run on the CPU, not on cuda")
    args = ap.parse_args(argv)
    from ..device import resolve_device

    dev = resolve_device("cpu" if args.cpu_only else "cuda")
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
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# one forward, batch {B}, 2 channels (4 candidates), T={T}, default config, "
          f"median of {args.reps}; {name}")
    print(f"{'stage':26s} {'device ms':>12s} {'host ms':>12s}")
    for stage, t in out.items():
        print(f"{stage:26s} {t['device_ms']:12.4f} {t['host_ms']:12.4f}")
    print(json.dumps({"device": name, "batch": B, "block": T, "stages": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
