"""A `torch.profiler` trace of one full encode (the JAX package's
``tools/profile.py``, itself the reference CLI's pprof wrap).

    python -m flacenc_tpu_torch.tools.profile [--seconds 10] [--packer auto]
        [--trace-dir flacenc_trace] [--cpu-only]

A warm-up encode of 6 s runs outside the trace (kernel build, CUDA
context, native library). The trace is written as Chrome-trace JSON
(``trace.json``, open with Perfetto) and the ops with the most device time
(host time with ``--cpu-only``) are printed with the encode's stats.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .. import config
from ..models import batch_encoder as be
from ..source import MemSource
from . import make_audio


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flacenc_tpu_torch.tools.profile")
    ap.add_argument("--trace-dir", default="flacenc_trace")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--packer", default="auto", choices=be.PACKERS)
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--cpu-only", action="store_true", help="run on the CPU, not on cuda")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu_only else "cuda"
    cfg = config.Encoder().into_verified()

    def encode(seconds, stats=None):
        return be.encode_with_fixed_block_size(
            cfg, MemSource(make_audio(seconds), 2, 16, 44100), args.block_size,
            device=device, packer=args.packer, stats=stats,
        )

    encode(6.0)  # warm-up outside the trace
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    stats = {}
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        encode(args.seconds, stats)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    os.makedirs(args.trace_dir, exist_ok=True)
    path = os.path.join(args.trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    sort = "self_device_time_total" if device == "cuda" else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=sort, row_limit=15))
    print(json.dumps({"audio_s": args.seconds, "wall_s": wall, "packer": args.packer,
                      "device": device, "stats": stats}))
    print(f"trace written to {path} (open with Perfetto)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
