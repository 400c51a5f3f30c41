"""The control of the check: the plain reference put in the program's
place with its QLPC analysis (autocorrelation and Levinson) in float32,
where the configuration states float64, compared with the float64
reference on the frames a run samples.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3

For each seed it samples frames as `check.check` does over one pass of the
cell's mix, and prints one JSON line with the control's
`frames_differ_pct` and `lossless_faults`: the upper reading that the
limit of `frames_differ_pct` is set below. The benchmark's own runs do not
run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from . import check, traffic
from .reference import encoder as ref_encoder


def _control_task(task) -> tuple:
    enc, fmt, number, block = task
    got = ref_encoder.encode_frame(enc, block, fmt["sample_rate"], fmt["bits_per_sample"],
                                   number, np.float32)
    return check._frame_task((enc, fmt, number, block, got))


def control(workload: str, seed: int, scale: float = 1.0, n_workers=None) -> dict:
    from .run import cell_and_config, load_manifest

    cell, cfg = cell_and_config(load_manifest(), workload)
    fmt, block = cfg["format"], cfg["block_size"]
    sources = traffic.generate(traffic.load_mix(cell["traffic"]), fmt, seed, scale)
    frames = [-(-s.frames // block) for s in sources]
    picks = set(check.sample_frames(frames, cfg["check"]["frames"], seed))
    picks |= {(k, n - 1) for k, n in enumerate(frames)}
    tasks = [(cfg["encoder"], check._fmt_of(fmt, sources[s]), f,
              sources[s].pcm[f * block:(f + 1) * block])
             for s, f in sorted(picks)]
    results = check.run_frames(tasks, n_workers, _control_task)
    return {"workload": workload, "seed": seed, "frames_checked": len(tasks),
            "frames_differ_pct": 100.0 * sum(not r[0] for r in results) / len(tasks),
            "lossless_faults": sum(not r[1] for r in results)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--scale", type=float, default=1.0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed % (1 << 63), args.scale)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
