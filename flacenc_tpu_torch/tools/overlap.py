"""Per-batch stage overlap of the streamed encode (the JAX package's
``tools/overlap.py``).

Runs one warm-up encode, then timed encodes with FLACENC_TIMELINE=1, and
reconstructs from each run's event stamps where the wall went:

- the caller's thread, partitioned: read (read_start -> read_done), submit
  CPU (submit -> packed: pad, range check and the upload wire's pack; the
  upload, the program call and the download enqueue run after `packed` on
  the runner's dispatch lane, which stamps `issued` as the JAX package's
  io thread does, so the span closes at `packed`), drain-blocked
  (drain_start -> drain_done: waiting for the lane's issue and an io
  worker's result) and the rest ("other": frame bookkeeping, the tail and
  loop glue; under FLACENC_INLINE_DISPATCH also the upload, launch and
  download enqueue, which then run on this thread);
- the spans of the other threads, which overlap the above: the issue
  (`issue_s`, the lane's busy seconds: a batch's runs from `packed`, or
  from the end of the lane's previous task, to `issued`, a group's from
  `gtrip_start` to `gissued`; under the kill switch the same spans on the
  caller's thread, inside "other"), per-batch fetch walls (fetch_start ->
  fetch_done: the wait for the downloads) and grouped round trips
  (gtrip_start -> gasm_done);
- from the encode's spans (``stats["spans"]``, `lane_seconds`): the lane's
  measured seconds, `lane_s` (its ``lane.launch`` spans, stamped by the
  lane as each task starts and ends), and `lane_queue_s` (its
  ``lane.queue`` spans: tasks handed to the lane and not yet started).
  Trust `lane_s` for the lane's work: `issue_s` is rebuilt from marks the
  lane does not stamp at a task's start, so it also takes in the lane's
  pickup delay, and `issue_s - lane_s` is at most about `lane_queue_s`.

Prints one JSON line per trial and one with the best trial, and with
``--out`` a markdown table:

    python -m flacenc_tpu_torch.tools.overlap [--seconds 600] [--batch 256]
        [--trials 3] [--gap 20] [--out overlap.md] [--cpu-only]

FLACENC_FETCH_GROUP and the other pipeline variables act as they do in
any encode.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def analyze(timeline, wall_s):
    """Classify the wall from the event stamps (see module docstring)."""
    ev = sorted(timeline, key=lambda e: e[2])
    spans = {"read": [], "submit": [], "drain": []}
    open_t = {}
    for e in ev:
        name, idx, t = e[0], e[1], e[2]
        if name == "read_start":
            open_t["read"] = t
        elif name == "read_done" and "read" in open_t:
            spans["read"].append((open_t.pop("read"), t))
        elif name == "submit":
            open_t[("submit", idx)] = t
        elif name == "packed" and ("submit", idx) in open_t:
            # close at the `packed` mark: the upload and launch follow it on
            # the dispatch lane, which stamps `issued` (on the caller's
            # thread only under FLACENC_INLINE_DISPATCH, then in "other"),
            # and `issued` would also take in the lane's queue
            spans["submit"].append((open_t.pop(("submit", idx)), t))
        elif name == "drain_start":
            open_t["drain"] = t
        elif name == "drain_done" and "drain" in open_t:
            spans["drain"].append((open_t.pop("drain"), t))
    # drain spans can nest INSIDE submit spans (submit() calls drain_one
    # at depth): subtract overlap so the classes partition the wall
    def total(key):
        return sum(b - a for a, b in spans[key])

    drain_in_submit = 0.0
    for a, b in spans["drain"]:
        for c, d in spans["submit"]:
            lo, hi = max(a, c), min(b, d)
            if hi > lo:
                drain_in_submit += hi - lo
    sub = {
        "read_s": round(total("read"), 3),
        "submit_cpu_s": round(total("submit") - drain_in_submit, 3),
        "drain_blocked_s": round(total("drain"), 3),
    }
    sub["other_s"] = round(
        wall_s - sub["read_s"] - sub["submit_cpu_s"]
        - sub["drain_blocked_s"], 3
    )
    # io-thread stage walls (overlap the above; reported for attribution)
    fetch = {}
    io = {"fetch_walls": [], "gtrip_walls": []}
    for e in ev:
        name, idx, t = e[0], e[1], e[2]
        if name == "fetch_start":
            fetch[idx] = t
        elif name == "fetch_done" and idx in fetch:
            io["fetch_walls"].append(t - fetch.pop(idx))
        elif name == "gtrip_start":
            # idx is a per-group id: concurrent group round trips must not
            # clobber each other's start stamps under one shared key
            fetch[("g", idx)] = t
        elif name == "gasm_done" and ("g", idx) in fetch:
            io["gtrip_walls"].append(t - fetch.pop(("g", idx)))
    sub["fetch_wall_mean_s"] = round(
        float(np.mean(io["fetch_walls"])), 4) if io["fetch_walls"] else None
    sub["gtrip_wall_mean_s"] = round(
        float(np.mean(io["gtrip_walls"])), 4) if io["gtrip_walls"] else None
    sub["n_fetches"] = len(io["fetch_walls"])
    sub["n_group_trips"] = len(io["gtrip_walls"])
    sub.update(_issue_spans(ev))
    return sub


def _issue_spans(ev) -> dict:
    """The issue's busy seconds from the time-ordered events (see the
    module docstring): the lane runs one task at a time in submit order, so
    a launch starts at its batch's `packed` mark or at the end of the
    lane's previous task, whichever is later; the launches of a partial
    group lie inside its round trip, so the spans are merged before they
    are summed."""
    packed, group, spans = {}, {}, []
    cursor = None  # where the lane's current task began, or its previous one ended
    for e in ev:
        name, idx, t = e[0], e[1], e[2]
        if name == "packed":
            packed[idx] = t
        elif name == "gtrip_start":
            group[idx] = cursor = t
        elif name == "issued" and idx in packed:
            start = packed.pop(idx)
            spans.append((start if cursor is None else max(start, cursor), t))
            cursor = t
        elif name == "gissued" and idx in group:
            spans.append((group.pop(idx), t))
            cursor = t
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is not None:
            a = max(a, end)
        busy += max(0.0, b - a)
        end = b if end is None else max(end, b)
    return {"issue_s": round(busy, 3), "n_issues": len(spans)}


def lane_seconds(spans) -> dict:
    """`lane_s` and `lane_queue_s` from an encode's spans (see the module
    docstring)."""
    def total(name):
        return round(sum(s["end_ns"] - s["start_ns"] for s in spans if s["name"] == name) / 1e9,
                     3)

    return {"lane_s": total("lane.launch"), "lane_queue_s": total("lane.queue")}


def _markdown(args, results) -> str:
    lines = [
        "# Pipeline stage overlap (flacenc_tpu_torch.tools.overlap)",
        "",
        f"Audio: {args.seconds:.0f} s {args.bps}/{args.rate / 1000:g} stereo, batch "
        f"{args.batch}, fetch group {os.environ.get('FLACENC_FETCH_GROUP')}, device "
        f"{results[0]['device']}, batches split over {results[0]['mesh']} device(s) "
        f"({'; '.join(results[0]['mesh_cards'])}). The wall is partitioned into the "
        "caller's thread's classes; the issue (the dispatch lane's busy seconds, rebuilt "
        "from the marks), the lane's own spans (lane: its tasks; lane queue: their waits "
        "to start) and the io-worker walls overlap them and are listed for attribution.",
        "",
        "| trial | wall s | x-rt | read | submit cpu | drain blocked | other | issue "
        "| lane | lane queue | fetch mean | gtrip mean | link MB/s |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for i, r in enumerate(results):
        lines.append(
            f"| {i} | {r['wall_s']} | {r['x_realtime']} | {r['read_s']} | "
            f"{r['submit_cpu_s']} | {r['drain_blocked_s']} | {r['other_s']} | "
            f"{r['issue_s']} | {r.get('lane_s')} | {r.get('lane_queue_s')} | "
            f"{r['fetch_wall_mean_s']} | {r['gtrip_wall_mean_s']} | {r['link_mbps']} |"
        )
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flacenc_tpu_torch.tools.overlap")
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--warm-seconds", type=float, default=60.0)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--gap", type=float, default=20.0)
    ap.add_argument("--rate", type=int, default=44100)
    ap.add_argument("--bps", type=int, default=16)
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu-only", action="store_true", help="run on the CPU, not on cuda")
    args = ap.parse_args(argv)

    import torch

    from .. import config
    from ..device import resolve_device
    from ..models import batch_encoder as be
    from ..source import MemSource
    from . import mesh_cards, stereo_audio

    device = resolve_device("cpu" if args.cpu_only else "cuda")
    name = "cpu" if args.cpu_only else torch.cuda.get_device_name(device)
    split = mesh_cards(device, args.batch)  # the devices the batches split over
    cfg = config.Encoder().into_verified()
    rate, bps, block = args.rate, args.bps, 4096

    def encode(audio, stats=None):
        return be.encode_with_fixed_block_size(
            cfg, MemSource(audio, 2, bps, rate), block, batch_size=args.batch,
            device=device, stats=stats,
        )

    previous = os.environ.get("FLACENC_TIMELINE")
    os.environ["FLACENC_TIMELINE"] = "1"  # read when each encode's runner is made
    try:
        encode(stereo_audio(args.warm_seconds, rate, bps))
        be.wait_all_warms()
        audio = stereo_audio(args.seconds, rate, bps)
        n_samples = len(audio) // 2
        results = []
        for i in range(args.trials):
            if i:
                time.sleep(args.gap)
            stats = {}
            t0 = time.perf_counter()
            encode(audio, stats)
            wall = time.perf_counter() - t0
            sub = analyze(stats.get("timeline", []), wall)
            if "spans" in stats:
                sub.update(lane_seconds(stats["spans"]))
            wires = stats.get("wire_batches") or {}
            sub.update(
                wall_s=round(wall, 3),
                x_realtime=round((n_samples / rate) / wall, 1),
                link_mbps=stats.get("link_mbps"),
                grouped_batches=stats.get("grouped_batches"),
                device_wait_s=round(stats.get("device_wait_s", 0.0), 3),
                pack_s=round(stats.get("pack_s", 0.0), 3),
                wire=(max(wires, key=wires.get) if wires else None),
                max_inflight=stats.get("max_inflight"),
                device=name,
                mesh=split["mesh"],
                mesh_devices=split["devices"],
                mesh_cards=split["cards"],
            )
            results.append(sub)
            print(json.dumps({"trial": i, **sub}), flush=True)
    finally:
        if previous is None:
            del os.environ["FLACENC_TIMELINE"]
        else:
            os.environ["FLACENC_TIMELINE"] = previous

    best = max(results, key=lambda r: r["x_realtime"])
    print(json.dumps({"best": best}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(_markdown(args, results))
        print(f"# wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
