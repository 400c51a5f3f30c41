"""x-realtime and bits/sample of the five ``BASELINE.json`` configs on one
card, as one table (the port's counterpart of the JAX package's
``tools/hwconfigs.py``).

    python -m flacenc_tpu_torch.tools.hwconfigs [--seconds 120] [--out PATH]
        [--skip NAME,...] [--gap 10] [--cpu-only]

1. fixed-only  - mono sigen sine + noise, 16/44.1, use_lpc = false
2. default     - stereo CD audio, QLPC + the full stereo search (the
                 bench's headline config, repeated for one table)
3. hi-res      - 24-bit / 96 kHz stereo (int32 uploads)
4. experimental- direct-MSE LPC (forwards that sync, never captured)
5. corpus      - 4 track-length files through `parallel.encode_corpus`

Each config gets a warm-up encode, then `timed_encode`'s settle encode and
the best of 3 timed trials, `--gap` seconds apart, at batch 256, block
4096. Prints one JSON line per config and rewrites the markdown table after
each (by default ``flacenc_tpu_torch_hardware_configs.md`` in the temporary
directory). A config that raises keeps its row with the error, as in the
JAX tool; the tool then exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np


def mono_audio(seconds: float, rate: int = 44100) -> np.ndarray:
    """Mono 16-bit sigen material: a 220 Hz sine at 0.4 over noise 0.04,
    seed 3 (the JAX tool's)."""
    from .. import sigen

    n = int(seconds * rate)
    return np.asarray(
        sigen.Sine(220, 0.4).noise_with_seed(3, 0.04).to_vec_quantized(16, n),
        np.int32,
    )


def timed_encode(cfg, audio, ch, bps, rate, block, batch, trials=3, gap_s=10.0,
                 device="cuda"):
    """One settle encode, then the best of `trials` timed encodes `gap_s`
    apart: {x_realtime, bits_per_sample, device_wait_s, host_pack_s, wall_s,
    audio_s, wire (the best trial's most used upload wire), link_mbps}."""
    from ..models import batch_encoder as be
    from ..source import MemSource

    # the settle encode lets the racer probe every wire with its programs
    # already captured, so the timed trials see its settled choice
    be.wait_all_warms(timeout=360)
    be.encode_with_fixed_block_size(
        cfg, MemSource(audio, ch, bps, rate), block, batch_size=batch, device=device
    )
    be.wait_all_warms(timeout=360)

    best, data = None, b""
    stats = {}
    for i in range(trials):
        if i:
            time.sleep(gap_s)
        src = MemSource(audio, ch, bps, rate)
        trial_stats = {}
        t0 = time.perf_counter()
        stream = be.encode_with_fixed_block_size(
            cfg, src, block, batch_size=batch, stats=trial_stats, device=device
        )
        data = stream.to_bytes()
        dt = time.perf_counter() - t0
        if best is None or dt < best:
            best, stats = dt, trial_stats
    n_samples = len(audio) // ch
    wires = stats.get("wire_batches") or {}
    return {
        "x_realtime": round((n_samples / rate) / best, 1),
        "bits_per_sample": round(len(data) * 8 / len(audio), 4),
        "device_wait_s": round(stats.get("device_wait_s", 0.0), 3),
        "host_pack_s": round(stats.get("pack_s", 0.0), 3),
        "wall_s": round(best, 3),
        "audio_s": round(n_samples / rate, 1),
        "wire": (max(wires, key=wires.get) if wires else "?"),
        "link_mbps": stats.get("link_mbps"),
    }


def write_markdown(path: str, backend: str, seconds: float, rows: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# Hardware config matrix (BASELINE.json north-star configs)\n\n")
        f.write(f"{backend} {seconds:.0f}s of audio per config "
                "(best-of-3 trials after warm-up + settle), batch 256, block 4096.\n\n")
        f.write("| config | x realtime | bits/sample | device_wait_s | "
                "host_pack_s | wall_s | audio_s | wire | link MB/s |\n"
                "|---|---|---|---|---|---|---|---|---|\n")
        for name, r in rows.items():
            if "error" in r:
                f.write(f"| {name} | FAILED | | | | | | | |  <!-- {r['error']} -->\n")
                continue
            f.write(
                f"| {name} | {r['x_realtime']} | {r['bits_per_sample']} "
                f"| {r.get('device_wait_s', '')} | {r.get('host_pack_s', '')} "
                f"| {r['wall_s']} | {r['audio_s']} "
                f"| `{r.get('wire', '')}` | {r.get('link_mbps', '')} |\n"
            )
        f.write(
            "\nReference context (different hardware, real-music corpus — NOT directly\n"
            "comparable on compression): flacenc-rs default mt 1309.5x / st 331.5x /\n"
            "experimental 212.3x on a GCE c2-standard-8 (BASELINE.md).\n"
        )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flacenc_tpu_torch.tools.hwconfigs")
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "flacenc_tpu_torch_hardware_configs.md"))
    ap.add_argument("--skip", default="",
                    help="comma-separated configs to skip, each by its name or first word "
                         "(fixed-only, default, hi-res, experimental, corpus)")
    ap.add_argument("--gap", type=float, default=10.0, help="seconds between timed trials")
    ap.add_argument("--cpu-only", action="store_true", help="run on the CPU, not on cuda")
    args = ap.parse_args(argv)

    from .. import config
    from ..device import resolve_device
    from ..models import batch_encoder as be
    from ..parallel import encode_corpus
    from ..source import MemSource
    from . import stereo_audio
    from .reporter import backend_line

    device = resolve_device("cpu" if args.cpu_only else "cuda")
    backend = backend_line(device)
    skip = set(filter(None, args.skip.split(",")))
    rows = {}

    def warm_encode(cfg, audio, ch, bps, rate):
        be.encode_with_fixed_block_size(
            cfg, MemSource(audio, ch, bps, rate), 4096, batch_size=256, device=device
        )

    def timed(cfg, audio, ch, bps, rate):
        return timed_encode(cfg, audio, ch, bps, rate, 4096, 256, gap_s=args.gap,
                            device=device)

    def run(name, fn):
        if name in skip or name.split()[0] in skip:
            return
        t0 = time.perf_counter()
        try:
            rows[name] = fn()
        except Exception as e:  # noqa: BLE001 - the other configs still run
            traceback.print_exc()
            rows[name] = {"x_realtime": 0.0, "bits_per_sample": 0.0,
                          "wall_s": 0.0, "audio_s": 0.0,
                          "error": f"{type(e).__name__}: {e}"[:200]}
        rows[name]["setup_plus_run_s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps({"config": name, **rows[name]}), flush=True)
        write_markdown(args.out, backend, args.seconds, rows)

    def fixed_only():
        c = config.Encoder()
        c.subframe_coding.use_lpc = False
        cfg = c.into_verified()
        warm_encode(cfg, mono_audio(20.0), 1, 16, 44100)
        return timed(cfg, mono_audio(args.seconds), 1, 16, 44100)

    def default_cd():
        cfg = config.Encoder().into_verified()
        warm_encode(cfg, stereo_audio(20.0, 44100, 16), 2, 16, 44100)
        return timed(cfg, stereo_audio(args.seconds, 44100, 16), 2, 16, 44100)

    def hires():
        cfg = config.Encoder().into_verified()
        warm_encode(cfg, stereo_audio(10.0, 96000, 24), 2, 24, 96000)
        return timed(cfg, stereo_audio(args.seconds, 96000, 24), 2, 24, 96000)

    def experimental():
        c = config.Encoder()
        c.subframe_coding.qlpc.use_direct_mse = True
        cfg = c.into_verified()
        warm_encode(cfg, stereo_audio(10.0, 44100, 16), 2, 16, 44100)
        return timed(cfg, stereo_audio(min(args.seconds, 60.0), 44100, 16), 2, 16, 44100)

    def corpus():
        cfg = config.Encoder().into_verified()
        # 4 track-length files (30 s each at --seconds 120): files longer
        # than one batch (23.8 s at 256 x 4096) take the bulk path, their
        # ragged tails the per-row loop
        n_files = 4
        per_file = max(args.seconds / n_files, 4.0)
        base = stereo_audio(per_file * n_files, 44100, 16)
        n_file = (len(base) // n_files) // 2 * 2
        chunks = [base[i * n_file: (i + 1) * n_file] for i in range(n_files)]
        total_samples = sum(len(c) // 2 for c in chunks)
        warm = [(f"w{i}", MemSource(base[: 44100 * 4], 2, 16, 44100)) for i in range(2)]
        encode_corpus(warm, cfg, 4096, batch_size=256, device=device)
        be.wait_all_warms(timeout=360)
        dt, streams, stats = None, {}, None
        for i in range(3):
            if i:
                time.sleep(args.gap)
            sources = [(f"f{j:02d}", MemSource(c, 2, 16, 44100)) for j, c in enumerate(chunks)]
            t0 = time.perf_counter()
            streams_i, stats_i = encode_corpus(sources, cfg, 4096, batch_size=256,
                                               device=device)
            dt_i = time.perf_counter() - t0
            if dt is None or dt_i < dt:
                dt, streams, stats = dt_i, streams_i, stats_i
        total_bytes = sum(len(s.to_bytes()) for s in streams.values())
        wires = stats.wire_batches  # keyed by each wire's repr, as the stream path's
        return {
            "x_realtime": round((total_samples / 44100) / dt, 1),
            "bits_per_sample": round(total_bytes * 8 / (2 * total_samples), 4),
            "files": len(streams),
            "device_wait_s": round(stats.device_wait_s, 3),
            "host_pack_s": round(stats.pack_s, 3),
            "wall_s": round(dt, 3),
            "audio_s": round(total_samples / 44100, 1),
            "wire": (max(wires, key=wires.get) if wires else "?"),
            "link_mbps": round(stats.link_mbps, 1) if stats.link_mbps else None,
        }

    run("fixed-only (mono 16/44.1)", fixed_only)
    run("default (stereo 16/44.1)", default_cd)
    run("hi-res (stereo 24/96)", hires)
    run("experimental (direct-MSE)", experimental)
    run("corpus (4 track-length files, stereo 16/44.1)", corpus)
    print(f"wrote {args.out}")
    return 1 if any("error" in r for r in rows.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
