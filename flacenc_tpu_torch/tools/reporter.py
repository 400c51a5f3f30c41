"""Benchmark report of the port (the JAX package's ``tools/reporter.py``,
itself the reference's ``pytools/reporter.py``).

Encodes a synthetic corpus of four stereo programs under four configs
(default, the numpy oracle, fixed-only, experimental direct MSE), times
each program (best of two), checks that every output decodes to its input
through the CRC-checking parser, and writes a markdown report of the
average compression rate and the inverse real-time factor, with the
same corpus in strict mode (the reference stable build's bytes) beside
each rate. With ``--resource-dir`` naming the reference's ``src/resource``
it adds its four embedded real recordings.

    python -m flacenc_tpu_torch.tools.reporter [-o REPORT.md] [--seconds 20]
        [--resource-dir DIR] [--cpu-only]

The report goes to ``flacenc_tpu_torch_report.md`` in the temporary
directory unless ``-o`` names another file.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

REAL_SIGNALS = ("sus109", "sus6", "ras22", "ras103")


def make_corpus(seconds: float, rate: int = 44100) -> dict:
    """Four synthetic stereo programs of different spectral character:
    tonal (`tools.make_audio`), percussive noise bursts, quiet ambient and
    near-silence with clicks (seeded)."""
    from . import make_audio

    n = int(seconds * rate)
    rng = np.random.default_rng(7)
    corpus = {"tonal": make_audio(seconds, rate)}
    t = np.arange(n) / rate
    env = np.sin(2 * np.pi * 2.1 * t) ** 8
    noise = rng.standard_normal(n) * env * 0.4
    x = np.clip(np.round(noise * 26000), -32768, 32767).astype(np.int32)
    interleaved = np.empty(2 * n, np.int32)
    interleaved[0::2] = x
    interleaved[1::2] = np.roll(x, 17)
    corpus["percussive"] = interleaved
    amb = (0.05 * np.sin(2 * np.pi * 55 * t) + 0.02 * np.sin(2 * np.pi * 110.3 * t)
           + 0.001 * rng.standard_normal(n))
    x = np.clip(np.round(amb * 32000), -32768, 32767).astype(np.int32)
    interleaved = np.empty(2 * n, np.int32)
    interleaved[0::2] = x
    interleaved[1::2] = x + rng.integers(-2, 3, n)
    corpus["ambient"] = interleaved
    x = np.zeros(n, np.int32)
    idx = rng.integers(0, n, 50)
    x[idx] = rng.integers(-30000, 30000, 50)
    interleaved = np.empty(2 * n, np.int32)
    interleaved[0::2] = x
    interleaved[1::2] = x
    corpus["sparse"] = interleaved
    return corpus


def load_real_corpus(resource_dir) -> dict:
    """The reference's embedded real-audio test signals (16-bit stereo,
    test_helper.rs:81-125) from `resource_dir`; {} when it is not given or
    not a directory."""
    if not resource_dir or not os.path.isdir(resource_dir):
        return {}
    corpus = {}
    for name in REAL_SIGNALS:
        chans = []
        for ch in (0, 1):
            path = os.path.join(resource_dir, f"testsignal.{name}.ch{ch}.bin")
            with open(path, "rb") as f:
                chans.append(np.frombuffer(f.read(), dtype="<i2").astype(np.int32))
        x = np.empty(2 * len(chans[0]), np.int32)
        x[0::2], x[1::2] = chans
        corpus[name] = x
    return corpus


def encoder_configs() -> dict:
    """{row name: (config, use_device)}."""
    from .. import config

    cfgs = {"default": (config.Encoder(), True),
            "st (oracle, scalar)": (config.Encoder(), False)}
    c = config.Encoder()
    c.subframe_coding.use_lpc = False
    cfgs["fixed-only"] = (c, True)
    c = config.Encoder()
    c.subframe_coding.qlpc.use_direct_mse = True
    cfgs["experimental (direct-MSE)"] = (c, True)
    return cfgs


def backend_line(device) -> str:
    """The report's backend: the card's name and power limit, or the CPU."""
    import torch

    from . import card_line

    if device.type != "cuda":
        return "Backend: `cpu`."
    return f"Backend: `cuda`, {card_line(device)} ({torch.cuda.device_count()} device(s))."


def measure(corpus: dict, device, rate: int = 44100) -> list:
    """One row per config of `encoder_configs`: {name, total_in, total_out
    (stream bytes), total_ref_out (strict mode's, 0 for direct MSE),
    audio_s, wall_s (the sum of each program's best of two), rate, irtf,
    ref_rate}. Every stream must decode to its program."""
    import flacenc_tpu_torch
    from ..component import decode_stream, parse_stream
    from ..source import MemSource

    rows = []
    for name, (cfg, use_device) in encoder_configs().items():
        verified = cfg.into_verified()

        def encode(x, **kw):
            return flacenc_tpu_torch.encode_with_fixed_block_size(
                verified, MemSource(x, 2, 16, rate), cfg.block_size, use_device=use_device,
                batch_size=256, device=device, **kw)

        total_in = total_out = total_ref_out = 0
        audio_s = wall_s = 0.0
        encode(next(iter(corpus.values()))[: 44100 * 4])  # warm-up, outside the timing
        for cname, interleaved in corpus.items():
            wall = None
            for _trial in range(2):
                t0 = time.perf_counter()
                data = encode(interleaved).to_bytes()
                t = time.perf_counter() - t0
                wall = t if wall is None else min(wall, t)
            if not np.array_equal(decode_stream(parse_stream(data)), interleaved):
                raise AssertionError(f"{name}/{cname} is not lossless")
            total_in += len(interleaved) * 2
            total_out += len(data)
            audio_s += len(interleaved) / 2 / rate
            wall_s += wall
            if not cfg.subframe_coding.qlpc.use_direct_mse:
                # the same corpus with the reference stable build's float
                # semantics: the bytes that build gives for this config
                total_ref_out += len(encode(interleaved, strict_lpc=True).to_bytes())
        rows.append({
            "name": name, "total_in": total_in, "total_out": total_out,
            "total_ref_out": total_ref_out, "audio_s": audio_s, "wall_s": wall_s,
            "rate": total_out / total_in, "irtf": audio_s / wall_s,
            "ref_rate": total_ref_out / total_in if total_ref_out else None,
        })
        r = rows[-1]
        print(f"{name}: rate={r['rate']:.5f} irtf={r['irtf']:.1f}x"
              + (f" ref_proxy={r['ref_rate']:.5f}" if r["ref_rate"] else ""), flush=True)
    return rows


def measure_real(real: dict, device, rate: int = 44100) -> list:
    """(signal, rate, bits/sample, strict-mode rate) per real recording and
    for all of them together, default config, block 4096."""
    import flacenc_tpu_torch
    from .. import config
    from ..component import decode_stream, parse_stream
    from ..source import MemSource

    verified = config.Encoder().into_verified()
    rows = []
    agg_in = agg_out = agg_ref = 0
    for cname, interleaved in real.items():
        def encode(**kw):
            return flacenc_tpu_torch.encode_with_fixed_block_size(
                verified, MemSource(interleaved, 2, 16, rate), 4096, batch_size=256,
                device=device, **kw).to_bytes()

        data = encode()
        if not np.array_equal(decode_stream(parse_stream(data)), interleaved):
            raise AssertionError(f"real/{cname} is not lossless")
        ref = encode(strict_lpc=True)
        nbytes_in = len(interleaved) * 2
        rows.append((cname, len(data) / nbytes_in, len(data) * 8 / len(interleaved),
                     len(ref) / nbytes_in))
        agg_in += nbytes_in
        agg_out += len(data)
        agg_ref += len(ref)
    if rows:
        rows.append(("ALL", agg_out / agg_in, agg_out * 8 / (agg_in // 2), agg_ref / agg_in))
    return rows


def write_report(path: str, backend: str, seconds: float, n_programs: int, rows,
                 real_rows) -> None:
    """The markdown report: rates, strict-proxy rates, inverse RTF, and the
    real recordings when there are any."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("# flacenc_tpu_torch benchmark report\n\n")
        f.write(f"{backend}\n")
        f.write(f"Corpus: {n_programs} synthetic stereo programs, ")
        f.write(f"{seconds:.0f}s each, 16-bit/44.1kHz. All outputs verified\n")
        f.write("sample-exact through the CRC-checking parser.\n\n")
        f.write(
            "**Caveat — synthetic corpus.** These rates are not comparable\n"
            "to rates measured on real music. The like-for-like parity check\n"
            "is the `ref (strict proxy)` column: the same corpus encoded with\n"
            "strict reference-stable float semantics, i.e. the bytes the\n"
            "reference's stable build would emit for this config.\n\n"
        )
        f.write("## Average compression rate (output/input, lower is better)\n\n")
        f.write("| config | rate | ref (strict proxy) |\n|---|---|---|\n")
        for r in rows:
            ref_s = f"{r['ref_rate']:.5f}" if r["ref_rate"] else "n/a (experimental)"
            f.write(f"| {r['name']} | {r['rate']:.5f} | {ref_s} |\n")
        f.write("\n## Encode speed (inverse RTF, higher is better)\n\n")
        f.write(
            "**Methodology — these are short-clip latency numbers, not\n"
            f"steady-state throughput.** Each corpus program is {seconds:.0f} s — one\n"
            "to a few device batches — so fixed per-stream costs (first-use\n"
            "graph captures, pipeline fill and drain) weigh on the wall and\n"
            "the column reads below the pipeline's steady state on long\n"
            "streams.\n\n"
        )
        f.write("| config | x realtime |\n|---|---|\n")
        for r in rows:
            f.write(f"| {r['name']} | {r['irtf']:.1f} |\n")
        if real_rows:
            f.write(
                "\n## Real audio (reference's embedded test signals)\n\n"
                "The four `testsignal.*` stereo pairs of the reference "
                "repository\n(`src/resource/`, real recordings per "
                "test_helper.rs:81-125). Default config,\nblock 4096; "
                "`ref (strict proxy)` is the same corpus with "
                "reference-stable\nfloat semantics.\n\n"
                "| signal | rate | bits/sample | ref (strict proxy) |\n"
                "|---|---|---|---|\n"
            )
            for cname, rate_, bits, ref_rate in real_rows:
                f.write(f"| {cname} | {rate_:.5f} | {bits:.4f} | {ref_rate:.5f} |\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m flacenc_tpu_torch.tools.reporter")
    ap.add_argument("-o", "--output",
                    default=os.path.join(tempfile.gettempdir(), "flacenc_tpu_torch_report.md"))
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--resource-dir", default=None,
                    help="the reference repository's src/resource (real recordings)")
    ap.add_argument("--cpu-only", action="store_true", help="run on the CPU, not on cuda")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device("cpu" if args.cpu_only else "cuda")
    corpus = make_corpus(args.seconds)
    rows = measure(corpus, device)
    real_rows = measure_real(load_real_corpus(args.resource_dir), device)
    write_report(args.output, backend_line(device), args.seconds, len(corpus), rows, real_rows)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
