"""Command line of the port: ``python -m flacenc_tpu_torch.cli encode|encode-corpus|decode``.

The same arguments, output and exit codes as ``python -m flacenc_tpu.cli``,
whose parser and decoder it reuses (that module imports JAX only inside
its own encode paths, which this one replaces). `encode` and
`encode-corpus` run on "cuda"; `--cpu-only` is the explicit request for
"cpu"; `--oracle` runs the shared numpy encoder. There is no device probe
and no fallback: without a card, a "cuda" run fails and the command exits
non-zero (70, EX_SOFTWARE). `--profile-trace DIR` writes a
`torch.profiler` Chrome trace to ``DIR/trace.json``.
"""

from __future__ import annotations

import os
import sys
import time

from flacenc_tpu import cli as base_cli
from flacenc_tpu import config as config_mod
from flacenc_tpu import display
from flacenc_tpu.errors import FlacencError
from flacenc_tpu.wav import WavFileSource

from .device import resolve_device


def _build_parser():
    """The JAX CLI's parser, with the help texts that name its backend
    rewritten for this one."""
    parser = base_cli._build_parser()
    parser.description = "FLAC encoder on PyTorch and CUDA"
    encode = parser._subparsers._group_actions[0].choices["encode"]
    for opt in encode._actions:
        if opt.dest == "profile_trace":
            opt.help = "write a torch.profiler Chrome trace of the encode to DIR/trace.json"
    return parser


def _config(args) -> config_mod.Encoder:
    cfg = config_mod.Encoder()
    if args.config:
        with open(args.config) as f:
            cfg = config_mod.Encoder.from_toml(f.read())
    if args.block_size is not None:
        cfg.block_size = args.block_size
    return cfg


def _profiled(trace_dir, device, fn):
    """fn() under a torch.profiler trace written to trace_dir, or plain."""
    if not trace_dir:
        return fn()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = fn()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    return out


def main_enc(args) -> int:
    import flacenc_tpu

    import flacenc_tpu_torch

    cfg = _config(args)
    verified = cfg.into_verified()
    src = WavFileSource(args.source)
    channels, bits, rate = src.channels(), src.bits_per_sample(), src.sample_rate()
    strict = True if args.strict_float else None
    if args.batch_size and args.oracle:
        print(
            "note: --batch-size has no effect with --oracle "
            "(the scalar reference encoder has no device batches)",
            file=sys.stderr,
        )
    device = None if args.oracle else resolve_device("cpu" if args.cpu_only else "cuda")
    t0 = time.perf_counter()

    def run():
        if device is None:
            return flacenc_tpu.encode_with_fixed_block_size(
                verified, src, cfg.block_size, use_tpu=False, strict_lpc=strict
            )
        kwargs = {"batch_size": args.batch_size} if args.batch_size else {}
        return flacenc_tpu_torch.encode_with_fixed_block_size(
            verified, src, cfg.block_size, device=device, strict_lpc=strict, **kwargs
        )

    stream = _profiled(args.profile_trace, device, run)
    data = stream.to_bytes()
    elapsed = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    if args.dump_config:
        with open(args.dump_config, "w") as f:
            f.write(cfg.to_toml())
    n = stream.stream_info().total_samples
    in_bytes = n * channels * (-(-bits // 8))
    display.progress_encoded(args.source, args.output, in_bytes, len(data), n / rate, elapsed)
    return 0


def main_corpus(args) -> int:
    from .parallel import encode_corpus

    cfg = _config(args)
    verified = cfg.into_verified()
    sources = [(path, WavFileSource(path)) for path in args.sources]
    os.makedirs(args.output_dir, exist_ok=True)
    device = resolve_device("cpu" if args.cpu_only else "cuda")
    t0 = time.perf_counter()
    kwargs = {"batch_size": args.batch_size} if args.batch_size else {}
    streams, stats = encode_corpus(
        sources, verified, cfg.block_size, device=device,
        strict_lpc=True if args.strict_float else None, **kwargs,
    )
    wall = time.perf_counter() - t0
    total_in = total_out = 0
    audio_s = 0.0
    for path, _ in sources:
        data = streams[path].to_bytes()
        name = os.path.splitext(os.path.basename(path))[0] + ".flac"
        with open(os.path.join(args.output_dir, name), "wb") as f:
            f.write(data)
        info = streams[path].stream_info()
        total_out += len(data)
        total_in += info.total_samples * info.channels * (-(-info.bits_per_sample // 8))
        audio_s += info.total_samples / info.sample_rate
    display.progress_encoded(
        f"{stats.files} files ({stats.frames} frames, {stats.batches} batches)",
        args.output_dir, total_in, total_out, audio_s, wall,
    )
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # default subcommand is `encode` (main.rs:404-418)
    if argv and argv[0] not in ("encode", "encode-corpus", "decode", "-h", "--help"):
        argv.insert(0, "encode")
    args = _build_parser().parse_args(argv)
    display.banner()
    if args.command is None:
        _build_parser().print_help()
        return base_cli.EX_USAGE
    try:
        if args.command == "encode":
            return main_enc(args)
        if args.command == "encode-corpus":
            return main_corpus(args)
        return base_cli.main_dec(args)
    except FileNotFoundError as e:
        # input-open failures are EX_NOINPUT, output-create failures
        # EX_CANTCREAT (flacenc-bin/src/main.rs:226,251,281-309)
        display.error(str(e))
        inputs = set(getattr(args, "sources", None) or [])
        for name in ("source", "config"):
            if getattr(args, name, None):
                inputs.add(getattr(args, name))
        return base_cli.EX_NOINPUT if e.filename in inputs else base_cli.EX_CANTCREAT
    except OSError as e:
        display.error(str(e))
        return base_cli.EX_IOERR
    except FlacencError as e:
        display.error(str(e))
        return base_cli.EX_DATAERR
    except Exception as e:  # internal errors, a missing card included (main.rs:234)
        display.error(f"internal error: {type(e).__name__}: {e}")
        return base_cli.EX_SOFTWARE


if __name__ == "__main__":
    sys.exit(main())
