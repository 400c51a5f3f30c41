"""Command line of the port: ``python -m flacenc_tpu_torch.cli encode|encode-corpus|decode``.

The same arguments, output and exit codes as the JAX package's command
line (``flacenc_tpu/cli.py``), which mirrors the reference CLI
(``flacenc-rs/flacenc-bin/src/main.rs``): `encode` is the default
subcommand; TOML config load (`--config`) and dump (`--dump-config`);
`decode` parses, optionally dumps the component tree (`--dump-struct`,
msgpack like the reference; a `.json` name switches to JSON), writes a WAV
and verifies the stream MD5.

`encode` and `encode-corpus` run on "cuda"; `--cpu-only` is the explicit
request for "cpu"; `--oracle` runs the numpy reference encoder. There is no
device probe and no fallback: without a card, a "cuda" run fails and the
command exits non-zero (70, EX_SOFTWARE). `--profile-trace DIR` writes a
`torch.profiler` Chrome trace to ``DIR/trace.json``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

from . import config as config_mod
from . import display
from .component import decode_stream, parse_stream
from .device import resolve_device
from .errors import FlacencError
from .source import samples_to_le_bytes
from .wav import WavFileSource, write_wav

# sysexits-style codes (main.rs:157-170)
EX_USAGE = 64
EX_DATAERR = 65
EX_NOINPUT = 66
EX_SOFTWARE = 70
EX_CANTCREAT = 73
EX_IOERR = 74


def _positive_int(text: str) -> int:
    v = int(text)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1 (got {v})")
    return v


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="flacenc", description="FLAC encoder on PyTorch and CUDA")
    sub = p.add_subparsers(dest="command")

    enc = sub.add_parser("encode", help="encode WAV to FLAC (default)")
    enc.add_argument("source", help="input WAV file")
    enc.add_argument("-o", "--output", required=True, help="output FLAC file")
    enc.add_argument("-c", "--config", help="TOML encoder config")
    enc.add_argument("--dump-config", help="write the effective config TOML here")
    enc.add_argument("--block-size", type=int, default=None)
    enc.add_argument(
        "--batch-size", type=_positive_int, default=None,
        help="blocks per device batch (default 64; output bytes never change)",
    )
    enc.add_argument(
        "--cpu-only", action="store_true",
        help="run the batched pipeline on the CPU (byte-identical to the card)",
    )
    enc.add_argument(
        "--oracle", action="store_true",
        help="use the scalar numpy reference encoder (the parity oracle)",
    )
    enc.add_argument(
        "--strict-float", action="store_true",
        help="exact stable-reference float semantics for QLPC estimation "
             "(byte-identical streams to flacenc-rs stable builds)",
    )
    enc.add_argument(
        "--profile-trace", default=None, metavar="DIR",
        help="write a torch.profiler Chrome trace of the encode to DIR/trace.json",
    )

    corp = sub.add_parser(
        "encode-corpus",
        help="encode many WAVs, batching blocks across files on the device",
    )
    corp.add_argument("sources", nargs="+", help="input WAV files")
    corp.add_argument("-d", "--output-dir", required=True)
    corp.add_argument("-c", "--config", help="TOML encoder config")
    corp.add_argument("--block-size", type=int, default=None)
    corp.add_argument(
        "--batch-size", type=_positive_int, default=None,
        help="blocks per device batch (see encode)",
    )
    corp.add_argument(
        "--strict-float", action="store_true",
        help="exact stable-reference float semantics (see encode)",
    )
    corp.add_argument(
        "--cpu-only", action="store_true",
        help="run the batched pipeline on the CPU (see encode)",
    )

    dec = sub.add_parser("decode", help="decode FLAC to WAV (experimental)")
    dec.add_argument("source", help="input FLAC file")
    dec.add_argument("-o", "--output", required=True, help="output WAV file")
    dec.add_argument(
        "--dump-struct",
        help="dump the parsed component tree (msgpack; .json for JSON)",
    )
    dec.add_argument("--no-verify", action="store_true", help="skip CRC/MD5 checks")
    return p


def _stream_struct(stream) -> dict:
    info = stream.stream_info()
    return {
        "stream_info": {
            "min_block_size": info.min_block_size,
            "max_block_size": info.max_block_size,
            "min_frame_size": info.min_frame_size,
            "max_frame_size": info.max_frame_size,
            "sample_rate": info.sample_rate,
            "channels": info.channels,
            "bits_per_sample": info.bits_per_sample,
            "total_samples": info.total_samples,
            "md5": info.md5.hex(),
        },
        "frames": [
            {
                "frame_number": f.header().frame_number,
                "block_size": f.block_size(),
                "channel_assignment": repr(f.header().channel_assignment),
                "subframes": [type(s).__name__ for s in f.subframes()],
            }
            for f in stream.frames()
        ],
    }


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
    from .models import reference_encoder
    from .models.batch_encoder import encode_with_fixed_block_size, resolve_strict

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
            return reference_encoder.encode_with_fixed_block_size(
                verified, src, cfg.block_size, strict_lpc=resolve_strict(strict, cfg)
            )
        kwargs = {"batch_size": args.batch_size} if args.batch_size else {}
        return encode_with_fixed_block_size(
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


def main_dec(args) -> int:
    with open(args.source, "rb") as f:
        data = f.read()
    try:
        stream = parse_stream(data, verify_crc=not args.no_verify)
    except FlacencError as e:
        # parse failures are EX_NOINPUT like the reference
        # (main.rs:283-293), not EX_DATAERR
        display.error(f"failed to parse the source FLAC file: {e}")
        return EX_NOINPUT
    if args.dump_struct:
        tree = _stream_struct(stream)
        if args.dump_struct.endswith(".json"):
            with open(args.dump_struct, "w") as f:
                json.dump(tree, f, indent=1)
        else:
            # rmp-serde msgpack analogue (flacenc-bin/src/main.rs:301-316)
            from .utils import msgpack

            with open(args.dump_struct, "wb") as f:
                f.write(msgpack.packb(tree))
    decoded = decode_stream(stream)
    info = stream.stream_info()
    md5_ok = True
    if not args.no_verify:
        md5 = hashlib.md5(
            samples_to_le_bytes(decoded, -(-info.bits_per_sample // 8))
        ).digest()
        md5_ok = info.md5 == bytes(16) or md5 == info.md5
    write_wav(
        args.output, decoded, info.channels, info.bits_per_sample, info.sample_rate
    )
    display.progress_decoded(
        args.source, args.output, len(decoded) // max(info.channels, 1), md5_ok
    )
    # MD5 mismatch exits EX_CANTCREAT like the reference (main.rs:352-356)
    return 0 if md5_ok else EX_CANTCREAT


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # default subcommand is `encode` (main.rs:404-418)
    if argv and argv[0] not in ("encode", "encode-corpus", "decode", "-h", "--help"):
        argv.insert(0, "encode")
    args = _build_parser().parse_args(argv)
    display.banner()
    if args.command is None:
        _build_parser().print_help()
        return EX_USAGE
    try:
        if args.command == "encode":
            return main_enc(args)
        if args.command == "encode-corpus":
            return main_corpus(args)
        return main_dec(args)
    except FileNotFoundError as e:
        # input-open failures are EX_NOINPUT, output-create failures
        # EX_CANTCREAT (flacenc-bin/src/main.rs:226,251,281-309)
        display.error(str(e))
        inputs = set(getattr(args, "sources", None) or [])
        for name in ("source", "config"):
            if getattr(args, name, None):
                inputs.add(getattr(args, name))
        return EX_NOINPUT if e.filename in inputs else EX_CANTCREAT
    except OSError as e:
        display.error(str(e))
        return EX_IOERR
    except FlacencError as e:
        display.error(str(e))
        return EX_DATAERR
    except Exception as e:  # internal errors, a missing card included (main.rs:234)
        display.error(f"internal error: {type(e).__name__}: {e}")
        return EX_SOFTWARE


if __name__ == "__main__":
    sys.exit(main())
