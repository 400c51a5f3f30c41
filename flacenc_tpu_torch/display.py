"""Terminal display for the CLI (the ``flacenc-bin/src/display.rs``
analogue): banner with build info, colored progress lines with compression
ratio and inverse RTF, error formatting. Colors auto-disable when stderr is
not a TTY or NO_COLOR is set."""

from __future__ import annotations

import os
import sys

from . import constants


def _use_color() -> bool:
    return sys.stderr.isatty() and not os.environ.get("NO_COLOR")


def _c(code: str, text: str) -> str:
    if not _use_color():
        return text
    return f"\x1b[{code}m{text}\x1b[0m"


def banner() -> None:
    bi = constants.build_info
    print(
        _c("1;36", f"flacenc-tpu {bi.CRATE_VERSION}")
        + f" ({bi.BUILD_PROFILE}; {bi.FEATURES})",
        file=sys.stderr,
    )


def progress_encoded(
    source: str, dest: str, in_bytes: int, out_bytes: int, audio_seconds: float,
    wall_seconds: float,
) -> None:
    ratio = out_bytes / in_bytes if in_bytes else 0.0
    irtf = audio_seconds / wall_seconds if wall_seconds > 0 else float("inf")
    print(
        _c("32", "encoded ")
        + f"{source} -> {dest}: {out_bytes} bytes "
        + _c("1", f"({ratio:.4f})")
        + f" of input, "
        + _c("1", f"{irtf:.1f}x")
        + " realtime",
        file=sys.stderr,
    )


def progress_decoded(source: str, dest: str, total_samples: int, md5_ok: bool) -> None:
    status = _c("32", "MD5 ok") if md5_ok else _c("31", "MD5 MISMATCH")
    print(
        _c("32", "decoded ") + f"{source} -> {dest}: {total_samples} samples, {status}",
        file=sys.stderr,
    )


def error(msg: str) -> None:
    print(_c("1;31", "error: ") + msg, file=sys.stderr)
