"""Builds the port's native shared libraries with g++.

Two deliberately SEPARATE libraries:
- the packer (``packer.cpp``): the encoder-side bit packer and strict-float
  kernels.
- the decoder (``decoder.cpp``): the clean-room independent decoder
  oracle, which must not link against (or share sources with) the packer
  so encoder bugs cannot cancel out in round-trip tests.

Both go into the gitignored ``flacenc_tpu_torch/_build/``, named after a
hash of the source, the compiler flags and the host CPU (``-march=native``
code must never be loaded on another machine that received a copy of the
tree). A build writes a temporary file and renames it into place under a
file lock, so concurrent processes (test workers) compile once and never
load half a file.

Run directly (``python -m flacenc_tpu_torch.native.build``) or let
``flacenc_tpu_torch.native`` build on first use.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
SRC = os.path.join(HERE, "packer.cpp")
DEC_SRC = os.path.join(HERE, "decoder.cpp")

FLAGS = [
    "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
    "-fno-exceptions", "-fno-rtti", "-pthread",
]


def _host_cpu() -> str:
    """The CPU model and feature flags `-march=native` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            keep = [line.strip() for line in f
                    if line.startswith(("model name", "flags", "Features", "CPU part"))]
        if keep:
            return "\n".join(sorted(set(keep)))
    except OSError:
        pass
    return f"{platform.machine()} {platform.processor()}"


def library_path(src: str, stem: str) -> str:
    """Where the library built from `src` on this host lives."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(_host_cpu().encode())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def _compile(src: str, stem: str, force: bool) -> str:
    lib = library_path(src, stem)
    if not force and os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f".{stem}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if force or not os.path.exists(lib):
            tmp = f"{lib}.{os.getpid()}.tmp"
            subprocess.run(["g++", *FLAGS, src, "-o", tmp], check=True)
            os.replace(tmp, lib)
    return lib


def build(force: bool = False) -> str:
    return _compile(SRC, "flacenc_torch_packer", force)


def build_decoder(force: bool = False) -> str:
    return _compile(DEC_SRC, "flacenc_torch_decoder", force)


if __name__ == "__main__":
    force = "--force" in sys.argv
    print(build(force=force))
    print(build_decoder(force=force))
