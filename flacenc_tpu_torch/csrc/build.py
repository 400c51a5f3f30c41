"""Builds the port's CUDA kernels with nvcc into a plain-C shared library.

The library (``flacenc_tpu_torch/_build/libflacenc_kernels.so``) is built
from the sources in this directory at first use and rebuilt when a source is
newer than it. It is loaded with ctypes; nothing here includes PyTorch's
headers, so a build takes seconds.

Run directly (``python flacenc_tpu_torch/csrc/build.py [--force]``) or let
``flacenc_tpu_torch.ops.rice_tables`` build on its first CUDA launch. A
failing ``nvcc`` raises.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(HERE, "rice_tables.cu")]
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
LIB = os.path.join(BUILD_DIR, "libflacenc_kernels.so")
# ptxas register / shared-memory report of the last build
PTXAS_LOG = os.path.join(BUILD_DIR, "ptxas.txt")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA toolkit is "
            "needed to build the port's kernels"
        )
    return path


def is_stale() -> bool:
    if not os.path.exists(LIB):
        return True
    built = os.path.getmtime(LIB)
    return any(os.path.getmtime(s) > built for s in SOURCES + [__file__])


def build(force: bool = False) -> str:
    """Path of the kernel library, compiling it first if stale."""
    if not force and not is_stale():
        return LIB
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    with open(PTXAS_LOG, "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, LIB)  # atomic: a concurrent loader never sees half a file
    return LIB


if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
