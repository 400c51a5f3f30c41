"""The port imports torch and never jax, and resolves its device explicitly."""

import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "flacenc_tpu_torch")

_PROBE = """
import sys
import numpy as np
import flacenc_tpu_torch
from flacenc_tpu_torch import config, sigen
from flacenc_tpu.source import MemSource

n = 3000
x = np.zeros(2 * n, np.int32)
x[0::2] = sigen.Sine(128, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
x[1::2] = sigen.Sine(130, 0.4).noise_with_seed(2, 0.01).to_vec_quantized(16, n)
s = flacenc_tpu_torch.encode_with_fixed_block_size(
    config.Encoder().into_verified(), MemSource(x, 2, 16, 44100), 1024, device="cpu"
)
assert s.frame_count() == 3
import flacenc_tpu_torch.cli
import flacenc_tpu_torch.parallel
streams, _ = flacenc_tpu_torch.encode_corpus(
    [("a", MemSource(x, 2, 16, 44100))], config.Encoder(), 1024, device="cpu",
    strict_lpc=True,
)
assert streams["a"].frame_count() == 3
print("JAX_LOADED" if "jax" in sys.modules else "JAX_ABSENT")
"""


def test_import_and_cpu_encode_leave_jax_out():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "JAX_ABSENT"


def test_cli_encode_and_decode_leave_jax_out(tmp_path):
    probe = (
        "import sys, numpy as np\n"
        "from flacenc_tpu.wav import write_wav\n"
        "from flacenc_tpu_torch import cli\n"
        "x = np.arange(-3000, 3000, dtype=np.int32)\n"
        "write_wav('in.wav', x, 2, 16, 44100)\n"
        "assert cli.main(['encode', 'in.wav', '-o', 'o.flac', '--cpu-only']) == 0\n"
        "assert cli.main(['decode', 'o.flac', '-o', 'back.wav']) == 0\n"
        "print('JAX_LOADED' if 'jax' in sys.modules else 'JAX_ABSENT')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "JAX_ABSENT"


def test_no_jax_import_in_sources():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    assert not pattern.search(f.read()), name
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert not pattern.search(src)
    assert "flacenc_tpu.models.batch_encoder" not in src


def test_resolve_device():
    from flacenc_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device("cuda")
        with pytest.raises(RuntimeError):
            resolve_device()


def test_worker_count_matches_jax_package(monkeypatch):
    from flacenc_tpu import config
    from flacenc_tpu.parallel import determine_worker_count as jax_count

    from flacenc_tpu_torch.parallel import determine_worker_count

    for env in ({}, {"FLACENC_WORKERS": "3"}, {"FLACENC_PACK_THREADS": "5"}):
        for key in ("FLACENC_WORKERS", "FLACENC_PACK_THREADS"):
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for cfg in (None, config.Encoder(), config.Encoder(workers=2),
                    config.Encoder(multithread=False)):
            assert determine_worker_count(cfg) == jax_count(cfg) >= 1
