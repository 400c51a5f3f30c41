"""The port imports torch and nothing of jax or the JAX package, and resolves
its device explicitly."""

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
from flacenc_tpu_torch.source import MemSource

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
"""

_CLI_PROBE = """
import numpy as np
from flacenc_tpu_torch.wav import write_wav
from flacenc_tpu_torch import cli
x = np.arange(-3000, 3000, dtype=np.int32)
write_wav('in.wav', x, 2, 16, 44100)
assert cli.main(['encode', 'in.wav', '-o', 'o.flac', '--cpu-only']) == 0
assert cli.main(['decode', 'o.flac', '-o', 'back.wav']) == 0
assert cli.main(['encode', 'in.wav', '-o', 'oracle.flac', '--oracle']) == 0
assert open('oracle.flac', 'rb').read() == open('o.flac', 'rb').read()
"""

# printed last by every probe: the modules of JAX or the JAX package loaded
_REPORT = """
import sys
print(sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "flacenc_tpu"
             or m.startswith("flacenc_tpu.")))
"""


def _run_probe(code, cwd):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code + _REPORT], cwd=str(cwd), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_import_and_cpu_encode_leave_jax_out(tmp_path):
    _run_probe(_PROBE, tmp_path)


def test_cli_encode_and_decode_leave_jax_out(tmp_path):
    _run_probe(_CLI_PROBE, tmp_path)


def test_no_jax_import_in_sources():
    """Neither jax nor the JAX package is imported by any source of the
    package, by chip_smoke.py or by the card-only tests."""
    paths = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "test_torch_gpu.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, name) for name in files if name.endswith(".py")]
    assert len(paths) > 30
    forbidden = re.compile(r"^\s*(import jax|from jax|(from|import) flacenc_tpu(\.|\s|$))", re.M)
    for path in paths:
        with open(path) as f:
            assert not forbidden.search(f.read()), path


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

    from flacenc_tpu_torch import config as tconfig
    from flacenc_tpu_torch.parallel import determine_worker_count

    for env in ({}, {"FLACENC_WORKERS": "3"}, {"FLACENC_PACK_THREADS": "5"}):
        for key in ("FLACENC_WORKERS", "FLACENC_PACK_THREADS"):
            monkeypatch.delenv(key, raising=False)
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for kw in (None, {}, {"workers": 2}, {"multithread": False}):
            cfg = None if kw is None else config.Encoder(**kw)
            tcfg = None if kw is None else tconfig.Encoder(**kw)
            assert determine_worker_count(tcfg) == jax_count(cfg) >= 1
