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

_PATHS_PROBE = """
import numpy as np
import flacenc_tpu_torch
from flacenc_tpu_torch import config, fuzz, sigen
from flacenc_tpu_torch.component.serde import stream_from_dict, stream_to_dict
from flacenc_tpu_torch.component.verify import verify_stream
from flacenc_tpu_torch.parallel import mesh
from flacenc_tpu_torch.source import MemSource

n = 5000
x = np.zeros(2 * n, np.int32)
x[0::2] = sigen.Sine(128, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
x[1::2] = sigen.Sine(130, 0.4).noise_with_seed(2, 0.01).to_vec_quantized(16, n)
out = set()
for packer, m in (("native", None), ("python", None), ("native2", mesh.block_mesh(["cpu"] * 2))):
    s = flacenc_tpu_torch.encode_with_fixed_block_size(
        config.Encoder(), MemSource(x, 2, 16, 44100), 1024, batch_size=4, device="cpu",
        packer=packer, mesh=m,
    )
    verify_stream(s)
    out.add(s.to_bytes())
    if packer == "python":  # component frames: the dict holds every field
        assert stream_from_dict(stream_to_dict(s)).to_bytes() == s.to_bytes()
assert len(out) == 1
assert fuzz.one_device_case(3, device="cpu") is None
mesh.dryrun_multichip(2, device="cpu")
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

_WIRES_PROBE = """
import os
import numpy as np
import flacenc_tpu_torch
from flacenc_tpu_torch import config, sigen
from flacenc_tpu_torch.models import batch_encoder as be
from flacenc_tpu_torch.ops import upack
from flacenc_tpu_torch.source import MemSource

n = 5000
x = np.zeros(2 * n, np.int32)
x[0::2] = sigen.Sine(128, 0.4).noise_with_seed(1, 0.01).to_vec_quantized(16, n)
x[1::2] = sigen.Sine(130, 0.4).noise_with_seed(2, 0.01).to_vec_quantized(16, n)
out = set()
for up, group, strict in ((False, "1", False), (True, "1", False), ("delta", "1", False),
                          ("auto", "2", False), (True, "1", True), (False, "1", True)):
    os.environ["FLACENC_FETCH_GROUP"] = group
    s = flacenc_tpu_torch.encode_with_fixed_block_size(
        config.Encoder(), MemSource(x, 2, 16, 44100), 1024, batch_size=2, device="cpu",
        upload_pack=up, strict_lpc=strict)
    out.add((strict, s.to_bytes()))
assert len(out) == 2
be.wait_all_warms()
assert upack.try_pack(x[: 4 * 2048].reshape(4, 1024, 2).transpose(0, 2, 1).copy()) is not None
"""

_TOOLS_PROBE = """
import numpy as np
import torch
from flacenc_tpu_torch import constants, fuzz
from flacenc_tpu_torch.examples import corpus_encode, encode_library
from flacenc_tpu_torch.tools import overlap, reporter
from flacenc_tpu_torch.wav import write_wav

constants.par.FRAMEBUF_MULTIPLICITY = 3
for tier in ("plain", "mutate", "upload", "cli"):
    assert fuzz.run(range(2), tier=tier, device="cpu", max_block=256)["cases"] == 2
assert overlap.main(["--cpu-only", "--seconds", "1", "--warm-seconds", "0.5", "--batch", "2",
                     "--trials", "1", "--gap", "0"]) == 0
rows = reporter.measure(reporter.make_corpus(0.2), torch.device("cpu"))
assert len(rows) == 4
encode_library.main(device="cpu")
write_wav("a.wav", np.arange(-5000, 5000, dtype=np.int32), 2, 16, 44100)
assert corpus_encode.main(["a.wav"], "out", device="cpu").max_inflight_batches == 1
"""

_MEASURE_PROBE = """
import os
import torch
os.environ.update(BENCH_SECONDS="1", BENCH_WARM_SECONDS="0.5", BENCH_TRIALS="1",
                  BENCH_BATCH="4", BENCH_TRIAL_GAP_S="0", FLACENC_PACK_THREADS="1")
torch.set_num_threads(1)  # it runs beside other test workers
from flacenc_tpu_torch.tools import bench, hwconfigs, microbench
assert bench.main(["--cpu-only"]) == 0
assert hwconfigs.main(["--cpu-only", "--seconds", "0.5", "--out", "m.md",
                       "--skip", "fixed-only,default,hi-res,experimental,corpus"]) == 0
assert microbench.main(["--cpu-only", "--batch", "2", "--block", "256", "--reps", "1"]) == 0
microbench.SWEEP_BLOCKS, microbench.SWEEP_BATCHES = (256,), (2,)
assert microbench.main(["--cpu-only", "--kernel-sweep", "--reps", "1"]) == 0
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


def test_packers_mesh_fuzz_and_verify_leave_jax_out(tmp_path):
    _run_probe(_PATHS_PROBE, tmp_path)


def test_upload_wires_groups_and_registry_leave_jax_out(tmp_path):
    _run_probe(_WIRES_PROBE, tmp_path)


def test_cli_encode_and_decode_leave_jax_out(tmp_path):
    _run_probe(_CLI_PROBE, tmp_path)


def test_fuzz_tiers_tools_and_examples_leave_jax_out(tmp_path):
    _run_probe(_TOOLS_PROBE, tmp_path)


def test_measurement_tools_leave_jax_out(tmp_path):
    _run_probe(_MEASURE_PROBE, tmp_path)


def test_no_jax_import_in_sources():
    """Neither jax nor the JAX package is imported by any source of the
    package, by chip_smoke.py or by the card-only tests."""
    paths = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "tests", "test_torch_gpu.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, name) for name in files if name.endswith(".py")]
    assert len(paths) > 30
    for new in (("ops", "upack.py"), ("fuzz.py",), ("tools", "overlap.py"),
                ("tools", "reporter.py"), ("examples", "encode_library.py"),
                ("examples", "corpus_encode.py"), ("tools", "bench.py"),
                ("tools", "hwconfigs.py"), ("tools", "microbench.py")):
        assert os.path.join(PKG, *new) in paths
    forbidden = re.compile(r"^\s*(import jax|from jax|(from|import) flacenc_tpu(\.|\s|$))", re.M)
    for path in paths:
        with open(path) as f:
            assert not forbidden.search(f.read()), path
    # the multi-process test's rank program, which runs alone in its process
    from test_torch_dcn import CHILD

    assert "flacenc_tpu_torch" in CHILD and not forbidden.search(CHILD)


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
