"""The control: the reference with its QLPC analysis in float32 fails the
check's limit on frames that differ, on three seeds; and each cell on the
card (marked `gpu`)."""

import json
import os

import pytest

from benchmark import control
from benchmark.test_bench_rehearsal import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


def _cell(workload):
    from benchmark.run import cell_and_config, load_manifest

    return cell_and_config(load_manifest(), workload)


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 987654321])
def test_float32_control_fails(seed):
    out = control.control(CELLS[0], seed, scale=0.01)
    assert out["lossless_faults"] == 0
    assert out["frames_differ_pct"] > _cell(CELLS[0])[1]["check"]["limits"]["frames_differ_pct"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    import subprocess
    import sys

    import torch

    chips = _cell(workload)[0]["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{workload} needs {chips} cards")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload,
                           "--seed", "31337", "--seconds", "5", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])["correct"] is True
