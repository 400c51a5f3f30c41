"""CPU smoke runs of the port's tools (``flacenc_tpu_torch.tools``)."""

import json

import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu_torch.tools import microbench, profile  # noqa: E402


def test_profile_writes_a_trace(tmp_path, capsys):
    trace_dir = tmp_path / "trace"
    assert profile.main(["--cpu-only", "--seconds", "1", "--packer", "native",
                         "--trace-dir", str(trace_dir)]) == 0
    assert (trace_dir / "trace.json").stat().st_size > 0
    lines = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(lines[-2])
    assert summary["packer"] == "native" and summary["stats"]["frames"] == 11


def test_microbench_times_every_stage(capsys):
    assert microbench.main(["--cpu-only", "--batch", "2", "--block", "256", "--reps", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out["stages"]) == {
        "candidates", "fixed search", "lpc search", "rice search", "forward",
        "rest of forward", "rice_cost_tables", "rice_cost_tables_plain",
    }
    assert all(t["device_ms"] > 0 and t["host_ms"] > 0 for name, t in out["stages"].items()
               if name != "rest of forward")
