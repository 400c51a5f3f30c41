"""Each cell's run path on the CPU at a reduced scale: it prints a
well-formed last line and comes out correct; without the program beside it
the benchmark fails and prints nothing."""

import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SCALE = "0.02"


def run_cell(workload, trace, extra_code="", cwd=ROOT, seed=12345, path=None):
    code = (extra_code + "\nimport sys\nfrom benchmark.run import main\n"
            f"sys.exit(main(['--workload', {workload!r}, '--seed', '{seed}', '--seconds', "
            f"'2', '--trace', '{trace}', '--device', 'cpu', '--scale', {SCALE!r}]))")
    env = dict(os.environ, PYTHONPATH=path or cwd)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=cwd, timeout=600)


def checkout_with(tmp_path, cell, config, mix=None, config_changes=None):
    """A copy of the benchmark with the cell `cell` of a new configuration
    `config` (the one-card configuration with `config_changes`) and, where
    given, a new mix (the album's with `mix`'s keys) added, as a later PR
    would add them, by data alone; the program is found in the repository.
    Returns run_cell's keywords."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    with open(os.path.join(HERE, "configs", "cd_default_1card.json")) as f:
        cfg = json.load(f)
    cfg.update(name=config, **(config_changes or {}))
    with open(tmp_path / "benchmark" / "configs" / f"{config}.json", "w") as f:
        json.dump(cfg, f)
    traffic = cell.split(".")[1]
    if mix is not None:
        with open(os.path.join(HERE, "traffic", "album.json")) as f:
            album = json.load(f)
        with open(tmp_path / "benchmark" / "traffic" / f"{traffic}.json", "w") as f:
            json.dump(dict(album, **mix), f)
    manifest["configs"].append({"name": config, "source": cfg["source"],
                                "file": f"benchmark/configs/{config}.json",
                                "reduced": [], "why": "a rehearsal"})
    manifest["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                  "chips": cfg["chips"], "why": "a rehearsal"})
    for m in manifest["per_layer"]:
        m["workloads"].append(cell)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(manifest, f)
    return {"cwd": str(tmp_path), "path": os.pathsep.join([str(tmp_path), ROOT])}


def four_device_checkout(tmp_path):
    """A four-card cell of the one-card configuration."""
    return checkout_with(tmp_path, "cd_default_4card.album", "cd_default_4card",
                         config_changes={"chips": 4})


def last_line(proc):
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["cd_default_1card.album", "cd_default_4card.album"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_rehearsal(workload, trace, tmp_path):
    where = four_device_checkout(tmp_path) if "4card" in workload else {}
    with open(os.path.join(where.get("cwd", ROOT), "BENCHMARK.json")) as f:
        manifest = json.load(f)
    line = last_line(run_cell(workload, trace, **where))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if trace else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    due = {m["name"]: m["unit"] for m in manifest[kind]
           if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) <= set(due)
    for name, m in line["metrics"].items():
        assert m["unit"] == due[name] and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(due)
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


# mixes and configurations a later PR could add as data files alone
BY_DATA = {
    # short clips of log-uniform lengths arriving at a fixed rate, two callers
    "cd_clips.clips": ({"items": 24, "length_s": {"kind": "log_uniform", "lo": 2, "hi": 60},
                        "loop": "open", "rate_per_s": 6, "callers": 2}, {}),
    # a library through encode_corpus at two sample rates, three files a call
    "cd_library.library": ({"items": 6, "sample_rates": {"44100": 0.5, "48000": 0.5},
                            "call": "encode_corpus", "corpus_items": 3}, {}),
    # loud noise-like mono material, 24-bit, two closed-loop callers
    "mono24_noisy.noisy": ({"sections": {"noise": 0.7, "percussive": 0.3}, "callers": 2},
                           {"format": {"sample_rate": 96000, "bits_per_sample": 24,
                                       "channels": 1}}),
}


@pytest.mark.parametrize("cell", sorted(BY_DATA))
@pytest.mark.parametrize("trace", [0, 1])
def test_new_cell_by_data_alone(cell, trace, tmp_path):
    mix, changes = BY_DATA[cell]
    where = checkout_with(tmp_path, cell, cell.split(".")[0], mix, changes)
    line = last_line(run_cell(cell, trace, **where))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    if not trace:
        assert set(line["metrics"]) == {"x_realtime", "bits_per_sample", "setup_s"}
    else:
        assert line["metrics"] and line["device"]["window_s"] > 0


def test_fails_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_cell("cd_default_1card.album", 0, cwd=str(tmp_path))
    assert proc.returncode != 0 and not proc.stdout.strip()
