"""BENCHMARK.json against the benchmark's contract, and every name in it
against a file of its own."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51 and isinstance(manifest["run_seconds"], int)
    assert len(manifest["command"]) <= 32
    for word in manifest["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_texts(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            extra = {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source"} | extra
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            names.append(m["name"])
    assert len(names) == len(set(names))


def test_end_to_end_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_moves_names_a_metric_of_every_cell_it_is_read_in(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in manifest["end_to_end"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_cells_chips_and_reports(manifest):
    cells = manifest["workloads"]
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    for w in cells:
        e2e = [m for m in manifest["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        per = [m for m in manifest["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per


def test_every_name_has_its_file(manifest):
    bench = os.path.join(ROOT, "benchmark")
    files = set()
    for c in manifest["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("benchmark/") and os.path.isfile(path)
        assert path not in files
        files.add(path)
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["check"]["limits"]) == {"failed_calls", "stream_faults",
                                                "lossless_faults", "frames_differ_pct"}
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}
    for w in manifest["workloads"]:
        assert os.path.isfile(os.path.join(bench, "traffic", w["traffic"] + ".json"))
        with open(os.path.join(ROOT, next(c["file"] for c in manifest["configs"]
                                          if c["name"] == w["config"]))) as f:
            assert json.load(f)["chips"] == w["chips"]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert os.path.isfile(os.path.join(bench, "metrics", m["name"].split(".")[0] + ".py"))
