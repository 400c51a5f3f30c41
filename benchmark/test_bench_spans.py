"""The readers of the program's spans (``stats["spans"]`` of a traced
call): each reads its value from a hand-made run of two calls, None where
its span is absent, and the CPU rehearsal of the traced cell reports every
one that needs no card."""

import importlib
import json
import os

import pytest

from .test_bench_rehearsal import last_line, run_cell

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELL = "cd_default_1card.album"


def span(name, start_ms, wall_ms, cpu_ms=None, seq=0):
    ns = 1_000_000
    return {"id": 0, "parent": None, "name": name, "call": 1, "seq": seq, "thread": "t",
            "start_ns": int(start_ms * ns), "end_ns": int((start_ms + wall_ms) * ns),
            "cpu_ns": None if cpu_ms is None else int(cpu_ms * ns)}


class Run:
    def __init__(self, calls):
        self.calls = calls


def call(batches, spans, error=None):
    return {"error": error, "stats": {"batches": batches, "spans": spans}}


# two calls of 3 and 1 batches (and one that failed, which no reader counts)
RUN = Run([
    call(3, [span("lane.queue", 0, 1.0), span("lane.queue", 5, 3.0),
             span("lane.launch", 1, 10.0, cpu_ms=4.0), span("lane.launch", 11, 6.0, cpu_ms=5.0),
             span("lane.launch.lock_wait", 1, 0.5), span("lane.launch.pin", 2, 2.0),
             span("lane.launch.replay", 4, 3.0),
             span("lane.launch.download", 7, 4.0), span("lane.launch.handoff", 11, 0.25),
             span("io.wait", 12, 8.0, cpu_ms=7.5),
             span("call.setup", 0, 2.0), span("call.close", 30, 1.0),
             span("call.tail", 31, 4.0), span("call.assemble", 35, 1.5)]),
    call(1, [span("lane.queue", 0, 4.0), span("lane.launch", 1, 8.0, cpu_ms=2.0),
             span("lane.launch.lock_wait", 1, 1.5), span("lane.launch.pin", 2, 2.0),
             span("lane.launch.replay", 4, 1.0), span("lane.launch.download", 7, 0.0),
             span("lane.launch.handoff", 7, 0.75),
             span("io.wait", 9, 2.0, cpu_ms=0.5), span("call.setup", 0, 1.0),
             span("call.close", 9, 0.5), span("call.assemble", 10, 1.0)]),
    call(2, [span("lane.queue", 0, 100.0), span("call.setup", 0, 100.0)], error="Boom: x"),
])

# metric -> its value on RUN: per batch over 4 batches, or per call over 2 calls
WANT = {
    "lane_queue_ms_per_batch": (1 + 3 + 4) / 4,
    "lane_lock_wait_ms_per_batch": (0.5 + 1.5) / 4,
    "lane_pin_ms_per_batch": (2 + 2) / 4,
    "lane_replay_ms_per_batch": (3 + 1) / 4,
    "lane_download_ms_per_batch": (4 + 0) / 4,
    "lane_offcpu_ms_per_batch": ((10 - 4) + (6 - 5) + (8 - 2)) / 4,
    "io_wait_cpu_ms_per_batch": (7.5 + 0.5) / 4,
    "call_edges_ms_per_call": (2 + 1 + 4 + 1.5 + 1 + 0.5 + 1) / 2,
    "lane_handoff_ms_per_batch": (0.25 + 0.75) / 4,
}
# the spans each reader reads
READS = {
    "lane_queue_ms_per_batch": {"lane.queue"},
    "lane_lock_wait_ms_per_batch": {"lane.launch.lock_wait"},
    "lane_pin_ms_per_batch": {"lane.launch.pin"},
    "lane_replay_ms_per_batch": {"lane.launch.replay"},
    "lane_download_ms_per_batch": {"lane.launch.download"},
    "lane_offcpu_ms_per_batch": {"lane.launch"},
    "io_wait_cpu_ms_per_batch": {"io.wait"},
    "call_edges_ms_per_call": {"call.setup", "call.close", "call.tail", "call.assemble"},
    "lane_handoff_ms_per_batch": {"lane.launch.handoff"},
}


def reader(name):
    return importlib.import_module(f"benchmark.metrics.{name}").read


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_value_on_two_calls(name):
    assert reader(name)(RUN) == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_none_without_its_spans(name):
    without = Run([call(c["stats"]["batches"],
                        [s for s in c["stats"]["spans"] if s["name"] not in READS[name]],
                        c["error"]) for c in RUN.calls])
    assert reader(name)(without) is None
    untraced = Run([{"error": None, "stats": {"batches": 3}}])
    assert reader(name)(untraced) is None
    assert reader(name)(Run([])) is None


def test_manifest_lists_each_reader_for_the_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    entries = {m["name"].split(".")[0]: m for m in manifest["per_layer"]}
    for name in WANT:
        m = entries[name]
        assert m["name"] == f"{name}.album" and m["workloads"] == [CELL]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms", "lower", "program_span", "x_realtime")


def test_cpu_rehearsal_reports_the_span_metrics():
    line = last_line(run_cell(CELL, 1))
    assert line["correct"] is True
    card_only = {"lane_pin_ms_per_batch", "io_wait_cpu_ms_per_batch"}
    for name in set(WANT) - card_only:
        value = line["metrics"][f"{name}.album"]["value"]
        assert value >= 0, (name, value)
    assert line["metrics"]["lane_replay_ms_per_batch.album"]["value"] > 0
    assert line["metrics"]["call_edges_ms_per_call.album"]["value"] > 0
