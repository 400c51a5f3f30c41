"""The port's tracer (``flacenc_tpu_torch.trace``, switched on by
FLACENC_TIMELINE=1), on the CPU: a short encode gives every batch its lane
and io spans and the call its caller spans, children inside their parents,
thread CPU time only on ``lane.launch`` and ``io.wait``; a mesh gives one
replay span per batch; a grouped round trip's batches share one wait; the
kill switch issues on the caller's thread with no queue span; switched off,
nothing is recorded; the stage marks keep their names and order; the spans
line up with `torch.profiler`'s clock; ``tools.overlap`` reports the lane's
measured seconds."""

import collections
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flacenc_tpu_torch import config as tconfig  # noqa: E402
from flacenc_tpu_torch import sigen, trace  # noqa: E402
from flacenc_tpu_torch.models import batch_encoder as tbe  # noqa: E402
from flacenc_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from flacenc_tpu_torch.source import MemSource  # noqa: E402
from flacenc_tpu_torch.tools import overlap  # noqa: E402

T = 512
N = T * 23 + 77  # 12 batches of 2 at block 512, the last one padded, and a tail
# on the CPU: no pinned staging, so no ``lane.launch.pin``
LANE_CHILDREN = {"lane.launch.lock_wait", "lane.launch.replay", "lane.launch.download",
                 "lane.launch.handoff"}
CPU_TIMED = {"lane.launch", "io.wait"}


def _cpu_step_ns() -> int:
    """The step of this thread's CPU clock: some kernels advance it a
    scheduler tick at a time, and a span's CPU time may then exceed its
    wall by up to one step."""
    t0 = time.thread_time_ns()
    while (t1 := time.thread_time_ns()) == t0:
        pass
    return t1 - t0


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # a fetch-wait seed left by an earlier test could switch to grouped round trips
    monkeypatch.setattr(tbe, "_LAST_FETCH_EWMA", None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("FLACENC_PACK_THREADS", "1")
    monkeypatch.setenv("FLACENC_TIMELINE", "1")
    for var in ("FLACENC_INLINE_DISPATCH", "FLACENC_FETCH_GROUP", "FLACENC_PACKED_UPLOAD"):
        monkeypatch.delenv(var, raising=False)
    yield
    torch.set_num_threads(threads)


def _tones(n: int, seed: int = 1) -> np.ndarray:
    x = np.zeros(2 * n, np.int32)
    for ch in range(2):
        x[ch::2] = sigen.Sine(90 + 7 * seed + ch, 0.4).noise_with_seed(seed + ch, 0.02) \
            .to_vec_quantized(16, n)
    return x


def _encode(n=N, batch_size=2, **kw) -> dict:
    stats = {}
    tbe.encode_with_fixed_block_size(tconfig.Encoder(), MemSource(_tones(n), 2, 16, 44100), T,
                                     batch_size=batch_size, device="cpu", stats=stats, **kw)
    return stats


def _by(spans, name):
    return [s for s in spans if s["name"] == name]


def _check_nesting(spans) -> None:
    """Every span of the call ends after it starts, no thread's CPU time
    exceeds its wall by more than the clocks' grain, and a span whose name
    extends a recorded span's name (``lane.launch.pin`` of ``lane.launch``)
    lies inside a parent of that name with the same call and batch."""
    by_id = {s["id"]: s for s in spans}
    names = {s["name"] for s in spans}
    grain = 2 * _cpu_step_ns() + 2_000_000
    for s in spans:
        assert s["end_ns"] >= s["start_ns"], s
        if s["cpu_ns"] is not None:
            assert 0 <= s["cpu_ns"] <= s["end_ns"] - s["start_ns"] + grain, s
        prefix = s["name"].rsplit(".", 1)[0]
        if prefix in names:
            parent = by_id[s["parent"]]
            assert parent["name"] == prefix, (s, parent)
            assert (parent["call"], parent["seq"]) == (s["call"], s["seq"])
            assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]
            assert parent["thread"] == s["thread"]


@pytest.mark.parametrize("strict", [False, True])
def test_every_batch_has_its_spans(strict):
    stats = _encode(strict_lpc=strict)
    spans = stats["spans"]
    assert stats["batches"] == 12
    assert {s["call"] for s in spans} == {spans[0]["call"]}
    _check_nesting(spans)
    for name in ("call.setup", "call.close", "call.tail", "call.assemble"):
        assert len(_by(spans, name)) == 1, name
        assert _by(spans, name)[0]["thread"] == "MainThread"
    per = collections.defaultdict(collections.Counter)
    for s in spans:
        per[s["seq"]][s["name"]] += 1
    want = {"submit.upload", "lane.queue", "lane.launch", "io.wait"} | LANE_CHILDREN
    for seq in range(12):
        assert set(per[seq]) == want, (seq, per[seq])
        assert all(n == 1 for n in per[seq].values()), (seq, per[seq])
    for s in spans:
        thread = {"lane": "flacenc-lane", "io": "flacenc-io", "call": "MainThread",
                  "submit": "MainThread"}
        assert s["thread"].startswith(thread[s["name"].split(".")[0]]), s
    for s in _by(spans, "lane.launch"):
        children = [c for c in spans if c["parent"] == s["id"]]
        assert {c["name"] for c in children} == LANE_CHILDREN
    assert isinstance(stats["trace_clock"]["perf_to_unix_ns"], int)
    assert set(stats) >= {"spans", "trace_clock", "timeline"}


def test_thread_cpu_time_only_on_the_spans_read_for_it():
    spans = _encode()["spans"]
    for s in spans:
        assert (s["cpu_ns"] is not None) == (s["name"] in CPU_TIMED), s
    assert sum(s["cpu_ns"] for s in _by(spans, "lane.launch")) > 0


def test_mesh_gives_one_replay_span_per_batch():
    """Over a four-device mesh each batch's launch runs every shard inside
    its one ``lane.launch.replay`` span."""
    mesh = pmesh.block_mesh(["cpu"] * 4)
    stats = _encode(n=T * 16, batch_size=4, mesh=mesh)
    spans = stats["spans"]
    _check_nesting(spans)
    replays = _by(spans, "lane.launch.replay")
    assert len(replays) == stats["batches"] == 4
    assert sorted(r["seq"] for r in replays) == [0, 1, 2, 3]
    assert not [s for s in spans if s["parent"] in {r["id"] for r in replays}]


def test_inline_dispatch_launches_on_the_caller(monkeypatch):
    """Under the kill switch nothing is handed to the lane: no
    ``lane.queue``, and each ``lane.launch`` is on the caller's thread."""
    monkeypatch.setenv("FLACENC_INLINE_DISPATCH", "1")
    spans = _encode()["spans"]
    _check_nesting(spans)
    assert not _by(spans, "lane.queue")
    launches = _by(spans, "lane.launch")
    assert sorted(s["seq"] for s in launches) == list(range(12))
    assert {s["thread"] for s in launches} == {"MainThread"}


def test_grouped_batches_share_one_wait(monkeypatch):
    monkeypatch.setenv("FLACENC_FETCH_GROUP", "4")
    _encode(n=T * 16)  # the grouped program warms on the capture thread
    tbe.wait_group_warms()
    stats = _encode(n=T * 16)
    assert stats["grouped_batches"] == stats["batches"] == 8
    spans = stats["spans"]
    _check_nesting(spans)
    waits = _by(spans, "io.wait")
    assert sorted(s["seq"] for s in waits) == [0, 4]
    assert sorted(s["seq"] for s in _by(spans, "lane.launch")) == [0, 4]
    assert sorted(s["seq"] for s in _by(spans, "lane.queue")) == [0, 4]
    assert sorted(s["seq"] for s in _by(spans, "lane.launch.replay")) == [0, 4]
    assert sorted(s["seq"] for s in _by(spans, "lane.launch.handoff")) == [0, 4]


def test_off_records_nothing(monkeypatch):
    monkeypatch.delenv("FLACENC_TIMELINE")

    def recorded(*args, **kwargs):
        raise AssertionError("the tracer recorded while tracing was off")

    for name in ("span", "record", "mark", "_add"):
        monkeypatch.setattr(trace.Tracer, name, recorded)
    made = []
    monkeypatch.setattr(trace.Tracer, "__init__", lambda self, *a, **k: made.append(self))
    stats = _encode()
    assert not made and not getattr(trace._LOCAL, "stack", None)
    assert not {"spans", "trace_clock", "timeline"} & set(stats)


def test_timeline_marks_keep_their_names_and_order():
    """Per batch the marks come in the order the runner's threads stamp
    them (the caller's drain may begin while the lane issues), the caller's
    own in its order, on the `perf_counter` clock."""
    t0 = time.perf_counter()
    stats = _encode()
    t1 = time.perf_counter()
    events = stats["timeline"]
    assert [e[2] for e in events] == sorted(e[2] for e in events)
    assert all(t0 <= e[2] <= t1 for e in events)
    for seq in range(12):
        names = [e[0] for e in events if e[1] == seq and not e[0].startswith("read")]
        assert [n for n in names if n != "drain_start"] == [
            "submit", "packed", "issued", "fetch_start", "fetch_done", "asm_done",
            "drain_done"], (seq, names)
        assert names.index("packed") < names.index("drain_start") < names.index("drain_done")
    caller = [e[0] for e in events if e[0] in ("read_start", "read_done", "submit", "packed")]
    assert caller == ["read_start", "read_done", "submit", "packed"] * 12
    assert all(len(e) == 5 and e[3] == "raw" and e[4] > 0 for e in events if e[0] == "packed")
    assert {e[0] for e in events} == {"read_start", "read_done", "submit", "packed", "issued",
                                      "fetch_start", "fetch_done", "asm_done", "drain_start",
                                      "drain_done"}


def test_grouped_run_stamps_no_parked(monkeypatch):
    monkeypatch.setenv("FLACENC_FETCH_GROUP", "4")
    _encode(n=T * 16)
    tbe.wait_group_warms()
    names = {e[0] for e in _encode(n=T * 16)["timeline"]}
    assert {"gtrip_start", "gissued", "gfetch_done", "gasm_done"} <= names
    assert "parked" not in names


def test_span_lines_up_with_the_profiler_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    tracer = trace.Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("probe"), record_function("flacenc_trace_probe"):
            torch.ones(4096).cumsum(0)
    (span,) = _by(tracer.report()["spans"], "probe")
    event = next(e for e in prof.profiler.kineto_results.events()
                 if e.name() == "flacenc_trace_probe")
    start = span["start_ns"] + tracer.report()["trace_clock"]["perf_to_unix_ns"]
    assert abs(event.start_ns() - start) < 1_000_000, (event.start_ns(), start)


def test_lane_seconds_of_spans():
    spans = [{"name": "lane.launch", "start_ns": 0, "end_ns": 1_500_000},
             {"name": "lane.launch", "start_ns": 2_000_000, "end_ns": 2_500_000},
             {"name": "lane.queue", "start_ns": 0, "end_ns": 300_000},
             {"name": "io.wait", "start_ns": 0, "end_ns": 9_000_000}]
    assert overlap.lane_seconds(spans) == {"lane_s": 0.002, "lane_queue_s": 0.0}
    assert overlap.lane_seconds(spans[:3] * 4) == {"lane_s": 0.008, "lane_queue_s": 0.001}


def test_overlap_tool_reports_lane_seconds(tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("FLACENC_TIMELINE")
    out = tmp_path / "overlap.md"
    assert overlap.main(["--cpu-only", "--seconds", "2", "--warm-seconds", "1", "--batch", "8",
                         "--trials", "1", "--gap", "0", "--out", str(out)]) == 0
    trial = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert trial["lane_s"] > 0 and trial["lane_queue_s"] >= 0 and trial["issue_s"] > 0
    assert "| lane | lane queue |" in out.read_text()
