"""The hi-res cell, ``hires_24_96_1card.album``: its run path on the CPU at
a reduced scale, traced and untraced, comes out correct with the cell's
metrics; the program's frames at 24-bit / 96 kHz against the plain
reference (strict mode byte-equal, the default mode lossless); and the
readers of the upload counters and the ``submit.upload`` span."""

import json
import os

import numpy as np
import pytest

from benchmark import check, programs, traffic
from benchmark.metrics import submit_upload_ms_per_batch, upload_bytes_per_sample
from benchmark.reference import encoder, flac

from .test_bench_rehearsal import ROOT, last_line, run_cell
from .test_bench_spans import Run, span

CELL = "hires_24_96_1card.album"
FMT = {"sample_rate": 96000, "bits_per_sample": 24, "channels": 2}
BLOCK = 4096


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cfg():
    with open(os.path.join(ROOT, "benchmark", "configs", "hires_24_96_1card.json")) as f:
        return json.load(f)


def test_configuration_is_the_cd_encoder_at_24_96(cfg):
    with open(os.path.join(ROOT, "benchmark", "configs", "cd_default_1card.json")) as f:
        cd = json.load(f)
    assert cfg["encoder"] == cd["encoder"] and cfg["entry"] == cd["entry"]
    assert cfg["format"] == FMT and cfg["block_size"] == BLOCK
    assert cfg["reduced"] == [] and cfg["chips"] == 1


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(trace, manifest):
    line = last_line(run_cell(CELL, trace))
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    kind = "per_layer" if trace else "end_to_end"
    due = {m["name"]: m["unit"] for m in manifest[kind] if CELL in m.get("workloads", [CELL])}
    for name, m in line["metrics"].items():
        assert m["unit"] == due[name] and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(due) == {"x_realtime", "bits_per_sample", "setup_s"}
        return
    assert all(name.endswith(".hires") for name in due)
    # on the CPU the runner uploads raw int32 and no card is traced
    assert line["metrics"]["upload_bytes_per_sample.hires"]["value"] == 4.0
    assert line["metrics"]["submit_upload_ms_per_batch.hires"]["value"] > 0
    assert line["metrics"]["read_ms_per_batch.hires"]["value"] > 0


@pytest.fixture(scope="module")
def sources():
    """Every program alone at 24/96, four blocks and a ragged tail, and one
    source of the album mix."""
    rng = np.random.default_rng(24)
    out = [traffic.Source(k, programs.quantize(f(rng, 4 * BLOCK + 999, 96000), 24), 96000)
           for k, f in programs.PROGRAMS.items()]
    return out + [traffic.generate(traffic.load_mix("album"), FMT, 5, scale=0.0005)[0]]


def _program_stream(cfg, src, strict):
    from flacenc_tpu_torch import config as pconfig
    from flacenc_tpu_torch.models import batch_encoder as be
    from flacenc_tpu_torch.source import MemSource

    enc = pconfig.Encoder.from_dict(cfg["encoder"]).into_verified()
    return be.encode_with_fixed_block_size(
        enc, MemSource(src.pcm.reshape(-1), 2, 24, 96000), BLOCK, batch_size=8,
        device="cpu", strict_lpc=strict).to_bytes()


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "default"])
def test_program_frames_against_the_reference(cfg, sources, strict):
    for src in sources:
        data = _program_stream(cfg, src, strict)
        fault, index = check._stream_fault(data, src.pcm, FMT, BLOCK)
        assert fault is None, (src.name, fault)
        assert flac.read_streaminfo(data).md5 == check.pcm_md5(src.pcm, 24)
        for i, (a, b, _) in enumerate(index):
            block = src.pcm[i * BLOCK:(i + 1) * BLOCK]
            if strict:
                assert encoder.encode_frame(cfg["encoder"], block, 96000, 24, i) == data[a:b], (
                    src.name, i)
            assert np.array_equal(flac.decode_frame(data[a:b], 96000, 24, 2), block), (
                src.name, i)


def _call(batches, nbytes=None, samples=None, spans=(), error=None):
    stats = {"batches": batches, "spans": list(spans)}
    if nbytes is not None:
        stats.update(upload_bytes=nbytes, upload_samples=samples)
    return {"error": error, "stats": stats}


def test_upload_bytes_per_sample_over_the_finished_calls():
    run = Run([_call(2, 4 * 1000, 1000), _call(1, 500, 500),
               _call(3, 10**9, 10, error="Boom: x")])
    assert upload_bytes_per_sample.read(run) == pytest.approx(4500 / 1500, rel=1e-12)


@pytest.mark.parametrize("calls", [
    [], [_call(2)], [_call(2, 0, 0)], [_call(2, 800, 200, error="Boom: x")],
], ids=["no_calls", "no_counters", "zero_counts", "only_failed"])
def test_upload_bytes_per_sample_none_without_counts(calls):
    assert upload_bytes_per_sample.read(Run(calls)) is None


def test_submit_upload_span_reader():
    run = Run([_call(3, spans=[span("submit.upload", 0, 1.0, seq=0),
                               span("submit.upload", 2, 2.5, seq=1),
                               span("submit.upload", 5, 0.5, seq=2),
                               span("lane.queue", 0, 9.0)]),
               _call(1, spans=[span("submit.upload", 0, 4.0)]),
               _call(2, spans=[span("submit.upload", 0, 100.0)], error="Boom: x")])
    assert submit_upload_ms_per_batch.read(run) == pytest.approx(8.0 / 4, rel=1e-12)
    assert submit_upload_ms_per_batch.read(Run([_call(2, spans=[span("lane.queue", 0, 1)])])) \
        is None
    assert submit_upload_ms_per_batch.read(Run([{"error": None, "stats": {"batches": 2}}])) \
        is None


def test_manifest_entries(manifest):
    (c,) = [c for c in manifest["configs"] if c["name"] == "hires_24_96_1card"]
    assert c["file"] == "benchmark/configs/hires_24_96_1card.json" and c["reduced"] == []
    (cd,) = [c for c in manifest["configs"] if c["name"] == "cd_default_1card"]
    assert c["source"] != cd["source"]  # another deployment, not the CD one under a new name
    (w,) = [w for w in manifest["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("hires_24_96_1card", "album", 1)
    hires = [m for m in manifest["per_layer"] if m["name"].endswith(".hires")]
    assert all(m["workloads"] == [CELL] and m["moves"] == "x_realtime" for m in hires)
    by = {m["name"]: m for m in hires}
    assert (by["upload_bytes_per_sample.hires"]["source"],
            by["upload_bytes_per_sample.hires"]["unit"]) == ("program_counter", "bytes/sample")
    assert (by["submit_upload_ms_per_batch.hires"]["source"],
            by["submit_upload_ms_per_batch.hires"]["unit"]) == ("program_span", "ms")
    album = {m["name"].split(".")[0]: m for m in manifest["per_layer"]
             if m["name"].endswith(".album")}
    for name, m in by.items():
        base = name.split(".")[0]
        if base in album:  # an accepted reader under the cell's name: same entry otherwise
            assert {k: v for k, v in m.items() if k not in ("name", "workloads")} == {
                k: v for k, v in album[base].items() if k not in ("name", "workloads")}
