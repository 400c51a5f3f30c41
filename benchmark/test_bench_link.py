"""The readers of the link gate's counters: `raw_upload_pct` (the share of
batches shipped on raw PCM) and `upload_link_gbps` (the uploads' bytes over
their event-timed seconds), over a hand-made run's finished calls, None
where no call counted any, and their manifest entries in both cells."""

import json
import os

import pytest

from .metrics import raw_upload_pct, upload_link_gbps
from .test_bench_spans import ROOT, Run

SUBMIT = "Submit on the caller (BatchRunner.submit, ops/upack)"
LANE = "Dispatch lane (BatchRunner._launch, parallel/mesh.ShardedEncoder.launch)"


def call(batches, raw=None, nbytes=None, seconds=None, error=None):
    stats = {"batches": batches}
    if raw is not None:
        stats["upload_raw_batches"] = raw
    if nbytes is not None:
        stats.update(link_bytes=nbytes, link_s=seconds)
    return {"error": error, "stats": stats}


def test_raw_share_over_the_finished_calls():
    run = Run([call(10, raw=9), call(30, raw=30), call(50, raw=0, error="Boom: x"),
               call(7)])  # a call without the counter does not count
    assert raw_upload_pct.read(run) == pytest.approx(100.0 * 39 / 40, rel=1e-12)


@pytest.mark.parametrize("calls", [
    [], [call(3)], [call(0, raw=0)], [call(4, raw=4, error="Boom: x")],
], ids=["no_calls", "no_counter", "no_batches", "only_failed"])
def test_raw_share_none_without_counts(calls):
    assert raw_upload_pct.read(Run(calls)) is None


def test_link_rate_over_the_finished_calls():
    run = Run([call(5, nbytes=3_000_000_000, seconds=0.2),
               call(5, nbytes=1_000_000_000, seconds=0.05),
               call(5, nbytes=10**12, seconds=1.0, error="Boom: x")])
    assert upload_link_gbps.read(run) == pytest.approx(4.0 / 0.25, rel=1e-12)


@pytest.mark.parametrize("calls", [
    [], [call(3)], [call(3, nbytes=0, seconds=0.0)],
    [call(3, nbytes=10**9, seconds=0.1, error="Boom: x")],
], ids=["no_calls", "no_counters", "zero_counts", "only_failed"])
def test_link_rate_none_without_counts(calls):
    assert upload_link_gbps.read(Run(calls)) is None


@pytest.mark.parametrize("base,unit,layer", [
    ("raw_upload_pct", "%", SUBMIT), ("upload_link_gbps", "GB/s", LANE),
])
def test_manifest_entries(base, unit, layer):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    got = {m["name"]: m for m in manifest["per_layer"] if m["name"].split(".")[0] == base}
    for suffix, cell in (("album", "cd_default_1card.album"),
                         ("hires", "hires_24_96_1card.album")):
        assert got.pop(f"{base}.{suffix}") == {
            "name": f"{base}.{suffix}", "unit": unit, "better": "higher",
            "source": "program_counter", "layer": layer, "moves": "x_realtime",
            "workloads": [cell]}
    assert not got
