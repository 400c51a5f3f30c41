"""The reader of the dispatch lane's staging counter
(``staging_reuse_pct``): the share of kept slots over a hand-made run's
finished calls, None where no call counted any, and its manifest entry."""

import json
import os

import pytest

from .metrics import staging_reuse_pct
from .test_bench_spans import ROOT, Run

LAYER = "Dispatch lane (BatchRunner._launch, parallel/mesh.ShardedEncoder.launch)"


def call(reused, allocated, error=None):
    return {"error": error, "stats": {"batches": 5, "staging_reused": reused,
                                      "staging_allocated": allocated, "staging_waited": 0}}


def test_share_of_kept_slots_over_the_finished_calls():
    run = Run([call(30, 10), call(60, 0), call(0, 500, error="Boom: x")])
    assert staging_reuse_pct.read(run) == pytest.approx(100.0 * 90 / 100, rel=1e-12)


@pytest.mark.parametrize("calls", [
    [], [call(0, 0)], [{"error": None, "stats": {"batches": 3}}], [call(5, 5, error="Boom: x")],
], ids=["no_calls", "zero_counts", "no_counts", "only_failed"])
def test_none_without_counts(calls):
    assert staging_reuse_pct.read(Run(calls)) is None


def test_manifest_entry():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    (m,) = [m for m in manifest["per_layer"] if m["name"].startswith("staging_reuse_pct")]
    assert m == {"name": "staging_reuse_pct.album", "unit": "%", "better": "higher",
                 "source": "program_counter", "layer": LAYER, "moves": "x_realtime",
                 "workloads": ["cd_default_1card.album"]}
