"""Milliseconds a batch of the dispatch lane's issue (strict arrays,
pinned upload, program call or shard launches, download enqueue): the
lane's busy spans in each call's ``FLACENC_TIMELINE=1`` timeline, by the
frozen `overlap.analyze`, over the calls' batches."""

from ..overlap import analyze


def read(run):
    done = [c for c in run.calls if not c["error"] and c["stats"].get("timeline")]
    batches = sum(c["stats"].get("batches") or 0 for c in done)
    if not batches:
        return None
    busy = sum(analyze(c["stats"]["timeline"], c["t1"] - c["t0"])["issue_s"] for c in done)
    return 1e3 * busy / batches
