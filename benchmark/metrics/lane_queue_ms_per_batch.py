"""Milliseconds a batch waited for the dispatch lane: the ``lane.queue``
spans of each call's ``stats["spans"]`` (a task handed to the lane, in
`BatchRunner._issue`, until the lane starts it; a group's batches share one)
over the calls' batches. `span_ms_per_batch` is the rule every reader of the
lane's and the io workers' spans uses."""


def wall_ns(span):
    return span["end_ns"] - span["start_ns"]


def span_ms_per_batch(run, name, part=wall_ns):
    """Milliseconds a batch of `part` (a span's wall, or of its thread CPU)
    of the spans named `name`, summed over the window's finished calls that
    carry spans, over their batches; None where no such span was
    recorded."""
    done = [c for c in run.calls if not c["error"] and c["stats"].get("spans") is not None]
    batches = sum(c["stats"].get("batches") or 0 for c in done)
    parts = [part(s) for c in done for s in c["stats"]["spans"] if s["name"] == name]
    if not batches or not parts:
        return None
    return sum(parts) / 1e6 / batches


def read(run):
    return span_ms_per_batch(run, "lane.queue")
