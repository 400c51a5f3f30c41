"""Milliseconds a batch of the dispatch lane handing the downloads' wait
and the pack to an io worker (the `issued` mark and the thread pool's
submit, which wakes a worker): the ``lane.launch.handoff`` spans over the
calls' batches (a group's batches share one)."""

from .lane_queue_ms_per_batch import span_ms_per_batch


def read(run):
    return span_ms_per_batch(run, "lane.launch.handoff")
