"""Milliseconds a batch of the dispatch lane running the program: the
static inputs' copies and `graph.replay()` (the eager forward where there is
no graph), over a mesh every shard's in turn within the one span: the
``lane.launch.replay`` spans over the calls' batches. A first run that
captures records no such span."""

from .lane_queue_ms_per_batch import span_ms_per_batch


def read(run):
    return span_ms_per_batch(run, "lane.launch.replay")
