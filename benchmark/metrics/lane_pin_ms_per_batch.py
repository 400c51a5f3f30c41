"""Milliseconds a batch of the dispatch lane copying the upload's inputs
into pinned host memory (`pin_memory()`, on a card only): the
``lane.launch.pin`` spans over the calls' batches."""

from .lane_queue_ms_per_batch import span_ms_per_batch


def read(run):
    return span_ms_per_batch(run, "lane.launch.pin")
