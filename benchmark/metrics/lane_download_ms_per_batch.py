"""Milliseconds a batch of the dispatch lane enqueueing the download: the
pinned host buffers made, the device-to-host copies and the CUDA event
recorded: the ``lane.launch.download`` spans over the calls' batches."""

from .lane_queue_ms_per_batch import span_ms_per_batch


def read(run):
    return span_ms_per_batch(run, "lane.launch.download")
