"""Milliseconds a batch of the caller choosing and packing its upload wire
(`BatchRunner._upload`, and `_fallback_wire` when the chosen wire is still
warming): the ``submit.upload`` spans over the calls' batches."""

from .lane_queue_ms_per_batch import span_ms_per_batch


def read(run):
    return span_ms_per_batch(run, "submit.upload")
