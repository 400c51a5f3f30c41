"""Milliseconds a batch of the dispatch lane taking the programs' locks
(`Program.lock`, then the memory pools' locks, which a capture thread's
check replay also takes): the ``lane.launch.lock_wait`` spans over the
calls' batches."""

from .lane_queue_ms_per_batch import span_ms_per_batch


def read(run):
    return span_ms_per_batch(run, "lane.launch.lock_wait")
