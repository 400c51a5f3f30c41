"""Milliseconds a batch that the dispatch lane's tasks spent off the CPU:
each ``lane.launch`` span's wall less the lane thread's CPU time over it,
over the calls' batches. The lane then waited for the interpreter lock, a
lock or the CUDA driver; the rest of the span is its own work."""

from .lane_queue_ms_per_batch import span_ms_per_batch, wall_ns


def read(run):
    return span_ms_per_batch(run, "lane.launch", lambda s: wall_ns(s) - s["cpu_ns"])
