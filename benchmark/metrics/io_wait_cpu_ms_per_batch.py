"""CPU milliseconds a batch that the io workers burnt waiting for the
downloads (`torch.cuda.Event.synchronize()`, which spins under CUDA's
default scheduling): the thread CPU time of the ``io.wait`` spans over the
calls' batches (a group's batches share one)."""

from .lane_queue_ms_per_batch import span_ms_per_batch


def read(run):
    return span_ms_per_batch(run, "io.wait", lambda s: s["cpu_ns"])
