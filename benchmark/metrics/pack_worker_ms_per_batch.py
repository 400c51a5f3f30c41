"""Milliseconds a batch of the io workers' C++ pack, summed over the workers (worker-seconds, not caller wall time): the encoder's `stats["pack_s"]` over its
`stats["batches"]`, summed over the window's calls."""

from ._stats import per_batch_ms


def read(run):
    return per_batch_ms(run, "pack_s")
