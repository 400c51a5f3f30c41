"""Milliseconds a batch of the caller's read + MD5 (the source's reads and the MD5 queue): the encoder's `stats["read_s"]` over its
`stats["batches"]`, summed over the window's calls."""

from ._stats import per_batch_ms


def read(run):
    return per_batch_ms(run, "read_s")
