"""Milliseconds a batch of the caller's submit (pad, range check, upload-wire pack): the encoder's `stats["submit_s"]` over its
`stats["batches"]`, summed over the window's calls."""

from ._stats import per_batch_ms


def read(run):
    return per_batch_ms(run, "submit_s")
