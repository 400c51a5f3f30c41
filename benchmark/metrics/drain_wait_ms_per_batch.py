"""Milliseconds a batch of the caller blocked on a batch's issue, downloads and pack (run by the dispatch lane and an io worker): the encoder's `stats["device_wait_s"]` over its
`stats["batches"]`, summed over the window's calls."""

from ._stats import per_batch_ms


def read(run):
    return per_batch_ms(run, "device_wait_s")
