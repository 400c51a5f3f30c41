"""Host parallelism of the port (counterpart of ``flacenc_tpu.parallel``).

`determine_worker_count` is the host pack-thread count: ``flacenc_tpu.
parallel`` imports its JAX mesh module on import, so the port keeps its own
copy of this one function and always hands the native packer an explicit
thread count (the packer resolves a count < 1 through that package).
`encode_corpus` (``pipeline.py``) encodes many sources through shared
device batches.
"""

from __future__ import annotations

import os

from flacenc_tpu import constants


def determine_worker_count(cfg=None) -> int:
    """Pack threads with the reference's precedence (par.rs:328-339):
    ``config.workers`` -> env ``FLACENC_WORKERS`` -> ``FLACENC_PACK_THREADS``
    -> available cores; ``multithread=False`` forces 1."""
    if cfg is not None:
        if not getattr(cfg, "multithread", True):
            return 1
        workers = getattr(cfg, "workers", None)
        if workers:
            return max(1, int(workers))
    for key in (constants.ENV_DEFAULT_PARALLELISM, "FLACENC_PACK_THREADS"):
        try:
            n = int(os.environ.get(key, ""))
        except ValueError:
            continue
        if n >= 1:
            return n
    return os.cpu_count() or 1


# after determine_worker_count: pipeline imports the batch encoder, which
# imports this package for it
from .pipeline import PipelineStats, encode_corpus  # noqa: E402

__all__ = ["PipelineStats", "determine_worker_count", "encode_corpus"]
