"""flacenc_tpu_torch: the batched FLAC encoder on PyTorch and CUDA.

A port of ``flacenc_tpu`` (JAX) to PyTorch, with the Rice cost-table kernel
written by hand in CUDA C++ for Hopper (``csrc/rice_tables.cu``). The host
side that never needed JAX is shared with ``flacenc_tpu``, not copied:
configs, sources, the FLAC component model, signal generators, the C++
packer and decoders, and the numpy reference encoder. This package imports
``torch`` and never ``jax``.

Entries:

- `encode_with_fixed_block_size(config, src, block_size, batch_size=64,
  device="cuda", stats=None, strict_lpc=None)` encodes one source;
- `encode_corpus(sources, config, block_size, batch_size=64,
  device="cuda", strict_lpc=None)` encodes many through shared batches
  and returns ({name: Stream}, PipelineStats);
- ``python -m flacenc_tpu_torch.cli`` is the command line.

The device is explicit: "cuda" raises when no card is visible, and "cpu"
runs only when asked for. `strict_lpc=True` (or, when it is None, the
environment's ``FLACENC_STRICT_LPC=1``) computes the LPC parameters on the
host with the reference stable build's float semantics, so the streams
are byte-identical to it; it raises with `use_direct_mse` when explicit
and falls back to the default mode when it came from the environment.
"""

from flacenc_tpu import component, config, constants, errors, sigen, source
from flacenc_tpu.errors import EncodeError, SourceError, Verified, VerifyError, into_verified

from flacenc_tpu.models.reference_encoder import encode_fixed_size_frame

from .models.batch_encoder import BatchEncoder, encode_with_fixed_block_size
from .parallel import encode_corpus

__version__ = constants.build_info.CRATE_VERSION


__all__ = [
    "BatchEncoder",
    "component",
    "config",
    "constants",
    "errors",
    "sigen",
    "source",
    "encode_corpus",
    "encode_with_fixed_block_size",
    "encode_fixed_size_frame",
    "EncodeError",
    "SourceError",
    "Verified",
    "VerifyError",
    "into_verified",
    "__version__",
]
