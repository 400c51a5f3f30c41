"""flacenc_tpu_torch: the batched FLAC encoder on PyTorch and CUDA.

A port of ``flacenc_tpu`` (JAX) to PyTorch, with the Rice cost-table kernel
written by hand in CUDA C++ for Hopper (``csrc/rice_tables.cu``). It keeps
its own copies of the host modules it needs, at the JAX package's relative
paths: configs, errors, sources and WAV I/O, the FLAC component model, signal
generators, the C++ packer and decoders (``native/``), and the numpy
reference encoder. This package imports ``torch`` and nothing of ``jax`` or
``flacenc_tpu``.

Entries:

- `encode_with_fixed_block_size(config, src, block_size, batch_size=64,
  device="cuda", stats=None, strict_lpc=None, packer="auto", mesh="auto")`
  encodes one source;
- `encode_corpus(sources, config, block_size, batch_size=64,
  device="cuda", strict_lpc=None, packer="auto", mesh="auto")` encodes
  many through shared batches and returns ({name: Stream}, PipelineStats);
- ``python -m flacenc_tpu_torch.cli`` is the command line,
  ``python -m flacenc_tpu_torch.fuzz --device`` the device fuzz tier, and
  ``flacenc_tpu_torch.tools`` holds the profiler and microbenchmark.

`packer` picks the host assembly ("native2": decisions only, the C++
packer rebuilds the residuals; "native": the card ships int16 residuals
to the C++ packer; "python": `component` objects; "auto": "native2", or
"python" without the native library). `mesh` splits each batch over
replicas of the device program (``parallel.mesh``). Neither changes bytes.

The device is explicit: "cuda" raises when no card is visible, and "cpu"
runs only when asked for. `strict_lpc=True` (or, when it is None, the
environment's ``FLACENC_STRICT_LPC=1``) computes the LPC parameters on the
host with the reference stable build's float semantics, so the streams
are byte-identical to it; it raises with `use_direct_mse` when explicit
and falls back to the default mode when it came from the environment.
"""

from . import bitio, component, config, constants, errors, sigen, source
from .errors import EncodeError, SourceError, Verified, VerifyError, into_verified
from .models.batch_encoder import BatchEncoder, encode_with_fixed_block_size
from .models.reference_encoder import encode_fixed_size_frame
from .parallel import encode_corpus

__version__ = constants.build_info.CRATE_VERSION


__all__ = [
    "BatchEncoder",
    "bitio",
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
