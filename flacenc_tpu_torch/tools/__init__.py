"""The port's measurement tools (counterparts of the JAX package's ``tools/``).

- ``python -m flacenc_tpu_torch.tools.profile``: a `torch.profiler` trace
  of one full encode;
- ``python -m flacenc_tpu_torch.tools.microbench``: per-stage times of one
  `BatchEncoder` forward and the Rice kernel against its plain version.

Both run on ``cuda`` unless given ``--cpu-only``.
"""

from __future__ import annotations

import numpy as np


def make_audio(seconds: float, rate: int = 44100) -> np.ndarray:
    """Interleaved 16-bit stereo program material: five partials per
    channel, a slow amplitude swell and a noise floor about 50 dB down
    (seeded; the JAX package's ``bench.make_audio``)."""
    n = int(seconds * rate)
    t = np.arange(n, dtype=np.float64) / rate
    rng = np.random.default_rng(1234)
    interleaved = np.empty(2 * n, dtype=np.int32)
    for ch in range(2):
        sig = np.zeros(n)
        for f0, amp in ((220.0 + 3 * ch, 0.30), (440.0, 0.18), (881.5, 0.09),
                        (1763.0, 0.05), (3526.0, 0.02)):
            sig += amp * np.sin(2 * np.pi * f0 * t + ch + rng.uniform(0, 6.28))
        sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 0.3 * t + ch)
        sig += 0.003 * rng.standard_normal(n)
        interleaved[ch::2] = np.clip(np.round(sig * 20000.0), -32768, 32767).astype(np.int32)
    return interleaved
