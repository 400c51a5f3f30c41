"""The port's measurement tools (counterparts of the JAX package's ``tools/``).

- ``python -m flacenc_tpu_torch.tools.profile``: a `torch.profiler` trace
  of one full encode;
- ``python -m flacenc_tpu_torch.tools.bench``: the headline measurement
  (the JAX package's ``bench.py`` worker): timed encode trials of CD stereo
  at batch 256, their median, the host ceiling, the device step and the
  same-corpus strict bits, as JSON result lines;
- ``python -m flacenc_tpu_torch.tools.hwconfigs``: x-realtime and
  bits/sample of the five ``BASELINE.json`` configs as one markdown table;
- ``python -m flacenc_tpu_torch.tools.microbench``: per-stage and per-op
  times of one `BatchEncoder` forward, the host packer and MD5 rates, the
  Rice kernel against its plain version, and with ``--kernel-sweep`` the
  two over batch x block;
- ``python -m flacenc_tpu_torch.tools.overlap``: where the wall of a
  streamed encode goes, from its stage timeline (``FLACENC_TIMELINE=1``);
- ``python -m flacenc_tpu_torch.tools.reporter``: compression rate and
  inverse real-time factor of four configs on a synthetic corpus, as a
  markdown report.

All run on ``cuda`` unless given ``--cpu-only``.
"""

from __future__ import annotations

import subprocess

import numpy as np


def card_line(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"),
    or "cpu" for the CPU."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[device.index or 0].strip()


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


def stereo_audio(seconds: float, rate: int, bps: int) -> np.ndarray:
    """Interleaved stereo program material at any rate and depth: the
    `make_audio` material at 16 bit / 44.1 kHz, else four partials per
    channel, a slow swell and a noise floor scaled to the depth (seeded; the
    JAX package's ``tools/hwconfigs.stereo_audio``)."""
    if bps == 16 and rate == 44100:
        return make_audio(seconds, rate)
    n = int(seconds * rate)
    t = np.arange(n, dtype=np.float64) / rate
    rng = np.random.default_rng(99)
    full = (1 << (bps - 1)) - 1
    out = np.empty(2 * n, np.int32)
    for ch in range(2):
        sig = np.zeros(n)
        for f0, amp in ((196.0 + 5 * ch, 0.3), (392.0, 0.15), (784.5, 0.07),
                        (1569.0, 0.03)):
            sig += amp * np.sin(2 * np.pi * f0 * t + ch + rng.uniform(0, 6.28))
        sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 0.25 * t + ch)
        sig += (2.0 ** -(bps - 6)) * rng.standard_normal(n)
        out[ch::2] = np.clip(np.round(sig * 0.6 * full), -full - 1, full).astype(np.int64)
    return out
