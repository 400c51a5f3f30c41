"""Synthetic program material, one generator per program type.

Frozen copies, at commit 4f28b57, of the port's seeded audio generators
``flacenc_tpu_torch/tools/__init__.py`` `make_audio` and
``flacenc_tpu_torch/tools/reporter.py`` `make_corpus`. The four
programs of `make_corpus` (tonal, percussive, ambient, near-silence with
clicks) are given a random generator in place of their fixed seeds, and
their parameters drawn from it within narrow ranges, so that a seed changes
the samples and not the kind of work they make. `noise` is the harness's
own, for mixes of loud, noise-like material. Each returns a (n, 2)
float64 array at full scale 1.0; `quantize` turns it into PCM.
"""

from __future__ import annotations

import numpy as np


def tonal(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    """Five partials a channel, a slow swell and a noise floor about 50 dB
    down (`make_audio`; scaled to its 20000 / 32767 of full scale)."""
    t = np.arange(n, dtype=np.float64) / rate
    out = np.empty((n, 2))
    base = rng.uniform(0.95, 1.05)
    for ch in range(2):
        sig = np.zeros(n)
        for f0, amp in ((220.0 + 3 * ch, 0.30), (440.0, 0.18), (881.5, 0.09),
                        (1763.0, 0.05), (3526.0, 0.02)):
            sig += amp * np.sin(2 * np.pi * f0 * base * t + ch + rng.uniform(0, 6.28))
        sig *= 0.6 + 0.4 * np.sin(2 * np.pi * 0.3 * t + ch + rng.uniform(0, 6.28))
        sig += 0.003 * rng.standard_normal(n)
        out[:, ch] = sig * (20000.0 / 32767.0)
    return out


def percussive(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    """Noise bursts under a sin^8 envelope near 2.1 Hz, the right channel a
    seeded lag of the left (`make_corpus`'s "percussive")."""
    t = np.arange(n) / rate
    env = np.sin(2 * np.pi * rng.uniform(1.9, 2.3) * t + rng.uniform(0, 6.28)) ** 8
    x = rng.standard_normal(n) * env * 0.4 * (26000.0 / 32767.0)
    return np.stack([x, np.roll(x, int(rng.integers(9, 26)))], axis=1)


def ambient(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    """Two low sines and a faint noise floor, the channels a few LSBs apart
    (`make_corpus`'s "ambient")."""
    t = np.arange(n) / rate
    f = rng.uniform(0.97, 1.03)
    x = (0.05 * np.sin(2 * np.pi * 55 * f * t + rng.uniform(0, 6.28))
         + 0.02 * np.sin(2 * np.pi * 110.3 * f * t + rng.uniform(0, 6.28))
         + 0.001 * rng.standard_normal(n)) * (32000.0 / 32767.0)
    return np.stack([x, x + rng.integers(-2, 3, n) / 32767.0], axis=1)


def near_silence(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    """Digital silence with about two clicks a second, the same on both
    channels (`make_corpus`'s "sparse": 50 clicks in its 24 s)."""
    x = np.zeros(n)
    k = max(1, round(n / rate * 50 / 24))
    x[rng.integers(0, n, k)] = rng.integers(-30000, 30000, k) / 32767.0
    return np.stack([x, x], axis=1)


def noise(rng: np.random.Generator, n: int, rate: int) -> np.ndarray:
    """Loud broadband noise, the channels partly correlated: material on
    which prediction gains little and the residuals are long."""
    level, rho = rng.uniform(0.2, 0.3), rng.uniform(0.2, 0.5)
    a, b = rng.standard_normal(n), rng.standard_normal(n)
    return level * np.stack([a, rho * a + np.sqrt(1.0 - rho * rho) * b], axis=1)


PROGRAMS = {"tonal": tonal, "percussive": percussive, "ambient": ambient,
            "near_silence": near_silence, "noise": noise}


def quantize(x: np.ndarray, bps: int) -> np.ndarray:
    """Round full-scale samples to `bps`-bit integers, clipped."""
    full = (1 << (bps - 1)) - 1
    y = np.multiply(x, x.dtype.type(full))
    np.rint(y, out=y)
    np.clip(y, -full - 1, full, out=y)
    return y.astype(np.int32)
