"""Test-signal generator combinators.

Mirrors ``flacenc-rs/src/sigen.rs``: composable Dc/Sine/Square/Noise
generators with mix/clip/concat decorators and ``to_vec_quantized``. Noise
reproduces the reference's rand StdRng (ChaCha12) + Open01 sampling
bit-for-bit (utils/stdrng.py), so seeded fixtures match the reference's
test signals exactly.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


class Signal:
    def fill_buffer(self, sample_offset: int, dest: np.ndarray) -> None:
        raise NotImplementedError

    def to_vec_quantized(self, bits_per_sample: int, block_size: int) -> np.ndarray:
        """sigen.rs:35-53 (f32 scale, round-half-away, clamp)."""
        assert 4 < bits_per_sample <= 24
        scalefactor = 1 << (bits_per_sample - 1)
        lo = -scalefactor
        hi = scalefactor - 1
        buf = np.zeros(block_size, dtype=np.float32)
        self.fill_buffer(0, buf)
        scaled = np.float32(scalefactor) * buf
        # Rust f32::round = half away from zero with a SINGLE rounding:
        # floor(x + 0.5f32) would round the largest f32 below 0.5 up to 1.
        # f32 values are exact in f64, so the frac comparison is exact.
        a = np.abs(scaled.astype(np.float64))
        f = np.floor(a)
        rounded = np.where(scaled < 0, -(f + (a - f >= 0.5)), f + (a - f >= 0.5))
        return np.clip(rounded, lo, hi).astype(np.int32)

    def clip(self) -> "Clip":
        return Clip(self)

    def noise(self, amplitude: float) -> "Mix":
        return self.mix(Noise(amplitude))

    def noise_with_seed(self, seed0: int, amplitude: float) -> "Mix":
        return self.mix(Noise.with_seed(seed0, amplitude))

    def mix(self, other: "Signal") -> "Mix":
        return Mix(1.0, self, 1.0, other)

    def concat(self, offset_time: int, other: "Signal") -> "Switch":
        return Switch(self, offset_time, other)


class Dc(Signal):
    def __init__(self, offset: float) -> None:
        self.offset = np.float32(offset)

    def fill_buffer(self, sample_offset: int, dest: np.ndarray) -> None:
        dest[:] = self.offset


class Sine(Signal):
    def __init__(self, period: int, amplitude: float, initial_phase: float = 0.0) -> None:
        self.period = period
        self.amplitude = np.float32(amplitude)
        self.initial_phase = np.float32(initial_phase)

    @staticmethod
    def with_initial_phase(period: int, amplitude: float, initial_phase: float) -> "Sine":
        return Sine(period, amplitude, initial_phase)

    def fill_buffer(self, sample_offset: int, dest: np.ndarray) -> None:
        from .ops.windows import sinf

        # f32 chain mirrors sigen.rs:160-167: phase + 2*PI * t / period,
        # evaluated with libm sinf (what Rust f32::sin lowers to).
        # (t + offset) is cast usize -> f32 PER SAMPLE in the reference;
        # arange(dtype=float32) accumulates differently past 2^24, so
        # build exact integers in f64 and round each to f32
        t = np.arange(
            sample_offset, sample_offset + len(dest), dtype=np.float64
        ).astype(np.float32)
        two_pi = np.float32(2.0) * np.float32(math.pi)
        arg = self.initial_phase + two_pi * t / np.float32(self.period)
        dest[:] = self.amplitude * sinf(arg)


class Square(Signal):
    def __init__(self, period: int, amplitude: float) -> None:
        self.period = period
        self.amplitude = np.float32(amplitude)

    def fill_buffer(self, sample_offset: int, dest: np.ndarray) -> None:
        t = np.arange(sample_offset, sample_offset + len(dest))
        dest[:] = np.where((t // self.period) % 2 == 0, self.amplitude, -self.amplitude)


class Noise(Signal):
    def __init__(self, amplitude: float, seed0: Optional[int] = None) -> None:
        if seed0 is None:
            seed0 = int(np.random.SeedSequence().entropy) & 0xFFFFFFFFFFFFFFFF
        self.seed0 = seed0
        self.amplitude = np.float32(amplitude)

    @staticmethod
    def with_seed(seed0: int, amplitude: float) -> "Noise":
        return Noise(amplitude, seed0=seed0)

    def fill_buffer(self, sample_offset: int, dest: np.ndarray) -> None:
        from .utils.stdrng import StdRng

        rng = StdRng((self.seed0 + sample_offset) & 0xFFFFFFFFFFFFFFFF)
        u = rng.open01_f32(len(dest))  # rand Open01, (0, 1)
        dest[:] = self.amplitude * np.float32(2.0) * (u - np.float32(0.5))


class Mix(Signal):
    def __init__(self, weight1: float, signal1: Signal, weight2: float, signal2: Signal):
        self.weight1 = np.float32(weight1)
        self.weight2 = np.float32(weight2)
        self.signal1 = signal1
        self.signal2 = signal2

    def fill_buffer(self, sample_offset: int, dest: np.ndarray) -> None:
        buf = np.zeros(len(dest), dtype=np.float32)
        self.signal1.fill_buffer(sample_offset, buf)
        # sigen.rs:265-269 uses f32 mul_add: the first pass adds to zero
        # (a lone product, same rounding either way); the second pass
        # emulates FMA as one f64 product+add rounded once to f32 (equal
        # except on measure-zero double-rounding ties)
        dest[:] = self.weight1 * buf
        self.signal2.fill_buffer(sample_offset, buf)
        dest[:] = (
            np.float64(self.weight2) * buf.astype(np.float64)
            + dest.astype(np.float64)
        ).astype(np.float32)


class Clip(Signal):
    def __init__(self, inner: Signal, lo: float = -1.0, hi: float = 1.0) -> None:
        self.inner = inner
        self.lo = np.float32(lo)
        self.hi = np.float32(hi)

    def fill_buffer(self, sample_offset: int, dest: np.ndarray) -> None:
        self.inner.fill_buffer(sample_offset, dest)
        np.clip(dest, self.lo, self.hi, out=dest)


class Switch(Signal):
    def __init__(self, input1: Signal, offset: int, input2: Signal) -> None:
        self.input1 = input1
        self.offset = offset
        self.input2 = input2

    def fill_buffer(self, sample_offset: int, dest: np.ndarray) -> None:
        self.input1.fill_buffer(sample_offset, dest)
        if self.offset < len(dest):
            self.input2.fill_buffer(
                sample_offset + self.offset, dest[self.offset :]
            )
