"""Analysis-window generation, bit-exact with the reference.

The reference computes Tukey windows in f32 using libm's ``cosf``
(``flacenc-rs/src/lpc.rs:96-120``). We evaluate the same f32 expression
chain, calling the system libm ``cosf`` through ctypes (the same function
Rust's ``f32::cos`` lowers to on this platform), so windows match
bit-for-bit. Results are cached per (window, size) like the reference's
``WINDOW_CACHE`` (lpc.rs:217-231).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math

import numpy as np

from ..config import Window

_F32_2PI = np.float32(2.0) * np.float32(math.pi)  # 2.0 * std::f32::consts::PI


@functools.cache
def _libm_cosf():
    try:
        libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        cosf = libm.cosf
        cosf.restype = ctypes.c_float
        cosf.argtypes = [ctypes.c_float]
        return cosf
    except OSError:  # pragma: no cover - fallback when libm is unavailable
        return None


@functools.cache
def _libm_sinf():
    try:
        libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        sinf = libm.sinf
        sinf.restype = ctypes.c_float
        sinf.argtypes = [ctypes.c_float]
        return sinf
    except OSError:  # pragma: no cover
        return None


def _libm_map(fn, x: np.ndarray) -> np.ndarray:
    out = np.empty(x.shape, dtype=np.float32)
    flat_in = x.ravel()
    flat_out = out.ravel()
    for i in range(flat_in.size):
        flat_out[i] = fn(ctypes.c_float(float(flat_in[i])))
    return out


def _cosf(x: np.ndarray) -> np.ndarray:
    """Elementwise f32 cosine via libm cosf (fallback: numpy cos)."""
    cosf = _libm_cosf()
    if cosf is None:  # pragma: no cover
        return np.cos(x, dtype=np.float32)
    return _libm_map(cosf, x)


def sinf(x: np.ndarray) -> np.ndarray:
    """Elementwise f32 sine via libm sinf — the same function Rust's
    f32::sin lowers to, for bit-exact sigen fixtures."""
    f = _libm_sinf()
    if f is None:  # pragma: no cover
        return np.sin(x, dtype=np.float32)
    return _libm_map(f, x)


def window_weights(win: Window, length: int) -> np.ndarray:
    """f32 window weights, matching lpc.rs:96-120 exactly."""
    if win.type == "Rectangle" or (win.type == "Tukey" and win.alpha == 0.0):
        return np.ones(length, dtype=np.float32)
    alpha = np.float32(win.alpha)
    max_t = np.float32(length) - np.float32(1.0)
    alpha_len = alpha * max_t
    t = np.arange(length, dtype=np.float32)
    half = alpha_len / np.float32(2.0)
    # rising/falling cosine lobes (f32 arithmetic throughout)
    rise_arg = (_F32_2PI * t) / alpha_len
    fall_arg = (_F32_2PI * (max_t - t)) / alpha_len
    rise = np.float32(0.5) * (np.float32(1.0) - _cosf(rise_arg))
    fall = np.float32(0.5) * (np.float32(1.0) - _cosf(fall_arg))
    w = np.ones(length, dtype=np.float32)
    w = np.where(t < half, rise, np.where(t < max_t - half, w, fall))
    return w.astype(np.float32)


@functools.cache
def _cached_window(wtype: str, alpha32_bits: int, length: int) -> np.ndarray:
    alpha = np.uint32(alpha32_bits).view(np.float32) if wtype == "Tukey" else 0.0
    w = window_weights(Window(type=wtype, alpha=float(alpha)), length)
    w.setflags(write=False)
    return w


def get_window(win: Window, length: int) -> np.ndarray:
    """Cached f32 window (read-only array)."""
    alpha_bits = int(np.float32(win.alpha).view(np.uint32)) if win.type == "Tukey" else 0
    return _cached_window(win.type, alpha_bits, length)
