"""Window functions (9 families) with unity-power-gain normalization.

Counterpart of `sonido_sonar_tpu/ops/windows.py`, with the same float64
numpy construction so every table is bit-identical to the JAX package's.

Reference parity: algorithms/windowing/*.go (formulas) and
fingerprint/analyzers/windowing.go (symmetric/periodic switch,
power-gain normalization `w *= 1/sqrt(mean(w^2))` at :426-437).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict

import numpy as np

from sonido_sonar_tpu_torch.config.config import WindowType


def _denominator(n: int, symmetric: bool) -> float:
    return float(n - 1) if symmetric else float(n)


def _hann(n: int, symmetric: bool) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return 0.5 * (1.0 - np.cos(2 * np.pi * i / _denominator(n, symmetric)))


def _hamming(n: int, symmetric: bool) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2 * np.pi * i / _denominator(n, symmetric))


def _blackman(n: int, symmetric: bool) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    x = 2 * np.pi * i / _denominator(n, symmetric)
    return 0.42 - 0.5 * np.cos(x) + 0.08 * np.cos(2 * x)


def _blackman_harris(n: int, symmetric: bool) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    x = 2 * np.pi * i / _denominator(n, symmetric)
    return (
        0.35875 - 0.48829 * np.cos(x) + 0.14128 * np.cos(2 * x)
        - 0.01168 * np.cos(3 * x)
    )


def _bessel_i0(x: np.ndarray) -> np.ndarray:
    """Modified Bessel I0 via power series (kaiser.go:46)."""
    result = np.ones_like(x)
    term = np.ones_like(x)
    half_x = x / 2.0
    for k in range(1, 51):
        term = term * (half_x / k) ** 2
        result = result + term
    return result


def _kaiser(n: int, beta: float, symmetric: bool) -> np.ndarray:
    d = _denominator(n, symmetric)
    i = np.arange(n, dtype=np.float64)
    arg = beta * np.sqrt(np.maximum(0.0, 1.0 - (2.0 * i / d - 1.0) ** 2))
    return _bessel_i0(arg) / _bessel_i0(np.array(beta, dtype=np.float64))


def _tukey(n: int, alpha: float, symmetric: bool) -> np.ndarray:
    """Tapered cosine (tukey.go:17-50)."""
    if alpha <= 0:
        return np.ones(n, dtype=np.float64)
    if alpha >= 1:
        return _hann(n, symmetric)
    d = _denominator(n, symmetric)
    i = np.arange(n, dtype=np.float64)
    w = np.ones(n, dtype=np.float64)
    edge = alpha * d / 2.0
    lo = i < edge
    arg_lo = np.pi * (2.0 * i / (alpha * d))
    w = np.where(lo, 0.5 * (1.0 + np.cos(arg_lo - np.pi)), w)
    hi = i > d - edge
    arg_hi = np.pi * (2.0 * (i - d + edge) / (alpha * d))
    w = np.where(hi, 0.5 * (1.0 + np.cos(arg_hi)), w)
    return w


def _bartlett(n: int, symmetric: bool) -> np.ndarray:
    d = _denominator(n, symmetric)
    i = np.arange(n, dtype=np.float64)
    return 1.0 - np.abs(2.0 * i / d - 1.0)


def _welch(n: int, symmetric: bool) -> np.ndarray:
    d = _denominator(n, symmetric)
    i = np.arange(n, dtype=np.float64)
    return 1.0 - (2.0 * i / d - 1.0) ** 2


def _rectangular(n: int, symmetric: bool) -> np.ndarray:
    return np.ones(n, dtype=np.float64)


_GENERATORS = {
    WindowType.HANN: lambda n, b, a, s: _hann(n, s),
    WindowType.HAMMING: lambda n, b, a, s: _hamming(n, s),
    WindowType.BLACKMAN: lambda n, b, a, s: _blackman(n, s),
    WindowType.BLACKMAN_HARRIS: lambda n, b, a, s: _blackman_harris(n, s),
    WindowType.KAISER: lambda n, b, a, s: _kaiser(n, b, s),
    WindowType.TUKEY: lambda n, b, a, s: _tukey(n, a, s),
    WindowType.BARTLETT: lambda n, b, a, s: _bartlett(n, s),
    WindowType.WELCH: lambda n, b, a, s: _welch(n, s),
    WindowType.RECTANGULAR: lambda n, b, a, s: _rectangular(n, s),
}


@functools.lru_cache(maxsize=256)
def make_window(
    window_type: WindowType = WindowType.HANN,
    size: int = 2048,
    beta: float = 8.6,
    alpha: float = 0.5,
    normalize: bool = True,
    symmetric: bool = True,
    dtype=np.float32,
) -> np.ndarray:
    """Window coefficients, built in float64 and cast to `dtype`.

    `normalize=True` applies the reference's unity-power-gain scaling
    `w *= 1/sqrt(mean(w^2))`. The production STFT uses normalize=True,
    symmetric=True (analyzers/spectral.go:290-295) — not the periodic
    window `torch.hann_window` returns.
    """
    if size <= 0:
        raise ValueError(f"window size must be positive, got {size}")
    gen = _GENERATORS.get(WindowType(window_type))
    w = gen(size, beta, alpha, symmetric)
    if normalize:
        w = w / np.sqrt(window_properties(w).power_gain)
    out = w.astype(dtype)
    out.setflags(write=False)
    return out


@dataclass(frozen=True)
class WindowProperties:
    """Analysis properties (analyzers/windowing.go:36-47,395-424)."""

    energy: float
    power_gain: float      # mean(w^2), incoherent averaging gain
    noise_gain: float      # mean(w), coherent averaging gain
    enbw: float            # equivalent noise bandwidth (bins)
    scallop_loss: float    # dB
    coherent: bool


def window_properties(w: np.ndarray) -> WindowProperties:
    n = float(len(w))
    energy = float(np.sum(w * w))
    coherent_sum = float(np.sum(w))
    power_gain = energy / n
    noise_gain = coherent_sum / n
    enbw = n * energy / (coherent_sum * coherent_sum)
    scallop = -20.0 * np.log10(abs(noise_gain)) if noise_gain != 0 else np.inf
    return WindowProperties(
        energy=energy,
        power_gain=power_gain,
        noise_gain=noise_gain,
        enbw=enbw,
        scallop_loss=float(scallop),
        coherent=noise_gain > 0.5,
    )


def all_window_types() -> Dict[str, WindowType]:
    return {wt.value: wt for wt in WindowType}


_RECOMMENDED = {
    "general_analysis": WindowType.HANN,
    "speech_analysis": WindowType.HAMMING,
    "music_analysis": WindowType.BLACKMAN,
    "transient_analysis": WindowType.RECTANGULAR,
    "high_resolution": WindowType.BLACKMAN_HARRIS,
}


def get_recommended_window(use_case: str, size: int) -> np.ndarray:
    """GetRecommendedWindow (analyzers/windowing.go:446-470): normalized
    symmetric window for a named use case."""
    wt = _RECOMMENDED.get(use_case, WindowType.HANN)
    return make_window(wt, size, normalize=True, symmetric=True)
