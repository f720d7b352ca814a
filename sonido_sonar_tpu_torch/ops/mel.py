"""Mel scale and triangular mel filter bank (counterpart of
`sonido_sonar_tpu/ops/mel.py`).

Reference parity: algorithms/spectral/mel_scale.go — HzToMel/MelToHz
(:19-26), bin mapping `floor((fftSize+1)*hz/sr + .5)` clamped to
fftSize/2 (:54-56), triangular filters (:65-87).
"""

from __future__ import annotations

import functools

import numpy as np


def hz_to_mel(hz):
    """mel = 2595 log10(1 + hz/700)."""
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    """hz = 700 (10^(mel/2595) - 1)."""
    return 700.0 * (np.power(10.0, np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=64)
def mel_filterbank(
    num_filters: int,
    fft_size: int,
    sample_rate: int,
    low_freq: float = 0.0,
    high_freq: float = 0.0,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank [num_filters, fft_size//2 + 1], with the
    reference's integer bin rounding and fftSize/2 clamp."""
    if high_freq <= 0:
        high_freq = sample_rate / 2.0
    low_mel = hz_to_mel(low_freq)
    high_mel = hz_to_mel(high_freq)
    mel_points = low_mel + (high_mel - low_mel) / (num_filters + 1) * np.arange(
        num_filters + 2, dtype=np.float64
    )
    hz_points = mel_to_hz(mel_points)
    bin_points = np.floor((fft_size + 1.0) * hz_points / sample_rate + 0.5).astype(
        np.int64
    )
    bin_points = np.minimum(bin_points, fft_size // 2)

    n_bins = fft_size // 2 + 1
    fb = np.zeros((num_filters, n_bins), dtype=np.float64)
    for m in range(1, num_filters + 1):
        left, center, right = bin_points[m - 1], bin_points[m], bin_points[m + 1]
        if center != left:
            k = np.arange(left, min(center, n_bins))
            fb[m - 1, k] = (k - left) / float(center - left)
        if right != center:
            k = np.arange(center, min(right, n_bins))
            fb[m - 1, k] = (right - k) / float(right - center)
    out = fb.astype(dtype)
    out.setflags(write=False)
    return out
