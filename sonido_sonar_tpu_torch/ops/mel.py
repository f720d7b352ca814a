"""Mel and Bark scales and filter banks (counterpart of
`sonido_sonar_tpu/ops/mel.py`).

Reference parity: algorithms/spectral/mel_scale.go — HzToMel/MelToHz
(:19-26), bin mapping `floor((fftSize+1)*hz/sr + .5)` clamped to
fftSize/2 (:54-56), triangular filters (:65-87); bark_scale.go
(Traunmueller/Zwicker conversions, critical-band filterbank). The banks
are float64 numpy tables cast to float32, as JAX builds them; applying
one is a float32 matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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


def apply_filterbank(power_spec: torch.Tensor, fb: np.ndarray) -> torch.Tensor:
    """[..., F] x [M, F]^T -> [..., M] (mel_scale.go:90-106), a true
    float32 matmul (TF32 off: the log downstream amplifies its error)."""
    from sonido_sonar_tpu_torch.utils.device import require_fp32_matmuls

    require_fp32_matmuls(power_spec, "apply_filterbank")
    table = torch.from_numpy(np.array(fb, dtype=np.float32)).to(power_spec.device)
    return torch.matmul(power_spec, table.T)


def hz_to_bark_traunmueller(hz):
    """bark = 26.81 hz / (1960 + hz) - 0.53, with edge corrections."""
    hz = np.asarray(hz, dtype=np.float64)
    bark = 26.81 * hz / (1960.0 + hz) - 0.53
    bark = np.where(bark < 2.0, bark + 0.15 * (2.0 - bark), bark)
    bark = np.where(bark > 20.1, bark + 0.22 * (bark - 20.1), bark)
    return bark


def bark_to_hz_traunmueller(bark):
    bark = np.asarray(bark, dtype=np.float64)
    b = np.where(bark < 2.0, (bark - 0.3) / 0.85, bark)
    b = np.where(bark > 20.1, (b + 4.422) / 1.22, b)
    return 1960.0 * (b + 0.53) / (26.28 - b)


def hz_to_bark_zwicker(hz):
    """bark = 13 atan(0.00076 hz) + 3.5 atan((hz/7500)^2)."""
    hz = np.asarray(hz, dtype=np.float64)
    return 13.0 * np.arctan(0.00076 * hz) + 3.5 * np.arctan((hz / 7500.0) ** 2)


def critical_band_edges() -> np.ndarray:
    """The 25 standard critical band edge frequencies (Hz)."""
    return np.array(
        [
            0, 100, 200, 300, 400, 510, 630, 770, 920, 1080, 1270, 1480,
            1720, 2000, 2320, 2700, 3150, 3700, 4400, 5300, 6400, 7700,
            9500, 12000, 15500,
        ],
        dtype=np.float64,
    )


@functools.lru_cache(maxsize=32)
def bark_filterbank(
    num_filters: int,
    fft_size: int,
    sample_rate: int,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular filterbank on the Traunmueller bark axis, [M, F]."""
    nyquist = sample_rate / 2.0
    low_bark = float(hz_to_bark_traunmueller(20.0))
    high_bark = float(hz_to_bark_traunmueller(nyquist))
    bark_points = np.linspace(low_bark, high_bark, num_filters + 2)
    hz_points = bark_to_hz_traunmueller(bark_points)
    n_bins = fft_size // 2 + 1
    freqs = np.arange(n_bins) * sample_rate / float(fft_size)
    fb = np.zeros((num_filters, n_bins), dtype=np.float64)
    for m in range(1, num_filters + 1):
        left, center, right = hz_points[m - 1], hz_points[m], hz_points[m + 1]
        rising = (freqs - left) / max(center - left, 1e-12)
        falling = (right - freqs) / max(right - center, 1e-12)
        fb[m - 1] = np.clip(np.minimum(rising, falling), 0.0, 1.0)
    out = fb.astype(dtype)
    out.setflags(write=False)
    return out
