"""Thin FFT wrappers (reference: algorithms/spectral/fft.go:19-51;
counterpart of `sonido_sonar_tpu/ops/fft.py`).

The reference wraps go-dsp's FFTReal/IFFT; here the equivalents are
`torch.fft` (cuFFT on the card, pocketfft on the CPU). Kept as a module
so the layer map matches the JAX package and callers have one import
point.
"""

from __future__ import annotations

from typing import Optional

import torch


def compute(signal: torch.Tensor) -> torch.Tensor:
    """Real -> complex spectrum (FFT.Compute / fft.FFTReal)."""
    return torch.fft.rfft(signal.to(torch.float32), dim=-1)


def compute_inverse(spectrum: torch.Tensor) -> torch.Tensor:
    """Complex -> complex inverse (FFT.ComputeInverse / fft.IFFT)."""
    return torch.fft.ifft(spectrum, dim=-1)


def compute_inverse_real(spectrum: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Complex half-spectrum -> real signal (FFT.ComputeInverseReal)."""
    return torch.fft.irfft(spectrum, n=n, dim=-1)


def fft_complex(signal: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft(signal, dim=-1)
