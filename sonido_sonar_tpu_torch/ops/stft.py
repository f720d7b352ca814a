"""Plain STFT magnitude and spectral flux (counterpart of
`sonido_sonar_tpu/ops/stft.py`).

Reference parity: fingerprint/analyzers/spectral.go:385-517 — frame,
window (symmetric, power-gain normalized), real DFT, magnitude. The DFT
is a matmul against the [W, 2F] windowed basis, in true float32: on a
CUDA device the caller keeps TF32 off.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from sonido_sonar_tpu_torch.config.config import WindowType
from sonido_sonar_tpu_torch.ops.framing import frame_signal
from sonido_sonar_tpu_torch.ops.tables import device_table
from sonido_sonar_tpu_torch.ops.windows import make_window


@functools.lru_cache(maxsize=32)
def _windowed_dft_matrix(window_type: WindowType, window_size: int) -> np.ndarray:
    """[W, 2F] real matrix: columns are Re then Im of the rDFT basis,
    each row pre-scaled by the window — frames @ M = [Re | Im]."""
    w = make_window(
        window_type, window_size, normalize=True, symmetric=True, dtype=np.float64
    )
    f_bins = window_size // 2 + 1
    n = np.arange(window_size, dtype=np.float64)[:, None]
    k = np.arange(f_bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / window_size
    m = np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    m *= w[:, None]
    out = m.astype(np.float32)
    out.setflags(write=False)
    return out


def stft(
    signal: torch.Tensor,
    window_size: int = 2048,
    hop_size: int = 512,
    window_type: WindowType = WindowType.HANN,
) -> torch.Tensor:
    """|STFT| over the last axis: [..., N] -> [..., T, F], F = W//2 + 1."""
    frames = frame_signal(signal.to(torch.float32), window_size, hop_size)
    m = device_table(
        _windowed_dft_matrix, (WindowType(window_type), window_size), signal.device
    )
    f_bins = window_size // 2 + 1
    reim = torch.matmul(frames, m)
    re, im = reim[..., :f_bins], reim[..., f_bins:]
    return torch.sqrt(re * re + im * im)


def spectral_flux(magnitude: torch.Tensor) -> torch.Tensor:
    """Half-wave-rectified L2 frame-to-frame flux, [..., T, F] -> [..., T]
    (spectral/spectral_flux.go:17-56). Frame 0 has flux 0."""
    diff = magnitude[..., 1:, :] - magnitude[..., :-1, :]
    rect = torch.clamp_min(diff, 0.0)
    flux = torch.sqrt(torch.sum(rect * rect, dim=-1))
    return F.pad(flux, (1, 0))
