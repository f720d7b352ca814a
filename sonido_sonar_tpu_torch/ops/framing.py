"""Signal framing: [..., N] -> [..., T, W].

Counterpart of `sonido_sonar_tpu/ops/framing.py`. Frame count
T = (N - W) // hop + 1 with no padding or centering (spectral.go:418);
frame t covers samples [t*hop, t*hop + W).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def num_frames(n_samples: int, window_size: int, hop_size: int) -> int:
    if n_samples < window_size:
        return 0
    return (n_samples - window_size) // hop_size + 1


def frame_signal(
    signal: torch.Tensor, window_size: int, hop_size: int
) -> torch.Tensor:
    """Frame the last axis: [..., N] -> [..., T, W], a strided view."""
    n = signal.shape[-1]
    if num_frames(n, window_size, hop_size) <= 0:
        raise ValueError(
            f"signal length {n} shorter than window {window_size}"
        )
    return signal.unfold(-1, window_size, hop_size)


def frame_times(
    t: int, hop_size: int, window_size: int, sample_rate: int
) -> np.ndarray:
    """Frame start times in seconds (host-side metadata)."""
    return (np.arange(t) * hop_size) / float(sample_rate)


def kernel_signal(
    signal: torch.Tensor, window_size: int, hop_size: int
) -> Tuple[torch.Tensor, int, int]:
    """Check a signal for one of the framed CUDA kernels and view it as
    rows: [..., N] -> (signal_2d [B, N], B, T), B the product of the
    leading axes (1 for an [N] row). Raises ValueError on anything the
    kernels do not take — they read float32, contiguous rows of at least
    one window, and never convert or copy (the [B, N] view of a
    contiguous tensor is free). Callers reshape each [B, ...] output
    back to `signal.shape[:-1] + (...)`."""
    if signal.dtype != torch.float32:
        raise ValueError(f"kernel input must be float32, got {signal.dtype}")
    if signal.dim() < 1:
        raise ValueError(
            f"kernel input must have a sample axis ([N] or [B, N], or more "
            f"leading axes), got {tuple(signal.shape)}"
        )
    if not signal.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    if hop_size < 1:
        raise ValueError(f"hop size must be >= 1, got {hop_size}")
    n = signal.shape[-1]
    sig = signal.view(-1, n)
    b = sig.shape[0]
    t = num_frames(n, window_size, hop_size)
    if b < 1 or t < 1:
        raise ValueError(
            f"kernel input {tuple(signal.shape)} holds no frame of {window_size} samples"
        )
    if b > 65535 or n >= 2**31:
        raise ValueError(f"kernel input {tuple(signal.shape)} exceeds the launch grid")
    return sig, b, t
