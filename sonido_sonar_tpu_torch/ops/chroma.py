"""Chroma-STFT fold (counterpart of the chroma-STFT part of
`sonido_sonar_tpu/ops/chroma.py`).

Reference parity: algorithms/chroma/chroma_stft.go — FFT bin -> pitch
class via MIDI 69 + 12 log2(f/440) rounded mod 12, energy (mag^2) summed
per class, unit-sum normalization (:91-140); range 80-8000 Hz (:34-35).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sonido_sonar_tpu_torch.ops.tables import device_table

_EPS = 1e-10
CHROMA_LABELS = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
# key profiles (chroma_stft.go:249-251)
_MAJOR_PROFILE = np.array([1.0, 0.2, 0.6, 0.2, 0.8, 0.6, 0.2, 1.0, 0.2, 0.6, 0.2, 0.4])
_MINOR_PROFILE = np.array([1.0, 0.2, 0.4, 0.6, 0.2, 0.8, 0.2, 0.6, 0.8, 0.2, 0.4, 0.2])


@functools.lru_cache(maxsize=32)
def chroma_fold_matrix(
    freq_bins: int,
    sample_rate: int,
    window_size: int,
    tuning_freq: float = 440.0,
    min_freq: float = 80.0,
    max_freq: float = 8000.0,
) -> np.ndarray:
    """[12, F] 0/1 fold matrix: entry (c, f) = 1 if bin f maps to pitch
    class c. `round` is round-half-to-even, as in the JAX package."""
    freq_res = sample_rate / float(window_size)
    fold = np.zeros((12, freq_bins), dtype=np.float32)
    for f in range(freq_bins):
        freq = f * freq_res
        if freq < min_freq or freq > max_freq or freq <= 0:
            continue
        midi = 69.0 + 12.0 * np.log2(freq / tuning_freq)
        c = int(round(midi)) % 12
        fold[c, f] = 1.0
    fold.setflags(write=False)
    return fold


def chroma_from_magnitude(
    magnitude: torch.Tensor,
    sample_rate: int,
    window_size: int,
    tuning_freq: float = 440.0,
    min_freq: float = 80.0,
    max_freq: float = 8000.0,
) -> torch.Tensor:
    """Chromagram [..., T, 12] from magnitude frames [..., T, F]."""
    fold = device_table(
        chroma_fold_matrix,
        (magnitude.shape[-1], sample_rate, window_size, tuning_freq, min_freq, max_freq),
        magnitude.device,
    )
    energy = torch.matmul(magnitude * magnitude, fold.T)
    return chroma_normalize(energy)


def chroma_normalize(energy: torch.Tensor) -> torch.Tensor:
    """Unit-sum normalization of [..., 12] energies."""
    total = torch.sum(energy, dim=-1, keepdim=True)
    return torch.where(total > _EPS, energy / torch.clamp_min(total, _EPS), energy)


def _key_profiles() -> np.ndarray:
    """[24, 12]: the major profile rolled to roots 0..11, then the minor."""
    rows = [np.roll(_MAJOR_PROFILE, r) for r in range(12)]
    rows += [np.roll(_MINOR_PROFILE, r) for r in range(12)]
    return np.stack(rows)


def key_correlations(mean_chroma: torch.Tensor) -> torch.Tensor:
    """[..., 12] -> [..., 24] Pearson correlations with the key profiles:
    index r = major root r, 12 + r = minor root r (chroma_stft.go:240-330)."""
    p = device_table(_key_profiles, (), mean_chroma.device)
    x = mean_chroma[..., None, :]
    mx = torch.mean(x, dim=-1, keepdim=True)
    my = torch.mean(p, dim=-1, keepdim=True)
    num = torch.sum((x - mx) * (p - my), dim=-1)
    den = torch.sqrt(torch.sum((x - mx) ** 2, dim=-1) * torch.sum((p - my) ** 2, dim=-1))
    return torch.where(den < _EPS, 0.0, num / torch.clamp_min(den, _EPS))
