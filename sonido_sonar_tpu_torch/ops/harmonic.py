"""Harmonic analysis: spectral peaks, HPS, autocorrelation F0
(counterpart of `sonido_sonar_tpu/ops/harmonic.py`).

Reference parity: algorithms/harmonic/*.go —
  spectral_peaks.go: local maxima above min height with greedy
    min-distance suppression keeping the higher peak (:36-100);
  harmonic_product.go: HPS = product of downsampled power spectra,
    F0 = argmax within [minF0, maxF0] (:10-60);
  fundamental_estimation.go: autocorrelation F0 with lag bounds from
    the F0 range (:10-55).

Variable-length peak lists are fixed-k arrays plus a count, from k
rounds of masked argmax (the reference's keep-the-higher-peak rule).
`torch.argmax` keeps the first of equal values on the CPU and on CUDA,
as `jnp.argmax` does, so tied peaks come out in the same order. Plain
PyTorch on every device: JAX computes these as XLA, outside any Pallas
kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-10


def detect_spectral_peaks(
    magnitude: torch.Tensor,
    sample_rate: int,
    window_size: int,
    max_peaks: int = 16,
    min_peak_height: float = 0.0,
    min_peak_distance_hz: float = 50.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy peak picking on [..., F] magnitude frames.

    Returns (freqs [..., max_peaks] float32, mags [..., max_peaks]
    float32, count [...] int32); unused slots hold freq 0 and mag 0.
    Each round takes the highest remaining candidate and suppresses the
    bins within min_distance of it (spectral_peaks.go:54-73): only those
    2 min_distance - 1 bins are written, not the whole row.
    """
    mag = magnitude.to(torch.float32)
    f_bins = mag.shape[-1]
    freq_res = sample_rate / float(window_size)
    min_dist_bins = max(int(min_peak_distance_hz / freq_res), 1)

    mid = mag[..., 1:-1]
    local_max = (mid > mag[..., :-2]) & (mid > mag[..., 2:]) & (mid >= min_peak_height)
    score = torch.full_like(mag, float("-inf"))
    score[..., 1:-1] = torch.where(local_max, mid, float("-inf"))
    # clamping the suppressed offsets to [0, F) keeps them within
    # min_distance of the peak, so the clamped writes are still correct
    offsets = torch.arange(-(min_dist_bins - 1), min_dist_bins, device=mag.device)

    lead = mag.shape[:-1]
    idx = torch.full(lead + (max_peaks,), -1, dtype=torch.int64, device=mag.device)
    mags = torch.zeros(lead + (max_peaks,), dtype=torch.float32, device=mag.device)
    for i in range(max_peaks):
        best = torch.argmax(score, dim=-1, keepdim=True)
        best_val = torch.gather(score, -1, best)[..., 0]
        ok = torch.isfinite(best_val)
        idx[..., i] = torch.where(ok, best[..., 0], -1)
        mags[..., i] = torch.where(ok, best_val, 0.0)
        near = torch.clamp(best + offsets, 0, f_bins - 1)
        score.scatter_(-1, near, float("-inf"))
    count = torch.sum(idx >= 0, dim=-1, dtype=torch.int32)
    freqs = torch.where(idx >= 0, idx.to(torch.float32) * freq_res, 0.0)
    return freqs, mags, count


def harmonic_product_spectrum(
    magnitude: torch.Tensor, num_harmonics: int = 5
) -> torch.Tensor:
    """HPS(f) = prod_h power(h*f) over downsampled spectra
    (harmonic_product.go:10-40). [..., F] -> [..., F//num_harmonics]."""
    power = magnitude * magnitude
    out_len = magnitude.shape[-1] // num_harmonics
    hps = power[..., :out_len]
    for h in range(2, num_harmonics + 1):
        hps = hps * power[..., : out_len * h: h]
    return hps


def estimate_f0_hps(
    magnitude: torch.Tensor,
    sample_rate: int,
    window_size: int,
    min_f0: float = 50.0,
    max_f0: float = 2000.0,
    num_harmonics: int = 5,
) -> torch.Tensor:
    """F0 = argmax of HPS within [min_f0, max_f0]
    (harmonic_product.go:42-60)."""
    hps = harmonic_product_spectrum(magnitude, num_harmonics)
    freq_res = sample_rate / float(window_size)
    freqs = torch.arange(hps.shape[-1], dtype=torch.float32, device=hps.device) * freq_res
    in_range = (freqs >= min_f0) & (freqs <= max_f0)
    best = torch.argmax(torch.where(in_range, hps, float("-inf")), dim=-1)
    return best.to(torch.float32) * freq_res


def estimate_f0_autocorrelation(
    frame: torch.Tensor,
    sample_rate: int,
    min_f0: float = 50.0,
    max_f0: float = 2000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autocorrelation F0 with lag bounds from the F0 range
    (fundamental_estimation.go:10-55). Returns (f0, confidence)."""
    from sonido_sonar_tpu_torch.ops.pitch import PitchParams, acf_pitch

    params = PitchParams(
        sample_rate=sample_rate, window_size=frame.shape[-1],
        min_freq=min_f0, max_freq=max_f0,
    )
    return acf_pitch(frame, params)
