"""Chroma features: STFT-fold chromagram, CQT chroma, HPCP, key
estimation (counterpart of `sonido_sonar_tpu/ops/chroma.py`).

Reference parity: algorithms/chroma/*.go —
  chroma_stft.go: FFT bin -> pitch class via MIDI 69 + 12 log2(f/440)
    rounded mod 12, energy (mag^2) summed per class, unit-sum normalize
    (:91-140); range 80-8000 Hz (:34-35); key estimation via shifted
    profile Pearson correlation over 12 roots x {major, minor} with the
    simplified profiles at :249-251;
  chroma_cqt.go: per-bin Gaussian-windowed complex exponential kernels,
    bins_per_octave log-spaced bins from min to max freq, octave-fold
    to 12 (:95-146, 213-244);
  hpcp.go: peak-based pitch-class profile, cosine window (1 semitone),
    band preset boost x2 below 500 Hz, defaults size 12 / 40-5000 Hz /
    ref 440 (:56-76), optional log non-linearity and max-shifted
    correlation (:330-374).

The tables (the fold matrices, the CQT kernels) are built in float64
numpy and cast once to float32, as in the JAX package. The CQT is a
framed product with the kernels (`torch.matmul`, true float32: JAX
computes it outside any Pallas kernel); HPCP takes the fixed-k peaks of
`ops/harmonic.detect_spectral_peaks`.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from sonido_sonar_tpu_torch.ops.framing import frame_signal
from sonido_sonar_tpu_torch.ops.harmonic import detect_spectral_peaks
from sonido_sonar_tpu_torch.ops.tables import device_table
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, require_fp32_matmuls

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


def chroma_stft(
    signal,
    sample_rate: int,
    window_size: int = 2048,
    hop_size: int = 512,
    device: Device = DEFAULT_DEVICE,
) -> torch.Tensor:
    """ChromaSTFT.ComputeChroma (chroma_stft.go:45-60): STFT (Hann) then
    fold. A tensor stays on its device, numpy goes to `device`."""
    from sonido_sonar_tpu_torch.ops.stft import stft

    res = stft(signal, window_size, hop_size, sample_rate=sample_rate, device=device)
    return chroma_from_magnitude(res.magnitude, sample_rate, window_size)


def _pearson(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pearson correlation over the last axis (chroma_stft.go:298-330)."""
    mx = torch.mean(x, dim=-1, keepdim=True)
    my = torch.mean(y, dim=-1, keepdim=True)
    num = torch.sum((x - mx) * (y - my), dim=-1)
    den = torch.sqrt(torch.sum((x - mx) ** 2, dim=-1) * torch.sum((y - my) ** 2, dim=-1))
    return torch.where(den < _EPS, 0.0, num / torch.clamp_min(den, _EPS))


def estimate_key(chromagram: torch.Tensor) -> Tuple[str, str]:
    """EstimateKey (chroma_stft.go:240-278): (root label, "major" or
    "minor") of one chromagram [T, 12]; the first of equal correlations
    wins, as `jnp.argmax`."""
    corr = key_correlations(torch.mean(chromagram, dim=-2))
    best = int(torch.argmax(corr))
    return CHROMA_LABELS[best % 12], ("major" if best < 12 else "minor")


# ---------------------------------------------------------------------
# Chroma-CQT
# ---------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def cqt_kernels(
    sample_rate: int,
    min_freq: float = 32.7,   # C1
    max_freq: float = 3951.1,  # B7
    bins_per_octave: int = 12,
    q_factor: float = 17.0,
    max_kernel_len: int = 8192,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Time-domain CQT kernels (chroma_cqt.go:95-146): (kernels_real
    [K, L], kernels_imag [K, L], L), L the common zero-padded length (a
    power of two). Kernel k has length q sr / f_k (at most
    max_kernel_len), a Gaussian window of sigma = sr / (2 pi f_k / Q)
    normalized to unit sum, and a complex exponential at f_k. Float64,
    cast once to float32: bit-equal to the JAX package's tables."""
    num_octaves = np.log2(max_freq / min_freq)
    total_bins = int(num_octaves * bins_per_octave)
    freqs = min_freq * 2.0 ** (np.arange(total_bins) / bins_per_octave)
    lengths = np.minimum((q_factor * sample_rate / freqs).astype(int), max_kernel_len)
    L = 1
    while L < lengths.max():
        L <<= 1
    kr = np.zeros((total_bins, L), dtype=np.float32)
    ki = np.zeros((total_bins, L), dtype=np.float32)
    for k, (f, ln) in enumerate(zip(freqs, lengths)):
        t = np.arange(ln, dtype=np.float64) - ln / 2
        sigma = sample_rate / (2.0 * np.pi * (f / q_factor))
        window = np.exp(-(t * t) / (2.0 * sigma * sigma))
        phase = 2.0 * np.pi * f * t / sample_rate
        # normalize kernel energy so octaves contribute comparably
        window /= window.sum() + 1e-12
        kr[k, :ln] = (window * np.cos(phase)).astype(np.float32)
        ki[k, :ln] = (window * np.sin(phase)).astype(np.float32)
    kr.setflags(write=False)
    ki.setflags(write=False)
    return kr, ki, L


def _cqt_table(which: int, *args) -> np.ndarray:
    return cqt_kernels(*args)[which]


@functools.lru_cache(maxsize=8)
def _cqt_fold_matrix(k_bins: int, bins_per_octave: int) -> np.ndarray:
    """[12, K] 0/1 octave fold of the CQT bins (chroma_cqt.go:213-244)."""
    fold = np.zeros((12, k_bins), dtype=np.float32)
    for k in range(k_bins):
        fold[(k % bins_per_octave) * 12 // bins_per_octave, k] = 1.0
    fold.setflags(write=False)
    return fold


# framed samples one product takes at once: 2^28 float32 (1 GiB); at
# B=128 x 30 s (T = 2,568 frames of L = 8,192) the frames would be
# 10.8 GB if materialized together
CQT_CHUNK_ELEMENTS = 1 << 28


def chroma_cqt(
    signal: torch.Tensor,
    sample_rate: int,
    hop_size: int = 512,
    min_freq: float = 32.7,
    max_freq: float = 3951.1,
    bins_per_octave: int = 12,
    q_factor: float = 17.0,
) -> torch.Tensor:
    """ChromaCQT.ComputeChroma (chroma_cqt.go:69-93): CQT magnitudes
    folded across octaves to [..., T, 12], unit-sum normalized. A signal
    shorter than the kernels is zero-padded to L. The framed products run
    over chunks of rows (CQT_CHUNK_ELEMENTS framed samples each); a CUDA
    input with TF32 matmuls on raises."""
    require_fp32_matmuls(signal, "chroma_cqt")
    args = (sample_rate, min_freq, max_freq, bins_per_octave, q_factor)
    L = cqt_kernels(*args)[2]
    dev = signal.device
    kr = device_table(_cqt_table, (0,) + args, dev)
    ki = device_table(_cqt_table, (1,) + args, dev)
    fold = device_table(_cqt_fold_matrix, (kr.shape[0], bins_per_octave), dev)

    x = signal.to(torch.float32)
    n = x.shape[-1]
    if n < L:
        x = torch.nn.functional.pad(x, (0, L - n))
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1])
    t = (rows.shape[-1] - L) // hop_size + 1
    step = max(CQT_CHUNK_ELEMENTS // (t * L), 1)
    energy = []
    for r0 in range(0, rows.shape[0], step):
        frames = frame_signal(rows[r0: r0 + step], L, hop_size)  # [b, T, L]
        re = torch.matmul(frames, kr.T)
        im = torch.matmul(frames, ki.T)
        mag = torch.sqrt(re * re + im * im)  # [b, T, K]
        energy.append(torch.matmul(mag * mag, fold.T))
    chroma = torch.cat(energy).reshape(lead + (t, 12))
    total = torch.sum(chroma, dim=-1, keepdim=True)
    return torch.where(total > _EPS, chroma / torch.clamp_min(total, _EPS), chroma)


# ---------------------------------------------------------------------
# HPCP
# ---------------------------------------------------------------------

def hpcp_from_magnitude(
    magnitude: torch.Tensor,
    sample_rate: int,
    window_size: int,
    size: int = 12,
    reference_freq: float = 440.0,
    window_semitones: float = 1.0,
    min_freq: float = 40.0,
    max_freq: float = 5000.0,
    split_freq: float = 500.0,
    band_preset: bool = True,
    non_linear: bool = False,
    max_shifted: bool = False,
    weight_type: str = "cosine",
    max_peaks: int = 24,
) -> torch.Tensor:
    """HPCP [..., size] from magnitude frames [..., F]
    (hpcp.go:147-204 + ComputeFromSpectrum :205-222).

    Peaks -> pitch class (scaled to `size`) -> cosine-window
    contribution to neighbouring bins with circular wrap -> unit-energy
    normalization. `weight_type`: "cosine", "squared_cosine", or any
    other value for a flat window.
    """
    freqs, mags, _ = detect_spectral_peaks(magnitude, sample_rate, window_size, max_peaks=max_peaks)
    valid = (freqs >= min_freq) & (freqs <= max_freq) & (mags > 0)

    # peak weight: x2 boost below split frequency (hpcp.go:239-252)
    weight = torch.where(freqs < split_freq, mags * 2.0, mags) if band_preset else mags

    # pitch class scaled to HPCP size (hpcp.go:224-237)
    midi = 69.0 + 12.0 * torch.log2(torch.clamp_min(freqs, _EPS) / reference_freq)
    pc = torch.remainder(midi, 12.0) * (size / 12.0)

    window_bins = window_semitones * size / 12.0
    bins = torch.arange(size, dtype=torch.float32, device=freqs.device)
    # circular distance from each peak's pc to each bin: [..., K, size]
    dist = torch.abs(bins - pc[..., :, None])
    dist = torch.minimum(dist, size - dist)
    if weight_type in ("cosine", "squared_cosine"):
        wwin = torch.clamp_min(torch.cos(math.pi * dist / max(window_bins, _EPS)), 0.0)
        if weight_type == "squared_cosine":
            wwin = wwin * wwin
    else:
        wwin = torch.ones_like(dist)
    wwin = torch.where(dist <= window_bins / 2.0, wwin, 0.0)

    contrib = torch.where(valid[..., :, None], weight[..., :, None] * wwin, 0.0)
    hpcp = torch.sum(contrib, dim=-2)  # [..., size]

    if non_linear:
        hpcp = torch.where(hpcp > 0, torch.log1p(hpcp), hpcp)

    # unit-energy normalization (common.Normalizer Energy)
    norm = torch.sqrt(torch.sum(hpcp * hpcp, dim=-1, keepdim=True))
    hpcp = torch.where(norm > _EPS, hpcp / torch.clamp_min(norm, _EPS), hpcp)

    if max_shifted:
        # best circular shift by self-correlation against the unshifted
        # profile (hpcp.go:339-374)
        corrs = torch.stack(
            [torch.sum(hpcp * torch.roll(hpcp, s, dims=-1), dim=-1) for s in range(size)], dim=-1)
        best = torch.argmax(corrs, dim=-1)
        idx = (torch.arange(size, device=hpcp.device) - best[..., None]) % size
        hpcp = torch.gather(hpcp, -1, idx)
    return hpcp


def hpcp_entropy(hpcp: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the normalized profile (hpcp.go:385-406)."""
    total = torch.sum(hpcp, dim=-1, keepdim=True)
    p = torch.where(total > 0, hpcp / torch.clamp_min(total, _EPS), 0.0)
    return torch.sum(torch.where(p > 0, -p * torch.log2(torch.clamp_min(p, _EPS)), 0.0), dim=-1)
