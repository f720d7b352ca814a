"""Frame-parallel spectral descriptors over magnitude spectrograms
(counterpart of `sonido_sonar_tpu/ops/spectral.py`: the standalone
descriptors, the contrast, ZCR and the shared-pass bundle).

Reference parity: algorithms/spectral/*.go — centroid, rolloff,
bandwidth, flatness (threshold 1e-10), crest, slope (log-log masked
regression), contrast (spectral_contrast.go:26-188: log-spaced bands
from 200 Hz, top/bottom 20% power means, dB), zero-crossing rate
(zero_crossing_rate.go:37-110).

Frequency axis convention (reference): freqs[i] = i * nyquist / (F - 1).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from sonido_sonar_tpu_torch.ops import hopper_contrast
from sonido_sonar_tpu_torch.ops.tables import device_table

_EPS = 1e-10
_INV_LN10 = 0.43429448190325176


def _freq_bins(num_bins: int, sample_rate: int) -> np.ndarray:
    nyquist = sample_rate / 2.0
    return (np.arange(num_bins, dtype=np.float64) * nyquist / (num_bins - 1)).astype(
        np.float32
    )


def spectral_centroid(magnitude: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """Magnitude-weighted mean frequency, [..., F] -> [...]
    (spectral_centroid.go:18-56)."""
    freqs = device_table(_freq_bins, (magnitude.shape[-1], sample_rate), magnitude.device)
    num = torch.sum(magnitude * freqs, dim=-1)
    den = torch.sum(magnitude, dim=-1)
    return torch.where(den > 0, num / torch.clamp_min(den, _EPS), 0.0)


def spectral_rolloff(
    magnitude: torch.Tensor, sample_rate: int, threshold: float = 0.85
) -> torch.Tensor:
    """Frequency of the first bin whose power prefix sum reaches
    `threshold` of the total (spectral_rolloff.go:19-56); 0 where the
    total is 0."""
    freqs = device_table(_freq_bins, (magnitude.shape[-1], sample_rate), magnitude.device)
    power = magnitude * magnitude
    total = torch.sum(power, dim=-1, keepdim=True)
    reached = torch.cumsum(power, dim=-1) >= threshold * total
    idx = torch.argmax(reached.to(torch.uint8), dim=-1)
    return torch.where(total[..., 0] > 0, freqs[idx], 0.0)


def spectral_bandwidth(
    magnitude: torch.Tensor, sample_rate: int, centroid: torch.Tensor | None = None
) -> torch.Tensor:
    """Magnitude-weighted std around the centroid (spectral_bandwidth.go:22-47)."""
    freqs = device_table(_freq_bins, (magnitude.shape[-1], sample_rate), magnitude.device)
    if centroid is None:
        centroid = spectral_centroid(magnitude, sample_rate)
    diff = freqs - centroid[..., None]
    num = torch.sum(diff * diff * magnitude, dim=-1)
    den = torch.sum(magnitude, dim=-1)
    return torch.where(den > 0, torch.sqrt(num / torch.clamp_min(den, _EPS)), 0.0)


def spectral_flatness(magnitude: torch.Tensor, min_threshold: float = _EPS) -> torch.Tensor:
    """Wiener entropy: geometric over arithmetic mean, the geometric mean
    over bins above `min_threshold` only (spectral_flatness.go:31-75)."""
    valid = magnitude > min_threshold
    count = torch.sum(valid, dim=-1)
    log_sum = torch.sum(
        torch.where(valid, torch.log(torch.clamp_min(magnitude, min_threshold)), 0.0), dim=-1)
    geo = torch.exp(log_sum / torch.clamp_min(count, 1))
    arith = torch.mean(magnitude, dim=-1)
    return torch.where(
        (count > 0) & (arith > min_threshold), geo / torch.clamp_min(arith, _EPS), 0.0)


def spectral_flatness_db(magnitude: torch.Tensor) -> torch.Tensor:
    """dB variant (spectral_flatness.go:78-92)."""
    return 10.0 * torch.log10(torch.clamp_min(spectral_flatness(magnitude), _EPS))


def spectral_crest(magnitude: torch.Tensor) -> torch.Tensor:
    """Peak over RMS (spectral_crest.go:18-39)."""
    peak = torch.amax(magnitude, dim=-1)
    rms = torch.sqrt(torch.mean(magnitude * magnitude, dim=-1))
    return torch.where(rms > 0, peak / torch.clamp_min(rms, _EPS), 0.0)


def spectral_slope(magnitude: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """Linear-regression slope of log10(mag) against log10(freq)
    (spectral_slope.go:24-82), over bins with mag > 1e-10 and f > 0."""
    freqs = device_table(_freq_bins, (magnitude.shape[-1], sample_rate), magnitude.device)
    valid = (magnitude > _EPS) & (freqs > 0)
    x = torch.where(valid, torch.log10(torch.clamp_min(freqs, _EPS)), 0.0)
    y = torch.where(valid, torch.log10(torch.clamp_min(magnitude, _EPS)), 0.0)
    n = torch.sum(valid, dim=-1).to(torch.float32)
    sum_x = torch.sum(x, dim=-1)
    sum_y = torch.sum(y, dim=-1)
    sum_xy = torch.sum(x * y, dim=-1)
    sum_xx = torch.sum(x * x, dim=-1)
    den = n * sum_xx - sum_x * sum_x
    den_ok = torch.abs(den) > _EPS
    return torch.where(
        (n >= 2) & den_ok, (n * sum_xy - sum_x * sum_y) / torch.where(den_ok, den, 1.0), 0.0)


@functools.lru_cache(maxsize=32)
def contrast_band_edges(
    num_bands: int, num_bins: int, sample_rate: int
) -> Tuple[int, ...]:
    """Log-spaced band edges in bin units (spectral_contrast.go:139-188):
    log10-spaced from 200 Hz to Nyquist, bin = int(f*(numBins-1)/nyquist),
    forced strictly increasing."""
    nyquist = sample_rate / 2.0
    min_freq = 200.0
    max_freq = nyquist if nyquist > min_freq else min_freq * 2
    log_min, log_max = np.log10(min_freq), np.log10(max_freq)
    edges = []
    for i in range(num_bands + 1):
        f = 10.0 ** (log_min + i * (log_max - log_min) / num_bands)
        b = int(f * (num_bins - 1) / nyquist)
        edges.append(min(max(b, 0), num_bins - 1))
    for i in range(1, num_bands + 1):
        if edges[i] <= edges[i - 1]:
            edges[i] = edges[i - 1] + 1
    return tuple(edges)


def spectral_contrast(
    magnitude: torch.Tensor, sample_rate: int, num_bands: int = 6
) -> torch.Tensor:
    """Per-band peak-vs-valley contrast in dB, float32 [..., F] -> float32
    [..., num_bands]; any other dtype raises.

    Per band: peak = mean of the top k powers, valley = mean of the bottom
    k, k = max(int(0.2 * width), 1), taken by K9
    (`ops/hopper_contrast.band_select_means_hopper`: the kernel on a CUDA
    tensor, one sort per band on a CPU tensor); the valley is floored at
    1e-10 and contrast is 0 where the peak is <= 0, so a degenerate band
    gives 0 (spectral_contrast.go:71-137).
    """
    if magnitude.dtype != torch.float32:
        raise ValueError(f"spectral_contrast needs float32 magnitudes, got {magnitude.dtype}")
    edges = contrast_band_edges(num_bands, magnitude.shape[-1], sample_rate)
    peak, valley = hopper_contrast.band_select_means_hopper(magnitude.contiguous(), edges)
    valley = torch.clamp_min(valley, _EPS)
    return torch.where(peak > 0, 10.0 * torch.log10(peak / valley), 0.0)


def zero_crossings(frames: torch.Tensor) -> torch.Tensor:
    """Count of sign changes per frame, [..., W] -> [...] (a change is a
    flip of (x >= 0) between neighbours, zero_crossing_rate.go:42-48)."""
    nonneg = frames >= 0
    changes = nonneg[..., 1:] != nonneg[..., :-1]
    return torch.sum(changes, dim=-1).to(torch.float32)


def per_second(counts: torch.Tensor, window_size: int, sample_rate: int) -> torch.Tensor:
    """Counts per frame of `window_size` samples -> per second, as
    counts * fl32(1 / fl32(W / sr)): one float32 reciprocal, computed
    once, on every device. That is what JAX's jitted division by the
    constant W / sr computes (XLA multiplies by the constant's float32
    reciprocal), and what PyTorch's CUDA division by a scalar computes;
    PyTorch's CPU division rounds once and differs from both by an ulp
    on some frames (at 16 kHz, 161 / 0.064 gives 2515.625 against
    2515.6248)."""
    inv = np.float32(1.0) / np.float32(window_size / float(sample_rate))
    return counts * float(inv)  # a float32 value: exact as a scalar on every device


def zcr(frames: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """Crossings per second (zero_crossing_rate.go:37-53)."""
    return per_second(zero_crossings(frames), frames.shape[-1], sample_rate)


def zcr_from_signal(
    signal: torch.Tensor, window_size: int, hop_size: int, sample_rate: int
) -> torch.Tensor:
    """`zcr` over the frames of `signal` without the [..., T, W] frames
    tensor: frame j counts the changes between samples i and i+1 for i
    in [j*hop, j*hop + W - 1), read off an integer prefix sum (exact)."""
    from sonido_sonar_tpu_torch.ops.framing import num_frames

    t = num_frames(signal.shape[-1], window_size, hop_size)
    nonneg = signal >= 0
    changes = (nonneg[..., 1:] != nonneg[..., :-1]).to(torch.int32)
    cs = torch.nn.functional.pad(torch.cumsum(changes, dim=-1, dtype=torch.int32), (1, 0))
    starts = torch.arange(t, device=signal.device) * hop_size
    counts = cs[..., starts + window_size - 1] - cs[..., starts]
    return per_second(counts.to(torch.float32), window_size, sample_rate)


def _frame_descriptors(
    magnitude: torch.Tensor, sample_rate: int
) -> Tuple[dict, torch.Tensor, torch.Tensor]:
    """(centroid, bandwidth, flatness, crest and slope of each frame,
    the power, the frame's power sum) over [..., T, F] magnitudes, with the same
    expressions and masks as the JAX bundle (spectral.py:510-577);
    bandwidth takes the bundle's second pass over (f - centroid)^2 m."""
    m = magnitude
    n_bins = m.shape[-1]
    freqs = device_table(_freq_bins, (n_bins, sample_rate), m.device)
    power = m * m

    m_sum = torch.sum(m, dim=-1)
    fm_sum = torch.sum(m * freqs, dim=-1)
    m_max = torch.amax(m, dim=-1)
    p_sum = torch.sum(power, dim=-1)
    log_m = torch.log(torch.clamp_min(m, _EPS))
    # flatness: geometric mean over bins above the threshold only
    valid_f = m > _EPS
    count_f = torch.sum(valid_f, dim=-1)
    log_sum = torch.sum(torch.where(valid_f, log_m, 0.0), dim=-1)
    # slope: log-log regression masked to mag > eps and f > 0
    logf = torch.where(freqs > 0, torch.log10(torch.clamp_min(freqs, _EPS)), 0.0)
    valid_s = valid_f & (freqs > 0)
    y = torch.where(valid_s, log_m * _INV_LN10, 0.0)
    n_s = torch.sum(valid_s, dim=-1).to(torch.float32)
    sum_x = torch.sum(torch.where(valid_s, logf, 0.0), dim=-1)
    sum_y = torch.sum(y, dim=-1)
    sum_xy = torch.sum(y * logf, dim=-1)
    sum_xx = torch.sum(torch.where(valid_s, logf * logf, 0.0), dim=-1)

    centroid = torch.where(m_sum > 0, fm_sum / torch.clamp_min(m_sum, _EPS), 0.0)
    arith = m_sum / n_bins
    geo = torch.exp(log_sum / torch.clamp_min(count_f, 1))
    flatness = torch.where(
        (count_f > 0) & (arith > _EPS), geo / torch.clamp_min(arith, _EPS), 0.0
    )
    rms = torch.sqrt(p_sum / n_bins)
    crest = torch.where(rms > 0, m_max / torch.clamp_min(rms, _EPS), 0.0)
    den_s = n_s * sum_xx - sum_x * sum_x
    den_ok = torch.abs(den_s) > _EPS
    slope = torch.where(
        (n_s >= 2) & den_ok,
        (n_s * sum_xy - sum_x * sum_y) / torch.where(den_ok, den_s, 1.0),
        0.0,
    )

    diff = freqs - centroid[..., None]
    bw_num = torch.sum(diff * diff * m, dim=-1)
    bandwidth = torch.where(
        m_sum > 0, torch.sqrt(bw_num / torch.clamp_min(m_sum, _EPS)), 0.0
    )
    out = {
        "spectral_centroid": centroid,
        "spectral_bandwidth": bandwidth,
        "spectral_flatness": flatness,
        "spectral_crest": crest,
        "spectral_slope": slope,
    }
    return out, power, p_sum


def frame_descriptors(magnitude: torch.Tensor, sample_rate: int) -> dict:
    """Centroid, bandwidth, flatness, crest and slope of each frame of
    [..., T, F] magnitudes: the descriptor bundle without flux and rolloff."""
    return _frame_descriptors(magnitude, sample_rate)[0]


def spectral_descriptor_bundle(
    magnitude: torch.Tensor,
    sample_rate: int,
    rolloff_threshold: float = 0.85,
    skip_rolloff: bool = False,
) -> dict:
    """Centroid, rolloff, bandwidth, flatness, crest, slope and flux
    from shared passes over [..., T, F] magnitudes, with the same
    expressions and masks as the JAX bundle. `skip_rolloff=True` leaves
    rolloff out, for callers that take it from the K1 kernel's epilogue."""
    from sonido_sonar_tpu_torch.ops.stft import spectral_flux

    m = magnitude
    out, power, p_sum = _frame_descriptors(m, sample_rate)
    out["spectral_flux"] = spectral_flux(m)
    if not skip_rolloff:
        freqs = device_table(_freq_bins, (m.shape[-1], sample_rate), m.device)
        reached = torch.cumsum(power, dim=-1) >= rolloff_threshold * p_sum[..., None]
        idx = torch.argmax(reached.to(torch.uint8), dim=-1)
        out["spectral_rolloff"] = torch.where(p_sum > 0, freqs[idx], 0.0)
    return out


def descriptors_from_feat(feat: torch.Tensor) -> dict:
    """The descriptor bundle's centroid, bandwidth, flatness, crest and
    slope from the K10 feature-epilogue lanes ([..., T, 43] laid out per
    `ops.hopper_stft.FEAT_LANES`; JAX `spectral.py:621-636`): the kernel
    finished them, so this slices the lanes out."""
    from sonido_sonar_tpu_torch.ops.hopper_stft import FEAT_LANES

    return {k: feat[..., idx] for k, idx in FEAT_LANES.items() if isinstance(idx, int)}


def band_limited_flatness(
    magnitude: torch.Tensor,
    sample_rate: int,
    low_hz: float,
    high_hz: float,
) -> torch.Tensor:
    """Flatness over a static frequency band (spectral_flatness.go:95-135)."""
    freqs = _freq_bins(magnitude.shape[-1], sample_rate)
    lo = int(np.searchsorted(freqs, low_hz, side="left"))
    hi = int(np.searchsorted(freqs, high_hz, side="right"))
    hi = max(hi, lo + 1)
    return spectral_flatness(magnitude[..., lo:hi])


def speech_band_flatness(magnitude: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """300-3400 Hz speech band (spectral_flatness.go:138-150)."""
    return band_limited_flatness(magnitude, sample_rate, 300.0, 3400.0)


def spectral_contrast_custom_bands(
    magnitude: torch.Tensor, sample_rate: int, band_freqs_hz: tuple
) -> torch.Tensor:
    """ComputeWithCustomBands (spectral_contrast.go:104-137): contrast
    over caller-provided band edge frequencies, each band's power sorted
    (no cell runs it, so K9 is not used here; JAX uses no Pallas kernel
    here either)."""
    n_bins = magnitude.shape[-1]
    nyquist = sample_rate / 2.0
    edges = [
        min(max(int(f * (n_bins - 1) / nyquist), 0), n_bins - 1)
        for f in band_freqs_hz
    ]
    for i in range(1, len(edges)):
        if edges[i] <= edges[i - 1]:
            edges[i] = edges[i - 1] + 1
    power = magnitude * magnitude
    outs = []
    for b in range(len(edges) - 1):
        lo, hi = edges[b], min(edges[b + 1], n_bins)
        if lo >= hi:
            outs.append(magnitude.new_zeros(magnitude.shape[:-1]))
            continue
        width = hi - lo
        k = max(int(0.2 * width), 1)
        sorted_band = torch.sort(power[..., lo:hi], dim=-1).values
        valley = torch.clamp_min(torch.mean(sorted_band[..., :k], dim=-1), _EPS)
        peak = torch.mean(sorted_band[..., width - k:], dim=-1)
        outs.append(torch.where(peak > 0, 10.0 * torch.log10(peak / valley), 0.0))
    return torch.stack(outs, dim=-1)


def zcr_normalized(frames: torch.Tensor) -> torch.Tensor:
    """Crossings / (W-1), range [0,1] (zero_crossing_rate.go:57-76)."""
    w = frames.shape[-1]
    return zero_crossings(frames) / float(max(w - 1, 1))


def zcr_with_threshold(
    frames: torch.Tensor, sample_rate: int, threshold: float
) -> torch.Tensor:
    """Crossings/sec counting only crossings where both samples exceed
    the amplitude threshold (zero_crossing_rate.go:126-143)."""
    strong = (torch.abs(frames[..., 1:]) > threshold) & (torch.abs(frames[..., :-1]) > threshold)
    nonneg = frames >= 0
    changes = (nonneg[..., 1:] != nonneg[..., :-1]) & strong
    counts = torch.sum(changes, dim=-1).to(torch.float32)
    return per_second(counts, frames.shape[-1], sample_rate)


# Voice activity (zero_crossing_rate.go:146-168)
VAD_ENERGY_THRESHOLD = 0.001
VAD_ZCR_LOW = 0.02
VAD_ZCR_HIGH = 0.6


def detect_voice_activity(
    frames: torch.Tensor,
    energy_threshold: float = VAD_ENERGY_THRESHOLD,
    zcr_low: float = VAD_ZCR_LOW,
    zcr_high: float = VAD_ZCR_HIGH,
) -> torch.Tensor:
    """Per-frame VAD (zero_crossing_rate.go:146-168): mean-square energy
    above threshold and normalized ZCR within the speech band."""
    energy = torch.mean(frames * frames, dim=-1)
    zn = zcr_normalized(frames)
    return (energy >= energy_threshold) & (zn >= zcr_low) & (zn <= zcr_high)


def detect_speech_segments(
    signal: torch.Tensor,
    frame_size: int,
    hop_size: int,
    energy_threshold: float = VAD_ENERGY_THRESHOLD,
    zcr_low: float = VAD_ZCR_LOW,
    zcr_high: float = VAD_ZCR_HIGH,
    min_segment_samples: int = 0,
):
    """Speech segments of a 1-D signal as (starts, ends) sample-index
    arrays (zero_crossing_rate.go:170-224): the VAD on the signal's
    device, the run-length extraction on the host."""
    from sonido_sonar_tpu_torch.ops.framing import frame_signal

    frames = frame_signal(signal, frame_size, hop_size)
    voice = detect_voice_activity(frames, energy_threshold, zcr_low, zcr_high).cpu().numpy()
    n = int(signal.shape[-1])
    starts, ends = [], []
    cur = -1
    for i, v in enumerate(voice):
        if v and cur == -1:
            cur = i * hop_size
        elif not v and cur != -1:
            end = i * hop_size
            if end - cur >= min_segment_samples:
                starts.append(cur)
                ends.append(end)
            cur = -1
    if cur != -1 and n - cur >= min_segment_samples:
        starts.append(cur)
        ends.append(n)
    return np.asarray(starts), np.asarray(ends)


def classify_frame_type(frames: torch.Tensor) -> torch.Tensor:
    """Frame class codes (zero_crossing_rate.go:227-244):
    0=silence (energy < 0.001), 1=voiced (zcr<0.1), 2=mixed (<0.4),
    3=unvoiced (<0.7), 4=noise."""
    energy = torch.mean(frames * frames, dim=-1)
    zn = zcr_normalized(frames)
    cls = torch.where(zn < 0.1, 1, torch.where(zn < 0.4, 2, torch.where(zn < 0.7, 3, 4)))
    return torch.where(energy < 0.001, 0, cls).to(torch.int32)
