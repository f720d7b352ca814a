"""Temporal (time-domain) features (counterpart of
`sonido_sonar_tpu/ops/temporal.py`).

Reference parity: algorithms/temporal/*.go — energy.go (short-time RMS,
variance, loudness range), envelope.go, onset_detection.go (flux and
energy peak picking, min-interval thinning, combineOnsets),
silence_detection.go, tempo_estimation.go (interval histogram),
dynamic_range.go. Variable-length results are (mask, count) pairs over
the frame axis, as in the JAX package.

The min-interval thinning of `detect_onsets_from_flux` is the K4 kernel
(`ops/hopper_onsets.py`); everything else is plain PyTorch.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from sonido_sonar_tpu_torch.ops.framing import frame_signal, num_frames

_EPS = 1e-10
# quantized tempo bins of findTempoFromIntervals (tempo_estimation.go:82)
_TEMPO_RANGE = (60.0, 70.0, 80.0, 90.0, 100.0, 110.0, 120.0, 130.0,
                140.0, 150.0, 160.0, 170.0, 180.0, 200.0)
_BIG = 2**30


# ---------------------------------------------------------------------
# Framed sums (no [..., T, W] frames tensor)
# ---------------------------------------------------------------------

def framed_sum_hopblocks(
    values: torch.Tensor, frame_size: int, hop_size: int, t: int
) -> torch.Tensor:
    """Per-frame sums of `values` at (frame_size, hop_size), [..., N] ->
    [..., t], as k = frame/hop consecutive hop-block sums. Requires
    hop_size | frame_size. The float32 error stays O(frame_size) whatever
    the signal length."""
    if frame_size % hop_size != 0:
        raise ValueError("framed_sum_hopblocks requires hop_size | frame_size")
    k = frame_size // hop_size
    nb = t - 1 + k
    need = nb * hop_size
    v = values.to(torch.float32)
    if need > v.shape[-1]:
        v = F.pad(v, (0, need - v.shape[-1]))
    bs = v[..., :need].reshape(v.shape[:-1] + (nb, hop_size)).sum(dim=-1)
    tot = bs[..., :t]
    for i in range(1, k):
        tot = tot + bs[..., i: i + t]
    return tot


def framed_max_hopblocks(
    values: torch.Tensor, frame_size: int, hop_size: int, t: int
) -> torch.Tensor:
    """Per-frame maxes as hop-block maxes; exact. Requires hop | frame."""
    if frame_size % hop_size != 0:
        raise ValueError("framed_max_hopblocks requires hop_size | frame_size")
    k = frame_size // hop_size
    nb = t - 1 + k
    bm = values[..., : nb * hop_size].reshape(values.shape[:-1] + (nb, hop_size)).amax(dim=-1)
    tot = bm[..., :t]
    for i in range(1, k):
        tot = torch.maximum(tot, bm[..., i: i + t])
    return tot


def short_time_energy_cumsum(
    signal: torch.Tensor, frame_size: int, hop_size: int
) -> torch.Tensor:
    """RMS per frame, [..., N] -> [..., T] (energy.go:25-50): hop-block
    sums of squares when hop | frame, the frames themselves otherwise
    (the JAX package's boundary prefix sums only reorder the same sum)."""
    if frame_size % hop_size != 0:
        frames = frame_signal(signal.to(torch.float32), frame_size, hop_size)
        return torch.sqrt(torch.mean(frames * frames, dim=-1))
    t = num_frames(signal.shape[-1], frame_size, hop_size)
    tot = framed_sum_hopblocks(signal.to(torch.float32) ** 2, frame_size, hop_size, t)
    return torch.sqrt(torch.clamp_min(tot, 0.0) / frame_size)


def short_time_energy(
    signal: torch.Tensor, frame_size: int, hop_size: int
) -> torch.Tensor:
    """Per-frame RMS energy, [..., N] -> [..., T] (energy.go:25-50)."""
    return short_time_energy_cumsum(signal, frame_size, hop_size)


def log_energy(
    signal: torch.Tensor, frame_size: int, hop_size: int, floor: float = _EPS
) -> torch.Tensor:
    """20 log10(max(rms, floor)) dB (energy.go:53-66)."""
    return 20.0 * torch.log10(torch.clamp_min(short_time_energy(signal, frame_size, hop_size), floor))


def energy_entropy(energies: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (log2) of the energy distribution over frames,
    [..., T] -> [...] (energy.go:69-94)."""
    total = torch.sum(energies, dim=-1, keepdim=True)
    p = torch.where(total > 0, energies / torch.clamp_min(total, _EPS), 0.0)
    terms = torch.where(p > 0, -p * torch.log2(torch.clamp_min(p, _EPS)), 0.0)
    return torch.sum(terms, dim=-1)


def energy_variance(energies: torch.Tensor) -> torch.Tensor:
    """Sample variance (N-1 denominator), [..., T] -> [...]
    (energy.go:97-119)."""
    t = energies.shape[-1]
    if t < 2:
        return energies.new_zeros(energies.shape[:-1])
    mean = torch.mean(energies, dim=-1, keepdim=True)
    return torch.sum((energies - mean) ** 2, dim=-1) / (t - 1)


def energy_derivative(energies: torch.Tensor) -> torch.Tensor:
    """First difference, [..., T] -> [..., T-1] (energy.go:122-134)."""
    return energies[..., 1:] - energies[..., :-1]


def energy_ratio(e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """Elementwise ratio, 0 where the denominator is <= 1e-10
    (energy.go:136-155)."""
    return torch.where(e2 > _EPS, e1 / torch.clamp_min(e2, _EPS), 0.0)


def loudness_range(signal: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """EBU-R128-style loudness range in LU (energy.go:157-225): 400 ms
    windows, 25 % hop, loudness -0.691 + 10 log10(rms^2), p95 - p10 by
    sorted index (the JAX package's EBU reading of the reference)."""
    window = int(0.4 * sample_rate)
    hop = max(window // 4, 1)
    if signal.shape[-1] < window:
        return signal.new_zeros(signal.shape[:-1], dtype=torch.float32)
    rms = short_time_energy_cumsum(signal, window, hop)
    loud = torch.where(
        rms > 0, -0.691 + 10.0 * torch.log10(torch.clamp_min(rms * rms, _EPS)), -70.0
    )
    t = loud.shape[-1]
    s = torch.sort(loud, dim=-1).values
    return s[..., int(0.95 * (t - 1))] - s[..., int(0.10 * (t - 1))]


def percentile_range_db(values: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """20 log10(v_hi / v_lo) over sorted values with floor-index
    percentiles (energy.go:199-225)."""
    t = values.shape[-1]
    s = torch.sort(values, dim=-1).values
    lo_v = torch.clamp_min(s[..., int(lo * (t - 1))], _EPS)
    hi_v = s[..., int(hi * (t - 1))]
    return torch.where(hi_v > 0, 20.0 * torch.log10(hi_v / lo_v), 0.0)


def rms_envelope(
    signal: torch.Tensor, window_size: int = 512, hop_size: int = 256
) -> torch.Tensor:
    """Sliding-window RMS envelope (envelope.go ComputeRMS)."""
    return short_time_energy(signal, window_size, hop_size)


# ---------------------------------------------------------------------
# Onsets (onset_detection.go:26-225)
# ---------------------------------------------------------------------

def adaptive_threshold(values: torch.Tensor) -> torch.Tensor:
    """mean + 2*std (population), [..., T] -> [...]."""
    return torch.mean(values, dim=-1) + 2.0 * torch.std(values, dim=-1, correction=0)


def _interior_peaks(v: torch.Tensor, above: torch.Tensor) -> torch.Tensor:
    """Local maxima over interior frames where `above`, padded with
    False at both ends."""
    inner = (v[..., 1:-1] > v[..., :-2]) & (v[..., 1:-1] > v[..., 2:]) & above
    return F.pad(inner, (1, 1))


def flux_onset_candidates(
    flux: torch.Tensor, threshold: float = 0.3, relative: bool = True
) -> torch.Tensor:
    """Onset candidates before thinning: interior local maxima of `flux`
    at or above the threshold (relative: times max(flux)), [..., T] bool."""
    thr = threshold * torch.amax(flux, dim=-1, keepdim=True) if relative else threshold
    return _interior_peaks(flux, flux[..., 1:-1] >= thr)


def detect_onsets_from_flux(
    flux: torch.Tensor,
    hop_size: int,
    sample_rate: int,
    threshold: float = 0.3,
    min_interval_sec: float = 0.05,
    relative: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectral-flux peak picking -> (onset mask [..., T], count [...])
    (onset_detection.go:26-120): `flux_onset_candidates` thinned to
    `min_interval_sec` by the K4 kernel."""
    from sonido_sonar_tpu_torch.ops.hopper_onsets import thin_onsets_hopper

    cand = flux_onset_candidates(flux, threshold, relative)
    min_frames = max(int(min_interval_sec * sample_rate / hop_size), 1)
    mask = thin_onsets_hopper(cand.contiguous(), min_frames)
    return mask, torch.sum(mask, dim=-1)


def detect_onsets_from_energy(energies: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Energy-derivative onsets (speech.go:672-716): local maxima of the
    first difference above mean + 2*std. Mask over derivative index
    [..., T-1]; index i is energy frame i+1."""
    deriv = energy_derivative(energies)
    thr = adaptive_threshold(deriv)[..., None]
    mask = _interior_peaks(deriv, deriv[..., 1:-1] > thr)
    return mask, torch.sum(mask, dim=-1)


def attack_times_from_onsets(
    onset_mask: torch.Tensor,
    energies: torch.Tensor,
    hop_size: int,
    sample_rate: int,
    lookback: int = 10,
) -> torch.Tensor:
    """Per-frame attack time (s) where onset_mask is set, else 0
    (speech.go:744-775): look back <= `lookback` frames for energy under
    10 % of the onset's; attack = (onset - start) * hop/sr, at most 0.1 s."""
    t = energies.shape[-1]
    m = onset_mask.shape[-1]
    dev = energies.device
    i = torch.clamp(torch.arange(m, device=dev), max=t - 1)             # [m]
    js = i[:, None] - 1 - torch.arange(lookback, device=dev)[None, :]   # [m, L]
    peak = energies[..., i]                                             # [..., m]
    vals = torch.where(js >= 0, energies[..., torch.clamp(js, 0, t - 1)], float("inf"))
    below = vals < 0.1 * peak[..., None]
    first = torch.argmax(below.to(torch.uint8), dim=-1)
    start = torch.where(torch.any(below, dim=-1), i - 1 - first, i)
    at = torch.clamp_max((i - start) * (hop_size / float(sample_rate)), 0.1)
    return torch.where(onset_mask, at, 0.0)


# ---------------------------------------------------------------------
# Silence (silence_detection.go) and pauses (speech.go:585-668)
# ---------------------------------------------------------------------

def silence_mask_db(
    signal: torch.Tensor, frame_size: int, hop_size: int, threshold_db: float = -40.0
) -> torch.Tensor:
    """Frames below an absolute dBFS threshold (the JAX package's reading
    of silence_detection.go:20-80)."""
    return log_energy(signal, frame_size, hop_size) < threshold_db


def _tenth_percentile(energies: torch.Tensor) -> torch.Tensor:
    """The sorted value at index T // 10 (no interpolation), [..., 1]."""
    t = energies.shape[-1]
    return torch.sort(energies, dim=-1).values[..., t // 10: t // 10 + 1]


def silence_ratio_percentile(energies: torch.Tensor) -> torch.Tensor:
    """Fraction of frames at/below the 10th-percentile energy."""
    return torch.mean((energies <= _tenth_percentile(energies)).to(torch.float32), dim=-1)


def pause_durations(
    energies: torch.Tensor,
    hop_size: int,
    sample_rate: int,
    max_pauses: int = 64,
    min_pause_sec: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Silence-run durations (s) at/below the 10th-percentile energy,
    longer than `min_pause_sec` (speech.go:585-640): (durations
    [..., max_pauses], count [...] int32), in order of occurrence."""
    t = energies.shape[-1]
    silent = energies <= _tenth_percentile(energies)
    idx = torch.arange(t, device=energies.device)
    last_sound = torch.cummax(torch.where(silent, -1, idx), dim=-1).values
    run_len = torch.where(silent, idx - last_sound, 0)
    is_end = silent & torch.cat([~silent[..., 1:], torch.ones_like(silent[..., :1])], dim=-1)
    dur = run_len.to(torch.float32) * (hop_size / float(sample_rate))
    keep = is_end & (dur > min_pause_sec)
    rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    onehot = keep[..., None] & (rank[..., None] == torch.arange(max_pauses, device=energies.device))
    durs = torch.sum(torch.where(onehot, dur[..., None], 0.0), dim=-2)
    counts = torch.clamp_max(torch.sum(keep, dim=-1), max_pauses).to(torch.int32)
    return durs, counts


# ---------------------------------------------------------------------
# Dynamic range (dynamic_range.go:21-168)
# ---------------------------------------------------------------------

def dynamic_range_db(
    signal: torch.Tensor,
    frame_size: int = 2048,
    hop_size: int = 512,
    low_pct: float = 0.10,
    high_pct: float = 0.95,
) -> torch.Tensor:
    """Percentile range of frame RMS in dB (dynamic_range.go:21-80, with
    the JAX package's valid percentile fractions)."""
    return percentile_range_db(short_time_energy(signal, frame_size, hop_size), low_pct, high_pct)


def crest_factor_frames(signal: torch.Tensor, frame_size: int, hop_size: int) -> torch.Tensor:
    """Per-frame peak/RMS (dynamic_range.go:113-140)."""
    x = signal.to(torch.float32)
    if frame_size % hop_size == 0:
        t = num_frames(x.shape[-1], frame_size, hop_size)
        peak = framed_max_hopblocks(torch.abs(x), frame_size, hop_size, t)
        rms = torch.sqrt(
            torch.clamp_min(framed_sum_hopblocks(x * x, frame_size, hop_size, t), 0.0) / frame_size
        )
    else:
        frames = frame_signal(x, frame_size, hop_size)
        peak = torch.amax(torch.abs(frames), dim=-1)
        rms = torch.sqrt(torch.mean(frames * frames, dim=-1))
    return torch.where(rms > 0, peak / torch.clamp_min(rms, _EPS), 0.0)


# ---------------------------------------------------------------------
# Tempo (tempo_estimation.go:22-119)
# ---------------------------------------------------------------------

def onset_positions_from_mask(
    mask: torch.Tensor, hop_size: int, max_onsets: int = 256
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., T] onset mask -> (sorted sample positions [..., K] int32,
    valid [..., K]), positions frame * hop (onset_detection.go:48-55)."""
    t = mask.shape[-1]
    idx = torch.arange(t, dtype=torch.int32, device=mask.device)
    keyed = torch.where(mask, idx * hop_size, _BIG)
    pos = torch.sort(keyed, dim=-1).values[..., :max_onsets]
    valid = pos < _BIG
    return torch.where(valid, pos, 0), valid


def combine_onset_positions(
    pos1: torch.Tensor, valid1: torch.Tensor,
    pos2: torch.Tensor, valid2: torch.Tensor,
    tolerance_samples: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """combineOnsets (onset_detection.go:148-182): merge two sorted
    onset lists and drop any onset within `tolerance_samples` of the last
    kept one — an ascending greedy scan over the merged positions, as
    ordinary tensor ops (it is XLA, not a kernel, in the JAX package)."""
    allpos = torch.cat(
        [torch.where(valid1, pos1, _BIG), torch.where(valid2, pos2, _BIG)], dim=-1
    )
    allpos = torch.sort(allpos, dim=-1).values
    last = torch.full(allpos.shape[:-1], -_BIG, dtype=allpos.dtype, device=allpos.device)
    kept = torch.empty_like(allpos, dtype=torch.bool)
    for i in range(allpos.shape[-1]):
        p = allpos[..., i]
        ok = (p < _BIG) & (p - last > tolerance_samples)
        kept[..., i] = ok
        last = torch.where(ok, p, last)
    pos = torch.sort(torch.where(kept, allpos, _BIG), dim=-1).values
    valid = pos < _BIG
    return torch.where(valid, pos, 0), valid


def tempo_from_intervals(intervals_sec: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """findTempoFromIntervals (tempo_estimation.go:77-119): each interval
    in (0.2 s, 2.0 s) votes for the nearest of 14 tempo bins (within 10
    BPM); the most voted bin wins, the lowest BPM on ties; 120 BPM when
    none votes."""
    bins = torch.tensor(_TEMPO_RANGE, dtype=torch.float32, device=intervals_sec.device)
    iv = intervals_sec.to(torch.float32)
    in_range = valid & (iv > 0.2) & (iv < 2.0)
    tempo = 60.0 / torch.clamp_min(iv, 1e-6)
    diffs = torch.abs(tempo[..., None] - bins)
    best_diff = torch.amin(diffs, dim=-1)
    best_idx = torch.argmin(diffs, dim=-1)  # first minimum on ties
    counted = in_range & (best_diff < 10.0)
    one_hot = counted[..., None] & (best_idx[..., None] == torch.arange(len(_TEMPO_RANGE), device=iv.device))
    counts = torch.sum(one_hot, dim=-2)
    best_bin = torch.argmax(counts, dim=-1)  # first maximum on ties
    return torch.where(torch.amax(counts, dim=-1) > 0, bins[best_bin], 120.0)


def tempo_from_onset_positions(
    positions: torch.Tensor, valid: torch.Tensor, sample_rate: int
) -> torch.Tensor:
    """EstimateTempo core (tempo_estimation.go:22-48): consecutive
    inter-onset intervals -> dominant-interval tempo; 0 BPM with fewer
    than two onsets."""
    n = torch.sum(valid, dim=-1)
    intervals = (positions[..., 1:] - positions[..., :-1]).to(torch.float32) / float(sample_rate)
    k = torch.arange(intervals.shape[-1], device=positions.device)
    bpm = tempo_from_intervals(intervals, k < (n[..., None] - 1))
    return torch.where(n >= 2, bpm, 0.0)


def estimate_tempo(
    signal: torch.Tensor, sample_rate: int, max_onsets: int = 256
) -> torch.Tensor:
    """EstimateTempo (tempo_estimation.go:22-48), [..., N] -> [...] BPM:
    flux onsets (1024/512 magnitudes from the K1 kernel, threshold 0.3)
    merged with energy-derivative onsets (512/256, threshold 0.1), each
    normalized to unit maximum and thinned to 50 ms by K4, deduplicated
    within 50 ms, then the interval histogram."""
    from sonido_sonar_tpu_torch.ops.hopper_stft import stft_magnitude_hopper

    x = signal.to(torch.float32).contiguous()
    min_interval = 0.05
    mag, _ = stft_magnitude_hopper(x, 1024, 512)
    d = mag[..., 1:, :] - mag[..., :-1, :]
    flux = F.pad(torch.sqrt(torch.sum(torch.where(d > 0, d * d, 0.0), dim=-1)), (1, 0))
    flux = flux / torch.clamp_min(torch.amax(flux, dim=-1, keepdim=True), 1e-10)
    m1, _ = detect_onsets_from_flux(flux, 512, sample_rate, 0.3, min_interval, relative=False)
    p1, v1 = onset_positions_from_mask(m1, 512, max_onsets)

    env = short_time_energy(x, 512, 256)
    ediff = F.pad(torch.clamp_min(env[..., 1:] - env[..., :-1], 0.0), (1, 0))
    ediff = ediff / torch.clamp_min(torch.amax(ediff, dim=-1, keepdim=True), 1e-10)
    m2, _ = detect_onsets_from_flux(ediff, 256, sample_rate, 0.1, min_interval, relative=False)
    p2, v2 = onset_positions_from_mask(m2, 256, max_onsets)

    pos, valid = combine_onset_positions(p1, v1, p2, v2, int(min_interval * sample_rate))
    return tempo_from_onset_positions(pos, valid, sample_rate)
