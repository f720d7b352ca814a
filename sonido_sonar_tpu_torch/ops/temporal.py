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

import numpy as np
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


# ---------------------------------------------------------------------
# Peaks, envelopes, tempo by autocorrelation, attack/decay, statistics
# ---------------------------------------------------------------------

def peak_energy(energies: torch.Tensor, threshold: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Local-max peaks above threshold: (peak mask [..., T], count [...])
    (energy.go:228-247). Endpoints are never peaks."""
    mask = _interior_peaks(energies, energies[..., 1:-1] >= threshold)
    return mask, torch.sum(mask, dim=-1)


def peak_envelope(
    signal: torch.Tensor, window_size: int = 512, hop_size: int = 256
) -> torch.Tensor:
    """Per-window max |x| (envelope.go ComputePeak): hop-block maxes when
    hop | window (exact, max is associative), the frames otherwise."""
    x = torch.abs(signal.to(torch.float32))
    if window_size % hop_size == 0:
        t = num_frames(x.shape[-1], window_size, hop_size)
        return framed_max_hopblocks(x, window_size, hop_size, t)
    return torch.amax(frame_signal(x, window_size, hop_size), dim=-1)


def hilbert_envelope(signal: torch.Tensor) -> torch.Tensor:
    """Analytic-signal magnitude |x + j H{x}| via the FFT
    (envelope.go ComputeHilbert)."""
    n = signal.shape[-1]
    spec = torch.fft.fft(signal.to(torch.complex64), dim=-1)
    h = torch.zeros(n, dtype=torch.float32, device=signal.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[1: n // 2] = 2.0
        h[n // 2] = 1.0
    else:
        h[1: (n + 1) // 2] = 2.0
    return torch.abs(torch.fft.ifft(spec * h, dim=-1)).to(torch.float32)


def smooth_envelope(env: torch.Tensor, kernel: int = 5) -> torch.Tensor:
    """Moving average over the last axis, same length, zeros outside:
    `np.convolve(v, ones(k) / k, mode="same")`, whose output n is the
    full convolution's (k - 1) // 2 + n, the mean of
    env[n - k + 1 + (k - 1) // 2 .. n + (k - 1) // 2]. For an even k that
    window is not where `conv1d(padding="same")` puts it (envelope.go
    smoothing)."""
    right = (kernel - 1) // 2
    padded = F.pad(env, (kernel - 1 - right, right))
    return torch.mean(padded.unfold(-1, kernel, 1), dim=-1)


def np_ceil_log2(n: int) -> int:
    k = 0
    while (1 << k) < n:
        k += 1
    return k


def estimate_tempo_autocorrelation(
    onset_strength: torch.Tensor,
    hop_size: int,
    sample_rate: int,
    min_bpm: float = 60.0,
    max_bpm: float = 200.0,
) -> torch.Tensor:
    """BPM from the autocorrelation peak of the onset-strength envelope
    within the BPM-implied lag range (tempo_estimation.go:120-229); the
    first of equal peaks."""
    t = onset_strength.shape[-1]
    x = onset_strength - torch.mean(onset_strength, dim=-1, keepdim=True)
    n_fft = 1 << np_ceil_log2(2 * t)
    spec = torch.fft.rfft(x, n=n_fft, dim=-1)
    ac = torch.fft.irfft(spec * torch.conj(spec), n=n_fft, dim=-1)[..., :t]
    frame_rate = sample_rate / hop_size
    min_lag = max(int(frame_rate * 60.0 / max_bpm), 1)
    max_lag = min(int(frame_rate * 60.0 / min_bpm) + 1, t)
    if min_lag >= max_lag:
        return onset_strength.new_zeros(onset_strength.shape[:-1], dtype=torch.float32)
    best = torch.argmax(ac[..., min_lag:max_lag], dim=-1) + min_lag
    return 60.0 * frame_rate / best.to(torch.float32)


def tempo_category(bpm: torch.Tensor) -> torch.Tensor:
    """0=slow(<90) 1=moderate(<140) 2=fast (tempo_estimation.go category)."""
    return torch.where(bpm < 90.0, 0, torch.where(bpm < 140.0, 1, 2)).to(torch.int32)


def estimate_tempo_range(
    signal: torch.Tensor, sample_rate: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EstimateTempoRange (tempo_estimation.go:204-218): the mean of the
    interval-histogram tempo (`estimate_tempo`, K1 and K4 on the card)
    and the autocorrelation tempo of the 100 ms RMS envelope, and the
    agreement confidence max(0, 1 - |diff|/50): (avg, confidence, diff)."""
    x = signal.to(torch.float32)
    onset_tempo = estimate_tempo(x, sample_rate)
    frame = int(0.1 * sample_rate)
    env = rms_envelope(x, frame, frame // 4)
    ac_tempo = estimate_tempo_autocorrelation(env, frame // 4, sample_rate, min_bpm=60.0, max_bpm=180.0)
    avg = (onset_tempo + ac_tempo) / 2.0
    diff = torch.abs(onset_tempo - ac_tempo)
    confidence = torch.clamp_min(1.0 - diff / 50.0, 0.0)
    return avg, confidence, diff


def attack_time(env: torch.Tensor, frame_rate: float) -> torch.Tensor:
    """Time from 10% to 90% of the global peak on the rising side
    (attack_decay.go:21-80), [..., T] -> [...] seconds: the first frames
    at or before the (first) peak that reach 10 % and 90 % of it."""
    peak_idx = torch.argmax(env, dim=-1, keepdim=True)
    peak = torch.amax(env, dim=-1, keepdim=True)
    before = torch.arange(env.shape[-1], device=env.device) <= peak_idx
    t10 = torch.argmax(((env >= 0.1 * peak) & before).to(torch.uint8), dim=-1)
    t90 = torch.argmax(((env >= 0.9 * peak) & before).to(torch.uint8), dim=-1)
    return torch.clamp_min(t90 - t10, 0).to(torch.float32) / frame_rate


def decay_time(env: torch.Tensor, frame_rate: float) -> torch.Tensor:
    """Time from 90% to 10% of the global peak on the falling side
    (attack_decay.go:83-140)."""
    return attack_time(torch.flip(env, dims=(-1,)), frame_rate)


def transient_ratio(env: torch.Tensor) -> torch.Tensor:
    """Energy in fast-changing parts / total (attack_decay.go:143-167);
    the threshold is mean + std (over N) of the changes."""
    d = torch.abs(env[..., 1:] - env[..., :-1])
    thr = torch.mean(d, dim=-1, keepdim=True) + torch.std(d, dim=-1, keepdim=True, correction=0)
    trans = torch.sum(torch.where(d > thr, d, 0.0), dim=-1)
    total = torch.sum(d, dim=-1)
    return torch.where(total > 0, trans / torch.clamp_min(total, _EPS), 0.0)


def crest_factor(signal: torch.Tensor) -> torch.Tensor:
    """Global peak/RMS (dynamic_range.go:83-110)."""
    peak = torch.amax(torch.abs(signal), dim=-1)
    rms = torch.sqrt(torch.mean(signal * signal, dim=-1))
    return torch.where(rms > 0, peak / torch.clamp_min(rms, _EPS), 0.0)


def prefix_sums_at(values: torch.Tensor, positions) -> torch.Tensor:
    """Prefix sums of `values` at host positions in [0, N], [..., N] ->
    [..., len(positions)], blocked as the JAX package sums them: 128-wide
    row sums, a cumsum over the rows, and each position's partial row."""
    positions = np.asarray(positions)
    n = values.shape[-1]
    r = (n + 127) // 128
    x2d = F.pad(values, (0, r * 128 - n)).reshape(values.shape[:-1] + (r, 128))
    p = F.pad(torch.cumsum(x2d.sum(dim=-1), dim=-1), (1, 0))       # [..., R + 1]
    qs = positions // 128
    rs = positions % 128
    dev = values.device
    # rows at q == r only occur when pos % 128 == 0 (mask all-zero)
    rowsel = x2d[..., torch.as_tensor(np.minimum(qs, r - 1), device=dev), :]   # [..., P, 128]
    masks = torch.as_tensor((np.arange(128)[None, :] < rs[:, None]).astype(np.float32), device=dev)
    part = torch.sum(rowsel * masks, dim=-1)
    return p[..., torch.as_tensor(qs, device=dev)] + part


# bytes of one float32 temporary of detect_onsets_complex's chunks
COMPLEX_ONSET_CHUNK_BYTES = 512 * 2**20


def _complex_deviation(magnitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """sum over bins of |observed - phase-advanced prediction|, [L, T, F]
    -> [L, T - 2]."""
    pred_phase = 2.0 * phase[..., 1:-1, :] - phase[..., :-2, :]
    pred_re = magnitude[..., 1:-1, :] * torch.cos(pred_phase)
    pred_im = magnitude[..., 1:-1, :] * torch.sin(pred_phase)
    obs_re = magnitude[..., 2:, :] * torch.cos(phase[..., 2:, :])
    obs_im = magnitude[..., 2:, :] * torch.sin(phase[..., 2:, :])
    dev = torch.sqrt((obs_re - pred_re) ** 2 + (obs_im - pred_im) ** 2)
    return torch.sum(dev, dim=-1)


def detect_onsets_complex(
    magnitude: torch.Tensor,
    phase: torch.Tensor,
    hop_size: int,
    sample_rate: int,
    threshold: float = 0.3,
    min_interval_sec: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex-domain onset detection (onset_detection.go complex
    method): the deviation between the observed spectrum and the
    phase-advanced prediction from the previous two frames, peak-picked
    and thinned by `detect_onsets_from_flux` (K4 on the card). The
    deviation runs over chunks of the leading rows, each chunk's
    temporaries within COMPLEX_ONSET_CHUNK_BYTES."""
    t, f = magnitude.shape[-2:]
    lead = magnitude.shape[:-2]
    mag = magnitude.reshape((-1, t, f))
    ph = phase.reshape((-1, t, f))
    rows = max(1, COMPLEX_ONSET_CHUNK_BYTES // max(4 * t * f, 1))
    onset_fn = torch.cat([_complex_deviation(mag[i:i + rows], ph[i:i + rows])
                          for i in range(0, mag.shape[0], rows)])
    onset_fn = F.pad(onset_fn, (2, 0)).reshape(lead + (t,))
    return detect_onsets_from_flux(onset_fn, hop_size, sample_rate, threshold, min_interval_sec)


def energy_statistics(signal: torch.Tensor, frame_size: int, hop_size: int) -> dict:
    """ComputeEnergyStatistics (energy.go:250-...): summary statistics of
    the short-time energy series (std over N, variance over N - 1)."""
    e = short_time_energy(signal, frame_size, hop_size)
    return {
        "mean": torch.mean(e, dim=-1),
        "std": torch.std(e, dim=-1, correction=0),
        "min": torch.amin(e, dim=-1),
        "max": torch.amax(e, dim=-1),
        "variance": energy_variance(e),
        "entropy": energy_entropy(e),
        "dynamic_range_db": percentile_range_db(e, 0.10, 0.95),
    }
