"""Speech analysis: LPC, formants, voice quality, speech detection
(counterpart of `sonido_sonar_tpu/ops/speech.py`).

Reference parity: algorithms/speech/*.go — lpc.go (autocorrelation
method + Levinson-Durbin, order 12 + sr/1000), format.go (pre-emphasis
0.97 + Hamming -> LPC envelope peaks -> validated formants, 200 Hz
spacing, VTL), voice_quality.go (frame 1024 / hop 256 pitch track,
jitter and shimmer over voiced frames, HNR, overall quality),
speech_analysis.go (is-speech heuristics, intelligibility). The JAX
package's deviations from the reference (textbook autocorrelation, the
error-filter envelope, per-frame periods) are kept.

Everything here is batch-clean over leading axes. The voice-quality
pitch track and its period amplitudes come from the K2 kernel
(`ops/hopper_yin.py`, `with_period_amp=True`); the rest is plain
PyTorch, with `torch.fft` where the JAX package uses XLA's FFT.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from sonido_sonar_tpu_torch.config.config import WindowType
from sonido_sonar_tpu_torch.ops.filters import pre_emphasis
from sonido_sonar_tpu_torch.ops.tables import device_table
from sonido_sonar_tpu_torch.ops.windows import make_window

_EPS = 1e-10


def lpc_order_for(sample_rate: int) -> int:
    """12 + sr/1000 (lpc.go:33)."""
    return 12 + sample_rate // 1000


def autocorrelation_r(signal: torch.Tensor, max_order: int) -> torch.Tensor:
    """Raw autocorrelation R[0..max_order], [..., N] -> [..., p+1]."""
    n = signal.shape[-1]
    size = 1 << max(0, (2 * n - 1).bit_length())
    f = torch.fft.rfft(signal.to(torch.float32), n=size, dim=-1)
    ac = torch.fft.irfft(f * torch.conj(f), n=size, dim=-1)
    return ac[..., : max_order + 1]


def levinson_durbin(r: torch.Tensor, order: int):
    """Levinson-Durbin recursion (lpc.go:84-134), batched over leading
    axes: r [..., p+1] -> (a [..., p+1] with a[0] = 1, reflection
    k [..., p], gain [...], residual energy [...])."""
    dev = r.device
    idx = torch.arange(order + 1, device=dev)
    a = torch.zeros(r.shape[:-1] + (order + 1,), dtype=torch.float32, device=dev)
    a[..., 0] = 1.0
    e = torch.clamp_min(r[..., 0], _EPS)
    ks = []
    for i in range(1, order + 1):
        mask = (idx >= 1) & (idx < i)
        rev = torch.clamp(i - idx, 0, order)
        num = r[..., i] - torch.sum(torch.where(mask, a * r[..., rev], 0.0), dim=-1)
        k = num / torch.clamp_min(e, _EPS)
        new_a = torch.where(mask, a - k[..., None] * a[..., rev], a)
        a = torch.where(idx == i, k[..., None], new_a)
        e = torch.clamp_min(e * (1.0 - k * k), _EPS)
        ks.append(k)
    return a, torch.stack(ks, dim=-1), torch.sqrt(e), e


@dataclass
class LPCResult:
    """LPCResult (lpc.go:13-30)."""

    coefficients: torch.Tensor     # [..., p+1], a[0] = 1
    reflection: torch.Tensor       # [..., p]
    gain: torch.Tensor             # [...]
    residual_energy: torch.Tensor  # [...]
    order: int


def lpc_analyze(signal: torch.Tensor, sample_rate: int, order: int = 0) -> LPCResult:
    """LPCAnalyzer.Analyze (lpc.go:44-80)."""
    p = order or lpc_order_for(sample_rate)
    a, k, gain, e = levinson_durbin(autocorrelation_r(signal, p), p)
    return LPCResult(a, k, gain, e, p)


def lpc_is_stable(reflection: torch.Tensor) -> torch.Tensor:
    """Filter stability check (lpc.go checkStability): all reflection
    coefficients strictly inside the unit circle."""
    return torch.all(torch.abs(reflection) < 1.0, dim=-1)


def lpc_residual(signal: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Prediction error e[n] = x[n] - sum_{i>=1} a_i x[n-i] (the
    whitening filter applied to the signal). Unbatched coeffs [p+1]."""
    x = signal.to(torch.float32)
    out = x
    for i in range(1, coeffs.shape[-1]):
        shifted = torch.nn.functional.pad(x[..., : x.shape[-1] - i], (i, 0))
        out = out - coeffs[i] * shifted
    return out


def lpc_spectral_envelope(coeffs: torch.Tensor, nfft: int = 1024) -> torch.Tensor:
    """LPC envelope 1/|A(e^jw)| over nfft/2+1 bins, with the error filter
    A(z) = 1 - sum_{i>=1} a_i z^-i (the JAX package's correction of
    lpc.go:233-265). Angles are formed in float32, as the JAX package
    forms them."""
    p1 = coeffs.shape[-1]
    dev = coeffs.device
    afilt = torch.cat([coeffs[..., :1], -coeffs[..., 1:]], dim=-1)
    k = torch.arange(nfft // 2 + 1, dtype=torch.float32, device=dev)
    i = torch.arange(p1, dtype=torch.float32, device=dev)
    omega = 2.0 * math.pi * k / nfft
    angles = -i[:, None] * omega[None, :]                # [p+1, F]
    re = torch.sum(afilt[..., :, None] * torch.cos(angles), dim=-2)
    im = torch.sum(afilt[..., :, None] * torch.sin(angles), dim=-2)
    mag = torch.sqrt(re * re + im * im)
    return torch.where(mag > 0, 1.0 / torch.clamp_min(mag, _EPS), 0.0)


# ---------------------------------------------------------------------
# Formants (format.go)
# ---------------------------------------------------------------------

@dataclass
class FormantResult:
    """FormantResult: fixed-size [..., max_formants] tensors + count."""

    frequencies: torch.Tensor
    bandwidths: torch.Tensor
    amplitudes: torch.Tensor
    confidences: torch.Tensor
    count: torch.Tensor               # [...] int32
    vocal_tract_length: torch.Tensor  # [...]
    quality: torch.Tensor             # [...]


def formant_confidence(freq, amp, bw, max_amp):
    """calculateFormantConfidence (format.go:274-301): amplitude ratio
    and narrow bandwidth raise confidence; `freq` is taken, as in JAX and
    the reference, and not used."""
    amp_score = torch.where(max_amp > 0, amp / torch.clamp_min(max_amp, _EPS), 0.0)
    bw_score = torch.clamp(1.0 - bw / 1000.0, 0.0, 1.0)
    return 0.6 * amp_score + 0.4 * bw_score


def analyze_formants(
    signal: torch.Tensor,
    sample_rate: int,
    window_size: int = 0,
    order: int = 0,
    max_formants: int = 4,
    nfft: int = 1024,
) -> FormantResult:
    """FormantAnalyzer.AnalyzeFormants (format.go:85-122) over the first
    window of each row, [..., N] -> [..., max_formants] results. Window
    defaults: 1024, or 2048 for sr > 22050 (format.go:49-51)."""
    if window_size == 0:
        window_size = 2048 if sample_rate > 22050 else 1024
    p = order or lpc_order_for(sample_rate)
    dev = signal.device
    x = pre_emphasis(signal[..., :window_size].to(torch.float32), 0.97)
    x = x * device_table(make_window, (WindowType.HAMMING, window_size, 8.6, 0.5, False, True), dev)
    env = lpc_spectral_envelope(lpc_analyze(x, sample_rate, p).coefficients, nfft)
    n_bins = env.shape[-1]
    freq_res = sample_rate / float(nfft)

    # local maxima above 10 % of the maximum (format.go:197-230)
    maxv = torch.amax(env, dim=-1, keepdim=True)
    inner = (
        (env[..., 1:-1] > env[..., :-2])
        & (env[..., 1:-1] > env[..., 2:])
        & (env[..., 1:-1] / torch.clamp_min(maxv, _EPS) > 0.1)
    )
    freqs = torch.arange(n_bins, dtype=torch.float32, device=dev) * freq_res
    peak_mask = torch.nn.functional.pad(inner, (1, 1)) & (freqs >= 50.0) & (freqs <= sample_rate / 2.0)

    # the strongest 3 * max_formants peaks; the lower bin first on ties,
    # as lax.top_k orders them
    k = max_formants * 3
    score = torch.where(peak_mask, env, float("-inf"))
    cand_idx = torch.sort(-score, dim=-1, stable=True).indices[..., :k]
    cand_amp = torch.gather(score, -1, cand_idx)
    cand_freq = cand_idx.to(torch.float32) * freq_res

    # half-height bandwidth: nearest bins left/right where env <= amp/2
    # (format.go:232-271)
    bins = torch.arange(n_bins, dtype=torch.float32, device=dev)
    idx_f = cand_idx.to(torch.float32)[..., None]
    le = env[..., None, :] <= cand_amp[..., None] / 2.0                # [..., k, F]
    dist = bins - idx_f
    left = torch.amax(torch.where(le & (dist < 0), dist, float("-inf")), dim=-1)
    right = torch.amin(torch.where(le & (dist > 0), dist, float("inf")), dim=-1)
    left = torch.where(torch.isfinite(left), -left, idx_f[..., 0])
    right = torch.where(torch.isfinite(right), right, (n_bins - 1) - idx_f[..., 0])
    bw = (left + right) * freq_res
    conf = formant_confidence(cand_freq, cand_amp, bw, maxv)

    # validation (format.go:303-329), then ascending frequency, invalid last
    valid = torch.isfinite(cand_amp) & (cand_freq >= 50.0) & (conf >= 0.2) & (bw > 0) & (bw <= 1000.0)
    order_idx = torch.sort(torch.where(valid, cand_freq, float("inf")), dim=-1, stable=True).indices
    cand_freq, cand_amp, bw, conf, valid = (
        torch.gather(v, -1, order_idx) for v in (cand_freq, cand_amp, bw, conf, valid)
    )

    # 200 Hz minimum spacing (format.go:332-357)
    last_f = torch.full(cand_freq.shape[:-1], -1e9, device=dev)
    keep = torch.empty_like(valid)
    for j in range(k):
        ok = valid[..., j] & (cand_freq[..., j] - last_f >= 200.0)
        keep[..., j] = ok
        last_f = torch.where(ok, cand_freq[..., j], last_f)

    # compact the kept candidates into the first `count` slots
    rank = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    slot = torch.where(keep & (rank < max_formants), rank, max_formants)

    def scatter(vals):
        buf = torch.zeros(vals.shape[:-1] + (max_formants + 1,), dtype=torch.float32, device=dev)
        return buf.scatter(-1, slot, torch.where(keep, vals, 0.0))[..., :max_formants]

    out_f, out_b, out_a, out_c = (scatter(v) for v in (cand_freq, bw, cand_amp, conf))
    count = torch.clamp_max(torch.sum(keep, dim=-1), max_formants).to(torch.int32)

    # VTL (format.go:359-391)
    n = torch.arange(1, max_formants + 1, dtype=torch.float32, device=dev)
    present = torch.arange(max_formants, device=dev) < count[..., None]
    vtl_each = (2 * n - 1) * 35000.0 / (4.0 * torch.clamp_min(out_f, _EPS))
    use = present & (out_f > 0) & (out_c > 0.3) & (vtl_each >= 10.0) & (vtl_each <= 25.0)
    n_use = torch.sum(use, dim=-1)
    vtl = torch.where(
        n_use > 0,
        torch.sum(torch.where(use, vtl_each, 0.0), dim=-1) / torch.clamp_min(n_use, 1),
        17.5,
    )
    quality = torch.clamp_max(count.to(torch.float32) / 3.0, 1.0)
    return FormantResult(out_f, out_b, out_a, out_c, count, vtl, quality)


# ---------------------------------------------------------------------
# Voice quality (voice_quality.go)
# ---------------------------------------------------------------------

@dataclass
class VoiceQualityResult:
    """VoiceQualityResult fields used by the extractors + facade."""

    jitter: torch.Tensor
    shimmer: torch.Tensor
    hnr: torch.Tensor
    f0_stability: torch.Tensor
    amplitude_stability: torch.Tensor
    voicing_strength: torch.Tensor
    noise_measure: torch.Tensor
    overall_quality: torch.Tensor
    num_periods: torch.Tensor
    mean_f0: torch.Tensor
    f0_range: torch.Tensor


def _masked_consecutive_reldiff(vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mean |v[i] - v[i-1]| over pairs voiced at both ends, over the mean
    voiced value, times 100."""
    pair = mask[..., 1:] & mask[..., :-1]
    diff = torch.abs(vals[..., 1:] - vals[..., :-1])
    n_pairs = torch.sum(pair, dim=-1)
    mean_diff = torch.sum(torch.where(pair, diff, 0.0), dim=-1) / torch.clamp_min(n_pairs, 1)
    n_vals = torch.sum(mask, dim=-1)
    mean_val = torch.sum(torch.where(mask, vals, 0.0), dim=-1) / torch.clamp_min(n_vals, 1)
    return torch.where(
        (n_pairs > 0) & (mean_val > _EPS),
        mean_diff / torch.clamp_min(mean_val, _EPS) * 100.0,
        0.0,
    )


def analyze_voice_quality(
    signal: torch.Tensor,
    sample_rate: int,
    min_f0: float = 50.0,
    max_f0: float = 500.0,
) -> VoiceQualityResult:
    """AnalyzeVoiceQuality (voice_quality.go:56-112) over [..., N], with
    the JAX package's per-voiced-frame periods (frame 1024 / hop 256).
    Pitch, confidence and the period RMS amplitudes come from one K2
    launch with `with_period_amp=True`."""
    from sonido_sonar_tpu_torch.ops.hopper_yin import yin_pitch_hopper

    x = signal.to(torch.float32).contiguous()
    pitch, conf, voicing, amp = yin_pitch_hopper(
        x, 1024, 256, sample_rate, min_f0, max_f0, 0.15, with_period_amp=True
    )
    voiced = (voicing > 0.5) & (conf > 0.5) & (pitch >= min_f0) & (pitch <= max_f0)
    period_len = torch.where(
        voiced, torch.full_like(pitch, float(sample_rate)) / torch.clamp_min(pitch, _EPS), 0.0
    )
    num_periods = torch.sum(voiced, dim=-1)

    jitter = _masked_consecutive_reldiff(period_len, voiced)
    shimmer = _masked_consecutive_reldiff(amp, voiced)

    nv = torch.clamp_min(num_periods, 1)
    mean_f0 = torch.sum(torch.where(voiced, pitch, 0.0), dim=-1) / nv
    var_f0 = torch.sum(torch.where(voiced, (pitch - mean_f0[..., None]) ** 2, 0.0), dim=-1) / nv
    cv = torch.sqrt(var_f0) / torch.clamp_min(mean_f0, _EPS)
    f0_stability = torch.where(num_periods >= 2, torch.clamp_min(1.0 - cv, 0.0), 0.0)
    f0_min = torch.amin(torch.where(voiced, pitch, float("inf")), dim=-1)
    f0_max = torch.amax(torch.where(voiced, pitch, float("-inf")), dim=-1)
    f0_range = torch.where(num_periods > 0, f0_max - f0_min, 0.0)

    mean_a = torch.sum(torch.where(voiced, amp, 0.0), dim=-1) / nv
    var_a = torch.sum(torch.where(voiced, (amp - mean_a[..., None]) ** 2, 0.0), dim=-1) / nv
    cv_a = torch.sqrt(var_a) / torch.clamp_min(mean_a, _EPS)
    amp_stability = torch.where(num_periods >= 2, torch.clamp_min(1.0 - cv_a, 0.0), 0.0)

    hnr = hnr_acf(x, sample_rate, mean_f0)
    voicing_strength = torch.sum(torch.where(voiced, voicing, 0.0), dim=-1) / nv

    # noise measure (voice_quality.go:374-399) over the first 1024 samples
    fr = x[..., :1024]
    d = fr[..., 1:] - fr[..., :-1]
    high = torch.sum(d * d, dim=-1)
    tot = torch.sum(fr[..., 1:] * fr[..., 1:], dim=-1)
    noise = torch.where(tot > 0, high / torch.clamp_min(tot, _EPS), 0.0)

    # overall quality (voice_quality.go:429-438)
    jitter_score = torch.clamp_min(1.0 - jitter / 5.0, 0.0)
    shimmer_score = torch.clamp_min(1.0 - shimmer / 10.0, 0.0)
    hnr_score = torch.clamp(hnr / 20.0, 0.0, 1.0)
    overall = (jitter_score + shimmer_score + hnr_score + f0_stability) / 4.0

    return VoiceQualityResult(
        jitter=jitter, shimmer=shimmer, hnr=hnr, f0_stability=f0_stability,
        amplitude_stability=amp_stability, voicing_strength=voicing_strength,
        noise_measure=noise, overall_quality=overall, num_periods=num_periods,
        mean_f0=mean_f0, f0_range=f0_range,
    )


def hnr_acf(signal: torch.Tensor, sample_rate: int, f0) -> torch.Tensor:
    """HNR = 10 log10(r_T / (1 - r_T)) at the period lag of f0, r_T the
    normalized autocorrelation of the mean-removed row
    (harmonic_ratio.go ACF method; voice_quality.go:232-295).

    One lag per row is read. Short rows in a batch (the music program's
    per-frame rows, n <= 4096) take all lags from a zero-padded
    `torch.fft` power spectrum; long rows (the voice-quality signal)
    take one dot product per row at its lag."""
    x = signal.to(torch.float32)
    x = x - torch.mean(x, dim=-1, keepdim=True)
    n = x.shape[-1]
    f0 = torch.as_tensor(f0, dtype=torch.float32, device=x.device)
    lag = torch.full_like(f0, float(sample_rate)) / torch.clamp_min(f0, 1.0)
    lag = torch.clamp(lag.to(torch.int64), 1, n - 1).broadcast_to(x.shape[:-1])
    r0 = torch.clamp_min(torch.sum(x * x, dim=-1), _EPS)
    if x.dim() >= 2 and n <= 4096:
        spec = torch.fft.rfft(x, n=2 * n, dim=-1)
        r_all = torch.fft.irfft(spec.real ** 2 + spec.imag ** 2, n=2 * n, dim=-1)[..., :n]
        r_lag = torch.gather(r_all, -1, lag[..., None])[..., 0]
    else:
        rows = x.reshape(-1, n)
        lags = lag.reshape(-1).tolist()
        r_lag = torch.stack(
            [torch.dot(row[: n - lg], row[lg:]) for row, lg in zip(rows, lags)]
        ).reshape(x.shape[:-1])
    r_t = torch.clamp(r_lag / r0, _EPS, 1.0 - 1e-6)
    return 10.0 * torch.log10(r_t / (1.0 - r_t))


# ---------------------------------------------------------------------
# Speech analyzer facade (speech_analysis.go)
# ---------------------------------------------------------------------

def detect_speech(signal: torch.Tensor, sample_rate: int) -> torch.Tensor:
    """detectSpeech heuristics (speech_analysis.go:105-207): ZCR in
    (0.01, 0.3), RMS > 0.001, normalized autocorrelation periodicity >
    0.1 in lags [20, 400) of the first 1024 samples. bool [...]."""
    x = signal.to(torch.float32)
    n = x.shape[-1]
    if n < sample_rate // 4:
        return torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    nonneg = x >= 0
    zcr = torch.mean((nonneg[..., 1:] != nonneg[..., :-1]).to(torch.float32), dim=-1)
    energy = torch.sqrt(torch.mean(x * x, dim=-1))

    frame = x[..., :1024]
    max_lag = min(400, 1024 // 2)
    f = torch.fft.rfft(frame, n=2048, dim=-1)
    ac = torch.fft.irfft(f * torch.conj(f), n=2048, dim=-1)[..., :max_lag]
    lags = torch.arange(max_lag, device=x.device)
    ac_norm = ac / (1024.0 - lags.to(torch.float32))
    max_corr = torch.amax(torch.where(lags >= 20, ac_norm, float("-inf")), dim=-1)
    fr_energy = torch.mean(frame * frame, dim=-1)
    periodicity = torch.where(fr_energy > 0, max_corr / torch.clamp_min(fr_energy, _EPS), 0.0)
    return (zcr > 0.01) & (zcr < 0.3) & (energy > 0.001) & (periodicity > 0.1)


@dataclass
class SpeechAnalysisResult:
    """SpeechAnalysisResult (speech_analysis.go:11-49)."""

    is_speech: torch.Tensor
    formants: Optional[FormantResult]
    voice_quality: Optional[VoiceQualityResult]
    quality_score: torch.Tensor
    intelligibility: torch.Tensor


def analyze_speech(signal: torch.Tensor, sample_rate: int) -> SpeechAnalysisResult:
    """AnalyzeSpeech facade (speech_analysis.go:50-98), batch-clean over
    leading axes."""
    is_speech = detect_speech(signal, sample_rate)
    formants = analyze_formants(signal, sample_rate)
    vq = analyze_voice_quality(signal, sample_rate)

    # intelligibility (speech_analysis.go:228-268)
    f1 = formants.frequencies[..., 0]
    f2 = formants.frequencies[..., 1]
    intel = 0.5 + torch.where((formants.count >= 2) & (f2 - f1 > 500.0), 0.2, 0.0)
    intel = (intel + formants.quality) / 2.0
    intel = intel + torch.where(vq.hnr > 10.0, 0.1, 0.0)
    intel = intel + torch.where((vq.jitter < 2.0) & (vq.shimmer < 5.0), 0.1, 0.0)
    return SpeechAnalysisResult(
        is_speech=is_speech,
        formants=formants,
        voice_quality=vq,
        quality_score=vq.overall_quality,
        intelligibility=torch.clamp_max(intel, 1.0),
    )


def estimate_gender(formants: FormantResult) -> Tuple[str, float]:
    """EstimateGender (speech_analysis.go:272-296). Host-side helper."""
    if int(formants.count) < 2:
        return "unknown", 0.0
    f1 = float(formants.frequencies[0])
    f2 = float(formants.frequencies[1])
    if f1 < 450 and f2 < 2200:
        return "male", 0.7
    if f1 > 500 and f2 > 2400:
        return "female", 0.7
    return "unknown", 0.3


def estimate_age(vq: VoiceQualityResult) -> Tuple[str, float]:
    """EstimateAge (speech_analysis.go:299-314). Host-side helper."""
    if float(vq.jitter) > 3.0 or float(vq.shimmer) > 8.0:
        return "elderly", 0.4
    if float(vq.mean_f0) > 200 and float(vq.f0_range) > 100:
        return "young", 0.4
    return "adult", 0.3
