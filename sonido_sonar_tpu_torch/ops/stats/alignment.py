"""Hybrid alignment analyzer: cross-correlation + DTW with confidence and
quality scoring.

Counterpart of `sonido_sonar_tpu/ops/stats/alignment.py` (reference
parity: alignment.go — xcorr over the first feature component with
normalized cross-correlation on the overlap; hybrid = xcorr first,
accept above 0.7 confidence, else DTW and the 0.6/0.4, 0.7/0.3 blends;
the hand-tuned constants verbatim; path stability, smoothness, cost
consistency and diagonal bias; consistency by deterministic sin-noise
trials), with the JAX package's documented deviations: one offset
convention (positive = reference delayed, in samples), the comb-
ambiguity penalty, the band widened to the lag budget, the interior
median DTW offset and the consistency-gated hybrid winner.

The analyzer is host-orchestrated per pair, as in JAX: the scores are
Python floats, path statistics numpy on the path's host copy. A
`KernelError` from the DTW kernels is never taken for a failed DTW: the
hybrid re-raises it (`_build.KernelError`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from sonido_sonar_tpu_torch._build import KernelError
from sonido_sonar_tpu_torch.ops.stats.correlation import (
    CorrelationResult,
    _next_pow2,
    _peak_metrics,
    lag_window,
    z_normalize,
)
from sonido_sonar_tpu_torch.ops.stats.dtw import DTWResult, dtw_align, dtw_align_banded
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32

_EPS = 1e-10

# Comb-ambiguity penalty (the JAX package's NOTE deviation,
# alignment.py:46-62): the strongest peak more than min_sep bins from the
# main one, relative to it, above the onset costs up to the cap.
_AMBIGUITY_ONSET = 0.75
_AMBIGUITY_SLOPE = 1.6
_AMBIGUITY_CAP = 0.4

# PCM verification (alignment.py:64-92): K candidates, the decisiveness
# gate (absolute floor, margin over differently-refining candidates),
# the low-overlap trigger and the confidence floor of a verified peak.
_VERIFY_TOP_K = 5
_VERIFY_FLOOR = 0.02
_VERIFY_MARGIN = 1.5
_VERIFY_OVERLAP = 0.5
_VERIFY_CONF_CAP = 0.9


def comb_ambiguity(correlations, peak_index: int, min_sep: int) -> float:
    """Ratio of the strongest secondary peak more than min_sep bins from
    the main peak to the main peak, in [0, 1]."""
    c = np.abs(np.asarray(torch.as_tensor(correlations).detach().cpu(), dtype=np.float64))
    if c.ndim != 1 or c.size == 0:
        return 0.0
    pk = int(peak_index)
    mask = np.abs(np.arange(c.size) - pk) > min_sep
    if not mask.any():
        return 0.0
    peak = float(c[pk])
    if peak <= _EPS:
        return 0.0
    return min(float(c[mask].max()) / peak, 1.0)


def ambiguity_penalty(ambiguity: float) -> float:
    """Confidence penalty for a comb-ambiguous correlation peak."""
    return min(_AMBIGUITY_CAP, _AMBIGUITY_SLOPE * max(0.0, ambiguity - _AMBIGUITY_ONSET))


@dataclass
class AlignmentResult:
    """AlignmentResult (alignment.go:33-58)."""

    method: str
    offset: int                 # samples (positive = reference delayed)
    offset_seconds: float
    confidence: float
    similarity: float
    alignment_quality: float
    noise_level: float = 0.0
    stability: float = 0.0
    query_length: int = 0
    reference_length: int = 0
    sample_rate: int = 0
    processing_time: float = 0.0
    dtw_result: Optional[DTWResult] = None
    cross_corr_result: Optional[CorrelationResult] = None
    ambiguity: float = 0.0


def _on_device(x, device: Device) -> torch.Tensor:
    """A tensor as it is; anything else as float32 on `device`."""
    return x if isinstance(x, torch.Tensor) else as_float32(x, device)


def _as_2d(x, device: Device) -> torch.Tensor:
    x = _on_device(x, device)
    return x[:, None] if x.dim() == 1 else x


def _path_host(dtw: DTWResult):
    """The valid prefix of a DTW path on the host: (qi, ri, costs)."""
    length = int(dtw.path_length)
    return (dtw.path_qidx[:length].cpu().numpy(), dtw.path_ridx[:length].cpu().numpy(),
            dtw.path_cost[:length].cpu().numpy())


class AlignmentAnalyzer:
    """AlignmentAnalyzer (alignment.go:22-84). Numpy input goes to
    `device` (the card by default); a tensor keeps its own device."""

    def __init__(self, method: str = "hybrid", max_lag: int = 0, sample_rate: int = 44100,
                 hop_size: int = 512, window_size: int = 2048,
                 confidence_threshold: float = 0.6, dtw_band: int = -1,
                 device: Device = DEFAULT_DEVICE):
        self.method = method
        self.max_lag = max_lag
        self.sample_rate = sample_rate
        self.hop_size = hop_size
        self.window_size = window_size
        self.confidence_threshold = confidence_threshold
        self.dtw_band = dtw_band
        self.device = torch.device(device)

    def align_features(self, query: torch.Tensor, reference: torch.Tensor,
                       sample_rate: int = 0) -> AlignmentResult:
        """AlignFeatures (alignment.go:84-106): [T, D] or [T] series."""
        sr = sample_rate or self.sample_rate
        query, reference = _as_2d(query, self.device), _as_2d(reference, self.device)
        if self.method == "dtw":
            return self._align_dtw(query, reference, sr)
        if self.method in ("correlation", "cross_correlation"):
            return self._align_xcorr(query, reference, sr)
        if self.method == "hybrid":
            return self._align_hybrid(query, reference, sr)
        raise ValueError(f"unsupported alignment method {self.method}")

    def align_audio(self, query_pcm: torch.Tensor, reference_pcm: torch.Tensor,
                    sample_rate: int = 0) -> AlignmentResult:
        """AlignAudio (alignment.go:109-130): short-time RMS energy series,
        then feature alignment."""
        from sonido_sonar_tpu_torch.ops.temporal import short_time_energy

        sr = sample_rate or self.sample_rate
        q = short_time_energy(_on_device(query_pcm, self.device), self.window_size, self.hop_size)
        r = short_time_energy(_on_device(reference_pcm, self.device), self.window_size,
                              self.hop_size)
        return self.align_features(q[:, None], r[:, None], sr)

    def find_best_alignment(self, query: torch.Tensor, reference: torch.Tensor,
                            sample_rate: int = 0) -> AlignmentResult:
        """FindBestAlignment (alignment.go:673-700): xcorr and DTW, keep
        max(0.6 confidence + 0.4 similarity)."""
        best, best_score = None, -1.0
        for m in ("correlation", "dtw"):
            prev = self.method
            self.method = m
            try:
                res = self.align_features(query, reference, sample_rate)
            finally:
                self.method = prev
            score = 0.6 * res.confidence + 0.4 * res.similarity
            if score > best_score:
                best, best_score = res, score
        if best is None:
            raise RuntimeError("all alignment methods failed")
        return best

    def _align_xcorr(self, query: torch.Tensor, reference: torch.Tensor, sr: int
                     ) -> AlignmentResult:
        """alignWithCrossCorrelation (alignment.go:151-181) with the
        parabolic sub-frame refinement and the ambiguity penalty."""
        qv, rv = query[:, 0], reference[:, 0]
        n1, n2 = qv.shape[-1], rv.shape[-1]
        max_lag = self.max_lag if self.max_lag > 0 else max(n1, n2) - 1
        max_lag = max(min(max_lag, n1 - 1, n2 - 1), 0)
        corr = ncc_overlap(qv, rv, max_lag)
        peak_corr = float(corr.peak_correlation)
        peak_lag = int(corr.peak_lag)
        similarity = min(1.0, max(0.0, abs(peak_corr)))
        confidence = correlation_confidence(corr)
        quality = correlation_quality(corr, self.max_lag)
        min_sep = max(int(0.1 * sr / max(self.hop_size, 1)), 2)
        amb = comb_ambiguity(corr.correlations, int(corr.peak_index), min_sep)
        confidence = max(0.0, confidence - ambiguity_penalty(amb))
        lag_refined = float(peak_lag)
        idx = int(corr.peak_index)
        c = corr.correlations
        if 0 < idx < c.shape[-1] - 1:
            y0, y1, y2 = float(c[idx - 1]), float(c[idx]), float(c[idx + 1])
            denom = y0 - 2.0 * y1 + y2
            if abs(denom) > 1e-12:
                shift = 0.5 * (y0 - y2) / denom
                if abs(shift) <= 1.0:
                    lag_refined = peak_lag + shift
        offset = int(round(-lag_refined * self.hop_size))
        return AlignmentResult(
            method="correlation", offset=offset, offset_seconds=offset / float(sr),
            confidence=confidence, similarity=similarity, alignment_quality=quality,
            noise_level=1.0 - float(corr.snr) / 20.0, query_length=n1, reference_length=n2,
            sample_rate=sr, cross_corr_result=corr, ambiguity=amb,
        )

    def _align_dtw(self, query: torch.Tensor, reference: torch.Tensor, sr: int
                   ) -> AlignmentResult:
        """alignWithDTW (alignment.go:133-149): offset = median interior
        path displacement in frames, times hop_size; long banded
        alignments take the banded fill (the kernels on a CUDA tensor)."""
        n, m = int(query.shape[0]), int(reference.shape[0])
        band = self.dtw_band
        if band > 0 and self.max_lag > 0:
            band = max(band, self.max_lag)
        if band > 0 and n * m > 4_000_000 and abs(n - m) <= band:
            dtw = dtw_align_banded(query, reference, band)
        else:
            dtw = dtw_align(query, reference, constraint_band=band)
        qi, ri, costs = _path_host(dtw)
        interior = (qi > 0) & (ri > 0) & (qi < dtw.query_length - 1) & (ri < dtw.ref_length - 1)
        disp = ri - qi
        if interior.any():
            # np.median averages the two middle values, as JAX does
            offset_frames = int(np.median(disp[interior]))
        else:
            offset_frames = int(np.sum(disp)) // max(len(qi), 1)
        offset = offset_frames * self.hop_size
        return AlignmentResult(
            method="dtw", offset=offset, offset_seconds=offset / float(sr),
            confidence=dtw_confidence(dtw, qi, ri, costs),
            similarity=dtw_similarity(dtw, qi, ri, costs),
            alignment_quality=dtw_quality(dtw, qi, ri, costs),
            stability=path_stability(qi, ri), query_length=n, reference_length=m,
            sample_rate=sr, dtw_result=dtw,
        )

    def _align_hybrid(self, query: torch.Tensor, reference: torch.Tensor, sr: int
                      ) -> AlignmentResult:
        """alignWithHybrid (alignment.go:308-337) with the JAX package's
        consistency-gated winner; routes on the unpenalized confidence."""
        corr_res = self._align_xcorr(query, reference, sr)
        corr_gate = corr_res.confidence + ambiguity_penalty(corr_res.ambiguity)
        if corr_gate > 0.7:
            return corr_res
        try:
            dtw_res = self._align_dtw(query, reference, sr)
        except KernelError:
            raise
        except Exception:  # degradation contract: a failed DTW keeps the xcorr answer
            return corr_res
        eff_dtw_conf = dtw_res.confidence * float(np.sqrt(_offset_consistency(dtw_res.dtw_result)))
        winner = dtw_res if eff_dtw_conf >= corr_res.confidence else corr_res
        return AlignmentResult(
            method="hybrid", offset=winner.offset, offset_seconds=winner.offset_seconds,
            confidence=0.6 * dtw_res.confidence + 0.4 * corr_res.confidence,
            similarity=0.7 * dtw_res.similarity + 0.3 * corr_res.similarity,
            alignment_quality=dtw_res.alignment_quality, noise_level=corr_res.noise_level,
            stability=dtw_res.stability, query_length=corr_res.query_length,
            reference_length=corr_res.reference_length, sample_rate=sr,
            dtw_result=dtw_res.dtw_result, cross_corr_result=corr_res.cross_corr_result,
            ambiguity=corr_res.ambiguity,
        )

    def analyze_alignment_consistency(self, query: torch.Tensor, reference: torch.Tensor,
                                      sample_rate: int = 0, num_trials: int = 5) -> dict:
        """Consistency over deterministic sin-noise trials
        (alignment.go:710-795)."""
        if num_trials < 2:
            num_trials = 5
        query, reference = _as_2d(query, self.device), _as_2d(reference, self.device)
        q = query.detach().cpu().numpy().astype(np.float64)
        offsets = []
        for _ in range(num_trials):
            i = np.arange(q.shape[0])[:, None]
            j = np.arange(q.shape[1])[None, :]
            noise = np.sin((i * j + i + j).astype(np.float64)) * 0.01 * q
            perturbed = torch.from_numpy((q + noise).astype(np.float32)).to(query.device)
            res = self.align_features(perturbed, reference, sample_rate)
            offsets.append(float(res.offset))
        return offset_stats(offsets)


# ---------------------------------------------------------------------
# NCC over the overlap region, FFT-accelerated
# ---------------------------------------------------------------------

def _ncc_arrays(qv: torch.Tensor, rv: torch.Tensor, max_lag: int, n1: int, n2: int
                ) -> torch.Tensor:
    """Per-lag NCC = sum(x1 x2) / sqrt(sum(x1^2) sum(x2^2)) over the
    overlap at each lag, after whole-signal z-normalization
    (alignment.go:62-70, correlation.go:373-410); batches over leading
    axes. Numerator by one rFFT correlation, denominators by prefix sums
    of squares over the overlap windows."""
    x1 = z_normalize(qv.to(torch.float32))
    x2 = z_normalize(rv.to(torch.float32))
    size = _next_pow2(n1 + n2 - 1)
    f1 = torch.fft.rfft(x1, n=size, dim=-1)
    f2 = torch.fft.rfft(x2, n=size, dim=-1)
    num = lag_window(torch.fft.irfft(f1 * torch.conj(f2), n=size, dim=-1), size, max_lag)

    zero = x1.new_zeros(x1.shape[:-1] + (1,))
    c1 = torch.cat([zero, torch.cumsum(x1 * x1, dim=-1)], dim=-1)
    c2 = torch.cat([zero, torch.cumsum(x2 * x2, dim=-1)], dim=-1)
    lags = torch.arange(-max_lag, max_lag + 1, device=x1.device)
    start1 = torch.where(lags >= 0, 0, -lags)
    end1 = torch.where(lags >= 0, torch.clamp_max(n2 - lags, n1), n1)
    length = torch.clamp_min(end1 - start1, 0)
    start2 = torch.where(lags >= 0, lags, 0)
    end2 = start2 + length
    e1 = c1[..., torch.clamp(end1, 0, n1)] - c1[..., torch.clamp(start1, 0, n1)]
    e2 = c2[..., torch.clamp(end2, 0, n2)] - c2[..., torch.clamp(start2, 0, n2)]
    den = torch.sqrt(torch.clamp_min(e1 * e2, 0.0))
    ncc = torch.where(den < _EPS, 0.0, num / torch.clamp_min(den, _EPS))
    return torch.clamp(ncc, -1.0, 1.0)


def ncc_overlap(qv: torch.Tensor, rv: torch.Tensor, max_lag: int) -> CorrelationResult:
    n1, n2 = qv.shape[-1], rv.shape[-1]
    max_lag = max(min(max_lag, n1 - 1, n2 - 1), 0)
    corr = _ncc_arrays(qv, rv, max_lag, n1, n2)
    lags = torch.arange(-max_lag, max_lag + 1, dtype=torch.int32, device=corr.device)
    return CorrelationResult(corr, lags, *_peak_metrics(corr, max_lag, n1, n2), max_lag=max_lag)


# ---------------------------------------------------------------------
# Confidence / quality scoring (verbatim constants)
# ---------------------------------------------------------------------

def correlation_confidence(corr: CorrelationResult) -> float:
    """calculateCorrelationConfidence (alignment.go:183-243)."""
    peak = abs(float(corr.peak_correlation))
    if peak < 0.1:
        return 0.0
    peak_score = peak + (peak - 0.6) * 0.5 if peak >= 0.6 else peak
    sharpness_score = min(0.9, float(corr.sharpness) * 8.0)
    psl = float(corr.peak_to_sidelobe)
    sidelobe_score = min(0.8, psl / 15.0) if (psl > 0 and np.isfinite(psl)) else 0.0
    snr = float(corr.snr)
    snr_score = min(0.7, snr / 25.0) if snr > 0 else 0.0
    second = float(corr.second_peak)
    second_penalty = 0.0
    if second != 0 and peak > 0:
        ratio = abs(second) / peak
        if ratio > 0.7:
            second_penalty = (ratio - 0.7) * 0.25
    excellence = 0.12 if peak >= 0.75 else (0.08 if peak >= 0.6 else 0.0)
    confidence = (0.55 * peak_score + 0.22 * sharpness_score + 0.12 * sidelobe_score
                  + 0.06 * snr_score + 0.05 * 0.15 + excellence - second_penalty)
    return min(0.95, max(0.0, confidence))


def correlation_quality(corr: CorrelationResult, max_lag: int) -> float:
    """calculateCorrelationQuality (alignment.go:245-305)."""
    peak = abs(float(corr.peak_correlation))
    if peak < 0.08:
        return 0.0
    peak_q = peak + (peak - 0.6) * 0.4 if peak >= 0.6 else peak
    sharp_q = min(0.85, float(corr.sharpness) * 5.0)
    psl = float(corr.peak_to_sidelobe)
    side_q = min(0.7, psl / 20.0) if (psl > 0 and np.isfinite(psl)) else 0.0
    snr = float(corr.snr)
    snr_q = min(0.6, snr / 30.0) if snr > 0 else 0.0
    lag_penalty = 0.0
    peak_lag = int(corr.peak_lag)
    if max_lag > 0 and peak_lag < 0:
        neg_ratio = abs(peak_lag) / max_lag
        if neg_ratio > 0.90:
            lag_penalty = (neg_ratio - 0.90) * 4.0
    bonus = 0.10 if peak >= 0.7 else (0.06 if peak >= 0.55 else 0.0)
    q = 0.50 * peak_q + 0.25 * sharp_q + 0.15 * side_q + 0.10 * snr_q + bonus - lag_penalty
    return min(1.0, max(0.0, q))


def _cost_consistency(costs: np.ndarray) -> float:
    """calculateCostConsistency (alignment.go:455-500)."""
    n = len(costs)
    if n <= 1:
        return 0.0
    w = max(min(5, n // 4), 2)
    smoothed = np.empty(n)
    for i in range(n):
        lo = max(0, i - w // 2)
        hi = min(n - 1, i + w // 2)
        smoothed[i] = costs[lo: hi + 1].mean()
    mean = smoothed.mean()
    if mean <= 1e-10:
        return 1.0
    return 1.0 / (1.0 + smoothed.std() / mean)


def _diagonal_bias(qi: np.ndarray, ri: np.ndarray) -> float:
    """calculateDiagonalBias (alignment.go:502-529)."""
    if len(qi) <= 1:
        return 1.0
    dq, dr = np.diff(qi), np.diff(ri)
    ratio = float(((dq > 0) & (dr > 0)).sum()) / (len(qi) - 1)
    return 1.0 / (1.0 + np.exp(-10.0 * (ratio - 0.3)))


def _path_changes(qi: np.ndarray, ri: np.ndarray) -> int:
    dq, dr = np.diff(qi), np.diff(ri)
    return int(((dq[1:] != dq[:-1]) | (dr[1:] != dr[:-1])).sum())


def _path_smoothness(qi: np.ndarray, ri: np.ndarray) -> float:
    """calculatePathSmoothness (alignment.go:570-607)."""
    if len(qi) <= 2:
        return 1.0
    return max(0.0, 1.0 - _path_changes(qi, ri) / (len(qi) - 1))


def _offset_consistency(dtw: Optional[DTWResult], tol: int = 5) -> float:
    """Share of interior path points whose displacement (ri - qi) lies
    within `tol` frames of the median displacement (the JAX package's
    hybrid deviation)."""
    if dtw is None:
        return 0.0
    qi, ri, _ = _path_host(dtw)
    if len(qi) < 3:
        return 0.0
    interior = (qi > 0) & (ri > 0) & (qi < dtw.query_length - 1) & (ri < dtw.ref_length - 1)
    if not interior.any():
        return 0.0
    disp = (ri - qi)[interior]
    return float(np.mean(np.abs(disp - np.median(disp)) <= tol))


def path_stability(qi: np.ndarray, ri: np.ndarray) -> float:
    """calculatePathStability (alignment.go:625-652)."""
    if len(qi) < 3:
        return 0.0
    return max(0.0, 1.0 - _path_changes(qi, ri) / (len(qi) - 1))


def dtw_similarity(dtw: DTWResult, qi, ri, costs) -> float:
    """calculateSimilarityFromDTW (alignment.go:380-411)."""
    avg_len = (dtw.query_length + dtw.ref_length) / 2.0
    if avg_len == 0:
        return 0.0
    nd = float(dtw.distance) / avg_len
    quality = dtw_quality(dtw, qi, ri, costs)
    mean_cost = float(costs.mean()) if len(costs) else 0.0
    return min(1.0, max(0.0, 0.5 / (1.0 + nd) + 0.3 * quality + 0.2 / (1.0 + mean_cost)))


def dtw_confidence(dtw: DTWResult, qi, ri, costs) -> float:
    """calculateDTWConfidence (alignment.go:418-453)."""
    if len(qi) == 0:
        return 0.0
    avg_len = (dtw.query_length + dtw.ref_length) / 2.0
    if avg_len == 0:
        return 0.0
    nd = float(dtw.distance) / avg_len
    eff = min(1.0, max(dtw.query_length, dtw.ref_length) / len(qi))
    return float(min(1.0, max(0.0, 0.4 * np.exp(-nd * 2.0) + 0.25 * eff
                              + 0.2 * _cost_consistency(costs) + 0.15 * _diagonal_bias(qi, ri))))


def dtw_quality(dtw: DTWResult, qi, ri, costs) -> float:
    """calculateDTWQuality (alignment.go:544-568)."""
    if len(qi) == 0:
        return 0.0
    eff = min(1.0, max(dtw.query_length, dtw.ref_length) / len(qi))
    return float(min(1.0, max(0.0, 0.3 * eff + 0.3 * _diagonal_bias(qi, ri)
                              + 0.2 * _path_smoothness(qi, ri) + 0.2 * _cost_consistency(costs))))


def offset_stats(offsets) -> dict:
    """calculateOffsetStats (alignment.go:766-801) -> AlignmentStats."""
    o = np.asarray(offsets, dtype=np.float64)
    if len(o) == 0:
        return dict(mean_offset=0.0, stddev_offset=0.0, median_offset=0.0, offset_range=0.0,
                    consistency=1.0)
    mean, std = o.mean(), o.std()
    consistency = 1.0 / (1.0 + std / abs(mean)) if mean != 0 else 1.0
    return dict(mean_offset=float(mean), stddev_offset=float(std),
                median_offset=float(np.median(o)), offset_range=float(o.max() - o.min()),
                consistency=float(consistency))
