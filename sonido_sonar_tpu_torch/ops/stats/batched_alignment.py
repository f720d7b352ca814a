"""Batched hybrid alignment: the analyzer's whole policy over [B] pairs.

Counterpart of `sonido_sonar_tpu/ops/stats/batched_alignment.py`:
  NCC xcorr + peak metrics + parabolic sub-frame refinement
  -> correlation confidence / quality (alignment.go:183-305)
  -> the 0.7 acceptance gate (alignment.go:318-321)
  -> banded DTW + path metrics (alignment.go:379-607)
  -> the consistency-gated winner and the verbatim blends.
Tensors in, tensors out, on the inputs' device; the entry points that
also take numpy (`batched_hybrid_align`, `batched_hybrid_align_device`,
`batched_align_audio`) put it on their `device` argument, the card unless
the caller asks for the CPU (`utils/device.py`). The banded DTW of
`dtw_align_batch` is one fill launch and one backtrack launch over the
whole batch (`ops/stats/hopper_dtw.py`, `ops/stats/hopper_backtrack.py`);
the TPU package's power-of-two sub-batches, which kept multi-GB band
tensors transient on a 16 GB chip, are not needed on an 80 GB card.

Spans (`utils/metrics.Span`, recorded while a profiler session runs):
`align.energy`, `align.xcorr`, `align.dtw`, `align.verify` and
`align.refine` around the stages, `align.gate_read` and
`align.verify_read` around the two host reads of a device flag, each of
which adds one to `utils/metrics.host_syncs`.

Medians average the two middle values, as `jnp.nanmedian` and
`np.median` do (`masked_median`); `torch.median` would take the lower
one and move an even-count DTW offset by one frame.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from sonido_sonar_tpu_torch.ops.stats.alignment import (
    _AMBIGUITY_CAP,
    _AMBIGUITY_ONSET,
    _AMBIGUITY_SLOPE,
    _VERIFY_CONF_CAP,
    _VERIFY_FLOOR,
    _VERIFY_MARGIN,
    _VERIFY_OVERLAP,
    _VERIFY_TOP_K,
    _ncc_arrays,
)
from sonido_sonar_tpu_torch.ops.stats.correlation import _peak_metrics, _take
from sonido_sonar_tpu_torch.ops.stats.hopper_backtrack import backtrack_banded_hopper
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32
from sonido_sonar_tpu_torch.ops.stats.hopper_dtw import fill_banded_hopper
from sonido_sonar_tpu_torch.utils.metrics import Span, count_host_sync

_EPS = 1e-10

ENERGY = Span("align.energy")
XCORR = Span("align.xcorr")
GATE_READ = Span("align.gate_read")
DTW = Span("align.dtw")
VERIFY_READ = Span("align.verify_read")
VERIFY = Span("align.verify")
REFINE = Span("align.refine")


def _any_on_host(span: Span, flags: torch.Tensor) -> bool:
    """Whether any of `flags` is set: one host read, a wait for the card."""
    with span:
        count_host_sync()
        return bool(flags.any())


def masked_median(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of values[mask] along the last axis, the two middle values
    averaged for an even count (jnp.nanmedian, np.median); NaN where the
    mask is empty."""
    v = torch.where(mask, values, float("inf"))
    s = torch.sort(v, dim=-1).values
    cnt = torch.sum(mask, dim=-1)
    lo = torch.clamp_min(cnt - 1, 0) // 2
    hi = cnt // 2
    med = (_take(s, lo) + _take(s, hi)) * 0.5
    return torch.where(cnt > 0, med, float("nan"))


def correlation_confidence_batch(peak, sharpness, psl, snr, second):
    """calculateCorrelationConfidence (alignment.go:183-243), [B]."""
    peak_mag = torch.abs(peak)
    peak_score = torch.where(peak_mag >= 0.6, peak_mag + (peak_mag - 0.6) * 0.5, peak_mag)
    sharp_score = torch.clamp_max(sharpness * 8.0, 0.9)
    side_score = torch.where((psl > 0) & torch.isfinite(psl), torch.clamp_max(psl / 15.0, 0.8), 0.0)
    snr_score = torch.where(snr > 0, torch.clamp_max(snr / 25.0, 0.7), 0.0)
    ratio = torch.abs(second) / torch.clamp_min(peak_mag, _EPS)
    second_penalty = torch.where((second != 0) & (peak_mag > 0) & (ratio > 0.7),
                                 (ratio - 0.7) * 0.25, 0.0)
    excellence = torch.where(peak_mag >= 0.75, 0.12, torch.where(peak_mag >= 0.6, 0.08, 0.0))
    conf = (0.55 * peak_score + 0.22 * sharp_score + 0.12 * side_score + 0.06 * snr_score
            + 0.05 * 0.15 + excellence - second_penalty)
    conf = torch.clamp(conf, 0.0, 0.95)
    return torch.where(peak_mag < 0.1, 0.0, conf)


def correlation_quality_batch(peak, sharpness, psl, snr, peak_lag, max_lag: int):
    """calculateCorrelationQuality (alignment.go:245-305), [B]."""
    peak_mag = torch.abs(peak)
    peak_q = torch.where(peak_mag >= 0.6, peak_mag + (peak_mag - 0.6) * 0.4, peak_mag)
    sharp_q = torch.clamp_max(sharpness * 5.0, 0.85)
    side_q = torch.where((psl > 0) & torch.isfinite(psl), torch.clamp_max(psl / 20.0, 0.7), 0.0)
    snr_q = torch.where(snr > 0, torch.clamp_max(snr / 30.0, 0.6), 0.0)
    if max_lag > 0:
        neg_ratio = torch.abs(peak_lag.to(torch.float32)) / float(max_lag)
        lag_penalty = torch.where((peak_lag < 0) & (neg_ratio > 0.90), (neg_ratio - 0.90) * 4.0, 0.0)
    else:
        lag_penalty = 0.0
    bonus = torch.where(peak_mag >= 0.7, 0.10, torch.where(peak_mag >= 0.55, 0.06, 0.0))
    q = 0.50 * peak_q + 0.25 * sharp_q + 0.15 * side_q + 0.10 * snr_q + bonus - lag_penalty
    q = torch.clamp(q, 0.0, 1.0)
    return torch.where(peak_mag < 0.08, 0.0, q)


def _dtw_path_scores(qs, rs, cs, length, raw_cost, n: int, m: int) -> Dict[str, torch.Tensor]:
    """Every DTW path metric of [B] pairs: the analyzer's dtw_confidence,
    dtw_similarity, dtw_quality, path_stability, _offset_consistency and
    offset estimator, with the path length as data. qs/rs/cs [B, L],
    length/raw_cost [B]."""
    dev = qs.device
    max_len = qs.shape[-1]
    idx = torch.arange(max_len, device=dev)
    ln = length.to(torch.int64)[:, None]
    valid = idx < ln
    lf = torch.clamp_min(length, 1).to(torch.float32)
    distance = raw_cost / lf

    # cost consistency (alignment.go:455-500): half-window 2 once L // 4 >= 4
    h = torch.where(ln // 4 >= 4, 2, 1)
    cs_masked = torch.where(valid, cs, 0.0)
    csum = torch.cat([cs.new_zeros(cs.shape[:-1] + (1,)), torch.cumsum(cs_masked, dim=-1)], dim=-1)
    lo = torch.clamp_min(idx - h, 0)
    hi = torch.minimum(ln - 1, idx + h)
    cnt = torch.clamp_min(hi - lo + 1, 1).to(torch.float32)
    smoothed = (torch.gather(csum, 1, torch.clamp_min(hi + 1, 0)) - torch.gather(csum, 1, lo)) / cnt
    smoothed = torch.where(valid, smoothed, 0.0)
    sm_mean = torch.sum(smoothed, dim=-1) / lf
    sm_var = torch.sum(torch.where(valid, (smoothed - sm_mean[:, None]) ** 2, 0.0), dim=-1) / lf
    cv = torch.sqrt(sm_var) / torch.clamp_min(sm_mean, _EPS)
    consistency = torch.where(length <= 1, 0.0,
                              torch.where(sm_mean <= 1e-10, 1.0, 1.0 / (1.0 + cv)))

    # step geometry
    dq = qs[:, 1:] - qs[:, :-1]
    dr = rs[:, 1:] - rs[:, :-1]
    step_valid = idx[1:] < ln
    total_steps = torch.clamp_min(length - 1, 1).to(torch.float32)
    diag_ratio = torch.sum((dq > 0) & (dr > 0) & step_valid, dim=-1) / total_steps
    diag_bias = torch.where(length <= 1, 1.0, 1.0 / (1.0 + torch.exp(-10.0 * (diag_ratio - 0.3))))
    changes = torch.sum(((dq[:, 1:] != dq[:, :-1]) | (dr[:, 1:] != dr[:, :-1])) & (idx[2:] < ln),
                        dim=-1).to(torch.float32)
    smooth = torch.where(length <= 2, 1.0, torch.clamp_min(1.0 - changes / total_steps, 0.0))
    stability = torch.where(length < 3, 0.0, torch.clamp_min(1.0 - changes / total_steps, 0.0))

    # composite scores (alignment.go:379-453, 545-568)
    nd = distance / ((n + m) / 2.0)
    eff = torch.clamp_max(max(n, m) / lf, 1.0)
    mean_cost = torch.sum(cs_masked, dim=-1) / lf
    quality = torch.clamp(0.3 * eff + 0.3 * diag_bias + 0.2 * smooth + 0.2 * consistency, 0.0, 1.0)
    similarity = torch.clamp(
        0.5 * (1.0 / (1.0 + nd)) + 0.3 * quality + 0.2 * (1.0 / (1.0 + mean_cost)), 0.0, 1.0)
    confidence = torch.clamp(
        0.4 * torch.exp(-nd * 2.0) + 0.25 * eff + 0.2 * consistency + 0.15 * diag_bias, 0.0, 1.0)
    confidence = torch.where(length == 0, 0.0, confidence)

    # offset: truncated median of the interior displacements
    interior = valid & (qs > 0) & (rs > 0) & (qs < n - 1) & (rs < m - 1)
    disp = (rs - qs).to(torch.float32)
    med = masked_median(disp, interior)
    has_interior = torch.any(interior, dim=-1)
    offset_frames = torch.where(
        has_interior,
        torch.trunc(torch.where(torch.isnan(med), 0.0, med)),
        torch.floor(torch.sum(torch.where(valid, disp, 0.0), dim=-1) / lf),
    ).to(torch.int32)

    # offset consistency gate (the hybrid's deviation note)
    within = torch.sum(interior & (torch.abs(disp - med[:, None]) <= 5.0), dim=-1)
    n_interior = torch.sum(interior, dim=-1)
    offset_consistency = torch.where(
        (length < 3) | (n_interior == 0), 0.0, within / torch.clamp_min(n_interior, 1))
    return {
        "offset_frames": offset_frames, "confidence": confidence, "similarity": similarity,
        "quality": quality, "stability": stability,
        "offset_consistency": offset_consistency.to(torch.float32), "distance": distance,
    }


def ambiguity_penalty_batch(ambiguity: torch.Tensor) -> torch.Tensor:
    """Vectorized alignment.ambiguity_penalty."""
    return torch.clamp_max(_AMBIGUITY_SLOPE * torch.clamp_min(ambiguity - _AMBIGUITY_ONSET, 0.0),
                           _AMBIGUITY_CAP)


def xcorr_align_batch(query: torch.Tensor, reference: torch.Tensor, max_lag: int, hop_size: int,
                      t1: int, t2: int, min_sep: int = 0, top_k: int = 1
                      ) -> Dict[str, torch.Tensor]:
    """Batched alignWithCrossCorrelation (alignment.go:151-181) with the
    parabolic sub-frame refinement, over [B, T1] x [B, T2] series.

    min_sep > 0 adds the comb-ambiguity ratio and penalizes `confidence`
    (the unpenalized value stays as `confidence_gate`); top_k > 1 adds
    the top-K well-separated peak lags [B, K]."""
    corr = _ncc_arrays(query, reference, max_lag, t1, t2)
    peak_corr, peak_lag, peak_idx, _pv, snr, sharp, second, psl, _ov = _peak_metrics(
        corr, max_lag, t1, t2)
    num_lags = 2 * max_lag + 1
    i = peak_idx.to(torch.int64)
    y0 = _take(corr, torch.clamp_min(i - 1, 0))
    y1 = _take(corr, i)
    y2 = _take(corr, torch.clamp_max(i + 1, num_lags - 1))
    denom = y0 - 2.0 * y1 + y2
    big_denom = torch.abs(denom) > 1e-12
    shift = 0.5 * (y0 - y2) / torch.where(big_denom, denom, 1.0)
    ok = (i > 0) & (i < num_lags - 1) & big_denom & (torch.abs(shift) <= 1.0)
    lag_refined = peak_lag.to(torch.float32) + torch.where(ok, shift, 0.0)
    offset = torch.round(-lag_refined * hop_size).to(torch.int32)

    abs_c = torch.abs(corr)
    idx = torch.arange(num_lags, device=corr.device)
    sep = max(min_sep, 1)
    masked = torch.where(torch.abs(idx - i[:, None]) <= sep, float("-inf"), abs_c)
    second_sep = torch.amax(masked, dim=-1)
    amb = torch.clamp(torch.where(torch.isfinite(second_sep),
                                  second_sep / torch.clamp_min(_take(abs_c, i), _EPS), 0.0),
                      0.0, 1.0)
    picks = [i]
    for _ in range(top_k - 1):
        p = torch.argmax(masked, dim=-1)
        picks.append(p)
        masked = torch.where(torch.abs(idx - p[:, None]) <= sep, float("-inf"), masked)

    similarity = torch.clamp(torch.abs(peak_corr), 0.0, 1.0)
    confidence = correlation_confidence_batch(peak_corr, sharp, psl, snr, second)
    quality = correlation_quality_batch(peak_corr, sharp, psl, snr, peak_lag, max_lag)
    out = {
        "offset_samples": offset, "peak_lag": peak_lag, "peak_correlation": peak_corr,
        "similarity": similarity, "confidence": confidence, "confidence_gate": confidence,
        "quality": quality, "noise_level": 1.0 - snr / 20.0,
    }
    if min_sep > 0:
        out["ambiguity"] = amb
        out["confidence"] = torch.clamp_min(confidence - ambiguity_penalty_batch(amb), 0.0)
    if top_k > 1:
        out["topk_lags"] = (torch.stack(picks, dim=-1) - max_lag).to(torch.int32)
    return out


def dtw_align_batch(query: torch.Tensor, reference: torch.Tensor, band: int, hop_size: int,
                    n: int, m: int) -> Dict[str, torch.Tensor]:
    """Batched alignWithDTW (alignment.go:133-149): one banded fill and
    one backtrack over the batch, then the path scores. [B, N] or
    [B, N, D] series."""
    q = query[..., None] if query.dim() == 2 else query
    r = reference[..., None] if reference.dim() == 2 else reference
    q = q.to(torch.float32).contiguous()
    r = r.to(torch.float32).contiguous()
    costs = fill_banded_hopper(q, r, band, n, m)
    qs, rs, cs, lengths = backtrack_banded_hopper(costs, band, n, m)
    raw = costs[:, n, m - n + band]
    scores = _dtw_path_scores(qs, rs, cs, lengths, raw, n, m)
    scores["offset_samples"] = scores.pop("offset_frames") * hop_size
    return scores


def _dtw_band(dtw_band: int, max_lag: int, t1: int, t2: int) -> int:
    """The DTW band of the hybrid: widened to the lag budget (the JAX
    package's deviation), at most the series length, at least |t1 - t2|."""
    band = dtw_band
    if band > 0 and max_lag > 0:
        band = max(band, max_lag)
    band = min(band, max(t1, t2))
    return max(band, abs(t1 - t2))


def _lag_setup(q: torch.Tensor, r: torch.Tensor, max_lag: int, hop_size: int, sample_rate: int):
    t1, t2 = int(q.shape[-1]), int(r.shape[-1])
    max_lag = max(min(max_lag, t1 - 1, t2 - 1), 0)
    min_sep = max(int(0.1 * sample_rate / max(hop_size, 1)), 2)
    return t1, t2, max_lag, min_sep


def batched_hybrid_align(query_energy: torch.Tensor, reference_energy: torch.Tensor,
                         max_lag: int, hop_size: int, sample_rate: int, dtw_band: int = 50,
                         skip_dtw_if_confident: bool = True, top_k: int = 1,
                         device: Device = DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """Hybrid alignment of B pairs of 1-D series, the policy of
    AlignmentAnalyzer._align_hybrid: accept xcorr when its unpenalized
    confidence > 0.7; otherwise banded DTW, its confidence scaled by
    sqrt(offset consistency), the more confident offset, the verbatim
    blends. The DTW pass is skipped when every pair clears the gate: one
    host read of the gate vector.

    Returns tensors on the inputs' device: offset_samples, offset_seconds
    (float64, as the JAX host combiner's numpy), confidence,
    confidence_unpenalized, similarity, quality, ambiguity, method (0
    correlation accepted, 1 hybrid/corr winner, 2 hybrid/DTW winner),
    and topk_lags [B, top_k] when top_k > 1.
    """
    q = as_float32(query_energy, device)
    r = as_float32(reference_energy, device).to(q.device)
    t1, t2, max_lag, min_sep = _lag_setup(q, r, max_lag, hop_size, sample_rate)
    with XCORR:
        xc = xcorr_align_batch(q, r, max_lag, hop_size, t1, t2, min_sep=min_sep, top_k=top_k)
    corr_off, corr_conf = xc["offset_samples"], xc["confidence"]
    corr_gate = xc["confidence_gate"]
    need_dtw = ~(corr_gate > 0.7)
    out = {
        "offset_samples": corr_off, "confidence": corr_conf, "confidence_unpenalized": corr_gate,
        "similarity": xc["similarity"], "quality": xc["quality"], "ambiguity": xc["ambiguity"],
        "method": torch.zeros_like(corr_off),
    }
    if top_k > 1:
        out["topk_lags"] = xc["topk_lags"]
    if not skip_dtw_if_confident or _any_on_host(GATE_READ, need_dtw):
        with DTW:
            dt = dtw_align_batch(q, r, _dtw_band(dtw_band, max_lag, t1, t2), hop_size, t1, t2)
            out.update(_hybrid_select(xc, dt, need_dtw))
    out["offset_seconds"] = out["offset_samples"].to(torch.float64) / float(sample_rate)
    return out


def _hybrid_select(xc: dict, dt: dict, need_dtw: torch.Tensor) -> Dict[str, torch.Tensor]:
    corr_conf = xc["confidence"]
    dtw_conf = dt["confidence"]
    eff_conf = dtw_conf * torch.sqrt(dt["offset_consistency"])
    dtw_wins = need_dtw & (eff_conf >= corr_conf)
    return {
        "offset_samples": torch.where(dtw_wins, dt["offset_samples"], xc["offset_samples"]),
        "confidence": torch.where(need_dtw, 0.6 * dtw_conf + 0.4 * corr_conf, corr_conf),
        "similarity": torch.where(need_dtw, 0.7 * dt["similarity"] + 0.3 * xc["similarity"],
                                  xc["similarity"]),
        "quality": torch.where(need_dtw, dt["quality"], xc["quality"]),
        "method": torch.where(need_dtw, torch.where(dtw_wins, 2, 1), 0).to(torch.int32),
    }


def batched_hybrid_align_device(query_energy: torch.Tensor, reference_energy: torch.Tensor,
                                max_lag: int, hop_size: int, sample_rate: int,
                                dtw_band: int = 50, device: Device = DEFAULT_DEVICE
                                ) -> Dict[str, torch.Tensor]:
    """Sync-free hybrid alignment: both passes always run and the winner
    select stays on the device, so nothing waits for the host. Same
    policy and outputs as batched_hybrid_align (offset_seconds here in
    float32, as JAX computes it on the device)."""
    q = as_float32(query_energy, device)
    r = as_float32(reference_energy, device).to(q.device)
    t1, t2, max_lag, min_sep = _lag_setup(q, r, max_lag, hop_size, sample_rate)
    xc = xcorr_align_batch(q, r, max_lag, hop_size, t1, t2, min_sep=min_sep)
    dt = dtw_align_batch(q, r, _dtw_band(dtw_band, max_lag, t1, t2), hop_size, t1, t2)
    out = _hybrid_select(xc, dt, ~(xc["confidence_gate"] > 0.7))
    out["offset_seconds"] = out["offset_samples"] / float(sample_rate)
    out["confidence_unpenalized"] = xc["confidence_gate"]
    out["ambiguity"] = xc["ambiguity"]
    return out


def batched_align_audio(query_pcm: torch.Tensor, reference_pcm: torch.Tensor, sample_rate: int,
                        window_size: int = 2048, hop_size: int = 512,
                        max_lag_seconds: float = 30.0, dtw_band: int = 50, refine: bool = False,
                        verify: Optional[bool] = None,
                        max_offset_samples: int = 0,
                        device: Device = DEFAULT_DEVICE) -> Dict[str, torch.Tensor]:
    """AlignAudio for B pairs (alignment.go:109-130): short-time RMS
    energy series -> batched hybrid alignment, the PCM verification of
    comb-ambiguous or low-overlap pairs (verify None: adaptive; True:
    every pair; False: none) and optional GCC-PHAT refinement.

    Adds `verified` [B] bool and `verify_margin` [B] (0 where not
    verified), and `offset_seconds_refined` with refine=True.
    `max_offset_samples` bounds |offset| for the PHAT windows (default
    N // 4). The energies are the hop-block RMS of
    `ops/temporal.short_time_energy`; JAX's `energy_impl` choice between
    two equal implementations of it has no counterpart.
    """
    from sonido_sonar_tpu_torch.ops.temporal import short_time_energy
    from sonido_sonar_tpu_torch.parallel.pipeline import (
        batched_phat_candidates,
        batched_phat_global,
        batched_refine_offsets,
    )

    q = as_float32(query_pcm, device)
    r = as_float32(reference_pcm, device).to(q.device)
    with ENERGY:
        qe = short_time_energy(q, window_size, hop_size)
        re_ = short_time_energy(r, window_size, hop_size)
    max_lag = int(max_lag_seconds * sample_rate) // hop_size
    top_k = 1 if verify is False else _VERIFY_TOP_K
    out = batched_hybrid_align(qe, re_, max_lag, hop_size, sample_rate, dtw_band=dtw_band,
                               top_k=top_k)
    b = out["offset_samples"].shape[0]
    dev = q.device
    out["verified"] = torch.zeros(b, dtype=torch.bool, device=dev)
    out["verify_margin"] = torch.zeros(b, dtype=torch.float64, device=dev)
    if verify is True:
        need = torch.ones(b, dtype=torch.bool, device=dev)
    elif verify is False:
        need = torch.zeros(b, dtype=torch.bool, device=dev)
    else:
        t1, t2 = qe.shape[-1], re_.shape[-1]
        lag_f = -out["offset_samples"].to(torch.float64) / hop_size
        ov = torch.clamp_min(torch.clamp_max(t2 - lag_f, t1) - torch.clamp_min(-lag_f, 0.0), 0.0)
        need = (out["ambiguity"] > _AMBIGUITY_ONSET) | (ov < _VERIFY_OVERLAP * min(t1, t2))
    if verify is not False and _any_on_host(VERIFY_READ, need):
        with VERIFY:
            glob_off, glob_peak = batched_phat_global(q, r, sample_rate,
                                                      int(max_lag_seconds * sample_rate))
            glob_off = torch.where(glob_peak.to(torch.float64) >= _VERIFY_FLOOR,
                                   glob_off.to(torch.float64), out["offset_seconds"])
            cand = torch.cat([
                -out["topk_lags"].to(torch.float64) * hop_size / sample_rate,
                out["offset_seconds"][:, None], glob_off[:, None],
            ], dim=1)
            refined, peaks = batched_phat_candidates(
                q, r, cand.to(torch.float32), sample_rate, hop_size=hop_size,
                max_offset_samples=max_offset_samples)
            refined = refined.to(torch.float64)
            peaks = peaks.to(torch.float64)
            k_star = torch.argmax(peaks, dim=1)
            best_off = _take(refined, k_star)
            best_val = _take(peaks, k_star)
            hop_s = hop_size / float(sample_rate)
            rival = torch.amax(torch.where(torch.abs(refined - best_off[:, None]) > hop_s, peaks, 0.0),
                               dim=1)
            margin = best_val / torch.clamp_min(rival, 1e-9)
            decisive = (best_val >= _VERIFY_FLOOR) & (margin >= _VERIFY_MARGIN)
            out["offset_samples"] = torch.where(
                need, torch.round(best_off * sample_rate).to(torch.int64),
                out["offset_samples"].to(torch.int64))
            # a decisive PCM confirmation lifts the comb-ambiguity penalty and
            # floors confidence at the whitened-peak evidence (_VERIFY_CONF_CAP)
            conf = out["confidence"].to(torch.float64)
            out["confidence"] = torch.where(
                need & decisive,
                torch.maximum(torch.maximum(conf, out["confidence_unpenalized"].to(torch.float64)),
                              torch.clamp_max(best_val, _VERIFY_CONF_CAP)),
                conf)
            out["verified"] = need
            out["verify_margin"] = torch.where(need, margin, 0.0)
    out["offset_seconds"] = out["offset_samples"].to(torch.float64) / float(sample_rate)
    if refine:
        with REFINE:
            out["offset_seconds_refined"] = batched_refine_offsets(
                q, r, out["offset_seconds"].to(torch.float32), sample_rate, hop_size=hop_size,
                max_offset_samples=max_offset_samples)
    return out
