"""Alignment extractor: multi-feature temporal alignment for CDN latency.

Counterpart of `sonido_sonar_tpu/extractors/alignment.py` (reference
parity: fingerprint/extractors/alignment.go — max lag seconds -> frames
via hop; corr_energy (weight 1.0) and dtw_chroma (0.7) active, dtw_mfcc /
dtw_centroid behind `enable_all_features`; best = max weight *
(0.4 conf + 0.4 sim + 0.2 quality); time stretch = 0.7 path slope + 0.3
length ratio; TruncateToAlignmentPCM with 0.5 s edge padding; the
consistency analysis on request), with the JAX package's PCM
verification (top-K peaks, the high-overlap peak and the whitened
full-range scan, GCC-PHAT-verified) in `align_audio_files`.

`_align_with` keeps the reference's degradation contract (a failed
feature alignment is reported, not raised) for data errors; a
`KernelError` (a CUDA kernel that did not build or launch) propagates.

Tensors are aligned on their own device; numpy PCM and feature series go
to the extractor's `device` (the card unless the caller asks for the CPU;
`utils/device.py`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sonido_sonar_tpu_torch._build import KernelError
from sonido_sonar_tpu_torch.config.config import AlignmentConfig, FeatureConfig
from sonido_sonar_tpu_torch.extractors.features import ExtractedFeatures
from sonido_sonar_tpu_torch.logging import get_global_logger
from sonido_sonar_tpu_torch.ops.stats.alignment import (
    _AMBIGUITY_ONSET,
    _VERIFY_CONF_CAP,
    _VERIFY_FLOOR,
    _VERIFY_MARGIN,
    _VERIFY_OVERLAP,
    _VERIFY_TOP_K,
    AlignmentAnalyzer,
    AlignmentResult,
    correlation_confidence,
)
from sonido_sonar_tpu_torch.ops.stats.correlation import _next_pow2
from sonido_sonar_tpu_torch.ops.temporal import short_time_energy
from sonido_sonar_tpu_torch.parallel.pipeline import _phat_cc
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device, as_float32

# selectBestAlignment weights (alignment.go:412-430)
_FEATURE_WEIGHTS = {
    "corr_energy": 1.0,
    "dtw_chroma": 0.7,
    "dtw_mfcc": 1.0,      # the reference's commented-out intent
    "dtw_centroid": 0.6,
    "default": 0.5,
}


@dataclass
class FeatureAlignment:
    """extractors.AlignmentResult wrapper (alignment.go:64-70)."""

    result: Optional[AlignmentResult]
    feature_type: str
    success: bool
    error: str = ""


@dataclass
class AlignmentFeatures:
    """AlignmentFeatures (alignment.go:35-61)."""

    best_alignment: Optional[FeatureAlignment] = None
    dtw_alignment: Optional[FeatureAlignment] = None
    corr_alignment: Optional[FeatureAlignment] = None
    temporal_offset: float = 0.0
    offset_confidence: float = 0.0
    time_stretch: float = 1.0
    alignment_similarity: float = 0.0
    feature_similarity: Dict[str, float] = field(default_factory=dict)
    alignment_quality: float = 0.0
    consistency: Optional[dict] = None
    method: str = ""
    processing_time: float = 0.0
    query_length: float = 0.0
    reference_length: float = 0.0


class AlignmentExtractor:
    """AlignmentExtractor (alignment.go:17-135)."""

    def __init__(self, feature_config: FeatureConfig,
                 alignment_config: Optional[AlignmentConfig] = None,
                 max_lag_seconds: Optional[float] = None, enable_all_features: bool = False,
                 device: Device = DEFAULT_DEVICE):
        self.config = feature_config
        self.device = torch.device(device)
        self.alignment_config = alignment_config or AlignmentConfig()
        self.max_lag_seconds = (max_lag_seconds if max_lag_seconds is not None
                                else self.alignment_config.max_lag_seconds)
        self.max_lag_samples = int(self.max_lag_seconds * feature_config.sample_rate)
        self.enable_all_features = enable_all_features
        self._log = get_global_logger().with_component("alignment_extractor")

    def _tensor(self, x) -> torch.Tensor:
        return as_float32(x, self.device)

    def _analyzer(self, method: str, max_lag_frames: int) -> AlignmentAnalyzer:
        return AlignmentAnalyzer(
            method=method, max_lag=max_lag_frames, sample_rate=self.config.sample_rate,
            hop_size=self.config.hop_size, window_size=self.config.window_size,
            confidence_threshold=self.alignment_config.min_confidence,
            dtw_band=self.alignment_config.dtw_band_radius, device=self.device,
        )

    def _align_with(self, feature_type: str, query, reference, sample_rate: int, method: str
                    ) -> FeatureAlignment:
        """alignWithFeatures (alignment.go:357-409): clamp the lag frames
        to the data, run the analyzer."""
        q, r = self._tensor(query), self._tensor(reference)
        q = q[:, None] if q.dim() == 1 else q
        r = r[:, None] if r.dim() == 1 else r
        min_frames = min(q.shape[0], r.shape[0])
        max_lag_frames = min(self.max_lag_samples // self.config.hop_size, min_frames - 1)
        try:
            res = self._analyzer(method, max_lag_frames).align_features(q, r, sample_rate)
            return FeatureAlignment(res, feature_type, True)
        except KernelError:
            raise
        except Exception as e:  # degradation contract (alignment.go:388-396)
            self._log.warn("alignment failed", feature_type=feature_type, error=str(e))
            return FeatureAlignment(None, feature_type, False, str(e))

    def perform_multi_feature_alignment(self, query: ExtractedFeatures,
                                        reference: ExtractedFeatures, sample_rate: int
                                        ) -> Dict[str, FeatureAlignment]:
        """performMultiFeatureAlignment (alignment.go:299-354)."""
        out: Dict[str, FeatureAlignment] = {}
        qe, re_ = query.energy_features, reference.energy_features
        if qe is not None and re_ is not None and qe.short_time_energy is not None:
            out["corr_energy"] = self._align_with(
                "corr_energy", qe.short_time_energy, re_.short_time_energy, sample_rate,
                "correlation")
        if query.chroma_features is not None and reference.chroma_features is not None:
            out["dtw_chroma"] = self._align_with(
                "dtw_chroma", query.chroma_features, reference.chroma_features, sample_rate,
                "dtw")
        if self.enable_all_features:
            if query.mfcc is not None and reference.mfcc is not None:
                out["dtw_mfcc"] = self._align_with("dtw_mfcc", query.mfcc, reference.mfcc,
                                                   sample_rate, "dtw")
            qs, rs = query.spectral_features, reference.spectral_features
            if qs is not None and rs is not None:
                out["dtw_centroid"] = self._align_with(
                    "dtw_centroid", qs.spectral_centroid, rs.spectral_centroid, sample_rate,
                    "dtw")
        return out

    @staticmethod
    def select_best_alignment(alignments: Dict[str, FeatureAlignment]
                              ) -> Optional[FeatureAlignment]:
        """selectBestAlignment (alignment.go:412-445)."""
        best, best_score = None, 0.0
        for ftype, a in alignments.items():
            if not a.success or a.result is None:
                continue
            w = _FEATURE_WEIGHTS.get(ftype, _FEATURE_WEIGHTS["default"])
            score = w * (0.4 * a.result.confidence + 0.4 * a.result.similarity
                         + 0.2 * a.result.alignment_quality)
            if score > best_score:
                best, best_score = a, score
        return best

    @staticmethod
    def estimate_time_stretch(best: Optional[FeatureAlignment], query_len: float,
                              ref_len: float) -> float:
        """estimateTimeStretch (alignment.go:448-476)."""
        if best is None or not best.success or query_len <= 0 or ref_len <= 0:
            return 1.0
        length_ratio = query_len / ref_len
        res = best.result
        if res is not None and res.dtw_result is not None:
            dtw = res.dtw_result
            length = int(dtw.path_length)
            if length > 1:
                qi = dtw.path_qidx[:length].cpu().numpy()
                ri = dtw.path_ridx[:length].cpu().numpy()
                q_span = float(qi[-1] - qi[0] + 1)
                r_span = float(ri[-1] - ri[0] + 1)
                if r_span > 0:
                    return 0.7 * (q_span / r_span) + 0.3 * length_ratio
        return length_ratio

    def extract_alignment_features(
        self, query_features: ExtractedFeatures, reference_features: ExtractedFeatures,
        query_pcm: torch.Tensor, reference_pcm: torch.Tensor, sample_rate: int,
        analyze_consistency: bool = False,
    ) -> AlignmentFeatures:
        """ExtractAlignmentFeatures (alignment.go:139-219)."""
        t0 = time.monotonic()
        result = AlignmentFeatures(
            query_length=query_pcm.shape[-1] / float(sample_rate),
            reference_length=reference_pcm.shape[-1] / float(sample_rate),
        )
        alignments = self.perform_multi_feature_alignment(query_features, reference_features,
                                                          sample_rate)
        best = self.select_best_alignment(alignments)
        if best is not None:
            result.best_alignment = best
            result.temporal_offset = best.result.offset_seconds
            result.offset_confidence = best.result.confidence
            result.alignment_similarity = best.result.similarity
            result.alignment_quality = best.result.alignment_quality
            result.method = best.feature_type
        for ftype, a in alignments.items():
            if ftype == "dtw_mfcc" and a.result is not None and a.result.dtw_result is not None:
                result.dtw_alignment = a
            if ftype == "corr_energy" and a.result is not None \
                    and a.result.cross_corr_result is not None:
                result.corr_alignment = a
            if a.success:
                result.feature_similarity[ftype] = a.result.similarity
        result.time_stretch = self.estimate_time_stretch(best, result.query_length,
                                                         result.reference_length)
        if analyze_consistency and best is not None:
            qe, re_ = query_features.energy_features, reference_features.energy_features
            if qe is not None and re_ is not None:
                analyzer = self._analyzer("correlation",
                                          self.max_lag_samples // self.config.hop_size)
                result.consistency = analyzer.analyze_alignment_consistency(
                    self._tensor(qe.short_time_energy)[:, None],
                    self._tensor(re_.short_time_energy)[:, None],
                    sample_rate, self.alignment_config.consistency_trials)
        result.processing_time = (time.monotonic() - t0) * 1000.0
        return result

    def _phat_refine(self, query_pcm: torch.Tensor, reference_pcm: torch.Tensor,
                     sample_rate: int, coarse_offset_seconds: float, search_hops: int = 24
                     ) -> Tuple[float, float]:
        """GCC-PHAT refinement -> (refined offset seconds, whitened peak)."""
        coarse = int(round(coarse_offset_seconds * sample_rate))
        n1, n2 = int(query_pcm.shape[-1]), int(reference_pcm.shape[-1])
        start_q, start_r = max(0, -coarse), max(0, coarse)
        length = min(n1 - start_q, n2 - start_r)
        if length < self.config.window_size * 4:
            return coarse_offset_seconds, 0.0
        q = self._tensor(query_pcm)[start_q: start_q + length]
        r = self._tensor(reference_pcm)[start_r: start_r + length]
        max_lag = max(search_hops * self.config.hop_size, 8)
        window = _phat_cc(q, r, _next_pow2(length + max_lag), max_lag)
        idx = int(torch.argmax(window))
        return (coarse - (idx - max_lag)) / float(sample_rate), float(window[idx])

    def _phat_global(self, query_pcm: torch.Tensor, reference_pcm: torch.Tensor,
                     sample_rate: int) -> Tuple[float, float]:
        """Whitened full-range scan over +-max_lag: (offset seconds, peak),
        a verification candidate the energy series may not contain."""
        n1, n2 = int(query_pcm.shape[-1]), int(reference_pcm.shape[-1])
        length = min(n1, n2)
        max_lag = min(self.max_lag_samples, length - 1)
        if length < self.config.window_size * 4 or max_lag < 1:
            return 0.0, 0.0
        window = _phat_cc(self._tensor(query_pcm)[..., :length],
                          self._tensor(reference_pcm)[..., :length],
                          _next_pow2(length + max_lag), max_lag)
        idx = int(torch.argmax(window))
        return -(idx - max_lag) / float(sample_rate), float(window[idx])

    def verify_candidate_offsets(self, query_pcm: torch.Tensor, reference_pcm: torch.Tensor,
                                 sample_rate: int, candidate_offsets_seconds,
                                 search_hops: int = 24) -> Tuple[float, float, float]:
        """The candidate best supported by the PCM: (refined offset
        seconds, peak, margin over candidates refining > one hop away)."""
        refined = [self._phat_refine(query_pcm, reference_pcm, sample_rate, float(c), search_hops)
                   for c in candidate_offsets_seconds]
        best_off, best_val = max(refined, key=lambda t: t[1])
        hop_s = self.config.hop_size / float(sample_rate)
        rival = max((val for off, val in refined if abs(off - best_off) > hop_s), default=0.0)
        return best_off, best_val, best_val / max(rival, 1e-9)

    def refine_offset_with_pcm(self, query_pcm: torch.Tensor, reference_pcm: torch.Tensor,
                               sample_rate: int, coarse_offset_seconds: float,
                               search_hops: int = 24) -> float:
        """Sample-level refinement of a frame-level offset via GCC-PHAT."""
        return self._phat_refine(query_pcm, reference_pcm, sample_rate, coarse_offset_seconds,
                                 search_hops)[0]

    def truncate_to_alignment_pcm(self, pcm1, pcm2, sample_rate: int,
                                  alignment: AlignmentFeatures):
        """TruncateToAlignmentPCM (alignment.go:223-297): both PCMs cut to
        their overlap, less 0.5 s at each edge."""
        offset_seconds = alignment.temporal_offset
        offset_samples = int(round(abs(offset_seconds) * sample_rate))
        if offset_seconds > 0:
            start1, start2 = 0, offset_samples
            if start2 >= len(pcm2):
                raise ValueError(f"offset too large: need to skip {start2} samples but "
                                 f"pcm2 only has {len(pcm2)}")
            common = min(len(pcm1), len(pcm2) - start2)
        elif offset_seconds < 0:
            start1, start2 = offset_samples, 0
            if start1 >= len(pcm1):
                raise ValueError(f"offset too large: need to skip {start1} samples but "
                                 f"pcm1 only has {len(pcm1)}")
            common = min(len(pcm1) - start1, len(pcm2))
        else:
            start1, start2 = 0, 0
            common = min(len(pcm1), len(pcm2))
        if common <= 0:
            raise ValueError("no overlapping audio after alignment")
        pad = int(0.5 * sample_rate)
        if common > 2 * pad:
            start1 += pad
            start2 += pad
            common -= 2 * pad
        return pcm1[start1: start1 + common], pcm2[start2: start2 + common]

    def align_audio_files(self, query_pcm: torch.Tensor, reference_pcm: torch.Tensor,
                          sample_rate: int, verify_top_peaks: Optional[int] = None
                          ) -> AlignmentFeatures:
        """AlignAudioFiles (alignment.go:489-553): energy-series hybrid
        alignment, then the PCM verification (None: adaptive, on a comb-
        ambiguous or low-overlap answer; 1: never; K > 1: always)."""
        query_pcm, reference_pcm = self._tensor(query_pcm), self._tensor(reference_pcm)
        hop = self.config.hop_size
        q = short_time_energy(query_pcm, self.config.window_size, hop)
        r = short_time_energy(reference_pcm, self.config.window_size, hop)
        min_frames = min(q.shape[-1], r.shape[-1])
        max_lag_frames = min(self.max_lag_samples // hop, min_frames - 1)
        res = self._analyzer("hybrid", max_lag_frames).align_features(q[:, None], r[:, None],
                                                                      sample_rate)
        t1, t2 = int(q.shape[-1]), int(r.shape[-1])

        def _overlap_frames(lag: float) -> float:
            return max(0.0, min(t1, t2 - lag) - max(0.0, -lag))

        chosen_lag = -res.offset_seconds * sample_rate / hop
        low_overlap = _overlap_frames(chosen_lag) < _VERIFY_OVERLAP * min_frames
        if verify_top_peaks is None:
            k = _VERIFY_TOP_K if (res.ambiguity > _AMBIGUITY_ONSET or low_overlap) else 1
        else:
            k = verify_top_peaks
        if k > 1 and res.cross_corr_result is not None:
            corr = res.cross_corr_result.correlations.cpu().numpy()
            lags = res.cross_corr_result.lags.cpu().numpy()
            order = np.argsort(-np.abs(corr))
            picked: list = []
            min_sep = max(int(0.1 * sample_rate / hop), 2)
            for i in order:
                if len(picked) >= k:
                    break
                if all(abs(int(lags[i]) - p) >= min_sep for p in picked):
                    picked.append(int(lags[i]))
            ho_mask = np.array([_overlap_frames(float(lg)) >= _VERIFY_OVERLAP * min_frames
                                for lg in lags])
            if ho_mask.any():
                ho_lag = int(lags[np.argmax(np.where(ho_mask, np.abs(corr), -np.inf))])
                if all(abs(ho_lag - p) >= min_sep for p in picked):
                    picked.append(ho_lag)
            candidates = [-p * hop / float(sample_rate) for p in picked]
            if res.offset_seconds not in candidates:
                candidates.append(res.offset_seconds)
            glob_off, glob_val = self._phat_global(query_pcm, reference_pcm, sample_rate)
            if glob_val >= _VERIFY_FLOOR:
                candidates.append(glob_off)
            best_off, best_val, margin = self.verify_candidate_offsets(
                query_pcm, reference_pcm, sample_rate, candidates)
            res.offset = int(round(best_off * sample_rate))
            res.offset_seconds = best_off
            if best_val >= _VERIFY_FLOOR and margin >= _VERIFY_MARGIN:
                restored = correlation_confidence(res.cross_corr_result)
                res.confidence = max(res.confidence, restored, min(_VERIFY_CONF_CAP, best_val))
        fa = FeatureAlignment(res, "energy", True)
        return AlignmentFeatures(
            best_alignment=fa,
            corr_alignment=fa if res.cross_corr_result is not None else None,
            temporal_offset=res.offset_seconds, offset_confidence=res.confidence,
            alignment_similarity=res.similarity, alignment_quality=res.alignment_quality,
            method="energy_correlation",
            query_length=query_pcm.shape[-1] / float(sample_rate),
            reference_length=reference_pcm.shape[-1] / float(sample_rate),
            feature_similarity={"energy": res.similarity},
        )

    @staticmethod
    def get_alignment_summary(features: Optional[AlignmentFeatures]) -> dict:
        """GetAlignmentSummary (alignment.go:556-591)."""
        if features is None:
            return {"status": "failed"}
        conf = features.offset_confidence
        desc = ("excellent" if conf > 0.8 else "good" if conf > 0.6
                else "fair" if conf > 0.4 else "poor")
        return {
            "status": "success", "method": features.method,
            "offset_seconds": features.temporal_offset,
            "similarity_percent": features.alignment_similarity * 100,
            "confidence_percent": conf * 100,
            "quality_percent": features.alignment_quality * 100,
            "quality_description": desc,
            "time_stretch_factor": features.time_stretch,
            "time_stretch_detected": abs(features.time_stretch - 1.0) > 0.05,
        }
