"""Fingerprint comparison: similarity scoring, matching, batch search
(counterpart of `sonido_sonar_tpu/fingerprint/comparison.py`).

Reference parity: fingerprint/comparison.go —
  method map fast -> cosine(+hash 0.5/0.5), precise -> pearson(feature
  1.0), auto -> adaptive(0.3/0.7) — hash path vestigial (:87-133);
  per-feature similarity:
    MFCC = cosine of per-coefficient (mean, std) stats vector; the
    sequence/DTW variants are implemented upstream but disabled —
    only the stats-cosine term is live (:344-401, quirk #3);
    spectral = mean of per-series (mean, std) cosines over centroid/
    rolloff/flux (:646-671);
    chroma = cosine of time-averaged 12-d vectors (:673-688);
    temporal / speech / harmonic = scalar ratios + sequence stats
    (:690-770);
  weighted mean with per-content weight tables (:1055-1104);
  OverallSimilarity = FeatureSimilarity (:886-889, quirk #4);
  confidence heuristic (:1011-1037); match classes (:1040-1052);
  quality metrics incl. availability/coverage/temporal alignment/noise
  (:892-1008); FindBestMatches (:197-263); BatchCompare (:1107-1151).

The host comparator is numpy float64, as in JAX. A fingerprint's leaves
may be numpy arrays, Python scalars or tensors on any device (the
generator's `generate_fingerprint` leaves them on its device); `_to_np`
reads each one. Corpus search packs each fingerprint into a statistics
vector and scores the corpus on a device (`device_compare.py`): a
packed corpus's tensors decide where it runs, and the comparator's
`device` (the card unless the caller asks for the CPU) where a list of
fingerprints is packed.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from sonido_sonar_tpu_torch.config.config import (
    ComparisonConfig,
    ContentType,
    default_comparison_config,
)
from sonido_sonar_tpu_torch.fingerprint.generator import AudioFingerprint
from sonido_sonar_tpu_torch.logging import get_global_logger
from sonido_sonar_tpu_torch.utils.device import DEFAULT_DEVICE, Device


@dataclass
class ComparisonQualityMetrics:
    """ComparisonQualityMetrics (comparison.go:55-66)."""

    data_availability: float = 0.0
    feature_coverage: float = 0.0
    temporal_alignment: float = 0.0
    noise_level: float = 0.0
    dynamic_range_match: float = 0.5
    spectral_coherence: float = 0.5


@dataclass
class SimilarityResult:
    """SimilarityResult (comparison.go:20-53)."""

    fingerprint1_id: str
    fingerprint2_id: str
    overall_similarity: float
    feature_similarity: float
    hash_similarity: float = 0.0
    content_type_match: bool = False
    match_type: str = "weak"
    confidence: float = 0.0
    feature_distances: Dict[str, float] = field(default_factory=dict)
    quality_metrics: Optional[ComparisonQualityMetrics] = None
    processing_time: float = 0.0


@dataclass
class Match:
    """Match (comparison.go FindBestMatches result)."""

    fingerprint: AudioFingerprint
    similarity: SimilarityResult
    rank: int


def _to_np(x) -> np.ndarray:
    """A feature leaf as float64 numpy: a tensor from its device, anything
    else through `np.asarray`."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _size(x) -> int:
    """Element count of a feature leaf (a tensor is not read)."""
    return x.numel() if isinstance(x, torch.Tensor) else np.asarray(x).size


def cosine_similarity(v1: np.ndarray, v2: np.ndarray) -> float:
    """comparison.go:858-873."""
    if len(v1) != len(v2) or len(v1) == 0:
        return 0.0
    n1 = float(np.linalg.norm(v1))
    n2 = float(np.linalg.norm(v2))
    if n1 == 0 or n2 == 0:
        return 0.0
    return float(np.dot(v1, v2) / (n1 * n2))


def compare_scalar(v1: float, v2: float) -> float:
    """comparison.go:843-856: 1 - |d|/max(|v1|,|v2|)."""
    if v1 == 0 and v2 == 0:
        return 1.0
    max_v = max(abs(v1), abs(v2))
    if max_v == 0:
        return 1.0
    return max(0.0, 1.0 - abs(v1 - v2) / max_v)


def compare_sequence_stats(s1: np.ndarray, s2: np.ndarray) -> float:
    """cosine of (mean, std) pairs (comparison.go:826-841). Uses gonum's
    sample variance (N-1), reproduced here."""
    if len(s1) == 0 or len(s2) == 0:
        return 0.0
    f1 = np.array([s1.mean(), np.sqrt(s1.var(ddof=1)) if len(s1) > 1 else 0.0])
    f2 = np.array([s2.mean(), np.sqrt(s2.var(ddof=1)) if len(s2) > 1 else 0.0])
    return cosine_similarity(f1, f2)


def extract_mfcc_statistics(mfcc: np.ndarray) -> np.ndarray:
    """[T, C] -> [2C] (means then stds per coefficient)
    (comparison.go:774-800)."""
    if mfcc.size == 0:
        return np.zeros(0)
    means = mfcc.mean(axis=0)
    stds = np.sqrt(mfcc.var(axis=0, ddof=1)) if mfcc.shape[0] > 1 else np.zeros_like(means)
    return np.concatenate([means, stds])


# per-content comparator weights (comparison.go:1055-1104)
_CONTENT_WEIGHTS: Dict[ContentType, Dict[str, float]] = {
    ContentType.NEWS: {
        "mfcc": 0.50, "spectral": 0.25, "temporal": 0.15, "speech": 0.10,
        "chroma": 0.05, "harmonic": 0.05, "energy": 0.10,
    },
    ContentType.TALK: {
        "mfcc": 0.50, "spectral": 0.25, "temporal": 0.15, "speech": 0.10,
        "chroma": 0.05, "harmonic": 0.05, "energy": 0.10,
    },
    ContentType.MUSIC: {
        "mfcc": 0.30, "chroma": 0.25, "spectral": 0.20, "harmonic": 0.15,
        "temporal": 0.10, "speech": 0.05, "energy": 0.10,
    },
    ContentType.SPORTS: {
        "energy": 0.30, "temporal": 0.25, "mfcc": 0.25, "spectral": 0.20,
        "speech": 0.10, "chroma": 0.05, "harmonic": 0.05,
    },
}
_DEFAULT_WEIGHTS = {
    "mfcc": 0.35, "spectral": 0.25, "temporal": 0.20, "energy": 0.15,
    "chroma": 0.10, "speech": 0.10, "harmonic": 0.10,
}


def _copy_to_host_async(out: Dict[str, torch.Tensor]):
    """(host tensors, event): each leaf copied into pinned host memory
    without a wait, and an event recorded after the copies; the reader
    waits on that event alone. CPU leaves are returned as they are, with
    no event."""
    if not any(v.is_cuda for v in out.values()):
        return out, None
    host = {}
    for k, v in out.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _to_host(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every leaf of a device result as numpy, after one wait."""
    host, event = _copy_to_host_async(out)
    if event is not None:
        event.synchronize()
    return {k: v.numpy() for k, v in host.items()}


class FingerprintComparator:
    """FingerprintComparator (comparison.go:69-131). `device` is where a
    list of candidates is packed and scored (the card unless the caller
    asks for the CPU); a PackedCorpus is searched on its own device."""

    def __init__(self, config: Optional[ComparisonConfig] = None, device: Device = DEFAULT_DEVICE):
        self.config = config or default_comparison_config()
        self.device = torch.device(device)
        method = self.config.method
        # method map (comparison.go:87-113); hash path vestigial
        if method == "fast":
            self.internal_method = "cosine"
            self.hash_weight, self.feature_weight = 0.5, 0.5
        elif method == "precise":
            self.internal_method = "pearson"
            self.hash_weight, self.feature_weight = 0.0, 1.0
        else:
            self.internal_method = "adaptive"
            self.hash_weight, self.feature_weight = 0.3, 0.7
        self._log = get_global_logger().with_component("fingerprint_comparator")

    def validate_config(self) -> None:
        """comparison.go:1208-1223."""
        if not 0.0 <= self.config.similarity_threshold <= 1.0:
            raise ValueError("similarity_threshold must be in [0, 1]")
        if self.config.method not in ("auto", "precise", "fast"):
            raise ValueError(f"unknown method {self.config.method}")

    # ------------------------------------------------------------------
    def compare(self, fp1: AudioFingerprint, fp2: AudioFingerprint) -> SimilarityResult:
        """Compare (comparison.go:133-194)."""
        t0 = time.monotonic()
        result = SimilarityResult(
            fingerprint1_id=fp1.id,
            fingerprint2_id=fp2.id,
            overall_similarity=0.0,
            feature_similarity=0.0,
            content_type_match=(fp1.content_type == fp2.content_type),
        )
        if self.config.enable_content_filter and not result.content_type_match:
            result.processing_time = (time.monotonic() - t0) * 1000
            return result

        result.feature_similarity = self._feature_similarity(fp1, fp2, result)
        # OverallSimilarity = FeatureSimilarity (comparison.go:886-889)
        result.overall_similarity = result.feature_similarity
        if self.config.enable_detailed_metrics:
            result.quality_metrics = self._quality_metrics(fp1, fp2, result)
        result.confidence = self._confidence(result)
        result.match_type = classify_match(result.overall_similarity)
        result.processing_time = (time.monotonic() - t0) * 1000
        return result

    # ------------------------------------------------------------------
    def _effective_weights(self, fp: AudioFingerprint) -> Dict[str, float]:
        """getEffectiveWeights (comparison.go:1055-1104)."""
        w = fp.metadata.get("feature_weights")
        if isinstance(w, dict) and w:
            return w
        return _CONTENT_WEIGHTS.get(fp.content_type, _DEFAULT_WEIGHTS)

    def _weight_vector(self, fp: AudioFingerprint) -> np.ndarray:
        """[6] float32 effective weights in FEATURE_ORDER."""
        from sonido_sonar_tpu_torch.fingerprint.device_compare import FEATURE_ORDER

        w = self._effective_weights(fp)
        return np.array([w.get(k, 0.0) for k in FEATURE_ORDER], dtype=np.float32)

    def _feature_similarity(
        self, fp1: AudioFingerprint, fp2: AudioFingerprint, result: SimilarityResult
    ) -> float:
        """calculateFeatureSimilarity (comparison.go:266-341)."""
        f1, f2 = fp1.features, fp2.features
        if f1 is None or f2 is None:
            raise ValueError("features cannot be None")
        sims: List[float] = []
        weights: List[float] = []
        w = self._effective_weights(fp1)

        def _nonempty(x) -> bool:
            # Go gates MFCC/chroma on len(...) > 0 (comparison.go:285,301)
            return x is not None and _size(x) > 0

        for name, a, b, fn in (
            ("mfcc", f1.mfcc, f2.mfcc, self._compare_mfcc),
            ("spectral", f1.spectral_features, f2.spectral_features, self._compare_spectral),
            ("chroma", f1.chroma_features, f2.chroma_features, self._compare_chroma),
            ("temporal", f1.temporal_features, f2.temporal_features, self._compare_temporal),
            ("speech", f1.speech_features, f2.speech_features, self._compare_speech),
            ("harmonic", f1.harmonic_features, f2.harmonic_features, self._compare_harmonic),
        ):
            gate = _nonempty if name in ("mfcc", "chroma") else (lambda x: x is not None)
            if gate(a) and gate(b):
                sim = fn(a, b)
                sims.append(sim)
                weights.append(w.get(name, 0.0))
                result.feature_distances[name] = 1.0 - sim

        if not sims:
            raise ValueError("no comparable features found")
        wsum = sum(weights)
        if wsum == 0:
            return float(np.mean(sims))
        return float(np.average(sims, weights=weights))

    @staticmethod
    def _compare_mfcc(m1, m2) -> float:
        """compareMFCC stats-cosine term (comparison.go:344-401)."""
        s1 = extract_mfcc_statistics(_to_np(m1))
        s2 = extract_mfcc_statistics(_to_np(m2))
        if len(s1) == 0 or len(s2) == 0 or len(s1) != len(s2):
            return 0.0
        return cosine_similarity(s1, s2)

    @staticmethod
    def _series_sims(pairs) -> float:
        """Mean of the sequence-stats cosines of the pairs whose series are
        both present and non-empty (the per-series `len(...) > 0` gates
        of comparison.go:650-663, :706-771), 0 when none is."""
        sims = [
            compare_sequence_stats(_to_np(a), _to_np(b))
            for a, b in pairs
            if a is not None and b is not None and _size(a) and _size(b)
        ]
        return float(np.mean(sims)) if sims else 0.0

    @staticmethod
    def _compare_spectral(sf1, sf2) -> float:
        """compareSpectralFeatures (comparison.go:646-671): centroid,
        rolloff, flux sequence-stats cosines averaged."""
        return FingerprintComparator._series_sims((
            (sf1.spectral_centroid, sf2.spectral_centroid),
            (sf1.spectral_rolloff, sf2.spectral_rolloff),
            (sf1.spectral_flux, sf2.spectral_flux),
        ))

    @staticmethod
    def _compare_chroma(c1, c2) -> float:
        """compareChromaFeatures (comparison.go:673-688)."""
        m1 = _to_np(c1).mean(axis=0)
        m2 = _to_np(c2).mean(axis=0)
        return cosine_similarity(m1, m2)

    @staticmethod
    def _compare_temporal(t1, t2) -> float:
        """compareTemporalFeatures (comparison.go:690-718)."""
        sims = []
        dr1, dr2 = float(t1.dynamic_range), float(t2.dynamic_range)
        if dr1 > 0 and dr2 > 0:
            sims.append(compare_scalar(dr1, dr2))
        sims.append(compare_scalar(float(t1.silence_ratio), float(t2.silence_ratio)))
        od1, od2 = float(t1.onset_density), float(t2.onset_density)
        if od1 > 0 and od2 > 0:
            sims.append(compare_scalar(od1, od2))
        a, b = t1.rms_energy, t2.rms_energy
        if a is not None and b is not None and _size(a) and _size(b):
            sims.append(compare_sequence_stats(_to_np(a), _to_np(b)))
        return float(np.mean(sims)) if sims else 0.0

    @staticmethod
    def _compare_speech(s1, s2) -> float:
        """compareSpeechFeatures (comparison.go:722-750)."""
        sims = []
        r1, r2 = float(s1.speech_rate), float(s2.speech_rate)
        if r1 > 0 and r2 > 0:
            sims.append(compare_scalar(r1, r2))
        v1, v2 = float(s1.vocal_tract_length), float(s2.vocal_tract_length)
        if v1 > 0 and v2 > 0:
            sims.append(compare_scalar(v1, v2))
        a, b = s1.voicing_probability, s2.voicing_probability
        if a is not None and b is not None and _size(a) and _size(b):
            sims.append(compare_sequence_stats(_to_np(a), _to_np(b)))
        return float(np.mean(sims)) if sims else 0.0

    @staticmethod
    def _compare_harmonic(h1, h2) -> float:
        """compareHarmonicFeatures (comparison.go:752-770)."""
        return FingerprintComparator._series_sims((
            (h1.harmonic_ratio, h2.harmonic_ratio),
            (h1.pitch_estimate, h2.pitch_estimate),
        ))

    # ------------------------------------------------------------------
    def _quality_metrics(
        self, fp1: AudioFingerprint, fp2: AudioFingerprint, result: SimilarityResult
    ) -> ComparisonQualityMetrics:
        """calculateQualityMetrics (comparison.go:892-1008)."""
        m = ComparisonQualityMetrics()
        f1, f2 = fp1.features, fp2.features
        total = 6
        available = sum(
            1
            for a, b in (
                (f1.mfcc, f2.mfcc),
                (f1.spectral_features, f2.spectral_features),
                (f1.chroma_features, f2.chroma_features),
                (f1.temporal_features, f2.temporal_features),
                (f1.speech_features, f2.speech_features),
                (f1.harmonic_features, f2.harmonic_features),
            )
            if a is not None and b is not None
        )
        m.data_availability = available / total
        m.feature_coverage = len(result.feature_distances) / total

        dur_diff = abs(fp1.duration - fp2.duration)
        max_dur = max(fp1.duration, fp2.duration)
        m.temporal_alignment = 1.0 - min(1.0, dur_diff / max_dur) if max_dur > 0 else 1.0

        # noise level from similarity variance (comparison.go:938-963):
        # 0.5 (unknown) when no per-feature distances exist, 0.0 for a
        # single one, else sqrt(sample variance) capped at 1
        sims = [1.0 - d for d in result.feature_distances.values()]
        if not sims:
            m.noise_level = 0.5
        elif len(sims) == 1:
            m.noise_level = 0.0
        else:
            m.noise_level = min(1.0, float(np.sqrt(np.var(sims, ddof=1))))

        # dynamic range match
        if f1.temporal_features is not None and f2.temporal_features is not None:
            dr1 = float(f1.temporal_features.dynamic_range)
            dr2 = float(f2.temporal_features.dynamic_range)
            m.dynamic_range_match = compare_scalar(dr1, dr2) if dr1 > 0 and dr2 > 0 else 0.5

        # spectral coherence: mean of |Pearson| over centroid AND rolloff
        # series (comparison.go:977-1008); NaN correlations (constant
        # series) are skipped, none valid -> 0.5
        if f1.spectral_features is not None and f2.spectral_features is not None:
            coherences = []
            for a, b in (
                (f1.spectral_features.spectral_centroid,
                 f2.spectral_features.spectral_centroid),
                (f1.spectral_features.spectral_rolloff,
                 f2.spectral_features.spectral_rolloff),
            ):
                if a is None or b is None:
                    continue
                s1, s2 = _to_np(a), _to_np(b)
                n = min(len(s1), len(s2))
                if n > 1:
                    with np.errstate(divide="ignore", invalid="ignore"):
                        corr = np.corrcoef(s1[:n], s2[:n])[0, 1]
                    if np.isfinite(corr):
                        coherences.append(abs(corr))
            m.spectral_coherence = float(np.mean(coherences)) if coherences else 0.5
        return m

    def _confidence(self, result: SimilarityResult) -> float:
        """calculateConfidence (comparison.go:1011-1037)."""
        confidence = 0.5
        if result.overall_similarity > 0.8:
            confidence += 0.3
        elif result.overall_similarity > 0.6:
            confidence += 0.2
        if result.content_type_match:
            confidence += 0.1
        confidence += len(result.feature_distances) * 0.05
        if result.quality_metrics is not None:
            confidence += result.quality_metrics.data_availability * 0.1
            confidence -= result.quality_metrics.noise_level * 0.1
        return max(0.0, min(1.0, confidence))

    # ------------------------------------------------------------------
    def find_best_matches(
        self,
        query: AudioFingerprint,
        candidates: List[AudioFingerprint],
        max_results: int = 0,
        use_device_prefilter: bool = True,
        prefilter_threshold: int = 0,
        mesh=None,
    ) -> List[Match]:
        """FindBestMatches (comparison.go:197-263): threshold + sort +
        rank.

        Default path: the whole candidate set is scored on the
        comparator's device (device_compare: packed statistics, one
        scoring and top-k pass; no per-candidate Python loop).
        `use_device_prefilter=False` keeps the host per-pair loop (the
        float64 parity path). `prefilter_threshold` is kept for API
        compatibility: device scoring engages above it (default 0 =
        always). With enable_detailed_metrics the device pass also
        computes the quality chain (batched_similarity_detailed). With
        `mesh` the packed corpus is sharded over its "data" axis (the
        full-[C] pass, `batch_compare_device`)."""
        from sonido_sonar_tpu_torch.fingerprint.device_compare import PackedCorpus

        max_results = max_results or self.config.max_candidates
        use_device = use_device_prefilter and len(candidates) > prefilter_threshold
        if not use_device:
            results = self.batch_compare(query, candidates)
            by_id = {c.id: c for c in candidates if c is not None}
            matches = [
                Match(by_id[r.fingerprint2_id], r, 0)
                for r in results
                if r.overall_similarity >= self.config.similarity_threshold
            ]
        elif self.config.enable_detailed_metrics or mesh is not None:
            # quality chain / sharded corpus: the full-[C] device pass
            cands = [c for c in candidates if c is not None and c.id != query.id]
            results = self.batch_compare_device(query, cands, mesh=mesh)
            matches = [
                Match(c, r, 0)
                for c, r in zip(cands, results)
                if r.overall_similarity >= self.config.similarity_threshold
            ]
        else:
            # default corpus search: pack + one top-k pass; only the
            # winning rows are fetched and only they become host objects
            cands = [c for c in candidates if c is not None]
            return self.search_corpus(query, PackedCorpus.build(cands, device=self.device), max_results)
        matches.sort(key=lambda m: m.similarity.overall_similarity, reverse=True)
        matches = matches[:max_results]
        for i, m in enumerate(matches):
            m.rank = i + 1
        return matches

    def search_corpus(self, query: AudioFingerprint, corpus, max_results: int = 0) -> List[Match]:
        """FindBestMatches against a pre-packed corpus
        (device_compare.PackedCorpus), the monitor's repeated search:
        pack the query (one clip, host), score and select the top k on
        the corpus's device, fetch only the k winning rows, and build
        host Match objects for those alone. Results equal
        find_best_matches over the same candidates (modulo float32
        rounding and ties at the cut)."""
        if self.config.enable_detailed_metrics:
            return self.find_best_matches(
                query, corpus.fingerprints, max_results,
                use_device_prefilter=True, prefilter_threshold=0,
            )
        if len(corpus) == 0:
            return []
        max_results = max_results or self.config.max_candidates
        out = _to_host(self._dispatch_topk(query, corpus, max_results))
        return self._matches_from_topk(query, corpus, out, max_results)

    def _dispatch_topk(self, query, corpus, max_results: int) -> Dict[str, torch.Tensor]:
        """Pack the query and launch scoring + top-k on the corpus's
        device, without a wait (the result's leaves are device
        tensors)."""
        from sonido_sonar_tpu_torch.fingerprint.device_compare import (
            content_code,
            pack_comparator_stats,
            topk_similarity,
        )

        qv = pack_comparator_stats(query, corpus.width)
        return topk_similarity(
            qv, corpus.matrix, self._weight_vector(query),
            corpus.codes == content_code(query.content_type),
            k=min(max_results + 4, len(corpus)),
            num_mfcc_coeffs=corpus.width,
            content_filter=self.config.enable_content_filter,
        )

    def search_corpus_stream(self, queries, corpus, max_results: int = 0, depth: int = 4):
        """Pipelined search_corpus over an iterable of queries: up to
        `depth` searches stay in flight. Each dispatch copies its k-row
        result into pinned host memory without a wait and records a CUDA
        event after the copies; a result is read once its event has
        passed, so the device's work and copies for queries i+1..i+depth
        overlap the host's reading of query i. On the CPU these are plain
        calls.

        Yields one Match list per query, in input order."""
        if self.config.enable_detailed_metrics:
            for q in queries:
                yield self.search_corpus(q, corpus, max_results)
            return
        max_results = max_results or self.config.max_candidates
        inflight = collections.deque()

        def _drain():
            q, host, event = inflight.popleft()
            if event is not None:
                event.synchronize()
            out = {k: v.numpy() for k, v in host.items()}
            return self._matches_from_topk(q, corpus, out, max_results)

        for q in queries:
            host, event = _copy_to_host_async(self._dispatch_topk(q, corpus, max_results))
            inflight.append((q, host, event))
            if len(inflight) > depth:
                yield _drain()
        while inflight:
            yield _drain()

    def _result_from_row(self, query, cand, out, idx) -> SimilarityResult:
        """A SimilarityResult from one row of a top-k result (`idx`
        indexes every leaf: a row, or (query, row))."""
        from sonido_sonar_tpu_torch.fingerprint.device_compare import FEATURE_ORDER, MATCH_CLASSES

        sim = float(out["overall"][idx])
        is_match = bool(out["content_match"][idx])
        r = SimilarityResult(
            fingerprint1_id=query.id,
            fingerprint2_id=cand.id,
            overall_similarity=sim,
            feature_similarity=sim,
            content_type_match=is_match,
            match_type=MATCH_CLASSES[int(out["match_class"][idx])],
            confidence=float(out["confidence"][idx]),
        )
        if self.config.enable_content_filter and not is_match:
            r.match_type = "weak"
            r.confidence = 0.0
        else:
            for j, name in enumerate(FEATURE_ORDER):
                if bool(out["feature_present"][idx][j]):
                    r.feature_distances[name] = 1.0 - float(out["feature_sims"][idx][j])
        return r

    def _ranked_matches(self, query, cands, out, row_of, n_rows: int, max_results: int) -> List[Match]:
        """Match objects from a top-k result's rows: self skipped, cut at
        the threshold (rows are sorted descending) and at max_results,
        ranked from 1."""
        matches: List[Match] = []
        for row in range(n_rows):
            idx = row_of(row)
            cand = cands[int(out["index"][idx])]
            if cand.id == query.id:
                continue
            if float(out["overall"][idx]) < self.config.similarity_threshold:
                break  # rows are sorted descending; nothing further passes
            matches.append(Match(cand, self._result_from_row(query, cand, out, idx), 0))
            if len(matches) >= max_results:
                break
        for i, m in enumerate(matches):
            m.rank = i + 1
        return matches

    def _matches_from_topk(self, query, corpus, out, max_results: int) -> List[Match]:
        return self._ranked_matches(
            query, corpus.fingerprints, out, lambda row: row, len(out["index"]), max_results)

    def find_best_matches_multi(
        self,
        queries: List[AudioFingerprint],
        candidates: List[AudioFingerprint],
        max_results: int = 0,
    ) -> List[List[Match]]:
        """Fleet corpus search: every query scored against the whole
        candidate corpus in one device pass
        (device_compare.topk_similarity_multi). The reference runs
        FindBestMatches per monitored stream inside its worker pool
        (comparison.go:197-263). Returns one Match list per query,
        ordered like `queries`; each list matches find_best_matches for
        that query (modulo float32 rounding, as for the single-query
        device path).

        Detailed-metrics configs fall back to per-query
        find_best_matches: the quality chain needs the per-pair series
        comparisons (batched_similarity_detailed)."""
        if self.config.enable_detailed_metrics:
            return [self.find_best_matches(q, candidates, max_results) for q in queries]
        from sonido_sonar_tpu_torch.fingerprint.device_compare import (
            comparator_matrix,
            content_code,
            pack_comparator_stats,
            topk_similarity_multi,
        )

        if not queries:
            return []
        max_results = max_results or self.config.max_candidates
        cands = [c for c in candidates if c is not None]
        if not cands:
            return [[] for _ in queries]
        corpus, width = comparator_matrix(cands)
        qmat = np.stack([pack_comparator_stats(q, width) for q in queries])
        weights = np.stack([self._weight_vector(q) for q in queries])
        q_codes = np.array([content_code(q.content_type) for q in queries], np.int32)
        c_codes = np.array([content_code(c.content_type) for c in cands], np.int32)
        # scoring + selection in one pass: the fetch is [Q, k] rows
        # instead of [Q, C] matrices, and the host loop touches only the
        # winners instead of Q*C pairs
        out = _to_host(topk_similarity_multi(
            qmat, corpus, weights, q_codes, c_codes,
            k=min(max_results + 4, len(cands)),
            num_mfcc_coeffs=width,
            content_filter=self.config.enable_content_filter,
            device=self.device,
        ))
        n_rows = out["index"].shape[1]
        return [
            self._ranked_matches(q, cands, out, lambda row, qi=qi: (qi, row), n_rows, max_results)
            for qi, q in enumerate(queries)
        ]

    def batch_compare_device(
        self,
        query: AudioFingerprint,
        candidates: List[AudioFingerprint],
        mesh=None,
    ) -> List[SimilarityResult]:
        """Batched Compare over all candidates in one device pass over the
        packed statistics (device_compare). Returns SimilarityResults in
        candidate order (no skipping — the caller filters None/self).
        Matches the host `compare` to float32 rounding; with
        enable_detailed_metrics the quality chain (comparison.go:892-1008)
        runs in the same pass. With `mesh` the candidates are sharded
        over its "data" axis (device_compare.sharded_batched_similarity)."""
        from sonido_sonar_tpu_torch.fingerprint.device_compare import (
            FEATURE_ORDER,
            MATCH_CLASSES,
            comparator_matrix,
            pack_comparator_stats,
            pack_quality_extras,
            quality_matrix,
            sharded_batched_similarity,
        )

        if not candidates:
            return []
        t0 = time.monotonic()
        corpus, width = comparator_matrix(candidates)
        qv = pack_comparator_stats(query, width)
        match = np.array([query.content_type == c.content_type for c in candidates], dtype=bool)
        detailed = self.config.enable_detailed_metrics
        quality = None
        if detailed:
            c_avail, c_dur, c_series, c_len = quality_matrix(candidates)
            q_avail, q_dur, q_series, q_len = pack_quality_extras(query, c_series.shape[-1])
            quality = (q_avail, q_dur, q_series, q_len, c_avail, c_dur, c_series, c_len)
        out = sharded_batched_similarity(
            qv, corpus, self._weight_vector(query), match, mesh=mesh, num_mfcc_coeffs=width,
            content_filter=self.config.enable_content_filter,
            quality=quality, device=self.device,
        )
        elapsed = (time.monotonic() - t0) * 1000
        results = []
        for i, cand in enumerate(candidates):
            sim = float(out["overall"][i])
            r = SimilarityResult(
                fingerprint1_id=query.id,
                fingerprint2_id=cand.id,
                overall_similarity=sim,
                feature_similarity=sim,
                content_type_match=bool(match[i]),
                match_type=MATCH_CLASSES[int(out["match_class"][i])],
                confidence=float(out["confidence"][i]),
                processing_time=elapsed / len(candidates),
            )
            filtered = self.config.enable_content_filter and not match[i]
            if detailed and not filtered:
                # host early-out leaves quality_metrics None when the
                # content filter rejects (comparison.go:160-166)
                r.quality_metrics = ComparisonQualityMetrics(
                    data_availability=float(out["data_availability"][i]),
                    feature_coverage=float(out["feature_coverage"][i]),
                    temporal_alignment=float(out["temporal_alignment"][i]),
                    noise_level=float(out["noise_level"][i]),
                    dynamic_range_match=float(out["dynamic_range_match"][i]),
                    spectral_coherence=float(out["spectral_coherence"][i]),
                )
            if not filtered:
                for j, name in enumerate(FEATURE_ORDER):
                    if bool(out["feature_present"][i, j]):
                        r.feature_distances[name] = 1.0 - float(out["feature_sims"][i, j])
            else:
                # content-filter early-out (comparison.go:160-166)
                r.match_type = "weak"
                r.confidence = 0.0
            results.append(r)
        return results

    def batch_compare(
        self, query: AudioFingerprint, candidates: List[AudioFingerprint]
    ) -> List[SimilarityResult]:
        """BatchCompare (comparison.go:1107-1151): skip None/self, keep
        going on failures."""
        results = []
        for cand in candidates:
            if cand is None or cand.id == query.id:
                continue
            try:
                results.append(self.compare(query, cand))
            except Exception as e:  # keep going (comparison.go:1130-1140)
                self._log.warn("comparison failed", candidate=cand.id, error=str(e))
        return results


def classify_match(similarity: float) -> str:
    """classifyMatch (comparison.go:1040-1052)."""
    if similarity >= 0.95:
        return "exact"
    if similarity >= 0.85:
        return "very_similar"
    if similarity >= 0.75:
        return "similar"
    if similarity >= 0.6:
        return "somewhat_similar"
    return "weak"


def get_similarity_statistics(results: List[SimilarityResult]) -> Dict[str, float]:
    """GetSimilarityStatistics (comparison.go:1154-1206)."""
    if not results:
        return {}
    sims = np.array([r.overall_similarity for r in results])
    confs = np.array([r.confidence for r in results])
    return {
        "mean_similarity": float(sims.mean()),
        "max_similarity": float(sims.max()),
        "min_similarity": float(sims.min()),
        "std_similarity": float(sims.std()),
        "mean_confidence": float(confs.mean()),
        "count": float(len(results)),
    }


# ---------------------------------------------------------------------
# Upstream-disabled MFCC similarity variants (comparison.go:404-609 —
# implemented in the reference but commented out of the live path,
# SURVEY.md quirk #3). Available here as opt-in functions; they run on
# the device of a tensor input, else on `device`.
# ---------------------------------------------------------------------

def _variant_device(m, device: Device) -> torch.device:
    return m.device if isinstance(m, torch.Tensor) else torch.device(device)


def compare_mfcc_sequences(m1, m2, num_coeffs: int = 10, device: Device = DEFAULT_DEVICE) -> float:
    """compareMFCCSequences (comparison.go:404-470): per-coefficient
    sequence cross-correlation peak over the first <=10 coefficients,
    averaged."""
    from sonido_sonar_tpu_torch.ops.stats.correlation import cross_correlate_pearson

    dev = _variant_device(m1, device)
    a = _to_np(m1)
    b = _to_np(m2)
    if a.size == 0 or b.size == 0:
        return 0.0
    k = min(a.shape[1], b.shape[1], num_coeffs)
    max_lag = min(len(a), len(b)) // 4
    sims = []
    for c in range(k):
        res = cross_correlate_pearson(
            torch.as_tensor(a[:, c], dtype=torch.float32, device=dev),
            torch.as_tensor(b[:, c], dtype=torch.float32, device=dev),
            max_lag,
        )
        sims.append(abs(float(res.peak_correlation)))
    return float(np.mean(sims)) if sims else 0.0


def compare_mfcc_with_dtw(m1, m2, band: int = 50, device: Device = DEFAULT_DEVICE) -> float:
    """compareMFCCWithDTW (comparison.go:473-609): banded DTW over the
    MFCC frame sequences, normalized distance -> exp(-d) similarity."""
    from sonido_sonar_tpu_torch.ops.stats.dtw import dtw_align

    dev = _variant_device(m1, device)
    a = _to_np(m1).astype(np.float32)
    b = _to_np(m2).astype(np.float32)
    if a.size == 0 or b.size == 0:
        return 0.0
    res = dtw_align(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev),
                    constraint_band=band)
    avg_len = (len(a) + len(b)) / 2.0
    nd = float(res.distance) / max(avg_len, 1.0)
    return float(np.exp(-nd))


# content-aware combination weights for the three MFCC methods — the
# reference computes these but leaves the combination commented out
# (comparison.go:375-399); combine_mfcc_methods applies them.
_MFCC_COMBINE_WEIGHTS = {
    ContentType.MUSIC: (0.15, 0.35, 0.50),
    ContentType.TALK: (0.40, 0.35, 0.25),
    ContentType.NEWS: (0.40, 0.35, 0.25),
    ContentType.SPORTS: (0.25, 0.25, 0.50),
    ContentType.MIXED: (0.20, 0.30, 0.50),
}


def combine_mfcc_methods(
    stats_sim: float, seq_sim: float, dtw_sim: float,
    content_type: ContentType = ContentType.UNKNOWN,
) -> float:
    """The reference's intended (commented-out) per-content combination
    of stats/sequence/DTW MFCC similarities (comparison.go:375-399)."""
    ws, wq, wd = _MFCC_COMBINE_WEIGHTS.get(content_type, (0.30, 0.30, 0.40))
    return ws * stats_sim + wq * seq_sim + wd * dtw_sim
