"""Core config dataclasses, field for field the JAX package's
(`sonido_sonar_tpu/config/config.py`): same names, same defaults.

Reference parity: fingerprint/config/config.go:5-209 and
fingerprint/fingerprint.go:70-134, with the per-content factories.
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field, replace
from typing import Dict, Tuple


class ContentType(str, enum.Enum):
    """Content classes (config.go:39-48)."""

    MUSIC = "music"
    NEWS = "news"
    SPORTS = "sports"
    TALK = "talk"
    MIXED = "mixed"
    UNKNOWN = "unknown"


def to_content_type(s: str) -> ContentType:
    """config.go:50-65 — anything unrecognized maps to UNKNOWN."""
    try:
        return ContentType(s)
    except ValueError:
        return ContentType.UNKNOWN


class WindowType(str, enum.Enum):
    """Window families (analyzers/windowing.go:13-23)."""

    HANN = "hann"
    HAMMING = "hamming"
    BLACKMAN = "blackman"
    BLACKMAN_HARRIS = "blackman_harris"
    KAISER = "kaiser"
    TUKEY = "tukey"
    BARTLETT = "bartlett"
    WELCH = "welch"
    RECTANGULAR = "rectangular"


@dataclass(frozen=True)
class FeatureConfig:
    """Spectral/feature extraction config (config.go:13-37)."""

    sample_rate: int = 44100
    window_size: int = 2048
    hop_size: int = 512
    freq_range: Tuple[float, float] = (20.0, 20000.0)
    window_type: WindowType = WindowType.HANN

    enable_chroma: bool = True
    enable_mfcc: bool = True
    enable_spectral_contrast: bool = True
    enable_temporal_features: bool = True
    enable_speech_features: bool = False
    enable_harmonic_features: bool = False

    mfcc_coefficients: int = 13
    chroma_bins: int = 12
    contrast_bands: int = 6

    # (name, weight) pairs, a tuple so the config stays hashable
    similarity_weights: Tuple[Tuple[str, float], ...] = (
        ("mfcc", 0.40),
        ("spectral", 0.25),
        ("chroma", 0.20),
        ("temporal", 0.15),
    )
    match_threshold: float = 0.85

    def weights_dict(self) -> Dict[str, float]:
        return dict(self.similarity_weights)

    def with_(self, **kw) -> "FeatureConfig":
        return replace(self, **kw)

    @property
    def freq_bins(self) -> int:
        return self.window_size // 2 + 1

    def num_frames(self, n_samples: int) -> int:
        """Reference frame count: (N - W) / H + 1 (spectral.go:418-421)."""
        if n_samples < self.window_size:
            return 0
        return (n_samples - self.window_size) // self.hop_size + 1


@dataclass(frozen=True)
class ComparisonConfig:
    """Fingerprint comparison config (config.go:68-80, defaults :120-128)."""

    similarity_threshold: float = 0.75
    method: str = "auto"  # "auto" | "precise" | "fast"
    enable_detailed_metrics: bool = False
    max_candidates: int = 50
    enable_content_filter: bool = False
    content_type: ContentType = ContentType.UNKNOWN
    feature_weights: Tuple[Tuple[str, float], ...] = ()

    def weights_dict(self) -> Dict[str, float]:
        return dict(self.feature_weights)


@dataclass(frozen=True)
class AlignmentConfig:
    """Temporal alignment config (config.go:82-117)."""

    max_lag_seconds: float = 30.0
    min_confidence: float = 0.6
    step_size: int = 1
    preferred_method: str = "hybrid"  # "hybrid" | "dtw" | "correlation"
    fallback_method: str = "correlation"
    min_similarity: float = 0.3
    min_quality: float = 0.4
    dtw_band_radius: int = 50
    corr_normalize: bool = True
    consistency_trials: int = 5
    noise_threshold: float = 0.1


@dataclass(frozen=True)
class ContentAwareConfig:
    """config.go:5-11."""

    enable_content_detection: bool = True
    default_content_type: ContentType = ContentType.UNKNOWN
    auto_detect_threshold: float = 2.0
    fallback_strategy: str = "conservative"


@dataclass(frozen=True)
class FingerprintConfig:
    """Top-level generator config (fingerprint.go:14-98)."""

    feature_config: FeatureConfig = field(default_factory=FeatureConfig)
    content_aware: ContentAwareConfig = field(default_factory=ContentAwareConfig)
    enable_hashing: bool = True


def default_fingerprint_config() -> FingerprintConfig:
    """fingerprint.go:70-98: window 2048 / hop 512 / weights
    mfcc .40 spectral .25 chroma .20 temporal .15."""
    return FingerprintConfig()


def default_comparison_config() -> ComparisonConfig:
    """config.go:120-128."""
    return ComparisonConfig(
        similarity_threshold=0.75,
        method="auto",
        max_candidates=50,
        enable_detailed_metrics=False,
        enable_content_filter=False,
    )


def default_alignment_config() -> AlignmentConfig:
    """config.go:103-117."""
    return AlignmentConfig()


def get_content_optimized_comparison_config(
    content_type: ContentType,
) -> ComparisonConfig:
    """config.go:131-155."""
    cfg = default_comparison_config()
    if content_type == ContentType.MUSIC:
        cfg = replace(cfg, similarity_threshold=0.80, method="precise")
    elif content_type in (ContentType.NEWS, ContentType.TALK):
        cfg = replace(
            cfg,
            similarity_threshold=0.70,
            enable_content_filter=False,
            method="precise",
        )
    elif content_type == ContentType.SPORTS:
        cfg = replace(cfg, similarity_threshold=0.75, method="auto")
    elif content_type == ContentType.MIXED:
        cfg = replace(
            cfg,
            similarity_threshold=0.72,
            method="auto",
            enable_detailed_metrics=True,
        )
    return replace(cfg, content_type=content_type)


def alignment_config_for_content(content_type: ContentType) -> AlignmentConfig:
    """config.go:160-181."""
    cfg = default_alignment_config()
    if content_type in (ContentType.NEWS, ContentType.TALK):
        cfg = replace(cfg, min_confidence=0.5, preferred_method="dtw")
    elif content_type == ContentType.MUSIC:
        cfg = replace(cfg, min_confidence=0.7, preferred_method="hybrid")
    elif content_type == ContentType.SPORTS:
        cfg = replace(cfg, min_confidence=0.4)
    elif content_type == ContentType.MIXED:
        cfg = replace(cfg, min_confidence=0.5, preferred_method="hybrid")
    return cfg


def comparison_config_for_content(content_type: ContentType) -> ComparisonConfig:
    """config.go:186-209."""
    if content_type == ContentType.MUSIC:
        return ComparisonConfig(
            similarity_threshold=0.80, method="precise", content_type=content_type
        )
    if content_type in (ContentType.NEWS, ContentType.TALK):
        return ComparisonConfig(
            similarity_threshold=0.70, method="precise", content_type=content_type
        )
    if content_type == ContentType.SPORTS:
        return ComparisonConfig(
            similarity_threshold=0.75, method="auto", content_type=content_type
        )
    return ComparisonConfig(
        similarity_threshold=0.75, method="auto", content_type=content_type
    )


def content_feature_toggles(content_type: ContentType) -> Dict[str, bool]:
    """Per-content feature enable flags (fingerprint.go:100-134)."""
    settings = {
        ContentType.MUSIC: dict(
            mfcc=True, chroma=True, contrast=True, harmonic=True,
            speech=False, temporal=False,
        ),
        ContentType.NEWS: dict(
            mfcc=True, chroma=False, contrast=True, harmonic=False,
            speech=True, temporal=True,
        ),
        ContentType.TALK: dict(
            mfcc=True, chroma=False, contrast=True, harmonic=False,
            speech=True, temporal=True,
        ),
        ContentType.MIXED: dict(
            mfcc=True, chroma=True, contrast=True, harmonic=True,
            speech=True, temporal=True,
        ),
        ContentType.UNKNOWN: dict(
            mfcc=True, chroma=True, contrast=True, harmonic=False,
            speech=False, temporal=True,
        ),
    }
    # Reference has no sports entry (content_config.go:106-278 quirk #9);
    # sports falls through to UNKNOWN.
    return settings.get(content_type, settings[ContentType.UNKNOWN])


def asdict(cfg) -> dict:
    """JSON-friendly dict of any config dataclass (enums as their values)."""
    d = dataclasses.asdict(cfg)

    def _clean(v):
        if isinstance(v, enum.Enum):
            return v.value
        if isinstance(v, dict):
            return {k: _clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [_clean(x) for x in v]
        return v

    return _clean(d)
