"""Centralized per-content-type preset tables.

Reference parity: fingerprint/content_config.go:106-278. All weight and
threshold constants carried verbatim (including the reference's quirks:
no SPORTS entry — sports falls back to UNKNOWN; TALK's comparison weights
differ from its feature weights, content_config.go:194-208).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Tuple

from sonido_sonar_tpu_torch.config.config import (
    ContentType,
    FeatureConfig,
    FingerprintConfig,
    WindowType,
    ComparisonConfig,
    default_fingerprint_config,
)


@dataclass(frozen=True)
class FeatureSettings:
    """content_config.go:15-26."""

    enable_mfcc: bool = True
    enable_chroma: bool = True
    enable_spectral_contrast: bool = True
    enable_harmonic_features: bool = False
    enable_speech_features: bool = False
    enable_temporal_features: bool = True
    similarity_weights: Tuple[Tuple[str, float], ...] = ()
    mfcc_coefficients: int = 13
    chroma_bins: int = 12
    window_type: WindowType = WindowType.HANN


@dataclass(frozen=True)
class ComparisonSettings:
    """content_config.go:29-33."""

    similarity_threshold: float = 0.75
    feature_weights: Tuple[Tuple[str, float], ...] = ()
    tolerance_factors: Tuple[Tuple[str, float], ...] = ()


@dataclass(frozen=True)
class ContentSettings:
    """content_config.go:8-12."""

    feature_settings: FeatureSettings = field(default_factory=FeatureSettings)
    comparison_settings: ComparisonSettings = field(default_factory=ComparisonSettings)


def get_content_configs() -> Dict[ContentType, ContentSettings]:
    """The central preset table (content_config.go:106-278), verbatim."""
    return {
        ContentType.MUSIC: ContentSettings(
            FeatureSettings(
                enable_mfcc=True,
                enable_chroma=True,
                enable_spectral_contrast=True,
                enable_harmonic_features=True,
                enable_speech_features=False,
                enable_temporal_features=False,
                mfcc_coefficients=13,
                chroma_bins=12,
                window_type=WindowType.HANN,
                similarity_weights=(
                    ("mfcc", 0.35), ("chroma", 0.30),
                    ("harmonic", 0.20), ("spectral", 0.15),
                ),
            ),
            ComparisonSettings(
                similarity_threshold=0.75,
                feature_weights=(
                    ("mfcc", 0.35), ("chroma", 0.30),
                    ("harmonic", 0.20), ("spectral", 0.15),
                ),
                tolerance_factors=(
                    ("pitch", 0.1), ("tempo", 0.2), ("timbre", 0.15),
                ),
            ),
        ),
        ContentType.NEWS: ContentSettings(
            FeatureSettings(
                enable_mfcc=True,
                enable_chroma=False,
                enable_spectral_contrast=True,
                enable_harmonic_features=False,
                enable_speech_features=True,
                enable_temporal_features=True,
                mfcc_coefficients=13,
                chroma_bins=12,
                window_type=WindowType.HANN,
                similarity_weights=(
                    ("mfcc", 0.50), ("speech", 0.25),
                    ("spectral", 0.15), ("temporal", 0.10),
                ),
            ),
            ComparisonSettings(
                similarity_threshold=0.80,
                feature_weights=(
                    ("mfcc", 0.50), ("speech", 0.25),
                    ("spectral", 0.15), ("temporal", 0.10),
                ),
                tolerance_factors=(
                    ("voice", 0.12), ("pace", 0.25), ("clarity", 0.08),
                ),
            ),
        ),
        ContentType.TALK: ContentSettings(
            FeatureSettings(
                enable_mfcc=True,
                enable_chroma=False,
                enable_spectral_contrast=True,
                enable_harmonic_features=False,
                enable_speech_features=True,
                enable_temporal_features=True,
                mfcc_coefficients=13,
                chroma_bins=12,
                window_type=WindowType.HANN,
                similarity_weights=(
                    ("mfcc", 0.45), ("speech", 0.30),
                    ("spectral", 0.15), ("temporal", 0.10),
                ),
            ),
            # NOTE: reference's talk comparison weights are sports-ish
            # (crowd/commentary/action tolerances) — likely a copy bug in
            # the reference, carried verbatim for parity
            # (content_config.go:194-208, SURVEY.md quirk table).
            ComparisonSettings(
                similarity_threshold=0.78,
                feature_weights=(
                    ("mfcc", 0.30), ("spectral", 0.25),
                    ("temporal", 0.25), ("energy", 0.20),
                ),
                tolerance_factors=(
                    ("crowd", 0.35), ("commentary", 0.20), ("action", 0.25),
                ),
            ),
        ),
        ContentType.MIXED: ContentSettings(
            FeatureSettings(
                enable_mfcc=True,
                enable_chroma=True,
                enable_spectral_contrast=True,
                enable_harmonic_features=True,
                enable_speech_features=True,
                enable_temporal_features=True,
                mfcc_coefficients=13,
                chroma_bins=12,
                window_type=WindowType.HANN,
                similarity_weights=(
                    ("mfcc", 0.30), ("spectral", 0.20), ("temporal", 0.20),
                    ("chroma", 0.15), ("speech", 0.15),
                ),
            ),
            ComparisonSettings(
                similarity_threshold=0.72,
                feature_weights=(
                    ("mfcc", 0.30), ("spectral", 0.20), ("temporal", 0.20),
                    ("chroma", 0.15), ("speech", 0.15),
                ),
                tolerance_factors=(
                    ("variation", 0.25), ("segments", 0.30), ("balance", 0.20),
                ),
            ),
        ),
        ContentType.UNKNOWN: ContentSettings(
            FeatureSettings(
                enable_mfcc=True,
                enable_chroma=True,
                enable_spectral_contrast=True,
                enable_harmonic_features=False,
                enable_speech_features=False,
                enable_temporal_features=True,
                mfcc_coefficients=13,
                chroma_bins=12,
                window_type=WindowType.HANN,
                similarity_weights=(
                    ("mfcc", 0.40), ("spectral", 0.25),
                    ("chroma", 0.20), ("temporal", 0.15),
                ),
            ),
            ComparisonSettings(
                similarity_threshold=0.75,
                feature_weights=(
                    ("mfcc", 0.40), ("spectral", 0.25),
                    ("chroma", 0.20), ("temporal", 0.15),
                ),
                tolerance_factors=(("general", 0.20),),
            ),
        ),
    }


class ContentAwareConfigManager:
    """content_config.go:36-103: resolves content type -> full configs."""

    def __init__(self, base_config: FingerprintConfig | None = None):
        self.base_config = base_config or default_fingerprint_config()
        self.content_configs = get_content_configs()

    def _settings(self, content_type: ContentType) -> ContentSettings:
        return self.content_configs.get(
            content_type, self.content_configs[ContentType.UNKNOWN]
        )

    def get_generation_config(self, content_type: ContentType) -> FingerprintConfig:
        """content_config.go:54-69."""
        s = self._settings(content_type).feature_settings
        base = self.base_config.feature_config
        fc = FeatureConfig(
            sample_rate=base.sample_rate,
            window_size=base.window_size,
            hop_size=base.hop_size,
            freq_range=base.freq_range,
            window_type=s.window_type,
            enable_mfcc=s.enable_mfcc,
            enable_chroma=s.enable_chroma,
            enable_spectral_contrast=s.enable_spectral_contrast,
            enable_harmonic_features=s.enable_harmonic_features,
            enable_speech_features=s.enable_speech_features,
            enable_temporal_features=s.enable_temporal_features,
            mfcc_coefficients=s.mfcc_coefficients,
            chroma_bins=s.chroma_bins,
            similarity_weights=s.similarity_weights,
            match_threshold=base.match_threshold,
        )
        return replace(self.base_config, feature_config=fc)

    def get_comparison_config(self, content_type: ContentType) -> ComparisonConfig:
        """content_config.go:72-84."""
        s = self._settings(content_type).comparison_settings
        return ComparisonConfig(
            similarity_threshold=s.similarity_threshold,
            feature_weights=s.feature_weights,
            content_type=content_type,
        )
