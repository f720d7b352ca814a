"""Feature extractor interface and factory (counterpart of
`sonido_sonar_tpu/extractors/base.py`; feature_extractor.go:10-63).

Factory quirk (reference :38-62, quirk #1): the music / sports / mixed
cases are commented out upstream, so EVERY content type gets the speech
extractor (news variant as the default). `strict_reference_routing=True`
(default) keeps that; `False` routes music, sports and mixed content to
their own extractors.
"""

from __future__ import annotations

from typing import Protocol

from sonido_sonar_tpu_torch.config.config import ContentType, FeatureConfig


class FeatureExtractor(Protocol):
    """FeatureExtractor interface (feature_extractor.go:10-15)."""

    def extract_features(self, spectrogram, pcm, sample_rate): ...
    def get_feature_weights(self) -> dict: ...
    def get_name(self) -> str: ...
    def get_content_type(self) -> ContentType: ...


class FeatureExtractorFactory:
    """feature_extractor.go:18-63."""

    def __init__(self, strict_reference_routing: bool = True):
        self.strict_reference_routing = strict_reference_routing

    def create_extractor(self, content_type: ContentType, feature_config: FeatureConfig):
        from sonido_sonar_tpu_torch.extractors.music import MusicFeatureExtractor
        from sonido_sonar_tpu_torch.extractors.speech import SpeechFeatureExtractor
        from sonido_sonar_tpu_torch.extractors.sports import (
            MixedFeatureExtractor,
            SportsFeatureExtractor,
        )

        if not self.strict_reference_routing:
            if content_type == ContentType.MUSIC:
                return MusicFeatureExtractor(feature_config)
            if content_type == ContentType.SPORTS:
                return SportsFeatureExtractor(feature_config)
            if content_type == ContentType.MIXED:
                return MixedFeatureExtractor(feature_config)
        if content_type == ContentType.TALK:
            return SpeechFeatureExtractor(feature_config, is_news=False)
        # news, and the default for every other type (reference :59-62)
        return SpeechFeatureExtractor(feature_config, is_news=True)


def create_extractor(content_type: ContentType, feature_config: FeatureConfig,
                     strict_reference_routing: bool = True):
    return FeatureExtractorFactory(strict_reference_routing).create_extractor(
        content_type, feature_config
    )
