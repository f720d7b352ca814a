"""Feature extractor factory (counterpart of
`sonido_sonar_tpu/extractors/base.py`; feature_extractor.go:18-63).

Factory quirk (reference :38-62, quirk #1): the music / sports / mixed
cases are commented out upstream, so EVERY content type gets the speech
extractor (news variant as the default). `strict_reference_routing=True`
(default) keeps that; `False` routes music to the music extractor.
Sports and mixed content under non-strict routing need the sports
extractor, a class composition that is not ported yet: they raise.
"""

from __future__ import annotations

from sonido_sonar_tpu_torch.config.config import ContentType, FeatureConfig


class FeatureExtractorFactory:
    """feature_extractor.go:18-63."""

    def __init__(self, strict_reference_routing: bool = True):
        self.strict_reference_routing = strict_reference_routing

    def create_extractor(self, content_type: ContentType, feature_config: FeatureConfig):
        from sonido_sonar_tpu_torch.extractors.music import MusicFeatureExtractor
        from sonido_sonar_tpu_torch.extractors.speech import SpeechFeatureExtractor

        if not self.strict_reference_routing:
            if content_type == ContentType.MUSIC:
                return MusicFeatureExtractor(feature_config)
            if content_type in (ContentType.SPORTS, ContentType.MIXED):
                raise NotImplementedError(
                    f"the {content_type.value} extractor under strict_reference_routing="
                    "False is the sports/mixed class composition, not ported yet "
                    "(ROADMAP queue 1, item 19: extractors/sports.py)"
                )
        if content_type == ContentType.TALK:
            return SpeechFeatureExtractor(feature_config, is_news=False)
        # news, and the default for every other type (reference :59-62)
        return SpeechFeatureExtractor(feature_config, is_news=True)


def create_extractor(content_type: ContentType, feature_config: FeatureConfig,
                     strict_reference_routing: bool = True):
    return FeatureExtractorFactory(strict_reference_routing).create_extractor(
        content_type, feature_config
    )
