"""Speech/news/talk feature extractor, program path (counterpart of
`sonido_sonar_tpu/extractors/speech.py`).

Reference parity: fingerprint/extractors/speech.go — weights :111-133
(mfcc .40 / speech .35 / spectral .15 / temporal .10; news flips speech
.40 / mfcc .35). The payload comes from one pass of
`extractors/programs.speech_extractor_program`. The class composition
over a spectrogram (`extract_features` and its `_extract_*` steps) is
not ported yet (ROADMAP queue 1, item 19).
"""

from __future__ import annotations

from typing import Dict

import torch

from sonido_sonar_tpu_torch.config.config import ContentType, FeatureConfig
from sonido_sonar_tpu_torch.extractors.features import ExtractedFeatures
from sonido_sonar_tpu_torch.extractors.programs import (
    assemble_speech_features,
    speech_extractor_program,
)


class SpeechFeatureExtractor:
    """SpeechFeatureExtractor (speech.go:20-98)."""

    def __init__(self, config: FeatureConfig, is_news: bool = False):
        self.config = config
        self.is_news = is_news

    def get_name(self) -> str:
        return "SpeechFeatureExtractor"

    def get_content_type(self) -> ContentType:
        return ContentType.NEWS if self.is_news else ContentType.TALK

    def get_feature_weights(self) -> Dict[str, float]:
        """speech.go:111-133."""
        if self.config.similarity_weights:
            return self.config.weights_dict()
        weights = {"mfcc": 0.40, "speech": 0.35, "spectral": 0.15, "temporal": 0.10}
        if self.is_news:
            weights["speech"] = 0.40
            weights["mfcc"] = 0.35
        return weights

    def extract_features_from_pcm(self, pcm: torch.Tensor, sample_rate: int) -> ExtractedFeatures:
        """[..., N] PCM -> ExtractedFeatures with [...]-leading tensors."""
        cfg = self.config
        out = speech_extractor_program(
            pcm,
            sample_rate=sample_rate,
            window_size=cfg.window_size,
            hop_size=cfg.hop_size,
            window_type=cfg.window_type,
            mfcc_coefficients=cfg.mfcc_coefficients,
            enable_mfcc=cfg.enable_mfcc,
            enable_speech=cfg.enable_speech_features,
            enable_temporal=cfg.enable_temporal_features,
            enable_contrast=cfg.enable_spectral_contrast,
            contrast_bands=cfg.contrast_bands,
        )
        return assemble_speech_features(out, cfg, self.is_news, sample_rate)
