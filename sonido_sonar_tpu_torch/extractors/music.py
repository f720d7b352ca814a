"""Music feature extractor, program path (counterpart of
`sonido_sonar_tpu/extractors/music.py`).

Reference parity: fingerprint/extractors/music.go — pipeline :178-243,
weight table :144-175. The payload comes from
`parallel/pipeline.batched_music_extractor_features`. The class
composition over a spectrogram (`extract_features` and its `_extract_*`
steps) is not ported yet (ROADMAP queue 1, item 19). The reference's
factory never reaches this extractor (quirk #1); the port's factory
does under `strict_reference_routing=False`.
"""

from __future__ import annotations

from typing import Dict

import torch

from sonido_sonar_tpu_torch.config.config import ContentType, FeatureConfig
from sonido_sonar_tpu_torch.extractors.features import ExtractedFeatures
from sonido_sonar_tpu_torch.extractors.programs import assemble_music_features
from sonido_sonar_tpu_torch.parallel.pipeline import batched_music_extractor_features

# music.go:144-175
MUSIC_FEATURE_WEIGHTS: Dict[str, float] = {
    "chroma_features": 1.0,
    "pitch_estimate": 0.9,
    "harmonic_ratio": 0.9,
    "key_detection": 0.8,
    "chord_detection": 0.8,
    "inharmonicity": 0.7,
    "spectral_centroid": 0.8,
    "spectral_rolloff": 0.7,
    "spectral_bandwidth": 0.7,
    "spectral_flatness": 0.6,
    "spectral_contrast": 0.8,
    "mfcc": 0.7,
    "onset_detection": 0.8,
    "tempo_estimation": 0.8,
    "attack_decay": 0.7,
    "dynamic_range": 0.7,
    "rms_energy": 0.6,
    "zero_crossing_rate": 0.4,
    "silence_ratio": 0.3,
    "speech_features": 0.1,
}


class MusicFeatureExtractor:
    """MusicFeatureExtractor (music.go:22-142)."""

    def __init__(self, config: FeatureConfig):
        self.config = config

    def get_name(self) -> str:
        return "MusicFeatureExtractor"

    def get_content_type(self) -> ContentType:
        return ContentType.MUSIC

    def get_feature_weights(self) -> Dict[str, float]:
        return dict(MUSIC_FEATURE_WEIGHTS)

    def extract_features_from_pcm(self, pcm: torch.Tensor, sample_rate: int) -> ExtractedFeatures:
        """[..., N] PCM -> ExtractedFeatures with [...]-leading tensors."""
        cfg = self.config
        out = batched_music_extractor_features(
            pcm, sample_rate=sample_rate, window_size=cfg.window_size, hop_size=cfg.hop_size
        )
        return assemble_music_features(out, cfg, sample_rate)
