"""Sports and mixed-content feature extractors (counterpart of
`sonido_sonar_tpu/extractors/sports.py`).

The reference ships these as empty stubs (extractors/sports.go and
extractors/mixed.go hold only package declarations) and routes both
content types to the speech extractor. These complete the intent the
config tables describe: sports comparison weights energy .30 / temporal
.25 / mfcc .25 / spectral .20 (comparison.go:1077-1087); mixed enables
every feature family with weights mfcc .30 / spectral .20 / temporal .20
/ chroma .15 / speech .15 (content_config.go:210-244). Both are class
compositions over an `STFTResult` built from the speech and music
steps; the factory gives them under `strict_reference_routing=False`.
"""

from __future__ import annotations

from typing import Dict

from sonido_sonar_tpu_torch.config.config import ContentType, FeatureConfig
from sonido_sonar_tpu_torch.extractors.features import ExtractedFeatures
from sonido_sonar_tpu_torch.extractors.speech import SpeechFeatureExtractor
from sonido_sonar_tpu_torch.logging import get_global_logger
from sonido_sonar_tpu_torch.ops import temporal as T
from sonido_sonar_tpu_torch.ops.chroma import chroma_from_magnitude
from sonido_sonar_tpu_torch.ops.filters import pre_emphasis_for_content
from sonido_sonar_tpu_torch.ops.mfcc import MFCCParams, mfcc
from sonido_sonar_tpu_torch.ops.stft import STFTResult, stft
from sonido_sonar_tpu_torch.utils.device import as_float32, require_fp32_matmuls


def _per_clip(t) -> object:
    """A host float for one clip, a list of floats for a batch."""
    a = t.detach().cpu().numpy()
    return float(a) if a.ndim == 0 else a.tolist()


class SportsFeatureExtractor(SpeechFeatureExtractor):
    """Sports content: commentary (speech-like) over crowd noise, with
    high energy variance and event-driven dynamics. The speech steps on
    broadcast pre-emphasis (0.96), no speech step, and two excitement
    proxies in the metadata."""

    def __init__(self, config: FeatureConfig):
        super().__init__(config, is_news=False)
        self._log = get_global_logger().with_component("sports_feature_extractor")

    def get_name(self) -> str:
        return "SportsFeatureExtractor"

    def get_content_type(self) -> ContentType:
        return ContentType.SPORTS

    def get_feature_weights(self) -> Dict[str, float]:
        # the sports comparator table (comparison.go:1077-1087)
        return {"energy": 0.30, "temporal": 0.25, "mfcc": 0.25, "spectral": 0.20, "speech": 0.10}

    def extract_features(
        self, spectrogram: STFTResult, pcm, sample_rate: int
    ) -> ExtractedFeatures:
        cfg = self.config
        x = as_float32(pcm, spectrogram.magnitude.device)
        require_fp32_matmuls(x, "SportsFeatureExtractor.extract_features")
        pre = pre_emphasis_for_content(x, "broadcast")
        features = ExtractedFeatures(metadata={})
        if cfg.enable_mfcc:
            features.mfcc = mfcc(
                spectrogram.magnitude, sample_rate, cfg.window_size,
                MFCCParams(num_coefficients=cfg.mfcc_coefficients),
            )
        features.spectral_features = self._extract_spectral(spectrogram, pre, sample_rate)
        features.temporal_features = self._extract_temporal(pre, sample_rate)
        features.energy_features = self._extract_energy(pre, spectrogram)
        features.harmonic_features = self._extract_harmonic(pre, sample_rate)
        # crowd/excitement proxies over the short-time energy: a float per
        # clip, or a list when a [B, N] batch comes through the generator
        rms = features.energy_features.short_time_energy
        features.metadata.update(
            extractor_type="sports",
            algorithms_used="spectral,temporal,filters,tonal",
            sample_rate=sample_rate,
            excitement_variance=_per_clip(T.energy_variance(rms)),
            excitement_entropy=_per_clip(T.energy_entropy(rms)),
        )
        return features

    def extract_features_from_pcm(self, pcm, sample_rate: int) -> ExtractedFeatures:
        """Sports has no single program: `extract_features` over the
        `stft` of the PCM at the config's geometry. (It overrides the
        speech program it would otherwise inherit; the JAX class does
        not, so the JAX generator gives a sports clip the speech
        program's payload.)"""
        cfg = self.config
        spectrogram = stft(pcm, cfg.window_size, cfg.hop_size, cfg.window_type, sample_rate)
        return self.extract_features(spectrogram, pcm, sample_rate)


class MixedFeatureExtractor:
    """Mixed content: the speech feature set plus chroma, weighted per
    the MIXED preset (content_config.go:210-244)."""

    def __init__(self, config: FeatureConfig):
        # mixed content turns on every feature family (content_config.go:210-228)
        self.config = config.with_(
            enable_mfcc=True,
            enable_chroma=True,
            enable_spectral_contrast=True,
            enable_harmonic_features=True,
            enable_speech_features=True,
            enable_temporal_features=True,
        )
        self._speech = SpeechFeatureExtractor(self.config, is_news=False)
        self._log = get_global_logger().with_component("mixed_feature_extractor")

    def get_name(self) -> str:
        return "MixedFeatureExtractor"

    def get_content_type(self) -> ContentType:
        return ContentType.MIXED

    def get_feature_weights(self) -> Dict[str, float]:
        return {"mfcc": 0.30, "spectral": 0.20, "temporal": 0.20, "chroma": 0.15, "speech": 0.15}

    def extract_features(
        self, spectrogram: STFTResult, pcm, sample_rate: int
    ) -> ExtractedFeatures:
        feats = self._speech.extract_features(spectrogram, pcm, sample_rate)
        if self.config.enable_chroma:
            feats.chroma_features = chroma_from_magnitude(
                spectrogram.magnitude, sample_rate, self.config.window_size)
        feats.metadata.update(
            extractor_type="mixed",
            algorithms_used="speech,spectral,chroma,temporal,filters,tonal",
        )
        return feats
