"""Music feature extractor (counterpart of
`sonido_sonar_tpu/extractors/music.py`).

Reference parity: fingerprint/extractors/music.go —
  pipeline (:178-243): DC removal + music pre-emphasis (:245-259) ->
  per-frame spectral incl. 6-band contrast (:261-302) -> MFCC per frame
  {13 coeffs, 26 filters, lifter 22} (:114-123, 304-325) -> chroma via
  ChromaSTFT with Hann (:327-376) -> temporal (onsets threshold 0.3 /
  min interval 50 ms :406-416, per-frame crest factor, silence -40 dB)
  -> energy -> harmonic per frame: pitch, HNR, inharmonicity gated on
  pitch confidence > 0.5, tonal centroid = spectral centroid * voicing
  (:528-592); weight table (:144-175).

Two paths give the same payload: `extract_features(spectrogram, pcm,
sample_rate)`, the class composition over an `STFTResult` (the oracle),
and `extract_features_from_pcm`, which assembles
`parallel/pipeline.batched_music_extractor_features`. Both thin their
flux onsets with K4 and take the tempo's magnitudes from K1. The
reference's factory never reaches this extractor (quirk #1); the port's
factory does under `strict_reference_routing=False`.
"""

from __future__ import annotations

from typing import Dict

import torch

from sonido_sonar_tpu_torch.config.config import ContentType, FeatureConfig
from sonido_sonar_tpu_torch.extractors.features import (
    EnergyFeatures,
    ExtractedFeatures,
    HarmonicFeatures,
    SpectralFeatures,
    TemporalFeatures,
)
from sonido_sonar_tpu_torch.extractors.programs import assemble_music_features
from sonido_sonar_tpu_torch.extractors.speech import energy_features
from sonido_sonar_tpu_torch.logging import get_global_logger
from sonido_sonar_tpu_torch.ops import spectral as S
from sonido_sonar_tpu_torch.ops import temporal as T
from sonido_sonar_tpu_torch.ops.chroma import chroma_from_magnitude
from sonido_sonar_tpu_torch.ops.filters import dc_removal, pre_emphasis_for_content
from sonido_sonar_tpu_torch.ops.mfcc import MFCCParams, mfcc
from sonido_sonar_tpu_torch.ops.pitch import PitchParams, yin_pitch
from sonido_sonar_tpu_torch.ops.speech import hnr_acf
from sonido_sonar_tpu_torch.ops.stft import STFTResult, spectral_flux
from sonido_sonar_tpu_torch.parallel.pipeline import batched_music_extractor_features
from sonido_sonar_tpu_torch.utils.device import as_float32, require_fp32_matmuls

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
        self._log = get_global_logger().with_component("music_feature_extractor")

    def get_name(self) -> str:
        return "MusicFeatureExtractor"

    def get_content_type(self) -> ContentType:
        return ContentType.MUSIC

    def get_feature_weights(self) -> Dict[str, float]:
        return dict(MUSIC_FEATURE_WEIGHTS)

    def extract_features(
        self, spectrogram: STFTResult, pcm, sample_rate: int
    ) -> ExtractedFeatures:
        """ExtractFeatures (music.go:178-243): pcm [..., N] and the
        `ops.stft.stft` of the same PCM. Numpy PCM goes to the
        spectrogram's device."""
        cfg = self.config
        x = as_float32(pcm, spectrogram.magnitude.device)
        require_fp32_matmuls(x, "MusicFeatureExtractor.extract_features")
        # preprocessing: DC removal + music pre-emphasis (music.go:245-259)
        pre = pre_emphasis_for_content(dc_removal(x), "music")
        features = ExtractedFeatures(metadata={})
        features.spectral_features = self._extract_spectral(spectrogram, pre, sample_rate)
        if cfg.enable_mfcc:
            features.mfcc = mfcc(
                spectrogram.magnitude, sample_rate, cfg.window_size,
                MFCCParams(num_coefficients=cfg.mfcc_coefficients, num_mel_filters=26,
                           lifter_coeff=22.0),
            )
        if cfg.enable_chroma:
            # the ChromaSTFT fold of the spectrogram's (Hann) magnitudes
            features.chroma_features = chroma_from_magnitude(
                spectrogram.magnitude, sample_rate, cfg.window_size)
        # music always extracts temporal features, whatever the config
        features.temporal_features = self._extract_temporal(pre, spectrogram, sample_rate)
        features.energy_features = self._extract_energy(pre, spectrogram)
        if cfg.enable_harmonic_features:
            features.harmonic_features = self._extract_harmonic(pre, spectrogram, sample_rate)
        features.metadata.update(
            extractor_type="music",
            algorithms_used="spectral,chroma,temporal,tonal,harmonic,filters",
            sample_rate=sample_rate,
            spectrogram_frames=int(spectrogram.time_frames),
        )
        return features

    def extract_features_from_pcm(self, pcm: torch.Tensor, sample_rate: int) -> ExtractedFeatures:
        """[..., N] PCM -> ExtractedFeatures with [...]-leading tensors:
        `extract_features` as one program (held to it by the tests)."""
        cfg = self.config
        out = batched_music_extractor_features(
            pcm, sample_rate=sample_rate, window_size=cfg.window_size, hop_size=cfg.hop_size
        )
        return assemble_music_features(out, cfg, sample_rate)

    # ------------------------------------------------------------------
    def _extract_spectral(self, spec: STFTResult, pcm: torch.Tensor, sr: int) -> SpectralFeatures:
        """music.go:261-302 (6 contrast bands at :111)."""
        mag = spec.magnitude
        t = mag.shape[-2]
        d = S.spectral_descriptor_bundle(mag, sr)
        return SpectralFeatures(
            spectral_centroid=d["spectral_centroid"],
            spectral_rolloff=d["spectral_rolloff"],
            spectral_bandwidth=d["spectral_bandwidth"],
            spectral_flatness=d["spectral_flatness"],
            spectral_crest=d["spectral_crest"],
            spectral_slope=d["spectral_slope"],
            spectral_flux=d["spectral_flux"],
            zero_crossing_rate=S.zcr_from_signal(pcm, spec.window_size, spec.hop_size, sr)[..., :t],
            spectral_contrast=S.spectral_contrast(mag, sr, 6),
        )

    def _extract_temporal(self, pcm: torch.Tensor, spec: STFTResult, sr: int) -> TemporalFeatures:
        """music.go:378-430: flux onsets (threshold 0.3, 50 ms apart, K4),
        per-frame crest, -40 dB silence, the interval-histogram tempo."""
        cfg = self.config
        rms = T.short_time_energy(pcm, cfg.window_size, cfg.hop_size)
        onset_mask, onset_count = T.detect_onsets_from_flux(
            spectral_flux(spec.magnitude), cfg.hop_size, sr, threshold=0.3, min_interval_sec=0.05
        )
        silence = T.silence_mask_db(pcm, cfg.window_size, cfg.hop_size, -40.0)
        return TemporalFeatures(
            rms_energy=rms,
            peak_amplitude=torch.amax(torch.abs(pcm), dim=-1),
            average_amplitude=torch.mean(torch.abs(pcm), dim=-1),
            # ComputeRange frames at a fixed 1024/512 whatever the config
            # (dynamic_range.go:27-28)
            dynamic_range=T.dynamic_range_db(pcm, 1024, 512),
            crest_factor=T.crest_factor_frames(pcm, cfg.window_size, cfg.hop_size),
            silence_ratio=torch.mean(silence.to(torch.float32), dim=-1),
            onset_density=onset_count.to(torch.float32) / (pcm.shape[-1] / float(sr)),
            onset_mask=onset_mask,
            # the reference's fixed 0.01 s per onset (music.go:418-424)
            attack_time=torch.where(onset_mask, 0.01, 0.0),
            # frame N // T samples at the config's hop (music.go:383-386)
            envelope_shape=T.rms_envelope(pcm, max(pcm.shape[-1] // rms.shape[-1], 1), cfg.hop_size),
            tempo_bpm=T.estimate_tempo(pcm, sr),
        )

    def _extract_energy(self, pcm: torch.Tensor, spec: STFTResult) -> EnergyFeatures:
        """music.go:478-525 (the speech extractor's energy step)."""
        return energy_features(pcm, spec, self.config)

    def _extract_harmonic(self, pcm: torch.Tensor, spec: STFTResult, sr: int) -> HarmonicFeatures:
        """music.go:528-592: pitch, HNR and inharmonicity over T contiguous
        frames of N // T samples (an odd width at some lengths). This YIN
        and hnr_acf are plain PyTorch on every device, as they are XLA in
        the JAX package."""
        t = spec.time_frames
        frame_size = pcm.shape[-1] // t
        frames = pcm[..., : t * frame_size].reshape(pcm.shape[:-1] + (t, frame_size))
        pitch, conf, voicing = yin_pitch(frames, PitchParams(sample_rate=sr, window_size=frame_size))
        hnr = hnr_acf(frames, sr, torch.clamp_min(pitch, 1.0))
        return HarmonicFeatures(
            pitch_estimate=pitch,
            pitch_confidence=conf,
            voicing_strength=voicing,
            harmonic_ratio=torch.where(pitch > 0, hnr, 0.0),
            # gated on a confident pitch (music.go:576-585)
            inharmonicity_ratio=torch.where(
                (pitch > 0) & (conf > 0.5), 1.0 - torch.clamp(voicing, 0.0, 1.0), 0.0),
            tonal_centroid=S.spectral_centroid(spec.magnitude, sr)[..., :t] * voicing,
        )
