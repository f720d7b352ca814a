"""Speech/news/talk feature extractor (counterpart of
`sonido_sonar_tpu/extractors/speech.py`).

Reference parity: fingerprint/extractors/speech.go —
  pipeline (:135-243): speech pre-emphasis -> MFCC from the spectrogram
  -> speech analysis (formants/voice quality; non-fatal on failure) ->
  per-frame spectral features + ZCR from PCM -> temporal (RMS energy,
  onsets via energy derivative with mean+2*std threshold :672-716,
  attack times :744-775, envelope 512/256 :719-745) -> energy features
  (elementwise entropy -E*ln(E+1e-10), low/high split at F/4 bins
  :411-461) -> harmonic via frame-wise pitch at fixed 1024/512
  (:464-509, quirk #8);
  weights (:111-133): mfcc .40 / speech .35 / spectral .15 / temporal
  .10; news flips speech .40 / mfcc .35.

Two paths give the same payload: `extract_features(spectrogram, pcm,
sample_rate)`, the class composition over an `STFTResult` and its
`_extract_*` steps, which is the oracle; and `extract_features_from_pcm`,
one pass of `extractors/programs.speech_extractor_program` (K1 for the
magnitudes), which the generator runs. The pitch tracks of both are K2,
and the voice-quality chain is K2 with the period amplitude.
"""

from __future__ import annotations

from typing import Dict

import torch

from sonido_sonar_tpu_torch._build import KernelError
from sonido_sonar_tpu_torch.config.config import ContentType, FeatureConfig
from sonido_sonar_tpu_torch.extractors.features import (
    EnergyFeatures,
    ExtractedFeatures,
    HarmonicFeatures,
    SpectralFeatures,
    SpeechFeatures,
    TemporalFeatures,
)
from sonido_sonar_tpu_torch.extractors.programs import (
    assemble_speech_features,
    speech_extractor_program,
)
from sonido_sonar_tpu_torch.logging import get_global_logger
from sonido_sonar_tpu_torch.ops import spectral as S
from sonido_sonar_tpu_torch.ops import temporal as T
from sonido_sonar_tpu_torch.ops.filters import pre_emphasis_for_content
from sonido_sonar_tpu_torch.ops.framing import frame_signal
from sonido_sonar_tpu_torch.ops.mfcc import MFCCParams, mfcc
from sonido_sonar_tpu_torch.ops.pitch import detect_pitch_track
from sonido_sonar_tpu_torch.ops.speech import analyze_speech
from sonido_sonar_tpu_torch.ops.stft import STFTResult
from sonido_sonar_tpu_torch.utils.device import as_float32, require_fp32_matmuls

_EPS = 1e-10


def energy_features(pcm: torch.Tensor, spec: STFTResult, config: FeatureConfig) -> EnergyFeatures:
    """The energy step of the speech and music extractors (speech.go:411-461,
    music.go:478-525): short-time RMS at the config's geometry, its
    elementwise 'entropy' -E ln(E + 1e-10) (speech.go:430-433), the
    loudness range at the config's sample rate (not the call's, as the
    reference), and the power below and above bin F // 4."""
    ste = T.short_time_energy(pcm, config.window_size, config.hop_size)
    power = spec.magnitude * spec.magnitude
    split = spec.magnitude.shape[-1] // 4
    total = torch.sum(power, dim=-1)
    denom = torch.clamp_min(total, _EPS)
    return EnergyFeatures(
        short_time_energy=ste,
        energy_variance=T.energy_variance(ste),
        energy_entropy=torch.where(ste > 0, -ste * torch.log(ste + 1e-10), 0.0),
        loudness_range=T.loudness_range(pcm, config.sample_rate),
        low_energy_ratio=torch.where(total > 0, torch.sum(power[..., :split], dim=-1) / denom, 0.0),
        high_energy_ratio=torch.where(total > 0, torch.sum(power[..., split:], dim=-1) / denom, 0.0),
    )


class SpeechFeatureExtractor:
    """SpeechFeatureExtractor (speech.go:20-98)."""

    def __init__(self, config: FeatureConfig, is_news: bool = False):
        self.config = config
        self.is_news = is_news
        self._log = get_global_logger().with_component("speech_feature_extractor")

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

    def _optional(self, what: str, step, *args):
        """An optional step (speech.go:179-189, 201-211, 222-230): any
        failure is logged and leaves the field None, except a kernel's
        (`KernelError`), which raises."""
        try:
            return step(*args)
        except KernelError:
            raise
        except Exception as e:
            self._log.warn(f"{what} feature extraction failed", error=str(e))
            return None

    def extract_features(
        self, spectrogram: STFTResult, pcm, sample_rate: int
    ) -> ExtractedFeatures:
        """ExtractFeatures (speech.go:135-243): pcm [..., N] and the
        `ops.stft.stft` of the same PCM. Numpy PCM goes to the
        spectrogram's device."""
        cfg = self.config
        x = as_float32(pcm, spectrogram.magnitude.device)
        require_fp32_matmuls(x, "SpeechFeatureExtractor.extract_features")
        # step 1: speech pre-emphasis (speech.go:247-253)
        pre = pre_emphasis_for_content(x, "speech")
        features = ExtractedFeatures(metadata={})
        # step 2: MFCC from the raw-signal spectrogram
        if cfg.enable_mfcc:
            features.mfcc = mfcc(
                spectrogram.magnitude, sample_rate, cfg.window_size,
                MFCCParams(num_coefficients=cfg.mfcc_coefficients),
            )
        # step 3: speech features, optional
        if cfg.enable_speech_features:
            features.speech_features = self._optional("speech", self._extract_speech, pre, sample_rate)
        # step 4: spectral features (critical)
        features.spectral_features = self._extract_spectral(spectrogram, pre, sample_rate)
        # step 5: temporal features, optional
        if cfg.enable_temporal_features:
            features.temporal_features = self._optional(
                "temporal", self._extract_temporal, pre, sample_rate)
        # step 6: energy features (critical)
        features.energy_features = self._extract_energy(pre, spectrogram)
        # step 7: harmonic features (voicing), optional
        features.harmonic_features = self._optional(
            "harmonic", self._extract_harmonic, pre, sample_rate)
        features.metadata.update(
            extractor_type="speech",
            content_subtype="news" if self.is_news else "talk",
            algorithms_used="speech,spectral,temporal,filters,tonal",
            pre_emphasis_applied=True,
            sample_rate=sample_rate,
            spectrogram_frames=int(spectrogram.time_frames),
            optimization="speech_optimized",
        )
        return features

    def extract_features_from_pcm(self, pcm: torch.Tensor, sample_rate: int) -> ExtractedFeatures:
        """[..., N] PCM -> ExtractedFeatures with [...]-leading tensors:
        `extract_features` as one program (held to it by the tests)."""
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

    # ------------------------------------------------------------------
    def _extract_spectral(self, spec: STFTResult, pcm: torch.Tensor, sr: int) -> SpectralFeatures:
        """speech.go:320-367: per-frame descriptors, ZCR from the PCM at
        the spectrogram's framing."""
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
            spectral_contrast=(
                S.spectral_contrast(mag, sr, self.config.contrast_bands)
                if self.config.enable_spectral_contrast else None
            ),
        )

    def _extract_temporal(self, pcm: torch.Tensor, sr: int) -> TemporalFeatures:
        """speech.go:370-407."""
        cfg = self.config
        rms = T.short_time_energy(pcm, cfg.window_size, cfg.hop_size)
        onset_mask, onset_count = T.detect_onsets_from_energy(rms)
        duration = pcm.shape[-1] / float(sr)
        return TemporalFeatures(
            rms_energy=rms,
            peak_amplitude=torch.amax(torch.abs(pcm), dim=-1),
            average_amplitude=torch.mean(torch.abs(pcm), dim=-1),
            dynamic_range=T.loudness_range(pcm, sr),
            silence_ratio=T.silence_ratio_percentile(rms),
            onset_density=onset_count.to(torch.float32) / duration,
            onset_mask=onset_mask,
            attack_time=T.attack_times_from_onsets(onset_mask, rms, cfg.hop_size, sr),
            envelope_shape=T.rms_envelope(pcm, 512, 256),
        )

    def _extract_energy(self, pcm: torch.Tensor, spec: STFTResult) -> EnergyFeatures:
        """speech.go:411-461."""
        return energy_features(pcm, spec, self.config)

    def _extract_harmonic(self, pcm: torch.Tensor, sr: int) -> HarmonicFeatures:
        """speech.go:464-509: the K2 pitch track at the fixed 1024/512
        (quirk #8); harmonic ratio = voicing * 10, inharmonicity =
        1 - voicing, tonal centroid = pitch."""
        pitch, conf, voicing = detect_pitch_track(pcm, sr, 1024, 512)
        return HarmonicFeatures(
            pitch_estimate=pitch,
            pitch_confidence=conf,
            voicing_strength=voicing,
            harmonic_ratio=voicing * 10.0,
            inharmonicity_ratio=1.0 - voicing,
            tonal_centroid=torch.where(pitch > 0, pitch, 0.0),
        )

    def _extract_speech(self, pcm: torch.Tensor, sr: int) -> SpeechFeatures:
        """speech.go:278-317: the speech analysis (K2 with the period
        amplitude in its voice quality), then voicing (K2) and spectral
        tilt per 1024/512 frame (:530-585), pauses and speech rate, all
        gated on is_speech."""
        cfg = self.config
        analysis = analyze_speech(pcm, sr)
        is_speech = analysis.is_speech
        _, _, voicing = detect_pitch_track(pcm, sr, 1024, 512)
        frames = frame_signal(pcm, 1024, 512)
        d = frames[..., 1:] - frames[..., :-1]
        high_e = torch.sum(d * d, dim=-1)
        low_e = torch.sum(frames[..., 1:] * frames[..., 1:], dim=-1)
        tilt = torch.where(
            low_e > 0,
            -10.0 * torch.log10(torch.clamp_min(high_e / torch.clamp_min(low_e, _EPS), _EPS)),
            0.0,
        )
        ste = T.short_time_energy(pcm, cfg.window_size, cfg.hop_size)
        pauses, pause_count = T.pause_durations(ste, cfg.hop_size, sr)
        # speech rate (speech.go:748-775): 4 * speech time / duration
        speech_rate = torch.where(is_speech, 4.0 * (1.0 - T.silence_ratio_percentile(ste)), 0.0)
        f = analysis.formants
        vq = analysis.voice_quality
        # is_speech is one value per clip: a trailing axis broadcasts it
        # over the per-frame and per-formant axes
        is_sp = is_speech[..., None]
        return SpeechFeatures(
            # [..., 1, max_formants]: one analysis frame (:516-527)
            formant_frequencies=torch.where(is_sp, f.frequencies, 0.0)[..., None, :],
            formant_count=torch.where(is_speech, f.count, 0),
            vocal_tract_length=torch.where(is_speech, f.vocal_tract_length, 17.5),
            voicing_probability=torch.where(is_sp, voicing, 0.0),
            spectral_tilt=torch.where(is_sp, tilt, 0.0),
            speech_rate=speech_rate,
            pause_duration=pauses,
            pause_count=pause_count,
            jitter=torch.where(is_speech, vq.jitter, 0.0),
            shimmer=torch.where(is_speech, vq.shimmer, 0.0),
        )
