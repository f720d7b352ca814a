"""Single-program extractor paths for the public generator surface
(counterpart of `sonido_sonar_tpu/extractors/programs.py`).

`speech_extractor_program` computes the whole SpeechFeatureExtractor
payload (speech.go:135-243) from PCM in one pass over the ops, riding
the K1 kernel with its aux epilogue for the magnitudes, rolloff and band
ratios:
  - MFCC / spectral descriptors / band ratios read the raw-signal
    magnitude, as the reference hands the extractor a raw-PCM
    spectrogram (fingerprint.go:189-199);
  - the speech pre-emphasized signal feeds ZCR, the speech chain
    (K2 with period amplitude), temporal and energy features;
  - the pitch track is K2 at the reference's fixed 1024/512 (quirk #8).
`assemble_speech_features` and `assemble_music_features` structure the
program dicts into the ExtractedFeatures schema with the extractors'
is_speech gates. The generator uses these for the per-clip and the
batched path alike, so batch == per-clip by construction.
"""

from __future__ import annotations

from typing import Dict

import torch

from sonido_sonar_tpu_torch.config.config import FeatureConfig, WindowType
from sonido_sonar_tpu_torch.extractors.features import (
    EnergyFeatures,
    ExtractedFeatures,
    HarmonicFeatures,
    SpectralFeatures,
    SpeechFeatures,
    TemporalFeatures,
)
from sonido_sonar_tpu_torch.ops import spectral as S
from sonido_sonar_tpu_torch.ops import temporal as T
from sonido_sonar_tpu_torch.ops.filters import pre_emphasis_for_content
from sonido_sonar_tpu_torch.ops.hopper_stft import stft_magnitude_hopper
from sonido_sonar_tpu_torch.ops.mfcc import MFCCParams, mfcc
from sonido_sonar_tpu_torch.ops.pitch import detect_pitch_track
from sonido_sonar_tpu_torch.ops.speech import analyze_speech
from sonido_sonar_tpu_torch.parallel.pipeline import spectral_tilt_1024
from sonido_sonar_tpu_torch.utils.device import require_fp32_matmuls


def speech_extractor_program(
    pcm: torch.Tensor,
    sample_rate: int,
    window_size: int = 1024,
    hop_size: int = 256,
    window_type: WindowType = WindowType.HANN,
    mfcc_coefficients: int = 13,
    enable_mfcc: bool = True,
    enable_speech: bool = True,
    enable_temporal: bool = True,
    enable_contrast: bool = True,
    contrast_bands: int = 6,
) -> Dict[str, torch.Tensor]:
    """[..., N] PCM -> flat dict of [..., ...] feature tensors: the full
    SpeechFeatureExtractor payload."""
    require_fp32_matmuls(pcm, "speech_extractor_program")
    x = pcm.to(torch.float32).contiguous()
    pre = pre_emphasis_for_content(x, "speech")
    mag, aux = stft_magnitude_hopper(x, window_size, hop_size, window_type)
    t = mag.shape[-2]
    out: Dict[str, torch.Tensor] = {}

    if enable_mfcc:
        out["mfcc"] = mfcc(
            mag, sample_rate, window_size, MFCCParams(num_coefficients=mfcc_coefficients)
        )

    # spectral (speech.go:320-367): raw magnitude, ZCR of the pre'd signal
    out.update(S.spectral_descriptor_bundle(mag, sample_rate, skip_rolloff=True))
    out["spectral_rolloff"] = aux["rolloff_bin"] * ((sample_rate / 2.0) / float(mag.shape[-1] - 1))
    out["zcr"] = S.zcr_from_signal(pre, window_size, hop_size, sample_rate)[..., :t]
    if enable_contrast:
        out["spectral_contrast"] = S.spectral_contrast(mag, sample_rate, contrast_bands)

    # energy (speech.go:411-461)
    ste = T.short_time_energy(pre, window_size, hop_size)
    out["short_time_energy"] = ste
    out["energy_variance"] = T.energy_variance(ste)
    out["energy_entropy"] = torch.where(ste > 0, -ste * torch.log(ste + 1e-10), 0.0)
    out["loudness_range"] = T.loudness_range(pre, sample_rate)
    out["low_energy_ratio"] = aux["low_energy_ratio"]
    out["high_energy_ratio"] = aux["high_energy_ratio"]

    # temporal (speech.go:370-407)
    if enable_temporal:
        onset_mask, onset_count = T.detect_onsets_from_energy(ste)
        out["onset_mask"] = onset_mask
        out["onset_density"] = onset_count.to(torch.float32) / (x.shape[-1] / float(sample_rate))
        out["attack_time"] = T.attack_times_from_onsets(onset_mask, ste, hop_size, sample_rate)
        out["peak_amplitude"] = torch.amax(torch.abs(pre), dim=-1)
        out["average_amplitude"] = torch.mean(torch.abs(pre), dim=-1)
        out["silence_ratio"] = T.silence_ratio_percentile(ste)
        out["envelope_shape"] = T.rms_envelope(pre, 512, 256)

    # harmonic (speech.go:464-509, fixed 1024/512, quirk #8)
    out["pitch"], out["pitch_confidence"], out["voicing"] = detect_pitch_track(
        pre, sample_rate, 1024, 512
    )

    # speech chain (speech.go:278-317)
    if enable_speech:
        analysis = analyze_speech(pre, sample_rate)
        out["is_speech"] = analysis.is_speech
        out["formant_frequencies"] = analysis.formants.frequencies
        out["formant_count"] = analysis.formants.count
        out["vocal_tract_length"] = analysis.formants.vocal_tract_length
        out["jitter"] = analysis.voice_quality.jitter
        out["shimmer"] = analysis.voice_quality.shimmer
        out["spectral_tilt"] = spectral_tilt_1024(pre)
        out["pause_duration"], out["pause_count"] = T.pause_durations(ste, hop_size, sample_rate)
        out["speech_rate"] = torch.where(
            analysis.is_speech, 4.0 * (1.0 - T.silence_ratio_percentile(ste)), 0.0
        )
    return out


def assemble_speech_features(
    out: Dict[str, torch.Tensor],
    config: FeatureConfig,
    is_news: bool,
    sample_rate: int,
) -> ExtractedFeatures:
    """Structure the program dict into the ExtractedFeatures schema with
    the is_speech gates of extractors/speech.py:253-273. Restructuring
    only, beyond the gating wheres."""
    features = ExtractedFeatures(metadata={})
    if config.enable_mfcc:
        features.mfcc = out["mfcc"]
    features.spectral_features = SpectralFeatures(
        spectral_centroid=out["spectral_centroid"],
        spectral_rolloff=out["spectral_rolloff"],
        spectral_bandwidth=out["spectral_bandwidth"],
        spectral_flatness=out["spectral_flatness"],
        spectral_crest=out["spectral_crest"],
        spectral_slope=out["spectral_slope"],
        spectral_flux=out["spectral_flux"],
        zero_crossing_rate=out["zcr"],
        spectral_contrast=out["spectral_contrast"] if config.enable_spectral_contrast else None,
    )

    if config.enable_speech_features and "is_speech" in out:
        is_speech = out["is_speech"]
        is_sp = is_speech[..., None]
        features.speech_features = SpeechFeatures(
            formant_frequencies=torch.where(is_sp, out["formant_frequencies"], 0.0)[..., None, :],
            formant_count=torch.where(is_speech, out["formant_count"], 0),
            vocal_tract_length=torch.where(is_speech, out["vocal_tract_length"], 17.5),
            voicing_probability=torch.where(is_sp, out["voicing"], 0.0),
            spectral_tilt=torch.where(is_sp, out["spectral_tilt"], 0.0),
            speech_rate=out["speech_rate"],
            pause_duration=out["pause_duration"],
            pause_count=out["pause_count"],
            jitter=torch.where(is_speech, out["jitter"], 0.0),
            shimmer=torch.where(is_speech, out["shimmer"], 0.0),
        )

    if config.enable_temporal_features and "onset_mask" in out:
        features.temporal_features = TemporalFeatures(
            rms_energy=out["short_time_energy"],
            peak_amplitude=out["peak_amplitude"],
            average_amplitude=out["average_amplitude"],
            dynamic_range=out["loudness_range"],
            silence_ratio=out["silence_ratio"],
            onset_density=out["onset_density"],
            onset_mask=out["onset_mask"],
            attack_time=out["attack_time"],
            envelope_shape=out["envelope_shape"],
        )

    features.energy_features = EnergyFeatures(
        short_time_energy=out["short_time_energy"],
        energy_variance=out["energy_variance"],
        energy_entropy=out["energy_entropy"],
        loudness_range=out["loudness_range"],
        low_energy_ratio=out["low_energy_ratio"],
        high_energy_ratio=out["high_energy_ratio"],
    )
    features.harmonic_features = HarmonicFeatures(
        pitch_estimate=out["pitch"],
        pitch_confidence=out["pitch_confidence"],
        voicing_strength=out["voicing"],
        harmonic_ratio=out["voicing"] * 10.0,
        inharmonicity_ratio=1.0 - out["voicing"],
        tonal_centroid=torch.where(out["pitch"] > 0, out["pitch"], 0.0),
    )
    features.metadata.update(
        extractor_type="speech",
        content_subtype="news" if is_news else "talk",
        algorithms_used="speech,spectral,temporal,filters,tonal",
        pre_emphasis_applied=True,
        sample_rate=sample_rate,
        spectrogram_frames=int(out["spectral_centroid"].shape[-1]),
        optimization="speech_optimized",
    )
    return features


def assemble_music_features(
    out: Dict[str, torch.Tensor],
    config: FeatureConfig,
    sample_rate: int,
) -> ExtractedFeatures:
    """Structure `parallel.pipeline.batched_music_extractor_features`
    output into the ExtractedFeatures schema as extractors/music.py
    assembles it."""
    features = ExtractedFeatures(metadata={})
    if config.enable_mfcc:
        features.mfcc = out["mfcc"]
    if config.enable_chroma:
        features.chroma_features = out["chroma"]
    features.spectral_features = SpectralFeatures(
        spectral_centroid=out["spectral_centroid"],
        spectral_rolloff=out["spectral_rolloff"],
        spectral_bandwidth=out["spectral_bandwidth"],
        spectral_flatness=out["spectral_flatness"],
        spectral_crest=out["spectral_crest"],
        spectral_slope=out["spectral_slope"],
        spectral_flux=out["spectral_flux"],
        zero_crossing_rate=out["zcr"],
        spectral_contrast=out["spectral_contrast"],
    )
    features.temporal_features = TemporalFeatures(
        rms_energy=out["rms_energy"],
        peak_amplitude=out["peak_amplitude"],
        average_amplitude=out["average_amplitude"],
        dynamic_range=out["dynamic_range"],
        crest_factor=out["crest_factor"],
        silence_ratio=out["silence_ratio"],
        onset_density=out["onset_density"],
        onset_mask=out["onset_mask"],
        attack_time=out["attack_time"],
        envelope_shape=out["envelope_shape"],
        tempo_bpm=out["tempo_bpm"],
    )
    features.energy_features = EnergyFeatures(
        short_time_energy=out["rms_energy"],
        energy_variance=out["energy_variance"],
        energy_entropy=out["energy_entropy"],
        loudness_range=out["loudness_range"],
        low_energy_ratio=out["low_energy_ratio"],
        high_energy_ratio=out["high_energy_ratio"],
    )
    if config.enable_harmonic_features:
        features.harmonic_features = HarmonicFeatures(
            pitch_estimate=out["pitch"],
            pitch_confidence=out["pitch_confidence"],
            voicing_strength=out["voicing"],
            harmonic_ratio=out["hnr"],
            inharmonicity_ratio=out["inharmonicity"],
            tonal_centroid=out["tonal_centroid"],
        )
    features.metadata.update(
        extractor_type="music",
        algorithms_used="spectral,chroma,temporal,tonal,harmonic,filters",
        sample_rate=sample_rate,
        spectrogram_frames=int(out["spectral_centroid"].shape[-1]),
    )
    return features
