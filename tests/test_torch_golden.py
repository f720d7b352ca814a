"""The port held to the repo's golden fixtures: `tests/test_golden.py`'s
two recipes run through the port's modules on the CPU and checked
against `tests/golden/features.npz` (rtol = atol = 1e-3) and
`tests/golden/extractors.npz` (2e-4), the fixtures' own bounds. The
fixtures are read, never written."""

import os

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SR = 22050

torch.set_num_threads(1)


def compute_features():
    """tests/test_golden.py:compute_features through the port."""
    from sonido_sonar_tpu_torch.io.synth import harmonic_tone, white_noise
    from sonido_sonar_tpu_torch.ops import spectral as S
    from sonido_sonar_tpu_torch.ops.chroma import chroma_from_magnitude
    from sonido_sonar_tpu_torch.ops.mfcc import mfcc
    from sonido_sonar_tpu_torch.ops.pitch import detect_pitch_track
    from sonido_sonar_tpu_torch.ops.stft import stft
    from sonido_sonar_tpu_torch.ops.temporal import short_time_energy

    x = torch.from_numpy((harmonic_tone(220.0, 2.0, SR) + white_noise(2.0, SR, 0.05, seed=42)).astype(np.float32))
    mag = stft(x, 1024, 256, sample_rate=SR).magnitude
    return {
        "stft_mag_f0": mag[0].numpy(),
        "stft_mag_mid": mag[mag.shape[0] // 2].numpy(),
        "mfcc_first8": mfcc(mag, SR, 1024).numpy()[:8],
        "chroma_mean": chroma_from_magnitude(mag, SR, 1024).numpy().mean(0),
        "centroid": S.spectral_centroid(mag, SR).numpy()[:32],
        "rolloff": S.spectral_rolloff(mag, SR).numpy()[:32],
        "flatness": S.spectral_flatness(mag).numpy()[:32],
        "contrast_mean": S.spectral_contrast(mag, SR, 6).numpy().mean(0),
        "rms": short_time_energy(x, 1024, 256).numpy()[:32],
        "pitch": detect_pitch_track(x, SR, 1024, 512)[0].numpy()[:16],
    }


def compute_extractor_features():
    """tests/test_golden.py:compute_extractor_features through the port."""
    from sonido_sonar_tpu_torch.config.config import FeatureConfig
    from sonido_sonar_tpu_torch.extractors.music import MusicFeatureExtractor
    from sonido_sonar_tpu_torch.extractors.speech import SpeechFeatureExtractor
    from sonido_sonar_tpu_torch.extractors.sports import MixedFeatureExtractor, SportsFeatureExtractor
    from sonido_sonar_tpu_torch.io.synth import harmonic_tone, white_noise
    from sonido_sonar_tpu_torch.ops.stft import stft

    x = torch.from_numpy((harmonic_tone(196.0, 2.0, SR) + white_noise(2.0, SR, 0.04, seed=7)).astype(np.float32))
    cfg = FeatureConfig(sample_rate=SR, window_size=1024, hop_size=256).with_(
        enable_harmonic_features=True, enable_chroma=True, enable_speech_features=True)
    spec = stft(x, 1024, 256, cfg.window_type, SR)
    out = {}
    for name, ext in (("speech", SpeechFeatureExtractor(cfg)), ("music", MusicFeatureExtractor(cfg)),
                      ("sports", SportsFeatureExtractor(cfg)), ("mixed", MixedFeatureExtractor(cfg))):
        f = ext.extract_features(spec, x, SR)
        out[f"{name}/mfcc_mean"] = f.mfcc.numpy().mean(0)
        sf = f.spectral_features
        out[f"{name}/centroid"] = sf.spectral_centroid.numpy()[:16]
        out[f"{name}/contrast_mean"] = sf.spectral_contrast.numpy().mean(0)
        out[f"{name}/rms"] = f.energy_features.short_time_energy.numpy()[:16]
        if f.harmonic_features is not None:
            out[f"{name}/pitch"] = f.harmonic_features.pitch_estimate.numpy()[:8]
        if f.chroma_features is not None:
            out[f"{name}/chroma_mean"] = f.chroma_features.numpy().mean(0)
        if f.speech_features is not None:
            out[f"{name}/jitter"] = np.asarray(f.speech_features.jitter)
            out[f"{name}/formants"] = f.speech_features.formant_frequencies.numpy().ravel()
    return out


@pytest.mark.parametrize("fixture,compute,tol", [
    ("features.npz", compute_features, 1e-3),
    ("extractors.npz", compute_extractor_features, 2e-4),
])
def test_port_matches_golden_fixture(fixture, compute, tol):
    path = os.path.join(GOLDEN, fixture)
    before = os.stat(path).st_mtime_ns
    got = compute()
    with np.load(path) as ref:
        assert set(ref.files) == set(got)
        for key in ref.files:
            np.testing.assert_allclose(got[key], ref[key], rtol=tol, atol=tol, err_msg=f"{fixture}: {key}")
    assert os.stat(path).st_mtime_ns == before
