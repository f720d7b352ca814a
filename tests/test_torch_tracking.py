"""The port's harmonic partial tracking (`ops/tracking.py`) held to the
JAX package on the CPU: twins of `tests/test_tracking.py`, each on
JAX's magnitudes handed to both packages. The peaks are equal bit for
bit (utils/parity: index outputs equal) and the host bookkeeping is the
same float64 numpy, so the track lists must be equal: ids, frames,
frequencies and amplitudes."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.io.synth import sine  # noqa: E402
from sonido_sonar_tpu.ops import tracking as J  # noqa: E402
from sonido_sonar_tpu.ops.stft import stft as jstft  # noqa: E402
from sonido_sonar_tpu_torch.ops import tracking as T  # noqa: E402
from sonido_sonar_tpu_torch.ops.stft import stft as tstft  # noqa: E402

torch.set_num_threads(1)
SR = 22050


def _tracks(x, params=None):
    """(port result, JAX result) on JAX's magnitudes; asserts equality."""
    mag = np.asarray(jstft(jnp.asarray(x.astype(np.float32)), 2048, 512, sample_rate=SR).magnitude)
    got = T.HarmonicTracking(SR, params and T.TrackingParams(**params), device="cpu").process_magnitude_spectrogram(
        mag, 2048)
    ref = J.HarmonicTracking(SR, params and J.TrackingParams(**params)).process_magnitude_spectrogram(
        jnp.asarray(mag), 2048)
    assert got.num_frames == ref.num_frames == mag.shape[0]
    assert [vars(t) for t in got.tracks] == [vars(t) for t in ref.tracks]
    return got, mag


def test_tracks_steady_partials():
    res, mag = _tracks(sine(440, 1.0, SR, 0.5) + sine(1320, 1.0, SR, 0.4))
    assert res.num_tracks >= 2
    long_tracks = sorted(res.tracks, key=lambda t: -t.length)[:2]
    freqs = sorted(t.mean_frequency for t in long_tracks)
    assert freqs[0] == pytest.approx(440, abs=15) and freqs[1] == pytest.approx(1320, abs=15)
    assert long_tracks[0].length > mag.shape[0] * 0.8


def test_track_birth_and_death():
    n = SR
    x = np.zeros(n, np.float32)
    x[n // 2:] = sine(880, 0.5, SR, 0.6)
    x[: n // 2] = sine(220, 0.5, SR, 0.6)
    res, mag = _tracks(x)
    t_frames = mag.shape[0]
    assert [t for t in res.tracks if t.start_frame > t_frames * 0.4 and abs(t.mean_frequency - 880) < 30]
    assert [t for t in res.tracks if t.end_frame < t_frames * 0.6 and abs(t.mean_frequency - 220) < 30]


def test_glide_tracked_continuously():
    t = np.arange(SR) / SR
    x = (0.5 * np.sin(2 * np.pi * np.cumsum(400 + 100 * t) / SR)).astype(np.float32)
    res, mag = _tracks(x)
    longest = max(res.tracks, key=lambda tr: tr.length)
    assert longest.length > mag.shape[0] * 0.8
    assert longest.frequencies[-1] > longest.frequencies[0] + 50


def test_min_track_length_filter():
    res, _ = _tracks(sine(440, 0.5, SR, 0.5), dict(min_track_length=5))
    assert all(t.length >= 5 for t in res.tracks)


@pytest.mark.parametrize("params", [None, dict(max_peaks=4, max_gap_length=1, birth_threshold=0.1)])
def test_noisy_chord_tracks_match_jax(params):
    """A three-note chord with amplitude swells, noise and a gap: births,
    deaths and matches in the reference's order."""
    rng = np.random.default_rng(180)
    t = np.arange(int(1.5 * SR)) / SR
    x = sum(a * (1 + 0.5 * np.sin(2 * np.pi * 1.5 * t + k)) * np.sin(2 * np.pi * f * t)
            for k, (f, a) in enumerate(((262.0, 0.4), (330.0, 0.3), (392.0, 0.3))))
    x = x + 0.05 * rng.standard_normal(len(t))
    x[int(0.7 * SR): int(0.8 * SR)] = 0.0
    res, _ = _tracks(x, params)
    assert res.num_tracks >= 3


def test_process_spectrogram_and_port_magnitudes():
    """The complex path takes |X|; the port's own spectrogram tracks the
    same partials."""
    x = (sine(440, 1.0, SR, 0.5) + sine(1320, 1.0, SR, 0.4)).astype(np.float32)
    spec = tstft(x, 2048, 512, sample_rate=SR, return_complex=True, device="cpu")
    track = T.HarmonicTracking(SR, device="cpu")
    a = track.process_spectrogram(spec.complex_spec, 2048)
    b = track.process_magnitude_spectrogram(torch.abs(spec.complex_spec), 2048)
    assert [vars(t) for t in a.tracks] == [vars(t) for t in b.tracks]
    freqs = sorted(t.mean_frequency for t in sorted(a.tracks, key=lambda t: -t.length)[:2])
    assert freqs[0] == pytest.approx(440, abs=15) and freqs[1] == pytest.approx(1320, abs=15)
