"""The port's local-window noise floors, moving average and spectral SNR
(`ops/tonal.py`) held to the goref float64 oracle (`tests/goref.py`, at
the JAX tests' bounds) and to the JAX package on the CPU: twins of
`tests/test_noise_floor.py`, plus the window edges where the window
holds fewer than 20 bins, for all three estimators, and the row chunks
of `local_noise_floor`. Port against JAX: MUSIC_RTOL with an atol of
1e-6 (float32 cumsums of the moving average in another order)."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.ops import tonal as J  # noqa: E402
from sonido_sonar_tpu.ops.framing import frame_signal as jframes  # noqa: E402
from sonido_sonar_tpu.ops.stft import stft as jstft  # noqa: E402
from sonido_sonar_tpu_torch.ops import tonal as T  # noqa: E402
from sonido_sonar_tpu_torch.ops.framing import frame_signal  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402
from tests import goref  # noqa: E402

torch.set_num_threads(1)
SR = 8000
WINDOW = 1024
METHODS = ("percentile", "median", "minimum")


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close_jax(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=parity.MUSIC_RTOL, atol=1e-6)


def test_moving_average_parity():
    rng = np.random.default_rng(60)
    for n, ws in [(50, 10), (20, 3), (5, 5), (8, 1), (4, 9), (6, 0)]:
        x = rng.uniform(0, 2, size=n)
        got = T.moving_average(_t(x), ws).numpy()
        np.testing.assert_allclose(got, goref.moving_average(list(x), ws), rtol=1e-5, atol=1e-6)
        _close_jax(got, J.moving_average(jnp.asarray(x, jnp.float32), ws))


@pytest.mark.parametrize("method", METHODS)
def test_local_noise_floor_parity(method):
    rng = np.random.default_rng(61)
    for _ in range(10):
        mag = rng.uniform(0, 3, size=129)
        got = T.local_noise_floor(_t(mag), method=method).numpy()
        np.testing.assert_allclose(got, goref.noise_floor(list(mag), method), rtol=1e-4, atol=1e-5)
        _close_jax(got, J.local_noise_floor(jnp.asarray(mag, jnp.float32), method=method))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("n_bins", [7, 19, 20, 33])
def test_local_noise_floor_window_edges(method, n_bins):
    """Bins whose window runs past either end hold nv < 20 valid bins (all
    of them when F < 20): the quantile index ceil(p nv) - 1 is taken in
    float32 as in JAX; no smoothing, so each bin's pick shows."""
    rng = np.random.default_rng(62 + n_bins)
    mag = rng.uniform(0, 3, size=(3, n_bins)).astype(np.float32)
    for p in (0.1, 0.25, 0.3, 0.9):
        got = T.local_noise_floor(_t(mag), method=method, percentile=p, smoothing_len=1).numpy()
        ref = np.asarray(J.local_noise_floor(jnp.asarray(mag), method=method, percentile=p, smoothing_len=1))
        np.testing.assert_array_equal(got, ref)
        for row in range(3):
            want = [goref.percentile_empirical(list(mag[row, max(0, i - 10): min(n_bins, i + 10)]),
                                               {"median": 0.5}.get(method, p)) for i in range(n_bins)]
            if method == "minimum":
                want = [min(mag[row, max(0, i - 10): min(n_bins, i + 10)]) for i in range(n_bins)]
            np.testing.assert_array_equal(got[row], np.float32(want))


def test_local_noise_floor_row_chunks(monkeypatch):
    """The row chunks give the same floors as one pass."""
    mag = _t(np.random.default_rng(63).uniform(0, 3, size=(5, 3, 65)))
    whole = T.local_noise_floor(mag).numpy()
    monkeypatch.setattr(T, "NOISE_FLOOR_CHUNK_ELEMENTS", 1)
    np.testing.assert_array_equal(T.local_noise_floor(mag).numpy(), whole)


def test_spectral_snr_parity():
    rng = np.random.default_rng(62)
    mag = rng.uniform(0, 2, size=WINDOW // 2 + 1)
    freqs = np.arange(len(mag)) * (SR / WINDOW)
    want = goref.spectral_snr(list(mag), goref.noise_floor(list(mag), "percentile"), list(freqs), 50.0, 1000.0)
    got = T.HarmonicRatioAnalyzer(SR, min_f0=50.0, max_f0=1000.0, device="cpu").spectral_snr(_t(mag), WINDOW)
    assert float(got) == pytest.approx(want, abs=1e-3)
    ref = J.HarmonicRatioAnalyzer(SR, min_f0=50.0, max_f0=1000.0).spectral_snr(jnp.asarray(mag, jnp.float32), WINDOW)
    assert float(got) == pytest.approx(float(ref), *parity.MUSIC_DB_TOL)


def _tone_plus_noise(noise_amp: float, seed: int = 0) -> np.ndarray:
    t = np.arange(SR * 2) / SR
    x = np.zeros_like(t, dtype=np.float64)
    for h in range(1, 6):
        x += np.sin(2 * np.pi * 200.0 * h * t) / h
    rng = np.random.default_rng(seed)
    return (x + noise_amp * rng.standard_normal(len(t))).astype(np.float32)


def _frame_mag(x: np.ndarray) -> np.ndarray:
    """JAX's magnitudes, handed to both packages."""
    return np.asarray(jstft(jnp.asarray(x), WINDOW, 512, sample_rate=SR).magnitude)


def _hnr_pair(mag, method):
    """The port's spectral HNR, held to JAX's (utils/parity.MUSIC_DB_TOL)."""
    got = T.HarmonicRatioAnalyzer(SR, min_f0=80.0, max_f0=500.0, device="cpu").analyze_spectrum(
        _t(mag), WINDOW, noise_estimation=method)
    ref = J.HarmonicRatioAnalyzer(SR, min_f0=80.0, max_f0=500.0).analyze_spectrum(
        jnp.asarray(mag), WINDOW, noise_estimation=method)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), *parity.MUSIC_DB_TOL)
    return float(got.median())


def test_hnr_tone_vs_noise_property():
    mags = {"clean": _frame_mag(_tone_plus_noise(0.01)), "noisy": _frame_mag(_tone_plus_noise(0.5)),
            "white": _frame_mag(np.random.default_rng(63).standard_normal(SR * 2).astype(np.float32))}
    for method in METHODS:
        v = {k: _hnr_pair(m, method) for k, m in mags.items()}
        assert v["clean"] > v["noisy"] > v["white"], (method, v)
        assert v["clean"] > 20.0, method


def test_method_switch_changes_hnr_on_colored_noise():
    rng = np.random.default_rng(64)
    n = SR * 2
    spec = np.fft.rfft(rng.standard_normal(n))
    spec /= np.maximum(np.sqrt(np.arange(len(spec)) + 1.0), 1.0)
    pink = np.fft.irfft(spec, n=n)
    pink = (pink / np.abs(pink).max()).astype(np.float32)
    mag = _frame_mag(_tone_plus_noise(0.0) + 0.3 * pink)
    vals = {m: _hnr_pair(mag, m) for m in METHODS}
    assert vals["minimum"] > vals["percentile"] > vals["median"], vals


def test_hnr_mask_split_methods():
    analyzer = T.HarmonicRatioAnalyzer(SR, method="comb", min_f0=80.0, max_f0=500.0, device="cpu")
    janalyzer = J.HarmonicRatioAnalyzer(SR, method="comb", min_f0=80.0, max_f0=500.0)
    tone = _tone_plus_noise(0.02, seed=1)
    noise = np.random.default_rng(2).standard_normal(SR * 2).astype(np.float32)
    med = {}
    for name, x in (("tone", tone), ("noise", noise)):
        got = analyzer.analyze_frames(frame_signal(_t(x), WINDOW, 512))
        ref = janalyzer.analyze_frames(jframes(jnp.asarray(x), WINDOW, 512))
        same = got.f0.numpy() == np.asarray(ref.f0)
        assert same.mean() >= 1.0 - parity.FFT_PITCH_MISS_SHARE
        np.testing.assert_allclose(got.harmonic_ratio.numpy()[same], np.asarray(ref.harmonic_ratio)[same],
                                   *parity.MUSIC_DB_TOL)
        med[name] = float(got.harmonic_ratio.median())
    assert med["tone"] > med["noise"] + 10.0 and med["tone"] > 10.0
