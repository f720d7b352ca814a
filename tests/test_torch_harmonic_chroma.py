"""The port's `ops/harmonic.py`, the rest of `ops/chroma.py` and
`ops/pitch.py`'s `acf_pitch` / `median_filter_pitch` held to the JAX
package on the CPU: twins of `tests/test_chroma.py` (each runs the same
recipe through both packages and asserts the same property of the
port), plus tied peaks, even-width and NaN medians, the CQT tables bit
for bit, the zero pad under the kernel length and every HPCP option.
Tolerances: utils/parity.py (MUSIC_*, CQT_CHROMA_ATOL, HPCP_*,
FFT_PITCH_MISS_SHARE); the HPCP entropy takes 1e-4 bits, HPCP_ATOL
through -p log2 p summed over 12 bins."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.io.synth import harmonic_tone, sine, white_noise  # noqa: E402
from sonido_sonar_tpu.ops import chroma as J  # noqa: E402
from sonido_sonar_tpu.ops import harmonic as JH  # noqa: E402
from sonido_sonar_tpu.ops import pitch as JP  # noqa: E402
from sonido_sonar_tpu.ops.stft import stft as jstft  # noqa: E402
from sonido_sonar_tpu_torch.ops import chroma as T  # noqa: E402
from sonido_sonar_tpu_torch.ops import harmonic as TH  # noqa: E402
from sonido_sonar_tpu_torch.ops import pitch as TP  # noqa: E402
from sonido_sonar_tpu_torch.ops.stft import stft as tstft  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)
SR = 22050


def note_freq(label, octave=4):
    semis = T.CHROMA_LABELS.index(label) - 9 + (octave - 4) * 12  # A4 = 440
    return 440.0 * 2 ** (semis / 12)


def _close(got, ref, rtol=parity.MUSIC_RTOL, atol=parity.MUSIC_ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def _mag(x, w, hop):
    """JAX's magnitudes, handed to both packages (same-magnitude checks)."""
    return np.asarray(jstft(jnp.asarray(x), w, hop, sample_rate=SR).magnitude)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def test_fold_matrix_columns():
    fold = T.chroma_fold_matrix(1025, SR, 2048)
    np.testing.assert_array_equal(fold, J.chroma_fold_matrix(1025, SR, 2048))
    assert (fold.sum(axis=0) <= 1.0).all()
    assert fold[T.CHROMA_LABELS.index("A"), round(440.0 * 2048 / SR)] == 1.0


@pytest.mark.parametrize("note", ["C", "E", "G", "A"])
def test_chroma_peaks_at_note(note):
    x = sine(note_freq(note), 0.5, SR)
    got = T.chroma_stft(x, SR, 2048, 512, device="cpu").numpy()
    _close(got, J.chroma_stft(jnp.asarray(x), SR, 2048, 512), 0.0, parity.FEATURE_TOLERANCES["chroma"][1])
    mean = got.mean(axis=0)
    assert mean.argmax() == T.CHROMA_LABELS.index(note)
    assert mean.sum() == pytest.approx(1.0, abs=1e-3)


def test_chroma_harmonic_tone():
    """W = 4096 takes the FFT spectrogram in both packages."""
    x = harmonic_tone(note_freq("C", 3), 0.5, SR)
    got = T.chroma_stft(x, SR, 4096, 1024, device="cpu").numpy()
    _close(got, J.chroma_stft(jnp.asarray(x), SR, 4096, 1024), 0.0, parity.FEATURE_TOLERANCES["chroma"][1])
    mean = got.mean(axis=0)
    assert mean[T.CHROMA_LABELS.index("C")] == mean.max()


def _triad(labels_octaves):
    return (sum(sine(note_freq(n, o), 1.0, SR) for n, o in labels_octaves) / 3.0).astype(np.float32)


def test_key_estimation_c_major():
    x = _triad([("C", 4), ("E", 4), ("G", 4)])
    got = T.estimate_key(T.chroma_stft(x, SR, 4096, 1024, device="cpu"))
    assert got == J.estimate_key(J.chroma_stft(jnp.asarray(x), SR, 4096, 1024)) == ("C", "major")


def test_key_estimation_a_minor():
    """The simplified profiles rank E minor first here (tests/test_chroma.py)."""
    x = _triad([("A", 3), ("C", 4), ("E", 4)])
    got = T.estimate_key(T.chroma_stft(x, SR, 4096, 1024, device="cpu"))
    assert got == J.estimate_key(J.chroma_stft(jnp.asarray(x), SR, 4096, 1024))
    assert got in [("A", "minor"), ("C", "major"), ("E", "minor")]


def test_key_correlations_and_pearson_match_jax():
    rng = np.random.default_rng(160)
    v = rng.uniform(0, 1, (6, 12)).astype(np.float32)
    v[0] = 0.25  # a constant row: zero variance, correlation 0
    _close(T.key_correlations(_t(v)), J.key_correlations(jnp.asarray(v)))
    y = rng.uniform(0, 1, (6, 12)).astype(np.float32)
    _close(T._pearson(_t(v), _t(y)), J._pearson(jnp.asarray(v), jnp.asarray(y)))


def test_chroma_cqt_peak():
    x = sine(note_freq("D"), 1.0, SR)
    got = T.chroma_cqt(_t(x), SR, hop_size=2048).numpy()
    _close(got, J.chroma_cqt(jnp.asarray(x), SR, hop_size=2048), 0.0, parity.CQT_CHROMA_ATOL)
    assert got.mean(axis=0).argmax() == T.CHROMA_LABELS.index("D")


@pytest.mark.parametrize("sample_rate", [16000, 22050, 44100])
def test_cqt_kernels_bit_equal(sample_rate):
    """Both packages build the tables in float64 and cast once."""
    kr, ki, L = T.cqt_kernels(sample_rate)
    jr, ji, jl = J.cqt_kernels(sample_rate)
    assert L == jl and kr.dtype == np.float32
    np.testing.assert_array_equal(kr, jr)
    np.testing.assert_array_equal(ki, ji)


@pytest.mark.parametrize("n", [3000, 8192, 8192 + 3 * 512 + 100])
def test_chroma_cqt_pads_and_frames_like_jax(n):
    """Under L = 8192 both zero-pad to one frame; at and past L they frame."""
    rng = np.random.default_rng(161)
    x = (rng.standard_normal((2, n)) * 0.1).astype(np.float32)
    x[1] += sine(330.0, n / SR, SR)[:n]
    got = T.chroma_cqt(_t(x), SR).numpy()
    ref = np.asarray(J.chroma_cqt(jnp.asarray(x), SR))
    assert got.shape == ref.shape == (2, max((n - 8192) // 512 + 1, 1), 12)
    _close(got, ref, 0.0, parity.CQT_CHROMA_ATOL)


def test_chroma_cqt_chunks_rows_like_one_pass(monkeypatch):
    """The row chunks give the same chroma as one pass over all rows."""
    rng = np.random.default_rng(162)
    x = _t(rng.standard_normal((3, 9000)) * 0.1)
    whole = T.chroma_cqt(x, SR)
    monkeypatch.setattr(T, "CQT_CHUNK_ELEMENTS", 1)
    _close(T.chroma_cqt(x, SR), whole, 0.0, parity.CQT_CHROMA_ATOL)


def test_spectral_peaks():
    x = sine(1000, 0.3, SR, 0.5) + sine(3000, 0.3, SR, 0.25)
    mag = _mag(x, 2048, 512).mean(0)
    got = [v.numpy() for v in TH.detect_spectral_peaks(_t(mag), SR, 2048, max_peaks=8, min_peak_height=0.1)]
    ref = [np.asarray(v) for v in JH.detect_spectral_peaks(jnp.asarray(mag), SR, 2048, max_peaks=8,
                                                           min_peak_height=0.1)]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    c = int(got[2])
    assert c >= 2
    assert np.min(np.abs(got[0][:c] - 1000)) < 30 and np.min(np.abs(got[0][:c] - 3000)) < 30
    assert abs(got[0][0] - 1000) < 30  # strongest peak first (greedy max-first)


@pytest.mark.parametrize("max_peaks,distance_hz", [(4, 50.0), (16, 200.0), (24, 50.0)])
def test_detect_spectral_peaks_ties_match_jax(max_peaks, distance_hz):
    """Tied peaks come out lowest bin first in both packages (argmax keeps
    the first of equal values); a suppression window clamped at the row's
    edges; fewer peaks than slots fill idx -1 / freq 0 / mag 0."""
    rng = np.random.default_rng(163)
    mag = np.abs(rng.standard_normal((5, 6, 257))).astype(np.float32)
    mag[0, 0, [10, 20, 30]] = 5.0          # three equal peaks
    mag[1, 1, [1, 255]] = 9.0              # peaks next to each edge
    mag[2, 2] = 0.0                        # no candidate
    mag[3, 3, 100:110] = 2.0               # a plateau: no strict local maximum
    got = [v.numpy() for v in TH.detect_spectral_peaks(_t(mag), SR, 512, max_peaks,
                                                        min_peak_distance_hz=distance_hz)]
    ref = [np.asarray(v) for v in JH.detect_spectral_peaks(jnp.asarray(mag), SR, 512, max_peaks,
                                                           min_peak_distance_hz=distance_hz)]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
    freq_res = SR / 512.0
    np.testing.assert_array_equal(got[0][0, 0, :3], np.float32([10, 20, 30]) * np.float32(freq_res))
    assert got[2][2, 2] == 0 and (got[1][2, 2] == 0).all()


def test_harmonic_product_spectrum_bit_equal():
    """The same products in the same order."""
    rng = np.random.default_rng(164)
    mag = rng.uniform(0, 2, (3, 513)).astype(np.float32)
    for h in (2, 3, 5):
        np.testing.assert_array_equal(TH.harmonic_product_spectrum(_t(mag), h).numpy(),
                                      np.asarray(JH.harmonic_product_spectrum(jnp.asarray(mag), h)))


def test_hps_f0():
    x = harmonic_tone(220.0, 0.5, SR)
    mag = _mag(x, 4096, 1024)
    got = TH.estimate_f0_hps(_t(mag), SR, 4096, 50, 1000).numpy()
    np.testing.assert_array_equal(got, np.asarray(JH.estimate_f0_hps(jnp.asarray(mag), SR, 4096, 50, 1000)))
    assert np.median(got) == pytest.approx(220.0, abs=15)
    port_mag = tstft(x, 4096, 1024, sample_rate=SR, device="cpu").magnitude
    assert np.median(TH.estimate_f0_hps(port_mag, SR, 4096, 50, 1000).numpy()) == pytest.approx(220.0, abs=15)


def test_acf_pitch_and_f0_autocorrelation_match_jax():
    """FFT-based lag picks: FFT_PITCH_MISS_SHARE of frames may differ."""
    rng = np.random.default_rng(165)
    tones = [harmonic_tone(f, 0.2, SR) for f in (110.0, 196.0, 330.0, 523.0)]
    x = np.stack(tones + [white_noise(0.2, SR, 0.3, seed=5)]).astype(np.float32)
    x = x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
    frames = np.lib.stride_tricks.sliding_window_view(x, 2048, axis=-1)[:, ::512]
    frames = np.ascontiguousarray(frames)
    params = (SR, 2048, 60.0, 1000.0)
    got = TP.acf_pitch(_t(frames), TP.PitchParams(*params))
    ref = JP.acf_pitch(jnp.asarray(frames), JP.PitchParams(*params))
    errors, failures = parity.check_pitch_decisions(got[0].numpy(), got[1].numpy(),
                                                    np.asarray(ref[0]), np.asarray(ref[1]))
    assert not failures, (failures, errors)
    assert (got[0].numpy()[:4] > 0).mean() > 0.9
    got = TH.estimate_f0_autocorrelation(_t(frames), SR, 60.0, 1000.0)
    ref = JH.estimate_f0_autocorrelation(jnp.asarray(frames), SR, 60.0, 1000.0)
    errors, failures = parity.check_pitch_decisions(got[0].numpy(), got[1].numpy(),
                                                    np.asarray(ref[0]), np.asarray(ref[1]))
    assert not failures, (failures, errors)
    # a lag range that the window cannot hold (min lag 22 > 15) gives zeros in both
    z = TP.acf_pitch(_t(frames[:, :, :16]), TP.PitchParams(SR, 16, 60.0, 1000.0))
    assert not z[0].any() and z[0].shape == frames.shape[:2]
    assert not np.asarray(JP.acf_pitch(jnp.asarray(frames[:, :, :16]), JP.PitchParams(SR, 16, 60.0, 1000.0))[0]).any()


@pytest.mark.parametrize("width", [3, 4, 5, 6])
def test_median_filter_pitch_matches_jax(width):
    """Edge padding, the two middle values averaged on an even width, and
    NaN propagated through every window that holds one."""
    rng = np.random.default_rng(166 + width)
    p = rng.uniform(80, 400, (3, 40)).astype(np.float32)
    p[0, [0, 17, 39]] = np.nan
    p[1, 5:9] = 0.0
    got = TP.median_filter_pitch(_t(p), width).numpy()
    ref = np.asarray(JP.median_filter_pitch(jnp.asarray(p), width))
    np.testing.assert_array_equal(got, ref)
    assert np.isnan(got[0, 16]) and not np.isnan(got[2]).any()


def test_hpcp_peaks_at_note():
    x = harmonic_tone(note_freq("G", 3), 0.5, SR)
    mag = _mag(x, 4096, 1024)
    got = T.hpcp_from_magnitude(_t(mag), SR, 4096).numpy()
    _close(got, J.hpcp_from_magnitude(jnp.asarray(mag), SR, 4096), 0.0, parity.HPCP_ATOL)
    assert got.mean(axis=0).argmax() == T.CHROMA_LABELS.index("G")
    assert np.linalg.norm(got[5]) == pytest.approx(1.0, abs=1e-3)


@pytest.mark.parametrize("options", [
    dict(non_linear=True), dict(max_shifted=True), dict(weight_type="squared_cosine"),
    dict(weight_type="none", band_preset=False), dict(size=36, window_semitones=4.0 / 3.0),
    dict(size=24, max_shifted=True, non_linear=True),
])
def test_hpcp_options_match_jax(options):
    rng = np.random.default_rng(167)
    x = np.stack([harmonic_tone(f, 0.4, SR) for f in (147.0, 262.0)])
    x = (x + 0.02 * rng.standard_normal(x.shape)).astype(np.float32)
    mag = _mag(x, 2048, 512)
    got = T.hpcp_from_magnitude(_t(mag), SR, 2048, **options).numpy()
    _close(got, J.hpcp_from_magnitude(jnp.asarray(mag), SR, 2048, **options), 0.0, parity.HPCP_ATOL)


def test_hpcp_entropy_tone_vs_noise():
    tone, noise = sine(440, 0.3, SR), white_noise(0.3, SR, 0.3)
    ent = {}
    for name, x in (("tone", tone), ("noise", noise)):
        mag = _mag(x, 2048, 512)
        h = T.hpcp_from_magnitude(_t(mag), SR, 2048)
        e = T.hpcp_entropy(h).numpy()
        _close(e, J.hpcp_entropy(J.hpcp_from_magnitude(jnp.asarray(mag), SR, 2048)), 0.0, 1e-4)
        ent[name] = float(e.mean())
    assert ent["tone"] < ent["noise"]
