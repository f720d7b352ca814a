"""The port's speech analysis (ops/speech.py) held to the JAX package on
the CPU: LPC, formants, voice quality (K2 with period amplitude, through
its plain version here), hnr_acf on long rows and on short frame rows,
speech detection and the AnalyzeSpeech facade. Tolerances are
EXTRACTOR_TOLERANCES and the shimmer bound of utils/parity.py."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.ops import speech as jsp  # noqa: E402
from sonido_sonar_tpu.ops.filters import pre_emphasis as j_pre  # noqa: E402
from sonido_sonar_tpu.parallel import pipeline as jpipe  # noqa: E402
from sonido_sonar_tpu_torch.ops import speech as tsp  # noqa: E402
from sonido_sonar_tpu_torch.parallel import pipeline as tpipe  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)
SR = 44100
N = int(1.5 * SR)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def speech_pcm():
    """[4, 1.5 s], speech-pre-emphasized `parity.voiced_pcm` rows: three
    voices with vibrato and tremolo, one noise row."""
    return np.array(j_pre(jnp.asarray(parity.voiced_pcm(4, N, 21).numpy()), 0.97))


@pytest.fixture(scope="module")
def analysis(speech_pcm):
    t = tsp.analyze_speech(torch.from_numpy(speech_pcm), SR)
    j = _np(jsp.analyze_speech(jnp.asarray(speech_pcm), SR))
    return t, j


def _check(pairs, n_samples=N):
    got = {k: v[0].numpy() if isinstance(v[0], torch.Tensor) else np.asarray(v[0]) for k, v in pairs.items()}
    ref = {k: np.asarray(v[1]) for k, v in pairs.items()}
    errors, failures = parity.check_extracted(got, ref, SR, 1024, n_samples=n_samples)
    assert not failures, (failures, errors)
    return errors


@pytest.mark.parametrize("order", [0, 12])
def test_lpc_matches_jax(speech_pcm, order):
    """Autocorrelation (rFFT both sides) and the batched Levinson-Durbin
    recursion over the first window: coefficients within 1e-3 of the
    largest (order 56 amplifies the autocorrelation's float32 rounding),
    reflection coefficients 1e-3, the envelope 1e-3 relative."""
    x = speech_pcm[:, :2048]
    t = tsp.lpc_analyze(torch.from_numpy(x), SR, order)
    j = jsp.lpc_analyze(jnp.asarray(x), SR, order)
    assert t.order == j.order == (order or 56)
    np.testing.assert_allclose(
        tsp.autocorrelation_r(torch.from_numpy(x), t.order).numpy(),
        np.asarray(jsp.autocorrelation_r(jnp.asarray(x), t.order)), rtol=1e-4, atol=1e-4)
    a, ja = t.coefficients.numpy(), np.asarray(j.coefficients)
    np.testing.assert_allclose(a, ja, atol=1e-3 * np.abs(ja).max())
    np.testing.assert_allclose(t.reflection.numpy(), np.asarray(j.reflection), atol=1e-3)
    np.testing.assert_allclose(t.residual_energy.numpy(), np.asarray(j.residual_energy), rtol=1e-3)
    env = tsp.lpc_spectral_envelope(torch.from_numpy(ja), 1024).numpy()
    np.testing.assert_allclose(env, np.asarray(jsp.lpc_spectral_envelope(jnp.asarray(ja), 1024)), rtol=1e-3)


def test_levinson_durbin_single_row_and_batch(speech_pcm):
    r = np.asarray(jsp.autocorrelation_r(jnp.asarray(speech_pcm[:, :1024]), 16))
    a, k, g, e = tsp.levinson_durbin(torch.from_numpy(r), 16)
    a0, k0, g0, e0 = tsp.levinson_durbin(torch.from_numpy(r[1]), 16)
    assert torch.equal(a[1], a0) and torch.equal(k[1], k0) and torch.equal(g[1], g0)
    ja, jk, jg, je = jsp.levinson_durbin(jnp.asarray(r), 16)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), atol=1e-4 * np.abs(np.asarray(ja)).max())
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4)


def test_formants(analysis):
    t, j = analysis
    f, jf = t.formants, j.formants
    _check({
        "formant_frequencies": (f.frequencies, jf.frequencies),
        "formant_count": (f.count, jf.count),
        "vocal_tract_length": (f.vocal_tract_length, jf.vocal_tract_length),
    })
    np.testing.assert_allclose(f.bandwidths.numpy(), jf.bandwidths, atol=1e-2)
    np.testing.assert_allclose(f.confidences.numpy(), jf.confidences, atol=1e-4)
    np.testing.assert_allclose(f.quality.numpy(), jf.quality)
    assert int(f.count.max()) >= 1


def test_formant_candidate_ties_keep_the_lower_bin():
    """An envelope with two equal peaks: lax.top_k puts the lower index
    first; the port's stable sort does the same."""
    x = np.zeros(2048, np.float32)
    x[0] = 1.0
    t = tsp.analyze_formants(torch.from_numpy(x), SR)
    j = _np(jsp.analyze_formants(jnp.asarray(x), SR))
    np.testing.assert_allclose(t.frequencies.numpy(), j.frequencies, atol=1e-2)
    assert int(t.count) == int(j.count)


def test_voice_quality(analysis, speech_pcm):
    """K2 with period amplitude (plain version here) against the JAX CPU
    path, whose amplitudes come from a whole-row float32 cumsum: shimmer
    and amplitude stability within the bound that cumsum allows."""
    t, j = analysis
    v, jv = t.voice_quality, j.voice_quality
    errors = _check({
        "jitter": (v.jitter, jv.jitter),
        "shimmer": (v.shimmer, jv.shimmer),
        "amplitude_stability": (v.amplitude_stability, jv.amplitude_stability),
        "hnr": (v.hnr, jv.hnr),
        "f0_mean": (v.mean_f0, jv.mean_f0),
        "voicing_strength": (v.voicing_strength, jv.voicing_strength),
        "noise_measure": (v.noise_measure, jv.noise_measure),
        "quality": (v.overall_quality, jv.overall_quality),
    })
    np.testing.assert_array_equal(v.num_periods.numpy(), jv.num_periods)
    np.testing.assert_allclose(v.f0_stability.numpy(), jv.f0_stability, atol=1e-5)
    np.testing.assert_allclose(v.f0_range.numpy(), jv.f0_range, rtol=1e-3, atol=1e-3)
    assert int(v.num_periods.max()) > 10 and errors["shimmer"] < parity.SHIMMER_ATOL_PER_SAMPLE * N


@pytest.mark.parametrize("shape", [(3, N), (N,)])
def test_hnr_acf_long_rows(speech_pcm, shape):
    """One lag per row as a dot product (the voice-quality call)."""
    x = speech_pcm[:3].reshape(shape) if len(shape) == 2 else speech_pcm[0]
    f0 = np.array([180.0, 333.3, 97.0][: 3 if len(shape) == 2 else 1], np.float32).reshape(shape[:-1])
    got = tsp.hnr_acf(torch.from_numpy(x), SR, torch.from_numpy(f0)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsp.hnr_acf(jnp.asarray(x), SR, jnp.asarray(f0))), atol=1e-2, rtol=1e-4)


def test_hnr_acf_short_frame_rows(speech_pcm):
    """[B, T, 256] frame rows (the music program's): all lags from a
    torch.fft power spectrum against the JAX DFT matmuls."""
    frames = speech_pcm[:2, : 40 * 256].reshape(2, 40, 256)
    f0 = np.random.default_rng(1).uniform(180.0, 900.0, (2, 40)).astype(np.float32)
    got = tsp.hnr_acf(torch.from_numpy(frames), SR, torch.from_numpy(f0)).numpy()
    ref = np.asarray(jsp.hnr_acf(jnp.asarray(frames), SR, jnp.asarray(f0)))
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-4)


def test_detect_speech(speech_pcm):
    x = np.concatenate([speech_pcm, 1e-5 * speech_pcm[:1]])
    got = tsp.detect_speech(torch.from_numpy(x), SR).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsp.detect_speech(jnp.asarray(x), SR)))
    assert got.any() and not got[-1]
    short = torch.zeros((2, SR // 8))
    assert not tsp.detect_speech(short, SR).any()


def test_analyze_speech_facade(analysis):
    t, j = analysis
    np.testing.assert_array_equal(t.is_speech.numpy(), j.is_speech)
    np.testing.assert_allclose(t.intelligibility.numpy(), j.intelligibility, atol=1e-6)
    np.testing.assert_allclose(t.quality_score.numpy(), j.quality_score, atol=1e-3)


def test_batched_speech_analysis(speech_pcm):
    got = {k: v.numpy() for k, v in tpipe.batched_speech_analysis(torch.from_numpy(speech_pcm), SR).items()}
    ref = _np(jpipe.batched_speech_analysis(jnp.asarray(speech_pcm), SR))
    errors, failures = parity.check_extracted(got, ref, SR, 1024, n_samples=N)
    assert not failures, (failures, errors)
