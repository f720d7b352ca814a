"""The port's temporal, filter and tonal ops held to the JAX package on
the CPU: framed energies, onsets (K4's plain version on the flux path),
pauses, silence, loudness, tempo, DC removal, dynamic range, crest, ZCR
from the signal, key correlations and chord templates. Inputs are made
with numpy from a seed; tolerances are stated per test, with the
package-wide ones in sonido_sonar_tpu_torch/utils/parity.py."""

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sonido_sonar_tpu.ops import chroma as jchroma  # noqa: E402
from sonido_sonar_tpu.ops import filters as jfilters  # noqa: E402
from sonido_sonar_tpu.ops import spectral as jspectral  # noqa: E402
from sonido_sonar_tpu.ops import temporal as jt  # noqa: E402
from sonido_sonar_tpu.ops import tonal as jtonal  # noqa: E402
from sonido_sonar_tpu_torch.ops import chroma as tchroma  # noqa: E402
from sonido_sonar_tpu_torch.ops import filters as tfilters  # noqa: E402
from sonido_sonar_tpu_torch.ops import spectral as tspectral  # noqa: E402
from sonido_sonar_tpu_torch.ops import temporal as tt  # noqa: E402
from sonido_sonar_tpu_torch.ops import tonal as ttonal  # noqa: E402
from sonido_sonar_tpu_torch.utils import parity  # noqa: E402

torch.set_num_threads(1)
SR = 44100


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def pcm():
    """[3, 2 s]: two tonal rows and a noise row, with a DC offset."""
    x = parity.synth_pcm(4, 2 * SR, 11).numpy()[1:]
    return (x + np.float32(0.05)).astype(np.float32)


@pytest.fixture(scope="module")
def energies(pcm):
    """STE at 1024/256 from the JAX package: the same input for both."""
    return np.array(jt.short_time_energy(jnp.asarray(pcm), 1024, 256))


def test_dc_removal_matches_jax_and_the_recurrence(pcm):
    """Both chunked float32 forms against the float64 sequential
    recurrence y[n] = x[n] - x[n-1] + R y[n-1]: within 1e-5 of the
    signal scale (the JAX tests' bound, tests/test_temporal.py:168)."""
    x = pcm.astype(np.float64)
    y = np.zeros_like(x)
    prev_x = np.zeros(x.shape[0])
    prev_y = np.zeros(x.shape[0])
    for n in range(x.shape[1]):
        prev_y = x[:, n] - prev_x + 0.995 * prev_y
        prev_x = x[:, n]
        y[:, n] = prev_y
    got = tfilters.dc_removal(torch.from_numpy(pcm)).numpy()
    ref = _np(jfilters.dc_removal(jnp.asarray(pcm)))
    scale = np.abs(y).max()
    np.testing.assert_allclose(got, y, atol=1e-5 * scale)
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale)
    assert abs(got[:, -SR // 2:].mean()) < 1e-3  # the offset is gone


def test_dc_removal_short_and_one_dim():
    x = np.random.default_rng(0).standard_normal(300).astype(np.float32)
    got = tfilters.dc_removal(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _np(jfilters.dc_removal(jnp.asarray(x))), atol=1e-5)
    assert tfilters.pre_emphasis_coefficient("music") == 0.95
    assert tfilters.pre_emphasis_coefficient("other") == 0.95
    np.testing.assert_allclose(
        tfilters.pre_emphasis_for_content(torch.from_numpy(x), "speech").numpy(),
        _np(jfilters.pre_emphasis_for_content(jnp.asarray(x), "speech")), atol=1e-7,
    )


@pytest.mark.parametrize("frame,hop", [(1024, 256), (512, 256), (17640, 4410), (260, 256), (2048, 512)])
def test_short_time_energy_geometries(pcm, frame, hop):
    """Hop-block sums (or frames, when hop does not divide the frame)
    against the JAX package's: float32 sums in another order."""
    got = tt.short_time_energy(torch.from_numpy(pcm), frame, hop).numpy()
    ref = _np(jt.short_time_energy(jnp.asarray(pcm), frame, hop))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("window,hop", [(1024, 256), (2048, 512), (1000, 300)])
def test_zcr_from_signal_exact(pcm, window, hop):
    """Counts of sign changes: integers, equal bits, per second as JAX's
    callers compute them, under jit: XLA scales by the float32 reciprocal
    of W / sr, which at 1000/300 rounds 2 of 873 frames an ulp away from
    an eager (exact) division."""
    got = tspectral.zcr_from_signal(torch.from_numpy(pcm), window, hop, SR).numpy()
    jitted = jax.jit(jspectral.zcr_from_signal, static_argnums=(1, 2, 3))
    np.testing.assert_array_equal(got, _np(jitted(jnp.asarray(pcm), window, hop, SR)))


def test_loudness_dynamic_range_and_crest(pcm):
    x = torch.from_numpy(pcm)
    np.testing.assert_allclose(
        tt.loudness_range(x, SR).numpy(), _np(jt.loudness_range(jnp.asarray(pcm), SR)), atol=1e-3)
    np.testing.assert_allclose(
        tt.dynamic_range_db(x, 1024, 512).numpy(),
        _np(jt.dynamic_range_db(jnp.asarray(pcm), 1024, 512)), atol=1e-3)
    np.testing.assert_allclose(
        tt.crest_factor_frames(x, 1024, 256).numpy(),
        _np(jt.crest_factor_frames(jnp.asarray(pcm), 1024, 256)), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tt.silence_mask_db(x * 1e-3, 1024, 256, -40.0).numpy(),
        _np(jt.silence_mask_db(jnp.asarray(pcm * 1e-3), 1024, 256, -40.0)))


def test_silence_and_pauses_on_the_same_energies(energies):
    """The sorted value at T // 10 (no interpolation): equal decisions.
    Quiet stretches make pauses to find."""
    e = energies.copy()
    e[:, 20:60] *= 1e-3
    e[:, 100:103] *= 1e-3
    te = torch.from_numpy(e)
    np.testing.assert_array_equal(
        tt.silence_ratio_percentile(te).numpy(), _np(jt.silence_ratio_percentile(jnp.asarray(e))))
    d, c = tt.pause_durations(te, 256, SR)
    jd, jc = jt.pause_durations(jnp.asarray(e), 256, SR)
    np.testing.assert_array_equal(c.numpy(), _np(jc))
    np.testing.assert_allclose(d.numpy(), _np(jd), atol=1e-6)
    assert c.dtype == torch.int32 and int(c.max()) >= 1


def test_energy_onsets_and_attack_times(energies):
    """Derivative peaks over mean + 2 std and the 10-frame look-back:
    the same decisions on the same energies."""
    e = energies.copy()
    e[:, ::37] *= 4.0  # onsets to find
    m, c = tt.detect_onsets_from_energy(torch.from_numpy(e))
    jm, jc = jt.detect_onsets_from_energy(jnp.asarray(e))
    np.testing.assert_array_equal(m.numpy(), _np(jm))
    np.testing.assert_array_equal(c.numpy(), _np(jc))
    assert int(c.min()) > 0
    at = tt.attack_times_from_onsets(m, torch.from_numpy(e), 256, SR).numpy()
    np.testing.assert_allclose(at, _np(jt.attack_times_from_onsets(jm, jnp.asarray(e), 256, SR)), atol=1e-7)


@pytest.mark.parametrize("relative,threshold", [(True, 0.3), (False, 0.1)])
def test_flux_onsets_on_the_same_flux(relative, threshold):
    """K4's plain version on the music and tempo thresholds."""
    flux = np.abs(np.random.default_rng(3).standard_normal((2, 517))).astype(np.float32)
    flux /= flux.max(-1, keepdims=True)
    m, c = tt.detect_onsets_from_flux(torch.from_numpy(flux), 256, SR, threshold, 0.05, relative)
    jm, jc = jt.detect_onsets_from_flux(jnp.asarray(flux), 256, SR, threshold, 0.05, relative)
    np.testing.assert_array_equal(m.numpy(), _np(jm))
    np.testing.assert_array_equal(c.numpy(), _np(jc))


def test_onset_positions_combine_and_tempo():
    """Positions, the 50 ms merge and the interval histogram on the same
    masks: equal positions and BPM."""
    rng = np.random.default_rng(5)
    m1 = rng.random((3, 300)) < 0.1
    m2 = rng.random((3, 600)) < 0.05
    p1, v1 = tt.onset_positions_from_mask(torch.from_numpy(m1), 512, 256)
    p2, v2 = tt.onset_positions_from_mask(torch.from_numpy(m2), 256, 256)
    jp1, jv1 = jt.onset_positions_from_mask(jnp.asarray(m1), 512, 256)
    jp2, jv2 = jt.onset_positions_from_mask(jnp.asarray(m2), 256, 256)
    np.testing.assert_array_equal(p1.numpy(), _np(jp1))
    np.testing.assert_array_equal(v2.numpy(), _np(jv2))
    pos, valid = tt.combine_onset_positions(p1, v1, p2, v2, int(0.05 * SR))
    jpos, jvalid = jt.combine_onset_positions(jp1, jv1, jp2, jv2, int(0.05 * SR))
    np.testing.assert_array_equal(pos.numpy(), _np(jpos))
    np.testing.assert_array_equal(valid.numpy(), _np(jvalid))
    np.testing.assert_array_equal(
        tt.tempo_from_onset_positions(pos, valid, SR).numpy(),
        _np(jt.tempo_from_onset_positions(jpos, jvalid, SR)))


def test_tempo_from_intervals_ties_and_default():
    """First-minimum bin per interval, first-maximum bin over counts,
    120 BPM when none qualifies, 0 with fewer than two onsets."""
    iv = np.array([[0.5, 0.5, 0.6, 0.6, 0.0], [3.0, 3.0, 0.1, 0.1, 0.1],
                   [0.4615, 0.4, 0.4615, 0.4, 0.3]], np.float32)
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1], [1, 1, 1, 1, 1]], bool)
    got = tt.tempo_from_intervals(torch.from_numpy(iv), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, _np(jt.tempo_from_intervals(jnp.asarray(iv), jnp.asarray(valid))))
    assert got[1] == 120.0
    pos = torch.tensor([[0, 0, 0]], dtype=torch.int32)
    assert tt.tempo_from_onset_positions(pos, torch.tensor([[True, False, False]]), SR).item() == 0.0


def test_estimate_tempo_on_click_trains():
    """Clicks every 0.5 s and every 0.4 s over noise, 3 s: the same BPM
    (intervals must fall in 0.2-2 s to vote)."""
    rng = np.random.default_rng(7)
    n = 3 * SR
    x = 0.01 * rng.standard_normal((2, n)).astype(np.float32)
    for row, period in enumerate((0.5, 0.4)):
        for k in np.arange(0.1, 3.0, period):
            s = int(k * SR)
            x[row, s: s + 400] += np.hanning(400).astype(np.float32) * rng.standard_normal(400).astype(np.float32)
    got = tt.estimate_tempo(torch.from_numpy(x), SR).numpy()
    np.testing.assert_array_equal(got, _np(jt.estimate_tempo(jnp.asarray(x), SR)))
    assert set(got.tolist()) == {120.0, 150.0}


def test_key_correlations_and_chord_templates():
    chroma = np.random.default_rng(2).random((3, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tchroma.key_correlations(torch.from_numpy(chroma)).numpy(),
        _np(jchroma.key_correlations(jnp.asarray(chroma))), atol=1e-6)
    np.testing.assert_array_equal(ttonal.CHORD_MATRIX, jtonal._CHORD_MATRIX)
    assert ttonal.CHORD_LABELS == jtonal._CHORD_LABELS
    assert tchroma.CHROMA_LABELS == jchroma.CHROMA_LABELS
